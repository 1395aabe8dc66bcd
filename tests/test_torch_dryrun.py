"""The port's dry run (``launch/dryrun.py``, ``launch/costs.py``,
``launch/report.py``) and its cells (``launch/specs.py``) against the
reference's.

In this process: ``model_flops_estimate`` and ``empirical_block_dims``
against the reference's, and the dense and list DMRG cells' functions at
tiny bond dimension (``DMRG_CELLS`` patched in both modules) on the same
seeded inputs, lam, the residual norm and the new vector within 1e-5 in
float32.  In subprocesses (a fake process group must not outlive its
test): the cost counter on hand-computed cases and ``run_cell`` on a smoke
granite at sequence 64 on fake 8-rank meshes (4,2) and (2,2,2), the
reference's ``TestDryRunSmoke``; ``report.emit`` on their records; and
the three kinds of cell that failed where "model" divides neither the KV
groups nor the heads (``UNEVEN``), each of which must lower.  The
reference's ``TestHloCosts`` parses HLO text and has no counterpart.
"""
import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS, SHAPES  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch.launch import report, specs  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def j_model_flops():
    """The reference's ``model_flops_estimate``: its module sets XLA_FLAGS
    for 512 host devices when imported, which this process must not keep."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import model_flops_estimate
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return model_flops_estimate


def test_model_flops_estimate_is_the_references(j_model_flops):
    from repro_torch.launch.dryrun import model_flops_estimate

    for arch in ARCH_IDS:
        for shape in SHAPES:
            assert model_flops_estimate(arch, shape) == j_model_flops(arch, shape), (arch, shape)


@pytest.mark.parametrize("m,q,r", [(32768, 4, 0.6), (16384, 10, 0.65), (64, 4, 0.6), (1000, 3, 0.5)])
def test_empirical_block_dims_are_the_references(m, q, r):
    assert specs.empirical_block_dims(m, q, r) == jspecs.empirical_block_dims(m, q, r)


TINY = {"dmrg_spins": dict(m=64, d=2, k=5, dtype="float32"), "dmrg_electrons": dict(m=48, d=4, k=3, dtype="float32")}


@pytest.fixture
def tiny_cells(monkeypatch):
    monkeypatch.setattr(specs, "DMRG_CELLS", TINY)
    monkeypatch.setattr(jspecs, "DMRG_CELLS", TINY)


def _inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) * 0.3 for s in shapes]


def _agree(got, want):
    lam, rn, xs = got
    jlam, jrn, jxs = want
    assert abs(float(lam) - float(jlam)) <= 1e-5 * max(1.0, abs(float(jlam)))
    assert abs(float(rn) - float(jrn)) <= 1e-5 * max(1.0, abs(float(jrn)))
    for x, jx in zip(xs, jxs):
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-5)


@pytest.mark.parametrize("name", list(TINY))
def test_dense_davidson_step_matches_the_reference(tiny_cells, name):
    import jax.numpy as jnp

    p = TINY[name]
    m, d, k = p["m"], p["d"], p["k"]
    arrays = _inputs([(m, k, m), (k, d, d, k), (k, d, d, k), (m, k, m), (m, d, d, m)], seed=k)
    arrays[-1] /= np.linalg.norm(arrays[-1])
    got = specs.dmrg_davidson_fn(m, d, k)(*(torch.from_numpy(a) for a in arrays))
    want = jspecs.dmrg_davidson_fn(m, d, k)(*(jnp.asarray(a) for a in arrays))
    _agree((got[0], got[1], [got[2]]), (want[0], want[1], [want[2]]))


@pytest.mark.parametrize("name", list(TINY))
def test_list_matvec_matches_the_reference(tiny_cells, name):
    import jax.numpy as jnp

    mesh = types.SimpleNamespace(shape={"data": 1, "model": 1}, mesh_dim_names=("data", "model"))
    from repro.launch.mesh import make_mesh

    fn, args, *_ = specs.dmrg_list_cell(f"{name}_list", mesh)
    jfn, jargs, *_ = jspecs.dmrg_list_cell(f"{name}_list", make_mesh((1, 1), ("data", "model")))
    a_blocks, w, _, _, x_blocks = args
    assert [tuple(t.shape) for t in a_blocks] == [tuple(s.shape) for s in jargs[0]]
    assert [tuple(t.shape) for t in x_blocks] == [tuple(s.shape) for s in jargs[4]]
    A = _inputs([t.shape for t in a_blocks], seed=1)
    W = _inputs([w.shape, w.shape], seed=2)
    X = _inputs([t.shape for t in x_blocks], seed=3)
    norm = np.sqrt(sum(float(np.sum(x * x)) for x in X))
    X = [(x / norm).astype(np.float32) for x in X]
    t = lambda arrs: tuple(torch.from_numpy(a) for a in arrs)
    j = lambda arrs: tuple(jnp.asarray(a) for a in arrs)
    got = fn(t(A), *t(W), t(A), t(X))
    want = jfn(j(A), *j(W), j(A), j(X))
    _agree(got, want)


# ------------------------------------------------------- fake worlds
COUNTS = textwrap.dedent("""\
    import json, sys
    sys.path.insert(0, sys.argv[1])
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor
    from repro_torch.launch.costs import counting
    from repro_torch.launch.mesh import HW, fake_mesh
    mesh = fake_mesh((4, 2), ("data", "model"))
    out = {}
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(8, 64), mesh, [Shard(0), Replicate()], src_data_rank=None)
        w = distribute_tensor(torch.empty(64, 32), mesh, [Replicate(), Shard(1)], src_data_rank=None)
        with counting(HW) as c:
            y = x @ w
        out["matmul"] = [c.flops, c.totals()["coll"]["total"], list(y.to_local().shape)]
        with counting(HW) as c:
            funcol.wait_tensor(funcol.all_reduce(torch.empty(16), "sum", (mesh, 0)))
        out["all_reduce"] = [c.coll["all-reduce"], c.coll_count]
        p = torch.distributed.tensor.DTensor.from_local(torch.empty(4, 8), mesh, [Partial(), Replicate()])
        with counting(HW) as c:
            p.redistribute(mesh, [Replicate(), Replicate()])
        out["partial"] = [c.coll["all-reduce"], c.coll_count]
    print("COUNTS " + json.dumps(out))
""")

CELL = textwrap.dedent("""\
    import dataclasses, json, sys
    sys.path.insert(0, sys.argv[1])
    import repro_torch.configs.base as base
    base.SHAPES["train_4k"] = dict(seq_len=64, global_batch=8, kind="train")
    from repro_torch.launch import dryrun, mesh as mesh_mod
    multi_pod = sys.argv[3] == "1"
    mesh_mod.make_production_mesh = lambda multi_pod=False: mesh_mod.fake_mesh(
        (2, 2, 2) if multi_pod else (4, 2), ("pod", "data", "model") if multi_pod else ("data", "model"))
    base.register(dataclasses.replace(base.get_config("granite_3_2b").smoke(), name="granite_tiny"))
    rec = dryrun.run_cell("granite_tiny", "train_4k", multi_pod, sys.argv[2], force=True)
    print("CELL " + json.dumps(rec))
""")


# The three kinds of cell that once failed where "model" divides neither
# the KV groups nor the heads, at smoke widths on a fake (2, 4) mesh: a
# grouped decode of 8 query heads over 2 KV heads, and a hybrid of 6 heads
# trained at S = 2W (the banded form) and prefilled at S = 4W (the
# block-local form).  Each cell's status, or its error.
UNEVEN = textwrap.dedent("""\
    import dataclasses, json, sys
    sys.path.insert(0, sys.argv[1])
    import repro_torch.configs.base as base
    base.SHAPES.update(train_4k=dict(seq_len=32, global_batch=8, kind="train"),
                       prefill_32k=dict(seq_len=64, global_batch=8, kind="prefill"),
                       decode_32k=dict(seq_len=64, global_batch=8, kind="decode"))
    from repro_torch.launch import dryrun, mesh as mesh_mod
    mesh_mod.make_production_mesh = lambda multi_pod=False: mesh_mod.fake_mesh((2, 4), ("data", "model"))
    base.register(dataclasses.replace(base.get_config("llama3_8b").smoke(), name="gqa_uneven", n_heads=8,
                                      n_kv_heads=2))
    base.register(dataclasses.replace(base.get_config("recurrentgemma_2b").smoke(), name="hybrid_uneven",
                                      n_heads=6))
    out = {}
    for arch, shape in (("gqa_uneven", "decode_32k"), ("hybrid_uneven", "train_4k"), ("hybrid_uneven", "prefill_32k")):
        try:
            out[shape] = dryrun.run_cell(arch, shape, False, sys.argv[2], force=True)["status"]
        except Exception as e:  # the cell's failure is the reading
            out[shape] = f"{type(e).__name__}: {e}"[:400]
    print("UNEVEN " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def fake_runs(tmp_path_factory):
    """The counter cases, the two smoke cells and the uneven cells, each in
    a subprocess of its own, run side by side: ({"counts": ..., mesh name:
    record, "uneven": {shape: status}}, records dir)."""
    out_dir = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    run = lambda code, *args: subprocess.Popen([sys.executable, "-c", code, str(REPO / "src"), *map(str, args)],
                                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    procs = {"counts": run(COUNTS), "pod256": run(CELL, out_dir, 0), "pod512": run(CELL, out_dir, 1),
             "uneven": run(UNEVEN, tmp_path_factory.mktemp("uneven"))}
    results = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        tag = {"counts": "COUNTS ", "uneven": "UNEVEN "}.get(name, "CELL ")
        line = [ln for ln in stdout.splitlines() if ln.startswith(tag)]
        assert proc.returncode == 0 and line, stderr[-3000:]
        results[name] = json.loads(line[-1][len(tag):])
    return results, out_dir


def test_sharded_matmul_counts_its_local_flops(fake_runs):
    flops, coll, local = fake_runs[0]["counts"]["matmul"]
    assert local == [2, 16]
    assert flops == 2 * 8 * 64 * 32 / 8  # the global product's flops over 8 ranks
    assert coll == 0


def test_all_reduce_wire_bytes(fake_runs):
    counts = fake_runs[0]["counts"]
    assert counts["all_reduce"] == [2 * 64 * 3 / 4, 1]  # 2R(G-1)/G: R = 64 bytes, G = 4
    assert counts["partial"] == [2 * 128 * 3 / 4, 1]  # a partial sum over "data" made whole


@pytest.mark.parametrize("mesh", ["pod256", "pod512"])
def test_small_mesh_cell(fake_runs, mesh):
    rec = fake_runs[0][mesh]
    assert rec["status"] == "ok", rec
    assert rec["chips"] == 8 and rec["mesh"] == mesh
    assert rec["flops_per_chip"] > 0 and rec["bytes_per_chip"] > 0
    assert rec["collective"]["total"] > 0
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    # per-rank flops are the local shards': about an eighth of one device's
    assert rec["flops_per_chip"] < rec["model_flops_global"]


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k", "prefill_32k"])
def test_cell_lowers_where_model_divides_no_heads(fake_runs, shape):
    """The grouped decode with 2 KV heads under a "model" of 4, and the
    banded (train) and block-local (prefill) attention of 6 heads under it,
    forward and backward: each cell lowers."""
    assert fake_runs[0]["uneven"][shape] == "ok"


def test_report_emits_both_meshes(fake_runs):
    text = report.emit(str(fake_runs[1]))
    assert "### Mesh pod256" in text and "### Mesh pod512" in text
    rows = [ln for ln in text.splitlines() if ln.startswith("| granite_tiny | train_4k |")]
    assert len(rows) == 2
