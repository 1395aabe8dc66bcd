"""The port's block-sparse substrate held against the JAX package.

The same numpy data goes through both; tolerances are stated per test.
Also: the port imports neither JAX nor the JAX package, and its entry
points refuse to run on a CPU they were not asked for.
"""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.tensor import blocksparse as jbs  # noqa: E402
from repro_torch.tensor import blocksparse as tbs  # noqa: E402
from repro_torch.tensor.block_csr import contract_block_csr  # noqa: E402
from repro_torch.dist.engine import ContractionEngine  # noqa: E402

from _torch_helpers import CASES, IN, OUT, S2, SP, assert_blocks_close, make_both, specs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("case", sorted(CASES))
def test_contract_backends_match_reference(case):
    """list, csr (plain version on the CPU), engine list/csr vs JAX
    ``contract``: every block within 1e-12."""
    a_specs, qa, b_specs, qb, axes = CASES[case]
    ja, ta = make_both(1, a_specs, qa)
    jb, tb = make_both(2, b_specs, qb)
    want = jbs.contract(ja, jb, axes)
    for got in (
        tbs.contract(ta, tb, axes),
        contract_block_csr(ta, tb, axes),
        ContractionEngine("list")(ta, tb, axes),
        ContractionEngine("csr")(ta, tb, axes),
        ContractionEngine("csr", use_kernel=False)(ta, tb, axes),
    ):
        assert_blocks_close(got, want, 1e-12)


def test_tensor_algebra_matches_reference():
    """scale, +, -, conj, transpose, norm, inner, dense round trip and
    flip_flow agree with JAX to 1e-12."""
    a_specs = CASES["one_mode"][0]
    ja, ta = make_both(3, a_specs, (0,))
    jb, tb = make_both(4, a_specs, (0,))
    assert_blocks_close(ta.scale(0.5) + tb - ta, ja.scale(0.5) + jb - ja, 1e-12)
    assert_blocks_close(ta.conj(), ja.conj(), 0.0)
    assert_blocks_close(ta.transpose((2, 0, 1)), ja.transpose((2, 0, 1)), 0.0)
    assert abs(float(ta.norm()) - float(ja.norm())) <= 1e-12
    assert abs(float(ta.inner(tb)) - float(ja.inner(jb))) <= 1e-12
    dense = ta.to_dense()
    np.testing.assert_allclose(dense.numpy(), np.asarray(ja.to_dense()), rtol=0, atol=0)
    assert_blocks_close(tbs.BlockSparseTensor.from_dense(dense, ta.indices, ta.charge), ta, 0.0)
    for axis in range(3):
        got, want = tbs.flip_flow(ta, axis), jbs.flip_flow(ja, axis)
        assert_blocks_close(got, want, 0.0)


THETA = [(S2, IN, "l"), (SP, OUT, "s1"), (SP, OUT, "s2"), (S2, OUT, "r")]


@pytest.mark.parametrize("max_bond,absorb", [(100, "right"), (5, "left"), (3, "right"), (4, "none")])
def test_svd_split_matches_reference(max_bond, absorb):
    """U.V, singular values, kept sectors and trunc_err agree with the JAX
    planned ``svd_split`` to 1e-12, up to the sign of each singular vector."""
    jt, tt = make_both(5, THETA, (0,))
    jU, jV, jS, jerr = jbs.svd_split(jt, 2, max_bond, absorb=absorb)
    tU, tV, tS, terr = tbs.svd_split(tt, 2, max_bond, absorb=absorb)
    assert specs(tU.indices) == specs(jU.indices) and specs(tV.indices) == specs(jV.indices)
    assert sorted(tS) == sorted(jS)
    for q in jS:
        np.testing.assert_allclose(tS[q].numpy(), np.asarray(jS[q]), rtol=0, atol=1e-12)
    assert abs(terr - jerr) <= 1e-12
    assert sum(d for _, d in tU.indices[-1].sectors) <= max_bond
    assert_blocks_close(tbs.contract(tU, tV, ((2,), (0,))), jbs.contract(jU, jV, ((2,), (0,))), 1e-12)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    """No module of the port, nor chip_smoke.py, imports jax or repro."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [
        (str(f.relative_to(ROOT)), mod)
        for f in files
        for mod in _imports(f)
        if mod.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert bad == []


def test_default_device_entry_points_raise_without_cuda(monkeypatch):
    """device=None means the card: without one every entry point raises
    and names the way to ask for the CPU."""
    from repro_torch.convert import bst_from_arrays
    from repro_torch.core import DMRGEngine, build_mpo, get_contractor, product_state_mps, run_dmrg
    from repro_torch.core.models import heisenberg_chain_system

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    space, terms = heisenberg_chain_system(4)
    mps = product_state_mps(space, [0, 1, 0, 1], device="cpu")
    mpo = build_mpo(space, terms, 4, device="cpu")
    calls = [
        lambda: run_dmrg(space, terms, 4, bond_schedule=(4,)),
        lambda: build_mpo(space, terms, 4),
        lambda: product_state_mps(space, [0, 1, 0, 1]),
        lambda: get_contractor("csr"),
        lambda: DMRGEngine(mps, mpo, algo="csr"),
        lambda: bst_from_arrays([(SP, OUT, "s")], (1,), {(0,): np.ones(1)}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("kwargs", [
    dict(spmd=True), dict(shard_policy="storage"), dict(plan_store="store"),
])
def test_unported_arguments_raise(kwargs, tmp_path):
    """The arguments of the reference API that the port refused until the
    distributed path and the plan store came (``spmd``, ``shard_policy``,
    ``plan_store``) now run and reach ED on a 4-site chain, and a bare
    contractor still refuses a policy rather than ignoring it."""
    from repro_torch.core import ground_energy, run_dmrg
    from repro_torch.core.models import heisenberg_chain_system
    from repro_torch.dist.shard import BlockShardPolicy, make_block_mesh

    space, terms = heisenberg_chain_system(4)
    if "shard_policy" in kwargs:
        kwargs = dict(shard_policy=BlockShardPolicy(make_block_mesh(device="cpu"), mode=kwargs["shard_policy"]))
        with pytest.raises(ValueError, match="shard_policy requires a ContractionEngine"):
            run_dmrg(space, terms, 4, bond_schedule=(4,), algo="list_unplanned", device="cpu", **kwargs)
    if "plan_store" in kwargs:
        kwargs = dict(plan_store=str(tmp_path / kwargs["plan_store"]))
    res = run_dmrg(space, terms, 4, bond_schedule=(4,), davidson_iters=4, algo="batched", device="cpu", **kwargs)
    assert abs(res.energy - ground_energy(space, terms, 4)) < 1e-8


@pytest.mark.parametrize("kwargs", [
    dict(algo="batched", jit_matvec=True), dict(algo="list", pad_matvec=True),
    dict(algo="batched", svd_method="svd"), dict(algo="csr", jit_env=True), dict(algo="batched"),
    dict(algo="dense"), dict(algo="auto"), dict(algo="planned"), dict(algo="dense_unplanned"),
    dict(algo="csr_unplanned"), dict(algo="auto", checkpoint_dir="ckpt"),
])
def test_ported_arguments_are_accepted(kwargs, tmp_path):
    """The engine options this port carries run, and reach ED on a 4-site
    chain."""
    from repro_torch.core import ground_energy, run_dmrg
    from repro_torch.core.models import heisenberg_chain_system

    space, terms = heisenberg_chain_system(4)
    if "checkpoint_dir" in kwargs:
        kwargs = dict(kwargs, checkpoint_dir=str(tmp_path / kwargs["checkpoint_dir"]))
    res = run_dmrg(space, terms, 4, bond_schedule=(4,), davidson_iters=4, device="cpu", **kwargs)
    assert abs(res.energy - ground_energy(space, terms, 4)) < 1e-8
