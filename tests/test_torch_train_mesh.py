"""Training under a data x model mesh on the CPU: the port's DTensor path
(parameters, moments and batches placed by their logical axes, flash
attention and the RWKV6 scan on each rank's local heads) against the same
steps on one device.

Spawned gloo worlds (``_torch_mesh_worker.py``, a rank imports only torch
and the port): a world of 2 on a 1x2 mesh trains one architecture of each
family (dense, MoE, RWKV6, the RG-LRU hybrid, the VLM, Whisper) for three
float32 steps, then runs the train CLI at ``--mesh-model 2``, saves, and
resumes on a 2x1 mesh (FSDP over "data"); a world of 4 trains llama3_8b
and rwkv6_3b on a 2x2 mesh and holds the flash wrapper's grouped-KV rule
(8 query heads over "model", 2 KV heads replicated) on a 1x4 mesh, and on
that mesh a grouped decode step (2 KV heads under a "model" of 4) and a
hybrid's banded and block-local attention (6 heads) against one device.
The first batch's float32 gradients are held per tensor to one device's
at 1e-5 (relative; ``scripts/mesh_grads.py``), and for llama3_8b and
rwkv6_3b the bf16 control and the planted faults in the kernel wrappers'
sharding (a wrong KV or u slice, u's gradient not summed over the batch
shards) must read above ``FAULT_FLOOR``.  Over three steps, losses,
learning rates and all parameters together are held to 1e-5, and so are
the grad norm and each parameter tensor but a key bias (its exact gradient
is zero) except where ``SPREAD`` says why not; the losses after a restore
to the uninterrupted run's at 1e-5.
"""
import json
import os
import shutil
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.multiprocessing as mp  # noqa: E402

import _torch_mesh_worker as worker  # noqa: E402
from repro_torch.kernels.sharded import local_kv_heads  # noqa: E402

FAMILIES = ["llama3_8b", "qwen2_moe_a27b", "rwkv6_3b", "recurrentgemma_2b", "pixtral_12b", "whisper_tiny"]
WIDE = ["llama3_8b", "rwkv6_3b"]
LIMIT = 1e-5
FAULT_FLOOR = 1e-3  # the least a planted fault or the bf16 control may read: 100x LIMIT
WORLD_DEADLINE = 240.0  # seconds a spawned world may take, start-up included


def run_worlds(specs, tmp_dir):
    """Spawn one gloo world per (size, shape, archs, extra) of ``specs``,
    all at once, and return each world's per-rank records; fail past
    ``WORLD_DEADLINE``."""
    worlds = []
    for i, (size, shape, archs, extra) in enumerate(specs):
        out_dir = os.path.join(tmp_dir, f"world{i}")
        os.makedirs(out_dir)
        ctx = mp.start_processes(worker.train_case, nprocs=size, join=False, start_method="spawn",
                                 args=(size, os.path.join(out_dir, "store"), out_dir, shape, archs, extra))
        worlds.append((ctx, size, out_dir))
    deadline = time.monotonic() + WORLD_DEADLINE
    try:
        for ctx, size, _ in worlds:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise AssertionError(f"gloo world of {size} did not finish in {WORLD_DEADLINE} s")
    finally:
        for ctx, _, _ in worlds:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
    out = []
    for _, size, out_dir in worlds:
        ranks = []
        for r in range(size):
            with open(os.path.join(out_dir, f"{r}.json")) as f:
                ranks.append(json.load(f))
        out.append(ranks)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The world of 2 (1x2: every family, then the CLI's save and restore)
    and the world of 4 (2x2: llama3_8b and rwkv6_3b, then the GQA case),
    run side by side."""
    return run_worlds([(2, (1, 2), FAMILIES, "restore"), (4, (2, 2), WIDE, "gqa+uneven")],
                      str(tmp_path_factory.mktemp("mesh")))


@pytest.fixture(scope="module")
def world2(worlds):
    return worlds[0]


@pytest.fixture(scope="module")
def world4(worlds):
    return worlds[1]


# rwkv6_3b's grad norm and single tensors after three steps (read up to
# 9.1e-4 and 1.1e-3 at 2x2, 3.8e-4 and 4.9e-4 at 1x2), against gradients
# equal to 1e-5 at the first step: rounding, not the mesh.  One device
# with the batch's gradient summed in another order (two microbatches)
# drifts as far, and with the group norm's eps raised from 1e-5 to 1e-3
# it stays at 1e-5 (``test_rwkv6_spread_is_rounding_on_one_device``): the
# norm divides each head's wkv row by its spread, small in the first
# tokens' rows, so rounding in the first step's gradients moves the next
# steps' gradients by up to 1/sqrt(eps) times as much
SPREAD = {"rwkv6_3b": (2e-3, 3e-3)}


def _check_arch(ranks, arch):
    rec = ranks[0]["archs"][arch]
    gnorm_limit, tensor_limit = SPREAD.get(arch, (LIMIT, LIMIT))
    assert rec["keys_equal"]
    readings = dict(rec["grads"])
    sound = readings.pop("sound")
    assert sound[0] <= LIMIT, (arch, sound)
    if arch in worker.READINGS:  # the control and every fault the mesh's layout reaches
        assert "control_bf16" in readings and any(k.startswith("fault_") for k in readings), readings
        for name, (err, key, _) in readings.items():
            assert err > FAULT_FLOOR, (arch, name, err, key)
    for got, want in zip(rec["metrics"], rec["want"]):
        for name, limit in (("loss", LIMIT), ("grad_norm", gnorm_limit), ("lr", LIMIT)):
            assert np.isfinite(got[name]) and got[name] == pytest.approx(want[name], rel=limit), (arch, name)
    assert rec["param_rel_all"] <= LIMIT, (arch, rec["param_rel_all"])
    assert rec["param_rel"] <= tensor_limit, (arch, rec["param_rel"])
    for other in ranks[1:]:  # every rank reads the same replicated metrics
        assert other["archs"][arch]["metrics"] == rec["metrics"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_1x2_matches_one_device(world2, arch):
    _check_arch(world2, arch)


@pytest.mark.parametrize("arch", WIDE)
def test_2x2_matches_one_device(world4, arch):
    _check_arch(world4, arch)


def test_restore_onto_another_mesh_continues_the_run(world2, tmp_path):
    """Saved at 1x2 (``--mesh-model 2``), resumed at 2x1 in the same world
    and on one device: both continuations equal the uninterrupted run."""
    from repro_torch.launch.train import main

    rec = world2[0]["restore"]
    full = main(worker.CLI + ["--steps", "4", "--checkpoint-dir", str(tmp_path / "full")])
    single = tmp_path / "single"
    shutil.copytree(rec["ckpt"], single)
    on_one = main(worker.CLI + ["--steps", "4", "--resume", "auto", "--checkpoint-dir", str(single)])
    assert len(rec["first"]) == 2 and len(rec["resumed"]) == 2 and len(on_one) == 2
    np.testing.assert_allclose(rec["first"], full[:2], rtol=LIMIT)
    np.testing.assert_allclose(rec["resumed"], full[2:], rtol=LIMIT)
    np.testing.assert_allclose(on_one, full[2:], rtol=LIMIT)
    assert world2[1]["restore"]["resumed"] == rec["resumed"]


def test_gqa_with_replicated_kv_heads(world4):
    """H=8 over a model axis of 4, Hkv=2 replicated: each rank's launch gets
    its 2 query heads and the 1 KV head they read."""
    for rank in world4:
        g = rank["gqa"]
        assert g["out"] <= LIMIT and max(g["grads"]) <= LIMIT, g
        assert g["placements"] == ["R", "S(2)"]
        assert g["local_shapes"] == [[[2, 16, 2, 16], [2, 16, 1, 16]]]
        assert g["refused"] and "mesh dim 1 (model)" in g["refused"]


@pytest.mark.parametrize("case", ["decode", "banded", "windowed"])
def test_uneven_heads_match_one_device(world4, case):
    """On a 1x4 mesh, "model" dividing neither 2 KV groups of 8 query heads
    (a grouped decode step, its cache sharded over the sequence) nor a
    hybrid's 6 heads (banded and block-local attention, forward and
    backward): the same as one device at 1e-5 in float32."""
    for rank in world4:
        got = rank["uneven"][case]
        assert (got if case == "decode" else got[0]) <= LIMIT, (case, got)
        assert rank["uneven"]["cache_placements"] == ["R", "S(2)"]  # [layers, B, S, Hkv, D]: the sequence over "model"


def test_rwkv6_spread_is_rounding_on_one_device(monkeypatch):
    """``SPREAD``'s cause: on one device, rwkv6_3b's three steps with the
    gradient summed over two microbatches drift from the same steps over
    one beyond 1e-5, as far as the mesh's; with the group norm's eps at
    1e-3 they stay within 1e-5."""
    from repro_torch.configs import get_config
    from repro_torch.models import rwkv6

    cfg = get_config("rwkv6_3b").smoke()
    batches = worker._batches(cfg, worker.STEPS)

    def drift():
        (one, p1), (two, p2) = (worker._train(cfg, None, batches, n) for n in (1, 2))
        gnorm = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"] for a, b in zip(two, one))
        return gnorm, max(worker._rel(p2[k], p1[k]) for k in p1)

    gnorm, tensor = drift()
    assert LIMIT < gnorm <= SPREAD["rwkv6_3b"][0] and LIMIT < tensor <= SPREAD["rwkv6_3b"][1], (gnorm, tensor)
    norm = rwkv6._group_norm
    monkeypatch.setattr(rwkv6, "_group_norm", lambda x, g, b, n_heads, eps=1e-5: norm(x, g, b, n_heads, eps=1e-3))
    gnorm, tensor = drift()
    assert gnorm <= LIMIT and tensor <= LIMIT, (gnorm, tensor)


def test_local_kv_heads():
    assert [local_kv_heads(8, 2, 4, c) for c in range(4)] == [(0, 1), (0, 1), (1, 2), (1, 2)]
    assert [local_kv_heads(8, 8, 2, c) for c in range(2)] == [(0, 4), (4, 8)]
    assert local_kv_heads(32, 8, 2, 1) == (4, 8)
    with pytest.raises(ValueError, match="not even"):
        local_kv_heads(12, 6, 4, 1)  # query heads 3-5 read KV heads 1, 2, 2
