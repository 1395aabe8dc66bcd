"""Rank bodies of the port's mesh-training CPU tests (``test_torch_train_mesh.py``).

Spawned by ``torch.multiprocessing`` (the spawn method): a module of its own
so that a rank imports only torch and the port, never JAX.  Each rank joins
a gloo world through a ``FileStore``, runs its cases, and writes what it saw
to ``<out_dir>/<rank>.json``.
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

STEPS = 3
BATCH, SEQ = 4, 16
READINGS = ("llama3_8b", "rwkv6_3b")  # the archs whose gradient check also takes the control and the faults


def _rel(got, want) -> float:
    den = float(np.linalg.norm(want))
    return float(np.linalg.norm(got - want)) / (den if den else 1.0)


def _batches(cfg, n, seed=1):
    """``n`` global batches from the seeded ``SyntheticLM``, with seeded
    patch / frame embeddings for a VLM / Whisper: the same on every rank."""
    import torch

    from repro_torch.train.data import SyntheticLM

    data = SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        b = next(data)
        if cfg.family == "vlm":
            b["patch_embeds"] = torch.randn(BATCH, cfg.n_patches, cfg.d_model, generator=gen)
        if cfg.family == "audio":
            b["enc_embeds"] = torch.randn(BATCH, cfg.enc_seq_len, cfg.d_model, generator=gen)
        out.append(b)
    return out


def _train(cfg, mesh, batches, n_micro=1):
    """(per-step metrics, final parameters as numpy) of ``STEPS`` float32
    steps of ``make_train_step`` (over ``n_micro`` microbatches) from the
    seed-0 parameters: on one device when ``mesh`` is None, else with every
    tensor a DTensor on it."""
    import torch

    from repro_torch import models
    from repro_torch.launch import specs
    from repro_torch.launch.sharding import batch_axes_for, distribute, tree_shardings
    from repro_torch.train.optim import OptConfig, init_opt_state

    params = models.init(cfg, torch.Generator().manual_seed(0), "cpu")
    pshard = None
    if mesh is not None:
        pshard = tree_shardings(params, models.param_axes(cfg), mesh)
        params = distribute(params, pshard, mesh, src_data_rank=None)
    opt = init_opt_state(params)
    step = specs.make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=1, total_steps=STEPS), n_micro,
                                 grad_shardings=pshard)
    metrics = []
    for b in batches:
        if mesh is not None:
            b = distribute(b, tree_shardings(b, batch_axes_for(cfg, ""), mesh), mesh, src_data_rank=None)
        params, opt, m = step(params, opt, b)
        metrics.append({k: float(v) for k, v in m.items()})
    full = {k: (v.full_tensor() if mesh is not None else v).numpy() for k, v in params.items()}
    return metrics, full


def train_case(rank: int, world: int, store_file: str, out_dir: str, shape, archs, extra: str) -> None:
    """One rank: for each arch at smoke size, the float32 gradients of the
    first batch under a mesh of ``shape`` against one device's, per tensor
    (``scripts/mesh_grads.py``; for llama3_8b and rwkv6_3b also its bf16
    control and planted faults), and ``STEPS`` float32 steps under the mesh
    against the same steps on one device (rank 0 runs those); then each
    case of ``extra`` ("+"-separated): "restore" (the train CLI at
    ``--mesh-model 2`` saving at step 2, then resuming on a 2x1 mesh to
    step 4), "gqa" (the flash wrapper at H=8, Hkv=2 on a 1x4 mesh against
    the plain version), "uneven" (``_uneven_case``)."""
    import torch
    import torch.distributed as dist

    import mesh_grads
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_world, make_mesh

    torch.set_num_threads(1)  # tiny products; the ranks share the cores with other tests
    init_world("cpu", store=dist.FileStore(store_file, world), rank=rank, world_size=world)
    try:
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        out = {"archs": {}}
        for arch in archs:
            cfg = get_config(arch).smoke()
            batches = _batches(cfg, STEPS)
            grads = mesh_grads.check(cfg, batches[0], "cpu", [mesh], readings=arch in READINGS)
            got, got_p = _train(cfg, mesh, batches)
            rec = {"metrics": got, "grads": grads["readings"]["x".join(map(str, shape))]}
            if rank == 0:
                want, want_p = _train(cfg, None, batches)
                rec["want"] = want
                # per tensor, except a key bias: softmax ignores a shift shared by
                # every key, so its exact gradient is zero and AdamW turns the
                # rounding of either run into steps of the learning rate's size
                rec["param_rel"] = max(_rel(got_p[k], want_p[k]) for k in want_p if not k.endswith("/bk"))
                keys = sorted(want_p)
                rec["param_rel_all"] = _rel(np.concatenate([got_p[k].ravel() for k in keys]),
                                            np.concatenate([want_p[k].ravel() for k in keys]))
                rec["keys_equal"] = sorted(got_p) == sorted(want_p)
            out["archs"][arch] = rec
        cases = extra.split("+")
        if "restore" in cases:
            out["restore"] = _restore_case(rank, out_dir)
        if "gqa" in cases:
            out["gqa"] = _gqa_case()
        if "uneven" in cases:
            out["uneven"] = _uneven_case()
        with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


CLI = ["--arch", "llama3_8b", "--smoke", "--device", "cpu", "--log-every", "0", "--global-batch", str(BATCH),
       "--seq-len", str(SEQ)]


def _restore_case(rank: int, out_dir: str):
    """The train CLI in this world: 2 steps at ``--mesh-model 2`` (1x2)
    with a checkpoint at step 2, then ``--resume auto`` to step 4 at
    ``--mesh-model 1`` (2x1, FSDP over "data")."""
    from repro_torch.launch.train import main

    ck = os.path.join(out_dir, "ckpt")
    first = main(CLI + ["--mesh-model", "2", "--steps", "2", "--checkpoint-every", "2", "--checkpoint-dir", ck])
    resumed = main(CLI + ["--mesh-model", "1", "--steps", "4", "--resume", "auto", "--checkpoint-dir", ck])
    return {"first": first, "resumed": resumed, "ckpt": ck}


def _gqa_case():
    """Flash attention (its plain version on the CPU) on a 1x4 mesh with 8
    query heads sharded over "model" and 2 KV heads replicated: output and
    gradients against the plain version on whole tensors, and the KV heads
    that each rank's local launch received."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    gen = torch.Generator().manual_seed(3)
    q, k, v, w = (torch.randn(2, 16, h, 16, generator=gen) for h in (8, 2, 2, 8))
    seen = []
    plain = ops._plain

    def recording(ql, kl, vl):
        seen.append([list(ql.shape), list(kl.shape)])
        return plain(ql, kl, vl)

    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = ops.flash_attention_bshd(*leaves)
    (want * w).sum().backward()
    dq = [distribute_tensor(t.clone(), mesh, [Replicate(), p], src_data_rank=None).requires_grad_(True)
          for t, p in zip((q, k, v), (Shard(2), Replicate(), Replicate()))]
    ops._plain = recording
    try:
        got = ops.flash_attention_bshd(*dq)
    finally:
        ops._plain = plain
    (got * distribute_tensor(w, mesh, [Replicate(), Shard(2)], src_data_rank=None)).sum().backward()
    err = lambda a, b: float((a.full_tensor() - b).abs().max())
    refused = None
    try:  # the sequence sharded: a placement the kernels' rule does not cover
        ops.flash_attention_bshd(*(distribute_tensor(t, mesh, [Replicate(), Shard(1)], src_data_rank=None)
                                   for t in (q, k, v)))
    except ValueError as e:
        refused = str(e)
    return {"out": err(got, want), "grads": [err(a.grad, b.grad) for a, b in zip(dq, leaves)],
            "placements": [str(p) for p in got.placements], "local_shapes": seen, "refused": refused}


def _uneven_case():
    """On a 1x4 mesh, where "model" divides neither the KV groups nor the
    heads, against one device in float32: a grouped decode step (8 query
    heads over 2 KV heads, the cache filled with draws, the sequence over
    "model") by its logits, relative L2; and the hybrid with 6 heads at
    windows of SEQ / 2 (the banded form) and SEQ / 4 (the block-local
    form), forward and backward, by its largest per-tensor gradient error
    (``mesh_grads.check``)."""
    import dataclasses

    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor

    import mesh_grads
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import distribute, tree_shardings

    mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    out = {}
    hybrid = dataclasses.replace(get_config("recurrentgemma_2b").smoke(), n_heads=6)
    for name, window in (("banded", SEQ // 2), ("windowed", SEQ // 4)):
        cfg = dataclasses.replace(hybrid, local_window=window)
        out[name] = mesh_grads.check(cfg, _batches(cfg, 1)[0], "cpu", [mesh], readings=False)["readings"]["1x4"]["sound"][:2]
    cfg = dataclasses.replace(get_config("llama3_8b").smoke(), n_heads=8, n_kv_heads=2)
    params = models.init(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(5)
    cache = {k: torch.randn(v.shape, generator=gen) for k, v in models.init_cache(cfg, BATCH, SEQ, "cpu").items()}
    token = torch.randint(0, cfg.vocab_size, (BATCH,), generator=gen)
    want, _ = models.decode_step(cfg, params, {k: v.clone() for k, v in cache.items()}, token, SEQ // 2)
    dparams = distribute(params, tree_shardings(params, models.param_axes(cfg), mesh), mesh, src_data_rank=None)
    dcache = distribute(cache, tree_shardings(cache, models.decode_cache_axes(cfg), mesh), mesh, src_data_rank=None)
    dtoken = distribute_tensor(token, mesh, [Replicate(), Replicate()], src_data_rank=None)
    got, _ = models.decode_step(cfg, dparams, dcache, dtoken, SEQ // 2)
    out["decode"] = _rel(got.full_tensor().numpy(), want.numpy())
    out["cache_placements"] = [str(p) for p in dcache["blocks/L0/k"].placements]
    return out
