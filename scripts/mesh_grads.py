"""Float32 gradients under a mesh against one device, per tensor: the check
that the kernel wrappers' sharding (``kernels/sharded.py``: a rank's query
heads, the KV heads they read, its shard of the RWKV6 bonus ``u``, the
partial sums of the gradients) computes what one device computes.

Every rank draws the same weights (``--seed``; every ``u``, zero at init,
drawn nonzero so that a wrong slice of it shows) and the same global batch
(``SyntheticLM``, B x S), takes the gradient of every parameter on one
device (whole tensors, each rank its own) and on each mesh of ``--meshes``
(DTensors placed by their logical axes, the kernels on local shards), and
compares its shard of each mesh gradient with the same slice of the
one-device gradient: ``||got - want|| / ||want||`` per tensor (for a tensor
whose gradient is zero in exact arithmetic, as a key bias's is, against
1e-3 of the whole gradient's norm), the largest over tensors and ranks.

Besides that sound reading it takes, on the first mesh, the control (the
weights in bf16 on the mesh, against the float32 gradients), and on each
mesh the planted faults of ``FAULTS`` that its layout reaches, each a
wrapper given one wrong slice; a limit that tells a sound mesh from a
faulty one sits between the sound reading and all of these.  Beside them,
not held to anything, bf16's own scale: the control against one device's
bf16 gradients, and those against the float32 ones.

    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        scripts/mesh_grads.py --arch rwkv6_3b --smoke --device cpu --out /tmp/grads

Each rank writes ``OUT/<rank>.json``; ``scripts/mesh_runs.py`` runs this
check as a ``grads`` group beside the train CLI's runs.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

# planted faults: what each changes, and what must split for it to act
# (the heads over "model" or the batch over "data")
FAULTS = {
    "kv_heads": ("each rank's KV heads cut from the first rank's place: the offset forgotten", "heads", "attn"),
    "u_heads": ("each rank's shard of u shifted by one head", "heads", "ssm"),
    "u_partial": ("u's gradient left a per-rank share where it sums over the batch shards", "batch", "ssm"),
}


@contextlib.contextmanager
def planted(fault):
    """The wrappers with ``fault`` (a key of ``FAULTS``, or None) in place."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rwkv6_scan import ops as scan_ops

    saved = {}
    if fault == "kv_heads":
        inner = flash_ops.heads_local
        saved[flash_ops, "heads_local"] = inner

        def first(t, n):  # the first n of t's heads, over this rank's batch shard
            whole = [Replicate() if p == Shard(2) else p for p in t.placements]
            return t.redistribute(t.device_mesh, whole).to_local()[:, :, :n].contiguous()

        flash_ops.heads_local = lambda what, fn, q, k, v: inner(
            what, lambda a, b, c: fn(a, first(k, b.shape[2]), first(v, c.shape[2])), q, k, v)
    elif fault == "u_heads":
        inner = scan_ops.rwkv6_wkv
        saved[scan_ops, "rwkv6_wkv"] = inner

        def shifted(r, k, v, logw, u, **kw):  # the wrapper's call on a rank's local shards
            from repro_torch.kernels.sharded import is_dtensor

            return inner(r, k, v, logw, u if is_dtensor(r) else u.roll(1, 0).contiguous(), **kw)

        scan_ops.rwkv6_wkv = shifted
    elif fault == "u_partial":
        inner = scan_ops.mesh_plan
        saved[scan_ops, "mesh_plan"] = inner

        def plan(*args, **kw):
            p = inner(*args, **kw)
            if "u" in p.grad:
                p.grad["u"] = tuple(Replicate() if isinstance(q, Partial) else q for q in p.grad["u"])
            return p

        scan_ops.mesh_plan = plan
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}; one of {sorted(FAULTS)}")
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def weights(cfg, dev, seed: int):
    """The seed's float32 weights, every RWKV6 bonus ``u`` drawn nonzero."""
    import torch

    from repro_torch import models

    params = models.init(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    for k, v in params.items():
        if k.endswith("/u"):
            params[k] = 0.5 * torch.randn(v.shape, generator=gen, device=dev, dtype=v.dtype)
    return params


def shard_errors(got, want, floor: float):
    """{path: ||got - want|| / max(||want||, floor)} over this rank's shard
    of each DTensor gradient in ``got`` and the same slice of the whole
    ``want``, the largest over ranks (one all-reduce)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    keys = sorted(want)
    vals = []
    for k in keys:
        g = got[k]
        w = distribute_tensor(want[k], g.device_mesh, g.placements, src_data_rank=None).to_local()
        g = g.to_local().float()
        vals.append(float((g - w).norm()) / max(float(w.norm()), floor))
    dev = "cpu" if dist.get_backend() == "gloo" else torch.device("cuda", torch.cuda.current_device())
    t = torch.tensor(vals, dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return dict(zip(keys, t.tolist()))


def worst(errs):
    key = max(errs, key=errs.get)
    return errs[key], key


def check(cfg, batch, dev, meshes, *, seed: int = 0, readings=True) -> dict:
    """The sound reading on each of ``meshes`` (DeviceMeshes over ("data",
    "model")); with ``readings`` also the bf16 control on the first and
    every planted fault each mesh's layout reaches: {"readings": {mesh
    label: {reading: [largest error, its tensor, seconds]}}}, and with
    ``readings`` "bf16": {"mesh_vs_one_device": ..., "one_device_vs_float32":
    ...} ([largest error, its tensor] each)."""
    import torch

    from repro_torch import models
    from repro_torch.launch.sharding import batch_axes_for, distribute, tree_shardings
    from repro_torch.launch.specs import loss_and_grads

    cfg = dataclasses.replace(cfg, dtype="float32")
    params = weights(cfg, dev, seed)
    _, want = loss_and_grads(cfg, params, batch)
    want = {k: v.detach() for k, v in want.items()}
    floor = 1e-3 * float(torch.sqrt(sum((v.float() ** 2).sum() for v in want.values())))
    kind = "ssm" if cfg.family == "ssm" else "attn"
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    out = {"readings": {}}
    if readings:
        _, want_bf = loss_and_grads(bf, {k: v.bfloat16() for k, v in params.items()}, batch)
        want_bf = {k: v.detach().float() for k, v in want_bf.items()}
        out["bf16"] = {"one_device_vs_float32": list(worst(
            {k: float((want_bf[k] - want[k]).norm()) / max(float(want[k].norm()), floor) for k in want}))}
    for i, mesh in enumerate(meshes):
        pshard = tree_shardings(params, models.param_axes(cfg), mesh)
        dparams = distribute(params, pshard, mesh, src_data_rank=None)
        dbatch = distribute(batch, tree_shardings(batch, batch_axes_for(cfg, ""), mesh), mesh, src_data_rank=None)
        split = {"heads": mesh.size(1) > 1, "batch": mesh.size(0) > 1}
        runs = [("sound", cfg, dparams, None)]
        if readings and i == 0:
            runs.append(("control_bf16", bf, {k: v.bfloat16() for k, v in dparams.items()}, None))
        if readings:
            runs += [(f"fault_{f}", cfg, dparams, f) for f, (_, needs, fam) in FAULTS.items() if fam == kind and split[needs]]
        rec = {}
        for name, c, p, fault in runs:
            t0 = time.perf_counter()
            with planted(fault):
                _, got = loss_and_grads(c, p, dbatch)
            err, key = worst(shard_errors(got, want, floor))
            rec[name] = [err, key, time.perf_counter() - t0]
            if name == "control_bf16":
                out["bf16"]["mesh_vs_one_device"] = list(worst(shard_errors(got, want_bf, floor)))
            del got
        out["readings"]["x".join(map(str, mesh.shape))] = rec
        del dparams, dbatch
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--layers", type=int, default=None, help="decoder layers (default: the config's)")
    ap.add_argument("--global-batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--meshes", default="1x2,2x1", help="comma-separated data x model shapes over the world")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--out", required=True, help="write OUT/<rank>.json")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import init_world, local_device, make_mesh
    from repro_torch.train.data import SyntheticLM

    dev = resolve_device(args.device)
    created = not dist.is_initialized()
    init_world(dev.type)
    dev = local_device(dev.type)
    cfg = get_config(args.arch)
    cfg = cfg.smoke() if args.smoke else cfg
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    meshes = [make_mesh(tuple(int(x) for x in s.split("x")), ("data", "model"), dev.type)
              for s in args.meshes.split(",")]
    batch = next(SyntheticLM(cfg.vocab_size, args.seq_len, args.global_batch, seed=args.seed + 1, device=dev))
    t0 = time.perf_counter()
    rec = dict(arch=cfg.name, layers=cfg.n_layers, batch=[args.global_batch, args.seq_len],
               **check(cfg, batch, dev, meshes, seed=args.seed))
    rec["seconds"] = time.perf_counter() - t0
    if dev.type == "cuda":
        rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        torch.cuda.empty_cache()
    rank = dist.get_rank()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{rank}.json"), "w") as f:
        json.dump(rec, f)
    if created:
        dist.destroy_process_group()
    return rec


if __name__ == "__main__":
    main()
