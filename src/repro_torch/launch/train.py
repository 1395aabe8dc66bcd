"""End-to-end training driver with fault tolerance.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b --smoke \
        --steps 100 --checkpoint-every 20 --resume auto --device cpu

The reference's driver (``repro.launch.train``) on one device: the train
step of ``specs.make_train_step`` (flash attention and the RWKV6 scan
forward and backward through the hand-written kernels on the card),
deterministic restorable data, async atomic checkpoints, resume,
straggler monitoring and optional gradient compression with error
feedback.  Weights are random, drawn from a ``torch.Generator`` seeded with
``--seed``; a VLM's patch and Whisper's frame embeddings are zeros, as in
the reference.  ``--layers`` cuts the depth (for a model whose weights,
gradients and float32 moments do not fit the card); ``--device`` defaults
to the CUDA card.  Returns the list of losses of the steps it ran.

Under ``torchrun`` (or with ``--mesh-model`` above 1) every rank trains on
a ``(world // mesh_model, mesh_model)`` mesh over ("data", "model"):
parameters and moments are DTensors placed by their logical axes
(``launch/sharding.py``: FSDP over "data", TP over "model"), every rank
draws the same global batch from the same seeded ``SyntheticLM`` and keeps
its shard, flash attention and the scan run on each rank's local heads,
and a resume re-shards the checkpoint onto the current mesh, which need
not be the one that saved it.  The process group's backend is NCCL on the
card and gloo on the CPU, or where ranks outnumber the cards
(``launch/mesh.backend_for``).

    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --arch llama3_8b --smoke --device cpu --mesh-model 2 --steps 3
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from .sharding import batch_axes_for, distribute, tree_shardings


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--checkpoint-dir", default="artifacts/ckpt")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", default="none", choices=["none", "auto"])
    ap.add_argument("--compress", default=None, choices=[None, "bf16", "int8"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--layers", type=int, default=None, help="decoder layers (default: the config's)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--record", default=None,
                    help="write <DIR>/<rank>.json: each step's seconds, peak device memory, loss and kernel launches")
    args = ap.parse_args(argv)

    from .. import models
    from ..configs import get_config
    from ..device import resolve_device
    from ..train.checkpoint import CheckpointManager
    from ..train.data import SyntheticLM
    from ..train.optim import OptConfig, init_opt_state
    from ..train.straggler import StepMonitor
    from . import specs

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    oc = OptConfig(lr=args.lr, warmup_steps=args.warmup, total_steps=max(args.steps, 1))

    mesh, created = None, False
    if args.mesh_model != 1 or "WORLD_SIZE" in os.environ:
        mesh, dev, created = _mesh(args, dev)
    rank = mesh.get_rank() if mesh is not None else 0

    params = models.init(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    pshard = oshard = bshard = None
    if mesh is not None:
        pshard = tree_shardings(params, models.param_axes(cfg), mesh)
        params = distribute(params, pshard, mesh, src_data_rank=None)  # equal on every rank: no scatter
    opt = init_opt_state(params)
    if mesh is not None:
        oshard = {k: pshard[k[2:]] for k in opt if k != "step"}
    data = SyntheticLM(cfg.vocab_size, args.seq_len, args.global_batch, seed=args.seed, device=dev)
    ckpt = CheckpointManager(f"{args.checkpoint_dir}/{cfg.name}", keep=3, writer=rank == 0)
    start_step = 0
    if args.resume == "auto" and ckpt.latest_step() is not None:
        shardings = None
        if mesh is not None:
            shardings = {f"p/{k}": v for k, v in pshard.items()}
            shardings.update({f"o/{k}": v for k, v in oshard.items()})
        step0, arrays, meta = ckpt.restore(device=dev, mesh=mesh, shardings=shardings)
        params = {k[2:]: v for k, v in arrays.items() if k.startswith("p/")}
        opt = {k[2:]: v for k, v in arrays.items() if k.startswith("o/")}
        data.load_state_dict(meta["data"])
        start_step = step0
        if rank == 0:
            print(f"resumed from step {step0}")

    step_fn = specs.make_train_step(cfg, oc, grad_shardings=pshard, compress=args.compress)
    if args.compress:
        from ..train.compress import init_error_state
        opt.update({f"err/{k}": v for k, v in init_error_state(params).items()})

    mon = StepMonitor()
    extras = {}
    dt = params["embed"].dtype
    if cfg.family == "vlm":
        extras["patch_embeds"] = torch.zeros((args.global_batch, cfg.n_patches, cfg.d_model), dtype=dt, device=dev)
    if cfg.family == "audio":
        extras["enc_embeds"] = torch.zeros((args.global_batch, cfg.enc_seq_len, cfg.d_model), dtype=dt, device=dev)

    losses, steps = [], []
    for step in range(start_step, args.steps):
        if args.record:
            t0 = _step_start(dev)
        batch = dict(next(data), **extras)
        if mesh is not None:  # every rank drew the same global batch: each keeps its shard
            bshard = bshard or tree_shardings(batch, batch_axes_for(cfg, ""), mesh)
            batch = distribute(batch, bshard, mesh, src_data_rank=None)
        mon.start()
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(metrics["loss"])
        rep = mon.stop(step)
        losses.append(loss)
        if args.record:
            steps.append(_step_record(dev, t0, loss, metrics))
        if rep is not None and rank == 0:
            print(f"straggler@{step}: {rep.seconds:.3f}s vs ewma {rep.ewma:.3f}s (evict={rep.evict})")
        if args.log_every and step % args.log_every == 0 and rank == 0:
            print(f"step {step:5d} loss {loss:.4f} gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        if args.checkpoint_every and (step + 1) % args.checkpoint_every == 0:
            arrays = {f"p/{k}": v for k, v in params.items()}
            arrays.update({f"o/{k}": v for k, v in opt.items()})
            ckpt.save_async(step + 1, arrays, meta={"data": data.state_dict(), "loss": loss})
    ckpt.wait()
    if mesh is not None:  # the checkpoint is on disk before any rank reads it
        torch.distributed.barrier()
    if losses and rank == 0:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    if args.record:
        os.makedirs(args.record, exist_ok=True)
        with open(os.path.join(args.record, f"{rank}.json"), "w") as f:
            json.dump(dict(rank=rank, mesh=None if mesh is None else list(mesh.shape), arch=cfg.name,
                           backend=None if mesh is None else torch.distributed.get_backend(),
                           layers=cfg.n_layers, steps=steps, losses=losses), f)
    if created:
        torch.distributed.destroy_process_group()
    return losses


def _step_start(dev) -> float:
    """Zero the launch counts and the peak memory; the step's start time."""
    from .. import kernels

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    return time.perf_counter()


def _step_record(dev, t0, loss, metrics) -> dict:
    """What ``--record`` keeps of one step (its launches counted from just
    before it)."""
    from .. import kernels

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return dict(seconds=time.perf_counter() - t0, loss=loss, grad_norm=float(metrics["grad_norm"]),
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None,
                launches={k: {v: c for v, c in kernels.VARIANT_LAUNCHES[k].items() if c}
                          for k, n in kernels.LAUNCHES.items() if n},
                shapes={k: sorted(s) for k, s in kernels.LAUNCH_SHAPES.items() if s})


def _mesh(args, dev):
    """(the ``(world // mesh_model, mesh_model)`` mesh over ("data",
    "model"), this rank's device, whether this call started the world)."""
    import torch.distributed as dist

    from .mesh import init_world, local_device, make_mesh

    created = not dist.is_initialized()
    init_world(dev.type)
    world = dist.get_world_size()
    if args.mesh_model < 1 or world % args.mesh_model:
        if created:
            dist.destroy_process_group()
        raise ValueError(f"--mesh-model {args.mesh_model} does not divide the world of {world} rank(s); "
                         "start the ranks with torchrun")
    mesh = make_mesh((world // args.mesh_model, args.mesh_model), ("data", "model"), dev.type)
    return mesh, local_device(dev.type), created


if __name__ == "__main__":
    main()
