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
to the CUDA card.  ``--mesh-model`` above 1 (tensor-parallel training)
waits for the port's sharding (ROADMAP Queue 1 #13 item 5) and raises.
Returns the list of losses of the steps it ran.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch


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
    args = ap.parse_args(argv)

    from .. import models
    from ..configs import get_config
    from ..device import resolve_device
    from ..train.checkpoint import CheckpointManager
    from ..train.data import SyntheticLM
    from ..train.optim import OptConfig, init_opt_state
    from ..train.straggler import StepMonitor
    from . import specs

    if args.mesh_model != 1:
        raise NotImplementedError("--mesh-model > 1 (tensor-parallel training) needs the port's sharding, "
                                  "ROADMAP Queue 1 #13 item 5; the port trains on one device")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    oc = OptConfig(lr=args.lr, warmup_steps=args.warmup, total_steps=max(args.steps, 1))

    params = models.init(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    opt = init_opt_state(params)
    data = SyntheticLM(cfg.vocab_size, args.seq_len, args.global_batch, seed=args.seed, device=dev)
    ckpt = CheckpointManager(f"{args.checkpoint_dir}/{cfg.name}", keep=3)
    start_step = 0
    if args.resume == "auto" and ckpt.latest_step() is not None:
        step0, arrays, meta = ckpt.restore(device=dev)
        params = {k[2:]: v for k, v in arrays.items() if k.startswith("p/")}
        opt = {k[2:]: v for k, v in arrays.items() if k.startswith("o/")}
        data.load_state_dict(meta["data"])
        start_step = step0
        print(f"resumed from step {step0}")

    step_fn = specs.make_train_step(cfg, oc, compress=args.compress)
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

    losses = []
    for step in range(start_step, args.steps):
        batch = dict(next(data), **extras)
        mon.start()
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(metrics["loss"])
        rep = mon.stop(step)
        losses.append(loss)
        if rep is not None:
            print(f"straggler@{step}: {rep.seconds:.3f}s vs ewma {rep.ewma:.3f}s (evict={rep.evict})")
        if args.log_every and step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        if args.checkpoint_every and (step + 1) % args.checkpoint_every == 0:
            arrays = {f"p/{k}": v for k, v in params.items()}
            arrays.update({f"o/{k}": v for k, v in opt.items()})
            ckpt.save_async(step + 1, arrays, meta={"data": data.state_dict(), "loss": loss})
    ckpt.wait()
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
