"""Train a language model of the PyTorch port end to end with the
production trainer (checkpointing, straggler monitor, resume) on the
synthetic pipeline (the counterpart of ``examples/train_lm.py``).

Smoke (a few seconds on the CPU):
    python examples/train_lm_torch.py --device cpu --steps 12

~100M-parameter run (a few hundred steps, sized for one card):
    python examples/train_lm_torch.py --full --steps 300
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--full", action="store_true",
                    help="~100M-param config instead of the smoke config")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--checkpoint-dir", default="artifacts/ckpt",
                    help="where checkpoints are written and resumed from")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.launch.train import main as train_main

    argv2 = ["--arch", args.arch, "--steps", str(args.steps),
             "--checkpoint-every", str(max(args.steps // 3, 1)),
             "--checkpoint-dir", args.checkpoint_dir,
             "--resume", "auto", "--log-every", "10"]
    if args.device:
        argv2 += ["--device", args.device]
    if args.full:
        # ~100M decoder: 12L x 768d via config surgery in-process
        import dataclasses
        from repro_torch.configs import base as cb
        cfg = cb.get_config(args.arch)
        cfg100 = dataclasses.replace(
            cfg, name=cfg.name + "_100m", n_layers=12, d_model=768,
            n_heads=12, n_kv_heads=4, head_dim=64, d_ff=2048,
            vocab_size=32000, dtype="float32")
        cb.register(cfg100)
        argv2[1] = cfg100.name
        argv2 += ["--global-batch", "8", "--seq-len", "512"]
    else:
        argv2 += ["--smoke", "--global-batch", "4", "--seq-len", "128"]
    return train_main(argv2)


if __name__ == "__main__":
    main()
