"""Serve a small model of the PyTorch port with batched requests through
the cached decode path (the counterpart of ``examples/serve_lm.py``).

    python examples/serve_lm_torch.py --arch recurrentgemma_2b
    python examples/serve_lm_torch.py --arch rwkv6_3b --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.launch.serve import main as serve_main

    argv2 = ["--arch", args.arch, "--smoke",
             "--batch", str(args.batch),
             "--prompt-len", str(args.prompt_len),
             "--gen-len", str(args.gen_len)]
    if args.device:
        argv2 += ["--device", args.device]
    return serve_main(argv2)


if __name__ == "__main__":
    main()
