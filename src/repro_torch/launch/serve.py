"""Batched serving driver: prefill-free cached decode over a request batch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b --smoke \
        --batch 4 --prompt-len 16 --gen-len 32 --device cpu

Feeds each request's prompt tokens through the one-token decode step
(filling the KV or recurrent cache), then greedy-decodes ``gen-len``
tokens.  Weights are random, drawn from ``--seed``; prompts are drawn from a
``torch.Generator`` seeded with ``--seed + 1``; Whisper's cross-attention
cache is primed first from frame embeddings drawn with ``--seed + 2``.
``--layers`` cuts the depth (for a model whose weights do not fit the
card).  ``--device`` defaults to the CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from .. import models
from ..configs import get_config
from ..device import resolve_device
from .specs import make_decode_step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None, help="decoder layers (default: the config's)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = models.init(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    cache = models.init_cache(cfg, args.batch, args.prompt_len + args.gen_len, dev)
    if cfg.family == "audio":
        from ..models.whisper import whisper_prime_cache

        frames = torch.Generator(device=dev).manual_seed(args.seed + 2)
        enc = torch.randn(args.batch, cfg.enc_seq_len, cfg.d_model, generator=frames, device=dev)
        cache = whisper_prime_cache(cfg, params, cache, enc)
    step = make_decode_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # prefill by stepping the prompt through the cache; the first step (cold
    # caches and handles) is timed on its own as well
    t0 = time.perf_counter()
    logits = None
    for t in range(args.prompt_len):
        logits, cache = step(params, cache, prompts[:, t], t)
        if t == 0:
            sync()
            t1 = time.perf_counter()
    out = []
    for t in range(args.gen_len):
        nxt = torch.argmax(logits[:, : cfg.vocab_size], dim=-1)
        out.append(nxt)
        logits, cache = step(params, cache, nxt, args.prompt_len + t)
    sync()
    t2 = time.perf_counter()
    steps = args.prompt_len + args.gen_len
    toks, dt = args.batch * steps, t2 - t0
    gen_tokens = torch.stack(out, dim=1)
    print(f"generated {tuple(gen_tokens.shape)} tokens; {toks} steps in {dt:.3f}s "
          f"({toks / dt:.1f} tok/s decode); first step {t1 - t0:.3f}s, "
          f"then {args.batch * (steps - 1) / (t2 - t1):.1f} tok/s")
    print("sample:", gen_tokens[0, :16].tolist())
    return gen_tokens


if __name__ == "__main__":
    main()
