"""Where the kernel path's LM logits part from the plain path's, layer by layer.

    python scripts/lm_divergence.py [--arch rwkv6_3b llama3_8b] [--out chiprun_out/lm_divergence.json]

For each architecture at its full published width and depth (random bf16
weights from seed 0, prefill tokens B=4 x S=2048 from seed 1, as
``chip_smoke.py`` phases 6 and 7), on the card:

  * ``per_layer``: each layer run by the kernel path on the plain path's
    own input, its update (output - input) against the plain path's update:
    the kernel's error at real activations, with nothing carried over;
  * ``free``: both paths run through all layers, the residual streams'
    distance after each layer: how the per-layer errors grow with depth;
  * ``perturbed``: the plain path run again from an input with one bf16
    rounding of noise (x * (1 + 2^-9 N(0,1))), against the plain path:
    how much depth amplifies a perturbation of that size with no kernel in
    the way;
  * ``float32``: the kernel and plain paths with the weights cast to
    float32, their logits against each other, and each bf16 path's logits
    against the float32 plain logits.

Distances are max |a - b| / max |b|.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

BATCH, SEQ = 4, 2048


def rel(a, b) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()


def embed(cfg, params, tokens):
    from repro_torch.models.common import layer_norm

    x = params["embed"][tokens]
    return layer_norm(x, 1.0 + params["ln0_g"], params["ln0_b"]) if cfg.family == "ssm" else x


def logits(cfg, params, x):
    from repro_torch.models.common import rms_norm
    from repro_torch.models.lm import _head

    return (rms_norm(x, params["ln_f"], cfg.norm_eps) @ _head(cfg, params))[..., : cfg.vocab_size]


def stream(cfg, params, x, use_kernel, positions):
    """The residual stream after every layer (layer 0 = the input)."""
    from repro_torch.models.lm import _apply_layer, _layers

    xs = [x]
    for _, lp in _layers(params, cfg):
        xs.append(_apply_layer(lp, xs[-1], cfg, positions, use_kernel))
    return xs


def diverge(arch: str, dev) -> dict:
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.models.lm import _apply_layer, _layers

    cfg = get_config(arch)
    params = models.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    positions = torch.arange(SEQ, device=dev).expand(BATCH, SEQ)
    x0 = embed(cfg, params, tokens)
    plain = stream(cfg, params, x0, False, positions)
    per_layer = []
    for i, lp in _layers(params, cfg):
        got = _apply_layer(lp, plain[i], cfg, positions, True)
        per_layer.append(rel(got - plain[i], plain[i + 1] - plain[i]))
    kern = stream(cfg, params, x0, True, positions)
    free = [rel(k, p) for k, p in zip(kern[1:], plain[1:])]
    g = torch.Generator(device=dev).manual_seed(2)
    noise = torch.randn(x0.shape, generator=g, device=dev) * 2.0**-9
    pert = stream(cfg, params, (x0.float() * (1 + noise)).to(x0.dtype), False, positions)
    perturbed = [rel(q, p) for q, p in zip(pert[1:], plain[1:])]
    lg_plain, lg_kern, lg_pert = (logits(cfg, params, s[-1]) for s in (plain, kern, pert))
    rec = dict(arch=arch, per_layer=per_layer, free=free, perturbed=perturbed,
               logits_kernel_vs_plain=rel(lg_kern, lg_plain), logits_perturbed_vs_plain=rel(lg_pert, lg_plain),
               argmax_kernel_vs_plain=(lg_kern.argmax(-1) == lg_plain.argmax(-1)).float().mean().item(),
               argmax_perturbed_vs_plain=(lg_pert.argmax(-1) == lg_plain.argmax(-1)).float().mean().item())
    del plain, kern, pert
    params32 = {k: v.float() for k, v in params.items()}
    del params
    torch.cuda.empty_cache()
    x32 = embed(cfg, params32, tokens)
    t_plain = logits(cfg, params32, stream(cfg, params32, x32, False, positions)[-1])
    t_kern = logits(cfg, params32, stream(cfg, params32, x32, True, positions)[-1])
    rec["float32"] = dict(kernel_vs_plain=rel(t_kern, t_plain), bf16_kernel_vs_f32=rel(lg_kern, t_plain),
                          bf16_plain_vs_f32=rel(lg_plain, t_plain))
    del params32
    torch.cuda.empty_cache()
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+", default=["rwkv6_3b", "llama3_8b"])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "lm_divergence.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    rec = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi, runs=[])
    with torch.no_grad():
        for arch in args.arch:
            row = diverge(arch, torch.device("cuda"))
            print(json.dumps(row))
            rec["runs"].append(row)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=1))
    print(smi)


if __name__ == "__main__":
    main()
