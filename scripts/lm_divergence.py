"""Where the kernel path's LM logits part from the plain path's, layer by layer.

    python scripts/lm_divergence.py [--arch rwkv6_3b llama3_8b qwen15_110b:4] [--out chiprun_out/lm_divergence.json]

For each architecture at its full published width and depth, or at the
depth given after a colon (random bf16 weights from seed 0, a prefill batch
of B=4 x S=2048 positions from seed 1 through ``launch.specs.make_batch``,
as ``chip_smoke.py`` phases 6, 7 and 19; Whisper: 448 tokens), on the card:

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
    against the float32 plain logits; ``row`` the same per token
    (``chip_smoke.py``'s metric: max over tokens of ||a - b|| / ||b||).
    A MoE's kernel-vs-plain pair is read twice: each path on its own
    router (``*_free_routing``), then the plain path on the experts the
    kernel path chose (``moe.routing_tape``), as ``chip_smoke.py`` holds it.

The layer-by-layer parts need a decoder-only stream, so Whisper gets the
float32 part alone.  Distances are max |a - b| / max |b|.  Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

BATCH, SEQ, WHISPER_SEQ = 4, 2048, 448


def rel(a, b) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()


def row_rel(a, b) -> float:
    """max over tokens of ||a - b|| / ||b|| over the vocabulary."""
    return max(((x.double() - y.double()).norm(dim=-1) / y.double().norm(dim=-1).clamp_min(1e-300)).max().item()
               for x, y in zip(a, b))


def logits(cfg, params, x):
    from repro_torch.models.common import rms_norm
    from repro_torch.models.lm import _head

    return (rms_norm(x, params["ln_f"], cfg.norm_eps) @ _head(cfg, params))[..., : cfg.vocab_size]


def stream(cfg, params, x, use_kernel, positions):
    """The residual stream after every layer (layer 0 = the input)."""
    from repro_torch.models.lm import _apply_layer, _layers

    xs = [x]
    for kind, lp in _layers(params, cfg):
        xs.append(_apply_layer(kind, lp, xs[-1], cfg, positions, use_kernel))
    return xs


def diverge(arch: str, dev) -> dict:
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import make_batch
    from repro_torch.models.lm import _apply_layer, _layers, embed_inputs

    name, _, depth = arch.partition(":")
    cfg = get_config(name)
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=int(depth))
    params = models.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    batch = make_batch(cfg, BATCH, WHISPER_SEQ if cfg.family == "audio" else SEQ,
                       torch.Generator(device=dev).manual_seed(1), dev)
    if cfg.family == "audio":
        return dict(arch=name, layers=cfg.n_layers, float32=float32(cfg, params, batch, None, None))
    x0 = embed_inputs(cfg, params, batch["tokens"], batch.get("patch_embeds"))
    positions = torch.arange(x0.shape[1], device=dev).expand(BATCH, x0.shape[1])
    plain = stream(cfg, params, x0, False, positions)
    per_layer = []
    for i, (kind, lp) in enumerate(_layers(params, cfg)):
        got = _apply_layer(kind, lp, plain[i], cfg, positions, True)
        per_layer.append(rel(got - plain[i], plain[i + 1] - plain[i]))
    kern = stream(cfg, params, x0, True, positions)
    free = [rel(k, p) for k, p in zip(kern[1:], plain[1:])]
    g = torch.Generator(device=dev).manual_seed(2)
    noise = torch.randn(x0.shape, generator=g, device=dev) * 2.0**-9
    pert = stream(cfg, params, (x0.float() * (1 + noise)).to(x0.dtype), False, positions)
    perturbed = [rel(q, p) for q, p in zip(pert[1:], plain[1:])]
    lg_plain, lg_kern, lg_pert = (logits(cfg, params, s[-1]) for s in (plain, kern, pert))
    rec = dict(arch=name, layers=cfg.n_layers, per_layer=per_layer, free=free, perturbed=perturbed,
               logits_kernel_vs_plain=rel(lg_kern, lg_plain), logits_perturbed_vs_plain=rel(lg_pert, lg_plain),
               argmax_kernel_vs_plain=(lg_kern.argmax(-1) == lg_plain.argmax(-1)).float().mean().item(),
               argmax_perturbed_vs_plain=(lg_pert.argmax(-1) == lg_plain.argmax(-1)).float().mean().item())
    del plain, kern, pert
    rec["float32"] = float32(cfg, params, batch, lg_plain, lg_kern)
    return rec


def float32(cfg, params, batch, lg_plain, lg_kern) -> dict:
    """The kernel and plain paths' logits with the weights cast to float32
    in place (``params`` is left in float32), against each other, and the
    bf16 paths' logits against the float32 plain ones."""
    from repro_torch import models
    from repro_torch.models.moe import routing_tape

    cut = lambda lg: lg[..., : cfg.vocab_size]
    if lg_plain is None:
        lg_plain = cut(models.forward(cfg, params, batch, use_kernel=False))
        lg_kern = cut(models.forward(cfg, params, batch))
    for k in list(params):
        params[k] = params[k].float()
    torch.cuda.empty_cache()
    t_plain = cut(models.forward(cfg, params, batch, use_kernel=False))
    with routing_tape() as tape:
        t_kern = cut(models.forward(cfg, params, batch))
    out = dict(bf16_kernel_vs_f32=rel(lg_kern, t_plain), bf16_plain_vs_f32=rel(lg_plain, t_plain),
               row=dict(bf16_plain_vs_f32=row_rel(lg_plain, t_plain)))
    if tape:  # MoE: each path on its own router, then the plain path on the kernel path's experts
        out.update(kernel_vs_plain_free_routing=rel(t_kern, t_plain))
        out["row"]["kernel_vs_plain_free_routing"] = row_rel(t_kern, t_plain)
        with routing_tape(replay=tape):
            t_plain = cut(models.forward(cfg, params, batch, use_kernel=False))
    out.update(kernel_vs_plain=rel(t_kern, t_plain))
    out["row"]["kernel_vs_plain"] = row_rel(t_kern, t_plain)
    params.clear()
    torch.cuda.empty_cache()
    return out


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
