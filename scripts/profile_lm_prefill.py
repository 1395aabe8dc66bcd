"""Where the time of one LM prefill, or one training step, goes on the card,
from a profiler trace.

    python scripts/profile_lm_prefill.py [--arch llama3_8b rwkv6_3b] [--train] [--out chiprun_out/lm_prefill_profile.json]

For each architecture at its full published width and depth (random bf16
weights, as ``chip_smoke.py`` phases 6 and 7): one warm-up prefill of
B=4 x S=2048 through ``make_prefill_step``, then one prefill under
``torch.profiler`` (CPU and CUDA activities).  With ``--train``, one
``make_train_step`` step (AdamW) of B=2 x S=2048 synthetic tokens instead,
at ``chip_smoke.py`` phase 20's depths (llama3_8b 4 layers, rwkv6_3b all
32), after a warm-up step.  Reports the wall time, the device's busy time
(the union of kernel intervals) and idle share, and the kernel time grouped
by kind (the port's own kernels by name, cuBLAS GEMMs, the rest) with the
top kernels.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

BATCH, SEQ = 4, 2048
TRAIN_BATCH, TRAIN_LAYERS = 2, {"llama3_8b": 4}


def kind(name: str) -> str:
    low = name.lower()
    if "flash_bwd" in low:
        return "flash_attention_bwd"
    if "rwkv6_bwd" in low:
        return "rwkv6_scan_bwd"
    if "flash_wgmma" in low or "flash_mma" in low or "flash_simple" in low:
        return "flash_attention"
    if "rwkv6_scan" in low or "rwkv6_chunk" in low or "rwkv6_state" in low:
        return "rwkv6_scan"
    if "gemm" in low or "sm90_xmma" in low or "cutlass" in low or "nvjet" in low:
        return "gemm"
    return "other"


def profile(arch: str, dev, train: bool = False) -> dict:
    import dataclasses

    from torch.profiler import ProfilerActivity, profile as tprofile

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import make_prefill_step, make_train_step
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optim import OptConfig, init_opt_state

    cfg = get_config(arch)
    if train and arch in TRAIN_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS[arch])
    params = models.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    if train:
        batch, data = TRAIN_BATCH, SyntheticLM(cfg.vocab_size, SEQ, TRAIN_BATCH, seed=0, device=dev)
        step, opt = make_train_step(cfg, OptConfig(warmup_steps=1, total_steps=2)), init_opt_state(params)

        def run():
            step(params, opt, next(data))
    else:
        batch = BATCH
        tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=torch.Generator(device=dev).manual_seed(1),
                               device=dev)
        prefill = make_prefill_step(cfg)

        def run():
            prefill(params, {"tokens": tokens})
    run()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_kind, by_name = {}, {}
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        by_kind[kind(e.name)] = by_kind.get(kind(e.name), 0.0) + dur
        by_name[e.name] = by_name.get(e.name, 0.0) + dur
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    del params
    if train:
        del opt
    torch.cuda.empty_cache()
    return dict(arch=arch, train=train, layers=cfg.n_layers, batch=batch, seq=SEQ, wall_ms=wall_us / 1e3,
                kernels=len(kernels),
                device_busy_ms=busy / 1e3, idle_share=(1.0 - busy / wall_us) if kernels else None,
                kernel_ms_by_kind={k: v / 1e3 for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])},
                top_kernels_ms=[(n[:120], v / 1e3) for n, v in top])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+", default=["llama3_8b", "rwkv6_3b"])
    ap.add_argument("--train", action="store_true", help="profile one training step instead of a prefill")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "lm_prefill_profile.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    rec = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi, torch=torch.__version__, runs=[])
    for arch in args.arch:
        row = profile(arch, torch.device("cuda"), args.train)
        print(json.dumps(row))
        rec["runs"].append(row)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=1))
    print(smi)


if __name__ == "__main__":
    main()
