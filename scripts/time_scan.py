"""Time a tree's RWKV6 scan kernel at rwkv6_3b's time-mix shapes (and, with --flash, its flash attention).

    python scripts/time_scan.py [--src src] [--batch 4 1] [--split 4] [--flash] [--scan-bwd] [--out chiprun_out/time_scan.json]

For each batch size: T=2048, H=40, N=64, bf16 r/k/v, float32 log-decay
(-exp of a normal clipped to [-8, 6], the model's range) and bonus, float32
output (what ``time_mix`` asks).  Reports the kernel's mean device time over
20 launches after a warm-up (CUDA events, the faster of two runs), its error
against the plain version (relative to max |value|), and the launches by
variant.  ``--src`` names the directory that holds ``repro_torch`` (as in
``scripts/profile_dmrg_sweep.py``): another checkout's ``src`` (for example
a parent commit unpacked under the gitignored ``build/``) is imported and
its kernels built in its own tree, so two trees can be timed in one call to
the card, one process each.  ``--split`` forces the state kernel's CTAs
per head (1, 2 or 4) in place of the wrapper's pick, for trees that have
the split variants.  ``--flash`` also times the flash-attention forward
as inference calls it (no gradient), causal, B=4, S=2048, bf16, at
llama3_8b's attention (32 query heads, 8 KV heads, D=128), the same heads
at D=64, pixtral_12b's (32/8, D=160) and recurrentgemma_2b's (10/1,
D=256), with its per-row error against the plain version and the variant
the tree launched; then the flash backward kernel alone (``_launch_bwd`` on
the forward's output and lse) at llama3_8b's training shape (B=2, S=2048,
32/8 heads, D=128), with its per-tensor error against autograd through the
plain version and the variant the tree launched.  ``--scan-bwd`` also
times the scan's backward kernel alone (``_launch_bwd``) at rwkv6_3b's
training shape (B=2, T=2048, H=40, N=64, bf16 r/k/v, float32 log-decay
and dout, no initial state), with its per-tensor error against autograd
through the plain version and the variant the tree launched.  Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch


def time_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# (label, H, Hkv, D)
FLASH_SHAPES = (("llama3_8b", 32, 8, 128), ("d64", 32, 8, 64), ("pixtral_12b", 32, 8, 160),
                ("recurrentgemma_2b", 10, 1, 256))


def flash_rows(dev):
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention.ops import flash_attention_bshd

    b, s = 4, 2048
    for label, h, hkv, d in FLASH_SHAPES:
        g = torch.Generator(device=dev).manual_seed(d)
        q = torch.randn(b, s, h, d, generator=g, device=dev).bfloat16()
        k, v = (torch.randn(b, s, hkv, d, generator=g, device=dev).bfloat16() for _ in range(2))
        fn = lambda: flash_attention_bshd(q, k, v)
        before = dict(kernels.VARIANT_LAUNCHES["flash_attention"])
        with torch.no_grad():
            got = fn()
            torch.cuda.synchronize()
            launched = [name for name, c in kernels.VARIANT_LAUNCHES["flash_attention"].items() if c != before[name]]
            want = flash_attention_bshd(q, k, v, use_kernel=False)
            gw, ww = got.reshape(-1, d).double(), want.reshape(-1, d).double()
            runs = [time_ms(fn), time_ms(fn)]
        yield dict(kernel="flash_attention", shape=label, B=b, S=s, H=h, Hkv=hkv, D=d, variant=launched, ms=min(runs),
                   runs=runs, row_rel_err=((gw - ww).norm(dim=1) / ww.norm(dim=1).clamp_min(1e-300)).max().item())
        del q, k, v, got, want, gw, ww
    yield flash_bwd_row(dev)


def flash_bwd_row(dev):
    """The backward kernel alone at llama3_8b's training shape."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops

    b, s, h, hkv, d = 2, 2048, 32, 8, 128
    g = torch.Generator(device=dev).manual_seed(21)
    q = torch.randn(b, s, h, d, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(b, s, hkv, d, generator=g, device=dev).bfloat16() for _ in range(2))
    do = torch.randn(b, s, h, d, generator=g, device=dev).bfloat16()
    o, lse = ops._launch(q, k, v, with_lse=True)
    fn = lambda: ops._launch_bwd(q, k, v, o, lse, do)
    before = dict(kernels.VARIANT_LAUNCHES["flash_attention_bwd"])
    got = fn()
    torch.cuda.synchronize()
    launched = [name for name, c in kernels.VARIANT_LAUNCHES["flash_attention_bwd"].items() if c != before[name]]
    leaves = [a.detach().requires_grad_(True) for a in (q, k, v)]
    want = torch.autograd.grad(ops.flash_attention_bshd(*leaves, use_kernel=False), leaves, do)
    rel = max(((x.double() - y.double()).norm() / y.double().norm()).item() for x, y in zip(got, want))
    del leaves, want
    runs = [time_ms(fn, 10), time_ms(fn, 10)]
    return dict(kernel="flash_attention_bwd", shape="llama3_8b_train", B=b, S=s, H=h, Hkv=hkv, D=d,
                variant=launched, ms=min(runs), runs=runs, rel_l2=rel)


def scan_bwd_row(dev):
    """The scan's backward kernel alone at rwkv6_3b's training shape."""
    from repro_torch import kernels
    from repro_torch.kernels.rwkv6_scan import ops

    b, t, h, n = 2, 2048, 40, 64
    g = torch.Generator(device=dev).manual_seed(22)
    r, k = ((0.5 * torch.randn(b, t, h, n, generator=g, device=dev)).bfloat16() for _ in range(2))
    v = torch.randn(b, t, h, n, generator=g, device=dev).bfloat16()
    logw = -torch.exp(torch.randn(b, t, h, n, generator=g, device=dev).clamp(-8.0, 6.0))
    u = 0.1 * torch.randn(h, n, generator=g, device=dev)
    do = torch.randn(b, t, h, n, generator=g, device=dev)
    fn = lambda: ops._launch_bwd(r, k, v, logw, u, None, do)[:5]
    before = dict(kernels.VARIANT_LAUNCHES["rwkv6_scan_bwd"])
    got = fn()
    torch.cuda.synchronize()
    launched = [name for name, c in kernels.VARIANT_LAUNCHES["rwkv6_scan_bwd"].items() if c != before[name]]
    leaves = [a.detach().requires_grad_(True) for a in (r, k, v, logw, u)]
    out, _ = ops.rwkv6_wkv(*leaves, out_dtype=torch.float32, use_kernel=False)
    want = torch.autograd.grad(out, leaves, do)
    rel = {name: ((x.double() - y.double()).norm() / y.double().norm()).item()
           for name, x, y in zip(("r", "k", "v", "logw", "u"), got, want)}
    del leaves, out, want
    runs = [time_ms(fn, 10), time_ms(fn, 10)]
    return dict(kernel="rwkv6_scan_bwd", shape="rwkv6_3b_train", B=b, T=t, H=h, N=n, variant=launched,
                ms=min(runs), runs=runs, rel_l2=rel, kernels_ms=kernel_split(fn))


def kernel_split(fn, reps: int = 5) -> dict:
    """Device ms per call of each CUDA kernel that ``fn`` launches, from
    torch.profiler (empty where the profiler records no device time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us and "CUDA" in str(getattr(evt, "device_type", "CUDA")):
            out[evt.key[:80]] = us / 1e3 / reps
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"),
                    help="directory that holds repro_torch")
    ap.add_argument("--batch", type=int, nargs="+", default=[4, 1])
    ap.add_argument("--split", type=int, default=None, help="force the state split (1, 2 or 4)")
    ap.add_argument("--flash", action="store_true", help="also time the flash-attention forward")
    ap.add_argument("--scan-bwd", action="store_true", help="also time the scan's backward kernel")
    ap.add_argument("--out", default=None, help="JSON record (default: none)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch import kernels
    from repro_torch.kernels.rwkv6_scan import ops
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_wkv

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    rec = dict(src=str(Path(args.src).resolve()), device=torch.cuda.get_device_name(0), nvidia_smi=smi, runs=[])
    for b in args.batch:
        g = torch.Generator(device=dev).manual_seed(b)
        t, h, n = 2048, 40, 64
        r, k = ((0.5 * torch.randn(b, t, h, n, generator=g, device=dev)).bfloat16() for _ in range(2))
        v = torch.randn(b, t, h, n, generator=g, device=dev).bfloat16()
        logw = -torch.exp(torch.randn(b, t, h, n, generator=g, device=dev).clamp(-8.0, 6.0))
        u = 0.1 * torch.randn(h, n, generator=g, device=dev)
        if args.split is None:
            fn = lambda: rwkv6_wkv(r, k, v, logw, u, out_dtype=torch.float32)
        else:
            fn = lambda: ops._launch(r, k, v, logw, u, None, torch.float32, args.split)
        before = {name: dict(vs) for name, vs in kernels.VARIANT_LAUNCHES.items()}
        got, s_got = fn()
        torch.cuda.synchronize()
        launched = {name: c - before["rwkv6_scan"][name]
                    for name, c in kernels.VARIANT_LAUNCHES["rwkv6_scan"].items() if c != before["rwkv6_scan"][name]}
        want, s_want = rwkv6_wkv(r, k, v, logw, u, out_dtype=torch.float32, use_kernel=False)
        rel = lambda a, w: ((a.double() - w.double()).abs().max() / w.double().abs().max()).item()
        runs = [time_ms(fn), time_ms(fn)]
        row = dict(B=b, T=t, H=h, N=n, split=args.split, ms=min(runs), runs=runs, rel_err=rel(got, want),
                   state_rel_err=rel(s_got, s_want), launches_by_variant=launched)
        print(json.dumps(row), flush=True)
        rec["runs"].append(row)
        del r, k, v, logw, got, want
    for row in flash_rows(dev) if args.flash else ():
        print(json.dumps(row), flush=True)
        rec["runs"].append(row)
    if args.scan_bwd:
        row = scan_bwd_row(dev)
        print(json.dumps(row), flush=True)
        rec["runs"].append(row)
    print(smi)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
