"""Where the time of a DMRG run goes on the card, from a profiler trace.

    python scripts/profile_dmrg_sweep.py [--src src] [--out chiprun_out/dmrg_sweep_profile.json]

Runs ``chip_smoke.py``'s full-size problem (J1-J2, J2=0.5, on the 8x4
cylinder, f64, ``algo="csr"``, ``davidson_iters=2``, one sweep per bond of
(128, 256, 512, 1024, 1024, 1024)) once to warm up, then again under
``torch.profiler`` (CUDA activity only, so the host is not slowed by CPU
tracing).  Reports the wall time and seconds of each sweep, the device's
busy time (the union of kernel intervals) and idle share, and kernel time
grouped by kind: the block GEMM's kernels, the SVD's (cuSOLVER), the rest.
``--src`` names the package root to import ``repro_torch`` from, so one
script profiles two trees in one call.  Needs a CUDA card.
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
BONDS = (128, 256, 512, 1024, 1024, 1024)


def kind(name: str) -> str:
    low = name.lower()
    if "block_gemm" in low or "tiled_dmma" in low or "tiled_fma" in low or "skinny" in low or "second_pass" in low:
        return "block_gemm"
    if "gesvd" in low or "gesdd" in low or "syevd" in low or "cusolver" in low or "svd" in low or "orgbr" in low:
        return "svd"
    return "other"


def run(dev):
    from repro_torch.core import run_dmrg, spin_system
    from repro_torch.core.mpo import build_mpo, compress_mpo

    space, terms = spin_system(8, 4)
    mpo = compress_mpo(build_mpo(space, terms, 32, device=dev), cutoff=1e-13)
    t0 = time.perf_counter()
    res = run_dmrg(space, terms, 32, bond_schedule=BONDS, sweeps_per_bond=1, davidson_iters=2,
                   algo="csr", mpo=mpo, device=dev)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="directory that holds repro_torch")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "dmrg_sweep_profile.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    run(dev)  # warm-up: kernel builds, cuSOLVER handles
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res, wall = run(dev)
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
    by_kind = {}
    for e in kernels:
        by_kind[kind(e.name)] = by_kind.get(kind(e.name), 0.0) + (e.time_range.end - e.time_range.start) / 1e6
    rec = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi, src=args.src, bonds=BONDS, wall_s=wall,
               sweep_s=[s.seconds for s in res.sweep_stats], energies=[s.energy for s in res.sweep_stats],
               kernels=len(kernels), device_busy_s=busy / 1e6, idle_share=1.0 - busy / 1e6 / wall,
               kernel_s_by_kind=dict(sorted(by_kind.items(), key=lambda kv: -kv[1])))
    print(json.dumps(rec))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=1))
    print(smi)


if __name__ == "__main__":
    main()
