"""Where the time of a DMRG run goes on the card, from a profiler trace.

    python scripts/profile_dmrg_sweep.py [--algo csr|batched] [--src src] [--out chiprun_out/dmrg_sweep_profile_ALGO.json]

Runs ``chip_smoke.py``'s full-size problem (J1-J2, J2=0.5, on the 8x4
cylinder, f64, ``davidson_iters=2``, one sweep per bond of
(128, 256, 512, 1024, 1024, 1024)) once to warm up, then again under
``torch.profiler`` (CUDA activity only, so the host is not slowed by CPU
tracing).  ``--algo csr`` is the csr path as PRs 11-14 ran it (per-sector
SVD, three-call environment updates); ``--algo batched`` is the planned
pipeline, ``run_dmrg(algo="batched", jit_matvec=True)`` with the
reference's defaults (planned batched SVD, fused environment updates), its
matvec and environment updates replayed as CUDA graphs.  Reports the wall
time and seconds of each sweep (with its SVD and environment seconds and
graph captures and replays), the device's busy time (the union of kernel
intervals) and idle share, the kernel count, kernel time and count by kind
(the block GEMM, the SVD's cuSOLVER kernels, cuBLAS GEMMs, copies and
gathers, reductions, elementwise, the rest) and the top kernels by time.
With ``--algo batched`` it then splits one Davidson solve on the last MPS's
middle bond: the kernels and host time of one graph replay of the matvec
against those of the whole solve (``davidson_iters=2``), the rest being
Davidson's own vector operations.  ``--src`` names the package root to
import ``repro_torch`` from, so one script profiles two trees in one call (a
tree without the batched path takes only ``--algo csr``).  Needs a CUDA
card.
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
    if any(k in low for k in ("gesvd", "gesdd", "syevd", "cusolver", "svd", "orgbr", "jacobi")):
        return "svd"
    if "gemm" in low or "xmma" in low or "cutlass" in low:
        return "cublas_gemm"
    if any(k in low for k in ("copy", "cat", "index", "gather", "scatter", "fill")):
        return "copy_gather"
    if "reduce" in low:
        return "reduce"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def run(dev, algo):
    from repro_torch.core import run_dmrg, spin_system
    from repro_torch.core.mpo import build_mpo, compress_mpo

    space, terms = spin_system(8, 4)
    mpo = compress_mpo(build_mpo(space, terms, 32, device=dev), cutoff=1e-13)
    kw = dict(svd_method="unplanned", jit_env=False) if algo == "csr" else dict(jit_matvec=True)
    t0 = time.perf_counter()
    res = run_dmrg(space, terms, 32, bond_schedule=BONDS, sweeps_per_bond=1, davidson_iters=2,
                   algo=algo, mpo=mpo, device=dev, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, mpo


def device_kernels(fn):
    """(result, kernels launched, their summed device seconds, host seconds)
    of one call of ``fn`` under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
    ks = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, len(ks), sum((e.time_range.end - e.time_range.start) for e in ks) / 1e6, host


def davidson_split(dev, res, mpo):
    """One Davidson solve on the middle bond with the graphed matvec,
    against one replay of that matvec."""
    from repro_torch.core.davidson import davidson
    from repro_torch.core.env import get_contractor, left_edge, right_edge
    from repro_torch.dist.batch import pad_block_sparse

    T, n = res.mps.tensors, len(mpo)
    j = n // 2 - 1
    engine = get_contractor("batched", dev)
    A = left_edge(T[0], mpo[0])
    for i in range(j):
        A = engine.env_update_left(A, T[i], mpo[i])
    B = right_edge(T[n - 1], mpo[n - 1])
    for i in range(n - 2, j, -1):
        B = engine.env_update_right(B, T[i + 1], mpo[i + 1])
    A, Wj, Wj1, B = (pad_block_sparse(t) for t in (A, mpo[j], mpo[j + 1], B))
    x = pad_block_sparse(engine(T[j], T[j + 1], ((2,), (0,))))
    mv = engine.matvec_fn(A, Wj, Wj1, B, jit=True)
    mv(x), mv(x)  # eager, then capture and replay
    _, mv_kernels, mv_device_s, mv_host_s = device_kernels(lambda: mv(x))
    calls = []

    def counted(v):
        calls.append(1)
        return mv(v)

    _, dav_kernels, dav_device_s, dav_host_s = device_kernels(lambda: davidson(counted, x, n_iter=2, seed=j))
    return dict(bond=j, x_blocks=len(x.blocks), matvec_replay=dict(kernels=mv_kernels, device_s=mv_device_s,
                                                                    host_s=mv_host_s),
                davidson=dict(matvec_calls=len(calls), kernels=dav_kernels, device_s=dav_device_s, host_s=dav_host_s),
                davidson_own_kernels=dav_kernels - len(calls) * mv_kernels)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--algo", choices=("csr", "batched"), default="csr")
    ap.add_argument("--src", default=str(ROOT / "src"), help="directory that holds repro_torch")
    ap.add_argument("--out", default=None, help="default chiprun_out/dmrg_sweep_profile_ALGO.json")
    args = ap.parse_args()
    out = Path(args.out or ROOT / "chiprun_out" / f"dmrg_sweep_profile_{args.algo}.json")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    run(dev, args.algo)  # warm-up: kernel builds, cuSOLVER handles
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res, wall, mpo = run(dev, args.algo)
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
    by_kind, count_kind, by_name = {}, {}, {}
    for e in kernels:
        k, dt = kind(e.name), (e.time_range.end - e.time_range.start) / 1e6
        by_kind[k] = by_kind.get(k, 0.0) + dt
        count_kind[k] = count_kind.get(k, 0) + 1
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + dt, c + 1)
    stats = res.sweep_stats
    rec = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi, src=args.src, algo=args.algo, bonds=BONDS,
               wall_s=wall, sweep_s=[s.seconds for s in stats], energies=[s.energy for s in stats],
               svd_s=[s.svd_seconds for s in stats], env_s=[s.env_seconds for s in stats],
               graphs=[getattr(s, "graphs", {}) for s in stats],
               kernels=len(kernels), device_busy_s=busy / 1e6, idle_share=1.0 - busy / 1e6 / wall,
               kernel_s_by_kind=dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
               kernel_count_by_kind=dict(sorted(count_kind.items(), key=lambda kv: -kv[1])),
               top_kernels=[dict(name=n[:120], s=t, count=c)
                            for n, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]])
    if args.algo == "batched":
        rec["davidson_split"] = davidson_split(dev, res, mpo)
    print(json.dumps(rec))
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    print(smi)


if __name__ == "__main__":
    main()
