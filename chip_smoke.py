"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--out chiprun_out/chip_smoke.json]

Phases (any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi);
  2. kernel vs plain: builds the block GEMM kernel from the sources in the
     checkout and holds it against its plain PyTorch version in f64, f32
     and bf16, with k-tiling, ragged edges and an output block with no pair;
  3. small exact check: 3x2 open J1-J2 through run_dmrg(algo="csr") against
     exact diagonalization and against algo="csr_ref" on the card;
  4. full size: J1-J2 (J2=0.5) on the 8x4 cylinder (32 sites), f64,
     algo="csr", one sweep per entry of BONDS, davidson_iters=2: launch
     counts, per-sweep times and flops, peak memory, then the kernel held
     against its plain version, and timed, on the four matvec contractions
     at the middle bond.  From a product state the bond grows at most
     fourfold per sweep (4, 16, 64, 256, 1024), so the last bond is swept
     three times: the fifth sweep reaches m=1024 and the sixth truncates
     there;
  5. summary lines, then {"ok": true, "device": {...}} as the last line.
Needs a CUDA card; exits non-zero without one, printing no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet, dense, full 700 W power limit
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
TOL = {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 5e-2}
# bond of each sweep of the full-size run (see phase 4 above)
BONDS = (128, 256, 512, 1024, 1024, 1024)


def log(*args):
    print(*args, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple:
    diff = (got.double() - want.double()).abs().max().item()
    scale = max(want.double().abs().max().item(), 1e-300)
    return diff, diff / scale


# ----------------------------------------------------------------- phase 2
def kernel_cases(dev):
    """Kernel vs plain on synthetic operands; returns worst rel err per dtype."""
    from repro_torch.kernels.block_gemm.ops import block_sparse_matmul
    from repro_torch.kernels.block_gemm.ref import block_sparse_matmul_ref

    rng = np.random.default_rng(0)
    # (P, BM, BK, BN, out_idx, num_out): ragged edges, BK over several
    # 16-deep k-tiles, output block 2 with no pair, a 1-pair case
    shapes = [
        (7, 37, 200, 45, [0, 0, 1, 1, 1, 3, 3], 4),
        (5, 130, 33, 70, [0, 1, 1, 2, 2], 4),
        (1, 64, 16, 64, [0], 1),
    ]
    worst = {}
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        for P, BM, BK, BN, oi, O in shapes:
            lhs = torch.from_numpy(rng.standard_normal((P, BM, BK))).to(dev, dtype)
            rhs = torch.from_numpy(rng.standard_normal((P, BK, BN))).to(dev, dtype)
            idx = np.array(oi, np.int64)
            got = block_sparse_matmul(lhs, rhs, idx, O)
            want = block_sparse_matmul_ref(lhs, rhs, idx, O)
            torch.cuda.synchronize()
            err, rel = rel_err(got, want)
            empty = sorted(set(range(O)) - set(oi))
            if empty and got[empty].abs().max().item() != 0.0:
                fail(f"output blocks {empty} with no pair are not zero ({dtype})")
            log(f"  block_gemm {str(dtype)[6:]:8s} P={P} BM={BM} BK={BK} BN={BN} O={O}: max abs err {err:.3e}, rel {rel:.3e}")
            if not rel <= TOL[dtype]:
                fail(f"block_gemm {dtype} rel err {rel:.3e} > {TOL[dtype]}")
            worst[dtype] = max(worst.get(dtype, 0.0), rel)
        # per-pair extents: zero padding beyond each pair's true shape is skipped
        if dtype == torch.float64:
            P, BM, BK, BN, O = 6, 50, 40, 30, 3
            ext = np.array([[50, 40, 30], [10, 40, 30], [50, 5, 30], [50, 40, 7], [1, 1, 1], [33, 17, 29]], np.int32)
            lhs = torch.zeros((P, BM, BK), dtype=dtype, device=dev)
            rhs = torch.zeros((P, BK, BN), dtype=dtype, device=dev)
            for p, (m, k, n) in enumerate(ext):
                lhs[p, :m, :k] = torch.from_numpy(rng.standard_normal((m, k))).to(dev, dtype)
                rhs[p, :k, :n] = torch.from_numpy(rng.standard_normal((k, n))).to(dev, dtype)
            idx = np.array([0, 0, 0, 1, 2, 2], np.int64)
            got = block_sparse_matmul(lhs, rhs, idx, O, extents=torch.from_numpy(ext).to(dev))
            want = block_sparse_matmul_ref(lhs, rhs, idx, O)
            err, rel = rel_err(got, want)
            log(f"  block_gemm float64  with per-pair extents: max abs err {err:.3e}, rel {rel:.3e}")
            if not rel <= TOL[dtype]:
                fail(f"block_gemm extents rel err {rel:.3e}")
            worst[dtype] = max(worst[dtype], rel)
    return worst


# ----------------------------------------------------------------- phase 4
def middle_bond_matvec(engine, res, mpo, dev):
    """Kernel vs plain, timed, on the four matvec contractions at the middle
    bond, with the run's own MPS, MPO and environments."""
    from repro_torch.core.env import extend_right, left_edge, right_edge
    from repro_torch.core.env import extend_left
    from repro_torch.kernels.block_gemm.ops import block_sparse_matmul
    from repro_torch.kernels.block_gemm.ref import block_sparse_matmul_ref

    T = res.mps.tensors
    n = len(T)
    j = n // 2 - 1
    A = left_edge(T[0], mpo[0])
    for i in range(j):
        A = extend_left(A, T[i], mpo[i], engine)
    B = right_edge(T[n - 1], mpo[n - 1])
    for i in range(n - 2, j, -1):
        B = extend_right(B, T[i + 1], mpo[i + 1], engine)
    x = engine(T[j], T[j + 1], ((2,), (0,)))
    steps = [
        ("A.x", lambda x: (A, x, ((2,), (0,)))),
        ("t.Wj", lambda t: (t, mpo[j], ((1, 2), (0, 2)))),
        ("t.Wj1", lambda t: (t, mpo[j + 1], ((4, 1), (0, 2)))),
        ("t.B", lambda t: (t, B, ((4, 1), (1, 2)))),
    ]
    rows, t = [], x
    for name, args in steps:
        a, b, axes = args(t)
        plan = engine.cache.get(a, b, axes)
        lhs, rhs, oi, seg, ext = engine.pack_csr(plan, a, b)
        O = len(plan.csr.out_keys)
        got = block_sparse_matmul(lhs, rhs, oi, O, seg=seg, extents=ext)
        want = block_sparse_matmul_ref(lhs, rhs, oi, O)
        err, rel = rel_err(got, want)
        if not rel <= TOL[torch.float64]:
            fail(f"middle-bond {name}: kernel vs plain rel err {rel:.3e}")
        idx = torch.from_numpy(oi.astype(np.int64)).to(dev)

        def library():
            out = torch.zeros((O, lhs.shape[1], rhs.shape[2]), dtype=lhs.dtype, device=dev)
            return out.index_add_(0, idx, torch.bmm(lhs, rhs))

        fns = dict(
            ms=lambda: block_sparse_matmul(lhs, rhs, oi, O, seg=seg, extents=ext),
            plain_ms=lambda: block_sparse_matmul_ref(lhs, rhs, oi, O),
            library_ms=library,
        )
        runs = {k: [] for k in fns}
        for _ in range(2):  # each the faster of two interleaved runs
            for k, fn in fns.items():
                runs[k].append(time_ms(fn))
        e = plan.csr.extents.astype(np.float64)
        flops = float(np.sum(2.0 * e[:, 0] * e[:, 1] * e[:, 2]))  # = plan.flops_list
        size = lhs.element_size()
        out_elems = float(sum(r * c for r, c in plan.csr.out_rc))
        nbytes = size * (float(np.sum(e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2])) + out_elems) + 4 * (seg.numel() + ext.numel())
        t_ops = flops / PEAK_FLOPS[lhs.dtype] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        row = dict(
            step=name, P=int(lhs.shape[0]), BM=int(lhs.shape[1]), BK=int(lhs.shape[2]), BN=int(rhs.shape[2]), O=O,
            max_abs_err=err, rel_err=rel, **{k: min(v) for k, v in runs.items()}, runs=runs,
            flops_exact=flops, flops_padded=plan.flops_csr, bytes=nbytes,
            bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
            lhs_mb=lhs.numel() * size / 2**20, rhs_mb=rhs.numel() * size / 2**20,
        )
        log("  middle bond " + json.dumps(row))
        rows.append(row)
        t = engine(a, b, axes)
        del lhs, rhs, got, want
    return j, rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "chip_smoke.json"), help="JSON record of the run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import kernels
    from repro_torch.core import run_dmrg, spin_system
    from repro_torch.core.ed import ground_energy
    from repro_torch.core.env import get_contractor
    from repro_torch.core.models import heisenberg_j1j2_terms
    from repro_torch.core.mpo import build_mpo, compress_mpo, mpo_bond_dims
    from repro_torch.core.siteops import spin_half_space
    from repro_torch.kernels.block_gemm.ops import SOURCE
    from repro_torch.kernels.build import build

    # ---- phase 1: device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"phase 1: {name} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    record = {"device": name, "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda}

    # ---- phase 2: build + kernel vs plain
    t0 = time.perf_counter()
    build_log = build(SOURCE).with_suffix(".log").read_text()
    record["build_s"] = time.perf_counter() - t0
    log(f"phase 2: built {SOURCE.name} in {record['build_s']:.1f} s")
    for line in build_log.splitlines():
        if "ptxas info" in line and ("Used" in line or "spill" in line):
            log("  " + line.strip())
    worst = kernel_cases(dev)
    record["kernel_cases_rel_err"] = {str(k)[6:]: v for k, v in worst.items()}

    # ---- phase 3: small exact check
    sp = spin_half_space()
    terms = heisenberg_j1j2_terms(3, 2, 1.0, 0.5, cylinder=False)
    e_ed = ground_energy(sp, terms, 6)
    kw = dict(bond_schedule=(8, 16), davidson_iters=6, device=dev)
    e_csr = run_dmrg(sp, terms, 6, algo="csr", **kw).energy
    e_ref = run_dmrg(sp, terms, 6, algo="csr_ref", **kw).energy
    log(f"phase 3: 3x2 E(csr)={e_csr:.12f} E(ED)={e_ed:.12f} |dE_ED|={abs(e_csr - e_ed):.2e} |dE_ref|={abs(e_csr - e_ref):.2e}")
    if not abs(e_csr - e_ed) <= 1e-8:
        fail(f"3x2 energy {e_csr} vs ED {e_ed}")
    if not abs(e_csr - e_ref) < 1e-10:
        fail(f"3x2 csr {e_csr} vs csr_ref {e_ref}")
    record["small"] = {"e_csr": e_csr, "e_csr_ref": e_ref, "e_ed": e_ed}

    # ---- phase 4: full size
    space, terms = spin_system(8, 4)
    n = 32
    t0 = time.perf_counter()
    mpo = compress_mpo(build_mpo(space, terms, n, device=dev), cutoff=1e-13)
    log(f"phase 4: 8x4 cylinder, MPO bond dims {mpo_bond_dims(mpo)} built in {time.perf_counter() - t0:.1f} s; bonds {BONDS}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run_dmrg(space, terms, n, bond_schedule=BONDS, sweeps_per_bond=1, davidson_iters=2,
                   algo="csr", mpo=mpo, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    sweeps = []
    for m, s in zip(BONDS, res.sweep_stats):
        row = dict(m=m, energy=s.energy, seconds=s.seconds, svd_seconds=s.svd_seconds, env_seconds=s.env_seconds,
                   max_bond=s.max_bond, trunc_err=s.trunc_err, flops_list=s.flops_list, flops_csr=s.flops_csr,
                   davidson_restarts=s.davidson_restarts, davidson_exhausted=s.davidson_exhausted)
        sweeps.append(row)
        log("  sweep " + json.dumps(row))
    log(f"  run {wall:.1f} s, launches {launches}, peak memory {peak_gb:.2f} GiB")
    es = [s["energy"] for s in sweeps]
    if not all(np.isfinite(es)):
        fail(f"non-finite energies {es}")
    if not all(es[i + 1] <= es[i] + 1e-9 for i in range(len(es) - 1)):
        fail(f"sweep energies increase: {es}")
    if any(s["davidson_exhausted"] for s in sweeps):
        fail("a sweep had exhausted Davidson solves")
    if launches["block_gemm"] == 0:
        fail("the full-size run launched no block_gemm kernel")
    engine = get_contractor("csr", dev)
    j, mid = middle_bond_matvec(engine, res, mpo, dev)
    record.update(full_size=dict(bonds=BONDS, sweeps=sweeps, wall_s=wall, launches=launches, peak_gib=peak_gb,
                                 middle_bond=j, matvec_steps=mid))

    # ---- phase 5: summary
    total = lambda k: sum(r[k] for r in mid)
    bound_ops = sum(r["bound_ms"] for r in mid if r["bound_by"] == "operations")
    entry = dict(
        name="block_gemm", route="cuda", source="src/repro_torch/kernels/block_gemm/block_gemm.cu",
        replaces="src/repro/kernels/block_gemm/kernel.py:59", launches=launches["block_gemm"],
        max_abs_err=max(r["max_abs_err"] for r in mid), ms=total("ms"), plain_ms=total("plain_ms"),
        bound_ms=total("bound_ms"), bound_by="operations" if bound_ops >= total("bound_ms") / 2 else "bytes",
        library_ms=total("library_ms"),
    )
    record["kernels"] = [entry]
    record["total_s"] = time.perf_counter() - t_start
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    log("kernels: block_gemm " + " ".join(f"{str(k)[6:]}={v:.2e}" for k, v in worst.items())
        + f" middle-bond-f64={max(r['rel_err'] for r in mid):.2e} (relative)")
    log(f"total {record['total_s']:.1f} s")
    print(json.dumps({"kernels": [entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
