"""How often ``torch.linalg.svd`` synchronizes the host with the card.

    python scripts/svd_syncs.py

The planned decomposition (``dist/decomp.py``) means to sync once per
split, at the singular values' read; it calls ``torch.linalg.svd`` once
per shape bucket, the per-sector loop once per sector.  For stacks of the
shapes a split meets, and each CUDA driver (the default, "gesvdj",
"gesvd"), this counts the synchronizing calls one ``torch.linalg.svd``
makes (``torch.cuda.set_sync_debug_mode("warn")``), its host and total
milliseconds, and its singular values' distance from LAPACK's on the CPU.
Needs a CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import time
import warnings

import torch

SHAPES = ((4, 24, 24), (3, 200, 300), (1, 700, 900))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    g = torch.Generator(device=dev).manual_seed(0)
    for shape in SHAPES:
        a = torch.randn(shape, generator=g, dtype=torch.float64, device=dev)
        want = torch.linalg.svd(a.cpu(), full_matrices=False)[1]
        for driver in (None, "gesvdj", "gesvd"):
            torch.linalg.svd(a, full_matrices=False, driver=driver)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                s = torch.linalg.svd(a, full_matrices=False, driver=driver)[1]
                t1 = time.perf_counter()
            torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            print(json.dumps(dict(shape=shape, driver=driver, syncs=len(caught), host_ms=(t1 - t0) * 1e3,
                                  total_ms=(t2 - t0) * 1e3, s_err=(s.cpu() - want).abs().max().item())))


if __name__ == "__main__":
    main()
