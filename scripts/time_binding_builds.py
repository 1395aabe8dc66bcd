"""Time the two ways of building and binding a port kernel, on the GPU machine.

    python scripts/time_binding_builds.py [--out chiprun_out/binding_builds.json]

Builds ``src/repro_torch/kernels/block_gemm/block_gemm.cu`` twice from
nothing, each into a fresh directory under ``build/``:

  * ``nvcc_ctypes``: the port's own route (``kernels/build.py``), one
    ``nvcc`` call on the plain C interface, loaded with ``ctypes``;
  * ``cpp_extension``: ``torch.utils.cpp_extension.load`` of the same
    ``.cu`` plus a small binding file that includes ``torch/extension.h``.

Each library is then launched once on the same operands and the two results
compared, so both builds are known to work.  Prints one JSON record with
the seconds of each build, the card's name and power limit.  Needs a CUDA
card, ``nvcc`` and (for ``load``) ``ninja``.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

BINDING = r"""
#include <torch/extension.h>
#include <c10/cuda/CUDAStream.h>

extern "C" int block_gemm_launch(int dtype, int route, const void* lhs, const void* rhs, const void* ext,
                                 const void* items, int n_items, const void* fix, const void* tile_fix,
                                 void* ws, void* out, int num_out, int BM, int BK, int BN, void* stream);

torch::Tensor block_gemm(torch::Tensor lhs, torch::Tensor rhs, torch::Tensor items, torch::Tensor fix,
                         torch::Tensor tile_fix, torch::Tensor ws, int64_t route, int64_t num_out) {
  TORCH_CHECK(lhs.is_cuda() && lhs.is_contiguous() && rhs.is_contiguous(), "contiguous CUDA operands");
  TORCH_CHECK(lhs.scalar_type() == torch::kFloat64, "float64 only in this timing binding");
  auto out = torch::empty({num_out, lhs.size(1), rhs.size(2)}, lhs.options());
  int err = block_gemm_launch(0, route, lhs.data_ptr(), rhs.data_ptr(), nullptr, items.data_ptr(),
                              items.size(0), fix.data_ptr(), tile_fix.data_ptr(), ws.data_ptr(), out.data_ptr(),
                              num_out, lhs.size(1), lhs.size(2), rhs.size(2),
                              c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == 0, "block_gemm launch failed: cudaError ", err);
  return out;
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) { m.def("block_gemm", &block_gemm); }
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "binding_builds.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.block_gemm import ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    rec = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi, torch=torch.__version__,
               cuda=torch.version.cuda, ninja=shutil.which("ninja"))
    work = ROOT / "build" / "binding_timing"
    shutil.rmtree(work, ignore_errors=True)

    kbuild.BUILD_DIR = work / "nvcc_ctypes"
    t0 = time.perf_counter()
    kbuild.build(ops.SOURCE)
    rec["nvcc_ctypes_s"] = time.perf_counter() - t0

    from torch.utils.cpp_extension import load

    ext_dir = work / "cpp_extension"
    ext_dir.mkdir(parents=True)
    binding = ext_dir / "binding.cpp"
    binding.write_text(BINDING)
    t0 = time.perf_counter()
    try:
        ext = load(name="block_gemm_timing", sources=[str(binding), str(ops.SOURCE)], build_directory=str(ext_dir),
                   extra_cuda_cflags=["-O3", "-gencode=arch=compute_90a,code=sm_90a"], verbose=False)
        rec["cpp_extension_error"] = None
    except Exception as exc:  # the timing is recorded either way
        ext, rec["cpp_extension_error"] = None, f"{type(exc).__name__}: {exc}"[-2000:]
    rec["cpp_extension_s"] = time.perf_counter() - t0

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    lhs = torch.randn(5, 70, 33, generator=g, device=dev, dtype=torch.float64)
    rhs = torch.randn(5, 33, 45, generator=g, device=dev, dtype=torch.float64)
    out_idx = [0, 0, 1, 2, 2]
    a = ops.block_sparse_matmul(lhs, rhs, out_idx, 3)
    if ext is not None:
        work = ops.work_list(ops.segments(out_idx, 3), None, 70, 33, 45)
        items, fix, tile_fix = work.tables(dev)
        ws = torch.empty((work.n_slots, work.tm, work.tn), dtype=torch.float64, device=dev)
        b = ext.block_gemm(lhs, rhs, items, fix, tile_fix, ws, 0 if work.route == "tiled" else 1, 3)
        torch.cuda.synchronize()
        rec["results_equal"] = bool(torch.equal(a, b))
    print(json.dumps(rec))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
