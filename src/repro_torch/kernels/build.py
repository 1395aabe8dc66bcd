"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``.cu`` source exposes a plain C interface (no PyTorch headers), so it
is compiled by one ``nvcc`` call.  Libraries go to ``build/torch_ext/`` at
the root of the checkout, named by a hash of the source, the headers beside
it (``*.cuh``, which it may include) and the flags, so an edited source or
header is rebuilt and an unchanged one is reused; nvcc's and ptxas' output
(registers, spills) is written beside each library as ``.log``.
Nothing is built when a module is imported: the first launch of a kernel
builds it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(source: Path) -> Path:
    text = source.read_bytes() + b"".join(h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{source.stem}-{digest[:16]}.so"


def build(source: Path) -> Path:
    """Compile ``source`` unless it is built already; returns the library."""
    source = Path(source)
    so = library_path(source)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, check=False)
    so.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}")
    os.replace(tmp, so)  # atomic: a reader never sees half a library
    return so


def load_library(source: Path) -> ctypes.CDLL:
    """The built library of ``source``, compiling it first when needed."""
    source = Path(source)
    lib = _loaded.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)))
        _loaded[source] = lib
    return lib
