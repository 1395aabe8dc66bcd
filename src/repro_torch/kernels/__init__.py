"""Hand-written Hopper kernels of the port, one package per TPU kernel.

``LAUNCHES`` counts, per kernel, the launches its wrapper made on the card
(a call that took the plain PyTorch version on the CPU does not count), so a
run can show that its path went through the kernels.  ``VARIANT_LAUNCHES``
splits each count by the variant of the kernel that the wrapper launched.
"""
from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = {"block_gemm": 0, "flash_attention": 0, "rwkv6_scan": 0}
VARIANT_LAUNCHES: Dict[str, Dict[str, int]] = {
    "block_gemm": {"tiled_dmma": 0, "tiled_fma": 0, "skinny": 0},
    "flash_attention": {"flash_wgmma": 0, "flash_mma": 0, "flash_simple": 0},
    "rwkv6_scan": {"split4": 0, "split2": 0, "split1": 0},
}


def count_launch(kernel: str, variant: str) -> None:
    """One launch of ``kernel`` by its ``variant``: called by the wrappers
    where they launch, and nowhere else."""
    LAUNCHES[kernel] += 1
    VARIANT_LAUNCHES[kernel][variant] += 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        for variant in VARIANT_LAUNCHES[name]:
            VARIANT_LAUNCHES[name][variant] = 0
