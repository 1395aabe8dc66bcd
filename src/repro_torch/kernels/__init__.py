"""Hand-written Hopper kernels of the port, one package per TPU kernel.

``LAUNCHES`` counts, per kernel, the launches its wrapper made on the card
(a call that took the plain PyTorch version on the CPU does not count), so a
run can show that its path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = {"block_gemm": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
