"""Hand-written Hopper kernels of the port, one package per TPU kernel.

``LAUNCHES`` counts, per kernel, the launches that ran on the card (a call
that took the plain PyTorch version on the CPU does not count), so a run
can show that its path went through the kernels.  ``VARIANT_LAUNCHES``
splits each count by the variant of the kernel that the wrapper launched.
The backward kernels (``flash_attention_bwd``, ``rwkv6_scan_bwd``) count
one launch per backward call, by variant: flash's ``bwd_mma`` (tensor
cores) or ``bwd_simple`` (CUDA cores), the scan's head dim (``n16/32/64``).

A wrapper counts where it launches.  Inside a CUDA graph capture
(``recording``) a launch is recorded into the graph and does not run, so it
is tallied for the graph instead; each replay of the graph then adds the
graph's tally (``count_replay``, ``dist/graphs.py``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Tuple

VARIANT_LAUNCHES: Dict[str, Dict[str, int]] = {
    "block_gemm": {"tiled_dmma": 0, "tiled_fma": 0, "skinny": 0},
    "flash_attention": {"flash_wgmma": 0, "flash_mma": 0, "flash_simple": 0},
    "rwkv6_scan": {"split4": 0, "split2": 0, "split1": 0},
    "flash_attention_bwd": {"bwd_mma": 0, "bwd_simple": 0},
    "rwkv6_scan_bwd": {"n16": 0, "n32": 0, "n64": 0},
}
LAUNCHES: Dict[str, int] = {name: 0 for name in VARIANT_LAUNCHES}
_RECORDING: Optional[Dict[Tuple[str, str], int]] = None


def count_launch(kernel: str, variant: str) -> None:
    """One launch of ``kernel`` by its ``variant``: called by the wrappers
    where they launch, and nowhere else."""
    if _RECORDING is not None:
        _RECORDING[(kernel, variant)] = _RECORDING.get((kernel, variant), 0) + 1
        return
    LAUNCHES[kernel] += 1
    VARIANT_LAUNCHES[kernel][variant] += 1


@contextlib.contextmanager
def recording() -> Iterator[Dict[Tuple[str, str], int]]:
    """Tally the launches made inside, by (kernel, variant), instead of
    counting them: for a CUDA graph capture, whose kernels run at replay."""
    global _RECORDING
    if _RECORDING is not None:
        raise RuntimeError("kernel launches are already being recorded")
    _RECORDING = tally = {}
    try:
        yield tally
    finally:
        _RECORDING = None


def count_replay(tally: Dict[Tuple[str, str], int]) -> None:
    """Count the launches of one replay of a graph whose capture recorded
    ``tally``."""
    for (kernel, variant), n in tally.items():
        LAUNCHES[kernel] += n
        VARIANT_LAUNCHES[kernel][variant] += n


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        for variant in VARIANT_LAUNCHES[name]:
            VARIANT_LAUNCHES[name][variant] = 0
