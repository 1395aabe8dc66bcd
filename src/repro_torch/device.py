"""Device resolution shared by the port's entry points.

Entry points (``run_dmrg``, ``DMRGEngine``, ``get_contractor``,
``build_mpo``, ``product_state_mps``, ``convert.*``) take ``device=None``,
which means the CUDA card.  Without one they raise rather than quietly
running on the CPU: a CPU run has to be asked for with ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raising when no card is present), else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
