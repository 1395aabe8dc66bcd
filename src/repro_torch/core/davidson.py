"""Davidson eigensolver (paper Alg. 1).

Follows the paper's ITensor-derived implementation: no preconditioning,
modified Gram-Schmidt re-orthogonalization with randomization on breakdown,
small subspace (size 2 during production sweeps).  Operates directly on
block-sparse tensors; the matvec is the environment contraction of Fig. 1d.

Each iteration reads the new column of the Rayleigh matrix
M[j, i] = <v_j | A v_i> AND of the Gram matrix W[j, i] = <A v_j | A v_i>
in ONE host sync: the inner products stay 0-d tensors on the device, are
stacked, and cross to the host with a single ``.cpu()``.  The residual norm
comes from the Gram identity ||A x - lam x||^2 = s^T W s - lam^2 without
another sync; below the identity's cancellation floor (about
sqrt(eps)·|lam|) the residual vector's norm is measured instead.

Every value the host decides on crosses through ``host`` (default: a plain
copy to the host).  Under a distributed policy it is the policy's
``host_values``, which gives every rank rank 0's numbers, so the break and
restart decisions agree across ranks (``dist/shard.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..dist import faults
from ..dist.faults import NumericalHealthError
from ..tensor.blocksparse import BlockSparseTensor

GRAM_NOISE_FLOOR = 1e-12   # scale factor for the Gram-identity noise floor
GS_BREAKDOWN_TOL = 1e-12   # Gram-Schmidt breakdown threshold factor


@dataclasses.dataclass
class DavidsonInfo:
    """Health record of one Davidson solve.

    ``converged``: the residual norm dropped below ``tol`` before the
    iteration budget ran out (budget-limited production solves usually stop
    without measuring it, so False there means "unknown").  ``restarts``
    counts Gram-Schmidt breakdowns answered with a seeded random restart;
    ``exhausted`` is set when the restart also broke down and the solve
    accepted the current Ritz pair early.
    """

    converged: bool = False
    iterations: int = 0
    restarts: int = 0
    exhausted: bool = False


HostRead = Callable[[torch.Tensor], np.ndarray]


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _new_columns(V, AV, i, host: HostRead) -> np.ndarray:
    """M[j, i] and W[j, i] for j <= i: one stack on the device, one sync."""
    vals = [V[j].inner(AV[i]) for j in range(i + 1)]
    vals += [AV[j].inner(AV[i]) for j in range(i + 1)]
    return np.real(host(torch.stack(vals)))


def davidson(
    matvec: Callable[[BlockSparseTensor], BlockSparseTensor],
    x0: BlockSparseTensor,
    n_iter: int = 2,
    tol: float = 1e-10,
    seed: int = 0,
    host: Optional[HostRead] = None,
) -> Tuple[float, BlockSparseTensor, DavidsonInfo]:
    """Return (smallest eigenvalue, eigenvector approximation, health info).

    A non-finite Rayleigh-Ritz entry at the per-iteration sync raises
    ``NumericalHealthError(stage="davidson")``.  A restart draws its random
    direction from a ``torch.Generator`` seeded with ``seed + i`` on the
    vector's device.  ``host`` reads a device tensor on the host (see the
    module docstring).
    """
    host = host or _to_host
    info = DavidsonInfo()
    # injected non-convergence: the residual break is suppressed, so the
    # solve runs its full budget and reports converged=False
    force_no_converge = faults.fire("davidson.no_converge") is not None
    x = x0.scale(1.0 / x0.norm())
    V = [x]
    AV = [matvec(x)]
    if n_iter <= 0:
        lam = float(np.real(host(V[0].inner(AV[0]))))
        if not np.isfinite(lam):
            raise NumericalHealthError("non-finite Rayleigh quotient", stage="davidson")
        return lam, x, info

    dim = n_iter + 1
    M = np.zeros((dim, dim))  # <v_j | A v_i>
    W = np.zeros((dim, dim))  # <A v_j | A v_i>
    lam = 0.0

    for i in range(n_iter):
        cols = _new_columns(V, AV, i, host)
        if not np.isfinite(cols).all():
            raise NumericalHealthError(
                f"non-finite Rayleigh-Ritz entries at iteration {i}", stage="davidson"
            )
        info.iterations = i + 1
        M[: i + 1, i] = M[i, : i + 1] = cols[: i + 1]
        W[: i + 1, i] = W[i, : i + 1] = cols[i + 1 :]
        evals, evecs = np.linalg.eigh(M[: i + 1, : i + 1])
        lam, s = float(evals[0]), evecs[:, 0]

        # Ritz vector (device-side; no sync)
        x = V[0].scale(float(s[0]))
        for j in range(1, i + 1):
            x = x + V[j].scale(float(s[j]))
        if i == n_iter - 1:
            break

        # residual q = A x - lam x, its norm from the Gram identity when
        # that is well above the cancellation floor, measured otherwise
        q = AV[0].scale(float(s[0]))
        for j in range(1, i + 1):
            q = q + AV[j].scale(float(s[j]))
        q = q - x.scale(lam)
        qn2_gram = float(s @ W[: i + 1, : i + 1] @ s - lam * lam)
        if qn2_gram > GRAM_NOISE_FLOOR * max(1.0, lam * lam):
            qn = float(np.sqrt(qn2_gram))
        else:
            qn = float(host(q.norm()))
        if qn < tol and not force_no_converge:
            info.converged = True
            break

        # modified Gram-Schmidt vs all v_j, randomize on breakdown (paper)
        for j in range(i + 1):
            q = q - V[j].scale(V[j].inner(q))
        qn2 = float(host(q.norm()))
        if qn2 < GS_BREAKDOWN_TOL * max(qn, 1.0):
            # restart with A·(random), so the new direction lies in range(A)
            info.restarts += 1
            gen = torch.Generator(device=x.device).manual_seed(seed + i)
            q = matvec(BlockSparseTensor.random(x.indices, x.charge, generator=gen, dtype=x.dtype))
            for j in range(i + 1):
                q = q - V[j].scale(V[j].inner(q))
            qn2 = float(host(q.norm()))
            if qn2 < GS_BREAKDOWN_TOL * max(qn, 1.0):
                info.exhausted = True
                break  # subspace exhausted; accept the current Ritz pair
        q = q.scale(1.0 / qn2)
        V.append(q)
        AV.append(matvec(q))

    return lam, x.scale(1.0 / x.norm()), info
