"""AdamW + gradient clipping + LR schedules, functional over flat dicts.

Optimizer state is a flat dict mirroring the param dict ("m/<path>",
"v/<path>", "step"), as in the reference.  The moments are float32; the
update is done in float32 and cast back to each parameter's dtype (bf16 on
the card).  Unlike the reference, whose trainer donates parameters and
state to its jitted step (``donate_argnums=(0, 1)``), ``adamw_update``
writes the new parameters and moments into the tensors it is given and
returns them in new dicts: one copy of each lives at a time.

Under a mesh the parameters, gradients and moments are DTensors laid out
alike (the moments take the parameters' logical axes, ``opt_state_axes``,
and the train step redistributes each gradient to its parameter's
placements), so the update is elementwise on each rank's local shards.
``global_norm`` is the norm of the whole gradient: each rank sums the
squares of its shards, each divided by the number of ranks that hold the
same shard, and the sums are added over every mesh dim.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from ..models.common import is_dtensor, like, local_part


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def init_opt_state(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    device = next(iter(params.values())).device
    st = {"step": torch.zeros((), dtype=torch.int32, device=device)}
    for k, v in params.items():
        st[f"m/{k}"] = torch.zeros_like(v, dtype=torch.float32)
        st[f"v/{k}"] = torch.zeros_like(v, dtype=torch.float32)
    return st


def opt_state_axes(axes: Dict) -> Dict:
    out = {"step": ()}
    for k, a in axes.items():
        out[f"m/{k}"] = a
        out[f"v/{k}"] = a
    return out


def lr_at(oc: OptConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio, in float32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(oc.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - oc.warmup_steps) / max(oc.total_steps - oc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return oc.lr * warm * (oc.min_lr_ratio + (1 - oc.min_lr_ratio) * cos)


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The float32 norm of all gradients together, a plain tensor (the same
    on every rank under a mesh)."""
    sharded = [g for g in grads.values() if is_dtensor(g)]
    if not sharded:
        return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))
    if len(sharded) != len(grads):
        raise TypeError("global_norm: the gradients are DTensors and plain tensors mixed")
    from torch.distributed import _functional_collectives as funcol

    mesh = sharded[0].device_mesh
    total = 0.0
    for g in sharded:
        copies = 1
        for i, p in enumerate(g.placements):
            if p.is_partial():
                raise ValueError(f"global_norm takes reduced gradients, got placements {g.placements}")
            copies *= mesh.size(i) if p.is_replicate() else 1
        total = total + torch.sum(torch.square(g.to_local().float())) / copies
    for i in range(mesh.ndim):
        total = funcol.wait_tensor(funcol.all_reduce(total, "sum", (mesh, i)))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(oc: OptConfig, params: Dict, grads: Dict, state: Dict) -> Tuple[Dict, Dict, Dict]:
    """Returns (new_params, new_state, metrics); the parameters and moments
    are updated in place (see the module's docstring)."""
    step = local_part(state["step"]) + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(oc.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(oc, step)
    b1c = 1 - oc.beta1 ** step.float()
    b2c = 1 - oc.beta2 ** step.float()

    new_params, new_state = {}, {"step": like(step, state["step"])}
    for k, p_all in params.items():
        tensors = (p_all, grads[k], state[f"m/{k}"], state[f"v/{k}"])
        if is_dtensor(p_all) and any(t.placements != p_all.placements for t in tensors[1:]):
            raise ValueError(f"adamw_update: {k}'s gradient and moments must be laid out as the parameter "
                             f"{p_all.placements}, got {[t.placements for t in tensors[1:]]}")
        p, g, m, v = (local_part(t) for t in tensors)
        g = g.float() * clip
        m.mul_(oc.beta1).add_(g, alpha=1 - oc.beta1)
        v.mul_(oc.beta2).add_(torch.square(g), alpha=1 - oc.beta2)
        del g
        upd = (m / b1c) / (torch.sqrt(v / b2c) + oc.eps)
        decay = oc.weight_decay if p_all.dim() > 1 else 0.0  # no decay on norms/biases
        pf = p.float()
        p.copy_(pf - lr * (upd + decay * pf))
        new_params[k] = p_all
        new_state[f"m/{k}"] = tensors[2]
        new_state[f"v/{k}"] = tensors[3]
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
