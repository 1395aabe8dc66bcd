"""The placement rule that the kernel wrappers follow under a mesh.

A wrapper given DTensors runs its kernel on each rank's local shard.  The
rule is the kernels' own: every operand is laid out by its batch dim and
its head dim.  On each mesh dim the lead operand (flash's q, the scan's r)
is either

- sharded on its batch dim: every operand with a batch dim shards it
  there too, and a per-head operand without one (the scan's u) replicates,
  its gradient a partial sum over the batch shards;
- sharded on its head dim (on one mesh dim at most, evenly): every operand
  shards its head dim there too, or replicates it, and then the rank takes
  the heads that its lead heads read (``local_kv_heads``), its gradient a
  partial sum;
- replicated, with every operand replicated.

A mesh dim of size one holds every operand whole, whatever its placement.

Anything else (a sharded sequence or feature dim, a partial sum, uneven
heads) raises: no wrapper gathers a sharded input to run the kernel on the
whole, or on a mapping of heads that is not the global one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple


def is_fake(x) -> bool:
    """A fake tensor (shapes and dtypes, no data: the dry run's).  The
    wrappers send it down the kernel path whatever its device, where the
    launch is the custom op's fake implementation: nothing is allocated,
    built or launched, and the flop formula counts it."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(x, FakeTensor)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


@dataclasses.dataclass
class MeshPlan:
    grad: Dict[str, Tuple]         # per operand: the placements its local gradient takes
    select: Dict[str, bool]        # per operand: replicated heads to cut to the rank's own
    head_mesh_dim: Optional[int]   # the mesh dim that shards the heads, if any
    head_parts: int = 1            # its size
    head_index: int = 0            # this rank's coordinate on it


def mesh_plan(what: str, lead, others: Dict[str, Tuple], *, batch_dim: int, head_dim: int) -> MeshPlan:
    """The rule above for the DTensor ``lead`` (batch at ``batch_dim``,
    heads at ``head_dim``) and ``others``: name -> (DTensor or None, its
    batch dim or None, its head dim)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(lead, DTensor):
        raise TypeError(f"{what} under a mesh: every operand must be a DTensor, the first is a {type(lead).__name__}")
    mesh = lead.device_mesh
    present = {n: o for n, o in others.items() if o[0] is not None}
    for n, (t, _, _) in present.items():
        if not isinstance(t, DTensor) or t.device_mesh != mesh:
            raise TypeError(f"{what} under a mesh: {n} must be a DTensor on the same mesh as the others")
    grad = {n: [] for n in present}
    select = {n: False for n in present}
    head_mesh_dim = None

    def refuse(i, why):
        placed = ", ".join(f"{n} {tuple(t.placements)}" for n, (t, _, _) in present.items())
        raise ValueError(f"{what} under a mesh: mesh dim {i} ({mesh.mesh_dim_names[i] if mesh.mesh_dim_names else i}) "
                         f"{why}; the kernel takes the batch and the heads sharded, all else replicated "
                         f"(lead {tuple(lead.placements)}, {placed})")

    for i, p in enumerate(lead.placements):
        size = mesh.size(i)
        if size == 1:  # every placement holds the whole tensor on a mesh dim of one
            for n in present:
                grad[n].append(Replicate())
        elif p == Shard(batch_dim):
            for n, (t, bd, _) in present.items():
                q = t.placements[i]
                if bd is not None and q == Shard(bd):
                    grad[n].append(Shard(bd))
                elif bd is None and q.is_replicate():
                    grad[n].append(Partial())
                else:
                    refuse(i, f"shards the batch and {n} is {q}")
        elif p == Shard(head_dim):
            if head_mesh_dim is not None:
                refuse(i, "is a second mesh dim that shards the heads")
            if lead.shape[head_dim] % size:
                refuse(i, f"splits {lead.shape[head_dim]} heads unevenly in {size}")
            head_mesh_dim = i
            for n, (t, _, hd) in present.items():
                q = t.placements[i]
                if q == Shard(hd) and t.shape[hd] % size == 0:
                    grad[n].append(Shard(hd))
                elif q.is_replicate():
                    grad[n].append(Partial())
                    select[n] = True
                else:
                    refuse(i, f"shards the heads and {n} is {q} (of {t.shape[hd]} heads)")
        elif p.is_replicate():
            for n, (t, _, _) in present.items():
                if not t.placements[i].is_replicate():
                    refuse(i, f"replicates the lead operand and {n} is {t.placements[i]}")
                grad[n].append(Replicate())
        else:
            refuse(i, f"places the lead operand as {p}")
    plan = MeshPlan({n: tuple(g) for n, g in grad.items()}, select, head_mesh_dim)
    if head_mesh_dim is not None:
        plan.head_parts = mesh.size(head_mesh_dim)
        plan.head_index = mesh.get_local_rank(head_mesh_dim)
    return plan


def local_kv_heads(h: int, hkv: int, parts: int, index: int) -> Tuple[int, int]:
    """[lo, hi) of the KV heads that query heads [index h/parts, (index+1)
    h/parts) read when query head j reads KV head j // (h / hkv), checked
    to be the local grouped mapping (local query head i reads local KV head
    i // (local count / (hi - lo))); raises where it is not."""
    n_rep, hl = h // hkv, h // parts
    h0 = index * hl
    lo, hi = h0 // n_rep, (h0 + hl - 1) // n_rep + 1
    nk = hi - lo
    if hl % nk or any((h0 + j) // n_rep - lo != j // (hl // nk) for j in range(hl)):
        raise ValueError(f"query heads [{h0}, {h0 + hl}) of {h} read KV heads [{lo}, {hi}) of {hkv} in groups "
                         "that are not even: no local grouped launch computes them")
    return lo, hi


def heads_local(what: str, fn, q, k, v):
    """``fn(q, k, v)`` of attention in the [B, S, H, D] layout (k, v at
    ``Hkv`` heads) on each rank's shard of DTensors q, k, v by the rule
    above: the output is a DTensor laid out as q."""
    plan = mesh_plan(what, q, {"k": (k, 0, 2), "v": (v, 0, 2)}, batch_dim=0, head_dim=2)
    if plan.select["k"] != plan.select["v"]:
        raise ValueError(f"{what} under a mesh: k {k.placements} and v {v.placements} must share placements")
    kl, vl = k.to_local(grad_placements=plan.grad["k"]), v.to_local(grad_placements=plan.grad["v"])
    if plan.select["k"]:
        lo, hi = local_kv_heads(q.shape[2], k.shape[2], plan.head_parts, plan.head_index)
        kl, vl = kl[:, :, lo:hi].contiguous(), vl[:, :, lo:hi].contiguous()
    return from_local_like(fn(q.to_local(), kl, vl), q)


def from_local_like(local, ref, *, dims: Optional[Sequence[Optional[int]]] = None, shape=None):
    """``local`` (a rank's kernel output, made contiguous) as a DTensor on ``ref``'s mesh:
    with ``ref``'s placements, each ``Shard(d)`` moved to ``Shard(dims[d])``
    when ``dims`` maps ``ref``'s dims to the output's; global ``shape``
    defaults to ``ref``'s."""
    from torch.distributed.tensor import DTensor, Shard

    placements = tuple(p if dims is None or not isinstance(p, Shard) else Shard(dims[p.dim]) for p in ref.placements)
    shape = tuple(ref.shape) if shape is None else tuple(shape)
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(local.contiguous(), ref.device_mesh, placements, run_check=False, shape=shape,
                              stride=tuple(reversed(stride)))
