"""Logical-axis -> mesh-axis resolution, and DTensor placements from it.

Each parameter, cache entry and input dim carries a logical axis name;
``RULES`` lists candidate mesh axes per logical axis in priority order.
Assignment is greedy per tensor with two constraints: a mesh axis is used
at most once per tensor, and the dim size must be divisible by the mesh
axis size (falls through to the next candidate, ultimately to
replication).  This one mechanism expresses TP ("model"), FSDP ("data"),
EP (experts over "model"), DP over "pod", and SP (cache sequence over
"data" when batch can't shard).  The rules and ``spec_for`` are the
reference's (``repro.launch.sharding``), kept here as a copy.

A spec is a tuple with one entry per tensor dim: None (replicated), a mesh
axis name, or a tuple of names (one dim split over several mesh axes, as
``("pod", "data")`` for the batch).  ``placements_for`` turns it into the
DTensor placements of a ``DeviceMesh`` whose ``mesh_dim_names`` are the
axes: ``Shard(d)`` on every mesh dim of more than one rank named at
tensor dim d, ``Replicate`` on the rest (on a mesh dim of one the two hold
the same data, and DTensor moves a replicated dim through reshapes
freely).  A dim named by two mesh dims is split over both in mesh
order, which is the reference's reading of ``P(("pod", "data"))``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

AxisCandidate = Union[str, Tuple[str, ...], None]
Spec = Tuple[AxisCandidate, ...]

# priority-ordered candidates per logical axis
RULES: Dict[str, Sequence[AxisCandidate]] = {
    # weights
    "embed": ["data", None],          # FSDP shard of the "reduction" dim
    "embed2": [None],
    "heads": ["model", None],         # TP
    "kv_heads": ["model", None],
    "ff": ["model", None],
    "expert_ff": ["model", None],
    "expert": ["model", None],        # EP when divisible (64e), else fall back
    "expert_in": [None],
    "vocab": ["model", None],
    "rnn": ["model", None],
    "rnn2": [None],
    "lora": [None],
    "conv": [None],
    "head_dim": [None],
    "hidden": ["model", None],        # activation feature dim
    "layers": [None],                 # the stacked-layer axis stays unsharded
    # activations / inputs
    "batch": [("pod", "data"), ("data",), None],
    "seq": [None],
    "cache_seq": ["data", "model", None],  # SP; "model" when batch takes "data"
    "cache_batch": [("pod", "data"), ("data",), None],
    "frames": [None],
    "patches": [None],
}


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh, or of anything with a ``shape``
    dict (the reference's ``Mesh.shape``)."""
    if isinstance(getattr(mesh, "shape", None), dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(sizes: Dict[str, int], cand: AxisCandidate) -> int:
    if cand is None:
        return 1
    if isinstance(cand, tuple):
        return int(np.prod([sizes[a] for a in cand]))
    return sizes[cand]


def spec_for(shape: Tuple[int, ...], axes: Tuple[str, ...], mesh) -> Spec:
    """The reference's PartitionSpec of a tensor of ``shape`` with logical
    ``axes`` on ``mesh``, as a tuple (one entry per dim)."""
    sizes = mesh_shape(mesh)
    used: set = set()
    out = []
    for dim, ax in zip(shape, axes):
        chosen = None
        for cand in RULES.get(ax, [None]):
            if cand is None:
                break
            names = cand if isinstance(cand, tuple) else (cand,)
            if any(n not in sizes for n in names):
                continue
            if any(n in used for n in names):
                continue
            if dim % _axis_size(sizes, cand) != 0:
                continue
            chosen = cand
            used.update(names)
            break
        out.append(chosen)
    return tuple(out)


def placements_for(spec: Spec, mesh) -> Tuple:
    """DTensor placements on ``mesh`` (a DeviceMesh with named dims) of a
    spec: ``Shard(d)`` on each mesh dim of more than one rank that the
    spec names at tensor dim d, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    sizes = mesh_shape(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for name in entry if isinstance(entry, tuple) else (entry,):
            if name not in names:
                raise ValueError(f"spec {spec} names mesh axis {name!r}, not one of {names}")
            if sizes[name] > 1:  # a mesh dim of one holds the whole tensor: Replicate says so
                out[names.index(name)] = Shard(d)
    return tuple(out)


def sharding_for(shape, axes, mesh) -> Tuple:
    """The placements of a tensor of ``shape`` with logical ``axes``."""
    return placements_for(spec_for(tuple(shape), tuple(axes), mesh), mesh)


def tree_shardings(shapes: Dict, axes: Dict, mesh) -> Dict:
    """Placements per path of a flat dict of tensors (or anything with a
    ``shape``); ``axes``: path -> logical axes."""
    return {k: sharding_for(v.shape, axes[k], mesh) for k, v in shapes.items()}


def distribute(tree: Dict, shardings: Dict, mesh, src_data_rank: Optional[int] = 0) -> Dict:
    """``distribute_tensor`` of every entry onto its placements.  Every rank
    passes the whole tensor; by default rank 0's values are scattered
    (``src_data_rank``), so ranks need not hold equal copies; with None each
    rank keeps its own slice of its own copy, with no communication."""
    from torch.distributed.tensor import distribute_tensor

    return {k: distribute_tensor(v, mesh, shardings[k], src_data_rank=src_data_rank) for k, v in tree.items()}


def batch_axes_for(cfg, shape_kind: str) -> Dict[str, Tuple[str, ...]]:
    """Logical axes for each input-batch tensor of an arch."""
    ax: Dict[str, Tuple[str, ...]] = {
        "tokens": ("batch", "seq"),
        "labels": ("batch", "seq"),
    }
    if cfg.family == "vlm":
        ax["patch_embeds"] = ("batch", "patches", "embed2")
    if cfg.family == "audio":
        ax["enc_embeds"] = ("batch", "frames", "embed2")
    return ax
