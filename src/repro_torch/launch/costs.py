"""Per-rank costs of one dry-run cell, counted while its step runs on fake
tensors: the counterpart of the reference's ``launch/hlo_costs.py``.

The reference lowers each cell with XLA and parses the compiled,
SPMD-partitioned HLO text: flops of its dots, bytes of its top-level
instructions, ring wire bytes of its collectives, with while-loop trip
counts multiplied in.  The port has no compiled program to parse: its step
is eager PyTorch over DTensors.  So ``CostCounter``, a ``TorchDispatchMode``,
watches the step run on fake tensors (``FakeTensorMode``: shapes and
dtypes, nothing allocated or computed) over a fake process group, and
counts what this rank would run:

* **flops**: each local op's count from ``torch.utils.flop_counter``'s
  formulas (matmuls, attention), the hand-written kernels' own formulas
  included (they are custom ops whose fake implementation stands for the
  launch; ``kernels/*/ops.py``).  DTensor-level ops are not counted: the
  mode passes them on (``NotImplemented``) and counts the local ops that
  DTensor runs on this rank's shards, at local shapes; the global-shape
  ops that DTensor runs on fake tensors to infer output metadata are not
  counted either (``FlopCounterMode`` alone counts both).
* **bytes** (HBM): operand plus result bytes of every local op that moves
  data, as the reference counts each top-level HLO instruction.  Views,
  empty allocations and waits move nothing; an op that is one fused kernel
  on the card (the kernels, a matmul) counts once; elementwise chains
  count each op, as an unfused eager step runs them.
* **collective wire bytes** by type, from the functional collectives that
  DTensor issues (``_c10d_functional.*``), with the reference's ring
  multipliers on the result bytes R over a group of G ranks: all-gather
  R(G-1)/G, all-reduce 2R(G-1)/G, reduce-scatter R(G-1), all-to-all
  R(G-1)/G.  Each collective's seconds take NVLink's rate when its group
  lies inside one node (``HW["node_gpus"]`` consecutive ranks) and the
  inter-node rate otherwise.  A CPU mesh (the dry run's) has no all-to-all
  in DTensor's redistribution, which moves a shard between dims by an
  all-gather and a slice; that all-gather is what is counted.
* **peak bytes**: the largest sum of live storages that the step's local
  ops allocated (a storage lives until the last tensor on it is freed, the
  saved activations of autograd included), on top of the cell's
  arguments (this rank's shards of parameters, moments and batch).

Everything is per rank: rank 0 of the fake world, whose shards are as large
as any (every mesh dim here divides its dims, or the dim replicates).
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")

_FUNCOL = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# ops that move no data: metadata, allocation without a fill, waits
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided", "detach", "alias",
               "lift_fresh", "wait_tensor", "_local_scalar_dense"}


def wire_bytes(kind: str, result_bytes: float, group: int) -> float:
    """The reference's ring-model wire bytes per rank of one collective."""
    if group <= 1 and kind != "collective-permute":
        return 0.0
    if kind == "all-gather" or kind == "all-to-all":
        return result_bytes * (group - 1) / group
    if kind == "all-reduce":
        return 2.0 * result_bytes * (group - 1) / group
    if kind == "reduce-scatter":
        return result_bytes * (group - 1)
    return float(result_bytes)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


class CostCounter(TorchDispatchMode):
    """Counts this rank's flops, bytes, collective wire bytes and seconds
    and live bytes while active (see the module docstring).  ``hw`` holds
    the interconnect rates (``launch.mesh.HW``)."""

    def __init__(self, hw: Dict):
        super().__init__()
        self.hw = hw
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = {c: 0.0 for c in COLLECTIVES}
        self.coll_count = 0
        self.coll_s = 0.0
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, list] = {}  # storage -> [bytes, tensors on it]
        self._hidden = 0

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # counted as the local ops DTensor runs
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._hidden:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        from torch.utils.flop_counter import flop_registry

        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns == "prim":
            return
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs, out_val=out))
        if ns == "_c10d_functional" and name in _FUNCOL:
            self._collective(_FUNCOL[name], args, out)
        if not func.is_view and name not in _NO_TRAFFIC:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))) + sum(_nbytes(t) for t in _tensors(out))
        for t in _tensors(out):
            self._track(t)

    def _collective(self, kind, args, out):
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group

        group = _resolve_process_group(args[-1])
        ranks = dist.get_process_group_ranks(group)
        wire = wire_bytes(kind, sum(_nbytes(t) for t in _tensors(out)), len(ranks))
        node = self.hw["node_gpus"]
        inside = len({r // node for r in ranks}) == 1
        self.coll[kind] += wire
        self.coll_count += 1
        self.coll_s += wire / (self.hw["nvlink_bw"] if inside else self.hw["internode_bw"])

    # ----------------------------------------------------------- liveness
    def exclude(self, tree):
        """Count the storages of ``tree``'s local tensors (the cell's
        arguments) as held outside the step: ops that write or view them
        allocate nothing."""
        from torch.distributed.tensor import DTensor

        for t in _tensors(tree):
            key = _storage_key(t.to_local() if isinstance(t, DTensor) else t)
            if key is not None:
                self._storages[key] = [0, float("inf")]

    def _track(self, t: torch.Tensor):
        key = _storage_key(t)
        if key is None:
            return
        entry = self._storages.get(key)
        if entry is None:
            size = t.untyped_storage().nbytes()
            entry = self._storages[key] = [size, 0]
            self.live += size
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key):
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    @contextlib.contextmanager
    def hiding_metadata_propagation(self):
        """Leave uncounted the ops that DTensor's sharding propagation runs
        on global-shape fake tensors to infer an output's metadata."""
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        inner = ShardingPropagator._propagate_tensor_meta_non_cached

        def hidden(prop, op_schema):
            self._hidden += 1
            try:
                return inner(prop, op_schema)
            finally:
                self._hidden -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = hidden
        try:
            yield self
        finally:
            ShardingPropagator._propagate_tensor_meta_non_cached = inner

    def totals(self) -> Dict:
        coll = dict(self.coll)
        coll["count"] = self.coll_count
        coll["total"] = sum(self.coll[c] for c in COLLECTIVES)
        return dict(flops=self.flops, bytes=self.bytes, coll=coll, coll_s=self.coll_s, peak_temp=self.peak)


def local_bytes(tree) -> int:
    """Bytes of this rank's shards (a DTensor's local tensor, or a plain
    tensor whole) of every tensor in ``tree``, each storage once."""
    from torch.distributed.tensor import DTensor

    seen, total = set(), 0
    for t in _tensors(tree):
        lt = t.to_local() if isinstance(t, DTensor) else t
        key = _storage_key(lt)
        if key is None or key not in seen:
            seen.add(key)
            total += lt.untyped_storage().nbytes() if key is not None else _nbytes(lt)
    return total


@contextlib.contextmanager
def counting(hw: Dict):
    """``with counting(HW) as counter:`` count what runs inside."""
    counter = CostCounter(hw)
    with counter.hiding_metadata_propagation(), counter:
        yield counter
