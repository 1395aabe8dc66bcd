"""DMRG-as-a-service: stacked multi-problem solving + batched serving.

Every problem sharing a charge structure is shape-identical after padding,
so a J/h parameter sweep or a disorder scan batches through ONE pipeline
with a leading problem axis, which the block GEMM folds into its pair axis
(one launch per bucket for the whole batch).  Throughput (problems/sec),
not single-run latency, is the metric.

Three layers, as in the reference (``src/repro/serve``):

- ``stacked`` / ``multicore``: the multi-problem core -- stacked
  block-sparse tensors, batched Davidson / truncated SVD / env updates with
  per-problem host decisions at the existing one-sync points, and
  ``run_dmrg_multi``;
- ``problems`` / ``scheduler``: model registry, structure-signature grouping
  and power-of-two batch slots with a warmup hook;
- ``service``: the async front end -- bounded request queue with
  submit/poll/result, a worker thread draining batch slots, and a structured
  stats endpoint -- exposed as ``python -m repro_torch.serve``.
"""
from .multicore import (
    MultiDavidsonInfo,
    MultiDMRGResult,
    MultiProblemEngine,
    MultiSweepStats,
    StructureMismatch,
    davidson_multi,
    mpo_structure_signature,
    run_dmrg_multi,
    svd_split_multi,
)
from .problems import MODEL_BUILDERS, build_problem, group_key
from .scheduler import BatchScheduler, BatchSlot, ProblemSpec, make_slot
from .service import DEVICE_LOCK, DMRGService, ServeQueueFull
from .stacked import StackedOps, broadcast_tensor, stack_tensors, unstack_tensor

__all__ = [
    "BatchScheduler",
    "BatchSlot",
    "DEVICE_LOCK",
    "DMRGService",
    "MODEL_BUILDERS",
    "MultiDavidsonInfo",
    "MultiDMRGResult",
    "MultiProblemEngine",
    "MultiSweepStats",
    "ProblemSpec",
    "ServeQueueFull",
    "StackedOps",
    "StructureMismatch",
    "broadcast_tensor",
    "build_problem",
    "davidson_multi",
    "group_key",
    "make_slot",
    "mpo_structure_signature",
    "run_dmrg_multi",
    "stack_tensors",
    "svd_split_multi",
    "unstack_tensor",
]
