"""Environment engine: plan-cached fused left/right environment updates.

After every pair optimization one site is absorbed into the left or right
environment: three chained block-sparse contractions plus a transpose
(``core/env.extend_left`` / ``extend_right``), and a full right-to-left
rebuild at startup.  Here:

1. an ``EnvironmentPlan`` (``dist/plan.py``, cached by the composite
   structural signature of the (env, site, MPO) triple and the direction)
   chains the three step plans and resolves every intermediate block
   structure, the bra (conjugate) and the final transpose ahead of time;
2. ``EnvironmentEngine.update_left/right`` executes it as ONE fused core,
   ``env_core_body`` — the three ``execute_pairs`` of the reference, the
   conjugation and the transpose — replayed as one CUDA graph per padded
   structure through the engine's ``GraphCache`` (``dist/graphs.py``);
3. operands are power-of-two padded first (``pad_block_sparse``), which is
   exact and quantizes the structure so a graph serves many sites and
   sweeps; the result is sliced back to the true environment structure,
   derived from the site and MPO indices (``env_out_indices``).

Equality: the core runs the three-contraction pipeline's own pair tables in
their own order, so it equals ``extend_left`` / ``extend_right`` block for
block to rounding (<=1e-12, ``tests/test_torch_envcore.py``).

Stacked operands (``serve/stacked.py``: one leading problem axis on every
block) take the same path: the pair products become batched ``matmul``s
(``execute_pairs``), the pads and the transpose leave the problem axis
alone, and the batch size joins the graph key.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import torch

from ..tensor.blocksparse import BlockSparseTensor
from ..tensor.qn import Index
from . import faults, persist
from .batch import batch_shape, execute_pairs, pad_block_sparse, unpad_block_sparse
from .faults import FaultInjected
from .graphs import GraphCache
from .plan import EnvironmentPlan, EnvPlanCache


def env_out_indices(site: BlockSparseTensor, mpo: BlockSparseTensor, side: str) -> Tuple[Index, ...]:
    """The (i', k', l') structure an env update produces, from its operands.

    Left: the site tensor's right index (dualized on the bra side) and the
    MPO's right bond; right: the left ones.  Two unpadded triples may share
    one padded plan, so the unpadded target cannot live on the plan.
    """
    if side == "left":
        return (site.indices[2].dual(), mpo.indices[3], site.indices[2])
    return (site.indices[0].dual(), mpo.indices[0], site.indices[0])


def env_core_body(plan: EnvironmentPlan):
    """All three contractions, the conjugation and the transpose, one
    function of the env, site and MPO blocks (in the plan's sorted key
    order) returning the env blocks in ``plan.out_keys`` order.  Stacked
    blocks keep their leading problem axis in front."""
    p1, p2, p3 = plan.steps
    left = plan.side == "left"

    def body(env_blocks, site_blocks, mpo_blocks):
        e = dict(zip(plan.env_keys, env_blocks))
        t = dict(zip(plan.site_keys, site_blocks))
        w = dict(zip(plan.mpo_keys, mpo_blocks))
        bra = {k: torch.conj(v) for k, v in t.items()}
        if left:
            x = execute_pairs(p3, bra, execute_pairs(p2, execute_pairs(p1, e, t), w))
        else:
            x = execute_pairs(p3, execute_pairs(p2, execute_pairs(p1, t, e), w), bra)
        lead = tuple(range(env_blocks[0].dim() - len(plan.perm)))
        perm = lead + tuple(len(lead) + p for p in plan.perm)
        return tuple(x[k].permute(perm) for k in plan.pre_out_keys)

    return body


class EnvironmentEngine:
    """Executes cached EnvironmentPlans as fused environment updates.

    ``graphs``: the CUDA graph cache the fused core replays through (the
    owning ``ContractionEngine`` passes its own).  ``jit=False`` runs the
    same fused body eagerly instead.  ``pad``: power-of-two pad the
    operands before planning (default).  ``stats()`` reports cumulative
    counters; see its docstring for units.
    """

    def __init__(self, cache: Optional[EnvPlanCache] = None, *, graphs: Optional[GraphCache] = None,
                 jit: bool = True, pad: bool = True, use_kernel: bool = True):
        self.cache = cache if cache is not None else EnvPlanCache()
        self.graphs = graphs if graphs is not None else GraphCache()
        self.jit = jit
        self.pad = pad
        self.use_kernel = use_kernel
        self.env_updates = 0
        self.env_flops = 0.0
        self.env_seconds = 0.0

    def update_left(self, A, T, W, *, mpo_padded: Optional[BlockSparseTensor] = None,
                    spmd_mesh=None) -> BlockSparseTensor:
        """A' = A · T · W · conj(T): absorb site T into the left env.
        ``mpo_padded`` is W already padded (the sweep pads each site once).
        ``spmd_mesh`` (a ("row", "col") DeviceMesh) runs the three
        contractions as SPMD bucket GEMMs over it (``dist/spmd.py``),
        eagerly: collectives are not captured into a graph."""
        return self._update("left", A, T, W, mpo_padded, spmd_mesh)

    def update_right(self, B, T, W, *, mpo_padded: Optional[BlockSparseTensor] = None,
                     spmd_mesh=None) -> BlockSparseTensor:
        """B' = T · W · conj(T) · B: absorb site T into the right env."""
        return self._update("right", B, T, W, mpo_padded, spmd_mesh)

    def _update(self, side, env, T, W, mpo_padded=None, spmd_mesh=None) -> BlockSparseTensor:
        # fault point: an exception out of the fused update, standing in
        # for a capture or launch failure; raised before any work, so the
        # caller's three-call fallback starts from a clean slate
        if faults.fire("env.exception") is not None:
            raise FaultInjected("env.exception", "fused environment update failed")
        t0 = time.perf_counter()
        if self.pad:
            env_p, T_p = pad_block_sparse(env), pad_block_sparse(T)
            W_p = mpo_padded if mpo_padded is not None else pad_block_sparse(W)
        else:
            env_p, T_p, W_p = env, T, W
        plan = self.cache.get(env_p, T_p, W_p, side)
        n_env, n_site = len(plan.env_keys), len(plan.site_keys)
        if spmd_mesh is not None:
            from .spmd import make_spmd_gemm, spmd_env_core_body

            core = spmd_env_core_body(plan, make_spmd_gemm(spmd_mesh, use_kernel=self.use_kernel))
        else:
            core = env_core_body(plan)
        inputs = (
            [env_p.blocks[k] for k in plan.env_keys]
            + [T_p.blocks[k] for k in plan.site_keys]
            + [W_p.blocks[k] for k in plan.mpo_keys]
        )
        if self.jit and spmd_mesh is None:
            def body(_fixed, live, _keep):
                return core(live[:n_env], live[n_env:n_env + n_site], live[n_env + n_site:])

            lead = batch_shape(env_p)

            def prepare():  # the pair tables are host data: nothing to upload or keep
                return [lead + tuple(ix.sector_dim(s) for ix, s in zip(plan.out_indices, k))
                        for k in plan.out_keys], None, None

            key = ("env", plan.signature, lead)
            if key not in self.graphs and persist.active_store() is not None:
                # a structure a plan store can replay before a later run
                persist.note(("env", side, str(inputs[0].dtype).split(".")[-1],
                              tuple(persist.structure_of(t) for t in (env_p, T_p, W_p))), inputs[0].device)
            blocks, _ = self.graphs.run(key, body, prepare, inputs)
        else:
            blocks = core(inputs[:n_env], inputs[n_env:n_env + n_site], inputs[n_env + n_site:])
        out = BlockSparseTensor(plan.out_indices, dict(zip(plan.out_keys, blocks)), plan.out_charge)
        if self.pad:
            out = unpad_block_sparse(out, env_out_indices(T, W, side))
        self.env_updates += 1
        self.env_flops += plan.flops
        self.env_seconds += time.perf_counter() - t0
        return out

    def stats(self) -> Dict:
        """Cumulative environment-stage counters.

        - ``plan_cache``: the EnvPlanCache's counters.
        - ``env_updates``: fused updates executed.
        - ``env_flops``: summed pair-table flops of the executed plans, on
          the padded structure (what runs; an estimate, not a hardware count).
        - ``env_seconds``: host wall-clock per update (pad, plan lookup,
          staging, replay, unpad); the card runs asynchronously, so this is
          mostly enqueue time.
        The graph captures and replays are in the graph cache's stats.
        """
        return {
            "plan_cache": self.cache.stats(),
            "env_updates": self.env_updates,
            "env_flops": self.env_flops,
            "env_seconds": self.env_seconds,
        }
