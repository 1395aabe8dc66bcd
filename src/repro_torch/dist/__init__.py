"""Contraction plans, the plan-cached contraction engine, the distributed
path (``shard``: ``BlockShardPolicy`` and ``make_block_mesh``; ``spmd``: the
split bucket GEMM) and the persistent plan store (``persist.PlanStore``).

Those names resolve at first use: ``tensor/blocksparse`` imports from this
package, so its import cannot pull in the plan modules."""
from __future__ import annotations

from typing import Dict


def _summed(caches) -> Dict[str, int]:
    out = {"hits": 0, "misses": 0, "evictions": 0, "builds": 0, "size": 0}
    for cache in caches:
        for k, v in cache.stats().items():
            out[k] += v
    return out


def cache_stats(*engines) -> dict:
    """The plan caches' hit, miss, eviction, build and size counters, with
    the keys of the reference's ``repro.dist.cache_stats``, plus each passed
    engine's ``stats()`` under ``"engines"``.

    The port keeps its plan caches per ``ContractionEngine`` (the reference
    has three process-wide ones), so ``plan_cache``, ``decomp_plan_cache``
    and ``env_plan_cache`` sum the contraction, decomposition and
    environment caches of the engines passed, each cache once (an engine's
    environment stage has a contraction cache of its own, counted under
    ``plan_cache``); with no engine every counter is zero.  ``plan_store``
    is the active plan store's ``stats()``, or ``None`` without one.
    """
    from .persist import store_stats

    contraction, decomp, env = {}, {}, {}
    for e in engines:
        for c in (e.cache, e.env.cache.contraction_cache):
            contraction[id(c)] = c
        decomp[id(e.decomp.cache)] = e.decomp.cache
        env[id(e.env.cache)] = e.env.cache
    out = {
        "plan_cache": _summed(contraction.values()),
        "decomp_plan_cache": _summed(decomp.values()),
        "env_plan_cache": _summed(env.values()),
        "plan_store": store_stats(),
    }
    if engines:
        out["engines"] = [e.stats() for e in engines]
    return out



_LAZY = {"BlockShardPolicy": "shard", "make_block_mesh": "shard", "PlanStore": "persist",
         "activate_store": "persist", "deactivate_store": "persist", "active_store": "persist",
         "using_store": "persist", "store_stats": "persist", "spmd_stats": "spmd"}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(f".{_LAZY[name]}", __name__)
    return mod.stats if name == "spmd_stats" else getattr(mod, name)
