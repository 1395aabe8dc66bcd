"""Contraction plans and the plan-cached contraction engine."""
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
    is ``None``: there is no persistent store before ROADMAP Queue 1 #11.
    """
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
        "plan_store": None,
    }
    if engines:
        out["engines"] = [e.stats() for e in engines]
    return out
