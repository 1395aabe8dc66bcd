"""The port's distributed path (``dist/shard.py``, ``dist/spmd.py``,
``launch/mesh.py``) against the reference's ``repro.dist.spmd`` on the CPU.

In one process (a gloo world of one rank): the split bucket GEMM against
the reference's on a one-device mesh, the pad-overhead fallback, the
program cache, the per-rank chunk arithmetic against the reference's
formulas, an engine contraction and ``run_dmrg(spmd=True)`` against the
reference's list backend, and what the port counts in place of the
reference's compile-once test (no graph is captured under spmd).

In gloo worlds of 2 (1x2) and 4 (2x2) ranks, spawned processes with a
``FileStore`` and a deadline of their own: spmd and storage mode on the
3x2 J1-J2 lattice, energies against the reference's single-process list
run and equal on every rank, and the fallbacks as the reference's rule
counts them.
"""
import json
import os
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro.core.models import heisenberg_j1j2_terms as jax_j1j2  # noqa: E402
from repro.core.siteops import spin_half_space as jax_space  # noqa: E402
from repro.dist import spmd as jspmd  # noqa: E402
from repro.dist.shard import _near_square_factors as jax_near_square  # noqa: E402
from repro.dist.shard import make_block_mesh as jax_block_mesh  # noqa: E402
from repro.tensor.blocksparse import contract as jax_contract  # noqa: E402
from repro_torch.convert import mpo_from_arrays  # noqa: E402
from repro_torch.core import run_dmrg  # noqa: E402
from repro_torch.core.models import heisenberg_j1j2_terms  # noqa: E402
from repro_torch.core.mps import neel_states, product_state_mps  # noqa: E402
from repro_torch.core.siteops import spin_half_space  # noqa: E402
from repro_torch.core.sweep import DMRGEngine  # noqa: E402
from repro_torch.dist import spmd  # noqa: E402
from repro_torch.dist.engine import ContractionEngine  # noqa: E402
from repro_torch.dist.shard import BlockShardPolicy, _near_square_factors, make_block_mesh  # noqa: E402

import _torch_dist_worker  # noqa: E402
from _torch_helpers import assert_blocks_close, to_arrays  # noqa: E402
from test_torch_batch import AX, rand_pair  # noqa: E402

BONDS = (8, 16)
RUN_KW = dict(sweeps_per_bond=1, davidson_iters=4)
# seconds a spawned gloo world may take, start-up included
WORLD_DEADLINE = 240.0


def rand_bucket(seed, p, m, k, n, num_out):
    """Seeded f64 bucket operands as numpy, ``oi`` sorted (the block GEMM's
    contract; the reference's segment sum takes it as well)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((p, m, k)), rng.standard_normal((p, k, n)),
            np.sort(rng.integers(0, num_out, size=p)).astype(np.int32))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tiny CPU GEMMs: a gloo
    collective waits on its own thread, and the sweeps here issue thousands,
    so the cores are left to the other test processes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def mesh():
    """The port's (1, 1) CPU mesh; the process becomes a world of one rank."""
    return make_block_mesh(device="cpu")


class TestSpmdGemm:
    @pytest.mark.parametrize("seed,shape", enumerate([(6, 4, 3, 5, 2), (1, 2, 2, 2, 1), (7, 8, 8, 8, 3)]))
    def test_matches_reference(self, mesh, seed, shape):
        p, m, k, n, o = shape
        lhs, rhs, oi = rand_bucket(seed, p, m, k, n, o)
        got = spmd.spmd_bucket_gemm(torch.from_numpy(lhs), torch.from_numpy(rhs), oi, o, mesh=mesh)
        want = jspmd.spmd_bucket_gemm(lhs, rhs, oi, o, mesh=jax_block_mesh())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)

    def test_fallback_on_pad_overhead(self, mesh):
        lhs, rhs, oi = rand_bucket(0, 3, 4, 4, 5, 2)
        before = spmd.stats()["fallback_calls"]
        jbefore = jspmd.stats()["fallback_calls"]
        got = spmd.spmd_bucket_gemm(torch.from_numpy(lhs), torch.from_numpy(rhs), oi, 2, mesh=mesh,
                                    pad_overhead_limit=0.0)
        want = jspmd.spmd_bucket_gemm(lhs, rhs, oi, 2, mesh=jax_block_mesh(), pad_overhead_limit=0.0)
        assert spmd.stats()["fallback_calls"] - before == jspmd.stats()["fallback_calls"] - jbefore == 1
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)

    def test_program_cache_compile_once(self, mesh):
        """One program per bucket shape: new values (and new output slots)
        of the same shape build none."""
        lhs, rhs, oi = rand_bucket(3, 4, 4, 4, 4, 2)
        spmd.spmd_bucket_gemm(torch.from_numpy(lhs), torch.from_numpy(rhs), oi, 2, mesh=mesh)
        progs = spmd.stats()["unique_programs"]
        for seed in range(3):
            lhs, rhs, oi = rand_bucket(10 + seed, 4, 4, 4, 4, 2)
            spmd.spmd_bucket_gemm(torch.from_numpy(lhs), torch.from_numpy(rhs), oi, 2, mesh=mesh)
        assert spmd.stats()["unique_programs"] == progs

    @pytest.mark.parametrize("grid", [(1, 2), (2, 2), (2, 4)])
    def test_chunk_arithmetic_matches_reference(self, grid):
        """Each rank's pairs and columns are the real part of the
        reference's padded chunk (``pp = ceil_to(P, rows)``, chunk
        ``pp // rows`` at ``r * chunk``; columns alike), the chunks cover the
        pairs and columns once, and the pad overhead is the reference's."""
        rows, cols = grid
        for p in range(0, 11):
            for n in range(1, 10):
                pp, np_ = jspmd._ceil_to(p, rows), jspmd._ceil_to(n, cols)
                pairs, columns = [], []
                for r in range(rows):
                    for c in range(cols):
                        (lo, hi), (c0, c1), pc, nc = spmd.chunk_bounds(p, n, rows, cols, r, c)
                        assert (pc, nc) == (pp // rows, np_ // cols)
                        assert list(range(lo, hi)) == [i for i in range(r * pc, (r + 1) * pc) if i < p]
                        assert list(range(c0, c1)) == [j for j in range(c * nc, (c + 1) * nc) if j < n]
                        if c == 0:
                            pairs += range(lo, hi)
                        if r == 0:
                            columns += range(c0, c1)
                assert pairs == list(range(p)) and columns == list(range(n))
                assert spmd.pad_overhead(p, n, rows, cols) == (pp * np_) / max(p * n, 1)
        assert _near_square_factors(rows * cols) == jax_near_square(rows * cols) == grid


class TestSpmdEngine:
    def test_contraction_matches_list(self, mesh):
        policy = BlockShardPolicy(mesh, mode="spmd")
        eng = ContractionEngine(policy=policy)
        for seed in range(4):
            (ja, jb), (ta, tb) = rand_pair(seed)
            got = eng(policy.place(ta), policy.place(tb), AX)
            assert_blocks_close(got, jax_contract(ja, jb, AX), 1e-12)
        assert eng.stats()["backend_counts"]["spmd"] > 0

    def test_run_dmrg_spmd_matches_list_single_device(self, mesh, j1j2_ref):
        ref, space, terms = j1j2_ref
        res = run_dmrg(space, terms, 6, bond_schedule=BONDS, spmd=True, mpo=mpo_from_arrays(ref["mpo"], device="cpu"),
                       device="cpu", **RUN_KW)
        assert abs(res.energy - ref["energies"][-1]) < 1e-10
        assert res.engine_stats["backend_counts"]["spmd"] > 0
        assert res.engine_stats["policy"]["mismatches"] == 0

    def test_spmd_kwarg_rejects_storage_policy(self, mesh):
        space, terms = spin_half_space(), heisenberg_j1j2_terms(3, 2, 1.0, 0.5, cylinder=False)
        storage = BlockShardPolicy(mesh)  # auto -> storage on a CPU mesh
        assert storage.mode == "storage"
        with pytest.raises(ValueError, match="spmd"):
            run_dmrg(space, terms, 6, shard_policy=storage, spmd=True, bond_schedule=(8,), sweeps_per_bond=1,
                     device="cpu")

    def test_no_graphs_under_spmd_and_programs_settle(self, mesh):
        """In place of the reference's compile-once test: under an spmd
        policy ``jit_matvec`` captures no graph (its collectives cannot be
        captured), every contraction takes the spmd rung, and once the
        structures settle no sweep builds a new SPMD program."""
        space, terms = spin_half_space(), heisenberg_j1j2_terms(3, 2, 1.0, 0.5, cylinder=False)
        from repro_torch.core.mpo import build_mpo, compress_mpo

        mpo = compress_mpo(build_mpo(space, terms, 6, device="cpu"), cutoff=1e-13)
        policy = BlockShardPolicy(mesh, mode="spmd")
        eng = DMRGEngine(product_state_mps(space, neel_states(space, 6), device="cpu"), mpo, davidson_iters=2,
                         algo="batched", jit_matvec=True, shard_policy=policy, device="cpu")
        for _ in range(3):  # the structures settle in the second sweep
            eng.sweep(max_bond=8)
        progs = spmd.stats()["unique_programs"]
        counts = dict(eng.contract_fn.backend_counts)
        eng.sweep(max_bond=8)
        assert spmd.stats()["unique_programs"] == progs
        stats = eng.contract_fn.stats()
        assert stats["graphs"]["graph_captures"] == 0 and stats["graphs"]["graph_replays"] == 0
        assert stats["backend_counts"]["spmd"] > counts["spmd"]
        assert sum(v for k, v in stats["backend_counts"].items() if k != "spmd") == 0


# ------------------------------------------------------------ gloo worlds
@pytest.fixture(scope="module")
def j1j2_ref():
    """The reference's single-process ``run_dmrg(algo="list")`` on the 3x2
    open J1-J2 lattice (J2=0.5), its per-sweep energies and its MPO as
    arrays for the port."""
    from repro.core.dmrg import run_dmrg as jax_run_dmrg
    from repro.core.mpo import build_mpo, compress_mpo

    space, terms = jax_space(), jax_j1j2(3, 2, 1.0, 0.5, cylinder=False)
    mpo = compress_mpo(build_mpo(space, terms, 6), cutoff=1e-13)
    res = jax_run_dmrg(space, terms, 6, bond_schedule=BONDS, mpo=mpo, algo="list", **RUN_KW)
    ref = dict(mpo=[to_arrays(w) for w in mpo], energies=res.energies)
    return ref, spin_half_space(), heisenberg_j1j2_terms(3, 2, 1.0, 0.5, cylinder=False)


def run_world(world, shape, mpo_arrays, tmp_dir):
    """Spawn ``world`` gloo ranks running ``_torch_dist_worker.dmrg_case``
    and return each rank's record; fail past ``WORLD_DEADLINE``."""
    ctx = mp.start_processes(
        _torch_dist_worker.dmrg_case, nprocs=world, join=False, start_method="spawn",
        args=(world, os.path.join(tmp_dir, "store"), tmp_dir, shape, mpo_arrays, BONDS, RUN_KW),
    )
    deadline = time.monotonic() + WORLD_DEADLINE
    try:
        while not ctx.join(timeout=2.0):
            if time.monotonic() > deadline:
                raise AssertionError(f"gloo world of {world} did not finish in {WORLD_DEADLINE} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    out = []
    for r in range(world):
        with open(os.path.join(tmp_dir, f"{r}.json")) as f:
            out.append(json.load(f))
    return out


@pytest.fixture(scope="module", params=[(2, (1, 2)), (4, (2, 2))], ids=["world2_1x2", "world4_2x2"])
def world(request, j1j2_ref, tmp_path_factory):
    size, shape = request.param
    ref = j1j2_ref[0]
    return size, shape, ref, run_world(size, shape, ref["mpo"], str(tmp_path_factory.mktemp(f"world{size}")))


class TestGlooWorlds:
    @pytest.mark.parametrize("mode", ["spmd", "storage"])
    def test_energies_match_reference_list(self, world, mode):
        size, shape, ref, ranks = world
        for rec in ranks:
            run = rec[mode]
            assert np.all(np.abs(np.array(run["energies"]) - np.array(ref["energies"])) < 1e-10), (
                mode, run["energies"], ref["energies"])
            assert run["policy"]["mesh"] == list(shape) and run["policy"]["mode"] == mode

    @pytest.mark.parametrize("mode", ["spmd", "storage"])
    def test_equal_on_every_rank(self, world, mode):
        _, _, _, ranks = world
        assert all(rec[mode]["energies"] == ranks[0][mode]["energies"] for rec in ranks)
        assert all(rec[mode]["policy"]["mismatches"] == 0 for rec in ranks)
        assert all(rec[mode]["policy"]["host_reads"] == ranks[0][mode]["policy"]["host_reads"] > 0 for rec in ranks)

    def test_spmd_collectives_and_fallbacks_as_the_reference_counts(self, world):
        """Every spmd rank split the same buckets: one all_reduce and one
        all_gather per call that did not fall back, and a fallback exactly
        where the reference's rule (its ``_ceil_to`` padding against its
        ``PAD_OVERHEAD_LIMIT``) says so."""
        size, (rows, cols), _, ranks = world
        for rec in ranks:
            st, calls = rec["spmd"]["spmd"], rec["spmd"]["calls"]
            want = sum(count for p, n, count in calls if (jspmd._ceil_to(p, rows) * jspmd._ceil_to(n, cols))
                       / max(p * n, 1) > jspmd.PAD_OVERHEAD_LIMIT)
            assert st["gemm_calls"] == sum(c for _, _, c in calls) > 0
            assert st["fallback_calls"] == want
            assert st["all_reduce_calls"] == st["all_gather_calls"] == st["gemm_calls"] - st["fallback_calls"]
            assert rec["storage"]["spmd"]["gemm_calls"] == 0 and rec["storage"]["policy"]["gathers"] > 0

    def test_split_bucket_gemm_on_the_world(self, world):
        """Pair and column counts that do not divide the mesh (short and
        empty chunks) against the plain GEMM, on every rank."""
        _, _, _, ranks = world
        for rec in ranks:
            assert max(rec["gemm"]) <= 1e-12
