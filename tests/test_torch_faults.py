"""The port's fault registry, degradation ladders and checkpoint/resume
(``dist/faults.py``, ``dist/engine.py``, ``dist/decomp.py``,
``core/sweep.py``, ``core/checkpoint.py``), held against the JAX package.

Mirrors ``tests/test_faults.py`` minus the serving layer: an injected
failure is detected at an existing host sync, recovered on a documented
ladder whose rungs run on the run's device, and invisible in the energies —
a recovered run equals the reference's clean run to <1e-10; a killed and
resumed run equals the uninterrupted one bit for bit.
"""
import math
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.dmrg import run_dmrg as jax_run_dmrg  # noqa: E402
from repro.core.models import heisenberg_chain_system  # noqa: E402
from repro.core.mpo import build_mpo, compress_mpo  # noqa: E402
from repro.core.mps import neel_states  # noqa: E402
from repro.core.sweep import DMRGEngine as JaxEngine  # noqa: E402
from repro.core.mps import product_state_mps as jax_product_state  # noqa: E402
from repro.dist import faults as jfaults  # noqa: E402
from repro.dist.engine import CONTRACTION_LADDER as JAX_LADDER  # noqa: E402
from repro_torch.convert import mpo_from_arrays  # noqa: E402
from repro_torch.core import run_dmrg  # noqa: E402
from repro_torch.core import models as tmodels  # noqa: E402
from repro_torch.core.checkpoint import CheckpointManager, tensor_restore, tensor_state  # noqa: E402
from repro_torch.core.mps import product_state_mps  # noqa: E402
from repro_torch.core.sweep import DMRGEngine  # noqa: E402
from repro_torch.dist import faults  # noqa: E402
from repro_torch.dist.engine import CONTRACTION_LADDER  # noqa: E402
from repro_torch.dist.faults import FaultInjected, FaultRegistry, NumericalHealthError  # noqa: E402

from _torch_helpers import to_arrays  # noqa: E402

N = 6  # chain length of the recovery tests
H = 0.3


@pytest.fixture(autouse=True)
def _clean_registries():
    """No fault leaks between tests, in either package's registry."""
    faults.registry.clear()
    jfaults.registry.clear()
    yield
    faults.registry.clear()
    jfaults.registry.clear()


@pytest.fixture(scope="module")
def ref():
    """The reference's two clean sweeps at m=8 (batched, as its fault tests
    run them) on its MPO, carried across as arrays."""
    space, terms = heisenberg_chain_system(N, h=H)
    mpo = compress_mpo(build_mpo(space, terms, N), cutoff=1e-13)
    eng = JaxEngine(jax_product_state(space, neel_states(space, N)), mpo, algo="batched", davidson_iters=4)
    eng.sweep(max_bond=8)
    last = eng.sweep(max_bond=8)
    return dict(mpo=[to_arrays(w) for w in mpo], energy=last.energy, restarts=last.davidson_restarts)


def _engine(ref, algo="batched", **kw):
    space, _ = tmodels.heisenberg_chain_system(N, h=H)
    mpo = mpo_from_arrays(ref["mpo"], device="cpu")
    mps = product_state_mps(space, neel_states(space, N), device="cpu")
    return DMRGEngine(mps, mpo, algo=algo, davidson_iters=4, device="cpu", **kw)


def _two_sweeps(eng, m=8):
    eng.sweep(max_bond=m)
    return eng.sweep(max_bond=m)


# ---------------------------------------------------------------- registry
class TestRegistry:
    def test_unknown_point_raises(self):
        """A typo is an unknown name; the port knows every point of the
        reference, the serving layer's three included."""
        reg = FaultRegistry()
        with pytest.raises(KeyError, match="unknown fault point"):
            reg.arm("decomp.typo_fail")
        for name in ("serve.worker_crash", "serve.slot_latency", "serve.poison_request"):
            assert reg.arm(name).point == name
        assert set(faults.FAULT_POINTS) == set(jfaults.FAULT_POINTS)

    def test_after_count_window(self):
        reg = FaultRegistry()
        f = reg.arm("decomp.svd_fail", after=2, count=2)
        hits = [reg.fire("decomp.svd_fail") is not None for _ in range(6)]
        assert hits == [False, False, True, True, False, False]
        assert f.seen == 6 and f.fired == 2

    def test_count_inf_fires_forever(self):
        reg = FaultRegistry()
        reg.arm("batch.gemm_nan", count=math.inf)
        assert all(reg.fire("batch.gemm_nan") is not None for _ in range(50))

    def test_inject_context_disarms(self):
        with faults.inject("env.exception") as f:
            assert faults.fire("env.exception") is not None
            assert f.fired == 1
        assert faults.fire("env.exception") is None

    def test_arm_from_env_grammar(self, monkeypatch):
        """The REPRO_FAULTS grammar on DMRG points, and the variable read at
        a registry's first use (not at import)."""
        reg = FaultRegistry()
        reg.arm_from_env("decomp.svd_fail:count=inf:after=1, sweep.kill:value=0.25")
        assert reg.fire("decomp.svd_fail") is None  # after=1 skips the first
        assert reg.fire("decomp.svd_fail").count == math.inf
        assert reg.fire("sweep.kill").value == 0.25
        with pytest.raises(ValueError, match="bad REPRO_FAULTS knob"):
            reg.arm_from_env("decomp.svd_fail:boom=1")
        with pytest.raises(KeyError):
            reg.arm_from_env("no.such_point")
        lazy = FaultRegistry(from_env=True)
        monkeypatch.setenv("REPRO_FAULTS", "env.exception:after=1")
        assert lazy.fire("env.exception") is None and lazy.fire("env.exception") is not None

    def test_stats_reports_armed_and_fired(self):
        reg = FaultRegistry()
        reg.arm("sweep.kill")
        reg.fire("sweep.kill")
        s = reg.stats()
        assert s["armed"] == ["sweep.kill"]
        assert s["fired"] == {"sweep.kill": 1}

    def test_registries_are_separate(self):
        """Arming the reference's registry arms nothing in the port."""
        jfaults.registry.arm("decomp.svd_fail")
        assert faults.fire("decomp.svd_fail") is None
        assert faults.registry.stats()["armed"] == []


# ------------------------------------------------- guards + degradation ladder
class TestDegradationLadder:
    def test_ladder_ordering(self):
        """The reference's ladder, its spmd rung included (taken only under
        an spmd policy), fastest first, ending at the seed."""
        assert CONTRACTION_LADDER == JAX_LADDER
        assert CONTRACTION_LADDER[-1] == "list"

    def test_clean_run_zero_counters(self, ref):
        eng = _engine(ref, jit_matvec=True)
        stats = _two_sweeps(eng)
        st = eng.contract_fn.stats()
        assert st["retries"] == {} and st["degradations"] == {}
        assert st["decomp"]["retries"] == 0
        assert not any(st["decomp"]["degradations"].values())
        assert stats.pair_retries == 0
        assert abs(stats.energy - ref["energy"]) < 1e-10

    def test_decomp_svd_fail_recovers_equal(self, ref):
        eng = _engine(ref)
        with faults.inject("decomp.svd_fail", count=1) as f:
            got = _two_sweeps(eng)
        assert f.fired == 1
        assert abs(got.energy - ref["energy"]) < 1e-10
        d = eng.contract_fn.stats()["decomp"]
        assert d["retries"] == 1 and d["degradations"] == {"svd_exact": 0, "svd_unplanned": 1}

    def test_env_exception_falls_back_to_seed_equal(self, ref):
        """Fired on the graphed environment path (on the CPU the graph cache
        runs the same pipeline eagerly)."""
        eng = _engine(ref, jit_matvec=True)
        with faults.inject("env.exception", count=2) as f:
            got = _two_sweeps(eng)
        assert f.fired == 2
        assert abs(got.energy - ref["energy"]) < 1e-10
        st = eng.contract_fn.stats()
        assert st["retries"] == {"env": 2} and st["degradations"] == {"env_seed": 2}

    def test_gemm_nan_pair_retries_on_seed_rung_equal(self, ref):
        """A NaN-poisoned batched GEMM surfaces at the Davidson sync as a
        NumericalHealthError; the pair is redone on the seed rung and the
        energy still equals the reference's clean run."""
        eng = _engine(ref, jit_matvec=False)
        first = eng.sweep(max_bond=8)
        with faults.inject("batch.gemm_nan", count=1) as f:
            got = eng.sweep(max_bond=8)
        assert f.fired == 1
        assert abs(got.energy - ref["energy"]) < 1e-10
        assert first.pair_retries == 0 and got.pair_retries == 1
        assert eng.contract_fn.degradations == {"pair_seed": 1}

    def test_davidson_health_surfaced_in_sweep_stats(self, ref):
        clean = _two_sweeps(_engine(ref))  # per-sweep stats: 2 passes x (N-1)
        assert clean.davidson_solves == 2 * (N - 1)
        assert clean.davidson_iterations >= clean.davidson_solves
        eng = _engine(ref)
        with faults.inject("davidson.no_converge", count=math.inf):
            forced = _two_sweeps(eng)
        assert forced.davidson_converged == 0
        assert forced.davidson_solves == clean.davidson_solves
        assert abs(forced.energy - ref["energy"]) < 1e-10

    def test_health_error_carries_stage_and_mask(self):
        e = NumericalHealthError("bad", stage="svd", problems=np.array([False, True]))
        assert e.stage == "svd"
        assert list(e.problems) == [False, True]
        assert isinstance(e, RuntimeError)

    def test_contraction_ladder_recovers_on_lower_rungs(self, ref):
        """A backend that raises a recoverable error (an injected fault, a
        health guard's finding) is redone on the rungs below it, counted;
        any other error, such as a kernel that fails to launch, propagates
        with nothing counted."""
        from _torch_helpers import CASES, assert_blocks_close, make_both
        from repro.tensor import blocksparse as jbs
        from repro_torch.dist.engine import ContractionEngine

        a_specs, a_q, b_specs, b_q, ax = CASES["one_mode"]
        (ja, ta), (jb, tb) = make_both(0, a_specs, a_q), make_both(1, b_specs, b_q)
        eng = ContractionEngine("batched")

        def raises(exc):
            def broken(*args, **kw):
                raise exc
            return broken

        eng._execute_batched = raises(FaultInjected("batch.gemm_nan"))
        assert_blocks_close(eng(ta, tb, ax), jbs.contract(ja, jb, ax), 1e-12)
        eng._execute_dense = raises(NumericalHealthError("bad", stage="davidson"))
        eng._execute_list = raises(FaultInjected("batch.gemm_nan"))
        assert_blocks_close(eng(ta, tb, ax), jbs.contract(ja, jb, ax), 1e-12)
        assert eng.retries == {"contraction": 2}
        assert eng.degradations == {"contraction_dense": 1, "contraction_seed": 1}

        eng._execute_batched = raises(RuntimeError("launch failed"))
        with pytest.raises(RuntimeError, match="launch failed"):
            eng(ta, tb, ax)
        eng._execute_batched = raises(FaultInjected("batch.gemm_nan"))
        eng._execute_dense = raises(RuntimeError("launch failed"))
        with pytest.raises(RuntimeError, match="launch failed"):
            eng(ta, tb, ax)
        assert eng.retries == {"contraction": 3}
        assert eng.degradations == {"contraction_dense": 1, "contraction_seed": 1}

    def test_env_ladder_lets_other_errors_through(self, ref):
        """The fused environment update's ladder recovers an injected fault
        only: a launch error or a failed capture propagates, uncounted."""
        eng = _engine(ref, jit_matvec=True)

        def broken(*args, **kw):
            raise RuntimeError("capture failed")

        eng.contract_fn.env_update_left = broken
        with pytest.raises(RuntimeError, match="capture failed"):
            eng.sweep(max_bond=8)
        assert eng.contract_fn.retries == {} and eng.contract_fn.degradations == {}

    @pytest.mark.parametrize("fails, want", [
        (1, {"svd_exact": 1, "svd_unplanned": 0}),
        (2, {"svd_exact": 0, "svd_unplanned": 1}),
    ])
    def test_svd_ladder_counts_the_rung_that_recovered(self, fails, want):
        """A randomized split that fails is retried exact, then per sector;
        only the rung that returned is counted, and the values equal a
        clean exact split's."""
        from repro_torch.dist.decomp import DecompositionEngine
        from repro_torch.tensor import blocksparse as tbs
        from repro_torch.tensor import qn as tqn

        rng = np.random.default_rng(0)
        mat = rng.standard_normal((33, 100)) * (0.7 ** np.arange(100))[None, :]
        theta = tbs.BlockSparseTensor([tqn.Index((((0,), 33),), -1), tqn.Index((((0,), 100),), 1)],
                                      {(0, 0): torch.from_numpy(mat)})
        eng = DecompositionEngine(method="randomized")
        assert eng._bucket_methods(eng.cache.get(theta, 1), 5)[0] == ("rsvd",)
        execute, calls = eng._execute, []

        def flaky(*args):
            calls.append(args[-2])
            if len(calls) <= fails:
                raise NumericalHealthError("bad", stage="svd")
            return execute(*args)

        eng._execute = flaky
        _, _, svals, err = eng.svd_split(theta, 1, 5)
        _, _, want_svals, want_err = tbs.svd_split(theta, 1, 5)
        assert calls[:2] == [("rsvd",), ("svd",)][:len(calls)]
        assert eng.retries == 1 and eng.degradations == want
        np.testing.assert_allclose(svals[(0,)].numpy(), want_svals[(0,)].numpy(), rtol=0, atol=1e-12)
        assert abs(err - want_err) < 1e-12

        def launch_fails(*args):
            raise RuntimeError("launch failed")

        eng._execute = launch_fails
        with pytest.raises(RuntimeError, match="launch failed"):
            eng.svd_split(theta, 1, 5)
        assert eng.retries == 1 and eng.degradations == want


# ------------------------------------------------------- checkpoint/resume
class TestCheckpoint:
    def _state(self, step):
        return {"step": step, "payload": list(range(step))}

    def test_roundtrip_and_prune(self, tmp_path):
        cm = CheckpointManager(str(tmp_path), every=1, keep=2)
        for s in range(1, 6):
            cm.save(self._state(s))
        assert sorted(os.listdir(tmp_path)) == ["ckpt_00000004.pkl", "ckpt_00000005.pkl"]
        assert cm.load_latest()["step"] == 5
        assert cm.saves == 5 and cm.save_seconds > 0

    def test_maybe_save_cadence(self, tmp_path):
        cm = CheckpointManager(str(tmp_path), every=3, keep=10)
        saved = [cm.maybe_save(self._state(s)) for s in range(1, 7)]
        assert [bool(p) for p in saved] == [False, False, True, False, False, True]

    def test_truncated_newest_degrades_to_previous(self, tmp_path):
        cm = CheckpointManager(str(tmp_path), every=1, keep=2)
        cm.save(self._state(1))
        cm.save(self._state(2))
        with open(os.path.join(tmp_path, "ckpt_00000002.pkl"), "wb") as f:
            f.write(b"\x80\x04garbage")  # a crash mid-write
        assert cm.load_latest()["step"] == 1

    def test_version_mismatch_skipped(self, tmp_path):
        cm = CheckpointManager(str(tmp_path), every=1, keep=2)
        cm.save(self._state(1))
        with open(os.path.join(tmp_path, "ckpt_00000002.pkl"), "wb") as f:
            pickle.dump({"step": 2, "version": 999}, f)
        assert cm.load_latest()["step"] == 1

    def test_kill_mid_sweep_resume_equal(self, tmp_path):
        """Kill the run after the 4th site update; a rerun with the same
        checkpoint directory resumes mid-sweep, and every sweep energy
        equals the uninterrupted run's bit for bit, and the reference's
        same run to <1e-10."""
        kw = dict(bond_schedule=(8, 12), sweeps_per_bond=1, davidson_iters=4, algo="batched")
        want = jax_run_dmrg(*heisenberg_chain_system(N, h=H), N, **kw)
        space, terms = tmodels.heisenberg_chain_system(N, h=H)
        clean = run_dmrg(space, terms, N, device="cpu", **kw)
        ckdir = str(tmp_path / "ck")
        with faults.inject("sweep.kill", after=3, count=1) as f:
            with pytest.raises(FaultInjected):
                run_dmrg(space, terms, N, checkpoint_dir=ckdir, device="cpu", **kw)
        assert f.fired == 1
        res = run_dmrg(space, terms, N, checkpoint_dir=ckdir, device="cpu", **kw)
        assert res.energies == clean.energies
        assert [s.site_energies for s in res.sweep_stats] == [s.site_energies for s in clean.sweep_stats]
        assert res.checkpoint_seconds > 0
        for a, b in zip(res.sweep_stats, want.sweep_stats):
            assert abs(a.energy - b.energy) < 1e-10

    def test_tensor_state_roundtrip_is_exact(self):
        """A block goes to numpy and back bit for bit, views included."""
        from _torch_helpers import CASES, make_both

        a_specs, a_q = CASES["one_mode"][:2]
        _, t = make_both(3, a_specs, a_q)
        # every other block a non-contiguous view of the same values
        t.blocks = {k: b.permute(2, 1, 0).contiguous().permute(2, 1, 0) if i % 2 else b
                    for i, (k, b) in enumerate(t.blocks.items())}
        back = tensor_restore(pickle.loads(pickle.dumps(tensor_state(t))), "cpu")
        assert back.indices == t.indices and back.charge == t.charge and list(back.blocks) == list(t.blocks)
        assert all(torch.equal(back.blocks[k], b) for k, b in t.blocks.items())
