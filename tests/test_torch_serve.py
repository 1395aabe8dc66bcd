"""The port's serving layer (``repro_torch/serve``) against the reference's
``repro.serve``: the counterparts of ``tests/test_serve.py`` and of the
serving cases of ``tests/test_faults.py``, on the CPU.

The multi-problem core is held to the reference's ``run_dmrg_multi`` on the
same operators (the reference's MPOs carried across with
``convert.mpo_from_arrays``: the port's compression has another sign
gauge) and to the port's own single runs; the service, scheduler and CLI
are held to the reference's contracts (bisection, masked retry, watchdog,
journal, backpressure, zero retraces after warmup).
"""
import math
import os
import subprocess
import sys
import textwrap
import threading

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.convert import mpo_from_arrays  # noqa: E402
from repro_torch.core import run_dmrg  # noqa: E402
from repro_torch.dist import cache_stats, faults  # noqa: E402
from repro_torch.dist.plan import _SignatureLRU  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    BatchScheduler,
    DMRGService,
    ProblemSpec,
    ServeQueueFull,
    StackedOps,
    build_problem,
    group_key,
    run_dmrg_multi,
)
from repro_torch.serve.stacked import unstack_tensor  # noqa: E402

from _torch_helpers import specs as index_specs, to_arrays  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
TRIPLES = [(1.0, 0.3), (0.9, 0.45), (1.1, 0.6)]


@pytest.fixture(autouse=True)
def _clean_registry():
    faults.registry.clear()
    yield
    faults.registry.clear()


# -------------------------------------------------------- multi-problem core
@pytest.fixture(scope="module")
def multi():
    """The 6-site Heisenberg (J, h) triples through the reference's
    ``run_dmrg_multi`` and, on the reference's MPOs, the port's."""
    from repro.serve import ProblemSpec as JaxSpec
    from repro.serve import build_problem as jax_build
    from repro.serve import run_dmrg_multi as jax_multi

    sp = [JaxSpec.make("heisenberg", 6, J=j, h=h, max_bond=8, davidson_iters=5) for j, h in TRIPLES]
    built = [jax_build(s) for s in sp]
    kw = dict(bond_schedule=sp[0].bond_schedule, sweeps_per_bond=2, davidson_iters=5)
    ref = jax_multi(built[0][0], 6, [m for _, m in built], **kw)
    mpos = [mpo_from_arrays([to_arrays(w) for w in m], device="cpu") for _, m in built]
    space, _ = build_problem(ProblemSpec.make("heisenberg", 6))
    got = run_dmrg_multi(space, 6, mpos, device="cpu", **kw)
    return dict(ref=ref, got=got, mpos=mpos, space=space, kw=kw, spec=ProblemSpec.make(
        "heisenberg", 6, max_bond=8, davidson_iters=5))


def test_multi_matches_reference_multi(multi):
    """Energies <1e-10 from the reference's batched solve, equal Davidson
    iteration and restart counts sweep by sweep, and equal kept sectors on
    every bond of the final stacked MPS."""
    ref, got = multi["ref"], multi["got"]
    np.testing.assert_allclose(got.energies, np.asarray(ref.energies), rtol=0, atol=1e-10)
    for a, b in zip(got.sweep_stats, ref.sweep_stats):
        assert (a.davidson_iterations, a.davidson_restarts, a.davidson_solves) == (
            b.davidson_iterations, b.davidson_restarts, b.davidson_solves)
        assert a.max_bond == b.max_bond
        np.testing.assert_allclose(a.energies, np.asarray(b.energies), rtol=0, atol=1e-10)
    for tg, tr in zip(got.engine.T, ref.engine.T):
        assert index_specs(tg.indices) == index_specs(tr.indices)


def test_multi_singular_values_match_reference(multi):
    """Per problem, the singular values across the middle bond of the final
    states, each package's stacked split of its own theta: <=1e-12."""
    from repro.serve import svd_split_multi as jax_split
    from repro.serve.stacked import StackedOps as JaxOps

    from repro_torch.serve import svd_split_multi

    ref, got = multi["ref"], multi["got"]
    jt = JaxOps().contract(ref.engine.T[2], ref.engine.T[3], ((2,), (0,)))
    ops = got.engine.ops
    tt = ops.contract(got.engine.T[2], got.engine.T[3], ((2,), (0,)))
    _, _, jsv, _ = jax_split(jt, 2, max_bond=64, cutoff=0.0)
    _, _, tsv, _ = svd_split_multi(tt, 2, max_bond=64, cutoff=0.0, ops=ops)
    assert set(tsv) == set(jsv)
    for q in jsv:
        np.testing.assert_allclose(tsv[q].numpy(), np.asarray(jsv[q]), rtol=0, atol=1e-12)


def test_multi_matches_port_singles(multi):
    """Each problem of the batch equals its own single run
    (``run_dmrg(algo="batched", jit_matvec=True)``) to 1e-10."""
    spec, got = multi["spec"], multi["got"]
    for b, mpo in enumerate(multi["mpos"]):
        ref = run_dmrg(multi["space"], None, 6, mpo=mpo, algo="batched", jit_matvec=True, device="cpu",
                       cutoff=spec.cutoff, **multi["kw"])
        assert abs(float(got.energies[b]) - ref.energy) < 1e-10
        # the batch's own per-problem view is an MPS of the single run's bonds
        one = [unstack_tensor(t, b) for t in got.engine.T]
        assert all(t.blocks for t in one)


def test_structure_mismatch_rejected():
    """Problems whose MPOs differ in block structure cannot share a batch
    axis: run_dmrg_multi refuses rather than compute garbage."""
    space, mpo_a = build_problem(ProblemSpec.make("heisenberg", 6, J=1.0, h=0.3))
    _, mpo_b = build_problem(ProblemSpec.make("j1j2_ladder", 6, J1=1.0, J2=0.5))
    with pytest.raises(ValueError, match="structure"):
        run_dmrg_multi(space, 6, [mpo_a, mpo_b], bond_schedule=(8,), device="cpu")


# ----------------------------------------------------------------- scheduler
class TestScheduler:
    def _spec(self, **kw):
        return ProblemSpec.make("heisenberg", kw.pop("n", 6), **kw)

    def test_group_key_ignores_values_catches_structure(self):
        sa, sb = self._spec(J=0.8, h=0.3), self._spec(J=1.2, h=0.45)
        sc = self._spec(J=1.0, h=0.0)  # h=0 keeps the zero-block field channel
        sd = self._spec(J=1.0, h=0.3, n=8)
        se = ProblemSpec.make("j1j2_ladder", 6, J1=1.0, J2=0.5)
        ka, kb, kc, kd, ke = (group_key(s, build_problem(s)[1]) for s in (sa, sb, sc, sd, se))
        assert ka == kb == kc
        assert ka != kd and ka != ke

    def test_power_of_two_slot_padding(self):
        sched = BatchScheduler(max_batch=8)
        spec = self._spec(J=1.0, h=0.3)
        for rid in range(3):
            sched.add(("g",), rid, spec, "space", f"mpo{rid}")
        slot = sched.next_batch()
        assert slot.rids == [0, 1, 2] and slot.slot_size == 4
        assert slot.mpos == ["mpo0", "mpo1", "mpo2", "mpo2"]
        assert slot.fill_ratio == pytest.approx(0.75)
        assert len(sched) == 0 and sched.next_batch() is None

    def test_oldest_head_group_served_first(self):
        sched = BatchScheduler(max_batch=2)
        spec = self._spec(J=1.0)
        sched.add(("a",), 0, spec, "sp", "m0")
        sched.add(("b",), 1, spec, "sp", "m1")
        sched.add(("a",), 2, spec, "sp", "m2")
        first = sched.next_batch()
        assert first.key == ("a",) and first.rids == [0, 2]
        second = sched.next_batch()
        assert second.key == ("b",) and second.rids == [1] and second.slot_size == 1


def test_spec_json_roundtrip():
    spec = ProblemSpec.make("j1j2_ladder", 32, J1=1.0, J2=0.4, max_bond=256)
    assert ProblemSpec.from_json_dict(spec.to_json_dict()) == spec
    assert spec.bond_schedule == (8, 16, 32, 64, 128, 256)


# --------------------------------------------------------------- plan caches
class TestPlanCacheThreadSafety:
    def test_concurrent_get_consistent_stats(self):
        """Many threads on one small cache: every lookup counted once
        (hits + misses == lookups), one build per miss, evictions counted."""
        cache = _SignatureLRU(maxsize=4)
        n_threads, n_iter, n_sigs = 8, 300, 12
        built, build_lock = [], threading.Lock()

        def worker(tid):
            for i in range(n_iter):
                sig = ("sig", (tid + i) % n_sigs)

                def build():
                    obj = object()
                    with build_lock:
                        built.append(obj)
                    return obj

                cache._get(sig, build)

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        st = cache.stats()
        assert st["hits"] + st["misses"] == n_threads * n_iter
        assert st["misses"] == st["builds"] == len(built)
        assert st["size"] <= 4
        assert st["evictions"] == st["misses"] - st["size"] > 0

    def test_one_plan_per_signature_under_races(self):
        """Racing first lookups of one signature share one plan."""
        cache = _SignatureLRU(maxsize=64)
        barrier = threading.Barrier(8)
        got = []

        def worker():
            barrier.wait(timeout=30)
            got.append(cache._get("sig", object))

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert len(got) == 8 and len({id(p) for p in got}) == 1
        assert cache.stats()["builds"] == 1

    def test_cache_stats_shape(self):
        from repro.dist import cache_stats as jax_cache_stats

        out = cache_stats()
        assert set(out) == set(jax_cache_stats()) == {"plan_cache", "decomp_plan_cache", "env_plan_cache",
                                                      "plan_store"}
        assert out["plan_store"] is None
        for k in ("plan_cache", "decomp_plan_cache", "env_plan_cache"):
            assert set(out[k]) == {"hits", "misses", "evictions", "size", "builds"}
        ops = StackedOps()
        with_engine = cache_stats(ops.engine)
        assert len(with_engine["engines"]) == 1 and with_engine["plan_cache"]["size"] == 0


# ------------------------------------------------------------------- service
SPECS = [ProblemSpec.make("heisenberg", 6, J=1.0 + 0.05 * i, max_bond=8, sweeps_per_bond=1, davidson_iters=4)
         for i in range(4)]
_OPS = {}


def _ops():
    """One StackedOps across the service tests: plans and graph keys once."""
    if "ops" not in _OPS:
        _OPS["ops"] = StackedOps()
    return _OPS["ops"]


def _manual(**kw):
    """A service with no worker thread: tests drive slots deterministically."""
    kw.setdefault("ops", _ops())
    return DMRGService(max_batch=4, start=False, device="cpu", **kw)


def _drain_one_slot(svc):
    """What one worker iteration does: cut a slot, mark running, solve."""
    with svc._cv:
        slot = svc.scheduler.next_batch()
        assert slot is not None
        for rid in slot.rids:
            svc._requests[rid]["status"] = "running"
    svc._run_slot(slot)
    return slot


@pytest.fixture(scope="module")
def clean():
    """Each spec solved alone through the service, the recovery tests'
    yardstick."""
    svc = _manual()
    out = {}
    for spec in SPECS:
        rid = svc.submit(spec)
        _drain_one_slot(svc)
        out[spec] = svc.result(rid, timeout=5.0)["energy"]
    svc.shutdown()
    return out


class TestService:
    def test_backpressure_queue_full(self):
        svc = DMRGService(max_batch=2, max_queue=2, start=False, device="cpu")
        spec = ProblemSpec.make("heisenberg", 4, J=1.0, h=0.3)
        svc.submit(spec, timeout=1.0)
        svc.submit(spec, timeout=1.0)
        with pytest.raises(ServeQueueFull):
            svc.submit(spec, timeout=0.05)
        assert svc.stats()["pending"] == 2
        svc.shutdown()

    def test_unknown_request_id(self):
        svc = DMRGService(start=False, device="cpu")
        with pytest.raises(KeyError):
            svc.poll(99)
        with pytest.raises(KeyError):
            svc.result(99, timeout=0.01)
        svc.shutdown()

    def test_unknown_model_rejected_at_submit(self):
        svc = DMRGService(start=False, device="cpu")
        with pytest.raises(ValueError, match="unknown model"):
            svc.submit(ProblemSpec.make("not-a-model", 4))
        svc.shutdown()

    def test_plan_store_not_ported(self, tmp_path):
        """The plan store, refused before it was ported, now activates
        process-wide and counts in ``cache_stats``."""
        from repro_torch.dist import persist

        svc = DMRGService(start=False, device="cpu", plan_store=str(tmp_path))
        try:
            assert persist.active_store() is svc.plan_store
            assert cache_stats()["plan_store"]["root"] == str(tmp_path)
        finally:
            svc.shutdown()
            persist.deactivate_store()

    def test_failed_slot_bisects_and_recovers(self):
        """A slot of mixed block structure (forced past the group key) does
        not fail its requests: it bisects and each half solves on its own."""
        svc = DMRGService(max_batch=2, start=False, device="cpu")
        s_chain = ProblemSpec.make("heisenberg", 6, J=1.0, h=0.3)
        s_ladder = ProblemSpec.make("j1j2_ladder", 6, J1=1.0, J2=0.5)
        space, mpo_a = build_problem(s_chain)
        _, mpo_b = build_problem(s_ladder)
        with svc._cv:
            for rid, (sp, mpo) in enumerate([(s_chain, mpo_a), (s_ladder, mpo_b)]):
                svc._requests[rid] = {"status": "running", "spec": sp, "submitted": 0.0, "retries": 0,
                                      "space": space, "mpo": mpo, "key": ("forced",)}
                svc.scheduler.add(("forced",), rid, sp, space, mpo)
        svc._run_slot(svc.scheduler.next_batch())
        assert svc.result(0, timeout=1.0)["status"] == "done"
        assert svc.result(1, timeout=1.0)["status"] == "done"
        st = svc.stats()
        assert (st["bisections"], st["completed"], st["failed"], st["unrecovered_errors"]) == (1, 2, 0, 0)
        svc.shutdown()

    def test_unrecoverable_error_fails_the_slot_at_once(self, monkeypatch):
        """An error that is neither an injected fault, a health finding nor
        a structure mismatch (here a stand-in for a block GEMM launch error)
        is not retried and not bisected: the slot's requests fail carrying
        it, and the stats count it."""
        from repro_torch.serve import service

        def launch_failure(*_a, **_k):
            raise RuntimeError("block_gemm kernel tiled_dmma launch failed: cudaError 700")

        svc = _manual()
        rids = [svc.submit(s) for s in SPECS[:2]]
        monkeypatch.setattr(service, "run_dmrg_multi", launch_failure)
        _drain_one_slot(svc)
        for rid in rids:
            with pytest.raises(RuntimeError, match="cudaError 700"):
                svc.result(rid, timeout=1.0)
        st = svc.stats()
        assert (st["failed"], st["retries"], st["bisections"], st["unrecovered_errors"]) == (2, 0, 0, 1)
        svc.shutdown()


class TestServeRecovery:
    @pytest.mark.parametrize("target", [0, 3])
    def test_poisoned_request_isolated(self, clean, target):
        """One NaN-poisoned request in a slot of 4 fails exactly itself; the
        other three match their clean solo runs to <1e-10."""
        svc = _manual(max_retries=0)
        rids = [svc.submit(s) for s in SPECS]
        faults.registry.arm("serve.poison_request", count=math.inf, problem=rids[target])
        _drain_one_slot(svc)
        faults.registry.clear()
        for i, (rid, spec) in enumerate(zip(rids, SPECS)):
            if i == target:
                with pytest.raises(RuntimeError, match="failed"):
                    svc.result(rid, timeout=5.0)
            else:
                assert abs(svc.result(rid, timeout=5.0)["energy"] - clean[spec]) < 1e-10
        st = svc.stats()
        assert st["failed"] == 1 and st["completed"] == 3 and st["bisections"] == 0
        svc.shutdown()

    def test_transient_poison_retried_masked(self, clean):
        """A count=1 poison is transient: the poisoned request is charged one
        retry, re-solved clean from its pristine MPO, and every request
        matches its clean run."""
        svc = _manual(max_retries=2)
        rids = [svc.submit(s) for s in SPECS[:2]]
        with faults.inject("serve.poison_request", count=1, problem=rids[1]) as f:
            _drain_one_slot(svc)
        assert f.fired == 1
        for rid, spec in zip(rids, SPECS):
            assert abs(svc.result(rid, timeout=5.0)["energy"] - clean[spec]) < 1e-10
        st = svc.stats()
        assert (st["retries"], st["bisections"], st["failed"]) == (1, 0, 0)
        svc.shutdown()

    def test_unmasked_failure_bisects(self):
        svc = _manual()
        rids = [svc.submit(s) for s in SPECS[:2]]
        with faults.inject("decomp.svd_fail", count=1) as f:
            _drain_one_slot(svc)
        assert f.fired == 1
        for rid in rids:
            assert svc.result(rid, timeout=5.0)["status"] == "done"
        st = svc.stats()
        assert st["bisections"] == 1 and st["failed"] == 0 and st["davidson"]["solves"] > 0
        svc.shutdown()

    def test_single_request_retry_budget_exhausts(self):
        svc = _manual(max_retries=1)
        rid = svc.submit(SPECS[0])
        with faults.inject("decomp.svd_fail", count=math.inf):
            _drain_one_slot(svc)
        with pytest.raises(RuntimeError, match="failed"):
            svc.result(rid, timeout=5.0)
        st = svc.stats()
        assert st["retries"] == 2 and st["failed"] == 1
        svc.shutdown()

    def test_worker_crash_restarts_and_recovers(self):
        svc = DMRGService(max_batch=4, ops=_ops(), batch_wait_s=0.01, device="cpu")
        faults.registry.arm("serve.worker_crash", count=1)
        rid = svc.submit(SPECS[0])
        assert svc.result(rid, timeout=120.0)["status"] == "done"
        assert svc.stats()["worker_restarts"] == 1
        svc.shutdown()
        assert not svc._worker.is_alive()

    def test_slot_latency_fault_delays_solve(self):
        import time

        svc = _manual()
        rid = svc.submit(SPECS[0])
        with faults.inject("serve.slot_latency", value=0.2):
            t0 = time.perf_counter()
            _drain_one_slot(svc)
            dt = time.perf_counter() - t0
        assert dt >= 0.2
        assert svc.result(rid, timeout=5.0)["status"] == "done"
        svc.shutdown()

    def test_cancel_pending_request(self):
        svc = _manual()
        r0, r1 = svc.submit(SPECS[0]), svc.submit(SPECS[1])
        assert svc.cancel(r0) is True and svc.cancel(r0) is False
        assert svc.poll(r0)["status"] == "cancelled"
        with pytest.raises(RuntimeError, match="cancelled"):
            svc.result(r0, timeout=1.0)
        _drain_one_slot(svc)
        assert svc.result(r1, timeout=5.0)["status"] == "done"
        st = svc.stats()
        assert st["cancelled"] == 1 and st["completed"] == 1
        svc.shutdown()

    def test_result_evicts_into_bounded_tombstones(self):
        svc = _manual(max_tombstones=2)
        rids = [svc.submit(s) for s in SPECS[:3]]
        while len(svc.scheduler):
            _drain_one_slot(svc)
        for rid in rids:
            svc.result(rid, timeout=5.0)
        assert svc._requests == {}
        assert svc.poll(rids[-1])["status"] == "done"
        with pytest.raises(KeyError):
            svc.poll(rids[0])
        svc.shutdown()

    def test_journal_recovery_reenqueues(self, tmp_path):
        ckdir = str(tmp_path)
        svc1 = _manual(checkpoint_dir=ckdir)
        rids = [svc1.submit(s) for s in SPECS[:2]]
        assert os.path.exists(os.path.join(ckdir, "serve_journal.json"))
        # no shutdown: the process dies with work undelivered
        svc2 = _manual(checkpoint_dir=ckdir)
        assert len(svc2.scheduler) == 2
        for rid in rids:
            assert svc2.poll(rid)["status"] == "pending"
        assert svc2.submit(SPECS[2]) == max(rids) + 1
        _drain_one_slot(svc2)
        assert all(svc2.result(r, timeout=5.0)["status"] == "done" for r in rids + [max(rids) + 1])
        svc2.shutdown()
        svc1.shutdown()


def _run(code: str, tmp_path, timeout=600):
    script = tmp_path / "run.py"
    script.write_text(textwrap.dedent(code))
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    return subprocess.run([sys.executable, str(script)], capture_output=True, text=True, timeout=timeout, env=env)


def test_service_end_to_end(tmp_path):
    """The whole service -- queue, worker thread, warmed steady state,
    energies against single runs -- in its own process, with zero
    retraces after warmup."""
    proc = _run("""
        from repro_torch.core import run_dmrg
        from repro_torch.serve import DEVICE_LOCK, DMRGService, ProblemSpec
        from repro_torch.serve.problems import build_problem

        svc = DMRGService(max_batch=2, max_queue=8, batch_wait_s=0.05, device="cpu")
        specs = [ProblemSpec.make("heisenberg", 6, J=j, h=0.3, max_bond=8, davidson_iters=5) for j in (0.9, 1.0, 1.1)]
        svc.warmup(specs[0], sizes=(1, 2))
        assert svc.stats()["retraces"] == 0 and svc.ops.retraces > 0
        rids = [svc.submit(s, timeout=5.0) for s in specs]
        recs = [svc.result(rid, timeout=600.0) for rid in rids]
        for rec, spec in zip(recs, specs):
            assert rec["status"] == "done"
            space, mpo = build_problem(spec)
            with DEVICE_LOCK:
                ref = run_dmrg(space, None, spec.n_sites, bond_schedule=spec.bond_schedule,
                               sweeps_per_bond=spec.sweeps_per_bond, davidson_iters=spec.davidson_iters,
                               cutoff=spec.cutoff, mpo=mpo, algo="batched", jit_matvec=True, device="cpu")
            assert abs(rec["energy"] - ref.energy) < 1e-10, (rec["energy"], ref.energy)
        st = svc.stats()
        assert st["completed"] == 3 and st["failed"] == 0 and st["pending"] == 0, st
        assert st["retraces"] == 0, st
        assert st["problems_per_sec"] > 0 and 0.0 < st["batch_fill_ratio"] <= 1.0, st
        assert set(st["plan_caches"]) >= {"plan_cache", "decomp_plan_cache", "env_plan_cache", "engines"}, st
        assert not any((st["retries"], st["bisections"], st["worker_restarts"], st["unrecovered_errors"]))
        svc.shutdown()
        print("SERVE_E2E_OK")
    """, tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SERVE_E2E_OK" in proc.stdout


def test_cli_check_on_cpu():
    """``python -m repro_torch.serve --device cpu ... --check`` exits 0."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve", "--device", "cpu", "--model", "heisenberg", "--n-sites", "6",
         "--max-bond", "8", "--sweep", "J=0.9:1.1:3", "--batch", "2", "--check"],
        capture_output=True, text=True, timeout=600, env=dict(os.environ, PYTHONPATH=os.path.abspath(SRC)))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "CHECK OK" in proc.stdout and "retraces 0" in proc.stdout


def test_cli_refuses_what_is_not_ported(capsys):
    """``--warmup`` and ``--plan-store`` are ported; what the CLI still
    refuses is a warmup with nowhere to persist and a malformed target."""
    from repro_torch.serve.__main__ import main

    assert main(["--device", "cpu", "--warmup", "heisenberg,m=8,n=6"]) == 2
    assert "requires --plan-store" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="bad --warmup"):
        main(["--device", "cpu", "--warmup", "heisenberg,q=3", "--plan-store", "unused"])
