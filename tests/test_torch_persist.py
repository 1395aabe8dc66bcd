"""The port's persistent plan store (``dist/persist.py``) against the
reference's ``repro.dist.persist`` on the CPU: the plan-build cases of
``tests/test_persist.py`` (signatures, round trips through the plan caches
with zero builds and bit-identical results, version, corruption and kind
gating, activation, primed runs equal to cold ones, ED cross-checks, two
processes on one store), the structure records that take the place of the
reference's export tier, and the cold start in a fresh process held by
counts: zero plan builds, and zero graph captures once the warmup has
replayed the store (on the CPU a capture is a graph key's first eager run).
No speed ratio is asserted.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")


from repro.dist.persist import signature_digest as jax_signature_digest  # noqa: E402
from repro.dist.plan import plan_signature as jax_plan_signature  # noqa: E402
from repro_torch.core import run_dmrg  # noqa: E402
from repro_torch.core.ed import ground_energy  # noqa: E402
from repro_torch.core.mps import neel_states, total_charge  # noqa: E402
from repro_torch.dist import PlanStore, persist  # noqa: E402
from repro_torch.dist.engine import ContractionEngine  # noqa: E402
from repro_torch.dist.persist import PERSIST_VERSION, canonical_signature, signature_digest  # noqa: E402
from repro_torch.dist.plan import PlanCache, plan_signature  # noqa: E402
from repro_torch.serve.problems import MODEL_BUILDERS  # noqa: E402
from repro_torch.tensor.blocksparse import BlockSparseTensor  # noqa: E402
from repro_torch.tensor.qn import Index  # noqa: E402

from test_torch_batch import AX, rand_pair  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
# the subprocesses' environment: the port on the path, one intra-op thread
# (their problems are tiny, and the cores are shared with other tests)
SUB_ENV = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tiny CPU runs, as in its
    subprocesses."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def port_pair(seed):
    return rand_pair(seed)[1]


def builds(res) -> int:
    return res.engine_stats["plan_builds"]


class TestSignatures:
    def test_digest_ignores_index_names(self):
        A, B = port_pair(3)
        renamed = BlockSparseTensor(tuple(Index(ix.sectors, ix.flow, "other") for ix in A.indices), A.blocks,
                                    A.charge)
        assert signature_digest(plan_signature(A, B, AX)) == signature_digest(plan_signature(renamed, B, AX))

    def test_digest_distinguishes_structure(self):
        A, B = port_pair(0)
        C, D = port_pair(5)
        assert plan_signature(A, B, AX) != plan_signature(C, D, AX)
        assert signature_digest(plan_signature(A, B, AX)) != signature_digest(plan_signature(C, D, AX))

    def test_canonical_form_drops_names_only(self):
        ix = Index((((0,), 2), ((1,), 3)), 1, "named")
        assert canonical_signature((ix, 7, "s")) == (("Ix", ix.sectors, ix.flow), 7, "s")

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_digest_matches_reference(self, seed):
        """One structure, one digest in both packages: the canonical forms
        are the same plain tuples."""
        (ja, jb), (ta, tb) = rand_pair(seed)
        assert signature_digest(plan_signature(ta, tb, AX)) == jax_signature_digest(jax_plan_signature(ja, jb, AX))


class TestPlanRoundtrip:
    def test_primed_cache_zero_builds_bit_identical(self, tmp_path):
        A, B = port_pair(1)
        store = PlanStore(tmp_path)
        cache = PlanCache()
        cache.store = store
        C1 = ContractionEngine(backend="list", cache=cache)(A, B, AX)
        assert cache.builds == 1 and store.stats()["saves"] == 1

        cache2 = PlanCache()
        cache2.store = store
        C2 = ContractionEngine(backend="list", cache=cache2)(A, B, AX)
        assert cache2.builds == 0, "a primed store must satisfy the miss"
        assert store.stats()["hits"] == 1
        assert set(C1.blocks) == set(C2.blocks)
        for k in C1.blocks:
            assert torch.equal(C1.blocks[k], C2.blocks[k])

    def test_version_mismatch_rejected_and_repaired(self, tmp_path):
        A, B = port_pair(2)
        sig = plan_signature(A, B, AX)
        store = PlanStore(tmp_path)
        cache = PlanCache()
        cache.store = store
        cache.get(A, B, AX)
        path = store._plan_path("contraction", sig)
        with open(path, "rb") as f:
            entry = pickle.load(f)
        entry["version"] = PERSIST_VERSION + 1
        with open(path, "wb") as f:
            pickle.dump(entry, f)

        store2 = PlanStore(tmp_path)
        assert store2.load_plan("contraction", sig) is None
        assert store2.stats()["stale"] == 1
        cache2 = PlanCache()
        cache2.store = store2
        cache2.get(A, B, AX)
        assert cache2.builds == 1
        store3 = PlanStore(tmp_path)
        assert store3.load_plan("contraction", sig) is not None and store3.stats()["hits"] == 1

    @pytest.mark.parametrize("payload", [b"", b"garbage", b"\x80\x04X"])
    def test_corrupt_entry_is_a_counted_miss(self, tmp_path, payload):
        A, B = port_pair(4)
        sig = plan_signature(A, B, AX)
        store = PlanStore(tmp_path)
        path = store._plan_path("contraction", sig)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(payload)
        assert store.load_plan("contraction", sig) is None
        assert store.stats()["corrupt"] == 1

    def test_truncated_entry_rebuilt(self, tmp_path):
        A, B = port_pair(6)
        sig = plan_signature(A, B, AX)
        store = PlanStore(tmp_path)
        cache = PlanCache()
        cache.store = store
        cache.get(A, B, AX)
        path = store._plan_path("contraction", sig)
        with open(path, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(data[: len(data) // 2])

        store2 = PlanStore(tmp_path)
        cache2 = PlanCache()
        cache2.store = store2
        cache2.get(A, B, AX)
        assert store2.stats()["corrupt"] == 1 and cache2.builds == 1 and store2.stats()["saves"] == 1
        assert PlanStore(tmp_path).load_plan("contraction", sig) is not None

    def test_foreign_kind_rejected(self, tmp_path):
        A, B = port_pair(7)
        sig = plan_signature(A, B, AX)
        store = PlanStore(tmp_path)
        cache = PlanCache()
        cache.store = store
        cache.get(A, B, AX)
        src, dst = store._plan_path("contraction", sig), store._plan_path("decomp", sig)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        with open(src, "rb") as f, open(dst, "wb") as g:
            g.write(f.read())
        assert store.load_plan("decomp", sig) is None
        assert store.stats()["corrupt"] == 1

    def test_stored_plans_hold_no_device_tables(self, tmp_path):
        """A plan that ran uploads its tables; the stored copy has none (they
        belong to the process that uploaded them) and uploads them again at
        first use, with the same result."""
        A, B = port_pair(8)
        eng = ContractionEngine(backend="batched")
        want = eng(A, B, AX)
        plan = eng.cache.get(A, B, AX)
        assert plan.batched.dev_idx
        plan.csr.device_tables(torch.device("cpu"))
        plan.csr.work.tables(torch.device("cpu"))
        loaded = pickle.loads(pickle.dumps(plan))
        assert loaded.batched.dev_idx == {} and loaded.batched._host == {}
        assert loaded.csr.dev_idx == {} and loaded.csr.work._dev == {}
        cache = PlanCache()
        cache._plans[plan.signature] = loaded
        got = ContractionEngine(backend="batched", cache=cache)(A, B, AX)
        for k in want.blocks:
            assert torch.equal(got.blocks[k], want.blocks[k])


class TestStructureRecords:
    def test_records_round_trip_under_their_fingerprint(self, tmp_path):
        A, B = port_pair(9)
        store = PlanStore(tmp_path)
        rec = ("env", "left", "float64", (persist.structure_of(A), persist.structure_of(B), persist.structure_of(A)))
        store.note_structure(rec, "cpu")
        store.note_structure(rec, "cpu")  # one record per structure
        assert store.stats()["structure_pending"] == 1
        assert store.flush() == 1 and store.flush() == 0
        again = PlanStore(tmp_path)
        assert again.structures("cpu") == [rec]
        assert again.stats()["structure_loads"] == 1

    def test_other_fingerprints_and_corrupt_files_are_not_read(self, tmp_path):
        store = PlanStore(tmp_path)
        fp = persist.port_fingerprint("cpu")
        other = (fp[0], "0.0.0") + fp[2:]
        path = store._structure_path(fp)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:  # a file named for this fingerprint holding another's records
            pickle.dump({"version": PERSIST_VERSION, "fingerprint": other, "records": [("svd", "float64", (1, 2, 2))]},
                        f)
        assert store.structures("cpu") == [] and store.stats()["structure_corrupt"] == 1
        with open(path, "wb") as f:
            f.write(b"torn")
        assert store.structures("cpu") == [] and store.stats()["structure_corrupt"] == 2


class TestActivation:
    def test_using_store_scopes_and_restores(self, tmp_path):
        assert persist.active_store() is None
        with persist.using_store(str(tmp_path)) as s1:
            assert persist.active_store() is s1
            with persist.using_store(str(tmp_path / "inner")) as s2:
                assert persist.active_store() is s2
            assert persist.active_store() is s1
        assert persist.active_store() is None

    def test_run_dmrg_plan_store_detaches_after_run(self, tmp_path):
        space, terms = MODEL_BUILDERS["heisenberg"](4)
        res = run_dmrg(space, terms, 4, bond_schedule=(8,), sweeps_per_bond=1, davidson_iters=2, algo="list",
                       plan_store=str(tmp_path), device="cpu")
        assert persist.active_store() is None
        assert res.energy < 0
        assert os.path.isdir(os.path.join(PlanStore(tmp_path).root, "contraction"))


class TestPrimedEqualsCold:
    """A run on a primed store (every plan loaded, none built) lands on the
    cold run's energies bit for bit, and on ED."""

    @pytest.mark.parametrize("j2,n", [(0.0, 4), (0.37, 6), (1.0, 6)])
    def test_primed_equals_cold_energy(self, tmp_path, j2, n):
        space, terms = MODEL_BUILDERS["j1j2_ladder"](n, J1=1.0, J2=j2)
        kw = dict(bond_schedule=(8,), sweeps_per_bond=2, davidson_iters=4, algo="batched", jit_matvec=True,
                  device="cpu", plan_store=str(tmp_path))
        cold = run_dmrg(space, terms, n, **kw)
        primed = run_dmrg(space, terms, n, **kw)
        assert builds(cold) > 0 and builds(primed) == 0, "a primed store must satisfy every plan miss"
        assert cold.energies == primed.energies
        e0 = ground_energy(space, terms, n, charge=total_charge(space, neel_states(space, n)))
        assert abs(primed.energy - e0) < 1e-8


class TestEDCrossCheck:
    @pytest.mark.parametrize("model", sorted(MODEL_BUILDERS))
    def test_ground_energy_matches_ed_l8(self, model, tmp_path):
        n = 8
        space, terms = MODEL_BUILDERS[model](n)
        e0 = ground_energy(space, terms, n, charge=total_charge(space, neel_states(space, n)))
        res = run_dmrg(space, terms, n, bond_schedule=(8, 16, 32), sweeps_per_bond=2, davidson_iters=6,
                       algo="auto", jit_matvec=True, plan_store=str(tmp_path), device="cpu")
        assert abs(res.energy - e0) < 1e-8, (model, res.energy, e0)


def _python(code: str, *args, timeout: float = 300.0) -> str:
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code), *map(str, args)], capture_output=True,
                          text=True, timeout=timeout, env=SUB_ENV)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    return proc.stdout


class TestConcurrentAccess:
    def test_two_process_store_access(self, tmp_path):
        """Two processes writing the same entries at once: every write is
        whole, both succeed, a fresh reader reads them all."""
        code = """
        import sys
        from repro_torch.dist.persist import PlanStore

        store = PlanStore(sys.argv[1])
        seed = int(sys.argv[2])
        for rounds in range(20):
            for i in range(10):
                sig = ("shared", i)
                assert store.save_plan("contraction", sig, ("plan-payload", seed, rounds, i, "x" * 4096))
                got = store.load_plan("contraction", sig)
                assert got is not None and got[0] == "plan-payload", got
        st = store.stats()
        assert st["corrupt"] == 0 and st["stale"] == 0, st
        print("WORKER_OK", st["saves"], st["hits"])
        """
        store_dir = tmp_path / "store"
        procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(code), str(store_dir), str(seed)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                  env=SUB_ENV) for seed in (1, 2)]
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-2000:]
            assert "WORKER_OK" in out
        reader = PlanStore(store_dir)
        for i in range(10):
            assert reader.load_plan("contraction", ("shared", i)) is not None
        st = reader.stats()
        assert st["corrupt"] == 0 and st["hits"] == 10, st


COLD_START = """
import json, sys
from repro_torch.core import run_dmrg
from repro_torch.serve.problems import MODEL_BUILDERS

space, terms = MODEL_BUILDERS["j1j2_ladder"](8)
res = run_dmrg(space, terms, 8, bond_schedule=(8, 16), sweeps_per_bond=1, davidson_iters=4, algo="batched",
               jit_matvec=True, device="cpu", plan_store=sys.argv[1])
print("COLD_START " + json.dumps(dict(
    energies=res.energies, plan_builds=res.engine_stats["plan_builds"], warmup=res.warmup,
    sweep_captures=sum(s.graphs["graph_captures"] for s in res.sweep_stats))))
"""


@pytest.fixture(scope="module")
def cold_start(tmp_path_factory):
    """One process primes a store, a fresh one runs on it."""
    store = tmp_path_factory.mktemp("cold_start")

    def run():
        out = _python(COLD_START, store)
        return json.loads(next(l for l in out.splitlines() if l.startswith("COLD_START "))[len("COLD_START "):])

    return run(), run()


class TestColdStart:
    def test_primed_process_builds_no_plan(self, cold_start):
        cold, primed = cold_start
        assert cold["plan_builds"] > 0 and primed["plan_builds"] == 0
        assert primed["energies"] == cold["energies"]

    def test_primed_process_captures_only_in_warmup(self, cold_start):
        cold, primed = cold_start
        assert cold["sweep_captures"] > 0 and cold["warmup"]["captures"] == 0
        assert primed["warmup"]["captures"] == cold["sweep_captures"]
        assert primed["sweep_captures"] == 0
