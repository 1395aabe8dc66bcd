"""The port's training substrate and train step held against the
reference's (``repro.train``, ``repro.launch.specs.make_train_step``) on
the same numpy inputs, and its train CLI end to end on the CPU.

Tolerances: the optimizer to 1e-6 relative (both update in float32; the
frameworks round a fused multiply-add or not); compression bitwise in
bf16 and to one int8 step where a value sits on a rounding boundary;
data bitwise.  Three train steps from the reference's parameters, in
loss, grad norm and lr (relative), per parameter tensor (relative L2) and
per tensor's change over the three steps (relative L2 of p3 - p0 against
the reference's; a dropped update reads 1), to limits set per case from
what they read:

* llama3_8b, with one or two microbatches: 1e-5, changes 1e-4 (read at
  most 7e-7, changes 3.9e-5).
* rwkv6_3b: metrics 1e-4, parameters 1e-3 and changes 2e-3 (read 2.5e-5,
  2.3e-4 and 5.9e-4).
  Its gradients differ from the reference's by up to 8.4e-6 per tensor
  (the reference's chunked scan takes exponents as differences of
  cumulative sums, tests/test_torch_train_grads.py), and AdamW divides
  each gradient element by its own magnitude, so an element near zero
  (a few w_lora_a entries of ~5e-8 differ by 27%) moves by a visibly
  different share of lr; the steps after inherit that.
* rwkv6_3b with int8 compression: metrics 1e-3, parameters and changes
  1e-2 (read 1.0e-4, 1.6e-3 and 1.9e-3): the same differences, and a
  gradient element on an int8 rounding boundary may round to the
  neighbouring step of the grid.
* recurrentgemma_2b (its banded attention: 24 tokens over a window of
  16): metrics 1e-4, parameters 5e-4, changes 2e-3 (read 4.3e-7, 8.0e-5
  and 5.6e-4).  The RG-LRU's doubling scan sums in another order than the
  reference's associative scan (ROADMAP Queue 3: 1e-4), and AdamW's
  per-element division carries the difference into the changes, as for
  rwkv6_3b.
* pixtral_12b (8 patch embeddings before the tokens): metrics and
  parameters 1e-5, changes 1e-3 (read 2.7e-7, 3.5e-6 and 2.0e-4, the last
  in wq and w_up, whose near-zero gradient elements AdamW scales up).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_config as j_get_config
from repro.launch import specs as jspecs
from repro.train import compress as jcompress
from repro.train import optim as joptim
from repro.train.data import SyntheticLM as JSyntheticLM
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import specs
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.compress import compressed_grads, init_error_state, wire_bytes_saved
from repro_torch.train.data import SyntheticLM
from repro_torch.train.optim import OptConfig, adamw_update, init_opt_state, lr_at
from repro_torch.train.straggler import StepMonitor


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# ------------------------------------------------------------------ optimizer
class TestOptimizer:
    def test_adamw_matches_reference_with_clipping(self):
        """Five steps on a matrix, a vector (no decay) and a bias, with
        gradients past the clip, against the reference to 1e-6."""
        oc = OptConfig(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=0.5)
        jc = joptim.OptConfig(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=0.5)
        rng = np.random.default_rng(0)
        p0 = {"w": rng.standard_normal((6, 5)).astype(np.float32), "g": rng.standard_normal(5).astype(np.float32)}
        jp, tp = {k: jnp.asarray(v) for k, v in p0.items()}, {k: t(v) for k, v in p0.items()}
        js, ts = joptim.init_opt_state(jp), init_opt_state(tp)
        for _ in range(5):
            g = {k: (3.0 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in p0.items()}
            jp, js, jm = joptim.adamw_update(jc, jp, {k: jnp.asarray(v) for k, v in g.items()}, js)
            tp, ts, tm = adamw_update(oc, tp, {k: t(v) for k, v in g.items()}, ts)
            for name in ("grad_norm", "lr"):
                assert float(tm[name]) == pytest.approx(float(jm[name]), rel=1e-6)
            assert float(tm["grad_norm"]) > 0.5  # the clip binds
        assert int(ts["step"]) == int(js["step"]) == 5
        for k in p0:
            assert rel(tp[k], jp[k]) <= 1e-6
            assert rel(ts[f"m/{k}"], js[f"m/{k}"]) <= 1e-6 and rel(ts[f"v/{k}"], js[f"v/{k}"]) <= 1e-6

    def test_state_keys_and_dtypes(self):
        p = {"a": torch.zeros(3, 2, dtype=torch.bfloat16), "b": torch.zeros(4)}
        st = init_opt_state(p)
        assert set(st) == {"step", "m/a", "v/a", "m/b", "v/b"}
        assert st["step"].dtype == torch.int32 and st["m/a"].dtype == torch.float32
        new_p, _, _ = adamw_update(OptConfig(warmup_steps=0), p, {k: torch.ones_like(v) for k, v in p.items()}, st)
        assert new_p["a"].dtype == torch.bfloat16 and bool((new_p["a"] != 0).all())

    @pytest.mark.parametrize("step", [0, 5, 10, 55, 100, 150])
    def test_lr_schedule_matches_reference(self, step):
        oc = OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
        jc = joptim.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
        assert float(lr_at(oc, step)) == pytest.approx(float(joptim.lr_at(jc, jnp.int32(step))), rel=1e-6, abs=1e-12)

    def test_adamw_reduces_quadratic(self):
        oc = OptConfig(lr=0.1, warmup_steps=0, total_steps=100, weight_decay=0.0, grad_clip=1e9)
        params = {"w": torch.tensor([3.0, -2.0])}
        state = init_opt_state(params)
        for _ in range(200):
            params, state, _ = adamw_update(oc, params, {"w": 2 * params["w"]}, state)
        assert float(params["w"].abs().sum()) < 1e-2


# ---------------------------------------------------------------- compression
class TestCompression:
    @pytest.mark.parametrize("mode", ["bf16", "int8"])
    def test_matches_reference_with_error_state(self, mode):
        """Four steps of error feedback; the int8 grid's ties (g / scale a
        half integer) round half to even in both."""
        rng = np.random.default_rng(1)
        shapes = {"a": (40,), "b": (7, 3)}
        jerr = jcompress.init_error_state({k: jnp.zeros(s) for k, s in shapes.items()})
        terr = init_error_state({k: torch.zeros(s) for k, s in shapes.items()})
        for _ in range(4):
            g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
            g["a"][:4] = [0.5, 1.5, -2.5, 127.0]  # exact halves on the int8 grid of scale 1
            jq, jerr = jcompress.compressed_grads({k: jnp.asarray(v) for k, v in g.items()}, jerr, mode)
            tq, terr = compressed_grads({k: t(v) for k, v in g.items()}, terr, mode)
            for k in shapes:
                step = float(np.max(np.abs(np.asarray(jq[k])))) / 127 if mode == "int8" else 0.0
                assert np.max(np.abs(tq[k].numpy() - np.asarray(jq[k]))) <= step * 1.0001
                assert np.max(np.abs(terr[k].numpy() - np.asarray(jerr[k]))) <= step * 1.0001 + 1e-7

    @pytest.mark.parametrize("mode", ["bf16", "int8"])
    def test_error_feedback_bounds_error(self, mode):
        g0 = torch.Generator().manual_seed(3)
        err = init_error_state({"w": torch.zeros(64)})
        true_sum, applied = torch.zeros(64), torch.zeros(64)
        for _ in range(20):
            g = {"w": torch.randn(64, generator=g0)}
            true_sum += g["w"]
            cg, err = compressed_grads(g, err, mode)
            applied += cg["w"]
        torch.testing.assert_close(applied + err["w"], true_sum, rtol=1e-5, atol=1e-4)

    def test_wire_bytes_saved(self):
        p = {"a": torch.zeros(10, 3), "b": torch.zeros(5)}
        assert wire_bytes_saved(p, "bf16") == 70 and wire_bytes_saved(p, "int8") == 105


# ----------------------------------------------------------------------- data
class TestData:
    def test_batches_bitwise_equal_to_reference(self):
        jd, td = JSyntheticLM(300, 64, 10, seed=5), SyntheticLM(300, 64, 10, seed=5, device="cpu")
        for _ in range(3):
            jb, tb = next(jd), next(td)
            for k in ("tokens", "labels"):
                assert tb[k].dtype == torch.int64 and tb[k].device.type == "cpu"
                np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))

    def test_deterministic_and_restorable(self):
        d1 = SyntheticLM(100, 32, 4, seed=7, device="cpu")
        b1 = [next(d1) for _ in range(3)]
        st = d1.state_dict()
        b_next = next(d1)
        d2 = SyntheticLM(100, 32, 4, seed=7, device="cpu")
        d2.load_state_dict(st)
        assert torch.equal(next(d2)["tokens"], b_next["tokens"])
        assert not torch.equal(b1[0]["tokens"], b1[1]["tokens"])


# ----------------------------------------------------------------- checkpoint
class TestCheckpoint:
    def test_roundtrip_and_retention(self, tmp_path):
        cm = CheckpointManager(tmp_path, keep=2)
        for s in (1, 2, 3):
            cm.save(s, {"a": torch.arange(4) * s, "n": torch.tensor(s, dtype=torch.int32)}, meta={"s": s})
        assert cm.all_steps() == [2, 3]
        step, arrs, meta = cm.restore(device="cpu")
        assert step == 3 and meta["s"] == 3
        assert torch.equal(arrs["a"], torch.arange(4) * 3) and arrs["n"].dtype == torch.int32 and int(arrs["n"]) == 3

    def test_layout_and_bfloat16_through_uint16(self, tmp_path):
        x = torch.randn(5, 3).to(torch.bfloat16)
        cm = CheckpointManager(tmp_path)
        cm.save(7, {"p/w": x, "o/m/w": x.float()})
        d = tmp_path / "step_0000000007"
        manifest = json.loads((d / "manifest.json").read_text())
        assert manifest["arrays"]["p/w"] == {"shape": [5, 3], "dtype": "bfloat16"}
        assert manifest["arrays"]["o/m/w"]["dtype"] == "float32"
        assert np.load(d / "arrays.npz")["p/w"].dtype == np.uint16
        _, arrs, _ = cm.restore(7, device="cpu")
        assert arrs["p/w"].dtype == torch.bfloat16 and torch.equal(arrs["p/w"], x)
        assert torch.equal(arrs["o/m/w"], x.float())

    def test_async_save(self, tmp_path):
        cm = CheckpointManager(tmp_path, keep=3)
        cm.save_async(5, {"x": torch.ones(8, 8)}, meta={})
        cm.wait()
        assert cm.latest_step() == 5

    def test_async_error_surfaces_on_wait(self, tmp_path):
        cm = CheckpointManager(tmp_path, keep=3)
        cm.save_async(1, {"x": torch.ones(2)}, meta={"bad": object()})  # not JSON-able
        with pytest.raises(TypeError):
            cm.wait()
        assert cm.latest_step() is None and not list(tmp_path.glob(".tmp_step_*"))

    def test_partial_write_ignored(self, tmp_path):
        cm = CheckpointManager(tmp_path, keep=3)
        cm.save(1, {"x": torch.ones(2)})
        os.makedirs(tmp_path / "step_0000000002")
        (tmp_path / "step_0000000002" / "arrays.npz").write_bytes(b"junk")
        assert cm.latest_step() == 1


# ------------------------------------------------------------------ straggler
class TestStraggler:
    def test_detects_spike(self):
        mon = StepMonitor(warmup=3, sigma_mult=3.0, evict_after=2)
        for i in range(10):
            mon.stop(i, seconds=0.1)
        r = mon.stop(10, seconds=1.0)
        assert r is not None and not r.evict
        r = mon.stop(11, seconds=1.0)
        assert r is not None and r.evict

    def test_tolerates_noise(self):
        mon = StepMonitor(warmup=3)
        rng = np.random.default_rng(0)
        assert all(mon.stop(i, seconds=0.1 + 0.005 * rng.random()) is None for i in range(50))


# ----------------------------------------------------------------- train step
STEP_CASES = {  # (arch, n_micro, compress, metrics, parameter and update limits): see the module's docstring
    "llama3_8b": ("llama3_8b", 1, None, 1e-5, 1e-5, 1e-4),
    "rwkv6_3b": ("rwkv6_3b", 1, None, 1e-4, 1e-3, 2e-3),
    "llama3_8b-micro2": ("llama3_8b", 2, None, 1e-5, 1e-5, 1e-4),
    "rwkv6_3b-int8": ("rwkv6_3b", 1, "int8", 1e-3, 1e-2, 1e-2),
    "recurrentgemma_2b": ("recurrentgemma_2b", 1, None, 1e-4, 5e-4, 2e-3),
    "pixtral_12b": ("pixtral_12b", 1, None, 1e-5, 1e-5, 1e-3),
}


def _batches(cfg, n, seed=11):
    """``n`` batches of 4 x 24 tokens, with a VLM's patch embeddings drawn
    from ``seed`` beside them."""
    d = JSyntheticLM(cfg.vocab_size, 24, 4, seed=seed)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {k: np.asarray(v) for k, v in next(d).items()}
        if cfg.family == "vlm":
            b["patch_embeds"] = rng.standard_normal((4, cfg.n_patches, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


@pytest.fixture(scope="module", params=list(STEP_CASES))
def three_steps(request):
    """Per-step metrics and the final parameters of three steps of the
    reference's jitted train step and the port's, from the same parameters
    and batches: (case, initial params, (reference metrics, params, state),
    (port metrics, params, state))."""
    arch, n_micro, comp, *_ = STEP_CASES[request.param]
    jc, pc = j_get_config(arch).smoke(), get_config(arch).smoke()
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    jp, _ = jmodels.init(jc, jax.random.PRNGKey(0))
    p0 = {k: np.array(v) for k, v in jp.items()}
    tp = lm_params_from_numpy(p0, pc, device="cpu")
    js, ts = joptim.init_opt_state(jp), init_opt_state(tp)
    if comp:
        js.update({f"err/{k}": v for k, v in jcompress.init_error_state(jp).items()})
        ts.update({f"err/{k}": v for k, v in init_error_state(tp).items()})
    jstep = jax.jit(jspecs.make_train_step(jc, joptim.OptConfig(**kw), n_micro, compress=comp))
    tstep = specs.make_train_step(pc, OptConfig(**kw), n_micro, compress=comp)
    jm, tm = [], []
    for b in _batches(jc, 3):
        jp, js, m = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        jm.append({k: float(v) for k, v in m.items()})
        tp, ts, m = tstep(tp, ts, {k: t(v) if v.dtype == np.float32 else t(v).long() for k, v in b.items()})
        tm.append({k: float(v) for k, v in m.items()})
    return (request.param, p0, (jm, {k: np.asarray(v) for k, v in jp.items()}, js),
            (tm, {k: v.numpy() for k, v in tp.items()}, ts))


def test_train_step_metrics_match_reference(three_steps):
    case, _, (jm, _, _), (tm, _, _) = three_steps
    limit = STEP_CASES[case][3]
    for want, got in zip(jm, tm):
        for name in ("loss", "grad_norm", "lr"):
            assert np.isfinite(got[name]) and got[name] == pytest.approx(want[name], rel=limit), name


def test_train_step_params_match_reference(three_steps):
    case, _, (_, jp, js), (_, tp, ts) = three_steps
    limit = STEP_CASES[case][4]
    assert set(tp) == set(jp) and set(ts) == set(js)
    assert int(ts["step"]) == 3
    for k, w in jp.items():
        assert rel(tp[k], w) <= limit, (k, rel(tp[k], w))


def test_train_step_updates_match_reference(three_steps):
    """Each tensor's change over the three steps against the reference's
    change: a tensor whose update was dropped reads 1 here, where its
    parameters alone would read its small relative move."""
    case, p0, (_, jp, _), (_, tp, _) = three_steps
    limit = STEP_CASES[case][5]
    for k, w in jp.items():
        err = rel(tp[k] - p0[k], w - p0[k])
        assert err <= limit, (k, err)


def test_microbatches_cover_the_references():
    assert specs.MICROBATCHES == jspecs.MICROBATCHES


# ------------------------------------------------------------------------ CLI
def test_train_loop_end_to_end(tmp_path):
    """The CLI at its default batch (8 x 128) on the CPU: the loss drops
    over 12 steps; resume continues from the checkpoint at 12 to 16."""
    from repro_torch.launch.train import main

    common = ["--arch", "granite_3_2b", "--smoke", "--device", "cpu", "--log-every", "0",
              "--checkpoint-every", "6", "--checkpoint-dir", str(tmp_path)]
    losses = main(common + ["--steps", "12"])
    assert len(losses) == 12 and losses[-1] < losses[0]
    losses2 = main(common + ["--steps", "16", "--resume", "auto"])
    assert len(losses2) == 4  # resumed at 12, ran to 16
    assert CheckpointManager(tmp_path / "granite_3_2b").all_steps() == [6, 12]


def test_train_cli_refuses_model_parallel_mesh(tmp_path):
    """--mesh-model 2 needs a world of ranks it divides (torchrun); a plain
    process is a world of one, and the CLI refuses it."""
    from repro_torch.launch.train import main

    with pytest.raises(ValueError, match="does not divide the world of 1"):
        main(["--arch", "granite_3_2b", "--smoke", "--device", "cpu", "--mesh-model", "2",
              "--checkpoint-dir", str(tmp_path)])
