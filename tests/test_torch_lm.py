"""The port's LM inference slice (llama3_8b and rwkv6_3b at smoke size)
held against the reference on the same parameters and tokens.

The reference's random parameters cross over as numpy arrays
(``lm_params_from_numpy``), so both packages run the same model.  The
tolerances are the reference's own (``tests/test_models.py``): 1e-4 for
whole-model float32 logits (the two frameworks sum in other orders),
rtol 1e-4 / atol 1e-5 for ``time_mix``, and 2e-3 for cached decode against
the full forward.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.models import rwkv6 as jrk
from repro.models.common import Registry as JRegistry
from repro_torch import models
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import convert_cache, lm_params_from_numpy
from repro_torch.models import rwkv6 as rk

ARCHS = ["llama3_8b", "rwkv6_3b"]
B, S = 2, 12


def configs(arch, tied=False):
    """The port's and the reference's smoke config of ``arch``."""
    pc, jc = get_config(arch).smoke(), j_get_config(arch).smoke()
    if tied:
        pc, jc = dataclasses.replace(pc, tie_embeddings=True), dataclasses.replace(jc, tie_embeddings=True)
    return pc, jc


def both_params(jc, pc, seed=0):
    jp, _ = jmodels.init(jc, jax.random.PRNGKey(seed))
    return jp, lm_params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, pc, device="cpu")


def tokens(cfg, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_config_matches_reference(arch):
    pc, jc = get_config(arch), j_get_config(arch)
    for tied in (False, True):
        a, b = dataclasses.replace(pc, tie_embeddings=tied), dataclasses.replace(jc, tie_embeddings=tied)
        assert dataclasses.asdict(a.smoke()) == dataclasses.asdict(b.smoke())
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)


def test_every_reference_architecture_resolves():
    """Every architecture of the reference resolves in the port, in the
    reference's order, and no family, window or cache type is refused."""
    assert ARCH_IDS == J_ARCH_IDS
    for arch in J_ARCH_IDS:
        cfg = get_config(arch)
        assert cfg.name == arch and dataclasses.asdict(cfg) == dataclasses.asdict(j_get_config(arch))
        smoke = cfg.smoke()
        params = models.init(smoke, torch.Generator().manual_seed(0), "cpu")
        assert models.init_cache(smoke, 1, 4, "cpu")
        assert models.init_cache(dataclasses.replace(smoke, kv_cache_dtype="int8"), 1, 4, "cpu")
        assert all(torch.isfinite(v.float()).all() for v in params.values())
    from repro_torch.models.attention import causal_attention

    q = torch.zeros(1, 40, 2, 16)
    assert causal_attention(q, q, q, local_window=16).shape == q.shape


@pytest.mark.parametrize("arch,tied", [("llama3_8b", False), ("llama3_8b", True), ("rwkv6_3b", False), ("rwkv6_3b", True)])
def test_forward_matches_reference(arch, tied):
    pc, jc = configs(arch, tied)
    jp, tp = both_params(jc, pc)
    tok = tokens(pc)
    want = jax.jit(lambda p, t: jmodels.forward(jc, p, {"tokens": t}))(jp, jnp.asarray(tok))
    got = models.forward(pc, tp, {"tokens": torch.from_numpy(tok).long()})
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference_and_own_forward(arch):
    """12 cached decode steps against the reference's decode (1e-4), from a
    cache carried across by ``convert_cache``, and against the port's own
    full forward (2e-3, the reference's bound)."""
    pc, jc = configs(arch)
    jp, tp = both_params(jc, pc)
    tok = tokens(pc)
    jcache = jmodels.init_cache(jc, B, S)
    cache = convert_cache({k: np.asarray(v) for k, v in jcache.items()}, pc, device="cpu")
    jstep = jax.jit(lambda p, c, t, pos: jmodels.decode_step(jc, p, c, t, pos))
    want, got = [], []
    for t in range(S):
        jl, jcache = jstep(jp, jcache, jnp.asarray(tok[:, t]), jnp.int32(t))
        logits, cache = models.decode_step(pc, tp, cache, torch.from_numpy(tok[:, t]).long(), t)
        want.append(np.asarray(jl))
        got.append(logits.numpy().copy())
    np.testing.assert_allclose(np.stack(got, 1), np.stack(want, 1), rtol=1e-4, atol=1e-4)
    for k, v in jcache.items():
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(v), rtol=1e-4, atol=1e-4)
    full = models.forward(pc, tp, {"tokens": torch.from_numpy(tok).long()})
    np.testing.assert_allclose(np.stack(got, 1), full.numpy(), rtol=2e-3, atol=2e-3)


def time_mix_params(seed=0, d=32, h=4, n=8):
    reg = JRegistry(jax.random.PRNGKey(seed))
    jrk.time_mix_params(reg, "tm", d, h, n, lora=8)
    jp = {k[3:]: v for k, v in reg.params.items()}
    # the init zeros mu, w0 and u, which would leave their paths untested
    rng = np.random.default_rng(seed)
    for key in ("mu_w", "mu_k", "mu_v", "mu_r", "mu_g", "w0", "u", "gn_g", "gn_b"):
        jp[key] = jnp.asarray(rng.uniform(-0.5, 0.5, jp[key].shape).astype(np.float32))
    return jp, {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jp.items()}


def test_time_mix_matches_reference():
    d, h, n = 32, 4, 8
    jp, tp = time_mix_params(d=d, h=h, n=n)
    x = (np.random.default_rng(1).standard_normal((2, 20, d)) * 0.5).astype(np.float32)
    jout, (js, jlast) = jrk.time_mix(jp, jnp.asarray(x), h, n, chunk=8)
    out, (s, last) = rk.time_mix(tp, torch.from_numpy(x), h, n)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=0, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_time_mix_bf16_feeds_float32_wkv_to_the_group_norm(seed, monkeypatch):
    """In bf16 the reference keeps the wkv output in float32 up to the group
    norm (``repro/models/rwkv6.py``, ``time_mix``); so does the port.  Then
    the whole bf16 ``time_mix`` is held to the reference's on the same
    numpy inputs, per element relative to the output's norm, to 1e-2: the
    reference rounds the pairwise decay, the scores and v to bf16 inside a
    chunk, where the port's scan computes in float32, and both round r, k,
    v, g and the output projection to bf16."""
    d, h, n = 64, 4, 16
    jp, tp = time_mix_params(seed=seed, d=d, h=h, n=n)
    jp = {k: v.astype(jnp.bfloat16) for k, v in jp.items()}
    tp = {k: v.to(torch.bfloat16) for k, v in tp.items()}
    x = (np.random.default_rng(seed + 10).standard_normal((2, 40, d)) * 0.5).astype(np.float32)
    seen = []
    group_norm = rk._group_norm
    monkeypatch.setattr(rk, "_group_norm", lambda a, *args: seen.append(a.dtype) or group_norm(a, *args))
    out, (s, _) = rk.time_mix(tp, torch.from_numpy(x).to(torch.bfloat16), h, n)
    assert seen == [torch.float32]
    assert out.dtype == torch.bfloat16 and s.dtype == torch.float32
    jout, _ = jrk.time_mix(jp, jnp.asarray(x).astype(jnp.bfloat16), h, n, chunk=8)
    want = np.asarray(jout.astype(jnp.float32))
    got = out.float().numpy()
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


def test_time_mix_decode_matches_reference():
    d, h, n = 32, 4, 8
    jp, tp = time_mix_params(seed=1, d=d, h=h, n=n)
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 5, d)) * 0.5).astype(np.float32)
    js = jnp.zeros((2, h, n, n), jnp.float32)
    jlast = jnp.zeros((2, d), jnp.float32)
    s, last = torch.zeros(2, h, n, n), torch.zeros(2, d)
    for t in range(5):
        jo, (js, jlast) = jrk.time_mix_decode(jp, jnp.asarray(x[:, t:t + 1]), js, jlast, h, n)
        o, (s, last) = rk.time_mix_decode(tp, torch.from_numpy(x[:, t:t + 1]), s, last, h, n)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4, atol=1e-5)


def test_time_mix_from_a_state_matches_reference():
    """Prefill that starts from a carried state and last token."""
    d, h, n = 32, 4, 8
    jp, tp = time_mix_params(seed=2, d=d, h=h, n=n)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 11, d)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((2, h, n, n)) * 0.1).astype(np.float32)
    x_last = (rng.standard_normal((2, d)) * 0.5).astype(np.float32)
    jout, (js, _) = jrk.time_mix(jp, jnp.asarray(x), h, n, state=jnp.asarray(s0), x_last=jnp.asarray(x_last), chunk=8)
    out, (s, _) = rk.time_mix(tp, torch.from_numpy(x), h, n, state=torch.from_numpy(s0), x_last=torch.from_numpy(x_last))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_is_the_last_position(arch):
    from repro_torch.launch.specs import make_prefill_step

    pc, _ = configs(arch)
    params = models.init(pc, torch.Generator().manual_seed(0), "cpu")
    tok = torch.from_numpy(tokens(pc)).long()
    nxt = make_prefill_step(pc)(params, {"tokens": tok})
    full = models.forward(pc, params, {"tokens": tok})
    assert nxt.shape == (B, pc.vocab_size)
    torch.testing.assert_close(nxt, full[:, -1, : pc.vocab_size], rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_on_cpu(arch, capsys):
    from repro_torch.launch import serve

    gen = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "3", "--prompt-len", "5", "--gen-len", "7"])
    assert gen.shape == (3, 7) and gen.dtype == torch.int64
    assert int(gen.min()) >= 0 and int(gen.max()) < get_config(arch).smoke().vocab_size
    assert "tok/s" in capsys.readouterr().out
    again = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "3", "--prompt-len", "5", "--gen-len", "7"])
    assert torch.equal(gen, again)  # weights and prompts come from --seed


def test_entry_points_default_to_cuda(monkeypatch):
    """device=None means the card: without one the LM entry points raise
    and name the way to ask for the CPU."""
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3_8b").smoke()
    calls = [
        lambda: models.init(cfg, torch.Generator().manual_seed(0)),
        lambda: models.init_cache(cfg, 2, 8),
        lambda: lm_params_from_numpy({}, cfg),
        lambda: convert_cache({"blocks/L0/k": np.zeros((2, 1, 8, 4, 16), np.float32)}, cfg),
        lambda: serve.main(["--arch", "llama3_8b", "--smoke"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_convert_rejects_foreign_layouts():
    pc, jc = configs("llama3_8b")
    jp, _ = jmodels.init(jc, jax.random.PRNGKey(0))
    arrays = {k: np.asarray(v) for k, v in jp.items()}
    with pytest.raises(ValueError, match="missing"):
        lm_params_from_numpy({k: v for k, v in arrays.items() if k != "ln_f"}, pc, device="cpu")
    arrays["embed"] = arrays["embed"][:, :8]
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_numpy(arrays, pc, device="cpu")
