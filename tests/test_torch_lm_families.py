"""The port's remaining LM families (the dense configs, MoE, the RG-LRU
hybrid with windowed attention, the VLM, Whisper and the int8 KV cache)
held against the reference at ``smoke()`` size in float32, on the same
parameters and inputs.

The reference's random parameters cross over as numpy arrays
(``lm_params_from_numpy``), inputs come from ``np.random.default_rng``.
The tolerances are the reference's own (``tests/test_models.py``): 1e-4
for whole-model logits and for a layer against the reference's layer (the
two frameworks sum in other orders), 2e-3 for cached decode against the
full forward.  Each reference function is jitted once per config.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_config as j_get_config
from repro.models import attention as jatt
from repro.models import moe as jmoe
from repro.models import rglru as jrg
from repro.models.whisper import whisper_prime_cache as j_prime
from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.convert import convert_cache, lm_params_from_numpy
from repro_torch.models import attention as att
from repro_torch.models import moe, rglru
from repro_torch.models.whisper import whisper_prime_cache

NEW_ARCHS = ["codeqwen15_7b", "granite_3_2b", "qwen15_110b", "qwen2_moe_a27b", "moonshot_v1_16b_a3b",
             "recurrentgemma_2b", "pixtral_12b", "whisper_tiny"]
B, S = 2, 12
TOL, DECODE_TOL = 1e-4, 2e-3


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


@functools.cache
def setup(arch, int8=False):
    """(port cfg, reference cfg, reference params, port params, jitted
    reference forward and decode step) of ``arch`` at smoke size."""
    pc, jc = get_config(arch).smoke(), j_get_config(arch).smoke()
    if int8:
        pc, jc = (dataclasses.replace(c, kv_cache_dtype="int8") for c in (pc, jc))
    jp, _ = jmodels.init(jc, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, pc, device="cpu")
    jfwd = jax.jit(lambda p, b: jmodels.forward(jc, p, b))
    jstep = jax.jit(lambda p, c, tok, pos: jmodels.decode_step(jc, p, c, tok, pos))
    return pc, jc, jp, tp, jfwd, jstep


def inputs(cfg, s=S, seed=3):
    """numpy batch of ``s`` tokens (after the patches of a VLM), with the
    VLM's patch or Whisper's frame embeddings."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["enc_embeds"] = rng.standard_normal((B, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)
    return batch


def port_batch(batch):
    return {k: (t(v).long() if k == "tokens" else t(v)) for k, v in batch.items()}


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_matches_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(j_get_config(arch))
    assert dataclasses.asdict(get_config(arch).smoke()) == dataclasses.asdict(j_get_config(arch).smoke())
    assert get_config(arch).param_count() == j_get_config(arch).param_count()


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_matches_reference(arch):
    pc, jc, jp, tp, jfwd, _ = setup(arch)
    batch = inputs(pc)
    want = jfwd(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got = models.forward(pc, tp, port_batch(batch))
    s_total = S + (pc.n_patches if pc.family == "vlm" else 0)
    assert tuple(got.shape) == tuple(want.shape) == (B, s_total, got.shape[-1])
    close(got, want)


def decode_both(arch, s=S, int8=False):
    """``s`` cached decode steps by the reference and by the port from a
    cache carried across with ``convert_cache`` (Whisper's primed by each
    package from the same frames): (port logits, reference logits, port
    cache, reference cache, tokens)."""
    pc, jc, jp, tp, _, jstep = setup(arch, int8)
    batch = inputs(pc, s)
    tok = batch["tokens"]
    jcache = jmodels.init_cache(jc, B, s)
    cache = convert_cache({k: np.asarray(v) for k, v in jcache.items()}, pc, device="cpu")
    if pc.family == "audio":
        jcache = j_prime(jc, jp, jcache, jnp.asarray(batch["enc_embeds"]))
        cache = whisper_prime_cache(pc, tp, cache, t(batch["enc_embeds"]))
        for name in ("cross_k", "cross_v"):
            close(cache[name], jcache[name])
    want, got = [], []
    for i in range(s):
        jl, jcache = jstep(jp, jcache, jnp.asarray(tok[:, i]), jnp.int32(i))
        logits, cache = models.decode_step(pc, tp, cache, t(tok[:, i]).long(), i)
        want.append(np.asarray(jl))
        got.append(logits.numpy().copy())
    return np.stack(got, 1), np.stack(want, 1), cache, jcache, batch


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_decode_matches_reference_and_own_forward(arch):
    """Cached decode step by step against the reference's decode (1e-4),
    caches included, and against the port's own forward (2e-3, the
    reference's bound); Whisper after ``whisper_prime_cache``."""
    pc, _, _, tp, _, _ = setup(arch)
    got, want, cache, jcache, batch = decode_both(arch)
    close(got, want)
    assert set(cache) == set(jcache)
    for k, v in jcache.items():
        close(cache[k], v)
    if pc.family == "vlm":  # the decode path runs on text alone, as in the reference
        batch = {"tokens": batch["tokens"], "patch_embeds": np.zeros((B, 0, pc.d_model), np.float32)}
    full = models.forward(pc, tp, port_batch(batch))
    close(got, full.numpy(), DECODE_TOL)


def test_ring_cache_past_the_window():
    """recurrentgemma's local window (16 at smoke size) as a ring cache of
    16 slots over 40 decode steps, against the reference's decode and
    against the port's forward (which at 40 > 2W takes the block-local
    form)."""
    pc, _, _, tp, _, _ = setup("recurrentgemma_2b")
    s = 40
    got, want, cache, jcache, batch = decode_both("recurrentgemma_2b", s)
    assert cache["blocks/L2/k"].shape[2] == pc.local_window < s
    close(got, want)
    for k, v in jcache.items():
        close(cache[k], v)
    close(got, models.forward(pc, tp, port_batch(batch)).numpy(), DECODE_TOL)


@pytest.mark.parametrize("arch", ["llama3_8b", "recurrentgemma_2b"])
def test_int8_cache_matches_reference(arch):
    """The int8 KV cache (absmax per token and head, round half to even):
    the values and scales written equal the reference's, and the decode's
    logits agree to 1e-4; recurrentgemma's is also a ring past its
    window."""
    s = 20
    got, want, cache, jcache, _ = decode_both(arch, s, int8=True)
    assert any(v.dtype == torch.int8 for v in cache.values())
    close(got, want)
    for k, v in jcache.items():
        if cache[k].dtype == torch.int8:
            assert cache[k].dtype == torch.int8 and np.array_equal(cache[k].numpy(), np.asarray(v)), k
        else:
            close(cache[k], v)


@pytest.mark.parametrize("arch", NEW_ARCHS + ["int8"])
def test_convert_cache_layouts(arch):
    """convert_cache carries every cache layout across (stacked and
    remainder layers, ring KV, RG-LRU h/conv, int8 values and scales,
    Whisper's self and cross caches) with the port's shapes and dtypes."""
    pc, jc = get_config(arch if arch != "int8" else "recurrentgemma_2b").smoke(), None
    if arch == "int8":
        pc = dataclasses.replace(pc, kv_cache_dtype="int8", n_layers=5)
    jc = j_get_config(pc.name).smoke()
    jc = dataclasses.replace(jc, kv_cache_dtype=pc.kv_cache_dtype, n_layers=pc.n_layers)
    rng = np.random.default_rng(0)
    jcache = {k: np.asarray(v) for k, v in jmodels.init_cache(jc, 3, 40).items()}
    jcache = {k: (rng.integers(-127, 128, v.shape) if v.dtype == np.int8 else rng.standard_normal(v.shape)).astype(v.dtype)
              for k, v in jcache.items()}
    cache = convert_cache(jcache, pc, device="cpu")
    mine = models.init_cache(pc, 3, 40, "cpu")
    assert set(cache) == set(mine) == set(jcache)
    for k, v in jcache.items():
        assert cache[k].shape == mine[k].shape and cache[k].dtype == mine[k].dtype, k
        assert np.array_equal(cache[k].numpy(), v), k


def moe_weights(seed, d=16, e=8, f=32, tie=False):
    rng = np.random.default_rng(seed)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.3 for s in ((d, e), (e, d, f), (e, d, f), (e, f, d))]
    if tie:  # experts 2 and 5 get the same router column: their logits tie exactly
        ws[0][:, 5] = ws[0][:, 2]
    return ws


@pytest.mark.parametrize("tie", [False, True])
def test_moe_drops_and_ties_as_the_reference(tie):
    """moe_ffn at capacity_factor=1.0 (slots are dropped) against the
    reference's, 1e-4; with two experts whose router logits tie, the
    lower index is taken first, as ``lax.top_k`` does."""
    x = np.random.default_rng(7).standard_normal((2, 32, 16)).astype(np.float32)
    ws = moe_weights(1, tie=tie)
    want = jmoe.moe_ffn(jnp.asarray(x), *map(jnp.asarray, ws), top_k=2, capacity_factor=1.0)
    got = moe.moe_ffn(t(x), *map(t, ws), top_k=2, capacity_factor=1.0)
    close(got, want)
    probs = torch.softmax(t(x) @ t(ws[0]), -1)
    _, idx = moe.select_top_k(probs, 2)
    cap = int(np.ceil(32 * 2 / 8 * 1.0))
    counts = torch.stack([torch.bincount(row.reshape(-1), minlength=8) for row in idx])
    assert int((counts - cap).clamp(min=0).sum()) > 0  # some slots were dropped
    if tie:
        has2, has5 = (idx == 2).any(-1), (idx == 5).any(-1)
        assert bool((has2 | ~has5).all())  # 5 is taken only beside 2, after it
        assert bool((idx[has5][:, 0] == 2).all())
        assert bool((idx[..., 1] == 2).any())  # where 2 is second, the tie leaves 5 out
        _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(ws[0]), -1), 2)
        assert np.array_equal(idx.numpy(), np.asarray(jidx))


def test_moe_sorted_matches_dense():
    x = np.random.default_rng(8).standard_normal((2, 32, 16)).astype(np.float32)
    ws = [t(w) for w in moe_weights(2)]
    y_sorted = moe.moe_ffn(t(x), *ws, top_k=2, capacity_factor=8.0)
    y_dense = moe.moe_ffn(t(x), *ws, top_k=2, dispatch="dense")
    close(y_sorted, y_dense)


def test_moe_routing_tape_replays_the_recorded_experts():
    """A recorded routing replayed under another router: every token goes
    to the recorded experts, weighted by its own router's probabilities at
    them (renormalised); the same router replays its own output exactly."""
    x = t(np.random.default_rng(9).standard_normal((2, 32, 16)).astype(np.float32))
    ws = [t(w) for w in moe_weights(3)]
    other = t(np.random.default_rng(4).standard_normal((16, 8)).astype(np.float32))
    with moe.routing_tape() as tape:
        y0 = moe.moe_ffn(x, *ws, top_k=2, capacity_factor=8.0)
    assert len(tape) == 1 and moe._TAPE is None
    with moe.routing_tape(replay=tape):
        assert torch.equal(moe.moe_ffn(x, *ws, top_k=2, capacity_factor=8.0), y0)
    with moe.routing_tape(replay=tape) as again:
        got = moe.moe_ffn(x, other, *ws[1:], top_k=2, capacity_factor=8.0)
    assert len(again) == 1 and torch.equal(again[0], tape[0])
    idx = tape[0]
    w = torch.gather(torch.softmax(x @ other, -1), -1, idx)
    w = w / w.sum(-1, keepdim=True)
    h = torch.nn.functional.silu(torch.einsum("bsd,edf->bsef", x, ws[1])) * torch.einsum("bsd,edf->bsef", x, ws[2])
    y_all = torch.einsum("bsef,efd->bsed", h, ws[3])
    want = (torch.gather(y_all, 2, idx[..., None].expand(-1, -1, -1, 16)) * w[..., None]).sum(2)
    close(got, want)
    assert not torch.equal(moe.select_top_k(torch.softmax(x @ other, -1), 2)[1], idx)  # the routing was pinned


@pytest.mark.parametrize("arch", ["qwen2_moe_a27b", "moonshot_v1_16b_a3b"])
def test_moe_routing_tape_pins_a_whole_forward(arch):
    """One recorded choice per MoE layer; the forward replayed on it
    reproduces the recorded forward, bit for bit."""
    pc, _, _, tp, _, _ = setup(arch)
    batch = port_batch(inputs(pc))
    with moe.routing_tape() as tape:
        want = models.forward(pc, tp, batch)
    assert len(tape) == pc.n_layers and all(tuple(i.shape) == (B, S, pc.top_k) for i in tape)
    with moe.routing_tape(replay=tape) as again:
        got = models.forward(pc, tp, batch, use_kernel=False)
    assert len(again) == len(tape) and torch.equal(got, want)


def test_rglru_block_from_a_state_matches_reference():
    """rglru_block with a carried h0 and conv state against the
    reference's associative scan."""
    d, c, w = 16, 24, 4
    reg_params = {}
    rng = np.random.default_rng(4)
    for name, shape, scale in (("w_x", (d, c), 0.25), ("w_gate", (d, c), 0.25), ("w_out", (c, d), 0.2),
                               ("conv_w", (w, c), 0.5), ("conv_b", (c,), 0.1), ("w_a", (c, c), 0.1),
                               ("b_a", (c,), 0.5), ("w_i", (c, c), 0.1), ("b_i", (c,), 0.5), ("lam", (c,), 1.0)):
        reg_params[name] = (rng.standard_normal(shape) * scale).astype(np.float32)
    x = rng.standard_normal((2, 37, d)).astype(np.float32)
    h0 = rng.standard_normal((2, c)).astype(np.float32)
    conv0 = rng.standard_normal((2, w - 1, c)).astype(np.float32)
    jout, (jh, jconv) = jrg.rglru_block({k: jnp.asarray(v) for k, v in reg_params.items()}, jnp.asarray(x),
                                        h0=jnp.asarray(h0), conv_state=jnp.asarray(conv0))
    out, (h, conv) = rglru.rglru_block({k: t(v) for k, v in reg_params.items()}, t(x), h0=t(h0), conv_state=t(conv0))
    close(out, jout)
    close(h, jh)
    close(conv, jconv)


def test_linear_scan_matches_the_recurrence():
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, (2, 45, 3)))
    b = torch.from_numpy(rng.standard_normal((2, 45, 3)))
    h, want = torch.zeros(2, 3, dtype=torch.float64), []
    for i in range(45):
        h = a[:, i] * h + b[:, i]
        want.append(h)
    torch.testing.assert_close(rglru.linear_scan(a, b), torch.stack(want, 1), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("s", [12, 16, 24, 32, 40])
def test_windowed_attention_matches_reference(s):
    """Local window W=16: S <= W (the flash path; the band is vacuous),
    W < S <= 2W (banded softmax) and S > 2W (block-local, padded), with
    GQA, against the reference's causal_attention(local_window=)."""
    rng = np.random.default_rng(s)
    q = rng.standard_normal((2, s, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, s, 2, 8)).astype(np.float32) for _ in range(2))
    want = jatt.causal_attention(*map(jnp.asarray, (q, k, v)), local_window=16)
    close(att.causal_attention(t(q), t(k), t(v), local_window=16), want)


def test_cross_and_banded_decode_attention_match_reference():
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 11, 2, 8)).astype(np.float32) for _ in range(2))
    close(att.cross_attention(t(q), t(k), t(v)), jatt.cross_attention(*map(jnp.asarray, (q, k, v))))
    q1 = q[:, :1]
    want = jatt.decode_attention(*map(jnp.asarray, (q1, k, v)), jnp.int32(8), local_window=4)
    close(att.decode_attention(t(q1), t(k), t(v), 8, local_window=4), want)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_step_on_make_batch(arch):
    """make_prefill_step on make_batch's tensors: a VLM's patches count
    in the sequence, Whisper's frames beside it."""
    from repro_torch.launch.specs import make_batch, make_prefill_step

    pc, _, _, tp, _, _ = setup(arch)
    batch = make_batch(pc, 3, 16, torch.Generator().manual_seed(0), "cpu")
    if pc.family == "vlm":
        assert batch["tokens"].shape == (3, 16 - pc.n_patches) and batch["patch_embeds"].shape[1] == pc.n_patches
    if pc.family == "audio":
        assert batch["enc_embeds"].shape == (3, pc.enc_seq_len, pc.d_model)
    nxt = make_prefill_step(pc)(tp, batch)
    assert nxt.shape == (3, pc.vocab_size)
    torch.testing.assert_close(nxt, models.forward(pc, tp, batch)[:, -1, : pc.vocab_size], rtol=0, atol=0)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_main_runs_on_cpu(arch, capsys):
    from repro_torch.launch import serve

    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "3", "--gen-len", "4"]
    gen = serve.main(argv)
    assert gen.shape == (2, 4) and int(gen.min()) >= 0 and int(gen.max()) < get_config(arch).smoke().vocab_size
    assert "tok/s" in capsys.readouterr().out
    assert torch.equal(gen, serve.main(argv))  # weights, prompts and frames come from --seed
