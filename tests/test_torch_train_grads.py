"""The training loss of every architecture, and the gradient of every
parameter, held against the reference's ``jax.value_and_grad(loss_fn)``
at ``smoke()`` size in float32, on the same parameters and batch.

The reference's random parameters cross over as numpy arrays
(``lm_params_from_numpy``); tokens, labels (a share masked with -1) and a
VLM's patch or Whisper's frame embeddings come from
``np.random.default_rng``.  S=40 runs recurrentgemma_2b's local attention
past twice its window of 16 (the block-local form), and every other
family's causal attention over a ragged length.  On the CPU the port
differentiates its plain versions (flash attention's ``ref.py``, the
scan's recurrence) with autograd; the reference differentiates its jnp
paths with ``jax.grad``.

Tolerances, per parameter tensor as ||g_port - g_ref|| / ||g_ref||: 2e-5
for the attention families (read at most 1.6e-6: the frameworks sum in
other orders); 1e-4 for rwkv6_3b (read 8.4e-6: the reference's chunked
scan takes its exponents as differences of cumulative sums, the port's
plain version steps the recurrence).  The loss to the same relative
bounds.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_config as j_get_config
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.specs import loss_and_grads

ARCHS = ["llama3_8b", "rwkv6_3b", "codeqwen15_7b", "granite_3_2b", "qwen15_110b", "qwen2_moe_a27b",
         "moonshot_v1_16b_a3b", "recurrentgemma_2b", "pixtral_12b", "whisper_tiny"]
B, S = 2, 40
TOL = {"ssm": 1e-4}
DEFAULT_TOL = 2e-5


def batch_of(cfg, seed=0):
    """numpy batch: ``S`` positions in all (a VLM's patches first), labels
    with about one in eight masked."""
    rng = np.random.default_rng(seed)
    s_text = S - (cfg.n_patches if cfg.family == "vlm" else 0)
    labels = rng.integers(0, cfg.vocab_size, (B, s_text)).astype(np.int32)
    labels[rng.random((B, s_text)) < 0.125] = -1
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, s_text)).astype(np.int32), "labels": labels}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["enc_embeds"] = rng.standard_normal((B, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)
    return batch


def port_batch(batch):
    return {k: torch.from_numpy(v).long() if k in ("tokens", "labels") else torch.from_numpy(v)
            for k, v in batch.items()}


@functools.cache
def both(arch):
    """((loss, grads) of the reference, (loss, grads) of the port), numpy."""
    jc, pc = j_get_config(arch).smoke(), get_config(arch).smoke()
    jp, _ = jmodels.init(jc, jax.random.PRNGKey(0))
    batch = batch_of(jc)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: jmodels.loss_fn(jc, p, b)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = lm_params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, pc, device="cpu")
    tl, tg = loss_and_grads(pc, tp, port_batch(batch))
    return ((float(jl), {k: np.asarray(v) for k, v in jg.items()}),
            (float(tl), {k: v.numpy() for k, v in tg.items()}))


def tol(arch):
    return TOL.get(get_config(arch).family, DEFAULT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch):
    (want, _), (got, _) = both(arch)
    assert np.isfinite(got)
    assert abs(got - want) <= tol(arch) * abs(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    (_, want), (_, got) = both(arch)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        norm = np.linalg.norm(w)
        if norm == 0:  # a parameter the loss does not reach (rwkv6's mu_x)
            assert not got[k].any(), (arch, k)
            continue
        assert np.linalg.norm(got[k] - w) <= tol(arch) * norm, (arch, k, np.linalg.norm(got[k] - w) / norm)


@pytest.mark.parametrize("w0", [0.0, 3.0, 5.5])
def test_time_mix_gradients_at_strong_decays_match_float64(w0):
    """At strong decays (w0 = 3 and 5.5 put logw near -exp(3) and past
    -exp(5.5)) the reference's gradients through logw are off by orders of
    magnitude from a float64 stepwise oracle (its chunk exponents are
    differences of cumulative sums and are clipped at -60; ROADMAP Queue 3),
    so there the port's float32 gradients are held to the port's own
    recurrence in float64 instead, to 1e-4 per tensor (read up to 1.2e-5)."""
    from repro_torch.models import rwkv6
    from repro_torch.models.common import Registry

    d, h, n = 64, 4, 16
    reg = Registry(torch.Generator().manual_seed(0), torch.device("cpu"))
    rwkv6.time_mix_params(reg, "tm", d, h, n)
    p = {k[3:]: v for k, v in reg.params.items()}
    p["w0"] = torch.full((d,), w0)
    p["u"] = 0.1 * torch.randn(h, n, generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((B, 70, d)).astype(np.float32))

    def grads(dtype):
        leaves = {k: v.to(dtype, copy=True).requires_grad_(True) for k, v in p.items()}
        xx = x.to(dtype, copy=True).requires_grad_(True)
        (rwkv6.time_mix(leaves, xx, h, n)[0] ** 2).sum().backward()
        out = {k: v.grad for k, v in leaves.items() if v.grad is not None}
        return {**out, "x": xx.grad}

    got, want = grads(torch.float32), grads(torch.float64)
    assert set(got) == set(want)
    for k, w in want.items():
        norm = w.norm().item()
        err = (got[k].double() - w).norm().item()
        assert err <= 1e-4 * norm or (norm < 1e-30 and err < 1e-30), (w0, k, err, norm)
