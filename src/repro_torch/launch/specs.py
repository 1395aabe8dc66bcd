"""Step functions and inputs of the LM paths: the reference's
``make_train_step`` (with ``MICROBATCHES``), ``make_prefill_step`` and
``make_decode_step``, and real batches in the shapes of its
``batch_specs``.  The dry-run cells, their shardings and HLO costing of
the reference's ``specs.py`` are ROADMAP Queue 1 #13 item 5."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .. import models
from ..device import resolve_device
from ..models.common import dtype_of
from ..train.optim import OptConfig, adamw_update


def make_batch(cfg, batch: int, seq_len: int, generator: torch.Generator, device=None) -> Dict[str, torch.Tensor]:
    """A prefill batch of real tensors drawn from ``generator``, shaped as
    the reference's ``batch_specs``: ``seq_len`` positions in all, of which
    a VLM's first ``n_patches`` are patch embeddings (so its ``tokens`` are
    ``seq_len - n_patches`` long); Whisper's ``enc_embeds`` are
    ``[batch, enc_seq_len, d_model]`` beside ``seq_len`` tokens."""
    dev = resolve_device(device)
    dt = dtype_of(cfg)
    out = {}
    s_text = seq_len
    if cfg.family == "vlm":
        s_text = seq_len - cfg.n_patches
        out["patch_embeds"] = torch.randn(batch, cfg.n_patches, cfg.d_model, generator=generator, device=dev).to(dt)
    if cfg.family == "audio":
        out["enc_embeds"] = torch.randn(batch, cfg.enc_seq_len, cfg.d_model, generator=generator, device=dev).to(dt)
    out["tokens"] = torch.randint(0, cfg.vocab_size, (batch, s_text), generator=generator, device=dev)
    return out


def make_prefill_step(cfg):
    def prefill(params, batch):
        logits = models.forward(cfg, params, batch)
        return logits[:, -1, : cfg.vocab_size]  # next-token logits

    return prefill


def make_decode_step(cfg):
    def decode(params, cache, token, pos):
        return models.decode_step(cfg, params, cache, token, pos)

    return decode


# ------------------------------------------------------------------- steps
# gradient-accumulation microbatches per (arch) for the reference's
# train_4k shape (they bounded its activation memory on 16 GiB TPU chips)
MICROBATCHES = {
    "qwen15_110b": 8,
    "pixtral_12b": 4,
    "llama3_8b": 2,
    "codeqwen15_7b": 2,
    "moonshot_v1_16b_a3b": 4,
    "qwen2_moe_a27b": 2,
    "rwkv6_3b": 4,
    "recurrentgemma_2b": 2,
}


def loss_and_grads(cfg, params: Dict, batch: Dict, *, use_kernel: bool = True) -> Tuple[torch.Tensor, Dict]:
    """(loss, gradient of every parameter in its dtype) of ``models.loss_fn``
    at ``params``, which need not require gradients themselves (the
    reference's ``jax.value_and_grad``)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = models.loss_fn(cfg, leaves, batch, use_kernel=use_kernel)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in zip(leaves, grads)}


def make_train_step(cfg, oc: OptConfig, n_micro: int = 1, compress: str | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the gradient of ``n_micro`` microbatches (float32 sums over
    the batch's leading axis cut in ``n_micro``, divided by ``n_micro``),
    compressed with error feedback when ``compress`` is "bf16" or "int8"
    (the ``err/`` keys ride in the optimizer state), then AdamW.  Updates
    ``params`` and ``opt_state`` in place (``adamw_update``)."""

    def train_step(params, opt_state, batch):
        if n_micro == 1:
            loss, grads = loss_and_grads(cfg, params, batch)
        else:
            gsum = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device) for k, v in params.items()}
            lsum = 0.0
            for i in range(n_micro):
                mb = {k: v.reshape((n_micro, v.shape[0] // n_micro) + tuple(v.shape[1:]))[i] for k, v in batch.items()}
                l, g = loss_and_grads(cfg, params, mb)
                for k in gsum:
                    gsum[k] += g[k].float()
                lsum = lsum + l
                del g
            grads = {k: v / n_micro for k, v in gsum.items()}
            loss = lsum / n_micro
        if compress:
            from ..train.compress import compressed_grads

            err = {k[4:]: v for k, v in opt_state.items() if k.startswith("err/")}
            opt_state = {k: v for k, v in opt_state.items() if not k.startswith("err/")}
            grads, new_err = compressed_grads(grads, err, compress)
        new_p, new_s, metrics = adamw_update(oc, params, grads, opt_state)
        if compress:
            new_s.update({f"err/{k}": v for k, v in new_err.items()})
        metrics["loss"] = loss
        return new_p, new_s, metrics

    return train_step
