"""Step functions, inputs and dry-run cells of the LM paths and of the
paper's DMRG workload.

The reference's ``make_train_step`` (with ``MICROBATCHES`` and
``grad_shardings``), ``make_prefill_step`` and ``make_decode_step``; real
batches in the shapes of its ``batch_specs``; and its cell builders for
the dry run (``launch/dryrun.py``): ``eval_params`` and ``batch_specs`` on
the meta device (shapes and dtypes, nothing allocated, as its
``jax.eval_shape``), ``lm_cell`` for every (architecture x input shape),
and the paper's Davidson matvec at production bond dimension,
``dmrg_cell`` (dense) and ``dmrg_list_cell`` (one distributed block per
quantum-number sector).  A cell is the reference's 5-tuple (fn, args,
in_shardings, out_shardings, donate_argnums): args are meta tensors,
shardings DTensor placements on the mesh (``launch/sharding.py``), and the
dry run distributes fake tensors onto them and runs ``fn``.  Donation has
no counterpart (the port's train step updates in place) and is kept for
the reader.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .. import models
from ..configs import SHAPES, get_config
from ..device import resolve_device
from ..models.common import dtype_of, is_dtensor, mesh_scope
from ..train.optim import OptConfig, adamw_update, init_opt_state, opt_state_axes
from .sharding import batch_axes_for, mesh_shape, placements_for, sharding_for, tree_shardings


def eval_params(cfg) -> Tuple[Dict, Dict]:
    """(params as meta tensors, logical axes) without allocating."""
    return models.meta_params(cfg), models.param_axes(cfg)


def batch_specs(cfg, shape_name: str, *, with_labels: bool) -> Tuple[Dict, Dict]:
    """(input tensors on the meta device, their logical axes) of a shape of
    ``SHAPES``: a VLM's patches count in the sequence, Whisper's frames
    beside it."""
    info = SHAPES[shape_name]
    b, s = info["global_batch"], info["seq_len"]
    dt = dtype_of(cfg)
    meta = torch.device("meta")
    specs = {}
    s_text = s
    if cfg.family == "vlm":
        s_text = s - cfg.n_patches
        specs["patch_embeds"] = torch.empty((b, cfg.n_patches, cfg.d_model), dtype=dt, device=meta)
    if cfg.family == "audio":
        specs["enc_embeds"] = torch.empty((b, cfg.enc_seq_len, cfg.d_model), dtype=dt, device=meta)
    specs["tokens"] = torch.empty((b, s_text), dtype=torch.int32, device=meta)
    if with_labels:
        specs["labels"] = torch.empty((b, s_text), dtype=torch.int32, device=meta)
    ba = batch_axes_for(cfg, shape_name)
    return specs, {k: ba[k] for k in specs}


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
    reference's ``jax.value_and_grad``).  Under a mesh each gradient comes
    back laid out as its parameter, and the loss replicated."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with mesh_scope(leaves):  # the backward's recompute makes plain tensors too
        loss = models.loss_fn(cfg, leaves, batch, use_kernel=use_kernel)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    out = {}
    for (k, p), g in zip(leaves.items(), grads):
        g = torch.zeros_like(p) if g is None else g
        if is_dtensor(g) and g.placements != p.placements:
            g = g.redistribute(p.device_mesh, p.placements)
        out[k] = g
    return _replicated(loss.detach()), out


def _replicated(t):
    """A DTensor scalar (a partial sum over the batch shards) as its full
    value, the same on every rank; a plain tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def _microbatches(batch: Dict, n_micro: int):
    """The batch cut in ``n_micro`` along its leading axis: a DTensor batch
    cut in each rank's shard, so each microbatch keeps the batch's
    placements (the reference's reshape to [n_micro, B / n_micro, ...],
    whose batch sharding stays on the inner axis)."""
    from ..models.common import like, local_part

    for i in range(n_micro):
        mb = {}
        for k, v in batch.items():
            lv = local_part(v)
            part = lv.reshape((n_micro, lv.shape[0] // n_micro) + tuple(lv.shape[1:]))[i]
            mb[k] = like(part, v, (v.shape[0] // n_micro,) + tuple(v.shape[1:]))
        yield mb


def make_train_step(cfg, oc: OptConfig, n_micro: int = 1, grad_shardings=None, compress: str | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the gradient of ``n_micro`` microbatches (float32 sums over
    the batch's leading axis cut in ``n_micro``, divided by ``n_micro``),
    compressed with error feedback when ``compress`` is "bf16" or "int8"
    (the ``err/`` keys ride in the optimizer state), then AdamW.  Updates
    ``params`` and ``opt_state`` in place (``adamw_update``).  Under a mesh
    ``grad_shardings`` (path -> placements) pins the float32 gradient sums,
    as the reference's ``with_sharding_constraint``."""

    def constrain(tree):
        if grad_shardings is None:
            return tree
        return {k: v.redistribute(v.device_mesh, grad_shardings[k]) if is_dtensor(v) else v for k, v in tree.items()}

    def train_step(params, opt_state, batch):
        if n_micro == 1:
            loss, grads = loss_and_grads(cfg, params, batch)
        else:
            gsum = constrain({k: torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()})
            lsum = 0.0
            for mb in _microbatches(batch, n_micro):
                l, g = loss_and_grads(cfg, params, mb)
                gsum = constrain({k: gsum[k] + g[k].float() for k in gsum})
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


# -------------------------------------------------------------------- cells
def lm_cell(arch: str, shape_name: str, mesh):
    """(fn, args, in_shardings, out_shardings, donate_argnums) of one dry-run
    cell: args as meta tensors, shardings as placements on ``mesh``."""
    cfg = get_config(arch)
    ok, why = cfg.shape_supported(shape_name)
    if not ok:
        raise ValueError(f"{arch} x {shape_name} skipped: {why}")
    info = SHAPES[shape_name]
    kind = info["kind"]
    params, paxes = eval_params(cfg)
    pshard = tree_shardings(params, paxes, mesh)
    repl = placements_for((), mesh)

    if kind == "train":
        oc = OptConfig()
        opt = init_opt_state(params)
        oshard = tree_shardings(opt, opt_state_axes(paxes), mesh)
        bspec, baxes = batch_specs(cfg, shape_name, with_labels=True)
        bshard = tree_shardings(bspec, baxes, mesh)
        fn = make_train_step(cfg, oc, MICROBATCHES.get(arch, 1), grad_shardings=pshard)
        metrics_shard = {"grad_norm": repl, "lr": repl, "loss": repl}
        return fn, (params, opt, bspec), (pshard, oshard, bshard), (pshard, oshard, metrics_shard), (0, 1)

    if kind == "prefill":
        bspec, baxes = batch_specs(cfg, shape_name, with_labels=False)
        bshard = tree_shardings(bspec, baxes, mesh)
        b = info["global_batch"]
        out_shard = sharding_for((b, cfg.vocab_size), ("batch", "seq"), mesh)
        return make_prefill_step(cfg), (params, bspec), (pshard, bshard), out_shard, ()

    # decode: one new token against a seq_len-deep cache
    from ..models.lm import padded_vocab

    b, s = info["global_batch"], info["seq_len"]
    cache = models.init_cache(cfg, b, s, device="meta")
    cshard = tree_shardings(cache, models.decode_cache_axes(cfg), mesh)
    token = torch.empty((b,), dtype=torch.int32, device="meta")
    lshard = sharding_for((b, padded_vocab(cfg)), ("batch", "vocab"), mesh)
    # the port's decode step takes the position as an int: the cache's last slot
    return (make_decode_step(cfg), (params, cache, token, s - 1), (pshard, cshard, repl, None),
            (lshard, cshard), (1,))


# ---------------------------------------------------------------- DMRG cell
DMRG_CELLS = {
    # the paper's production workloads (Sec. V-VI): two-site Davidson matvec
    # at large bond dimension, sparse-dense algorithm (dense distributed
    # tensors, single contraction call).  *_opt variants: bf16 storage with
    # float32 accumulation for the env tensors and the m^2*k*d^2
    # intermediates.
    "dmrg_spins": dict(m=32768, d=2, k=30, dtype="float32"),
    "dmrg_electrons": dict(m=16384, d=4, k=26, dtype="float32"),
    "dmrg_spins_opt": dict(m=32768, d=2, k=30, dtype="bfloat16"),
    "dmrg_electrons_opt": dict(m=16384, d=4, k=26, dtype="bfloat16"),
}

_STORE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def two_site_matvec(A, Wj, Wj1, B, x, store_dtype=None):
    """y[i,c,f,j] = A[i,k,l] x[l,s,t,r] Wj[k,c,s,n] Wj1[n,f,t,g] B[j,g,r]
    (Fig. 1d), as the reference's four einsums, each result stored in
    ``store_dtype`` (the last one float32).  Each product is a matmul or
    batched matmul whose merged dims keep a mesh-sharded dim (the bond
    dims i, l of A and x, r of x) first or apart, so that a DTensor
    operand stays evenly sharded through the reshapes."""
    m_i, k, _ = A.shape
    _, d1, d2, m_r = x.shape
    c, n = Wj.shape[1], Wj.shape[3]
    f, g = Wj1.shape[1], Wj1.shape[3]
    m_j = B.shape[0]
    store = (lambda t: t) if store_dtype is None else (lambda t: t.to(store_dtype))
    # t1[i,k,r,s,t] = A[i,k,l] x[l,s,t,r]
    t = store(A.reshape(m_i * k, -1) @ x.permute(0, 3, 1, 2).reshape(x.shape[0], m_r * d1 * d2))
    t = t.reshape(m_i, k, m_r, d1, d2)
    # t2[r,i,t,c,n] = t1[i,k,r,s,t] Wj[k,c,s,n]: batched over r
    lhs = t.permute(2, 0, 4, 1, 3).reshape(m_r, m_i * d2, k * d1)
    w = Wj.permute(0, 2, 1, 3).reshape(k * d1, c * n)
    t = store(torch.bmm(lhs, w.expand(m_r, k * d1, c * n))).reshape(m_r, m_i, d2, c, n)
    # t3[r,i,c,f,g] = t2[r,i,t,c,n] Wj1[n,f,t,g]: batched over r
    lhs = t.permute(0, 1, 3, 2, 4).reshape(m_r, m_i * c, d2 * n)
    w = Wj1.permute(2, 0, 1, 3).reshape(d2 * n, f * g)
    t = store(torch.bmm(lhs, w.expand(m_r, d2 * n, f * g))).reshape(m_r, m_i, c, f, g)
    # y[i,c,f,j] = t3[r,i,c,f,g] B[j,g,r]
    lhs = t.permute(1, 2, 3, 0, 4).reshape(m_i * c * f, m_r * g)
    y = lhs @ B.permute(2, 1, 0).reshape(m_r * g, m_j)
    return y.float().reshape(m_i, c, f, m_j)


def dmrg_davidson_fn(m: int, d: int, k: int, store_dtype=torch.float32):
    """One Davidson iteration body (paper Alg. 1 step): y = K x via the
    environment contraction of Fig. 1d (``two_site_matvec``), Rayleigh
    quotient, residual norm.  Tensors are dense (sparse-dense algorithm)
    and sharded over the FULL mesh.  Each contraction accumulates in
    float32 (torch's products do, in every storage dtype) and its result
    is stored in ``store_dtype``; y and the reductions are float32."""

    def step(A, Wj, Wj1, B, x):
        y = two_site_matvec(A, Wj, Wj1, B, x, store_dtype)
        xf = x.float()
        lam = torch.sum(xf * y)                        # <x|K|x> (x normalized)
        resid = y - lam * xf
        rnorm = torch.sqrt(torch.sum(resid * resid))
        xnew = (resid / (rnorm + 1e-30)).to(x.dtype)
        return lam, rnorm, xnew

    return step


def _data_axes(mesh):
    return ("pod", "data") if "pod" in mesh_shape(mesh) else "data"


def dmrg_cell(name: str, mesh):
    p = DMRG_CELLS[name]
    m, d, k = p["m"], p["d"], p["k"]
    dt = _STORE[p["dtype"]]
    meta = torch.device("meta")
    A = torch.empty((m, k, m), dtype=dt, device=meta)
    W = torch.empty((k, d, d, k), dtype=dt, device=meta)
    x = torch.empty((m, d, d, m), dtype=dt, device=meta)
    sh_env = placements_for((_data_axes(mesh), None, "model"), mesh)
    sh_w = placements_for((), mesh)
    sh_x = placements_for((_data_axes(mesh), None, None, "model"), mesh)
    fn = dmrg_davidson_fn(m, d, k, store_dtype=dt)
    return fn, (A, W, W, A, x), (sh_env, sh_w, sh_w, sh_env, sh_x), (sh_w, sh_w, sh_x), ()


# ------------------------------------------------- DMRG list-algorithm cell
def empirical_block_dims(m: int, q: float, r: float, pad: int = 16):
    """The paper's fitted block model: b_l = floor((m/q) r^l) (Table II).

    ``pad`` rounds each block up to a multiple of the mesh-axis size so every
    block 2-D-shards over the full mesh (unpadded, the 4915-dim block
    replicates; Cyclops handles arbitrary dims with cyclic layouts, the
    reference pads instead, ~+6% flops)."""
    dims, b = [], m / q
    while int(b) >= 1 and sum(dims) < m:
        dims.append(max(pad, ((int(b) + pad - 1) // pad) * pad))
        b *= r
    return dims


def list_matvec_fn(x_keys):
    """The list algorithm's matvec over the theta blocks keyed (i, s1, s2,
    j): y = K x block by block, then the Rayleigh quotient, the residual
    norm and the new vector, as ``dmrg_davidson_fn``."""

    def list_matvec(A_list, Wj, Wj1, B_list, xs):
        ys = []
        for (i, s1, s2, j), xb in zip(x_keys, xs):
            ys.append(two_site_matvec(A_list[i], Wj, Wj1, B_list[j], xb))
        lam = sum(torch.sum(xb * yb) for xb, yb in zip(xs, ys))
        rn = torch.sqrt(sum(torch.sum((yb - lam * xb) ** 2) for xb, yb in zip(xs, ys)))
        xnew = tuple((yb - lam * xb) / (rn + 1e-30) for xb, yb in zip(xs, ys))
        return lam, rn, xnew

    return list_matvec


def dmrg_list_cell(name: str, mesh):
    """The paper's *list* algorithm at production bond dimension: every
    quantum-number block is its own distributed dense tensor (sharded over
    the FULL mesh when its dims divide it; small tail blocks replicate, the
    heterogeneity of the paper's Fig. 2a), and the Davidson matvec unrolls
    into per-block-pair products.

    Block structure: one U(1) charge; bond sectors l = 0..N_b-1 with dims
    b_l from the paper's empirical model and charges q_l = l; physical
    charges +-1, so x blocks couple |q_l - q_r| <= 2 (banded, like the real
    MPS) and env blocks are charge-diagonal.
    """
    base = DMRG_CELLS[name.replace("_list", "")]
    m, k = base["m"], base["k"]
    qq, rr = (4, 0.6) if "spins" in name else (10, 0.65)
    dims = empirical_block_dims(m, qq, rr)
    nb = len(dims)
    f32, meta = torch.float32, torch.device("meta")
    sizes = mesh_shape(mesh)
    da = _data_axes(mesh)
    dsz = int(np.prod([sizes[a] for a in (da if isinstance(da, tuple) else (da,))]))

    def shard2(d0: int, d1: int):
        """2-D shard a block when divisible; replicate the small tail."""
        return (da if d0 % dsz == 0 else None), ("model" if d1 % sizes["model"] == 0 else None)

    A_blocks, A_sh = [], []      # env: (q, q): [b_q, k, b_q]
    for i in range(nb):
        A_blocks.append(torch.empty((dims[i], k, dims[i]), dtype=f32, device=meta))
        p0, p1 = shard2(dims[i], dims[i])
        A_sh.append(placements_for((p0, None, p1), mesh))
    # theta blocks (l, s1, s2, r): r-sector = l-sector + c(s1) + c(s2),
    # phys charges c(0)=+1, c(1)=-1 -> banded structure like the real MPS
    x_blocks, x_sh, x_keys = [], [], []
    for i in range(nb):
        for s1 in (0, 1):
            for s2 in (0, 1):
                j = i + (1 if s1 == 0 else -1) + (1 if s2 == 0 else -1)
                if 0 <= j < nb:
                    x_blocks.append(torch.empty((dims[i], 1, 1, dims[j]), dtype=f32, device=meta))
                    p0, p1 = shard2(dims[i], dims[j])
                    x_sh.append(placements_for((p0, None, None, p1), mesh))
                    x_keys.append((i, s1, s2, j))
    # sector-diagonal MPO block (trivial MPO-bond charge): [k, 1, 1, k]
    W = torch.empty((k, 1, 1, k), dtype=f32, device=meta)
    repl = placements_for((), mesh)
    return (list_matvec_fn(x_keys), (tuple(A_blocks), W, W, tuple(A_blocks), tuple(x_blocks)),
            (tuple(A_sh), repl, repl, tuple(A_sh), tuple(x_sh)), (repl, repl, tuple(x_sh)), ())
