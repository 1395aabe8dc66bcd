"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--out chiprun_out/chip_smoke.json]

Phases (any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi);
  2. kernel vs plain: builds the three kernels from the sources in the
     checkout (one nvcc each, all started together) and holds the block GEMM kernel
     against its plain PyTorch version in f64, f32 and bf16, with k-tiling,
     ragged edges and an output block with no pair, then on every route and
     work split (long segments cut into items, skinny K and N, empty
     segments, per-pair extents); times the f64 tiles on the FP64 tensor
     cores on a dense case beside torch.bmm;
  3. small exact check: 3x2 open J1-J2 through run_dmrg(algo="csr") (the
     per-sector SVD and three-call environment updates, as before) against
     exact diagonalization and against algo="csr_ref" on the card;
  4. full size: J1-J2 (J2=0.5) on the 8x4 cylinder (32 sites), f64,
     algo="csr" (per-sector SVD, three-call environment updates, as in
     PRs 11-14), one sweep per entry of BONDS, davidson_iters=2: launch
     counts, per-sweep times and flops, peak memory, then the kernel held
     against its plain version, and timed beside one library call, on the
     four matvec contractions at the middle bond, with the variant each took.  From a product state the bond grows at most
     fourfold per sweep (4, 16, 64, 256, 1024), so the last bond is swept
     three times: the fifth sweep reaches m=1024 and the sixth truncates
     there;
  5. LM kernels vs plain: flash attention (ragged S up to 8192, GQA, head
     dims 16-256, f32 and bf16, strict causality, also at D=256; flash_wgmma over S in
     {1, 63, 128, 129, 1000, 2048, 8192}, D in {64, 128, 160, 256}, n_rep in {1, 4, 8},
     B in {1, 3}) and the RWKV6 scan (ragged T, head dims 16 and 64,
     log-decay down to -exp(6), a carried state; log-decay -exp(6) for the
     first 16 or 4 steps of each chunk, then -1e-3, at head dims 16-64; every
     state split, counted by name);
  6. llama3_8b at its full published width and depth (random bf16 weights):
     prefill of B=4 x S=2048 through make_prefill_step (flash launches,
     time, peak memory; every launch flash_wgmma); full-width logits of the kernel path against the
     plain path in bf16 (reported) and with the weights in float32 (held,
     beside the bf16 model's own distance from the float32 one as the
     control); then launch/serve.main (4 requests, prompt 16, generate 32);
  7. rwkv6_3b, the same (every layer's scan by the split the wrapper picks);
  8. cached decode against prefill for every architecture at smoke size in
     f32 (Whisper after priming its cross cache); one int8-KV-cache decode
     on the card against the same decode on the CPU;
  9. flash and scan timed at the prefill's shapes against their plain
     versions (and scaled_dot_product_attention as a yardstick); the scan at
     B=1 as well, each with its bound from the split of its work between
     tensor cores, CUDA cores and bytes; flash's tolerance checked against
     plain versions with a planted fault; flash at every phase 19 family's
     attention shape as FAMILIES names it (flash_wgmma at pixtral_12b's
     D=160 and recurrentgemma_2b's D=256, one KV head), with flash_mma forced
     at those two shapes beside it as the yardstick;
  10. the planned pipeline, run_dmrg(algo="batched", jit_matvec=True) with
     the reference's defaults (planned batched SVD, fused environment
     updates; matvec and environment updates replayed as CUDA graphs per
     padded structure): the 3x2 case against ED (1e-8) and phase 3 (1e-10);
     the 8x4 run on the full BONDS, per sweep its seconds, SVD and
     environment seconds, graph captures and replays, block GEMM launches
     by variant (replays included) and peak memory, its last energy held to
     phase 4's (1e-8); on its middle bond, a graph replay against the eager
     matvec (1e-12 relative) for two inputs in turn; the block GEMM on that
     matvec's largest bucket against its plain version, timed beside
     bmm + index_add_, with its bound;
  11. the engine front door's path, run_dmrg(algo="auto", jit_matvec=True)
     with the reference's defaults on the 8x4 run over the full BONDS: per
     sweep its seconds, SVD seconds, contractions by backend (the cost
     model's choices), graph captures and replays, block GEMM launches by
     variant and peak memory; its last energy held to phase 10's (1e-8).
     The block GEMM launches exactly where the cost model chose batched:
     on this run the reference's cost model chooses list throughout, so
     the phase launches none, and phases 4 and 10 are the checks of the
     kernel on a DMRG path.
     Phases 4, 10 and 11 also hold every degradation-ladder counter at zero
     (contraction, environment and pair retries, SVD retries);
  12. on that run's middle bond (m=1024) one eager two-site matvec through
     a dense, a batched and a list engine, held to each other (1e-12
     relative) and timed; then algo="dense" and "auto" on the 3x2 case
     against ED (1e-8);
  13. faults on the card: batch.gemm_nan (eager matvec), decomp.svd_fail,
     env.exception (graphed environment updates) and davidson.no_converge,
     each armed once on the 6-site Heisenberg chain, the recovered energy
     held to a clean run (1e-10) with the ladder counters expected;
  14. checkpoint and resume: the auto 8x4 run at bonds (128, 256) killed by
     sweep.kill in the middle of its second sweep, rerun on the same
     checkpoint directory, every sweep energy held to the uninterrupted run
     (1e-10; whether bitwise equal is printed);
  15. observables: Sz, SzSz and S+S- on the 3x2 case against ED (1e-8); on
     the 8x4 auto ground state the sum of <Sz_i> against the state's total
     charge (1e-8) and correlation_profile("Sz", "Sz", ref=0) timed;
  16. the serving path, DMRG-as-a-service: a J1-J2 ladder scan of 8 rungs
     (16 sites, J1=1, J2 over 0.30:0.65 in 8 steps, max_bond 128: bonds 8
     ... 128, two sweeps each, davidson_iters=6, f64), one slot of 8 through
     DMRGService(max_batch=8) warmed on the scan's own problems at slot size
     8: problems/s, solve seconds, seconds per sweep and per stage, block
     GEMM launches by variant, captures during and after warmup, peak
     memory; asserts launches > 0, zero captures after warmup, every
     recovery counter zero, and |dE| < 1e-10 against run_dmrg(algo="batched",
     jit_matvec=True) for the first and last J2 (untimed: the entry points
     run beside them, ENTRY_POINTS); on the middle bond's stacked matvec,
     the largest folded bucket launch against its plain version (1e-12
     relative) and against 8 per-problem launches (1e-13), timed beside
     their total and bmm + index_add_; then the entry points' results: the
     README's CLI quickstart with --check, the serve CLI with --warmup and
     --plan-store and a fresh CLI process on that store with --check
     reporting 0 plan builds, and examples/dmrg_groundstate_torch.py on the
     open 3x2 Hubbard patch (csr, --check-ed: exit code 0, its ED line
     within 1e-8);
  17. distributed DMRG: the 4x4 J1-J2 cylinder (J2=0.5, f64) through
     run_dmrg(spmd=True) under torchrun (scripts/spmd_dmrg.py), ranks
     sharing the card: one rank on NCCL, then 1x2 and 2x2 meshes on gloo
     (NCCL refuses two ranks on one card), SPMD_BONDS one sweep each,
     davidson_iters=2.  Per world: seconds per sweep, spmd.stats(), block
     GEMM launches per rank by variant (counted from just before run_dmrg to
     just after it); asserts launches > 0 on every rank, every ladder
     counter zero, no graph captured, no agreement mismatch, energies equal
     on every rank and within 1e-10 of the single-process
     run_dmrg(algo="batched", jit_matvec=True) at the same schedule; each
     rank's largest chunk run again after the run against its plain version
     (1e-12 relative), timed beside it, bmm + index_add_ and its bound;
  18. the plan store: the auto 8x4 run at bonds (128, 256) in one process
     on an empty store (scripts/plan_store_run.py), then in a fresh process
     on the primed store: 0 plan builds, every capture in the warmup before
     the first sweep (as many as the cold run's sweeps took), none in the
     sweeps, energies within 1e-10 of the cold run's (the serve CLI on a
     plan store ran with the entry points of phase 16);
  19. the other LM families at full published width (random bf16 weights;
     depth cut only where one card forces it, FAMILIES): codeqwen15_7b,
     granite_3_2b, qwen15_110b, qwen2_moe_a27b, moonshot_v1_16b_a3b,
     pixtral_12b (256 patches + 1792 tokens), recurrentgemma_2b (S = W =
     2048) and whisper_tiny (448 tokens over 1500 frames): a warmed prefill
     of B=4 through make_prefill_step (time, launches by variant, peak
     memory; flash once per attention layer as the variant FAMILIES names),
     the kernel path's logits against the plain path's in bf16 (reported)
     and with the weights in float32 at a depth whose float32 weights fit
     (held below F32_LOGITS_TOL, with the bf16-vs-float32 control above
     it), then launch/serve.main (4 requests, prompt 16, generate 32);
  20. LM training on the card: the flash attention and RWKV6 scan backward
     kernels alone against autograd through their plain versions (per
     tensor relative L2) at the training shapes in bf16 and float32, at
     the smoke D=16 and at flash's D=160 and 256 (small, and at
     pixtral_12b's and recurrentgemma_2b's training shapes), with
     planted-fault plain gradients above the float32 limits (and above
     the bf16 limit at D 160 and 256); the kernel path's loss and every
     float32 gradient at full width (1 layer deep; recurrentgemma_2b 3,
     its first attention layer) against the plain path's (a planted fault
     in the backward kernel's output and the bf16-weights control above
     the limit); llama3_8b (4 of 32 layers), rwkv6_3b (all 32),
     pixtral_12b (4 of 40) and recurrentgemma_2b (all 26) at full width
     in bf16 through make_train_step, B=2 x S=2048 of the synthetic data
     (pixtral_12b: 256 patch embeddings and 1792 tokens), AdamW: a
     warm-up step and 3 timed steps (seconds, tokens/s, peak memory,
     loss, grad norm, launches by variant, held to each forward kernel
     twice per layer and each backward kernel once, flash's as the
     variants the wrappers pick: flash_wgmma and bwd_wgmma), then at D 160
     and 256 2 steps with bwd_simple forced (the parent's backward);
     each backward kernel timed against its plain version (flash's
     bwd_wgmma at llama3_8b's shape also against bwd_mma forced, at
     pixtral_12b's and recurrentgemma_2b's against bwd_simple forced, and
     at all three against the backward of scaled_dot_product_attention,
     its backend named) with its bound; then
     launch/train.main --arch llama3_8b --layers 4 --steps 3 at B=2 x S=2048
     (phase 21 reuses its losses);
  21. training under a data x model mesh, ranks sharing the card under
     torchrun (NCCL for one rank, gloo for two: launch/mesh.backend_for):
     gloo's collectives on CUDA tensors probed beside the first run
     (scripts/gloo_cuda_probe.py; the functional all-gather, which kills
     the process, is routed through c10d by scripts/mesh_runs.py); the
     float32 gradients of llama3_8b (1x2) and rwkv6_3b (1x2, 2x1), 1
     layer, against one device per tensor (scripts/mesh_grads.py, MESH_GRAD_TOL),
     with the bf16 control and planted faults in the wrappers' sharding
     above the limit; through the train CLI (--record), llama3_8b (4
     layers) on a 1x1 NCCL mesh and on a 1x2 gloo mesh, rwkv6_3b (4 of 32
     layers) on a 1x2 gloo mesh, B=2 x S=2048, 3 steps: each rank's
     backend, step seconds, peak memory and launches by variant, held to
     each forward kernel twice per layer and each backward once, to the
     local heads each launch took (16 q / 4 kv heads at 1x2, 20 scan
     heads), and the losses to the same CLI on one device (MESH_LOSS_TOL;
     beside rwkv6_3b's, one device over two microbatches, MESH_REORDER);
     whisper_tiny saved at 1x2 after 2 steps and resumed at 2x1 (FSDP over
     "data") for 2 more, against 4 steps on one device, the gloo runs all
     in one world (scripts/mesh_runs.py); the dry run's dense DMRG step at
     m=4096 on a 1x1 mesh in float32 and bf16, timed beside the flops
     launch/costs.py counts; one launch of each training kernel at a 1x2
     rank's local heads timed beside all heads;
  22. the paper's electron system (triangular Hubbard, t=1, U=8.5, d=4, two
     U(1) charges): the open 3x2 patch through run_dmrg(algo="batched",
     jit_matvec=True) against ED (1e-8; through the entry point on csr in
     phase 16); the width-6 cylinder (k=26) at ELECTRON_LX columns through
     csr, batched with graphs and auto with graphs at ELECTRON_BONDS: per
     sweep its seconds, SVD and environment seconds, the host planner's
     work-list milliseconds, contractions by backend and buckets, graph
     captures, replays, evictions and pool bytes, block GEMM launches by
     variant (at least one per csr contraction and one per bucket) and peak
     memory; the csr operands' packed bytes, the SVD's host syncs; energies
     non-increasing (1e-10), no recovery, the last energies of the three
     within 1e-8; then the block GEMM on the csr run's middle-bond matvec
     at the top bond against its plain version (1e-12 relative), timed
     beside bmm + index_add_, with its bytes bound, and on the batched run's
     middle-bond matvec its largest bucket and a bucket of extent 1 against
     their plain version (1e-12 relative), timed beside bmm + index_add_;
  23. summary lines, then {"ok": true, "device": {...}} as the last line.
Needs a CUDA card; exits non-zero without one, printing no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet, dense, full 700 W power limit
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
TOL = {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 5e-2}
# bond of each sweep of the full-size run (see phase 4 above)
BONDS = (128, 256, 512, 1024, 1024, 1024)
# LM prefill shape: B requests of S tokens.  Cut from the reference's
# prefill_32k (batch 32 x 32768) because the plain path that the kernel
# path is held against materialises [B, H, S, S] float32 scores.
LM_BATCH, LM_SEQ = 4, 2048
# Flash attention vs plain, per output row: max over (b, s, h) of
# ||got - want|| / ||want||.  float32: the reference's 2e-5 (the order of
# the sums differs).  bfloat16: the kernel rounds p to bf16 for p @ v and
# rounds its output (2^-9 relative each), and read up to 6.5e-3 on an H100;
# plain versions that drop one key tile, or leave one tile's share out of
# the softmax denominator, in the last query tile read 0.63 and 7.0e-2
# (PERF.md).  The limit sits between, and phase 9 checks that both planted
# faults still read above it.
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# The scan vs plain, relative to the largest |value| of the plain result:
# the reference's 2e-4 (tests/test_kernels.py); bf16 inputs are computed in
# float32 by both, so bf16 adds only the output's own rounding.
SCAN_TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}
# The served scan of phase 16: the J1-J2 ladder (Ly=2 strip of the paper's
# spins model), the J2 values of one slot, the largest bond (cut from 256 to
# 128 to keep the script near half its time limit) and the length, cut from
# 16 rungs to 8 when phase 22 came (the shortest ladder whose middle bond
# holds 128): at 16 rungs and m=128 the phase took ~260 s on an H100, 700 W.
SERVE_MODEL, SERVE_SITES, SERVE_BOND = "j1j2_ladder", 16, 128
SERVE_J2 = tuple(float(j) for j in np.linspace(0.30, 0.65, 8))
# The README's CLI quickstart, run with --check on the card.
SERVE_CLI = ["--model", "heisenberg", "--n-sites", "8", "--max-bond", "16", "--sweep", "J=0.8:1.2:4",
             "--sweep", "h=0.2:0.4:2", "--batch", "4", "--check"]
# Phase 17: the spmd worlds (ranks, backend, mesh) on the one card, the bond
# schedule, cut from BONDS so that the phase takes about two minutes (the
# eager matvec with two collectives per bucket took 24 / 62 / 119 s at
# worlds 1 / 2 / 4 over (16, 64, 128) on an H100; scripts/spmd_dmrg.py), and
# the cylinder, cut in length from phase 4's 8x4 to 4x4 when phase 22 came
# (the phase took 217 s at 8x4; H100, 700 W).
SPMD_WORLDS = ((1, "nccl", "1x1"), (2, "gloo", "1x2"), (4, "gloo", "2x2"))
SPMD_BONDS = (16, 64)
SPMD_LX, SPMD_LY = 4, 4
# Phase 18: the cold and primed runs' bonds; the serve CLI on a store primed
# by --warmup (the same group: model, sites, bond, h=0), one of ENTRY_POINTS.
STORE_BONDS = (128, 256)
STORE_WARMUP = "heisenberg,m=8,n=6"
STORE_CLI = ["--model", "heisenberg", "--n-sites", "6", "--max-bond", "8", "--sweep", "J=0.9:1.1:2",
             "--batch", "2", "--check"]
# Full-width logits with the weights cast to float32, kernel path vs plain
# path, per token: max over (b, s) of ||got - want|| / ||want|| over the
# vocabulary.  The control that must read above it: the plain path with the
# weights in bf16 against the same path in float32.  In bf16 the kernel and
# plain paths are compared and reported, not held: the random-init models
# amplify one rounding through their 32 layers (scripts/lm_divergence.py).
# Phase 19's limits sit between the kernel-vs-plain reading and the control
# that scripts/lm_divergence.py gave at phase 19's float32 depths on an
# H100 (per token; NVIDIA H100 80GB HBM3, 700 W): 5-9e-6 against controls
# of 1.4e-2 to 6.9e-2 for the dense configs, pixtral_12b and
# recurrentgemma_2b, 7.6e-7 against 7.8e-3 for whisper_tiny.  A MoE's
# router flips at near-ties under float32 differences of ~1e-6, and a
# flipped expert moves a token's whole FFN output (0.18 and 0.065 per
# token for the MoE pair with each path on its own router), so its plain
# path is held on the kernel path's experts, to the dense configs' limit.
F32_LOGITS_TOL = {"llama3_8b": 1e-4, "rwkv6_3b": 1e-2, "codeqwen15_7b": 1e-4, "granite_3_2b": 1e-4,
                  "qwen15_110b": 1e-4, "qwen2_moe_a27b": 1e-4, "moonshot_v1_16b_a3b": 1e-4, "pixtral_12b": 1e-4,
                  "recurrentgemma_2b": 1e-4, "whisper_tiny": 1e-4}
# Phase 19: per architecture, the decoder depth on the card (None: all of
# it), the depth of the float32 check (None: the same), the prefill's
# positions and the flash variant its attention must take.  qwen15_110b's
# 222 GB of bf16 weights are cut to 8 of 80 layers (2.72 GB a layer) to
# fit one card; moonshot_v1_16b_a3b's 57.8 GB to 24 of 48, since at 48
# models.init runs out of an 80 GB H100 (its float32 draw of one stacked
# expert tensor, 16.5 GiB, beside 68.9 GiB already allocated).  The float32
# depth keeps float32 weights near 34 GB or below.
FAMILIES = {
    "codeqwen15_7b": dict(layers=None, f32_layers=None, seq=LM_SEQ, variant="flash_wgmma"),
    "granite_3_2b": dict(layers=None, f32_layers=None, seq=LM_SEQ, variant="flash_wgmma"),
    "qwen15_110b": dict(layers=8, f32_layers=4, seq=LM_SEQ, variant="flash_wgmma"),
    "qwen2_moe_a27b": dict(layers=None, f32_layers=12, seq=LM_SEQ, variant="flash_wgmma"),
    "moonshot_v1_16b_a3b": dict(layers=24, f32_layers=12, seq=LM_SEQ, variant="flash_wgmma"),
    "pixtral_12b": dict(layers=None, f32_layers=24, seq=LM_SEQ, variant="flash_wgmma"),
    "recurrentgemma_2b": dict(layers=None, f32_layers=None, seq=LM_SEQ, variant="flash_wgmma"),
    "whisper_tiny": dict(layers=None, f32_layers=None, seq=448, variant="flash_wgmma"),
}
# Phase 20: training at full width in bf16, B x S of the synthetic data,
# TRAIN_STEPS timed steps after a warm-up.  llama3_8b is cut to 4 of its 32
# layers: bf16 weights and gradients and float32 moments take 12 bytes a
# parameter (~96 GB whole); 4 layers keep its 128,256-row embedding and head
# (1.9 B parameters, ~23 GB of state).  rwkv6_3b at all 32 layers (3.1 B,
# ~37 GB).  pixtral_12b at 4 of 40 (all 40 would be ~154 GB; 4 keep its
# 131,072-row embedding and head: 2.5 B, ~30 GB), recurrentgemma_2b at all
# 26 (2.7 B, ~32 GB; its window of 2048 makes its 8 attention layers causal
# at S=2048: flash forward and backward).  The float32 gradient check runs
# 1 layer deep (the plain path's [B, H, S, S] scores and the plain scan's
# T-step autograd loop); recurrentgemma_2b 3, since its pattern (rglru,
# rglru, attn) puts its first attention layer third.
TRAIN_ARCHS = {"llama3_8b": dict(layers=4, f32_layers=1), "rwkv6_3b": dict(layers=None, f32_layers=1),
               "pixtral_12b": dict(layers=4, f32_layers=1), "recurrentgemma_2b": dict(layers=None, f32_layers=3)}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 3
# steps timed with flash's backward forced to bwd_simple (the parent's at D
# 160 and 256) after the timed steps of those families
BASELINE_STEPS = 2
# the train CLI at the training shape; phase 21's one-device reference of
# llama3_8b's meshes (the same arguments: its run is reused)
TRAIN_CLI = ["--arch", "llama3_8b", "--global-batch", str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ), "--steps",
             str(TRAIN_STEPS), "--seed", "0", "--layers", "4"]
# Backward kernels vs autograd through their plain versions, per tensor
# ||got - want|| / ||want||.  float32: the sums run in other orders (read
# 2.0e-6 and 6.2e-7 on an H100).  bf16: each side rounds its gradients (and
# the flash kernel its forward output, which its Delta reads) to bf16 once,
# and flash's bwd_wgmma and bwd_mma round P and dS to bf16 for their
# tensor-core products (bwd_mma read 3.3e-3; the scan 5.6e-5).  Phase 20 checks that plain gradients with
# a planted fault read above the float32 limits (1.0e-2 and more).
BWD_TOL = {"flash_attention_bwd": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
           "rwkv6_scan_bwd": {torch.float32: 1e-4, torch.bfloat16: 2e-2}}
# Phase 20: the kernel path's float32 gradients vs the plain path's, per
# tensor (read 9.6e-7 for llama3_8b and 3.2e-6 for rwkv6_3b at 1 layer on an
# H100); a planted fault in the backward kernel's output (5.1e-2, 0.12) and
# the control, bf16 weights against float32 (0.18, 0.30), must read above it.
TRAIN_GRAD_TOL = 1e-4
# Phase 21: training under a data x model mesh, every world through the
# train CLI under torchrun (ranks share the card: NCCL at a world of one,
# gloo beyond), each against the same CLI on one device (same seed, batch
# and steps).  (label, ranks, backend, --mesh-model, arch, --layers).
# rwkv6_3b is cut to 4 of its 32 layers for time, not memory: at 32 its
# 1x2 steps took 18.7-30.5 s over gloo (peak 24.1 GB a rank, so two fit),
# at 8 4.3-9.6 s (NVIDIA H100 80GB HBM3, 700 W), which would take the phase
# past its 150 s and the script near its 1200 s limit.
MESH_RUNS = (("llama3_8b 1x1 nccl", 1, "nccl", 1, "llama3_8b", 4),
             ("llama3_8b 1x2 gloo", 2, "gloo", 2, "llama3_8b", 4),
             ("rwkv6_3b 1x2 gloo", 2, "gloo", 2, "rwkv6_3b", 4))
MESH_BATCH, MESH_SEQ, MESH_STEPS = 2, 2048, 3
# Restore onto another mesh: whisper_tiny at full width (a small checkpoint)
# saved after 2 steps at 1x2, resumed at 2x1 (FSDP over "data") for 2 more.
RESUME_CLI = ["--arch", "whisper_tiny", "--global-batch", "2", "--seq-len", "448"]
# Mesh losses against one device, relative, the first step's and the later
# ones': in bf16 the mesh computes the same products on column splits,
# reduces partial sums in other orders and takes the cross entropy
# vocab-parallel, so the first loss (the same weights) differs by bf16
# rounding (read 7e-6 for llama3_8b, 3.1e-4 for rwkv6_3b, whose group norm
# magnifies it), and the later ones by what the steps make of it: by step
# 3 5.7e-5 for llama3_8b and 1.51e-3 for rwkv6_3b (4 layers, NVIDIA H100
# 80GB HBM3, 700 W), where one device with the batch's gradient summed
# over two microbatches (MESH_REORDER, reported beside) drifts 7.7e-5, so
# reduction order alone does not explain rwkv6_3b's.  The loss is a
# coarse check, 6.6x above that reading: at random init it hardly feels a
# wrong attention or wkv output; the float32 gradients below are the fine one.
MESH_LOSS_TOL = (1e-3, 1e-2)
MESH_REORDER = ("rwkv6_3b", 4)
# Phase 21's float32 gradients of mesh training against one device, per
# tensor, 1 layer deep at B x S = MESH_BATCH x MESH_SEQ on the meshes of
# MESH_GRAD_ARCHS (scripts/mesh_grads.py: the same kernels on local shards; every u drawn
# nonzero).  The bf16 control and the planted faults in the wrappers'
# sharding (a wrong KV or u slice, u's gradient not summed over the batch
# shards) must read above the limit.  Read on the H100 (700 W): sound
# 2.6e-6 to 1.8e-5, control 9.4e-3 (llama3_8b) and 6.3e-2 (rwkv6_3b),
# faults 0.57-1.43; llama3_8b's 2x1 reading (2.6e-6) took 33.5 s of
# gloo-staged float32 gathers and is left to the CPU tests.
MESH_GRAD_TOL = 2e-4
MESH_GRAD_ARCHS = {"llama3_8b": "1x2", "rwkv6_3b": "1x2,2x1"}
# Phase 21 (d): the dense DMRG Davidson step of the dry run's cells on one
# card (a 1x1 mesh), spins (d=2, k=30) at m=4096: each of its three
# m^2 k d^2 intermediates takes 8 GB in float32
MESH_DMRG = dict(m=4096, d=2, k=30)
# Phase 22: the paper's electron system (Sec. V), the triangular Hubbard
# cylinder (t=1, U=8.5, d=4, charges (N, 2Sz)) at width 6, where its MPO
# compresses to the paper's k=26, from neel_states (half filling, Sz=0),
# f64, davidson_iters=2 and one sweep per bond as phase 4.  Only the length
# and the bond are cut: 3 columns (18 sites, the shortest cylinder whose
# middle bonds reach k=26) and bonds to 256, so that the three paths fit
# about two and a half minutes: at bonds (16, 128, 512) csr, batched and
# auto took 53.3, 70.9 and 60.0 s, at 4 columns and bonds (64, 256, 1024)
# 91, 112 and 125 s (scripts/electron_sweeps.py; NVIDIA H100 80GB HBM3, 700
# W).  A sweep grows the bond at most sixteenfold (d^2): from the product
# state to 12, then to 128, then to the top bond.
ELECTRON_LX, ELECTRON_LY = 3, 6
ELECTRON_BONDS = (16, 128, 256)
# the paths, in order (scripts/electron_sweeps.py PATHS: csr as phase 4,
# batched and auto with graphs as phases 10 and 11)
ELECTRON_PATHS = ("csr", "batched", "auto")
# The exact check: the open 3x2 patch (Ly=2 has no wrap; 4096 states) through
# the entry point on csr (one of ENTRY_POINTS), and in process through the
# planned pipeline, each at the entry point's schedule (bonds 8 ... 64, two
# sweeps each, davidson_iters=4: 1.7e-9 from ED on the CPU).
ELECTRON_CLI = ["examples/dmrg_groundstate_torch.py", "--system", "electrons", "--lx", "3", "--ly", "2",
                "--max-bond", "64", "--algo", "csr", "--check-ed"]
# The entry points run as subprocesses on the card, each a chain of commands
# run one after another, the chains side by side and beside untimed work
# only (phase 16's single runs): the README's serve CLI quickstart, the
# serve CLI's --warmup on a plan store and then a fresh CLI process on it
# (phase 18), and the DMRG entry point on the 3x2 Hubbard patch (phase 22).
ENTRY_POINTS = {
    "serve": [["-m", "repro_torch.serve", *SERVE_CLI]],
    "plan_store": [["-m", "repro_torch.serve", "--warmup", STORE_WARMUP, "--batch", "2", "--plan-store", "{store}"],
                   ["-m", "repro_torch.serve", *STORE_CLI, "--plan-store", "{store}"]],
    "electrons": [ELECTRON_CLI],
}


def log(*args):
    print(*args, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple:
    diff = (got.double() - want.double()).abs().max().item()
    scale = max(want.double().abs().max().item(), 1e-300)
    return diff, diff / scale


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest over rows (every index but the last) of ||got - want|| / ||want||."""
    g, w = got.reshape(-1, got.shape[-1]).double(), want.reshape(-1, want.shape[-1]).double()
    return ((g - w).norm(dim=1) / w.norm(dim=1).clamp_min(1e-300)).max().item()


# ----------------------------------------------------------------- phase 2
def kernel_cases(dev):
    """Kernel vs plain on synthetic operands; returns worst rel err per dtype."""
    from repro_torch import kernels
    from repro_torch.kernels.block_gemm.ops import block_sparse_matmul
    from repro_torch.kernels.block_gemm.ref import block_sparse_matmul_ref

    rng = np.random.default_rng(0)
    # (P, BM, BK, BN, out_idx, num_out): ragged edges, BK over several
    # 16-deep k-tiles, output block 2 with no pair, a 1-pair case
    shapes = [
        (7, 37, 200, 45, [0, 0, 1, 1, 1, 3, 3], 4),
        (5, 130, 33, 70, [0, 1, 1, 2, 2], 4),
        (1, 64, 16, 64, [0], 1),
    ]
    worst = {}
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        for P, BM, BK, BN, oi, O in shapes:
            lhs = torch.from_numpy(rng.standard_normal((P, BM, BK))).to(dev, dtype)
            rhs = torch.from_numpy(rng.standard_normal((P, BK, BN))).to(dev, dtype)
            idx = np.array(oi, np.int64)
            got = block_sparse_matmul(lhs, rhs, idx, O)
            want = block_sparse_matmul_ref(lhs, rhs, idx, O)
            torch.cuda.synchronize()
            err, rel = rel_err(got, want)
            empty = sorted(set(range(O)) - set(oi))
            if empty and got[empty].abs().max().item() != 0.0:
                fail(f"output blocks {empty} with no pair are not zero ({dtype})")
            log(f"  block_gemm {str(dtype)[6:]:8s} P={P} BM={BM} BK={BK} BN={BN} O={O}: max abs err {err:.3e}, rel {rel:.3e}")
            if not rel <= TOL[dtype]:
                fail(f"block_gemm {dtype} rel err {rel:.3e} > {TOL[dtype]}")
            worst[dtype] = max(worst.get(dtype, 0.0), rel)
        # per-pair extents: zero padding beyond each pair's true shape is skipped
        if dtype == torch.float64:
            P, BM, BK, BN, O = 6, 50, 40, 30, 3
            ext = np.array([[50, 40, 30], [10, 40, 30], [50, 5, 30], [50, 40, 7], [1, 1, 1], [33, 17, 29]], np.int32)
            lhs = torch.zeros((P, BM, BK), dtype=dtype, device=dev)
            rhs = torch.zeros((P, BK, BN), dtype=dtype, device=dev)
            for p, (m, k, n) in enumerate(ext):
                lhs[p, :m, :k] = torch.from_numpy(rng.standard_normal((m, k))).to(dev, dtype)
                rhs[p, :k, :n] = torch.from_numpy(rng.standard_normal((k, n))).to(dev, dtype)
            idx = np.array([0, 0, 0, 1, 2, 2], np.int64)
            got = block_sparse_matmul(lhs, rhs, idx, O, extents=torch.from_numpy(ext).to(dev))
            want = block_sparse_matmul_ref(lhs, rhs, idx, O)
            err, rel = rel_err(got, want)
            log(f"  block_gemm float64  with per-pair extents: max abs err {err:.3e}, rel {rel:.3e}")
            if not rel <= TOL[dtype]:
                fail(f"block_gemm extents rel err {rel:.3e}")
            worst[dtype] = max(worst[dtype], rel)
    for case in sorted(ROUTE_CASES):
        for dtype in (torch.float64, torch.float32, torch.bfloat16):
            lhs, rhs, oi, O, ext = route_case(case, dev, dtype, rng)
            kinds = dict(kernels.VARIANT_LAUNCHES["block_gemm"])
            got = block_sparse_matmul(lhs, rhs, oi, O, extents=ext)
            kind = next(k for k, n in kernels.VARIANT_LAUNCHES["block_gemm"].items() if n != kinds[k])
            want = block_sparse_matmul_ref(lhs, rhs, oi, O)
            err, rel = rel_err(got, want)
            empty = sorted(set(range(O)) - set(oi.tolist()))
            if empty and got[empty].abs().max().item() != 0.0:
                fail(f"block_gemm {case} {dtype}: output blocks {empty} with no pair are not zero")
            if dtype == torch.float64 and not torch.equal(got, block_sparse_matmul(lhs, rhs, oi, O, extents=ext)):
                fail(f"block_gemm {case}: two f64 launches differ")
            log(f"  block_gemm {case:14s} {str(dtype)[6:]:8s} {kind:10s} P={lhs.shape[0]} BM={lhs.shape[1]} "
                f"BK={lhs.shape[2]} BN={rhs.shape[2]}: max abs err {err:.3e}, rel {rel:.3e}")
            if not rel <= TOL[dtype]:
                fail(f"block_gemm {case} {dtype} rel err {rel:.3e} > {TOL[dtype]}")
            worst[dtype] = max(worst[dtype], rel)
    return worst


# (P, BM, BK, BN, out_idx, num_out, extents): a long segment cut into items
# (second pass), odd strides (8-byte copies), per-pair extents with a pair
# of no depth, the skinny route with cut segments, 1 x 1 blocks
ROUTE_CASES = {
    "tiled_split": (6, 100, 700, 90, [0, 0, 0, 0, 0, 2], 3, None),
    "tiled_odd": (4, 67, 133, 71, [1, 1, 2, 2], 3, None),
    "tiled_extents": (5, 130, 300, 130, [0, 0, 0, 2, 2], 3,
                      [[130, 300, 130], [17, 299, 130], [130, 0, 130], [64, 64, 65], [1, 1, 1]]),
    "skinny_split": (40, 3000, 6, 5, [0] * 30 + [2] * 10, 3, "random"),
    "skinny_1x1": (3, 5, 1, 1, [0, 2, 2], 4, None),
}


def route_case(name, dev, dtype, rng):
    P, BM, BK, BN, oi, O, ext = ROUTE_CASES[name]
    if ext == "random":
        ext = np.stack([rng.integers(1, BM + 1, P), rng.integers(0, BK + 1, P), rng.integers(1, BN + 1, P)], 1)
    ext = np.array(ext if ext is not None else [[BM, BK, BN]] * P, np.int32)
    lhs = torch.zeros((P, BM, BK), dtype=torch.float64)
    rhs = torch.zeros((P, BK, BN), dtype=torch.float64)
    for p, (m, k, n) in enumerate(ext):
        lhs[p, :m, :k] = torch.from_numpy(rng.standard_normal((m, k)))
        rhs[p, :k, :n] = torch.from_numpy(rng.standard_normal((k, n)))
    return lhs.to(dev, dtype), rhs.to(dev, dtype), np.array(oi), O, torch.from_numpy(ext).to(dev)


def dmma_rate(dev):
    """f64 tiles on the FP64 tensor cores at a dense, tile-aligned shape
    (four pairs of 2048^3, one per output block) beside torch.bmm."""
    from repro_torch.kernels.block_gemm.ops import block_sparse_matmul

    g = torch.Generator(device=dev).manual_seed(5)
    P, n = 4, 2048
    lhs = torch.randn(P, n, n, generator=g, device=dev, dtype=torch.float64)
    rhs = torch.randn(P, n, n, generator=g, device=dev, dtype=torch.float64)
    oi = np.arange(P)
    got = block_sparse_matmul(lhs, rhs, oi, P)
    err, rel = rel_err(got, torch.bmm(lhs, rhs))
    if not rel <= TOL[torch.float64]:
        fail(f"dense f64 block_gemm rel err {rel:.3e}")
    flops = 2.0 * P * n**3
    row = dict(shape=dict(P=P, BM=n, BK=n, BN=n), mma="m16n8k8.f64", rel_err=rel, flops=flops,
               **timed(dict(ms=lambda: block_sparse_matmul(lhs, rhs, oi, P), library_ms=lambda: torch.bmm(lhs, rhs)),
                       dict(ms=5, library_ms=5)))
    row["tflops"], row["library_tflops"] = flops / row["ms"] / 1e9, flops / row["library_ms"] / 1e9
    log("  dense f64 " + json.dumps(row))
    return row


# ----------------------------------------------------------------- phase 4
def middle_bond_matvec(engine, res, mpo, dev):
    """Kernel vs plain, timed, on the four matvec contractions at the middle
    bond, with the run's own MPS, MPO and environments."""
    from repro_torch.core.env import extend_right, left_edge, right_edge
    from repro_torch.core.env import extend_left
    from repro_torch.kernels.block_gemm.ops import block_sparse_matmul
    from repro_torch.kernels.block_gemm.ref import block_sparse_matmul_ref
    from repro_torch.kernels.block_gemm.work import variant, work_list

    T = res.mps.tensors
    n = len(T)
    j = n // 2 - 1
    A = left_edge(T[0], mpo[0])
    for i in range(j):
        A = extend_left(A, T[i], mpo[i], engine)
    B = right_edge(T[n - 1], mpo[n - 1])
    for i in range(n - 2, j, -1):
        B = extend_right(B, T[i + 1], mpo[i + 1], engine)
    x = engine(T[j], T[j + 1], ((2,), (0,)))
    steps = [
        ("A.x", lambda x: (A, x, ((2,), (0,)))),
        ("t.Wj", lambda t: (t, mpo[j], ((1, 2), (0, 2)))),
        ("t.Wj1", lambda t: (t, mpo[j + 1], ((4, 1), (0, 2)))),
        ("t.B", lambda t: (t, B, ((4, 1), (1, 2)))),
    ]
    rows, t = [], x
    for name, args in steps:
        a, b, axes = args(t)
        plan = engine.cache.get(a, b, axes)
        lhs, rhs, oi, work, ext = engine.pack_csr(plan, a, b)
        O = len(plan.csr.out_keys)
        t0 = time.perf_counter()  # the host planner, once per layout
        L = plan.csr
        work_list(L.seg, L.extents, L.bm, L.bk, L.bn)
        plan_ms = (time.perf_counter() - t0) * 1e3
        got = block_sparse_matmul(lhs, rhs, oi, O, work=work, extents=ext)
        want = block_sparse_matmul_ref(lhs, rhs, oi, O)
        err, rel = rel_err(got, want)
        if not rel <= TOL[torch.float64]:
            fail(f"middle-bond {name}: kernel vs plain rel err {rel:.3e}")
        idx = torch.from_numpy(oi.astype(np.int64)).to(dev)

        def library():
            out = torch.zeros((O, lhs.shape[1], rhs.shape[2]), dtype=lhs.dtype, device=dev)
            return out.index_add_(0, idx, torch.bmm(lhs, rhs))

        fns = dict(
            ms=lambda: block_sparse_matmul(lhs, rhs, oi, O, work=work, extents=ext),
            plain_ms=lambda: block_sparse_matmul_ref(lhs, rhs, oi, O),
            library_ms=library,
        )
        runs = {k: [] for k in fns}
        for _ in range(2):  # each the faster of two interleaved runs
            for k, fn in fns.items():
                runs[k].append(time_ms(fn))
        e = plan.csr.extents.astype(np.float64)
        flops = float(np.sum(2.0 * e[:, 0] * e[:, 1] * e[:, 2]))  # = plan.flops_list
        size = lhs.element_size()
        # the true blocks of both operands read once, the whole padded
        # output [O, BM, BN] (zeros included) written once
        out_elems = float(O * lhs.shape[1] * rhs.shape[2])
        nbytes = size * (float(np.sum(e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2])) + out_elems) + 4 * ext.numel()
        t_ops = flops / PEAK_FLOPS[lhs.dtype] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        row = dict(
            step=name, variant=variant(work.route, lhs.dtype), items=len(work.items), slots=work.n_slots,
            cut_tiles=len(work.fix), work_list_host_ms=plan_ms,
            P=int(lhs.shape[0]), BM=int(lhs.shape[1]), BK=int(lhs.shape[2]), BN=int(rhs.shape[2]), O=O,
            max_abs_err=err, rel_err=rel, **{k: min(v) for k, v in runs.items()}, runs=runs,
            flops_exact=flops, flops_padded=plan.flops_csr, bytes=nbytes,
            bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
            lhs_mb=lhs.numel() * size / 2**20, rhs_mb=rhs.numel() * size / 2**20,
        )
        log("  middle bond " + json.dumps(row))
        rows.append(row)
        t = engine(a, b, axes)
        del lhs, rhs, got, want
    return j, rows


# ----------------------------------------------------------------- phase 5
def lm_kernel_cases(dev):
    """Flash attention and the RWKV6 scan against their plain versions on
    synthetic inputs; returns {kernel: {dtype: worst relative error}}."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention.ops import flash_attention_bshd
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_wkv

    g = torch.Generator(device=dev).manual_seed(0)
    worst = {"flash_attention": {}, "rwkv6_scan": {}}

    def check(name, dtype, label, got, want, tol):
        rel = row_rel_err(got, want) if name == "flash_attention" else rel_err(got, want)[1]
        worst[name][str(dtype)[6:]] = max(worst[name].get(str(dtype)[6:], 0.0), rel)
        if not rel <= tol:
            fail(f"{name} {label} {dtype}: rel err {rel:.3e} > {tol}")
        return rel

    # (B, H, Hkv, S, D): every S x D at n_rep 1 and 4, then S=8192 at BH=2
    cases = [(1, 4, 4 // rep, s, d) for s in (1, 37, 128, 300, 2048) for d in (16, 48, 64, 128) for rep in (1, 4)]
    cases += [(1, 2, 2, 8192, 128), (1, 2, 1, 8192, 128)]
    # pixtral_12b's head dim (H/Hkv = 4) and recurrentgemma_2b's (one KV head)
    cases += [(1, 8, 2, s, 160) for s in (1, 37, 300, 2048)] + [(1, 10, 1, s, 256) for s in (1, 37, 300, 2048)]
    for dtype in (torch.float32, torch.bfloat16):
        for b, h, hkv, s, d in cases:
            q = torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
            k = torch.randn(b, s, hkv, d, generator=g, device=dev).to(dtype)
            v = torch.randn(b, s, hkv, d, generator=g, device=dev).to(dtype)
            got = flash_attention_bshd(q, k, v)
            torch.cuda.synchronize()
            check("flash_attention", dtype, f"B={b} H={h} Hkv={hkv} S={s} D={d}", got,
                  flash_attention_bshd(q, k, v, use_kernel=False), FLASH_TOL[dtype])
        # strict causality: future keys and values change no earlier output,
        # cut inside a key tile and at a tile boundary
        for d in (64, 256):
            q, k, v = (torch.randn(1, 384, 2, d, generator=g, device=dev).to(dtype) for _ in range(3))
            o1 = flash_attention_bshd(q, k, v)
            for cut in (200, 256):
                k2, v2 = k.clone(), v.clone()
                k2[:, cut:], v2[:, cut:] = 99.0, -99.0
                if not torch.equal(o1[:, :cut], flash_attention_bshd(q, k2, v2)[:, :cut]):
                    fail(f"flash_attention {dtype} D={d}: outputs depend on future keys")
        for t in (1, 33, 64, 2048):
            for n in (16, 64):
                b, h = 2, 2
                r, kk = ((0.5 * torch.randn(b, t, h, n, generator=g, device=dev)).to(dtype) for _ in range(2))
                vv = torch.randn(b, t, h, n, generator=g, device=dev).to(dtype)
                # log-decay from -exp(-8) down to -exp(6), the model's clip
                logw = -torch.exp(torch.rand(b, t, h, n, generator=g, device=dev) * 14.0 - 8.0)
                u = 0.1 * torch.randn(h, n, generator=g, device=dev)
                s0 = 0.1 * torch.randn(b, h, n, n, generator=g, device=dev)
                got, s_got = rwkv6_wkv(r, kk, vv, logw, u, state=s0)
                torch.cuda.synchronize()
                want, s_want = rwkv6_wkv(r, kk, vv, logw, u, state=s0, use_kernel=False)
                label = f"B={b} H={h} T={t} N={n}"
                check("rwkv6_scan", dtype, label, got, want, SCAN_TOL[dtype])
                check("rwkv6_scan", torch.float32, label + " state", s_got, s_want, SCAN_TOL[torch.float32])
        # log-decay -exp(6) for the first few steps of every chunk, then
        # -1e-3: chunk-wide cumulative sums would cancel here; float32 out
        for n in (16, 32, 64):
            for strong in (16, 4):
                b, h, t = 2, 3, 100
                r, kk = ((0.5 * torch.randn(b, t, h, n, generator=g, device=dev)).to(dtype) for _ in range(2))
                vv = torch.randn(b, t, h, n, generator=g, device=dev).to(dtype)
                logw = torch.full((b, t, h, n), -1e-3, device=dev)
                for c0 in range(0, t, 32):
                    logw[:, c0:c0 + strong] = -float(np.exp(6.0))
                u = 0.1 * torch.randn(h, n, generator=g, device=dev)
                s0 = 0.1 * torch.randn(b, h, n, n, generator=g, device=dev)
                f32 = torch.float32
                got, s_got = rwkv6_wkv(r, kk, vv, logw, u, state=s0, out_dtype=f32)
                want, s_want = rwkv6_wkv(r, kk, vv, logw, u, state=s0, out_dtype=f32, use_kernel=False)
                label = f"{str(dtype)[6:]} in, strong{strong} T={t} N={n}"
                check("rwkv6_scan", f32, label, got, want, SCAN_TOL[f32])
                check("rwkv6_scan", f32, label + " state", s_got, s_want, SCAN_TOL[f32])
    # every state split forced at N=64, counted by its own name
    from repro_torch.kernels.rwkv6_scan import ops as scan_ops
    for split in (4, 2, 1):
        b, h, t, n = 2, 5, 77, 64
        r, kk = ((0.5 * torch.randn(b, t, h, n, generator=g, device=dev)).bfloat16() for _ in range(2))
        vv = torch.randn(b, t, h, n, generator=g, device=dev).bfloat16()
        logw = -torch.exp(torch.rand(b, t, h, n, generator=g, device=dev) * 14.0 - 8.0)
        u = 0.1 * torch.randn(h, n, generator=g, device=dev)
        s0 = 0.1 * torch.randn(b, h, n, n, generator=g, device=dev)
        before = kernels.VARIANT_LAUNCHES["rwkv6_scan"][f"split{split}"]
        got, s_got = scan_ops._launch(r, kk, vv, logw, u, s0, torch.float32, split)
        if kernels.VARIANT_LAUNCHES["rwkv6_scan"][f"split{split}"] != before + 1:
            fail(f"rwkv6_scan split{split} was not counted under its name")
        want, s_want = rwkv6_wkv(r, kk, vv, logw, u, state=s0, out_dtype=torch.float32, use_kernel=False)
        check("rwkv6_scan", torch.float32, f"split{split}", got, want, SCAN_TOL[torch.float32])
        check("rwkv6_scan", torch.float32, f"split{split} state", s_got, s_want, SCAN_TOL[torch.float32])
    # flash_wgmma over its grid: 8 query heads, n_rep 1, 4, 8; key tiles of
    # 128 at D 64 and 128, of 64 at D 160 (three 64-column panels) and 256
    before = kernels.VARIANT_LAUNCHES["flash_attention"]["flash_wgmma"]
    n_cases = 0
    for s in (1, 63, 128, 129, 1000, 2048, 8192):
        for d in (64, 128, 160, 256):
            for rep in (1, 4, 8):
                for b in (1, 3):
                    q = torch.randn(b, s, 8, d, generator=g, device=dev).bfloat16()
                    k = torch.randn(b, s, 8 // rep, d, generator=g, device=dev).bfloat16()
                    v = torch.randn(b, s, 8 // rep, d, generator=g, device=dev).bfloat16()
                    got = flash_attention_bshd(q, k, v)
                    torch.cuda.synchronize()
                    check("flash_attention", torch.bfloat16, f"flash_wgmma B={b} H=8 Hkv={8 // rep} S={s} D={d}", got,
                          flash_attention_bshd(q, k, v, use_kernel=False), FLASH_TOL[torch.bfloat16])
                    n_cases += 1
    del q, k, v, got
    if kernels.VARIANT_LAUNCHES["flash_attention"]["flash_wgmma"] - before != n_cases:
        fail("the flash_wgmma grid did not launch flash_wgmma once per case")
    log(f"  flash_wgmma: {n_cases} cases held per row to {FLASH_TOL[torch.bfloat16]}")
    for name, w in worst.items():
        metric = "per-row relative" if name == "flash_attention" else "relative to max |value|"
        log(f"  {name} worst error vs plain ({metric}): " + ", ".join(f"{k} {v:.2e}" for k, v in w.items()))
    return worst


# ------------------------------------------------------------- phases 6, 7
def lm_full_width(arch: str, dev, layers=None, f32_layers=None, seq: int = LM_SEQ, variant="flash_wgmma"):
    """One architecture at its published width and depth (or ``layers``
    deep), random bf16 weights: prefill through make_prefill_step, the
    kernel path's full logits against the plain path's (in float32 at
    ``f32_layers`` deep), then launch/serve.main.  Flash must run once per
    attention layer as ``variant``; the RWKV6 scan once per layer as the
    split the wrapper picks.  In float32 a MoE's plain path takes the
    experts that the kernel path's router chose (``moe.routing_tape``)."""
    from repro_torch import kernels, models
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.specs import make_batch, make_prefill_step
    from repro_torch.models.moe import routing_tape

    t_start = time.perf_counter()
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    kernel = "rwkv6_scan" if cfg.family == "ssm" else "flash_attention"
    n_kernel = cfg.n_layers if cfg.family in ("ssm", "audio") else cfg.layer_kinds().count("attn")
    t0 = time.perf_counter()
    params = models.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    weights_gb = sum(p.numel() * p.element_size() for p in params.values()) / 1e9
    rec = dict(arch=arch, kernel=kernel, layers=cfg.n_layers, weights_gb=weights_gb, init_s=time.perf_counter() - t0,
               batch=LM_BATCH, seq=seq)
    batch = make_batch(cfg, LM_BATCH, seq, torch.Generator(device=dev).manual_seed(1), dev)
    prefill = make_prefill_step(cfg)
    prefill(params, batch)  # warm-up: cuBLAS handles, kernel library load
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    nxt = prefill(params, batch)
    torch.cuda.synchronize()
    rec["prefill_s"] = time.perf_counter() - t0
    rec["launches"] = dict(kernels.LAUNCHES)
    rec["variant_launches"] = dict(kernels.VARIANT_LAUNCHES[kernel])
    rec["prefill_tok_s"] = LM_BATCH * seq / rec["prefill_s"]
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if rec["launches"][kernel] != n_kernel:
        fail(f"{arch} prefill launched {kernel} {rec['launches'][kernel]} times, not once per layer ({n_kernel})")
    if kernel == "flash_attention" and rec["variant_launches"][variant] != n_kernel:
        fail(f"{arch} prefill ran flash attention as {rec['variant_launches']}, not {variant} in every attention layer")
    if kernel == "rwkv6_scan":
        from repro_torch.kernels.rwkv6_scan.ops import variant as scan_variant
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        variant = rec["scan_variant"] = scan_variant(cfg.rwkv_head_dim, LM_BATCH * cfg.n_heads, sms)
        if rec["variant_launches"][variant] != n_kernel:
            fail(f"{arch} prefill ran the scan as {rec['variant_launches']}, not {variant} in every layer")
    log(f"  {arch} prefill: {kernel} ran {rec['variant_launches'][variant]} of {n_kernel} times as {variant}")
    if tuple(nxt.shape) != (LM_BATCH, cfg.vocab_size) or not bool(torch.isfinite(nxt).all()):
        fail(f"{arch} prefill: next-token logits {tuple(nxt.shape)}, finite={bool(torch.isfinite(nxt).all())}")
    del nxt

    # the kernel path's full-width logits against the plain path's: in bf16
    # (reported), then with the weights in float32 (held)
    t0 = time.perf_counter()
    got = models.forward(cfg, params, batch)[..., : cfg.vocab_size]
    torch.cuda.synchronize()
    rec["forward_kernel_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = models.forward(cfg, params, batch, use_kernel=False)[..., : cfg.vocab_size]
    torch.cuda.synchronize()
    rec["forward_plain_s"] = time.perf_counter() - t0
    rec["logits_max_abs"] = want.float().abs().max().item()
    rec["logits_max_abs_err"] = max((got[i].float() - want[i].float()).abs().max().item() for i in range(LM_BATCH))
    rec["logits_rel_err"] = rec["logits_max_abs_err"] / rec["logits_max_abs"]
    rec["logits_row_rel_err"] = logits_row_dist(got, want)
    rec["argmax_agree"] = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    rec["logits_finite"] = bool(torch.isfinite(got).all())
    del got
    if f32_layers and f32_layers != cfg.n_layers:  # float32 weights of every layer would not fit
        del params, want
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(cfg, n_layers=f32_layers)
        params = models.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        want = models.forward(cfg, params, batch, use_kernel=False)[..., : cfg.vocab_size]
    rec["f32_layers"] = cfg.n_layers
    for k in list(params):  # in place, one tensor at a time
        params[k] = params[k].float()
    torch.cuda.empty_cache()
    with routing_tape() as tape:
        got = models.forward(cfg, params, batch)[..., : cfg.vocab_size]
    want32 = models.forward(cfg, params, batch, use_kernel=False)[..., : cfg.vocab_size]
    rec["bf16_vs_f32_row_rel_err"] = logits_row_dist(want, want32)  # the control
    if tape:  # MoE: the plain path held on the experts the kernel path chose
        rec["f32_free_routing_row_rel_err"] = logits_row_dist(got, want32)  # reported
        del want32
        with routing_tape(replay=tape):
            want32 = models.forward(cfg, params, batch, use_kernel=False)[..., : cfg.vocab_size]
    rec["f32_logits_row_rel_err"] = logits_row_dist(got, want32)
    del got, want, want32, params
    torch.cuda.empty_cache()

    # serving: cached decode through the entry point, its own weights
    buf = io.StringIO()
    kernels.reset_launches()
    t0 = time.perf_counter()
    argv = ["--arch", arch, "--batch", str(LM_BATCH), "--prompt-len", "16", "--gen-len", "32"]
    with contextlib.redirect_stdout(buf):
        gen = serve.main(argv + (["--layers", str(layers)] if layers else []))
    rec["serve_s"] = time.perf_counter() - t0
    out = buf.getvalue()
    found = re.search(r"steps in ([0-9.]+)s \(([0-9.]+) tok/s decode\); first step ([0-9.]+)s, then ([0-9.]+) tok/s", out)
    if found:  # decode_tok_s: the steps after the first, one window of 4 x 47
        rec["decode_s"], rec["decode_all_tok_s"], rec["decode_first_step_s"], rec["decode_tok_s"] = map(
            float, found.groups())
    rec["serve_launches"] = dict(kernels.LAUNCHES)
    log(f"  serve.main: {out.strip().splitlines()[0] if out.strip() else '(no output)'}")
    if tuple(gen.shape) != (LM_BATCH, 32) or found is None:
        fail(f"{arch} serve.main returned {tuple(gen.shape)} tokens; output {out!r}")
    del gen
    torch.cuda.empty_cache()
    rec["wall_s"] = time.perf_counter() - t_start
    log(f"  {arch} " + json.dumps(rec))
    if not rec["logits_finite"]:
        fail(f"{arch} bf16 logits of the kernel path are not finite")
    tol = F32_LOGITS_TOL[arch]
    if not rec["f32_logits_row_rel_err"] <= tol < rec["bf16_vs_f32_row_rel_err"]:
        fail(f"{arch} float32 logits: kernel vs plain per-token rel err {rec['f32_logits_row_rel_err']:.3e} and the "
             f"control (bf16 vs float32 weights) {rec['bf16_vs_f32_row_rel_err']:.3e} do not bracket {tol}")
    return rec


def logits_row_dist(a, b) -> float:
    """row_rel_err over [B, S, V] logits, one request at a time."""
    return max(row_rel_err(a[i], b[i]) for i in range(a.shape[0]))


# ----------------------------------------------------------------- phase 8
def decode_vs_prefill(dev):
    """Cached decode reproduces the kernel path's teacher-forced logits at
    smoke size in f32, to the reference's 2e-3 (tests/test_models.py), for
    every architecture (a VLM's decode runs on text alone, as the
    reference's; Whisper's after priming its cross cache).  Then one
    int8-KV-cache decode on the card against the same decode on the CPU."""
    from repro_torch import models
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models.whisper import whisper_prime_cache

    worst = {}
    s = 40
    for arch in ARCH_IDS:
        cfg = get_config(arch).smoke()
        params = models.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        g = torch.Generator(device=dev).manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, s), generator=g, device=dev)}
        if cfg.family == "vlm":
            batch["patch_embeds"] = torch.zeros(2, 0, cfg.d_model, device=dev)
        cache = models.init_cache(cfg, 2, s, dev)
        if cfg.family == "audio":
            batch["enc_embeds"] = torch.randn(2, cfg.enc_seq_len, cfg.d_model, generator=g, device=dev)
            cache = whisper_prime_cache(cfg, params, cache, batch["enc_embeds"])
        full = models.forward(cfg, params, batch)
        dec = []
        for t in range(s):
            logits, cache = models.decode_step(cfg, params, cache, batch["tokens"][:, t], t)
            dec.append(logits)
        dec = torch.stack(dec, 1)
        bad = (dec - full).abs() > 2e-3 + 2e-3 * full.abs()
        worst[arch] = (dec - full).abs().max().item()
        log(f"  {arch} smoke f32: decode vs prefill max abs diff {worst[arch]:.2e}")
        if bool(bad.any()):
            fail(f"{arch}: decode differs from prefill beyond rtol/atol 2e-3")
    # the int8 KV cache: the same weights and tokens decoded on the card and
    # on the CPU; logits to the decode bound 2e-3 (a value that rounds to the
    # other int8 neighbour on one device moves its logit by one step of 1/127
    # of its row's absmax), and the share of int8 entries that differ
    cfg = dataclasses.replace(get_config("llama3_8b").smoke(), kv_cache_dtype="int8")
    params = models.init(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, s), generator=torch.Generator().manual_seed(1))
    runs = {}
    for where in ("cpu", dev):
        p = {k: v.to(where) for k, v in params.items()}
        cache = models.init_cache(cfg, 2, s, where)
        out = [models.decode_step(cfg, p, cache, tok[:, t].to(where), t)[0] for t in range(s)]
        runs[str(where)] = (torch.stack(out, 1).cpu(), {k: v.cpu() for k, v in cache.items()})
    (cpu_l, cpu_c), (card_l, card_c) = runs["cpu"], runs[str(dev)]
    worst["int8_card_vs_cpu"] = (card_l - cpu_l).abs().max().item()
    int8_keys = [k for k, v in cpu_c.items() if v.dtype == torch.int8]
    worst["int8_entries_differing"] = sum(int((card_c[k] != cpu_c[k]).sum()) for k in int8_keys) / sum(
        cpu_c[k].numel() for k in int8_keys)
    log(f"  llama3_8b smoke int8 cache: card vs CPU logits max abs diff {worst['int8_card_vs_cpu']:.2e}, int8 "
        f"entries differing {worst['int8_entries_differing']:.2e}")
    if not bool(((card_l - cpu_l).abs() <= 2e-3 + 2e-3 * cpu_l.abs()).all()):
        fail("int8 KV-cache decode on the card differs from the CPU's beyond rtol/atol 2e-3")
    return worst


# ----------------------------------------------------------------- phase 9
def lm_kernel_timings(dev):
    """Flash attention and the scan timed at the prefill's shapes, each
    against its plain version; flash also against PyTorch's
    scaled_dot_product_attention (the yardstick only: the port never calls
    it).  Bounds from this run's shapes and the H100 SXM data sheet."""
    from repro_torch.configs import get_config

    g = torch.Generator(device=dev).manual_seed(3)
    rows = {}
    # flash: llama3_8b's attention at B=4, S=2048: 32 query heads, 8 KV
    # heads, D=128, bf16 (flash_wgmma; with the planted-fault controls);
    # then the attention of every phase 19 family at its prefill's S, heads
    # and head dim, as the variant FAMILIES names (flash_wgmma at pixtral_12b's
    # D=160 and recurrentgemma_2b's D=256 too); families of one shape share a row
    rows["flash_attention"] = flash_timing(dev, g, LM_BATCH, LM_SEQ, 32, 8, 128, controls=True)
    by_shape = {}
    for arch, spec in FAMILIES.items():
        cfg = get_config(arch)
        shape = (spec["seq"], cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
        if shape in by_shape:
            rows[by_shape[shape]]["archs"].append(arch)
            continue
        by_shape[shape] = key = f"flash_{arch}"
        rows[key] = row = dict(archs=[arch], **flash_timing(dev, g, LM_BATCH, *shape, controls=False))
        if row["variant"] != spec["variant"]:
            fail(f"flash at {arch}'s attention {shape} launched {row['variant']}, not {spec['variant']}")
    # the yardstick at the two widest heads: flash_mma (mma.sync, its DMAX=256
    # instantiation) forced at the shapes where the wrapper takes flash_wgmma
    for arch in ("pixtral_12b", "recurrentgemma_2b"):
        sh = rows[f"flash_{arch}"]["shape"]
        rows[f"flash_mma_{arch}"] = flash_timing(dev, g, LM_BATCH, sh["S"], sh["H"], sh["Hkv"], sh["D"], controls=False,
                                                 kind="flash_mma")
    # scan: rwkv6_3b's time-mix at T=2048, 40 heads of 64, r/k/v bf16, at
    # B=4 (the prefill's, in the kernels line) and B=1 (one request)
    for b, key in ((LM_BATCH, "rwkv6_scan"), (1, "rwkv6_scan_b1")):
        rows[key] = scan_timing(dev, g, b)
    for name, row in rows.items():
        log(f"  timing {name} " + json.dumps(row))
        if not row["rel_err"] <= (FLASH_TOL[torch.bfloat16] if name.startswith("flash") else SCAN_TOL[torch.float32]):
            fail(f"{name} at the prefill's shape: kernel vs plain rel err {row['rel_err']:.3e}")
        if "state_rel_err" in row and not row["state_rel_err"] <= SCAN_TOL[torch.float32]:
            fail(f"{name} at the prefill's shape: final state vs plain rel err {row['state_rel_err']:.3e}")
    return rows


def flash_timing(dev, g, b: int, s: int, h: int, hkv: int, d: int, controls: bool, kind=None) -> dict:
    """Flash at [B, S, H, D] with Hkv KV heads in bf16, as the variant the
    wrapper picks (or ``kind``), against its plain version and
    scaled_dot_product_attention, with its bound; with ``controls``, the
    planted-fault plain versions must read above the limit."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention.ops import flash_attention_bshd, variant

    q = torch.randn(b, s, h, d, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(b, s, hkv, d, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(b, s, hkv, d, generator=g, device=dev).to(torch.bfloat16)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True, enable_gqa=True)
    kind = kind or variant(torch.bfloat16, d)
    fns = dict(ms=lambda: flash_attention_bshd(q, k, v, kind=kind),
               plain_ms=lambda: flash_attention_bshd(q, k, v, use_kernel=False), library_ms=sdpa)
    before = kernels.VARIANT_LAUNCHES["flash_attention"][kind]
    got, want = fns["ms"](), fns["plain_ms"]()
    if kernels.VARIANT_LAUNCHES["flash_attention"][kind] != before + 1:
        fail(f"flash at D={d} did not launch {kind}")
    err = rel_err(got, want)[0]
    rel = row_rel_err(got, want)
    lib_err = row_rel_err(sdpa().transpose(1, 2), want)
    row = dict(shape=dict(B=b, S=s, H=h, Hkv=hkv, D=d, dtype="bfloat16"), variant=kind, max_abs_err=err, rel_err=rel,
               library_rel_err=lib_err)
    tol = FLASH_TOL[torch.bfloat16]
    if controls:
        row["fault_controls"] = faults = flash_controls(q, k, v, want)
        log(f"  flash bf16 per-row rel err {rel:.3e}, limit {tol}, planted-fault controls "
            + ", ".join(f"{name} {c:.3e}" for name, c in faults.items()))
        if not min(faults.values()) > tol:
            fail(f"flash bf16 limit {tol} does not reject every planted fault: {faults}")
    del got, want
    ops = 4.0 * d * b * h * s * (s + 1) / 2  # q k^T and p v over the causal pairs
    nbytes = 2.0 * (2 * b * s * h * d + 2 * b * s * hkv * d)  # q, o and k, v in bf16
    row.update(ops=ops, bytes=nbytes, **timed(fns, dict(ms=20, plain_ms=3, library_ms=20)), **bound(ops, 989e12, nbytes))
    return row


def scan_timing(dev, g, b: int) -> dict:
    """The scan at rwkv6_3b's time-mix shape (T=2048, H=40, N=64, bf16 in,
    float32 out) against its plain version, with launches by variant.  Its
    bound: bytes (inputs read once, outputs written once), or the operations
    at the rates they run at, whichever is longer -- tensor-core products at
    495 TFLOP/s TF32 over their split passes (3 with both operands float32,
    2 against v, exact in TF32), the rest at 67 TFLOP/s on the CUDA cores.
    The bound as counted before the tensor cores took the products, every
    operation at 67 TFLOP/s, is logged beside it."""
    from repro_torch import kernels
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_wkv

    t, h, n, c = LM_SEQ, 40, 64, 32  # the kernel's chunk; T is a multiple of it here
    r, kk = ((0.5 * torch.randn(b, t, h, n, generator=g, device=dev)).to(torch.bfloat16) for _ in range(2))
    vv = torch.randn(b, t, h, n, generator=g, device=dev).to(torch.bfloat16)
    logw = -torch.exp(torch.randn(b, t, h, n, generator=g, device=dev).clamp(-8.0, 6.0))
    u = 0.1 * torch.randn(h, n, generator=g, device=dev)
    f32 = torch.float32  # the wkv output type that time_mix asks for
    fns = dict(ms=lambda: rwkv6_wkv(r, kk, vv, logw, u, out_dtype=f32),
               plain_ms=lambda: rwkv6_wkv(r, kk, vv, logw, u, out_dtype=f32, use_kernel=False))
    before = dict(kernels.VARIANT_LAUNCHES["rwkv6_scan"])
    (got, s_got), (want, s_want) = fns["ms"](), fns["plain_ms"]()
    launched = {k: v - before[k] for k, v in kernels.VARIANT_LAUNCHES["rwkv6_scan"].items() if v != before[k]}
    err, rel = rel_err(got, want)
    chunks = (t // c) * b * h
    # the count before the tensor cores took the products: every operation of
    # the chunked algorithm at 67 TFLOP/s
    per_chunk = (4 * c * n * n + n * n + 3 * n * c * (c - 1) / 2 + 3 * n * c + 2 * n * c * (c + 1) / 2 + 4 * c * n)
    pairs = 4 * (8 * 7 // 2)  # pairs (t, i < t) inside the four diagonal sub-blocks of 8
    tensor = {  # flops of each tensor-core product per chunk, and its split passes
        "carry_in": (2 * c * n * n, 3), "state_increment": (2 * n * c * n, 2),
        "intra": (2 * (c * (c + 1) // 2) * n, 2), "offdiag_scores": (2 * (6 * 8 * 8) * n, 3),
    }
    cuda_ops = (2 * c * n + 10 * n + pairs * n  # exponentials
                + 2 * c * n + 4 * c * n          # sub-chunk scans; r, k and their decayed forms
                + 3 * pairs * n + 3 * c * n      # diagonal pairs, bonus
                + 2 * n * n + c * n)             # state update, out = intra + carry-in
    t_tensor = chunks * sum(f * passes for f, passes in tensor.values()) / 495e12 * 1e3
    t_cuda = chunks * cuda_ops / 67e12 * 1e3
    nbytes = 2.0 * 3 * b * t * h * n + 4.0 * 2 * b * t * h * n + 4.0 * h * n + 4.0 * b * h * n * n  # r,k,v; logw,out; u; state
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bound_ms = max(t_tensor, t_cuda, t_bytes)
    row = dict(shape=dict(B=b, T=t, H=h, N=n, dtype="bfloat16", out_dtype="float32", chunk=c), max_abs_err=err,
               rel_err=rel, state_rel_err=rel_err(s_got, s_want)[1], launches_by_variant=launched,
               tensor_flops=chunks * sum(f for f, _ in tensor.values()), cuda_core_ops=chunks * cuda_ops, bytes=nbytes,
               library_ms=None, **timed(fns, dict(ms=20, plain_ms=1)),
               bound_ms=bound_ms, bound_by="bytes" if bound_ms == t_bytes else "operations",
               bound_tensor_ms=t_tensor, bound_cuda_core_ms=t_cuda, bound_bytes_ms=t_bytes,
               bound_f32_ms=max(per_chunk * chunks / 67e12 * 1e3, t_bytes))
    log(f"  scan B={b}: {row['ms']:.4f} ms (plain {row['plain_ms']:.1f} ms), bound {bound_ms:.4f} ms by {row['bound_by']} "
        f"(tensor cores {t_tensor:.4f}, CUDA cores {t_cuda:.4f}, bytes {t_bytes:.4f}; every operation at 67 TFLOP/s "
        f"{row['bound_f32_ms']:.4f}), rel err {rel:.2e}, state {row['state_rel_err']:.2e}, launches {launched}")
    return row


def flash_controls(q, k, v, want, tile: int = 64) -> dict:
    """Plain attention with a planted fault in the rows of the last query
    tile, each held against ``want`` by the per-row metric: one key tile in
    the middle of the sequence dropped, and that tile's share left out of the
    softmax denominator.  Both must read above the bf16 limit."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    kk, vv = (a.float().repeat_interleave(rep, dim=2) for a in (k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", q[:, s - tile:].float(), kk) / d**0.5
    causal = torch.arange(s, device=q.device)[None, :] <= torch.arange(s - tile, s, device=q.device)[:, None]
    e = torch.where(causal, logits, -torch.inf)
    e = (e - e.amax(-1, keepdim=True)).exp()
    mid = slice(s // 2, s // 2 + tile)
    dropped = e.clone()
    dropped[..., mid] = 0.0
    faults = dict(key_tile_dropped=(dropped, dropped.sum(-1, keepdim=True)),
                  denominator_tile_dropped=(e, dropped.sum(-1, keepdim=True)))
    return {name: row_rel_err(torch.einsum("bhqk,bkhd->bqhd", p, vv).div(l.transpose(1, 2)).to(want.dtype),
                              want[:, s - tile:])
            for name, (p, l) in faults.items()}


# ---------------------------------------------------------------- phase 10
def bst_rel_err(got, want) -> float:
    """Largest |got - want| over the blocks, relative to the largest |want|."""
    if set(got.blocks) != set(want.blocks):
        fail(f"block keys differ: {sorted(set(got.blocks) ^ set(want.blocks))[:5]}")
    scale = max(b.abs().max().item() for b in want.blocks.values())
    return max((got.blocks[k] - want.blocks[k]).abs().max().item() for k in want.blocks) / max(scale, 1e-300)


def planned_pipeline(dev, record, space, terms, mpo):
    """run_dmrg(algo="batched", jit_matvec=True) with the reference's
    defaults: the 3x2 case against ED and phase 3, the 8x4 run on the full
    BONDS against phase 4, a graph replay against the eager matvec on its
    middle bond, and the block GEMM on that matvec's largest bucket."""
    from repro_torch import kernels
    from repro_torch.core import run_dmrg
    from repro_torch.core.ed import ground_energy
    from repro_torch.core.env import get_contractor
    from repro_torch.core.models import heisenberg_j1j2_terms
    from repro_torch.core.siteops import spin_half_space
    from repro_torch.tensor.blocksparse import BlockSparseTensor

    rec = {}
    kw = dict(algo="batched", jit_matvec=True, device=dev)
    # the 3x2 case, against ED and the csr run of phase 3
    sp, small_terms = spin_half_space(), heisenberg_j1j2_terms(3, 2, 1.0, 0.5, cylinder=False)
    e_small = run_dmrg(sp, small_terms, 6, bond_schedule=(8, 16), davidson_iters=6, **kw).energy
    e_ed, e_csr = record["small"]["e_ed"], record["small"]["e_csr"]
    log(f"  3x2 E(batched, graphs)={e_small:.12f} |dE_ED|={abs(e_small - e_ed):.2e} |dE_csr|={abs(e_small - e_csr):.2e}")
    if not (abs(e_small - e_ed) <= 1e-8 and abs(e_small - e_csr) <= 1e-10):
        fail(f"3x2 batched energy {e_small} vs ED {e_ed} and csr {e_csr}")
    rec["small"] = dict(energy=e_small, e_ed=e_ed, e_csr=e_csr)

    # the 8x4 run on the full schedule
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run_dmrg(space, terms, len(mpo), bond_schedule=BONDS, sweeps_per_bond=1, davidson_iters=2, mpo=mpo, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, variants = dict(kernels.LAUNCHES), dict(kernels.VARIANT_LAUNCHES["block_gemm"])
    sweeps = []
    for m, st in zip(BONDS, res.sweep_stats):
        row = dict(m=m, energy=st.energy, seconds=st.seconds, svd_seconds=st.svd_seconds, env_seconds=st.env_seconds,
                   max_bond=st.max_bond, trunc_err=st.trunc_err, davidson_restarts=st.davidson_restarts,
                   davidson_exhausted=st.davidson_exhausted, graphs=st.graphs,
                   block_gemm_launches=st.block_gemm_launches, peak_gib=st.peak_bytes / 2**30)
        sweeps.append(row)
        log("  sweep " + json.dumps(row))
    e_last, e_csr_last = sweeps[-1]["energy"], record["full_size"]["sweeps"][-1]["energy"]
    log(f"  run {wall:.1f} s, block_gemm launches by variant {variants} (replays included), peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; last sweep E={e_last:.12f}, csr (phase 4) "
        f"{e_csr_last:.12f}, |dE|={abs(e_last - e_csr_last):.2e}")
    es = [r["energy"] for r in sweeps]
    if not all(np.isfinite(es)) or not all(es[i + 1] <= es[i] + 1e-9 for i in range(len(es) - 1)):
        fail(f"batched sweep energies {es}")
    if any(r["davidson_exhausted"] for r in sweeps):
        fail("a batched sweep had exhausted Davidson solves")
    if not abs(e_last - e_csr_last) <= 1e-8:
        fail(f"batched last-sweep energy {e_last} vs csr {e_csr_last}")
    rec["ladder"] = assert_no_recovery("the batched run", res)
    replays = sum(r["graphs"]["graph_replays"] for r in sweeps)
    if launches["block_gemm"] == 0 or replays == 0 or variants["skinny"] == 0 or variants["tiled_dmma"] == 0:
        fail(f"the batched run launched {variants} block GEMMs with {replays} graph replays")
    rec.update(bonds=BONDS, sweeps=sweeps, wall_s=wall, launches=launches, variant_launches=variants,
               graph_replays=replays, peak_gib=torch.cuda.max_memory_allocated() / 2**30)

    # graph replays against the eager matvec on the middle bond, with a
    # fresh engine: the first call captures, every call replays
    engine = get_contractor("batched", dev)
    j, (A, Wj, Wj1, B, x1) = padded_middle_bond(engine, res, mpo)
    g = torch.Generator(device=dev).manual_seed(7)
    x2 = BlockSparseTensor(x1.indices, {k: torch.randn(b.shape, generator=g, dtype=b.dtype, device=dev)
                                        for k, b in x1.blocks.items()}, x1.charge)
    mv = engine.matvec_fn(A, Wj, Wj1, B, jit=True)
    before = engine.graphs.stats()
    outs = [(x, mv(x)) for x in (x1, x2, x1, x2)]
    after = engine.graphs.stats()
    if (after["graph_captures"] - before["graph_captures"], after["graph_replays"] - before["graph_replays"]) != (1, 4):
        fail(f"the middle-bond matvec did not capture once and replay four times: {before} -> {after}")
    errs = [bst_rel_err(y, engine.two_site_matvec(A, Wj, Wj1, B, x)) for x, y in outs]
    apart = bst_rel_err(outs[1][1], outs[0][1])
    log(f"  middle bond {j}: graph replays vs eager matvec rel err {errs} (x1, x2, x1, x2); "
        f"x1 vs x2 results {apart:.2e} apart")
    if not max(errs) <= 1e-12 or not apart > 1e-3:
        fail(f"graph replay vs eager {errs}, replays of two inputs {apart:.2e} apart")
    rec["replay_vs_eager"] = dict(bond=j, rel_errs=errs, x1_vs_x2=apart, graphs=after)

    # the block GEMM on the largest bucket of that matvec
    rec["largest_bucket"] = bucket_row(dev, max(matvec_buckets(dev, engine, A, Wj, Wj1, B, x1), key=lambda c: c[0]),
                                       "largest bucket")
    return rec


def padded_middle_bond(engine, res, mpo):
    """The middle bond j of a run's state and its two-site matvec's padded
    operands (A, W[j], W[j+1], B and the two-site tensor), as the planned
    pipeline pads them, the environments built through ``engine``."""
    from repro_torch.core.env import left_edge, right_edge
    from repro_torch.dist.batch import pad_block_sparse

    T, n = res.mps.tensors, len(mpo)
    j = n // 2 - 1
    A = left_edge(T[0], mpo[0])
    for i in range(j):
        A = engine.env_update_left(A, T[i], mpo[i])
    B = right_edge(T[n - 1], mpo[n - 1])
    for i in range(n - 2, j, -1):
        B = engine.env_update_right(B, T[i + 1], mpo[i + 1])
    return j, tuple(pad_block_sparse(t) for t in (A, mpo[j], mpo[j + 1], B, engine(T[j], T[j + 1], ((2,), (0,)))))


def matvec_buckets(dev, engine, A, Wj, Wj1, B, x) -> list:
    """Every shape bucket of the two-site matvec's four steps through a
    batched ``engine``: (flops, step, bucket, device out-slot table, plan,
    a, b) each."""
    from repro_torch.dist.engine import MATVEC_AXES

    out, t = [], x
    for i, axes in enumerate(MATVEC_AXES):
        a, b = (A, t) if i == 0 else (t, (Wj, Wj1, B)[i - 1])
        plan = engine.cache.get(a, b, axes)
        for bucket, oi in zip(plan.batched.buckets, plan.batched.device_tables(dev)):
            out.append((2.0 * len(bucket.oi) * bucket.m * bucket.k * bucket.n, i, bucket, oi, plan, a, b))
        t = engine(a, b, axes)
    return out


def bucket_row(dev, cand, what: str) -> dict:
    """The block GEMM on one bucket of ``matvec_buckets`` against its plain
    version (1e-12 relative), timed beside it and bmm + index_add_, with its
    bound."""
    from repro_torch.dist.batch import bucket_operands, matricize_lhs, matricize_rhs
    from repro_torch.kernels.block_gemm.ops import block_sparse_matmul
    from repro_torch.kernels.block_gemm.ref import block_sparse_matmul_ref
    from repro_torch.kernels.block_gemm.work import variant

    flops, step, bucket, oi, plan, a, b = cand
    lhs, rhs = bucket_operands(bucket, matricize_lhs(a, plan.keep_a, plan.ax_a), matricize_rhs(b, plan.keep_b, plan.ax_b))
    O = len(bucket.out_keys)
    got = block_sparse_matmul(lhs, rhs, oi, O, work=bucket.work)
    want = block_sparse_matmul_ref(lhs, rhs, oi, O)
    err, rel = rel_err(got, want)
    if not rel <= TOL[torch.float64]:
        fail(f"{what}: kernel vs plain rel err {rel:.3e}")
    idx = oi.long()

    def library():
        return torch.zeros((O, bucket.m, bucket.n), dtype=lhs.dtype, device=dev).index_add_(0, idx, torch.bmm(lhs, rhs))

    nbytes = lhs.element_size() * (lhs.numel() + rhs.numel() + O * bucket.m * bucket.n) + 4 * len(bucket.oi)
    row = dict(step=step, P=len(bucket.oi), M=bucket.m, K=bucket.k, N=bucket.n, O=O,
               variant=variant(bucket.work.route, lhs.dtype), max_abs_err=err, rel_err=rel, flops=flops,
               bytes=nbytes, **timed(dict(ms=lambda: block_sparse_matmul(lhs, rhs, oi, O, work=bucket.work),
                                          plain_ms=lambda: block_sparse_matmul_ref(lhs, rhs, oi, O),
                                          library_ms=library), dict(ms=20, plain_ms=20, library_ms=20)),
               **bound(flops, PEAK_FLOPS[lhs.dtype], nbytes))
    log(f"  {what} " + json.dumps(row))
    return row


def assert_no_recovery(what: str, res) -> dict:
    """Every ladder counter of a run is zero.  A ladder recovers only from an
    injected fault or a health guard's finding (a kernel that fails to build
    or launch raises through it), but a kernel whose non-finite output a
    pair ladder recovered would otherwise pass unseen."""
    st = res.engine_stats
    counters = dict(retries=st["retries"], degradations=st["degradations"],
                    svd_retries=st["decomp"]["retries"], svd_degradations=st["decomp"]["degradations"],
                    pair_retries=[s.pair_retries for s in res.sweep_stats])
    if (counters["retries"] or counters["degradations"] or counters["svd_retries"]
            or any(counters["svd_degradations"].values()) or any(counters["pair_retries"])):
        fail(f"{what}: a ladder recovered something in a clean run: {counters}")
    return counters


# ---------------------------------------------------------------- phase 11
def auto_path(dev, record, space, terms, mpo):
    """run_dmrg(algo="auto", jit_matvec=True), the reference's defaults, on
    the 8x4 cylinder over the full BONDS: per sweep its seconds, SVD seconds,
    contractions by backend, graph captures and replays, block GEMM launches
    by variant and peak memory; its last energy held to phase 10's (1e-8)
    and every ladder counter zero.  The block GEMM runs here exactly where
    the cost model chooses the batched backend."""
    from repro_torch import kernels
    from repro_torch.core import run_dmrg

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run_dmrg(space, terms, len(mpo), bond_schedule=BONDS, sweeps_per_bond=1, davidson_iters=2, mpo=mpo,
                   algo="auto", jit_matvec=True, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, variants = dict(kernels.LAUNCHES), dict(kernels.VARIANT_LAUNCHES["block_gemm"])
    sweeps = []
    for m, st in zip(BONDS, res.sweep_stats):
        row = dict(m=m, energy=st.energy, seconds=st.seconds, svd_seconds=st.svd_seconds, env_seconds=st.env_seconds,
                   max_bond=st.max_bond, backend_counts=st.backend_counts,
                   graph_captures=st.graphs["graph_captures"], graph_replays=st.graphs["graph_replays"],
                   pool_bytes=st.graphs["pool_bytes"], block_gemm_launches=st.block_gemm_launches,
                   peak_gib=st.peak_bytes / 2**30, davidson_exhausted=st.davidson_exhausted)
        sweeps.append(row)
        log("  sweep " + json.dumps(row))
    counters = assert_no_recovery("the auto run", res)
    e_last, e_batched = sweeps[-1]["energy"], record["planned"]["sweeps"][-1]["energy"]
    chosen = {k: sum(r["backend_counts"][k] for r in sweeps) for k in sweeps[0]["backend_counts"]}
    log(f"  run {wall:.1f} s, contractions by backend {chosen} (captures and eager calls; replays run none), "
        f"block_gemm launches by variant {variants} (replays included), peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; last sweep E={e_last:.12f}, batched (phase 10) "
        f"{e_batched:.12f}, |dE|={abs(e_last - e_batched):.2e}; ladder counters {counters}")
    es = [r["energy"] for r in sweeps]
    if not all(np.isfinite(es)) or any(r["davidson_exhausted"] for r in sweeps):
        fail(f"auto sweep energies {es}")
    if not abs(e_last - e_batched) <= 1e-8:
        fail(f"auto last-sweep energy {e_last} vs batched {e_batched}")
    if sum(r["graph_replays"] for r in sweeps) == 0:
        fail("the auto run replayed no graph")
    # the kernel is on this path exactly where the cost model routes to batched
    if (launches["block_gemm"] > 0) != (chosen["batched"] > 0):
        fail(f"auto chose batched {chosen['batched']} times and launched {launches['block_gemm']} block GEMMs")
    return dict(bonds=BONDS, sweeps=sweeps, wall_s=wall, launches=launches, variant_launches=variants,
                backend_counts=chosen, ladder=counters, peak_gib=torch.cuda.max_memory_allocated() / 2**30), res


# ---------------------------------------------------------------- phase 12
def dense_vs_batched(dev, res, mpo):
    """On the auto run's middle bond (m=1024) one two-site matvec through a
    dense, a batched and a list engine (eager), held to each other (1e-12
    relative) and timed with CUDA events; then algo="dense" and "auto" on
    the 3x2 case against ED (1e-8)."""
    from repro_torch.core import run_dmrg
    from repro_torch.core.ed import ground_energy
    from repro_torch.core.env import left_edge, right_edge
    from repro_torch.core.models import heisenberg_j1j2_terms
    from repro_torch.core.siteops import spin_half_space
    from repro_torch.dist.engine import ContractionEngine

    T, n = res.mps.tensors, len(mpo)
    j = n // 2 - 1
    batched = ContractionEngine("batched")
    A = left_edge(T[0], mpo[0])
    for i in range(j):
        A = batched.env_update_left(A, T[i], mpo[i])
    B = right_edge(T[n - 1], mpo[n - 1])
    for i in range(n - 2, j, -1):
        B = batched.env_update_right(B, T[i + 1], mpo[i + 1])
    x = batched(T[j], T[j + 1], ((2,), (0,)))
    rec = dict(bond=j, m=T[j].indices[2].dim, x_blocks=len(x.blocks))
    out, mvs = {}, {}
    for name in ("batched", "dense", "list"):
        engine = batched if name == "batched" else ContractionEngine(name)
        mvs[name] = engine.matvec_fn(A, mpo[j], mpo[j + 1], B, jit=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out[name] = mvs[name](x)
        torch.cuda.synchronize()
        rec[f"{name}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    for name in ("dense", "list"):
        rec[f"{name}_vs_batched_rel_err"] = bst_rel_err(out[name], out["batched"])
    rec.update(timed({f"{k}_ms": (lambda f=f: f(x)) for k, f in mvs.items()}, dict(batched_ms=5, dense_ms=5, list_ms=5)))
    log("  middle bond matvec " + json.dumps(rec))
    if not max(rec["dense_vs_batched_rel_err"], rec["list_vs_batched_rel_err"]) <= 1e-12:
        fail(f"middle-bond matvec: dense/list vs batched {rec['dense_vs_batched_rel_err']:.2e} "
             f"{rec['list_vs_batched_rel_err']:.2e}")
    sp, small = spin_half_space(), heisenberg_j1j2_terms(3, 2, 1.0, 0.5, cylinder=False)
    e_ed = ground_energy(sp, small, 6)
    for algo in ("dense", "auto"):
        r = run_dmrg(sp, small, 6, bond_schedule=(8, 16), davidson_iters=6, algo=algo, jit_matvec=True, device=dev)
        rec[f"3x2_{algo}"] = dict(energy=r.energy, e_ed=e_ed, ladder=assert_no_recovery(f"3x2 {algo}", r))
        log(f"  3x2 E({algo}, graphs)={r.energy:.12f} |dE_ED|={abs(r.energy - e_ed):.2e}")
        if not abs(r.energy - e_ed) <= 1e-8:
            fail(f"3x2 {algo} energy {r.energy} vs ED {e_ed}")
    return rec


# ---------------------------------------------------------------- phase 13
def faults_on_card(dev):
    """Each DMRG fault point armed once on the 6-site Heisenberg chain
    (h=0.3, two sweeps at m=8) of the reference's fault tests: the recovered
    energy held to a clean run on the card (1e-10), with the counters those
    tests assert.  The sweep.kill point is phase 14's."""
    import math

    from repro_torch.core.models import heisenberg_chain_system
    from repro_torch.core.mpo import build_mpo, compress_mpo
    from repro_torch.core.mps import neel_states, product_state_mps
    from repro_torch.core.sweep import DMRGEngine
    from repro_torch.dist import faults

    n = 6
    space, terms = heisenberg_chain_system(n, h=0.3)
    mpo = compress_mpo(build_mpo(space, terms, n, device=dev), cutoff=1e-13)

    def two_sweeps(**kw):
        eng = DMRGEngine(product_state_mps(space, neel_states(space, n), device=dev), mpo, algo="batched",
                         davidson_iters=4, device=dev, **kw)
        first = eng.sweep(max_bond=8)
        return eng, first, eng.sweep(max_bond=8)

    faults.registry.clear()
    rec = {}
    for name, jit in (("clean", False), ("clean_graphs", True)):
        eng, _, last = two_sweeps(jit_matvec=jit)
        rec[name] = last.energy
    cases = (
        ("batch.gemm_nan", dict(count=1), dict(jit_matvec=False)),
        ("decomp.svd_fail", dict(count=1), dict(jit_matvec=True)),
        ("env.exception", dict(count=2), dict(jit_matvec=True)),
        ("davidson.no_converge", dict(count=math.inf), dict(jit_matvec=True)),
    )
    try:
        for point, arm, kw in cases:
            with faults.inject(point, **arm) as f:
                eng, first, last = two_sweeps(**kw)
            st = eng.contract_fn.stats()
            row = dict(fired=f.fired, energy=last.energy, retries=st["retries"], degradations=st["degradations"],
                       svd_retries=st["decomp"]["retries"], svd_degradations=st["decomp"]["degradations"],
                       pair_retries=first.pair_retries + last.pair_retries,
                       davidson_converged=first.davidson_converged + last.davidson_converged)
            clean = rec["clean_graphs" if kw["jit_matvec"] else "clean"]
            row["abs_err_vs_clean"] = abs(last.energy - clean)
            log(f"  {point}: " + json.dumps(row))
            expected = {
                "batch.gemm_nan": f.fired == 1 and row["pair_retries"] == 1 and st["degradations"] == {"pair_seed": 1},
                "decomp.svd_fail": f.fired == 1 and row["svd_retries"] == 1
                and row["svd_degradations"] == {"svd_exact": 0, "svd_unplanned": 1},
                "env.exception": f.fired == 2 and st["retries"] == {"env": 2} and st["degradations"] == {"env_seed": 2},
                "davidson.no_converge": f.fired == 2 * 2 * (n - 1) and row["davidson_converged"] == 0,
            }[point]
            if not (expected and row["abs_err_vs_clean"] <= 1e-10):
                fail(f"fault {point}: {row}")
            rec[point] = row
    finally:
        faults.registry.clear()
    return rec


# ---------------------------------------------------------------- phase 14
def checkpoint_resume(dev, space, terms, mpo):
    """The slice's path at a cut depth (bonds 128, 256; the bond reaches 4,
    then 16), killed by sweep.kill after a site update in the middle of the
    second sweep, then rerun on the same checkpoint directory: every sweep
    energy held to the uninterrupted run's (1e-10)."""
    import tempfile

    from repro_torch.core import run_dmrg
    from repro_torch.dist import faults
    from repro_torch.dist.faults import FaultInjected

    n = len(mpo)
    kw = dict(bond_schedule=(128, 256), sweeps_per_bond=1, davidson_iters=2, mpo=mpo, algo="auto",
              jit_matvec=True, device=dev)
    clean = run_dmrg(space, terms, n, **kw)
    kill_after = 2 * (n - 1) + (n - 1)  # site updates before the kill: the first sweep and half the second
    faults.registry.clear()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckdir:
        try:
            with faults.inject("sweep.kill", after=kill_after - 1, count=1) as f:
                try:
                    run_dmrg(space, terms, n, checkpoint_dir=ckdir, **kw)
                except FaultInjected:
                    pass
                else:
                    fail("sweep.kill did not stop the run")
        finally:
            faults.registry.clear()
        t0 = time.perf_counter()
        res = run_dmrg(space, terms, n, checkpoint_dir=ckdir, **kw)
        resume_s = time.perf_counter() - t0
    diffs = [abs(a - b) for a, b in zip(res.energies, clean.energies)]
    site_bitwise = [a.site_energies == b.site_energies for a, b in zip(res.sweep_stats, clean.sweep_stats)]
    rec = dict(killed_after_site_updates=kill_after, fired=f.fired, energies=res.energies,
               clean_energies=clean.energies, abs_diffs=diffs, bitwise_equal=res.energies == clean.energies,
               site_energies_bitwise=site_bitwise, resume_s=resume_s, checkpoint_write_s=res.checkpoint_seconds,
               resumed_graph_captures=[s.graphs["graph_captures"] for s in res.sweep_stats[-1:]])
    log("  resume " + json.dumps(rec))
    if f.fired != 1 or len(diffs) != 2 or not max(diffs) <= 1e-10:
        fail(f"resumed run vs uninterrupted: {rec}")
    assert_no_recovery("the resumed run", res)
    return rec


# ---------------------------------------------------------------- phase 15
def observables(dev, res, space):
    """Sz, SzSz and S+S- on the 3x2 case against ED (1e-8); on the auto
    8x4 ground state the sum of <Sz_i> against the state's total charge
    (1e-8) and correlation_profile("Sz", "Sz", ref=0) timed."""
    from repro_torch.core import run_dmrg
    from repro_torch.core.ed import build_dense_hamiltonian, state_charges_vector
    from repro_torch.core.measure import correlation, correlation_profile, site_expectation
    from repro_torch.core.models import heisenberg_j1j2_terms
    from repro_torch.core.mps import neel_states, total_charge
    from repro_torch.core.siteops import spin_half_space

    sp, small, n = spin_half_space(), heisenberg_j1j2_terms(3, 2, 1.0, 0.5, cylinder=False), 6
    r = run_dmrg(sp, small, n, bond_schedule=(8, 16), davidson_iters=6, algo="auto", jit_matvec=True, device=dev)
    H = build_dense_hamiltonian(sp, small, n)
    mask = np.all(state_charges_vector(sp, n) == np.array((0,)), axis=1)
    psi = np.zeros(2**n)
    psi[mask] = np.linalg.eigh(H[np.ix_(mask, mask)])[1][:, 0]

    def op(o, site):
        m = np.ones((1, 1))
        for s in range(n):
            m = np.kron(m, np.asarray(sp.ops[o]) if s == site else np.eye(2))
        return m

    errs = [abs(site_expectation(r.mps, sp, "Sz", s) - psi @ op("Sz", s) @ psi) for s in range(n)]
    errs += [abs(correlation(r.mps, sp, "Sz", "Sz", i, j) - psi @ op("Sz", i) @ op("Sz", j) @ psi)
             for i, j in ((0, 1), (1, 4), (0, 5))]
    errs += [abs(correlation(r.mps, sp, "S+", "S-", i, j) - psi @ op("S+", i) @ op("S-", j) @ psi)
             for i, j in ((0, 3), (2, 5))]
    rec = dict(small_max_abs_err_vs_ed=max(errs))
    n8 = res.mps.n_sites
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sz_sum = sum(site_expectation(res.mps, space, "Sz", i) for i in range(n8))
    rec["sz_sum_s"] = time.perf_counter() - t0
    want = 0.5 * total_charge(space, neel_states(space, n8))[0]  # charge = 2 Sz
    t0 = time.perf_counter()
    prof = correlation_profile(res.mps, space, "Sz", "Sz", ref=0)
    rec.update(sz_sum=sz_sum, sz_total=want, profile_s=time.perf_counter() - t0,
               profile=[c for _, c in prof])
    log("  observables " + json.dumps(rec))
    if not (max(errs) <= 1e-8 and abs(sz_sum - want) <= 1e-8 and np.all(np.isfinite(rec["profile"]))
            and len(prof) == n8 - 1):
        fail(f"observables: {rec}")
    return rec


# ---------------------------------------------------------------- phase 16
def serve_path(dev):
    """The served J1-J2 ladder scan (see phase 16 above): the slot, its
    checks against single runs, the folded launch on the middle bond, and
    the CLI quickstart."""
    from repro_torch import kernels
    from repro_torch.core import run_dmrg
    from repro_torch.dist.batch import bucket_operands, matricize_lhs, matricize_rhs
    from repro_torch.dist.engine import MATVEC_AXES
    from repro_torch.kernels.block_gemm.ops import block_sparse_matmul
    from repro_torch.kernels.block_gemm.ref import block_sparse_matmul_ref
    from repro_torch.kernels.block_gemm.work import variant
    from repro_torch.core.env import left_edge, right_edge
    from repro_torch.serve import DMRGService, ProblemSpec, build_problem, group_key
    from repro_torch.serve.stacked import broadcast_tensor, pad_stacked, unstack_tensor
    from repro_torch.tensor.blocksparse import BlockSparseTensor

    specs = [ProblemSpec.make(SERVE_MODEL, SERVE_SITES, J1=1.0, J2=j, max_bond=SERVE_BOND) for j in SERVE_J2]
    built = [build_problem(sp) for sp in specs]
    if len({group_key(sp, mpo) for sp, (_, mpo) in zip(specs, built)}) != 1:
        fail("the J2 scan spans more than one batch group")
    nb, n_sweeps = len(specs), len(specs[0].bond_schedule) * specs[0].sweeps_per_bond
    rec = dict(model=SERVE_MODEL, n_sites=SERVE_SITES, max_bond=SERVE_BOND, J2=SERVE_J2,
               bond_schedule=specs[0].bond_schedule, sweeps=n_sweeps, davidson_iters=specs[0].davidson_iters)
    svc = DMRGService(max_batch=nb, batch_wait_s=600.0, device=dev)
    try:
        t0 = time.perf_counter()
        warm = svc.warmup(specs, sizes=(nb,))[-1]
        torch.cuda.synchronize()
        rec.update(warmup_s=time.perf_counter() - t0, warmup_captures=svc.ops.retraces,
                   warmup_graphs=svc.ops.engine.graphs.stats())
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        rids = [svc.submit(sp) for sp in specs]
        recs = [svc.result(r, timeout=1800) for r in rids]
        rec["slot_wall_s"] = time.perf_counter() - t0
        launches, variants = dict(kernels.LAUNCHES), dict(kernels.VARIANT_LAUNCHES["block_gemm"])
        st = svc.stats()
    finally:
        svc.shutdown()
    rec.update(peak_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches, variant_launches=variants,
               energies=[r["energy"] for r in recs], batch_sizes=[r["batch_size"] for r in recs],
               problems_per_s=st["problems_per_sec"], solve_s=st["solve_seconds"],
               sweep_s=st["solve_seconds"] / n_sweeps, stage_s=st["stage_seconds"],
               stage_per_sweep_s={k: v / n_sweeps for k, v in st["stage_seconds"].items()},
               captures_after_warmup=st["retraces"], davidson=st["davidson"], fill=st["batch_fill_ratio"],
               ledger={k: st[k] for k in ("completed", "failed", "retries", "bisections", "worker_restarts",
                                          "unrecovered_errors")}, ladders=st["ladders"])
    log("  served slot " + json.dumps({k: v for k, v in rec.items() if k != "warmup_graphs"}))
    ld = st["ladders"]
    if (st["completed"] != nb or st["failed"] or st["retries"] or st["bisections"] or st["worker_restarts"]
            or st["unrecovered_errors"] or ld["retries"] or ld["degradations"] or ld["svd_retries"]
            or any(ld["svd_degradations"].values())):
        fail(f"served slot: recovery ledger {rec['ledger']}, ladders {ld}")
    if rec["batch_sizes"] != [nb] * nb or not all(np.isfinite(rec["energies"])):
        fail(f"served slot: batch sizes {rec['batch_sizes']}, energies {rec['energies']}")
    if st["retraces"] != 0:
        fail(f"served slot captured {st['retraces']} graphs after warmup")
    if launches["block_gemm"] == 0:
        fail("the served slot launched no block GEMM")

    # the first and last J2 alone, against the batch (untimed: the entry
    # points run beside them)
    singles = []
    with ThreadPoolExecutor(max_workers=len(ENTRY_POINTS)) as pool:
        chains = start_entry_points(pool)
        for b in (0, nb - 1):
            space, mpo = built[b]
            mpo = [BlockSparseTensor(w.indices, {k: v.to(dev) for k, v in w.blocks.items()}, w.charge) for w in mpo]
            r = run_dmrg(space, None, SERVE_SITES, bond_schedule=specs[b].bond_schedule,
                         sweeps_per_bond=specs[b].sweeps_per_bond, davidson_iters=specs[b].davidson_iters,
                         cutoff=specs[b].cutoff, mpo=mpo, algo="batched", jit_matvec=True, device=dev)
            singles.append(dict(J2=SERVE_J2[b], energy=r.energy, abs_diff=abs(r.energy - rec["energies"][b]),
                                ladder=assert_no_recovery(f"single J2={SERVE_J2[b]}", r)))
        rec["entry_points"] = finish_entry_points(chains)
    rec["singles"] = singles
    log("  singles " + json.dumps(singles))
    if not all(x["abs_diff"] < 1e-10 for x in singles):
        fail(f"served energies vs single runs: {singles}")

    # the largest folded bucket of the middle bond's stacked matvec (the
    # warmup solve ends in the served slot's state)
    ops, eng = warm.engine.ops, warm.engine
    T, W, n = eng.T, eng.W, SERVE_SITES
    j = n // 2 - 1
    A = broadcast_tensor(left_edge(T[0], W[0]), nb)
    for i in range(j):
        A = ops.env_update("left", A, T[i], W[i])
    Bx = broadcast_tensor(right_edge(T[n - 1], W[n - 1]), nb)
    for i in range(n - 2, j, -1):
        Bx = ops.env_update("right", Bx, T[i + 1], W[i + 1])
    A, Wj, Wj1, Bx, x = (pad_stacked(t) for t in (A, W[j], W[j + 1], Bx, ops.contract(T[j], T[j + 1], ((2,), (0,)))))
    best, t = None, x
    for i, axes in enumerate(MATVEC_AXES):
        a, b = (A, t) if i == 0 else (t, (Wj, Wj1, Bx)[i - 1])
        plan = ops.engine.cache.get(a, b, axes)
        for bi, bucket in enumerate(plan.batched.buckets):
            flops = 2.0 * nb * len(bucket.oi) * bucket.m * bucket.k * bucket.n
            if best is None or flops > best[0]:
                best = (flops, i, bi, bucket, plan, a, b)
        t = ops.contract(a, b, axes)
    flops, step, bi, bucket, plan, a, b = best
    O = len(bucket.out_keys)
    oi = plan.batched.device_tables(dev, nb)[bi]
    lhs, rhs = bucket_operands(bucket, matricize_lhs(a, plan.keep_a, plan.ax_a), matricize_rhs(b, plan.keep_b, plan.ax_b))
    work = bucket.folded_work(nb)
    got = block_sparse_matmul(lhs, rhs, oi, nb * O, work=work)
    err, rel = rel_err(got, block_sparse_matmul_ref(lhs, rhs, oi, nb * O))
    one_oi = plan.batched.device_tables(dev)[bi]
    per = []
    for p in range(nb):
        l1, r1 = bucket_operands(bucket, matricize_lhs(unstack_tensor(a, p), plan.keep_a, plan.ax_a),
                                 matricize_rhs(unstack_tensor(b, p), plan.keep_b, plan.ax_b))
        per.append((l1, r1))
    sep = torch.stack([block_sparse_matmul(l1, r1, one_oi, O, work=bucket.work) for l1, r1 in per])
    scale = max(got.abs().max().item(), 1e-300)
    sep_rel = (got.view(nb, O, bucket.m, bucket.n) - sep).abs().max().item() / scale
    if not rel <= TOL[torch.float64] or not sep_rel <= 1e-13:
        fail(f"folded bucket: vs plain {rel:.3e}, vs per-problem launches {sep_rel:.3e}")
    idx = oi.long()

    def library():
        return torch.zeros((nb * O, bucket.m, bucket.n), dtype=lhs.dtype, device=dev).index_add_(0, idx, torch.bmm(lhs, rhs))

    def separate():
        for l1, r1 in per:
            block_sparse_matmul(l1, r1, one_oi, O, work=bucket.work)

    nbytes = lhs.element_size() * (lhs.numel() + rhs.numel() + nb * O * bucket.m * bucket.n) + 4 * len(idx)
    row = dict(step=step, B=nb, P=len(bucket.oi), M=bucket.m, K=bucket.k, N=bucket.n, O=O,
               variant=variant(work.route, lhs.dtype), max_abs_err=err, rel_err=rel, per_problem_rel_err=sep_rel,
               flops=flops, bytes=nbytes,
               **timed(dict(ms=lambda: block_sparse_matmul(lhs, rhs, oi, nb * O, work=work),
                            plain_ms=lambda: block_sparse_matmul_ref(lhs, rhs, oi, nb * O),
                            library_ms=library, separate_ms=separate),
                       dict(ms=20, plain_ms=20, library_ms=20, separate_ms=20)),
               **bound(flops, PEAK_FLOPS[lhs.dtype], nbytes))
    log("  largest folded bucket " + json.dumps(row))
    rec["largest_folded_bucket"] = row
    del warm, eng, ops, T, W, A, Bx, x, t, a, b, lhs, rhs, per
    return rec


def start_entry_points(pool) -> dict:
    """ENTRY_POINTS started side by side on the card (see phase 16 above):
    a future per chain, each the list of its commands' runs."""
    import shutil

    store = ROOT / "chiprun_out" / "plan_store_cli"
    shutil.rmtree(store, ignore_errors=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

    def chain(cmds):
        runs = []
        for cmd in cmds:
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, *(a.replace("{store}", str(store)) for a in cmd)], cwd=ROOT,
                                  capture_output=True, text=True, timeout=600, env=env)
            runs.append(dict(args=cmd, returncode=proc.returncode, seconds=time.perf_counter() - t0,
                             out=proc.stdout, err=proc.stderr))
            if proc.returncode != 0:
                break
        return runs

    return {name: pool.submit(chain, cmds) for name, cmds in ENTRY_POINTS.items()}


def finish_entry_points(chains) -> dict:
    """Each chain's runs held to their checks: exit code 0 everywhere, the
    serve CLIs' "CHECK OK", 0 plan builds on the primed store, and the DMRG
    entry point's ED line within 1e-8.  Their seconds were taken side by
    side and beside the single runs."""
    rec = {}
    for name, fut in chains.items():
        runs = fut.result()
        for r in runs:
            if r["returncode"] != 0:
                fail(f"entry point {' '.join(r['args'])} exited {r['returncode']}: {r['out'][-1500:]} "
                     f"{r['err'][-1500:]}")
        rec[name] = [dict(args=r["args"], seconds=r["seconds"], tail=r["out"].strip().splitlines()[-6:])
                     for r in runs]
        log(f"  entry point {name}: " + json.dumps(rec[name]))
        out = runs[-1]["out"]
        if name in ("serve", "plan_store") and "CHECK OK" not in out:
            fail(f"the serve CLI {' '.join(runs[-1]['args'])}: {out[-1500:]}")
        if name == "plan_store" and "plan store: 0 plan builds" not in out:
            fail(f"the serve CLI on the primed store: {out[-1500:]}")
    out = chains["electrons"].result()[-1]["out"]
    found = re.search(r"ground-state energy estimate: +(\S+)", out)
    ed_line = re.search(r"ED reference: +(\S+) \(\|err\|=(\S+)\)", out)
    if not found or not ed_line or not float(ed_line.group(2)) <= 1e-8:
        fail(f"the entry point {' '.join(ELECTRON_CLI)}: {out[-1500:]}")
    rec["electrons"][-1].update(energy=float(found.group(1)), ed=float(ed_line.group(1)),
                                ed_err=float(ed_line.group(2)))
    return rec


# ---------------------------------------------------------------- phase 17
def spmd_path(dev):
    """run_dmrg(spmd=True) on the SPMD_LX x SPMD_LY cylinder in each of
    SPMD_WORLDS (see phase 17 above), against the single-process batched
    run."""
    import shutil

    from repro_torch.core import run_dmrg, spin_system
    from repro_torch.core.mpo import build_mpo, compress_mpo

    n = SPMD_LX * SPMD_LY
    space, terms = spin_system(SPMD_LX, SPMD_LY)
    mpo = compress_mpo(build_mpo(space, terms, n, device=dev), cutoff=1e-13)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = run_dmrg(space, terms, n, bond_schedule=SPMD_BONDS, sweeps_per_bond=1, davidson_iters=2, mpo=mpo,
                   algo="batched", jit_matvec=True, device=dev)
    torch.cuda.synchronize()
    rec = {"lx": SPMD_LX, "ly": SPMD_LY, "bonds": SPMD_BONDS,
           "reference": dict(energies=ref.energies, wall_s=time.perf_counter() - t0,
                             seconds=[s.seconds for s in ref.sweep_stats])}
    log("  single-process batched " + json.dumps(rec["reference"]))
    rec["worlds"] = []
    for world, backend, mesh in SPMD_WORLDS:
        out = ROOT / "chiprun_out" / f"spmd_{world}"
        shutil.rmtree(out, ignore_errors=True)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(world),
             str(ROOT / "scripts" / "spmd_dmrg.py"), "--backend", backend, "--mesh", mesh, "--probe",
             "--lx", str(SPMD_LX), "--ly", str(SPMD_LY), "--bonds", ",".join(map(str, SPMD_BONDS)),
             "--davidson-iters", "2", "--out", str(out)],
            cwd=ROOT, capture_output=True, text=True, timeout=600, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"spmd world {world} ({backend}, {mesh}) exited {proc.returncode}: {proc.stdout[-1500:]} "
                 f"{proc.stderr[-3000:]}")
        ranks = [json.loads((out / f"{r}.json").read_text()) for r in range(world)]
        r0 = ranks[0]
        row = dict(world=world, backend=backend, mesh=mesh, wall_s=wall, run_s=[r["wall_s"] for r in ranks],
                   seconds=r0["seconds"], energies=r0["energies"], spmd=r0["spmd"], policy=r0["policy"],
                   launches=[sum(r["block_gemm_launches"].values()) for r in ranks],
                   variant_launches=[r["block_gemm_launches"] for r in ranks],
                   largest_chunk=[r["largest_chunk"] for r in ranks],
                   max_abs_diff=max(abs(a - b) for r in ranks for a, b in zip(r["energies"], ref.energies)))
        log("  world " + json.dumps(row))
        rec["worlds"].append(row)
        for r in ranks:
            lad = r["ladder"]
            if lad["retries"] or lad["degradations"] or lad["svd_retries"] or any(lad["svd_degradations"].values()) \
                    or any(lad["pair_retries"]):
                fail(f"spmd world {world} rank {r['rank']}: a ladder recovered something: {lad}")
            if sum(r["block_gemm_launches"].values()) == 0:
                fail(f"spmd world {world} rank {r['rank']} launched no block GEMM")
            if r["graph_captures"] or r["policy"]["mismatches"] or r["backend_counts"]["spmd"] == 0:
                fail(f"spmd world {world} rank {r['rank']}: captures {r['graph_captures']}, mismatches "
                     f"{r['policy']['mismatches']}, backend counts {r['backend_counts']}")
            if r["energies"] != r0["energies"]:
                fail(f"spmd world {world}: rank {r['rank']} energies {r['energies']} differ from rank 0's")
            if not r["largest_chunk"]["rel_err"] <= TOL[torch.float64]:
                fail(f"spmd world {world} rank {r['rank']}: largest chunk vs plain {r['largest_chunk']}")
        if not row["max_abs_diff"] < 1e-10:
            fail(f"spmd world {world}: energies {r0['energies']} vs single-process {ref.energies}")
    del ref
    return rec


# ---------------------------------------------------------------- phase 18
def plan_store_path():
    """The cold and the primed process on one plan store (see phase 18
    above)."""
    import shutil

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    store = ROOT / "chiprun_out" / "plan_store"
    shutil.rmtree(store, ignore_errors=True)
    runs = []
    for phase in ("cold", "primed"):
        proc = subprocess.run([sys.executable, str(ROOT / "scripts" / "plan_store_run.py"), "--store", str(store),
                               "--bonds", ",".join(map(str, STORE_BONDS))],
                              cwd=ROOT, capture_output=True, text=True, timeout=600, env=env)
        if proc.returncode != 0:
            fail(f"plan store {phase} run exited {proc.returncode}: {proc.stderr[-3000:]}")
        line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("PLAN_STORE_RUN "))
        runs.append(json.loads(line[len("PLAN_STORE_RUN "):]))
        log(f"  {phase} " + json.dumps({k: v for k, v in runs[-1].items() if k != "store"}))
    cold, primed = runs
    rec = dict(bonds=STORE_BONDS, cold=cold, primed=primed,
               max_abs_diff=max(abs(a - b) for a, b in zip(cold["energies"], primed["energies"])))
    if cold["plan_builds"] == 0 or primed["plan_builds"] != 0:
        fail(f"plan builds cold {cold['plan_builds']}, primed {primed['plan_builds']} (want > 0 and 0)")
    if sum(primed["sweep_captures"]) != 0 or primed["warmup"]["captures"] != sum(cold["sweep_captures"]):
        fail(f"captures: cold sweeps {cold['sweep_captures']}, primed warmup {primed['warmup']}, primed sweeps "
             f"{primed['sweep_captures']}")
    if not rec["max_abs_diff"] < 1e-10:
        fail(f"primed energies {primed['energies']} vs cold {cold['energies']}")
    return rec


# ---------------------------------------------------------------- phase 20
def train_path(dev):
    """LM training on the card (see phase 20 above): the backward kernels
    alone against their plain versions, the kernel path's float32
    gradients against the plain path's, the training runs and the CLI."""
    rec = {"kernels_vs_plain": backward_kernel_cases(dev)}
    rec["f32_grads"] = {arch: train_grads_vs_plain(arch, dev, spec["f32_layers"]) for arch, spec in TRAIN_ARCHS.items()}
    rec["runs"] = {arch: train_run(arch, dev, spec["layers"]) for arch, spec in TRAIN_ARCHS.items()}
    rec["timings"] = backward_timings(dev)
    # the CLI, in process, as a user would start it
    t0 = time.perf_counter()
    losses = _one_device(TRAIN_CLI, dev)["losses"]
    rec["cli"] = dict(argv=TRAIN_CLI, seconds=time.perf_counter() - t0, losses=losses)
    log(f"  CLI {' '.join(TRAIN_CLI)}: {rec['cli']['seconds']:.1f} s, losses {[round(x, 4) for x in losses]}")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        fail(f"the train CLI returned losses {losses}")
    return rec


def grad_rel(got: dict, want: dict) -> tuple:
    """(largest per-tensor ||got - want|| / ||want||, its key) over the
    tensors whose plain gradient is not zero."""
    worst = (0.0, "")
    for k, w in want.items():
        norm = w.double().norm().item()
        if norm > 0:
            worst = max(worst, ((got[k].double() - w.double()).norm().item() / norm, k))
    return worst


def flash_grads(q, k, v, do, use_kernel=True):
    from repro_torch.kernels.flash_attention.ops import flash_attention_bshd

    q, k, v = (a.detach().requires_grad_(True) for a in (q, k, v))
    flash_attention_bshd(q, k, v, use_kernel=use_kernel).backward(do)
    return {"q": q.grad, "k": k.grad, "v": v.grad}


def scan_grads(r, k, v, logw, u, do, use_kernel=True, s0=None, ds_fin=None):
    """Gradients of sum(out * do), plus sum(s_fin * ds_fin) when given, with
    respect to r, k, v, logw, u and, when given, the initial state s0."""
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_wkv

    leaves = {n: a.detach().requires_grad_(True) for n, a in zip(("r", "k", "v", "logw", "u"), (r, k, v, logw, u))}
    if s0 is not None:
        leaves["s0"] = s0.detach().requires_grad_(True)
    out, s_fin = rwkv6_wkv(*list(leaves.values())[:5], state=leaves.get("s0"), out_dtype=do.dtype,
                           use_kernel=use_kernel)
    torch.autograd.backward([out] + ([] if ds_fin is None else [s_fin]), [do] + ([] if ds_fin is None else [ds_fin]))
    return {n: a.grad for n, a in leaves.items()}


def flash_inputs(dev, g, dtype, b, s, h, hkv, d):
    q = torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(b, s, hkv, d, generator=g, device=dev).to(dtype) for _ in range(2))
    return q, k, v, torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)


def scan_inputs(dev, g, dtype, b, t, h, n):
    r, k = ((0.5 * torch.randn(b, t, h, n, generator=g, device=dev)).to(dtype) for _ in range(2))
    v = torch.randn(b, t, h, n, generator=g, device=dev).to(dtype)
    logw = -torch.exp(torch.rand(b, t, h, n, generator=g, device=dev) * 14.0 - 8.0)  # -exp(-8) .. -exp(6)
    u = 0.1 * torch.randn(h, n, generator=g, device=dev)
    return r, k, v, logw, u, torch.randn(b, t, h, n, generator=g, device=dev)  # the wkv output is float32


def backward_kernel_cases(dev):
    """Each backward kernel alone against autograd through its plain
    version, per tensor relative L2: at the training shapes in bf16 and
    float32, at the smoke D=16 and (flash) at D=160 and 256; at the float32
    training shapes, plain gradients with a planted fault must read above
    the float32 limit, and at flash's D 160 and 256 training shapes in
    bf16, coarser planted faults above the bf16 limit."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops as flash_ops

    g = torch.Generator(device=dev).manual_seed(20)
    worst = {"flash_attention_bwd": {}, "rwkv6_scan_bwd": {}}
    controls = {}

    def check(name, dtype, label, got, want):
        rel, key = grad_rel(got, want)
        tol = BWD_TOL[name][dtype]
        worst[name][str(dtype)[6:]] = max(worst[name].get(str(dtype)[6:], 0.0), rel)
        if not rel <= tol:
            fail(f"{name} {label} {dtype}: d{key} rel L2 {rel:.3e} > {tol}")
        return want

    # llama3_8b's, pixtral_12b's and recurrentgemma_2b's training shapes, then small ones
    flash_cases = [(TRAIN_BATCH, TRAIN_SEQ, 32, 8, 128), (TRAIN_BATCH, TRAIN_SEQ, 32, 8, 160),
                   (TRAIN_BATCH, TRAIN_SEQ, 10, 1, 256), (2, 37, 4, 4, 16), (1, 300, 8, 2, 160), (1, 300, 10, 1, 256)]
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, h, hkv, d in flash_cases:
            q, k, v, do = flash_inputs(dev, g, dtype, b, s, h, hkv, d)
            before = kernels.LAUNCHES["flash_attention_bwd"]
            got = flash_grads(q, k, v, do)
            torch.cuda.synchronize()
            if kernels.LAUNCHES["flash_attention_bwd"] != before + 1:
                fail(f"flash backward at D={d} did not launch its kernel once")
            want = check("flash_attention_bwd", dtype, f"B={b} S={s} H={h} Hkv={hkv} D={d}", got,
                         flash_grads(q, k, v, do, use_kernel=False))
            if s == TRAIN_SEQ and (dtype == torch.float32 or d in flash_ops.WIDE_HEAD_DIMS):
                # float32: the last query tile's diagonal key tile dropped; bf16 (a limit
                # 1000x coarser): every query tile's
                controls[("flash_attention_bwd", dtype, d)] = flash_bwd_controls(
                    q, k, v, do, want, rows=64 if dtype == torch.float32 else s)
            del q, k, v, do, got, want
        # the last case carries an initial state that takes a gradient and a
        # loss on the final state (dS0 and dS_fin, held to the float32 limit)
        for b, t, h, n, states in ((TRAIN_BATCH, TRAIN_SEQ, 40, 64, False), (2, 100, 4, 16, False),
                                   (2, 300, 8, 64, True)):
            r, k, v, logw, u, do = scan_inputs(dev, g, dtype, b, t, h, n)
            s0, ds_fin = ((0.1 * torch.randn(b, h, n, n, generator=g, device=dev),
                           torch.randn(b, h, n, n, generator=g, device=dev)) if states else (None, None))
            before = dict(kernels.VARIANT_LAUNCHES["rwkv6_scan_bwd"])
            got = scan_grads(r, k, v, logw, u, do, s0=s0, ds_fin=ds_fin)
            torch.cuda.synchronize()
            if kernels.VARIANT_LAUNCHES["rwkv6_scan_bwd"] != {**before, f"chunk{n}": before[f"chunk{n}"] + 1}:
                fail(f"scan backward at N={n} did not launch chunk{n} once")
            want = scan_grads(r, k, v, logw, u, do, use_kernel=False, s0=s0, ds_fin=ds_fin)
            label = f"B={b} T={t} H={h} N={n}" + (" from s0, with dS_fin" if states else "")
            check("rwkv6_scan_bwd", dtype, f"{label} (r, k, v)", {x: got[x] for x in "rkv"}, {x: want[x] for x in "rkv"})
            f32 = ("logw", "u") + (("s0",) if states else ())
            check("rwkv6_scan_bwd", torch.float32, f"{label} ({', '.join(f32)})",
                  {x: got[x] for x in f32}, {x: want[x] for x in f32})
            if dtype == torch.float32 and t == TRAIN_SEQ:
                controls[("rwkv6_scan_bwd", dtype, n)] = scan_bwd_controls(r, k, v, do, u, want)
            del r, k, v, logw, u, do, s0, ds_fin, got, want
    for (name, dtype, d), faults in controls.items():
        tol = BWD_TOL[name][dtype]
        log(f"  {name} worst per-tensor rel L2 vs plain: " + ", ".join(f"{k} {v:.2e}" for k, v in worst[name].items())
            + f"; planted-fault controls ({str(dtype)[6:]}, head dim {d}) "
            + ", ".join(f"{c} {x:.3e}" for c, x in faults.items()) + f", limit {tol}")
        if not min(faults.values()) > tol:
            fail(f"the {dtype} {name} limit {tol} does not reject every planted fault at head dim {d}: {faults}")
    torch.cuda.empty_cache()
    return {"worst": worst, "controls": {f"{name} {str(dtype)[6:]} {d}": f for (name, dtype, d), f in controls.items()}}


def flash_bwd_controls(q, k, v, do, want, tile: int = 64, rows: int = 64) -> dict:
    """The plain gradients with a planted fault, each held against ``want``
    by the per-tensor metric: dq of the last ``rows`` queries (S a multiple
    of ``tile``) without their diagonal key tiles; dk and dv without the
    last query head of each GQA group."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    qr, dor = q[:, s - rows:].float(), do[:, s - rows:].float()
    kk, vv = (a.float().repeat_interleave(rep, dim=2) for a in (k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", qr, kk) / d**0.5
    kpos, qpos = torch.arange(s, device=q.device)[None, :], torch.arange(s - rows, s, device=q.device)[:, None]
    p = torch.softmax(torch.where(kpos <= qpos, logits, -torch.inf), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vv)
    dp = torch.einsum("bqhd,bkhd->bhqk", dor, vv)
    ds = p * (dp - (dor * o).sum(-1).transpose(1, 2)[..., None])
    ds = torch.where(kpos // tile == qpos // tile, 0.0, ds)  # the diagonal key tiles dropped
    dq = want["q"].clone()
    dq[:, s - rows:] = (torch.einsum("bhqk,bkhd->bqhd", ds, kk) / d**0.5).to(dq.dtype)
    del logits, p, dp, ds
    # per query head gradients of k and v through the plain version, then the group sums without one head
    kx, vx = (a.repeat_interleave(rep, dim=2).detach().requires_grad_(True) for a in (k, v))
    from repro_torch.kernels.flash_attention.ops import flash_attention_bshd
    flash_attention_bshd(q, kx, vx, use_kernel=False).backward(do)
    part = lambda x: x.reshape(b, s, h // rep, rep, d)[:, :, :, :-1].sum(3)
    faults = {"dq_diagonal_tile_dropped": {"q": dq}, "dk_dv_one_group_head_dropped": {"k": part(kx.grad), "v": part(vx.grad)}}
    return {name: grad_rel(f, {x: want[x] for x in f})[0] for name, f in faults.items()}


def scan_bwd_controls(r, k, v, do, u, want) -> dict:
    """Plain scan gradients with a planted fault: dr without the bonus
    term u k (v . do); du summed over the first batch element only."""
    vdo = (v.float() * do.float()).sum(-1, keepdim=True)
    faults = {"dr_bonus_dropped": {"r": want["r"] - (u * k.float() * vdo).to(want["r"].dtype)},
              "du_one_batch_element": {"u": (r.float() * k.float() * vdo)[:1].sum((0, 1))}}
    return {name: grad_rel(f, {x: want[x] for x in f})[0] for name, f in faults.items()}


def train_data(cfg, dev, seed: int):
    """The synthetic batches of phase 20 at B x S = TRAIN_BATCH x TRAIN_SEQ
    positions: a VLM's TRAIN_SEQ take its patch embeddings (standard
    normal draws, from ``seed``) first, then the tokens."""
    from repro_torch.train.data import SyntheticLM

    patches = cfg.n_patches if cfg.family == "vlm" else 0
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ - patches, TRAIN_BATCH, seed=seed, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    dtype = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
    for batch in data:
        if patches:
            batch["patch_embeds"] = torch.randn(TRAIN_BATCH, patches, cfg.d_model, generator=g, device=dev).to(dtype)
        yield batch


def train_grads_vs_plain(arch: str, dev, layers: int) -> dict:
    """At full width, ``layers`` deep, float32 weights: loss and every
    gradient of the kernel path (flash or the scan, forward and backward)
    against the plain path on the same batch, per tensor relative L2, held
    below TRAIN_GRAD_TOL.  Two readings must land above it: the kernel path
    with a planted fault in its backward kernel's output (dq of the last 64
    positions dropped, or dk of the scan's last chunk of 32), and the
    control, the plain path with the weights in bf16."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rwkv6_scan import ops as scan_ops
    from repro_torch.launch.specs import loss_and_grads

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), n_layers=layers, dtype="float32")
    params = models.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    batch = next(train_data(cfg, dev, seed=1))
    want_loss, want = loss_and_grads(cfg, params, batch, use_kernel=False)
    loss, got = loss_and_grads(cfg, params, batch)
    rel, key = grad_rel(got, want)
    del got
    ops = scan_ops if cfg.family == "ssm" else flash_ops
    launch_bwd = ops._launch_bwd

    def planted(*args, **kwargs):
        grads = launch_bwd(*args, **kwargs)
        grads[0 if ops is flash_ops else 1][:, -64 if ops is flash_ops else -32:] = 0.0
        return grads

    ops._launch_bwd = planted
    try:
        _, bad = loss_and_grads(cfg, params, batch)
    finally:
        ops._launch_bwd = launch_bwd
    fault = grad_rel(bad, want)[0]
    del bad
    params = {k: v.bfloat16() for k, v in params.items()}
    batch = {k: v.bfloat16() if v.is_floating_point() else v for k, v in batch.items()}
    _, bf = loss_and_grads(dataclasses.replace(cfg, dtype="bfloat16"), params, batch, use_kernel=False)
    control, control_key = grad_rel(bf, want)
    del params, bf, want
    torch.cuda.empty_cache()
    rec = dict(layers=layers, loss=loss.item(), plain_loss=want_loss.item(), grad_rel_l2=rel, worst_tensor=key,
               planted_fault_rel_l2=fault, control_bf16_rel_l2=control, control_worst_tensor=control_key,
               seconds=time.perf_counter() - t0)
    log(f"  {arch} float32 gradients, {layers} layer(s): kernel vs plain per-tensor rel L2 {rel:.3e} ({key}), loss "
        f"{rec['loss']:.6f} vs {rec['plain_loss']:.6f}; planted fault {fault:.3e}; control bf16 weights "
        f"{control:.3e} ({control_key}); limit {TRAIN_GRAD_TOL}")
    if not rel <= TRAIN_GRAD_TOL < min(fault, control):
        fail(f"{arch} float32 gradients: kernel vs plain {rel:.3e}, the planted fault {fault:.3e} and the bf16 "
             f"control {control:.3e} do not bracket {TRAIN_GRAD_TOL}")
    if not abs(rec["loss"] - rec["plain_loss"]) <= 1e-5 * abs(rec["plain_loss"]):
        fail(f"{arch} float32 loss {rec['loss']} vs plain {rec['plain_loss']}")
    return rec


def train_run(arch: str, dev, layers) -> dict:
    """make_train_step at full width in bf16 (``layers`` deep, or all),
    B x S = TRAIN_BATCH x TRAIN_SEQ of the synthetic data, AdamW: a warm-up
    step, then TRAIN_STEPS timed steps, each with its seconds, tokens/s,
    peak memory, loss, grad norm and the launches of every kernel by
    variant (counts set to 0 before the step), held to the design's
    counts: each forward kernel twice per layer (the forward and the
    checkpointed block's recompute), each backward kernel once.  At flash's
    D 160 and 256, then BASELINE_STEPS steps with the backward forced to
    bwd_simple (the parent's), timed alike."""
    from repro_torch import kernels, models
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.specs import make_train_step
    from repro_torch.train.optim import OptConfig, init_opt_state

    t_start = time.perf_counter()
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    params = models.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(p.numel() for p in params.values())
    opt = init_opt_state(params)
    data = train_data(cfg, dev, seed=0)
    step = make_train_step(cfg, OptConfig(warmup_steps=1, total_steps=TRAIN_STEPS + 1 + BASELINE_STEPS))
    fwd, bwd = ("rwkv6_scan", "rwkv6_scan_bwd") if cfg.family == "ssm" else ("flash_attention", "flash_attention_bwd")
    n = cfg.n_layers if cfg.family == "ssm" else cfg.layer_kinds().count("attn")
    rec = dict(arch=arch, layers=cfg.n_layers, params=n_params, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               state_gb=n_params * 12 / 1e9, steps=[])
    for i in range(TRAIN_STEPS + 1):  # step 0 warms up (cuBLAS handles, kernel library loads)
        batch = next(data)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        row = dict(seconds=dt, tokens_s=TRAIN_BATCH * TRAIN_SEQ / dt, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]), lr=float(metrics["lr"]),
                   launches={k: v for k, v in kernels.LAUNCHES.items() if v},
                   variants={k: {x: c for x, c in kernels.VARIANT_LAUNCHES[k].items() if c} for k in (fwd, bwd)})
        if i:
            rec["steps"].append(row)
        log(f"  {arch} {'warm-up' if i == 0 else f'step {i}'}: {dt:.3f} s ({row['tokens_s']:.0f} tok/s), peak "
            f"{row['peak_gib']:.2f} GiB, loss {row['loss']:.4f}, grad norm {row['grad_norm']:.4f}, {row['variants']}")
        if not (np.isfinite(row["loss"]) and np.isfinite(row["grad_norm"])):
            fail(f"{arch} training step {i}: loss {row['loss']}, grad norm {row['grad_norm']}")
        want = {fwd: 2 * n, bwd: n}
        if row["launches"] != want:
            fail(f"{arch} training step {i} launched {row['launches']}, not {want}")
        if cfg.family != "ssm":  # bf16 flash: TMA + wgmma both ways at every family's head dim
            want = {fwd: {"flash_wgmma": 2 * n}, bwd: {"bwd_wgmma": n}}
            if row["variants"] != want:
                fail(f"{arch} training step {i} launched flash as {row['variants']}, not {want}")
        elif row["variants"][bwd] != {f"chunk{cfg.rwkv_head_dim}": n}:
            fail(f"{arch} training step {i} launched the scan backward as {row['variants'][bwd]}")
    if cfg.family != "ssm" and cfg.resolved_head_dim in flash_ops.WIDE_HEAD_DIMS:
        chosen = flash_ops.bwd_variant
        flash_ops.bwd_variant = lambda dtype, d: "bwd_simple"
        try:
            baseline = []
            for _ in range(BASELINE_STEPS):
                batch = next(data)
                torch.cuda.synchronize()
                kernels.reset_launches()
                t0 = time.perf_counter()
                params, opt, metrics = step(params, opt, batch)
                torch.cuda.synchronize()
                baseline.append(time.perf_counter() - t0)
                if {k: c for k, c in kernels.VARIANT_LAUNCHES[bwd].items() if c} != {"bwd_simple": n}:
                    fail(f"{arch}: the step with bwd_simple forced launched {kernels.VARIANT_LAUNCHES[bwd]}")
                if not np.isfinite(float(metrics["loss"])):
                    fail(f"{arch}: the step with bwd_simple forced gave loss {float(metrics['loss'])}")
        finally:
            flash_ops.bwd_variant = chosen
        rec["bwd_simple_step_s"] = baseline
        log(f"  {arch} with bwd_simple forced (the parent's backward): steps {[round(x, 3) for x in baseline]} s")
    del params, opt
    torch.cuda.empty_cache()
    rec.update(wall_s=time.perf_counter() - t_start, launches=rec["steps"][-1]["launches"],
               variants=rec["steps"][-1]["variants"], step_s=float(np.mean([r["seconds"] for r in rec["steps"]])),
               peak_gib=max(r["peak_gib"] for r in rec["steps"]))
    rec["tokens_s"] = TRAIN_BATCH * TRAIN_SEQ / rec["step_s"]
    return rec


# ---------------------------------------------------------------- phase 21
def mesh_path(dev):
    """Training under a mesh (see phase 21 above): the gloo probe beside the
    NCCL world; then every gloo run of MESH_RUNS and the save and resume in
    one gloo world of 2 (scripts/mesh_runs.py: one start-up for all), each
    against one device; the dense DMRG step of the dry run timed beside the
    flops it counts; the kernels at a rank's local heads."""
    probe = gloo_probe_start()  # beside the one-device run and the NCCL world: a few small collectives
    nccl = [spec for spec in MESH_RUNS if spec[2] == "nccl"]
    gloo = [spec for spec in MESH_RUNS if spec[2] == "gloo"]
    rec = {"runs": []}
    for label, world, backend, mm, arch, layers in nccl:
        ref = _one_device(_mesh_argv(arch, layers), dev)
        out = ROOT / "chiprun_out" / f"mesh_{label.replace(' ', '_')}"
        ranks, wall = torchrun(world, ["-m", "repro_torch.launch.train", *_mesh_argv(arch, layers),
                                       *_mesh_flags(mm, out)], out)
        rec["runs"].append(mesh_check(label, world, backend, mm, arch, layers, ranks, ref, wall))
    rec["gloo_probe"] = gloo_probe_end(*probe)
    refs = [_one_device(_mesh_argv(arch, layers), dev) for _, _, _, _, arch, layers in gloo]
    resume_ref = _one_device(RESUME_CLI + ["--steps", "4", "--seed", "0"], dev)
    reorder = _one_device(_mesh_argv(*MESH_REORDER), dev, n_micro=2)
    out = ROOT / "chiprun_out" / "mesh_gloo"
    ck = tempfile.mkdtemp(prefix="mesh_resume_ck_")  # the checkpoint stays on that machine
    # the gradient checks first, while the world's memory is its own
    groups = [["grads", "--arch", arch, "--layers", "1", "--global-batch", str(MESH_BATCH), "--seq-len", str(MESH_SEQ),
               "--meshes", meshes, "--out", str(out / f"grads_{arch}")] for arch, meshes in MESH_GRAD_ARCHS.items()]
    groups += [[*_mesh_argv(arch, layers), *_mesh_flags(mm, out / label.replace(" ", "_"))]
               for label, _, backend, mm, arch, layers in gloo]
    common = [*RESUME_CLI, "--seed", "0", "--log-every", "0", "--checkpoint-dir", ck]
    groups += [common + ["--mesh-model", "2", "--steps", "2", "--checkpoint-every", "2", "--record", str(out / "first")],
               common + ["--mesh-model", "1", "--steps", "4", "--resume", "auto", "--record", str(out / "resumed")]]
    argv = [str(ROOT / "scripts" / "mesh_runs.py")]
    for g in groups:
        argv += (["---"] if len(argv) > 1 else []) + g
    _, wall = torchrun(2, argv, out / "first", timeout=900)
    import shutil

    shutil.rmtree(ck, ignore_errors=True)
    read = lambda d: [json.loads((out / d / f"{r}.json").read_text()) for r in range(2)]
    for (label, world, backend, mm, arch, layers), ref in zip(gloo, refs):
        rec["runs"].append(mesh_check(label, world, backend, mm, arch, layers, read(label.replace(" ", "_")), ref, None))
    rec["gloo_world_s"] = wall
    rec["grads"] = {arch: mesh_grad_check(arch, read(f"grads_{arch}")) for arch in MESH_GRAD_ARCHS}
    rec["reorder"] = mesh_reorder(rec["runs"], reorder)
    rec["resume"] = mesh_resume_check(read("first"), read("resumed"), resume_ref)
    rec["dmrg"] = dmrg_cell_on_card(dev)
    rec["local_heads"] = local_head_timings(dev)
    return rec


def local_head_timings(dev) -> dict:
    """One launch of each training kernel at a 1x2 rank's local heads
    beside the same launch at all heads (B=2 x S=2048, bf16; CUDA-event
    means): flash forward and backward at llama3_8b's 16 q / 4 kv heads
    against 32 / 8, the scan forward and backward at rwkv6_3b's 20 heads
    against 40."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rwkv6_scan import ops as scan_ops

    g = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for label, (h, hkv) in (("local", (16, 4)), ("all", (32, 8))):
        q, k, v, do = flash_inputs(dev, g, torch.bfloat16, MESH_BATCH, MESH_SEQ, h, hkv, 128)
        o, lse = flash_ops._launch(q, k, v, with_lse=True)
        out[f"flash_{label}"] = dict(heads=[h, hkv], fwd_ms=time_ms(lambda: flash_ops._launch(q, k, v), reps=20),
                                     bwd_ms=time_ms(lambda: flash_ops._launch_bwd(q, k, v, o, lse, do), reps=20))
    for label, h in (("local", 20), ("all", 40)):
        r, k, v, logw, u, do = scan_inputs(dev, g, torch.bfloat16, MESH_BATCH, MESH_SEQ, h, 64)
        out[f"scan_{label}"] = dict(
            heads=h, fwd_ms=time_ms(lambda: scan_ops._launch(r, k, v, logw, u, None, torch.float32), reps=20),
            bwd_ms=time_ms(lambda: scan_ops._launch_bwd(r, k, v, logw, u, None, do), reps=20))
    log("  one launch at local heads vs all heads (ms): " + json.dumps(out))
    return out


def torchrun(world: int, argv: list, out: Path, timeout: int = 600):
    """``argv`` under torchrun with ``world`` ranks on this card, each rank's
    JSON record from ``out``."""
    import shutil

    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(world),
                           *argv], cwd=ROOT, capture_output=True, text=True, timeout=timeout,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"torchrun {' '.join(argv)} exited {proc.returncode}: {proc.stdout[-1500:]} {proc.stderr[-3000:]}")
    return [json.loads((out / f"{r}.json").read_text()) for r in range(world)], wall


# kills the process in a gloo world on the H100 (torch 2.11;
# scripts/gloo_cuda_probe.py without --skip): scripts/mesh_runs.py sends
# these gathers through c10d's all_gather_into_tensor (gloo_gathers)
GLOO_CRASH = "funcol.all_gather_into_tensor"


def gloo_probe_start():
    """Start the probe of every other collective of mesh training on CUDA
    tensors in a gloo world of 2 (scripts/gloo_cuda_probe.py)."""
    import shutil

    out = ROOT / "chiprun_out" / "gloo_probe"
    shutil.rmtree(out, ignore_errors=True)
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
                             str(ROOT / "scripts" / "gloo_cuda_probe.py"), "--skip", GLOO_CRASH, "--out", str(out)],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    return proc, out


def gloo_probe_end(proc, out) -> dict:
    """The probe's result: each collective ran and right, or the phase
    fails; GLOO_CRASH named as routed through c10d."""
    stdout, stderr = proc.communicate(timeout=300)
    if proc.returncode != 0:
        fail(f"the gloo probe exited {proc.returncode}: {stdout[-1500:]} {stderr[-3000:]}")
    ranks = [json.loads((out / f"{r}.json").read_text()) for r in range(2)]
    for r in ranks:
        for name, res in r["ops"].items():
            if not (res.get("ran") and res.get("right")):
                fail(f"gloo {name} on CUDA tensors on rank {r['rank']}: {res}")
    ops = dict(ranks[0]["ops"])
    ops[GLOO_CRASH] = dict(ran=False, error="not run: it kills the process (SIGSEGV) on the H100 with torch 2.11; "
                                            "scripts/mesh_runs.py routes it through c10d")
    log(f"  gloo on CUDA tensors: " + json.dumps(ops))
    return {"ops": ops}


_ONE_DEVICE = {}


def _one_device(argv: list, dev, n_micro: int = 1) -> dict:
    """The train CLI in this process on one device: its per-step record
    (once per argv); with ``n_micro`` its steps' gradients summed over that
    many microbatches (the reduction order changed, nothing else)."""
    from repro_torch.launch import specs
    from repro_torch.launch import train as train_cli

    key = (tuple(argv), n_micro)
    if key in _ONE_DEVICE:
        return _ONE_DEVICE[key]
    make = specs.make_train_step
    specs.make_train_step = lambda cfg, oc, **kw: make(cfg, oc, n_micro, **kw)
    try:
        with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
            train_cli.main(argv + ["--checkpoint-dir", f"{tmp}/ck", "--record", f"{tmp}/rec", "--log-every", "0"])
            step_rec = json.loads(Path(f"{tmp}/rec/0.json").read_text())
    finally:
        specs.make_train_step = make
    torch.cuda.empty_cache()
    _ONE_DEVICE[key] = step_rec
    return step_rec


def _mesh_argv(arch, layers) -> list:
    """The train CLI's arguments of one of MESH_RUNS (and of its one-device
    reference)."""
    return (["--arch", arch, "--global-batch", str(MESH_BATCH), "--seq-len", str(MESH_SEQ), "--steps",
             str(MESH_STEPS), "--seed", "0"] + (["--layers", str(layers)] if layers else []))


def _mesh_flags(mesh_model, out) -> list:
    return ["--mesh-model", str(mesh_model), "--log-every", "0",
            "--checkpoint-dir", tempfile.mkdtemp(prefix="mesh_ck_"), "--record", str(out)]


def mesh_check(label, world, backend, mesh_model, arch, layers, ranks, ref, wall) -> dict:
    """One of MESH_RUNS from each rank's record (steps' seconds, peak
    memory, losses, launches by variant and the shapes each kernel took),
    held to one device's losses, to the kernels' launch counts of phase 20
    and to each rank's local heads."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    fwd, bwd = ("rwkv6_scan", "rwkv6_scan_bwd") if cfg.family == "ssm" else ("flash_attention", "flash_attention_bwd")
    n = cfg.n_layers if cfg.family == "ssm" else cfg.layer_kinds().count("attn")
    local = lambda h: h // mesh_model if h % mesh_model == 0 else h
    row = dict(label=label, world=world, backend=backend, mesh=ranks[0]["mesh"], arch=arch, layers=cfg.n_layers,
               wall_s=wall, losses=ranks[0]["losses"], one_device_losses=ref["losses"],
               step_s=[[st["seconds"] for st in r["steps"]] for r in ranks],
               one_device_step_s=[st["seconds"] for st in ref["steps"]],
               peak_gib=[max(st["peak_gib"] for st in r["steps"]) for r in ranks],
               launches=[r["steps"][-1]["launches"] for r in ranks], shapes=[r["steps"][-1]["shapes"] for r in ranks])
    rels = [abs(a - b) / abs(b) for a, b in zip(row["losses"], ref["losses"])]
    row["loss_rel"] = max(rels)
    log(f"  {label}: step s per rank {[[round(x, 3) for x in t] for t in row['step_s']]} (one device "
        f"{[round(x, 3) for x in row['one_device_step_s']]}), peak {[round(x, 2) for x in row['peak_gib']]} GiB, losses "
        f"{[round(x, 4) for x in row['losses']]} vs one device {[round(x, 4) for x in ref['losses']]} (rel "
        f"{row['loss_rel']:.2e}), launches per rank {row['launches']}, shapes {row['shapes']}")
    for r in ranks:
        if r["backend"] != backend:
            fail(f"{label}: rank {r['rank']} trained on {r['backend']}, not {backend}")
        if r["losses"] != ranks[0]["losses"]:
            fail(f"{label}: rank {r['rank']} losses {r['losses']} differ from rank 0's {ranks[0]['losses']}")
        for i, st in enumerate(r["steps"]):
            counts = {k: sum(v.values()) for k, v in st["launches"].items()}
            if counts.get(fwd) != 2 * n or counts.get(bwd) != n:
                fail(f"{label} rank {r['rank']} step {i} launched {st['launches']}, not {fwd} {2 * n} and {bwd} {n}")
        if cfg.family == "ssm":
            want = {(MESH_BATCH, MESH_SEQ, local(cfg.n_heads), cfg.rwkv_head_dim)}
        else:
            want = {(MESH_BATCH, MESH_SEQ, local(cfg.n_heads), local(cfg.n_kv_heads), cfg.resolved_head_dim)}
        for name in (fwd, bwd):
            if {tuple(x) for x in r["steps"][-1]["shapes"][name]} != want:
                fail(f"{label} rank {r['rank']}: {name} took shapes {r['steps'][-1]['shapes'][name]}, not {want}")
    if not (len(rels) == MESH_STEPS and rels[0] <= MESH_LOSS_TOL[0] and max(rels) <= MESH_LOSS_TOL[1]):
        fail(f"{label}: losses {row['losses']} vs one device {ref['losses']} (rel {rels})")
    return row


def mesh_grad_check(arch, ranks) -> dict:
    """scripts/mesh_grads.py's readings of ``arch`` (the largest over ranks:
    each rank wrote the same): on every mesh the sound reading at most
    MESH_GRAD_TOL, and the bf16 control and every planted fault above it."""
    rec = ranks[0]
    for label, readings in rec["readings"].items():
        log(f"  {arch} float32 gradients at {label}, {rec['layers']} layer: " + ", ".join(
            f"{name} {err:.3e} ({key}, {sec:.1f} s)" for name, (err, key, sec) in readings.items()))
        sound = readings["sound"][0]
        others = {k: v[0] for k, v in readings.items() if k != "sound"}
        if not sound <= MESH_GRAD_TOL or any(v <= MESH_GRAD_TOL for v in others.values()):
            fail(f"{arch} mesh gradients at {label}: sound {sound:.3e}, control and faults {others}: the limit "
                 f"{MESH_GRAD_TOL} does not tell them apart")
    if not any(k.startswith("fault_") for r in rec["readings"].values() for k in r):
        fail(f"{arch} mesh gradients: no planted fault was read")
    bf = rec["bf16"]
    log(f"  {arch} bf16's own scale: the mesh's bf16 gradients vs one device's {bf['mesh_vs_one_device'][0]:.3e} "
        f"({bf['mesh_vs_one_device'][1]}); one device's bf16 vs float32 {bf['one_device_vs_float32'][0]:.3e} "
        f"({bf['one_device_vs_float32'][1]})")
    rec["peak_gib"] = [r.get("peak_gib") for r in ranks]
    return rec


def mesh_reorder(runs, reorder) -> dict:
    """MESH_REORDER's one-device run with its gradient summed over two
    microbatches against the same run over one, reported beside the mesh's
    drift from one device."""
    row = next(r for r in runs if r["arch"] == MESH_REORDER[0] and r["world"] > 1)
    rels = [abs(a - b) / abs(b) for a, b in zip(reorder["losses"], row["one_device_losses"])]
    rec = dict(arch=MESH_REORDER[0], layers=MESH_REORDER[1], losses=reorder["losses"], loss_rel=rels,
               mesh_loss_rel=row["loss_rel"])
    log(f"  {MESH_REORDER[0]} ({MESH_REORDER[1]} layers) on one device over two microbatches: losses rel "
        f"{[f'{x:.2e}' for x in rels]} to one (the mesh's {row['loss_rel']:.2e})")
    if len(rels) != MESH_STEPS or not all(np.isfinite(reorder["losses"])):
        fail(f"the one-device run over two microbatches gave losses {reorder['losses']}")
    return rec


def mesh_resume_check(first, resumed, ref) -> dict:
    """whisper_tiny saved at 1x2 after 2 steps and resumed at 2x1 (FSDP over
    "data") for 2 more, against 4 uninterrupted steps on one device."""
    rec = dict(first=first[0]["losses"], first_mesh=first[0]["mesh"], resumed=resumed[0]["losses"],
               resumed_mesh=resumed[0]["mesh"], one_device=ref["losses"])
    got = rec["first"] + rec["resumed"]
    rels = [abs(a - b) / abs(b) for a, b in zip(got, ref["losses"])]
    rec["loss_rel"] = max(rels) if rels else None
    log(f"  resume: 1x2 {[round(x, 4) for x in rec['first']]} then 2x1 {[round(x, 4) for x in rec['resumed']]} vs one "
        f"device {[round(x, 4) for x in rec['one_device']]} (rel {rec['loss_rel']})")
    if len(got) != 4 or not (rels[0] <= MESH_LOSS_TOL[0] and max(rels) <= MESH_LOSS_TOL[1]):
        fail(f"the run resumed on another mesh gave {got}, against one device's {ref['losses']}")
    return rec


def dmrg_cell_on_card(dev) -> dict:
    """The dry run's dense Davidson step (launch/specs.dmrg_davidson_fn) on a
    1x1 mesh at MESH_DMRG, f32 and bf16 storage: its time beside the
    per-rank flops launch/costs.py counts while it runs, and its lam and
    residual norm against the same step on plain tensors."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch import mesh as mesh_mod, specs
    from repro_torch.launch.costs import counting
    from repro_torch.launch.sharding import placements_for

    p = MESH_DMRG
    m, d, k = p["m"], p["d"], p["k"]
    mesh = mesh_mod.make_mesh((1, 1), ("data", "model"), "cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        A = (torch.randn(m, k, m, generator=g, device=dev) / m).to(dt)
        W = (torch.randn(k, d, d, k, generator=g, device=dev) / k).to(dt)
        x = torch.randn(m, d, d, m, generator=g, device=dev)
        x = (x / x.norm()).to(dt)
        env = placements_for(("data", None, "model"), mesh)
        xs = placements_for(("data", None, None, "model"), mesh)
        rep = placements_for((), mesh)
        args = [distribute_tensor(t, mesh, pl) for t, pl in ((A, env), (W, rep), (W, rep), (A, env), (x, xs))]
        step = specs.dmrg_davidson_fn(m, d, k, store_dtype=dt)
        with counting(mesh_mod.HW) as c:
            lam, rn, _ = step(*args)
        plain_lam, plain_rn, _ = step(A, W, W, A, x)
        ms = time_ms(lambda: step(*args), reps=3)
        plain_ms = time_ms(lambda: step(A, W, W, A, x), reps=3)
        peak_ops = PEAK_FLOPS[dt]
        out[name] = dict(m=m, d=d, k=k, ms=ms, plain_ms=plain_ms, flops=c.flops, bytes=c.bytes,
                         achieved_tflops=c.flops / (ms * 1e-3) / 1e12, bound_ms=c.flops / peak_ops * 1e3,
                         lam=float(lam.full_tensor()), lam_plain=float(plain_lam),
                         rnorm=float(rn.full_tensor()), rnorm_plain=float(plain_rn))
        log(f"  DMRG step m={m} {name}: {ms:.2f} ms on the mesh ({plain_ms:.2f} plain), {c.flops:.3e} flops counted "
            f"({out[name]['achieved_tflops']:.1f} TFLOP/s), lam {out[name]['lam']:.6e} (plain {out[name]['lam_plain']:.6e})")
        del args, A, W, x
        torch.cuda.empty_cache()
        lim = 1e-4 if dt == torch.float32 else 5e-2
        if not abs(out[name]["lam"] - out[name]["lam_plain"]) <= lim * max(1.0, abs(out[name]["lam_plain"])):
            fail(f"DMRG step on the mesh: lam {out[name]['lam']} vs plain {out[name]['lam_plain']}")
    return out


def mesh_paths(entry: dict, name: str, meshed: dict) -> None:
    """Each rank's launches of ``name`` under phase 21's meshes, added to
    its kernels-line entry."""
    for r in meshed["runs"]:
        per_rank = [lc.get(name) for lc in r["launches"]]
        if any(per_rank):
            entry["launches"] += sum(sum(v.values()) for v in per_rank if v) * MESH_STEPS
            entry.setdefault("paths", {})[f"{r['label']} training, a step per rank (phase 21)"] = dict(
                launches=per_rank, shapes=[s.get(name) for s in r["shapes"]])


def flash_bwd_timing(dev, g, b: int, s: int, h: int, hkv: int, d: int, forced: str) -> dict:
    """flash's backward at one bf16 shape, one launch: the kernel the
    wrapper picks, ``forced`` (another variant, as ``<forced>_ms``), the
    plain version's backward and the backward of
    scaled_dot_product_attention (is_causal, enable_gqa; its backend
    named), each the faster of two CUDA-event means; with the kernel's
    error against plain and its bound."""
    from repro_torch.kernels.flash_attention import ops as flash_ops

    q, k, v, do = flash_inputs(dev, g, torch.bfloat16, b, s, h, hkv, d)
    o, lse = flash_ops._launch(q, k, v, with_lse=True)
    leaves = [a.detach().requires_grad_(True) for a in (q, k, v)]
    plain_o = flash_ops.flash_attention_bshd(*leaves, use_kernel=False)
    sdpa_in = [a.detach().transpose(1, 2).requires_grad_(True) for a in (q, k, v)]
    backend = torch.nn.attention.SDPBackend(torch._fused_sdp_choice(*sdpa_in, is_causal=True, enable_gqa=True)).name
    sdpa_o = torch.nn.functional.scaled_dot_product_attention(*sdpa_in, is_causal=True, enable_gqa=True)
    sdpa_do = do.transpose(1, 2)
    key = f"{forced.split('_')[1]}_ms"
    fns = {"ms": lambda: flash_ops._launch_bwd(q, k, v, o, lse, do),
           "plain_ms": lambda: torch.autograd.grad(plain_o, leaves, do, retain_graph=True),
           "library_ms": lambda: torch.autograd.grad(sdpa_o, sdpa_in, sdpa_do, retain_graph=True),
           key: lambda: flash_ops._launch_bwd(q, k, v, o, lse, do, kind=forced)}
    got = fns["ms"]()
    want = fns["plain_ms"]()
    rel = grad_rel(dict(zip("qkv", got)), dict(zip("qkv", want)))[0]
    forced_rel = grad_rel(dict(zip("qkv", fns[key]())), dict(zip("qkv", want)))[0]
    ops = 2.5 * 4.0 * d * b * h * s * (s + 1) / 2
    nbytes = 2.0 * (3 * b * s * h * d + 4 * b * s * hkv * d) + 4.0 * b * h * s  # q, o, do, dq; k, v, dk, dv; lse
    row = dict(shape=dict(B=b, S=s, H=h, Hkv=hkv, D=d, dtype="bfloat16"), variant=flash_ops.bwd_variant(torch.bfloat16, d),
               splits=flash_ops.bwd_splits(b, s, h, hkv, d, torch.cuda.get_device_properties(dev).multi_processor_count),
               rel_l2=rel, max_abs_err=max((x.float() - y.float()).abs().max().item() for x, y in zip(got, want)),
               forced=forced, forced_rel_l2=forced_rel, library_backend=backend, ops=ops, bytes=nbytes,
               **timed(fns, {"ms": 10, "plain_ms": 3, "library_ms": 10, key: 3 if forced == "bwd_simple" else 10}),
               **bound(ops, 989e12, nbytes))
    del q, k, v, do, o, lse, leaves, plain_o, sdpa_in, sdpa_o, sdpa_do, fns, got, want
    torch.cuda.empty_cache()
    return row


def backward_timings(dev) -> dict:
    """Each backward kernel timed alone at its training shape in bf16
    beside its plain version's backward (autograd through ref.py) and, for
    flash, the backward of scaled_dot_product_attention(is_causal=True);
    each with its bound.  Flash at llama3_8b's shape (with bwd_mma forced
    beside it) and at pixtral_12b's and recurrentgemma_2b's (D 160 and 256,
    with bwd_simple, the parent's, forced beside it), keyed
    ``flash_attention_bwd`` and ``flash_attention_bwd@<arch>``.  FA2's
    backward does 2.5 times the forward's matrix operations (five products
    of the causal pairs, not two); the scan's backward 12 N^2 operations
    per token and head, priced as the forward scan's bound prices them
    (products at the tensor cores' TF32 rate over their split passes, the
    rest at 67 TFLOP/s), with every operation at 67 TFLOP/s logged beside
    it."""
    from repro_torch.kernels.rwkv6_scan import ops as scan_ops

    g = torch.Generator(device=dev).manual_seed(21)
    rows = {"flash_attention_bwd": flash_bwd_timing(dev, g, TRAIN_BATCH, TRAIN_SEQ, 32, 8, 128, "bwd_mma"),
            "flash_attention_bwd@pixtral_12b": flash_bwd_timing(dev, g, TRAIN_BATCH, TRAIN_SEQ, 32, 8, 160,
                                                                "bwd_simple"),
            "flash_attention_bwd@recurrentgemma_2b": flash_bwd_timing(dev, g, TRAIN_BATCH, TRAIN_SEQ, 10, 1, 256,
                                                                      "bwd_simple")}

    b, t, h, n = TRAIN_BATCH, TRAIN_SEQ, 40, 64
    r, k, v, logw, u, do = scan_inputs(dev, g, torch.bfloat16, b, t, h, n)
    leaves = [a.detach().requires_grad_(True) for a in (r, k, v, logw, u)]
    plain_out, _ = scan_ops.rwkv6_wkv(*leaves, out_dtype=torch.float32, use_kernel=False)
    fns = dict(ms=lambda: scan_ops._launch_bwd(r, k, v, logw, u, None, do),
               plain_ms=lambda: torch.autograd.grad(plain_out, leaves, do, retain_graph=True))
    got = fns["ms"]()
    want = fns["plain_ms"]()
    rel = grad_rel(dict(zip(("r", "k", "v", "logw", "u"), got)), dict(zip(("r", "k", "v", "logw", "u"), want)))[0]
    tokens = b * t * h
    # per token and head: five products that a chunked form runs on the tensor
    # cores (dr = do S^T, dk = G v, dv = G^T k, the increments k^T v of S and
    # r^T do of G), 2 N^2 flops each, with their TF32 split passes counted as
    # the forward's bound counts them (3 with both operands float32, 2 against
    # bf16 k or v); dlogw = w * rowsum(G * S) on the CUDA cores
    passes = {"dr": 3, "dk": 2, "dv": 2, "s_increment": 2, "g_increment": 3}
    t_tensor = tokens * 2 * n * n * sum(passes.values()) / 495e12 * 1e3
    t_cuda = tokens * 2 * n * n / 67e12 * 1e3
    ops = tokens * 2 * n * n * (len(passes) + 1)
    nbytes = (2.0 * 3 + 4.0 * 2) * b * t * h * n + (2.0 * 3 + 4.0) * b * t * h * n + 4.0 * 2 * h * n
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bound_ms = max(t_tensor, t_cuda, t_bytes)
    rows["rwkv6_scan_bwd"] = dict(
        shape=dict(B=b, T=t, H=h, N=n, dtype="bfloat16", out_dtype="float32"), variant=f"chunk{n}", rel_l2=rel,
        max_abs_err=max((x.float() - y.float()).abs().max().item() for x, y in zip(got, want)), ops=ops,
        bytes=nbytes, library_ms=None, **timed(fns, dict(ms=10, plain_ms=1)),
        bound_ms=bound_ms, bound_by="bytes" if bound_ms == t_bytes else "operations",
        bound_tensor_ms=t_tensor, bound_cuda_core_ms=t_cuda, bound_bytes_ms=t_bytes,
        bound_f32_ms=max(ops / 67e12 * 1e3, t_bytes))
    del r, k, v, logw, u, do, leaves, plain_out, fns, got, want
    torch.cuda.empty_cache()
    for name, row in rows.items():
        log(f"  timing {name} " + json.dumps(row))
        if not max(row["rel_l2"], row.get("forced_rel_l2", 0.0)) <= BWD_TOL[name.split("@")[0]][torch.bfloat16]:
            fail(f"{name} at the training shape: kernel vs plain rel L2 {row['rel_l2']:.3e} "
                 f"({row.get('forced')} {row.get('forced_rel_l2')})")
    return rows


# ---------------------------------------------------------------- phase 22
def electron_run(dev, name, space, terms, mpo):
    """One width-6 run on the path ``name`` (scripts/electron_sweeps.py
    ``run_path``, see phase 22 above): its record, held to its checks,
    and its result."""
    sys.path.insert(0, str(ROOT / "scripts"))
    from electron_sweeps import run_path

    rec, res = run_path(space, terms, mpo, name, ELECTRON_BONDS, dev)
    sweeps, chosen, variants = rec["sweeps"], rec["backend_counts"], rec["variant_launches"]
    for st in sweeps:
        log(f"  {name} sweep " + json.dumps(st))
        # one launch per csr contraction, one per bucket of a batched one
        launched = sum(st["block_gemm_launches"].values())
        if launched < st["backend_counts"]["csr"] + st["buckets"]:
            fail(f"electrons {name} at m={st['m']}: {launched} block GEMM launches for {st['backend_counts']['csr']} "
                 f"csr contractions and {st['buckets']} buckets")
    es = [r["energy"] for r in sweeps]
    if not all(np.isfinite(es)) or not all(es[i + 1] <= es[i] + 1e-10 for i in range(len(es) - 1)):
        fail(f"electrons {name} sweep energies {es}")
    if any(r["davidson_exhausted"] for r in sweeps):
        fail(f"electrons {name}: a sweep had exhausted Davidson solves")
    if (chosen["csr"] + chosen["batched"] > 0) != (rec["launches"] > 0) or (name != "auto" and chosen[name] == 0):
        fail(f"electrons {name}: contractions by backend {chosen}, block GEMM launches {variants}")
    rec["ladder"] = assert_no_recovery(f"the electron {name} run", res)
    log(f"  {name}: {rec['wall_s']:.1f} s, sweeps {[round(r['seconds'], 2) for r in sweeps]} s, work lists "
        f"{[round(r['work_list_ms'], 1) for r in sweeps]} ms, contractions {chosen}, {rec['buckets']} buckets, "
        f"block_gemm {variants}, peak {rec['peak_gib']:.2f} GiB, csr packed {rec['csr_packed']}, SVD host syncs "
        f"{rec['svd_host_syncs']} over {rec['svd_calls']} splits; last E {es[-1]:.12f}")
    return rec, res


def electron_path(dev, entry):
    """The paper's electron system on the card (see phase 22 above): the
    3x2 patch through the planned pipeline against ED and the entry point's
    run (``entry``, phase 16), the width-6 runs, and the block GEMM on the
    csr run's and the batched run's middle-bond matvecs."""
    from repro_torch.core import run_dmrg
    from repro_torch.core.ed import ground_energy
    from repro_torch.core.env import get_contractor
    from repro_torch.core.models import electron_system
    from repro_torch.core.mpo import build_mpo, compress_mpo, mpo_bond_dims
    from repro_torch.core.mps import neel_states, total_charge

    space, small = electron_system(3, 2)
    e_ed = ground_energy(space, small, 6, charge=total_charge(space, neel_states(space, 6)))
    e_small = run_dmrg(space, small, 6, bond_schedule=(8, 16, 32, 64), sweeps_per_bond=2, davidson_iters=4,
                       algo="batched", jit_matvec=True, device=dev).energy
    small_rec = dict(e_ed=e_ed, e_batched=e_small, e_entry_point=entry["energy"], entry_point_err=entry["ed_err"])
    log(f"  3x2 patch: ED {e_ed:.12f}; batched with graphs {e_small:.12f} |dE_ED| {abs(e_small - e_ed):.2e}; the "
        f"entry point on csr {entry['energy']:.10f} |err| {entry['ed_err']:.2e}")
    if not (abs(e_small - e_ed) <= 1e-8 and abs(entry["energy"] - e_ed) <= 1e-8):
        fail(f"3x2 electrons: batched {e_small}, entry point {entry['energy']}, ED {e_ed}")

    space, terms = electron_system(ELECTRON_LX, ELECTRON_LY)
    mpo = compress_mpo(build_mpo(space, terms, ELECTRON_LX * ELECTRON_LY, device=dev), cutoff=1e-13)
    dims = mpo_bond_dims(mpo)
    if max(dims) != 26:
        fail(f"the width-6 MPO compressed to k={max(dims)}, not 26")
    runs, results = {}, {}
    for name in ELECTRON_PATHS:
        runs[name], res = electron_run(dev, name, space, terms, mpo)
        if name != "auto":
            results[name] = res
    del res
    last = {k: r["sweeps"][-1]["energy"] for k, r in runs.items()}
    spread = max(last.values()) - min(last.values())
    if not spread <= 1e-8:
        fail(f"electron last-sweep energies across paths {last}")

    # the block GEMM on the csr run's middle-bond matvec at the top bond
    j, rows = middle_bond_matvec(get_contractor("csr", dev), results.pop("csr"), mpo, dev)
    # and on the batched run's: its largest bucket and a bucket of extent 1
    engine = get_contractor("batched", dev)
    _, ops = padded_middle_bond(engine, results.pop("batched"), mpo)
    cands = matvec_buckets(dev, engine, *ops)
    thin = [c for c in cands if min(c[2].m, c[2].k, c[2].n) == 1]
    if not thin:
        fail(f"the batched electron matvec at m={ELECTRON_BONDS[-1]} has no bucket of extent 1")
    buckets = dict(count=len(cands), largest=bucket_row(dev, max(cands, key=lambda c: c[0]), "largest bucket"),
                   extent_1=bucket_row(dev, max(thin, key=lambda c: c[0]), "largest bucket of extent 1"))
    return dict(small=small_rec, mpo_bond_dims=dims, lx=ELECTRON_LX, ly=ELECTRON_LY, bonds=ELECTRON_BONDS, runs=runs,
                last_energy_spread=spread, middle_bond=j, matvec_steps=rows, batched_buckets=buckets)


def timed(fns, reps):
    """Each function's time, the faster of two interleaved CUDA-event means."""
    runs = {k: [] for k in fns}
    for _ in range(2):
        for k, fn in fns.items():
            runs[k].append(time_ms(fn, reps[k]))
    return {**{k: min(v) for k, v in runs.items()}, "runs": runs}


def bound(ops: float, peak_ops: float, nbytes: float) -> dict:
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_ops_ms=t_ops, bound_bytes_ms=t_bytes)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "chip_smoke.json"), help="JSON record of the run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    laps, t_lap = {}, [t_start]

    def lap(phase: str):  # seconds of the phase that just ended
        now = time.perf_counter()
        laps[phase], t_lap[0] = now - t_lap[0], now

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import kernels
    from repro_torch.core import run_dmrg, spin_system
    from repro_torch.core.ed import ground_energy
    from repro_torch.core.env import get_contractor
    from repro_torch.core.models import heisenberg_j1j2_terms
    from repro_torch.core.mpo import build_mpo, compress_mpo, mpo_bond_dims
    from repro_torch.core.siteops import spin_half_space
    from repro_torch.kernels.block_gemm import ops as block_gemm_ops
    from repro_torch.kernels.build import build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rwkv6_scan import ops as scan_ops

    # ---- phase 1: device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    device_name = torch.cuda.get_device_name(0)
    log(f"phase 1: {device_name} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    record = {"device": device_name, "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda}

    # ---- phase 2: build + kernel vs plain
    sources = [block_gemm_ops.SOURCE, flash_ops.SOURCE, scan_ops.SOURCE, flash_ops.BWD_SOURCE, scan_ops.BWD_SOURCE]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:  # one nvcc each, all started together
        libs = list(pool.map(build, sources))
    record["build_s"] = time.perf_counter() - t0
    log(f"phase 2: built {', '.join(src.name for src in sources)} in parallel in {record['build_s']:.1f} s")
    record["ptxas"] = ptxas = {}
    for lib in libs:  # each kernel instantiation's registers and spills, by its name in the mangled symbol
        entry = None
        for line in lib.with_suffix(".log").read_text().splitlines():
            found = re.search(r"Compiling entry function '\w*?\d(flash_simple|flash_mma|flash_wgmma|tiled_dmma|tiled_fma|"
                              r"skinny|second_pass|rwkv6_chunk_kernel|rwkv6_state_kernel|flash_bwd_dq_mma|flash_bwd_dkdv_mma|"
                              r"flash_bwd_dq_wgmma|flash_bwd_dkdv_wgmma|flash_bwd_delta|flash_bwd_dq|flash_bwd_dkdv|"
                              r"rwkv6_bwd_state|rwkv6_bwd_dv)(?:I(\w*?)E+v)?", line)
            if found:
                targs = re.sub(r"Li(\d+)E?", r",\1", found.group(2) or "").replace("13__nv_bfloat16", "bf16").strip(",")
                entry = found.group(1) + (f"<{targs}>" if targs else "")
            elif entry and ("spill" in line or "Used" in line):
                ptxas[entry] = (ptxas.get(entry, "") + " " + line.split(":", 1)[-1].strip()).strip()
    for entry, info in ptxas.items():
        log(f"  ptxas {entry}: {info}")
    worst = kernel_cases(dev)
    record["kernel_cases_rel_err"] = {str(k)[6:]: v for k, v in worst.items()}
    record["dense_f64"] = dmma_rate(dev)

    lap("1, 2")
    # ---- phase 3: small exact check
    sp = spin_half_space()
    terms = heisenberg_j1j2_terms(3, 2, 1.0, 0.5, cylinder=False)
    e_ed = ground_energy(sp, terms, 6)
    kw = dict(bond_schedule=(8, 16), davidson_iters=6, device=dev, svd_method="unplanned", jit_env=False)
    e_csr = run_dmrg(sp, terms, 6, algo="csr", **kw).energy
    e_ref = run_dmrg(sp, terms, 6, algo="csr_ref", **kw).energy
    log(f"phase 3: 3x2 E(csr)={e_csr:.12f} E(ED)={e_ed:.12f} |dE_ED|={abs(e_csr - e_ed):.2e} |dE_ref|={abs(e_csr - e_ref):.2e}")
    if not abs(e_csr - e_ed) <= 1e-8:
        fail(f"3x2 energy {e_csr} vs ED {e_ed}")
    if not abs(e_csr - e_ref) < 1e-10:
        fail(f"3x2 csr {e_csr} vs csr_ref {e_ref}")
    record["small"] = {"e_csr": e_csr, "e_csr_ref": e_ref, "e_ed": e_ed}

    lap("3")
    # ---- phase 4: full size
    space, terms = spin_system(8, 4)
    n = 32
    t0 = time.perf_counter()
    mpo = compress_mpo(build_mpo(space, terms, n, device=dev), cutoff=1e-13)
    log(f"phase 4: 8x4 cylinder, MPO bond dims {mpo_bond_dims(mpo)} built in {time.perf_counter() - t0:.1f} s; bonds {BONDS}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run_dmrg(space, terms, n, bond_schedule=BONDS, sweeps_per_bond=1, davidson_iters=2,
                   algo="csr", svd_method="unplanned", jit_env=False, mpo=mpo, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    gemm_variants = dict(kernels.VARIANT_LAUNCHES["block_gemm"])
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    sweeps = []
    for m, s in zip(BONDS, res.sweep_stats):
        row = dict(m=m, energy=s.energy, seconds=s.seconds, svd_seconds=s.svd_seconds, env_seconds=s.env_seconds,
                   max_bond=s.max_bond, trunc_err=s.trunc_err, flops_list=s.flops_list, flops_csr=s.flops_csr,
                   davidson_restarts=s.davidson_restarts, davidson_exhausted=s.davidson_exhausted)
        sweeps.append(row)
        log("  sweep " + json.dumps(row))
    log(f"  run {wall:.1f} s, launches {launches} (block_gemm by variant {gemm_variants}), peak memory {peak_gb:.2f} GiB")
    es = [s["energy"] for s in sweeps]
    if not all(np.isfinite(es)):
        fail(f"non-finite energies {es}")
    if not all(es[i + 1] <= es[i] + 1e-9 for i in range(len(es) - 1)):
        fail(f"sweep energies increase: {es}")
    if any(s["davidson_exhausted"] for s in sweeps):
        fail("a sweep had exhausted Davidson solves")
    if launches["block_gemm"] == 0:
        fail("the full-size run launched no block_gemm kernel")
    ladder4 = assert_no_recovery("the csr run", res)
    engine = get_contractor("csr", dev)
    j, mid = middle_bond_matvec(engine, res, mpo, dev)
    record.update(full_size=dict(bonds=BONDS, sweeps=sweeps, wall_s=wall, launches=launches,
                                 variant_launches=gemm_variants, peak_gib=peak_gb, ladder=ladder4,
                                 middle_bond=j, matvec_steps=mid))

    lap("4")
    # ---- phase 5: LM kernels vs plain
    log("phase 5: flash attention and RWKV6 scan vs plain")
    record["lm_kernel_cases_rel_err"] = lm_kernel_cases(dev)

    lap("5")
    # ---- phases 6, 7: the LM serving path at full width
    record["lm"] = {}
    for phase, arch in ((6, "llama3_8b"), (7, "rwkv6_3b")):
        log(f"phase {phase}: {arch} at full width, prefill B={LM_BATCH} x S={LM_SEQ}, then serve.main")
        record["lm"][arch] = lm_full_width(arch, dev)

    lap("6, 7")
    # ---- phase 8: decode vs prefill
    log("phase 8: cached decode vs prefill, smoke size, f32")
    record["decode_vs_prefill_max_abs"] = decode_vs_prefill(dev)

    lap("8")
    # ---- phase 9: LM kernel timings
    log("phase 9: flash attention and RWKV6 scan timed at the prefill's shapes")
    timing = lm_kernel_timings(dev)
    record["lm_kernel_timings"] = timing

    lap("9")
    # ---- phase 10: the planned pipeline
    log("phase 10: run_dmrg(algo=\"batched\", jit_matvec=True): 3x2, then the 8x4 run on the full BONDS")
    record["planned"] = planned = planned_pipeline(dev, record, space, terms, mpo)

    lap("10")
    # ---- phase 11: the slice's path, auto
    log("phase 11: run_dmrg(algo=\"auto\", jit_matvec=True): the 8x4 run on the full BONDS")
    auto, auto_res = auto_path(dev, record, space, terms, mpo)
    record["auto"] = auto

    lap("11")
    # ---- phase 12: dense against batched at full size
    log("phase 12: one middle-bond matvec through dense, batched and list engines; 3x2 dense and auto vs ED")
    record["dense_vs_batched"] = dense_vs_batched(dev, auto_res, mpo)

    lap("12")
    # ---- phase 13: faults on the card
    log("phase 13: each DMRG fault point armed once on the 6-site chain, held to a clean run")
    record["faults"] = faults_on_card(dev)

    lap("13")
    # ---- phase 14: checkpoint and resume
    log("phase 14: 8x4 auto run killed mid-sweep, resumed from its checkpoints")
    record["resume"] = checkpoint_resume(dev, space, terms, mpo)

    lap("14")
    # ---- phase 15: observables
    log("phase 15: observables on the 3x2 case against ED, and on the 8x4 auto ground state")
    record["observables"] = observables(dev, auto_res, space)
    del auto_res

    lap("15")
    # ---- phase 16: the serving path
    log(f"phase 16: DMRG-as-a-service, {SERVE_MODEL} {SERVE_SITES} sites m={SERVE_BOND}, one slot of "
        f"{len(SERVE_J2)} J2 values; the entry points beside its single runs")
    record["serve"] = served = serve_path(dev)

    lap("16")
    # ---- phase 17: distributed DMRG
    log(f"phase 17: run_dmrg(spmd=True) on the {SPMD_LX}x{SPMD_LY} cylinder, bonds {SPMD_BONDS}, worlds "
        f"{SPMD_WORLDS}")
    record["spmd"] = spmd_rec = spmd_path(dev)

    lap("17")
    # ---- phase 18: the plan store
    log(f"phase 18: the plan store: auto 8x4 at bonds {STORE_BONDS} cold, then primed in a fresh process")
    record["plan_store"] = store_rec = plan_store_path()

    lap("18")
    # ---- phase 19: the other LM families
    record["families"] = {}
    for arch, spec in FAMILIES.items():
        log(f"phase 19: {arch} at full width ({spec['layers'] or 'all'} layers), prefill B={LM_BATCH} x S={spec['seq']}"
            f", float32 at {spec['f32_layers'] or 'the same depth'}, then serve.main")
        record["families"][arch] = lm_full_width(arch, dev, **spec)
    families = record["families"]
    record["families_s"] = sum(r["wall_s"] for r in families.values())

    lap("19")
    # ---- phase 20: training
    log(f"phase 20: training at full width: the backward kernels vs plain, float32 gradients vs the plain path, "
        f"{', '.join(TRAIN_ARCHS)} B={TRAIN_BATCH} x S={TRAIN_SEQ}, {TRAIN_STEPS} timed steps; then the train CLI")
    t0 = time.perf_counter()
    record["train"] = trained = train_path(dev)
    trained["wall_s"] = time.perf_counter() - t0

    lap("20")
    # ---- phase 21: training under a mesh
    log(f"phase 21: training under a mesh: {', '.join(r[0] for r in MESH_RUNS)}, B={MESH_BATCH} x S={MESH_SEQ}, "
        f"{MESH_STEPS} steps each against one device; restore onto another mesh; the DMRG cell at m={MESH_DMRG['m']}")
    t0 = time.perf_counter()
    record["mesh"] = meshed = mesh_path(dev)
    meshed["wall_s"] = time.perf_counter() - t0

    lap("21")
    # ---- phase 22: the electron system
    log(f"phase 22: the electron system: the 3x2 patch through batched with graphs against ED; the "
        f"width-{ELECTRON_LY} cylinder ({ELECTRON_LX * ELECTRON_LY} sites) through {', '.join(ELECTRON_PATHS)} at "
        f"bonds {ELECTRON_BONDS}; the csr and batched middle-bond matvecs")
    t0 = time.perf_counter()
    record["electrons"] = electrons = electron_path(dev, served["entry_points"]["electrons"][-1])
    electrons["wall_s"] = time.perf_counter() - t0
    emid, ebk = electrons["matvec_steps"], {k: electrons["batched_buckets"][k] for k in ("largest", "extent_1")}

    lap("22")
    # ---- phase 23: summary
    total = lambda k: sum(r[k] for r in mid)
    bound_ops = sum(r["bound_ms"] for r in mid if r["bound_by"] == "operations")
    bucket = planned["largest_bucket"]
    entries = [dict(
        name="block_gemm", route="cuda", source="src/repro_torch/kernels/block_gemm/block_gemm.cu",
        replaces="src/repro/kernels/block_gemm/kernel.py:59",
        launches=(launches["block_gemm"] + planned["launches"]["block_gemm"] + auto["launches"]["block_gemm"]
                  + served["launches"]["block_gemm"] + sum(sum(w["launches"]) for w in spmd_rec["worlds"])
                  + sum(r["launches"] for r in electrons["runs"].values())),
        max_abs_err=max([r["max_abs_err"] for r in mid + emid + list(ebk.values())] + [bucket["max_abs_err"]]
                        + [c["max_abs_err"] for w in spmd_rec["worlds"] for c in w["largest_chunk"]]), ms=total("ms"),
        plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
        bound_by="operations" if bound_ops >= total("bound_ms") / 2 else "bytes",
        library_ms=total("library_ms"), variants=gemm_variants,
        paths={"csr (phase 4; ms etc.: the middle-bond matvec's four launches)": dict(
                   launches=launches["block_gemm"], variants=gemm_variants),
               "batched with graphs (phase 10; ms etc.: the middle-bond matvec's largest bucket)": dict(
                   launches=planned["launches"]["block_gemm"], variants=planned["variant_launches"],
                   **{k: bucket[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")}),
               "auto with graphs (phase 11; the cost model's batched choices only)": dict(
                   launches=auto["launches"]["block_gemm"], variants=auto["variant_launches"],
                   backend_counts=auto["backend_counts"]),
               "serve (phase 16; ms etc.: the largest folded bucket of the middle-bond stacked matvec)": dict(
                   launches=served["launches"]["block_gemm"], variants=served["variant_launches"],
                   **{k: served["largest_folded_bucket"][k] for k in
                      ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "separate_ms", "max_abs_err")}),
               **{f"spmd world {w['world']} {w['backend']} {w['mesh']} (phase 17; launches per rank; ms etc.: rank "
                  f"0's largest chunk)": dict(
                   launches=w["launches"], variants=w["variant_launches"],
                   **{k: w["largest_chunk"][0][k] for k in
                      ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")})
                  for w in spmd_rec["worlds"]},
               **{f"electrons {name} (phase 22)" + {
                   "csr": f"; ms etc.: the middle-bond matvec's four launches at m={ELECTRON_BONDS[-1]}",
                   "batched": "; ms etc.: the middle-bond matvec's largest bucket, and its largest of extent 1",
               }.get(name, ""): dict(
                   launches=r["launches"], variants=r["variant_launches"], buckets=r["buckets"],
                   **({k: sum(x[k] for x in emid) for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
                      if name == "csr" else {}),
                   **({k: ebk["largest"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                                       "max_abs_err")} | {"extent_1": ebk["extent_1"]}
                      if name == "batched" else {}))
                  for name, r in electrons["runs"].items()}},
    )]
    flash_runs = {"llama3_8b": record["lm"]["llama3_8b"], **families}
    family_rows = [r for r in timing.values() if "archs" in r]
    flash_variants = {v: sum(r["variant_launches"][v] for r in flash_runs.values())
                      for v in record["lm"]["llama3_8b"]["variant_launches"]}
    for name, arch, replaces in (
        ("flash_attention", "llama3_8b", "src/repro/kernels/flash_attention/kernel.py:70"),
        ("rwkv6_scan", "rwkv6_3b", "src/repro/kernels/rwkv6_scan/kernel.py:71"),
    ):
        row = timing[name]
        entry = dict(
            name=name, route="cuda", source=f"src/repro_torch/kernels/{name}/{name}.cu", replaces=replaces,
            launches=record["lm"][arch]["launches"][name], max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=row["library_ms"],
            variants=record["lm"][arch]["variant_launches"],
        )
        if name == "flash_attention":  # summed over llama3_8b's prefill and phase 19's
            entry.update(
                launches=sum(r["launches"][name] for r in flash_runs.values()), variants=flash_variants,
                paths={**{f"{a} prefill": dict(launches=r["variant_launches"]) for a, r in flash_runs.items()},
                       **{f"{', '.join(r['archs'])} attention (ms etc.)": {
                           k: r[k] for k in ("shape", "variant", "ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms", "max_abs_err")}
                          for r in family_rows}})
        for a, run in trained["runs"].items():
            if name in run["launches"]:
                entry["launches"] += sum(r["launches"][name] for r in run["steps"])
                entry.setdefault("paths", {})[f"{a} training, {len(run['steps'])} timed steps (phase 20)"] = dict(
                    launches=[r["variants"][name] for r in run["steps"]])
        mesh_paths(entry, name, meshed)
        entries.append(entry)
    for name, arch, src, replaces in (
        ("flash_attention_bwd", "llama3_8b", "flash_attention/flash_attention_bwd.cu",
         "none; the reference differentiates src/repro/models/attention.py:39 by autodiff"),
        ("rwkv6_scan_bwd", "rwkv6_3b", "rwkv6_scan/rwkv6_scan_bwd.cu",
         "none; the reference differentiates src/repro/models/rwkv6.py:118-151 by autodiff"),
    ):
        row = trained["timings"][name]
        runs = {a: run for a, run in trained["runs"].items() if name in run["launches"]}
        entries.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/kernels/{src}", replaces=replaces,
            launches=sum(r["launches"][name] for run in runs.values() for r in run["steps"]),
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            variants=[r["variants"][name] for r in runs[arch]["steps"]], rel_l2=row["rel_l2"], shape=row["shape"],
            paths={**{f"{a} training, {len(run['steps'])} timed steps (phase 20)": dict(
                      launches=[r["variants"][name] for r in run["steps"]]) for a, run in runs.items()},
                   **{f"{key.split('@')[1]}'s training shape (ms etc.)": {
                       k: r[k] for k in ("shape", "variant", "splits", "ms", "simple_ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms", "library_backend", "max_abs_err", "rel_l2")}
                      for key, r in trained["timings"].items() if key.startswith(f"{name}@")}}))
        mesh_paths(entries[-1], name, meshed)
    record["kernels"] = entries
    record["total_s"] = time.perf_counter() - t_start
    record["phase_s"] = laps
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    log("kernels: block_gemm " + " ".join(f"{str(k)[6:]}={v:.2e}" for k, v in worst.items())
        + f" middle-bond-f64={max(r['rel_err'] for r in mid):.2e} (relative to max |value|)")
    for name, w in record["lm_kernel_cases_rel_err"].items():
        metric = "per-row relative" if name == "flash_attention" else "relative to max |value|"
        log(f"kernels: {name} " + " ".join(f"{k}={v:.2e}" for k, v in w.items()) + f" ({metric})")
    for arch, rec in record["lm"].items():
        log(f"{arch}: prefill {rec['prefill_s']:.3f} s ({rec['prefill_tok_s']:.0f} tok/s), {rec['launches'][rec['kernel']]} "
            f"{rec['kernel']} launches, peak {rec['peak_gib']:.2f} GiB, bf16 logits kernel vs plain "
            f"{rec['logits_rel_err']:.2e} of max |logit| (per token {rec['logits_row_rel_err']:.2e}), argmax agree "
            f"{rec['argmax_agree']:.4f}; f32 logits per token {rec['f32_logits_row_rel_err']:.2e} (control "
            f"{rec['bf16_vs_f32_row_rel_err']:.2e}); decode {rec['decode_tok_s']} tok/s after the first step "
            f"({rec['decode_first_step_s']} s)")
    for arch, rec in families.items():
        log(f"{arch} ({rec['layers']} layers): prefill {rec['prefill_s']:.3f} s ({rec['prefill_tok_s']:.0f} tok/s), flash "
            f"{rec['variant_launches']}, peak {rec['peak_gib']:.2f} GiB, bf16 logits per token "
            f"{rec['logits_row_rel_err']:.2e}, argmax agree {rec['argmax_agree']:.4f}; f32 ({rec['f32_layers']} layers) "
            f"{rec['f32_logits_row_rel_err']:.2e} (control {rec['bf16_vs_f32_row_rel_err']:.2e}, limit "
            f"{F32_LOGITS_TOL[arch]}" + (f"; each path on its own router {rec['f32_free_routing_row_rel_err']:.2e}"
                                         if "f32_free_routing_row_rel_err" in rec else "")
            + f"); decode {rec['decode_tok_s']} tok/s")
    for r in family_rows:
        log(f"flash at {', '.join(r['archs'])} ({r['variant']}, {r['shape']}): {r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, sdpa {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
            f"by {r['bound_by']}), per-row rel err {r['rel_err']:.2e}")
    log(f"phase 19: {record['families_s']:.1f} s")
    for arch, run in trained["runs"].items():
        f32 = trained["f32_grads"][arch]
        log(f"{arch} training ({run['layers']} layers, {run['params'] / 1e9:.2f} B parameters, B={TRAIN_BATCH} x "
            f"S={TRAIN_SEQ}): {run['step_s']:.3f} s a step ({run['tokens_s']:.0f} tok/s), peak {run['peak_gib']:.2f} GiB, "
            f"losses {[round(r['loss'], 4) for r in run['steps']]}, grad norms "
            f"{[round(r['grad_norm'], 4) for r in run['steps']]}, launches a step {run['launches']}; float32 gradients "
            f"({f32['layers']} layer) kernel vs plain {f32['grad_rel_l2']:.2e} (control {f32['control_bf16_rel_l2']:.2e}, "
            f"limit {TRAIN_GRAD_TOL})")
    for arch, run in trained["runs"].items():
        if "bwd_simple_step_s" in run:
            log(f"{arch} training step {run['step_s']:.3f} s; with bwd_simple forced (the parent's backward) "
                f"{[round(x, 3) for x in run['bwd_simple_step_s']]} s")
    for name, row in trained["timings"].items():
        lib = f", sdpa backward {row['library_ms']:.4f} ({row['library_backend']})" if row["library_ms"] is not None else ""
        lib += f", {row['forced']} forced {row[row['forced'].split('_')[1] + '_ms']:.4f}" if "forced" in row else ""
        log(f"{name} at {row['shape']}: {row['ms']:.4f} ms (plain {row['plain_ms']:.3f}{lib}, bound {row['bound_ms']:.4f} "
            f"by {row['bound_by']}), rel L2 {row['rel_l2']:.2e}")
    log(f"phase 20: {trained['wall_s']:.1f} s")
    for r in meshed["runs"]:
        log(f"mesh {r['label']}: step s per rank {[[round(x, 3) for x in t] for t in r['step_s']]} (one device "
            f"{[round(x, 3) for x in r['one_device_step_s']]}), peak {[round(x, 2) for x in r['peak_gib']]} GiB, losses "
            f"rel {r['loss_rel']:.2e}, launches per rank {r['launches']}")
    for arch, g in meshed["grads"].items():
        log(f"mesh float32 gradients {arch}: " + "; ".join(
            f"{label} " + ", ".join(f"{n} {v[0]:.2e}" for n, v in r.items()) for label, r in g["readings"].items())
            + f" (limit {MESH_GRAD_TOL}); bf16 mesh vs one device {g['bf16']['mesh_vs_one_device'][0]:.2e}, one "
            f"device bf16 vs float32 {g['bf16']['one_device_vs_float32'][0]:.2e}")
    ro = meshed["reorder"]
    log(f"{ro['arch']} one device over two microbatches: losses rel {[f'{x:.2e}' for x in ro['loss_rel']]} (mesh "
        f"{ro['mesh_loss_rel']:.2e}, limit {MESH_LOSS_TOL})")
    res, dm = meshed["resume"], meshed["dmrg"]
    log(f"mesh resume 1x2 -> 2x1: losses rel {res['loss_rel']:.2e}; gloo on CUDA: "
        + ", ".join(f"{k} {'ok' if v.get('right') else 'refused'}" for k, v in meshed["gloo_probe"]["ops"].items()))
    for name, r in dm.items():
        log(f"DMRG step m={r['m']} {name}: {r['ms']:.2f} ms ({r['plain_ms']:.2f} plain), {r['flops']:.3e} flops counted, "
            f"{r['achieved_tflops']:.1f} TFLOP/s")
    lh = meshed["local_heads"]
    log("launches at a 1x2 rank's heads vs all heads, ms: " + ", ".join(
        f"{k.split('_')[0]} fwd {lh[k.split('_')[0] + '_local']['fwd_ms']:.4f} / {lh[k]['fwd_ms']:.4f}, bwd "
        f"{lh[k.split('_')[0] + '_local']['bwd_ms']:.4f} / {lh[k]['bwd_ms']:.4f}" for k in ("flash_all", "scan_all")))
    log(f"phase 21: {meshed['wall_s']:.1f} s")
    for arch in ("pixtral_12b", "recurrentgemma_2b"):
        r, w = timing[f"flash_mma_{arch}"], timing[f"flash_{arch}"]
        log(f"flash_mma forced at {arch}'s attention: {r['ms']:.4f} ms against {w['variant']}'s {w['ms']:.4f} "
            f"({r['ms'] / w['ms']:.2f}x), per-row rel err {r['rel_err']:.2e}")
    small, sw = planned["small"], planned["sweeps"]
    log(f"planned pipeline: 3x2 |dE_ED|={abs(small['energy'] - small['e_ed']):.2e}; 8x4 {planned['wall_s']:.1f} s "
        f"(csr {record['full_size']['wall_s']:.1f} s), sweeps {[round(r['seconds'], 2) for r in sw]} s, SVD "
        f"{[round(r['svd_seconds'], 2) for r in sw]} s, {planned['graph_replays']} graph replays, block_gemm "
        f"{planned['variant_launches']}; replay vs eager {max(planned['replay_vs_eager']['rel_errs']):.2e}; largest "
        f"bucket {bucket['ms']:.4f} ms (bound {bucket['bound_ms']:.4f}, bmm + index_add_ {bucket['library_ms']:.4f})")
    auto, dvb, res14 = record["auto"], record["dense_vs_batched"], record["resume"]
    log(f"auto path: 8x4 {auto['wall_s']:.1f} s, sweeps {[round(r['seconds'], 2) for r in auto['sweeps']]} s, "
        f"contractions by backend {auto['backend_counts']}, block_gemm {auto['variant_launches']}; middle-bond "
        f"matvec dense {dvb['dense_ms']:.2f} ms, batched {dvb['batched_ms']:.2f} ms, list {dvb['list_ms']:.2f} ms "
        f"(dense vs batched {dvb['dense_vs_batched_rel_err']:.2e}); faults recovered "
        f"{[p for p in record['faults'] if '.' in p]}; resume bitwise {res14['bitwise_equal']} "
        f"(max |dE| {max(res14['abs_diffs']):.2e}); correlation profile {record['observables']['profile_s']:.2f} s")
    fb = served["largest_folded_bucket"]
    single_diffs = ", ".join(f"{x['abs_diff']:.1e}" for x in served["singles"])
    log(f"serve: {served['problems_per_s']:.3f} problems/s ({served['solve_s']:.1f} s solve, {served['sweep_s']:.2f} s "
        f"a sweep; stages per sweep {json.dumps({k: round(v, 3) for k, v in served['stage_per_sweep_s'].items()})}), "
        f"block_gemm {served['variant_launches']}, captures {served['warmup_captures']} in warmup and "
        f"{served['captures_after_warmup']} after, peak {served['peak_gib']:.2f} GiB; singles |dE| {single_diffs}; "
        f"folded bucket {fb['ms']:.4f} ms (8 separate {fb['separate_ms']:.4f}, bmm + index_add_ "
        f"{fb['library_ms']:.4f}, bound {fb['bound_ms']:.4f})")
    log("entry points, side by side: " + "; ".join(
        f"{k} " + " then ".join(f"{r['seconds']:.1f} s" for r in v) for k, v in served["entry_points"].items()))
    for w in spmd_rec["worlds"]:
        c = w["largest_chunk"][0]
        log(f"spmd world {w['world']} ({w['backend']}, {w['mesh']}): {w['run_s'][0]:.1f} s run ({w['wall_s']:.1f} s "
            f"with start-up), sweeps {[round(x, 2) for x in w['seconds']]} s, |dE| vs single process "
            f"{w['max_abs_diff']:.1e}, block_gemm per rank {w['launches']}, {w['spmd']['gemm_calls']} split GEMMs "
            f"({w['spmd']['fallback_calls']} fallbacks); rank 0's largest chunk {c['shape']} {c['ms']:.4f} ms (plain "
            f"{c['plain_ms']:.4f}, bmm + index_add_ {c['library_ms']:.4f}, bound {c['bound_ms']:.4f})")
    cold, primed = store_rec["cold"], store_rec["primed"]
    log(f"plan store: cold {cold['plan_builds']} plan builds, {sum(cold['sweep_captures'])} captures in its sweeps, "
        f"first sweep {cold['seconds'][0]:.2f} s; primed 0 builds, {primed['warmup']['captures']} captures in "
        f"{primed['warmup']['seconds']:.2f} s of warmup and {sum(primed['sweep_captures'])} in its sweeps, first sweep "
        f"{primed['seconds'][0]:.2f} s; |dE| {store_rec['max_abs_diff']:.1e}")
    esm = electrons["small"]
    log(f"electrons: 3x2 entry point |err| {esm['entry_point_err']:.2e}, batched with graphs "
        f"|dE_ED| {abs(esm['e_batched'] - esm['e_ed']):.2e}; width {ELECTRON_LY} x {ELECTRON_LX} at bonds "
        f"{ELECTRON_BONDS}: " + "; ".join(
            f"{k} {r['wall_s']:.1f} s (sweeps {[round(x['seconds'], 2) for x in r['sweeps']]}), block_gemm "
            f"{r['variant_launches']}, peak {r['peak_gib']:.2f} GiB" for k, r in electrons["runs"].items())
        + f"; last energies within {electrons['last_energy_spread']:.1e}; matvec at m={ELECTRON_BONDS[-1]} "
        f"{sum(x['ms'] for x in emid):.4f} ms (plain {sum(x['plain_ms'] for x in emid):.3f}, bmm + index_add_ "
        f"{sum(x['library_ms'] for x in emid):.4f}, bound {sum(x['bound_ms'] for x in emid):.4f}); batched buckets "
        + ", ".join(f"{k} [{r['P']}, {r['M']}, {r['K']}, {r['N']}] {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
                    f"bmm + index_add_ {r['library_ms']:.4f}, bound {r['bound_ms']:.4f})"
                    for k, r in (("largest", ebk["largest"]), ("extent 1", ebk["extent_1"])))
        + f" of {electrons['batched_buckets']['count']}; phase 22 {electrons['wall_s']:.1f} s")
    log("seconds by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in laps.items()))
    log(f"total {record['total_s']:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
