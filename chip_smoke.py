#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``tvqvae_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It needs no JAX and no network. Phases, each fatal on failure:

  1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` name, the
     scipy version and whether scikit-learn, pandas and matplotlib are there
     (for the record: the port never imports the first two; matplotlib draws
     the flyability CLI's plot where it is importable).
  2. build: every CUDA kernel from ``tvqvae_tpu_torch/csrc`` with nvcc, one
     nvcc per source, all started together, while the published-width
     sampler of phase 4 is built.
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes, the K sweep and one ragged shape, with times,
     device time per launched kernel (torch.profiler) and bounds.
  4-6. the served path, with every launch counter set to 0 first: the
     sampler at the published width (B=32, C=4, L=4633, hid_dim 128,
     codebooks 32/32, priors 128x4Lx2H and 32x1Lx1H, 5 classes, seeded
     random weights), ``reconstruct`` of 64 series (two launches of the VQ
     kernel per batch), and the HTTP server answering three requests.
  7. train: the counters set to 0 again, ``train_stage1`` at the published
     width (``Config()``, dropout as configured) for 30 steps on 320
     synthetic series (288 train, 32 test), writing its checkpoint as the
     train CLI lays them out (``models/trajectories/stage1`` in a temp
     directory): two VQ kernel launches per step and per validation batch,
     a finite loss that falls after the warmup, steady ms per step (CUDA
     events), peak memory.
  8. stage 2: the counters set to 0 again, the trained stage 1 read back
     from its checkpoint (``load_stage1_bundle``) and ``train_stage2``,
     writing ``stage2``, at the published width (priors 128x4Lx2H and
     32x1Lx1H, B=16, dropout 0.3, p_unconditional 0.2) for 120 steps on the
     precomputed-token path: the sweep's VQ launches (2 per 64-series
     batch), a finite loss that falls, steady ms per step past a 20-step
     warmup (CUDA events), peak memory; and one validation at the end
     scoring 32 series sampled from the priors with the ROCKET ``Metrics``
     (1000 kernels, built on the card after phase 7): the JAX runner's
     ``running_metrics`` names, finite, its seconds apart from the steps.
  9. stage 3: the counters set to 0 again, ``train_stage3`` over the same
     stage 1 read from disk, writing ``stage3``, at the published width (``Config()``: enhancer dim 8,
     dim_mults (1, 2, 4, 8), 4 groups, dropout 0.5, B=16) for 60 steps on
     the precomputed-x' path: the x' sweep's VQ launches (2 per 32-series
     batch) and none in the steps, a finite loss that falls, steady ms per
     step past a 20-step warmup (CUDA events), the memory it adds, the
     enhancer's parameter count; one validation as in phase 8, over 32
     series sampled from the written stage 2, raw and enhanced.
 10. fcn: ``train_fcn`` (128/256/128 channels, kernels 8/5/3) for 45 steps
     at batch min(256, 288), writing ``fcn``: a finite loss that falls, the
     128-wide features, train accuracy, steady ms per step, peak memory.
 11. eval: ROCKET features/s and the card against the CPU on 8 series;
     ``Metrics("supervised_fcn")`` over ``fcn`` read from disk and
     MiniRocket (a 64-series fit, above 2^24 values per quantile sort) against
     the CPU; then, the counters set to 0 again, the evaluate entry point
     (``scripts/evaluate.py::evaluate`` over the written stages and ``fcn``:
     64 series sampled ``from_checkpoints`` and enhanced, FID by svd on the
     2000-wide ROCKET features, FID_rec of the test split with 2 VQ launches
     per batch, IS, MDD/ACD/SD/KD, the same with the enhancer; the JAX
     package's result names, finite; its seconds by call) and the tau search
     over two taus; after the count, Schur against svd on the 128-wide FCN
     features of the train split and its round trip (n > D).
 12. bf16: the counters set to 0 again, the JAX package's production
     recipe under ``--bf16`` at the published width: phase 4's seeded
     weights under the JAX sampler's bfloat16 defaults
     (``compute_dtype="bfloat16"``, ``fast_bn``, ``bf16_head``,
     ``bf16_istft``): tokens equal to phase 4's float32 sampler's under the
     same noise, series within 0.30 of their scale (JAX's own bfloat16 gap
     on such weights: their BatchNorms keep their identity statistics,
     which do not normalise the random stacks), and the stages trained in
     phases 7-8 read ``from_checkpoints`` in bfloat16 within 0.06 of phase
     8's float32 decode of the same tokens; ms per 32-batch and device busy
     beside the float32 sampler's and beside the same weights in float32
     with ``fast_bn`` (the generate and serve CLIs' default), the top
     device ops of one batch, ``reconstruct`` of 64 series (4 VQ launches:
     the bfloat16 encoders hand the kernel float32 latents);
     ``train_stage1`` with ``compute_dtype="bfloat16"``, ``fast_bn``,
     ``bf16_mu``, ``bf16_head`` for 20 steps on phase 7's data (loss finite
     and falling, Adam's first moment stored in bfloat16, steady ms per
     step and the memory it adds beside phase 7's), then a few steps each
     (CUDA events) of the runner's float32 defaults and the train CLI's
     (float32, ``fast_bn``, ``bf16_mu``) on phase 7's weights, and of the
     production recipe with and without ``remat``, with the peak memory
     each adds; ``train_stage3`` over phase 8's stage 1 with a bfloat16
     stream and ``fast_norm`` for 10 steps (ms per step, the memory it
     adds). Its VQ launches are ``launches_by_path.bf16``.
 13. ess: the ESS sampler (naive LF decode, token critic, critical reverse
     sampling, critic-guided re-decode, HF pass) of a seeded small model on
     the card against the CPU with the same noise (confidences within
     1e-5, t_star and tokens equal, series within 2e-4 of their scale);
     then, the counters set to 0 again, phase 4's seeded published-width
     weights with ``MaskGIT.ESS.use``: ms per 32-batch beside the plain
     sampler's, prior forwards a batch, device busy over one batch, and no
     VQ launch (ESS decodes through the codebook lookup).
 14. quality: the counters set to 0 again, the port's quality run
     (``scripts/quality_run.py::run``: the JAX tool's synthetic set, L=512,
     hid_dim 64, through the train CLI with ``--bf16`` and its defaults,
     then the FID ladder with ROCKET features, and ``--ess``) at cut
     budgets (10/20/5 steps, 64 series scored): every SUMMARY key of the
     JAX tool, finite, ``fid_noise`` above ``fid_floor``, FID_rec through
     the VQ kernel (2 launches). The kernel phase holds the kernel at this
     geometry's D=64 shapes too.
 14b. flyability: the counters set to 0, the 14 trajectory distances of 66
     synthetic flight pairs through ``calculate_trajectory_distances_batch``
     on the card: 64 generated tracks of L=4633 points along the EHAM ->
     LIMC great circle with smooth noise, each with a flown counterpart
     shaped like a 10-s BlueSky log (every 8th point, 0.005 deg of noise;
     bucket (5120, 1024)), and 2 pairs of 4633 points each (bucket (5120,
     5120)): one launch of ``csrc/traj_dp.cu`` a bucket and the rounds of
     ``csrc/frechet_decision.cu`` that its launch plan gives the bucket,
     wall ms, pairs/s, device ms a launch (torch.profiler); each bucket's
     Frechet equal to the kernel at depth 1 (the sequential schedule), its
     ms a call beside the depth-1 call's (CUDA events, in turns), its depth,
     rounds, blocks and ns a dependent step; then the DP kernel against its plain version on 2
     pairs of the first bucket (EDR and LCSS exactly, the discrete Frechet
     1e-6, DTW and ERP 1e-5 relative), SSPD and Hausdorff against the plain
     matrices on the card and the CPU, and the Frechet kernel against its
     plain version (its decision replayed from a CUDA graph) on 2 pairs of
     (1024, 512) points and at each bucket's plan on its pairs cut to 64 of
     p's points (1e-5 relative, and equal to depth 1), with ms, the plain
     version's ms and the bound; the DP kernel at each bucket's plan on its
     pairs cut to 300 of p's points (past two turns of the strips' 128-row
     hand-off ring), and each bucket's batch values equal to a standalone
     launch of its pairs at another plan.
 14c. preprocess: (a) the counters set to 0, the OpenSky preprocess CLI in
     the process on a synthetic export written by the phase (5 corridors of
     20 flights of 4633 points, ~0.46M rows, aircraft interleaved in time,
     each aircraft flying twice 8 h apart), its clustering on the card:
     rows/s of the parse, seconds by stage, EM iterations and lower bound;
     the flight ids are the written flights, the labels the corridors, each
     timedelta ends at its flight's duration in seconds, and the .npz goes
     through ``get_data`` into one published-width ``train_stage1`` step (2
     VQ launches a step and a validation batch); (b) the Gaussian mixture at
     the published dataset's clustering geometry (N=6592, D=2000, K=5) on
     the card on seeded corridor features: seconds, EM iterations, ms an E+M
     pair, its float64 operations and their share of 67 TFLOP/s, peak
     memory; (c) the mixture on the card and on the CPU at N=512, D=400,
     K=5: labels and iterations equal, means within 1e-9 relative.
 14d. import: seeded published-width modules (stage 1 with
     random BatchNorm statistics, both priors with the x-transformers
     wrapper's projections, the enhancer, the FCN) written with
     ``torch.save`` as the reference's Lightning checkpoints (the inverse of
     ``utils/import_reference.py``, newer x-transformers naming, a stage-3
     tau of 0.5); ``python -m tvqvae_tpu_torch.scripts.import_ckpt`` on them
     in a subprocess (bytes, seconds by stage); then, the counters set to 0,
     ``from_checkpoints`` of its output without and with the enhancer
     against the in-memory sampler of the same modules: a 32-batch with
     injected noise (tokens equal, series bit-equal, ms), ``reconstruct`` of
     32 series (bit-equal, 2 VQ launches; ``launches_by_path.import``); one
     sample batch under ``profiling.trace`` with an ``annotate("sample")``
     span, the Chrome trace read back (the span, the device kernels).
 14e. parallel: data parallelism over ``torch.distributed``, its ranks child
     processes on the one card (spawned; NCCL refuses two ranks on one
     device, so two ranks talk over gloo, which reduces CUDA tensors through
     the host). (a) two ranks, each with 16 of a global batch of 32, take
     three published-width stage-1 steps (``Config()`` with dropout 0; SGD,
     PyTorch's native kernels and its deterministic algorithms,
     ``par_sgd`` and ``parallel_phase`` say why) against this process's
     one-process run of the same steps at 32: VQ indices and
     ``cluster_size`` equal, ``embed_avg`` within Σ(n-1)·2⁻²⁴·Σ|x| of the
     steps' VQ inputs, the step-1 gradients per leaf within 1e-4 of its
     scale (``check_stage1_pair``: the HF leaves by the HF L1 loss's sign
     flips where its residual crossed 0, at most PAR_FLIPS of them), every
     leaf after the steps within 1e-4, the ranks' BatchNorm statistics and
     codebooks equal and their parameters' sums equal; (b) three on-the-fly
     stage-2 steps at the published prior widths (dropout 0, masks handed
     in) at 8 + 8 of 16: tokens equal, prior leaves within 1e-4 + 1e-4
     relative; (c) one stage-1 step in a one-rank NCCL group against the
     same step with no group, bit for bit; (d) the serve CLI's service with
     ``--data_parallel`` over the card against the one without: the same
     seeded 32-batch, bit-equal; (e) ``train_stage1`` of a small config by
     the two ranks on the host feed (``prefetch_batches``' pinned copies),
     straight and resumed from its step-2 snapshot (bit-equal), against
     this process's run on the device gather (Adam's element rule,
     ``check_adam_elements``; losses 1e-4 relative; the ranks' validation
     against one process's of the same state, 1e-5) and its run on the host
     feed (bit-equal); (f) ``train_stage1`` in the production recipe
     (cuDNN, AdamW with bfloat16 moments, bfloat16 compute, fast BatchNorm)
     at the published width by the two ranks, three steps: one state on
     both ranks, finite, two VQ launches a step on each; (g) tensor
     parallelism (``parallel/tp.py``): the two ranks as a (1, 2) grid take
     (a)'s three steps on all 32 rows at the published width, the rule's
     leaves split between them, held to (a)'s one-process reference by
     (a)'s bounds (and whether bit-equal); then one AdamW step; each rank's
     ``memory_allocated`` between steps against the shard arithmetic
     (parameters and gradients with SGD, parameters and both moments with
     AdamW, 5 %), its peak, the split fraction of the parameter bytes, rank
     0's step ms; then ``train_stage1(tp=2)`` at (e)'s small config (the
     floor lowered to 512 elements so that the rule splits its leaves)
     straight and resumed from its step-2 snapshot (bit-equal), against
     (e)'s one-process run by Adam's element rule. (b)-(g) under
     deterministic cuDNN. Each rank's VQ launches come back to this process
     (``launches_by_path.parallel``, and (g)'s as ``launches_by_path.tp``);
     the two-rank steps' ms and each rank's peak memory are printed.
 14f. bundle: the train CLI's default ``--bundle_steps 10``
     (``train/multistep.py``: each stage's step captured once as a CUDA
     graph and replayed a bundle at a time). The counters set to 0, under
     deterministic cuDNN and PyTorch's deterministic algorithms, each case
     through its runner from one seeded state on phase 7's data, in
     bundles of 10 and step by step, 23 steps (two bundles and a 3-step
     tail), validating and snapshotting at step 20: (a) stage 1 at the
     published width in float32, (b) stage 1 in the production recipe,
     (c) stage 2 on precomputed tokens over phase 8's frozen stage 1, (d)
     stage 3 on a precomputed x' (dropout 0.5), (e) stage 1 at the small
     config on the train CLI's small set (below) on the host feed (a
     bundle's batches staged on the card) with
     k-means init and dead-code expiry (off when published: the latch is
     set before the capture, the expiry draws replay). The
     final parameters,
     BatchNorm statistics, codebooks and AdamW state, the step-20
     snapshots with their generator states, the logged bundle means (the
     eager steps' metrics summed in order and divided by 10) and tail
     steps, and the validations: all bit-equal; VQ launches 2 a stage-1
     step and validation batch, the replays' counted by the graph's
     recorded launches; (a) resumed in bundles from the step-20 snapshot
     (3 steps left) bit-equal to the straight run; one captured
     published-width stage-1 step against the same step run eagerly with
     the plain VQ twin (indices equal, loss 1e-5, codebooks 1e-4 + 1e-4
     relative); the train CLI at its default in a subprocess on the small
     config (``--stage all``, 23 steps a stage: each stage's step captured
     once). Then, at PyTorch's defaults, each case's steady ms a step eager
     and bundled (CUDA events over 20 steps), the capture's seconds, the
     peak memory above the state beside the graph's pool, and device busy
     and idle share of one bundle beside one eager step (torch.profiler);
     its VQ launches are ``launches_by_path.bundle``.
 15. ckpt: each checkpoint's bytes, write and read seconds; one
     published-width stage-1 snapshot's bytes and stall; then, the counters
     set to 0 again, ``TrainedModelSampler.from_checkpoints`` at the
     published width against the in-memory sampler of the trained states
     with the same noise (a 32-batch: tokens equal, series within 1e-5 of
     their scale; ``reconstruct`` of 64 series: 4 VQ launches), and one
     HTTP request to the service the serve CLI builds from disk; then the
     generate CLI starts in a subprocess (64 series, raw and enhanced:
     finite, in original units), then the evaluate CLI (the JAX package's
     result names, finite); both run beside the untimed checks below, which
     wait for them before the timed ones.
 16. checks after the counted runs: the reconstruct tokens against the
     plain VQ version; a small model on the card against the same model on
     the CPU (plain versions) with the same weights and noise, sampling and
     three training steps of each stage; one more published-width training
     step from the trained state through the VQ kernel and through its
     plain twin (indices by the near-tie rule, ``vq_near_ties``, and EMA
     codebook state); two series at the published width through the card
     and the CPU; the stage-2 sweep's tokens against the plain VQ version's
     (the near-tie rule); three on-the-fly stage-2 steps
     against the token path; a 32-batch sampled from the trained priors;
     the x' sweep through the kernel and its plain twin (the near-tie
     rule); three on-the-fly
     stage-3 steps against the precomputed path and three at tau 0.5; a
     small stage 3 (dim_mults (1, 2) with dropout 0, and the published
     (1, 2, 4, 8) with dropout 0.5 on masks drawn on the CPU and replayed on
     the card) and a small FCN on the card against the CPU; the
     published-width enhancer on the card against the CPU and a float64
     witness; the sampler with a seeded enhancer, and the trained enhancer
     over a batch sampled from the trained priors; a small model in
     bfloat16 on the card against the CPU (samples, a stage-1 step and an
     enhancer step); a small stage 1 resumed from its snapshot against the
     same run straight through.
     Beside them, the flyability CLI (``python -m
     tvqvae_tpu_torch.scripts.evaluate_flyability`` in a subprocess; its
     CDF plot where the card has matplotlib) on the generate CLI's 64
     series with the JAX tests' stub simulator: the simulated CSV, the
     distances JSON with the 14 metrics, finite, one value per simulated
     flight. The evaluate CLI of phase 15 writes the JAX CLI's images where
     the card has matplotlib; without it a subprocess calls its
     ``run(args, figures=False)``: every image's data computed and finite.
 16b. analysis: the analysis CLI's ``run(args, figures=<matplotlib
     importable>)`` in the process on 5200 synthetic series of L=256 (520
     test) and 512 more as the generated set, with the flyability CLI's
     JSON: its seconds by step, ROCKET features (250 kernels), FID and the
     statistics on the card, PCA and t-SNE of 2 x 512 feature rows on the
     card (ms, the t-SNE's KL and trustworthiness); the same PCA and t-SNE
     on the CPU: coordinates within 1e-4 of their scale, KL within 5%.
 17. profile: device time by kernel and the device's idle share over one
     sample batch, one reconstruct batch, one training step of each stage,
     one FCN step and one 32-series ROCKET featurisation (torch.profiler).

The last lines are a JSON list of the kernels with their numbers, the card's
``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero before that line. Without a card, or copied out of
a checkout (the package does not import), it exits 1 at once.
"""

import contextlib
import csv
import dataclasses
import functools
import io
import json
import os
import re
import shlex
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.client import HTTPConnection

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
# M = 27 or 108 tokens a series times 16 (a stage-2 batch), 32 (serving,
# stage 1) or 64 (the stage-2 sweep); then the K sweep; then the quality
# run's geometry (L=512, hid_dim 64: 24 and 96 tokens a series) at 32 (its
# stage-1 step and x' sweep) and 64 (its token sweep and reconstruct)
KERNEL_SHAPES = [(432, 32, 128), (864, 32, 128), (1728, 32, 128), (3456, 32, 128),
                 (6912, 32, 128), (3456, 512, 128), (3456, 2048, 128),
                 (768, 32, 64), (1536, 32, 64), (3072, 32, 64), (6144, 32, 64)]
CHECK_SHAPES = KERNEL_SHAPES + [(865, 33, 20)]  # a ragged shape: 4-byte copies, padded dims
MAIN_SHAPE = (3456, 32, 128)  # the HF call of a 32-batch, the larger of the two per batch
B, C, L, N_CLASSES = 32, 4, 4633, 5
TRAIN_STEPS, TRAIN_SERIES = 30, 320
STAGE2_STEPS, STAGE2_WARMUP, SWEEP_BATCH = 120, 20, 64
STAGE3_STEPS, STAGE3_WARMUP, XPRIME_BATCH = 60, 20, 32
FCN_STEPS, FCN_WARMUP = 45, 10
ROCKET_KERNELS, EVAL_SERIES, EVAL_TAUS = 1000, 64, (0.5, 1.0)
# the JAX evaluate CLI's image names (tvqvae_tpu/scripts/evaluate.py), one
# conditional grid a class besides, and its result names
JAX_EVAL_IMAGES = ("visual_inspection.png", "pca_test_gen.png", "tsne_test_gen.png",
                   "visual_inspection_fe.png", "pca_test_gen_fe.png")
JAX_EVAL_KEYS = ("FID", "FID_rec", "MDD", "ACD", "SD", "KD", "IS_mean", "IS_std", "FID with FE",
                 "MDD with FE", "ACD with FE", "SD with FE", "KD with FE", "IS_mean with FE",
                 "IS_std with FE", "FID_svq")
# the schedule lengths of the small card-vs-CPU checks, apart from the depths
# above: their float64-witnessed bounds were set at these learning rates
SMALL_STEPS, SMALL_FCN_STEPS = 40, 60
VQ_KERNELS = ("assign_kernel", "merge_stats_kernel", "final_kernel")  # csrc/vq_nearest.cu
CONV_OPS = ("aten::cudnn_convolution", "aten::cudnn_convolution_transpose",
            "aten::convolution_backward")
# the production recipe of the JAX train CLI under --bf16 (its defaults:
# fast_bn, bf16_mu, bf16_head); the bound JAX holds its own bfloat16 decode
# to against float32 (tests/test_bf16_decode.py), which the port's holds at
# the published width with trained-like BatchNorm statistics
# (tests/test_torch_published_width.py); and the bound for phase 4's seeded
# weights, whose BatchNorms keep their identity statistics and so do not
# normalise the random stacks: JAX's own bfloat16 decode of those weights
# lies 0.300 (LF) and 0.111 (HF) of scale from its float32 one, the port's
# on the CPU 0.245 and 0.129 (tests/test_torch_published_width.py), and
# published_width_check holds the card's gap to the CPU's
PRODUCTION = dict(compute_dtype="bfloat16", fast_bn=True, bf16_mu=True, bf16_head=True)
BF16_STACK, BF16_PUBLISHED = 0.06, 0.30
BF16_TRAIN_STEPS, BF16_STAGE3_STEPS, BF16_TIMED_STEPS = 20, 10, 4
# [ess]: the small model's LF steps (a moving-average window of 2), the
# published-width batches timed; [quality]: the quality run's cut budgets
# and its number of series scored
ESS_SMALL_T, ESS_BATCHES = 8, 4
QUALITY_STEPS, QUALITY_EVAL = {"stage1": 10, "stage2": 20, "stage3": 5}, 64
# [flyability]: FLY_PAIRS generated tracks of L points along the EHAM -> LIMC
# great circle, each with a "flown" counterpart shaped like a 10-s BlueSky log
# (every FLY_STRIDE-th point, ~0.005 deg of noise): the (5120, 1024) bucket;
# FLY_LONG_PAIRS more at full length in both, the (5120, 5120) bucket. The
# DP kernel is held to its plain version on FLY_CHECK_PAIRS pairs of the
# first bucket, the Frechet kernel on FLY_CHECK_PAIRS pairs of exactly
# FLY_FRECHET_SHAPE points (the plain Frechet at full length takes minutes).
# More checks reach the launch plans of the full-length buckets that those
# shapes do not: each kernel's plan of each bucket of the batch (the
# Frechet's depth, candidates a block, elements a thread and block size; the
# DP's warps a block and cluster), on the bucket's pairs cut to
# FLY_BRANCH_ROWS (the Frechet) or FLY_DP_BRANCH_ROWS (the DP: past two
# turns of a strip's 128-row hand-off ring, so that it wraps and its
# producer waits on the reader) of p's points; the plain versions' cost
# grows with the rows.
FLY_PAIRS, FLY_LONG_PAIRS, FLY_STRIDE, FLY_CHECK_PAIRS = 64, 2, 8, 2
FLY_FRECHET_SHAPE = (1024, 512)
FLY_BRANCH_ROWS, FLY_DP_BRANCH_ROWS = 64, 300
# fp32 operations per grid cell, a transcendental counted as one: the cost
# (planar: 2 sub, 2 mul, 2 add, sqrt; spherical: 2 sub, 2 halvings, 2 sin, 2
# squares, 2 mul, add, 2 clamps, sqrt, asin, mul) and each recurrence. The
# Frechet: at each cell that a decision reaches, the eps-dependent part of its
# two free intervals (disc: sub, div, add; its sign; the root; lo and hi:
# sub, add and two clamps: 9 each) and the update (two emptiness tests, a
# max, the top's test, two caps' tests, a max: 7); once a cell for all 30
# decisions, the eps-invariant part (w: 2 sub; w.w and w.d: 2 mul and an add
# each; t0: div; t0^2: mul: 10 each). The segments' terms (once a row or a
# column) and the boundary edges are left out.
DP_COST_OPS = {"euclidean": 7, "spherical": 16}
DP_STEP_OPS = {"dtw": 3, "erp": 5, "edr": 6, "lcss": 4, "discret_frechet": 3}
FRECHET_STEP_OPS, FRECHET_CELL_OPS = 2 * 9 + 7, 2 * 10
FLY_KERNELS = ("traj_dp_kernel", "frechet_kernel")  # csrc/traj_dp.cu, csrc/frechet_decision.cu
# [preprocess]: (a) the OpenSky CLI on PREP_CORRIDORS corridors of
# PREP_PER_CORRIDOR flights of ~PREP_POINTS points each (the published
# EHAM->LIMC length), two flights an aircraft PREP_GAP_H hours apart; (b) the
# mixture at the published dataset's clustering geometry: 6592 flights
# (5932 train + 660 test, BASELINE.md), 2 x 1000 resampled coordinates, 5
# components; (c) the same module on the card and on the CPU at PREP_CHECK.
PREP_CORRIDORS, PREP_PER_CORRIDOR, PREP_POINTS, PREP_GAP_H = 5, 20, 4633, 8.0
PREP_GMM, PREP_CHECK = (6592, 2000, 5), (512, 400, 5)
# [import]: the stage-3 file's nonzero tau buffer; [analysis]: a dataset of
# ANALYSIS_SERIES series at ANALYSIS_L (its 10% test split above 512 rows) and
# ANALYSIS_GEN generated ones, so the joint t-SNE embeds 2 x 512 points, with
# ANALYSIS_KERNELS ROCKET kernels (the FID's Schur trace at 500 features)
IMPORT_TAU = 0.5
ANALYSIS_SERIES, ANALYSIS_L, ANALYSIS_GEN, ANALYSIS_KERNELS = 5200, 256, 512, 250
FP64_TC_FLOPS = 67e12  # H100 SXM float64 on the tensor cores

# The JAX package's test stub for the BlueSky simulator
# (tests/test_flyability.py:35-68): replays each flight's waypoints with a
# fixed offset and writes an EVALLOG log into $STUB_LOGS_DIR.
BLUESKY_STUB = """\
#!/usr/bin/env python3
import os, re, sys, time

scen = sys.argv[sys.argv.index("--scenfile") + 1]
logs_dir = os.environ["STUB_LOGS_DIR"]
flights = {}
with open(scen) as f:
    for line in f:
        m = re.search(r">PCALL (.*output_(.*)\\.scn)", line.strip())
        if m:
            flights[m.group(2)] = m.group(1)
rows = []
for fid, path in flights.items():
    wpts = []
    with open(path) as f:
        for line in f:
            m = re.search(r">CRE \\S+ \\S+ ([-\\d.]+) ([-\\d.]+)", line)
            if m:
                wpts.append((float(m.group(1)), float(m.group(2)), 10000.0))
            m = re.search(r">DEFWPT \\S+?,([-\\d.]+), ([-\\d.]+)", line)
            if m:
                wpts.append((float(m.group(1)), float(m.group(2)), 10000.0))
    for k, (lat, lon, alt) in enumerate(wpts):
        rows.append(f"{k * 10.0},{lat + 0.001},{lon - 0.001},{alt},{fid}")
os.makedirs(logs_dir, exist_ok=True)
out = os.path.join(logs_dir, f"EVALLOG_{time.time_ns()}.log")
with open(out, "w") as f:
    f.write("# stub log\\n")
    f.write("\\n".join(rows) + "\\n")
"""
SMALL_CFG = {
    "encoder": {"init_dim": 4, "hid_dim": 16, "n_resnet_blocks": 1,
                "downsampled_width": {"lf": 4, "hf": 8}},
    "decoder": {"n_resnet_blocks": 1},
    "VQ-VAE": {"n_fft": 4, "codebook_sizes": {"lf": 8, "hf": 8}},
    "MaskGIT": {"T": {"lf": 3, "hf": 1},
                "prior_model_l": {"hidden_dim": 16, "n_layers": 2, "heads": 2},
                "prior_model_h": {"hidden_dim": 8, "n_layers": 1, "heads": 1}},
    "fidelity_enhancer": {"dim": 8, "dim_mults": [1, 2], "resnet_block_groups": 4},
}


# ---------------------------------------------------------------------------
# reference-layout (SynthAIr/T-VQ-VAE-TrajGen) checkpoints from port modules:
# the inverse of tvqvae_tpu_torch/utils/import_reference.py, key for key, so
# that [import] feeds the import CLI the files a reference user has


def _renamed(module, rename, prefix, reshape=None):
    """``module``'s state dict with each key's leading parts renamed by the
    longest matching prefix of ``rename`` {port prefix: reference prefix},
    under ``prefix``; ``reshape`` {leaf: shape} gives the reference's shape
    of a leaf (Snake's ``a``, ChanLayerNorm's ``g``)."""
    out = {}
    for key, v in module.state_dict().items():
        top = max((p for p in rename if key == p or key.startswith(p + ".")), key=len)
        ref = rename[top] + key[len(top):]
        leaf = key.rsplit(".", 1)[-1]
        v = v.detach().cpu().clone()
        if reshape and leaf in reshape:
            v = v.reshape(reshape[leaf])
        out[prefix + ref] = v
    return out


_STAGE1_BLOCKS = {
    "EncBlock2d": {"Conv_0": "block.0", "BatchNorm_0": "block.1", "Snake_0": "block.2"},
    "DecBlock2d": {"ConvTranspose2dTorch_0": "block.0", "BatchNorm_0": "block.1",
                   "Snake_0": "block.2"},
    "ResBlock2d": {"Snake_0": "convs.0", "Conv_0": "convs.1", "BatchNorm_0": "convs.2",
                   "Snake_1": "convs.3", "Conv_1": "convs.4", "Conv_2": "proj"},
}


def reference_stage1_sd(model, vq_l, vq_h) -> dict:
    """A port ``Stage1Model`` and its codebooks -> the reference stage-1
    LightningModule's state dict: ``{encoder,decoder}_{l,h}.{encoder,decoder}.{i}``
    by Sequential index, ``decoder_{l,h}.linear`` (the TimeHead) and
    ``vq_model_{l,h}._codebook.*``."""
    sd = {}
    for band, vq in (("l", vq_l), ("h", vq_h)):
        for part in ("encoder", "decoder"):
            stack = getattr(model, f"{part}_{band}")
            for i, (name, block) in enumerate(stack.named_children()):
                kind = name.rsplit("_", 1)[0]
                rename = {k: f"{i}.{v}" for k, v in _STAGE1_BLOCKS.get(kind, {}).items()}
                if kind == "ConvTranspose2dTorch":  # the decoder's bare tail convs
                    sd.update({f"{part}_{band}.{part}.{i}.{k}": v.detach().cpu().clone()
                               for k, v in block.state_dict().items()})
                    continue
                sd.update(_renamed(block, rename, f"{part}_{band}.{part}.",
                                   {"a": (1, -1, 1, 1)}))
        sd.update(_renamed(getattr(model, f"head_{band}"), {"Dense_0": f"decoder_{band}.linear"},
                           ""))
        for f in ("embed", "embed_avg", "cluster_size"):
            sd[f"vq_model_{band}._codebook.{f}"] = getattr(vq, f).detach().cpu().clone()
        sd[f"vq_model_{band}._codebook.initted"] = vq.initted.detach().cpu().reshape(1).float()
    return sd


def reference_prior_sd(prior) -> dict:
    """A port ``BidirectionalTransformer`` (RMSNorm, as the published
    priors) -> the reference prior's state dict in the newer x-transformers
    naming (a ContinuousTransformerWrapper with project_in/out,
    ``layers.{i}.0.0.g`` norm slots, ``ff.0.0``/``ff.2``, a bare ``to_out``)."""
    rename = {"logit_bias": "bias", "class_emb": "class_condition_emb",
              "projector.Conv_0": "projector.conv.0", "projector.BatchNorm_0": "projector.conv.2",
              "projector.Conv_1": "projector.conv.3", "project_in": "blocks.project_in",
              "project_out": "blocks.project_out", "post_emb_norm": "blocks.post_emb_norm",
              "pred_head": "pred_head.0", "pred_norm": "pred_head.2",
              "tok_emb_l": "tok_emb_l", "tok_emb_h": "tok_emb_h", "pos_emb": "pos_emb"}
    al = "blocks.attn_layers"
    for j in range(sum(1 for c, _ in prior.named_children() if c.startswith("block_"))):
        a, f = f"{al}.layers.{2 * j}", f"{al}.layers.{2 * j + 1}"
        rename.update({f"block_{j}.RMSNorm_0.weight": f"{a}.0.0.g",
                       f"block_{j}.Dense_0": f"{a}.1.to_q", f"block_{j}.Dense_1": f"{a}.1.to_k",
                       f"block_{j}.Dense_2": f"{a}.1.to_v", f"block_{j}.Dense_3": f"{a}.1.to_out",
                       f"block_{j}.RMSNorm_1.weight": f"{f}.0.0.g",
                       f"block_{j}.Dense_4": f"{f}.1.ff.0.0", f"block_{j}.Dense_5": f"{f}.1.ff.2"})
    rename["RMSNorm_0.weight"] = f"{al}.final_norm.g"
    return _renamed(prior, rename, "")


def reference_stage2_sd(t_l, t_h) -> dict:
    """Both priors -> a stage-2 LightningModule's state dict
    (``maskgit.transformer_{l,h}.*``)."""
    sd = {}
    for name, prior in (("transformer_l", t_l), ("transformer_h", t_h)):
        sd.update({f"maskgit.{name}.{k}": v for k, v in reference_prior_sd(prior).items()})
    return sd


def _fe_names(n_stages: int) -> dict:
    """Port ``Unet1D_0`` prefix -> the reference Unet1D's state-dict prefix,
    as ``import_reference.fe_from_state_dict`` walks it."""
    out = {"Conv_0": "unet.init_conv"}
    inner = {"UnetBlock_0": "block1", "UnetBlock_1": "block2", "WSConv1d_0": "proj",
             "GroupNorm_0": "norm", "Snake_0": "act", "Conv_0": "res_conv"}

    def resnet(port, ref):
        for a, b in inner.items():
            out[f"{port}.{a}"] = f"{ref}.{b}"
        for u in ("UnetBlock_0", "UnetBlock_1"):
            for a in ("WSConv1d_0", "GroupNorm_0", "Snake_0"):
                out[f"{port}.{u}.{a}"] = f"{ref}.{inner[u]}.{inner[a]}"

    def stage(ref, res, pre, attn, conv, conv_key, linear=True):
        resnet(f"ResnetBlock1d_{res}", f"{ref}.0")
        resnet(f"ResnetBlock1d_{res + 1}", f"{ref}.1")
        out[f"_PreNormResidual_{pre}.ChanLayerNorm_0"] = f"{ref}.2.fn.norm"
        out[f"{attn}.Conv_0"] = f"{ref}.2.fn.fn.to_qkv"
        out[f"{attn}.Conv_1"] = f"{ref}.2.fn.fn.to_out" + (".0" if linear else "")
        if linear:
            out[f"{attn}.ChanLayerNorm_0"] = f"{ref}.2.fn.fn.to_out.1"
        out[f"Conv_{conv}"] = f"{ref}.{conv_key}"

    n = n_stages
    for i in range(n):
        stage(f"unet.downs.{i}", 2 * i, i, f"LinearAttention1d_{i}", i + 1, "3")
    resnet(f"ResnetBlock1d_{2 * n}", "unet.mid_block1")
    out[f"_PreNormResidual_{n}.ChanLayerNorm_0"] = "unet.mid_attn.fn.norm"
    out["Attention1d_0.Conv_0"] = "unet.mid_attn.fn.fn.to_qkv"
    out["Attention1d_0.Conv_1"] = "unet.mid_attn.fn.fn.to_out"
    resnet(f"ResnetBlock1d_{2 * n + 1}", "unet.mid_block2")
    for j in range(n):
        stage(f"unet.ups.{j}", 2 * n + 2 + 2 * j, n + 1 + j, f"LinearAttention1d_{n + j}",
              n + 1 + j, "3.1" if j < n - 1 else "3")
    out[f"Conv_{2 * n + 1}"] = "unet.last_up.1"
    resnet(f"ResnetBlock1d_{4 * n + 2}", "unet.final_res_block")
    for k in range(3):
        out[f"Conv_{2 * n + 2 + k}"] = f"unet.final_conv.{k}"
    return out


def reference_stage3_sd(fe, tau: float) -> dict:
    """A port ``FidelityEnhancer`` and its tau -> a stage-3 LightningModule's
    state dict: ``fidelity_enhancer.unet.*`` and the ``fidelity_enhancer.tau``
    buffer."""
    n_stages = sum(1 for c, _ in fe.Unet1D_0.named_children()
                   if c.startswith("LinearAttention1d_")) // 2
    sd = _renamed(fe.Unet1D_0, _fe_names(n_stages), "fidelity_enhancer.",
                  {"a": (1, -1, 1), "g": (1, -1, 1)})
    sd["fidelity_enhancer.tau"] = np.float32(tau) * np.ones(1, np.float32)
    return sd


def reference_fcn_sd(fcn) -> dict:
    """A port ``FCN`` -> the reference ``FCNBaseline.state_dict()``
    (``layers.{i}.layers.{0: conv, 1: bn}``, ``final``)."""
    rename = {f"{kind}_{i}": f"layers.{i}.layers.{j}" for i in range(3)
              for kind, j in (("Conv", 0), ("BatchNorm", 1))}
    return _renamed(fcn, {**rename, "Dense_0": "final"}, "")


def write_reference_ckpts(torch, out_dir, model, vq_l, vq_h, t_l, t_h, fe, tau, fcn) -> dict:
    """``torch.save`` the four reference checkpoints into ``out_dir``: the
    stages as Lightning checkpoints (``state_dict``, ``hyper_parameters``,
    the stage-3 file with frozen stage-2 keys the importer must skip), the
    FCN as a raw state dict. -> {stage: path}."""
    os.makedirs(out_dir, exist_ok=True)
    s3 = reference_stage3_sd(fe, tau)
    s3["fidelity_enhancer.tau"] = torch.from_numpy(s3["fidelity_enhancer.tau"])
    s3["maskgit.transformer_l.bias"] = torch.zeros(2, 3)  # frozen stage-2 keys: ignored
    files = {"stage1": reference_stage1_sd(model, vq_l, vq_h),
             "stage2": reference_stage2_sd(t_l, t_h), "stage3": s3}
    paths = {}
    for name, sd in files.items():
        paths[name] = os.path.join(out_dir, f"{name}.ckpt")
        torch.save({"state_dict": sd, "hyper_parameters": {"stage": name}, "epoch": 0,
                    "global_step": 0, "pytorch-lightning_version": "2.4.0"}, paths[name])
    paths["fcn"] = os.path.join(out_dir, "fcn.ckpt")
    torch.save(reference_fcn_sd(fcn), paths["fcn"])
    return paths


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def time_ms(torch, fn, iters=100, warmup=10):
    """Mean ms per call over back-to-back calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def vq_bound(M, K, D):
    """Least time for one nearest_codes_stats call: inputs read once, outputs
    written once, and the fp32 work of distances, argmax and the sums."""
    nbytes = 4 * (M * D + K * D + M + K + K * D)
    flops = 2 * M * K * D + 3 * M * K + 2 * (M + K) * D + M * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


VQ_TIE_CAP = 1e-3  # share of the compared tokens that may differ, all at near-ties
VQ_TIE_ROWS = 8  # differing rows printed in full


def vq_tie_bounds(flat, embed):
    """(M, K) float64 distances d = 2<x, e> - |x|^2 - |e|^2 of the float32
    rows and codes, and the forward-error bound b of one float32 evaluation
    of each.

    Either side (the kernel's FFMA sums, the plain twin's cuBLAS product and
    torch sums, TF32 off) evaluates d in float32 as fl(fl(2 s - x2) - e2)
    with s = <x, e>, x2 = |x|^2 and e2 = |e|^2 each a sum of D products, in
    any order, with or without FMA. Each product x_i e_i, x_i^2 or e_i^2
    then carries at most D roundings in its sum and two in the last two
    subtractions (the factor 2 is exact), so with u = 2^-24

        |d^ - d| <= gamma_{D+2} sum_i (2 |x_i e_i| + x_i^2 + e_i^2)
                 <= gamma_{D+2} (|x| + |e|)^2        (Cauchy-Schwarz).

    The float64 distance errs by the same form with u = 2^-53, added in, so
    b = (gamma_{D+2}(2^-24) + gamma_{D+2}(2^-53)) (|x| + |e|)^2 bounds both
    sides' errors from the float64 value d64. A side that picks code a over
    code c has d^(a) >= d^(c), so d64(c) - d64(a) <= b(a) + b(c): two sides
    that pick a and c, each rounding correctly, leave |d64(a) - d64(c)| <=
    b(a) + b(c), and each side's code lies within that of the float64
    nearest code k*: d64(k*) - d64(a) <= b(k*) + b(a)."""
    x, e = flat.double(), embed.double()
    xn, en = x.norm(dim=1), e.norm(dim=1)
    d = 2.0 * (x @ e.T) - (x * x).sum(1, keepdim=True) - (e * e).sum(1)[None, :]
    n = flat.shape[1] + 2
    gamma = sum(n * u / (1 - n * u) for u in (2.0 ** -24, 2.0 ** -53))  # Higham's gamma_n
    return d, gamma * (xn[:, None] + en[None, :]) ** 2


def vq_near_ties(calls, cap=VQ_TIE_CAP):
    """Hold two assignments of the same float32 rows to the near-tie rule.

    ``calls``: (flat, embed, idx_a, idx_b) of each call, the two index
    vectors computed from these very tensors (one latent, two assignment
    functions). A row whose codes differ passes only when (1) the float64
    gap of its two codes' distances is within b(a) + b(c), the bound of
    ``vq_tie_bounds``, and (2) the float64 nearest code is one of the two
    or within that bound of both; and (3) all the differing rows are at
    most ``cap`` of the rows compared, so that a kernel slightly but
    systematically wrong still fails. -> {"compared", "differing",
    "max_ratio" (the largest gap / bound over the differing rows, 0 with
    none), "within_bound" (rows whose float64 best two codes lie within the
    bound: the rows where two correct sides may differ), "rows" (the first
    ``VQ_TIE_ROWS`` differing rows: |x|, codes, float64 distances, ratio),
    "bad" (rows failing (1) or (2))}; ``check`` fails on any bad row or
    above the cap."""
    out = {"compared": 0, "differing": 0, "max_ratio": 0.0, "within_bound": 0, "rows": [],
           "bad": 0}
    for flat, embed, idx_a, idx_b in calls:
        a, c = idx_a.long().flatten(), idx_b.long().flatten()
        out["compared"] += a.numel()
        d, b = vq_tie_bounds(flat, embed)
        if d.shape[1] > 1:
            top = d.topk(2, dim=1)
            pair_b = b.gather(1, top.indices)
            out["within_bound"] += int(((top.values[:, 0] - top.values[:, 1])
                                        <= pair_b.sum(1)).sum())
        rows = (a != c).nonzero().flatten()
        if not len(rows):
            continue
        out["differing"] += len(rows)
        da, dc = d[rows, a[rows]], d[rows, c[rows]]
        ba, bc = b[rows, a[rows]], b[rows, c[rows]]
        ratio = (da - dc).abs() / (ba + bc)
        best = d[rows].argmax(1)
        dk, bk = d[rows, best], b[rows, best]
        nearest = ((best == a[rows]) | (best == c[rows])
                   | ((dk - da <= bk + ba) & (dk - dc <= bk + bc)))
        out["bad"] += int((~((ratio <= 1.0) & nearest)).sum())
        out["max_ratio"] = max(out["max_ratio"], float(ratio.max()))
        norms = flat[rows].double().norm(dim=1)
        for i in range(min(len(rows), VQ_TIE_ROWS - len(out["rows"]))):
            out["rows"].append({"row": int(rows[i]), "norm": float(norms[i]),
                                "codes": (int(a[rows[i]]), int(c[rows[i]])),
                                "d64": (float(da[i]), float(dc[i])),
                                "nearest": int(best[i]), "ratio": float(ratio[i])})
    check(out["bad"] == 0, f"{out['bad']} of {out['differing']} differing tokens lie beyond "
                           f"float32 rounding (largest gap/bound {out['max_ratio']:.3g}): "
                           f"a fault of the kernel; rows {out['rows']}")
    check(out["differing"] <= cap * out["compared"],
          f"{out['differing']} of {out['compared']} tokens differ, above the near-tie cap "
          f"{cap}; rows {out['rows']}")
    return out


class AssignTape:
    """An assignment function (``nearest_codes_stats``'s signature) that
    records each call's (flat, embed, idx), so that the rows one side saw
    can be handed to the other side's function too."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, flat, embed):
        out = self.fn(flat, embed)
        self.calls.append((flat.detach().clone(), embed.detach().clone(), out[0].clone()))
        return out


def same_latent_ties(torch, vq_kernel, kernel_tape, plain_tape, where):
    """The near-tie rule on one latent: each call the kernel side recorded,
    its indices against the plain twin's on the same tensors. Prints whether
    the plain side's own run saw the same latents bit for bit (when not, the
    two runs' tokens may differ for that reason alone, which the rule then
    does not cover), and the rule's line. -> ``vq_near_ties``' result."""
    kc, pc = kernel_tape.calls, plain_tape.calls
    same = len(kc) == len(pc) and all(
        torch.equal(fk, fp) and torch.equal(ek, ep) for (fk, ek, _), (fp, ep, _) in zip(kc, pc))
    if same:
        calls = [(f, e, ik, ip) for (f, e, ik), (_, _, ip) in zip(kc, pc)]
    else:
        gap = max((float((fk - fp).abs().max()) for (fk, _, _), (fp, _, _) in zip(kc, pc)
                   if fk.shape == fp.shape), default=float("nan"))
        print(f"{where} finding: the plain twin's run saw other latents than the kernel's "
              f"({len(kc)} vs {len(pc)} calls, largest latent gap {gap:.3g}); the rule below "
              f"compares both functions on the kernel run's latents", flush=True)
        calls = [(f, e, ik, vq_kernel.nearest_codes_stats_plain(f, e)[0]) for f, e, ik in kc]
    ties = vq_near_ties(calls)
    rows = "".join(f"; row {r['row']} |x| {r['norm']:.4g} codes {r['codes']} d64 "
                   f"({r['d64'][0]:.9g}, {r['d64'][1]:.9g}) nearest {r['nearest']} "
                   f"gap/bound {r['ratio']:.3g}" for r in ties["rows"])
    print(f"{where} kernel vs plain VQ twin on one latent (bit-equal latents in both runs: "
          f"{same}): {ties['differing']} of {ties['compared']} tokens differ (cap "
          f"{int(VQ_TIE_CAP * ties['compared'])}), largest gap/bound {ties['max_ratio']:.3g}, "
          f"{ties['within_bound']} rows with their best two codes within the bound{rows}",
          flush=True)
    return ties


def kernel_names(events):
    """Device time per kernel name (us) and launches, from profiler events."""
    by_name = {}
    for name, d in events:
        m = re.search(r"(\w+_kernel(?:<.*>)?)\(", name.replace("(anonymous namespace)::", ""))
        key = m.group(1) if m else name[:60]
        n, t = by_name.get(key, (0, 0.0))
        by_name[key] = (n + 1, t + d)
    return by_name


def kernel_device_ms(torch, vq_kernel, inputs, iters=20):
    """{shape: {kernel name: (launches, device ms) per call}} of ``iters``
    calls at each shape of ``inputs`` ({shape: (flat, embed)}), from one
    profiler session: each shape's calls sit in a ``record_function`` range
    that starts with a 5 ms pause and ends with a synchronise, and a device
    event belongs to the last range that started before it (the pause
    absorbs an offset between the host's and the device's clocks)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for shape, (flat, embed) in inputs.items():
            with record_function(f"vq_calls {shape}"):
                time.sleep(0.005)
                for _ in range(iters):
                    vq_kernel.nearest_codes_stats(flat, embed)
                torch.cuda.synchronize()
    events = prof.events()
    starts = {e.name: e.time_range.start for e in events if e.name.startswith("vq_calls ")
              and e.device_type == DeviceType.CPU}
    order = sorted((starts[f"vq_calls {shape}"], shape) for shape in inputs
                   if f"vq_calls {shape}" in starts)
    mine = {shape: [] for shape in inputs}
    for e in events:
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        owner = [shape for start, shape in order if start <= e.time_range.start]
        if owner:
            mine[owner[-1]].append((e.name, e.time_range.end - e.time_range.start))
    return {shape: {k: (n / iters, t / 1e3 / iters) for k, (n, t) in kernel_names(ev).items()}
            for shape, ev in mine.items()}


def kernel_phase(torch, vq_kernel):
    """The VQ kernel against its plain version at every shape of CHECK_SHAPES;
    at KERNEL_SHAPES also its time (events), device time per kernel per call
    (profiler), the bound, and the times of the plain version, of
    cdist+argmin and of the fp32 product flat @ embed.T alone."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    results, inputs, lines = {}, {}, {}
    for M, K, D in CHECK_SHAPES:
        flat = torch.randn(M, D, device="cuda", generator=gen)
        embed = torch.randn(K, D, device="cuda", generator=gen)
        idx, cnt, es = vq_kernel.nearest_codes_stats(flat, embed)
        torch.cuda.synchronize()
        p_idx, _, _ = vq_kernel.nearest_codes_stats_plain(flat, embed)
        dist = 2.0 * (flat @ embed.T) - (flat * flat).sum(-1, keepdim=True) - (embed * embed).sum(-1)
        rows = torch.nonzero(idx != p_idx).flatten()
        d_k = dist[rows, idx[rows].long()]
        d_p = dist[rows, p_idx[rows].long()]
        near = (d_k - d_p).abs() <= 1e-5 * d_p.abs().clamp_min(1e-30)
        check(bool(near.all()), f"kernel idx differs from plain beyond ties at {(M, K, D)}")
        # the statistics of the kernel's own assignment, computed plainly; the
        # row sums in float64 (exact here), and the kernel's float32 sums held
        # to the rounding bound of any order of n additions: (n-1) 2^-24 sum|x|
        r_cnt = torch.bincount(idx.long(), minlength=K).float()
        check(torch.equal(cnt, r_cnt), f"counts differ at {(M, K, D)}")
        r_es, abs_sum = (torch.zeros(K, D, dtype=torch.float64, device="cuda")
                         .index_add_(0, idx.long(), v.double()) for v in (flat, flat.abs()))
        bound = (r_cnt.double() - 1).clamp_min(0)[:, None] * 2.0 ** -24 * abs_sum
        err = float((es.double() - r_es).abs().max())
        check(bool(((es.double() - r_es).abs() <= bound).all()),
              f"embed_sum off by {err} at {(M, K, D)}, beyond float32 rounding")
        line = (f"[kernel] vq_nearest_stats M={M} K={K} D={D}: idx rows off {len(rows)} "
                f"(near-ties {int(near.sum())}), embed_sum err {err:.3g}")
        if (M, K, D) not in KERNEL_SHAPES:
            print(line + " (correctness only)", flush=True)
            continue

        ms = time_ms(torch, lambda: vq_kernel.nearest_codes_stats(flat, embed))
        plain_ms = time_ms(torch, lambda: vq_kernel.nearest_codes_stats_plain(flat, embed))
        lib_ms = time_ms(torch, lambda: torch.cdist(flat, embed).argmin(-1))
        mm_ms = time_ms(torch, lambda: flat @ embed.T)  # cuBLAS fp32: the distances' product alone
        bound_ms, bound_by = vq_bound(M, K, D)
        results[(M, K, D)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                  bound_ms=bound_ms, bound_by=bound_by)
        inputs[(M, K, D)] = (flat, embed)
        lines[(M, K, D)] = (f"{line}, {ms:.4f} ms/call, plain {plain_ms:.4f} ms, bound "
                            f"{bound_ms:.5f} ms ({bound_by}), library_ms {lib_ms:.4f} (cdist+argmin: "
                            f"idx only), fp32 matmul alone {mm_ms:.4f} ms")
    for shape, by_kernel in kernel_device_ms(torch, vq_kernel, inputs).items():
        device_ms = sum(t for _, t in by_kernel.values()) or None
        results[shape]["device_ms"] = device_ms
        split = ", ".join(f"{k} {t:.5f} ms x{n:g}" for k, (n, t) in by_kernel.items())
        print(f"{lines[shape]}; device ms per call "
              f"{device_ms if device_ms is None else f'{device_ms:.5f}'}: "
              f"{split or 'not measured'}", flush=True)
    return results


def serving_phase(sampler):
    from tvqvae_tpu_torch.serving import GenerationService

    svc = GenerationService(sampler, features=["latitude", "longitude", "altitude", "timedelta"])
    srv = make_server_thread(svc)
    try:
        port = srv.server_address[1]
        for body, n, labels in (({"n": 4, "seed": 1}, 4, [-1] * 4),
                                ({"n": 3, "class_index": 2}, 3, [2] * 3),
                                ({"class_counts": {"0": 2, "4": 1}}, 3, [0, 0, 4])):
            t0 = time.perf_counter()
            conn = HTTPConnection("127.0.0.1", port, timeout=300)
            conn.request("POST", "/v1/generate", body=json.dumps(body).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            out = json.loads(resp.read())
            conn.close()
            check(resp.status == 200, f"server answered {resp.status}: {out}")
            check(out["shape"] == [n, C, L] and out["y"] == labels, f"bad response to {body}")
            check(bool(np.isfinite(np.asarray(out["X"])).all()), "non-finite response")
            print(f"[serve] {json.dumps(body)} -> {out['shape']} in "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
    finally:
        stop_server(srv)

class Work:
    """The run's files under one temp directory: the synthetic dataset and,
    as the train CLI lays them out, ``models/<dataset stem>/stage{1,2,3}``
    and ``fcn``."""

    def __init__(self, root):
        self.root = root
        self.dataset = os.path.join(root, "trajectories.npz")
        self.models = os.path.join(root, "models")
        ckpt = os.path.join(self.models, "trajectories")
        self.stage = {s: os.path.join(ckpt, f"stage{s}") for s in ("1", "2", "3")}
        self.stage["fcn"] = os.path.join(ckpt, "fcn")


def cli_subprocess(work, script, cli_args, code=None):
    """``python -m tvqvae_tpu_torch.scripts.<script>`` (or ``python -c
    code`` with the same arguments) over the run's dataset and written
    checkpoints, started in the background."""
    repo = os.path.dirname(os.path.abspath(__file__))
    # its host work is file reads and numpy; two threads leave the cores to
    # the card-vs-CPU checks that run beside it
    env = {**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "2"}
    head = ["-c", code] if code else ["-m", f"tvqvae_tpu_torch.scripts.{script}"]
    cmd = [sys.executable, *head, "--dataset_file", work.dataset, "--model_save_dir",
           work.models, *cli_args]
    return subprocess.Popen(cmd, cwd=repo, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def generate_subprocess(work, cli_args):
    """The generate CLI (64 series, raw and enhanced) in the background."""
    return cli_subprocess(work, "generate", [
        "--n_samples", str(2 * B), "--synthetic_save_dir", os.path.join(work.root, "synthetic"),
        "--synthetic_fidelity_dir", os.path.join(work.root, "synthetic_fe"), *cli_args])


def check_generated(proc, t0, work):
    """Wait for ``generate_subprocess`` and check its two ``.npz`` files:
    finite, original units (altitude >= 0, timedelta[:, 0] = 0)."""
    out, _ = proc.communicate(timeout=300)
    check(proc.returncode == 0, f"generate exited {proc.returncode}:\n{out[-3000:]}")
    shapes = []
    for path in (os.path.join(work.root, "synthetic", "synthetic.npz"),
                 os.path.join(work.root, "synthetic_fe", "synthetic_fe.npz")):
        z = np.load(path)
        X, y = z["X"], z["y"]
        check(X.shape[1:] == (C, L) and len(y) == len(X) and abs(len(X) - 2 * B) <= N_CLASSES,
              f"{path}: X {X.shape}, y {y.shape}")
        check(bool(np.isfinite(X).all()) and bool((X[:, 2] >= 0).all())
              and bool((X[:, 3, 0] == 0).all()), f"{path}: not finite or not in original units")
        shapes.append(X.shape)
    print(f"[ckpt] generate CLI (a subprocess): {shapes[0][0]} raw and {shapes[1][0]} enhanced "
          f"series {shapes[0][1:]} in original units, finite, altitude >= 0, timedelta[:, 0] = 0; "
          f"{time.perf_counter() - t0:.1f} s from its start", flush=True)


def ckpt_phase(torch, vq_kernel, work, trained, stage2, stage3, n_classes, step_ms,
               device="cuda", config=None):
    """The written checkpoints: each one's bytes, write and read seconds; one
    published-width stage-1 snapshot's bytes and stall; then, counted, the
    sampler built from the checkpoints (``from_checkpoints``) against the
    in-memory sampler of the same trained states with the same noise (a
    32-batch: tokens equal, series within 1e-5 of their scale; reconstruct
    of 64 series, 4 VQ launches), and one HTTP request to the service the
    serve CLI builds from disk, with the generate CLI started beside it in a
    subprocess. ``config``: a config file for ``Config()`` here and in the
    CLIs. -> (the VQ kernel launches of the counted part, (the generate
    subprocess, its start time) for ``check_generated``)."""
    from tvqvae_tpu_torch.generation import TrainedModelSampler
    from tvqvae_tpu_torch.models.maskgit import FrozenStage1, encode_tokens, iterative_decoding
    from tvqvae_tpu_torch.scripts import serve
    from tvqvae_tpu_torch.scripts._cli import load_config
    from tvqvae_tpu_torch.train.runner import train_state_payload
    from tvqvae_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint, save_train_state

    cfg = load_config(config)
    cli_args = ["--device", device, *(["--config", config] if config else [])]
    for name, path in work.stage.items():
        t0 = time.perf_counter()
        tree, meta = load_checkpoint(path)
        t_read = time.perf_counter() - t0
        t0 = time.perf_counter()
        save_checkpoint(path + ".rewrite", tree, meta)
        t_write = time.perf_counter() - t0
        size = os.path.getsize(path)
        check(os.path.getsize(path + ".rewrite") == size, f"{name}: rewritten size differs")
        os.remove(path + ".rewrite")
        os.remove(path + ".rewrite.meta.json")
        print(f"[ckpt] {os.path.basename(path)}: {size} bytes, write {t_write:.3f} s, read {t_read:.3f} s; meta "
              f"completed_step {meta.get('completed_step')}", flush=True)

    snap = os.path.join(work.root, "stage1.train")
    gen = torch.Generator(device=device).manual_seed(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_train_state(snap, train_state_payload(trained, gen))
    stall = time.perf_counter() - t0
    size = os.path.getsize(snap)
    os.remove(snap)
    interval = cfg.trainer_params.val_check_interval["stage1"]
    share = stall / (interval * step_ms / 1e3)
    print(f"[ckpt] published-width stage-1 snapshot (model, codebooks, AdamW, schedule, step, "
          f"generator): {size} bytes, stall {stall:.3f} s (device-to-host copy and write, "
          f"synchronous); {share:.4%} of a {interval}-step validation "
          f"interval at {step_ms:.2f} ms/step", flush=True)

    t_gen = time.perf_counter()
    proc = generate_subprocess(work, cli_args)
    try:
        vq_kernel.launch_count = 0
        t0 = time.perf_counter()
        disk = TrainedModelSampler.from_checkpoints(cfg, work.stage["1"], work.stage["2"],
                                                    work.stage["3"], use_fidelity_enhancer=True,
                                                    batch_size=B, device=device)
        t_build = time.perf_counter() - t0
        mem = TrainedModelSampler.__new__(TrainedModelSampler)
        mem._assemble(cfg, FrozenStage1.from_stage1_state(trained), stage2.t_l, stage2.t_h,
                      n_classes, B, torch.device(device), stage3.fe, True)
        spec = disk.mg_spec
        rng = np.random.default_rng(23)
        noise = {band: tuple(torch.from_numpy(-np.log(-np.log(rng.uniform(1e-12, 1.0, size))))
                             .float() for size in ((T, B, tok, K), (T, B, tok)))
                 for band, T, tok, K in (("l", spec.T_l, spec.tokens_l, spec.mask_token_l),
                                         ("h", spec.T_h, spec.tokens_h, spec.mask_token_h))}
        got = disk.sample(B, "conditional", class_index=2, noise=[noise])
        series = np.random.default_rng(24).normal(size=(2 * B, C, L)).astype(np.float32)
        before = vq_kernel.launch_count
        rec = disk.reconstruct(series)
        check(vq_kernel.launch_count - before == 4,
              f"reconstruct from disk launched the VQ kernel {vq_kernel.launch_count - before} times")

        parser = serve.build_argparser()
        svc = serve.build_service(parser.parse_args(
            ["--dataset_file", work.dataset, "--model_save_dir", work.models, "--use_fe",
             *cli_args]), parser)
        svc.warmup()
        srv = make_server_thread(svc)
        try:
            conn = HTTPConnection("127.0.0.1", srv.server_address[1], timeout=300)
            conn.request("POST", "/v1/generate", body=json.dumps({"n": 3, "class_index": 1}).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            out = json.loads(resp.read())
            conn.close()
        finally:
            stop_server(srv)
        check(resp.status == 200 and out["shape"] == [3, C, L] and out["postprocessed"]
              and bool(np.isfinite(np.asarray(out["X"])).all()), f"serve CLI answered {resp.status}")
        launches = vq_kernel.launch_count

        ref = mem.sample(B, "conditional", class_index=2, noise=[noise])
        with torch.inference_mode():
            toks = [iterative_decoding(spec, lambda a, c, s=s: s.t_l(a, None, c),
                                       lambda a, b, c, s=s: s.t_h(a, b, c), B, 2, device=device,
                                       noise=noise) for s in (disk, mem)]
            xb = torch.from_numpy(series).to(device)
            for band in ("lf", "hf"):
                check(torch.equal(encode_tokens(disk.frozen, xb, band),
                                  encode_tokens(mem.frozen, xb, band)),
                      f"{band} tokens of the sampler from disk differ from the in-memory one's")
        check(all(torch.equal(a, b) for a, b in zip(*toks)),
              "tokens sampled from disk differ from the in-memory sampler's")
        errs = [float(np.abs(a - b).max() / np.abs(b).max())
                for a, b in (*zip(got, ref), (rec, mem.reconstruct(series)))]
        check(max(errs) <= 1e-5, f"the sampler from disk is off the in-memory one by {errs}")
        print(f"[ckpt] from_checkpoints at the published width (with the enhancer) built in "
              f"{t_build:.2f} s; a {B}-batch against the in-memory sampler of the trained "
              f"states with the same noise: tokens equal, x_l/x_h/x/reconstruct within "
              f"{', '.join(f'{e:.3g}' for e in errs)} of their scale; reconstruct of {2 * B} "
              f"series: 4 VQ launches; serve CLI service from disk answered {out['shape']}",
              flush=True)
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    return launches, (proc, t_gen)


def small_resume_check(torch, work, k=3, device="cuda"):
    """A small stage 1 (dropout as configured) on the card for 2k steps with
    validation every k, then its checkpoint deleted and the run repeated:
    it resumes from the snapshot at step k and ends within the bounds of
    ``small_train_check`` of the straight run (losses 1e-4 relative,
    codebooks 1e-4 of 1 + |value|, parameters and BN statistics 1e-4, the
    BatchNorm-cancelled biases and running means 1e-4 + 2 * sum(lr_t))."""
    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.data import get_data, make_synthetic_trajectories, save_npz
    from tvqvae_tpu_torch.models.stage1 import Stage1Model, Stage1Spec
    from tvqvae_tpu_torch.train.runner import train_stage1
    from tvqvae_tpu_torch.utils.checkpoint import load_checkpoint
    from tvqvae_tpu_torch.utils.convert import stage1_from_jax
    from tvqvae_tpu_torch.utils.schedule import warmup_cosine_schedule

    Ls = 127
    cfg = Config.from_dict({**SMALL_CFG, "dataset": {"batch_sizes": {"stage1": 8}},
                            "trainer_params": {"val_check_interval": {"stage1": k}}})
    path = os.path.join(work.root, "small.npz")
    save_npz(path, *make_synthetic_trajectories(n=40, channels=C, length=Ls, seed=12))
    data = get_data(path, cfg.dataset.features)
    ckpt = os.path.join(work.root, "small", "stage1")
    runs = []
    for _ in range(2):
        rec = StepRecorder(torch)
        train_stage1(cfg, data, max_steps=2 * k, seed=2, logger=rec, device=device,
                     log_interval=1, save_path=ckpt)
        tree, meta = load_checkpoint(ckpt)
        runs.append(([float(v) for v in rec.losses], stage1_from_jax(tree), meta))
        os.remove(ckpt)
        os.remove(ckpt + ".meta.json")
    (ref_loss, ref, _), (dut_loss, dut, meta) = runs
    check(len(ref_loss) == 2 * k and len(dut_loss) == k and meta["completed_step"] == 2 * k,
          f"the resumed run logged {len(dut_loss)} steps, not {k}")
    loss_err = max(abs(a - b) / abs(a) for a, b in zip(ref_loss[k:], dut_loss))
    check(loss_err <= 1e-4, f"resumed stage 1: losses off by {loss_err} relative")
    noise = 2 * sum(warmup_cosine_schedule(cfg.exp_params.lr, 2 * k)(t) for t in range(2 * k))
    cancelled = biases_cancelled_by_batchnorm(Stage1Model(Stage1Spec.from_config(cfg, Ls, C)))
    cb_err, worst = check_stage1_leaves("resumed stage 1", ref, dut, cancelled, noise)
    print(f"[ckpt] small stage 1 on the card, {2 * k} steps straight against {k} + a resume + {k}: "
          f"losses {dut_loss} vs {ref_loss[k:]}, rel err {loss_err:.3g}; codebooks {cb_err:.3g}, "
          f"parameters and BN variances {worst['tight']:.3g}, BN-cancelled biases and running "
          f"means {worst['cancelled']:.3g} (bound {1e-4 + noise:.3g})", flush=True)


def make_server_thread(svc):
    from tvqvae_tpu_torch.serving import make_server

    srv = make_server(svc, "127.0.0.1", 0)
    srv.thread = threading.Thread(target=srv.serve_forever, daemon=True)
    srv.thread.start()
    return srv


def stop_server(srv):
    srv.shutdown()
    srv.server_close()
    srv.thread.join(timeout=30)
    check(not srv.thread.is_alive(), "server thread did not stop")


def device_events(torch, fn, ops=None):
    """Run fn under torch.profiler (CUPTI): profiled wall ms and the device
    events as (name, duration us), read from the profiler's raw events (the
    tree ``prof.events()`` builds costs seconds per ten thousand ops). With
    ``ops`` (a list), also append the convolution ops as (device ms, calls,
    input shapes), largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=ops is not None) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    events = [(e.name(), e.duration_ns() / 1e3) for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
              and not getattr(e, "is_hidden_event", lambda: False)()]
    if ops is not None:
        for e in prof.key_averages(group_by_input_shape=True):
            if e.key in CONV_OPS:
                ops.append((e.device_time_total / 1e3, e.count, e.key, e.input_shapes[:3]))
        ops.sort(key=lambda o: -o[0])
    return prof_ms, events


def print_profile(label, fn, wall_ms, n_convs=6):
    """Device busy time, idle share against ``wall_ms`` (the unprofiled time
    of the same work: the profiler slows the host), the top device kernels
    and (``n_convs`` > 0) the top convolutions by shape, of one call of
    ``fn``. -> the device busy ms (0 when the profiler saw none)."""
    import torch

    convs = [] if n_convs else None
    prof_ms, events = device_events(torch, fn, convs)
    if not events:
        print(f"[profile] {label}: the profiler saw no device time: not measured", flush=True)
        return 0.0
    busy_ms = sum(d for _, d in events) / 1e3
    by_name = {}
    for name, d in events:
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + d)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    vq = [d for name, d in events if any(k in name for k in VQ_KERNELS)]
    print(f"[profile] {label}: device busy {busy_ms:.2f} ms over {len(events)} device events; "
          f"unprofiled wall {wall_ms:.2f} ms, idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}; "
          f"profiled wall {prof_ms:.2f} ms; VQ kernel {sum(vq) / 1e3:.4f} ms in {len(vq)} device "
          f"kernels ({sum(vq) / 1e3 / busy_ms:.3%} of busy)", flush=True)
    for name, (n, t) in top:
        print(f"[profile]   {t / 1e3:8.3f} ms  x{n:<4d} {name[:90]}", flush=True)
    for key in CONV_OPS:
        for ms, n, _, shapes in [c for c in convs or () if c[2] == key][:n_convs]:
            print(f"[profile]   conv {ms:8.3f} ms  x{n:<3d} {key[6:]} {shapes}", flush=True)
    return busy_ms


def profile_phase(torch, sampler, series, wall_ms):
    """Where a sampler batch and a reconstruct batch spend device time."""
    for label, fn in (("sample", lambda: sampler.sample(B, seed=5)),
                      ("reconstruct", lambda: sampler.reconstruct(series[:B]))):
        print_profile(f"{label} of {B}", fn, wall_ms[label])


class StepRecorder:
    """The logger ``train_stage1`` calls: each step's loss as a device tensor
    (read after the run, so nothing waits for the device between steps) and
    a CUDA event recorded after the step's work; the validations; every
    logged train metric by step (``train``)."""

    def __init__(self, torch):
        self.torch = torch
        self.losses, self.events, self.val, self.acc = [], [], [], []
        self.train = {}
        self.t_train = self.t_val = None  # host clock at the last train and validation logs

    def log_metrics(self, metrics, step):
        if "train/loss" in metrics:
            self.train[step] = {k: v for k, v in metrics.items() if k.startswith("train/")}
            self.losses.append(metrics["train/loss"])
            self.acc.append(metrics.get("train/acc"))
            self.events.append(self.torch.cuda.Event(enable_timing=True))
            self.events[-1].record()
            self.t_train = time.perf_counter()
        else:
            self.val.append((step, metrics))
            self.t_val = time.perf_counter()

    def check_running_metrics(self, label, tags):
        """The run's one validation logged the JAX runner's running metrics,
        finite, under each tag; -> its seconds (from the last step's log:
        the validation, and the drain of that step's device work)."""
        check(len(self.val) == 1, f"{label}: {len(self.val)} validations, expected 1")
        step, val = self.val[0]
        want = {f"val/running_metrics/{k}{t}" for k in ("FID", "MDD", "ACD", "SD", "KD")
                for t in tags}
        check(set(val) == want and bool(np.isfinite([float(v) for v in val.values()]).all()),
              f"{label}: validation logged {sorted(val)}")
        return self.t_val - self.t_train


def train_phase(torch, vq_kernel, work):
    """``train_stage1`` at the published width, counted, writing its
    checkpoint to ``work.stage["1"]``; -> (state, data, steady ms per step,
    VQ kernel launches)."""
    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.data import get_data, make_synthetic_trajectories, save_npz
    from tvqvae_tpu_torch.train.runner import train_stage1

    cfg = Config()
    save_npz(work.dataset, *make_synthetic_trajectories(n=TRAIN_SERIES, channels=C, length=L,
                                                        seed=7))
    data = get_data(work.dataset, cfg.dataset.features)
    rec = StepRecorder(torch)
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 2 ** 30
    vq_kernel.launch_count = 0
    t0 = time.perf_counter()
    state = train_stage1(cfg, data, max_steps=TRAIN_STEPS, device="cuda", logger=rec,
                         log_interval=1, save_path=work.stage["1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = vq_kernel.launch_count
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    n_test = len(data.X_test)
    val_batches = -(-n_test // min(cfg.dataset.batch_sizes["stage1"], n_test))
    expected = 2 * TRAIN_STEPS + 2 * val_batches * len(rec.val)
    check(len(rec.losses) == TRAIN_STEPS and len(rec.val) >= 1, "train_stage1 logged too little")
    check(launches == expected, f"VQ kernel launches {launches} in training, expected {expected}")
    losses = [float(v) for v in rec.losses]
    check(bool(np.isfinite(losses).all()), f"non-finite training loss: {losses}")
    warm = int(TRAIN_STEPS * cfg.exp_params.linear_warmup_rate)
    first, last = float(np.mean(losses[warm:warm + 5])), float(np.mean(losses[-5:]))
    check(last < first, f"loss did not fall: steps {warm + 1}-{warm + 5} {first}, last 5 {last}")
    ms = rec.events[warm].elapsed_time(rec.events[-1]) / (TRAIN_STEPS - 1 - warm)
    val = rec.val[-1][1]
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"[train] published width B={B} C={C} L={L} ({n_params / 1e6:.1f} M parameters), "
          f"{len(data.X_train)} train / {n_test} test series: {TRAIN_STEPS} steps in {wall:.1f} s "
          f"(with init, upload, validation and the checkpoint); "
          f"steady {ms:.2f} ms/step = {1e3 / ms:.3f} steps/s (CUDA events, steps "
          f"{warm + 2}-{TRAIN_STEPS}); peak memory {peak_gb:.2f} GiB, of which "
          f"{peak_gb - base_gb:.2f} GiB above what was allocated before", flush=True)
    print(f"[train] loss step 1 {losses[0]:.4f}, step {TRAIN_STEPS} {losses[-1]:.4f}; mean of "
          f"steps {warm + 1}-{warm + 5} {first:.4f}, of the last 5 {last:.4f}; val loss "
          f"{val['val/loss']:.4f} at step {rec.val[-1][0]}; VQ kernel launches {launches} "
          f"(2 per step, 2 per validation batch: {len(rec.val)} x {val_batches})", flush=True)
    return state, data, ms, launches, peak_gb - base_gb


def given_assignment(torch, indices):
    """An assignment function that hands back, call by call, the given
    indices with their counts and row sums computed plainly: the plain
    twin's statistics of another side's assignment."""
    queue = list(indices)

    def assign(flat, embed):
        idx = queue.pop(0).long()
        return (idx.to(torch.int32), torch.bincount(idx, minlength=embed.shape[0]).to(flat.dtype),
                torch.zeros_like(embed).index_add_(0, idx, flat))
    return assign


def published_train_twin_check(torch, trained, data, device="cuda"):
    """One more training step at the published width from two copies of the
    trained model and codebooks, on the same batch and dropout seed: one
    through the VQ kernel, one with its plain twin in its place. Indices
    held to the near-tie rule on one latent (``same_latent_ties``). The
    kernel's counts and row sums feed the EMA here, so: losses within 1e-5
    relative, and cluster_size, embed_avg and embed within 1e-4 + 1e-4
    relative (the row sums add ~M/K rows of D=128 in another order) of the
    plain twin's step, or, where the two steps' indices differ, of a third
    step whose statistics are the plain ones of the kernel's indices."""
    import copy

    from tvqvae_tpu_torch.models import vq as vq_module
    from tvqvae_tpu_torch.ops import vq_kernel
    from tvqvae_tpu_torch.train.optim import adamw
    from tvqvae_tpu_torch.train.stage1 import create_stage1_state, make_stage1_train_step

    x = torch.from_numpy(data.X_train[B:2 * B]).to(device)
    step = make_stage1_train_step()

    def one_step(assign):
        state = create_stage1_state(copy.deepcopy(trained.model), trained.vq_l, trained.vq_h,
                                    functools.partial(adamw, learning_rate=1e-4))
        seen = []
        state.model.register_forward_hook(
            lambda m, i, o, seen=seen: seen.append((o.vq_l.indices, o.vq_h.indices)))
        vq_module.nearest_codes_stats = assign
        try:
            loss = step(state, x, torch.Generator(device=device).manual_seed(13))[1]["loss"].item()
        finally:
            vq_module.nearest_codes_stats = vq_kernel.nearest_codes_stats
        return state, seen[0], loss

    tapes = {"kernel": AssignTape(vq_kernel.nearest_codes_stats),
             "plain": AssignTape(vq_kernel.nearest_codes_stats_plain)}
    runs = {name: one_step(tape) for name, tape in tapes.items()}
    (k_state, k_idx, k_loss), (p_state, p_idx, p_loss) = runs["kernel"], runs["plain"]
    ties = same_latent_ties(torch, vq_kernel, tapes["kernel"], tapes["plain"],
                            "[reference] published-width train step:")
    ref = "the plain twin's step"
    if not all(torch.equal(a, b) for a, b in zip(k_idx, p_idx)):
        p_state, _, p_loss = one_step(given_assignment(
            torch, [idx for _, _, idx in tapes["kernel"].calls]))
        ref = "a step with the plain statistics of the kernel's indices"
    check(abs(k_loss - p_loss) <= 1e-5 * abs(p_loss),
          f"published-width train step: loss {k_loss} vs {ref} {p_loss}")
    errs = {}
    for band in ("vq_l", "vq_h"):
        for f in ("embed", "embed_avg", "cluster_size"):
            a, b = getattr(getattr(k_state, band), f), getattr(getattr(p_state, band), f)
            errs[f"{band}.{f}"] = float((a - b).abs().max())
            check(bool(((a - b).abs() <= 1e-4 + 1e-4 * b.abs()).all()),
                  f"published-width train step: {band}.{f} off by {errs[f'{band}.{f}']} "
                  f"from {ref}")
    print(f"[reference] published-width train step, kernel vs plain VQ twin: "
          f"{ties['differing']} of {k_idx[0].numel()} LF + {k_idx[1].numel()} HF tokens differ, "
          f"loss {k_loss:.6f} vs {p_loss:.6f} of {ref}, codebook max abs err "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()), flush=True)


def stage2_phase(torch, vq_kernel, work, data, metrics, device="cuda"):
    """``train_stage2`` at the published width over the trained stage 1 read
    back from its checkpoint (``load_stage1_bundle``), counted, writing its
    own, with one validation at the end scoring B series sampled from the
    priors with ``metrics``; -> (frozen, state, steady ms per step, VQ kernel
    launches)."""
    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.train.runner import load_stage1_bundle, train_stage2

    cfg = Config()
    t0 = time.perf_counter()
    frozen, _, meta = load_stage1_bundle(cfg, work.stage["1"], device=device)
    torch.cuda.synchronize()
    check(meta["completed_step"] == TRAIN_STEPS and meta["input_length"] == L,
          f"stage-1 checkpoint meta {dict((k, meta[k]) for k in meta if k != 'config')}")
    print(f"[stage2] frozen stage 1 read from its checkpoint ({os.path.getsize(work.stage['1'])} "
          f"bytes) in {time.perf_counter() - t0:.2f} s", flush=True)
    rec = StepRecorder(torch)
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 2 ** 30  # the earlier phases' models and states
    vq_kernel.launch_count = 0
    t0 = time.perf_counter()
    state = train_stage2(cfg, data, frozen, max_steps=STAGE2_STEPS, device=device, logger=rec,
                         log_interval=1, save_path=work.stage["2"], metrics=metrics,
                         val_n_samples=B)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = vq_kernel.launch_count
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    N = len(data.X_train)
    expected = 2 * -(-N // SWEEP_BATCH)  # the sweep only: the token steps run no encoder
    check(launches == expected, f"VQ kernel launches {launches} in stage 2, expected {expected}")
    check(len(rec.losses) == STAGE2_STEPS, "train_stage2 logged wrongly")
    val_s = rec.check_running_metrics("stage 2", ("",))
    losses = [float(v) for v in rec.losses]
    check(bool(np.isfinite(losses).all()), f"non-finite stage-2 loss: {losses}")
    w = STAGE2_WARMUP
    first, last = float(np.mean(losses[w:2 * w])), float(np.mean(losses[-w:]))
    check(last < first, f"stage-2 loss did not fall: steps {w + 1}-{2 * w} {first}, last {w} {last}")
    ms = rec.events[w].elapsed_time(rec.events[-1]) / (STAGE2_STEPS - 1 - w)
    n_params = sum(p.numel() for t in (state.t_l, state.t_h) for p in t.parameters())
    print(f"[stage2] published width, priors {n_params / 1e6:.3f} M parameters, batch "
          f"{cfg.dataset.batch_sizes['stage2']}, {N} train series: {STAGE2_STEPS} steps in "
          f"{wall:.1f} s (with init and the token sweep); steady {ms:.3f} ms/step = "
          f"{1e3 / ms:.1f} steps/s (CUDA events, steps {w + 2}-{STAGE2_STEPS}); peak memory "
          f"{peak_gb:.2f} GiB, of which {peak_gb - base_gb:.3f} GiB above what was allocated "
          f"before", flush=True)
    print(f"[stage2] loss step 1 {losses[0]:.4f}, step {STAGE2_STEPS} {losses[-1]:.4f}; mean of "
          f"steps {w + 1}-{2 * w} {first:.4f}, of the last {w} {last:.4f}; VQ kernel launches "
          f"{launches} (the sweep: 2 per {SWEEP_BATCH}-series batch)", flush=True)
    print(f"[stage2] validation at step {rec.val[0][0]} with metrics ({B} series sampled, ROCKET "
          f"features, FID by svd, MDD/ACD/SD/KD): {val_s:.2f} s, not in the steady ms/step; "
          + ", ".join(f"{k[len('val/running_metrics/'):]} {float(v):.4g}"
                      for k, v in rec.val[0][1].items()), flush=True)
    return frozen, state, ms, launches


def stage2_checks(torch, vq_kernel, frozen, state, data, device="cuda"):
    """After the counted run: the sweep of the whole train split through the
    kernel and through its plain twin (tokens by the near-tie rule on one
    latent, ``same_latent_ties``; the sweep's time, by host clock with a
    synchronise); three on-the-fly steps from a copy of
    the initial priors against the token path (step 1: tokens and loss
    equal; steps 2-3: losses within 1e-5 relative, the backward's atomic
    sums being unordered); and one 32-batch sampled from the trained priors
    (finite series, tokens in range). -> the token path's tensors."""
    import copy

    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.data import make_batches
    from tvqvae_tpu_torch.models import vq as vq_module
    from tvqvae_tpu_torch.models.maskgit import MaskGITSpec, build_transformers, iterative_decoding
    from tvqvae_tpu_torch.train.runner import _adamw
    from tvqvae_tpu_torch.train.stage2 import (
        create_stage2_state,
        init_stage2,
        make_sampling_fn,
        make_stage2_train_step,
        make_token_encode_fn,
        precompute_token_dataset,
        stage2_train_step_tokens,
    )

    cfg = Config()
    X = torch.from_numpy(data.X_train).to(device)
    precompute_token_dataset(frozen, X)  # warm
    sweeps, tapes = {}, {}
    for name, assign in (("kernel", vq_kernel.nearest_codes_stats),
                         ("plain", vq_kernel.nearest_codes_stats_plain)):
        vq_module.nearest_codes_stats = tapes[name] = AssignTape(assign)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = precompute_token_dataset(frozen, X, SWEEP_BATCH)
            sweeps[name] = (toks, 1e3 * (time.perf_counter() - t0))
        finally:
            vq_module.nearest_codes_stats = vq_kernel.nearest_codes_stats
    (k_l, k_h), k_ms = sweeps["kernel"]
    (p_l, p_h), p_ms = sweeps["plain"]
    ties = same_latent_ties(torch, vq_kernel, tapes["kernel"], tapes["plain"],
                            "[stage2] sweep tokens:")
    n_diff = int((k_l != p_l).sum() + (k_h != p_h).sum())
    print(f"[stage2] sweep of {len(k_l)} series ({k_l.shape[1]} LF + {k_h.shape[1]} HF tokens "
          f"each): {k_ms:.2f} ms through the kernel, {p_ms:.2f} ms through the plain twin "
          f"(the sweeps' time with each call's latent recorded); {n_diff} tokens differ between "
          f"the two sweeps, {ties['differing']} on one latent", flush=True)

    tok_l, tok_h = torch.from_numpy(k_l).to(device), torch.from_numpy(k_h).to(device)
    y = torch.from_numpy(data.y_train).to(device)
    priors = init_stage2(*build_transformers(cfg, frozen.model.spec, data.n_classes),
                         torch.Generator().manual_seed(0), device)
    fly_state = create_stage2_state(*priors, _adamw(cfg, STAGE2_STEPS))
    tok_state = create_stage2_state(*(copy.deepcopy(t) for t in priors),
                                    _adamw(cfg, STAGE2_STEPS))
    fly, tok, enc = (make_stage2_train_step(frozen), stage2_train_step_tokens,
                     make_token_encode_fn(frozen))
    g_fly, g_tok = (torch.Generator(device=device).manual_seed(1) for _ in range(2))
    batches = make_batches(np.arange(len(k_l)), None, cfg.dataset.batch_sizes["stage2"],
                           shuffle=True, seed=0)
    pairs = []
    for t in range(3):
        idx = torch.from_numpy(next(batches)[0]).to(device)
        if t == 0:
            s_l, s_h = enc(X[idx])
            check(torch.equal(s_l, tok_l[idx]) and torch.equal(s_h, tok_h[idx]),
                  "on-the-fly step 1: tokens differ from the sweep's")
        a = fly(fly_state, X[idx], y[idx], g_fly)[1]["loss"].item()
        b = tok(tok_state, tok_l[idx], tok_h[idx], y[idx], g_tok)[1]["loss"].item()
        check(a == b if t == 0 else abs(a - b) <= 1e-5 * abs(b),
              f"on-the-fly stage-2 step {t + 1}: loss {a} vs the token path's {b}")
        pairs.append((a, b))
    print(f"[stage2] on-the-fly vs token path, 3 steps from the same initial priors: step-1 "
          f"tokens equal, losses {pairs}", flush=True)

    spec = MaskGITSpec.from_config(cfg, frozen.model.spec)
    sample = make_sampling_fn(frozen, state.t_l, state.t_h, spec)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_l, x_h, x = sample(B, None, torch.Generator(device=device).manual_seed(21))
    torch.cuda.synchronize()
    dt = 1e3 * (time.perf_counter() - t0)
    check(tuple(x.shape) == (B, C, L) and bool(torch.isfinite(x).all()), "bad stage-2 samples")
    with torch.inference_mode():
        s_l, s_h = iterative_decoding(spec, lambda s, c: state.t_l(s, None, c),
                                      lambda a, b, c: state.t_h(a, b, c), B, device=device,
                                      generator=torch.Generator(device=device).manual_seed(21))
    check(bool(((s_l >= 0) & (s_l < spec.mask_token_l)).all()
               and ((s_h >= 0) & (s_h < spec.mask_token_h)).all()), "sampled tokens out of range")
    print(f"[stage2] sampled {B} series from the trained priors in {dt:.1f} ms: finite, tokens "
          f"in range ({len(torch.unique(s_l))} LF / {len(torch.unique(s_h))} HF codes used)",
          flush=True)
    return tok_l, tok_h, y


def small_stage2_check(torch, devices=("cpu", "cuda"), steps=3):
    """Three on-the-fly stage-2 steps of the same seeded small stage 1 and
    priors (dropouts and p_unconditional 0) on the CPU (plain VQ) and on the
    card (kernel), with the same masking noise: tokens equal at every step,
    losses within 1e-5 relative, parameters and the HF BatchNorm statistics
    within 1e-4."""
    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.models.maskgit import FrozenStage1, build_transformers
    from tvqvae_tpu_torch.models.stage1 import Stage1Spec, init_stage1
    from tvqvae_tpu_torch.train.runner import _adamw
    from tvqvae_tpu_torch.train.stage2 import (
        create_stage2_state,
        init_stage2,
        make_stage2_train_step,
        make_token_encode_fn,
    )

    off = {"p_unconditional": 0.0, "model_dropout": 0.0, "emb_dropout": 0.0}
    mg = SMALL_CFG["MaskGIT"]
    cfg = Config.from_dict({**SMALL_CFG, "MaskGIT": {
        **mg, "prior_model_l": {**mg["prior_model_l"], **off},
        "prior_model_h": {**mg["prior_model_h"], **off}}})
    Ls, n = 127, 8
    spec = Stage1Spec.from_config(cfg, Ls, C)
    rng = np.random.default_rng(9)
    xs = rng.normal(size=(steps, n, C, Ls)).astype(np.float32)
    ys = rng.integers(0, 3, size=(steps, n, 1))
    noise = [{band: (torch.from_numpy(rng.uniform(size=n).astype(np.float32)),
                     torch.from_numpy(rng.uniform(size=(n, tok)).astype(np.float32)))
              for band, tok in (("l", spec.tokens_l), ("h", spec.tokens_h))} for _ in range(steps)]
    runs = []
    for dev in devices:
        model, vq_l, vq_h = init_stage1(spec, torch.Generator().manual_seed(3), dev)
        frozen = FrozenStage1(model.eval().requires_grad_(False), vq_l, vq_h)
        priors = init_stage2(*build_transformers(cfg, spec, 3), torch.Generator().manual_seed(4), dev)
        state = create_stage2_state(*priors, _adamw(cfg, SMALL_STEPS))
        step, enc = make_stage2_train_step(frozen), make_token_encode_fn(frozen)
        toks, losses = [], []
        for x, yb, nz in zip(xs, ys, noise):
            xt = torch.from_numpy(x).to(dev)
            toks.append(tuple(s.cpu() for s in enc(xt)))
            losses.append(step(state, xt, torch.from_numpy(yb).to(dev), None, nz)[1]["loss"].item())
        runs.append((state, toks, losses))
    (ref, ref_tok, ref_loss), (dut, dut_tok, dut_loss) = runs
    for t, (a, b) in enumerate(zip(ref_tok, dut_tok)):
        check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
              f"small stage 2: tokens differ at step {t + 1}")
    loss_err = max(abs(a - b) / abs(a) for a, b in zip(ref_loss, dut_loss))
    check(loss_err <= 1e-5, f"small stage 2: losses off by {loss_err} relative")
    worst = 0.0
    for a_mod, b_mod in ((ref.t_l, dut.t_l), (ref.t_h, dut.t_h)):
        b_sd = b_mod.state_dict()
        for k, a in a_mod.state_dict().items():
            err = float((a.float() - b_sd[k].cpu().float()).abs().max())
            check(err <= 1e-4, f"small stage 2: {k} off by {err}")
            worst = max(worst, err)
    print(f"[reference] small stage 2, {steps} steps, card vs CPU: tokens equal, losses "
          f"{dut_loss} vs {ref_loss}, rel err {loss_err:.3g}, parameters and HF BN statistics "
          f"{worst:.3g}", flush=True)


def stage3_phase(torch, vq_kernel, work, frozen, data, metrics, device="cuda"):
    """``train_stage3`` at the published width over the stage 1 read from
    its checkpoint, counted, writing its own, with one validation at the end
    scoring B series sampled from the written stage 2, raw and enhanced, with
    ``metrics``; -> (state, steady ms per step, VQ kernel launches)."""
    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.train.runner import train_stage3

    cfg = Config()
    rec = StepRecorder(torch)
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 2 ** 30  # the earlier phases' models and states
    vq_kernel.launch_count = 0
    t0 = time.perf_counter()
    state = train_stage3(cfg, data, frozen, max_steps=STAGE3_STEPS, device=device, logger=rec,
                         log_interval=1, save_path=work.stage["3"], stage2_ckpt=work.stage["2"],
                         metrics=metrics, val_n_samples=B)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = vq_kernel.launch_count
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    N = len(data.X_train)
    expected = 2 * -(-N // XPRIME_BATCH)  # the sweep only: the steps run on x'
    check(launches == expected, f"VQ kernel launches {launches} in stage 3, expected {expected}")
    check(len(rec.losses) == STAGE3_STEPS, "train_stage3 logged wrongly")
    val_s = rec.check_running_metrics("stage 3", ("", " with FE"))
    losses = [float(v) for v in rec.losses]
    check(bool(np.isfinite(losses).all()), f"non-finite stage-3 loss: {losses}")
    w = STAGE3_WARMUP
    first, last = float(np.mean(losses[w:2 * w])), float(np.mean(losses[-w:]))
    check(last < first, f"stage-3 loss did not fall: steps {w + 1}-{2 * w} {first}, last {w} {last}")
    ms = rec.events[w].elapsed_time(rec.events[-1]) / (STAGE3_STEPS - 1 - w)
    n_params = sum(p.numel() for p in state.fe.parameters())
    print(f"[stage3] published width, enhancer {n_params} parameters, batch "
          f"{cfg.dataset.batch_sizes['stage3']}, dropout {cfg.fidelity_enhancer.dropout}, {N} train "
          f"series: {STAGE3_STEPS} steps in {wall:.1f} s (with init and the x' sweep); steady "
          f"{ms:.3f} ms/step = {1e3 / ms:.1f} steps/s (CUDA events, steps {w + 2}-{STAGE3_STEPS}); "
          f"peak memory {peak_gb:.2f} GiB, of which {peak_gb - base_gb:.3f} GiB above what was "
          f"allocated before", flush=True)
    print(f"[stage3] loss step 1 {losses[0]:.4f}, step {STAGE3_STEPS} {losses[-1]:.4f}; mean of "
          f"steps {w + 1}-{2 * w} {first:.4f}, of the last {w} {last:.4f}; VQ kernel launches "
          f"{launches} (the sweep: 2 per {XPRIME_BATCH}-series batch)", flush=True)
    print(f"[stage3] validation at step {rec.val[0][0]} with metrics ({B} series sampled from the "
          f"written stage 2, raw and enhanced): {val_s:.2f} s, not in the steady ms/step; "
          + ", ".join(f"{k[len('val/running_metrics/'):]} {float(v):.4g}"
                      for k, v in rec.val[0][1].items()), flush=True)
    return state, ms, launches, peak_gb - base_gb


def fcn_phase(torch, work, data, device="cuda"):
    """``train_fcn`` on the train split at batch min(256, N), writing its
    checkpoint; -> (the trained FCN, steady ms per step)."""
    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.train.runner import train_fcn

    rec = StepRecorder(torch)
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    fcn = train_fcn(Config(), data, logger=rec, max_epochs=FCN_STEPS, device=device, log_interval=1,
                    save_path=work.stage["fcn"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    check(len(rec.losses) == FCN_STEPS, "train_fcn logged wrongly")
    losses = [float(v) for v in rec.losses]
    check(bool(np.isfinite(losses).all()), f"non-finite FCN loss: {losses}")
    w = FCN_WARMUP
    first, last = float(np.mean(losses[:w])), float(np.mean(losses[-w:]))
    check(last < first, f"FCN loss did not fall: first {w} {first}, last {w} {last}")
    ms = rec.events[w].elapsed_time(rec.events[-1]) / (FCN_STEPS - 1 - w)
    X = torch.from_numpy(data.X_train).to(device)
    y = torch.from_numpy(data.y_train[:, 0]).to(device)
    with torch.inference_mode():
        z = fcn(X[:B], features=True)
        acc = float((fcn(X).argmax(-1) == y).float().mean())
    check(tuple(z.shape) == (B, 128) and bool(torch.isfinite(z).all()), "bad FCN features")
    bs = min(256, len(X))
    n_params = sum(p.numel() for p in fcn.parameters())
    print(f"[fcn] {n_params / 1e6:.3f} M parameters, batch {bs}, {len(X)} train series, "
          f"{data.n_classes} classes: {FCN_STEPS} steps in {wall:.1f} s (with init and upload); "
          f"steady {ms:.3f} ms/step = {1e3 / ms:.1f} steps/s (CUDA events, steps {w + 2}-"
          f"{FCN_STEPS}); peak memory {peak_gb:.2f} GiB, of which {peak_gb - base_gb:.3f} GiB "
          f"above what was allocated before", flush=True)
    print(f"[fcn] loss step 1 {losses[0]:.4f}, step {FCN_STEPS} {losses[-1]:.4f}; mean of the "
          f"first {w} {first:.4f}, of the last {w} {last:.4f}; last batch accuracy "
          f"{float(rec.acc[-1]):.3f}; train accuracy (eval mode) {acc:.3f}; features {tuple(z.shape)} "
          f"finite", flush=True)
    return fcn, ms


def eval_metrics(torch, data, device="cuda"):
    """The ROCKET ``Metrics`` at the published length (1000 kernels,
    2000-wide features) over the run's train and test splits, built on the
    card."""
    from tvqvae_tpu_torch.evaluation import Metrics

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = Metrics(L, C, data.n_classes, B, data.X_train, data.X_test, fid_method="svd",
                      device=device)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_train, n_test = len(data.X_train), len(data.X_test)
    check(metrics.z_train.shape == (n_train, 2 * ROCKET_KERNELS)
          and metrics.z_test.shape == (n_test, 2 * ROCKET_KERNELS)
          and bool(np.isfinite(metrics.z_train).all() and np.isfinite(metrics.z_test).all()),
          "bad ROCKET features")
    print(f"[eval] Metrics(rocket, {ROCKET_KERNELS} kernels) at L={L} built on the card in "
          f"{dt:.2f} s: z_train {metrics.z_train.shape}, z_test {metrics.z_test.shape} (bank "
          f"drawn and uploaded, {n_train + n_test} series featurised in batches of {B})", flush=True)
    return metrics


def rocket_vs_cpu(rocket_kernels, x, device="cuda"):
    """ROCKET features of ``x`` (n, L) on the card and on the CPU: the max
    columns within 1e-5 of their scale, a PPV entry off by at most 1/ol and
    in at most 0.1% of the entries (the CPU tests' bounds); -> (max err
    relative to scale, PPV entries off, entries)."""
    from tvqvae_tpu_torch.evaluation import apply_kernels

    card = apply_kernels(x, rocket_kernels, device=device)
    cpu = apply_kernels(x, rocket_kernels, device="cpu")
    scale = float(np.abs(cpu[:, 1::2]).max())
    mx_err = float(np.abs(card[:, 1::2] - cpu[:, 1::2]).max()) / scale
    k = rocket_kernels
    ol = (k.input_length + 2 * k.paddings - (k.lengths - 1) * k.dilations)[None]
    diff = np.abs(card[:, 0::2] - cpu[:, 0::2])
    off = int((diff > 0).sum())
    check(mx_err <= 1e-5, f"ROCKET max features card vs CPU off by {mx_err} of their scale")
    check(bool((diff <= 1.0 / ol + 1e-7).all()) and off <= 1e-3 * diff.size,
          f"ROCKET PPV card vs CPU: {off} of {diff.size} entries off, max {diff.max()}")
    return mx_err, off, diff.size


@contextlib.contextmanager
def timed_methods(targets):
    """While inside, each call of ``cls.name`` for ``(cls, name)`` in
    ``targets`` adds its wall seconds to the yielded dict under ``name``
    (the methods named must not call one another); restored on exit."""
    secs, saved = {}, []
    for cls, name in targets:
        fn = cls.__dict__[name]

        def timed(*args, _fn=fn, _name=name, **kwargs):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                secs[_name] = secs.get(_name, 0.0) + time.perf_counter() - t0

        saved.append((cls, name, fn))
        setattr(cls, name, timed)
    try:
        yield secs
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


def eval_phase(torch, vq_kernel, work, data, metrics, device="cuda"):
    """Evaluation on the card at the published width, over the trained
    stages and ``fcn`` on disk: ROCKET (``metrics``) features/s and against
    the CPU; ``Metrics("supervised_fcn")`` and MiniRocket against the CPU;
    then, counted, the evaluate entry point (``scripts/evaluate.py::
    evaluate``: 64 series sampled ``from_checkpoints`` and enhanced, FID by
    svd on the ROCKET features, FID_rec with its VQ launches, IS, MDD/ACD/
    SD/KD, the same with the enhancer) and the tau search over two taus;
    after the count, Schur against svd on the FCN features of the train
    split and its round trip (n > D). -> (VQ kernel launches of the counted
    part, ms per 32-series ROCKET batch)."""
    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.evaluation import Metrics, MiniRocket
    from tvqvae_tpu_torch.generation import TrainedModelSampler, search_optimal_tau
    from tvqvae_tpu_torch.scripts.evaluate import evaluate
    from tvqvae_tpu_torch.utils.checkpoint import load_checkpoint
    from tvqvae_tpu_torch.utils.logging import RunLogger

    x_train = data.X_train
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z = metrics.compute_z(x_train)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(np.array_equal(z, metrics.z_train), "ROCKET features differ from call to call")
    rocket_32_ms = 1e3 * dt * B / len(x_train)
    mx_err, off, n = rocket_vs_cpu(metrics.rocket_kernels, data.X_test[:8, 0].astype(np.float64),
                                   device)
    print(f"[eval] ROCKET features: {len(x_train) / dt:.1f} series/s ({len(x_train)} series in "
          f"{dt:.3f} s, batches of {B}, host normalisation included); card vs CPU on 8 series: max "
          f"features within {mx_err:.3g} of their scale, {off} of {n} PPV entries off", flush=True)

    fcn_vars = load_checkpoint(work.stage["fcn"])[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fcn_m = Metrics(L, C, data.n_classes, B, x_train, data.X_test,
                    feature_extractor_type="supervised_fcn", fcn_variables=fcn_vars,
                    fid_method="svd", device=device)
    torch.cuda.synchronize()
    fcn_build_s = time.perf_counter() - t0
    cpu_m = Metrics(L, C, data.n_classes, 8, x_train[:8], data.X_test[:8],
                    feature_extractor_type="supervised_fcn", fcn_variables=fcn_vars,
                    device="cpu")
    fcn_err = float(np.abs(fcn_m.z_train[:8] - cpu_m.z_train).max() / np.abs(cpu_m.z_train).max())
    check(fcn_m.z_train.shape == (len(x_train), 128) and fcn_err <= 1e-5,
          f"FCN features card vs CPU off by {fcn_err} of their scale")
    print(f"[eval] Metrics(supervised_fcn) over the trained fcn read from disk, built in "
          f"{fcn_build_s:.2f} s; card vs CPU on 8 series: features within "
          f"{fcn_err:.3g} of their scale", flush=True)

    fit = x_train[:64]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mr = MiniRocket(L, device=device).fit(fit)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    n_conv = len(fit) * len(mr.kernels) * (L - 8)  # the shortest dilation's output, per fit
    check(n_conv > 2 ** 24 and all(np.isfinite(b).all() for b in mr.biases), "bad MiniRocket fit")
    card_mr, cpu_mr = (MiniRocket(L, device=d).fit(fit[:8]) for d in (device, "cpu"))
    bias_err = max(float(np.abs(a - b).max() / np.abs(b).max())
                   for a, b in zip(card_mr.biases, cpu_mr.biases))
    za, zb = card_mr(fit[:8]).cpu().numpy(), cpu_mr(fit[:8]).numpy()
    mr_off = int((np.abs(za - zb) > 1e-6).sum())
    check(bias_err <= 1e-5 and mr_off <= 1e-3 * za.size,
          f"MiniRocket card vs CPU: biases off by {bias_err}, {mr_off} features off")
    print(f"[eval] MiniRocket (dilations {mr.dilations}, {len(mr.kernels)} kernels): fit on "
          f"{len(fit)} series ({n_conv} values per quantile sort, above 2^24) in {fit_s:.3f} s; "
          f"card vs CPU on 8 series: biases within {bias_err:.3g} of their scale, {mr_off} of "
          f"{za.size} features off by more than 1e-6", flush=True)

    cfg = Config()
    sampler = TrainedModelSampler.from_checkpoints(cfg, work.stage["1"], work.stage["2"],
                                                   work.stage["3"], batch_size=B, device=device)
    logger = RunLogger(os.path.join(work.root, "runs", "eval_phase"))
    # ---- the evaluation path, counted -------------------------------------
    vq_kernel.launch_count = 0
    try:
        with timed_methods([(Metrics, "compute_z"), (Metrics, "fid_score"),
                            (Metrics, "inception_score"), (Metrics, "stat_metrics"),
                            (TrainedModelSampler, "sample"), (TrainedModelSampler, "enhance"),
                            (TrainedModelSampler, "reconstruct")]) as secs:
            t0 = time.perf_counter()
            scores, images = evaluate(
                cfg, data, os.path.dirname(work.stage["1"]), logger, batch_size=B,
                min_num_gen=EVAL_SERIES, use_fe=True,
                feature_extractor_type=cfg.evaluation.feature_extractor_type,
                fid_method="svd", device=device, figures=False)
            eval_s = time.perf_counter() - t0
    finally:
        logger.close()
    t0 = time.perf_counter()
    tau = search_optimal_tau(cfg, sampler, metrics, x_train, n_samples=EVAL_SERIES,
                             tau_search_rng=EVAL_TAUS)
    tau_s = time.perf_counter() - t0
    launches = vq_kernel.launch_count
    # ---------------------------------------------------------------------

    n_rec = -(-len(data.X_test) // B)
    check(launches == 2 * n_rec, f"VQ kernel launches {launches} in eval, expected {2 * n_rec} "
          f"(2 per reconstructed test batch; the tau search's SVQ round trips launch none)")
    want = [k for k in JAX_EVAL_KEYS if k != "FID_svq"]  # stage 3 trained at tau 0
    check(sorted(scores) == sorted(want) and tau in EVAL_TAUS
          and bool(np.isfinite(list(scores.values())).all()), f"bad scores {scores}, tau {tau}")
    want_images = {*JAX_EVAL_IMAGES, *(f"conditional_class_{c}.png" for c in range(data.n_classes))}
    check(set(images) == want_images, f"evaluate's images {sorted(images)}")
    for c in range(data.n_classes):
        xc = images[f"conditional_class_{c}.png"]
        check(xc.shape == (16, C, L) and bool(np.isfinite(xc).all()), f"class {c} grid {xc.shape}")
    for name in ("pca_test_gen.png", "tsne_test_gen.png", "pca_test_gen_fe.png"):
        check(all(np.isfinite(e).all() for _, e in images[name]["sets"]), f"{name} not finite")
    print(f"[eval] evaluate() in the process ({EVAL_SERIES} series, ROCKET features, FID by svd, "
          f"against the {len(data.X_test)} test series) in {eval_s:.2f} s: "
          + ", ".join(f"{k} {v:.4g}" for k, v in scores.items()), flush=True)
    print(f"[eval] evaluate() images' data (figures=False): the JAX CLI's {len(images)} "
          f"names; PCA and t-SNE of the test and generated features finite, "
          f"{data.n_classes} conditional batches of 16 (C, L) finite; t-SNE KL "
          f"{images['tsne_test_gen.png']['kl_divergence']:.4f}", flush=True)
    print(f"[eval] evaluate() seconds by call: "
          + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
          + f", the rest (set-up: checkpoints read, the bank drawn) {eval_s - sum(secs.values()):.2f}"
          f"; VQ kernel launches {launches} (2 per reconstructed test batch)", flush=True)
    print(f"[eval] tau search over {list(EVAL_TAUS)} ({EVAL_SERIES} samples against the SVQ round "
          f"trips of {len(x_train)} train series, ROCKET, svd): tau {tau} in {tau_s:.2f} s",
          flush=True)

    z_rec_train = fcn_m.compute_z(sampler.reconstruct(x_train))
    t0 = time.perf_counter()
    schur = fcn_m.fid_score(fcn_m.z_train, z_rec_train, method="schur")
    schur_s = time.perf_counter() - t0
    svd = fcn_m.fid_score(fcn_m.z_train, z_rec_train, method="svd")
    check(abs(schur - svd) <= 1e-6 * abs(svd), f"FCN FID schur {schur} vs svd {svd}")
    print(f"[eval] FCN features (128 wide, n = {len(x_train)} > D), train split vs its round "
          f"trip (after the count): FID schur {schur:.10g} vs svd {svd:.10g} (rel "
          f"{abs(schur - svd) / abs(svd):.3g}, schur {schur_s:.2f} s)", flush=True)
    return launches, rocket_32_ms


# the evaluate CLI where the card has no matplotlib: ``run(args,
# figures=False)``, then one line of each image's data (shapes, finite)
EVALUATE_NO_FIGURES = """\
import json, sys
import numpy as np
from tvqvae_tpu_torch.scripts import evaluate
out = evaluate.run(evaluate.build_argparser().parse_args(sys.argv[1:]), figures=False)
def shape(d):
    arrays = [e for _, e in d["sets"]] if isinstance(d, dict) else [] if d is None else [d]
    return [[list(a.shape), bool(np.isfinite(a).all())] for a in arrays]
print("[images] " + json.dumps({k: shape(v) for k, v in out["images"].items()}))
"""


def evaluate_cli_start(work, figures, device="cuda", config=None):
    """The evaluate CLI over the run's dataset and checkpoints, in a
    subprocess beside what follows: ``python -m ...scripts.evaluate``
    where matplotlib is importable (it writes the JAX CLI's images), else
    ``run(args, figures=False)`` (every image's data computed, nothing
    drawn). ``config``: a config file for the CLI. -> (the subprocess, its
    start time, ``figures``)."""
    args = ["--min_num_gen_samples", str(EVAL_SERIES), "--fid_method", "svd",
            "--run_dir", os.path.join(work.root, "runs"), "--device", device,
            *(["--config", config] if config else [])]
    t0 = time.perf_counter()
    return cli_subprocess(work, "evaluate", args, None if figures else EVALUATE_NO_FIGURES), \
        t0, figures


def check_evaluated(proc, t0, figures, work, n_classes):
    """Wait for the evaluate CLI and check its printed results (the JAX
    package's names, ``FID_svq`` only where stage 3 trained at tau > 0, here
    at 0; every value finite) and its images: the JAX CLI's file names
    written, or without matplotlib each image's data computed and finite."""
    out, _ = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"evaluate exited {proc.returncode}:\n{out[-3000:]}")
    want_images = {*JAX_EVAL_IMAGES, *(f"conditional_class_{c}.png" for c in range(n_classes))}
    if figures:
        run_dir = os.path.join(work.root, "runs", "trajectories_evaluate")
        images = {f for f in os.listdir(run_dir) if f.endswith(".png")}
        check(images == want_images, f"evaluate wrote images {sorted(images)}")
        how = f"a subprocess; its {len(images)} images written"
    else:
        line = next(x for x in out.splitlines() if x.startswith("[images] "))
        images = json.loads(line[len("[images] "):])
        out = out.replace(line, "")
        check(set(images) == want_images and all(ok for v in images.values() for _, ok in v),
              f"evaluate's image data {images}")
        tsne = [shape[0] for shape, _ in images["tsne_test_gen.png"]]
        cond = images["conditional_class_0.png"][0][0]
        how = (f"a subprocess calling run(args, figures=False): no matplotlib; the data of its "
               f"{len(images)} images computed and finite (t-SNE sets of {tsne} points, "
               f"conditional batches {cond})")
    results = json.loads(out[out.rindex("\n{") + 1:])
    want = [k for k in JAX_EVAL_KEYS if k != "FID_svq"]
    check(sorted(results) == sorted(want), f"evaluate printed {sorted(results)}")
    check(bool(np.isfinite(list(results.values())).all()), f"evaluate: non-finite {results}")
    print(f"[eval] evaluate CLI ({how}; --min_num_gen_samples {EVAL_SERIES} --fid_method "
          f"svd): the JAX package's {len(results)} result names, finite, in "
          f"{time.perf_counter() - t0:.1f} s from its start: "
          + ", ".join(f"{k} {v:.4g}" for k, v in results.items()), flush=True)


def stage3_checks(torch, vq_kernel, frozen, state, stage2, data, device="cuda"):
    """After the counted run: the x' sweep of the train split through the
    kernel and through its plain twin (tokens by the near-tie rule on one
    latent, ``same_latent_ties``; x' within 1e-4 of its scale over the
    series whose tokens agree; the sweep's time by host clock with a
    synchronise); three
    on-the-fly tau = 0 steps from a copy of one initial enhancer against
    three precomputed-x' steps on the same batches and generator seed (2
    kernel launches per on-the-fly step; losses within 1e-6 relative at
    step 1, 1e-5 at steps 2-3: the on-the-fly x' is decoded in batches of
    16, the sweep's in batches of 32, and cuDNN may pick other algorithms);
    three on-the-fly steps at tau 0.5 (finite); the trained enhancer over a
    32-batch sampled from the trained priors. -> the sweep's x'."""
    import copy

    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.data import make_batches
    from tvqvae_tpu_torch.models import vq as vq_module
    from tvqvae_tpu_torch.models.fidelity_enhancer import FidelityEnhancer
    from tvqvae_tpu_torch.models.maskgit import MaskGITSpec
    from tvqvae_tpu_torch.train.runner import _adamw
    from tvqvae_tpu_torch.train.stage2 import make_sampling_fn, precompute_token_dataset
    from tvqvae_tpu_torch.train.stage3 import (
        create_stage3_state,
        init_stage3,
        make_stage3_train_step,
        make_stage3_train_step_pre,
        make_xprime_fn,
        precompute_xprime_dataset,
    )

    cfg = Config()
    X = torch.from_numpy(data.X_train).to(device)
    precompute_xprime_dataset(frozen, X, XPRIME_BATCH, keep_on_device=True)  # warm
    sweeps, tapes = {}, {}
    for name, assign in (("kernel", vq_kernel.nearest_codes_stats),
                         ("plain", vq_kernel.nearest_codes_stats_plain)):
        vq_module.nearest_codes_stats = tapes[name] = AssignTape(assign)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xp = precompute_xprime_dataset(frozen, X, XPRIME_BATCH, keep_on_device=True)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            sweeps[name] = (xp, precompute_token_dataset(frozen, X, XPRIME_BATCH), ms)
        finally:
            vq_module.nearest_codes_stats = vq_kernel.nearest_codes_stats
    (k_xp, (k_l, k_h), k_ms), (p_xp, (p_l, p_h), p_ms) = sweeps["kernel"], sweeps["plain"]
    ties = same_latent_ties(torch, vq_kernel, tapes["kernel"], tapes["plain"],
                            "[stage3] x' sweep and its tokens:")
    n_diff = int((k_l != p_l).sum() + (k_h != p_h).sum())
    # x' decodes the tokens: a row whose token differs at a near-tie decodes
    # another code there, so x' is held to the plain twin's only where the
    # two sweeps' tokens agree throughout the series
    same = torch.from_numpy(((k_l == p_l).all(1) & (k_h == p_h).all(1))).to(k_xp.device)
    rel = float((k_xp[same] - p_xp[same]).abs().max() / p_xp.abs().max())
    check(rel <= 1e-4, f"stage-3 x' through the kernel off the plain twin's by {rel} of its scale")
    print(f"[stage3] x' sweep of {len(k_xp)} series: {k_ms:.2f} ms through the kernel, "
          f"{p_ms:.2f} ms through the plain twin (each call's latent recorded); {n_diff} tokens "
          f"differ between the two sweeps, {ties['differing']} on one latent; x' within "
          f"{rel:.3g} of its scale over the {int(same.sum())} series whose tokens agree",
          flush=True)

    fe0 = init_stage3(FidelityEnhancer.from_config(cfg, L, C), torch.Generator().manual_seed(0),
                      device)
    fe_hot = copy.deepcopy(fe0)
    fly_state = create_stage3_state(fe0, _adamw(cfg, STAGE3_STEPS))
    pre_state = create_stage3_state(copy.deepcopy(fe0), _adamw(cfg, STAGE3_STEPS))
    fly, pre, xprime_of = (make_stage3_train_step(frozen), make_stage3_train_step_pre(),
                           make_xprime_fn(frozen))
    g_fly, g_pre = (torch.Generator(device=device).manual_seed(1) for _ in range(2))
    batches = make_batches(np.arange(len(X)), None, cfg.dataset.batch_sizes["stage3"],
                           shuffle=True, seed=0)
    pairs, idxs = [], [torch.from_numpy(next(batches)[0]).to(device) for _ in range(3)]
    x_err = float((xprime_of(X[idxs[0]]) - k_xp[idxs[0]]).abs().max() / k_xp.abs().max())
    before = vq_kernel.launch_count
    for t, idx in enumerate(idxs):
        a = fly(fly_state, X[idx], g_fly)[1]["loss"].item()
        b = pre(pre_state, X[idx], k_xp[idx], g_pre)[1]["loss"].item()
        check(abs(a - b) <= (1e-6 if t == 0 else 1e-5) * abs(b),
              f"on-the-fly stage-3 step {t + 1}: loss {a} vs the precomputed path's {b}")
        pairs.append((a, b))
    fly_launches = vq_kernel.launch_count - before
    check(fly_launches == 2 * len(idxs), f"on-the-fly stage-3 steps launched {fly_launches}")
    print(f"[stage3] on-the-fly (tau 0) vs precomputed x', 3 steps from the same initial enhancer: "
          f"losses {pairs} (step 1 bit-equal: {pairs[0][0] == pairs[0][1]}; the batch's x' "
          f"within {x_err:.3g} of the sweep's scale); {fly_launches} VQ launches", flush=True)

    hot_state = create_stage3_state(fe_hot, _adamw(cfg, STAGE3_STEPS))
    hot, g_hot = make_stage3_train_step(frozen, tau=0.5), torch.Generator(device=device).manual_seed(2)
    before = vq_kernel.launch_count
    hot_losses = [hot(hot_state, X[idx], g_hot)[1]["loss"].item() for idx in idxs]
    check(bool(np.isfinite(hot_losses).all()), f"tau 0.5 stage-3 losses {hot_losses}")
    print(f"[stage3] on-the-fly tau 0.5, 3 steps: losses {hot_losses}, VQ launches "
          f"{vq_kernel.launch_count - before} (the SVQ categorical draws in plain torch)", flush=True)

    spec = MaskGITSpec.from_config(cfg, frozen.model.spec)
    sample = make_sampling_fn(frozen, stage2.t_l, stage2.t_h, spec)
    _, _, x = sample(B, None, torch.Generator(device=device).manual_seed(22))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        xe = state.fe(x)
    torch.cuda.synchronize()
    dt = 1e3 * (time.perf_counter() - t0)
    check(tuple(xe.shape) == (B, C, L) and bool(torch.isfinite(xe).all()), "bad enhanced samples")
    print(f"[stage3] trained enhancer over {B} series sampled from the trained priors: {dt:.1f} ms, "
          f"finite; mean |FE(x) - x| {float((xe - x).abs().mean()):.4f}", flush=True)
    return k_xp


def witness_check(label, ours, ref, exact, tight, loose=None):
    """Each leaf of the state dicts ``ours`` (the run under test, e.g. the
    card) and ``ref`` (the float32 reference run, e.g. the CPU) within
    ``tight`` + ``tight`` relative of each other, except where the
    reference is itself farther than that from ``exact`` (the same steps in
    float64): there ``ours`` must be no farther from ``exact`` than twice
    the reference is. ``loose`` {leaf: bound} caps the leaves whose gradient
    a train-mode norm cancels. -> (worst error, witnessed leaves)."""
    worst, witnessed = 0.0, []
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        v = v.double()
        o = ours[k].cpu().double()
        e_or, e_oe, e_re = (float((a - b).abs().max()) for a, b in ((o, v), (o, exact[k]),
                                                                    (v, exact[k])))
        if e_or > tight + tight * float(v.abs().max()):
            check(e_re > tight and e_oe <= 2 * e_re,
                  f"{label}: {k} off by {e_or}; from float64: ours {e_oe}, reference {e_re}")
            witnessed.append(k)
        if loose and k in loose:
            check(e_or <= loose[k], f"{label}: {k} off by {e_or}, beyond {loose[k]}")
        worst = max(worst, e_or)
    return worst, witnessed


class MaskTape:
    """Stands in for ``models/fidelity_enhancer.py::dropout``, so that two
    devices, a float64 witness or two packages drop the same elements.
    Made with a seed, it records: each call draws its keep mask on the CPU
    and keeps it. After ``rewind`` it replays what it recorded, after
    ``load(masks)`` the masks given: each call takes the next mask (its
    shape must be the call's), moved to its input's device. ``pos`` counts
    the calls of the replay."""

    def __init__(self, torch, seed=None):
        self.gen = None if seed is None else torch.Generator().manual_seed(seed)
        self.masks, self.pos = [], None if seed is not None else 0

    def rewind(self):
        self.pos = 0

    def load(self, masks):
        self.masks, self.pos = list(masks), 0

    def __call__(self, x, rate, generator=None):
        from tvqvae_tpu_torch.models.layers import dropout, dropout_mask

        if self.pos is None:
            self.masks.append(dropout_mask(tuple(x.shape), rate, self.gen))
            mask = self.masks[-1]
        else:
            check(self.pos < len(self.masks), "dropout tape: more calls than masks")
            mask = self.masks[self.pos]
            check(tuple(mask.shape) == tuple(x.shape),
                  f"dropout tape: call {self.pos} of {tuple(x.shape)}, mask {tuple(mask.shape)}")
            self.pos += 1
        return dropout(x, rate, mask=mask.to(x.device))


SMALL_STAGE3_CASES = {"dim_mults (1, 2), dropout 0": ([1, 2], 0.0),
                      "dim_mults (1, 2, 4, 8), dropout 0.5": ([1, 2, 4, 8], 0.5)}


def small_stage3_check(torch, devices=("cpu", "cuda"), steps=3):
    """The same seeded small stage 1 and small enhancer (dim 8, 4 groups) on
    the CPU (plain VQ) and on the card (kernel), at dim_mults (1, 2) with
    dropout 0 and at the published dim_mults (1, 2, 4, 8) with the published
    dropout 0.5 (the masks drawn once on the CPU and handed to both devices
    and the witness, ``MaskTape``): the x' sweep within 1e-5 of its scale,
    three on-the-fly tau = 0 steps' losses within 1e-5 relative,
    parameters within 1e-5 (the float64 witness rule of
    ``witness_check``)."""
    import copy

    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.models import fidelity_enhancer as tfe
    from tvqvae_tpu_torch.models.maskgit import FrozenStage1
    from tvqvae_tpu_torch.models.stage1 import Stage1Spec, init_stage1
    from tvqvae_tpu_torch.train.runner import _adamw
    from tvqvae_tpu_torch.train.stage3 import (
        create_stage3_state,
        init_stage3,
        make_stage3_train_step,
        make_stage3_train_step_pre,
        precompute_xprime_dataset,
    )

    Ls, n = 127, 8
    xs = np.random.default_rng(10).normal(size=(steps, n, C, Ls)).astype(np.float32)
    drop = tfe.dropout
    for label, (mults, rate) in SMALL_STAGE3_CASES.items():
        cfg = Config.from_dict({**SMALL_CFG, "fidelity_enhancer": {
            **SMALL_CFG["fidelity_enhancer"], "dim_mults": mults, "dropout": rate}})
        spec = Stage1Spec.from_config(cfg, Ls, C)
        tape = tfe.dropout = MaskTape(torch, 11)
        try:
            runs = []
            for dev in devices:
                model, vq_l, vq_h = init_stage1(spec, torch.Generator().manual_seed(3), dev)
                frozen = FrozenStage1(model.eval().requires_grad_(False), vq_l, vq_h)
                fe = init_stage3(tfe.FidelityEnhancer.from_config(cfg, Ls, C),
                                 torch.Generator().manual_seed(4), dev)
                fe0 = copy.deepcopy(fe)
                state = create_stage3_state(fe, _adamw(cfg, SMALL_STEPS))
                xprime = precompute_xprime_dataset(frozen, xs.reshape(-1, C, Ls), batch_size=n)
                step = make_stage3_train_step(frozen)
                losses = [step(state, torch.from_numpy(x).to(dev))[1]["loss"].item() for x in xs]
                runs.append((state, xprime, losses, fe0))
                replayed = tape.pos
                tape.rewind()
            (ref, ref_xp, ref_loss, fe0), (dut, dut_xp, dut_loss, _) = runs
            recorded = len(tape.masks)
            check(replayed == recorded == (38 * steps if rate else 0),
                  f"small stage 3 ({label}): {recorded} masks recorded, {replayed} replayed")
            xp_err = float(np.abs(dut_xp - ref_xp).max() / np.abs(ref_xp).max())
            check(xp_err <= 1e-5, f"small stage 3 ({label}): x' off by {xp_err} of its scale")
            loss_err = max(abs(a - b) / abs(a) for a, b in zip(ref_loss, dut_loss))
            check(loss_err <= 1e-5, f"small stage 3 ({label}): losses off by {loss_err} relative")
            # the float64 witness: the CPU's precomputed steps from the same x' and masks, in float64
            tape.rewind()
            exact = create_stage3_state(fe0.double(), _adamw(cfg, SMALL_STEPS))
            pre = make_stage3_train_step_pre()
            for x, xp in zip(xs, ref_xp.reshape(steps, n, C, Ls)):
                pre(exact, torch.from_numpy(x).double(), torch.from_numpy(xp).double())
        finally:
            tfe.dropout = drop
        worst, witnessed = witness_check(f"small stage 3 ({label})", dut.fe.state_dict(),
                                         ref.fe.state_dict(), exact.fe.state_dict(), 1e-5)
        print(f"[reference] small stage 3 ({label}; {recorded} dropout masks), {steps} steps, "
              f"card vs CPU: x' {xp_err:.3g} of scale, losses {dut_loss} vs {ref_loss}, "
              f"rel err {loss_err:.3g}, parameters {worst:.3g} "
              f"(held to the float64 witness: {witnessed or 'none'})", flush=True)


def published_fe_check(torch, series):
    """The published-width enhancer (seeded, random GroupNorm scales and
    biases) on two series on the card, on the CPU in float32 and on the CPU
    in float64: the card within 2e-5 of the output's scale of both, tight
    enough that TF32 (inputs rounded to 2^-11) or another lossy conv
    algorithm fails it."""
    import copy

    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.models.fidelity_enhancer import FidelityEnhancer
    from tvqvae_tpu_torch.train.stage3 import init_stage3

    gen = torch.Generator().manual_seed(5)
    fe = init_stage3(FidelityEnhancer.from_config(Config(), L, C), gen, "cpu")
    with torch.no_grad():
        for name, p in fe.named_parameters():
            if "GroupNorm" in name:
                p.copy_(0.5 + torch.rand(p.shape, generator=gen) if name.endswith("weight")
                        else 0.1 * torch.randn(p.shape, generator=gen))
    x = torch.from_numpy(series[:2])
    with torch.inference_mode():
        y_cpu = fe(x)
        y_64 = copy.deepcopy(fe).double()(x.double())
        y_dev = copy.deepcopy(fe).cuda()(x.cuda()).cpu()
    scale = float(y_64.abs().max())
    dev_cpu = float((y_dev - y_cpu).abs().max()) / scale
    dev_64, cpu_64 = (float((y.double() - y_64).abs().max()) / scale for y in (y_dev, y_cpu))
    print(f"[reference] published-width enhancer, 2 series: card vs CPU {dev_cpu:.3g} of scale; "
          f"vs float64 on the CPU: card {dev_64:.3g}, CPU float32 {cpu_64:.3g}", flush=True)
    check(dev_cpu <= 2e-5 and dev_64 <= 2e-5,
          f"published-width enhancer: card vs CPU {dev_cpu}, card vs float64 {dev_64}")


def fe_sampler_check(torch, Config, TrainedModelSampler):
    """The sampler at the published width with a seeded enhancer: one
    32-batch, finite; ms per batch with the enhancer and without it."""
    s = TrainedModelSampler.from_init(Config(), L, C, N_CLASSES, seed=0, device="cuda",
                                      batch_size=B, use_fidelity_enhancer=True)
    s.sample(B, seed=100)  # warm-up
    times = {}
    for use_fe in (True, False, True, False):
        s.use_fe = use_fe
        t0 = time.perf_counter()
        x_l, x_h, x = s.sample(B, seed=1)
        times.setdefault(use_fe, []).append(1e3 * (time.perf_counter() - t0))
        check(x.shape == (B, C, L) and bool(np.isfinite(x).all()), "bad enhanced sampler output")
    s.use_fe = True
    print(f"[sampler] seeded enhancer at the published width: finite; ms per {B}-batch with the "
          f"enhancer {times[True]}, without {times[False]}", flush=True)


def small_fcn_check(torch, devices=("cpu", "cuda"), steps=3):
    """Three FCN steps from the same seeded weights on the CPU and on the
    card (B=8, L=257, the same batches): losses within 1e-5 relative,
    parameters and BatchNorm statistics within 1e-5, with the float64
    witness rule of ``witness_check``; the conv biases (a train-mode
    BatchNorm cancels their gradient) and the running means they feed are
    also capped at 1e-5 + 2 * sum(lr_t)."""
    import copy

    from tvqvae_tpu_torch.models.fcn import FCN
    from tvqvae_tpu_torch.models.layers import init_weights_
    from tvqvae_tpu_torch.train.optim import adamw
    from tvqvae_tpu_torch.train.runner import fcn_train_step
    from tvqvae_tpu_torch.utils.schedule import cosine_decay_schedule

    n, Ls = 8, 257
    rng = np.random.default_rng(11)
    xs = rng.normal(size=(steps, n, C, Ls)).astype(np.float32)
    ys = rng.integers(0, 3, size=(steps, n, 1))
    fcn0 = init_weights_(FCN(C, 3), torch.Generator().manual_seed(6))
    schedule = cosine_decay_schedule(1e-3, SMALL_FCN_STEPS)
    runs = []
    for dev, dtype in (*((d, torch.float32) for d in devices), ("cpu", torch.float64)):
        m = copy.deepcopy(fcn0).to(dev, dtype)
        opt, sched = adamw(m.parameters(), schedule, weight_decay=1e-5)
        losses = [fcn_train_step(m, opt, sched, torch.from_numpy(x).to(dev, dtype),
                                 torch.from_numpy(y).to(dev))[0].item() for x, y in zip(xs, ys)]
        runs.append((m.state_dict(), losses))
    (ref, ref_loss), (dut, dut_loss), (exact, _) = runs
    loss_err = max(abs(a - b) / abs(a) for a, b in zip(ref_loss, dut_loss))
    check(loss_err <= 1e-5, f"small FCN: losses off by {loss_err} relative")
    noise = 1e-5 + 2 * sum(schedule(t) for t in range(steps))
    loose = {f"{m}_{i}.{leaf}": noise for i in range(3)
             for m, leaf in (("Conv", "bias"), ("BatchNorm", "running_mean"))}
    worst, witnessed = witness_check("small FCN", dut, ref, exact, 1e-5, loose)
    print(f"[reference] small FCN, {steps} steps, card vs CPU: losses {dut_loss} vs {ref_loss}, "
          f"rel err {loss_err:.3g}, parameters and BN statistics {worst:.3g} (held to the float64 "
          f"witness: {witnessed or 'none'})", flush=True)


def train_profile(torch, state, data, step_ms):
    """One more training step of the trained state, under the profiler."""
    from tvqvae_tpu_torch.train.stage1 import make_stage1_train_step

    step = make_stage1_train_step()
    x = torch.from_numpy(data.X_train[:B]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(11)
    step(state, x, gen)
    print_profile(f"train step of {B}", lambda: step(state, x, gen), step_ms)


def stage2_profile(torch, state, tok_l, tok_h, y, step_ms, device="cuda"):
    """One more token step of the trained priors, under the profiler."""
    from tvqvae_tpu_torch.train.stage2 import stage2_train_step_tokens as step

    idx = torch.arange(16, device=device)
    gen = torch.Generator(device=device).manual_seed(12)
    step(state, tok_l[idx], tok_h[idx], y[idx], gen)
    print_profile("stage-2 step of 16", lambda: step(state, tok_l[idx], tok_h[idx], y[idx], gen),
                  step_ms)


def stage3_profile(torch, state, data, xprime, step_ms, device="cuda"):
    """One more precomputed-x' step of the trained enhancer, under the profiler."""
    from tvqvae_tpu_torch.train.stage3 import make_stage3_train_step_pre

    step = make_stage3_train_step_pre()
    idx = torch.arange(16, device=device)
    x = torch.from_numpy(data.X_train).to(device)[idx]
    gen = torch.Generator(device=device).manual_seed(13)
    step(state, x, xprime[idx], gen)
    print_profile("stage-3 step of 16", lambda: step(state, x, xprime[idx], gen), step_ms)


def fcn_profile(torch, fcn, data, step_ms, device="cuda"):
    """One more FCN step of the trained net, under the profiler."""
    from tvqvae_tpu_torch.train.optim import adamw
    from tvqvae_tpu_torch.train.runner import fcn_train_step

    optimizer, scheduler = adamw(fcn.parameters(), 1e-4, weight_decay=1e-5)
    bs = min(256, len(data.X_train))
    x = torch.from_numpy(data.X_train[:bs]).to(device)
    y = torch.from_numpy(data.y_train[:bs]).to(device)
    fcn_train_step(fcn, optimizer, scheduler, x, y)
    print_profile(f"fcn step of {bs}", lambda: fcn_train_step(fcn, optimizer, scheduler, x, y),
                  step_ms)


def rocket_profile(torch, metrics, data, wall_ms):
    """One 32-series ROCKET featurisation (1000 kernels, L=4633) under the profiler."""
    from tvqvae_tpu_torch.evaluation import apply_kernels

    x = data.X_train[:B, 0].astype(np.float64)
    print_profile(f"rocket features of {B}", lambda: apply_kernels(x, metrics.rocket_kernels),
                  wall_ms)


def biases_cancelled_by_batchnorm(model) -> dict:
    """{bias name: weight name of the same conv} for every bias whose
    per-channel constant reaches a train-mode BatchNorm through
    shift-invariant linear ops only, so that its gradient is 0 up to
    rounding: each conv right before a BatchNorm (``EncBlock2d.Conv_0``,
    ``ResBlock2d.Conv_0``, ``DecBlock2d.ConvTranspose2dTorch_0``), and the
    ``Conv_1`` of a ResBlock followed by an EncBlock2d (edge padding and a
    VALID conv keep a constant channel constant). Adam's m / (sqrt(v) + eps)
    turns that rounding noise into steps of up to lr, so two correct
    implementations drift apart in these biases (and in the running mean of
    the BatchNorm each feeds) by up to 2 * sum(lr_t)."""
    from tvqvae_tpu_torch.models.layers import DecBlock2d, EncBlock2d, NamedStack, ResBlock2d

    out = {}
    for sname, stack in model.named_children():
        if not isinstance(stack, NamedStack):
            continue
        blocks = list(stack.named_children())
        for i, (bname, block) in enumerate(blocks):
            convs = {EncBlock2d: ["Conv_0"], ResBlock2d: ["Conv_0"],
                     DecBlock2d: ["ConvTranspose2dTorch_0"]}.get(type(block), [])
            if isinstance(block, ResBlock2d) and i + 1 < len(blocks) \
                    and isinstance(blocks[i + 1][1], EncBlock2d):
                convs = convs + ["Conv_1"]
            for c in convs:
                out[f"{sname}.{bname}.{c}.bias"] = f"{sname}.{bname}.{c}.weight"
    return out


def check_stage1_leaves(label, ref, dut, cancelled, noise):
    """Hold ``dut`` to ``ref``, two stage-1 states laid out as
    ``stage1_from_jax`` lays them out (the model's state dict and the
    codebooks' ``vq_l.*``/``vq_h.*`` fields), to ``small_train_check``'s
    bounds: codebooks within 1e-4 of 1 + |value|, ``initted`` equal, every
    other leaf within 1e-4, and the ``cancelled`` biases and the running
    means within 1e-4 + ``noise``. -> (codebook error, worst error of the
    tight and of the cancelled leaves)."""
    cb_err, worst = 0.0, {"tight": 0.0, "cancelled": 0.0}
    for k, a in ref.items():
        b = dut[k].cpu()
        if k.endswith(("num_batches_tracked", "initted")):
            check(bool((a.cpu() == b).all()), f"{label}: {k} differs")
            continue
        a, b = a.cpu().float(), b.float()
        if k.startswith(("vq_l.", "vq_h.")):
            # relative to the value too: a code no row has chosen yet has embed =
            # embed_avg / ~eps, ~1e5 here, where one float32 ulp is 2^-6
            cb_err = max(cb_err, float(((a - b).abs() / (1.0 + a.abs())).max()))
            continue
        err = float((a - b).abs().max())
        loose = k in cancelled or k.endswith("running_mean")
        check(err <= 1e-4 + (noise if loose else 0.0), f"{label}: {k} off by {err}")
        kind = "cancelled" if loose else "tight"
        worst[kind] = max(worst[kind], err)
    check(cb_err <= 1e-4, f"{label}: codebooks off by {cb_err} of 1 + |value|")
    return cb_err, worst


def small_train_check(torch, devices=("cpu", "cuda"), steps=3):
    """Three training steps of the same seeded small model (dropout 0) on the
    CPU (plain VQ) and on the card (kernel): indices equal at every step,
    losses within 1e-4 relative, codebooks within 1e-4 of 1 + |value|,
    BatchNorm variances and parameters within 1e-4; the biases whose gradient a BatchNorm
    cancels (and the running means after them) within 1e-4 + 2 * sum(lr_t),
    the drift Adam makes of their rounding noise."""
    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.models.stage1 import Stage1Spec, init_stage1
    from tvqvae_tpu_torch.train.optim import adamw
    from tvqvae_tpu_torch.train.stage1 import create_stage1_state, make_stage1_train_step
    from tvqvae_tpu_torch.utils.schedule import warmup_cosine_schedule

    cfg = Config.from_dict({**SMALL_CFG, "encoder": {**SMALL_CFG["encoder"], "dropout": 0.0},
                            "decoder": {**SMALL_CFG["decoder"], "dropout": 0.0}})
    Ls, n = 127, 8
    spec = Stage1Spec.from_config(cfg, Ls, C)
    schedule = warmup_cosine_schedule(cfg.exp_params.lr, SMALL_STEPS)
    xs = np.random.default_rng(8).normal(size=(steps, n, C, Ls)).astype(np.float32)
    runs = []
    for dev in devices:
        model, vq_l, vq_h = init_stage1(spec, torch.Generator().manual_seed(3), dev)
        state = create_stage1_state(model, vq_l, vq_h,
                                    functools.partial(adamw, learning_rate=schedule, weight_decay=0.01))
        seen = []
        model.register_forward_hook(
            lambda m, i, o, seen=seen: seen.append((o.vq_l.indices.cpu(), o.vq_h.indices.cpu())))
        step = make_stage1_train_step()
        losses = [step(state, torch.from_numpy(x).to(dev))[1]["loss"].item() for x in xs]
        runs.append((state, seen, losses))
    (ref, ref_seen, ref_loss), (dut, dut_seen, dut_loss) = runs
    for t, (a, b) in enumerate(zip(ref_seen, dut_seen)):
        check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
              f"small model training: indices differ at step {t + 1}")
    loss_err = max(abs(a - b) / abs(a) for a, b in zip(ref_loss, dut_loss))
    check(loss_err <= 1e-4, f"small model training: losses off by {loss_err} relative")
    noise = 2 * sum(schedule(t) for t in range(steps))

    def leaves(state):
        return {**state.model.state_dict(), **{f"{band}.{c.name}": getattr(cb, c.name)
                                               for band, cb in (("vq_l", state.vq_l), ("vq_h", state.vq_h))
                                               for c in dataclasses.fields(cb)}}

    cb_err, worst = check_stage1_leaves("small model training", leaves(ref), leaves(dut),
                                        biases_cancelled_by_batchnorm(ref.model), noise)
    print(f"[reference] small model training, {steps} steps, card vs CPU: indices equal, losses "
          f"{dut_loss} vs {ref_loss}, rel err {loss_err:.3g}, codebooks {cb_err:.3g}, parameters and BN variances "
          f"{worst['tight']:.3g}, BN-cancelled biases and running means {worst['cancelled']:.3g} "
          f"(bound {1e-4 + noise:.3g})", flush=True)


def published_width_check(torch, Config, TrainedModelSampler, sampler, series):
    """Two series at the published width through the card's encoders (with
    the VQ kernel) and the same seeded model on the CPU: latents within 1e-4
    of their scale, and the card's tokens decoded on the card within 5e-4 of
    the output's scale of both the CPU's float32 decode and a float64 one,
    the bound ``tests/test_torch_published_width.py`` holds decoded series
    to. Both float32 decodes are printed against the float64 one: float32
    rounding alone takes this decode ~1e-4 of its scale from it on either
    device (PERF.md section 6). The same tokens decoded under the JAX
    sampler's bfloat16 defaults: the card's gap from its float32 decode
    between 0.25x and 4x the CPU's (the guard of
    ``tests/test_torch_precision.py``, which holds the CPU's to JAX's)."""
    import copy

    from tvqvae_tpu_torch.models.maskgit import FrozenStage1, decode_tokens, encode_tokens

    cpu = TrainedModelSampler.from_init(Config(), L, C, N_CLASSES, seed=0, device="cpu",
                                        batch_size=B)
    f = cpu.frozen
    exact = FrozenStage1(copy.deepcopy(f.model).double(), *(
        dataclasses.replace(vq, embed=vq.embed.double()) for vq in (f.vq_l, f.vq_h)))
    x = torch.from_numpy(series[:2])
    def bf16_twin(frozen, device):  # the same weights under the JAX sampler's bfloat16 defaults
        spec = dataclasses.replace(frozen.model.spec, compute_dtype="bfloat16", fast_bn=True,
                                   bf16_head=True, bf16_istft=True)
        sd = {**frozen.model.state_dict(),
              **{f"{band}.{c.name}": getattr(vq, c.name) for band, vq in
                 (("vq_l", frozen.vq_l), ("vq_h", frozen.vq_h)) for c in dataclasses.fields(vq)}}
        return FrozenStage1.from_state_dict(spec, sd, device)

    f16, dev16 = bf16_twin(f, "cpu"), bf16_twin(sampler.frozen, "cuda")
    errs, guards = [], []
    with torch.inference_mode():
        for band in ("lf", "hf"):
            z_dev = sampler.frozen.model.encode(x.cuda(), band).cpu()
            z_cpu = f.model.encode(x, band)
            z_err = float((z_dev - z_cpu).abs().max() / z_cpu.abs().max())
            s_dev = encode_tokens(sampler.frozen, x.cuda(), band)
            s_cpu = encode_tokens(f, x, band)
            flips = int((s_dev.cpu() != s_cpu).sum())
            y_dev = decode_tokens(sampler.frozen, s_dev, band).cpu()
            y_cpu = decode_tokens(f, s_dev.cpu(), band)
            y_64 = decode_tokens(exact, s_dev.cpu(), band)
            y_err = float((y_dev - y_cpu).abs().max() / y_cpu.abs().max())
            dev_64, cpu_64 = (float((y.double() - y_64).abs().max() / y_64.abs().max())
                              for y in (y_dev, y_cpu))
            print(f"[reference] published width {band}: card vs CPU latents rel err "
                  f"{z_err:.3g}, decode rel err {y_err:.3g}, token flips {flips} of "
                  f"{s_cpu.numel()}; decode vs float64 on the CPU: card {dev_64:.3g}, "
                  f"CPU float32 {cpu_64:.3g}", flush=True)
            errs.append((band, z_err, y_err, dev_64))
            # bfloat16: the card's gap from its float32 decode against the CPU's
            g_dev = rel_gap(decode_tokens(dev16, s_dev, band).cpu(), y_dev)
            g_cpu = rel_gap(decode_tokens(f16, s_dev.cpu(), band), y_cpu)
            guards.append((band, g_dev, g_cpu))
            print(f"[reference] published width {band}, bfloat16 decode of the same tokens: card "
                  f"{g_dev:.3g} of scale from its float32 decode, CPU {g_cpu:.3g} (ratio "
                  f"{g_dev / g_cpu:.3g}, bound 0.25-4)", flush=True)
    for band, g_dev, g_cpu in guards:
        check(0.25 <= g_dev / g_cpu <= 4.0, f"published width {band}: the card's bfloat16 gap "
                                            f"{g_dev} against the CPU's {g_cpu}")
    for band, z_err, y_err, dev_64 in errs:
        check(z_err <= 1e-4 and y_err <= 5e-4 and dev_64 <= 5e-4,
              f"published width {band}: card vs CPU off by {z_err}, {y_err}; "
              f"card vs float64 {dev_64}")


def gumbel_noise(torch, spec, n, rng):
    """One ``iterative_decoding`` noise dict for a batch of ``n``: Gumbel
    draws from the numpy generator ``rng``."""
    noise = {}
    for band, T, tok, K in (("l", spec.T_l, spec.tokens_l, spec.mask_token_l),
                            ("h", spec.T_h, spec.tokens_h, spec.mask_token_h)):
        noise[band] = tuple(torch.from_numpy(
            -np.log(-np.log(rng.uniform(1e-12, 1.0, size)))).float()
            for size in ((T, n, tok, K), (T, n, tok)))
    return noise


def rel_gap(a, ref) -> float:
    """max |a - ref| over max |ref|, of host arrays or tensors."""
    a, ref = (np.asarray(t.detach().float().cpu()) if hasattr(t, "detach") else np.asarray(t)
              for t in (a, ref))
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def steps_cost(torch, step, state, x, gen, n=BF16_TIMED_STEPS):
    """``n`` training steps after one warm-up step: (ms per step by CUDA
    events, GiB their peak rises above what was allocated before them)."""
    step(state, x, gen)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        step(state, x, gen)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n, (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def stage1_twin(torch, state, tx, **spec_kw):
    """A stage-1 train state on a copy (on the card) of ``state``'s weights,
    its codebooks, the spec changed by ``spec_kw`` and a fresh optimizer
    ``tx``: no initialiser draws on the host."""
    from tvqvae_tpu_torch.models.stage1 import Stage1Model
    from tvqvae_tpu_torch.train.stage1 import create_stage1_state

    with torch.device("meta"):
        model = Stage1Model(dataclasses.replace(state.model.spec, **spec_kw))
    model.load_state_dict({k: v.clone() for k, v in state.model.state_dict().items()},
                          assign=True)
    return create_stage1_state(model, state.vq_l, state.vq_h, tx)


def ess_noise(torch, spec, n, rng):
    """One ``iterative_decoding_ess`` noise dict for a batch of ``n``: the
    LF and HF passes' draws (``gumbel_noise``) and the re-decode's."""
    noise = gumbel_noise(torch, spec, n, rng)
    noise["crit"] = tuple(torch.from_numpy(
        -np.log(-np.log(rng.uniform(1e-12, 1.0, size)))).float()
        for size in ((spec.T_l - 1, n, spec.tokens_l, spec.mask_token_l),
                     (spec.T_l - 1, n, spec.tokens_l)))
    return noise


def small_ess_check(torch, devices=("cpu", "cuda")):
    """The ESS sampler of one seeded small model on the CPU and on the card
    with the same noise: the confidences within 1e-5, t_star and the tokens
    equal, the series within 2e-4 of their scale."""
    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.generation import TrainedModelSampler
    from tvqvae_tpu_torch.models.maskgit import compute_confidence_score, iterative_decoding_ess

    cfg = Config.from_dict({**SMALL_CFG, "MaskGIT": {
        **SMALL_CFG["MaskGIT"], "T": {"lf": ESS_SMALL_T, "hf": 1}, "ESS": {"use": True}}})
    Ls, n = 127, 6
    ref, dut = (TrainedModelSampler.from_init(cfg, Ls, C, 3, seed=3, device=d, batch_size=n)
                for d in devices)
    noise = ess_noise(torch, ref.mg_spec, n, np.random.default_rng(11))
    outs = []
    with torch.inference_mode():
        for s in (ref, dut):
            apply_l = lambda a, c, s=s: s.t_l(a, None, c)  # noqa: E731
            s_l, s_h, t_star = iterative_decoding_ess(
                s.mg_spec, apply_l, lambda a, b, c, s=s: s.t_h(a, b, c), s.frozen.vq_l.embed,
                n, 1, device=s.device, noise=noise)
            cond = torch.full((n, 1), 1, dtype=torch.int32, device=s.device)
            s_ref = torch.as_tensor(outs[0][1] if outs else s_l.cpu()).to(s.device)
            conf = compute_confidence_score(apply_l, s_ref, s.mg_spec.mask_token_l,
                                            s.frozen.vq_l.embed, cond)
            outs.append((t_star, s_l.cpu(), s_h.cpu(), conf.cpu()))
    conf_err = float((outs[1][3] - outs[0][3]).abs().max())
    check(conf_err <= 1e-5, f"small ESS: card vs CPU confidences off by {conf_err}")
    check(outs[0][0] == outs[1][0], f"small ESS: t_star {outs[1][0]} on the card, "
                                    f"{outs[0][0]} on the CPU")
    check(torch.equal(outs[0][1], outs[1][1]) and torch.equal(outs[0][2], outs[1][2]),
          "small ESS: card vs CPU tokens differ")
    x_ref, x_dut = (s.sample(n, "conditional", class_index=1, noise=[noise])[2] for s in (ref, dut))
    err = rel_gap(x_dut, x_ref)
    check(err <= 2e-4, f"small ESS: card vs CPU series off by {err} of their scale")
    print(f"[ess] small model card vs CPU: t_star {outs[0][0]} on both, confidences within "
          f"{conf_err:.3g}, tokens equal, series within {err:.3g} of their scale", flush=True)


def ess_phase(torch, vq_kernel, wall_ms, device="cuda"):
    """The small card-vs-CPU check; then, the counters set to 0, the ESS
    sampler of phase 4's seeded published-width weights (``ess_use``):
    ms per 32-batch beside the plain sampler's, the prior forwards a batch,
    the device's busy ms over one batch, and no VQ launch (ESS decodes
    through the codebook lookup). -> its VQ launches (0)."""
    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.generation import TrainedModelSampler

    small_ess_check(torch, devices=("cpu", device))
    sampler = TrainedModelSampler.from_init(Config.from_dict({"MaskGIT": {"ESS": {"use": True}}}),
                                            L, C, N_CLASSES, seed=0, device=device, batch_size=B)
    check(sampler.use_ess, "the ESS config did not reach the sampler")
    sampler.sample(B, seed=100)  # warm-up
    forwards = []
    hooks = [m.register_forward_pre_hook(lambda *_: forwards.append(1))
             for m in (sampler.t_l, sampler.t_h)]
    vq_kernel.launch_count = 0
    try:
        t0 = time.perf_counter()
        _, _, x = sampler.sample(ESS_BATCHES * B, seed=1)
        ms = 1e3 * (time.perf_counter() - t0) / ESS_BATCHES
    finally:
        for h in hooks:
            h.remove()
    launches = vq_kernel.launch_count
    check(x.shape == (ESS_BATCHES * B, C, L) and bool(np.isfinite(x).all()), "bad ESS samples")
    check(launches == 0, f"the ESS sampler launched the VQ kernel {launches} times")
    _, events = device_events(torch, lambda: sampler.sample(B, seed=5))
    busy = sum(d for _, d in events) / 1e3 if events else None
    print(f"[ess] published width, B={B}: {ms:.2f} ms per {B}-batch (the plain sampler "
          f"{wall_ms['sample']:.2f} ms), {len(forwards) / ESS_BATCHES:.1f} prior forwards a "
          f"batch (plain: {sampler.mg_spec.T_l + sampler.mg_spec.T_h}), device busy "
          f"{'not measured' if busy is None else f'{busy:.2f} ms'} over one batch, "
          f"VQ launches {launches}", flush=True)
    return launches


def quality_phase(torch, vq_kernel, work, device="cuda"):
    """The counters set to 0, the port's quality run
    (``scripts/quality_run.py::run``) on the card at cut budgets
    (QUALITY_STEPS, validations of QUALITY_EVAL series) with ``--bf16
    --ess``, scoring QUALITY_EVAL series by the svd FID (the JAX tool's
    Schur form costs seconds of host time a rung): every SUMMARY key of the JAX
    tool, finite; the noise rung above the floor; FID_rec through the VQ
    kernel (2 launches per 64 series). -> its VQ launches."""
    from tvqvae_tpu_torch.scripts import quality_run

    cut = json.loads(json.dumps(quality_run.CFG_OVERRIDES))
    cut["trainer_params"] = {"max_steps": dict(QUALITY_STEPS),
                             "val_check_interval": dict(QUALITY_STEPS)}
    cut["evaluation"]["min_num_gen_samples"] = QUALITY_EVAL
    args = quality_run.build_argparser().parse_args(
        ["--workdir", os.path.join(work.root, "qr"), "--bf16", "--ess", "--n_eval",
         str(QUALITY_EVAL), "--fid_method", "svd", "--device", device])
    vq_kernel.launch_count = 0
    summary, details = quality_run.run(args, overrides=cut)
    launches = vq_kernel.launch_count
    check(set(summary) == set(quality_run.SUMMARY_KEYS) | {"ess_ms_per_32batch", "fid_gen_ess"},
          f"SUMMARY keys {sorted(summary)}")
    bad = [k for k, v in summary.items() if not isinstance(v, bool) and not np.isfinite(v)]
    check(not bad, f"non-finite SUMMARY values {bad}")
    check(summary["fid_noise"] > summary["fid_floor"],
          f"fid_noise {summary['fid_noise']} not above fid_floor {summary['fid_floor']}")
    rec = details["vq_launches"]["rec"]
    check(rec == 2 * -(-QUALITY_EVAL // 64), f"FID_rec launched the VQ kernel {rec} times")
    check(launches == details["vq_launches"]["train"] + rec and launches > rec,
          f"quality-run VQ launches {launches} against {details['vq_launches']}")
    print(f"[quality] {QUALITY_STEPS} steps, n_eval {QUALITY_EVAL}: " + ", ".join(
        f"{k} {summary[k]:.5f}" for k in ("fid_floor", "fid_rec", "fid_gen", "fid_gen_fe",
                                          "fid_gen_ess", "fid_noise"))
          + f"; ESS {summary['ess_ms_per_32batch']:.2f} ms per 32-batch; minutes by stage "
          f"{ {k: round(v, 3) for k, v in details['stage_minutes'].items()} }, median ms a step "
          f"{details['step_ms_p50']}; VQ launches {launches} ({rec} in FID_rec)", flush=True)
    return launches


def bf16_phase(torch, vq_kernel, work, sampler, series, rec32, wall_ms, data, frozen, trained,
               f32, device="cuda"):
    """The JAX package's production recipe under ``--bf16`` at the published
    width, counted on its own (``launches_by_path.bf16``): phase 4's seeded
    weights under the JAX sampler's bfloat16 defaults (``fast_bn``,
    ``bf16_head``, ``bf16_istft``), its tokens equal to the float32
    sampler's under the same noise and its series within
    ``BF16_PUBLISHED`` of their scale, the stages trained in phases 7-8
    read ``from_checkpoints`` in bfloat16 within 0.06 of phase 8's float32
    decode of the same tokens, ms per batch and device busy beside the
    float32 sampler's and beside the same weights in float32 with
    ``fast_bn`` (the generate and serve CLIs' default; tokens equal, series
    within 5e-4 of scale), the bfloat16 batch's top device ops, and
    ``reconstruct`` of 64 series (4 VQ launches); ``train_stage1`` with
    ``compute_dtype="bfloat16"``, ``fast_bn``, ``bf16_mu``, ``bf16_head``
    for 20 steps (loss finite and falling, Adam's first moment stored in
    bfloat16, steady ms per step and memory beside the float32 run's), then
    ``BF16_TIMED_STEPS`` steps each of the runner's float32 defaults and
    the train CLI's (float32, ``fast_bn``, ``bf16_mu``) on phase 7's
    weights and of the production recipe with and without ``remat``, and
    the device time of a remat step; ``train_stage3`` with a bfloat16
    stream and ``fast_norm`` for 10 steps (its ms per step and the memory
    it adds). ``f32``: the float32 runs' numbers. -> the VQ kernel
    launches."""
    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.generation import TrainedModelSampler
    from tvqvae_tpu_torch.models.maskgit import decode_tokens, iterative_decoding
    from tvqvae_tpu_torch.train.runner import _adamw, train_stage1, train_stage3
    from tvqvae_tpu_torch.train.stage1 import make_stage1_train_step
    from tvqvae_tpu_torch.utils import convert

    vq_kernel.launch_count = 0
    laps = [time.perf_counter()]
    # phase 4's weights in the sampler's own tree layout: no initialiser draws on the host
    f = sampler.frozen
    trees = (convert.stage1_to_jax(f.model, f.vq_l, f.vq_h),
             dict(zip(("params", "h_stats"), convert.prior_to_jax(sampler.t_l, sampler.t_h))))

    def twin(**precision):
        return TrainedModelSampler(Config(), *trees, input_length=L, in_channels=C,
                                   n_classes=N_CLASSES, batch_size=B, device=device, **precision)

    s16, s32f = twin(compute_dtype="bfloat16", fast_bn=True), twin(fast_bn=True)
    build_s = time.perf_counter() - laps[0]
    sp = s16.s1_spec
    check((sp.compute_dtype, sp.fast_bn, sp.bf16_head, sp.bf16_istft)
          == ("bfloat16", True, True, True), f"the bfloat16 sampler's spec: {sp}")
    check((s32f.s1_spec.compute_dtype, s32f.s1_spec.fast_bn) == ("float32", True),
          f"the fast_bn sampler's spec: {s32f.s1_spec}")
    noise = gumbel_noise(torch, s16.mg_spec, B, np.random.default_rng(11))
    with torch.inference_mode():
        toks = [iterative_decoding(s.mg_spec, lambda a, c, s=s: s.t_l(a, None, c),
                                   lambda a, b, c, s=s: s.t_h(a, b, c), B, None, device=device,
                                   noise=noise) for s in (sampler, s16, s32f)]
    check(all(torch.equal(a, b) for t in toks[1:] for a, b in zip(toks[0], t)),
          "the bfloat16 or fast_bn sampler's tokens differ from the float32 sampler's")
    x32, x16, x32f = (s.sample(B, noise=[noise]) for s in (sampler, s16, s32f))
    gaps = [rel_gap(a, b) for a, b in zip(x16, x32)]
    check(all(bool(np.isfinite(a).all()) for a in x16) and 0.0 < max(gaps) <= BF16_PUBLISHED,
          f"bfloat16 samples off the float32 ones by {gaps} of their scale")
    f_gaps = [rel_gap(a, b) for a, b in zip(x32f, x32)]
    check(max(f_gaps) <= 5e-4, f"float32 fast_bn samples off the float32 ones by {f_gaps}")
    # the stages trained in phases 7-8: the bfloat16 sampler from their checkpoints against
    # phase 8's float32 stage 1 (read from the same checkpoint) decoding the same tokens
    laps.append(time.perf_counter())
    trained16 = TrainedModelSampler.from_checkpoints(Config(), work.stage["1"], work.stage["2"],
                                                     batch_size=B, device=device,
                                                     compute_dtype="bfloat16", fast_bn=True)
    t16 = trained16.sample(B, noise=[noise])
    with torch.inference_mode():
        toks = iterative_decoding(trained16.mg_spec, lambda a, c: trained16.t_l(a, None, c),
                                  lambda a, b, c: trained16.t_h(a, b, c), B, None, device=device,
                                  noise=noise)
        t32 = [decode_tokens(frozen, t, band).cpu().numpy() for t, band in zip(toks, ("lf", "hf"))]
    t_gaps = [rel_gap(a, b) for a, b in zip(t16, (*t32, t32[0] + t32[1]))]
    check(all(bool(np.isfinite(a).all()) for a in t16) and 0.0 < max(t_gaps) <= BF16_STACK,
          f"trained bfloat16 samples off the float32 ones by {t_gaps} of their scale")
    del trained16
    laps.append(time.perf_counter())
    ms_by = {}
    for name, s in (("bfloat16", s16), ("float32 fast_bn", s32f)):
        s.sample(B, seed=100)  # warm-up, as phase 4's
        t0 = time.perf_counter()
        s.sample(4 * B, seed=1)
        ms_by[name] = 1e3 * (time.perf_counter() - t0) / 4
    busy = {name: sum(d for _, d in device_events(torch, lambda s=s: s.sample(B, seed=5))[1]) / 1e3
            for name, s in (("float32", sampler), ("float32 fast_bn", s32f))}
    busy["bfloat16"] = print_profile(f"bf16 sample of {B}", lambda: s16.sample(B, seed=5),
                                     ms_by["bfloat16"])
    print(f"[bf16] sampler at the published width (compute_dtype bfloat16, fast_bn, bf16_head, "
          f"bf16_istft; phase 4's seeded weights; it and the float32 fast_bn twin built in "
          f"{build_s:.1f} s); a {B}-batch with the same noise: tokens equal to the float32 "
          f"sampler's, x_l/x_h/x within {', '.join(f'{g:.3g}' for g in gaps)} of the float32 "
          f"series' scale (bound {BF16_PUBLISHED}); {ms_by['bfloat16']:.2f} ms per {B}-batch "
          f"against {wall_ms['sample']:.2f} in float32; device busy {busy['bfloat16']:.2f} ms "
          f"against {busy['float32']:.2f}; the trained stages from their checkpoints, the same "
          f"noise: x_l/x_h/x within {', '.join(f'{g:.3g}' for g in t_gaps)} of the float32 "
          f"series' scale (bound {BF16_STACK})", flush=True)
    print(f"[bf16] the same weights in float32 with fast_bn (the generate and serve CLIs' "
          f"default): tokens equal, x_l/x_h/x within {', '.join(f'{g:.3g}' for g in f_gaps)} of "
          f"scale (bound 5e-4); {ms_by['float32 fast_bn']:.2f} ms per {B}-batch against "
          f"{wall_ms['sample']:.2f}; device busy {busy['float32 fast_bn']:.2f} ms against "
          f"{busy['float32']:.2f}", flush=True)
    del s32f

    before = vq_kernel.launch_count
    t0 = time.perf_counter()
    rec16 = s16.reconstruct(series)
    rec_ms = 1e3 * (time.perf_counter() - t0)
    check(vq_kernel.launch_count - before == 4 and rec16.shape == series.shape
          and bool(np.isfinite(rec16).all()),
          f"bfloat16 reconstruct: {vq_kernel.launch_count - before} VQ launches, not 4")
    print(f"[bf16] reconstruct of {2 * B} series: {rec_ms:.1f} ms against "
          f"{2 * wall_ms['reconstruct']:.1f} in float32, 4 VQ launches (float32 latents from the "
          f"bfloat16 encoders); {rel_gap(rec16, rec32):.3g} of scale from the float32 round trip "
          f"(a token that flips at a near-tie moves its series)", flush=True)
    del s16

    laps.append(time.perf_counter())
    cfg = Config()
    rec = StepRecorder(torch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = vq_kernel.launch_count
    t0 = time.perf_counter()
    state = train_stage1(cfg, data, max_steps=BF16_TRAIN_STEPS, device=device, logger=rec,
                         log_interval=1, **PRODUCTION)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    added = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    launches = vq_kernel.launch_count - before
    n_test = len(data.X_test)
    val_batches = -(-n_test // min(cfg.dataset.batch_sizes["stage1"], n_test))
    expected = 2 * BF16_TRAIN_STEPS + 2 * val_batches
    check(launches == expected, f"bfloat16 train_stage1: {launches} VQ launches, not {expected}")
    losses = [float(v) for v in rec.losses]
    check(len(losses) == BF16_TRAIN_STEPS and bool(np.isfinite(losses).all()),
          f"bfloat16 train_stage1 losses {losses}")
    warm = int(BF16_TRAIN_STEPS * cfg.exp_params.linear_warmup_rate)
    first, last = float(np.mean(losses[warm:warm + 5])), float(np.mean(losses[-5:]))
    check(last < first, f"bfloat16 stage-1 loss did not fall: {first} then {last}")
    moments = list(state.optimizer.state.values())
    check(len(moments) == len(list(state.model.parameters()))
          and all(m["exp_avg"].dtype == torch.bfloat16 and m["exp_avg_sq"].dtype == torch.float32
                  for m in moments), "Adam's first moment is not stored in bfloat16")
    ms = rec.events[warm].elapsed_time(rec.events[-1]) / (BF16_TRAIN_STEPS - 1 - warm)
    mu_gb = sum(m["exp_avg"].numel() * 2 for m in moments) / 2 ** 30
    print(f"[bf16] train_stage1 at the published width with the production recipe "
          f"({', '.join(f'{k}={v}' for k, v in PRODUCTION.items())}): {BF16_TRAIN_STEPS} steps in "
          f"{wall:.1f} s (with init and validation); steady {ms:.2f} ms/step against "
          f"{f32['train_ms']:.2f} in float32 (CUDA events, steps {warm + 2}-{BF16_TRAIN_STEPS}); "
          f"{added:.2f} GiB above what was allocated before, against {f32['train_gb']:.2f}; loss "
          f"step 1 {losses[0]:.4f}, mean of steps {warm + 1}-{warm + 5} {first:.4f}, of the last 5 "
          f"{last:.4f}; Adam's first moment in bfloat16 ({len(moments)} tensors, {mu_gb:.3f} GiB), "
          f"the second in float32; VQ launches {launches}", flush=True)

    # a few steps of each recipe on one batch, each on weights copied on the card
    laps.append(time.perf_counter())
    x = torch.from_numpy(data.X_train[:B]).to(device)
    gen = torch.Generator(device=device).manual_seed(3)
    step = make_stage1_train_step()
    tx = _adamw(cfg, BF16_TRAIN_STEPS)
    tx_mu = _adamw(cfg, BF16_TRAIN_STEPS, bf16_mu=True)
    cost = {}
    for name, base_state, t, kw in (
            ("float32, the runner's defaults", trained, tx, {}),
            ("float32, the train CLI's defaults (fast_bn, bf16_mu)", trained, tx_mu,
             dict(fast_bn=True, bf16_head=True)),
            ("the production recipe", state, None, {}),
            ("the production recipe with remat", state, tx_mu, dict(remat=True))):
        st = state if t is None else stage1_twin(torch, base_state, t, **kw)
        cost[name] = steps_cost(torch, step, st, x, gen)
        check(all(np.isfinite(v) for v in cost[name]), f"{name}: steps not measured")
        if kw.get("remat"):
            print_profile(f"bf16 remat train step of {B}", lambda: step(st, x, gen),
                          cost[name][0], n_convs=0)
        del st
    print(f"[bf16] published-width stage-1 steps on one batch ({BF16_TIMED_STEPS} after a "
          f"warm-up, CUDA events; ms/step, GiB the peak rises above what was allocated before): "
          + "; ".join(f"{n} {c[0]:.2f} ms, {c[1]:.2f} GiB" for n, c in cost.items()), flush=True)
    print_profile(f"bf16 train step of {B}", lambda: step(state, x, gen),
                  cost["the production recipe"][0], n_convs=0)
    del state

    laps.append(time.perf_counter())
    rec3 = StepRecorder(torch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = vq_kernel.launch_count
    st3 = train_stage3(cfg, data, frozen, max_steps=BF16_STAGE3_STEPS, device=device, logger=rec3,
                       log_interval=1, compute_dtype="bfloat16", fast_norm=True, bf16_mu=True)
    torch.cuda.synchronize()
    added3 = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    launches3 = vq_kernel.launch_count - before
    check(launches3 == 2 * -(-len(data.X_train) // XPRIME_BATCH),
          f"bfloat16 train_stage3: {launches3} VQ launches")
    losses3 = [float(v) for v in rec3.losses]
    check(len(losses3) == BF16_STAGE3_STEPS and bool(np.isfinite(losses3).all()),
          f"bfloat16 stage-3 losses {losses3}")
    unet = st3.fe.Unet1D_0
    check(getattr(unet, unet.stem).compute_dtype == torch.bfloat16, "the enhancer is not bfloat16")
    w = 3
    ms3 = rec3.events[w].elapsed_time(rec3.events[-1]) / (BF16_STAGE3_STEPS - 1 - w)
    print(f"[bf16] train_stage3 at the published width, the stream in bfloat16 with fast_norm and "
          f"bf16_mu: {BF16_STAGE3_STEPS} steps, steady {ms3:.3f} ms/step against "
          f"{f32['stage3_ms']:.3f} in float32 (steps {w + 2}-{BF16_STAGE3_STEPS}); "
          f"{added3:.3f} GiB above what was allocated before (the x' sweep's {launches3} VQ "
          f"launches included) against {f32['stage3_gb']:.3f}; loss step 1 {losses3[0]:.4f}, step "
          f"{BF16_STAGE3_STEPS} {losses3[-1]:.4f}", flush=True)
    laps.append(time.perf_counter())
    print("[bf16] seconds by part: " + ", ".join(
        f"{name} {b - a:.1f}" for name, a, b in zip(
            ("samplers", "trained samplers", "timing and reconstruct", "train_stage1",
             "step comparison", "train_stage3"), laps, laps[1:])), flush=True)
    return vq_kernel.launch_count


def small_bf16_check(torch, devices=("cpu", "cuda")):
    """The same seeded small models in bfloat16 on the CPU (plain versions)
    and on the card (kernel): a sampler with the JAX sampler's bfloat16
    defaults, same noise: series within 0.06 of their scale; one stage-1
    step with the production recipe: loss within 2e-2 relative (the VQ
    indices may flip at bfloat16 near-ties; the count is printed); one
    enhancer step (bfloat16 stream, fast_norm, dropout 0): loss within 2e-2
    relative and each gradient within 5e-2 of its scale plus twice the CPU's
    own bfloat16-vs-float32 gap on that leaf, the median within 5e-2 (the
    bounds of ``tests/test_torch_precision_paths.py``)."""
    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.generation import TrainedModelSampler
    from tvqvae_tpu_torch.models.fidelity_enhancer import FidelityEnhancer
    from tvqvae_tpu_torch.models.stage1 import Stage1Spec, init_stage1
    from tvqvae_tpu_torch.train.runner import _adamw
    from tvqvae_tpu_torch.train.stage1 import create_stage1_state, make_stage1_train_step
    from tvqvae_tpu_torch.train.stage3 import (
        create_stage3_state,
        init_stage3,
        make_stage3_train_step_pre,
    )

    cfg = Config.from_dict({**SMALL_CFG,
                            "encoder": {**SMALL_CFG["encoder"], "dropout": 0.0},
                            "decoder": {**SMALL_CFG["decoder"], "dropout": 0.0},
                            "fidelity_enhancer": {**SMALL_CFG["fidelity_enhancer"],
                                                  "dropout": 0.0}})
    Ls, n = 127, 6
    samplers = [TrainedModelSampler.from_init(cfg, Ls, C, 3, seed=3, device=d, batch_size=n,
                                              compute_dtype="bfloat16", fast_bn=True)
                for d in devices]
    noise = gumbel_noise(torch, samplers[0].mg_spec, n, np.random.default_rng(6))
    ref, dut = (s.sample(n, "conditional", class_index=1, noise=[noise]) for s in samplers)
    x_gaps = [rel_gap(a, b) for a, b in zip(dut, ref)]
    check(max(x_gaps) <= BF16_STACK, f"small bfloat16 sampler: card vs CPU {x_gaps} of scale")

    xs = np.random.default_rng(9).normal(size=(n, C, Ls)).astype(np.float32)
    spec = Stage1Spec.from_config(cfg, Ls, C, **{k: v for k, v in PRODUCTION.items()
                                                  if k != "bf16_mu"})
    s1 = []
    for dev in devices:
        model, vq_l, vq_h = init_stage1(spec, torch.Generator().manual_seed(3), dev)
        st = create_stage1_state(model, vq_l, vq_h, _adamw(cfg, SMALL_STEPS, bf16_mu=True))
        seen = []
        model.register_forward_hook(lambda m, i, o, seen=seen: seen.append(
            (o.vq_l.indices.cpu(), o.vq_h.indices.cpu())))
        s1.append((make_stage1_train_step()(st, torch.from_numpy(xs).to(dev))[1]["loss"].item(),
                   seen[0]))
    s1_err = abs(s1[1][0] - s1[0][0]) / abs(s1[0][0])
    flips = sum(int((a != b).sum()) for a, b in zip(s1[0][1], s1[1][1]))
    check(s1_err <= 2e-2, f"small bfloat16 stage-1 step: card vs CPU loss off by {s1_err}")

    xp = (0.8 * xs + 0.3 * np.random.default_rng(10).normal(size=xs.shape)).astype(np.float32)
    grads = {}
    for dev, dt in ((devices[0], "float32"), *((d, "bfloat16") for d in devices)):
        fe = init_stage3(FidelityEnhancer.from_config(cfg, Ls, C, dt, fast_norm=True),
                         torch.Generator().manual_seed(4), dev)
        st = create_stage3_state(fe, _adamw(cfg, SMALL_STEPS, bf16_mu=True))
        loss = make_stage3_train_step_pre()(st, torch.from_numpy(xs).to(dev),
                                            torch.from_numpy(xp).to(dev))[1]["loss"].item()
        grads[(dev, dt)] = loss, {k: p.grad.cpu() for k, p in fe.named_parameters()}
    (l32, g32), (lr, gr), (ld, gd) = (grads[k] for k in ((devices[0], "float32"),
                                                         (devices[0], "bfloat16"),
                                                         (devices[1], "bfloat16")))
    fe_err = abs(ld - lr) / abs(lr)
    check(fe_err <= 2e-2, f"small bfloat16 enhancer step: card vs CPU loss off by {fe_err}")
    gaps = {k: (rel_gap(gd[k], gr[k]), rel_gap(gr[k], g32[k])) for k in gr}
    bad = {k: v for k, v in gaps.items() if v[0] > 5e-2 + 2 * v[1]}
    med = float(np.median([v[0] for v in gaps.values()]))
    check(not bad and med <= 5e-2, f"small bfloat16 enhancer gradients: card vs CPU {bad}, "
                                   f"median {med}")
    worst = max(gaps, key=lambda k: gaps[k][0])
    print(f"[bf16] small model card vs CPU, both bfloat16: samples within "
          f"{', '.join(f'{g:.3g}' for g in x_gaps)} of scale (bound {BF16_STACK}); a stage-1 step "
          f"with the production recipe: loss {s1[1][0]:.6f} vs {s1[0][0]:.6f}, rel err "
          f"{s1_err:.3g} (bound 2e-2), {flips} VQ indices of {sum(a.numel() for a in s1[0][1])} "
          f"flipped; an enhancer step: loss rel err {fe_err:.3g}, gradients median {med:.3g}, "
          f"worst {gaps[worst][0]:.3g} ({worst}, whose CPU bfloat16 gradient is "
          f"{gaps[worst][1]:.3g} from the float32 one)", flush=True)


def small_model_check(torch, Config, TrainedModelSampler, devices=("cpu", "cuda")):
    """The same seeded small model on the CPU (plain versions) and on the
    card (kernel), with the same injected noise: equal tokens, series within
    1e-4."""
    from tvqvae_tpu_torch.models.maskgit import encode_tokens

    cfg = Config.from_dict(SMALL_CFG)
    Ls, n = 127, 6
    ref, dut = (TrainedModelSampler.from_init(cfg, Ls, C, 3, seed=3, device=d, batch_size=n)
                for d in devices)
    spec = ref.mg_spec
    rng = np.random.default_rng(5)
    noise = gumbel_noise(torch, spec, n, rng)
    x_ref, x_dut = (s.sample(n, "conditional", class_index=1, noise=[noise])[2] for s in (ref, dut))
    err = float(np.abs(x_dut - x_ref).max())
    check(err <= 1e-4, f"small model: card vs CPU sample off by {err}")
    series = rng.normal(size=(n, C, Ls)).astype(np.float32)
    with torch.inference_mode():
        for band in ("lf", "hf"):
            t_ref, t_dut = (encode_tokens(s.frozen, torch.from_numpy(series).to(s.device), band)
                            .cpu() for s in (ref, dut))
            check(torch.equal(t_ref, t_dut), f"small model: {band} tokens differ")
    rec_err = float(np.abs(dut.reconstruct(series) - ref.reconstruct(series)).max())
    check(rec_err <= 1e-4, f"small model: card vs CPU reconstruct off by {rec_err}")
    print(f"[reference] small model card vs CPU: sample err {err:.3g}, "
          f"reconstruct err {rec_err:.3g}, tokens equal", flush=True)


def fly_tracks(rng, n_pairs, length, stride, flown_noise=0.005):
    """``n_pairs`` generated tracks of ``length`` [lat, lon] points along the
    EHAM -> LIMC great circle (slerp of the endpoints' unit vectors) with
    smooth noise (three low sines of ~0.03 deg), each with a flown
    counterpart: every ``stride``-th point with ``flown_noise`` deg of
    Gaussian noise. -> (gens, sims) lists of float32 arrays."""
    from tvqvae_tpu_torch.data.preprocess import AIRPORTS

    def unit(lat, lon):
        la, lo = np.radians(lat), np.radians(lon)
        return np.array([np.cos(la) * np.cos(lo), np.cos(la) * np.sin(lo), np.sin(la)])

    a, b = unit(*AIRPORTS["EHAM"]), unit(*AIRPORTS["LIMC"])
    omega = np.arccos(np.clip(a @ b, -1, 1))
    t = np.linspace(0, 1, length)[:, None]
    xyz = (np.sin((1 - t) * omega) * a + np.sin(t * omega) * b) / np.sin(omega)
    route = np.stack([np.degrees(np.arcsin(xyz[:, 2])),
                      np.degrees(np.arctan2(xyz[:, 1], xyz[:, 0]))], 1)
    gens, sims = [], []
    for _ in range(n_pairs):
        smooth = sum(rng.normal(0, 0.03, 2) * np.sin(np.pi * k * t + rng.uniform(0, np.pi))
                     for k in (1, 2, 3))
        gen = route + smooth
        flown = gen[::stride] + rng.normal(0, flown_noise, gen[::stride].shape)
        gens.append(gen.astype(np.float32))
        sims.append(flown.astype(np.float32))
    return gens, sims


def fly_batch(rng):
    """The [flyability] batch: FLY_PAIRS generated tracks of L points with
    their flown tracks at every FLY_STRIDE-th point, and FLY_LONG_PAIRS whose
    flown tracks keep every point. -> (gens, sims)."""
    gens, sims = fly_tracks(rng, FLY_PAIRS, L, FLY_STRIDE)
    long_gens, _ = fly_tracks(rng, FLY_LONG_PAIRS, L, 1)
    gens += long_gens
    sims += [g + rng.normal(0, 0.005, g.shape).astype(np.float32) for g in long_gens]
    return gens, sims


def fly_bound(n, m, variants=None, reached=None):
    """Least time of one traj_dp launch (``variants`` given) or one Frechet
    call (``reached`` given: (30, B) cells that each sequential decision
    reaches, ``frechet_kernel.reached_cells``) over pairs of true lengths
    ``n``, ``m``: the bytes they need read once (their points, lengths, and
    hi) and written once at HBM_BYTES_PER_S, or the fp32 operations at
    FP32_FLOPS, the larger. The DP's operations cover the true grids: a
    cell's cost once for each metric the variants use, one step a variant; the
    Frechet's the reached cells at every step and, once, the most cells one
    step reaches (a larger eps reaches a superset). -> (ms, bound_by, ops)."""
    points = 8 * (sum(n) + sum(m))
    if variants is None:
        reached = np.asarray(reached, np.int64)
        ops = FRECHET_STEP_OPS * int(reached.sum()) + FRECHET_CELL_OPS * int(reached.max(0).sum())
        nbytes = points + len(n) * (8 + 4 + 4)
    else:
        cells = sum(a * b for a, b in zip(n, m))
        metrics = dict.fromkeys(metric for _, metric, _ in variants)  # a cost once a metric
        ops = cells * (sum(DP_COST_OPS[metric] for metric in metrics)
                       + sum(DP_STEP_OPS[kind] for kind, _, _ in variants))
        nbytes = points + len(n) * (8 + 4 * len(variants))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", ops


def fly_device_ms(torch, fn):
    """{kernel: [device ms of each launch, in launch order]} of the
    flyability kernels over one call of ``fn`` (torch.profiler), and the
    call's device busy ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches, busy = {k: [] for k in FLY_KERNELS}, 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        dur = (e.time_range.end - e.time_range.start) / 1e3
        busy += dur
        for k in FLY_KERNELS:
            if k in e.name:
                launches[k].append((e.time_range.start, dur))
    return {k: [d for _, d in sorted(v)] for k, v in launches.items()}, busy


def frechet_plain_start(torch, D, p, q, n, m, hi, device="cuda"):
    """Start ``distances.frechet_bisect`` on pairs of true lengths n, m whose
    padding repeats their last point (as ``frechet_bisect`` pads): its 30
    bisection steps of the plain decision ``_frechet_decision``, which also
    counts each step's reached cells. Eagerly each step is ~1.6e5
    launches from the host; on the card the decision is captured once in a
    CUDA graph and the steps are replayed on a side stream, which leaves the
    host free for other work meanwhile. The tensors made on the current
    stream are marked as used by the side stream, and the graph (with its
    memory pool) lives until the replays have run, so that nothing the
    replays read or write is handed to other work before. Capturing a graph
    waits for the whole card: start the shorter of two first. -> a function
    that waits and returns (hi, ms: the capture's host time plus the
    replays' device time, (30, B) int64 reached cells)."""
    t0 = time.perf_counter()
    lengths = tuple(torch.as_tensor(x, dtype=torch.int64, device=p.device) for x in (n, m))
    lo = torch.maximum(torch.sqrt(D._sq_dist(p[:, 0], q[:, 0])),
                       torch.sqrt(D._sq_dist(p[:, -1], q[:, -1])))
    eps = 0.5 * (lo + hi)
    cells = []
    if device != "cuda":  # the CPU rehearsal: eagerly
        for _ in range(D.BISECTION_STEPS):
            eps = 0.5 * (lo + hi)
            ok, c = D._frechet_decision(p, q, eps, lengths)
            cells.append(c)
            lo, hi = torch.where(ok, lo, eps), torch.where(ok, eps, hi)
        return lambda: (hi, 1e3 * (time.perf_counter() - t0), torch.stack(cells))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    for t in (p, q, lo, hi, eps, *lengths):
        t.record_stream(side)
    with torch.cuda.stream(side):
        D._frechet_decision(p, q, eps, lengths)  # warm-up outside the capture
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            ok, count = D._frechet_decision(p, q, eps, lengths)
        capture_ms = 1e3 * (time.perf_counter() - t0)
        first, last = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        first.record(side)
        for _ in range(D.BISECTION_STEPS):
            eps.copy_(0.5 * (lo + hi))
            graph.replay()
            cells.append(count.clone())
            lo, hi = torch.where(ok, lo, eps), torch.where(ok, eps, hi)
        last.record(side)

    def finish():
        last.synchronize()
        torch.cuda.current_stream().wait_stream(side)
        graph.reset()  # the replays have run: its pool may go
        return hi, capture_ms + first.elapsed_time(last), torch.stack(cells)

    return finish


def fly_bucket_inputs(torch, D, gens, sims, out, device):
    """The batch's buckets as ``_score_bucket`` receives them, in launch
    order (``distances.shape_buckets``): {key: (indices, p, q, n, m, hi)}, hi
    the batch's discrete Frechet (float32 values, exact through Python
    floats)."""
    return {key: (idxs, p, q, n, m,
                  torch.tensor([out["Discrete Frechet"][i] for i in idxs], dtype=torch.float32,
                               device=device))
            for key, (idxs, p, q, n, m) in D.shape_buckets(gens, sims, device).items()}


def fly_plan(frechet_kernel, B, mmax, device, depth=None):
    """The Frechet kernel's launch plan on the card; in a CPU rehearsal the
    rule on an H100's 132 SMs at one block an SM."""
    if device == "cuda":
        return frechet_kernel.card_plan(B, mmax, device, depth)
    return frechet_kernel.launch_plan(B, mmax, 132, lambda *a: 1, depth)


def fly_dp_plan(traj_dp_kernel, B, ntasks, nmax, mmax, device):
    """The DP kernel's launch plan on the card; in a CPU rehearsal the rule
    on an H100's 132 SMs at one block an SM."""
    if device == "cuda":
        return traj_dp_kernel.card_plan(B, ntasks, nmax, mmax, device)
    return traj_dp_kernel.launch_plan(B, ntasks, nmax, mmax, 132, lambda *a: (1, 132))


def fly_dp_steps(plan):
    """The DP pipeline's dependent steps at a plan: its rows, then a step
    for each lane across its columns."""
    return plan.rows + plan.cols - 1


def fly_dp_other_plan(traj_dp_kernel, plan):
    """Another DP plan over the same grids: a cluster one block narrower,
    or two blocks where the plan has one; where the columns fit one strip,
    the lanes across the other side."""
    nmax, mmax = (plan.cols, plan.rows) if plan.swap else (plan.rows, plan.cols)
    other = traj_dp_kernel.make_plan(nmax, mmax, plan.cluster - 1 if plan.cluster > 1 else 2,
                                     plan.swap)
    return other if other != plan else traj_dp_kernel.make_plan(nmax, mmax, 1, not plan.swap)


def fly_reached(torch, frechet_kernel, D, p, q, n, m, hi, device):
    """(30, B) cells that the 30 sequential decisions reach: the kernel's
    count on the card; in a CPU rehearsal the plain decision's."""
    if device == "cuda":
        return frechet_kernel.reached_cells(p, q, n, m, hi).cpu()
    return frechet_plain_start(torch, D, p, q, n, m, hi, device)()[2]


def flyability_phase(torch, device="cuda"):
    """[flyability]: the counters set to 0, the 14 metrics of FLY_PAIRS +
    FLY_LONG_PAIRS synthetic pairs through ``calculate_trajectory_distances_batch``
    on the card (two buckets: one launch of the DP kernel a bucket and the
    rounds of the Frechet kernel's plan); wall ms, pairs/s, each kernel's
    device ms per launch; each bucket's Frechet equal to the kernel at depth 1
    on the same inputs, its ms a call beside depth 1's (events, in turns),
    depth, rounds, blocks and ns a dependent step; each bucket's DP plan,
    bound (a cost a metric and a step a variant over its cells) and ns a
    dependent step; then each kernel held to its plain version on
    the card (DP family: EDR, LCSS exactly, the discrete Frechet 1e-6, DTW and
    ERP 1e-5 relative; the Frechet 1e-5 relative), also at the launch plans
    of the full-length buckets (each bucket's Frechet plan on its pairs cut
    to FLY_BRANCH_ROWS rows, equal to depth 1 there too, its DP plan on
    them cut to FLY_DP_BRANCH_ROWS rows; each bucket's batch values equal
    to a standalone DP launch at another plan), with ms (events), the plain
    version's ms and
    the bound at those inputs (the Frechet's over the cells its decisions
    reach: the kernel's count, equal to the plain decision's at the check
    inputs and the cuts), and SSPD / Hausdorff of the batch against the
    plain version on the card (1e-5 relative) and on the CPU. -> the
    kernels' JSON entries."""
    from tvqvae_tpu_torch.data.preprocess import AIRPORTS
    from tvqvae_tpu_torch.evaluation.flyability import distances as D
    from tvqvae_tpu_torch.ops import frechet_kernel, traj_dp_kernel

    rng = np.random.default_rng(20)
    gens, sims = fly_batch(rng)
    adep = AIRPORTS["EHAM"]
    buckets = list(dict.fromkeys((D._bucket_size(len(a)), D._bucket_size(len(b)))
                                 for a, b in zip(gens, sims)))  # in the batch's launch order
    D.calculate_trajectory_distances_batch(gens[:1], sims[:1], adep, device=device)  # warm-up

    traj_dp_kernel.launch_count = frechet_kernel.launch_count = 0
    t0 = time.perf_counter()
    out = D.calculate_trajectory_distances_batch(gens, sims, adep, device=device)
    wall = time.perf_counter() - t0
    launches = {"traj_dp": traj_dp_kernel.launch_count, "frechet": frechet_kernel.launch_count}
    inputs = fly_bucket_inputs(torch, D, gens, sims, out, device)
    check(list(inputs) == buckets, f"buckets {list(inputs)} against {buckets}")
    plans = {key: fly_plan(frechet_kernel, len(idxs), int(m.max()), device)
             for key, (idxs, _, _, _, m, _) in inputs.items()}
    variants = D.dp_variants()
    spec = [v[1:] for v in variants]
    ntasks = len(traj_dp_kernel.tasks(spec))
    dp_plans = {key: fly_dp_plan(traj_dp_kernel, len(idxs), ntasks, int(n.max()), int(m.max()),
                                 device)
                for key, (idxs, _, _, n, m, _) in inputs.items()}
    rounds = [plans[key].rounds for key in buckets]
    check(launches == {"traj_dp": len(buckets), "frechet": sum(rounds)},
          f"flyability launches {launches}, buckets {buckets}, the plans' rounds {rounds}")
    # each bucket's batch values: the same bits from its pairs alone at
    # another DP plan (another cluster size, so other strips cross blocks)
    dp_others = {}
    for key, (idxs, bp, bq, bn, bm, _) in inputs.items():
        other = dp_others[key] = fly_dp_other_plan(traj_dp_kernel, dp_plans[key])
        check(other != dp_plans[key], f"traj_dp bucket {key}: no other plan than {dp_plans[key]}")
        alone = traj_dp_kernel.traj_dp(bp, bq, bn, bm, adep, spec, plan=other).cpu().numpy()
        for j, (vkey, *_) in enumerate(variants):
            check(np.array_equal(alone[:, j], np.asarray(out[vkey])[list(idxs)].astype(np.float32)),
                  f"traj_dp {vkey} of bucket {key}: the batch's values differ from its pairs "
                  f"alone at plan {tuple(other[:3])}")
    check(set(out) == set(D.KEYS) and all(len(v) == len(gens) for v in out.values()),
          f"flyability keys {sorted(out)}")
    bad = [k for k, v in out.items() if not np.isfinite(v).all()]
    check(not bad, f"non-finite flyability metrics {bad}")
    check(all(f <= df + 1e-5 for f, df in zip(out["Frechet"], out["Discrete Frechet"])),
          "Frechet above the discrete Frechet")
    by_kernel, busy = fly_device_ms(
        torch, lambda: D.calculate_trajectory_distances_batch(gens, sims, adep, device=device))
    dp_launch_ms = by_kernel["traj_dp_kernel"]
    check(device != "cuda" or len(dp_launch_ms) == len(buckets),
          f"profiled {len(dp_launch_ms)} DP launches, the batch has {len(buckets)} buckets")
    fr_launch_ms = by_kernel["frechet_kernel"]
    check(device != "cuda" or len(fr_launch_ms) == sum(rounds),
          f"profiled {len(fr_launch_ms)} Frechet launches, the plans give {sum(rounds)}")
    edges = np.cumsum([0] + rounds)
    fr_batch_ms = [float(sum(fr_launch_ms[a:b])) for a, b in zip(edges[:-1], edges[1:])]
    print(f"[flyability] {len(gens)} pairs in buckets {buckets}: {1e3 * wall:.1f} ms wall, "
          f"{len(gens) / wall:.1f} pairs/s; launches {launches}; device busy {busy:.2f} ms; "
          f"traj_dp_kernel ms a launch by bucket {[round(t, 3) for t in dp_launch_ms]}"
          f"; frechet_kernel ms a bucket (its rounds summed) {[round(t, 3) for t in fr_batch_ms]}"
          "; medians " + ", ".join(f"{k} {np.median(out[k]):.6g}" for k in D.KEYS), flush=True)

    # each bucket's Frechet: the batch's values, the plan's call and the
    # sequential schedule (depth 1) on the same inputs, equal; each call's ms
    # by CUDA events in turns (plan, depth 1, depth 1, plan)
    per_bucket = {}
    for key, (idxs, p, q, n, m, hi) in inputs.items():
        plan = plans[key]
        got = frechet_kernel.frechet(p, q, n, m, hi)
        seq = frechet_kernel.frechet(p, q, n, m, hi, depth=1)
        batch = torch.tensor([out["Frechet"][i] for i in idxs], dtype=torch.float32)
        check(torch.equal(got.cpu(), batch), f"frechet of bucket {key}: the call differs from "
                                             "the batch's values")
        check(torch.equal(got, seq), f"frechet of bucket {key} at {tuple(plan)} differs from "
                                     f"depth 1 by {float((got - seq).abs().max())}")
        turns = {1: [], None: []}
        for depth in (None, 1, 1, None):
            turns[depth].append(time_ms(torch, lambda: frechet_kernel.frechet(
                p, q, n, m, hi, depth=depth), iters=1, warmup=0))
        ms, ms1 = float(np.mean(turns[None])), float(np.mean(turns[1]))
        plan1 = fly_plan(frechet_kernel, len(idxs), int(m.max()), device, depth=1)
        steps = int(n.max()) - 1 + frechet_kernel.active_threads(int(m.max()), plan.chunk) - 1
        cells = fly_reached(torch, frechet_kernel, D, p, q, n, m, hi, device)
        bound, by, ops = fly_bound(n.tolist(), m.tolist(), reached=cells)
        share = float(cells.sum()) / (D.BISECTION_STEPS * float(((n - 1) * (m - 1)).sum()))
        per_bucket[key] = dict(plan=plan, plan1=plan1, ms=ms, ms1=ms1, steps=steps, bound=bound,
                               cells=int(cells.sum()))
        print(f"[flyability] frechet bucket {key}, {len(idxs)} pairs: plan {plan._asdict()}: "
              f"{ms:.3f} ms a call by events (turns {[round(t, 3) for t in turns[None]]}; "
              f"{1e6 * ms / (plan.rounds * steps):.1f} ns per dependent round-step of "
              f"{plan.rounds} x {steps}); depth 1 {plan1._asdict()}: {ms1:.3f} ms (turns "
              f"{[round(t, 3) for t in turns[1]]}), equal; bound {bound:.5f} ms ({by}: "
              f"{ops / 1e9:.4f} GFLOP over the {int(cells.sum())} cells that the 30 sequential "
              f"decisions reach, {100 * share:.2f}% of their grids; no single PyTorch call "
              f"computes it)", flush=True)

    # the DP kernel against its plain version, FLY_CHECK_PAIRS pairs of the
    # first bucket, and both kernels against their plain versions at each
    # bucket's plan on FLY_BRANCH_ROWS rows, the Frechet also at
    # FLY_FRECHET_SHAPE: the plain Frechet's graph replays run on the card
    # while the host issues the plain DP family's row loops
    k = FLY_CHECK_PAIRS
    p = torch.from_numpy(np.stack([D._bucket_pad(x) for x in gens[:k]])).to(device)
    q = torch.from_numpy(np.stack([D._bucket_pad(x) for x in sims[:k]])).to(device)
    n = torch.tensor([len(x) for x in gens[:k]], device=device)
    m = torch.tensor([len(x) for x in sims[:k]], device=device)
    got = traj_dp_kernel.traj_dp(p, q, n, m, adep, spec)
    fg, fs = fly_tracks(rng, k, FLY_FRECHET_SHAPE[0], 2)
    fp = torch.from_numpy(np.stack(fg)).to(device)
    fq = torch.from_numpy(np.stack([x[:FLY_FRECHET_SHAPE[1]] for x in fs])).to(device)
    fn_, fm = [FLY_FRECHET_SHAPE[0]] * k, [FLY_FRECHET_SHAPE[1]] * k
    hi = traj_dp_kernel.traj_dp(fp, fq, fn_, fm, adep, [("discret_frechet", "euclidean", 0.0)])
    hi = hi[:, 0].contiguous()
    fr = frechet_kernel.frechet(fp, fq, fn_, fm, hi)
    check(torch.equal(fr, frechet_kernel.frechet(fp, fq, fn_, fm, hi, depth=1)),
          f"frechet at {FLY_FRECHET_SHAPE} differs from depth 1")
    fr_cells = fly_reached(torch, frechet_kernel, D, fp, fq, fn_, fm, hi, device)
    # each bucket's plan on its pairs cut to FLY_BRANCH_ROWS (the Frechet) and
    # FLY_DP_BRANCH_ROWS (the DP) of p's points
    pick = np.linspace(0, L - 1, FLY_BRANCH_ROWS).round().astype(int)
    dp_pick = np.linspace(0, L - 1, FLY_DP_BRANCH_ROWS).round().astype(int)
    branch, dp_branch = {}, {}
    for key, (idxs, _, bq, _, bm, _) in inputs.items():
        bp = torch.from_numpy(np.stack([D._bucket_pad(gens[i][pick]) for i in idxs])).to(device)
        bn = [FLY_BRANCH_ROWS] * len(idxs)
        bhi = traj_dp_kernel.traj_dp(bp, bq, bn, bm, adep,
                                     [("discret_frechet", "euclidean", 0.0)])[:, 0].contiguous()
        bgot = frechet_kernel.frechet(bp, bq, bn, bm, bhi, plan=plans[key])
        check(torch.equal(bgot, frechet_kernel.frechet(bp, bq, bn, bm, bhi, depth=1)),
              f"frechet at bucket {key}'s plan {tuple(plans[key])} on {FLY_BRANCH_ROWS} rows "
              "differs from depth 1")
        branch[key] = (bp, bq, bn, bm, bhi, bgot,
                       fly_reached(torch, frechet_kernel, D, bp, bq, bn, bm, bhi, device))
        dp_bp = torch.from_numpy(np.stack([D._bucket_pad(gens[i][dp_pick]) for i in idxs]))
        dp_bp, dp_bn = dp_bp.to(device), [FLY_DP_BRANCH_ROWS] * len(idxs)
        dp_branch[key] = (dp_bp, bq, dp_bn, bm, traj_dp_kernel.traj_dp(
            dp_bp, bq, dp_bn, bm, adep, spec, plan=dp_plans[key]))
    torch.cuda.synchronize()
    finish_branch = {key: frechet_plain_start(torch, D, bp, bq, bn, bm, bhi.clone(), device)
                     for key, (bp, bq, bn, bm, bhi, *_) in branch.items()}
    finish_frechet = frechet_plain_start(torch, D, fp, fq, fn_, fm, hi.clone(), device)
    t0 = time.perf_counter()
    want = D.dp_metrics(p, q, n, m, adep, spec)
    torch.cuda.current_stream().synchronize()
    dp_plain_ms = 1e3 * (time.perf_counter() - t0)
    branch_dp = {key: D.dp_metrics(bp, bq, bn, bm, adep, spec)
                 for key, (bp, bq, bn, bm, _) in dp_branch.items()}
    fr_plain, fr_plain_ms, fr_plain_cells = finish_frechet()
    branch_plain = {key: fin() for key, fin in finish_branch.items()}

    def dp_rels(got, want, what):
        """Max relative gap of each DP variant; LCSS and EDR exactly, the
        discrete Frechet 1e-6, DTW and ERP 1e-5."""
        rels = {}
        for j, (key, kind, _, _) in enumerate(variants):
            a, b = got[:, j].double(), want[:, j].double()
            rels[key] = float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
            tol = 0.0 if kind in ("edr", "lcss") else 1e-6 if kind == "discret_frechet" else 1e-5
            check(rels[key] <= tol,
                  f"traj_dp {key} {what} differs from the plain version by {rels[key]}")
        return rels

    rels = dp_rels(got, want, "in the (5120, 1024) bucket")
    branch_rels = {key: dp_rels(dp_branch[key][4], branch_dp[key], f"at bucket {key}'s plan "
                                f"{tuple(dp_plans[key][:3])} on {FLY_DP_BRANCH_ROWS} rows")
                   for key in dp_branch}
    for j, (key, *_) in enumerate(variants):
        check(np.allclose(out[key][:k], got[:, j].cpu().numpy(), rtol=0, atol=0),
              f"traj_dp {key}: the batch's value differs from the two-pair launch")
    dp_err = max([float((got - want).abs().max())]
                 + [float((dp_branch[key][4] - branch_dp[key]).abs().max()) for key in dp_branch])
    dp_ms = time_ms(torch, lambda: traj_dp_kernel.traj_dp(p, q, n, m, adep, spec), iters=5,
                    warmup=1)
    dp_bound, dp_by, dp_ops = fly_bound(n.tolist(), m.tolist(), spec)
    dp_plan = fly_dp_plan(traj_dp_kernel, k, ntasks, int(n.max()), int(m.max()), device)
    dp_steps = fly_dp_steps(dp_plan)
    dp_buckets = {}  # each bucket of the batch: its bound, cells, plan and ns a step
    for (key, (_, _, _, bn_, bm_, _)), launch_ms in zip(inputs.items(), dp_launch_ms or
                                                        [float("nan")] * len(inputs)):
        bound, by, ops = fly_bound(bn_.tolist(), bm_.tolist(), spec)
        steps = fly_dp_steps(dp_plans[key])
        dp_buckets[key] = dict(bound=bound, by=by, gflop=ops / 1e9, steps=steps,
                               cells=traj_dp_kernel.cells(bn_.tolist(), bm_.tolist()),
                               ns_per_step=1e6 * launch_ms / steps)
        print(f"[flyability] traj_dp bucket {key}, {len(bn_)} pairs: plan "
              f"{dp_plans[key]._asdict()}: {launch_ms:.3f} ms a launch in the batch "
              f"({1e6 * launch_ms / steps:.1f} ns per dependent step of {steps}); bound "
              f"{bound:.5f} ms ({by}: {ops / 1e9:.3f} GFLOP over {dp_buckets[key]['cells']} "
              "cells, a cost a metric and a step a variant)", flush=True)

    # SSPD / Hausdorff: the plain matrices, on the card and on the CPU
    for metric in ("euclidean", "spherical"):
        name = metric.capitalize()
        for fn in (D.sspd, D.hausdorff):
            key = f"{'SSPD' if fn is D.sspd else 'Hausdorff'} {name}"
            card = fn(p, q, metric, n, m).cpu().numpy()
            # the same code in a batch of another size: summation order only
            check(np.allclose(card, out[key][:k], rtol=1e-5, atol=0),
                  f"{key}: the batch {out[key][:k]} differs from the plain version {card}")
            cpu = fn(p.cpu(), q.cpu(), metric, n.cpu(), m.cpu()).numpy()
            # the cross-track formula amplifies the card's and the CPU's
            # last-ulp sin/cos differences (tests/test_torch_flyability.py)
            tol = 1e-5 if metric == "euclidean" else 1e-3
            check(np.allclose(card, cpu, rtol=tol, atol=0), f"{key}: card {card} vs CPU {cpu}")

    fr_rel = float(((fr - fr_plain).abs() / fr_plain.abs()).max())
    check(fr_rel <= 1e-5, f"frechet kernel differs from the plain version by {fr_rel}")
    fr_err = float((fr - fr_plain).abs().max())
    # the cells the kernel counts reached at each sequential step, against
    # the plain decision's count: the work behind the bound
    check(torch.equal(fr_cells, fr_plain_cells.cpu()),
          f"frechet reached cells at {FLY_FRECHET_SHAPE}: kernel {fr_cells.sum(0).tolist()}, "
          f"plain {fr_plain_cells.sum(0).tolist()}")
    branch_rel = {}
    for key, (_, _, _, _, _, bgot, bcells) in branch.items():
        want_b, _, want_cells = branch_plain[key]
        branch_rel[key] = float(((bgot - want_b).abs() / want_b.abs()).max())
        check(branch_rel[key] <= 1e-5, f"frechet kernel at bucket {key}'s plan "
                                       f"{tuple(plans[key])} differs from the plain version by "
                                       f"{branch_rel[key]}")
        check(torch.equal(bcells, want_cells.cpu()),
              f"frechet reached cells at bucket {key} on {FLY_BRANCH_ROWS} rows: kernel "
              f"{bcells.sum(0).tolist()}, plain {want_cells.sum(0).tolist()}")
        fr_err = max(fr_err, float((bgot - want_b).abs().max()))
    fr_ms = time_ms(torch, lambda: frechet_kernel.frechet(fp, fq, fn_, fm, hi), iters=3, warmup=1)
    fr_bound, fr_by, fr_ops = fly_bound(fn_, fm, reached=fr_cells)
    fr_plan = fly_plan(frechet_kernel, k, FLY_FRECHET_SHAPE[1], device)
    fr_steps = FLY_FRECHET_SHAPE[0] - 1 + frechet_kernel.active_threads(FLY_FRECHET_SHAPE[1],
                                                                        fr_plan.chunk) - 1
    print(f"[flyability] traj_dp vs plain on {k} pairs at {tuple(p.shape[1:2]) + tuple(q.shape[1:2])} "
          f"(true {n.tolist()} x {m.tolist()}): max rel by metric "
          + ", ".join(f"{key} {r:.3g}" for key, r in rels.items())
          + f"; plan {tuple(dp_plan[:3])}: {dp_ms:.3f} ms a launch ({1e6 * dp_ms / dp_steps:.1f} "
          f"ns per dependent step of {dp_steps}), plain {dp_plain_ms:.1f} ms, bound "
          f"{dp_bound:.5f} ms ({dp_by}: {dp_ops / 1e9:.3f} GFLOP, no single PyTorch call "
          "computes it)", flush=True)
    for key, (bp, bq, *_) in dp_branch.items():
        print(f"[flyability] traj_dp vs plain at bucket {key}'s plan {tuple(dp_plans[key][:3])} "
              f"on {bp.shape[0]} pairs at {tuple(bp.shape[1:2]) + tuple(bq.shape[1:2])} (true "
              f"{FLY_DP_BRANCH_ROWS} x {int(inputs[key][4].max())}): max rel by metric "
              + ", ".join(f"{v} {r:.3g}" for v, r in branch_rels[key].items())
              + f"; the batch's values equal to its pairs alone at plan "
              f"{tuple(dp_others[key][:3])}", flush=True)
    print(f"[flyability] frechet vs plain on {k} pairs at {FLY_FRECHET_SHAPE}, plan "
          f"{tuple(fr_plan)}: max rel {fr_rel:.3g}, equal to depth 1; {fr_ms:.3f} ms a call "
          f"({1e6 * fr_ms / (fr_plan.rounds * fr_steps):.1f} ns per dependent round-step of "
          f"{fr_plan.rounds} x {fr_steps}), plain {fr_plain_ms:.1f} ms (its decision replayed "
          f"from a CUDA graph, beside the plain DP family), bound {fr_bound:.5f} ms ({fr_by}: "
          f"{fr_ops / 1e9:.4f} GFLOP over {int(fr_cells.sum())} reached cells, the kernel's "
          f"count equal to the plain decision's; no single PyTorch call computes it)",
          flush=True)
    for key, (bp, bq, _, _, _, _, bcells) in branch.items():
        print(f"[flyability] frechet vs plain at bucket {key}'s plan {tuple(plans[key])} on "
              f"{bp.shape[0]} pairs at {tuple(bp.shape[1:2]) + tuple(bq.shape[1:2])} (true "
              f"{FLY_BRANCH_ROWS} x {int(inputs[key][4].max())}): max rel {branch_rel[key]:.3g}, "
              f"equal to depth 1; {int(bcells.sum())} reached cells, equal to the plain count",
              flush=True)
    common = {"route": "cuda", "library_ms": None}
    by_bucket = lambda f: {str(key): f(v) for key, v in per_bucket.items()}  # noqa: E731
    return [
        {"name": "traj_dp", "source": "tvqvae_tpu_torch/csrc/traj_dp.cu",
         "replaces": "tvqvae_tpu/evaluation/flyability/distances.py:188",
         "launches": launches["traj_dp"], "launches_by_path": {"flyability": launches["traj_dp"]},
         "max_abs_err": dp_err, "ms": dp_ms, "plain_ms": dp_plain_ms, "bound_ms": dp_bound,
         "bound_by": dp_by, "shape_pairs_PQ": [k, *p.shape[1:2], *q.shape[1:2]],
         "plan": dp_plan._asdict(), "ns_per_step": 1e6 * dp_ms / dp_steps,
         "device_ms_by_bucket": dict(zip(map(str, buckets), dp_launch_ms)),
         "bound_ms_by_bucket": {str(key): v["bound"] for key, v in dp_buckets.items()},
         "cells_by_bucket": {str(key): v["cells"] for key, v in dp_buckets.items()},
         "gflop_by_bucket": {str(key): v["gflop"] for key, v in dp_buckets.items()},
         "plan_by_bucket": {str(key): dp_plans[key]._asdict() for key in dp_buckets},
         "ns_per_step_by_bucket": {str(key): v["ns_per_step"] for key, v in dp_buckets.items()},
         **common},
        {"name": "frechet_decision", "source": "tvqvae_tpu_torch/csrc/frechet_decision.cu",
         "replaces": "tvqvae_tpu/evaluation/flyability/distances.py:406",
         "launches": launches["frechet"], "launches_by_path": {"flyability": launches["frechet"]},
         "max_abs_err": fr_err, "ms": fr_ms, "plain_ms": fr_plain_ms,
         "bound_ms": fr_bound, "bound_by": fr_by, "shape_pairs_PQ": [k, *FLY_FRECHET_SHAPE],
         "device_ms_by_bucket": dict(zip(map(str, buckets), fr_batch_ms)),
         "call_ms_by_bucket": by_bucket(lambda v: v["ms"]),
         "depth1_ms_by_bucket": by_bucket(lambda v: v["ms1"]),
         "depth_by_bucket": by_bucket(lambda v: v["plan"].depth),
         "rounds_by_bucket": by_bucket(lambda v: v["plan"].rounds),
         "plan_by_bucket": by_bucket(lambda v: v["plan"]._asdict()),
         "bound_ms_by_bucket": by_bucket(lambda v: v["bound"]),
         "reached_cells_by_bucket": by_bucket(lambda v: v["cells"]),
         **common},
    ]


def flyability_cli_start(work, plot, device="cuda"):
    """The port's flyability CLI on the generate CLI's ``.npz``, with the JAX
    tests' stub simulator. With ``plot`` (matplotlib importable) it runs as
    ``python -m tvqvae_tpu_torch.scripts.evaluate_flyability`` in a
    subprocess, beside what follows; without, ``run(args, plot=False)``
    runs its steps up to the JSON in this process, now (its output kept for
    an error message; its seconds printed). -> (the subprocess or None, its
    start time, its output when run here)."""
    stub = os.path.join(work.root, "bluesky_stub.py")
    with open(stub, "w") as f:
        f.write(BLUESKY_STUB)
    logs = os.path.join(work.root, "stub_logs")
    repo = os.path.dirname(os.path.abspath(__file__))
    argv = ["--synthetic_file", os.path.join(work.root, "synthetic", "synthetic.npz"),
            "--save_dir", os.path.join(work.root, "flyability"), "--ADEP", "EHAM",
            "--ADES", "LIMC", "--bluesky_cmd",
            f"STUB_LOGS_DIR={shlex.quote(logs)} {shlex.quote(sys.executable)} "
            f"{shlex.quote(stub)} --headless --scenfile {{scenfile}}",
            "--logs_directory", logs, "--device", device]
    t0 = time.perf_counter()
    if not plot:
        from tvqvae_tpu_torch.scripts import evaluate_flyability

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            evaluate_flyability.run(evaluate_flyability.build_argparser().parse_args(argv),
                                    plot=False)
        print(f"[flyability] evaluate_flyability's steps up to the JSON ran in this process in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        return None, t0, out.getvalue()
    env = {**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "2"}
    cmd = [sys.executable, "-m", "tvqvae_tpu_torch.scripts.evaluate_flyability", *argv]
    return subprocess.Popen(cmd, cwd=repo, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), t0, None


def check_flyability_cli(proc, t0, out, work):
    """Wait for the flyability CLI (where it is a subprocess) and check its
    outputs: the simulated CSV, ``synthetic_distances.json`` with the 14
    keys, finite values, one per simulated flight of two or more points, and
    the summary's statistics, and the CDF plot where it was asked for."""
    if proc is not None:
        out, _ = proc.communicate(timeout=600)
        check(proc.returncode == 0,
              f"evaluate_flyability exited {proc.returncode}:\n{out[-3000:]}")
    save = os.path.join(work.root, "flyability")
    with open(os.path.join(save, "synthetic_simulated.csv")) as f:
        ids = [row["flight_id"] for row in csv.DictReader(f)]
    scored = sum(1 for fid in set(ids) if ids.count(fid) >= 2)
    with open(os.path.join(save, "synthetic_distances.json")) as f:
        res = json.load(f)
    from tvqvae_tpu_torch.evaluation.flyability.distances import KEYS

    check(set(res["per_flight"]) == set(KEYS) == set(res["summary"]),
          f"flyability JSON keys {sorted(res['per_flight'])}")
    check(all(len(v) == scored for v in res["per_flight"].values()) and scored > 0,
          f"{scored} simulated flights, per-flight lengths "
          f"{ {k: len(v) for k, v in res['per_flight'].items()} }")
    check(all(np.isfinite(v).all() for v in res["per_flight"].values()),
          "non-finite flyability distances")
    check(all(set(s) == {"mean", "median", "p90"} for s in res["summary"].values()),
          "flyability summary statistics")
    plot = os.path.exists(os.path.join(save, "synthetic_distance_cdfs.png"))
    check(plot == (proc is not None), f"CDF plot written: {plot}, asked for: {proc is not None}")
    how = ("a subprocess, its CDF plot written" if proc is not None else
           "its steps up to the JSON in this process, run(args, plot=False): no matplotlib")
    took = f"; {time.perf_counter() - t0:.1f} s from its start" if proc is not None else ""
    print(f"[flyability] evaluate_flyability CLI ({how}; stub simulator): {len(set(ids))} "
          f"flights simulated, {scored} scored, 14 metrics finite{took}", flush=True)


def corridor_features(n, points, k, spread, seed, pinned_ends=False):
    """(n, 2 * points) interleaved (y, x) tracks in km of n flights on k
    corridors: each corridor a bent path, each flight its corridor plus a
    smooth sideways offset and point noise of ``spread``; with
    ``pinned_ends`` every flight starts and ends at the same two points, as
    flights between two airports do. -> (features, corridor of each)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, points)
    corridor = rng.integers(0, k, n)
    bend = np.linspace(-1.0, 1.0, k)[corridor, None] * np.sin(np.pi * t)
    smooth = rng.normal(0, 0.3 * spread, (n, 1)) * np.sin(np.pi * t) ** 2
    y = -700.0 * t + 100.0 * bend + rng.normal(0, spread, (n, points)) * 5
    x = 250.0 * t + 150.0 * bend + 150.0 * smooth + rng.normal(0, spread, (n, points)) * 5
    if pinned_ends:
        y[:, [0, -1]] = y[0, [0, -1]]
        x[:, [0, -1]] = x[0, [0, -1]]
    F = np.empty((n, 2 * points))
    F[:, 0::2], F[:, 1::2] = y, x
    return F, corridor


def gmm_iteration_flops(n, d, k):
    """float64 operations of one E+M pair of the full-covariance mixture:
    per component the weighted covariance and the log-probability products
    (2nd^2 each), the Cholesky (d^3/3) and the triangular inverse (d^3), and
    the means and elementwise terms (~6nd)."""
    return k * (4 * n * d * d + 4 * d ** 3 / 3 + 6 * n * d)


def write_opensky_csv(path, seed=11):
    """An OpenSky-like export EHAM -> LIMC: PREP_CORRIDORS corridors (bends of
    up to 1.2 deg), PREP_PER_CORRIDOR flights each of PREP_POINTS or one more
    points at ~1.2 s with millisecond stamps (every flight within one
    standard deviation of the mean length), a flight starting every 12
    minutes (rows interleaved in time). Flights i and i + n/2 share an
    aircraft, callsign and corridor, PREP_GAP_H hours apart (a real gap of
    > 6 h between them).
    -> (rows, {the flight id the port must give: (corridor, duration s)})."""
    from tvqvae_tpu_torch.data.preprocess import AIRPORTS

    rng = np.random.default_rng(seed)
    (lat0, lon0), (lat1, lon1) = AIRPORTS["EHAM"], AIRPORTS["LIMC"]
    n = PREP_CORRIDORS * PREP_PER_CORRIDOR
    epoch = np.datetime64("2021-06-01T00:00:00", "ms")
    cols, truth = [], {}
    for i in range(n):
        m = PREP_POINTS + i % 2
        t = np.linspace(0, 1, m)
        plane = i % (n // 2)
        c = plane % PREP_CORRIDORS
        start = (i // (n // 2)) * PREP_GAP_H * 3600e3 + plane * 720e3
        ms = (start + np.round(t * rng.uniform(5200, 5600) * 1e3)).astype(np.int64)
        bend = (c - (PREP_CORRIDORS - 1) / 2) * 0.6 * np.sin(np.pi * t)
        lat = lat0 + (lat1 - lat0) * t + 0.5 * bend + rng.normal(0, 0.002, m)
        lon = lon0 + (lon1 - lon0) * t + bend + rng.normal(0, 0.002, m)
        lat[[0, -1]], lon[[0, -1]] = (lat0, lat1), (lon0, lon1)
        alt = 300 + 35000 * np.sin(np.pi * t) + rng.normal(0, 30, m)
        cols.append((ms, lat, lon, alt, np.full(m, plane)))
        first = str(np.datetime_as_string(epoch + ms[0], unit="s"))
        stamp = first.replace("-", "").replace(":", "").replace("T", "_")
        truth[f"4ca{plane:03x}_KLM{plane:04d}_{stamp}"] = (c, (ms[-1] - ms[0]) / 1e3)
    ms, lat, lon, alt, plane = (np.concatenate(x) for x in zip(*cols))
    order = np.argsort(ms, kind="stable")
    stamps = np.datetime_as_string(epoch + ms[order], unit="ms")
    with open(path, "w") as f:
        f.write("timestamp,icao24,latitude,longitude,altitude,callsign,estdepartureairport,"
                "estarrivalairport\n")
        f.writelines(f"{s}+00:00,4ca{p:03x},{a:.6f},{o:.6f},{h:.1f},KLM{p:04d},EHAM,LIMC\n"
                     for s, p, a, o, h in zip(stamps.tolist(), plane[order].tolist(),
                                              lat[order].tolist(), lon[order].tolist(),
                                              alt[order].tolist()))
    return len(ms), truth


def mixture_fit(torch, F, k, device):
    """StandardScaler + GaussianMixture(k, random_state=199) on ``device``
    -> (labels, the fitted mixture)."""
    from tvqvae_tpu_torch.data.mixture import GaussianMixture, StandardScaler

    gmm = GaussianMixture(k, random_state=199, device=device)
    return gmm.fit_predict(StandardScaler(device=device).fit_transform(F)), gmm


def same_partition(a, b) -> bool:
    return len(set(zip(a.tolist(), b.tolist()))) == len(set(a.tolist())) == len(set(b.tolist()))


def preprocess_phase(torch, vq_kernel, work, device="cuda"):
    """[preprocess]: (a) the counters set to 0, the OpenSky CLI in the process
    on a synthetic export (``write_opensky_csv``), clustering on the card:
    rows/s of the parse, seconds by stage, EM iterations and lower bound;
    the labels are the corridors, each timedelta ends at its flight's
    duration in seconds, and the .npz goes through ``get_data`` into one
    ``train_stage1`` step at the published width (its VQ launches are the
    phase's count); (b) the mixture at PREP_GMM on the card: seconds, EM
    iterations, ms an E+M pair, its float64 operations and their share of
    the card's float64 tensor peak, peak memory; (c) the mixture at
    PREP_CHECK on the card and on the CPU: labels and iterations equal,
    means within 1e-9 relative. -> the phase's VQ launches."""
    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.data import get_data
    from tvqvae_tpu_torch.scripts import preprocess as cli
    from tvqvae_tpu_torch.train.runner import train_stage1

    raw = os.path.join(work.root, "raw", "OpenSky")
    os.makedirs(raw, exist_ok=True)
    t0 = time.perf_counter()
    rows, truth = write_opensky_csv(os.path.join(raw, "opensky_EHAM_LIMC_2021.csv"))
    t_write = time.perf_counter() - t0
    vq_kernel.launch_count = 0
    got = cli.main(["--ADEP", "EHAM", "--ADES", "LIMC", "--raw_data_dir",
                    os.path.join(work.root, "raw"), "--data_source", "OpenSky", "--save_dir",
                    os.path.join(work.root, "real"), "--device", device])
    check(got["rows"] == rows, f"the CLI read {got['rows']} rows of {rows}")
    stages = ("parse", "ids", "outliers", "resample", "features", "kmeans", "em", "export")
    print(f"[preprocess] OpenSky CLI, {rows} rows ({t_write:.2f} s to write): parse "
          f"{rows / got['parse']:.0f} rows/s; seconds " + ", ".join(
              f"{s} {got[s]:.3f}" for s in stages)
          + f"; EM iterations {got['em_iterations']}, lower bound {got['lower_bound']:.4f}; "
          f"X {tuple(got['shape'])}", flush=True)
    check(sorted(got["flights"]) == sorted(truth), "flight ids differ from the written flights "
          f"(one per aircraft and gap): {sorted(set(got['flights']) ^ set(truth))[:4]}")
    corridor = np.array([truth[i][0] for i in got["flights"]])
    check(same_partition(got["labels"], corridor),
          f"labels {got['labels'].tolist()} are not the corridors {corridor.tolist()}")
    z = np.load(got["path"])
    td_end = z["X"][:, 3, -1].astype(np.float64)
    dur = np.array([truth[i][1] for i in got["flights"]])
    td_err = float(np.abs(td_end - dur).max() / dur.max())
    check(td_err <= 2.0 ** -23, f"timedelta ends off the flight durations by {td_err}")

    cfg = Config()
    data = get_data(got["path"], cfg.dataset.features)
    rec = StepRecorder(torch)
    train_stage1(cfg, data, max_steps=1, device=device, logger=rec, log_interval=1)
    launches = vq_kernel.launch_count
    n_test = len(data.X_test)
    val_batches = -(-n_test // min(cfg.dataset.batch_sizes["stage1"], n_test))
    expected = 2 + 2 * val_batches * len(rec.val)
    check(launches == expected, f"[preprocess] VQ launches {launches}, expected {expected}")
    loss = float(rec.losses[0])
    check(np.isfinite(loss), f"stage-1 step on the preprocessed set: loss {loss}")
    print(f"[preprocess] the .npz through get_data ({len(data.X_train)} train / {n_test} test, "
          f"L={data.input_length}) into one published-width stage-1 step: loss {loss:.4f}, "
          f"VQ launches {launches}; timedelta ends at the flight durations within "
          f"{td_err:.2e} of the longest", flush=True)

    # (b) the published dataset's clustering geometry
    n, d, k = PREP_GMM
    F, corridor = corridor_features(n, d // 2, k, 0.5, seed=12, pinned_ends=True)
    X = torch.from_numpy(F).to(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    labels, gmm = mixture_fit(torch, X, k, device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    check(same_partition(labels, corridor), "the published-geometry mixture missed the corridors")
    ms_pair = 1e3 * gmm.seconds_["em"] / (gmm.n_iter_ + 1)  # + the init M and the final E
    flops = gmm_iteration_flops(n, d, k)
    print(f"[preprocess] mixture N={n} D={d} K={k} on the card: {wall:.3f} s (k-means "
          f"{gmm.seconds_['kmeans']:.3f} s, EM {gmm.seconds_['em']:.3f} s), {gmm.n_iter_} EM "
          f"iterations, {ms_pair:.2f} ms an E+M pair, {flops:.3e} float64 operations a pair = "
          f"{flops / (ms_pair / 1e3) / 1e12:.1f} TFLOP/s, {flops / (ms_pair / 1e3) / FP64_TC_FLOPS:.1%} "
          f"of 67 TFLOP/s; lower bound {gmm.lower_bound_:.4f}; peak memory {peak_gib:.2f} GiB "
          "above the features", flush=True)

    # (c) the card against the CPU
    n, d, k = PREP_CHECK
    F, corridor = corridor_features(n, d // 2, k, 1.5, seed=13, pinned_ends=True)
    fits = {dev: mixture_fit(torch, F, k, dev) for dev in (device, "cpu")}
    (lc, gc), (lh, gh) = fits[device], fits["cpu"]
    mean_rel = float((gc.means_.cpu() - gh.means_).abs().max() / gh.means_.abs().max())
    check(np.array_equal(lc, lh) and gc.n_iter_ == gh.n_iter_,
          f"card labels/iterations differ from the CPU's ({gc.n_iter_} vs {gh.n_iter_})")
    check(mean_rel <= 1e-9, f"card means off the CPU's by {mean_rel} relative")
    print(f"[preprocess] mixture N={n} D={d} K={k}: card and CPU labels equal, "
          f"{gc.n_iter_} EM iterations each, means within {mean_rel:.2e} relative, lower bounds "
          f"{gc.lower_bound_:.6f} / {gh.lower_bound_:.6f}", flush=True)
    return launches


@contextlib.contextmanager
def deterministic_cudnn(torch):
    """cuDNN restricted to its deterministic algorithms while inside."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


@contextlib.contextmanager
def deterministic_algorithms(torch):
    """PyTorch's deterministic implementations while inside, an op without
    one warning: among them the encoders' ``F.pad(mode="replicate")``, whose
    CUDA backward otherwise adds the copied edges with atomics (two runs of
    one step then differ in the last bits)."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])


def _random_bn_statistics(torch, modules, g):
    """Trained-like BatchNorm statistics (means ~0.1 N(0, 1), variances in
    [0.5, 1.5)), so that a swapped mean and variance would show."""
    with torch.no_grad():
        for m in modules:
            for mod in m.modules():
                if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
                    n = mod.running_mean.numel()
                    mod.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                    mod.running_var.copy_(0.5 + torch.rand(n, generator=g))


def import_phase(torch, vq_kernel, work, device="cuda", config=None):
    """Reference checkpoints into the port at the published width: seeded
    port modules (stage 1 with random BatchNorm statistics, both priors with
    the wrapper's projections as the reference has them, the enhancer, the
    FCN) written as the reference's Lightning checkpoints
    (``write_reference_ckpts``: the newer x-transformers naming, a stage-3
    tau of IMPORT_TAU); the import CLI on them in a subprocess; then,
    counted, ``from_checkpoints`` of its output without and with the
    enhancer against the in-memory sampler of the same modules: a 32-batch
    with injected noise (timed, and its repeat's gap under cuDNN's default
    algorithms; then under deterministic cuDNN tokens equal and series
    bit-equal) and ``reconstruct`` of 32 series (2 VQ launches, bit-equal
    under deterministic cuDNN); after the count, one sample
    batch under ``profiling.trace`` with an ``annotate("sample")`` span, the
    trace read back. -> the VQ kernel launches of the counted part."""
    from tvqvae_tpu_torch.generation import TrainedModelSampler
    from tvqvae_tpu_torch.models.fcn import FCN
    from tvqvae_tpu_torch.models.fidelity_enhancer import FidelityEnhancer
    from tvqvae_tpu_torch.models.layers import init_weights_
    from tvqvae_tpu_torch.models.maskgit import (FrozenStage1, build_transformers, encode_tokens,
                                                 iterative_decoding)
    from tvqvae_tpu_torch.models.stage1 import Stage1Spec, init_stage1
    from tvqvae_tpu_torch.scripts._cli import load_config
    from tvqvae_tpu_torch.train.stage2 import init_stage2
    from tvqvae_tpu_torch.train.stage3 import init_stage3
    from tvqvae_tpu_torch.utils import profiling
    from tvqvae_tpu_torch.utils.checkpoint import load_checkpoint

    cfg = load_config(config)
    dev = torch.device(device)
    g = torch.Generator().manual_seed(12)
    spec = Stage1Spec.from_config(cfg, L, C)
    model, vq_l, vq_h = init_stage1(spec, g, dev)
    t_l, t_h = init_stage2(*build_transformers(cfg, spec, N_CLASSES, (True, True)), g, dev)
    fe = init_stage3(FidelityEnhancer.from_config(cfg, L, C), g, dev)
    fcn = init_weights_(FCN(C, N_CLASSES), g).to(dev)
    _random_bn_statistics(torch, (model, t_h, fcn), g)
    for m in (model, t_l, t_h, fe, fcn):
        m.eval()

    t0 = time.perf_counter()
    paths = write_reference_ckpts(torch, os.path.join(work.root, "reference"), model, vq_l, vq_h,
                                  t_l, t_h, fe, IMPORT_TAU, fcn)
    write_s = time.perf_counter() - t0
    out_dir = os.path.join(work.root, "imported")
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    cmd = [sys.executable, "-m", "tvqvae_tpu_torch.scripts.import_ckpt",
           *(a for s in ("stage1", "stage2", "stage3", "fcn") for a in (f"--{s}_ckpt", paths[s])),
           "--out_dir", out_dir, "--device", device, *(["--config", config] if config else [])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=repo, env=env, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"import_ckpt exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    line = next(x for x in proc.stdout.splitlines() if x.startswith("[import] seconds by stage "))
    by_stage = json.loads(line[len("[import] seconds by stage "):])
    written = {s: os.path.join(out_dir, s) for s in ("stage1", "stage2", "stage3", "fcn")}
    metas = {s: load_checkpoint(p)[1] for s, p in written.items()}
    check(metas["stage1"]["n_classes"] == N_CLASSES and metas["stage1"]["input_length"] == L
          and metas["stage2"]["force_projections"] is True
          and abs(metas["stage3"]["tau"] - IMPORT_TAU) < 1e-6, f"imported meta {metas}")
    print(f"[import] reference Lightning checkpoints from seeded modules (torch.save, "
          f"{write_s:.2f} s): " + ", ".join(f"{s} {os.path.getsize(p)} bytes"
                                            for s, p in paths.items()), flush=True)
    print(f"[import] import_ckpt CLI (a subprocess) in {cli_s:.2f} s; seconds by stage (read, "
          f"convert, validate against a fresh init on the card, write): "
          + ", ".join(f"{k} {v:.2f}" for k, v in by_stage.items()) + "; wrote "
          + ", ".join(f"{s} {os.path.getsize(p)} bytes" for s, p in written.items()), flush=True)

    frozen = FrozenStage1(model, vq_l, vq_h)
    rng = np.random.default_rng(31)
    series = rng.normal(size=(B, C, L)).astype(np.float32)
    numbers = {}
    # ---- the imported checkpoints served, counted -----------------------
    vq_kernel.launch_count = 0
    for use_fe in (False, True):
        t0 = time.perf_counter()
        disk = TrainedModelSampler.from_checkpoints(
            cfg, written["stage1"], written["stage2"], written["stage3"],
            use_fidelity_enhancer=use_fe, batch_size=B, device=device)
        build_s = time.perf_counter() - t0
        check(disk.tau == IMPORT_TAU, f"imported tau {disk.tau}")
        mem = TrainedModelSampler.__new__(TrainedModelSampler)
        mem._assemble(cfg, frozen, t_l, t_h, N_CLASSES, B, dev, fe, use_fe)
        noise = gumbel_noise(torch, disk.mg_spec, B, rng)
        first = disk.sample(B, noise=[noise])  # also the warm-up
        t0 = time.perf_counter()
        again = disk.sample(B, noise=[noise])
        sample_ms = 1e3 * (time.perf_counter() - t0)
        # cuDNN's default transposed-convolution algorithms are not
        # bit-reproducible from call to call; under deterministic ones two
        # samplers of the same weights agree bit for bit
        repeat_gap = max(float(np.abs(a - b).max() / np.abs(b).max())
                         for a, b in zip(first, again))
        with deterministic_cudnn(torch):
            got = disk.sample(B, noise=[noise])
            ref = mem.sample(B, noise=[noise])
        check(all(np.array_equal(a, b) for a, b in zip(got, ref)),
              f"the sampler from imported checkpoints (enhancer {use_fe}) is not bit-equal to the "
              f"in-memory one: {[float(np.abs(a - b).max()) for a, b in zip(got, ref)]}")
        with torch.inference_mode():
            toks = [iterative_decoding(s.mg_spec, lambda a, c, s=s: s.t_l(a, None, c),
                                       lambda a, b, c, s=s: s.t_h(a, b, c), B, None,
                                       device=device, noise=noise) for s in (disk, mem)]
        check(all(torch.equal(a, b) for a, b in zip(*toks)),
              "tokens sampled from the imported checkpoints differ from the in-memory sampler's")
        numbers[use_fe] = (build_s, sample_ms, repeat_gap)
    before = vq_kernel.launch_count
    t0 = time.perf_counter()
    disk.reconstruct(series)
    rec_ms = 1e3 * (time.perf_counter() - t0)
    check(vq_kernel.launch_count - before == 2,
          f"reconstruct from the import launched the VQ kernel {vq_kernel.launch_count - before} "
          f"times, not 2")
    with deterministic_cudnn(torch):
        check(np.array_equal(disk.reconstruct(series), mem.reconstruct(series)),
              "reconstruct from the import is not bit-equal to the in-memory one")
    with torch.inference_mode():
        xb = torch.from_numpy(series).to(dev)
        for band in ("lf", "hf"):
            check(torch.equal(encode_tokens(disk.frozen, xb, band), encode_tokens(frozen, xb, band)),
                  f"{band} reconstruct tokens from the import differ from the in-memory ones")
    launches = vq_kernel.launch_count
    # ---------------------------------------------------------------------
    print(f"[import] from_checkpoints of the import built in {numbers[False][0]:.2f} s (no "
          f"enhancer) / {numbers[True][0]:.2f} s (enhancer, tau {disk.tau}); a {B}-batch with "
          f"injected noise: tokens equal and, under deterministic cuDNN, x_l/x_h/x bit-equal to "
          f"the in-memory sampler of the same modules; {numbers[False][1]:.2f} / "
          f"{numbers[True][1]:.2f} ms (default cuDNN, whose repeat of one batch differs by "
          f"{numbers[False][2]:.3g} / {numbers[True][2]:.3g} of scale); reconstruct of {B} series "
          f"{rec_ms:.2f} ms, bit-equal, tokens equal; VQ kernel launches {launches}", flush=True)

    trace_dir = os.path.join(work.root, "trace")
    with profiling.trace(trace_dir):
        with profiling.annotate("sample"):
            disk.sample(B, noise=[noise])
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("name") == "sample" and "dur" in e]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    check(spans and (kernels or dev.type != "cuda"), f"the trace holds {len(spans)} sample spans and {len(kernels)} "
          f"device kernels")
    print(f"[import] profiling.trace of one sample batch: {len(events)} events in "
          f"{os.path.getsize(os.path.join(trace_dir, 'trace.json'))} bytes; the 'sample' span "
          f"{max(e['dur'] for e in spans) / 1e3:.2f} ms; {len(kernels)} device kernels, "
          f"{sum(e.get('dur', 0) for e in kernels) / 1e3:.2f} ms", flush=True)
    del disk, mem, frozen, model, t_l, t_h, fe, fcn
    torch.cuda.empty_cache()
    return launches


# [parallel]: two ranks on the one card, three steps each of stages 1 and 2
PAR_WORLD, PAR_STEPS, PAR_B1, PAR_B2 = 2, 3, 32, 16
PAR_FLIPS = 8  # the most HF L1 residual sign flips (a) accepts (the card has seen 1 of 593024)
PAR_RUN_STEPS, PAR_RUN_B, PAR_RUN_TEST, PAR_RUN_L = 4, 8, 16, 127  # (e): small train_stage1 runs
PAR_PROD_STEPS = 3  # (f): two-rank steps of the production recipe at the published width
PAR_TP_FLOOR = 512  # (g)'s runner: the tensor-parallel rule's floor at (e)'s small config
PAR_TP_MEMORY = 0.05  # (g): memory between steps within 5 % of the shard arithmetic
PAR_CFG = {"encoder": {"dropout": 0.0}, "decoder": {"dropout": 0.0}, "MaskGIT": {
    f"prior_model_{b}": {"model_dropout": 0.0, "emb_dropout": 0.0, "p_unconditional": 0.0}
    for b in ("l", "h")}}


def par_inputs(cfg, length):
    """The stage-1 spec, the global batches of (a) and (b), and (b)'s labels
    and masking draws (seeded: the same in every process)."""
    from tvqvae_tpu_torch.models.stage1 import Stage1Spec

    spec = Stage1Spec.from_config(cfg, length, C)
    rng = np.random.default_rng(21)
    xs1 = rng.normal(size=(PAR_STEPS, PAR_B1, C, length)).astype(np.float32)
    xs2 = rng.normal(size=(PAR_STEPS, PAR_B2, C, length)).astype(np.float32)
    ys2 = rng.integers(0, N_CLASSES, size=(PAR_STEPS, PAR_B2, 1)).astype(np.int64)
    noise = [{band: (rng.uniform(size=PAR_B2).astype(np.float32),
                     rng.uniform(size=(PAR_B2, n)).astype(np.float32))
              for band, n in (("l", spec.tokens_l), ("h", spec.tokens_h))}
             for _ in range(PAR_STEPS)]
    return spec, xs1, xs2, ys2, noise


def par_tx(cfg):
    from tvqvae_tpu_torch.train.optim import adamw
    from tvqvae_tpu_torch.utils.schedule import warmup_cosine_schedule

    return functools.partial(adamw, learning_rate=warmup_cosine_schedule(
        cfg.exp_params.lr, PAR_STEPS, cfg.exp_params.linear_warmup_rate), weight_decay=0.01)


def par_sgd(cfg):
    """Plain SGD at the config's learning rate: (a)'s optimizer. Adam's first
    step is lr·sign(g), so at 181 M parameters every element whose gradient
    is 0 up to rounding moves ±lr at random between any two float32
    computations, and the next steps' near-tie VQ indices with them; SGD
    moves each element by lr·g, so three steps compare what the reduction
    decides, the gradient."""
    import torch

    def tx(params):
        opt = torch.optim.SGD(params, lr=cfg.exp_params.lr)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda _: 1.0)

    return tx


def par_stage1(torch, cfg, model0, vq_l0, vq_h0, xs, rows, device, timed=False, tx=None):
    """``len(xs)`` stage-1 steps from a copy of ``model0`` on ``rows`` of each
    global batch, with ``tx`` (default ``par_tx``) -> {"final": the state as
    ``stage1_from_jax`` lays it out, on ``device``; "grads": the step-1
    gradients (averaged over the ranks inside a group), on ``device``;
    "indices": per step (LF, HF) on the host; "signs": the signs of the HF
    L1 loss's residual x_h - xhat_h at step 1, on the host; "loss"; "ms" of
    the steps after the first (CUDA events) with ``timed``}."""
    import copy

    from tvqvae_tpu_torch.train.stage1 import create_stage1_state, make_stage1_train_step

    state = create_stage1_state(copy.deepcopy(model0), vq_l0, vq_h0, tx or par_tx(cfg))
    seen, signs = [], []

    def hook(m, i, o):
        seen.append((o.vq_l.indices.cpu(), o.vq_h.indices.cpu()))
        if not signs:
            signs.append(torch.sign(o.x_h - o.xhat_h).detach().to(torch.int8).cpu())

    state.model.register_forward_hook(hook)
    step = make_stage1_train_step()
    events, losses, grads = [], [], None
    for x in xs:
        _, m = step(state, torch.from_numpy(np.ascontiguousarray(x[rows])).to(device))
        losses.append(m["loss"])
        if grads is None:
            grads = {k: p.grad.detach().clone() for k, p in state.model.named_parameters()}
        if timed:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
    if device == "cuda":
        torch.cuda.synchronize()
    final = dict(state.model.state_dict())
    for band, cb in (("vq_l", state.vq_l), ("vq_h", state.vq_h)):
        for f in ("embed", "embed_avg", "cluster_size", "initted"):
            final[f"{band}.{f}"] = getattr(cb, f)
    out = {"final": final, "grads": grads, "indices": seen, "signs": signs[0],
           "loss": [float(v) for v in losses]}
    if timed:
        out["ms"] = events[0].elapsed_time(events[-1]) / (len(events) - 1)
    return out


def par_stage2(torch, cfg, frozen, xs, ys, noise, rows, device):
    """``len(xs)`` on-the-fly stage-2 steps from seeded priors over
    ``frozen`` on ``rows`` of each global batch, with the masking draws
    handed in -> {"tokens": per step (LF, HF) on the host, "final": both
    priors' state dicts on the host, "loss"}."""
    from tvqvae_tpu_torch.models.maskgit import build_transformers
    from tvqvae_tpu_torch.train import stage2 as st2

    t_l, t_h = st2.init_stage2(*build_transformers(cfg, frozen.model.spec, N_CLASSES),
                               torch.Generator().manual_seed(1), device)
    state = st2.create_stage2_state(t_l, t_h, par_tx(cfg))
    step = st2.make_stage2_train_step(frozen)
    tokens, losses, real = [], [], st2.encode_tokens

    def recording(fz, x, band, **kw):
        s = real(fz, x, band, **kw)
        tokens.append(s.cpu())
        return s

    st2.encode_tokens = recording
    try:
        for x, y, nz in zip(xs, ys, noise):
            _, m = step(state, torch.from_numpy(np.ascontiguousarray(x[rows])).to(device),
                        torch.from_numpy(y[rows]).to(device),
                        noise={b: tuple(torch.from_numpy(np.ascontiguousarray(d[rows])).to(device)
                                        for d in ds) for b, ds in nz.items()})
            losses.append(float(m["loss"]))
    finally:
        st2.encode_tokens = real
    return {"tokens": list(zip(tokens[0::2], tokens[1::2])), "loss": losses,
            "final": {b: {k: v.detach().cpu() for k, v in t.state_dict().items()}
                      for b, t in (("l", t_l), ("h", t_h))}}


def par_final(state) -> dict:
    """A stage-1 train state on the host, laid out as ``stage1_from_jax``
    lays it out (the model's state dict, then the codebooks' fields)."""
    final = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
    for band, cb in (("vq_l", state.vq_l), ("vq_h", state.vq_h)):
        for f in ("embed", "embed_avg", "cluster_size", "initted"):
            final[f"{band}.{f}"] = getattr(cb, f).detach().cpu().clone()
    return final


class ParRecorder:
    """The logger of (e) and (f)'s runs: each step's loss (read after the
    run), a CUDA event after each step on the card, the validations."""

    def __init__(self, torch, on_card: bool):
        self.torch, self.on_card = torch, on_card
        self.losses, self.events, self.val = [], [], []

    def log_metrics(self, metrics, step):
        if "train/loss" not in metrics:
            self.val.append((step, {k: float(v) for k, v in metrics.items()}))
            return
        self.losses.append(metrics["train/loss"])
        if self.on_card:
            self.events.append(self.torch.cuda.Event(enable_timing=True))
            self.events[-1].record()


def par_run_cfg():
    """(e)'s config: the small one, dropout 0, a global batch of PAR_RUN_B,
    validating and snapshotting every 2 steps."""
    from tvqvae_tpu_torch.config import Config

    return Config.from_dict({**SMALL_CFG, "encoder": {**SMALL_CFG["encoder"], "dropout": 0.0},
                             "decoder": {**SMALL_CFG["decoder"], "dropout": 0.0},
                             "dataset": {"batch_sizes": {"stage1": PAR_RUN_B}},
                             "trainer_params": {"val_check_interval": {"stage1": 2}}})


def par_run_data():
    """(e)'s seeded splits: 32 train and PAR_RUN_TEST test series."""
    from tvqvae_tpu_torch.data.dataset import DatasetSplits, make_synthetic_trajectories

    X, y = make_synthetic_trajectories(n=32 + PAR_RUN_TEST, channels=C, length=PAR_RUN_L,
                                       n_classes=N_CLASSES, seed=5)
    return DatasetSplits(X_train=X[:32], y_train=y[:32, None], X_test=X[32:],
                         y_test=y[32:, None], scaler=None, n_classes=N_CLASSES)


def par_run(torch, save_path, device, data_on_device=True, tp=1) -> dict:
    """(e): ``train_stage1`` of ``par_run_cfg`` over ``par_run_data`` for
    PAR_RUN_STEPS steps (with ``tp``), writing to ``save_path`` -> {"final":
    its state on the host, "loss": the logged losses, "val": the
    validations} (the primary's log; another rank logs nothing)."""
    from tvqvae_tpu_torch.train.runner import train_stage1

    rec = ParRecorder(torch, device == "cuda")
    state = train_stage1(par_run_cfg(), par_run_data(), max_steps=PAR_RUN_STEPS, seed=2,
                         logger=rec, device=device, log_interval=1, save_path=save_path,
                         data_on_device=data_on_device, tp=tp)
    return {"final": par_final(state), "loss": [float(v) for v in rec.losses], "val": rec.val}


def par_production(torch, cfg_dict, length, device) -> dict:
    """(f): ``train_stage1`` in the production recipe (``PRODUCTION``: cuDNN,
    AdamW with bfloat16 first moments, bfloat16 compute, fast BatchNorm) at
    ``cfg_dict``'s widths with its dropout, PAR_PROD_STEPS steps at a global
    batch of PAR_B1 on seeded series, no validation -> {"sums": the state's
    leaf sums, "finite", "loss", "ms": steps 2 on (CUDA events, the
    primary's), "peak_gib"}."""
    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.data.dataset import DatasetSplits
    from tvqvae_tpu_torch.train.runner import train_stage1

    prod = json.loads(json.dumps(cfg_dict))
    for part in ("encoder", "decoder"):
        prod.get(part, {}).pop("dropout", None)
    prod["dataset"] = {"batch_sizes": {"stage1": PAR_B1}}
    X = np.random.default_rng(22).normal(size=(2 * PAR_B1, C, length)).astype(np.float32)
    data = DatasetSplits(X_train=X, y_train=np.zeros((len(X), 1), np.int64),
                         X_test=X[:0], y_test=np.zeros((0, 1), np.int64), scaler=None,
                         n_classes=N_CLASSES)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    rec = ParRecorder(torch, on_card)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = False
    try:
        state = train_stage1(Config.from_dict(prod), data, max_steps=PAR_PROD_STEPS, logger=rec,
                             device=device, log_interval=1, **PRODUCTION)
    finally:
        torch.backends.cudnn.deterministic = saved
    final = par_final(state)
    ms = (rec.events[0].elapsed_time(rec.events[-1]) / (len(rec.events) - 1)
          if rec.events else None)
    return {"sums": par_leaf_sums(final), "loss": [float(v) for v in rec.losses], "ms": ms,
            "finite": all(bool(torch.isfinite(v).all()) for v in final.values()
                          if v.is_floating_point()),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0.0}


def par_tp(torch, cfg, model0, vq_l0, vq_h0, xs, device, out_dir):
    """(g) in a rank of the two: the ranks as a (1, 2) grid take (a)'s steps
    with SGD on every row of each global batch in native kernels, the
    rule's leaves split between them, then one AdamW step; then
    ``train_stage1(tp=2)`` at (e)'s small config, straight and resumed ->
    (summary for the parent, the SGD steps' state for rank 0's check against
    (a)'s reference, on the host: "final", step-1 "grads", "signs")."""
    import copy

    from tvqvae_tpu_torch.parallel import mesh, tp
    from tvqvae_tpu_torch.train.stage1 import create_stage1_state, make_stage1_train_step

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    allocated = torch.cuda.memory_allocated if on_card else (lambda: 0)
    sync()
    base = allocated()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    out, seen, signs, events, grads = {}, [], [], [], None
    with tp.make_mesh2d(1, PAR_WORLD), torch.backends.cudnn.flags(enabled=False), \
            deterministic_algorithms(torch):
        state = create_stage1_state(copy.deepcopy(model0), vq_l0, vq_h0, par_sgd(cfg))
        tp.shard_train_state_tp(state)
        model = state.model
        local = sum(p.numel() * p.element_size() for p in model.parameters())
        whole = sum(p.numel() * p.element_size() * (p.tp_shard.count if hasattr(p, "tp_shard")
                                                    else 1) for p in model.parameters())
        out.update(fraction=tp.sharded_fraction(model), local_bytes=local, whole_bytes=whole,
                   split_leaves=sum(hasattr(p, "tp_shard") for p in model.parameters()))

        def hook(m, i, o):
            seen.append((o.vq_l.indices.cpu(), o.vq_h.indices.cpu()))
            if not signs:
                signs.append(torch.sign(o.x_h - o.xhat_h).detach().to(torch.int8).cpu())

        model.register_forward_hook(hook)
        step = make_stage1_train_step()
        losses = []
        for x in xs:  # the batch is split over the data index alone: all rows on each rank
            _, m = step(state, torch.from_numpy(np.ascontiguousarray(x)).to(device))
            losses.append(m["loss"])
            if grads is None:
                grads = {k: tp.full_tensor(p, p.grad).cpu() for k, p in model.named_parameters()}
            if on_card:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
        sync()
        out["sgd_bytes"] = allocated() - base  # the slices and their gradients
        with tp.gathered(model):  # (a)'s state after the steps, whole, on the host
            final = {k: v.to("cpu", copy=True) for k, v in model.state_dict().items()}
        for band, cb in (("vq_l", state.vq_l), ("vq_h", state.vq_h)):
            for f in ("embed", "embed_avg", "cluster_size", "initted"):
                final[f"{band}.{f}"] = getattr(cb, f).to("cpu", copy=True)
        out["sums"] = par_leaf_sums(final)
        out.update(loss=[float(v) for v in losses], indices=seen)
        state.optimizer, state.scheduler = par_tx(cfg)(model.parameters())
        step(state, torch.from_numpy(np.ascontiguousarray(xs[-1])).to(device))
        state.optimizer.zero_grad(set_to_none=True)
        sync()
        out["adam_bytes"] = allocated() - base  # the slices and both moments
        out["moments_sliced"] = all(
            state.optimizer.state[p][k].shape == p.shape for p in model.parameters()
            if hasattr(p, "tp_shard") for k in ("exp_avg", "exp_avg_sq"))
        out["peak_bytes"] = (torch.cuda.max_memory_allocated() - base) if on_card else 0
        out["ms"] = (events[0].elapsed_time(events[-1]) / (len(events) - 1)) if on_card else None
        del state, model
    # the runner: tp=2 over the two ranks, straight, then its step-2 snapshot resumed
    path = os.path.join(out_dir, "tp", "stage1")
    floor, tp.MIN_SHARD_ELEMS = tp.MIN_SHARD_ELEMS, PAR_TP_FLOOR
    try:
        with deterministic_algorithms(torch):
            full = par_run(torch, path, device, tp=PAR_WORLD)
            mesh.barrier("par-tp-run")
            if mesh.is_primary():
                os.remove(path)
                os.remove(path + ".meta.json")
            mesh.barrier("par-tp-resume")
            resumed = par_run(torch, path, device, tp=PAR_WORLD)
    finally:
        tp.MIN_SHARD_ELEMS = floor
    for k, v in full["final"].items():
        check(torch.equal(v, resumed["final"][k]),
              f"[parallel] (g) tp=2 run: {k} after the resume differs from the straight run")
    check(resumed["loss"] == full["loss"][PAR_RUN_STEPS // 2:],
          f"[parallel] (g) tp=2 resumed losses {resumed['loss']} against {full['loss']}")
    out["run"] = {"final": full["final"], "sums": par_leaf_sums(full["final"]),
                  "loss": full["loss"], "val": full["val"]}
    return out, {"final": final, "grads": grads, "signs": signs[0]}


def check_adam_elements(label, ref, dut, cancelled, noise) -> dict:
    """Hold ``dut`` to ``ref``, two runs of the same Adam steps computed two
    ways (``par_final``'s layout): an element whose gradient is 0 up to
    rounding takes Adam's sign step either way, so every element within
    2e-4 + ``noise`` (2·Σlr) and all but 1e-4 of the elements outside the
    ``cancelled`` biases and the running means within 2e-4 + 2e-4 relative;
    codebooks within 1e-4 of 1 + |value|, counts and flags equal. -> the
    worst errors."""
    worst = {"leaf": 0.0, "codebook": 0.0, "beyond share": 0.0}
    beyond = n_el = 0
    for k, r in ref.items():
        a = dut[k]
        if k.endswith(("num_batches_tracked", "initted", "cluster_size")):
            check(torch_equal(a, r), f"{label}: {k} differs")
            continue
        a, r = a.double(), r.double()
        err = (a - r).abs()
        if k.startswith(("vq_l.", "vq_h.")):
            worst["codebook"] = max(worst["codebook"], float((err / (1.0 + r.abs())).max()))
            continue
        check(float(err.max()) <= 2e-4 + noise, f"{label}: {k} off by {float(err.max())}")
        worst["leaf"] = max(worst["leaf"], float(err.max()))
        if k not in cancelled and not k.endswith("running_mean"):
            beyond += int((err > 2e-4 + 2e-4 * r.abs()).sum())
            n_el += err.numel()
    check(worst["codebook"] <= 1e-4, f"{label}: codebooks off by {worst['codebook']}")
    worst["beyond share"] = beyond / max(n_el, 1)
    check(beyond <= 1e-4 * n_el, f"{label}: {beyond} of {n_el} elements beyond 2e-4")
    return worst


def torch_equal(a, b) -> bool:
    return a.shape == b.shape and bool((a == b).all())


HF_LEAVES = ("encoder_h.", "decoder_h.", "head_h.")  # what the HF band's L1 loss feeds


def check_stage1_pair(torch, label, ref, got, cancelled, flip_share, bound, vq_eps):
    """Hold a stage-1 run ``got`` (``par_stage1``'s, with SGD) to ``ref``, the
    same steps computed another way. The step-1 gradients per leaf within
    1e-4 of the leaf's max |grad| (a BatchNorm-cancelled bias, whose gradient
    is 0 up to rounding in both, within 1e-4 of its conv weight's), but for
    one case: the HF band's loss is an L1, whose gradient flips at a
    residual of 0. Where the residual changed sign between the two runs (k
    of n elements, residuals within rounding of 0), each flip changes one of
    the n terms ±1/n whose sum the HF gradients back-propagate, ~2/sqrt(n)
    of their norm; the HF leaves are then held to 4·k/sqrt(n)
    (``flip_share`` = k/sqrt(n)) in relative L2 norm. After the steps every leaf
    within 1e-4 + 1e-4 relative. Codebooks: ``cluster_size`` (the counts)
    equal, ``embed_avg`` within ``bound`` per column ((n-1)·2⁻²⁴·Σ|x| summed
    over the steps, plus 2⁻²² relative for the EMA's own rounding), and
    ``embed`` = ``embed_avg`` / the smoothed counts (the same in both,
    Laplace ``vq_eps``) within that bound over the smoothed counts (plus
    2⁻²¹ relative). -> the worst errors."""
    worst = {"grad": 0.0, "HF grad L2": 0.0, "cancelled grad": 0.0, "leaf": 0.0,
             "codebook bound share": 0.0}
    for k, g in got["grads"].items():
        r = ref["grads"][k].to(g.device)
        if k in cancelled:
            scale = float(ref["grads"][cancelled[k]].abs().max())
            e = max(float(r.abs().max()), float(g.abs().max())) / scale
            check(e <= 1e-4, f"{label}: cancelled {k} gradient {e:.3g} of its weight's")
            worst["cancelled grad"] = max(worst["cancelled grad"], e)
            continue
        if flip_share and k.startswith(HF_LEAVES):
            e = float((g - r).double().norm() / r.double().norm())
            check(e <= 4 * flip_share, f"{label}: {k} step-1 gradient off by {e:.3g} in L2")
            worst["HF grad L2"] = max(worst["HF grad L2"], e)
            continue
        e = float((g - r).abs().max()) / float(r.abs().max())
        check(e <= 1e-4, f"{label}: {k} step-1 gradient off by {e:.3g} of its scale")
        worst["grad"] = max(worst["grad"], e)
    for k, r in ref["final"].items():
        a = got["final"][k]
        r = r.to(a.device)
        if k.endswith(("num_batches_tracked", "initted")):
            check(bool((a == r).all()), f"{label}: {k} differs")
            continue
        a, r = a.double(), r.double()
        err = (a - r).abs()
        if not k.startswith(("vq_l.", "vq_h.")):
            check(bool((err <= 1e-4 + 1e-4 * r.abs()).all()),
                  f"{label}: {k} off by {float(err.max())}")
            worst["leaf"] = max(worst["leaf"], float(err.max()))
        elif k.endswith("cluster_size"):
            check(torch.equal(a, r), f"{label}: {k} (the counts) differs")
        else:
            avg = ref["final"][k[:5] + "embed_avg"].to(a.device).double()
            b = bound[k[:4]].to(a.device).double()[None, :] + 2.0 ** -22 * avg.abs()
            if k.endswith(".embed"):
                cs = ref["final"][k[:5] + "cluster_size"].to(a.device).double()
                n = cs.sum()
                smoothed = (cs + vq_eps) / (n + cs.numel() * vq_eps) * n
                b = b / smoothed[:, None] + 2.0 ** -21 * r.abs()
            check(bool((err <= b).all()), f"{label}: {k} beyond its sum bound")
            worst["codebook bound share"] = max(worst["codebook bound share"],
                                                float((err / b).max()))
    return worst


PAR_KM_STEPS, PAR_KM_THRESHOLD = 3, 20  # (h): steps, and a threshold that expires LF codes
PAR_I_SERIES, PAR_I_STEPS, PAR_I_VAL = 40, 2, 32  # (i): the sweeps' series, steps, validation


def par_km_cfg(cfg_dict):
    """(h)'s config: ``cfg_dict`` with k-means init and dead-code expiry on
    both codebooks (off when published), a global batch of PAR_B1."""
    from tvqvae_tpu_torch.config import Config

    vq = {**cfg_dict.get("VQ-VAE", {}), "kmeans_init": True,
          "threshold_ema_dead_code": PAR_KM_THRESHOLD}
    return Config.from_dict({**cfg_dict, "VQ-VAE": vq,
                             "dataset": {"batch_sizes": {"stage1": PAR_B1}}})


class KMRecorder:
    """Inside: ``models/vq.py``'s k-means (its (means, bins) per codebook and
    its ms by CUDA events on the card), the rows the k-means init and the
    dead-code expiry drew (global indices, rows) and each quantizer call of
    the steps (rows, Σ|x| per column, codes expired), recorded."""

    def __init__(self, torch, on_card):
        self.torch, self.on_card = torch, on_card
        self.kmeans, self.kmeans_ms, self.draws, self.vq_in, self.expired = [], [], [], [], 0

    def __enter__(self):
        from tvqvae_tpu_torch.models import stage1 as s1_module
        from tvqvae_tpu_torch.models import vq as vq_module

        torch, self.mods = self.torch, (vq_module, s1_module)
        self.real = (vq_module.kmeans, vq_module._global_rows, s1_module.vq_forward)
        real_kmeans, real_rows, real_vq = self.real

        def kmeans(samples, *a, **kw):
            if self.on_card:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            means, bins = real_kmeans(samples, *a, **kw)
            if self.on_card:
                ev[1].record()
                torch.cuda.synchronize()
                self.kmeans_ms.append(ev[0].elapsed_time(ev[1]))
            self.kmeans.append((means.cpu(), bins.cpu()))
            return means, bins

        def rows(flat, idx):
            got = real_rows(flat, idx)
            self.draws.append((idx.cpu(), got.cpu()))
            return got

        def vq(state, x, p, **kw):
            out = real_vq(state, x, p, **kw)
            if kw.get("train"):
                flat = x.detach().reshape(-1, x.shape[-1]).double()
                self.vq_in.append((flat.shape[0], flat.abs().sum(0).cpu()))
                self.expired += int((out.state.cluster_size < p.threshold_ema_dead_code).sum())
            return out

        vq_module.kmeans, vq_module._global_rows, s1_module.vq_forward = kmeans, rows, vq
        return self

    def __exit__(self, *exc):
        vq_module, s1_module = self.mods
        vq_module.kmeans, vq_module._global_rows, s1_module.vq_forward = self.real


def par_kmeans(torch, cfg_dict, length, device) -> dict:
    """(h): ``train_stage1`` of ``par_km_cfg`` for PAR_KM_STEPS steps at a
    global batch of PAR_B1 on seeded series, with SGD (``par_sgd``: Adam's
    first step is a sign step), in PyTorch's native kernels and
    deterministic algorithms (as (a)) -> the ``KMRecorder``'s records, the
    codebooks after the steps, the draw generator's state, the VQ launches
    (the card's counter)."""
    from tvqvae_tpu_torch.data.dataset import DatasetSplits
    from tvqvae_tpu_torch.ops import vq_kernel
    from tvqvae_tpu_torch.train import runner

    X = np.random.default_rng(23).normal(size=(PAR_B1, C, length)).astype(np.float32)
    data = DatasetSplits(X_train=X, y_train=np.zeros((len(X), 1), np.int64), X_test=X[:0],
                         y_test=np.zeros((0, 1), np.int64), scaler=None, n_classes=N_CLASSES)
    real_tx = runner._adamw
    runner._adamw = lambda cfg, *a: par_sgd(cfg)
    vq_kernel.launch_count = 0
    try:
        with KMRecorder(torch, device == "cuda") as rec, \
                torch.backends.cudnn.flags(enabled=False), deterministic_algorithms(torch):
            state = runner.train_stage1(par_km_cfg(cfg_dict), data, max_steps=PAR_KM_STEPS,
                                        seed=4, device=device)
    finally:
        runner._adamw = real_tx
    return {"kmeans": rec.kmeans, "kmeans_ms": rec.kmeans_ms, "draws": rec.draws,
            "vq_in": rec.vq_in, "expired": rec.expired, "draw_state": state.draws.get_state(),
            "codebooks": {band: {f: getattr(cb, f).cpu() for f in ("embed", "embed_avg",
                                                                  "cluster_size", "initted")}
                          for band, cb in (("vq_l", state.vq_l), ("vq_h", state.vq_h))},
            "launches": vq_kernel.launch_count}


def check_kmeans(torch, label, ref, got, eps) -> dict:
    """Hold (h)'s run ``got`` to one process's ``ref`` (``par_kmeans``'s):
    the rows drawn (the same global indices, their values within 1e-4 +
    1e-4 relative), the k-means ``bins`` (counts) equal and its means within
    (n-1)·2⁻²⁴·Σ|x| of its samples, per column; after the steps
    ``cluster_size`` equal, ``embed_avg`` within that bound plus the steps'
    (Σ over the steps' quantizer inputs) plus 2⁻²² relative, ``embed``
    within it over the smoothed counts plus 2⁻²¹ relative where its code did
    not expire, and the draw generator in one state. -> the worst shares of
    the bounds."""
    worst = {"kmeans means": 0.0, "embed_avg": 0.0, "embed": 0.0, "drawn rows": 0.0}
    check(torch.equal(got["draw_state"], ref["draw_state"]),
          f"{label}: the draw generator's state differs")
    check(len(got["draws"]) == len(ref["draws"]) == 2 + 2 * PAR_KM_STEPS,
          f"{label}: {len(got['draws'])} row draws, not {2 + 2 * PAR_KM_STEPS}")
    for (idx, rows), (r_idx, r_rows) in zip(got["draws"], ref["draws"]):
        check(torch.equal(idx, r_idx), f"{label}: the drawn rows' indices differ")
        e = (rows.double() - r_rows.double()).abs() / (1e-4 + 1e-4 * r_rows.double().abs())
        worst["drawn rows"] = max(worst["drawn rows"], float(e.max()))
    check(worst["drawn rows"] <= 1.0, f"{label}: drawn rows off by {worst['drawn rows']} of bound")
    bounds = {}
    for b, band in enumerate(("vq_l", "vq_h")):
        (means, bins), (r_means, r_bins) = got["kmeans"][b], ref["kmeans"][b]
        check(torch.equal(bins, r_bins), f"{label}: {band} k-means bins (counts) differ")
        n, s = ref["vq_in"][b]  # step 1's quantizer input: the k-means samples
        km = (n - 1) * 2.0 ** -24 * s
        e = (means.double() - r_means.double()).abs() / km[None, :]
        worst["kmeans means"] = max(worst["kmeans means"], float(e.max()))
        bounds[band] = km + sum((n_ - 1) * 2.0 ** -24 * s_ for n_, s_ in ref["vq_in"][b::2])
    check(worst["kmeans means"] <= 1.0, f"{label}: k-means means beyond their sum bound")
    for band, cb in got["codebooks"].items():
        r = ref["codebooks"][band]
        check(torch.equal(cb["cluster_size"], r["cluster_size"]),
              f"{label}: {band} cluster_size (the counts) differs")
        check(bool(cb["initted"]) and bool(r["initted"]), f"{label}: {band} not initialised")
        avg = r["embed_avg"].double()
        b_avg = bounds[band][None, :] + 2.0 ** -22 * avg.abs()
        e = (cb["embed_avg"].double() - avg).abs() / b_avg
        worst["embed_avg"] = max(worst["embed_avg"], float(e.max()))
        cs = r["cluster_size"].double()
        smoothed = (cs + eps) / (cs.sum() + cs.numel() * eps) * cs.sum()
        live = cs >= PAR_KM_THRESHOLD  # an expired code holds a drawn row
        emb = r["embed"].double()
        e = ((cb["embed"].double() - emb).abs()
             / (b_avg / smoothed[:, None] + 2.0 ** -21 * emb.abs()))[live]
        worst["embed"] = max(worst["embed"], float(e.max()) if e.numel() else 0.0)
    check(worst["embed_avg"] <= 1.0 and worst["embed"] <= 1.0,
          f"{label}: codebooks beyond their sum bounds {worst}")
    return worst


class ValRecorder:
    """What ``runner._running_metrics`` reads of an ``evaluation.Metrics``:
    it records the series each validation scores instead of scoring them."""

    z_test = X_test = None

    def __init__(self):
        self.seen = []

    def z_gen_fn(self, x):
        self.seen.append(np.array(x))

    def fid_score(self, *a, **kw):
        return 0.0

    def stat_metrics(self, *a):
        return 0.0, 0.0, 0.0, 0.0


@contextlib.contextmanager
def recorded_tokens(out):
    """The token grids the samplers of ``train/stage2.py`` decode, appended
    to ``out`` (LF then HF of each batch) on the host."""
    from tvqvae_tpu_torch.train import stage2 as st2

    real = st2.decode_tokens

    def recording(frozen, s, band, *a, **kw):
        out.append(s.cpu())
        return real(frozen, s, band, *a, **kw)

    st2.decode_tokens = recording
    try:
        yield out
    finally:
        st2.decode_tokens = real


def par_i_data(length):
    """(i)'s seeded splits: PAR_I_SERIES train series, 4 test."""
    from tvqvae_tpu_torch.data.dataset import DatasetSplits

    rng = np.random.default_rng(24)
    X = rng.normal(size=(PAR_I_SERIES + 4, C, length)).astype(np.float32)
    y = rng.integers(0, N_CLASSES, size=(len(X), 1)).astype(np.int64)
    return DatasetSplits(X_train=X[:PAR_I_SERIES], y_train=y[:PAR_I_SERIES],
                         X_test=X[PAR_I_SERIES:], y_test=y[PAR_I_SERIES:], scaler=None,
                         n_classes=N_CLASSES)


def par_i_cfg(cfg_dict):
    """(i)'s config: ``cfg_dict`` at the published batches, validating at
    the last step only."""
    from tvqvae_tpu_torch.config import Config

    return Config.from_dict({**cfg_dict, "dataset": {"batch_sizes": {"stage2": PAR_B2,
                                                                      "stage3": PAR_B2}},
                             "evaluation": {"batch_size": PAR_I_VAL},
                             "trainer_params": {"val_check_interval": {"stage2": 10 ** 6,
                                                                       "stage3": 10 ** 6}}})


def par_sweeps(torch, frozen, X, data_parallel) -> dict:
    """The token sweep (batches of 64) and the x' sweep (batches of 32) over
    ``X`` on the card, each timed -> {"tokens", "xprime" on the host,
    "seconds": (token, x')}."""
    from tvqvae_tpu_torch.train import stage2 as st2, stage3 as st3

    sync = torch.cuda.synchronize if X.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    tokens = st2.precompute_token_dataset(frozen, X, 64, data_parallel=data_parallel)
    sync()
    t1 = time.perf_counter()
    xprime = st3.precompute_xprime_dataset(frozen, X, 32, keep_on_device=True,
                                           data_parallel=data_parallel)
    sync()
    return {"tokens": tokens, "xprime": xprime.cpu(),
            "seconds": (t1 - t0, time.perf_counter() - t1)}


def par_fanout(torch, cfg_dict, length, frozen, device, out_dir) -> dict:
    """(i) in a rank of the two: both sweeps spread over the ranks; then
    ``train_stage2`` and ``train_stage3`` (tau 0) for PAR_I_STEPS steps over
    ``frozen``, precomputing over the ranks (they share one host) and
    validating at the end, PAR_I_VAL series decoded (and enhanced) over the
    ranks, the primary alone holding the metrics -> the sweeps, each
    validation's series and tokens (this rank's rows), the final priors and
    enhancer on the host."""
    from tvqvae_tpu_torch.parallel import mesh
    from tvqvae_tpu_torch.train import runner

    data, cfg = par_i_data(length), par_i_cfg(cfg_dict)
    out = {"sweeps": par_sweeps(torch, frozen, torch.from_numpy(data.X_train).to(device), True)}
    stage2_path = os.path.join(out_dir, "i", "stage2")
    for stage in (2, 3):
        metrics = ValRecorder() if mesh.is_primary() else None
        tokens = []
        kw = dict(max_steps=PAR_I_STEPS, seed=5, device=device, metrics=metrics,
                  val_n_samples=PAR_I_VAL)
        with recorded_tokens(tokens):
            if stage == 2:
                state = runner.train_stage2(cfg, data, frozen, save_path=stage2_path, **kw)
                sd = {b: {k: v.cpu() for k, v in t.state_dict().items()}
                      for b, t in (("l", state.t_l), ("h", state.t_h))}
            else:
                state = runner.train_stage3(cfg, data, frozen, stage2_ckpt=stage2_path, **kw)
                sd = {k: v.cpu() for k, v in state.fe.state_dict().items()}
        out[stage] = {"val": metrics.seen if metrics is not None else None, "tokens": tokens,
                      "state": sd}
    return out


def par_fanout_one(torch, cfg_dict, length, frozen, device, ranks_out, stage2_path) -> dict:
    """(i) in this process: the validation of each of the ranks' final
    states, one process sampling (and enhancing) every row -> {stage:
    (series list, tokens)}."""
    from tvqvae_tpu_torch.models.fidelity_enhancer import FidelityEnhancer
    from tvqvae_tpu_torch.models.maskgit import MaskGITSpec, build_transformers
    from tvqvae_tpu_torch.train import runner
    from tvqvae_tpu_torch.train import stage2 as st2
    from tvqvae_tpu_torch.utils.checkpoint import load_checkpoint

    cfg = par_i_cfg(cfg_dict)
    spec = MaskGITSpec.from_config(cfg, frozen.model.spec)
    out = {}
    t_l, t_h = build_transformers(cfg, frozen.model.spec, N_CLASSES)
    t_l.load_state_dict(ranks_out[2]["state"]["l"])
    t_h.load_state_dict(ranks_out[2]["state"]["h"])
    tokens = []
    with recorded_tokens(tokens):
        sets = runner._val_samples(cfg, st2.make_sampling_fn(frozen, t_l.to(device).eval(),
                                                             t_h.to(device).eval(), spec),
                                   PAR_I_VAL, 10_000 + PAR_I_STEPS, torch.device(device))
    out[2] = ([x for _, x in sets], tokens)
    p_l, p_h = st2.priors_from_tree(cfg, frozen.model.spec, N_CLASSES,
                                    load_checkpoint(stage2_path)[0])
    fe = FidelityEnhancer.from_config(cfg, length, C)
    fe.load_state_dict(ranks_out[3]["state"])
    tokens = []
    with recorded_tokens(tokens):
        sets = runner._val_samples(cfg, st2.make_sampling_fn(frozen, p_l.to(device).eval(),
                                                             p_h.to(device).eval(), spec),
                                   PAR_I_VAL, 20_000 + PAR_I_STEPS, torch.device(device),
                                   enhance=fe.to(device).eval())
    out[3] = ([x for _, x in sets], tokens)
    return out


def par_leaf_sums(final) -> dict:
    """{leaf: (Σ v, Σ |v|) in float64}, to hold two ranks' states equal
    without moving them."""
    return {k: (float(v.double().sum()), float(v.double().abs().sum())) for k, v in final.items()}


def parallel_rank(rank, world, ports, out_dir, cfg_dict, length, device):
    """One rank of ``[parallel]`` (a spawned child on the card): (c)'s
    reference step with no process group (rank 0), then a gloo group of
    ``world`` ranks for (a) and (b), then, on rank 0, (a)'s check against
    the parent's one-process run (``out_dir/ref.pt``, read where the state
    lies) and a one-rank NCCL group (gloo on the CPU) for (c); its results,
    VQ launches by part and peak memory to ``out_dir/rank<rank>.pt``."""
    import torch
    import torch.distributed as dist

    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.models.stage1 import init_stage1
    from tvqvae_tpu_torch.ops import vq_kernel

    torch.set_num_threads(2)
    on_card = device == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        vq_kernel.build()
    cfg = Config.from_dict(cfg_dict)
    spec, xs1, xs2, ys2, noise = par_inputs(cfg, length)
    model0, vq_l0, vq_h0 = init_stage1(spec, torch.Generator().manual_seed(0), device)
    cancelled = biases_cancelled_by_batchnorm(model0)
    with deterministic_cudnn(torch):  # (b), (c) and (e): (c) and (e) compare bit for bit
        res = parallel_rank_work(torch, dist, rank, world, ports, out_dir, cfg, spec, xs1, xs2,
                                 ys2, noise, model0, vq_l0, vq_h0, cancelled, device,
                                 cfg_dict, length)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt.tmp"))
    os.replace(os.path.join(out_dir, f"rank{rank}.pt.tmp"), os.path.join(out_dir, f"rank{rank}.pt"))


def parallel_rank_work(torch, dist, rank, world, ports, out_dir, cfg, spec, xs1, xs2, ys2, noise,
                       model0, vq_l0, vq_h0, cancelled, device, cfg_dict, length):
    """``parallel_rank``'s steps and checks, under deterministic cuDNN."""
    import copy

    from tvqvae_tpu_torch.models.maskgit import FrozenStage1
    from tvqvae_tpu_torch.ops import vq_kernel
    from tvqvae_tpu_torch.parallel import mesh

    on_card = device == "cuda"
    res, launches = {}, {}
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{ports[0]}", rank=rank,
                            world_size=world)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    rows1, rows2 = mesh.shard_bounds(PAR_B1), mesh.shard_bounds(PAR_B2)
    vq_kernel.launch_count = 0
    t0 = time.perf_counter()
    # (a) in native kernels and deterministic algorithms: see parallel_phase
    with torch.backends.cudnn.flags(enabled=False), deterministic_algorithms(torch):
        a = par_stage1(torch, cfg, model0, vq_l0, vq_h0, xs1, rows1, device, timed=on_card,
                       tx=par_sgd(cfg))
    res["a_seconds"] = time.perf_counter() - t0
    launches["a"] = vq_kernel.launch_count
    signs = torch.cat(mesh.all_gather_object(a["signs"]))  # the global batch's HF residual signs
    res["a"] = {"indices": a["indices"], "loss": a["loss"], "ms": a.get("ms"),
                "hf_elements": signs.numel(),
                "sums": par_leaf_sums(a["final"]),
                "side": {k: v.cpu() for k, v in a["final"].items()
                         if k.startswith(("vq_l.", "vq_h.")) or "running_" in k}}
    frozen = FrozenStage1(copy.deepcopy(model0).eval().requires_grad_(False), vq_l0, vq_h0)
    vq_kernel.launch_count = 0
    res["b"] = par_stage2(torch, cfg, frozen, xs2, ys2, noise, rows2, device)
    launches["b"] = vq_kernel.launch_count
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0.0
    # (e): the runner on the host feed, a straight run, then its step-2
    # snapshot resumed (the stage checkpoint removed): the same state
    path = os.path.join(out_dir, "run", "stage1")
    vq_kernel.launch_count = 0
    with deterministic_algorithms(torch):
        full = par_run(torch, path, device)
        mesh.barrier("par-run")
        if rank == 0:
            os.remove(path)
            os.remove(path + ".meta.json")
        mesh.barrier("par-resume")
        resumed = par_run(torch, path, device)
    launches["e"] = vq_kernel.launch_count
    for k, v in full["final"].items():
        check(torch.equal(v, resumed["final"][k]),
              f"[parallel] (e) rank {rank}: {k} after the resume differs from the straight run")
    check(resumed["loss"] == full["loss"][PAR_RUN_STEPS // 2:],
          f"[parallel] (e) resumed losses {resumed['loss']} against {full['loss']}")
    res["e"] = {"final": full["final"], "sums": par_leaf_sums(full["final"]),
                "loss": full["loss"], "val": full["val"]}
    # (f): the production recipe's two-rank steps at the published width
    vq_kernel.launch_count = 0
    res["f"] = par_production(torch, cfg_dict, length, device)
    launches["f"] = vq_kernel.launch_count
    # (g): tensor parallelism, the two ranks as a (1, 2) grid
    vq_kernel.launch_count = 0
    t0 = time.perf_counter()
    res["g"], g_state = par_tp(torch, cfg, model0, vq_l0, vq_h0, xs1, device, out_dir)
    res["g_seconds"] = time.perf_counter() - t0
    launches["g"] = vq_kernel.launch_count
    # (h): k-means init and dead-code expiry over the global batch
    t0 = time.perf_counter()
    res["h"] = par_kmeans(torch, cfg_dict, length, device)
    res["h_seconds"] = time.perf_counter() - t0
    launches["h"] = res["h"].pop("launches")
    # (i): the sweeps and the stage-2/3 validations spread over the ranks
    vq_kernel.launch_count = 0
    t0 = time.perf_counter()
    res["i"] = par_fanout(torch, cfg_dict, length, frozen, device, out_dir)
    res["i_seconds"] = time.perf_counter() - t0
    launches["i"] = vq_kernel.launch_count
    dist.destroy_process_group()
    del frozen
    if rank == 0:
        ref_path = os.path.join(out_dir, "ref.pt")
        t_wait = time.perf_counter()
        while not os.path.exists(ref_path):
            check(time.perf_counter() - t_wait < 300, "[parallel] no one-process reference")
            time.sleep(0.1)
        ref = torch.load(ref_path, map_location=device, weights_only=True)
        flips = int((signs != ref["signs"].cpu()).sum())
        # each flip widens the HF leaves' bound: a faulty reduction must not widen its own
        check(flips <= PAR_FLIPS, f"[parallel] the HF L1 residual changed sign at {flips} of "
                                  f"{signs.numel()} elements, more than {PAR_FLIPS}")
        res["a_check"] = check_stage1_pair(torch, "[parallel] two-rank steps", ref, a, cancelled,
                                           flips / signs.numel() ** 0.5, ref["bound"],
                                           spec.vq_l.eps)
        res["a_check"]["HF L1 residual sign flips"] = flips
        print(f"[parallel] rank 0, (a) against one process: {res['a_check']}", flush=True)
        # (g)'s steps on all 32 rows against the same one-process reference
        flips = int((g_state["signs"] != ref["signs"].cpu()).sum())
        check(flips <= PAR_FLIPS, f"[parallel] (g) the HF L1 residual changed sign at {flips} "
                                  f"elements, more than {PAR_FLIPS}")
        res["g_check"] = check_stage1_pair(torch, "[parallel] (g) tp=2 steps", ref, g_state,
                                           cancelled, flips / signs.numel() ** 0.5,
                                           ref["bound"], spec.vq_l.eps)
        res["g_check"]["HF L1 residual sign flips"] = flips
        res["g_check"]["bit-equal"] = all(
            torch.equal(v, g_state["final"][k].to(v.device)) for k, v in ref["final"].items()) \
            and all(torch.equal(v.cpu(), g_state["grads"][k]) for k, v in ref["grads"].items())
        print(f"[parallel] rank 0, (g) against one process: {res['g_check']}", flush=True)
        del ref, a, g_state
        vq_kernel.launch_count = 0  # (c): one step with no process group, then in one of NCCL
        with deterministic_algorithms(torch):
            ref_c = par_stage1(torch, cfg, model0, vq_l0, vq_h0, xs1[:1], slice(None), device)
            launches["c_ref"] = vq_kernel.launch_count
            dist.init_process_group("nccl" if on_card else "gloo",
                                    init_method=f"tcp://127.0.0.1:{ports[1]}", rank=0,
                                    world_size=1)
            vq_kernel.launch_count = 0
            got_c = par_stage1(torch, cfg, model0, vq_l0, vq_h0, xs1[:1], slice(None), device)
            launches["c"] = vq_kernel.launch_count
            dist.destroy_process_group()
        # a one-rank group's reductions are identities: the same step, bit for bit
        for band in (0, 1):
            check(torch.equal(ref_c["indices"][0][band], got_c["indices"][0][band]),
                  f"one-rank NCCL step: band {band} indices differ from the step with no group")
        for part in ("grads", "final"):
            for k, v in ref_c[part].items():
                check(torch.equal(v, got_c[part][k]),
                      f"one-rank NCCL step: {part} {k} differs from the step with no group")
        res["c"] = {"leaves": len(ref_c["final"]), "loss": (ref_c["loss"][0], got_c["loss"][0])}
    res["launches"] = launches
    return res


def _free_ports(n: int) -> list:
    """``n`` distinct free localhost ports (the sockets held until all are
    picked)."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for sock in socks:
            sock.bind(("127.0.0.1", 0))
        return [sock.getsockname()[1] for sock in socks]
    finally:
        for sock in socks:
            sock.close()


def parallel_phase(torch, vq_kernel, work, smi, device="cuda", cfg_dict=None, length=None):
    """``[parallel]``: (a)-(c) in ``PAR_WORLD`` spawned ranks while this
    process runs their one-process references and (d); then every check,
    the numbers printed beside ``smi`` (the card's name and power limit).
    ``cfg_dict`` and ``length`` (default ``PAR_CFG`` and ``L``) size a
    rehearsal on the CPU. -> the VQ kernel launches of the phase (every
    process's): those of (a)-(f), and those of (g)."""
    import copy

    import torch.multiprocessing as mp

    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.models import vq as vq_module
    from tvqvae_tpu_torch.models.maskgit import FrozenStage1
    from tvqvae_tpu_torch.models.stage1 import Stage1Model, Stage1Spec, init_stage1
    from tvqvae_tpu_torch.scripts import serve
    from tvqvae_tpu_torch.train import runner
    from tvqvae_tpu_torch.train.stage1 import create_stage1_state
    from tvqvae_tpu_torch.utils.schedule import warmup_cosine_schedule

    t_start = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="parallel_", dir=work.root)
    ctx = mp.get_context("spawn")
    ports = _free_ports(2)
    cfg_dict = PAR_CFG if cfg_dict is None else cfg_dict
    length = L if length is None else length
    procs = [ctx.Process(target=parallel_rank, daemon=True,
                         args=(r, PAR_WORLD, ports, out_dir, cfg_dict, length, device))
             for r in range(PAR_WORLD)]
    for proc in procs:
        proc.start()
    try:
        # the one-process references of (a) and (b), counted, while the ranks start
        cfg = Config.from_dict(cfg_dict)
        spec, xs1, xs2, ys2, noise = par_inputs(cfg, length)
        model0, vq_l0, vq_h0 = init_stage1(spec, torch.Generator().manual_seed(0), device)
        vq_kernel.launch_count = 0
        vq_in = []  # (rows, Σ|x| per column) of each VQ call of (a)'s reference

        def sizing(flat, embed):
            vq_in.append((flat.shape[0], flat.detach().abs().sum(0).double().cpu()))
            return vq_kernel.nearest_codes_stats(flat, embed)

        vq_module.nearest_codes_stats = sizing
        try:
            # (a) compares native kernels: cuDNN picks its algorithms by batch
            # size, and an FFT convolution at 32 rows against another at 16
            # moved the HF decoder's output by more than rounding; and
            # deterministic algorithms, so that the only differences left are
            # the two ways of reducing the batch
            with torch.backends.cudnn.flags(enabled=False), deterministic_algorithms(torch):
                ref_a = par_stage1(torch, cfg, model0, vq_l0, vq_h0, xs1, slice(None), device,
                                   tx=par_sgd(cfg))
        finally:
            vq_module.nearest_codes_stats = vq_kernel.nearest_codes_stats
        # embed_avg's bound per column: (n-1)·2⁻²⁴·Σ|x| of each step's VQ input, summed
        bound = {band: sum((n - 1) * 2.0 ** -24 * s_ for n, s_ in vq_in[i::2])
                 for i, band in enumerate(("vq_l", "vq_h"))}
        # rank 0 checks its state against this, where its state lies
        torch.save({"final": {k: v.cpu() for k, v in ref_a.pop("final").items()},
                    "grads": {k: v.cpu() for k, v in ref_a.pop("grads").items()},
                    "signs": ref_a["signs"], "bound": bound}, os.path.join(out_dir, "ref.pt.tmp"))
        os.replace(os.path.join(out_dir, "ref.pt.tmp"), os.path.join(out_dir, "ref.pt"))
        frozen = FrozenStage1(copy.deepcopy(model0).eval().requires_grad_(False), vq_l0, vq_h0)
        with deterministic_cudnn(torch):
            ref_b = par_stage2(torch, cfg, frozen, xs2, ys2, noise, slice(None), device)
        parent_launches = vq_kernel.launch_count
        del model0

        # (d): the serve CLI's service with and without --data_parallel
        parser = serve.build_argparser()
        base = ["--dataset_file", work.dataset, "--model_save_dir", work.models, "--device",
                device, "--no_warmup"]
        series = {}
        with deterministic_cudnn(torch):
            for flag in ((), ("--data_parallel",)):
                svc = serve.build_service(parser.parse_args(base + list(flag)), parser)
                series[flag] = (svc.sampler.sample(B, seed=3), len(svc.sampler.devices))
                del svc
        for (a_, b_) in zip(series[()][0], series[("--data_parallel",)][0]):
            check(np.array_equal(a_, b_), "serve --data_parallel differs from the one-device "
                                          "service")
        n_dev = series[("--data_parallel",)][1]
        check(n_dev == (torch.cuda.device_count() if device == "cuda" else 1),
              f"--data_parallel over {n_dev} devices")

        # (e)'s one-process runs: the device gather, then the host feed
        vq_kernel.launch_count = 0
        with deterministic_cudnn(torch), deterministic_algorithms(torch):
            one = par_run(torch, os.path.join(out_dir, "one", "stage1"), device)
            host = par_run(torch, os.path.join(out_dir, "host", "stage1"), device,
                           data_on_device=False)
        run_launches = vq_kernel.launch_count
        for k, v in one["final"].items():
            check(torch.equal(v, host["final"][k]),
                  f"[parallel] (e) one process on the host feed: {k} differs from the device "
                  f"gather's run")
        check(host["loss"] == one["loss"] and host["val"] == one["val"],
              "[parallel] (e) one process on the host feed: the logs differ")

        # (h)'s one-process run and (i)'s one-process sweeps, while the ranks run
        with deterministic_cudnn(torch):
            ref_h = par_kmeans(torch, cfg_dict, length, device)
            vq_kernel.launch_count = 0
            one_sweeps = par_sweeps(torch, frozen, torch.from_numpy(
                par_i_data(length).X_train).to(device), False)
            sweep_launches = vq_kernel.launch_count

        for proc in procs:
            proc.join(timeout=300)
        for r, proc in enumerate(procs):
            check(proc.exitcode == 0, f"[parallel] rank {r} exited {proc.exitcode}")
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(PAR_WORLD)]
    # (i): this process's validation of the ranks' final states
    with deterministic_cudnn(torch):
        one_val = par_fanout_one(torch, cfg_dict, length, frozen, device, ranks[0]["i"],
                                 os.path.join(out_dir, "i", "stage2"))
    del frozen
    shutil.rmtree(out_dir, ignore_errors=True)

    # (a): indices, the ranks equal (rank 0 held its state to this process's)
    for t in range(PAR_STEPS):
        for band in (0, 1):
            got = torch.cat([rk["a"]["indices"][t][band] for rk in ranks])
            check(torch.equal(got, ref_a["indices"][t][band]),
                  f"[parallel] two-rank step {t + 1}: band {band} indices differ")
    loss_two = [float(np.mean([rk["a"]["loss"][t] for rk in ranks])) for t in range(PAR_STEPS)]
    loss_gap = max(abs(a_ - b_) / abs(b_) for a_, b_ in zip(loss_two, ref_a["loss"]))
    check(loss_gap <= 1e-4, f"[parallel] two-rank losses {loss_two} vs {ref_a['loss']}")
    side = [rk["a"]["side"] for rk in ranks]
    for k, v in side[0].items():
        check(torch.equal(v, side[1][k]), f"[parallel] ranks' {k} differ")
    check(ranks[0]["a"]["sums"] == ranks[1]["a"]["sums"], "[parallel] ranks' parameters differ")
    n_bn = sum(k.endswith("running_mean") for k in side[0])

    # (b): tokens and the priors
    for t in range(PAR_STEPS):
        for band in (0, 1):
            got = torch.cat([rk["b"]["tokens"][t][band] for rk in ranks])
            check(torch.equal(got, ref_b["tokens"][t][band]),
                  f"[parallel] stage-2 step {t + 1}: band {band} tokens differ")
    prior_err = 0.0
    for b_ in ("l", "h"):
        for k, v in ref_b["final"][b_].items():
            for rk in ranks:
                got = rk["b"]["final"][b_][k]
                if k.endswith("num_batches_tracked"):
                    check(torch.equal(got, v), f"[parallel] prior {b_}.{k} differs")
                    continue
                e = (got - v).abs()
                check(bool((e <= 1e-4 + 1e-4 * v.abs()).all()),
                      f"[parallel] prior {b_}.{k} off by {float(e.max())}")
                prior_err = max(prior_err, float(e.max()))

    # (e): the ranks' run against one process's, Adam's element rule; their
    # last validation (each rank its share of the test split's batches)
    # within 1e-5 relative of one process's validation of the same state
    e0 = ranks[0]["e"]
    check(e0["sums"] == ranks[1]["e"]["sums"], "[parallel] (e) the ranks' states differ")
    run_cfg, run_spec = par_run_cfg(), Stage1Spec.from_config(par_run_cfg(), PAR_RUN_L, C)
    run_noise = 2 * sum(warmup_cosine_schedule(run_cfg.exp_params.lr, PAR_RUN_STEPS)(t)
                        for t in range(PAR_RUN_STEPS))
    run_worst = check_adam_elements(
        "[parallel] (e) two ranks against one process", one["final"], e0["final"],
        biases_cancelled_by_batchnorm(Stage1Model(run_spec)), run_noise)
    run_loss = max(abs(a_ - b_) / abs(b_) for a_, b_ in zip(e0["loss"], one["loss"]))
    check(len(e0["loss"]) == PAR_RUN_STEPS and run_loss <= 1e-4,
          f"[parallel] (e) two-rank losses {e0['loss']} against one process's {one['loss']}")
    check([st for st, _ in e0["val"]] == [st for st, _ in one["val"]] == [2, 4],
          f"[parallel] (e) validations at {[st for st, _ in e0['val']]}")
    fz = FrozenStage1.from_state_dict(run_spec, {k: v.clone() for k, v in e0["final"].items()},
                                      device)
    val = runner._make_eval(create_stage1_state(fz.model, fz.vq_l, fz.vq_h, par_sgd(run_cfg)),
                            par_run_data().X_test, PAR_RUN_B, torch.device(device))(PAR_RUN_STEPS)
    run_val = max(abs(e0["val"][-1][1][f"val/{k}"] - v) / abs(v) for k, v in val.items())
    check(run_val <= 1e-5, f"[parallel] (e) the ranks' validation off by {run_val} relative")
    # (f): the production recipe's ranks hold one state, finite
    f0 = ranks[0]["f"]
    check(f0["sums"] == ranks[1]["f"]["sums"], "[parallel] (f) the ranks' states differ")
    check(f0["finite"] and ranks[1]["f"]["finite"] and all(np.isfinite(f0["loss"])),
          f"[parallel] (f) non-finite state or losses {f0['loss']}")

    nb = PAR_RUN_TEST // PAR_RUN_B  # (e)'s validation batches
    # (g): the (1, 2) grid's steps against (a)'s reference (rank 0 held the
    # state), the shard arithmetic of memory, the tp=2 run against (e)'s one process
    for rk in ranks:
        g_ = rk["g"]
        for t in range(PAR_STEPS):
            for band in (0, 1):
                check(torch.equal(g_["indices"][t][band], ref_a["indices"][t][band]),
                      f"[parallel] (g) tp=2 step {t + 1}: band {band} indices differ")
        g_gap = max(abs(a_ - b_) / abs(b_) for a_, b_ in zip(g_["loss"], ref_a["loss"]))
        check(g_gap <= 1e-4, f"[parallel] (g) tp=2 losses {g_['loss']} vs {ref_a['loss']}")
        check(g_["fraction"] > 0.25 and g_["moments_sliced"],
              f"[parallel] (g) split {g_['fraction']}, moments sliced {g_['moments_sliced']}")
        for kind, n in (("sgd_bytes", 2), ("adam_bytes", 3)):
            want = n * g_["local_bytes"]
            check(device != "cuda" or abs(g_[kind] - want) <= PAR_TP_MEMORY * want,
                  f"[parallel] (g) {kind} {g_[kind]} against {n} x {g_['local_bytes']}")
    g0 = ranks[0]["g"]
    check(g0["sums"] == ranks[1]["g"]["sums"], "[parallel] (g) the ranks' states differ")
    check(g0["run"]["sums"] == ranks[1]["g"]["run"]["sums"],
          "[parallel] (g) the tp=2 run's ranks differ")
    tp_worst = check_adam_elements(
        "[parallel] (g) tp=2 run against one process", one["final"], g0["run"]["final"],
        biases_cancelled_by_batchnorm(Stage1Model(run_spec)), run_noise)
    tp_bit = all(torch.equal(v, g0["run"]["final"][k]) for k, v in one["final"].items())
    tp_loss = max(abs(a_ - b_) / abs(b_) for a_, b_ in zip(g0["run"]["loss"], one["loss"]))
    check(tp_loss <= 1e-4, f"[parallel] (g) tp=2 run losses {g0['run']['loss']} against "
                           f"{one['loss']}")
    tp_launches = sum(rk["launches"].pop("g") for rk in ranks)
    tp_rank = (2 * (PAR_STEPS + 1)  # the grid's SGD steps and its AdamW step
               + 2 * (PAR_RUN_STEPS + PAR_RUN_STEPS // 2)  # the run, straight then resumed
               + 2 * (PAR_RUN_STEPS // 2 + 1) * nb)  # 3 validations, every batch on each rank
    check(device != "cuda" or tp_launches == PAR_WORLD * tp_rank,
          f"[parallel] (g) VQ launches {tp_launches}, expected {PAR_WORLD * tp_rank}")

    # (h): the k-means draws, Lloyd counts and codebooks against one process
    check(ref_h["expired"] > 0, "[parallel] (h) no code expired in one process's run")
    h_worst = check_kmeans(torch, "[parallel] (h) two ranks against one process", ref_h,
                           ranks[0]["h"], spec.vq_l.eps)
    h_ = [rk["h"] for rk in ranks]
    for band in ("vq_l", "vq_h"):
        for f, v in h_[0]["codebooks"][band].items():
            check(torch.equal(v, h_[1]["codebooks"][band][f]),
                  f"[parallel] (h) the ranks' {band}.{f} differ")
    for (m0, b0), (m1, b1) in zip(h_[0]["kmeans"], h_[1]["kmeans"]):
        check(torch.equal(m0, m1) and torch.equal(b0, b1), "[parallel] (h) the ranks' k-means "
                                                            "differ")
    check(h_[0]["expired"] == h_[1]["expired"] == ref_h["expired"],
          f"[parallel] (h) expired codes {[h['expired'] for h in h_]} against "
          f"{ref_h['expired']}")
    h_cfg = par_km_cfg(cfg_dict)
    h_per = 2 * (h_cfg.vqvae.kmeans_iters + 1) + 2 * PAR_KM_STEPS  # a process's launches
    for rk in ranks:
        check(device != "cuda" or rk["launches"]["h"] == h_per,
              f"[parallel] (h) a rank's VQ launches {rk['launches']['h']}, not {h_per}")
    check(device != "cuda" or ref_h["launches"] == h_per,
          f"[parallel] (h) one process's VQ launches {ref_h['launches']}, not {h_per}")

    # (i): the sweeps over the ranks against one process's; each runner's
    # validation over the ranks against this process's of the same state
    x_scale = float(one_sweeps["xprime"].abs().max())
    x_gap = 0.0
    for rk in ranks:
        sw = rk["i"]["sweeps"]
        for band in (0, 1):
            check(np.array_equal(sw["tokens"][band], one_sweeps["tokens"][band]),
                  f"[parallel] (i) the two-rank token sweep's band {band} differs")
        x_gap = max(x_gap, float((sw["xprime"] - one_sweeps["xprime"]).abs().max()) / x_scale)
    check(x_gap <= 2e-4, f"[parallel] (i) the two-rank x' sweep off by {x_gap} of its scale")
    val_gap = {}
    for stage in (2, 3):
        got = ranks[0]["i"][stage]
        check(ranks[1]["i"][stage]["val"] is None, "[parallel] (i) rank 1 scored a validation")
        series, tokens = one_val[stage]
        check(len(got["val"]) == len(series) == stage - 1,
              f"[parallel] (i) stage {stage}: {len(got['val'])} validation sets")
        for x, want in zip(got["val"], series):
            check(x.shape == (PAR_I_VAL, C, length),
                  f"[parallel] (i) stage {stage} validation shape {x.shape}")
            gap = float(np.abs(x - want).max() / np.abs(want).max())
            val_gap[stage] = max(val_gap.get(stage, 0.0), gap)
        check(val_gap[stage] <= 2e-4,
              f"[parallel] (i) stage {stage} validation off by {val_gap[stage]} of its scale")
        for band in (0, 1):
            two = torch.cat([rk["i"][stage]["tokens"][band] for rk in ranks])
            check(torch.equal(two, tokens[band]),
                  f"[parallel] (i) stage {stage} validation: band {band} tokens differ")
    i_one = 2 + 2 * -(-PAR_I_SERIES // 32)  # the token sweep's one batch, the x' sweep's
    i_rank = 2 * i_one  # the sweeps, then the runners' own
    check(device != "cuda" or sweep_launches == i_one,
          f"[parallel] (i) one process's VQ launches {sweep_launches}, not {i_one}")
    for rk in ranks:
        check(device != "cuda" or rk["launches"]["i"] == i_rank,
              f"[parallel] (i) a rank's VQ launches {rk['launches']['i']}, not {i_rank}")

    launches = (parent_launches + run_launches + ref_h["launches"] + sweep_launches
                + sum(sum(rk["launches"].values()) for rk in ranks))
    run_rank = (2 * (PAR_RUN_STEPS + PAR_RUN_STEPS // 2)  # straight, then resumed at step 2
                + 2 * (PAR_RUN_STEPS // 2 + 1) * nb // PAR_WORLD)  # 2 + 1 validations
    for rk in ranks:
        check(device != "cuda" or (rk["launches"]["e"], rk["launches"]["f"])
              == (run_rank, 2 * PAR_PROD_STEPS),
              f"[parallel] a rank's (e) and (f) launches {rk['launches']}")
    expected = (2 * PAR_STEPS * 2 * (PAR_WORLD + 1)  # (a) and (b): each rank, the reference
                + 2 * 2  # (c): the step with no group and the NCCL step
                + PAR_WORLD * run_rank  # (e): the ranks
                + 2 * (2 * PAR_RUN_STEPS + 2 * (PAR_RUN_STEPS // 2) * nb)  # (e): one process, twice
                + PAR_WORLD * 2 * PAR_PROD_STEPS  # (f)
                + (PAR_WORLD + 1) * h_per  # (h): the ranks and one process
                + PAR_WORLD * i_rank + i_one)  # (i): the ranks, one process's sweeps
    # on the CPU (a rehearsal) the plain twin runs and counts nothing
    check(launches == expected or device != "cuda",
          f"[parallel] VQ launches {launches}, expected {expected}")
    c_, wa = ranks[0]["c"], ranks[0]["a_check"]
    hf = (f", the HF leaves within {wa['HF grad L2']:.3g} in L2 (bound "
          f"{4 * wa['HF L1 residual sign flips'] / ranks[0]['a']['hf_elements'] ** 0.5:.3g})"
          if wa["HF L1 residual sign flips"] else "")
    print(f"[parallel] {smi} | (a) {PAR_WORLD} gloo ranks on cuda:0, {PAR_B1 // PAR_WORLD} of "
          f"{PAR_B1} rows each, {PAR_STEPS} published-width stage-1 steps (SGD, native kernels, "
          f"deterministic algorithms) "
          f"against one process at {PAR_B1}: indices equal; cluster_size equal; embed_avg and "
          f"embed at most {wa['codebook bound share']:.3g} of their sum bounds; step-1 "
          f"gradients within {wa['grad']:.3g} of each leaf's scale{hf} (the HF L1 residual "
          f"changed sign at {wa['HF L1 residual sign flips']} of "
          f"{ranks[0]['a']['hf_elements']} elements; cancelled biases "
          f"{wa['cancelled grad']:.3g} of their weight's); leaves after the steps within "
          f"{wa['leaf']:.3g}; losses within {loss_gap:.3g} relative; the ranks' {n_bn} "
          f"BatchNorm statistics and codebooks equal, parameter sums equal", flush=True)
    print(f"[parallel] {smi} | (b) {PAR_STEPS} on-the-fly stage-2 steps at the published prior "
          f"widths, {PAR_B2 // PAR_WORLD} + {PAR_B2 // PAR_WORLD} of {PAR_B2}, masks handed in: "
          f"tokens equal, prior leaves within {prior_err:.3g} of one process's; (c) one-rank "
          f"NCCL group: one step bit-equal to the step with no group (indices, step-1 "
          f"gradients, {c_['leaves']} leaves and codebooks; loss {c_['loss'][1]:.6f}; "
          f"deterministic cuDNN and algorithms); (d) serve "
          f"--data_parallel over {n_dev} device(s): the seeded {B}-batch bit-equal to the "
          f"one-device service (deterministic cuDNN)", flush=True)
    print(f"[parallel] {smi} | (e) train_stage1 at the small config, {PAR_RUN_STEPS} steps of "
          f"{PAR_RUN_B // PAR_WORLD} + {PAR_RUN_B // PAR_WORLD} on the host feed: resumed from "
          f"the step-2 snapshot bit-equal to the straight run on both ranks; against one "
          f"process on the device gather: leaves within {run_worst['leaf']:.3g} (Adam's rule, "
          f"{run_worst['beyond share']:.3g} of the elements beyond 2e-4), codebooks "
          f"{run_worst['codebook']:.3g} of 1 + |value|, losses {run_loss:.3g} relative, the "
          f"ranks' validation {run_val:.3g} relative of one process's of the same state; one "
          f"process on the host feed bit-equal to the device gather (deterministic cuDNN and "
          f"algorithms); (f) the production recipe (cuDNN, AdamW, bfloat16 moments and "
          f"compute, fast BatchNorm), {PAR_PROD_STEPS} published-width steps of "
          f"{PAR_B1 // PAR_WORLD} + {PAR_B1 // PAR_WORLD}: one state on both ranks, finite, "
          f"losses {[round(v, 4) for v in f0['loss']]}", flush=True)
    print(f"[parallel] {smi} | two-rank stage-1 step, production recipe "
          f"{f0['ms'] or 0.0:.1f} ms; (a)'s (native kernels, SGD, deterministic algorithms) "
          f"{ranks[0]['a']['ms'] or 0.0:.1f} ms (CUDA events, steps 2-{PAR_STEPS} on rank 0, "
          f"{ranks[0]['a_seconds']:.1f} s for (a)'s {PAR_STEPS}; a gloo all-reduce of ~726 MB of "
          f"float32 gradients through the host a step, two ranks sharing one card: not a "
          f"scaling rate); peak memory by rank {[round(rk['peak_gib'], 2) for rk in ranks]} "
          f"GiB in (a)-(b), {[round(rk['f']['peak_gib'], 2) for rk in ranks]} GiB in (f); VQ "
          f"launches {launches} (ranks {[rk['launches'] for rk in ranks]}, this process "
          f"{parent_launches} + {run_launches}); {time.perf_counter() - t_start:.1f} s",
          flush=True)
    wg = ranks[0]["g_check"]
    gb = [(rk["g"]["sgd_bytes"] / 1e9, rk["g"]["adam_bytes"] / 1e9, rk["g"]["peak_bytes"] / 1e9)
          for rk in ranks]
    print(f"[parallel] {smi} | (g) tensor parallelism, the {PAR_WORLD} ranks as a (1, "
          f"{PAR_WORLD}) grid: {g0['split_leaves']} leaves, {100 * g0['fraction']:.2f}% of the "
          f"parameter bytes, split; {PAR_STEPS} published-width stage-1 steps on all {PAR_B1} "
          f"rows (SGD, native kernels, deterministic algorithms) against (a)'s one process: "
          f"indices equal; bit-equal {wg['bit-equal']}; step-1 gradients within {wg['grad']:.3g} "
          f"of each leaf's scale (HF sign flips {wg['HF L1 residual sign flips']}); leaves "
          f"within {wg['leaf']:.3g}; codebooks at most {wg['codebook bound share']:.3g} of their "
          f"bounds; memory_allocated between steps by rank (GB: SGD parameters + gradients, "
          f"AdamW parameters + moments, peak) {[tuple(round(v, 3) for v in b) for b in gb]} "
          f"against 2 x and 3 x {g0['local_bytes'] / 1e9:.3f} GB of local parameters (one "
          f"process: {g0['whole_bytes'] / 1e9:.3f} GB of parameters, "
          f"{3 * g0['whole_bytes'] / 1e9:.3f} GB with AdamW's moments); rank 0's step "
          f"{g0['ms'] or 0.0:.1f} ms (CUDA events, steps 2-{PAR_STEPS}; the weights gathered "
          f"through the host by gloo, not a scaling rate), {ranks[0]['g_seconds']:.1f} s for "
          f"(g); train_stage1(tp={PAR_WORLD}) at (e)'s config (floor {PAR_TP_FLOOR}): resumed "
          f"bit-equal to the straight run; against (e)'s one process: bit-equal {tp_bit}, "
          f"leaves within {tp_worst['leaf']:.3g}, losses {tp_loss:.3g} relative; VQ launches "
          f"{tp_launches}", flush=True)
    hw, ho = ranks[0]["h"]["kmeans_ms"], ref_h["kmeans_ms"]
    print(f"[parallel] {smi} | (h) train_stage1 with k-means init ({h_cfg.vqvae.kmeans_iters} "
          f"Lloyd iterations) and dead-code expiry (threshold {PAR_KM_THRESHOLD}) on both "
          f"codebooks at the published width, {PAR_KM_STEPS} steps of {PAR_B1 // PAR_WORLD} + "
          f"{PAR_B1 // PAR_WORLD} (SGD, native kernels, deterministic algorithms) against one "
          f"process at {PAR_B1}: the same {len(ref_h['draws'])} row draws (global indices; rows "
          f"at most {h_worst['drawn rows']:.3g} of 1e-4 + 1e-4 relative), the draw generator in "
          f"one state, k-means bins equal and means at most {h_worst['kmeans means']:.3g} of "
          f"their sum bound, cluster_size equal, embed_avg and live embed at most "
          f"{max(h_worst['embed_avg'], h_worst['embed']):.3g} of theirs, {ref_h['expired']} "
          f"code expiries; the ranks' codebooks equal; k-means init ms (LF, HF; CUDA events) "
          f"rank 0 {[round(v, 2) for v in hw]} against one process {[round(v, 2) for v in ho]}; "
          f"VQ launches by rank {[rk['launches']['h'] for rk in ranks]} (one process "
          f"{ref_h['launches']}), {ranks[0]['h_seconds']:.1f} s for (h)", flush=True)
    tw, to = ranks[0]["i"]["sweeps"]["seconds"], one_sweeps["seconds"]
    print(f"[parallel] {smi} | (i) the ranks on one host: the token sweep of {PAR_I_SERIES} "
          f"series (batches of 64) and the x' sweep (batches of 32) over the two ranks against "
          f"one process: tokens equal, x' within {x_gap:.3g} of its scale; seconds (token, x') "
          f"two ranks {tuple(round(v, 3) for v in tw)} against one process "
          f"{tuple(round(v, 3) for v in to)}; train_stage2 and train_stage3 (tau 0) "
          f"{PAR_I_STEPS} steps of {PAR_B2 // PAR_WORLD} + {PAR_B2 // PAR_WORLD} at the "
          f"published prior and enhancer widths, precomputed over the ranks; one validation "
          f"of each, {PAR_I_VAL} series at {PAR_I_VAL // PAR_WORLD} rows a rank, against one "
          f"process's of the same state: series within {val_gap[2]:.3g} (stage 2) and "
          f"{val_gap[3]:.3g} (stage 3, raw and enhanced) of their scale, tokens equal; VQ "
          f"launches by rank {[rk['launches']['i'] for rk in ranks]} (one process "
          f"{sweep_launches}), {ranks[0]['i_seconds']:.1f} s for (i)", flush=True)
    return launches, tp_launches


def analysis_phase(torch, work, figures, device="cuda"):
    """The analysis CLI's ``run(args, figures=...)`` in the process on a
    dataset of ANALYSIS_SERIES synthetic series at ANALYSIS_L (test split
    above 512), ANALYSIS_GEN more as the generated set, and the flyability
    CLI's JSON: its seconds by step, ROCKET features, FID and the statistics
    on the card, PCA and t-SNE of 2 x 512 feature rows on the card with the
    t-SNE's KL and trustworthiness; then the same PCA and t-SNE on the CPU:
    the coordinates within 1e-4 of their scale, the KL within 5%."""
    from tvqvae_tpu_torch.data.dataset import make_synthetic_trajectories, save_npz
    from tvqvae_tpu_torch.scripts import analyze
    from tvqvae_tpu_torch.utils import plots

    root = os.path.join(work.root, "analysis")
    os.makedirs(root, exist_ok=True)
    save_npz(os.path.join(root, "flights.npz"),
             *make_synthetic_trajectories(n=ANALYSIS_SERIES, channels=C, length=ANALYSIS_L,
                                          n_classes=N_CLASSES, seed=41))
    Xg, _ = make_synthetic_trajectories(n=ANALYSIS_GEN, channels=C, length=ANALYSIS_L,
                                        n_classes=N_CLASSES, seed=42)
    np.savez_compressed(os.path.join(root, "synthetic.npz"), X=Xg, y=np.zeros(len(Xg), np.int64))
    save_dir = os.path.join(root, "out")
    argv = ["--dataset_file", os.path.join(root, "flights.npz"),
            "--synthetic_file", os.path.join(root, "synthetic.npz"),
            "--distances_json", os.path.join(work.root, "flyability", "synthetic_distances.json"),
            "--save_dir", save_dir, "--rocket_num_kernels", str(ANALYSIS_KERNELS),
            "--device", device]
    inputs = {}
    saved = {name: getattr(plots, name) for name in ("pca_data", "tsne_data")}

    def capture(name):
        def wrapped(*args, **kwargs):
            inputs[name] = (args, kwargs)
            return saved[name](*args, **kwargs)
        return wrapped

    for name in saved:
        setattr(plots, name, capture(name))
    try:
        t0 = time.perf_counter()
        out = analyze.run(analyze.build_argparser().parse_args(argv), figures=figures)
        run_s = time.perf_counter() - t0
    finally:
        for name, fn in saved.items():
            setattr(plots, name, fn)
    res = out["results"]
    check(set(res) == {"FID", "MDD", "ACD", "SD", "KD"} and bool(np.isfinite(list(res.values())).all()),
          f"analyze results {res}")
    names = {"timeseries_ci.png", "distribution_plots.png", "visual_inspection.png",
             "trajectories_generated.png", "trajectories_real.png", "clustering_real.png",
             "altitude_map_generated.png", "altitude_generated.png", "pca.png", "tsne.png",
             *(f"{kind}_{tag}.png" for kind in ("correlation_heatmap", "percentile_plots")
               for tag in ("euclidean", "spherical"))}
    check(set(out["figures"]) == names, f"analyze figures {sorted(out['figures'])}")
    pngs = {f for f in os.listdir(save_dir) if f.endswith(".png")}
    check(pngs == (names if figures else set()), f"analyze wrote {sorted(pngs)}")
    pca, tsne = out["figures"]["pca.png"], out["figures"]["tsne.png"]
    n_points = sum(len(e) for _, e in tsne["sets"])
    n_test = ANALYSIS_SERIES - int(0.9 * ANALYSIS_SERIES)  # get_data's split
    check(n_points == min(512, n_test) + min(512, ANALYSIS_GEN) and all(np.isfinite(e).all() for _, e in tsne["sets"] + pca["sets"]),
          f"t-SNE of {n_points} points, or non-finite embeddings")

    args, kwargs = inputs["pca_data"]
    pca_cpu = plots.pca_data(*args, **{**kwargs, "device": "cpu"})
    scale = max(float(np.abs(e).max()) for _, e in pca_cpu["sets"])
    pca_err = max(float(np.abs(a - b).max()) for (_, a), (_, b) in
                  zip(pca["sets"], pca_cpu["sets"])) / scale
    check(pca_err <= 1e-4, f"PCA card vs CPU off by {pca_err} of scale")
    args, kwargs = inputs["tsne_data"]
    t0 = time.perf_counter()
    tsne_cpu = plots.tsne_data(*args, **{**kwargs, "device": "cpu"})
    cpu_tsne_s = time.perf_counter() - t0
    kl_gap = abs(tsne["kl_divergence"] - tsne_cpu["kl_divergence"]) / tsne_cpu["kl_divergence"]
    check(kl_gap <= 0.05, f"t-SNE KL card {tsne['kl_divergence']} vs CPU "
          f"{tsne_cpu['kl_divergence']}")
    secs = out["seconds"]
    print(f"[analysis] analyze.run (figures {'drawn' if figures else 'skipped: no matplotlib'}) on "
          f"{ANALYSIS_SERIES} series of L={ANALYSIS_L} and {ANALYSIS_GEN} generated, "
          f"{ANALYSIS_KERNELS} ROCKET kernels, in {run_s:.2f} s; seconds by step: "
          + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()), flush=True)
    print(f"[analysis] results " + ", ".join(f"{k} {v:.4g}" for k, v in res.items())
          + f"; PCA of {sum(len(e) for _, e in pca['sets'])} rows {1e3 * secs['pca']:.1f} ms, "
          f"within {pca_err:.3g} of scale of the CPU's; t-SNE of {n_points} points "
          f"{1e3 * secs['tsne']:.1f} ms ({tsne['n_iter'] + 1} iterations; the CPU "
          f"{1e3 * cpu_tsne_s:.1f} ms): KL {tsne['kl_divergence']:.4f} (CPU "
          f"{tsne_cpu['kl_divergence']:.4f}, {kl_gap:.2%} apart), trustworthiness "
          f"{tsne['trustworthiness']:.4f} (CPU {tsne_cpu['trustworthiness']:.4f})", flush=True)
    return secs


# ---------------------------------------------------------------------------
# [bundle]: the train CLI's default --bundle_steps 10 (train/multistep.py)

BUNDLE, BUNDLE_STEPS, BUNDLE_SNAPSHOT = 10, 23, 20  # two bundles and a 3-step tail; the resume
BUNDLE_WARM, BUNDLE_TIMED = 3, 2  # eager steps before the timed ones; bundles timed after capture
BUNDLE_KINDS = {"a": "stage 1, float32", "b": "stage 1, production recipe",
                "c": "stage 2 on precomputed tokens", "d": "stage 3 on a precomputed x'",
                "e": "stage 1, small config, host feed, k-means init and dead-code expiry"}
BUNDLE_TIMED_KINDS = "abcd"  # (e) guards the latch and the dead-code draws, off when published
BUNDLE_KMEANS = {**SMALL_CFG, "VQ-VAE": {**SMALL_CFG["VQ-VAE"], "kmeans_init": True,
                                        "threshold_ema_dead_code": 2}}


def bundle_run(torch, kind, bundle, path, data, frozen, cfg_dict=None, device="cuda"):
    """Case ``kind`` of BUNDLE_KINDS through its runner for BUNDLE_STEPS
    steps in bundles of ``bundle``, validating and snapshotting to
    ``path + ".train"`` at BUNDLE_SNAPSHOT, resuming from that snapshot
    where ``path`` has one and no checkpoint; ``cfg_dict`` (default: none,
    the published config; case (e) takes ``BUNDLE_KMEANS``) in the reference
    schema. -> (state, recorder)."""
    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.train import runner

    cfg = Config.from_dict({**(BUNDLE_KMEANS if kind == "e" else cfg_dict or {}),
                            "trainer_params": {"val_check_interval": dict.fromkeys(
                                ("stage1", "stage2", "stage3"), BUNDLE_SNAPSHOT)}})
    rec = StepRecorder(torch)
    kw = dict(max_steps=BUNDLE_STEPS, device=device, logger=rec, log_interval=1,
              bundle_steps=bundle, save_path=path)
    if kind in "abe":
        state = runner.train_stage1(cfg, data, data_on_device=kind != "e", **kw,
                                    **(PRODUCTION if kind == "b" else {}))
    elif kind == "c":
        state = runner.train_stage2(cfg, data, frozen, **kw)
    else:
        state = runner.train_stage3(cfg, data, frozen, **kw)
    return state, rec


def state_tensors(torch, state) -> dict:
    """Every tensor a train state holds: its modules' parameters and
    buffers (the BatchNorm statistics), its codebooks, AdamW's moments and
    step count."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.nn.Module):
            out.update({f"{f.name}.{k}": t for k, t in v.state_dict().items()})
        elif dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{c.name}": getattr(v, c.name) for c in dataclasses.fields(v)})
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"adamw.{i}.{k}": t for k, t in st.items()})
    return out


def differences(torch, a, b, at=""):
    """Where two nested payloads (dicts, lists, tensors, numbers, strings)
    differ, bit for bit."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return [f"{at} (keys)"]
        return [d for k in a for d in differences(torch, a[k], b[k], f"{at}/{k}")]
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            return [at]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in differences(torch, x, y, f"{at}/{i}")]
    if torch.is_tensor(a):
        same = (torch.is_tensor(b) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b))
        return [] if same else [at]
    return [] if a == b else [at]


def check_bundle_means(torch, label, eager, bundled, start=0):
    """The bundled run from ``start`` logged, at each bundle's end, the
    eager run's step metrics summed in step order from zeros and divided by
    the bundle's length (the multistep's arithmetic), and at each tail step
    that step's metrics: all bit-equal. -> the steps it logged."""
    tail = (BUNDLE_STEPS - start) % BUNDLE
    ends = list(range(start + BUNDLE, BUNDLE_STEPS - tail + 1, BUNDLE))
    want = ends + list(range(BUNDLE_STEPS - tail + 1, BUNDLE_STEPS + 1))
    check(sorted(bundled.train) == want,
          f"[bundle] {label}: logged at steps {sorted(bundled.train)}, expected {want}")
    prev = start
    for s in want:
        n = s - prev
        for k, got in bundled.train[s].items():
            ref = torch.zeros_like(eager.train[s][k])
            for t in range(prev + 1, s + 1):
                ref += eager.train[t][k]
            ref = ref / n if n > 1 else eager.train[s][k]
            check(torch.equal(got, ref),
                  f"[bundle] {label}: {k} at step {s} is {float(got)!r}, eager {float(ref)!r}")
        prev = s
    return want


def clone_stage1_state(torch, state):
    """A copy of a stage-1 train state: the model, codebooks, AdamW (its
    moments and step count) and schedule, none shared."""
    import copy

    from tvqvae_tpu_torch.models.vq import CodebookState
    from tvqvae_tpu_torch.train.optim import adamw
    from tvqvae_tpu_torch.train.stage1 import Stage1TrainState

    model = copy.deepcopy(state.model)
    opt = state.optimizer
    optimizer, scheduler = adamw(model.parameters(), opt.schedule,
                                 weight_decay=opt.param_groups[0]["weight_decay"],
                                 mu_dtype=opt.mu_dtype, nu_dtype=opt.nu_dtype)
    optimizer.load_state_dict(opt.state_dict())
    scheduler.load_state_dict(state.scheduler.state_dict())
    codebooks = [CodebookState(*(t.clone() for t in (c.embed, c.embed_avg, c.cluster_size,
                                                     c.initted))) for c in (state.vq_l, state.vq_h)]
    return Stage1TrainState(model, *codebooks, optimizer, scheduler, state.step)


def captured_twin_check(torch, vq_kernel, state, x):
    """One published-width stage-1 step captured as a CUDA graph and
    replayed, the VQ kernel inside it, against the same step run eagerly
    with the kernel's plain twin in its place, from a copy of the same state
    on the same batch and generator state: ``published_train_twin_check``'s
    bounds (indices equal, loss within 1e-5 relative, codebooks within
    1e-4 + 1e-4 relative), and 2 launches counted by the replay."""
    from tvqvae_tpu_torch.models import vq as vq_module
    from tvqvae_tpu_torch.train.multistep import WARMUP, Multistep
    from tvqvae_tpu_torch.train.stage1 import make_stage1_train_step

    gen = torch.Generator(device="cuda").manual_seed(13)
    step = make_stage1_train_step(in_place=True)
    ms = Multistep(lambda: step(state, x, gen)[1], state, gen, state.step + WARMUP + 1)
    ms.bundle(WARMUP)  # the eager warm-up steps: nothing captured yet
    check(ms.graph is None, "[bundle] twin: captured during the warm-up")
    twin, twin_gen = clone_stage1_state(torch, state), gen.get_state()
    seen = []
    hook = state.model.register_forward_hook(
        lambda m, i, o: seen.append((o.vq_l.indices, o.vq_h.indices)))
    launches = vq_kernel.launch_count
    try:
        loss = float(ms.bundle(1)["loss"])  # captured, then replayed once
    finally:
        hook.remove()
    check(ms.replays == 1 and ms.vq_launches == 2 and vq_kernel.launch_count - launches == 2,
          f"[bundle] twin: {ms.replays} replays, {ms.vq_launches} launches in the graph, "
          f"{vq_kernel.launch_count - launches} counted")
    twin_seen = []
    twin.model.register_forward_hook(
        lambda m, i, o: twin_seen.append((o.vq_l.indices, o.vq_h.indices)))
    vq_module.nearest_codes_stats = vq_kernel.nearest_codes_stats_plain
    try:
        g = torch.Generator(device="cuda")
        g.set_state(twin_gen)
        p_loss = float(make_stage1_train_step()(twin, x, g)[1]["loss"])
    finally:
        vq_module.nearest_codes_stats = vq_kernel.nearest_codes_stats
    for band, a, b in zip(("lf", "hf"), seen[0], twin_seen[0]):
        check(torch.equal(a, b), f"[bundle] twin: captured {band} indices differ from plain")
    check(abs(loss - p_loss) <= 1e-5 * abs(p_loss), f"[bundle] twin: loss {loss} vs plain {p_loss}")
    errs = {}
    for band in ("vq_l", "vq_h"):
        for f in ("embed", "embed_avg", "cluster_size"):
            a, b = getattr(getattr(state, band), f), getattr(getattr(twin, band), f)
            errs[f"{band}.{f}"] = float((a - b).abs().max())
            check(bool(((a - b).abs() <= 1e-4 + 1e-4 * b.abs()).all()),
                  f"[bundle] twin: {band}.{f} off by {errs[f'{band}.{f}']}")
    print(f"[bundle] published-width stage-1 step captured (VQ kernel inside the graph, 2 "
          f"launches counted by its replay) vs the eager step with the plain VQ twin: indices "
          f"equal ({seen[0][0].numel()} LF, {seen[0][1].numel()} HF tokens), loss {loss:.6f} vs "
          f"{p_loss:.6f}, codebook max abs err "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()), flush=True)


def bundle_cli_start(work, device="cuda"):
    """The train CLI with its default ``--bundle_steps`` (10) in a
    subprocess: ``--stage all`` for BUNDLE_STEPS steps on the small config
    over 64 synthetic series of L=127. -> (process, start time, its
    directory)."""
    from tvqvae_tpu_torch.data import make_synthetic_trajectories, save_npz

    root = os.path.join(work.root, "bundle_cli")
    os.makedirs(root, exist_ok=True)
    save_npz(os.path.join(root, "small.npz"),
             *make_synthetic_trajectories(n=64, channels=C, length=127, seed=5))
    with open(os.path.join(root, "small.json"), "w") as f:
        json.dump(SMALL_CFG, f)
    proc = cli_subprocess(work, "train", [
        "--dataset_file", os.path.join(root, "small.npz"), "--config",
        os.path.join(root, "small.json"), "--model_save_dir", os.path.join(root, "models"),
        "--run_dir", os.path.join(root, "runs"), "--stage", "all", "--max_steps",
        str(BUNDLE_STEPS), "--no_val_metrics", "--device", device])
    return proc, time.perf_counter(), root


def check_bundle_cli(proc, t0, root, capture=True):
    """The train CLI exited 0, captured each stage's step once, and wrote
    every stage with its BUNDLE_STEPS steps."""
    out, _ = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"the train CLI exited {proc.returncode}:\n{out[-3000:]}")
    captured = re.findall(r"\[(stage\d)\] step captured as one CUDA graph in ([0-9.]+)s", out)
    check([s for s, _ in captured] == (["stage1", "stage2", "stage3"] if capture else []),
          f"the train CLI captured {captured}:\n{out[-3000:]}")
    for s in ("1", "2", "3"):
        with open(os.path.join(root, "models", "small", f"stage{s}.meta.json")) as f:
            done = json.load(f)["completed_step"]
        check(done == BUNDLE_STEPS, f"the train CLI's stage {s} completed {done} steps")
    print(f"[bundle] the train CLI (a subprocess, its default --bundle_steps 10, --stage all, "
          f"{BUNDLE_STEPS} steps a stage on the small config): each stage's step captured once "
          f"(" + ", ".join(f"{s} {t} s" for s, t in captured) + f"), every stage written with "
          f"{BUNDLE_STEPS} steps; {time.perf_counter() - t0:.1f} s from its start", flush=True)


def bundle_inputs(torch, kind, state, data, frozen, horizon):
    """-> (step, generator, feed) of case ``kind`` as its runner builds
    them, from ``state`` on, for steps up to ``horizon``."""
    from tvqvae_tpu_torch.train import runner
    from tvqvae_tpu_torch.train.stage1 import make_stage1_train_step
    from tvqvae_tpu_torch.train.stage2 import precompute_token_dataset, stage2_train_step_tokens
    from tvqvae_tpu_torch.train.stage3 import make_stage3_train_step_pre, precompute_xprime_dataset

    gen = torch.Generator(device="cuda").manual_seed(21)
    X = torch.from_numpy(data.X_train).cuda()
    if kind in "ab":
        fn = make_stage1_train_step(in_place=True)
        feed = runner._Feed((X,), B, horizon, 0, "cuda", state.step)
        return (lambda: fn(state, feed.next()[0], gen)[1]), gen, feed
    if kind == "c":
        tok_l, tok_h = precompute_token_dataset(frozen, X, batch_size=SWEEP_BATCH)
        feed = runner._Feed((tok_l, tok_h, data.y_train), 16, horizon, 0, "cuda", state.step)
        return (lambda: stage2_train_step_tokens(state, *feed.next(), gen)[1]), gen, feed
    fn = make_stage3_train_step_pre()
    xprime = precompute_xprime_dataset(frozen, X, batch_size=XPRIME_BATCH, keep_on_device=True)
    feed = runner._Feed((X, xprime), 16, horizon, 0, "cuda", state.step)
    return (lambda: fn(state, *feed.next(), gen)[1]), gen, feed


def bundle_timing(torch, vq_kernel, kind, state, data, frozen, smi):
    """Case ``kind``'s step from ``state`` on, eager and in bundles (cuDNN
    and PyTorch at their defaults): steady ms a step by CUDA events over
    BUNDLE_TIMED bundles' worth of steps after BUNDLE_WARM eager ones and
    after the capturing bundle, the capture's seconds, the peak memory above
    the state with the graph's pool beside the eager steps', and the device
    busy ms and idle share of one bundle beside one eager step's
    (torch.profiler). -> the VQ launches a replay counts."""
    from tvqvae_tpu_torch.train.multistep import Multistep

    n = BUNDLE * BUNDLE_TIMED
    horizon = state.step + BUNDLE_WARM + n + 1 + (BUNDLE_TIMED + 2) * BUNDLE
    step, gen, feed = bundle_inputs(torch, kind, state, data, frozen, horizon)

    def events_ms(fn):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    eager = Multistep(step, state, gen, horizon, feed.prepare)
    for _ in range(BUNDLE_WARM):
        eager.single()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eager_ms = events_ms(lambda: [eager.single() for _ in range(n)]) / n
    eager_gb = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    bundled = Multistep(step, state, gen, horizon, feed.prepare)
    torch.cuda.reset_peak_memory_stats()
    first_ms = events_ms(lambda: bundled.bundle(BUNDLE))
    bundled_ms = events_ms(lambda: [bundled.bundle(BUNDLE) for _ in range(BUNDLE_TIMED)]) / n
    bundled_gb = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    # the graph's private pool: the allocator's segments under its pool id
    pool = tuple(bundled.graph.pool())
    segments = [sg for sg in torch.cuda.memory_snapshot() if "segment_pool_id" in sg]
    pool_bytes = sum(sg["total_size"] for sg in segments if tuple(sg["segment_pool_id"]) == pool)
    pool_gb = f"{pool_bytes / 2 ** 30:.3f} GiB" if segments else "not measured"
    launches = vq_kernel.launch_count
    busy_b = print_profile(f"[bundle] ({kind}) one bundle of {BUNDLE}",
                           lambda: bundled.bundle(BUNDLE), BUNDLE * bundled_ms, n_convs=0)
    check(vq_kernel.launch_count - launches == BUNDLE * bundled.vq_launches,
          f"[bundle] ({kind}): {vq_kernel.launch_count - launches} VQ launches counted in a "
          f"bundle of {BUNDLE} replays of {bundled.vq_launches}")
    busy_e = print_profile(f"[bundle] ({kind}) one eager step", eager.single, eager_ms,
                           n_convs=0)

    def idle(busy, wall):
        return f"{max(0.0, 1 - busy / wall):.3f}" if busy else "not measured"

    print(f"[bundle] ({kind}) {BUNDLE_KINDS[kind]}: steady ms a step eager {eager_ms:.3f}, "
          f"bundled {bundled_ms:.3f} ({eager_ms / bundled_ms:.3f}x; CUDA events over {n} steps); "
          f"capture {bundled.capture_s:.3f} s (its bundle {first_ms / 1e3:.3f} s); device busy "
          f"a step eager {busy_e:.3f} ms (idle share {idle(busy_e, eager_ms)}), bundled "
          f"{busy_b / BUNDLE:.3f} ms (idle share {idle(busy_b, BUNDLE * bundled_ms)}); peak "
          f"memory above the state eager {eager_gb:.3f} GiB, bundled {bundled_gb:.3f} GiB, the "
          f"graph's pool {pool_gb}; VQ launches a replay "
          f"{bundled.vq_launches} | {smi}", flush=True)
    return bundled.vq_launches


def bundle_phase(torch, vq_kernel, work, data, frozen, smi, cfg_dict=None, device="cuda"):
    """[bundle]: the counters set to 0, each case of BUNDLE_KINDS (stage 1
    at the published width in float32 and in the production recipe, stage 2
    on precomputed tokens at the published prior widths, stage 3 on a
    precomputed x' at the published enhancer widths, dropout 0.5; and stage
    1 at a small config on the host feed with k-means init and dead-code
    expiry) through
    its runner from one seeded state on the same data, once in bundles of
    BUNDLE and once step by step, BUNDLE_STEPS steps (two bundles and a
    3-step tail), under deterministic cuDNN and PyTorch's deterministic
    algorithms: the final parameters, BatchNorm statistics, codebooks and
    AdamW state bit-equal, the step-BUNDLE_SNAPSHOT snapshots (their
    generator states among them) bit-equal, the bundle means and tail steps
    logged bit-equal to the eager steps' (``check_bundle_means``), the
    validations equal, the VQ launches 2 a stage-1 step and a validation
    batch (the sweeps' in stages 2-3); case (a) resumed in bundles from the
    bundled run's snapshot (fewer steps left than a bundle) bit-equal to the
    straight run; ``captured_twin_check``; the train CLI at its default in a
    subprocess (``bundle_cli_start``); then ``bundle_timing`` of (a)-(d).
    ``cfg_dict`` replaces the published config (a rehearsal at a small one);
    on the CPU (a rehearsal) nothing is captured, and the twin check and the
    timing are left out. -> the VQ launches."""
    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.data import get_data
    from tvqvae_tpu_torch.utils.checkpoint import load_train_state

    cli = bundle_cli_start(work, device)
    vq_kernel.launch_count = 0
    root = os.path.join(work.root, "bundle")
    # (e) trains on the CLI's small set (L=127)
    small = get_data(os.path.join(cli[2], "small.npz"), Config().dataset.features)

    def n_val(d):
        return -(-len(d.X_test) // min(B, len(d.X_test)))

    N = len(data.X_train)
    expect = {"a": 2 * BUNDLE_STEPS + 2 * n_val(data) * 2, "c": 2 * -(-N // SWEEP_BATCH),
              "d": 2 * -(-N // XPRIME_BATCH)}
    expect["b"] = expect["a"]
    # the k-means init's assignments at the first step: kmeans_iters + 1 a codebook
    expect["e"] = (2 * BUNDLE_STEPS + 2 * n_val(small) * 2
                   + 2 * (Config.from_dict(BUNDLE_KMEANS).vqvae.kmeans_iters + 1))
    final = {}
    try:
        with deterministic_cudnn(torch), deterministic_algorithms(torch):
            for kind in BUNDLE_KINDS:
                runs, t0 = {}, time.perf_counter()
                for bundle in (1, BUNDLE):
                    launches = vq_kernel.launch_count
                    path = os.path.join(root, f"{kind}{bundle}", "stage")
                    state, rec = bundle_run(torch, kind, bundle, path,
                                            small if kind == "e" else data, frozen, cfg_dict,
                                            device)
                    got = vq_kernel.launch_count - launches
                    check(got == expect[kind], f"[bundle] ({kind}) bundle {bundle}: {got} VQ "
                                               f"launches, expected {expect[kind]}")
                    runs[bundle] = (state, rec, path)
                (s1, r1, p1), (sb, rb, pb) = runs[1], runs[BUNDLE]
                bad = differences(torch, state_tensors(torch, s1), state_tensors(torch, sb))
                check(not bad and s1.step == sb.step == BUNDLE_STEPS,
                      f"[bundle] ({kind}): bundled and eager states differ at {bad[:8]}")
                snaps = [load_train_state(p + ".train") for p in (p1, pb)]
                bad = differences(torch, *snaps)
                check(not bad and snaps[0]["step"] == BUNDLE_SNAPSHOT,
                      f"[bundle] ({kind}): step-{BUNDLE_SNAPSHOT} snapshots differ at {bad[:8]}")
                logged = check_bundle_means(torch, f"({kind})", r1, rb)
                check(not differences(torch, r1.val, rb.val),
                      f"[bundle] ({kind}): validations {rb.val} vs {r1.val}")
                resumed = ""
                if kind == "a":
                    for suffix in ("", ".meta.json"):
                        os.remove(pb + suffix)  # the snapshot stays
                    launches = vq_kernel.launch_count
                    sr, rr = bundle_run(torch, kind, BUNDLE, pb, data, frozen, cfg_dict, device)
                    bad = differences(torch, state_tensors(torch, s1), state_tensors(torch, sr))
                    check(not bad, f"[bundle] (a) resumed: differs from the eager run at {bad[:8]}")
                    check_bundle_means(torch, "(a) resumed", r1, rr, BUNDLE_SNAPSHOT)
                    check(vq_kernel.launch_count - launches
                          == 2 * (BUNDLE_STEPS - BUNDLE_SNAPSHOT) + 2 * n_val(data),
                          "[bundle] (a) resumed: VQ launches")
                    resumed = (f"; resumed in bundles from the step-{BUNDLE_SNAPSHOT} snapshot "
                               f"({BUNDLE_STEPS - BUNDLE_SNAPSHOT} steps left, all tail): "
                               f"bit-equal")
                    if device == "cuda":
                        captured_twin_check(torch, vq_kernel, sr,
                                            torch.from_numpy(data.X_train[B:2 * B]).cuda())
                    del sr
                print(f"[bundle] ({kind}) {BUNDLE_KINDS[kind]}: {BUNDLE_STEPS} steps in bundles "
                      f"of {BUNDLE} bit-equal to step by step (deterministic cuDNN and "
                      f"algorithms): {len(state_tensors(torch, sb))} state tensors, the "
                      f"step-{BUNDLE_SNAPSHOT} snapshots with their generator states, metrics "
                      f"logged at steps {logged} (bundle means, then the tail), "
                      f"{len(rb.val)} validations; VQ launches {expect[kind]} a run{resumed}; "
                      f"{time.perf_counter() - t0:.1f} s | {smi}", flush=True)
                if kind in BUNDLE_TIMED_KINDS:
                    final[kind] = sb
                del runs, s1, sb
        check_bundle_cli(*cli, capture=device == "cuda")
    finally:
        if cli[0].poll() is None:
            cli[0].kill()
            cli[0].wait()
    for kind in BUNDLE_TIMED_KINDS if device == "cuda" else ():
        per_replay = bundle_timing(torch, vq_kernel, kind, final.pop(kind), data, frozen, smi)
        check(per_replay == (2 if kind in "ab" else 0),
              f"[bundle] ({kind}): {per_replay} VQ launches in the captured step")
    return vq_kernel.launch_count


def main():
    """Exit 1 without a card, or outside a checkout (the package does not
    import); else every phase, with the run's files in a temp directory."""
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        import tvqvae_tpu_torch  # noqa: F401
    except ModuleNotFoundError as e:
        print(f"chip_smoke: {e}; run it from the root of a checkout of the repository",
              file=sys.stderr)
        return 1
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return smoke(torch, Work(root), t_start)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def smoke(torch, work, t_start):
    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.generation import TrainedModelSampler
    from tvqvae_tpu_torch.models.maskgit import encode_tokens
    from tvqvae_tpu_torch.models.vq import lookup_codes
    from tvqvae_tpu_torch.ops import frechet_kernel, traj_dp_kernel, vq_kernel

    marks = [("start", t_start)]

    def lap(name):  # the script's length by phase, printed at the end
        marks.append((name, time.perf_counter()))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    import importlib.util

    import scipy

    # for the record only: the port runs its own isolation forest either way,
    # and reads and writes flight tables without pandas; matplotlib draws the
    # flyability CLI's CDF plot where it is importable
    found = {name: importlib.util.find_spec(name) is not None
             for name in ("sklearn", "pandas", "matplotlib")}
    print(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind} | scipy "
          f"{scipy.__version__} | " + " | ".join(
              f"{name} {'importable' if ok else 'absent'}" for name, ok in found.items()),
          flush=True)

    def timed_build(module):
        t0 = time.perf_counter()
        module.build(verbose=True)
        return time.perf_counter() - t0

    # one nvcc per kernel source, all started together, while the published
    # sampler is built: nothing launches a kernel before its build is read
    builds = (vq_kernel, traj_dp_kernel, frechet_kernel)
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        building = [pool.submit(timed_build, module) for module in builds]
        t0 = time.perf_counter()
        sampler = TrainedModelSampler.from_init(Config(), L, C, N_CLASSES, seed=0, device="cuda",
                                                batch_size=B)
        print(f"[sampler] published width built in {time.perf_counter() - t0:.1f} s: "
              f"tokens {sampler.s1_spec.tokens_l}/{sampler.s1_spec.tokens_h}", flush=True)
        print("[build] " + ", ".join(f"{module.SOURCE.name} in {job.result():.1f} s"
                                     for module, job in zip(builds, building)), flush=True)
    lap("build")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = kernel_phase(torch, vq_kernel)
    lap("kernels")

    sampler.sample(B, seed=100)  # warm-up batch, before the counted run

    # ---- the main path, counted --------------------------------------
    vq_kernel.launch_count = 0
    n_batches = 4
    wall_ms = {}
    for label, kw in (("unconditional", {}),
                      ("class 3", {"kind": "conditional", "class_index": 3})):
        t0 = time.perf_counter()
        x_l, x_h, x = sampler.sample(n_batches * B, seed=1, **kw)
        dt = time.perf_counter() - t0
        check(x.shape == (n_batches * B, C, L) and x_l.shape == x_h.shape == x.shape,
              f"sample shape {x.shape}")
        check(bool(np.isfinite(x).all()), "non-finite samples")
        wall_ms.setdefault("sample", 1e3 * dt / n_batches)
        print(f"[sampler] {label}: {1e3 * dt / n_batches:.2f} ms per {B}-batch, "
              f"{n_batches * B / dt:.1f} traj/s", flush=True)

    series = np.random.default_rng(7).normal(size=(2 * B, C, L)).astype(np.float32)
    before = vq_kernel.launch_count
    t0 = time.perf_counter()
    rec = sampler.reconstruct(series)
    dt = time.perf_counter() - t0
    check(rec.shape == series.shape and bool(np.isfinite(rec).all()), "bad reconstruction")
    check(vq_kernel.launch_count - before == 2 * 2,
          f"VQ kernel launches rose by {vq_kernel.launch_count - before}, not 2 per batch")
    wall_ms["reconstruct"] = 1e3 * dt / 2
    print(f"[reconstruct] {2 * B} series in {1e3 * dt:.1f} ms, VQ kernel launches "
          f"{vq_kernel.launch_count - before} (2 per batch)", flush=True)

    serving_phase(sampler)
    serve_launches = vq_kernel.launch_count
    check(serve_launches > 0, "the served path never launched the VQ kernel")
    lap("serve")

    # ---- training, counted on its own, each stage written to disk -----
    trained, data, step_ms, train_launches, train_gb = train_phase(torch, vq_kernel, work)
    lap("train")
    metrics = eval_metrics(torch, data)  # scores the validations of stages 2-3
    frozen, stage2, stage2_ms, stage2_launches = stage2_phase(torch, vq_kernel, work, data, metrics)
    lap("stage2")
    stage3, stage3_ms, stage3_launches, stage3_gb = stage3_phase(torch, vq_kernel, work, frozen,
                                                                 data, metrics)
    lap("stage3")
    fcn, fcn_ms = fcn_phase(torch, work, data)
    lap("fcn")
    eval_launches, rocket_ms = eval_phase(torch, vq_kernel, work, data, metrics)
    lap("eval")
    bf16_launches = bf16_phase(torch, vq_kernel, work, sampler, series, rec, wall_ms, data,
                               frozen, trained, dict(train_ms=step_ms, train_gb=train_gb,
                                            stage3_ms=stage3_ms, stage3_gb=stage3_gb))
    lap("bf16")
    ess_launches = ess_phase(torch, vq_kernel, wall_ms)
    lap("ess")
    quality_launches = quality_phase(torch, vq_kernel, work)
    lap("quality")
    fly_entries = flyability_phase(torch)
    lap("flyability")
    preprocess_launches = preprocess_phase(torch, vq_kernel, work)
    lap("preprocess")
    import_launches = import_phase(torch, vq_kernel, work)
    lap("import")
    parallel_launches, tp_launches = parallel_phase(torch, vq_kernel, work, smi)
    lap("parallel")
    bundle_launches = bundle_phase(torch, vq_kernel, work, data, frozen, smi)
    lap("bundle")

    # ---- the checkpoints: served and generated from disk, counted -----
    ckpt_launches, generating = ckpt_phase(torch, vq_kernel, work, trained, stage2, stage3,
                                           data.n_classes, step_ms)
    lap("ckpt")
    evaluating = evaluate_cli_start(work, figures=found["matplotlib"])

    # ---- checks after the counted run: the untimed ones while the ------
    # ---- generate and evaluate CLIs run, then the timed ones -----------
    try:
        small_model_check(torch, Config, TrainedModelSampler)
        small_train_check(torch)
        published_train_twin_check(torch, trained, data)
        published_width_check(torch, Config, TrainedModelSampler, sampler, series)
        small_stage2_check(torch)
        small_stage3_check(torch)
        published_fe_check(torch, series)
        small_fcn_check(torch)
        small_bf16_check(torch)
        small_resume_check(torch, work)
        lap("untimed checks")
        check_generated(*generating, work)
        check_evaluated(*evaluating, work, data.n_classes)
    except BaseException:
        for proc in (generating[0], evaluating[0]):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        raise
    lap("CLI wait")
    # the flyability CLI on the generated .npz, beside the checks below
    flying = flyability_cli_start(work, plot=found["matplotlib"])
    try:
        rel = 0.0
        with torch.inference_mode():
            for start in range(0, series.shape[0], B):
                xb = torch.from_numpy(series[start:start + B]).cuda()
                plain = []
                for band, state in (("lf", sampler.frozen.vq_l), ("hf", sampler.frozen.vq_h)):
                    z = sampler.frozen.model.encode(xb, band)
                    flat = z.reshape(-1, z.shape[-1]).contiguous()
                    idx_p = vq_kernel.nearest_codes_stats_plain(flat, state.embed)[0]
                    idx_p = idx_p.reshape(z.shape[:2])
                    check(torch.equal(encode_tokens(sampler.frozen, xb, band), idx_p),
                          f"reconstruct {band} tokens differ from the plain VQ version")
                    plain.append(sampler.frozen.model.decode(lookup_codes(state, idx_p), band))
                ref = torch.from_numpy(rec[start:start + B])
                # relative to the output's scale: cuDNN's default transposed-conv
                # algorithms are not bit-reproducible from call to call ([import])
                gap = (plain[0] + plain[1]).cpu().sub(ref).abs().max() / ref.abs().max()
                rel = max(rel, float(gap))
                check(rel <= 1e-4,
                      f"reconstruct differs from the plain VQ path by {rel} of its scale")
        print(f"[reconstruct] tokens equal to the plain VQ version on the card; decoded series "
              f"within {rel:.3g} of their scale", flush=True)
        tok_l, tok_h, y = stage2_checks(torch, vq_kernel, frozen, stage2, data)
        xprime = stage3_checks(torch, vq_kernel, frozen, stage3, stage2, data)
        fe_sampler_check(torch, Config, TrainedModelSampler)
        check_flyability_cli(*flying, work)
    except BaseException:
        if flying[0] is not None and flying[0].poll() is None:
            flying[0].kill()
            flying[0].wait()
        raise
    lap("timed checks")
    analysis_phase(torch, work, figures=found["matplotlib"])
    lap("analysis")
    profile_phase(torch, sampler, series, wall_ms)
    train_profile(torch, trained, data, step_ms)
    stage2_profile(torch, stage2, tok_l, tok_h, y, stage2_ms)
    stage3_profile(torch, stage3, data, xprime, stage3_ms)
    fcn_profile(torch, fcn, data, fcn_ms)
    rocket_profile(torch, metrics, data, rocket_ms)
    lap("profiles")

    main_numbers = kernels[MAIN_SHAPE]
    entry = {
        "name": "vq_nearest_stats",
        "route": "cuda",
        "source": "tvqvae_tpu_torch/csrc/vq_nearest.cu",
        "replaces": "tvqvae_tpu/ops/vq_pallas.py:36",
        "launches": (serve_launches + train_launches + stage2_launches + stage3_launches
                     + eval_launches + bf16_launches + ess_launches + quality_launches
                     + preprocess_launches + import_launches + parallel_launches
                     + tp_launches + bundle_launches + ckpt_launches),
        "launches_by_path": {"serve": serve_launches, "train": train_launches,
                             "stage2": stage2_launches, "stage3": stage3_launches,
                             "eval": eval_launches, "bf16": bf16_launches,
                             "ess": ess_launches, "quality": quality_launches,
                             "preprocess": preprocess_launches, "import": import_launches,
                             "parallel": parallel_launches, "tp": tp_launches,
                             "bundle": bundle_launches, "ckpt": ckpt_launches},
        "max_abs_err": max(r["max_abs_err"] for r in kernels.values()),
        "ms": main_numbers["ms"],
        "plain_ms": main_numbers["plain_ms"],
        "bound_ms": main_numbers["bound_ms"],
        "bound_by": main_numbers["bound_by"],
        "library_ms": main_numbers["library_ms"],
        "device_ms": main_numbers["device_ms"],
        "shape_MKD": list(MAIN_SHAPE),
    }
    print(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s: "
          + ", ".join(f"{name} {t - t_prev:.1f}" for (_, t_prev), (name, t) in zip(marks, marks[1:])),
          flush=True)
    print(json.dumps({"kernels": [entry, *fly_entries]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
