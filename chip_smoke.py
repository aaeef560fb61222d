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
     5120)): one launch of each kernel (``csrc/traj_dp.cu``,
     ``csrc/frechet_decision.cu``) a bucket, wall ms, pairs/s, device ms a
     launch (torch.profiler); then the DP kernel against its plain version
     on 2 pairs of the first bucket (EDR and LCSS exactly, the discrete
     Frechet 1e-6, DTW and ERP 1e-5 relative), SSPD and Hausdorff against
     the plain matrices on the card and the CPU, and the Frechet kernel
     against its plain version (its decision replayed from a CUDA graph) on
     2 pairs of (1024, 512) points (1e-5 relative), each with ms, the plain
     version's ms and the bound.
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
     plain twin (indices and EMA codebook state); two series at the
     published width through the card and the CPU; the stage-2 sweep's
     tokens against the plain VQ version's; three on-the-fly stage-2 steps
     against the token path; a 32-batch sampled from the trained priors;
     the x' sweep through the kernel and its plain twin; three on-the-fly
     stage-3 steps against the precomputed path and three at tau 0.5; a
     small stage 3 and a small FCN on the card against the CPU; the
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
     flight.
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
# the JAX evaluate CLI's result names (tvqvae_tpu/scripts/evaluate.py), images aside
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
# Two more checks reach the launch plans of the full-length buckets that those
# shapes do not: the Frechet's rows of 8 elements a thread, on pairs of
# FLY_CHUNK8_ROWS x L points (the plain Frechet's cost grows with the rows),
# and the DP's diagonals longer than a block's 1024 threads, on pairs of
# FLY_WIDE x FLY_WIDE points.
FLY_PAIRS, FLY_LONG_PAIRS, FLY_STRIDE, FLY_CHECK_PAIRS = 64, 2, 8, 2
FLY_FRECHET_SHAPE = (1024, 512)
FLY_CHUNK8_ROWS, FLY_WIDE = 64, 1100
# fp32 operations per grid cell, a transcendental counted as one: the cost
# (planar: 2 sub, 2 mul, 2 add, sqrt; spherical: 2 sub, 2 halvings, 2 sin, 2
# squares, 2 mul, add, 2 clamps, sqrt, asin, mul) and each recurrence; the
# Frechet decision's cell: two free intervals (4 sub, 6 mul, 3 add, max, 2
# div, sub, mul, add, 2 compares, sqrt, sub, add, 2 clamps: 26 each) and
# the map's compose and apply (8)
DP_COST_OPS = {"euclidean": 7, "spherical": 16}
DP_STEP_OPS = {"dtw": 3, "erp": 5, "edr": 6, "lcss": 4, "discret_frechet": 3}
FRECHET_CELL_OPS = 2 * 26 + 8
FLY_KERNELS = ("traj_dp_kernel", "frechet_kernel")  # csrc/traj_dp.cu, csrc/frechet_decision.cu
# [preprocess]: (a) the OpenSky CLI on PREP_CORRIDORS corridors of
# PREP_PER_CORRIDOR flights of ~PREP_POINTS points each (the published
# EHAM->LIMC length), two flights an aircraft PREP_GAP_H hours apart; (b) the
# mixture at the published dataset's clustering geometry: 6592 flights
# (5932 train + 660 test, BASELINE.md), 2 x 1000 resampled coordinates, 5
# components; (c) the same module on the card and on the CPU at PREP_CHECK.
PREP_CORRIDORS, PREP_PER_CORRIDOR, PREP_POINTS, PREP_GAP_H = 5, 20, 4633, 8.0
PREP_GMM, PREP_CHECK = (6592, 2000, 5), (512, 400, 5)
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


def cli_subprocess(work, script, cli_args):
    """``python -m tvqvae_tpu_torch.scripts.<script>`` over the run's dataset
    and written checkpoints, started in the background."""
    repo = os.path.dirname(os.path.abspath(__file__))
    # its host work is file reads and numpy; two threads leave the cores to
    # the card-vs-CPU checks that run beside it
    env = {**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "2"}
    cmd = [sys.executable, "-m", f"tvqvae_tpu_torch.scripts.{script}", "--dataset_file",
           work.dataset, "--model_save_dir", work.models, *cli_args]
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
    a CUDA event recorded after the step's work; the validations."""

    def __init__(self, torch):
        self.torch = torch
        self.losses, self.events, self.val, self.acc = [], [], [], []
        self.t_train = self.t_val = None  # host clock at the last train and validation logs

    def log_metrics(self, metrics, step):
        if "train/loss" in metrics:
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


def published_train_twin_check(torch, trained, data, device="cuda"):
    """One more training step at the published width from two copies of the
    trained model and codebooks, on the same batch and dropout seed: one
    through the VQ kernel, one with its plain twin in its place. The kernel's
    counts and row sums feed the EMA here, so: indices equal, losses within
    1e-5 relative, and cluster_size, embed_avg and embed within 1e-4 + 1e-4
    relative (the row sums add ~M/K rows of D=128 in another order)."""
    import copy

    from tvqvae_tpu_torch.models import vq as vq_module
    from tvqvae_tpu_torch.ops import vq_kernel
    from tvqvae_tpu_torch.train.optim import adamw
    from tvqvae_tpu_torch.train.stage1 import create_stage1_state, make_stage1_train_step

    x = torch.from_numpy(data.X_train[B:2 * B]).to(device)
    step = make_stage1_train_step()
    runs = {}
    for name, assign in (("kernel", vq_kernel.nearest_codes_stats),
                         ("plain", vq_kernel.nearest_codes_stats_plain)):
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
        runs[name] = (state, seen[0], loss)
    (k_state, k_idx, k_loss), (p_state, p_idx, p_loss) = runs["kernel"], runs["plain"]
    for band, a, b in zip(("lf", "hf"), k_idx, p_idx):
        check(torch.equal(a, b), f"published-width train step: {band} indices differ from plain")
    check(abs(k_loss - p_loss) <= 1e-5 * abs(p_loss),
          f"published-width train step: loss {k_loss} vs plain {p_loss}")
    errs = {}
    for band in ("vq_l", "vq_h"):
        for f in ("embed", "embed_avg", "cluster_size"):
            a, b = getattr(getattr(k_state, band), f), getattr(getattr(p_state, band), f)
            errs[f"{band}.{f}"] = float((a - b).abs().max())
            check(bool(((a - b).abs() <= 1e-4 + 1e-4 * b.abs()).all()),
                  f"published-width train step: {band}.{f} off by {errs[f'{band}.{f}']}")
    print(f"[reference] published-width train step, kernel vs plain VQ twin: indices equal "
          f"({k_idx[0].numel()} LF, {k_idx[1].numel()} HF tokens), loss {k_loss:.6f} vs "
          f"{p_loss:.6f}, codebook max abs err "
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
    kernel and through its plain twin (tokens equal; the sweep's time, by
    host clock with a synchronise); three on-the-fly steps from a copy of
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
    sweeps = {}
    for name, assign in (("kernel", vq_kernel.nearest_codes_stats),
                         ("plain", vq_kernel.nearest_codes_stats_plain)):
        vq_module.nearest_codes_stats = assign
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = precompute_token_dataset(frozen, X, SWEEP_BATCH)
            sweeps[name] = (toks, 1e3 * (time.perf_counter() - t0))
        finally:
            vq_module.nearest_codes_stats = vq_kernel.nearest_codes_stats
    (k_l, k_h), k_ms = sweeps["kernel"]
    (p_l, p_h), p_ms = sweeps["plain"]
    check(np.array_equal(k_l, p_l) and np.array_equal(k_h, p_h),
          "stage-2 sweep tokens differ from the plain VQ version's")
    print(f"[stage2] sweep of {len(k_l)} series ({k_l.shape[1]} LF + {k_h.shape[1]} HF tokens "
          f"each): {k_ms:.2f} ms through the kernel, {p_ms:.2f} ms through the plain twin; "
          f"tokens equal", flush=True)

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
            scores = evaluate(cfg, data, os.path.dirname(work.stage["1"]), logger, batch_size=B,
                              min_num_gen=EVAL_SERIES, use_fe=True,
                              feature_extractor_type=cfg.evaluation.feature_extractor_type,
                              fid_method="svd", device=device)
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
    print(f"[eval] evaluate() in the process ({EVAL_SERIES} series, ROCKET features, FID by svd, "
          f"against the {len(data.X_test)} test series) in {eval_s:.2f} s: "
          + ", ".join(f"{k} {v:.4g}" for k, v in scores.items()), flush=True)
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


def check_evaluated(proc, t0):
    """Wait for the evaluate CLI and check its printed results: the JAX
    package's names (``FID_svq`` only where stage 3 trained at tau > 0; here
    at 0), every value finite."""
    out, _ = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"evaluate exited {proc.returncode}:\n{out[-3000:]}")
    results = json.loads(out[out.rindex("\n{") + 1:])
    want = [k for k in JAX_EVAL_KEYS if k != "FID_svq"]
    check(sorted(results) == sorted(want), f"evaluate printed {sorted(results)}")
    check(bool(np.isfinite(list(results.values())).all()), f"evaluate: non-finite {results}")
    print(f"[eval] evaluate CLI (a subprocess, --min_num_gen_samples {EVAL_SERIES} --fid_method "
          f"svd): the JAX package's {len(results)} result names, finite, in "
          f"{time.perf_counter() - t0:.1f} s from its start: "
          + ", ".join(f"{k} {v:.4g}" for k, v in results.items()), flush=True)


def stage3_checks(torch, vq_kernel, frozen, state, stage2, data, device="cuda"):
    """After the counted run: the x' sweep of the train split through the
    kernel and through its plain twin (tokens equal, x' within 1e-4 of its
    scale; the sweep's time by host clock with a synchronise); three
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
    sweeps = {}
    for name, assign in (("kernel", vq_kernel.nearest_codes_stats),
                         ("plain", vq_kernel.nearest_codes_stats_plain)):
        vq_module.nearest_codes_stats = assign
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
    check(np.array_equal(k_l, p_l) and np.array_equal(k_h, p_h),
          "stage-3 sweep tokens differ from the plain VQ version's")
    rel = float((k_xp - p_xp).abs().max() / p_xp.abs().max())
    check(rel <= 1e-4, f"stage-3 x' through the kernel off the plain twin's by {rel} of its scale")
    print(f"[stage3] x' sweep of {len(k_xp)} series: {k_ms:.2f} ms through the kernel, "
          f"{p_ms:.2f} ms through the plain twin; tokens equal, x' within {rel:.3g} of its scale",
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


def small_stage3_check(torch, devices=("cpu", "cuda"), steps=3):
    """The same seeded small stage 1 and small enhancer (dim 8, dim_mults
    (1, 2), dropout 0) on the CPU (plain VQ) and on the card (kernel): the
    x' sweep within 1e-5 of its scale, three on-the-fly tau = 0 steps'
    losses within 1e-5 relative, parameters within 1e-5 (the float64
    witness rule of ``witness_check``)."""
    import copy

    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.models.fidelity_enhancer import FidelityEnhancer
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

    cfg = Config.from_dict({**SMALL_CFG, "fidelity_enhancer": {**SMALL_CFG["fidelity_enhancer"],
                                                               "dropout": 0.0}})
    Ls, n = 127, 8
    spec = Stage1Spec.from_config(cfg, Ls, C)
    xs = np.random.default_rng(10).normal(size=(steps, n, C, Ls)).astype(np.float32)
    runs = []
    for dev in devices:
        model, vq_l, vq_h = init_stage1(spec, torch.Generator().manual_seed(3), dev)
        frozen = FrozenStage1(model.eval().requires_grad_(False), vq_l, vq_h)
        fe = init_stage3(FidelityEnhancer.from_config(cfg, Ls, C), torch.Generator().manual_seed(4), dev)
        fe0 = copy.deepcopy(fe)
        state = create_stage3_state(fe, _adamw(cfg, SMALL_STEPS))
        xprime = precompute_xprime_dataset(frozen, xs.reshape(-1, C, Ls), batch_size=n)
        step = make_stage3_train_step(frozen)
        losses = [step(state, torch.from_numpy(x).to(dev))[1]["loss"].item() for x in xs]
        runs.append((state, xprime, losses, fe0))
    (ref, ref_xp, ref_loss, fe0), (dut, dut_xp, dut_loss, _) = runs
    xp_err = float(np.abs(dut_xp - ref_xp).max() / np.abs(ref_xp).max())
    check(xp_err <= 1e-5, f"small stage 3: x' off by {xp_err} of its scale")
    loss_err = max(abs(a - b) / abs(a) for a, b in zip(ref_loss, dut_loss))
    check(loss_err <= 1e-5, f"small stage 3: losses off by {loss_err} relative")
    # the float64 witness: the CPU's precomputed steps from the same x', in float64
    exact_fe = fe0.double()
    exact = create_stage3_state(exact_fe, _adamw(cfg, SMALL_STEPS))
    pre = make_stage3_train_step_pre()
    for x, xp in zip(xs, ref_xp.reshape(steps, n, C, Ls)):
        pre(exact, torch.from_numpy(x).double(), torch.from_numpy(xp).double())
    worst, witnessed = witness_check("small stage 3", dut.fe.state_dict(), ref.fe.state_dict(),
                                     exact.fe.state_dict(), 1e-5)
    print(f"[reference] small stage 3, {steps} steps, card vs CPU: x' {xp_err:.3g} of scale, "
          f"losses {dut_loss} vs {ref_loss}, rel err {loss_err:.3g}, parameters {worst:.3g} "
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
    --ess``, scoring QUALITY_EVAL series: every SUMMARY key of the JAX
    tool, finite; the noise rung above the floor; FID_rec through the VQ
    kernel (2 launches per 64 series). -> its VQ launches."""
    from tvqvae_tpu_torch.scripts import quality_run

    cut = json.loads(json.dumps(quality_run.CFG_OVERRIDES))
    cut["trainer_params"] = {"max_steps": dict(QUALITY_STEPS),
                             "val_check_interval": dict(QUALITY_STEPS)}
    cut["evaluation"]["min_num_gen_samples"] = QUALITY_EVAL
    args = quality_run.build_argparser().parse_args(
        ["--workdir", os.path.join(work.root, "qr"), "--bf16", "--ess", "--n_eval",
         str(QUALITY_EVAL), "--device", device])
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


def fly_bound(n, m, variants=None):
    """Least time of one traj_dp launch (``variants`` given) or one Frechet
    launch over pairs of true lengths ``n``, ``m``: the bytes they need read
    once (their points, lengths, and hi) and written once at
    HBM_BYTES_PER_S, or the fp32 operations of the true grids at
    FP32_FLOPS, the larger. -> (ms, bound_by, ops)."""
    from tvqvae_tpu_torch.ops.frechet_kernel import STEPS

    points = 8 * (sum(n) + sum(m))
    if variants is None:
        ops = STEPS * FRECHET_CELL_OPS * sum((a - 1) * (b - 1) for a, b in zip(n, m))
        nbytes = points + len(n) * (8 + 4 + 4)
    else:
        cells = sum(a * b for a, b in zip(n, m))
        ops = cells * sum(DP_COST_OPS[metric] + DP_STEP_OPS[kind] for kind, metric, _ in variants)
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


def frechet_plain_start(torch, D, p, q, hi, device="cuda"):
    """Start ``distances.frechet_bisect`` on pairs whose padding repeats
    their last point (as ``frechet_bisect`` pads): its 30 bisection steps of
    the plain decision ``_frechet_decision``. Eagerly each step is ~1.6e5
    launches from the host; on the card the decision is captured once in a
    CUDA graph and the steps are replayed on a side stream, which leaves the
    host free for other work meanwhile. The tensors made on the current
    stream are marked as used by the side stream, and the graph (with its
    memory pool) lives until the replays have run, so that nothing the
    replays read or write is handed to other work before. Capturing a graph
    waits for the whole card: start the shorter of two first. -> a function
    that waits and returns (hi, ms: the capture's host time plus the
    replays' device time)."""
    t0 = time.perf_counter()
    lo = torch.maximum(torch.sqrt(D._sq_dist(p[:, 0], q[:, 0])),
                       torch.sqrt(D._sq_dist(p[:, -1], q[:, -1])))
    eps = 0.5 * (lo + hi)
    if device != "cuda":  # the CPU rehearsal: eagerly
        hi = D.frechet_bisect(p, q, p.shape[1], q.shape[1], hi)
        return lambda: (hi, 1e3 * (time.perf_counter() - t0))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    for t in (p, q, lo, hi, eps):
        t.record_stream(side)
    with torch.cuda.stream(side):
        D._frechet_decision(p, q, eps)  # warm-up outside the capture
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            ok = D._frechet_decision(p, q, eps)
        capture_ms = 1e3 * (time.perf_counter() - t0)
        first, last = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        first.record(side)
        for _ in range(D.BISECTION_STEPS):
            eps.copy_(0.5 * (lo + hi))
            graph.replay()
            lo, hi = torch.where(ok, lo, eps), torch.where(ok, eps, hi)
        last.record(side)

    def finish():
        last.synchronize()
        torch.cuda.current_stream().wait_stream(side)
        graph.reset()  # the replays have run: its pool may go
        return hi, capture_ms + first.elapsed_time(last)

    return finish


def flyability_phase(torch, device="cuda"):
    """[flyability]: the counters set to 0, the 14 metrics of FLY_PAIRS +
    FLY_LONG_PAIRS synthetic pairs through ``calculate_trajectory_distances_batch``
    on the card (two buckets: one launch of each kernel a bucket); wall ms,
    pairs/s, each kernel's device ms per launch; then each kernel held to its
    plain version on the card (DP family: EDR, LCSS exactly, the discrete
    Frechet 1e-6, DTW and ERP 1e-5 relative; the Frechet 1e-5 relative),
    also at the launch plans of the full-length buckets (the Frechet's 8
    elements a thread, the DP's diagonals longer than its threads), with
    ms (events), the plain version's ms and the bound at those inputs, and
    SSPD / Hausdorff of the batch against the plain version on the card (1e-5
    relative) and on the CPU. -> the kernels' JSON entries."""
    from tvqvae_tpu_torch.data.preprocess import AIRPORTS
    from tvqvae_tpu_torch.evaluation.flyability import distances as D
    from tvqvae_tpu_torch.ops import frechet_kernel, traj_dp_kernel

    rng = np.random.default_rng(20)
    gens, sims = fly_tracks(rng, FLY_PAIRS, L, FLY_STRIDE)
    long_gens, _ = fly_tracks(rng, FLY_LONG_PAIRS, L, 1)
    gens += long_gens
    sims += [g + rng.normal(0, 0.005, g.shape).astype(np.float32) for g in long_gens]
    adep = AIRPORTS["EHAM"]
    buckets = list(dict.fromkeys((D._bucket_size(len(a)), D._bucket_size(len(b)))
                                 for a, b in zip(gens, sims)))  # in the batch's launch order
    D.calculate_trajectory_distances_batch(gens[:1], sims[:1], adep, device=device)  # warm-up

    traj_dp_kernel.launch_count = frechet_kernel.launch_count = 0
    t0 = time.perf_counter()
    out = D.calculate_trajectory_distances_batch(gens, sims, adep, device=device)
    wall = time.perf_counter() - t0
    launches = {"traj_dp": traj_dp_kernel.launch_count, "frechet": frechet_kernel.launch_count}
    check(launches == {"traj_dp": len(buckets), "frechet": len(buckets)},
          f"flyability launches {launches}, buckets {buckets}")
    check(set(out) == set(D.KEYS) and all(len(v) == len(gens) for v in out.values()),
          f"flyability keys {sorted(out)}")
    bad = [k for k, v in out.items() if not np.isfinite(v).all()]
    check(not bad, f"non-finite flyability metrics {bad}")
    check(all(f <= df + 1e-5 for f, df in zip(out["Frechet"], out["Discrete Frechet"])),
          "Frechet above the discrete Frechet")
    by_kernel, busy = fly_device_ms(
        torch, lambda: D.calculate_trajectory_distances_batch(gens, sims, adep, device=device))
    print(f"[flyability] {len(gens)} pairs in buckets {buckets}: {1e3 * wall:.1f} ms wall, "
          f"{len(gens) / wall:.1f} pairs/s; launches {launches}; device busy {busy:.2f} ms; "
          + ", ".join(f"{k} ms a launch by bucket {[round(t, 3) for t in ts]}"
                      for k, ts in by_kernel.items())
          + "; medians " + ", ".join(f"{k} {np.median(out[k]):.6g}" for k in D.KEYS), flush=True)

    # the DP kernel against its plain version, FLY_CHECK_PAIRS pairs of the
    # first bucket, and the Frechet kernel against its plain version at
    # FLY_FRECHET_SHAPE: the plain Frechet's graph replays run on the card
    # while the host issues the plain DP family's row loops
    k = FLY_CHECK_PAIRS
    p = torch.from_numpy(np.stack([D._bucket_pad(x) for x in gens[:k]])).to(device)
    q = torch.from_numpy(np.stack([D._bucket_pad(x) for x in sims[:k]])).to(device)
    n = torch.tensor([len(x) for x in gens[:k]], device=device)
    m = torch.tensor([len(x) for x in sims[:k]], device=device)
    variants = D.dp_variants()
    spec = [v[1:] for v in variants]
    got = traj_dp_kernel.traj_dp(p, q, n, m, adep, spec)
    fg, fs = fly_tracks(rng, k, FLY_FRECHET_SHAPE[0], 2)
    fp = torch.from_numpy(np.stack(fg)).to(device)
    fq = torch.from_numpy(np.stack([x[:FLY_FRECHET_SHAPE[1]] for x in fs])).to(device)
    fn_, fm = [FLY_FRECHET_SHAPE[0]] * k, [FLY_FRECHET_SHAPE[1]] * k
    hi = traj_dp_kernel.traj_dp(fp, fq, fn_, fm, adep, [("discret_frechet", "euclidean", 0.0)])
    hi = hi[:, 0].contiguous()
    fr = frechet_kernel.frechet(fp, fq, fn_, fm, hi)
    # the Frechet's plan of 8 elements a thread: pairs of FLY_CHUNK8_ROWS x L
    # points in their bucket, as the (5120, 5120) bucket launches it
    cg, cs = fly_tracks(rng, k, L, 1)
    pick = np.linspace(0, L - 1, FLY_CHUNK8_ROWS).round().astype(int)
    cp = torch.from_numpy(np.stack([D._bucket_pad(x[pick]) for x in cg])).to(device)
    cq = torch.from_numpy(np.stack([D._bucket_pad(x) for x in cs])).to(device)
    cn, cm = [FLY_CHUNK8_ROWS] * k, [L] * k
    c_plan = frechet_kernel.launch_plan(L)
    check(device != "cuda" or c_plan[1] == frechet_kernel.CHUNKS[-1],
          f"the Frechet's plan at {L} columns is {c_plan}, not {frechet_kernel.CHUNKS[-1]} a thread")
    c_hi = traj_dp_kernel.traj_dp(cp, cq, cn, cm, adep, [("discret_frechet", "euclidean", 0.0)])
    c_hi = c_hi[:, 0].contiguous()
    c_fr = frechet_kernel.frechet(cp, cq, cn, cm, c_hi)
    # the DP's diagonals longer than a block: pairs of FLY_WIDE x FLY_WIDE points
    wg, ws = fly_tracks(rng, k, FLY_WIDE, 1)
    wp = torch.from_numpy(np.stack([D._bucket_pad(x) for x in wg])).to(device)
    wq = torch.from_numpy(np.stack([D._bucket_pad(x) for x in ws])).to(device)
    wn = torch.tensor([FLY_WIDE] * k, device=device)
    w_threads = traj_dp_kernel.launch_plan(FLY_WIDE, FLY_WIDE)[0]
    check(device != "cuda" or w_threads < FLY_WIDE,
          f"the DP's plan at {FLY_WIDE} x {FLY_WIDE} has {w_threads} threads: no strided diagonal")
    w_got = traj_dp_kernel.traj_dp(wp, wq, wn, wn, adep, spec)
    torch.cuda.synchronize()
    finish_chunk8 = frechet_plain_start(torch, D, cp, cq, c_hi.clone(), device)
    finish_frechet = frechet_plain_start(torch, D, fp, fq, hi.clone(), device)
    t0 = time.perf_counter()
    want = D.dp_metrics(p, q, n, m, adep, spec)
    torch.cuda.current_stream().synchronize()
    dp_plain_ms = 1e3 * (time.perf_counter() - t0)
    w_want = D.dp_metrics(wp, wq, wn, wn, adep, spec)
    fr_plain, fr_plain_ms = finish_frechet()
    c_plain, _ = finish_chunk8()

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
    w_rels = dp_rels(w_got, w_want, f"with strided diagonals at {FLY_WIDE} x {FLY_WIDE}")
    for j, (key, *_) in enumerate(variants):
        check(np.allclose(out[key][:k], got[:, j].cpu().numpy(), rtol=0, atol=0),
              f"traj_dp {key}: the batch's value differs from the two-pair launch")
    dp_err = max(float((got - want).abs().max()), float((w_got - w_want).abs().max()))
    dp_ms = time_ms(torch, lambda: traj_dp_kernel.traj_dp(p, q, n, m, adep, spec), iters=5,
                    warmup=1)
    dp_bound, dp_by, dp_ops = fly_bound(n.tolist(), m.tolist(), spec)
    diagonals = max(a + b - 1 for a, b in zip(n.tolist(), m.tolist()))

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
    c_rel = float(((c_fr - c_plain).abs() / c_plain.abs()).max())
    check(c_rel <= 1e-5, f"frechet kernel at {c_plan[1]} elements a thread differs from the "
                         f"plain version by {c_rel}")
    fr_ms = time_ms(torch, lambda: frechet_kernel.frechet(fp, fq, fn_, fm, hi), iters=3, warmup=1)
    fr_bound, fr_by, fr_ops = fly_bound(fn_, fm)
    rows = frechet_kernel.STEPS * (FLY_FRECHET_SHAPE[0] - 1)
    print(f"[flyability] traj_dp vs plain on {k} pairs at {tuple(p.shape[1:2]) + tuple(q.shape[1:2])} "
          f"(true {n.tolist()} x {m.tolist()}): max rel by metric "
          + ", ".join(f"{key} {r:.3g}" for key, r in rels.items())
          + f"; {dp_ms:.3f} ms a launch ({1e6 * dp_ms / diagonals:.1f} ns per dependent diagonal "
          f"of {diagonals}), plain {dp_plain_ms:.1f} ms, bound {dp_bound:.5f} ms ({dp_by}: "
          f"{dp_ops / 1e9:.3f} GFLOP, no single PyTorch call computes it)", flush=True)
    print(f"[flyability] traj_dp vs plain with strided diagonals on {k} pairs at "
          f"{tuple(wp.shape[1:2]) + tuple(wq.shape[1:2])} (true {FLY_WIDE} x {FLY_WIDE}, "
          f"{w_threads} threads): max rel by metric "
          + ", ".join(f"{key} {r:.3g}" for key, r in w_rels.items()), flush=True)
    print(f"[flyability] frechet vs plain on {k} pairs at {FLY_FRECHET_SHAPE}: max rel {fr_rel:.3g}, "
          f"{fr_ms:.3f} ms a launch ({1e6 * fr_ms / rows:.1f} ns per dependent row of {rows}), "
          f"plain {fr_plain_ms:.1f} ms (its decision replayed from a CUDA graph, beside the "
          f"plain DP family), bound "
          f"{fr_bound:.5f} ms ({fr_by}: {fr_ops / 1e9:.3f} GFLOP, no single PyTorch call computes "
          f"it)", flush=True)
    print(f"[flyability] frechet vs plain at {c_plan[1]} elements a thread on {k} pairs at "
          f"{tuple(cp.shape[1:2]) + tuple(cq.shape[1:2])} (true {FLY_CHUNK8_ROWS} x {L}, "
          f"{c_plan[0]} threads): max rel {c_rel:.3g}", flush=True)
    common = {"route": "cuda", "library_ms": None}
    return [
        {"name": "traj_dp", "source": "tvqvae_tpu_torch/csrc/traj_dp.cu",
         "replaces": "tvqvae_tpu/evaluation/flyability/distances.py:188",
         "launches": launches["traj_dp"], "launches_by_path": {"flyability": launches["traj_dp"]},
         "max_abs_err": dp_err, "ms": dp_ms, "plain_ms": dp_plain_ms, "bound_ms": dp_bound,
         "bound_by": dp_by, "shape_pairs_PQ": [k, *p.shape[1:2], *q.shape[1:2]],
         "device_ms_by_bucket": dict(zip(map(str, buckets), by_kernel["traj_dp_kernel"])),
         **common},
        {"name": "frechet_decision", "source": "tvqvae_tpu_torch/csrc/frechet_decision.cu",
         "replaces": "tvqvae_tpu/evaluation/flyability/distances.py:406",
         "launches": launches["frechet"], "launches_by_path": {"flyability": launches["frechet"]},
         "max_abs_err": max(float((fr - fr_plain).abs().max()),
                            float((c_fr - c_plain).abs().max())),
         "ms": fr_ms, "plain_ms": fr_plain_ms,
         "bound_ms": fr_bound, "bound_by": fr_by, "shape_pairs_PQ": [k, *FLY_FRECHET_SHAPE],
         "device_ms_by_bucket": dict(zip(map(str, buckets), by_kernel["frechet_kernel"])),
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

    # ---- the checkpoints: served and generated from disk, counted -----
    ckpt_launches, generating = ckpt_phase(torch, vq_kernel, work, trained, stage2, stage3,
                                           data.n_classes, step_ms)
    lap("ckpt")
    t_eval = time.perf_counter()
    evaluating = cli_subprocess(work, "evaluate", [
        "--min_num_gen_samples", str(EVAL_SERIES), "--fid_method", "svd",
        "--run_dir", os.path.join(work.root, "runs"), "--device", "cuda"])

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
        check_evaluated(evaluating, t_eval)
    except BaseException:
        for proc in (generating[0], evaluating):
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
                # relative to the output's scale: cuDNN may pick other conv algorithms
                # as free memory changes between the two decodes
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
        if flying[0].poll() is None:
            flying[0].kill()
            flying[0].wait()
        raise
    lap("timed checks")
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
                     + preprocess_launches + ckpt_launches),
        "launches_by_path": {"serve": serve_launches, "train": train_launches,
                             "stage2": stage2_launches, "stage3": stage3_launches,
                             "eval": eval_launches, "bf16": bf16_launches,
                             "ess": ess_launches, "quality": quality_launches,
                             "preprocess": preprocess_launches, "ckpt": ckpt_launches},
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
