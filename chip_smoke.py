#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``tvqvae_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It needs no JAX and no network. Phases, each fatal on failure:

  1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda`` name.
  2. build: every CUDA kernel from ``tvqvae_tpu_torch/csrc`` with nvcc.
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes, the K sweep and one ragged shape, with times,
     device time per launched kernel (torch.profiler) and bounds.
  4-6. the served path, with every launch counter set to 0 first: the
     sampler at the published width (B=32, C=4, L=4633, hid_dim 128,
     codebooks 32/32, priors 128x4Lx2H and 32x1Lx1H, 5 classes, seeded
     random weights), ``reconstruct`` of 64 series (two launches of the VQ
     kernel per batch), and the HTTP server answering three requests.
  7. train: the counters set to 0 again, ``train_stage1`` at the published
     width (``Config()``, dropout as configured) for 40 steps on 320
     synthetic series (288 train, 32 test): two VQ kernel launches per step
     and per validation batch, a finite loss that falls after the warmup,
     steady ms per step (CUDA events), peak memory.
  8. checks after the counted runs: the reconstruct tokens against the
     plain VQ version; a small model on the card against the same model on
     the CPU (plain versions) with the same weights and noise, sampling and
     three training steps; one more published-width training step from
     the trained state through the VQ kernel and through its plain twin
     (indices and EMA codebook state); and two series at the published
     width through the card and the CPU.
  9. profile: device time by kernel and the device's idle share over one
     sample batch, one reconstruct batch and one training step
     (torch.profiler).

The last lines are a JSON list of the kernels with their numbers, the card's
``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero before that line.
"""

import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from http.client import HTTPConnection

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
KERNEL_SHAPES = [(864, 32, 128), (3456, 32, 128), (3456, 512, 128), (3456, 2048, 128)]
CHECK_SHAPES = KERNEL_SHAPES + [(865, 33, 20)]  # a ragged shape: 4-byte copies, padded dims
MAIN_SHAPE = (3456, 32, 128)  # the HF call of a 32-batch, the larger of the two per batch
B, C, L, N_CLASSES = 32, 4, 4633, 5
TRAIN_STEPS, TRAIN_SERIES = 40, 320
VQ_KERNELS = ("assign_kernel", "merge_stats_kernel", "final_kernel")  # csrc/vq_nearest.cu
CONV_OPS = ("aten::cudnn_convolution", "aten::cudnn_convolution_transpose",
            "aten::convolution_backward")
SMALL_CFG = {
    "encoder": {"init_dim": 4, "hid_dim": 16, "n_resnet_blocks": 1,
                "downsampled_width": {"lf": 4, "hf": 8}},
    "decoder": {"n_resnet_blocks": 1},
    "VQ-VAE": {"n_fft": 4, "codebook_sizes": {"lf": 8, "hf": 8}},
    "MaskGIT": {"T": {"lf": 3, "hf": 1},
                "prior_model_l": {"hidden_dim": 16, "n_layers": 2, "heads": 2},
                "prior_model_h": {"hidden_dim": 8, "n_layers": 1, "heads": 1}},
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


def kernel_phase(torch, vq_kernel):
    """The VQ kernel against its plain version at every shape of CHECK_SHAPES;
    at KERNEL_SHAPES also its time (events), device time per kernel per call
    (profiler), the bound, and the times of the plain version, of
    cdist+argmin and of the fp32 product flat @ embed.T alone."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
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
        # the statistics of the kernel's own assignment, computed plainly
        r_cnt = torch.bincount(idx.long(), minlength=K).float()
        r_es = torch.zeros_like(embed).index_add_(0, idx.long(), flat)
        check(torch.equal(cnt, r_cnt), f"counts differ at {(M, K, D)}")
        # 1e-4 plus 1e-6 relative: both sum ~M/K float32 rows, in another order
        err = float((es - r_es).abs().max())
        check(bool(((es - r_es).abs() <= 1e-4 + 1e-6 * r_es.abs()).all()),
              f"embed_sum off by {err} at {(M, K, D)}")
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
        iters = 20
        _, events = device_events(torch, lambda: [vq_kernel.nearest_codes_stats(flat, embed)
                                                  for _ in range(iters)])
        by_kernel = {k: (n / iters, t / 1e3 / iters) for k, (n, t) in kernel_names(events).items()}
        device_ms = sum(t for _, t in by_kernel.values()) or None
        results[(M, K, D)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                  bound_ms=bound_ms, bound_by=bound_by, device_ms=device_ms)
        split = ", ".join(f"{k} {t:.5f} ms x{n:g}" for k, (n, t) in by_kernel.items())
        print(f"{line}, {ms:.4f} ms/call, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by}), library_ms {lib_ms:.4f} (cdist+argmin: idx only), fp32 "
              f"matmul alone {mm_ms:.4f} ms; device ms "
              f"per call {device_ms if device_ms is None else f'{device_ms:.5f}'}: "
              f"{split or 'not measured'}", flush=True)
    return results


def serving_phase(sampler):
    from tvqvae_tpu_torch.serving import GenerationService, make_server

    svc = GenerationService(sampler, features=["latitude", "longitude", "altitude", "timedelta"])
    srv = make_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
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
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "server thread did not stop")


def device_events(torch, fn, ops=None):
    """Run fn under torch.profiler (CUPTI): profiled wall ms and the device
    events as (name, duration us). With ``ops`` (a list), also append the
    convolution ops as (device ms, calls, input shapes), largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=ops is not None) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    events = [(e.name, e.time_range.end - e.time_range.start) for e in prof.events()
              if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    if ops is not None:
        for e in prof.key_averages(group_by_input_shape=True):
            if e.key in CONV_OPS:
                ops.append((e.device_time_total / 1e3, e.count, e.key, e.input_shapes[:3]))
        ops.sort(key=lambda o: -o[0])
    return prof_ms, events


def print_profile(label, fn, wall_ms, n_convs=6):
    """Device busy time, idle share against ``wall_ms`` (the unprofiled time
    of the same work: the profiler slows the host), the top device kernels
    and the top convolutions by shape, of one call of ``fn``."""
    import torch

    convs = []
    prof_ms, events = device_events(torch, fn, convs)
    if not events:
        print(f"[profile] {label}: the profiler saw no device time: not measured", flush=True)
        return
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
        for ms, n, _, shapes in [c for c in convs if c[2] == key][:n_convs]:
            print(f"[profile]   conv {ms:8.3f} ms  x{n:<3d} {key[6:]} {shapes}", flush=True)


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
        self.losses, self.events, self.val = [], [], []

    def log_metrics(self, metrics, step):
        if "train/loss" in metrics:
            self.losses.append(metrics["train/loss"])
            self.events.append(self.torch.cuda.Event(enable_timing=True))
            self.events[-1].record()
        else:
            self.val.append((step, metrics))


def train_phase(torch, vq_kernel):
    """``train_stage1`` at the published width, counted; -> (state, data,
    steady ms per step, VQ kernel launches)."""
    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.data import get_data, make_synthetic_trajectories, save_npz
    from tvqvae_tpu_torch.train.runner import train_stage1

    cfg = Config()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trajectories.npz")
        save_npz(path, *make_synthetic_trajectories(n=TRAIN_SERIES, channels=C, length=L, seed=7))
        data = get_data(path, cfg.dataset.features)
    rec = StepRecorder(torch)
    torch.cuda.reset_peak_memory_stats()
    vq_kernel.launch_count = 0
    t0 = time.perf_counter()
    state = train_stage1(cfg, data, max_steps=TRAIN_STEPS, device="cuda", logger=rec,
                         log_interval=1)
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
          f"{len(data.X_train)} train / {n_test} test series: {TRAIN_STEPS} steps in {wall:.1f} s (with init, upload and validation); "
          f"steady {ms:.2f} ms/step = {1e3 / ms:.3f} steps/s (CUDA events, steps "
          f"{warm + 2}-{TRAIN_STEPS}); peak memory {peak_gb:.2f} GiB", flush=True)
    print(f"[train] loss step 1 {losses[0]:.4f}, step {TRAIN_STEPS} {losses[-1]:.4f}; mean of "
          f"steps {warm + 1}-{warm + 5} {first:.4f}, of the last 5 {last:.4f}; val loss "
          f"{val['val/loss']:.4f} at step {rec.val[-1][0]}; VQ kernel launches {launches} "
          f"(2 per step, 2 per validation batch: {len(rec.val)} x {val_batches})", flush=True)
    return state, data, ms, launches


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


def train_profile(torch, state, data, step_ms):
    """One more training step of the trained state, under the profiler."""
    from tvqvae_tpu_torch.train.stage1 import make_stage1_train_step

    step = make_stage1_train_step()
    x = torch.from_numpy(data.X_train[:B]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(11)
    step(state, x, gen)
    print_profile(f"train step of {B}", lambda: step(state, x, gen), step_ms)


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


def small_train_check(torch, devices=("cpu", "cuda"), steps=3):
    """Three training steps of the same seeded small model (dropout 0) on the
    CPU (plain VQ) and on the card (kernel): indices equal at every step,
    losses within 1e-4 relative, codebooks and BatchNorm variances within
    1e-4, parameters within 1e-4; the biases whose gradient a BatchNorm
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
    schedule = warmup_cosine_schedule(cfg.exp_params.lr, TRAIN_STEPS)
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
    cb_err = max(float((getattr(getattr(ref, band), f) - getattr(getattr(dut, band), f).cpu())
                       .abs().max())
                 for band in ("vq_l", "vq_h") for f in ("embed", "embed_avg", "cluster_size"))
    check(cb_err <= 1e-4, f"small model training: codebooks off by {cb_err}")
    noise = 2 * sum(schedule(t) for t in range(steps))
    cancelled = biases_cancelled_by_batchnorm(ref.model)
    worst = {"tight": 0.0, "cancelled": 0.0}
    for k, a in ref.model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        err = float((a - dut.model.state_dict()[k].cpu()).abs().max())
        loose = k in cancelled or k.endswith("running_mean")
        check(err <= 1e-4 + (noise if loose else 0.0), f"small model training: {k} off by {err}")
        kind = "cancelled" if loose else "tight"
        worst[kind] = max(worst[kind], err)
    print(f"[reference] small model training, {steps} steps, card vs CPU: indices equal, losses "
          f"{dut_loss} vs {ref_loss}, rel err {loss_err:.3g}, codebooks {cb_err:.3g}, parameters and BN variances "
          f"{worst['tight']:.3g}, BN-cancelled biases and running means {worst['cancelled']:.3g} "
          f"(bound {1e-4 + noise:.3g})", flush=True)


def published_width_check(torch, Config, TrainedModelSampler, sampler, series):
    """Two series at the published width through the card's encoders (with
    the VQ kernel) and the same seeded model on the CPU: latents within 1e-4
    of their scale, and the card's tokens decoded on both devices within
    1e-4 of the output's scale."""
    from tvqvae_tpu_torch.models.maskgit import decode_tokens, encode_tokens

    cpu = TrainedModelSampler.from_init(Config(), L, C, N_CLASSES, seed=0, device="cpu",
                                        batch_size=B)
    x = torch.from_numpy(series[:2])
    with torch.inference_mode():
        for band in ("lf", "hf"):
            z_dev = sampler.frozen.model.encode(x.cuda(), band).cpu()
            z_cpu = cpu.frozen.model.encode(x, band)
            z_err = float((z_dev - z_cpu).abs().max() / z_cpu.abs().max())
            s_dev = encode_tokens(sampler.frozen, x.cuda(), band)
            s_cpu = encode_tokens(cpu.frozen, x, band)
            flips = int((s_dev.cpu() != s_cpu).sum())
            y_dev = decode_tokens(sampler.frozen, s_dev, band).cpu()
            y_cpu = decode_tokens(cpu.frozen, s_dev.cpu(), band)
            y_err = float((y_dev - y_cpu).abs().max() / y_cpu.abs().max())
            print(f"[reference] published width {band}: card vs CPU latents rel err "
                  f"{z_err:.3g}, decode rel err {y_err:.3g}, token flips {flips} of "
                  f"{s_cpu.numel()}", flush=True)
            check(z_err <= 1e-4 and y_err <= 1e-4,
                  f"published width {band}: card vs CPU off by {z_err}, {y_err}")


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
    noise = {}
    for band, T, tok, K in (("l", spec.T_l, spec.tokens_l, spec.mask_token_l),
                            ("h", spec.T_h, spec.tokens_h, spec.mask_token_h)):
        noise[band] = tuple(torch.from_numpy(
            -np.log(-np.log(rng.uniform(1e-12, 1.0, size)))).float()
            for size in ((T, n, tok, K), (T, n, tok)))
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from tvqvae_tpu_torch.config import Config
    from tvqvae_tpu_torch.generation import TrainedModelSampler
    from tvqvae_tpu_torch.models.maskgit import encode_tokens
    from tvqvae_tpu_torch.models.vq import lookup_codes
    from tvqvae_tpu_torch.ops import vq_kernel

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}",
          flush=True)

    t0 = time.perf_counter()
    vq_kernel.build(verbose=True)
    print(f"[build] vq_nearest.cu in {time.perf_counter() - t0:.1f} s", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = kernel_phase(torch, vq_kernel)

    t0 = time.perf_counter()
    sampler = TrainedModelSampler.from_init(Config(), L, C, N_CLASSES, seed=0, device="cuda",
                                            batch_size=B)
    print(f"[sampler] published width built in {time.perf_counter() - t0:.1f} s: "
          f"tokens {sampler.s1_spec.tokens_l}/{sampler.s1_spec.tokens_h}", flush=True)
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

    # ---- training, counted on its own ---------------------------------
    trained, data, step_ms, train_launches = train_phase(torch, vq_kernel)

    # ---- checks after the counted run ---------------------------------
    with torch.inference_mode():
        for start in range(0, series.shape[0], B):
            xb = torch.from_numpy(series[start:start + B]).cuda()
            plain = []
            for band, state in (("lf", sampler.frozen.vq_l), ("hf", sampler.frozen.vq_h)):
                z = sampler.frozen.model.encode(xb, band)
                idx_p = vq_kernel.nearest_codes_stats_plain(z.reshape(-1, z.shape[-1]).contiguous(),
                                                            state.embed)[0].reshape(z.shape[:2])
                check(torch.equal(encode_tokens(sampler.frozen, xb, band), idx_p),
                      f"reconstruct {band} tokens differ from the plain VQ version")
                plain.append(sampler.frozen.model.decode(lookup_codes(state, idx_p), band))
            err = float((plain[0] + plain[1]).cpu().sub(torch.from_numpy(
                rec[start:start + B])).abs().max())
            check(err <= 1e-4, f"reconstruct differs from the plain VQ path by {err}")
    print("[reconstruct] tokens equal to the plain VQ version on the card", flush=True)
    small_model_check(torch, Config, TrainedModelSampler)
    small_train_check(torch)
    published_train_twin_check(torch, trained, data)
    published_width_check(torch, Config, TrainedModelSampler, sampler, series)
    profile_phase(torch, sampler, series, wall_ms)
    train_profile(torch, trained, data, step_ms)

    main_numbers = kernels[MAIN_SHAPE]
    entry = {
        "name": "vq_nearest_stats",
        "route": "cuda",
        "source": "tvqvae_tpu_torch/csrc/vq_nearest.cu",
        "replaces": "tvqvae_tpu/ops/vq_pallas.py:36",
        "launches": serve_launches + train_launches,
        "launches_by_path": {"serve": serve_launches, "train": train_launches},
        "max_abs_err": max(r["max_abs_err"] for r in kernels.values()),
        "ms": main_numbers["ms"],
        "plain_ms": main_numbers["plain_ms"],
        "bound_ms": main_numbers["bound_ms"],
        "bound_by": main_numbers["bound_by"],
        "library_ms": main_numbers["library_ms"],
        "device_ms": main_numbers["device_ms"],
        "shape_MKD": list(MAIN_SHAPE),
    }
    print(json.dumps({"kernels": [entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
