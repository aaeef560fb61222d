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
  4-6. the main path, with every launch counter set to 0 first: the sampler
     at the published width (B=32, C=4, L=4633, hid_dim 128, codebooks
     32/32, priors 128x4Lx2H and 32x1Lx1H, 5 classes, seeded random
     weights), ``reconstruct`` of 64 series (two launches of the VQ kernel
     per batch), and the HTTP server answering three requests.
  7. checks after the counted run: the reconstruct tokens against the plain
     VQ version; a small model on the card against the same model on the
     CPU (plain versions) with the same weights and noise; and two series
     at the published width through the card and the CPU.
  8. profile: device time by kernel and the device's idle share over one
     sample batch and one reconstruct batch (torch.profiler).

The last lines are a JSON list of the kernels with their numbers, the card's
``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero before that line.
"""

import json
import re
import subprocess
import sys
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
    events = [(e.name, e.time_range.end - e.time_range.start)
              for e in prof.events() if e.device_type == DeviceType.CUDA]
    if ops is not None:
        for e in prof.key_averages(group_by_input_shape=True):
            if e.key in ("aten::cudnn_convolution", "aten::cudnn_convolution_transpose"):
                ops.append((e.device_time_total / 1e3, e.count, e.key, e.input_shapes[:2]))
        ops.sort(key=lambda o: -o[0])
    return prof_ms, events


def profile_phase(torch, sampler, series, wall_ms):
    """Where a sampler batch and a reconstruct batch spend device time. The
    idle share is taken against the unprofiled wall time per batch
    (``wall_ms``), since the profiler slows the host."""
    for label, fn in (("sample", lambda: sampler.sample(B, seed=5)),
                      ("reconstruct", lambda: sampler.reconstruct(series[:B]))):
        convs = []
        prof_ms, events = device_events(torch, fn, convs)
        if not events:
            print(f"[profile] {label}: the profiler saw no device time: not measured", flush=True)
            continue
        busy_ms = sum(d for _, d in events) / 1e3
        by_name = {}
        for name, d in events:
            n, t = by_name.get(name, (0, 0.0))
            by_name[name] = (n + 1, t + d)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
        print(f"[profile] {label} of {B}: device busy {busy_ms:.2f} ms over {len(events)} "
              f"device events; unprofiled wall {wall_ms[label]:.2f} ms, idle share "
              f"{max(0.0, 1 - busy_ms / wall_ms[label]):.3f}; profiled wall {prof_ms:.2f} ms",
              flush=True)
        for name, (n, t) in top:
            print(f"[profile]   {t / 1e3:8.3f} ms  x{n:<4d} {name[:90]}", flush=True)
        for ms, n, key, shapes in convs[:6]:
            print(f"[profile]   conv {ms:8.3f} ms  x{n:<3d} {key[6:]} {shapes}", flush=True)


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
    launches = vq_kernel.launch_count
    check(launches > 0, "the main path never launched the VQ kernel")

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
    published_width_check(torch, Config, TrainedModelSampler, sampler, series)
    profile_phase(torch, sampler, series, wall_ms)

    main_numbers = kernels[MAIN_SHAPE]
    entry = {
        "name": "vq_nearest_stats",
        "route": "cuda",
        "source": "tvqvae_tpu_torch/csrc/vq_nearest.cu",
        "replaces": "tvqvae_tpu/ops/vq_pallas.py:36",
        "launches": launches,
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
