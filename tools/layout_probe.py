"""The loaded stage 1's weight layout in the sweeps stages 2-3 train on.

Stages 2-3 load stage 1 from its checkpoint through ``utils/convert.py``,
whose ``_tensor`` copies each kernel in C order. Without ``order="C"`` (as
the loader once copied) a kernel transposed from flax's axes keeps the
permuted strides of the transpose, ``load_state_dict(assign=True)`` hands
them to the modules, and cuDNN may convolve with other kernels. This probe
builds one seeded stage 1 at the quality run's widths
(``scripts/quality_run.py``'s ``CFG_OVERRIDES`` over its ``DATA``
geometry), writes it with ``utils/checkpoint.py`` and loads it back both
ways, and on ``--n`` of the quality run's synthetic series prints, for
each band:

- the weights the old copy leaves non-contiguous;
- each layout's encoder latents (float32, TF32 off, as the token sweep
  runs) against a float64 witness: the contiguous model in float64 on the
  same device, the same input;
- the latents' largest gap between the layouts, and the tokens they give
  that differ (nearest codes in float64 of each layout's float32 latent);
- each layout's decoder output from the float64 witness's tokens, against
  the witness's (the stage-3 x' sweep decodes the tokens it encodes);
- the device kernels each layout's encoder and decoder launch that the
  other's do not (``torch.profiler``).

The weights and codebooks are random (``init_stage1``), not trained: the
kernels cuDNN picks depend on shapes and strides only, and the errors are
those of these weights.

    python tools/layout_probe.py [--device cuda] [--n 256] [--seed 0] [--out FILE]
"""

import argparse
import contextlib
import json
import os
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

from tvqvae_tpu_torch.config import Config  # noqa: E402
from tvqvae_tpu_torch.data import make_synthetic_trajectories  # noqa: E402
from tvqvae_tpu_torch.models.maskgit import FrozenStage1  # noqa: E402
from tvqvae_tpu_torch.models.stage1 import Stage1Spec, init_stage1  # noqa: E402
from tvqvae_tpu_torch.scripts.quality_run import CFG_OVERRIDES, DATA  # noqa: E402
from tvqvae_tpu_torch.utils import convert  # noqa: E402
from tvqvae_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from tvqvae_tpu_torch.utils.device import resolve_device  # noqa: E402

BATCH = 64  # the token sweep's batch (train/stage2.py::precompute_token_dataset)


def _tensor_any_order(arr):
    """``convert._tensor`` without ``order="C"``: the copy keeps ``arr``'s
    memory order."""
    return torch.from_numpy(np.array(arr, dtype=np.bool_ if arr.dtype == np.bool_ else np.float32))


@contextlib.contextmanager
def any_order_copies():
    saved = convert._tensor
    convert._tensor = _tensor_any_order
    try:
        yield
    finally:
        convert._tensor = saved


def nearest(z, embed):
    """(B, N, D) latents, (K, D) codes -> (B, N) nearest codes in float64."""
    z, e = z.double(), embed.double()
    d = 2.0 * z @ e.T - (z * z).sum(-1, keepdim=True) - (e * e).sum(-1)
    return d.argmax(-1)


def launched_kernels(fn, device):
    """{device kernel name: launches} of one call of ``fn``."""
    if device.type != "cuda":
        return {}
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def probe(device="cuda", n=256, seed=0):
    dev = resolve_device(device)  # float32 with TF32 off, as the sweeps run
    cfg = Config.from_dict(CFG_OVERRIDES)
    spec = Stage1Spec.from_config(cfg, DATA["length"], DATA["channels"])
    model, vq_l, vq_h = init_stage1(spec, torch.Generator().manual_seed(seed), device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stage1.npz")
        save_checkpoint(path, convert.stage1_to_jax(model, vq_l, vq_h))
        tree, _ = load_checkpoint(path)
    sd_c = convert.stage1_from_jax(tree)
    with any_order_copies():
        sd_k = convert.stage1_from_jax(tree)
    permuted = sorted(k for k, v in sd_k.items() if not v.is_contiguous())
    layouts = {"contiguous": FrozenStage1.from_state_dict(spec, sd_c, dev),
               "permuted": FrozenStage1.from_state_dict(spec, sd_k, dev)}
    witness = FrozenStage1.from_state_dict(spec, {k: v.double() for k, v in sd_c.items()}, dev)
    X, _ = make_synthetic_trajectories(**DATA)
    X = torch.from_numpy(np.ascontiguousarray(X[:n], dtype=np.float32)).to(dev)
    encoder = [k for k in permuted if k.startswith("encoder")]
    print(json.dumps({"device": str(dev), "n": n, "seed": seed, "weights": len(sd_k),
                      "permuted_weights": len(permuted), "permuted_encoder_weights": encoder}),
          flush=True)
    results = []
    for band in ("lf", "hf"):
        embed = (witness.vq_l if band == "lf" else witness.vq_h).embed
        with torch.inference_mode():
            z64 = torch.cat([witness.model.encode(X[i:i + BATCH].double(), band)
                             for i in range(0, n, BATCH)])
            z = {name: torch.cat([f.model.encode(X[i:i + BATCH], band)
                                  for i in range(0, n, BATCH)])
                 for name, f in layouts.items()}
            again = torch.cat([layouts["contiguous"].model.encode(X[i:i + BATCH], band)
                               for i in range(0, n, BATCH)])
            tok64 = nearest(z64, embed)
            zq = embed[tok64[:BATCH]]
            x64 = witness.model.decode(zq, band)
            xs = {name: f.model.decode(zq.float(), band) for name, f in layouts.items()}
            names = {name: launched_kernels(
                lambda m=f.model: m.decode(m.encode(X[:BATCH], band), band), dev)
                for name, f in layouts.items()}
        scale = z64.abs().max().item()
        tok = {name: nearest(v, embed) for name, v in z.items()}
        row = {
            "band": band, "latent_shape": list(z64.shape), "latent_absmax_f64": scale,
            "contiguous_repeat_equal": bool(torch.equal(again, z["contiguous"])),
            "layouts_equal": bool(torch.equal(z["contiguous"], z["permuted"])),
            "layouts_max_abs_gap": (z["contiguous"] - z["permuted"]).abs().max().item(),
            "tokens": tok64.numel(),
            "tokens_differ_between_layouts": int((tok["contiguous"] != tok["permuted"]).sum()),
        }
        for name, v in z.items():
            err = (v.double() - z64).abs()
            row[f"{name}_vs_f64_max_abs"] = err.max().item()
            row[f"{name}_vs_f64_mean_abs"] = err.mean().item()
            row[f"{name}_tokens_off_f64"] = int((tok[name] != tok64).sum())
            row[f"{name}_decode_vs_f64_max_abs"] = (xs[name].double() - x64).abs().max().item()
        row["decode_layouts_equal"] = bool(torch.equal(xs["contiguous"], xs["permuted"]))
        a, b = names["contiguous"], names["permuted"]
        row["kernels_only_contiguous"] = {k: a[k] for k in sorted(set(a) - set(b))}
        row["kernels_only_permuted"] = {k: b[k] for k in sorted(set(b) - set(a))}
        row["kernels_shared"] = len(set(a) & set(b))
        print(json.dumps(row), flush=True)
        results.append(row)
    return {"permuted_weights": permuted, "bands": results}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=256, help="series encoded (the quality run's first n)")
    ap.add_argument("--seed", type=int, default=0, help="the random stage 1's seed")
    ap.add_argument("--out", default=None, help="also write the result as JSON here")
    args = ap.parse_args(argv)
    out = probe(args.device, args.n, args.seed)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
