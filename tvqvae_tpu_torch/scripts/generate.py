"""Generate CLI: sample synthetic trajectories from trained checkpoints.

Port of ``tvqvae_tpu/scripts/generate.py``, with its flags:

    python -m tvqvae_tpu_torch.scripts.generate --dataset_file data.npz \
        [--model_save_dir saved_models] [--n_samples N] [--device cuda] \
        [--bf16] [--no-fast_bn]

Per-class conditional sampling matched to the real class distribution, the
inverse min-max transform, timedelta[0] := 0 and altitude clipped at >= 0
(``serving.postprocess_generated``), written as ``synthetic.npz`` (X in
original units, y); a reference-compatible Traffic pickle beside it where
``pandas`` and ``traffic`` import. It runs twice, as the reference does:
raw into ``--synthetic_save_dir`` and, when ``stage3`` exists, through the
fidelity enhancer into ``--synthetic_fidelity_dir`` (``synthetic_fe.npz``);
one sampler serves both passes, so the checkpoints are read once.
"""

import argparse
import os
from pathlib import Path

import numpy as np

from tvqvae_tpu_torch.data import get_data
from tvqvae_tpu_torch.generation import TrainedModelSampler
from tvqvae_tpu_torch.scripts._cli import load_config
from tvqvae_tpu_torch.serving import postprocess_generated


def export_traffic_pickle(path: str, X: np.ndarray, y: np.ndarray, features):
    """Write a reference-compatible traffic.Traffic pickle (synthetic
    timestamps from the timedelta channel). -> False, with a note, where
    ``pandas`` or ``traffic`` is missing."""
    try:
        import pandas as pd
        from traffic.core import Traffic
    except ImportError:
        print("[generate] `traffic` not installed; skipped Traffic pickle")
        return False
    frames = []
    t0 = pd.Timestamp("2020-01-01", tz="utc")
    td_idx = features.index("timedelta") if "timedelta" in features else None
    for i in range(X.shape[0]):
        df = pd.DataFrame({f: X[i, j] for j, f in enumerate(features)})
        if td_idx is not None:
            df["timestamp"] = t0 + pd.to_timedelta(np.cumsum(X[i, td_idx]), unit="s")
        else:
            df["timestamp"] = t0 + pd.to_timedelta(np.arange(X.shape[-1]), unit="s")
        df["flight_id"] = f"synthetic_{i}"
        df["callsign"] = f"SYN{i:05d}"
        df["icao24"] = f"{i:06x}"
        df["cluster"] = int(y[i])
        frames.append(df)
    Traffic(pd.concat(frames)).to_pickle(path)
    return True


def generate_synthetic_data(cfg, sampler, data, n_samples, save_dir, features, seed=0, tag=""):
    os.makedirs(save_dir, exist_ok=True)
    # per-class counts matched to the real class distribution
    counts = np.bincount(np.concatenate([data.y_train[:, 0], data.y_test[:, 0]]),
                         minlength=data.n_classes)
    total = counts.sum()
    Xs, ys = [], []
    for cls in range(data.n_classes):
        n_cls = int(round(n_samples * counts[cls] / max(total, 1)))
        if n_cls == 0:
            continue
        _, _, x = sampler.sample(n_cls, "conditional", class_index=cls, seed=seed + cls)
        Xs.append(x)
        ys.append(np.full(n_cls, cls, np.int64))
    X = np.concatenate(Xs)
    y = np.concatenate(ys)
    X = postprocess_generated(X, data.scaler, features)

    npz_path = os.path.join(save_dir, f"synthetic{tag}.npz")
    np.savez_compressed(npz_path, X=X.astype(np.float32), y=y)
    export_traffic_pickle(os.path.join(save_dir, f"synthetic{tag}.pkl"), X, y, features)
    print(f"[generate] wrote {X.shape[0]} trajectories -> {npz_path}")
    return X, y


def build_argparser():
    p = argparse.ArgumentParser(description="Generate synthetic trajectories (PyTorch port)")
    p.add_argument("--config", type=str, default=None,
                   help="config in the reference schema, YAML or .json; defaults built in")
    p.add_argument("--dataset_file", type=str, required=True)
    p.add_argument("--model_save_dir", type=str, default="saved_models")
    p.add_argument("--synthetic_save_dir", type=str, default="synthetic_data")
    p.add_argument("--synthetic_fidelity_dir", type=str, default="synthetic_data_fidelity")
    p.add_argument("--n_samples", type=int, default=None,
                   help="default: size of the real dataset")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--bf16", action="store_true",
                   help="the frozen stage-1 stacks and the enhancer in bfloat16, with the "
                        "TimeHead and the iSTFT (the JAX sampler's defaults under bf16)")
    p.add_argument("--fast_bn", action=argparse.BooleanOptionalAction, default=True,
                   help="BatchNorm/GroupNorm normalisation in the compute dtype "
                        "(--no-fast_bn: flax's float32 promotion)")
    return p


def main(argv=None):
    p = build_argparser()
    args = p.parse_args(argv)
    cfg = load_config(args.config)
    data = get_data(args.dataset_file, cfg.dataset.features, scale=cfg.dataset.data_scaling)
    ckpt = os.path.join(args.model_save_dir, Path(args.dataset_file).stem)
    n = args.n_samples or (len(data.X_train) + len(data.X_test))
    stage3 = os.path.join(ckpt, "stage3")
    has_fe = os.path.exists(stage3)

    # twice, as the reference does: raw, then through the fidelity enhancer
    # (one sampler, read from disk once, with its enhancer off and then on)
    sampler = TrainedModelSampler.from_checkpoints(
        cfg, os.path.join(ckpt, "stage1"), os.path.join(ckpt, "stage2"),
        stage3 if has_fe else None, batch_size=args.batch_size, device=args.device,
        compute_dtype="bfloat16" if args.bf16 else "float32", fast_bn=args.fast_bn)
    generate_synthetic_data(cfg, sampler, data, n, args.synthetic_save_dir,
                            cfg.dataset.features, seed=args.seed)
    if has_fe:
        sampler.use_fe = True
        generate_synthetic_data(cfg, sampler, data, n, args.synthetic_fidelity_dir,
                                cfg.dataset.features, seed=args.seed, tag="_fe")
    else:
        print("[generate] no stage3 checkpoint; skipped FE output")


if __name__ == "__main__":
    main()
