"""FCN classifier training CLI: the FID/IS feature network.

Port of ``tvqvae_tpu/scripts/train_fcn.py``, with its flags:

    python -m tvqvae_tpu_torch.scripts.train_fcn --dataset_file data.npz \
        [--config fcn_config.yaml] [--max_steps 1000] [--device cuda]

The reference caps Lightning at ``max_steps=max_epochs``, so ``--max_steps``
counts optimizer steps (1000 by default). A config file (reference
``fcn_config`` schema, YAML or ``.json``) overrides the features,
``exp_params.LR``, ``exp_params.weight_decay`` and ``dataset.batch_size``.
The checkpoint lands in ``<model_save_dir>/<dataset stem>/fcn``.
"""

import argparse
import os
from pathlib import Path

from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.data import get_data
from tvqvae_tpu_torch.scripts._cli import load_config_dict
from tvqvae_tpu_torch.train import runner
from tvqvae_tpu_torch.utils.logging import RunLogger


def build_argparser():
    p = argparse.ArgumentParser(description="Train the supervised FCN (PyTorch port)")
    p.add_argument("--config", type=str, default=None,
                   help="fcn_config in the reference schema, YAML or .json")
    p.add_argument("--dataset_file", type=str, required=True)
    p.add_argument("--model_save_dir", type=str, default="saved_models")
    p.add_argument("--run_dir", type=str, default="runs")
    p.add_argument("--max_steps", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=1e-5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    cfg = Config()
    features = cfg.dataset.features
    lr, wd, bs = args.lr, args.weight_decay, args.batch_size
    if args.config:
        raw = load_config_dict(args.config)
        features = raw.get("dataset", {}).get("features", features)
        exp = raw.get("exp_params", {})
        lr = float(exp.get("LR", lr))
        wd = float(exp.get("weight_decay", wd))
        bs = int(raw.get("dataset", {}).get("batch_size", bs))

    data = get_data(args.dataset_file, features)
    stem = Path(args.dataset_file).stem
    save_path = os.path.join(args.model_save_dir, stem, "fcn")
    log = RunLogger(os.path.join(args.run_dir, f"{stem}_fcn"),
                    run_name=f"{stem}_fcn", mlflow_uri=cfg.logger.mlflow_uri)
    try:
        runner.train_fcn(cfg, data, logger=log, max_epochs=args.max_steps, batch_size=bs, lr=lr,
                         weight_decay=wd, seed=args.seed, device=args.device,
                         save_path=save_path)
    finally:
        log.close()
    print(f"fcn checkpoint at {save_path}")


if __name__ == "__main__":
    main()
