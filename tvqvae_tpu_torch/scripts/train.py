"""Train CLI: chains stage 1 -> stage 2 -> stage 3, or trains the FCN.

Port of ``tvqvae_tpu/scripts/train.py``, with its flags:

    python -m tvqvae_tpu_torch.scripts.train --dataset_file data.npz \
        [--config cfg.json] [--stage {all,1,2,3,fcn}] [--model_save_dir DIR] \
        [--max_steps N] [--device cuda]

Checkpoints land in ``<model_save_dir>/<dataset stem>/stage{1,2,3}`` and
``fcn`` (``utils/checkpoint.py``: an ``.npz`` at exactly that path and its
``.meta.json``); stages 2 and 3 read stage 1 back from disk. Metrics go to
a JSONL run directory (and MLflow when configured). A stage whose checkpoint
records its budget is skipped, and an interrupted one resumes from its
snapshot. ``--config`` takes the reference YAML schema, or the same schema as
``.json`` where PyYAML is missing.

Stages 2 and 3 score samples at each validation with an
``evaluation.Metrics`` over the data (``evaluation.feature_extractor_type``;
the supervised FCN needs ``fcn`` on disk and falls back to ROCKET without
it) unless ``--no_val_metrics``; ``--search_tau`` picks stage 3's SVQ
temperature by FID first (``generation.search_optimal_tau``).

The JAX flags all parse, with the JAX CLI's defaults but one: the
production recipe's ``--fast_bn --bf16_mu --bf16_head`` on, ``--bf16``,
``--bf16_nu``, ``--bf16_istft`` and ``--remat`` off, passed to the runners as
the JAX CLI passes them (stage 3 gets ``fast_norm=--fast_bn``);
``--host_data`` feeds stage 1 per-step host batches (``data_on_device=False``)
and ``--no_precompute`` runs the frozen stage 1 inside every step of stages 2
and 3 (``precompute=False``). ``--bundle_steps`` (default 10, as in JAX)
trains stage 1, stage 2 on precomputed tokens and stage 3 on a precomputed
x' in bundles of that many steps: on the card each stage's step is captured
once as a CUDA graph and replayed a bundle at a time, on the CPU a bundle is
the same steps in a loop; the steps are the single steps, the logged train
metrics the bundle's means (``train/multistep.py``). ``--rbg_rng`` reaches
stage 1 as ``rng_impl="rbg"``, as in JAX: the port's dropout masks come
from torch's generator either way (on the card Philox4x32-10, a
counter-based generator as XLA's rbg is), so the flag changes nothing.

Data-parallel training: run this CLI in every rank of a ``torch.distributed``
process group that the launching code initialised (the JAX CLI has no
launcher flag either; ``train/runner.py`` says what the ranks share). The
primary rank logs; every rank trains its slice of each global batch. With
``--tp N`` the W ranks train stages 1-3 as a (W / N, N) grid, the big
parameters and their AdamW moments split over N ranks (``parallel/tp.py``);
a world that N does not divide is an error.
"""

import argparse
import os
from pathlib import Path

from tvqvae_tpu_torch.data import get_data
from tvqvae_tpu_torch.evaluation import Metrics
from tvqvae_tpu_torch.generation import TrainedModelSampler, search_optimal_tau
from tvqvae_tpu_torch.parallel import is_primary, process_count
from tvqvae_tpu_torch.scripts._cli import load_config
from tvqvae_tpu_torch.train import runner
from tvqvae_tpu_torch.utils.checkpoint import load_checkpoint
from tvqvae_tpu_torch.utils.logging import RunLogger


def build_argparser():
    p = argparse.ArgumentParser(description="Train the TimeVQVAE stages (PyTorch port)")
    p.add_argument("--config", type=str, default=None,
                   help="config in the reference schema, YAML or .json; defaults built in")
    p.add_argument("--dataset_file", type=str, required=True,
                   help=".npz (X, y), or a pickled traffic.Traffic where traffic is installed")
    p.add_argument("--stage", type=str, default="all", choices=["all", "1", "2", "3", "fcn"])
    p.add_argument("--model_save_dir", type=str, default="saved_models")
    p.add_argument("--run_dir", type=str, default="runs")
    p.add_argument("--max_steps", type=int, default=None,
                   help="override the per-stage step budget (stages 1-3)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no_val_metrics", action="store_true",
                   help="skip validation-time sampling metrics in stages 2/3")
    p.add_argument("--search_tau", action="store_true",
                   help="FID-search the SVQ temperature before stage 3 (default tau=0)")
    p.add_argument("--use_pallas", action="store_true",
                   help="accepted for the JAX command line: on the card the port always "
                        "runs its CUDA VQ kernel")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute in the stage-1 conv stacks and the stage-3 U-Net "
                        "stream (parameters, norm statistics, VQ, losses, attention float32)")
    p.add_argument("--remat", action="store_true",
                   help="stage 1: recompute each conv block in the backward (less memory)")
    p.add_argument("--fast_bn", action=argparse.BooleanOptionalAction, default=True,
                   help="BatchNorm (stage 1) and GroupNorm (stage 3) normalisation in the "
                        "compute dtype over float32 statistics")
    p.add_argument("--bf16_mu", action=argparse.BooleanOptionalAction, default=True,
                   help="store AdamW's first moment in bfloat16 (the update stays float32)")
    p.add_argument("--bf16_nu", action=argparse.BooleanOptionalAction, default=False,
                   help="store AdamW's second moment in bfloat16")
    p.add_argument("--bf16_head", action=argparse.BooleanOptionalAction, default=True,
                   help="stage 1: the TimeHead dense in the compute dtype (residual float32)")
    p.add_argument("--bf16_istft", action=argparse.BooleanOptionalAction, default=False,
                   help="stage 1: the decode path's iSTFT in the compute dtype")
    p.add_argument("--no_precompute", action="store_true",
                   help="stages 2/3: run the frozen stage 1 inside every step instead of "
                        "the one-sweep precompute (the reference behaviour)")
    p.add_argument("--host_data", action="store_true",
                   help="stage 1: per-step host batches instead of the device-resident gather")
    p.add_argument("--bundle_steps", type=int, default=10,
                   help="optimizer steps per host dispatch (stage 1, stage 2 on precomputed "
                        "tokens, stage 3 on a precomputed x'): on the card one captured CUDA "
                        "graph of the step replayed that many times, on the CPU a loop of the "
                        "same steps; the same steps as bundles of 1, train metrics logged as "
                        "bundle means")
    p.add_argument("--rbg_rng", action="store_true",
                   help="stage 1: JAX's counter-based (rbg) generator for the dropout masks; "
                        "the port's masks come from torch's generator, on the card "
                        "Philox4x32-10 (counter-based), either way")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel width: train over a 2-D (data, model) grid of the "
                        "ranks with the big parameter leaves and AdamW moments sharded over "
                        "`model` (parallel/tp.py), for when per-card memory, not batch math, "
                        "is the constraint. Requires world size %% tp == 0")
    return p


def search_tau(cfg, data, paths, device) -> float:
    """``search_optimal_tau`` over the trained stages 1-2 with ROCKET
    features, ``min_num_gen_samples`` samples against the train split, as
    the JAX CLI runs it."""
    sampler = TrainedModelSampler.from_checkpoints(cfg, paths["1"], paths["2"],
                                                   batch_size=cfg.evaluation.batch_size,
                                                   device=device)
    metrics = Metrics(data.input_length, data.in_channels, data.n_classes,
                      cfg.evaluation.batch_size, data.X_train, data.X_test,
                      feature_extractor_type="rocket", device=device)
    return search_optimal_tau(cfg, sampler, metrics, data.X_train,
                              n_samples=cfg.evaluation.min_num_gen_samples)


def main(argv=None):
    p = build_argparser()
    args = p.parse_args(argv)
    if args.tp > 1 and process_count() % args.tp:
        p.error(f"{process_count()} devices not divisible by tp={args.tp}")
    dtype = "bfloat16" if args.bf16 else "float32"
    moments = dict(bf16_mu=args.bf16_mu, bf16_nu=args.bf16_nu)
    cfg = load_config(args.config)
    data = get_data(args.dataset_file, cfg.dataset.features, scale=cfg.dataset.data_scaling)
    stem = Path(args.dataset_file).stem
    ckpt_dir = os.path.join(args.model_save_dir, stem)
    os.makedirs(ckpt_dir, exist_ok=True)
    paths = {s: os.path.join(ckpt_dir, f"stage{s}") for s in ("1", "2", "3")}
    paths["fcn"] = os.path.join(ckpt_dir, "fcn")

    def logger(stage):
        if not is_primary():
            return None
        return RunLogger(
            os.path.join(args.run_dir, f"{stem}_{stage}"),
            experiment_name=cfg.logger.experiment_name,
            run_name=f"{stem}_{stage}",
            mlflow_uri=cfg.logger.mlflow_uri,
        )

    stages = ["1", "2", "3"] if args.stage == "all" else [args.stage]
    val_metrics = None
    # the primary rank alone scores validations
    if is_primary() and not args.no_val_metrics and any(s in ("2", "3") for s in stages):
        # the configured featuriser; the supervised FCN needs a trained fcn
        # checkpoint and falls back to ROCKET without one
        fx = cfg.evaluation.feature_extractor_type
        fcn_vars = None
        if fx == "supervised_fcn":
            if os.path.exists(paths["fcn"]):
                fcn_vars = load_checkpoint(paths["fcn"])[0]
            else:
                print("[train] no fcn checkpoint; val metrics use rocket")
                fx = "rocket"
        val_metrics = Metrics(data.input_length, data.in_channels, data.n_classes,
                              cfg.evaluation.batch_size, data.X_train, data.X_test,
                              feature_extractor_type=fx, fcn_variables=fcn_vars,
                              device=args.device)
    common = dict(max_steps=args.max_steps, seed=args.seed, device=args.device,
                  bundle_steps=args.bundle_steps)
    tp = dict(tp=args.tp)
    for stage in stages:
        log = logger(f"stage{stage}" if stage != "fcn" else "fcn")
        try:
            if stage == "1":
                runner.train_stage1(cfg, data, logger=log, save_path=paths["1"],
                                    compute_dtype=dtype, remat=args.remat, fast_bn=args.fast_bn,
                                    bf16_head=args.bf16_head, bf16_istft=args.bf16_istft,
                                    data_on_device=not args.host_data,
                                    rng_impl="rbg" if args.rbg_rng else None, **moments, **tp,
                                    **common)
            elif stage == "2":
                frozen, _, _ = runner.load_stage1_bundle(cfg, paths["1"], device=args.device)
                runner.train_stage2(cfg, data, frozen, logger=log, save_path=paths["2"],
                                    metrics=val_metrics, precompute=not args.no_precompute,
                                    **moments, **tp, **common)
            elif stage == "3":
                tau = search_tau(cfg, data, paths, args.device) if args.search_tau else 0.0
                frozen, _, _ = runner.load_stage1_bundle(cfg, paths["1"], device=args.device)
                runner.train_stage3(
                    cfg, data, frozen, tau=tau, logger=log, save_path=paths["3"],
                    stage2_ckpt=paths["2"] if os.path.exists(paths["2"]) else None,
                    metrics=val_metrics, compute_dtype=dtype, fast_norm=args.fast_bn,
                    precompute=not args.no_precompute, **moments, **tp, **common)
            elif stage == "fcn":
                runner.train_fcn(cfg, data, logger=log, seed=args.seed, device=args.device,
                                 save_path=paths["fcn"])
        finally:
            if log is not None:
                log.close()
    if is_primary():
        print(f"checkpoints in {ckpt_dir}")


if __name__ == "__main__":
    main()
