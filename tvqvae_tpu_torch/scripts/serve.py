"""Serve CLI: run a trained generator as an HTTP service.

Port of ``tvqvae_tpu/scripts/serve.py``, with its flags:

    python -m tvqvae_tpu_torch.scripts.serve --dataset_file data.npz \
        --model_save_dir saved_models --port 8080 [--use_fe] [--warm_classes] \
        [--bf16] [--no-fast_bn] [--data_parallel]

It loads the stage checkpoints as the generate CLI does and fits nothing:
the training scaler is derived again from the dataset file, so responses
come back in original physical units. ``--bf16`` and ``--fast_bn`` (on by
default) set the sampler's precision, as in the JAX CLI. ``--data_parallel``
fans every batch out over all visible CUDA devices (the sampler's
``devices``; ``--batch_size`` must divide by their count): one card is the
degenerate one-device case, as in JAX, and ``--device cpu`` the CPU alone.
``build_service`` makes the service without serving it. See ``tvqvae_tpu_torch/serving/`` for the endpoints.
"""

import argparse
import os
from pathlib import Path

import torch

from tvqvae_tpu_torch.data import get_data
from tvqvae_tpu_torch.generation import TrainedModelSampler
from tvqvae_tpu_torch.scripts._cli import load_config
from tvqvae_tpu_torch.serving import GenerationService, serve_forever
from tvqvae_tpu_torch.utils.device import resolve_device


def build_argparser():
    p = argparse.ArgumentParser(description="Serve a trained generator (PyTorch port)")
    p.add_argument("--config", type=str, default=None,
                   help="config in the reference schema, YAML or .json; defaults built in")
    p.add_argument("--dataset_file", type=str, required=True,
                   help="training dataset (the scaler and features for original-unit responses)")
    p.add_argument("--model_save_dir", type=str, default="saved_models")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--use_fe", action="store_true",
                   help="serve fidelity-enhanced samples (needs stage3)")
    p.add_argument("--max_request", type=int, default=4096)
    p.add_argument("--warm_classes", action="store_true",
                   help="also warm the per-class conditional paths")
    p.add_argument("--no_warmup", action="store_true")
    p.add_argument("--coalesce_ms", type=float, default=None,
                   help="merge concurrent same-class seedless requests arriving within this "
                        "window into one batch")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--bf16", action="store_true",
                   help="the frozen stage-1 stacks and the enhancer in bfloat16, with the "
                        "TimeHead and the iSTFT (the JAX sampler's defaults under bf16)")
    p.add_argument("--fast_bn", action=argparse.BooleanOptionalAction, default=True,
                   help="BatchNorm/GroupNorm normalisation in the compute dtype "
                        "(--no-fast_bn: flax's float32 promotion)")
    p.add_argument("--data_parallel", action="store_true",
                   help="fan generation out over every visible CUDA device (batch_size must "
                        "divide by the device count; one device needs no flag)")
    return p


def build_service(args, parser=None) -> GenerationService:
    """The service ``main`` serves, from parsed arguments, not yet warmed."""
    devices = None
    if args.data_parallel:
        dev = resolve_device(args.device)
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" else [dev])
        if args.batch_size % len(devices):
            (parser or build_argparser()).error(
                f"--batch_size {args.batch_size} must divide by the device count {len(devices)}")
        print(f"[serve] data-parallel over {len(devices)} devices", flush=True)
    cfg = load_config(args.config)
    data = get_data(args.dataset_file, cfg.dataset.features, scale=cfg.dataset.data_scaling)
    ckpt = os.path.join(args.model_save_dir, Path(args.dataset_file).stem)
    stage3 = os.path.join(ckpt, "stage3")
    sampler = TrainedModelSampler.from_checkpoints(
        cfg,
        os.path.join(ckpt, "stage1"),
        os.path.join(ckpt, "stage2"),
        stage3_ckpt=stage3 if (args.use_fe and os.path.exists(stage3)) else None,
        use_fidelity_enhancer=args.use_fe,
        batch_size=args.batch_size,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        fast_bn=args.fast_bn,
        device=args.device,
        devices=devices,
    )
    return GenerationService(
        sampler,
        scaler=data.scaler if cfg.dataset.data_scaling else None,
        features=cfg.dataset.features,
        max_request=args.max_request,
        coalesce_ms=args.coalesce_ms,
    )


def main(argv=None):
    p = build_argparser()
    args = p.parse_args(argv)
    service = build_service(args, p)
    if not args.no_warmup:
        print("[serve] warming the decode paths...", flush=True)
        service.warmup(classes=args.warm_classes)
    serve_forever(service, args.host, args.port)


if __name__ == "__main__":
    main()
