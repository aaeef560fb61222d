"""Export the JAX package's stage checkpoints (Orbax) to the PyTorch port's
format, so a model trained with ``tvqvae_tpu`` serves and generates with
``tvqvae_tpu_torch`` on a machine without JAX or orbax.

Run it where JAX runs (it reads Orbax, read-only; the port's side needs no
JAX):

    python tools/export_jax_ckpt.py SRC DST            # one checkpoint
    python tools/export_jax_ckpt.py --all SRC_DIR DST_DIR
        # every stage1/stage2/stage3/fcn checkpoint in a model directory,
        # e.g. saved_models/<dataset stem>

Each tree is written unchanged (same keys, same leaves) by
``tvqvae_tpu_torch.utils.checkpoint.save_checkpoint`` to exactly DST, and
the ``.meta.json`` sidecar is copied byte for byte, so
``TrainedModelSampler.from_checkpoints`` and the port's CLIs read DST as
they read the port's own checkpoints. Works for stages 1-3 and the FCN.
"""

import argparse
import os
import shutil
import sys

STAGES = ("stage1", "stage2", "stage3", "fcn")


def export_checkpoint(src: str, dst: str) -> None:
    """One Orbax checkpoint directory ``src`` -> the port's file ``dst``."""
    from tvqvae_tpu.utils.checkpoint import load_checkpoint
    from tvqvae_tpu_torch.utils.checkpoint import save_checkpoint

    tree, _ = load_checkpoint(src)
    save_checkpoint(dst, tree)
    meta = os.path.abspath(src) + ".meta.json"
    if os.path.exists(meta):
        shutil.copyfile(meta, os.path.abspath(dst) + ".meta.json")
    print(f"[export] {src} -> {dst} ({os.path.getsize(dst) / 1e6:.1f} MB)")


def export_model_dir(src_dir: str, dst_dir: str) -> list:
    """Every stage checkpoint of ``src_dir`` into ``dst_dir``; -> the names."""
    done = []
    for name in STAGES:
        if os.path.exists(os.path.join(src_dir, name)):
            export_checkpoint(os.path.join(src_dir, name), os.path.join(dst_dir, name))
            done.append(name)
    if not done:
        raise FileNotFoundError(f"no {'/'.join(STAGES)} checkpoint in {src_dir}")
    return done


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("src", help="a JAX stage checkpoint (with --all: a model directory)")
    p.add_argument("dst", help="the port's checkpoint path (with --all: a directory)")
    p.add_argument("--all", action="store_true",
                   help="export every stage1/stage2/stage3/fcn checkpoint of a directory")
    args = p.parse_args(argv)
    if args.all:
        export_model_dir(args.src, args.dst)
    else:
        export_checkpoint(args.src, args.dst)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # the repo
    main()
