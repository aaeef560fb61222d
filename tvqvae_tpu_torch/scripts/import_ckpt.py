"""Import reference-trained checkpoints (torch Lightning) into the port's.

Port of ``tvqvae_tpu/scripts/import_ckpt.py``, with its flags, plus
``--device`` (the card unless ``cpu`` is asked for):

    python -m tvqvae_tpu_torch.scripts.import_ckpt \
        --stage1_ckpt saved_models/DS/stage1.ckpt \
        --stage2_ckpt saved_models/DS/stage2.ckpt \
        --stage3_ckpt saved_models/DS/stage3.ckpt \
        --fcn_ckpt saved_models/DS/fcn.ckpt \
        --out_dir saved_models/OpenSky_EHAM_LIMC --n_classes 5 [--config cfg.json]

It writes the port's checkpoints (``utils/checkpoint.py``: an ``.npz`` in
the JAX package's tree layout plus ``.meta.json``) under ``--out_dir`` as
``stage1``, ``stage2``, ``stage3`` and ``fcn``, which
``TrainedModelSampler.from_checkpoints``, ``load_stage1_bundle``, the
evaluate CLI and ``train --resume`` read as they read the port's own. The
meta keys are the JAX CLI's (``config``, ``input_length``, ``in_channels``,
``n_classes``, ``tau``, ``force_projections``, ``imported_from``). The
``.ckpt`` files are read by ``utils/import_reference.py::
load_reference_checkpoint``, which runs none of their pickled globals.

Every imported tree is checked against a freshly initialised model of the
same config, built on ``--device``: the same tree and shapes, or the CLI
exits with the geometry it inferred from the weights, in the JAX CLI's
words.
"""

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from tvqvae_tpu_torch.models.fcn import FCN
from tvqvae_tpu_torch.models.fidelity_enhancer import FidelityEnhancer
from tvqvae_tpu_torch.models.maskgit import build_transformers
from tvqvae_tpu_torch.models.stage1 import Stage1Spec, init_stage1
from tvqvae_tpu_torch.scripts._cli import load_config
from tvqvae_tpu_torch.train.stage2 import init_stage2
from tvqvae_tpu_torch.train.stage3 import init_stage3
from tvqvae_tpu_torch.utils.checkpoint import save_checkpoint
from tvqvae_tpu_torch.utils.convert import fcn_to_jax, fe_to_jax, prior_to_jax, stage1_to_jax
from tvqvae_tpu_torch.utils.device import resolve_device
from tvqvae_tpu_torch.utils.import_reference import (
    fcn_from_state_dict,
    fe_from_state_dict,
    load_reference_checkpoint,
    stage1_from_state_dict,
    stage2_from_state_dict,
)


def _tree_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_tree_shapes(v, p))
        else:
            out[p] = tuple(np.shape(v))
    return out


def _assert_same_tree(imported, fresh, what: str, inferred: dict):
    a, b = _tree_shapes(imported), _tree_shapes(fresh)
    missing = sorted(set(b) - set(a))
    extra = sorted(set(a) - set(b))
    mismatch = sorted(k for k in set(a) & set(b) if a[k] != b[k])
    if missing or extra or mismatch:
        lines = [f"{what}: imported tree does not match the config's model."]
        if inferred:
            lines.append(f"geometry inferred from the weights: {inferred}")
        for tag, ks in (("missing", missing), ("unexpected", extra)):
            if ks:
                lines.append(f"{tag} ({len(ks)}): {ks[:6]}{'...' if len(ks) > 6 else ''}")
        for k in mismatch[:6]:
            lines.append(f"shape mismatch {k}: imported {a[k]} vs model {b[k]}")
        raise SystemExit("\n".join(lines))


def build_argparser():
    p = argparse.ArgumentParser(description="Import reference torch checkpoints (PyTorch port)")
    p.add_argument("--stage1_ckpt", type=str, default=None,
                   help="reference stage1.ckpt (Lightning)")
    p.add_argument("--stage2_ckpt", type=str, default=None,
                   help="reference stage2.ckpt (Lightning; both prior transformers are "
                        "imported, the frozen stage-1 copy inside it is ignored)")
    p.add_argument("--stage3_ckpt", type=str, default=None,
                   help="reference stage3.ckpt (Lightning; the fidelity-enhancer weights and "
                        "tau are imported)")
    p.add_argument("--fcn_ckpt", type=str, default=None, help="reference fcn.ckpt (raw state_dict)")
    p.add_argument("--out_dir", type=str, required=True,
                   help="the port's model dir (e.g. saved_models/<dataset>)")
    p.add_argument("--config", type=str, default=None,
                   help="config of the reference training run in the reference schema, YAML or "
                        ".json (defaults to the published config)")
    p.add_argument("--n_classes", type=int, default=None,
                   help="class count for the stage-1 meta (taken from the FCN head when "
                        "--fcn_ckpt is given)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the validation models are built: cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    """Import what the flags name. -> seconds by stage (read, convert,
    validate, write)."""
    p = build_argparser()
    args = p.parse_args(argv)
    if not any((args.stage1_ckpt, args.stage2_ckpt, args.stage3_ckpt, args.fcn_ckpt)):
        p.error("nothing to do: pass --stage1_ckpt, --stage2_ckpt, --stage3_ckpt and/or "
                "--fcn_ckpt")
    if args.stage2_ckpt and not args.stage1_ckpt:
        p.error("--stage2_ckpt needs --stage1_ckpt in the same invocation (the prior's "
                "token-grid geometry comes from the stage-1 spec)")
    if args.stage3_ckpt and not args.stage1_ckpt:
        p.error("--stage3_ckpt needs --stage1_ckpt in the same invocation (the sampler reads "
                "the FE geometry from the stage-1 meta)")
    if args.stage1_ckpt and args.n_classes is None and not args.fcn_ckpt:
        p.error("--n_classes is required with --stage1_ckpt (or pass --fcn_ckpt to take it "
                "from the FCN head)")

    cfg = load_config(args.config)
    dev = resolve_device(args.device)
    gen = torch.Generator().manual_seed(0)
    os.makedirs(args.out_dir, exist_ok=True)
    n_classes = args.n_classes
    seconds = {}

    def timed(stage, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[stage] = time.perf_counter() - t0
        return out

    def write(name, tree, meta, src):
        out = os.path.join(args.out_dir, name)
        save_checkpoint(out, tree, meta={"config": dataclasses.asdict(cfg), **meta,
                                         "imported_from": os.path.abspath(src)})
        print(f"[import] wrote {out}")

    if args.fcn_ckpt:
        def fcn_stage():
            variables, inferred = fcn_from_state_dict(load_reference_checkpoint(args.fcn_ckpt))
            print(f"[import] fcn.ckpt: {inferred}")
            fresh = fcn_to_jax(FCN(inferred["in_channels"], inferred["n_classes"]).to(dev))
            _assert_same_tree({"params": variables["params"],
                               "batch_stats": variables["batch_stats"]}, fresh, "fcn", inferred)
            write("fcn", variables, {"in_channels": inferred["in_channels"],
                                     "n_classes": inferred["n_classes"]}, args.fcn_ckpt)
            return inferred

        fcn_classes = timed("fcn", fcn_stage)["n_classes"]
        n_classes = n_classes or fcn_classes

    inferred = None
    if args.stage1_ckpt:
        def stage1_stage():
            params, stats, vq_l, vq_h, inf = stage1_from_state_dict(
                load_reference_checkpoint(args.stage1_ckpt))
            print(f"[import] stage1.ckpt: {inf}")
            spec = Stage1Spec.from_config(cfg, inf["input_length"], inf["in_channels"])
            f_model, f_vql, f_vqh = init_stage1(spec, gen, dev)
            fresh = stage1_to_jax(f_model, f_vql, f_vqh)
            _assert_same_tree(
                {"params": params, "batch_stats": stats, "vq_l": {"embed": vq_l["embed"]},
                 "vq_h": {"embed": vq_h["embed"]}},
                {"params": fresh["params"], "batch_stats": fresh["batch_stats"],
                 "vq_l": {"embed": fresh["vq_l"]["embed"]},
                 "vq_h": {"embed": fresh["vq_h"]["embed"]}},
                "stage1", inf)
            write("stage1", {"params": params, "batch_stats": stats, "vq_l": vq_l, "vq_h": vq_h,
                             "step": np.asarray(0)},
                  {"input_length": inf["input_length"], "in_channels": inf["in_channels"],
                   "n_classes": int(n_classes)}, args.stage1_ckpt)
            return inf

        inferred = timed("stage1", stage1_stage)

    if args.stage2_ckpt:
        def stage2_stage():
            p2, h_stats, inf2 = stage2_from_state_dict(load_reference_checkpoint(args.stage2_ckpt))
            print(f"[import] stage2.ckpt: {inf2}")
            spec1 = Stage1Spec.from_config(cfg, inferred["input_length"], inferred["in_channels"])
            for kind, inf in (("lf", inf2["lf"]), ("hf", inf2["hf"])):
                want = spec1.tokens_l if kind == "lf" else spec1.tokens_h
                if inf["num_tokens"] != want:
                    raise SystemExit(
                        f"stage2 {kind}: prior trained on {inf['num_tokens']} tokens but the "
                        f"stage-1 geometry yields {want} — stage-1/stage-2 checkpoints are from "
                        "different runs?")
            force = bool(inf2["force_projections"])
            t_l, t_h = init_stage2(*build_transformers(cfg, spec1, int(inf2["lf"]["n_classes"]),
                                                       (force, force)), gen, dev)
            f_params, f_hstats = prior_to_jax(t_l, t_h)
            _assert_same_tree({"params": p2, "h_stats": h_stats},
                              {"params": f_params, "h_stats": f_hstats}, "stage2", inf2)
            write("stage2", {"params": p2, "h_stats": h_stats, "step": np.asarray(0)},
                  {"n_classes": int(inf2["lf"]["n_classes"]), "force_projections": force},
                  args.stage2_ckpt)

        timed("stage2", stage2_stage)

    if args.stage3_ckpt:
        def stage3_stage():
            fe_params, tau, fe_inferred = fe_from_state_dict(
                load_reference_checkpoint(args.stage3_ckpt))
            print(f"[import] stage3.ckpt: {fe_inferred}")
            if fe_inferred["in_channels"] != inferred["in_channels"]:
                raise SystemExit(f"stage3: FE channels {fe_inferred['in_channels']} != "
                                 f"stage-1 in_channels {inferred['in_channels']}")
            # the GroupNorm group count cannot be read off the weights: it comes
            # from the config, as the reference's sampler rebuilds its enhancer
            fe = init_stage3(FidelityEnhancer.from_config(cfg, inferred["input_length"],
                                                          inferred["in_channels"]), gen, dev)
            _assert_same_tree(fe_params, fe_to_jax(fe), "stage3", fe_inferred)
            write("stage3", {"params": fe_params, "tau": np.asarray(tau, np.float32),
                             "step": np.asarray(0)},
                  {"input_length": inferred["input_length"],
                   "in_channels": inferred["in_channels"], "tau": tau}, args.stage3_ckpt)

        timed("stage3", stage3_stage)
    print("[import] seconds by stage " + json.dumps(seconds))
    return seconds


if __name__ == "__main__":
    main()
