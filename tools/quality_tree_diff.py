"""Two source trees' cut quality runs on the CPU, checkpoint leaf by leaf.

Each commit is unpacked with ``git archive`` into a directory of its own,
and in a subprocess from that directory (its own ``tvqvae_tpu_torch``) the
port's quality run (``scripts/quality_run.py::run``) trains and scores at a
cut size: the small widths of the sampler tests (``SMALL``) over the quality
run's config overrides, its synthetic set cut to ``--n`` series of length
``--length``, ``--steps`` steps a stage, ROCKET with 50 kernels, ``--n_eval``
series scored, seed ``--seed``, the recipe's defaults (``--fast_bn
--bf16_mu --bf16_head``) and ``--bf16`` when given. Then the three stage
checkpoints of the two runs are compared leaf by leaf: the leaves that
differ and the largest gap, with its leaf. Reads ``tvqvae_tpu_torch`` only:

    python tools/quality_tree_diff.py 2724d94 f9e4eb2 [--bf16] [--steps 2] \
        [--workdir DIR] [--threads 1]

It prints each tree's SUMMARY line, then one line a stage and a JSON line
with everything (also written to ``DIR/diff.json`` when ``--workdir`` is
given; otherwise a temporary directory is removed at the end). A run takes
~1-2 minutes a tree at 2 steps a stage on one thread.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # run as a script from anywhere
    sys.path.insert(0, REPO)

# the sampler tests' small widths (tests/test_torch_sampler.py::CFG)
SMALL = {
    "encoder": {"init_dim": 4, "hid_dim": 16, "n_resnet_blocks": 1,
                "downsampled_width": {"lf": 4, "hf": 8}},
    "decoder": {"n_resnet_blocks": 1},
    "VQ-VAE": {"n_fft": 4, "codebook_sizes": {"lf": 8, "hf": 8}},
    "MaskGIT": {
        "choice_temperatures": {"lf": 10, "hf": 4},
        "T": {"lf": 3, "hf": 1},
        "prior_model_l": {"hidden_dim": 16, "n_layers": 2, "heads": 2},
        "prior_model_h": {"hidden_dim": 8, "n_layers": 1, "heads": 1},
    },
    "fidelity_enhancer": {"dim": 8, "dim_mults": [1, 2], "resnet_block_groups": 4},
}
STAGES = ("stage1", "stage2", "stage3")

# run in the unpacked tree: its quality run at the cut size; argv[1] is a
# JSON of {workdir, overrides, data, threads, flags}
_RUN = """
import functools, json, sys
import torch
spec = json.loads(sys.argv[1])
torch.set_num_threads(spec["threads"])
from tvqvae_tpu_torch.evaluation import Metrics
from tvqvae_tpu_torch.scripts import quality_run, train
small = functools.partial(Metrics, rocket_num_kernels=50)
train.Metrics = quality_run.Metrics = small
quality_run.DATA = {**quality_run.DATA, **spec["data"]}
args = quality_run.build_argparser().parse_args(["--workdir", spec["workdir"], *spec["flags"]])
quality_run.run(args, overrides=spec["overrides"])
"""


def cut_overrides(overrides, steps):
    """The quality run's ``overrides`` at the small widths and ``steps``
    steps a stage (a validation at the end of each)."""
    cut = {**SMALL, **overrides, "encoder": SMALL["encoder"]}
    cut["trainer_params"] = {"max_steps": {s: steps for s in STAGES},
                             "val_check_interval": {s: steps for s in STAGES}}
    cut["evaluation"] = {**overrides.get("evaluation", {}), "min_num_gen_samples": 8}
    return cut


def flat_leaves(path):
    """A stage checkpoint's leaves as {"/"-joined key: array}."""
    from tvqvae_tpu_torch.utils.checkpoint import load_checkpoint

    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                out[prefix + k] = np.asarray(v)
    walk(load_checkpoint(path)[0], "")
    return out


def compare_checkpoints(path_a, path_b):
    """Two stage checkpoints leaf by leaf -> {"leaves": leaves in both,
    "differ": leaves not bit-equal, "max_gap": the largest |a - b| (in
    float64), "max_leaf": its leaf, "only_a"/"only_b": leaves in one only,
    "shape": leaves whose shapes differ}."""
    a, b = flat_leaves(path_a), flat_leaves(path_b)
    both = sorted(set(a) & set(b))
    out = {"leaves": len(both), "differ": 0, "max_gap": 0.0, "max_leaf": None,
           "only_a": sorted(set(a) - set(b)), "only_b": sorted(set(b) - set(a)), "shape": []}
    for k in both:
        x, y = a[k], b[k]
        if x.shape != y.shape:
            out["shape"].append(k)
            continue
        if np.array_equal(x, y):
            continue
        out["differ"] += 1
        gap = float(np.abs(x.astype(np.float64) - y.astype(np.float64)).max())
        if gap > out["max_gap"] or out["max_leaf"] is None:
            out["max_gap"], out["max_leaf"] = gap, k
    return out


def unpack(commit, dest, repo="."):
    os.makedirs(dest, exist_ok=True)
    archive = subprocess.run(["git", "-C", repo, "archive", commit], check=True,
                             capture_output=True).stdout
    subprocess.run(["tar", "-x", "-C", dest], input=archive, check=True)


def run_tree(tree, workdir, overrides, data, threads, flags):
    """The cut quality run in ``tree`` -> its SUMMARY dict."""
    spec = {"workdir": workdir, "overrides": overrides, "data": data, "threads": threads,
            "flags": flags}
    env = {**os.environ, "PYTHONPATH": tree}
    proc = subprocess.run([sys.executable, "-c", _RUN, json.dumps(spec)], cwd=tree, env=env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"quality run in {tree} exited {proc.returncode}:\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("SUMMARY ")][-1]
    return json.loads(line[len("SUMMARY "):])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("commit_a")
    ap.add_argument("commit_b")
    ap.add_argument("--repo", default=".", help="the git repository holding both commits")
    ap.add_argument("--workdir", default=None, help="kept when given")
    ap.add_argument("--steps", type=int, default=2, help="steps a stage")
    ap.add_argument("--n", type=int, default=240, help="synthetic series")
    ap.add_argument("--length", type=int, default=128)
    ap.add_argument("--n_eval", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args(argv)

    from tvqvae_tpu_torch.scripts.quality_run import CFG_OVERRIDES, STEM

    keep = args.workdir is not None
    root = os.path.abspath(args.workdir) if keep else tempfile.mkdtemp(prefix="qtd_")
    overrides = cut_overrides(CFG_OVERRIDES, args.steps)
    data = {"n": args.n, "length": args.length}
    flags = ["--device", "cpu", "--n_eval", str(args.n_eval), "--seed", str(args.seed)]
    flags += ["--bf16"] if args.bf16 else []
    summaries, ckpts = {}, {}
    try:
        for side, commit in (("a", args.commit_a), ("b", args.commit_b)):
            tree, wd = os.path.join(root, f"tree_{side}"), os.path.join(root, f"run_{side}")
            unpack(commit, tree, args.repo)
            summaries[side] = run_tree(tree, wd, overrides, data, args.threads, flags)
            ckpts[side] = os.path.join(wd, "models", STEM)
            print(f"{side} {commit}: SUMMARY {json.dumps(summaries[side])}", flush=True)
        result = {"commits": [args.commit_a, args.commit_b], "summary": summaries,
                  "stages": {s: compare_checkpoints(os.path.join(ckpts["a"], s),
                                                    os.path.join(ckpts["b"], s))
                             for s in STAGES}}
        for s, r in result["stages"].items():
            print(f"{s}: {r['differ']} of {r['leaves']} leaves differ, largest gap "
                  f"{r['max_gap']:.3g} at {r['max_leaf']}; only in a {len(r['only_a'])}, only in "
                  f"b {len(r['only_b'])}, shapes differ {len(r['shape'])}", flush=True)
        print(json.dumps(result), flush=True)
        if keep:
            with open(os.path.join(root, "diff.json"), "w") as f:
                json.dump(result, f, indent=1)
        return result
    finally:
        if not keep:
            import shutil
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
