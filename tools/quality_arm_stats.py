"""Seed-0 quality readings by arm: medians, Mann-Whitney p and the verdict.

Reads the last ``SUMMARY`` line of each quality-run log (``quality_run``'s
output, e.g. as ``tools/quality_arms.sh`` writes it), grouped by arm, and
prints for each group its ``fid_gen`` readings and median, the ranges of
``fid_gen_ess``, ``fid_gen_fe``, ``fid_rec`` and ``train_minutes``, the
Mann-Whitney U and p of its ``fid_gen`` against the ``--against`` group
(two-sided, and one-sided for the group lying below it), and ROADMAP
§3.2's verdict on its median: at most ``--low`` reads as the baseline
tree's (``001b271``), at least ``--high`` as the head's, between needs
more runs.

    python tools/quality_arm_stats.py --against head \
        --group "head=logs/head_qr*.log,logs/arms_A?.log" \
        --group "B=logs/arms_B?.log" --group "base=logs/base_qr*.log"
"""

import argparse
import glob
import json
import statistics
import sys

KEYS = ("fid_gen_ess", "fid_gen_fe", "fid_rec", "train_minutes")


def summary(path):
    """The last SUMMARY dict in a log."""
    found = None
    with open(path, errors="replace") as f:
        for line in f:
            if line.startswith("SUMMARY "):
                found = json.loads(line[len("SUMMARY "):])
    if found is None:
        raise ValueError(f"{path}: no SUMMARY line")
    return found


def mann_whitney(x, y):
    """U of x against y and the exact p: two-sided and one-sided (x below
    y), from scipy."""
    from scipy.stats import mannwhitneyu

    two = mannwhitneyu(x, y, alternative="two-sided", method="exact")
    less = mannwhitneyu(x, y, alternative="less", method="exact")
    return float(two.statistic), float(two.pvalue), float(less.pvalue)


def verdict(median, low, high):
    if median <= low:
        return "reads as the baseline tree's"
    if median >= high:
        return "reads as the head's"
    return "between: run 3 more"


def report(groups, against=None, low=0.0075, high=0.009):
    """{name: [SUMMARY dicts]} -> {name: statistics} (printed too)."""
    out = {}
    ref = [s["fid_gen"] for s in groups[against]] if against else None
    for name, sums in groups.items():
        gen = [s["fid_gen"] for s in sums]
        med = statistics.median(gen)
        row = {"n": len(gen), "fid_gen": gen, "median": med,
               "verdict": verdict(med, low, high),
               **{k: (min(s[k] for s in sums), max(s[k] for s in sums)) for k in KEYS}}
        if ref is not None and name != against:
            row["U"], row["p_two_sided"], row["p_below"] = mann_whitney(gen, ref)
        out[name] = row
        print(f"{name}: n {row['n']}, fid_gen {gen}, median {med:.5g} ({row['verdict']})"
              + "".join(f", {k} {row[k][0]:.5g}-{row[k][1]:.5g}" for k in KEYS)
              + (f"; against {against}: U {row['U']:g}, p {row['p_two_sided']:.4g} two-sided, "
                 f"{row['p_below']:.4g} below" if "U" in row else ""), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--group", action="append", required=True,
                    help="NAME=GLOB[,GLOB...] of quality-run logs (repeatable)")
    ap.add_argument("--against", default=None, help="the group the others are tested against")
    ap.add_argument("--low", type=float, default=0.0075)
    ap.add_argument("--high", type=float, default=0.009)
    args = ap.parse_args(argv)
    groups = {}
    for g in args.group:
        name, patterns = g.split("=", 1)
        paths = sorted({p for pattern in patterns.split(",") for p in glob.glob(pattern)})
        if not paths:
            sys.exit(f"no log matches {patterns}")
        groups[name] = [summary(p) for p in paths]
    return report(groups, args.against, args.low, args.high)


if __name__ == "__main__":
    main()
