#!/usr/bin/env python3
"""Time every launch plan of the trajectory-DP kernel on the card.

    python3 tools/traj_dp_sweep.py [--parent_source OLD.cu] [--out FILE]

Builds ``csrc/traj_dp.cu`` (printing ptxas's registers and spills) and makes
the two shape buckets of ``chip_smoke.py``'s ``[flyability]`` batch (64 pairs
of 4633 x 580 points, 2 pairs of 4633 x 4633, the same seeded tracks), with
the nine DP variants of the bundle. For every plan ``traj_dp_kernel.plans``
lists (each side across the lanes, every cluster size)
that the card can place, it runs ``traj_dp_kernel.traj_dp`` at that plan:
its output held ``torch.equal`` to the picked plan's, its device ms (CUDA
events around one call, after a warm-up call). It says whether the plan
that ``launch_plan`` picks is the fastest it measured, and where it is not,
times the two again in turns (picked, fastest, fastest, picked). With
``--parent_source`` it builds an earlier ``traj_dp.cu`` of the one-block-a-
(pair, variant) design (its own C interface and block rule), holds its
output equal to the picked plan's, variant by variant, and times the two in
turns (picked, parent, parent, picked). It prints each bucket's bound
(``chip_smoke.fly_bound``) and the ns a dependent step of each design. The
card's name and power limit head the output; the JSON goes to ``--out``.
Needs a CUDA card; takes ~1-2 minutes.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (fly_batch, fly_bound, fly_dp_steps: the [flyability] batch)
from tvqvae_tpu_torch.data.preprocess import AIRPORTS  # noqa: E402
from tvqvae_tpu_torch.evaluation.flyability import distances as D  # noqa: E402
from tvqvae_tpu_torch.ops import nvcc, traj_dp_kernel as TK  # noqa: E402


def event_ms(fn):
    """Device ms of one call of ``fn`` (CUDA events), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    res = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b), res


def parent_runner(source):
    """The one-block-a-(pair, variant) kernel of an earlier traj_dp.cu: a
    block of whole warps over min(nmax, mmax) (at most 1024 threads) and its
    points and three diagonals in shared memory."""
    lib = ctypes.CDLL(str(nvcc.build(Path(source))))
    fn = lib.traj_dp
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                   + [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                      ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(p, q, n, m, g, variants):
        nmax, mmax = int(n.max()), int(m.max())
        w = min(nmax, mmax)
        threads = TK.sum_threads(nmax, mmax)
        smem = 4 * (4 * (nmax + mmax) + 3 * w + 32)
        V = len(variants)
        kinds = (ctypes.c_int * V)(*(TK.KINDS[k] for k, _, _ in variants))
        metrics = (ctypes.c_int * V)(*(TK.METRICS[mt] for _, mt, _ in variants))
        eps = (ctypes.c_float * V)(*(float(e) for _, _, e in variants))
        out = torch.empty(p.shape[0], V, dtype=torch.float32, device=p.device)
        n32, m32 = n.to(torch.int32), m.to(torch.int32)
        err = fn(p.data_ptr(), q.data_ptr(), n32.data_ptr(), m32.data_ptr(), p.shape[0],
                 p.shape[1], q.shape[1], nmax, mmax, float(g[0]), float(g[1]), V, kinds, metrics,
                 eps, threads, smem, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent kernel failed: {err}")
        return out

    return run


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent_source", default=None)
    ap.add_argument("--out", default="build/traj_dp_sweep.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("traj_dp_sweep needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"[card] {smi} | {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    TK.build(verbose=True)
    parent = parent_runner(args.parent_source) if args.parent_source else None
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    g = AIRPORTS["EHAM"]
    variants = D.dp_variants()
    spec = [v[1:] for v in variants]
    result = {"card": smi, "buckets": {}}
    gens, sims = chip_smoke.fly_batch(np.random.default_rng(20))
    bad = []
    for key, (_, p, q, n, m) in D.shape_buckets(gens, sims, "cuda").items():
        B, nmax, mmax = p.shape[0], int(n.max()), int(m.max())
        ntasks = len(TK.tasks(spec))
        picked = TK.card_plan(B, ntasks, nmax, mmax, "cuda")
        base_ms, base = event_ms(lambda: TK.traj_dp(p, q, n, m, g, spec, plan=picked))
        bound, by, ops = chip_smoke.fly_bound(n.tolist(), m.tolist(), spec)
        rec = {"B": B, "nmax": nmax, "mmax": mmax, "picked": picked._asdict(), "plans": [],
               "bound_ms": bound, "bound_by": by, "gflop": ops / 1e9,
               "cells": TK.cells(n.tolist(), m.tolist())}
        print(f"[bucket {key}] B={B} {nmax} x {mmax}: picked {tuple(picked)} {base_ms:.3f} ms; "
              f"bound {bound:.5f} ms ({by}: {ops / 1e9:.3f} GFLOP)", flush=True)
        for plan in TK.plans(nmax, mmax):
            blocks, clusters = TK.card_occupancy(plan.warps, plan.cluster, plan.smem)
            if blocks < 1 or clusters < 1:
                continue
            ms, got = event_ms(lambda: TK.traj_dp(p, q, n, m, g, spec, plan=plan))
            equal = bool(torch.equal(got, base))
            rec["plans"].append({**plan._asdict(), "blocks_per_sm": blocks, "clusters": clusters,
                                 "ms": ms, "equal_to_picked": equal,
                                 "ns_per_step": 1e6 * ms / chip_smoke.fly_dp_steps(plan)})
            print(f"  {tuple(plan[:3])} per_sm={blocks} clusters={clusters}: {ms:.3f} ms, "
                  f"equal {equal}", flush=True)
            if not equal:
                bad.append((str(key), tuple(plan)))
        fastest = min(rec["plans"], key=lambda x: x["ms"])
        rec.update(fastest=fastest, picked_is_fastest=all(
            fastest[f] == picked._asdict()[f] for f in TK.Plan._fields))
        if not rec["picked_is_fastest"]:  # the two again, in turns
            best = TK.Plan(**{f: fastest[f] for f in TK.Plan._fields})
            vs = {"picked": [], "fastest": []}
            for who, plan in (("picked", picked), ("fastest", best), ("fastest", best),
                              ("picked", picked)):
                vs[who].append(event_ms(lambda: TK.traj_dp(p, q, n, m, g, spec, plan=plan))[0])
            rec["picked_vs_fastest_turns"] = vs
            print(f"  in turns: picked {[round(t, 3) for t in vs['picked']]}, fastest "
                  f"{[round(t, 3) for t in vs['fastest']]} ms", flush=True)
        steps = chip_smoke.fly_dp_steps(picked)
        shape = tuple(fastest[f] for f in ("warps", "cluster", "swap"))
        line = (f"[bucket {key}] fastest measured {shape} {fastest['ms']:.3f} ms; picked is "
                f"fastest: {rec['picked_is_fastest']}; {1e6 * base_ms / steps:.1f} ns per "
                f"dependent step of {steps}")
        if parent:
            turns, outs = {"picked": [], "parent": []}, {}
            runs = {"picked": lambda: TK.traj_dp(p, q, n, m, g, spec, plan=picked),
                    "parent": lambda: parent(p, q, n, m, g, spec)}
            for who in ("picked", "parent", "parent", "picked"):
                ms, outs[who] = event_ms(runs[who])
                turns[who].append(ms)
            diff = {vk: float((outs["parent"][:, j] - outs["picked"][:, j]).abs().max())
                    for j, (vk, *_) in enumerate(variants)}
            equal = bool(torch.equal(outs["parent"], outs["picked"]))
            diagonals = nmax + mmax - 1
            rec.update(turns=turns, parent_equal=equal, parent_max_abs_diff=diff,
                       parent_ns_per_diagonal=1e6 * float(np.mean(turns["parent"])) / diagonals)
            line += (f"; in turns picked {[round(t, 3) for t in turns['picked']]}, parent "
                     f"{[round(t, 3) for t in turns['parent']]} ms "
                     f"({rec['parent_ns_per_diagonal']:.1f} ns per diagonal of {diagonals}); "
                     f"parent bit-equal: {equal} {diff}")
            if not equal:
                bad.append((str(key), "parent"))
        print(line, flush=True)
        result["buckets"][str(key)] = rec
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"ok": not bad, "mismatches": bad}))
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
