#!/usr/bin/env python3
"""Time every launch plan of the continuous-Fréchet kernel on the card.

    python3 tools/frechet_sweep.py [--parent_source OLD.cu] [--out FILE]

Builds ``csrc/frechet_decision.cu`` (printing ptxas's registers and spills
per instance) and makes the two shape buckets of ``chip_smoke.py``'s
``[flyability]`` batch (64 pairs of 4633 x 580 points, 2 pairs of 4633 x
4633, the same seeded tracks, the discrete Fréchet as hi). For every
(depth, candidates a block, row elements a thread) that the kernel has and
whose full round fits in at most MAX_WAVES waves of blocks, it runs
``frechet_kernel.frechet`` at that plan: its output held ``torch.equal`` to
depth 1's, its device ms (CUDA events around one call, after a warm-up
call). Then it times the plan that ``launch_plan`` picks against depth 1 in
turns (picked, depth 1, depth 1, picked) and says whether the picked plan
is the fastest it measured. With ``--parent_source`` it builds an earlier
``frechet_decision.cu`` of the one-block-a-pair design (one launch, all 30
steps, its own C interface and block rule) and times it in the same turns,
its output held equal. The card's name and power limit head the output;
the JSON goes to ``--out``. Needs a CUDA card; takes ~2-4 minutes.
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
MAX_WAVES = 4  # plans whose full round needs more waves of blocks are not run
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (fly_batch: the [flyability] batch)
from tvqvae_tpu_torch.data.preprocess import AIRPORTS  # noqa: E402
from tvqvae_tpu_torch.evaluation.flyability import distances as D  # noqa: E402
from tvqvae_tpu_torch.ops import frechet_kernel as FK, nvcc, traj_dp_kernel  # noqa: E402


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
    """The one-block-a-pair kernel of an earlier frechet_decision.cu: one
    launch of all 30 steps; its block is the fewest of 1, 2, 4 or 8 row
    elements a thread that 1024 threads cover, in whole warps."""
    lib = ctypes.CDLL(str(nvcc.build(Path(source))))
    fn = lib.frechet_decision
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int

    def run(p, q, n, m, hi):
        nmax, mmax = int(n.max()), int(m.max())
        chunk = next(c for c in (1, 2, 4, 8) if c * 1024 >= mmax - 1)
        threads = max(32, -(-FK.active_threads(mmax, chunk) // 32) * 32)
        out = torch.empty_like(hi)
        n32, m32 = n.to(torch.int32), m.to(torch.int32)
        err = fn(p.data_ptr(), q.data_ptr(), n32.data_ptr(), m32.data_ptr(), hi.data_ptr(),
                 p.shape[0], p.shape[1], q.shape[1], nmax, mmax, threads, chunk,
                 out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent kernel failed: {err}")
        return out

    return run


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent_source", default=None)
    ap.add_argument("--out", default="build/frechet_sweep.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("frechet_sweep needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"[card] {smi} | {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    FK.build(verbose=True)
    traj_dp_kernel.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    parent = parent_runner(args.parent_source) if args.parent_source else None
    result = {"card": smi, "sms": sms, "buckets": {}}
    gens, sims = chip_smoke.fly_batch(np.random.default_rng(20))
    for key, (_, p, q, n, m) in D.shape_buckets(gens, sims, "cuda").items():
        hi = traj_dp_kernel.traj_dp(p, q, n, m, AIRPORTS["EHAM"],
                                    [("discret_frechet", "euclidean", 0.0)])[:, 0].contiguous()
        B, nmax, mmax = p.shape[0], int(n.max()), int(m.max())
        base_ms, base = event_ms(lambda: FK.frechet(p, q, n, m, hi, depth=1))
        rec = {"B": B, "nmax": nmax, "mmax": mmax, "depth1_ms": base_ms, "plans": []}
        print(f"[bucket {key}] B={B} mmax={mmax}: depth 1 {base_ms:.3f} ms", flush=True)
        for chunk, k in FK.INSTANCES:
            threads = FK.threads_for(mmax, chunk)
            if threads is None:
                continue
            per_sm = FK.card_blocks_per_sm(threads, chunk, k)
            for d in range(1, FK.MAX_DEPTH + 1):
                plan = FK.Plan(d, k, chunk, threads, len(FK.round_levels(d)),
                               B * -(-(2 ** d - 1) // k))
                waves = -(-plan.blocks // (sms * per_sm))
                if k > 2 ** d - 1 or waves > MAX_WAVES:
                    continue
                ms, got = event_ms(lambda: FK.frechet(p, q, n, m, hi, plan=plan))
                equal = bool(torch.equal(got, base))
                rec["plans"].append({**plan._asdict(), "blocks_per_sm": per_sm, "waves": waves,
                                     "ms": ms, "equal_to_depth1": equal})
                print(f"  {tuple(plan)} per_sm={per_sm} waves={waves}: {ms:.3f} ms, "
                      f"equal {equal}", flush=True)
        picked = FK.card_plan(B, mmax, "cuda")
        runs = {"picked": lambda: FK.frechet(p, q, n, m, hi),
                "depth1": lambda: FK.frechet(p, q, n, m, hi, depth=1),
                "parent": lambda: parent(p, q, n, m, hi)}
        order = ("picked", "depth1", "parent", "parent", "depth1", "picked")
        turns, outs = {who: [] for who in runs}, {}
        for who in order if parent else [w for w in order if w != "parent"]:
            ms, outs[who] = event_ms(runs[who])
            turns[who].append(ms)
        fastest = min(rec["plans"], key=lambda x: x["ms"])
        rec.update(picked=picked._asdict(), turns=turns,
                   picked_is_fastest=tuple(fastest[f] for f in FK.Plan._fields) == tuple(picked),
                   fastest=fastest, picked_equal_depth1=bool(torch.equal(outs["picked"], base)))
        if parent:
            rec["parent_equal"] = bool(torch.equal(outs["parent"], base))
        print(f"[bucket {key}] picked {tuple(picked)}: turns {turns}; fastest measured "
              f"{fastest}; picked is fastest: {rec['picked_is_fastest']}", flush=True)
        result["buckets"][str(key)] = rec
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    bad = [k for k, r in result["buckets"].items()
           if not (r["picked_equal_depth1"] and r.get("parent_equal", True)
                   and all(x["equal_to_depth1"] for x in r["plans"]))]
    print(json.dumps({"ok": not bad, "mismatch_buckets": bad}))
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
