"""Bundled training steps: ``n`` optimizer steps a host dispatch.

Port of ``tvqvae_tpu/train/runner.py::make_multistep`` and
``tvqvae_tpu/train/stage1.py::make_stage1_train_multistep``. JAX scans its
jitted step ``n`` times as one program: the batch indices and the dropout
keys derive from the state inside the scan, the host dispatches once a
bundle, and the bundle returns the means of the steps' metrics. Each step is
the single step.

Here a stage's step is a function of no argument (``Multistep``'s ``step``)
that reads its batch through device state (``runner._Feed``: a device step
counter, or a static buffer the bundle's host batches are staged into),
draws from its generator, updates the train state in place (the stage-1
codebooks are copied into their tensors, ``make_stage1_train_step(in_place=
True)``) and returns its metrics as 0-dim device tensors. Nothing in it reads
the device from the host or takes a host value that changes from step to
step (``train/optim.py::AdamWStorage`` holds its step count on the device).

On a CUDA device the first bundle's first ``WARMUP`` steps run eagerly on a
side stream, as PyTorch's capture recipe asks (they are the run's own
steps: lazy initialisation, the optimizer's moments, the kernels' builds),
and, where ``ready`` says so (the k-means latch of stage 1), more eager
steps until it holds. Then one step is captured as a ``torch.cuda.CUDAGraph``
(thread-local mode: the host feed's prefetch thread may pin memory
meanwhile) and replayed for the rest of that bundle and every step of every later
bundle: the host issues one replay a step and reads nothing until the
bundle's means are read. The graph is captured once a run and never again:
the tail (``single``) runs eager steps, whose host-fed batches come from the
same static buffer. A capture or a replay that fails raises; nothing falls
back to eager steps.

- The generators register with the graph
  (``CUDAGraph.register_generator_state``), so each replay draws from their
  offsets at that replay, as the eager step draws: the same numbers, and the
  generators' states after a bundle are the eager steps' (snapshots save
  them).
- The capture runs the step's Python once without running a kernel, so the
  host counters it advanced (``state.step``, the schedule, the optimizer's
  ``count``) are put back after it; each replay advances them by one step.
- The VQ kernel's launches in the graph (``ops/vq_kernel.py``'s
  ``captured_launches``) are added to its ``launch_count`` at each replay:
  the count is of launches that ran.
- The metrics are summed into static accumulators in the step's order and
  divided by the bundle's length once it ends, on the CPU as on the card.

On the CPU a bundle is the same steps in a loop, summed the same way.
"""

import contextlib
import time
from typing import Callable, Dict, Optional

import torch

from tvqvae_tpu_torch.ops import vq_kernel

WARMUP = 2  # eager steps before the capture

Metrics = Dict[str, torch.Tensor]


class Multistep:
    """``bundle(n)`` runs ``n`` steps of ``step`` and returns their metrics'
    means; ``single()`` runs one eager step and returns its metrics (JAX's
    ``train_tail``). ``state`` is the stage's train state (its ``step``,
    ``scheduler`` and ``optimizer``, an ``AdamWStorage``), ``generator`` the
    steps' generator (on the state's device) or a tuple of the generators
    they draw from, ``max_steps`` the run's last
    step (the optimizer's table is grown to it before the capture).
    ``prepare(k)``, where given, stages the next ``k`` steps' batches
    before each bundle and each single step; ``ready()``, where given, must
    hold before a step is captured.

    ``capture_s`` is the capture's seconds (None before it) and
    ``replays`` the replays so far."""

    def __init__(self, step: Callable[[], Metrics], state, generator, max_steps: int,
                 prepare: Optional[Callable[[int], None]] = None,
                 ready: Optional[Callable[[], bool]] = None):
        self.step, self.state = step, state
        gens = generator if isinstance(generator, tuple) else (generator,)
        self.generators = [g for g in gens if g is not None]
        self.max_steps = max_steps
        self.prepare = prepare or (lambda k: None)
        self.ready = ready or (lambda: True)
        self.cuda = next(iter(_parameters(state))).is_cuda
        self.graph = None
        self.acc: Optional[Metrics] = None
        self.eager = 0  # eager bundle steps so far
        self.vq_launches = 0  # VQ kernel launches a replay runs
        self.capture_s = None
        self.replays = 0

    def single(self) -> Metrics:
        self.prepare(1)
        return self.step()

    def bundle(self, n: int) -> Metrics:
        self.prepare(n)
        for v in (self.acc or {}).values():
            v.zero_()
        done = 0
        if self.graph is None:
            cur = torch.cuda.current_stream() if self.cuda else None
            side = torch.cuda.Stream() if self.cuda else None
            if side is not None:
                side.wait_stream(cur)
            with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
                while done < n and (not self.cuda or self.eager < WARMUP or not self.ready()):
                    metrics = self.step()
                    if self.acc is None:
                        self.acc = {k: torch.zeros_like(v) for k, v in metrics.items()}
                    for k, v in metrics.items():
                        self.acc[k] += v
                    done += 1
                    self.eager += 1
            if side is not None:
                cur.wait_stream(side)
                if done < n:
                    self._capture()
        for _ in range(n - done):
            self._replay()
        return {k: v / n for k, v in self.acc.items()}

    def _capture(self) -> None:
        state, opt = self.state, self.state.optimizer
        opt.reserve(self.max_steps)
        host = (state.step, state.scheduler.state_dict(),
                [g["lr"] for g in opt.param_groups], opt.count)
        before = vq_kernel.captured_launches
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        t0 = time.perf_counter()
        # thread-local: a prefetch thread (the host feed) may pin memory meanwhile
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            for k, v in self.step().items():
                self.acc[k] += v
        self.capture_s = time.perf_counter() - t0
        state.step, sched, lrs, opt.count = host
        state.scheduler.load_state_dict(sched)
        for g, lr in zip(opt.param_groups, lrs):
            g["lr"] = lr
        self.vq_launches = vq_kernel.captured_launches - before
        self.graph = graph

    def _replay(self) -> None:
        self.graph.replay()
        self.replays += 1
        vq_kernel.launch_count += self.vq_launches
        self.state.step += 1
        self.state.scheduler.step()
        self.state.optimizer.count += 1


def _parameters(state):
    return (p for g in state.optimizer.param_groups for p in g["params"])
