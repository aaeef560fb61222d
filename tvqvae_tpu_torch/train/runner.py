"""Training orchestration: the three stages and the FCN feature net, their
checkpoints, mid-run snapshots and resume.

Port of ``tvqvae_tpu/train/runner.py``: ``_adamw``, ``_loop``,
``codebook_to_dict``/``codebook_from_dict``, ``config_meta``,
``_stage_completed``, ``load_stage1_bundle``, ``load_fcn_bundle``,
``train_stage1``, ``train_stage2``, ``train_stage3`` and ``train_fcn``. The
loops are the JAX package's device-data path: the train split (in stage 2
its token grids, in stage 3 its x' set beside it) is uploaded once, each
step gathers its batch on the device by index, and stage-1 validation runs
over the whole test split in fixed, wrap-padded batches with the padding
masked out of the sums. Nothing reads a value back from the device between
steps; the loop waits for the device only where it prints, validates or
snapshots. Batches follow ``make_batches(shuffle=True, seed=seed,
repeat=True)``; the JAX device path permutes on the device with threefry
instead, a deviation its own runner calls non-semantic. ``data_on_device=False``
(stage 1) feeds the same batches from the host, and ``precompute=False``
(stages 2 and 3) runs the frozen stage 1 inside every step, as in JAX.

``bundle_steps`` > 1 is JAX's bundled stepping (``make_multistep``): stage
1 (device gather or host feed), stage 2 on precomputed tokens and stage 3
on a precomputed x' advance that many steps a host dispatch
(``train/multistep.py``: on the card one captured CUDA graph of the step,
replayed; on the CPU the same steps in a loop), the logger gets the
bundle's means, a remainder smaller than a bundle runs as single steps,
and the log, validation and snapshot cadences fire where a bundle crosses
their boundary (``_loop``). The steps and their results are the single
steps'. As in JAX, the on-the-fly steps of stages 2 and 3 (tau > 0
included) and every step inside a process group take one step a dispatch.
JAX's host-fed stage-1 tail draws its batches from another seed; here the
tail continues the run's order.

Data parallelism (``parallel/``): the runners run unchanged in every rank of
a ``torch.distributed`` process group that the caller initialised, as JAX's
do under ``jax.distributed``. With more than one rank they take per-step
host batches, each rank its contiguous slice of every global batch
(``make_batches(process_index, process_count)``). PyTorch drives W cards of
one host as W processes where JAX drives them from one, so what JAX does
under ``jax.process_count() == 1`` the port does when every rank runs on
one host (``parallel.one_host``): stages 2 and 3 precompute their sweep,
spread over the data group, and step on their slices of the precomputed
arrays; ranks spread over hosts take the on-the-fly steps, as JAX's
multi-process runs do. The steps reduce what JAX reduces over the sharded
batch (BatchNorm statistics, the VQ statistics and its k-means init and
dead-code rows, the masked cross-entropy, the gradients), so W ranks take
the step one process takes over the global batch; rank r draws its dropouts
and masks from its own generator. The validations of stages 2-3 sample over
the data group where it divides ``evaluation.batch_size``, as JAX's runners
hand their sampler the mesh; the primary rank scores them, prints, logs and
writes every file; the others wait at a barrier. JAX bundles its steps
whenever ``jax.process_count() == 1``; the port bundles only without a
process group (``_bundle``).

Tensor parallelism (``tp`` > 1, ``parallel/tp.py``): the W ranks form a
(W / tp, tp) grid, as JAX's runner builds its 2-D mesh; W must divide by
``tp``. The batch is split over the data index alone (the ranks of a model
group take the same rows and draw the same dropouts and masks: their
generator is seeded by the data index), and after init and resume the
stage's big parameters and their AdamW moments are cut to slices over the
model group (``shard_train_state_tp``, JAX's ``_place_state``); the frozen
stage 1 of stages 2 and 3 stays whole. Validation runs on every rank of a
model group together; snapshots and checkpoints hold the full tensors, so
their layout does not depend on ``tp``, and a run returns its state whole.

Stages 2 and 3 take their frozen stage 1 in memory: ``load_stage1_bundle``
of a stage-1 checkpoint (as the JAX runner reads it),
``FrozenStage1.from_stage1_state`` of a ``train_stage1`` result, or
``FrozenStage1.from_state_dict`` of a JAX tree.

With ``save_path`` a stage writes its checkpoint at the end
(``utils/checkpoint.py``: the JAX package's tree layout in an ``.npz`` at
exactly ``save_path``, its meta at ``save_path + ".meta.json"`` with the
``completed_step``), skips itself when that meta already records the
budget, snapshots its full train state to ``save_path + ".train"`` at each
validation boundary but the last, and resumes from that snapshot. Snapshots
are synchronous: the JAX package's ``AsyncSnapshotter`` hides a slow link to
its device, which the card's host does not have. The runners also return
their final state (the FCN runner its trained module).

With ``metrics`` (an ``evaluation.Metrics``) stages 2 and 3 score samples at
each validation: ``val_n_samples`` (default ``min(min_num_gen_samples,
1024)``) unconditional series from the priors being trained (stage 2) or
from ``stage2_ckpt``'s, raw and through the enhancer being trained (stage
3), against ``metrics.z_test`` (FID by ``"svd"``) and ``metrics.X_test``,
logged as ``val/running_metrics/{FID,MDD,ACD,SD,KD}[ with FE]``.
"""

import contextlib
import dataclasses
import functools
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.data.dataset import DatasetSplits, make_batches
from tvqvae_tpu_torch.models.fcn import FCN
from tvqvae_tpu_torch.models.fidelity_enhancer import FidelityEnhancer
from tvqvae_tpu_torch.models.layers import init_weights_
from tvqvae_tpu_torch.models.maskgit import FrozenStage1, MaskGITSpec, build_transformers
from tvqvae_tpu_torch.models.stage1 import Stage1Spec, init_stage1
from tvqvae_tpu_torch.models.vq import CodebookState
from tvqvae_tpu_torch.parallel.mesh import (
    all_gather,
    all_gather_object,
    all_reduce_,
    all_reduce_grads,
    all_reduce_metrics,
    broadcast_,
    data_count,
    data_index,
    initialized,
    is_primary,
    one_host,
    prefetch_batches,
    process_count,
    replicate_,
    shard_batch,
)
from tvqvae_tpu_torch.parallel.tp import (
    full_optimizer_state,
    gathered,
    make_mesh2d,
    shard_train_state_tp,
    unshard_train_state_tp,
)
from tvqvae_tpu_torch.train.multistep import Multistep
from tvqvae_tpu_torch.train.optim import adamw
from tvqvae_tpu_torch.train.stage1 import (
    Stage1TrainState,
    create_stage1_state,
    make_stage1_eval_step,
    make_stage1_train_step,
)
from tvqvae_tpu_torch.train.stage2 import (
    Stage2TrainState,
    create_stage2_state,
    init_stage2,
    make_sampling_fn,
    make_stage2_train_step,
    precompute_token_dataset,
    priors_from_tree,
    stage2_train_step_tokens,
)
from tvqvae_tpu_torch.train.stage3 import (
    Stage3TrainState,
    create_stage3_state,
    init_stage3,
    make_stage3_train_step,
    make_stage3_train_step_pre,
    precompute_xprime_dataset,
)
from tvqvae_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_train_state,
    save_checkpoint,
    save_train_state,
)
from tvqvae_tpu_torch.utils.convert import (
    codebook_to_dict,
    fcn_from_jax,
    fcn_to_jax,
    fe_to_jax,
    prior_to_jax,
    stage1_from_jax,
    stage1_to_jax,
)
from tvqvae_tpu_torch.utils.device import resolve_device
from tvqvae_tpu_torch.utils.profiling import StepTimer
from tvqvae_tpu_torch.utils.schedule import cosine_decay_schedule, warmup_cosine_schedule


def codebook_from_dict(d: dict) -> CodebookState:
    """A codebook on the CPU (``.to(device)`` moves it)."""
    return CodebookState(*(torch.as_tensor(np.asarray(d[f]))
                           for f in ("embed", "embed_avg", "cluster_size", "initted")))


# --------------------------------------------------------------------------
# checkpoints, snapshots and resume


def config_meta(cfg: Config, data: DatasetSplits,
                completed_step: Optional[int] = None) -> dict:
    meta = {
        "config": dataclasses.asdict(cfg),
        "input_length": int(data.input_length),
        "in_channels": int(data.in_channels),
        "n_classes": int(data.n_classes),
    }
    if completed_step is not None:
        meta["completed_step"] = int(completed_step)
    return meta


def _stage_completed(save_path: str, max_steps: int, resume: bool,
                     name: str) -> bool:
    """Stage idempotency via the checkpoint meta: a finished stage records
    its completed step, so calling the stage again returns at once instead
    of retraining from the last mid-run snapshot."""
    if not resume:
        return False
    try:
        with open(os.path.abspath(save_path) + ".meta.json") as f:
            done = int(json.load(f).get("completed_step", -1))
    except (OSError, ValueError, TypeError):
        return False
    if done >= max_steps:
        _say(f"[{name}] checkpoint already records completed_step {done} "
              f">= max_steps {max_steps}; skipping (pass resume=False or "
              f"delete the checkpoint to retrain)")
        return True
    return False


def load_stage1_bundle(cfg: Config, stage1_ckpt: str, device="cuda",
                       compute_dtype: str = "float32", fast_bn: bool = False,
                       bf16_head: bool = False, bf16_istft: bool = False):
    """A stage-1 checkpoint -> (FrozenStage1 on ``device``, Stage1Spec, meta);
    the geometry comes from the meta, the rest of the spec from ``cfg``.
    ``compute_dtype``, ``fast_bn``, ``bf16_head`` and ``bf16_istft`` set the
    loaded stacks' inference precision (the checkpoint's parameters are
    float32 either way); the stage 1 that stages 2-3 train over is float32."""
    dev = resolve_device(device)
    tree, meta = load_checkpoint(stage1_ckpt)
    spec = Stage1Spec.from_config(cfg, int(meta["input_length"]), int(meta["in_channels"]),
                                  compute_dtype=compute_dtype, fast_bn=fast_bn,
                                  bf16_head=bf16_head, bf16_istft=bf16_istft)
    frozen = FrozenStage1.from_state_dict(spec, stage1_from_jax(tree), dev)
    frozen.model.requires_grad_(False)
    return frozen, spec, meta


def load_fcn_bundle(fcn_ckpt: str, device="cuda"):
    """An FCN checkpoint -> (the FCN in eval mode on ``device``, meta)."""
    tree, meta = load_checkpoint(fcn_ckpt)
    fcn = FCN(int(meta["in_channels"]), int(meta["n_classes"]))
    fcn.load_state_dict(fcn_from_jax(tree))
    return fcn.to(resolve_device(device)).eval(), meta


def _say(*args, **kw) -> None:
    """``print`` on the primary rank only."""
    if is_primary():
        print(*args, **kw)


def train_state_payload(state, generator: torch.Generator) -> dict:
    """What resumes ``state`` (a stage's train state) exactly: the state dict
    of each module in it, its codebooks, the optimizer's and the schedule's
    states, the step, and the state of the generator the steps draw from:
    ``generators`` holds one per slice of the batch, in data-index order
    (each slice draws its own dropouts and masks); a generator in the
    state (stage 1's ``draws``, the same on every rank) is written under its
    field's name. Tensor-parallel
    parameters and moments are written whole (``parallel/tp.py``), so the
    layout does not depend on ``tp``. Inside a process group every rank
    calls this together."""
    modules = [getattr(state, f.name) for f in dataclasses.fields(state)]
    optimizer = full_optimizer_state(state.optimizer)  # before the parameters are gathered
    with gathered(*(m for m in modules if isinstance(m, torch.nn.Module))):
        payload = {"step": int(state.step),
                   "generators": all_gather_object(generator.get_state()),
                   "optimizer": optimizer, "scheduler": state.scheduler.state_dict()}
        for f, v in zip(dataclasses.fields(state), modules):
            if isinstance(v, torch.nn.Module):
                payload[f.name] = v.state_dict()
            elif isinstance(v, CodebookState):
                payload[f.name] = {c.name: getattr(v, c.name) for c in dataclasses.fields(v)}
            elif isinstance(v, torch.Generator):  # the same on every rank (stage 1's draws)
                payload[f.name] = v.get_state()
    return payload


def restore_train_state(state, generator: torch.Generator, payload: dict) -> int:
    """Load ``train_state_payload``'s payload into a freshly built, whole
    ``state`` of the same shapes (the schedule rebuilt by the caller, then
    its counter loaded) and into ``generator``, the stream of this rank's
    slice of the batch. -> the step it resumes after. A snapshot resumes
    only with the batch split into as many slices as when it was written."""
    gens = payload["generators"]
    if len(gens) != data_count():
        raise ValueError(f"the snapshot holds the generators of {len(gens)} batch slices, "
                         f"not of {data_count()}: resume with as many data-parallel ranks")
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.nn.Module):
            v.load_state_dict(payload[f.name])
        elif isinstance(v, CodebookState):
            setattr(state, f.name, CodebookState(**payload[f.name]).to(v.embed.device))
        elif isinstance(v, torch.Generator):
            v.set_state(payload[f.name])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.scheduler.load_state_dict(payload["scheduler"])
    generator.set_state(gens[data_index()])
    state.step = int(payload["step"])
    return state.step


def _resume(save_path: Optional[str], resume: bool, state, generator, name: str) -> int:
    """The step a run starts after: that of ``save_path + ".train"``, loaded
    into ``state`` and ``generator``, or 0. Every rank reads the same
    snapshot."""
    if not (save_path and resume and os.path.exists(save_path + ".train")):
        return 0
    step = restore_train_state(state, generator, load_train_state(save_path + ".train"))
    _say(f"[{name}] resuming from step {step}")
    return step


def _snapshotter(save_path: Optional[str], state, generator):
    if not save_path:
        return None
    return lambda step: save_train_state(save_path + ".train",
                                         train_state_payload(state, generator))


def _save_stage(name: str, save_path: str, tree: dict, cfg: Config, data: DatasetSplits,
                completed_step: Optional[int]) -> None:
    t0 = time.time()
    save_checkpoint(save_path, tree, meta=config_meta(cfg, data, completed_step))
    _say(f"[{name}] checkpoint {save_path}: {os.path.getsize(save_path) / 1e6:.1f} MB "
         f"in {time.time() - t0:.1f}s")


def _rank_generator(seed: int, dev) -> torch.Generator:
    """The generator of this rank's dropouts, masks and SVQ draws: seeded
    ``seed`` for the first slice of the batch (a one-process run's), with
    the data index folded in for the others, so the slices do not share
    masks and the ranks of a model group, which hold one slice, draw the
    same ones."""
    return torch.Generator(device=dev).manual_seed(seed + (data_index() << 32))


def _draw_generator(seed: int, dev) -> torch.Generator:
    """The generator of stage 1's k-means and dead-code rows: seeded
    ``seed`` on every rank and in one process, so that the ranks draw the
    rows one process draws (JAX draws them from its one replicated key)."""
    return torch.Generator(device=dev).manual_seed(seed)


def _replicate(*parts) -> None:
    """Broadcast rank 0's modules and codebooks (``CodebookState``) to every
    rank; they are built from one seed, so this only guards the invariant."""
    for part in parts:
        if isinstance(part, CodebookState):
            for f in dataclasses.fields(part):
                broadcast_(getattr(part, f.name))
        else:
            replicate_(part)


class _Feed:
    """A stage's batches, each step's read through device state, so that a
    CUDA graph of the step reads the next batch at each replay
    (``train/multistep.py``): ``next()`` returns the step's batch of each
    array of ``arrays`` (None passing through) on ``dev``, in
    ``make_batches(shuffle=True, seed=seed, repeat=True)``'s global order,
    from step ``start_step`` + 1 on; ``prepare(k)`` comes before every ``k``
    steps (a bundle, or a single step).

    One process with ``on_device`` uploads the arrays (numpy arrays, or
    tensors) once and gathers every batch on the device by a device step
    counter into the step order (``_batch_order``), as does every rank of a
    grid with one data index. Otherwise, or when the batch is split over
    more than one rank (as in JAX), per-step host batches, each rank its
    data index's slice of every global batch, reach ``dev`` through
    ``prefetch_batches``, and ``prepare(k)`` stages the next ``k`` into a
    static buffer of ``bundle`` batches on the device (JAX's ``_stacked``),
    which the steps read in turn: the same batches."""

    def __init__(self, arrays, batch_size: int, max_steps: int, seed: int, dev,
                 start_step: int = 0, on_device: bool = True, bundle: int = 1):
        N = len(arrays[0])
        self.bundle, self.host = bundle, None
        if on_device and data_count() == 1:
            self.order = _batch_order(N, batch_size, max_steps, seed, dev)
            self.arrays = [None if a is None else torch.as_tensor(a).to(dev) for a in arrays]
            self.t = torch.full((1,), start_step, dtype=torch.int64, device=dev)
            return
        if N < batch_size:
            raise ValueError(f"{N} training series, fewer than one batch of {batch_size}")
        order = make_batches(np.arange(N), None, batch_size, shuffle=True, seed=seed,
                             repeat=True, process_index=data_index(),
                             process_count=data_count())
        for _ in range(start_step):
            next(order)
        self.host = prefetch_batches((tuple(None if a is None else a[idx] for a in arrays)
                                      for idx, _ in order), dev, size=max(2, bundle))
        self.buffers, self.j = None, torch.zeros(1, dtype=torch.int64, device=dev)

    def prepare(self, k: int) -> None:
        if self.host is None:
            return
        got = [next(self.host) for _ in range(k)]
        if self.buffers is None:
            self.buffers = [None if t is None else t.new_empty((self.bundle, *t.shape))
                            for t in got[0]]
        for i, buf in enumerate(self.buffers):
            if buf is not None:
                torch.stack([g[i] for g in got], out=buf[:k])
        self.j.zero_()

    def next(self) -> tuple:
        if self.host is None:
            idx = self.order.index_select(0, self.t)[0]
            self.t += 1
            return tuple(None if a is None else a.index_select(0, idx) for a in self.arrays)
        batch = tuple(None if b is None else b.index_select(0, self.j)[0] for b in self.buffers)
        self.j += 1
        return batch


def _adamw(cfg: Config, max_steps: int, bf16_mu: bool = False, bf16_nu: bool = False) -> Callable:
    """AdamW (weight decay 0.01) with the reference warmup-cosine schedule, as
    ``tx(parameters) -> (optimizer, scheduler)``; ``bf16_mu``/``bf16_nu``
    store the first/second moment in bfloat16 (the update stays float32)."""
    schedule = warmup_cosine_schedule(cfg.exp_params.lr, max_steps,
                                      cfg.exp_params.linear_warmup_rate)
    return functools.partial(adamw, learning_rate=schedule, weight_decay=0.01,
                             mu_dtype=torch.bfloat16 if bf16_mu else None,
                             nu_dtype=torch.bfloat16 if bf16_nu else None)


def _loop(name: str, max_steps: int, train_once, eval_once, logger, val_interval: int,
          log_interval: int = 100, start_step: int = 0, snapshot=None, stride: int = 1,
          train_tail=None):
    """Train steps ``start_step`` + 1..``max_steps``: ``train_once(step)``
    takes ``stride`` steps (a bundle, ``train/multistep.py``) ending at
    ``step``, which stays in true steps, and returns their metrics' means; a
    remainder that does not fill a bundle runs through ``train_tail(step)``,
    one step each, so the loop ends at ``max_steps`` exactly (a resume with
    fewer than a bundle left included); without ``train_tail`` the
    remainder is trimmed, with a notice. Log where a bundle crosses a
    multiple of ``log_interval``, validate and print where it crosses one of
    ``val_interval``, and both at the end; at each validation but the last
    call ``snapshot(step)`` (the stage checkpoint supersedes it). JAX's
    ``_loop``. ``logger.log_metrics(metrics, step)`` gets the train metrics
    as 0-dim device tensors (reading one waits for the device) and the
    validation metrics as floats.

    Inside a process group every rank runs the loop: the train metrics are
    averaged over the ranks where they are logged or printed (at the same
    steps on every rank), and the primary alone prints and logs."""
    timer = StepTimer()
    t0 = time.time()
    last = {"step": start_step, "t": t0}  # segment-rate anchor
    logger = logger if is_primary() else None
    tail = (max_steps - start_step) % stride if stride > 1 else 0
    if tail and train_tail is None:
        _say(f"[{name}] bundle stride {stride} trims max_steps to {max_steps - tail} "
             f"(from {max_steps})")
        max_steps -= tail
        tail = 0

    def emit(step, metrics, width):
        timer.tick(width)
        at_log = step % log_interval < width or step == max_steps
        at_val = step % max(val_interval, 1) < width or step == max_steps
        if at_log or at_val:
            metrics = all_reduce_metrics(metrics)
        if logger and at_log:
            logger.log_metrics({f"train/{k}": v for k, v in metrics.items()}
                               | timer.summary(), step)
        if at_val:
            val = eval_once(step) if eval_once else {}
            now = time.time()
            rate = (step - start_step) / (now - t0)
            # the rate since the last print shows a slowdown a cumulative one hides
            seg = (step - last["step"]) / max(now - last["t"], 1e-9)
            last["step"], last["t"] = step, now
            line = " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
            _say(f"[{name}] step {step}/{max_steps} "
                 f"({rate:.1f} it/s cum, {seg:.1f} seg) {line}")
            if logger and val:
                logger.log_metrics({f"val/{k}": v for k, v in val.items()}, step)
            if snapshot is not None and step < max_steps:
                snapshot(step)

    for step in range(start_step + stride, max_steps - tail + 1, stride):
        emit(step, train_once(step), stride)
    for step in range(max_steps - tail + 1, max_steps + 1):
        emit(step, train_tail(step), 1)


def _bundle(name: str, bundle_steps: int) -> int:
    """The steps a stage's bundles take: ``bundle_steps``, or 1 inside a
    process group (a one-rank one too), whose collectives a CUDA graph
    cannot capture; JAX keeps per-step dispatch with more than one process
    as well."""
    if bundle_steps < 1:
        raise ValueError(f"bundle_steps must be at least 1, got {bundle_steps}")
    if bundle_steps > 1 and initialized():
        _say(f"[{name}] inside a process group: one step a dispatch, not bundles of "
             f"{bundle_steps}")
        return 1
    return bundle_steps


def _bundled(name: str, bundle: int, step, state, generator, max_steps: int, feed=None,
             ready=None):
    """-> (``train_once``, the other ``_loop`` arguments) of a stage trained
    in bundles of ``bundle`` steps of ``step`` (``train/multistep.py``,
    whose ``prepare`` is ``feed``'s; ``generator`` one generator the steps
    draw from, or a tuple of them); with ``bundle`` 1 each step is an eager
    step."""
    ms = Multistep(step, state, generator, max_steps,
                   prepare=feed.prepare if feed is not None else None, ready=ready)
    if bundle == 1:
        return (lambda step: ms.single()), {}

    def train_once(step):
        captured = ms.graph is not None
        metrics = ms.bundle(bundle)
        if not captured and ms.graph is not None:
            _say(f"[{name}] step captured as one CUDA graph in {ms.capture_s:.2f}s; "
                 f"bundles of {bundle} steps replay it")
        return metrics

    return train_once, dict(stride=bundle, train_tail=lambda step: ms.single())


RNG_IMPLS = (None, "threefry2x32", "rbg", "unsafe_rbg")  # jax.random.key's impl names


def _train_grid(tp: int):
    """The context a stage trains in: with ``tp`` > 1 the (W / tp, tp) grid
    of the W ranks (``parallel/tp.py``, JAX's ``_make_train_mesh``), else
    none. A world that ``tp`` does not divide raises."""
    if tp <= 1:
        return contextlib.nullcontext()
    W = process_count()
    if W % tp:
        raise ValueError(f"{W} devices not divisible by tp={tp}")
    return make_mesh2d(W // tp, tp)


def _validating(metrics) -> bool:
    """Whether the primary scores validations (in the train CLI it alone
    holds ``metrics``), on every rank: they all take part in a validation
    that fans out over the data group or gathers split weights."""
    return all_gather_object(metrics is not None, torch.distributed.group.WORLD)[0]


def _val_fan_out(cfg: Config, name: str) -> bool:
    """Whether a stage's validations sample over the data group: inside a
    process group of more than one slice whose count divides
    ``evaluation.batch_size``, as JAX's runners hand the sampler their mesh;
    otherwise the primary samples alone, as JAX does without one."""
    if data_count() == 1:
        return False
    if cfg.evaluation.batch_size % data_count():
        _say(f"[{name}] validation batch {cfg.evaluation.batch_size} not divisible by "
             f"{data_count()} data slices: the primary samples alone")
        return False
    return True


def _val_samples(cfg: Config, sample_fn: Callable, n_val: Optional[int], seed: int, dev,
                 enhance: Optional[Callable] = None, data_parallel: bool = False):
    """``n_val`` (default ``min(min_num_gen_samples, 1024)``) unconditional
    series in batches of ``evaluation.batch_size`` from a generator seeded
    ``seed`` -> host arrays [("", x)] and, with ``enhance``, (" with FE",
    enhance(x)) batch by batch. With ``data_parallel`` every rank calls it
    together with a ``sample_fn`` over the data group
    (``make_sampling_fn(data_parallel=True)``), and each rank enhances its
    slice of a batch that the group divides, the slices gathered in rank
    order."""
    n_val = n_val or min(cfg.evaluation.min_num_gen_samples, 1024)
    vbatch = cfg.evaluation.batch_size
    gen = torch.Generator(device=dev).manual_seed(seed)
    xs, xs_fe = [], []
    for start in range(0, n_val, vbatch):
        x = sample_fn(min(vbatch, n_val - start), None, generator=gen)[2]
        xs.append(x.cpu().numpy())
        if enhance is not None:
            with torch.inference_mode():
                split = data_parallel and len(x) % data_count() == 0
                xs_fe.append((all_gather(enhance(shard_batch(x))) if split
                              else enhance(x)).cpu().numpy())
    sets = [("", np.concatenate(xs))]
    if enhance is not None:
        sets.append((" with FE", np.concatenate(xs_fe)))
    return sets


def _running_metrics(metrics, sets) -> dict:
    """FID (``"svd"``, the outlier filter on) against ``metrics.z_test`` and
    MDD/ACD/SD/KD against ``metrics.X_test``, per (tag, series) of
    ``sets``, under the JAX package's ``running_metrics/...`` names."""
    out = {}
    for tag, x in sets:
        out[f"running_metrics/FID{tag}"] = metrics.fid_score(metrics.z_test, metrics.z_gen_fn(x),
                                                             method="svd")
        mdd, acd, sd, kd = metrics.stat_metrics(metrics.X_test, x)
        out[f"running_metrics/MDD{tag}"] = mdd
        out[f"running_metrics/ACD{tag}"] = acd
        out[f"running_metrics/SD{tag}"] = sd
        out[f"running_metrics/KD{tag}"] = kd
    return out


def _precompute_here(name: str) -> bool:
    """Whether a stage precomputes its sweep: in one process, and inside a
    process group whose ranks all run on this host (``parallel.one_host``),
    the sweep spread over the data group; ranks spread over hosts take the
    on-the-fly steps, as JAX's multi-process runs do (JAX precomputes
    whenever ``jax.process_count() == 1``)."""
    if one_host():
        return True
    _say(f"[{name}] ranks on more than one host: the frozen stage 1 runs inside every step, "
         f"as in JAX's multi-process runs")
    return False


def _batch_order(N: int, batch_size: int, steps: int, seed: int, dev) -> torch.Tensor:
    """(steps, batch_size) row indices on ``dev``, in
    ``make_batches(shuffle=True, seed=seed, repeat=True)``'s order."""
    if N < batch_size:
        raise ValueError(f"{N} training series, fewer than one batch of {batch_size}")
    batches = make_batches(np.arange(N), None, batch_size, shuffle=True, seed=seed, repeat=True)
    return torch.from_numpy(np.stack([next(batches)[0] for _ in range(steps)])).to(dev)


def train_stage1(
    cfg: Config,
    data: DatasetSplits,
    max_steps: Optional[int] = None,
    seed: int = 0,
    logger=None,
    bundle_steps: int = 1,
    device="cuda",
    log_interval: int = 100,
    compute_dtype: str = "float32",
    remat: bool = False,
    fast_bn: bool = False,
    bf16_mu: bool = False,
    bf16_nu: bool = False,
    bf16_head: bool = False,
    bf16_istft: bool = False,
    tp: int = 1,
    rng_impl: Optional[str] = None,
    save_path: Optional[str] = None,
    resume: bool = True,
    data_on_device: bool = True,
) -> Optional[Stage1TrainState]:
    """Train stage 1 from seeded random weights for ``max_steps`` (default:
    the config's) and return the final state, or None when ``save_path``'s
    meta already records that many steps (with ``resume``). With
    ``save_path`` it resumes from, and snapshots to, ``save_path +
    ".train"`` and writes ``{"params", "batch_stats", "vq_l", "vq_h",
    "step"}`` there at the end. Batches of
    ``dataset.batch_sizes["stage1"]`` follow ``make_batches(shuffle=True,
    seed=seed, repeat=True)``; dropout masks come from a generator seeded
    ``seed + 1`` (rank 0's). ``compute_dtype``, ``remat``, ``fast_bn``, ``bf16_head``
    and ``bf16_istft`` go into the spec (``models/stage1.py``), ``bf16_mu``
    and ``bf16_nu`` into the optimizer (``_adamw``), as in the JAX runner.
    With ``data_on_device`` (the default) the train split is uploaded once
    and each step gathers its batch on the device; without it, or inside a
    process group of more than one rank (as in JAX), each step's batch comes
    from the host (``_Feed``), the same batches. Inside a process group
    each rank steps on its slice of every global batch: the BatchNorm
    statistics, the VQ's EMA statistics, the gradients and the logged
    metrics are the global batch's (``parallel/``), rank r's dropout masks
    come from its own generator (``_rank_generator``), the primary alone
    writes the checkpoint and snapshots (holding every slice's generator),
    and validation spreads its batches over the data index. With ``tp`` > 1
    the ranks train as a (W / tp, tp) grid (module docstring).
    The rows of the codebooks' k-means init and dead-code expiry (both off
    in the published config) come from a generator of their own, seeded
    ``seed + 2`` alike on every rank (``_draw_generator``, the state's
    ``draws``), so W ranks draw the global batch's rows that one process
    draws; the snapshot holds its state.
    ``bundle_steps`` > 1 trains in bundles of that many steps (module
    docstring), on the device gather and on the host feed, whose bundle's
    batches are staged on the device together. ``rng_impl`` names the XLA
    PRNG implementation of JAX's dropout key (``"rbg"`` under the CLI's
    ``--rbg_rng``); it is accepted and changes nothing here: the masks come
    from torch's generator, on the card Philox4x32-10, a counter-based
    generator as rbg is, and JAX's runs under either implementation differ
    only in their masks (``tests/test_rbg_rng.py``)."""
    if rng_impl not in RNG_IMPLS:
        raise ValueError(f"rng_impl {rng_impl!r} is none of JAX's {RNG_IMPLS[1:]}")
    grid = _train_grid(tp)
    dev = resolve_device(device)
    batch_size = cfg.dataset.batch_sizes.get("stage1", 32)
    max_steps = max_steps or cfg.trainer_params.max_steps["stage1"]
    if save_path and _stage_completed(save_path, max_steps, resume, "stage1"):
        return None

    with grid:
        t_init = time.time()
        spec = Stage1Spec.from_config(cfg, data.input_length, data.in_channels,
                                      compute_dtype=compute_dtype, remat=remat, fast_bn=fast_bn,
                                      bf16_head=bf16_head, bf16_istft=bf16_istft)
        model, vq_l, vq_h = init_stage1(spec, torch.Generator().manual_seed(seed), dev)
        _replicate(model, vq_l, vq_h)
        state = create_stage1_state(model, vq_l, vq_h, _adamw(cfg, max_steps, bf16_mu, bf16_nu),
                                    draws=_draw_generator(seed + 2, dev))
        _say(f"[stage1] model init: {time.time() - t_init:.1f}s")

        gen = _rank_generator(seed + 1, dev)
        start_step = _resume(save_path, resume, state, gen, "stage1")
        shard_train_state_tp(state)  # JAX's _place_state: a no-op without a grid
        step_fn = make_stage1_train_step(in_place=True)
        t_up = time.time()
        bundle = _bundle("stage1", bundle_steps)
        feed = _Feed((data.X_train,), batch_size, max_steps, seed, dev, start_step,
                     data_on_device, bundle)
        if data_on_device and data_count() == 1:
            _say(f"[stage1] train split -> {dev}: {data.X_train.nbytes / 1e6:.0f} MB in "
                 f"{time.time() - t_up:.1f}s")
        # k-means init latches on the first step: a graph is captured after it
        latched = spec.vq_l.kmeans_init or spec.vq_h.kmeans_init
        train_once, bundled = _bundled(
            "stage1", bundle, lambda: step_fn(state, feed.next()[0], gen)[1], state,
            (gen, state.draws), max_steps, feed,
            ready=(lambda: bool(state.vq_l.initted) and bool(state.vq_h.initted)) if latched
            else None)

        eval_once = _make_eval(state, data.X_test, batch_size, dev) if len(data.X_test) else None
        t_loop = time.time()
        _loop("stage1", max_steps, train_once, eval_once, logger,
              cfg.trainer_params.val_check_interval.get("stage1", 5000), log_interval,
              start_step, _snapshotter(save_path, state, gen), **bundled)
        _say(f"[stage1] loop {time.time() - t_loop:.1f}s")
        unshard_train_state_tp(state)
    if save_path:
        tree = stage1_to_jax(state.model, state.vq_l, state.vq_h)
        _save_stage("stage1", save_path, {**tree, "step": np.asarray(state.step, np.int32)},
                    cfg, data, state.step)
    return state


def train_stage2(
    cfg: Config,
    data: DatasetSplits,
    frozen: FrozenStage1,
    max_steps: Optional[int] = None,
    seed: int = 0,
    logger=None,
    bundle_steps: int = 1,
    bf16_mu: bool = False,
    bf16_nu: bool = False,
    tp: int = 1,
    metrics=None,
    val_n_samples: Optional[int] = None,
    device="cuda",
    log_interval: int = 100,
    save_path: Optional[str] = None,
    resume: bool = True,
    precompute: bool = True,
) -> Optional[Stage2TrainState]:
    """Train both MaskGIT priors from seeded random weights over ``frozen``
    (on ``device``) for ``max_steps`` (default: the config's) and return the
    final state, or None when ``save_path``'s meta already records that many
    steps. ``save_path`` and ``resume`` work as in ``train_stage1``; the
    checkpoint is ``{"params": {"l", "h"}, "h_stats", "step"}``. A resumed
    run encodes the token dataset again (the sweep is deterministic).

    With ``precompute`` (the default) one sweep encodes the train split to
    token grids through the VQ kernel, and the steps run on those: one
    process gathers them on the device; inside a process group whose ranks
    share one host the sweep spreads over the data group and each rank
    takes its slice of every global batch from the host (``_Feed``).
    Without it, or over ranks on more than one host (as in JAX), each step
    encodes its batch through the frozen stage 1
    (``train/stage2.py::make_stage2_train_step``, two VQ launches) and makes
    the same update from the same generator state: one process gathers the
    batch on the device, the ranks of a group take host batches
    (``_Feed``). Batches of ``dataset.batch_sizes["stage2"]`` follow
    ``make_batches(shuffle=True, seed=seed, repeat=True)`` (the JAX token
    path permutes on the device with threefry instead, a deviation its own
    runner calls non-semantic); masks and dropouts come from a generator
    seeded ``seed + 1`` (rank 0's). With ``metrics`` (the primary's) each
    validation scores ``val_n_samples`` series sampled from the priors as
    they are, from a generator seeded ``10_000 + step`` (module docstring),
    on the primary rank, the batches decoded over the data group where it
    divides ``evaluation.batch_size``. ``bf16_mu``/``bf16_nu`` store Adam's moments in bfloat16. Inside
    a process group the ranks step as in ``train_stage1``: the HF prior's
    BatchNorm statistics, the masked cross-entropies' denominators, the
    gradients and the logged metrics are the global batch's. With ``tp`` > 1
    the ranks train as a (W / tp, tp) grid (module docstring): the priors'
    big parameters split over the model group, ``frozen`` whole on every
    rank, each validation sampling from the priors gathered whole.
    ``bundle_steps`` > 1 trains the token path in bundles (module
    docstring); the on-the-fly path takes one step a dispatch, as in
    JAX."""
    grid = _train_grid(tp)
    dev = resolve_device(device)
    if frozen.vq_l.embed.device.type != dev.type:
        raise ValueError(f"the frozen stage 1 is on {frozen.vq_l.embed.device}, not {dev}")
    batch_size = cfg.dataset.batch_sizes.get("stage2", 16)
    max_steps = max_steps or cfg.trainer_params.max_steps["stage2"]
    if save_path and _stage_completed(save_path, max_steps, resume, "stage2"):
        return None

    with grid:
        t_l, t_h = init_stage2(*build_transformers(cfg, frozen.model.spec, data.n_classes),
                               torch.Generator().manual_seed(seed), dev)
        _replicate(t_l, t_h)
        state = create_stage2_state(t_l, t_h, _adamw(cfg, max_steps, bf16_mu, bf16_nu))
        gen = _rank_generator(seed + 1, dev)
        start_step = _resume(save_path, resume, state, gen, "stage2")
        shard_train_state_tp(state)  # JAX's _place_state: a no-op without a grid
        if precompute and _precompute_here("stage2"):
            t0 = time.time()
            tok_l, tok_h = precompute_token_dataset(frozen,
                                                    torch.from_numpy(data.X_train).to(dev),
                                                    batch_size=max(batch_size, 64),
                                                    data_parallel=initialized())
            _say(f"[stage2] precomputed {len(tok_l)} token rows in {time.time() - t0:.1f}s")
            feed = _Feed((tok_l, tok_h, data.y_train), batch_size, max_steps, seed, dev,
                         start_step)
            train_once, bundled = _bundled(
                "stage2", _bundle("stage2", bundle_steps),
                lambda: stage2_train_step_tokens(state, *feed.next(), gen)[1],
                state, gen, max_steps, feed)
        else:  # per-step dispatch, as in JAX
            step_fn = make_stage2_train_step(frozen)
            feed = _Feed((data.X_train, data.y_train), batch_size, max_steps, seed, dev,
                         start_step)
            train_once, bundled = _bundled("stage2", 1,
                                           lambda: step_fn(state, *feed.next(), gen)[1],
                                           state, gen, max_steps, feed)

        eval_once = None
        if _validating(metrics):
            fan_out = _val_fan_out(cfg, "stage2")
            sample_fn = make_sampling_fn(frozen, state.t_l, state.t_h,
                                         MaskGITSpec.from_config(cfg, frozen.model.spec),
                                         data_parallel=fan_out)

            def eval_once(step):
                with gathered(state.t_l, state.t_h):
                    if not (fan_out or is_primary()):
                        return {}
                    sets = _val_samples(cfg, sample_fn, val_n_samples, 10_000 + step, dev,
                                        data_parallel=fan_out)
                    return _running_metrics(metrics, sets) if is_primary() else {}

        _loop("stage2", max_steps, train_once, eval_once, logger,
              cfg.trainer_params.val_check_interval.get("stage2", 10000), log_interval,
              start_step, _snapshotter(save_path, state, gen), **bundled)
        unshard_train_state_tp(state)
    if save_path:
        params, h_stats = prior_to_jax(state.t_l, state.t_h)
        _save_stage("stage2", save_path, {"params": params, "h_stats": h_stats,
                                          "step": np.asarray(state.step, np.int32)},
                    cfg, data, state.step)
    return state


def train_stage3(
    cfg: Config,
    data: DatasetSplits,
    frozen: FrozenStage1,
    max_steps: Optional[int] = None,
    tau: float = 0.0,
    seed: int = 0,
    logger=None,
    stage2_ckpt=None,
    metrics=None,
    val_n_samples: Optional[int] = None,
    bundle_steps: int = 1,
    compute_dtype: str = "float32",
    fast_norm: bool = False,
    bf16_mu: bool = False,
    bf16_nu: bool = False,
    tp: int = 1,
    device="cuda",
    log_interval: int = 100,
    save_path: Optional[str] = None,
    resume: bool = True,
    precompute: bool = True,
) -> Optional[Stage3TrainState]:
    """Train the fidelity enhancer from seeded random weights over ``frozen``
    (on ``device``) for ``max_steps`` (default: the config's) and return the
    final state, or None when ``save_path``'s meta already records that many
    steps. ``save_path`` and ``resume`` work as in ``train_stage1``; the
    checkpoint is ``{"params": {"Unet1D_0": ...}, "tau", "step"}`` with the
    ``tau`` the run trained at.

    With ``precompute`` (the default) at tau = 0 one sweep computes x' for
    the train split through the VQ kernel (batches of ``max(batch_size,
    32)``) and the steps gather (x, x') pairs on the device; inside a
    process group whose ranks share one host the sweep spreads over the
    data group and each rank takes its slice of every global batch of
    (x, x') from the host. At tau > 0, without ``precompute``, or over
    ranks on more than one host (as in JAX), each step runs its own round
    trip of its batch
    (``train/stage3.py::make_stage3_train_step``), which at tau = 0 makes the
    same update from the same generator state: one process gathers the
    batch on the device, the ranks of a group take host batches
    (``_Feed``). Batches of
    ``dataset.batch_sizes["stage3"]``; the SVQ draws and the dropout masks
    come from a generator seeded ``seed + 1`` (rank 0's). With ``metrics``
    and ``stage2_ckpt`` (a stage-2 checkpoint's path) each validation scores
    ``val_n_samples`` series sampled from those priors, from a generator
    seeded ``20_000 + step``, raw and through the enhancer as it is (module
    docstring), on the primary rank, the batches decoded and enhanced over
    the data group where it divides ``evaluation.batch_size``; with
    ``metrics`` alone it scores
    nothing, as in JAX. ``compute_dtype`` and ``fast_norm`` go to the
    enhancer, ``bf16_mu``/``bf16_nu`` to the optimizer; the frozen stage 1
    stays as it was loaded (float32 from the CLI, as in JAX). Inside a
    process group the gradients and the logged metrics are the global
    batch's (the enhancer's GroupNorms are per series). With ``tp`` > 1 the
    ranks train as a (W / tp, tp) grid (module docstring): the enhancer's
    big parameters split over the model group, ``frozen`` whole on every
    rank, each validation enhancing with the enhancer gathered whole.
    ``bundle_steps`` > 1 trains the precomputed-x' path in bundles (module
    docstring); tau > 0 and the on-the-fly path take one step a dispatch,
    as in JAX. ``percept_loss_weight`` > 0 raises ``NotImplementedError``:
    the JAX runner hands its steps no ``percept_fn`` and so trains such a
    config without the term; the port refuses it rather than do the same
    (``train/stage3.py`` takes the term)."""
    grid = _train_grid(tp)
    if cfg.fidelity_enhancer.percept_loss_weight > 0.0:
        raise NotImplementedError(
            "percept_loss_weight > 0: the JAX runner passes its stage-3 steps no percept_fn "
            "and would train without the perceptual term; build the step with "
            "train/stage3.py::make_stage3_train_step_pre(weight, percept_fn) instead")
    dev = resolve_device(device)
    if frozen.vq_l.embed.device.type != dev.type:
        raise ValueError(f"the frozen stage 1 is on {frozen.vq_l.embed.device}, not {dev}")
    batch_size = cfg.dataset.batch_sizes.get("stage3", 16)
    max_steps = max_steps or cfg.trainer_params.max_steps["stage3"]
    if save_path and _stage_completed(save_path, max_steps, resume, "stage3"):
        return None

    with grid:
        fe = init_stage3(FidelityEnhancer.from_config(cfg, data.input_length, data.in_channels,
                                                      compute_dtype, fast_norm),
                         torch.Generator().manual_seed(seed), dev)
        _replicate(fe)
        state = create_stage3_state(fe, _adamw(cfg, max_steps, bf16_mu, bf16_nu))
        gen = _rank_generator(seed + 1, dev)
        start_step = _resume(save_path, resume, state, gen, "stage3")
        shard_train_state_tp(state)  # JAX's _place_state: a no-op without a grid
        if precompute and tau == 0.0 and _precompute_here("stage3"):
            step_fn = make_stage3_train_step_pre()
            X_dev = torch.from_numpy(data.X_train).to(dev)
            t0 = time.time()
            # one process keeps x' on the device for its gather; the ranks of a
            # group take their slices of each batch from the host (_Feed)
            xprime = precompute_xprime_dataset(frozen, X_dev, batch_size=max(batch_size, 32),
                                               keep_on_device=data_count() == 1,
                                               data_parallel=initialized())
            _say(f"[stage3] precomputed {len(xprime)} x' rows in {time.time() - t0:.1f}s")
            arrays = (X_dev, xprime) if data_count() == 1 else (data.X_train, xprime)
            feed = _Feed(arrays, batch_size, max_steps, seed, dev, start_step)
            train_once, bundled = _bundled("stage3", _bundle("stage3", bundle_steps),
                                           lambda: step_fn(state, *feed.next(), gen)[1],
                                           state, gen, max_steps, feed)
        else:  # per-step dispatch, as in JAX
            step_fn = make_stage3_train_step(frozen, tau)
            feed = _Feed((data.X_train,), batch_size, max_steps, seed, dev, start_step)
            train_once, bundled = _bundled("stage3", 1,
                                           lambda: step_fn(state, feed.next()[0], gen)[1],
                                           state, gen, max_steps, feed)

        eval_once = None
        if _validating(metrics) and stage2_ckpt is not None:
            fan_out = _val_fan_out(cfg, "stage3")
            t_l, t_h = priors_from_tree(cfg, frozen.model.spec, data.n_classes,
                                        load_checkpoint(stage2_ckpt)[0])
            sample_fn = make_sampling_fn(frozen, t_l.to(dev).eval(), t_h.to(dev).eval(),
                                         MaskGITSpec.from_config(cfg, frozen.model.spec),
                                         data_parallel=fan_out)

            def eval_once(step):
                with gathered(state.fe):
                    if not (fan_out or is_primary()):
                        return {}
                    sets = _val_samples(cfg, sample_fn, val_n_samples, 20_000 + step, dev,
                                        enhance=state.fe, data_parallel=fan_out)
                    return _running_metrics(metrics, sets) if is_primary() else {}

        _loop("stage3", max_steps, train_once, eval_once, logger,
              cfg.trainer_params.val_check_interval.get("stage3", 2500), log_interval,
              start_step, _snapshotter(save_path, state, gen), **bundled)
        unshard_train_state_tp(state)
    if save_path:
        _save_stage("stage3", save_path, {"params": fe_to_jax(state.fe),
                                          "tau": np.asarray(tau, np.float32),
                                          "step": np.asarray(state.step, np.int32)},
                    cfg, data, state.step)
    return state


def fcn_train_step(fcn: FCN, optimizer, scheduler, x: torch.Tensor, y: torch.Tensor):
    """One supervised step: softmax cross-entropy of ``fcn(x, train=True)``
    against the labels ``y[:, 0]``, one optimizer and schedule step. ->
    (mean cross-entropy, accuracy), 0-dim device tensors."""
    labels = y[:, 0].long()
    logits = fcn(x, train=True)
    ce = torch.nn.functional.cross_entropy(logits, labels)
    optimizer.zero_grad(set_to_none=True)
    ce.backward()
    all_reduce_grads(fcn.parameters())
    optimizer.step()
    scheduler.step()
    return ce.detach(), (logits.detach().argmax(-1) == labels).float().mean()


def train_fcn(
    cfg: Config,
    data: DatasetSplits,
    logger=None,
    max_epochs: int = 1000,
    batch_size: int = 256,
    lr: float = 1e-3,
    weight_decay: float = 1e-5,
    seed: int = 0,
    device="cuda",
    log_interval: int = 50,
    save_path: Optional[str] = None,
) -> FCN:
    """Supervised FCN classifier training from seeded random weights ->
    the trained ``FCN`` in eval mode (its state dict: the parameters and the
    BatchNorm statistics). ``max_epochs`` counts optimizer *steps*, as the
    JAX runner does (the reference caps Lightning at ``max_steps=max_epochs``),
    at batches of ``min(batch_size, N)``. Its own optimiser, not the stages':
    AdamW with weight decay ``weight_decay`` over ``cosine_decay_schedule(lr,
    max_epochs)``. ``cfg`` goes only into the checkpoint's meta: with
    ``save_path`` the run ends by writing ``{"params", "batch_stats"}``
    there (``load_fcn_bundle`` reads it); it takes no snapshots, as in JAX.
    ``logger.log_metrics`` gets ``train/loss`` and ``train/acc`` as 0-dim
    device tensors every ``log_interval`` steps. One process gathers its
    batches on the device; inside a process group of more than one rank each
    rank steps on its slice of every global batch from the host, with the
    BatchNorm statistics, gradients and logged metrics the global batch's."""
    dev = resolve_device(device)
    max_steps = max_epochs
    bs = min(batch_size, len(data.X_train))
    fcn = init_weights_(FCN(data.in_channels, data.n_classes),
                        torch.Generator().manual_seed(seed)).to(dev)
    _replicate(fcn)
    optimizer, scheduler = adamw(fcn.parameters(), cosine_decay_schedule(lr, max_steps),
                                 weight_decay=weight_decay)
    feed = _Feed((data.X_train, data.y_train), bs, max_steps, seed, dev)
    logger = logger if is_primary() else None
    for step in range(1, max_steps + 1):
        feed.prepare(1)
        ce, acc = fcn_train_step(fcn, optimizer, scheduler, *feed.next())
        at_log, at_print = step % log_interval == 0, step % 200 == 0 or step == max_steps
        if at_log or at_print:
            m = all_reduce_metrics({"ce": ce, "acc": acc})
            ce, acc = m["ce"], m["acc"]
        if logger and at_log:
            logger.log_metrics({"train/loss": ce, "train/acc": acc}, step)
        if at_print:
            _say(f"[fcn] step {step}/{max_steps} ce={float(ce):.4f} acc={float(acc):.3f}")
    if save_path:
        _save_stage("fcn", save_path, fcn_to_jax(fcn), cfg, data, None)
    return fcn.eval()


def _make_eval(state: Stage1TrainState, X_test: np.ndarray, batch_size: int, dev):
    """Validation over the whole test split: fixed batches of
    ``min(batch_size, N)`` indices, the last wrapped around to the start,
    and the wrapped entries masked out of the per-sample sums, so the
    metrics are exact means over the split. Inside a process group the
    ranks of data index d evaluate batches d, d + D, ... of D data indices
    (the split must make a batch for every index; under a grid every rank of
    a model group runs the same batches, whose sharded weights it gathers
    with the others) and one all-reduce over the data group sums the sums:
    the same means as one process's, up to the order of the additions."""
    eval_step = make_stage1_eval_step(per_sample=True)
    X = torch.from_numpy(X_test).to(dev)
    N = len(X_test)
    bs = min(batch_size, N)
    nb = -(-N // bs)
    flat = torch.arange(nb * bs, device=dev)
    idx, valid = (flat % N).reshape(nb, bs), (flat < N).reshape(nb, bs)
    if nb < data_count():
        raise ValueError(f"{N} test series make {nb} validation batches of {bs}, fewer than "
                         f"the {data_count()} data-parallel ranks")
    mine = range(data_index(), nb, data_count())

    def eval_once(step):
        sums, scalar_sums = {}, {}
        for i in mine:
            per, scalars, _ = eval_step(state, X[idx[i]])
            for k, v in per.items():
                sums[k] = sums.get(k, 0.0) + torch.where(valid[i], v, 0.0).sum()
            for k, v in scalars.items():
                scalar_sums[k] = scalar_sums.get(k, 0.0) + v
        if initialized():  # every rank holds a batch, so the same keys
            keys = sorted(sums) + sorted(scalar_sums)
            got = {**sums, **scalar_sums}
            total = dict(zip(keys, all_reduce_(torch.stack(
                [torch.as_tensor(got[k], dtype=torch.float64, device=dev) for k in keys]))))
            sums = {k: total[k] for k in sums}
            scalar_sums = {k: total[k] for k in scalar_sums}
        out = {k: float(v) / N for k, v in sums.items()}
        out.update({k: float(v) / nb for k, v in scalar_sums.items()})
        out["recons_loss.time"] = out["recons_loss.LF.time"] + out["recons_loss.HF.time"]
        # the commitment loss is 0 outside training, so the val loss is the recon terms
        out["loss"] = out["recons_loss.time"]
        return out

    return eval_once
