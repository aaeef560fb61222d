"""Data parallelism over ``torch.distributed``: the process group as the
JAX package's 1-D ``data`` mesh.

Port of ``tvqvae_tpu/parallel/mesh.py``. W processes (ranks), each holding
B/W rows of a global batch of B, take the same optimizer step as one process
holding all B rows. Under GSPMD that comes for free: every ``mean``/``sum``
over the sharded batch axis becomes an all-reduce. Here each such site calls
a collective of this module explicitly:

  - BatchNorm train statistics (``models/layers.py``): each rank's mean and
    variance of its rows, gathered over the ranks by ``all_reduce_sum``,
    whose backward sums the statistics' gradients as well, so the step
    differentiates through the global statistics as JAX's does;
  - the VQ's EMA statistics (``models/vq.py``): the kernel's per-rank
    ``counts`` and ``embed_sum``, summed by ``all_reduce_``, and its
    k-means init and dead-code expiry: rows drawn over the global batch,
    each filled in by the rank that holds it and summed, and the Lloyd
    iterations' counts and sums;
  - the masked cross-entropy (``models/maskgit.py::masked_ce``): a global
    denominator;
  - the gradients (``all_reduce_grads``), averaged after the backward and
    before AdamW;
  - the logged metrics (``all_reduce_metrics``), averaged when they are read;
  - the stage-2/3 precompute sweeps and the validation sampler
    (``train/stage2.py``, ``train/stage3.py``): each rank's slice of a
    batch, put back together in rank order by ``all_gather``, as JAX shards
    the sweep batch or the decoded tokens over the mesh.

Every collective runs whenever a process group is initialised, a one-rank
group included (where it is an identity; the BatchNorm statistics of a
one-rank group take the one-process code); without one they are no-ops,
and a process is the one rank of a one-process run. As under ``jax.distributed``, the caller initialises
the group (``torch.distributed.init_process_group``); nothing here starts
processes. Parameters stay replicated: every rank builds them from the same
seed, ``replicate_`` broadcasts rank 0's, and the averaged gradients keep
them equal.

Both backends take CUDA tensors: gloo reduces them through pinned host
copies (two ranks that share one card cannot use NCCL, which refuses a
device held by two ranks), NCCL on the devices.

Under a (data, model) grid (``parallel/tp.py``, active while its ``Mesh2D``
is entered) the batch is split over the *data* index alone: ``data_index``
and ``data_count`` take the place of ``process_index`` and
``process_count`` in ``shard_bounds``, ``shard_batch`` and every reduction
over the batch, and the reductions (``all_reduce_``, ``all_reduce_sum``,
``all_reduce_metrics``, ``all_gather_object``, ``all_gather``) run over
the rank's data group unless given another group. Without a grid the data group is the
world and the data index the rank. ``broadcast_``, ``replicate_`` and
``barrier`` stay over the world.
"""

import queue
import socket
import threading
from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

GRAD_BUCKET = 1 << 24  # elements per gradient all-reduce (64 MB of float32)


_GRID = None  # the active (data, model) grid: a ``tp.Mesh2D``, or None


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if initialized() else 1


def set_grid(grid):
    """Make ``grid`` (a ``tp.Mesh2D``, or None) the active grid; -> the one
    it replaces."""
    global _GRID
    prev, _GRID = _GRID, grid
    return prev


def grid():
    """The active (data, model) grid, or None."""
    return _GRID


def data_group():
    """The ranks that hold the other slices of this rank's batch: the active
    grid's data group, else the world (None, torch.distributed's default)."""
    return None if _GRID is None else _GRID.data_group


def data_index() -> int:
    """This rank's slice of the global batch: its data index under a grid,
    else its rank."""
    return process_index() if _GRID is None else _GRID.data_index


def data_count() -> int:
    """How many slices the global batch is split into: the grid's data
    size, else the world's."""
    return process_count() if _GRID is None else _GRID.n_data


def _size(group) -> int:
    return dist.get_world_size(group)


def is_primary() -> bool:
    """True on the rank that writes files and prints (rank 0)."""
    return process_index() == 0


def barrier(tag: str = "") -> None:
    """Every rank waits here for the others (``tag`` names the site in a
    hang's traceback, as JAX's ``sync_global_devices`` tag does)."""
    if initialized():
        dist.barrier()


def all_reduce_(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """Reduce ``t`` in place over ``group`` (default: the data group) by
    ``"sum"`` or ``"mean"``; -> t."""
    if op not in ("sum", "mean"):
        raise ValueError(f"op must be 'sum' or 'mean', not {op!r}")
    if not initialized():
        return t
    group = data_group() if group is None else group
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    if op == "mean":
        t /= _size(group)
    return t


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` into every rank's ``t``, in place; -> t."""
    if initialized():
        dist.broadcast(t, src)
    return t


class _AllReduceSum(torch.autograd.Function):
    """y = Σ_ranks x over the data group. The gradient of the ranks' summed
    losses with respect to one rank's x is the sum over the ranks of their
    gradients with respect to y, so the backward is an all-reduce as well."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone())


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over the data group of ``x``, differentiable; ``x`` itself without
    a process group."""
    return _AllReduceSum.apply(x) if initialized() else x


def replicate_(*modules: torch.nn.Module) -> None:
    """Broadcast rank 0's parameters and buffers into every rank's modules
    (JAX's ``replicate_tree``)."""
    if not initialized():
        return
    with torch.no_grad():
        for m in modules:
            for t in [*m.parameters(), *m.buffers()]:
                broadcast_(t.data)


def all_reduce_grads(params: Iterable[torch.nn.Parameter], group=None) -> None:
    """Average the gradients of ``params`` over ``group`` (default: the data
    group), in buckets of up to ``GRAD_BUCKET`` elements of one dtype and
    device. A parameter without a gradient counts as a zero gradient (as
    AdamW and optax treat it), so every rank reduces the same buckets.

    Under a grid with no ``group`` given, a parameter split over the model
    group (``tp.py``: it carries ``tp_shard``) averages over the data group,
    which holds the same slice, and a replicated one over every rank: the
    ranks of a model group compute its gradient from the same rows, and the
    world's mean keeps their copies one where a kernel is not deterministic."""
    if not initialized():
        return
    params = [p for p in params if p.requires_grad]
    if group is None and _GRID is not None:
        split = [getattr(p, "tp_shard", None) is not None for p in params]
        all_reduce_grads([p for p, s in zip(params, split) if s], _GRID.data_group)
        all_reduce_grads([p for p, s in zip(params, split) if not s], dist.group.WORLD)
        return
    group = data_group() if group is None else group
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    bucket, n = [], 0
    for p in params + [None]:
        if p is None or (bucket and (n + p.numel() > GRAD_BUCKET
                                     or (p.dtype, p.device) != (bucket[0].dtype, bucket[0].device))):
            if bucket:
                flat = torch.cat([q.grad.reshape(-1) for q in bucket])
                all_reduce_(flat, "mean", group)
                for q, g in zip(bucket, flat.split([q.numel() for q in bucket])):
                    q.grad.copy_(g.view_as(q))
            bucket, n = [], 0
        if p is not None:
            bucket.append(p)
            n += p.numel()


def all_reduce_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The mean over the data group of each 0-dim metric, in one collective.
    The steps return per-rank values whose mean is the global one (means
    over equal slices, and ``masked_ce``'s scaled share)."""
    if not initialized() or not metrics:
        return metrics
    keys = sorted(metrics)
    flat = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    all_reduce_(flat, "mean")
    return dict(zip(keys, flat.unbind()))


def all_gather_object(obj, group=None) -> list:
    """Every ``obj`` (picklable) of ``group`` (default: the data group), in
    rank order: under a grid one per data index."""
    if not initialized():
        return [obj]
    group = data_group() if group is None else group
    out = [None] * _size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ``t`` of every rank of ``group`` (default: the data group),
    concatenated along dim 0 in rank order (under a grid: data-index
    order); ``t`` itself without a process group. Every rank's ``t`` has
    the same shape."""
    if not initialized():
        return t
    group = data_group() if group is None else group
    parts = [torch.empty_like(t) for _ in range(_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def one_host() -> bool:
    """Whether every rank of the world runs on this host (True without a
    process group): the port's ``jax.process_count() == 1``. PyTorch drives
    W cards of one host as W processes, where JAX drives them from one.
    Every rank calls it together (it gathers the host names)."""
    if not initialized():
        return True
    return len(set(all_gather_object(socket.gethostname(), dist.group.WORLD))) == 1


def shard_bounds(batch_size: int, index: Optional[int] = None,
                 count: Optional[int] = None) -> slice:
    """The rows of a global batch of ``batch_size`` that slice ``index`` of
    ``count`` (default: this rank's data index and count) holds: its
    contiguous ``batch_size / count`` slice."""
    index = data_index() if index is None else index
    count = data_count() if count is None else count
    if batch_size % count:
        raise ValueError(f"global batch {batch_size} not divisible by {count} processes")
    per = batch_size // count
    return slice(index * per, (index + 1) * per)


def shard_batch(batch, index: Optional[int] = None, count: Optional[int] = None):
    """This rank's contiguous slice of a global batch (its data index's): a
    tensor, an array, or a tuple or dict of them (None passes through)."""
    if batch is None:
        return None
    if isinstance(batch, dict):
        return {k: shard_batch(v, index, count) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, index, count) for v in batch)
    return batch[shard_bounds(batch.shape[0], index, count)]


def prefetch_batches(iterator: Iterator, device, size: int = 2) -> Iterator:
    """Host batches (tuples of numpy arrays or None) onto ``device`` from a
    background thread: the thread assembles the next batches, pins them and
    starts their copies (``non_blocking``) while the consumer's step runs,
    with at most ``size`` batches in flight. Errors surface at the consumer."""
    device = torch.device(device)
    pin = device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=max(size, 1))
    end = object()
    stop = threading.Event()

    def put(v):
        if v is None:
            return None
        t = torch.from_numpy(np.ascontiguousarray(v))
        if pin:
            t = t.pin_memory()
        return t.to(device, non_blocking=pin)

    def producer():
        try:
            # the copies run on a side stream; the consumer waits for it
            stream = torch.cuda.Stream(device) if pin else None
            for item in iterator:
                if stop.is_set():
                    return
                if stream is not None:
                    with torch.cuda.stream(stream):
                        moved = tuple(put(v) for v in item)
                    done = stream.record_event()
                else:
                    moved, done = tuple(put(v) for v in item), None
                q.put((moved, done))
        except Exception as e:  # surfaced at the consumer
            q.put(e)
        finally:
            q.put(end)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, Exception):
                raise item
            moved, done = item
            if done is not None:
                torch.cuda.current_stream(device).wait_event(done)
                for t in moved:
                    if t is not None:
                        t.record_stream(torch.cuda.current_stream(device))
            yield moved
    finally:
        stop.set()
        while thread.is_alive():  # unblock a producer waiting on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                thread.join(timeout=0.01)
