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
    ``counts`` and ``embed_sum``, summed by ``all_reduce_``;
  - the masked cross-entropy (``models/maskgit.py::masked_ce``): a global
    denominator;
  - the gradients (``all_reduce_grads``), averaged after the backward and
    before AdamW;
  - the logged metrics (``all_reduce_metrics``), averaged when they are read.

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
"""

import queue
import threading
from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

GRAD_BUCKET = 1 << 24  # elements per gradient all-reduce (64 MB of float32)


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if initialized() else 1


def is_primary() -> bool:
    """True on the rank that writes files and prints (rank 0)."""
    return process_index() == 0


def barrier(tag: str = "") -> None:
    """Every rank waits here for the others (``tag`` names the site in a
    hang's traceback, as JAX's ``sync_global_devices`` tag does)."""
    if initialized():
        dist.barrier()


def all_reduce_(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` in place over the ranks (``"sum"`` or ``"mean"``); -> t."""
    if op not in ("sum", "mean"):
        raise ValueError(f"op must be 'sum' or 'mean', not {op!r}")
    if not initialized():
        return t
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    if op == "mean":
        t /= process_count()
    return t


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` into every rank's ``t``, in place; -> t."""
    if initialized():
        dist.broadcast(t, src)
    return t


class _AllReduceSum(torch.autograd.Function):
    """y = Σ_ranks x. The gradient of the ranks' summed losses with respect
    to one rank's x is the sum over the ranks of their gradients with
    respect to y, so the backward is an all-reduce as well."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone())


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over the ranks of ``x``, differentiable; ``x`` itself without a
    process group."""
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


def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Average the gradients of ``params`` over the ranks, in buckets of up
    to ``GRAD_BUCKET`` elements of one dtype and device. A parameter without
    a gradient counts as a zero gradient (as AdamW and optax treat it), so
    every rank reduces the same buckets."""
    if not initialized():
        return
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    bucket, n = [], 0
    for p in params + [None]:
        if p is None or (bucket and (n + p.numel() > GRAD_BUCKET
                                     or (p.dtype, p.device) != (bucket[0].dtype, bucket[0].device))):
            if bucket:
                flat = torch.cat([q.grad.reshape(-1) for q in bucket])
                all_reduce_(flat, "mean")
                for q, g in zip(bucket, flat.split([q.numel() for q in bucket])):
                    q.grad.copy_(g.view_as(q))
            bucket, n = [], 0
        if p is not None:
            bucket.append(p)
            n += p.numel()


def all_reduce_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The mean over the ranks of each 0-dim metric, in one collective.
    The steps return per-rank values whose mean is the global one (means
    over equal slices, and ``masked_ce``'s scaled share)."""
    if not initialized() or not metrics:
        return metrics
    keys = sorted(metrics)
    flat = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    all_reduce_(flat, "mean")
    return dict(zip(keys, flat.unbind()))


def all_gather_object(obj) -> list:
    """Every rank's ``obj`` (picklable), in rank order."""
    if not initialized():
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def shard_bounds(batch_size: int, index: Optional[int] = None,
                 count: Optional[int] = None) -> slice:
    """The rows of a global batch of ``batch_size`` that rank ``index`` of
    ``count`` holds: its contiguous ``batch_size / count`` slice."""
    index = process_index() if index is None else index
    count = process_count() if count is None else count
    if batch_size % count:
        raise ValueError(f"global batch {batch_size} not divisible by {count} processes")
    per = batch_size // count
    return slice(index * per, (index + 1) * per)


def shard_batch(batch, index: Optional[int] = None, count: Optional[int] = None):
    """This rank's contiguous slice of a global batch: a tensor, an array,
    or a tuple or dict of them (None passes through)."""
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
