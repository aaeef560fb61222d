"""Tensor parallelism over a 2-D (data, model) grid of ranks.

Port of ``tvqvae_tpu/parallel/tp.py``. The JAX package places the big
parameter leaves and their AdamW moments on a ``(data, model)`` mesh split
over ``model``, the batch split over ``data``, and lets GSPMD partition the
unchanged jitted step. Here one process is one device: world rank r sits at
data index ``r // n_model`` and model index ``r % n_model``
(``make_mesh2d``, JAX's ``devices.reshape(n_data, n_model)``), and the
partitioning is written out:

  - **Placement** (``shard_train_state_tp``): ``tp_leaf_spec``, JAX's rule,
    picks each parameter's axis from its *flax* layout's shape (a leaf of at
    least ``MIN_SHARD_ELEMS`` elements splits over ``model`` along its
    largest ``n_model``-divisible axis, the last winning ties; the rest is
    replicated), and ``utils/convert.py``'s permutation maps that axis to the
    torch dim (``tp_plan``), so the port splits the leaves JAX splits along
    the same axes. Such a parameter *is* its slice: an ``nn.Parameter`` of
    1/n_model of the dim, which the optimizer steps as it steps any other,
    so AdamW's moments are slices too. BatchNorm statistics, codebooks, the
    step, the schedule and the generators stay replicated.
  - **Forward**: reading a sharded parameter off its module
    (``module.weight``, by whatever code reads it: the module's own forward,
    a parent's, a remat recompute) gathers the full tensor over the model
    group through an autograd function whose backward keeps the local slice
    of the full gradient. The ranks of a model group hold the same rows
    (the batch is split over ``data`` only) and compute the same full
    gradient, so the slice needs no reduction over the model group; the
    step's ``all_reduce_grads`` averages it over the data group, which holds
    the same slice, and averages every replicated parameter over the whole
    world, which keeps the model group's copies one where a kernel is not
    deterministic (the replicated parameters' gradients of a model group's
    ranks agree up to such kernels' rounding).
  - **Memory**: the gathered weight does not live to the backward. While a
    sharded module's root runs its forward, a saved-tensor hook stores any
    gathered weight (or view of one) that an operation saves for its
    backward as a reference to the parameter, and gathers it again when
    the backward unpacks it; a remat recompute gathers again by itself.
    Between steps a rank holds its slices, their moments and the replicated
    rest. A weight cast to another dtype before the op that saves it (the
    bfloat16 compute options) is a new tensor and is kept as the op saved it.
  - **Whole tensors** (``gathered``): checkpoints, snapshots, validation and
    sampling read the full parameters inside ``gathered(*modules)``, which
    every rank of a model group enters together.

The rule is JAX's, quirks included: at the published width the two TimeHead
kernels (4633 x 4633; 4633 = 41·113 divides by neither 2 nor 4) stay
replicated although the JAX module's docstring names them as what tensor
parallelism divides; 70 of stage 1's 650 leaves, 75.74 % of its parameter
bytes, split at ``tp`` = 2 and 4.

Collectives run on whichever backend the process group has; two ranks that
share one card use gloo (NCCL refuses a device held by two ranks).
"""

import contextlib
import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tvqvae_tpu_torch.parallel import mesh
from tvqvae_tpu_torch.utils.convert import flax_axes

# Leaves smaller than this stay replicated (2^16 elements = 256 KB fp32).
# Read late, so that tests can lower it to engage the rule on tiny models.
MIN_SHARD_ELEMS = 2 ** 16


def _min_elems(v):
    return MIN_SHARD_ELEMS if v is None else v


@dataclasses.dataclass(eq=False)
class Mesh2D:
    """The rank grid: this rank's place in it and its two groups (the ranks
    of its model index, which split the batch; the ranks of its data index,
    which split the big parameters). Entering it makes it the active grid
    of ``parallel.mesh`` until the ``with`` block ends."""

    n_data: int
    n_model: int
    data_index: int
    model_index: int
    data_group: object
    model_group: object

    def __enter__(self):
        self._prev = mesh.set_grid(self)
        return self

    def __exit__(self, *exc):
        mesh.set_grid(self._prev)


def make_mesh2d(n_data: int, n_model: int) -> Mesh2D:
    """The (n_data, n_model) grid over the process group's ranks: rank r at
    data index r // n_model, model index r % n_model (JAX's
    ``devices.reshape(n_data, n_model)``). Every rank calls this together:
    it creates one data group per model index and one model group per data
    index, in that order, on every rank."""
    W, r = mesh.process_count(), mesh.process_index()
    if n_data * n_model != W:
        raise ValueError(f"a ({n_data}, {n_model}) grid needs {n_data * n_model} ranks, "
                         f"the process group has {W}")
    if not mesh.initialized():
        return Mesh2D(1, 1, 0, 0, None, None)
    data = [dist.new_group(list(range(m, W, n_model))) for m in range(n_model)]
    model = [dist.new_group(list(range(d * n_model, (d + 1) * n_model))) for d in range(n_data)]
    return Mesh2D(n_data, n_model, r // n_model, r % n_model, data[r % n_model],
                  model[r // n_model])


def tp_leaf_spec(shape: Sequence[int], n_model: int, min_elems=None) -> Optional[int]:
    """The axis of a leaf of ``shape`` (the flax layout's) that splits over
    ``model``: its largest ``n_model``-divisible axis, later axes winning
    ties; None (replicated) if the leaf is smaller than ``min_elems``
    (default ``MIN_SHARD_ELEMS``) or no axis divides. JAX's ``tp_leaf_spec``
    as an axis index instead of a ``PartitionSpec``."""
    shape = tuple(int(n) for n in shape)
    if (int(np.prod(shape)) if shape else 0) < _min_elems(min_elems):
        return None
    best = None
    for d, n in enumerate(shape):
        if n % n_model == 0 and n >= n_model and (best is None or n >= shape[best]):
            best = d
    return best


def tp_plan(module: nn.Module, n_model: int, min_elems=None) -> Dict[str, Optional[int]]:
    """{parameter name: the torch dim the rule splits over ``model``, or
    None} for an unsharded ``module``: ``tp_leaf_spec`` of each parameter's
    flax-layout shape, its axis mapped through ``convert.flax_axes``."""
    plan = {}
    for prefix, owner in module.named_modules():
        for name, p in owner.named_parameters(recurse=False):
            axes = flax_axes(owner, name, p.dim())
            a = tp_leaf_spec([p.shape[i] for i in axes], n_model, min_elems)
            plan[f"{prefix}.{name}" if prefix else name] = None if a is None else axes[a]
    return plan


@dataclasses.dataclass(eq=False)
class TPShard:
    """What a sharded parameter (``p.tp_shard``) is a slice of: the full
    tensor's ``dim`` cut into ``count`` equal slices over ``group``, this
    one the ``index``-th; ``gathered`` while ``gathered()`` holds the full
    tensor in it."""

    dim: int
    index: int
    count: int
    group: object
    gathered: bool = False


def _shard(p) -> Optional[TPShard]:
    s = getattr(p, "tp_shard", None)
    return None if s is None or s.gathered else s


def _gather(t: torch.Tensor, s: TPShard) -> torch.Tensor:
    """The model group's slices ``t`` concatenated along the shard's dim."""
    parts = [torch.empty_like(t) for _ in range(s.count)]
    dist.all_gather(parts, t.contiguous(), group=s.group)
    return torch.cat(parts, s.dim)


def _slice(t: torch.Tensor, s: TPShard) -> torch.Tensor:
    n = t.shape[s.dim] // s.count
    return t.narrow(s.dim, s.index * n, n).clone()


class _Gather(torch.autograd.Function):
    """The full tensor of a sharded parameter; backward: the local slice of
    the full tensor's gradient (module docstring)."""

    @staticmethod
    def forward(ctx, p, s):
        ctx.s = s
        return _gather(p.detach(), s)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.s), None


def full_weight(p: nn.Parameter) -> torch.Tensor:
    """What a sharded module reads for ``p``: the gathered full tensor
    (differentiable; tagged for the saved-tensor hook), or ``p`` itself
    inside ``gathered``."""
    s = _shard(p)
    if s is None:
        return p
    full = _Gather.apply(p, s)
    full.tp_of = p
    return full


def full_tensor(p: nn.Parameter, t: torch.Tensor) -> torch.Tensor:
    """A slice-shaped companion ``t`` of ``p`` (its gradient, a moment)
    gathered to the full shape, a collective over the model group; ``t``
    itself where ``p`` is not sharded."""
    s = _shard(p)
    return t if s is None else _gather(t, s)


class _Saved:
    """What the pack hook keeps of a saved (view of a) gathered weight."""

    __slots__ = ("p", "size", "stride", "offset")

    def __init__(self, p, t):
        self.p, self.size, self.stride, self.offset = p, t.size(), t.stride(), t.storage_offset()


def _pack(t):
    base = t if t._base is None else t._base
    p = getattr(base, "tp_of", None)
    return t if p is None else _Saved(p, t)


def _unpack(x):
    if not isinstance(x, _Saved):
        return x
    with torch.no_grad():
        return _gather(x.p.detach(), x.p.tp_shard).as_strided(x.size, x.stride, x.offset)


def _install_saving(root: nn.Module) -> None:
    """The saved-tensor hooks around every forward of ``root``."""
    if "_tp_saving" in root.__dict__:
        return
    active = []

    def enter(module, args):
        ctx = torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)
        ctx.__enter__()
        active.append(ctx)

    def leave(module, args, out):
        active.pop().__exit__(None, None, None)

    root.__dict__["_tp_saving"] = (root.register_forward_pre_hook(enter),
                                   root.register_forward_hook(leave, always_call=True))


_CLASSES = {}


def _tp_class(cls, names):
    """``cls`` with each parameter of ``names`` read through ``full_weight``."""
    key = (cls, names)
    if key not in _CLASSES:
        props = {n: property(lambda self, n=n: full_weight(self._parameters[n])) for n in names}
        _CLASSES[key] = type(cls.__name__, (cls,),
                             {**props, "__module__": cls.__module__, "_tp_base": cls})
    return _CLASSES[key]


def shard_module_tp(module: nn.Module, min_elems=None, grid: Optional[Mesh2D] = None):
    """Cut every parameter of ``module`` that ``tp_plan`` splits to this
    rank's slice over the model group of ``grid`` (default: the active one);
    the rest stays. -> ``module``. A grid of one model rank splits nothing."""
    grid = mesh.grid() if grid is None else grid
    if grid is None or grid.n_model == 1:
        return module
    plan = tp_plan(module, grid.n_model, min_elems)
    for prefix, owner in module.named_modules():
        names = []
        for name, p in owner.named_parameters(recurse=False):
            dim = plan[f"{prefix}.{name}" if prefix else name]
            if dim is None:
                continue
            if getattr(p, "tp_shard", None) is not None:
                raise ValueError(f"{prefix}.{name} is sharded already")
            s = TPShard(dim, grid.model_index, grid.n_model, grid.model_group)
            with torch.no_grad():
                p.data = _slice(p.data, s)
            p.grad = None
            p.tp_shard = s
            names.append(name)
        if names:
            owner.__class__ = _tp_class(type(owner), tuple(names))
    _install_saving(module)
    return module


def _params(*modules):
    seen, out = set(), []
    for m in modules:
        for p in m.parameters():
            if id(p) not in seen:
                seen.add(id(p))
                out.append(p)
    return out


def _map_moments(optimizer, fn) -> dict:
    """``optimizer.state_dict()`` with ``fn(p, v)`` in place of each of its
    parameter-shaped state tensors (the moments; not the step counts)."""
    sd = optimizer.state_dict()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    sd["state"] = {i: {k: fn(params[i], v) if torch.is_tensor(v) and v.dim() else v
                       for k, v in st.items()} for i, st in sd["state"].items()}
    return sd


def full_optimizer_state(optimizer) -> dict:
    """``optimizer.state_dict()`` with every sharded parameter's moments
    gathered to the full shape (a collective over the model group)."""
    return _map_moments(optimizer, full_tensor)


def _modules(state):
    return [getattr(state, f.name) for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), nn.Module)]


def shard_train_state_tp(state, min_elems=None, grid: Optional[Mesh2D] = None):
    """JAX's ``shard_train_state_tp`` on a stage's train state: its modules'
    parameters by the rule (``shard_module_tp``) and the optimizer's
    moments with them; everything else stays replicated. -> ``state``."""
    grid = mesh.grid() if grid is None else grid
    if grid is None or grid.n_model == 1:
        return state
    for m in _modules(state):
        shard_module_tp(m, min_elems, grid)
    # the moments of a fresh or restored state, whole: each split one cut to
    # its parameter's slice, the rest copied out of any flat buffer they view
    state.optimizer.load_state_dict(_map_moments(
        state.optimizer, lambda p, v: v.clone() if _shard(p) is None else _slice(v, p.tp_shard)))
    return state


def unshard_train_state_tp(state):
    """The inverse of ``shard_train_state_tp``: every sharded parameter and
    moment gathered to its full tensor for good, the modules as they were
    built. -> ``state``, replicated."""
    modules = _modules(state)
    if not any(_shard(p) for p in _params(*modules)):
        return state
    sd = full_optimizer_state(state.optimizer)
    for m in modules:
        for p in m.parameters():
            s = _shard(p)
            if s is not None:
                with torch.no_grad():
                    p.data = _gather(p.data, s)
                p.grad = None
                del p.tp_shard
        for owner in m.modules():
            base = type(owner).__dict__.get("_tp_base")
            if base is not None:
                owner.__class__ = base
        for handle in m.__dict__.pop("_tp_saving", ()):
            handle.remove()
    state.optimizer.load_state_dict(sd)
    return state


@contextlib.contextmanager
def gathered(*modules: nn.Module):
    """Inside: every sharded parameter of ``modules`` holds its full tensor
    (gathered over the model group on entry; its slice back on exit), so
    that one rank alone may run, read or save them. Every rank of a model
    group enters together. Without sharded parameters it does nothing."""
    shards = [p for p in _params(*modules) if _shard(p) is not None]
    slices = [p.data for p in shards]
    with torch.no_grad():
        fulls = [_gather(p.data, p.tp_shard) for p in shards]
    for p, f in zip(shards, fulls):
        p.data = f
        p.tp_shard.gathered = True
    try:
        yield
    finally:
        for p, s in zip(shards, slices):
            p.data = s
            p.tp_shard.gathered = False


def sharded_fraction(*modules: nn.Module) -> float:
    """The fraction of the parameter bytes of ``modules`` (at their full
    sizes) that is split over ``model``."""
    total = split = 0
    for p in _params(*modules):
        s = _shard(p)
        n = p.numel() * p.element_size() * (s.count if s else 1)
        total += n
        split += n if s else 0
    return split / max(total, 1)
