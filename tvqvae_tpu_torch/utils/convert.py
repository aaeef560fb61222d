"""Weights bridge between the JAX package's parameter trees and the port's
state dicts, both ways.

The port's submodules carry the flax tree's names, so the conversion is a
per-leaf rename and transpose, decided by the leaf's name and rank:

    kernel (in, out)             Dense      -> weight (out, in)
    kernel (k, I, O)             Conv 1-D   -> weight (O, I, k)
    kernel (kh, kw, I, O)        Conv 2-D   -> weight (O, I, kh, kw)
    kernel of ConvTranspose2dTorch_*        -> weight (I, O, kh, kw), spatially
        flipped (the inverse of tvqvae_tpu/utils/import_reference.py:_convT2d)
    scale (norms), embedding    -> weight
    g (ChanLayerNorm), a (Snake) -> g, a
    batch_stats mean / var      -> running_mean / running_var

Inputs are nested mappings of numpy (or numpy-convertible) arrays, as the
JAX package's checkpoints and ``load_stage1_bundle`` give them.

``stage1_to_jax``, ``prior_to_jax``, ``fe_to_jax`` and ``fcn_to_jax`` are the
exact inverses: they read each state-dict entry's module type to name and
transpose it back, drop ``num_batches_tracked`` and keep ``initted`` bool,
so the port writes its checkpoints in the JAX package's layout.
"""

from collections import OrderedDict
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_RENAME = {"bias": "bias", "scale": "weight", "embedding": "weight", "a": "a",
           "logit_bias": "logit_bias", "g": "g"}
_CODEBOOK_FIELDS = ("embed", "embed_avg", "cluster_size", "initted")


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


# the torch weight's dims in the flax kernel's order, by layer kind: flax's
# kernel is ``weight.permute(KERNEL_AXES[kind])`` (a transposed conv's also
# flipped spatially), so flax axis a is the weight's dim KERNEL_AXES[kind][a]
KERNEL_AXES = {"dense": (1, 0), "conv1d": (2, 1, 0), "conv2d": (2, 3, 1, 0),
               "conv_transpose2d": (2, 3, 0, 1)}


def _kernel_kind(path, ndim: int) -> str:
    """A flax kernel's layer kind, from its rank and module name."""
    if ndim == 4 and path[-2].startswith("ConvTranspose2dTorch"):
        return "conv_transpose2d"
    return {2: "dense", 3: "conv1d", 4: "conv2d"}[ndim]


def module_kind(module: nn.Module) -> Optional[str]:
    """The ``KERNEL_AXES`` kind of a module's ``weight``, or None where the
    weight is stored as flax stores it (embeddings, norm scales)."""
    for cls, kind in ((nn.ConvTranspose2d, "conv_transpose2d"), (nn.Conv2d, "conv2d"),
                      (nn.Conv1d, "conv1d"), (nn.Linear, "dense")):
        if isinstance(module, cls):
            return kind
    return None


def flax_axes(module: nn.Module, name: str, ndim: int) -> Tuple[int, ...]:
    """The dims of ``module``'s parameter ``name`` in the order of its flax
    leaf's axes (the identity for every leaf but a layer's kernel)."""
    kind = module_kind(module) if name == "weight" else None
    return KERNEL_AXES[kind] if kind else tuple(range(ndim))


def _param(path, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    *mods, leaf = path
    if leaf == "kernel":
        kind = _kernel_kind(path, arr.ndim)
        arr = arr.transpose(np.argsort(KERNEL_AXES[kind]))
        if kind == "conv_transpose2d":
            arr = arr[:, :, ::-1, ::-1]
        name = "weight"
    elif leaf in _RENAME:
        name = _RENAME[leaf]
    else:
        raise ValueError(f"unknown parameter leaf {'/'.join(path)}")
    return ".".join([*mods, name]), arr


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A contiguous, writable copy: float32, or bool for the ``initted`` flag."""
    # order="C": a transposed kernel copied in its own order keeps permuted
    # strides, which the modules' parameters would take over (``assign=True``)
    # and cuDNN would then convolve with other kernels than the trained model's
    return torch.from_numpy(np.array(arr, dtype=np.bool_ if arr.dtype == np.bool_ else np.float32,
                                     order="C"))


def params_to_state_dict(params: Mapping, batch_stats: Mapping = None) -> "OrderedDict[str, torch.Tensor]":
    """One flax module tree (params + batch_stats) -> a torch state dict."""
    sd = OrderedDict()
    for path, arr in _flatten(params):
        name, arr = _param(path, arr)
        sd[name] = _tensor(arr)
    for path, arr in _flatten(batch_stats or {}):
        *mods, leaf = path
        if leaf not in ("mean", "var"):
            raise ValueError(f"unknown batch-stat leaf {'/'.join(path)}")
        sd[".".join([*mods, "running_" + leaf])] = _tensor(arr)
        sd[".".join([*mods, "num_batches_tracked"])] = torch.tensor(0)
    return sd


def stage1_from_jax(tree: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """{"params", "batch_stats", "vq_l", "vq_h"} -> state dict of the port's
    ``Stage1Model`` plus its codebooks under ``vq_l.*`` / ``vq_h.*``
    (``FrozenStage1.from_state_dict`` splits them). A codebook is a mapping
    or an object with embed / embed_avg / cluster_size / initted."""
    sd = params_to_state_dict(tree["params"], tree.get("batch_stats"))
    for band in ("vq_l", "vq_h"):
        cb = tree[band]
        for f in _CODEBOOK_FIELDS:
            v = cb[f] if isinstance(cb, Mapping) else getattr(cb, f)
            sd[f"{band}.{f}"] = _tensor(np.asarray(v))
    return sd


def prior_from_jax(params: Mapping, h_stats: Mapping = None):
    """Stage-2 {"l", "h"} params (+ the HF prior's batch stats) -> (sd_l, sd_h)."""
    return (
        params_to_state_dict(params["l"]),
        params_to_state_dict(params["h"], h_stats),
    )


def fe_from_jax(params: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """Stage-3 params ``{"Unet1D_0": ...}`` -> state dict of the port's
    ``FidelityEnhancer`` (``WSConv1d`` kernels and the ``ChanLayerNorm``
    scale ``g`` included)."""
    return params_to_state_dict(params)


def fcn_from_jax(variables: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """FCN ``{"params", "batch_stats"}`` -> state dict of the port's ``FCN``."""
    return params_to_state_dict(variables["params"], variables.get("batch_stats"))


# --------------------------------------------------------------------------
# the port's modules -> the JAX package's trees

_NORMS = (nn.modules.batchnorm._NormBase, nn.GroupNorm, nn.LayerNorm, nn.RMSNorm)


def _flax_param(module: nn.Module, name: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    """The inverse of ``_param`` for one parameter of ``module``."""
    if name == "weight":
        kind = module_kind(module)
        if kind == "conv_transpose2d":
            arr = arr[:, :, ::-1, ::-1]
        if kind:
            return "kernel", arr.transpose(KERNEL_AXES[kind])
        if isinstance(module, nn.Embedding):
            return "embedding", arr
        if isinstance(module, _NORMS):
            return "scale", arr
    elif name in _RENAME.values():
        return name, arr
    raise ValueError(f"unknown parameter {name} of {type(module).__name__}")


def _insert(tree: dict, path, arr: np.ndarray) -> None:
    *mods, leaf = path
    for m in mods:
        tree = tree.setdefault(m, {})
    tree[leaf] = np.ascontiguousarray(arr)


def module_to_jax(module: nn.Module) -> Tuple[Dict, Dict]:
    """One module's state dict -> (params, batch_stats), flax trees of numpy
    arrays: the inverse of ``params_to_state_dict``."""
    params, stats = {}, {}
    for key, t in module.state_dict().items():
        *mods, name = key.split(".")
        owner = module.get_submodule(".".join(mods))
        arr = t.detach().to("cpu", copy=True).numpy()  # never a view of the live module
        if name == "num_batches_tracked":
            continue
        if name in ("running_mean", "running_var"):
            _insert(stats, [*mods, name[len("running_"):]], arr)
        else:
            leaf, arr = _flax_param(owner, name, arr)
            _insert(params, [*mods, leaf], arr)
    return params, stats


def codebook_to_dict(cb) -> Dict[str, np.ndarray]:
    """A ``CodebookState`` -> {embed, embed_avg, cluster_size, initted},
    host copies."""
    return {f: getattr(cb, f).detach().to("cpu", copy=True).numpy() for f in _CODEBOOK_FIELDS}


def stage1_to_jax(model: nn.Module, vq_l, vq_h) -> Dict:
    """The port's ``Stage1Model`` and codebooks -> {"params", "batch_stats",
    "vq_l", "vq_h"}: the inverse of ``stage1_from_jax``."""
    params, stats = module_to_jax(model)
    return {"params": params, "batch_stats": stats,
            "vq_l": codebook_to_dict(vq_l), "vq_h": codebook_to_dict(vq_h)}


def prior_to_jax(t_l: nn.Module, t_h: nn.Module):
    """Both priors -> (params {"l", "h"}, the HF prior's batch stats): the
    inverse of ``prior_from_jax`` (square ``project_in``/``project_out``
    layers included where a prior has them)."""
    p_l, _ = module_to_jax(t_l)
    p_h, h_stats = module_to_jax(t_h)
    return {"l": p_l, "h": p_h}, h_stats


def fe_to_jax(fe: nn.Module) -> Dict:
    """The port's ``FidelityEnhancer`` -> params ``{"Unet1D_0": ...}``."""
    return module_to_jax(fe)[0]


def fcn_to_jax(fcn: nn.Module) -> Dict:
    """The port's ``FCN`` -> {"params", "batch_stats"}."""
    params, stats = module_to_jax(fcn)
    return {"params": params, "batch_stats": stats}
