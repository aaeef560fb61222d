"""Weights bridge: the JAX package's parameter trees -> the port's state dicts.

The port's submodules carry the flax tree's names, so the conversion is a
per-leaf rename and transpose, decided by the leaf's name and rank:

    kernel (in, out)             Dense      -> weight (out, in)
    kernel (k, I, O)             Conv 1-D   -> weight (O, I, k)
    kernel (kh, kw, I, O)        Conv 2-D   -> weight (O, I, kh, kw)
    kernel of ConvTranspose2dTorch_*        -> weight (I, O, kh, kw), spatially
        flipped (the inverse of tvqvae_tpu/utils/import_reference.py:_convT2d)
    scale (norms), embedding    -> weight
    batch_stats mean / var      -> running_mean / running_var

Inputs are nested mappings of numpy (or numpy-convertible) arrays, as the
JAX package's checkpoints and ``load_stage1_bundle`` give them.
"""

from collections import OrderedDict
from typing import Mapping, Tuple

import numpy as np
import torch

_RENAME = {"bias": "bias", "scale": "weight", "embedding": "weight", "a": "a",
           "logit_bias": "logit_bias"}
_CODEBOOK_FIELDS = ("embed", "embed_avg", "cluster_size", "initted")


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _param(path, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    *mods, leaf = path
    if leaf == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 3:
            arr = arr.transpose(2, 1, 0)
        elif mods[-1].startswith("ConvTranspose2dTorch"):
            arr = arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        else:
            arr = arr.transpose(3, 2, 0, 1)
        name = "weight"
    elif leaf in _RENAME:
        name = _RENAME[leaf]
    else:
        raise ValueError(f"unknown parameter leaf {'/'.join(path)}")
    return ".".join([*mods, name]), arr


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A contiguous, writable copy: float32, or bool for the ``initted`` flag."""
    return torch.from_numpy(np.array(arr, dtype=np.bool_ if arr.dtype == np.bool_ else np.float32))


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
