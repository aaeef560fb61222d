"""Checkpoint IO: the stage checkpoints and the mid-run train-state snapshots.

Port of ``tvqvae_tpu/utils/checkpoint.py`` for a machine without orbax.

A stage checkpoint keeps the JAX package's tree layout: the same nested
keys and the same leaves (Dense kernels ``(in, out)``, conv kernels HWIO,
codebooks, ``step``, ``tau``), as numpy arrays. The tree is flattened to
``/``-joined keys in one uncompressed ``.npz`` written at exactly ``path``
(through an open file, so numpy appends no ``.npz`` suffix), and the JSON
meta sidecar sits at ``path + ".meta.json"``, as in the JAX package. Both
are written to a temp file first and moved into place with ``os.replace``.
``tools/export_jax_ckpt.py`` turns the JAX package's Orbax checkpoints
into this format.

A snapshot (``save_train_state``) is the port's own format: a
``torch.save`` payload of state dicts, optimizer and scheduler states, the
step and the generator state, read back with ``weights_only=True``. The JAX
package's msgpack of optax states is neither read nor written.

Inside a ``torch.distributed`` process group (``parallel/``) every saved
tree is replicated, so, as in the JAX package, the primary rank alone writes
and every rank calls the writer and waits at a barrier until the file is in
place; any rank may then read it.
"""

import json
import os
import zipfile
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from tvqvae_tpu_torch.parallel.mesh import barrier, is_primary

SEP = "/"


def _flatten(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        k = str(k)
        if not k or SEP in k:
            raise ValueError(f"checkpoint key {k!r} under {prefix!r}: empty or holds {SEP!r}")
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + k + SEP)
        else:
            yield prefix + k, np.asarray(v)


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        *mods, leaf = key.split(SEP)
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return tree


def _replace_into(path: str, write) -> None:
    """``write(file)`` into ``path + ".tmp"``, then move it onto ``path``."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


def _write_npz(f, flat: Mapping[str, np.ndarray]) -> None:
    """``np.savez``'s layout (one ``<key>.npy`` member per array, stored
    uncompressed), without its keyword arguments, which a key could shadow."""
    with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, arr in flat.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as out:
                np.lib.format.write_array(out, arr, allow_pickle=False)


def save_checkpoint(path: str, tree: Mapping, meta: Optional[dict] = None) -> None:
    """Write ``tree`` (nested mappings of arrays) to ``path`` and, when given,
    ``meta`` to ``path + ".meta.json"``; the primary rank writes, every
    rank waits."""
    path = os.path.abspath(path)
    if is_primary():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        flat = dict(_flatten(tree))
        _replace_into(path, lambda f: _write_npz(f, flat))
        if meta is not None:
            _replace_into(path + ".meta.json",
                          lambda f: f.write(json.dumps(meta, indent=2,
                                                       default=_json_default).encode()))
    barrier(f"save_checkpoint:{path}")


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Optional[dict]]:
    """-> (tree of numpy arrays, meta or None), from exactly ``path``."""
    path = os.path.abspath(path)
    with np.load(path, allow_pickle=False) as z:
        tree = _unflatten({k: z[k] for k in z.files})
    meta = None
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return tree, meta


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


# --------------------------------------------------------------------------
# mid-run train-state snapshots


def save_train_state(path: str, payload: dict) -> None:
    """Write a full train state (state dicts, optimizer and scheduler
    states, step, generator state) for an exact resume; synchronous, atomic.
    The primary rank writes its ``payload``, every rank waits."""
    path = os.path.abspath(path)
    if is_primary():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _replace_into(path, lambda f: torch.save(payload, f))
    barrier(f"save_train_state:{path}")


def load_train_state(path: str) -> dict:
    """A snapshot's payload, every tensor on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
