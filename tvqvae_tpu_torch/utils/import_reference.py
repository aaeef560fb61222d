"""Import reference-trained torch checkpoints into the port's checkpoints.

The port's own copy of ``tvqvae_tpu/utils/import_reference.py`` (numpy
only; the port imports nothing of the JAX package). It converts the
reference's (SynthAIr/T-VQ-VAE-TrajGen) Lightning checkpoints

  - ``stage1.ckpt``: encoder_l/encoder_h/decoder_l/decoder_h/vq_model_l/
    vq_model_h (``stage1_from_state_dict``);
  - ``stage2.ckpt``: the two x-transformers priors (``stage2_from_state_dict``);
  - ``stage3.ckpt``: the fidelity enhancer and its ``tau`` buffer
    (``fe_from_state_dict``);
  - ``fcn.ckpt``: a raw ``FCNBaseline.state_dict()`` (``fcn_from_state_dict``)

into the JAX package's tree layout as numpy arrays: the layout the port's
``utils/checkpoint.py`` stores and ``utils/convert.py`` reads. The
conversions work from the state dicts' key structure alone; no module of
the reference is needed, only the ``.ckpt`` file, which
``load_reference_checkpoint`` reads without running its pickled globals.

Encoder and decoder stacks (reference vq_vae.py:155-167) are walked by
their Sequential indices: an index with ``block.0/1/2`` subkeys is an
Enc/DecBlock (conv or transposed conv, BN, Snake), ``convs.0..4`` (with an
optional ``proj``) a ResBlock, and a bare ``weight``/``bias`` pair one of
the decoder's two tail ConvTranspose2d layers (vq_vae.py:238-250).

The enhancer's ``fidelity_enhancer.unet.*`` keys map onto the auto-named
``Unet1D_0`` tree; its dead time-embedding MLPs (reference :339-344 built,
:417-464 never used) are skipped and its ``tau`` buffer (:472) is returned.

The prior body is x-transformers (bidirectional_transformer.py:92-110:
ContinuousTransformerWrapper over a pre-norm Encoder). The walker is
structural: a block with ``to_q`` is attention, else feed-forward; a norm
slot with one 1-D tensor is RMSNorm, with two LayerNorm. So it takes the
naming of both x-transformers generations (``layers.{i}.0.g`` or
``layers.{i}.0.0.g``, ``ff.0.0`` or ``net.0.0``, ``to_out`` or
``to_out.0``, Linears with or without bias) and raises on anything else.
The wrapper's project_in/project_out Linears, which x-transformers creates
whenever dim_in/dim_out are passed (the published LF prior has a square
128->128 pair), become the prior's project_in/project_out; for the square
case the returned ``force_projections`` flag (written to the checkpoint's
meta) tells loaders to build the prior with those projections. They cannot
be folded away: project_in would fold into tok_emb, whose table is tied to
the output logits.
"""

import pickle
from typing import Dict, Tuple

import numpy as np

__all__ = [
    "load_reference_checkpoint",
    "stage1_from_state_dict",
    "fcn_from_state_dict",
    "fe_from_state_dict",
    "stage2_from_state_dict",
]


# --- reading a .ckpt without running its globals -----------------------------


class InertGlobal(dict):
    """Stands in for a class or function a checkpoint's pickle names but
    ``torch.load(weights_only=True)`` does not allow (a Lightning
    ``AttributeDict``, a user's config class in ``hyper_parameters``):
    calling, building or filling it only records what it was given."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        self.args, self.kwargs, self.items_list, self.state = args, kwargs, [], None

    def __new__(cls, *args, **kwargs):
        return super().__new__(cls)

    def __setstate__(self, state):
        self.state = state

    def append(self, value):
        self.items_list.append(value)

    def extend(self, values):
        self.items_list.extend(values)


class _InertUnpickler(pickle.Unpickler):
    """Resolves only the globals ``torch.load(weights_only=True)`` allows
    (tensor rebuilds, storages, containers); any other global becomes an
    ``InertGlobal`` subclass of the same name, never imported."""

    def find_class(self, module, name):
        from torch._weights_only_unpickler import _get_allowed_globals

        allowed = _get_allowed_globals()
        full = f"{module}.{name}"
        if full in allowed:
            return allowed[full]
        return type(name, (InertGlobal,), {"__module__": module, "__qualname__": name})


class _InertPickle:
    """A ``pickle_module`` for ``torch.load`` (of a zip checkpoint, as
    torch has written since 1.6) whose unpickler is ``_InertUnpickler``."""

    Unpickler = _InertUnpickler
    __name__ = "inert_pickle"


def load_reference_checkpoint(path: str):
    """A reference ``.ckpt`` (a torch pickle) -> its object, on the CPU.

    ``torch.load(weights_only=True)`` where the file allows it; otherwise an
    unpickler that resolves the same allowed globals and turns every other
    one into an inert ``InertGlobal`` stub, so tensors and containers load
    and no pickled global is imported or run."""
    import torch

    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        return torch.load(path, map_location="cpu", weights_only=False,
                          pickle_module=_InertPickle)


# --- tensor layout conversions (proven in the transplant tests) -----------


def _np(t) -> np.ndarray:
    # works for torch tensors and numpy arrays alike
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def _conv2d(sub: Dict[str, np.ndarray]) -> dict:
    # torch Conv2d (O, I, kh, kw) -> flax (kh, kw, I, O)
    return {
        "kernel": _np(sub["weight"]).transpose(2, 3, 1, 0),
        "bias": _np(sub["bias"]),
    }


def _conv1d(sub: Dict[str, np.ndarray]) -> dict:
    # torch Conv1d (O, I, k) -> flax (k, I, O)
    return {
        "kernel": _np(sub["weight"]).transpose(2, 1, 0),
        "bias": _np(sub["bias"]),
    }


def _convT2d(sub: Dict[str, np.ndarray]) -> dict:
    # torch ConvTranspose2d (I, O, kh, kw) -> our input-dilated-conv
    # formulation: spatially flipped kernel in (kh, kw, I, O)
    w = _np(sub["weight"])[:, :, ::-1, ::-1]
    return {
        "kernel": np.ascontiguousarray(w.transpose(2, 3, 0, 1)),
        "bias": _np(sub["bias"]),
    }


def _bn(sub: Dict[str, np.ndarray]) -> Tuple[dict, dict]:
    return (
        {"scale": _np(sub["weight"]), "bias": _np(sub["bias"])},
        {"mean": _np(sub["running_mean"]), "var": _np(sub["running_var"])},
    )


def _snake(sub: Dict[str, np.ndarray]) -> dict:
    return {"a": _np(sub["a"]).reshape(-1)}


def _dense(sub: Dict[str, np.ndarray]) -> dict:
    return {"kernel": _np(sub["weight"]).T, "bias": _np(sub["bias"])}


# --- state-dict structure walking -----------------------------------------


def _subtree(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    p = prefix + "."
    return {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}


def _children(sd: Dict[str, np.ndarray]):
    """Split '{i}.rest' keys into ordered [(i, {rest: tensor})]."""
    out: Dict[int, Dict[str, np.ndarray]] = {}
    for k, v in sd.items():
        head, _, rest = k.partition(".")
        if head.isdigit():
            out.setdefault(int(head), {})[rest] = v
    return sorted(out.items())


def _res_block(sub: Dict[str, np.ndarray]) -> Tuple[dict, dict]:
    """ResBlock (vq_vae.py:13-62): convs = Sequential(Snake, Conv, BN,
    Snake, Conv, Dropout); proj is a 1x1 Conv when channels change."""
    bn_p, bn_s = _bn(_subtree(sub, "convs.2"))
    params = {
        "Snake_0": _snake(_subtree(sub, "convs.0")),
        "Conv_0": _conv2d(_subtree(sub, "convs.1")),
        "BatchNorm_0": bn_p,
        "Snake_1": _snake(_subtree(sub, "convs.3")),
        "Conv_1": _conv2d(_subtree(sub, "convs.4")),
    }
    if "proj.weight" in sub:
        params["Conv_2"] = _conv2d(_subtree(sub, "proj"))
    return params, {"BatchNorm_0": bn_s}


def _enc_dec_block(sub: Dict[str, np.ndarray], transposed: bool):
    """VQVAEEncBlock / VQVAEDecBlock: block = Sequential(conv|convT, BN,
    Snake) (vq_vae.py:65-121)."""
    conv = (_convT2d if transposed else _conv2d)(_subtree(sub, "block.0"))
    bn_p, bn_s = _bn(_subtree(sub, "block.1"))
    params = {
        ("ConvTranspose2dTorch_0" if transposed else "Conv_0"): conv,
        "BatchNorm_0": bn_p,
        "Snake_0": _snake(_subtree(sub, "block.2")),
    }
    return params, {"BatchNorm_0": bn_s}


def _convert_stack(stack_sd: Dict[str, np.ndarray], decoder: bool):
    """Ordered reference Sequential -> flax auto-named {params, stats}."""
    params: dict = {}
    stats: dict = {}
    counters = {"EncBlock2d": 0, "DecBlock2d": 0, "ResBlock2d": 0,
                "ConvTranspose2dTorch": 0}

    def put(kind, p, s):
        name = f"{kind}_{counters[kind]}"
        counters[kind] += 1
        params[name] = p
        if s:
            stats[name] = s

    for idx, sub in _children(stack_sd):
        if "block.0.weight" in sub:
            kind = "DecBlock2d" if decoder else "EncBlock2d"
            put(kind, *_enc_dec_block(sub, transposed=decoder))
        elif "convs.0.a" in sub:
            put("ResBlock2d", *_res_block(sub))
        elif "weight" in sub and "bias" in sub and len(sub) == 2:
            if not decoder:
                raise ValueError(
                    f"bare conv at encoder index {idx} — unexpected layout"
                )
            put("ConvTranspose2dTorch", _convT2d(sub), None)
        else:
            raise ValueError(
                f"unrecognized block at index {idx}: keys {sorted(sub)}"
            )
    return params, stats


def _codebook(sub: Dict[str, np.ndarray]) -> dict:
    """vq_model_*. -> CodebookState dict (runner.codebook_to_dict layout).
    Reference EuclideanCodebook buffers: initted (1,), cluster_size (K,),
    embed_avg (K, D), embed (K, D) (vq.py:157-165)."""
    for bad in ("project_in.weight", "project_out.weight"):
        if any(k.endswith(bad) for k in sub):
            raise ValueError(
                "VectorQuantize with project_in/out (codebook_dim != dim) "
                "is not used by the reference config and is not supported"
            )
    cb = _subtree(sub, "_codebook")
    return {
        "embed": _np(cb["embed"]),
        "embed_avg": _np(cb["embed_avg"]),
        "cluster_size": _np(cb["cluster_size"]),
        "initted": np.asarray(bool(_np(cb["initted"]).reshape(-1)[0])),
    }


# --- public entry points ---------------------------------------------------


def stage1_from_state_dict(sd: Dict[str, np.ndarray]):
    """Reference stage1.ckpt state_dict -> (params, batch_stats, vq_l,
    vq_h, inferred) matching this repo's Stage1Model tree (models/stage1.py)
    and runner checkpoint layout. `inferred` carries geometry read off the
    weights (input_length from the TimeHead Linear, in_channels from the
    first conv) for meta/validation."""
    if "state_dict" in sd and not hasattr(sd["state_dict"], "shape"):
        sd = sd["state_dict"]  # Lightning checkpoint wrapper

    params: dict = {}
    stats: dict = {}
    for band in ("l", "h"):
        enc_p, enc_s = _convert_stack(
            _subtree(sd, f"encoder_{band}.encoder"), decoder=False
        )
        dec_p, dec_s = _convert_stack(
            _subtree(sd, f"decoder_{band}.decoder"), decoder=True
        )
        params[f"encoder_{band}"] = enc_p
        params[f"decoder_{band}"] = dec_p
        params[f"head_{band}"] = {
            "Dense_0": _dense(_subtree(sd, f"decoder_{band}.linear"))
        }
        stats[f"encoder_{band}"] = enc_s
        stats[f"decoder_{band}"] = dec_s

    vq_l = _codebook(_subtree(sd, "vq_model_l"))
    vq_h = _codebook(_subtree(sd, "vq_model_h"))

    first_conv = params["encoder_l"]["EncBlock2d_0"]["Conv_0"]["kernel"]
    head = params["head_l"]["Dense_0"]["kernel"]
    inferred = {
        "in_channels": int(first_conv.shape[2]) // 2,  # spectral 2C -> C
        "input_length": int(head.shape[0]),
        "init_dim": int(first_conv.shape[3]),
        "hid_dim": int(vq_l["embed"].shape[1]),
        "codebook_sizes": {"lf": int(vq_l["embed"].shape[0]),
                           "hf": int(vq_h["embed"].shape[0])},
    }
    return params, stats, vq_l, vq_h, inferred


def _chan_ln(sub: Dict[str, np.ndarray]) -> dict:
    # reference LayerNorm (fidelity_enhancer.py:123-132): g is (1, C, 1)
    return {"g": _np(sub["g"]).reshape(-1)}


def _unet_block(sub: Dict[str, np.ndarray]) -> dict:
    # Block (fidelity_enhancer.py:186-204): proj (WSConv) / norm (GN) / act
    return {
        "WSConv1d_0": _conv1d(_subtree(sub, "proj")),
        "GroupNorm_0": {"scale": _np(sub["norm.weight"]),
                        "bias": _np(sub["norm.bias"])},
        "Snake_0": _snake(_subtree(sub, "act")),
    }


def _resnet_1d(sub: Dict[str, np.ndarray]) -> dict:
    # ResnetBlock (fidelity_enhancer.py:207-231); mlp.* (time emb) is dead
    # code — built with time_emb_dim but forward never passes time_emb
    p = {
        "UnetBlock_0": _unet_block(_subtree(sub, "block1")),
        "UnetBlock_1": _unet_block(_subtree(sub, "block2")),
    }
    if "res_conv.weight" in sub:  # Identity when dim == dim_out
        p["Conv_0"] = _conv1d(_subtree(sub, "res_conv"))
    return p


def _attn_residual(sub: Dict[str, np.ndarray], linear: bool):
    """Residual(PreNorm(attn)) (fidelity_enhancer.py:77-84,134-142) ->
    (_PreNormResidual params, attention params)."""
    prenorm = {"ChanLayerNorm_0": _chan_ln(_subtree(sub, "fn.norm"))}
    a = _subtree(sub, "fn.fn")
    attn = {"Conv_0": {"kernel":
                       _np(a["to_qkv.weight"]).transpose(2, 1, 0)}}
    if linear:  # to_out = Sequential(Conv1d, LayerNorm) (:242)
        attn["Conv_1"] = _conv1d(_subtree(a, "to_out.0"))
        attn["ChanLayerNorm_0"] = _chan_ln(_subtree(a, "to_out.1"))
    else:  # full attention: bare Conv1d to_out (:268)
        attn["Conv_1"] = _conv1d(_subtree(a, "to_out"))
    return prenorm, attn


def fe_from_state_dict(sd: Dict[str, np.ndarray]):
    """Reference stage3.ckpt state_dict -> (params, tau, inferred) matching
    this repo's FidelityEnhancer tree ({"Unet1D_0": ...}, the layout
    runner.train_stage3 checkpoints and TrainedModelSampler read).

    Accepts the full Lightning Stage3 state_dict (frozen stage-2/metric
    keys are ignored; only ``fidelity_enhancer.*`` is read) or an already
    prefix-stripped FidelityEnhancer state_dict."""
    if "state_dict" in sd and not hasattr(sd["state_dict"], "shape"):
        sd = sd["state_dict"]
    if any(k.startswith("fidelity_enhancer.") for k in sd):
        sd = _subtree(sd, "fidelity_enhancer")
    tau = float(_np(sd["tau"]).reshape(-1)[0]) if "tau" in sd else 0.0
    u = _subtree(sd, "unet")

    downs = _children(_subtree(u, "downs"))
    ups = _children(_subtree(u, "ups"))
    if not downs or len(downs) != len(ups):
        raise ValueError(
            f"unexpected Unet1D layout: {len(downs)} downs vs {len(ups)} ups"
        )

    p: dict = {"Conv_0": _conv1d(_subtree(u, "init_conv"))}
    ci = ri = ai = li = 0

    def put_stage(sub, linear_attn: bool, conv_key: str):
        """One down/up ModuleList entry: ResnetBlock, ResnetBlock,
        Residual(PreNorm(attn)), conv (fidelity_enhancer.py:352-392)."""
        nonlocal ci, ri, ai, li
        for j in ("0", "1"):
            p[f"ResnetBlock1d_{ri}"] = _resnet_1d(_subtree(sub, j))
            ri += 1
        prenorm, attn = _attn_residual(_subtree(sub, "2"), linear_attn)
        p[f"_PreNormResidual_{ai}"] = prenorm
        ai += 1
        if linear_attn:
            p[f"LinearAttention1d_{li}"] = attn
            li += 1
        else:
            p["Attention1d_0"] = attn
        ci += 1
        p[f"Conv_{ci}"] = _conv1d(_subtree(sub, conv_key))

    for i, sub in downs:
        # Downsample is a bare Conv1d at index 3 (:87-95,368)
        put_stage(sub, linear_attn=True, conv_key="3")

    p[f"ResnetBlock1d_{ri}"] = _resnet_1d(_subtree(u, "mid_block1")); ri += 1
    prenorm, attn = _attn_residual(_subtree(u, "mid_attn"), linear=False)
    p[f"_PreNormResidual_{ai}"] = prenorm; ai += 1
    p["Attention1d_0"] = attn
    p[f"ResnetBlock1d_{ri}"] = _resnet_1d(_subtree(u, "mid_block2")); ri += 1

    for i, sub in ups:
        # Upsample is Sequential(Upsample, Conv1d) except the last, which
        # is a bare Conv1d (:375-392)
        key = "3.1" if "3.1.weight" in sub else "3"
        put_stage(sub, linear_attn=True, conv_key=key)

    ci += 1
    p[f"Conv_{ci}"] = _conv1d(_subtree(u, "last_up.1"))
    p[f"ResnetBlock1d_{ri}"] = _resnet_1d(_subtree(u, "final_res_block"))
    for j in range(3):  # 1-3-3 output head (:399-415)
        ci += 1
        p[f"Conv_{ci}"] = _conv1d(_subtree(u, f"final_conv.{j}"))

    init_conv = p["Conv_0"]["kernel"]  # (k, I, O)
    dim = int(_np(u["final_conv.0.weight"]).shape[1])
    if int(init_conv.shape[2]) != dim:
        raise ValueError(
            "init_dim != dim Unet1D configurations are not used by the "
            f"reference config and are not supported (init_dim "
            f"{init_conv.shape[2]}, dim {dim})"
        )
    inferred = {
        "in_channels": int(init_conv.shape[1]),
        "dim": dim,
        # downs.{i}.3 is always a bare Conv1d(dim_in, dim_out) whose
        # out-channels are dim * dim_mults[i] (:352-368)
        "dim_mults": [int(_np(sub["3.weight"]).shape[0]) // dim
                      for _, sub in downs],
        "tau": tau,
    }
    return {"Unet1D_0": p}, tau, inferred


# --- stage-2 prior (x-transformers ContinuousTransformerWrapper) -----------


def _natural_key(k: str):
    """Sort '10' after '2': split digit runs into ints."""
    import re

    return [int(p) if p.isdigit() else p for p in re.split(r"(\d+)", k)]


def _norm_params(sub: Dict[str, np.ndarray], where: str):
    """A norm slot: 1 one-dim tensor = RMSNorm g -> {'scale'}; 2 = LayerNorm
    weight/bias -> {'scale','bias'}. Tolerates nesting (ModuleList of norms
    in newer x-transformers: '0.g') and naming (g/gamma/weight/scale)."""
    onedim = {k: _np(v) for k, v in sub.items()
              if np.ndim(v) == 1 and "num_batches" not in k}
    if len(onedim) == 1:
        return {"scale": next(iter(onedim.values()))}, True
    if len(onedim) == 2:
        scale = bias = None
        for k, v in onedim.items():
            leaf = k.rsplit(".", 1)[-1]
            if leaf in ("g", "gamma", "weight", "scale"):
                scale = v
            elif leaf in ("bias", "beta", "b"):
                bias = v
        if scale is None or bias is None:
            raise ValueError(
                f"{where}: cannot identify LayerNorm scale/bias among "
                f"{sorted(onedim)}"
            )
        return {"scale": scale, "bias": bias}, False
    raise ValueError(
        f"{where}: expected 1 (RMSNorm) or 2 (LayerNorm) 1-D tensors, "
        f"got {sorted(onedim)}"
    )


def _linear_of(sub: Dict[str, np.ndarray], prefix: str, dim_out: int,
               where: str):
    """A torch Linear under `prefix` (directly or one Sequential level
    down, e.g. to_out vs to_out.0): -> flax {'kernel','bias'} (bias zeros
    when the Linear has none — exact, flax Dense always carries one)."""
    cand = {k: v for k, v in _subtree(sub, prefix).items()} \
        if any(k.startswith(prefix + ".") for k in sub) else {}
    if not cand and prefix + ".weight" not in sub:
        raise ValueError(f"{where}: no Linear under '{prefix}'")
    if "weight" not in cand:
        # one Sequential level down: take the lone 2-D weight
        w2 = {k: v for k, v in cand.items()
              if k.endswith("weight") and np.ndim(v) == 2}
        if len(w2) != 1:
            raise ValueError(
                f"{where}: expected exactly one 2-D weight under "
                f"'{prefix}', got {sorted(w2)}"
            )
        wkey = next(iter(w2))
        w = _np(cand[wkey])
        b = cand.get(wkey[: -len("weight")] + "bias")
    else:
        w = _np(cand["weight"])
        b = cand.get("bias")
    return {
        "kernel": w.T,
        "bias": _np(b) if b is not None else np.zeros(dim_out, np.float32),
    }


def _xt_attention(sub: Dict[str, np.ndarray], where: str):
    """x-transformers Attention -> flax EncoderBlock attention Denses
    (Dense_0/1/2 = q/k/v, no bias; Dense_3 = to_out)."""
    out = {}
    for i, name in enumerate(("to_q", "to_k", "to_v")):
        w = sub.get(f"{name}.weight")
        if w is None:
            raise ValueError(f"{where}: attention missing {name}.weight")
        out[f"Dense_{i}"] = {"kernel": _np(w).T}
    dim = int(_np(sub["to_q.weight"]).shape[1])
    out["Dense_3"] = _linear_of(sub, "to_out", dim, where)
    return out, dim


def _xt_feedforward(sub: Dict[str, np.ndarray], where: str):
    """x-transformers FeedForward (GELU variant) -> flax Dense_4/Dense_5.
    Structural: the ordered 2-D weights are [in-proj, out-proj] regardless
    of the Sequential index naming across versions (ff.0.0/ff.2 vs
    net.0.0/net.3)."""
    w2 = sorted(
        (k for k, v in sub.items()
         if k.endswith("weight") and np.ndim(v) == 2),
        key=_natural_key,
    )
    if len(w2) != 2:
        raise ValueError(
            f"{where}: expected 2 Linear weights in feed-forward, got {w2}"
        )
    out = {}
    for slot, k in zip(("Dense_4", "Dense_5"), w2):
        w = _np(sub[k])
        b = sub.get(k[: -len("weight")] + "bias")
        out[slot] = {
            "kernel": w.T,
            "bias": (_np(b) if b is not None
                     else np.zeros(w.shape[0], np.float32)),
        }
    return out


def _upscale(sub: Dict[str, np.ndarray]):
    """Reference Upscale (bidirectional_transformer.py:12-30):
    conv = Sequential(Conv1d, GELU, BatchNorm1d, Conv1d) -> this repo's
    projector {Conv_0, BatchNorm_0, Conv_1} (+ batch stats)."""
    bn_p, bn_s = _bn(_subtree(sub, "conv.2"))
    params = {
        "Conv_0": _conv1d(_subtree(sub, "conv.0")),
        "BatchNorm_0": bn_p,
        "Conv_1": _conv1d(_subtree(sub, "conv.3")),
    }
    return params, {"BatchNorm_0": bn_s}


def _prior_from_state_dict(sd: Dict[str, np.ndarray], kind: str):
    """One BidirectionalTransformer state dict -> (flax params,
    batch_stats, inferred). Projections are folded when square (see module
    docstring)."""
    where = f"transformer_{kind[0]}"
    params: dict = {
        "tok_emb_l": {"embedding": _np(sd["tok_emb_l.weight"])},
        "pos_emb": {"embedding": _np(sd["pos_emb.weight"])},
        "class_emb": {"embedding": _np(sd["class_condition_emb.weight"])},
        "logit_bias": _np(sd["bias"]),
    }
    stats: dict = {}
    if kind == "hf":
        params["tok_emb_h"] = {"embedding": _np(sd["tok_emb_h.weight"])}
        proj_p, proj_s = _upscale(_subtree(sd, "projector"))
        params["projector"] = proj_p
        stats["projector"] = proj_s

    blocks = _subtree(sd, "blocks")
    in_dim = params["pos_emb"]["embedding"].shape[1]

    # wrapper projections: x-transformers creates them whenever dim_in/
    # dim_out are passed (the reference always passes both, :92-94)
    proj_in = proj_out = None
    if "project_in.weight" in blocks:
        proj_in = _linear_of(blocks, "project_in",
                             int(_np(blocks["project_in.weight"]).shape[0]),
                             where)
    if "project_out.weight" in blocks:
        proj_out = _linear_of(blocks, "project_out",
                              int(_np(blocks["project_out.weight"]).shape[0]),
                              where)
    hidden_dim = (proj_in["kernel"].shape[1] if proj_in is not None
                  else in_dim)
    if proj_in is not None:
        if proj_out is None:
            raise ValueError(f"{where}: project_in without project_out")
        params["project_in"] = proj_in
        params["project_out"] = proj_out
    elif hidden_dim != in_dim:
        raise ValueError(
            f"{where}: hidden_dim {hidden_dim} != in_dim {in_dim} "
            "but wrapper projections are missing"
        )
    # square projections are real trained weights in the reference (the
    # wrapper creates them unconditionally) but fresh training here omits
    # them; the meta flag makes loaders rebuild the model WITH them.
    # Folding them away instead is impossible: project_in would have to
    # fold into tok_emb, whose table is weight-TIED to the output logits.
    force_projections = proj_in is not None and hidden_dim == in_dim

    pe_p, pe_is_rms = _norm_params(
        _subtree(blocks, "post_emb_norm"), where + ".post_emb_norm"
    )
    if pe_is_rms:
        raise ValueError(
            f"{where}: post_emb_norm should be a LayerNorm "
            "(ContinuousTransformerWrapper post_emb_norm=True)"
        )
    params["post_emb_norm"] = pe_p

    # encoder layers: alternating attention / feed-forward, classified by
    # their own keys, each with its pre-norm at slot 0
    al = _subtree(blocks, "attn_layers")
    layer_items = _children(_subtree(al, "layers"))
    use_rmsnorm = None
    pairs = []  # (attn_dict+norm, ff_dict+norm)
    pending_attn = None
    for i, sub in layer_items:
        lw = f"{where}.layers.{i}"
        norm, is_rms = _norm_params(_subtree(sub, "0"), lw + ".norm")
        if use_rmsnorm is None:
            use_rmsnorm = is_rms
        elif use_rmsnorm != is_rms:
            raise ValueError(f"{lw}: mixed norm types across layers")
        block = _subtree(sub, "1")
        is_attn = any("to_q" in k for k in block)
        if is_attn:
            if pending_attn is not None:
                raise ValueError(f"{lw}: two attention layers in a row — "
                                 "not the reference Encoder('a','f') order")
            attn, _dim = _xt_attention(block, lw)
            pending_attn = {("RMSNorm_0" if is_rms else "LayerNorm_0"): norm,
                            **attn}
        else:
            if pending_attn is None:
                raise ValueError(f"{lw}: feed-forward before attention — "
                                 "not the reference Encoder('a','f') order")
            ff = _xt_feedforward(block, lw)
            pairs.append({
                **pending_attn,
                ("RMSNorm_1" if is_rms else "LayerNorm_1"): norm,
                **ff,
            })
            pending_attn = None
    if pending_attn is not None:
        raise ValueError(f"{where}: trailing attention layer without "
                         "feed-forward")
    if not pairs:
        raise ValueError(f"{where}: no encoder layers found")
    for j, blk in enumerate(pairs):
        params[f"block_{j}"] = blk

    # final norm: the attn_layers-level 1-D tensors outside 'layers.'
    fin = {k: v for k, v in al.items()
           if not k.startswith("layers.") and np.ndim(v) == 1}
    fin_p, fin_is_rms = _norm_params(fin, where + ".final_norm")
    params["RMSNorm_0" if fin_is_rms else "LayerNorm_0"] = fin_p

    # prediction head: Sequential(Linear, GELU, LayerNorm) (:111-117)
    embed_dim = params["tok_emb_l"]["embedding"].shape[1]
    pred = _linear_of(sd, "pred_head.0", embed_dim, where + ".pred_head")
    pn_p, pn_is_rms = _norm_params(
        _subtree(sd, "pred_head.2"), where + ".pred_norm"
    )
    if pn_is_rms:
        raise ValueError(f"{where}: pred_head LayerNorm expected")
    params["pred_norm"] = pn_p

    params["pred_head"] = pred

    inferred = {
        "embed_dim": int(embed_dim),
        "in_dim": int(in_dim),
        "hidden_dim": int(hidden_dim),
        "n_layers": len(pairs),
        "num_tokens": int(params["logit_bias"].shape[0]),
        "codebook_size": int(params["logit_bias"].shape[1]) - 1,
        "n_classes": int(params["class_emb"]["embedding"].shape[0]) - 1,
        "use_rmsnorm": bool(use_rmsnorm),
        "force_projections": force_projections,
        # heads are not recoverable from shapes (inner = heads*64); the
        # reshape is head-count-dependent, so it must match the config
        "heads_times_dim_head": int(
            params["block_0"]["Dense_0"]["kernel"].shape[1]
        ),
    }
    return params, stats, inferred


def stage2_from_state_dict(sd: Dict[str, np.ndarray]):
    """Reference stage2.ckpt (Lightning ExpMaskGIT: maskgit.transformer_l /
    maskgit.transformer_h, stage2.py:28 + maskgit.py:87-105) -> (params
    {'l','h'}, h_stats, inferred) matching this repo's stage-2 checkpoint
    layout (runner.train_stage2: {'params', 'h_stats', 'step'}). Frozen
    stage-1 keys inside the checkpoint are ignored."""
    if "state_dict" in sd and not hasattr(sd["state_dict"], "shape"):
        sd = sd["state_dict"]
    # locate the transformer prefixes ('maskgit.transformer_l.' in the
    # Lightning tree; bare 'transformer_l.' in a raw MaskGIT state dict)
    prefix = None
    for k in sd:
        marker = "transformer_l."
        at = k.find(marker)
        if at >= 0:
            prefix = k[:at]
            break
    if prefix is None:
        raise ValueError(
            "no transformer_l.* keys found — not a stage-2 checkpoint?"
        )
    p_l, s_l, inf_l = _prior_from_state_dict(
        _subtree(sd, prefix + "transformer_l"), "lf"
    )
    p_h, s_h, inf_h = _prior_from_state_dict(
        _subtree(sd, prefix + "transformer_h"), "hf"
    )
    if s_l:
        raise ValueError(f"unexpected LF batch stats: {sorted(s_l)}")
    inferred = {
        "lf": inf_l, "hf": inf_h,
        # one flag for both transformers: forcing is a no-op on a model
        # whose dims already differ, so the union is safe
        "force_projections": bool(inf_l["force_projections"]
                                  or inf_h["force_projections"]),
    }
    return {"l": p_l, "h": p_h}, s_h, inferred


def fcn_from_state_dict(sd: Dict[str, np.ndarray]):
    """Reference fcn.ckpt (raw FCNBaseline state_dict, fcn.py:65-101) ->
    (variables, inferred) for this repo's FCN (models/fcn.py)."""
    if "state_dict" in sd and not hasattr(sd["state_dict"], "shape"):
        sd = sd["state_dict"]
    params: dict = {}
    stats: dict = {}
    blocks = _children(_subtree(sd, "layers"))
    if len(blocks) != 3:
        raise ValueError(f"expected 3 FCN conv blocks, got {len(blocks)}")
    for i, sub in blocks:
        conv = _subtree(sub, "layers.0")
        bn = _subtree(sub, "layers.1")
        params[f"Conv_{i}"] = _conv1d(conv)
        bn_p, bn_s = _bn(bn)
        params[f"BatchNorm_{i}"] = bn_p
        stats[f"BatchNorm_{i}"] = bn_s
    params["Dense_0"] = _dense(_subtree(sd, "final"))
    variables = {"params": params, "batch_stats": stats}
    inferred = {
        "in_channels": int(params["Conv_0"]["kernel"].shape[1]),
        "n_classes": int(params["Dense_0"]["kernel"].shape[1]),
    }
    return variables, inferred
