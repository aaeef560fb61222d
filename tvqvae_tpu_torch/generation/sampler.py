"""Trained-model sampler: weights -> batched generation and reconstruction.

Port of ``tvqvae_tpu/generation/sampler.py::TrainedModelSampler``, float32.
Per batch, ``sample`` runs MaskGIT decoding of both token grids, the
codebook lookup, the frozen stage-1 decoders and the LF+HF sum
(``train/stage2.make_sampling_fn``); ``reconstruct`` runs the stage-1 round
trip, whose argmax quantization launches the VQ kernel once per band.

The JAX sampler loads Orbax checkpoints; this one takes the trees they hold,
in memory: stage 1 ``{"params", "batch_stats", "vq_l", "vq_h"}`` and stage 2
``{"params": {"l", "h"}, "h_stats"}``. ``from_init`` builds seeded random
weights instead. The fidelity enhancer (stage 3), bfloat16 decoding and the
ESS sampler are not ported yet and raise ``NotImplementedError``.
"""

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.models.layers import init_weights_
from tvqvae_tpu_torch.models.maskgit import (
    FrozenStage1,
    MaskGITSpec,
    build_transformers,
    decode_tokens,
    encode_tokens,
)
from tvqvae_tpu_torch.models.stage1 import Stage1Spec, init_stage1
from tvqvae_tpu_torch.train.stage2 import make_sampling_fn
from tvqvae_tpu_torch.utils.convert import prior_from_jax, stage1_from_jax
from tvqvae_tpu_torch.utils.device import resolve_device


class TrainedModelSampler:
    use_fe = False
    use_ess = False

    def __init__(
        self,
        cfg: Config,
        stage1: Mapping,
        stage2: Mapping,
        *,
        input_length: int,
        in_channels: int,
        n_classes: int,
        stage3: Optional[Mapping] = None,
        use_fidelity_enhancer: bool = False,
        batch_size: int = 32,
        compute_dtype: str = "float32",
        device="cuda",
    ):
        if stage3 is not None or use_fidelity_enhancer:
            raise NotImplementedError("the fidelity enhancer (stage 3) is not ported yet")
        if compute_dtype != "float32":
            raise NotImplementedError(f"compute_dtype={compute_dtype!r}: only float32 is ported")
        if cfg.maskgit.ess_use:
            raise NotImplementedError("the ESS sampler is not ported yet")
        dev = resolve_device(device)
        spec = Stage1Spec.from_config(cfg, input_length, in_channels)
        frozen = FrozenStage1.from_state_dict(spec, stage1_from_jax(stage1), dev)
        params = stage2["params"]
        # imported reference priors carry square project_in/out layers
        force = ("project_in" in params["l"], "project_in" in params["h"])
        t_l, t_h = build_transformers(cfg, spec, n_classes, force)
        sd_l, sd_h = prior_from_jax(params, stage2.get("h_stats"))
        t_l.load_state_dict(sd_l)
        t_h.load_state_dict(sd_h)
        self._assemble(cfg, frozen, t_l, t_h, n_classes, batch_size, dev)

    @classmethod
    def from_init(cls, cfg: Config, input_length: int, in_channels: int,
                  n_classes: int, seed: int = 0, device="cuda",
                  batch_size: int = 32) -> "TrainedModelSampler":
        """A sampler with seeded random weights at ``cfg``'s shapes: every
        draw comes from one CPU generator, so a seed gives the same weights
        on every device."""
        dev = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        spec = Stage1Spec.from_config(cfg, input_length, in_channels)
        model, vq_l, vq_h = init_stage1(spec, g, dev)
        frozen = FrozenStage1(model.eval(), vq_l, vq_h)
        t_l, t_h = (init_weights_(t, g) for t in build_transformers(cfg, spec, n_classes))
        self = cls.__new__(cls)
        self._assemble(cfg, frozen, t_l, t_h, n_classes, batch_size, dev)
        return self

    def _assemble(self, cfg, frozen, t_l, t_h, n_classes, batch_size, device):
        spec = frozen.model.spec
        self.device = device
        self.batch_size = batch_size
        self.input_length = spec.input_length
        self.in_channels = spec.in_channels
        self.n_classes = n_classes
        self.s1_spec = spec
        self.mg_spec = MaskGITSpec.from_config(cfg, spec)
        self.frozen = frozen
        self.t_l, self.t_h = t_l.to(device).eval(), t_h.to(device).eval()
        self._sample_tokens = make_sampling_fn(frozen, self.t_l, self.t_h, self.mg_spec)

    # ------------------------------------------------------------------

    def sample(
        self,
        n_samples: int,
        kind: str = "unconditional",
        class_index: Optional[int] = None,
        batch_size: Optional[int] = None,
        seed: int = 0,
        noise: Optional[Sequence[dict]] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched sampling; returns (x_l, x_h, x) host arrays (n, C, L).
        ``noise``, when given, holds one ``iterative_decoding`` noise dict
        per batch in place of the seeded draws."""
        if kind not in ("unconditional", "conditional"):
            raise ValueError(f"kind must be 'unconditional' or 'conditional', got {kind!r}")
        if kind == "conditional":
            if class_index is None:
                raise ValueError("conditional sampling needs class_index")
        else:
            class_index = None
        bs = batch_size or self.batch_size
        gen = torch.Generator(device=self.device).manual_seed(seed)
        outs = ([], [], [])
        for i, start in enumerate(range(0, n_samples, bs)):
            b = min(bs, n_samples - start)
            xs = self._sample_tokens(b, class_index, generator=gen,
                                     noise=None if noise is None else noise[i])
            for acc, x in zip(outs, xs):
                acc.append(x.cpu().numpy())
        return tuple(np.concatenate(acc) for acc in outs)

    # ------------------------------------------------------------------

    @torch.inference_mode()
    def reconstruct(self, x: np.ndarray, svq_temp: Optional[float] = None,
                    seed: int = 0) -> np.ndarray:
        """Stage-1 round trip: encode (argmax, or SVQ-stochastic with
        svq_temp > 0) and decode, in batches of ``batch_size``."""
        temp = svq_temp if svq_temp else None
        gen = torch.Generator(device=self.device).manual_seed(seed)
        outs = []
        for start in range(0, x.shape[0], self.batch_size):
            xb = torch.as_tensor(x[start:start + self.batch_size], dtype=torch.float32,
                                 device=self.device)
            s_l = encode_tokens(self.frozen, xb, "lf", svq_temp=temp, generator=gen)
            s_h = encode_tokens(self.frozen, xb, "hf", svq_temp=temp, generator=gen)
            out = decode_tokens(self.frozen, s_l, "lf") + decode_tokens(self.frozen, s_h, "hf")
            outs.append(out.cpu().numpy())
        return np.concatenate(outs)
