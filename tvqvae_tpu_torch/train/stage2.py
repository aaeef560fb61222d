"""Stage 2 (MaskGIT prior): the sampling function.

Port of ``tvqvae_tpu/train/stage2.py::make_sampling_fn``; the training step
comes with the training slice. JAX passes every parameter tree as a jit
argument; here the frozen stage 1 and the priors are eval-mode modules that
the returned function closes over.
"""

from typing import Callable, Optional

import torch

from tvqvae_tpu_torch.models.maskgit import (
    FrozenStage1,
    MaskGITSpec,
    decode_tokens,
    iterative_decoding,
)
from tvqvae_tpu_torch.models.transformer import BidirectionalTransformer


def make_sampling_fn(
    frozen: FrozenStage1,
    t_l: BidirectionalTransformer,
    t_h: BidirectionalTransformer,
    spec: MaskGITSpec,
) -> Callable:
    """Returns fn(num, class_index=None, generator=None, noise=None) ->
    (x_l, x_h, x), each (num, C, L): MaskGIT decoding of both token grids,
    codebook lookup, the frozen decoders and the LF+HF sum."""

    def apply_l(s_l, cond):
        return t_l(s_l, None, cond)

    def apply_h(s_l, s_h, cond):
        return t_h(s_l, s_h, cond)

    @torch.inference_mode()
    def sample(num: int, class_index: Optional[int] = None,
               generator: Optional[torch.Generator] = None, noise: Optional[dict] = None):
        device = frozen.vq_l.embed.device
        s_l, s_h = iterative_decoding(
            spec, apply_l, apply_h, num, class_index,
            device=device, generator=generator, noise=noise,
        )
        x_l = decode_tokens(frozen, s_l, "lf")
        x_h = decode_tokens(frozen, s_h, "hf")
        return x_l, x_h, x_l + x_h

    return sample
