"""Stage-1 TimeVQVAE model: dual-band (LF/HF) spectral VQ-VAE.

Port of ``tvqvae_tpu/models/stage1.py``. Per band:

    STFT -> band copy -> encoder -> VQ -> decoder -> band zero -> iSTFT
         -> resize + residual dense head

The codebooks are separate state (``models/vq.py::CodebookState``), passed in
as in the JAX package, and come back advanced one EMA step from a training
forward. Tokens are H-major: the encoder's NCHW output is permuted to NHWC
before it is flattened to (B, H'*W', D), and back on decode, so token n is
(h, w) = divmod(n, W') in both packages.

``forward(..., train=True)`` puts the stacks in train mode (BatchNorm batch
statistics and running-statistics update, ResBlock dropout) and ``False``
back in eval mode; ``encode``/``decode`` run in whichever mode the module is.

The spec carries the JAX package's precision options: ``compute_dtype``
(the four conv stacks; parameters, BatchNorm statistics, the VQ, the loss
targets and the losses stay float32), ``fast_bn``, ``remat``, ``bf16_head``
(the TimeHeads' dense in the compute dtype) and ``bf16_istft`` (the decode
path's iSTFT in the compute dtype).
"""

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.models.layers import cast_dtype, init_weights_
from tvqvae_tpu_torch.models.vq import CodebookState, VQOutput, VQParams, init_codebook, vq_forward
from tvqvae_tpu_torch.models.vqvae import TimeHead, VQVAEDecoder, VQVAEEncoder
from tvqvae_tpu_torch.ops import (
    interp_linear,
    time_to_timefreq,
    timefreq_to_time,
    token_geometry,
    zero_pad_high_freq,
    zero_pad_low_freq,
)
from tvqvae_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class Stage1Spec:
    """Static shape/hyperparameter bundle derived from the config."""

    input_length: int
    in_channels: int
    n_fft: int
    init_dim: int
    hid_dim: int
    n_resnet_blocks_enc: int
    n_resnet_blocks_dec: int
    halvings_l: int
    halvings_h: int
    tokens_l: int
    tokens_h: int
    hw_l: tuple
    hw_h: tuple
    vq_l: VQParams
    vq_h: VQParams
    dropout_enc: float = 0.3
    dropout_dec: float = 0.3
    compute_dtype: str = "float32"
    remat: bool = False
    fast_bn: bool = False
    bf16_head: bool = False
    bf16_istft: bool = False

    @staticmethod
    def from_config(cfg: Config, input_length: int, in_channels: int,
                    compute_dtype: str = "float32", remat: bool = False, fast_bn: bool = False,
                    bf16_head: bool = False, bf16_istft: bool = False) -> "Stage1Spec":
        g_l = token_geometry(input_length, cfg.vqvae.n_fft, cfg.encoder.downsampled_width["lf"])
        g_h = token_geometry(input_length, cfg.vqvae.n_fft, cfg.encoder.downsampled_width["hf"])

        def mk_vq(band):
            return VQParams(
                codebook_size=cfg.vqvae.codebook_sizes[band],
                dim=cfg.encoder.hid_dim,
                decay=cfg.vqvae.decay,
                eps=cfg.vqvae.eps,
                commitment_weight=cfg.vqvae.commitment_weight,
                threshold_ema_dead_code=cfg.vqvae.threshold_ema_dead_code,
                kmeans_init=cfg.vqvae.kmeans_init,
                kmeans_iters=cfg.vqvae.kmeans_iters,
            )

        return Stage1Spec(
            input_length=input_length,
            in_channels=in_channels,
            n_fft=cfg.vqvae.n_fft,
            init_dim=cfg.encoder.init_dim,
            hid_dim=cfg.encoder.hid_dim,
            n_resnet_blocks_enc=cfg.encoder.n_resnet_blocks,
            n_resnet_blocks_dec=cfg.decoder.n_resnet_blocks,
            halvings_l=g_l.num_halvings,
            halvings_h=g_h.num_halvings,
            tokens_l=g_l.num_tokens,
            tokens_h=g_h.num_tokens,
            hw_l=(g_l.h_prime, g_l.w_prime),
            hw_h=(g_h.h_prime, g_h.w_prime),
            vq_l=mk_vq("lf"),
            vq_h=mk_vq("hf"),
            dropout_enc=cfg.encoder.dropout,
            dropout_dec=cfg.decoder.dropout,
            compute_dtype=compute_dtype,
            remat=remat,
            fast_bn=fast_bn,
            bf16_head=bf16_head,
            bf16_istft=bf16_istft,
        )


@dataclass
class Stage1Output:
    x_l: torch.Tensor  # LF time-domain target
    x_h: torch.Tensor  # HF time-domain target
    xhat_l: torch.Tensor
    xhat_h: torch.Tensor
    vq_l: VQOutput
    vq_h: VQOutput


class Stage1Model(nn.Module):
    """The four conv stacks and two time heads; VQ state is passed in."""

    def __init__(self, spec: Stage1Spec):
        super().__init__()
        s = spec
        self.spec = s
        spectral = 2 * s.in_channels
        self.compute_dtype = dt = cast_dtype(s.compute_dtype)  # None: float32
        prec = dict(compute_dtype=dt, remat=s.remat, fast_bn=s.fast_bn)
        self.encoder_l = VQVAEEncoder(spectral, s.init_dim, s.hid_dim, s.halvings_l,
                                      s.n_resnet_blocks_enc, dropout=s.dropout_enc, **prec)
        self.encoder_h = VQVAEEncoder(spectral, s.init_dim, s.hid_dim, s.halvings_h,
                                      s.n_resnet_blocks_enc, dropout=s.dropout_enc, **prec)
        self.decoder_l = VQVAEDecoder(s.init_dim, s.hid_dim, spectral, s.halvings_l,
                                      s.n_resnet_blocks_dec, dropout=s.dropout_dec, **prec)
        self.decoder_h = VQVAEDecoder(s.init_dim, s.hid_dim, spectral, s.halvings_h,
                                      s.n_resnet_blocks_dec, dropout=s.dropout_dec, **prec)
        head_dt = dt if s.bf16_head else None
        self.head_l = TimeHead(s.input_length, head_dt)
        self.head_h = TimeHead(s.input_length, head_dt)

    def encode(self, x: torch.Tensor, band: str,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, C, L) time series -> (B, N, D) latent tokens, H-major."""
        xf = time_to_timefreq(x, self.spec.n_fft)  # (B, 2C, H, W)
        pad = zero_pad_high_freq if band == "lf" else zero_pad_low_freq
        enc = self.encoder_l if band == "lf" else self.encoder_h
        z = enc(pad(xf, copy=True), generator)  # (B, D, H', W')
        B, D, H, W = z.shape
        return z.permute(0, 2, 3, 1).reshape(B, H * W, D)

    def decode(self, zq: torch.Tensor, band: str,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, N, D) quantized tokens -> (B, C, input_length) time series."""
        s = self.spec
        H, W = s.hw_l if band == "lf" else s.hw_h
        z = zq.reshape(zq.shape[0], H, W, s.hid_dim).permute(0, 3, 1, 2)
        dec = self.decoder_l if band == "lf" else self.decoder_h
        head = self.head_l if band == "lf" else self.head_h
        pad = zero_pad_high_freq if band == "lf" else zero_pad_low_freq
        u = pad(dec(z, generator))  # zero the other band of the decoder output
        if s.bf16_istft and self.compute_dtype is not None:
            u = u.to(self.compute_dtype)  # the head adds in float32
        return head(timefreq_to_time(u, s.n_fft))

    def forward(
        self,
        x: torch.Tensor,
        vq_state_l: CodebookState,
        vq_state_h: CodebookState,
        train: bool = False,
        svq_temp: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
        row_generator: Optional[torch.Generator] = None,
    ) -> Stage1Output:
        """``generator`` draws the dropout masks and the SVQ draws,
        ``row_generator`` the rows of the VQ's k-means init and dead-code
        expiry (``models/vq.py::vq_forward``)."""
        s = self.spec
        self.train(train)
        xf = time_to_timefreq(x, s.n_fft)
        x_l = interp_linear(timefreq_to_time(zero_pad_high_freq(xf), s.n_fft), s.input_length)
        x_h = interp_linear(timefreq_to_time(zero_pad_low_freq(xf), s.n_fft), s.input_length)
        out_l = vq_forward(vq_state_l, self.encode(x, "lf", generator), s.vq_l,
                           train=train, svq_temp=svq_temp, generator=generator,
                           row_generator=row_generator)
        xhat_l = self.decode(out_l.quantized, "lf", generator)
        out_h = vq_forward(vq_state_h, self.encode(x, "hf", generator), s.vq_h,
                           train=train, svq_temp=svq_temp, generator=generator,
                           row_generator=row_generator)
        xhat_h = self.decode(out_h.quantized, "hf", generator)
        return Stage1Output(x_l=x_l, x_h=x_h, xhat_l=xhat_l, xhat_h=xhat_h,
                            vq_l=out_l, vq_h=out_h)


def init_stage1(spec: Stage1Spec, generator: torch.Generator, device="cuda"):
    """Seeded random weights and codebooks, every draw from ``generator`` (a
    CPU generator gives the same weights on every device): the model's
    layers, then the LF and the HF codebook. -> (model, vq_l, vq_h) on
    ``device``."""
    device = resolve_device(device)
    model = init_weights_(Stage1Model(spec), generator)
    vq_l, vq_h = init_codebook(spec.vq_l, generator), init_codebook(spec.vq_h, generator)
    return model.to(device), vq_l.to(device), vq_h.to(device)


def stage1_losses(out: Stage1Output):
    """MSE on the LF series, L1 on the HF series, plus both commitment losses.
    -> (total, {name: scalar tensor}), with the JAX package's metric names."""
    recon_l = ((out.x_l - out.xhat_l) ** 2).mean()
    recon_h = (out.x_h - out.xhat_h).abs().mean()
    total = recon_l + recon_h + out.vq_l.loss + out.vq_h.loss
    metrics = {
        "loss": total,
        "recons_loss.LF.time": recon_l,
        "recons_loss.HF.time": recon_h,
        "recons_loss.time": recon_l + recon_h,
        "commit_loss.LF": out.vq_l.commit_loss,
        "commit_loss.HF": out.vq_h.commit_loss,
        "perplexity.LF": out.vq_l.perplexity,
        "perplexity.HF": out.vq_h.perplexity,
    }
    return total, metrics
