"""Trained-model sampler: weights -> batched generation and reconstruction.

Port of ``tvqvae_tpu/generation/sampler.py::TrainedModelSampler``. Per
batch, ``sample`` runs MaskGIT decoding of both token grids, the
codebook lookup, the frozen stage-1 decoders and the LF+HF sum
(``train/stage2.make_sampling_fn``); ``reconstruct`` runs the stage-1 round
trip, whose argmax quantization launches the VQ kernel once per band.

With ``use_fidelity_enhancer`` the stage-3 U-Net refines the summed
series ``x`` of every batch (not ``x_l`` or ``x_h``); ``enhance`` applies it
to given series.

The constructor takes the trees a checkpoint holds, in the JAX package's
layout: stage 1 ``{"params", "batch_stats", "vq_l", "vq_h"}``, stage 2
``{"params": {"l", "h"}, "h_stats"}`` and stage 3 ``{"params": {"Unet1D_0":
...}, "tau"}``; ``tau``, the SVQ temperature stage 3 trained at (0 without
one), is what the evaluation's ``FID_svq`` round trip uses.
``from_checkpoints`` reads them from the port's checkpoint files, as the JAX
sampler reads its Orbax ones (``tools/export_jax_ckpt.py`` converts those);
``from_init`` builds seeded random weights instead.
``search_optimal_tau`` is the FID-matching search for that temperature.

The three constructors take the JAX sampler's precision options:
``compute_dtype`` (``"bfloat16"``: the frozen stage-1 stacks and the
enhancer's stream), ``fast_bn`` (stage 1's fast BatchNorm and the enhancer's
fast GroupNorm), and ``bf16_head`` and ``bf16_istft``, on by default and
inert at float32, as in JAX. The priors stay float32, so the sampled tokens
do not depend on them.

With ``cfg.maskgit.ess_use`` every batch runs the ESS sampler
(``train/stage2.make_ess_sampling_fn``, moving-average rate
``cfg.maskgit.ess_error_ratio_ma_rate``) from any constructor. Its step
retraction takes one ``t_star`` per batch, so an ESS batch is always
``batch_size`` samples, the last one cut to what was asked, as the JAX
sampler batches.

``devices`` (every constructor; the counterpart of the JAX sampler's
``mesh``) fans ``sample`` out over several devices: one replica of the
frozen stage 1, the priors and the enhancer per device, each batch's
decoding noise drawn once on the first device from the seeded generator
(``models/maskgit.py::decoding_noise``, what one device draws inside) and
split into contiguous row chunks, one per replica, each decoded in its own
thread, and the results concatenated in order. So a seed gives the same
series with and without the fan-out. ``batch_size`` must divide by the
number of devices, as the JAX serve CLI checks. An ESS batch, whose step
retraction is one per batch, runs whole on the first device, as JAX's ESS
sampler takes no mesh; ``reconstruct`` and ``enhance`` run there too.
"""

import copy
from concurrent.futures import ThreadPoolExecutor
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from tvqvae_tpu_torch.config import Config
from tvqvae_tpu_torch.models.maskgit import (
    FrozenStage1,
    MaskGITSpec,
    build_transformers,
    decode_tokens,
    decoding_noise,
    encode_tokens,
)
from tvqvae_tpu_torch.models.fidelity_enhancer import FidelityEnhancer
from tvqvae_tpu_torch.models.stage1 import Stage1Spec, init_stage1
from tvqvae_tpu_torch.train.stage2 import (
    init_stage2,
    make_ess_sampling_fn,
    make_sampling_fn,
    priors_from_tree,
)
from tvqvae_tpu_torch.train.stage3 import init_stage3
from tvqvae_tpu_torch.utils.checkpoint import load_checkpoint
from tvqvae_tpu_torch.utils.convert import fe_from_jax, stage1_from_jax
from tvqvae_tpu_torch.utils.device import resolve_device


class TrainedModelSampler:
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
        fast_bn: bool = False,
        bf16_head: bool = True,
        bf16_istft: bool = True,
        device="cuda",
        devices: Optional[Sequence] = None,
    ):
        if use_fidelity_enhancer and stage3 is None:
            raise ValueError("use_fidelity_enhancer=True needs a stage3 tree")
        dev = resolve_device(devices[0] if devices else device)
        spec = Stage1Spec.from_config(cfg, input_length, in_channels, compute_dtype=compute_dtype,
                                      fast_bn=fast_bn, bf16_head=bf16_head, bf16_istft=bf16_istft)
        frozen = FrozenStage1.from_state_dict(spec, stage1_from_jax(stage1), dev)
        t_l, t_h = priors_from_tree(cfg, spec, n_classes, stage2)
        fe = None
        if stage3 is not None:
            fe = FidelityEnhancer.from_config(cfg, input_length, in_channels, compute_dtype,
                                              fast_bn)
            fe.load_state_dict(fe_from_jax(stage3["params"]))
        self._assemble(cfg, frozen, t_l, t_h, n_classes, batch_size, dev, fe,
                       use_fidelity_enhancer, devices)
        if stage3 is not None:
            self.tau = float(np.asarray(stage3.get("tau", 0.0)))

    @classmethod
    def from_checkpoints(cls, cfg: Config, stage1_ckpt: str, stage2_ckpt: str,
                         stage3_ckpt: Optional[str] = None, use_fidelity_enhancer: bool = False,
                         batch_size: int = 32, device="cuda", compute_dtype: str = "float32",
                         fast_bn: bool = False, bf16_head: bool = True,
                         bf16_istft: bool = True,
                         devices: Optional[Sequence] = None) -> "TrainedModelSampler":
        """A sampler from stage checkpoints (``utils/checkpoint.py``), as the
        JAX sampler is built: the geometry (``input_length``,
        ``in_channels``, ``n_classes``) from the stage-1 meta, everything
        else from ``cfg`` and the precision options."""
        if use_fidelity_enhancer and stage3_ckpt is None:
            raise ValueError("use_fidelity_enhancer=True needs stage3_ckpt")
        tree1, meta = load_checkpoint(stage1_ckpt)
        tree2, _ = load_checkpoint(stage2_ckpt)
        tree3 = load_checkpoint(stage3_ckpt)[0] if stage3_ckpt is not None else None
        return cls(cfg, tree1, tree2, input_length=int(meta["input_length"]),
                   in_channels=int(meta["in_channels"]), n_classes=int(meta["n_classes"]),
                   stage3=tree3, use_fidelity_enhancer=use_fidelity_enhancer,
                   batch_size=batch_size, compute_dtype=compute_dtype, fast_bn=fast_bn,
                   bf16_head=bf16_head, bf16_istft=bf16_istft, device=device,
                   devices=devices)

    @classmethod
    def from_init(cls, cfg: Config, input_length: int, in_channels: int,
                  n_classes: int, seed: int = 0, device="cuda",
                  batch_size: int = 32, use_fidelity_enhancer: bool = False,
                  compute_dtype: str = "float32", fast_bn: bool = False,
                  bf16_head: bool = True, bf16_istft: bool = True,
                  devices: Optional[Sequence] = None) -> "TrainedModelSampler":
        """A sampler with seeded random weights at ``cfg``'s shapes: every
        draw comes from one CPU generator, so a seed gives the same weights
        on every device and at every precision. With
        ``use_fidelity_enhancer`` the enhancer's weights are drawn after the
        priors' and it refines every sample."""
        dev = resolve_device(devices[0] if devices else device)
        g = torch.Generator().manual_seed(seed)
        spec = Stage1Spec.from_config(cfg, input_length, in_channels, compute_dtype=compute_dtype,
                                      fast_bn=fast_bn, bf16_head=bf16_head, bf16_istft=bf16_istft)
        model, vq_l, vq_h = init_stage1(spec, g, dev)
        frozen = FrozenStage1(model.eval(), vq_l, vq_h)
        t_l, t_h = init_stage2(*build_transformers(cfg, spec, n_classes), g, dev)
        fe = (init_stage3(FidelityEnhancer.from_config(cfg, input_length, in_channels,
                                                       compute_dtype, fast_bn), g, dev)
              if use_fidelity_enhancer else None)
        self = cls.__new__(cls)
        self._assemble(cfg, frozen, t_l, t_h, n_classes, batch_size, dev, fe,
                       use_fidelity_enhancer, devices)
        return self

    def _assemble(self, cfg, frozen, t_l, t_h, n_classes, batch_size, device, fe, use_fe,
                  devices=None):
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
        self.use_ess = bool(cfg.maskgit.ess_use)
        self._ess_rate = float(cfg.maskgit.ess_error_ratio_ma_rate)
        self._sample_tokens = (
            make_ess_sampling_fn(frozen, self.t_l, self.t_h, self.mg_spec, self._ess_rate)
            if self.use_ess else make_sampling_fn(frozen, self.t_l, self.t_h, self.mg_spec))
        self.fe = None if fe is None else fe.to(device).eval()
        self.use_fe = use_fe
        self.tau = 0.0
        self.devices = [device] + [resolve_device(d) for d in (devices or [])[1:]]
        if batch_size % len(self.devices):
            raise ValueError(f"batch_size {batch_size} must divide by the device count "
                             f"{len(self.devices)}")
        # (sample_fn, enhancer) per device, the first one this sampler's own
        # (the fan-out runs only without ESS: _sample_tokens is then the plain one)
        self._replicas = [(self._sample_tokens, self.fe)]
        for d in self.devices[1:]:
            f = FrozenStage1(copy.deepcopy(frozen.model).to(d), frozen.vq_l.to(d),
                             frozen.vq_h.to(d))
            self._replicas.append((make_sampling_fn(f, copy.deepcopy(self.t_l).to(d),
                                                    copy.deepcopy(self.t_h).to(d), self.mg_spec),
                                   None if self.fe is None else copy.deepcopy(self.fe).to(d)))

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
        """Batched sampling; returns (x_l, x_h, x) host arrays (n, C, L), ``x``
        through the fidelity enhancer when it is on. ``noise``, when given,
        holds one ``iterative_decoding`` noise dict per batch in place of the
        seeded draws (``iterative_decoding_ess``'s dict with ESS)."""
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
            if len(self.devices) > 1 and not self.use_ess:
                got = self._fan_out(b, class_index, noise[i] if noise is not None
                                    else decoding_noise(self.mg_spec, b, gen, self.device))
            else:
                x_l, x_h, x = self._sample_tokens(bs if self.use_ess else b, class_index,
                                                  generator=gen,
                                                  noise=None if noise is None else noise[i])
                x_l, x_h, x = x_l[:b], x_h[:b], x[:b]
                if self.use_fe:
                    x = self._enhance(x)
                got = tuple(t.cpu().numpy() for t in (x_l, x_h, x))
            for acc, t in zip(outs, got):
                acc.append(t)
        return tuple(np.concatenate(acc) for acc in outs)

    def _fan_out(self, num: int, class_index: Optional[int], noise: dict):
        """One batch of ``num`` over the replicas: contiguous row chunks of
        ``noise`` (split along its batch axis, 1), one thread per device.
        -> host arrays (x_l, x_h, x) in row order."""
        bounds = np.cumsum([0] + [len(c) for c in np.array_split(np.arange(num),
                                                                  len(self.devices))])

        threads = torch.get_num_threads()

        def run(k):
            # a new thread starts with the default intra-op (OpenMP) width:
            # give it the caller's, so a CPU chunk reduces as the caller would
            torch.set_num_threads(threads)
            sample_fn, fe = self._replicas[k]
            lo, hi, d = bounds[k], bounds[k + 1], self.devices[k]
            chunk = {band: tuple(t[:, lo:hi].to(d) for t in ts) for band, ts in noise.items()}
            x_l, x_h, x = sample_fn(hi - lo, class_index, noise=chunk)
            if self.use_fe:
                with torch.inference_mode():
                    x = fe(x)
            return tuple(t.cpu().numpy() for t in (x_l, x_h, x))

        busy = [k for k in range(len(self.devices)) if bounds[k + 1] > bounds[k]]
        with ThreadPoolExecutor(max_workers=len(busy)) as pool:
            parts = list(pool.map(run, busy))
        return tuple(np.concatenate(p) for p in zip(*parts))

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

    @torch.inference_mode()
    def _enhance(self, x: torch.Tensor) -> torch.Tensor:
        return self.fe(x)

    def enhance(self, x: np.ndarray) -> np.ndarray:
        """The fidelity enhancer (eval mode) over host series (n, C, L'), in
        batches of ``batch_size``; a length other than ``input_length`` is
        resized first. -> (n, C, input_length)."""
        if self.fe is None:
            raise ValueError("this sampler has no fidelity enhancer (stage3)")
        outs = []
        for start in range(0, x.shape[0], self.batch_size):
            xb = torch.as_tensor(x[start:start + self.batch_size], dtype=torch.float32,
                                 device=self.device)
            outs.append(self._enhance(xb).cpu().numpy())
        return np.concatenate(outs)


def search_optimal_tau(cfg: Config, sampler: TrainedModelSampler, metrics, X_train: np.ndarray,
                       n_samples: int = 1024, tau_search_rng=None, seed: int = 0) -> float:
    """The SVQ temperature whose stochastic round trip of ``X_train`` comes
    closest, by ``metrics.fid_score``, to ``n_samples`` unconditional
    samples: one FID per tau of ``tau_search_rng`` (default
    ``cfg.fidelity_enhancer.tau_search_rng``), the arg-min returned. The
    reference defines it and never calls it; the train CLI's
    ``--search_tau`` does."""
    taus = list(tau_search_rng or cfg.fidelity_enhancer.tau_search_rng)
    _, _, xhat = sampler.sample(n_samples, "unconditional", seed=seed)
    z_hat = metrics.compute_z(xhat)
    fids = []
    for tau in taus:
        xprime = sampler.reconstruct(X_train, svq_temp=float(tau), seed=seed)
        fid = metrics.fid_score(z_hat, metrics.compute_z(xprime))
        fids.append(float(fid))
        print(f"[tau-search] tau={tau} fid={fid:.4f}")
    best = taus[int(np.argmin(fids))]
    print(f"[tau-search] optimal tau = {best}")
    return float(best)
