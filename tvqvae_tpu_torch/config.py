"""Typed configuration mirroring the reference YAML schema.

A copy of ``tvqvae_tpu/config.py``: the same YAML keys parse into the same
frozen dataclasses, and the dataclass defaults are the published shapes.
PyYAML is imported only inside ``load_yaml``, so the package imports on a
machine without it (``Config()`` and ``Config.from_dict`` need no YAML).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


def load_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path, "r") as f:
        return yaml.safe_load(f)


@dataclass(frozen=True)
class DatasetConfig:
    features: List[str] = field(
        default_factory=lambda: ["latitude", "longitude", "altitude", "timedelta"]
    )
    data_scaling: bool = True
    batch_sizes: Dict[str, int] = field(
        default_factory=lambda: {"stage1": 32, "stage2": 16, "stage3": 16}
    )
    num_workers: int = 0


@dataclass(frozen=True)
class ExpConfig:
    lr: float = 1e-3
    linear_warmup_rate: float = 0.1


@dataclass(frozen=True)
class TrainerConfig:
    max_steps: Dict[str, int] = field(
        default_factory=lambda: {"stage1": 50000, "stage2": 200000, "stage3": 50000}
    )
    val_check_interval: Dict[str, int] = field(
        default_factory=lambda: {"stage1": 5000, "stage2": 10000, "stage3": 2500}
    )


@dataclass(frozen=True)
class EncoderConfig:
    init_dim: int = 4
    hid_dim: int = 128
    n_resnet_blocks: int = 2
    downsampled_width: Dict[str, int] = field(
        default_factory=lambda: {"lf": 8, "hf": 32}
    )
    dropout: float = 0.3


@dataclass(frozen=True)
class DecoderConfig:
    n_resnet_blocks: int = 2
    dropout: float = 0.3


@dataclass(frozen=True)
class VQVAEConfig:
    n_fft: int = 4
    codebook_sizes: Dict[str, int] = field(
        default_factory=lambda: {"lf": 32, "hf": 32}
    )
    decay: float = 0.8
    eps: float = 1e-5
    commitment_weight: float = 1.0
    threshold_ema_dead_code: int = 0
    kmeans_init: bool = False
    kmeans_iters: int = 10
    emb_dropout: float = 0.0


@dataclass(frozen=True)
class PriorModelConfig:
    hidden_dim: int = 128
    n_layers: int = 4
    heads: int = 2
    ff_mult: int = 1
    use_rmsnorm: bool = True
    p_unconditional: float = 0.2
    model_dropout: float = 0.3
    emb_dropout: float = 0.3


@dataclass(frozen=True)
class MaskGITConfig:
    choice_temperatures: Dict[str, float] = field(
        default_factory=lambda: {"lf": 10, "hf": 4}
    )
    T: Dict[str, int] = field(default_factory=lambda: {"lf": 10, "hf": 1})
    prior_model_l: PriorModelConfig = field(default_factory=PriorModelConfig)
    prior_model_h: PriorModelConfig = field(
        default_factory=lambda: PriorModelConfig(
            hidden_dim=32, n_layers=1, heads=1
        )
    )
    cfg_scale: float = 1.0
    # ESS — Enhanced Sampling Scheme (reference maskgit.py:479-679;
    # disabled/"under maintenance" in the reference config, off by default)
    ess_use: bool = False
    ess_error_ratio_ma_rate: float = 0.3


@dataclass(frozen=True)
class FidelityEnhancerConfig:
    dim: int = 8
    dim_mults: List[int] = field(default_factory=lambda: [1, 2, 4, 8])
    resnet_block_groups: int = 4
    dropout: float = 0.5
    tau_search_rng: List[float] = field(
        default_factory=lambda: [0.1, 0.5, 1, 2, 4]
    )
    percept_loss_weight: float = 0.0


@dataclass(frozen=True)
class EvaluationConfig:
    batch_size: int = 32
    min_num_gen_samples: int = 1024
    feature_extractor_type: str = "rocket"


@dataclass(frozen=True)
class LoggerConfig:
    mlflow_uri: Optional[str] = None
    experiment_name: str = "SynTraj-TimeVQVAE-TPU"


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout of the JAX package (parsed, unused by the port)."""

    data: int = -1  # data-parallel axis over ICI


@dataclass(frozen=True)
class Config:
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    exp_params: ExpConfig = field(default_factory=ExpConfig)
    trainer_params: TrainerConfig = field(default_factory=TrainerConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    vqvae: VQVAEConfig = field(default_factory=VQVAEConfig)
    maskgit: MaskGITConfig = field(default_factory=MaskGITConfig)
    fidelity_enhancer: FidelityEnhancerConfig = field(
        default_factory=FidelityEnhancerConfig
    )
    evaluation: EvaluationConfig = field(default_factory=EvaluationConfig)
    logger: LoggerConfig = field(default_factory=LoggerConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    seed: int = 0

    @staticmethod
    def from_yaml(path: str) -> "Config":
        return Config.from_dict(load_yaml(path))

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Config":
        """Parse a reference-schema config dict (extra keys are ignored)."""

        def build(cls, section):
            if section is None:
                return cls()
            names = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: v for k, v in section.items() if k in names})

        mg = d.get("MaskGIT", {}) or {}
        mg_kwargs = {}
        if "choice_temperatures" in mg:
            mg_kwargs["choice_temperatures"] = mg["choice_temperatures"]
        if "T" in mg:
            mg_kwargs["T"] = mg["T"]
        if "cfg_scale" in mg:
            mg_kwargs["cfg_scale"] = float(mg["cfg_scale"])
        if "prior_model_l" in mg:
            mg_kwargs["prior_model_l"] = build(PriorModelConfig, mg["prior_model_l"])
        if "prior_model_h" in mg:
            mg_kwargs["prior_model_h"] = build(PriorModelConfig, mg["prior_model_h"])
        if "ESS" in mg and mg["ESS"]:
            mg_kwargs["ess_use"] = bool(mg["ESS"].get("use", False))
            mg_kwargs["ess_error_ratio_ma_rate"] = float(
                mg["ESS"].get("error_ratio_ma_rate", 0.3)
            )

        return Config(
            dataset=build(DatasetConfig, d.get("dataset")),
            exp_params=build(ExpConfig, d.get("exp_params")),
            trainer_params=build(TrainerConfig, d.get("trainer_params")),
            encoder=build(EncoderConfig, d.get("encoder")),
            decoder=build(DecoderConfig, d.get("decoder")),
            vqvae=build(VQVAEConfig, d.get("VQ-VAE")),
            maskgit=MaskGITConfig(**mg_kwargs),
            fidelity_enhancer=build(
                FidelityEnhancerConfig, d.get("fidelity_enhancer")
            ),
            evaluation=build(EvaluationConfig, d.get("evaluation")),
            logger=build(LoggerConfig, d.get("logger")),
            mesh=build(MeshConfig, d.get("mesh")),
            seed=int(d.get("seed", 0)),
        )
