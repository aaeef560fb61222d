from .fcn import FCN
from .fidelity_enhancer import FidelityEnhancer
from .maskgit import FrozenStage1, MaskGITSpec, build_transformers, iterative_decoding
from .stage1 import Stage1Model, Stage1Spec
from .transformer import BidirectionalTransformer
from .vq import CodebookState, VQParams, lookup_codes, vq_forward

__all__ = [
    "FCN",
    "FidelityEnhancer",
    "FrozenStage1",
    "MaskGITSpec",
    "build_transformers",
    "iterative_decoding",
    "Stage1Model",
    "Stage1Spec",
    "BidirectionalTransformer",
    "CodebookState",
    "VQParams",
    "lookup_codes",
    "vq_forward",
]
