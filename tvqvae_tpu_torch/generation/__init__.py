from .sampler import TrainedModelSampler

__all__ = ["TrainedModelSampler"]
