from .sampler import TrainedModelSampler, search_optimal_tau

__all__ = ["TrainedModelSampler", "search_optimal_tau"]
