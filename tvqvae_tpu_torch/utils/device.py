"""Device selection for the port's entry points."""

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``; raises when CUDA is asked for and absent, so
    an entry point never runs on the CPU unless the caller asked for it.

    On the card it also turns TF32 off for float32 matmuls and convolutions:
    the JAX package computes the STFT, the VQ distances and its products at
    ``Precision.HIGHEST``, and cuDNN convolutions default to TF32."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (False without CUDA)."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()
