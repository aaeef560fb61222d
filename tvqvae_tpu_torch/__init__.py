"""PyTorch/CUDA port of ``tvqvae_tpu`` for NVIDIA Hopper (H100).

A second package beside the JAX one, which stays the reference: the same
module names, the same public layouts ((B, C, L) series, (B, N, D) tokens in
H-major order, (B, 2C, H, W) spectra), checked against it by
``tests/test_torch_*.py``. It imports torch and numpy only, never JAX or
anything of ``tvqvae_tpu``. Entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
