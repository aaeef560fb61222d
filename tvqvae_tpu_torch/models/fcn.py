"""FCN time-series classifier: the FID/IS feature network.

Port of ``tvqvae_tpu/models/fcn.py``: three Conv1d("same") + BatchNorm +
ReLU blocks (128/256/128 channels, kernels 8/5/3), global average pooling
over time and a dense head; ``features=True`` returns the 128-wide pooled
vector. For the even kernel 8, torch's ``padding="same"`` pads 3 on the left
and 4 on the right, as flax's (TensorFlow's) "SAME" does. The BatchNorms are
``layers.BatchNorm1d`` (flax's train statistics, momentum 0.9, eps 1e-5).
Channel-first (B, C, L) input, as the JAX module takes it.
"""

import torch
from torch import nn

from tvqvae_tpu_torch.models.layers import BatchNorm1d

BLOCKS = ((128, 8), (256, 5), (128, 3))


class FCN(nn.Module):
    def __init__(self, in_channels: int, n_classes: int):
        super().__init__()
        c_in = in_channels
        for i, (ch, k) in enumerate(BLOCKS):
            self.add_module(f"Conv_{i}", nn.Conv1d(c_in, ch, k, padding="same"))
            self.add_module(f"BatchNorm_{i}", BatchNorm1d(ch))
            c_in = ch
        self.Dense_0 = nn.Linear(c_in, n_classes)

    def forward(self, x: torch.Tensor, train: bool = False, features: bool = False):
        """x (B, C, L) -> logits (B, n_classes), or the pooled (B, 128) with
        ``features``. ``train`` normalises with the batch's statistics and
        moves the running ones."""
        self.train(train)
        h = x
        for i in range(len(BLOCKS)):
            h = torch.relu(getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(h)))
        h = h.mean(dim=-1)
        return h if features else self.Dense_0(h)
