"""Learning-rate schedules: linear warmup then cosine annealing (the three
stages), and a plain cosine decay (the FCN, ``cosine_decay_schedule``).

Port of ``tvqvae_tpu/utils/schedule.py``, which returns
``optax.warmup_cosine_decay_schedule(0, lr, int(max_steps * rate), max_steps,
min_lr)``. The value at optimizer step ``t`` (counted from 0, before the
step's increment, as optax counts) is

    lr * t / w                                         t < w
    lr * ((1 - a) * (1 + cos(pi * min(t - w, T) / T)) / 2 + a)   t >= w

with ``w = int(max_steps * rate)``, ``T = max_steps - w`` and ``a = min_lr /
lr``. So the first step has lr 0 and moves no parameter; with ``w == 0`` the
cosine starts at once, as in optax (its warmup piece is never reached). The
arithmetic is float64; optax's is float32.
"""

import math
from typing import Callable


def warmup_cosine_schedule(
    lr: float,
    max_steps: int,
    linear_warmup_rate: float = 0.1,
    min_lr: float = 1e-6,
) -> Callable[[int], float]:
    """Step count -> learning rate."""
    if not 0.0 <= linear_warmup_rate < 1.0:
        raise ValueError(f"need 0 <= linear_warmup_rate < 1, got {linear_warmup_rate}")
    warmup = int(max_steps * linear_warmup_rate)
    decay = max_steps - warmup
    if decay <= 0:
        raise ValueError(f"max_steps={max_steps} leaves no cosine steps after {warmup} of warmup")
    alpha = 0.0 if lr == 0.0 else min_lr / lr

    def schedule(t: int) -> float:
        if t < warmup:
            return lr * t / warmup
        c = min(t - warmup, decay)
        return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / decay)) + alpha)

    return schedule


def cosine_decay_schedule(lr: float, decay_steps: int) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule(lr, decay_steps)`` (alpha 0, exponent 1):
    the schedule above with no warmup and min_lr 0. ``train_fcn``'s
    schedule: lr at the first step, 0 from step T on."""
    return warmup_cosine_schedule(lr, decay_steps, 0.0, 0.0)
