"""AdamW driven by a step schedule.

Port of ``tvqvae_tpu/train/optim.py::adamw`` as the stage-1 runner builds it
(``train/runner.py::_adamw``): ``optax.adamw`` over every parameter (no
mask), b1 0.9, b2 0.999, eps 1e-8 added to sqrt of the bias-corrected second
moment, decoupled weight decay 0.01 scaled by the scheduled lr. That is what
``torch.optim.AdamW`` computes; the schedule drives it through ``LambdaLR``,
which, like optax, reads the step count before the step's increment.

The moment-storage dtypes (``mu_dtype`` / ``nu_dtype``, the JAX package's
``bf16_mu`` / ``bf16_nu``) are not ported and raise ``NotImplementedError``.
"""

from typing import Callable, Iterable, Optional, Tuple, Union

import torch
from torch.optim.lr_scheduler import LambdaLR


def adamw(
    params: Iterable[torch.nn.Parameter],
    learning_rate: Union[float, Callable[[int], float]],
    weight_decay: float = 0.01,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    mu_dtype: Optional[torch.dtype] = None,
    nu_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.optim.AdamW, LambdaLR]:
    """-> (optimizer, scheduler). Call ``optimizer.step()`` then
    ``scheduler.step()`` once per training step."""
    if mu_dtype is not None or nu_dtype is not None:
        raise NotImplementedError("bf16 moment storage (mu_dtype/nu_dtype) is not ported yet")
    schedule = learning_rate if callable(learning_rate) else (lambda _: learning_rate)
    # base lr 1: the scheduler's factor is then the learning rate itself
    opt = torch.optim.AdamW(params, lr=1.0, betas=(b1, b2), eps=eps, weight_decay=weight_decay)
    return opt, LambdaLR(opt, schedule)
