"""AdamW driven by a step schedule, with optional bfloat16 moment storage.

Port of ``tvqvae_tpu/train/optim.py::adamw`` as the runners build it
(``train/runner.py::_adamw``): ``optax.adamw`` over every parameter (no
mask), b1 0.9, b2 0.999, eps 1e-8 added to sqrt of the bias-corrected second
moment, decoupled weight decay scaled by the scheduled lr. The schedule
drives it through ``LambdaLR``, which, like optax, reads the step count
before the step's increment.

``AdamWStorage`` follows optax 0.2.6's ``scale_by_adam`` step by step: the
moments are updated in (at least) float32 as ``(1 - b)·g^k + b·m``, the
step's update is computed from the unrounded moments, and only then are they
rounded (to nearest even) into their storage dtype. That is the parameter's
dtype unless ``mu_dtype`` / ``nu_dtype`` (the JAX package's ``bf16_mu`` /
``bf16_nu``) name another.

One rounding is optax's own: in ``b·m`` JAX's weak typing casts the Python
float ``b`` to the stored moment's dtype, so a bfloat16 moment decays by
``b`` rounded to bfloat16 (0.9 -> 0.8984375; 0.999 -> 1.0, so a bfloat16
second moment does not decay at all). The bias corrections ``1 - b^t`` are
computed in float32 (float64 for float64 parameters), as optax computes them
outside ``jax.enable_x64``. ``AdamWStorage`` computes the same, so that its
stored moments are optax's.

A step reads nothing from the host that changes from step to step, so that a
CUDA graph can capture it (``train/multistep.py``): the step count lives on
the parameters' device, and the learning rate and both corrections come
from a device table indexed by it. Each row is computed on the host as the
eager step computed them: the schedule in float64 (``utils/schedule.py``)
times the group's base lr, as ``LambdaLR`` multiplies them, rounded to the
compute dtype as a Python scalar operand is, and ``1 - b^t`` by the same
torch expression in the compute dtype.
"""

from typing import Callable, Iterable, Optional, Tuple, Union

import torch
from torch.optim.lr_scheduler import LambdaLR

from tvqvae_tpu_torch.utils.device import capturing


class AdamWStorage(torch.optim.Optimizer):
    """optax's ``adamw`` with its moments stored in ``mu_dtype`` /
    ``nu_dtype`` (None: the parameter's dtype). The per-parameter state is
    torch AdamW's (``step``, ``exp_avg``, ``exp_avg_sq``), so ``state_dict``
    and ``load_state_dict`` save and restore it; a restored moment keeps its
    storage dtype.

    The update runs over flat chunks of up to ``CHUNK`` elements (a chunk is
    consecutive whole parameters of one dtype and device; its moments are one
    buffer each, the per-parameter states views into them): a fixed number of
    elementwise kernels per chunk, not per parameter, with the same
    arithmetic element by element. A parameter without a gradient counts as
    a zero gradient, as optax sees it; every parameter of a group steps
    together.

    The learning rate of step t (counted from 0) is ``schedule(t)`` times the
    group's ``initial_lr`` (``LambdaLR``'s), or the group's ``lr`` without a
    schedule. ``count`` is the number of steps taken, the host's copy of the
    count on the device; the table the step reads grows as ``count`` needs
    it, and ``reserve(steps)`` grows it before a CUDA graph captures a step
    (it cannot grow during a capture)."""

    CHUNK = 1 << 24  # elements a chunk's float32 temporaries span (64 MB each)
    TABLE = 1024  # the first table's rows; it doubles as the steps need

    def __init__(self, params, lr: float = 1.0, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.01, mu_dtype: Optional[torch.dtype] = None,
                 nu_dtype: Optional[torch.dtype] = None,
                 schedule: Optional[Callable[[int], float]] = None):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.mu_dtype = mu_dtype
        self.nu_dtype = nu_dtype
        self.schedule = schedule
        self.count = 0
        self._counts = {}  # device -> the step count there, (1,) int64
        self._tables = {}  # (group index, compute dtype, device) -> (rows, 3) table
        self._chunks = None  # [(group index, params, mu, nu)], built at the first step

    def state_dict(self):
        for st in self.state.values():
            if "step" in st:
                st["step"] = torch.tensor(float(self.count))
        return super().state_dict()

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)  # casts every moment to its parameter's dtype
        steps = [int(st["step"]) for st in self.state.values() if "step" in st]
        self.count = steps[0] if steps else 0
        self._chunks = None  # rebuilt from the restored moments, in their storage dtypes
        self._counts = {}

    def _build_chunks(self):
        """Group the parameters into chunks and move each chunk's moments
        (zeros, or the restored ones) into one flat buffer per moment."""
        self._chunks = []
        for gi, group in enumerate(self.param_groups):
            cur, n = [], 0
            for p in group["params"] + [None]:
                if p is None or (cur and (n + p.numel() > self.CHUNK or p.dtype != cur[0].dtype
                                          or p.device != cur[0].device)):
                    if cur:
                        self._chunks.append(self._flatten(gi, cur))
                    cur, n = [], 0
                if p is not None:
                    cur.append(p)
                    n += p.numel()
        for _, params, _, _ in self._chunks:
            dev = params[0].device
            if dev not in self._counts:
                self._counts[dev] = torch.full((1,), self.count, dtype=torch.int64, device=dev)

    def _flatten(self, gi, params):
        flats = []
        for key, dt in (("exp_avg", self.mu_dtype or params[0].dtype),
                        ("exp_avg_sq", self.nu_dtype or params[0].dtype)):
            parts = [self.state[p][key].reshape(-1) if key in self.state[p]
                     else torch.zeros(p.numel(), dtype=dt, device=p.device) for p in params]
            flat = torch.cat(parts).to(dt)
            for p, view in zip(params, flat.split([q.numel() for q in params])):
                self.state[p][key] = view.view_as(p)
            flats.append(flat)
        for p in params:
            self.state[p].setdefault("step", torch.tensor(float(self.count)))
        return gi, params, flats[0], flats[1]

    def _rows(self, group, cdt, n: int) -> torch.Tensor:
        """Rows t < n: (-lr of step t, 1 - b1^(t+1), 1 - b2^(t+1)) in ``cdt``
        on the CPU, each as the eager step computed it."""
        base = group.get("initial_lr", group["lr"])
        lrs = [-(base * self.schedule(t)) if self.schedule else -group["lr"] for t in range(n)]
        cols = [lrs]
        for b in group["betas"]:
            bt, col = torch.tensor(b, dtype=cdt), []
            for t in range(1, n + 1):
                col.append(float(1.0 - bt ** t))
                if col[-1] == 1.0:  # b^t below half an ulp of 1: so is every later power
                    col += [1.0] * (n - t)
                    break
            cols.append(col)
        return torch.tensor(list(zip(*cols)), dtype=torch.float64).to(cdt)

    def _table(self, gi: int, cdt, dev, need: int) -> torch.Tensor:
        key = (gi, cdt, dev)
        tab = self._tables.get(key)
        if tab is None or len(tab) < need:
            if capturing():
                raise RuntimeError(f"AdamWStorage: step {need} is past the table's "
                                   f"{0 if tab is None else len(tab)} rows inside a CUDA graph "
                                   f"capture; call reserve(steps) before capturing")
            rows = max(need, self.TABLE, 2 * len(tab) if tab is not None else 0)
            tab = self._tables[key] = self._rows(self.param_groups[gi], cdt, rows).to(dev)
        return tab

    def reserve(self, steps: int) -> None:
        """Grow the tables to cover ``steps`` steps in all."""
        if self._chunks is None:
            self._build_chunks()
        for gi, params, _, _ in self._chunks:
            self._table(gi, torch.promote_types(params[0].dtype, torch.float32),
                        params[0].device, steps)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamWStorage.step takes no closure")
        if self._chunks is None:
            self._build_chunks()
        for gi, params, mu_flat, nu_flat in self._chunks:
            group = self.param_groups[gi]
            (b1, b2), eps, wd = group["betas"], group["eps"], group["weight_decay"]
            # the decays as optax applies them: rounded to the moment's dtype (module doc)
            d1 = float(torch.tensor(b1, dtype=mu_flat.dtype))
            d2 = float(torch.tensor(b2, dtype=nu_flat.dtype))
            cdt = torch.promote_types(params[0].dtype, torch.float32)
            dev = params[0].device
            row = self._table(gi, cdt, dev, self.count + 1).index_select(0, self._counts[dev])
            neg_lr, c1, c2 = row.unbind(1)  # (1,) each: this step's -lr and corrections
            g = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                           for p in params]).to(cdt)
            mu = g * (1.0 - b1)
            mu += mu_flat.to(cdt) * d1
            nu = g * g
            nu *= 1.0 - b2
            nu += nu_flat.to(cdt) * d2
            del g
            u = mu / c1
            u /= (nu / c2).sqrt_() + eps
            u += torch.cat([p.reshape(-1) for p in params]).to(cdt) * wd
            u *= neg_lr
            u = u.to(params[0].dtype)
            torch._foreach_add_(params, [v.view_as(p) for p, v in
                                         zip(params, u.split([p.numel() for p in params]))])
            mu_flat.copy_(mu)  # rounded to nearest even into the stored dtype
            nu_flat.copy_(nu)
        for c in self._counts.values():
            c += 1
        self.count += 1


def adamw(
    params: Iterable[torch.nn.Parameter],
    learning_rate: Union[float, Callable[[int], float]],
    weight_decay: float = 0.01,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    mu_dtype: Optional[torch.dtype] = None,
    nu_dtype: Optional[torch.dtype] = None,
) -> Tuple[AdamWStorage, LambdaLR]:
    """-> (``AdamWStorage``, scheduler). Call ``optimizer.step()`` then
    ``scheduler.step()`` once per training step."""
    schedule = learning_rate if callable(learning_rate) else (lambda _: learning_rate)
    # base lr 1: the scheduler's factor is then the learning rate itself
    opt = AdamWStorage(params, lr=1.0, betas=(b1, b2), eps=eps, weight_decay=weight_decay,
                       mu_dtype=mu_dtype, nu_dtype=nu_dtype, schedule=schedule)
    return opt, LambdaLR(opt, schedule)
