"""The port's bfloat16 ``TimeHead`` against the JAX package's as the JAX runner
compiles it.

The JAX runner and its quality tool jit with XLA's default flags. Under
them the ``TimeHead``'s ``nn.Dense(dtype=bfloat16)`` rounds its product to
bfloat16 and then adds the bias and the float32 residual without rounding
the sum: XLA's excess-precision licence keeps the fused add in float32.
Compiled as written (``jit_as_written``, the licence off) the sum is
rounded to bfloat16 too, and a cuBLAS call given the bias rounds product
and bias once. The port computes the default compile's rounding: its gap to
the default jit is held below the as-written compile's, and for a float32
input (the default ``bf16_istft=False``) within float32 rounding of it on
most outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_precision_paths import jit_as_written
from tvqvae_tpu.models import vqvae as jv
from tvqvae_tpu_torch.models import vqvae as tv
from tvqvae_tpu_torch.utils import convert


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _heads(L, seed):
    head = tv.TimeHead(L, torch.bfloat16)
    with torch.no_grad():
        head.Dense_0.weight.normal_(0.0, L ** -0.5, generator=torch.Generator().manual_seed(seed))
        head.Dense_0.bias.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(seed + 1))
    params, _ = convert.module_to_jax(head)
    return head, jv.TimeHead(L, dtype=jnp.bfloat16), {"params": params}


@pytest.mark.parametrize("shape,L,in_dtype", [((2, 4, 37), 40, "float32"),
                                              ((2, 4, 37), 40, "bfloat16"),
                                              ((8, 4, 515), 512, "float32")])
def test_time_head_follows_the_default_jit(shape, L, in_dtype):
    head, jhead, params = _heads(L, 3)
    x = np.random.default_rng(L).normal(size=shape).astype(np.float32)
    with torch.no_grad():
        ours = head(torch.from_numpy(x).to(getattr(torch, in_dtype))).numpy()
    xj = jnp.asarray(x, getattr(jnp, in_dtype))
    default = np.asarray(jax.jit(jhead.apply)(params, xj))
    written = np.asarray(jit_as_written(jhead.apply)(params, xj))
    ours_gap, written_gap = np.abs(ours - default), np.abs(written - default)
    assert ours.dtype == np.float32 and ours.shape == default.shape
    assert written_gap.mean() > 0
    assert ours_gap.mean() <= written_gap.mean() and ours_gap.max() <= written_gap.max()
    if in_dtype == "float32":
        # the default compile's rounding itself: most outputs bit-equal, the
        # rest an order of float32 additions (or a bfloat16 product rounded
        # after another order of its sums) away
        assert (ours_gap == 0).mean() >= 0.8
        assert ours_gap.mean() <= 1e-2 * written_gap.mean()
