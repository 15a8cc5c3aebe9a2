"""Port ops (glfusion_tpu_torch/ops) against the JAX package on the CPU.

Same numpy inputs through both; float32 tolerances as stated per test.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import TOL, one_torch_thread  # noqa: F401
from glfusion_tpu.ops import pooling as j_pool
from glfusion_tpu.ops import resize as j_resize
from glfusion_tpu.ops.nonlocal_attn import dot_nonlocal_attention as j_attn
from glfusion_tpu.ops.tpavi_pallas import fused_dot_nonlocal as j_fused
from glfusion_tpu_torch.ops import pooling, resize
from glfusion_tpu_torch.ops.nonlocal_attn import dot_nonlocal_attention
from glfusion_tpu_torch.ops.tpavi_fused import (fused_dot_nonlocal,
                                                fused_dot_nonlocal_plain)


def _rand(rs, *shape):
    return rs.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("out_hw", [(16, 20), (5, 4)])
def test_resize_bilinear_matches_jax(out_hw):
    x = _rand(np.random.RandomState(0), 2, 7, 9, 3)
    ref = np.asarray(j_resize.resize_bilinear(jnp.asarray(x), out_hw))
    got = resize.resize_bilinear(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("out_size,in_size",
                         [(144, 200), (112, 144), (40, 48), (7, 3)])
def test_nearest_indices_match_jax(out_size, in_size):
    np.testing.assert_array_equal(
        resize._nearest_indices_np(out_size, in_size),
        j_resize._nearest_indices_np(out_size, in_size))


def test_max_pool_matches_jax():
    x = _rand(np.random.RandomState(1), 2, 9, 8, 3)
    ref = np.asarray(j_pool.max_pool_3x3_s2(jnp.asarray(x)))
    got = pooling.max_pool_3x3_s2(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("impl", ["naive", "reassoc", "auto"])
@pytest.mark.parametrize("n,c", [(40, 8), (6, 16)])
def test_dot_nonlocal_attention_matches_jax(impl, n, c):
    rs = np.random.RandomState(2)
    t, p, g = (_rand(rs, 2, n, c) for _ in range(3))
    ref = np.asarray(j_attn(*map(jnp.asarray, (t, p, g)), impl=impl))
    got = dot_nonlocal_attention(*map(torch.from_numpy, (t, p, g)), impl=impl)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("n", [75, 256])
def test_fused_plain_matches_pallas_interpret(n):
    """The kernel's plain version against the Pallas kernel in interpret
    mode, including a token count that is not a multiple of any tile."""
    rs = np.random.RandomState(3)
    t, p, g = (_rand(rs, 2, n, 32) for _ in range(3))
    ref = np.asarray(j_fused(*map(jnp.asarray, (t, p, g)), interpret=True))
    args = tuple(map(torch.from_numpy, (t, p, g)))
    np.testing.assert_allclose(fused_dot_nonlocal_plain(*args).numpy(), ref,
                               **TOL)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_allclose(fused_dot_nonlocal(*args).numpy(), ref, **TOL)


def test_fused_gradient_matches_jax():
    """The autograd backward (three reassociated products) against
    jax.grad through the Pallas custom VJP."""
    rs = np.random.RandomState(4)
    t, p, g = (_rand(rs, 2, 48, 16) for _ in range(3))

    def loss(a, b, c):
        return jnp.sum(jnp.sin(j_fused(a, b, c, True)))

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (t, p, g)))
    args = [torch.from_numpy(a).requires_grad_() for a in (t, p, g)]
    torch.sin(fused_dot_nonlocal(*args)).sum().backward()
    for a, r in zip(args, ref):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r),
                                   rtol=2e-4, atol=2e-5)


def test_fused_wrapper_refuses_other_devices():
    """Only CPU tensors take the plain version; anything else must be a
    CUDA tensor the kernel launches on."""
    x = torch.empty(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_dot_nonlocal(x, x, x)
