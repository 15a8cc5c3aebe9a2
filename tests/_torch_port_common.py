"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_port_*.py).

Inputs and weights are made with numpy from a seed and handed to both the
JAX package and the port, so the two see the same arrays.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glfusion_tpu.config import ModelConfig as JModelConfig
from glfusion_tpu.models import GlobalAndLocal as JGlobalAndLocal

# Tiny widths, full topology (tests/test_full_model_torch_parity.py).
TINY_MODEL = dict(
    views=("1", "3", "4"),
    stem_width=8,
    block_sizes=(1, 1, 1, 1),
    widths=(4, 8, 12, 16),
    expansion=4,
    aspp_rates=(2, 4, 6),
    aspp_channels=8,
    aspp_dropout=0.0,
    tpavi_inter_channels=8,
)

# float32 parity tolerance (tests/test_full_model_torch_parity.py:67-72)
TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six test workers share the machine's cores: one torch thread each."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _fill(path, shape, rs: np.random.RandomState) -> np.ndarray:
    name = path[-1]
    if name == "kernel":
        fan_in = int(np.prod(shape[-4:-1])) if len(shape) >= 4 else shape[0]
        return rs.standard_normal(shape) * np.sqrt(2.0 / fan_in)
    if name == "bias":
        return rs.uniform(-0.1, 0.1, shape)
    if name == "scale":  # BN and LayerNorm scales, TPAVI's W_z BN included
        return rs.uniform(0.5, 1.5, shape)
    if name == "mean":
        return rs.uniform(-0.2, 0.2, shape)
    if name == "var":
        return rs.uniform(0.5, 1.5, shape)
    raise KeyError(f"no filler for {path}")


def random_variables(init_fn, seed: int = 0):
    """Random ``{'params', 'batch_stats'}`` in the shapes ``init_fn`` would
    make, traced with ``jax.eval_shape`` (no compile). Every BN gets random
    running stats and a nonzero scale, TPAVI's zero-initialized W_z BN too.
    """
    shapes = jax.eval_shape(init_fn)
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: _fill(tuple(k.key for k in p), s.shape, rs).astype(
            np.float32),
        {k: v for k, v in shapes.items() if k in ("params", "batch_stats")})


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def tiny_flagship(seed: int = 7):
    """The JAX GlobalAndLocal at TINY_MODEL widths and random variables,
    shared by the test files that run in one worker."""
    jm = JGlobalAndLocal(JModelConfig(**TINY_MODEL))
    x = jnp.zeros((len(TINY_MODEL["views"]), 2, 32, 32, 1), jnp.float32)
    return jm, random_variables(lambda: jm.init(jax.random.PRNGKey(0), x,
                                                False), seed)
