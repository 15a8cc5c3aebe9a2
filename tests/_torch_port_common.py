"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_port_*.py).

Inputs and weights are made with numpy from a seed and handed to both the
JAX package and the port, so the two see the same arrays.
"""

from __future__ import annotations

import concurrent.futures
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

# XLA:CPU options for the JAX side's jitted references: no LLVM
# optimization, which halves their compile time (the tests' own cost with a
# cold compilation cache); the arithmetic is the same operations.
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


# one thread that compiles and runs the JAX references a test file asks
# for ahead of use (``compile_and_run``); started at the first submit
_COMPILER = concurrent.futures.ThreadPoolExecutor(
    max_workers=1, thread_name_prefix="jax-reference")


def compile_and_run(lowered, *args, x64: bool = False, then=lambda r: r):
    """A future of ``then(jax.device_get(lowered.compile()(*args)))``,
    computed on one background thread. XLA:CPU compiles in C++ without the
    interpreter's lock, so one reference's compile overlaps the tracing of
    the next on the caller's thread (a third less time for a file of float64
    zoo references); the arithmetic is the same program's."""
    def run():
        with jax.enable_x64(x64):
            return then(jax.device_get(lowered.compile()(*args)))
    return _COMPILER.submit(run)


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


def _zeros_like_draw(real, shape_at: int):
    """A ``jax.random`` draw that gives zeros of the draw's shape and type:
    what ``init_shapes`` traces in place of the initializers' arithmetic."""
    def draw(key, *args, **kw):
        names = ("lower", "upper", "shape", "dtype")[4 - shape_at - 2:]
        bound = dict(zip(names, args), **kw)
        shape = bound.get("shape", () if shape_at == 0 else None)
        if shape is None:
            return real(key, *args, **kw)
        return jnp.zeros(shape, bound.get("dtype"))
    return draw


def init_shapes(init_fn):
    """``jax.eval_shape(init_fn)`` (a trace, no compile) with the random
    initializers drawing zeros: the variables' shapes and types are the
    same, and the trace skips each initializer's arithmetic (a third of an
    init's trace; the tests fill every leaf from numpy anyway)."""
    from unittest import mock

    from jax._src import random as jrandom

    with mock.patch.object(jrandom, "truncated_normal", _zeros_like_draw(
            jrandom.truncated_normal, 2)), \
            mock.patch.object(jrandom, "normal", _zeros_like_draw(
                jrandom.normal, 0)), \
            mock.patch.object(jrandom, "uniform", _zeros_like_draw(
                jrandom.uniform, 0)):
        return jax.eval_shape(init_fn)


def random_variables(init_fn, seed: int = 0):
    """Random ``{'params', 'batch_stats'}`` in the shapes ``init_fn`` would
    make, traced with ``init_shapes`` (no compile). Every BN gets random
    running stats and a nonzero scale, TPAVI's zero-initialized W_z BN too.
    """
    shapes = init_shapes(init_fn)
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
