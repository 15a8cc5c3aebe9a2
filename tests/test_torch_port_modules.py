"""Port modules (TPAVI, ResNetIEKD, DeepLabHead) against the JAX modules on
the CPU, on random JAX weights carried over by the port's converter.

float32, atol = rtol = 2e-4 (tests/test_full_model_torch_parity.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (FAST_COMPILE, TOL,  # noqa: F401
                                one_torch_thread, random_variables,
                                to_numpy)
from glfusion_tpu.models.aspp import DeepLabHead as JDeepLabHead
from glfusion_tpu.models.resnet import ResNetIEKD as JResNetIEKD
from glfusion_tpu.models.tpavi import TPAVI as JTPAVI
from glfusion_tpu_torch.models.aspp import DeepLabHead
from glfusion_tpu_torch.models.resnet import ResNetIEKD
from glfusion_tpu_torch.models.tpavi import TPAVI
from glfusion_tpu_torch.utils.convert import (backbone_state_dict,
                                              head_state_dict,
                                              tpavi_state_dict)

KEY = jax.random.PRNGKey(0)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> np.ndarray:
    return y.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def tpavi_case():
    x = np.random.RandomState(0).standard_normal((2, 3, 4, 4, 16)).astype(
        np.float32)
    jm = JTPAVI()
    v = random_variables(lambda: jm.init(KEY, jnp.asarray(x), False), seed=1)
    return jm, v, x


@pytest.mark.parametrize("impl", ["auto", "naive", "pallas"])
def test_tpavi_eval_matches_jax(tpavi_case, impl):
    """Eval (fused θ/φ/g projection), W_z BN scale ≠ 0; 'pallas' runs the
    kernel's plain version on the CPU against JAX's default order."""
    jm, v, x = tpavi_case
    ref = jax.jit(lambda v, x: jm.apply(v, x, False),
                  compiler_options=FAST_COMPILE)(v, jnp.asarray(x))
    m = TPAVI(16, attn_impl=impl)
    m.load_state_dict(tpavi_state_dict(v["params"], v["batch_stats"]))
    assert (m.W_z[1].weight != 0).all()
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_tpavi_train_matches_jax(tpavi_case):
    """Train form (three projections, batch-statistics BN): the output and
    the updated W_z BN running stats. The running variance differs by
    design: torch (the reference) updates it with the unbiased batch
    variance, flax with the biased one, a factor n/(n−1) over n rows."""
    jm, v, x = tpavi_case
    ref, upd = jax.jit(lambda v, x: jm.apply(v, x, True,
                                             mutable=["batch_stats"]),
                       compiler_options=FAST_COMPILE)(v, jnp.asarray(x))
    m = TPAVI(16).train()
    m.load_state_dict(tpavi_state_dict(v["params"], v["batch_stats"]))
    got = m(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)

    bn = m.W_z[1]
    old, new = v["batch_stats"]["w_z_bn"], to_numpy(upd["batch_stats"])
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               new["w_z_bn"]["mean"], **TOL)
    n = x.size // x.shape[-1]
    batch_var = (new["w_z_bn"]["var"] - 0.9 * old["var"]) / 0.1
    np.testing.assert_allclose(
        bn.running_var.numpy(),
        0.9 * old["var"] + 0.1 * batch_var * n / (n - 1), **TOL)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("mode", ["gaussian", "embedded", "concatenate"])
def test_tpavi_modes_match_jax(mode, train):
    """The reference module's other modes (JAX ``TPAVI(mode=...)``, which no
    JAX model builds): the parameter tree (gaussian has no θ, φ;
    concatenate adds ``w_f``), the output in eval and in train, and in
    train the W_z BN's running mean; W_z BN scale ≠ 0. 48 tokens, so
    concatenate's pairwise (B, N, N) map is small. float32, TOL."""
    x = np.random.RandomState(4).standard_normal((2, 3, 4, 4, 16)).astype(
        np.float32)
    jm = JTPAVI(inter_channels=8, mode=mode)
    v = random_variables(lambda: jm.init(KEY, jnp.asarray(x), False), seed=5)
    assert ("theta" in v["params"]) == (mode != "gaussian")
    assert ("w_f" in v["params"]) == (mode == "concatenate")
    ref, upd = jax.jit(lambda v, x: jm.apply(v, x, train,
                                             mutable=["batch_stats"]),
                       compiler_options=FAST_COMPILE)(v, jnp.asarray(x))
    m = TPAVI(16, 8, mode=mode).train(train)
    m.load_state_dict(tpavi_state_dict(v["params"], v["batch_stats"]))
    assert (m.W_z[1].weight != 0).all()
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(m.W_z[1].running_mean.numpy(), np.asarray(
        upd["batch_stats"]["w_z_bn"]["mean"]), **TOL)


def test_resnet_iekd_matches_jax():
    arch = dict(stem_width=8, block_sizes=(2, 1, 1, 1), widths=(4, 8, 12, 16))
    x = np.random.RandomState(2).rand(2, 32, 32, 1).astype(np.float32)
    jm = JResNetIEKD(**arch)
    v = random_variables(lambda: jm.init(KEY, jnp.asarray(x), False), seed=3)
    ref = jax.jit(lambda v, x: jm.apply(v, x, False),
                  compiler_options=FAST_COMPILE)(v, jnp.asarray(x))
    m = ResNetIEKD(**arch)
    m.load_state_dict(backbone_state_dict(v["params"], v["batch_stats"],
                                          arch["block_sizes"]))
    with torch.no_grad():
        got = m.eval()(_nchw(x))
    assert got.shape == (2, 64, 8, 8)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("rates", [(2, 4, 6), (12, 24, 36)])
def test_deeplab_head_matches_jax(rates):
    """(12, 24, 36) on an 8² map takes JAX's clipped-tap path; the port's
    plain dilated convolutions must give the same logits."""
    x = np.random.RandomState(4).standard_normal((2, 8, 8, 16)).astype(
        np.float32)
    jm = JDeepLabHead(num_outputs=5, channels=8, rates=rates, dropout=0.0)
    v = random_variables(lambda: jm.init(KEY, jnp.asarray(x), False), seed=5)
    ref = jax.jit(lambda v, x: jm.apply(v, x, False),
                  compiler_options=FAST_COMPILE)(v, jnp.asarray(x))
    m = DeepLabHead(16, 5, channels=8, rates=rates, dropout=0.0)
    m.load_state_dict(head_state_dict(v["params"], v["batch_stats"],
                                      len(rates)))
    with torch.no_grad():
        got = m.eval()(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)
