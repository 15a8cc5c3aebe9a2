"""The zoo's multi-view U-Net, UTNet, CEN and 3-D ResUNet against the JAX
package's on the CPU: eval and train parity (``_torch_port_zoo_common``)
and the pins of what they alone use: flax ``ConvTranspose`` → torch
``ConvTranspose3d`` (taps flipped), ``resize_bilinear_ac`` and the device
``resize_nearest`` (size-1 axes too), CEN's channel exchange at S = 3 (the
ring). The U-Net family and the wiring are in test_torch_port_zoo.py."""

from __future__ import annotations

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import one_torch_thread  # noqa: F401
from _torch_port_zoo_common import check_eval, check_train
from glfusion_tpu.models import cen as jcen
from glfusion_tpu.ops import resize as jresize
from glfusion_tpu_torch.models import cen as pcen
from glfusion_tpu_torch.ops import resize as presize
from glfusion_tpu_torch.utils.convert import _zoo_kernel

ARCHS = ("multiview_unet", "utnet", "cen", "res3dunet")


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_eval_matches_jax(arch):
    check_eval(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_train_grads_match_jax(arch):
    check_train(arch)


def test_conv_transpose_flips_taps():
    """flax ConvTranspose (transpose_kernel=False) does not flip its
    kernel; torch's ConvTranspose3d does. The converter flips the taps and
    swaps in/out; a kernel whose taps all differ pins it."""
    cin, cout = 2, 3
    k = np.arange(8 * cin * cout, dtype=np.float32).reshape(
        2, 2, 2, cin, cout) / 10
    x = np.random.RandomState(0).rand(1, 3, 2, 4, cin).astype(np.float32)
    layer = fnn.ConvTranspose(cout, (2, 2, 2), strides=(2, 2, 2),
                              padding="VALID", use_bias=False)
    ref = np.asarray(layer.apply({"params": {"kernel": k}}, x))
    conv = torch.nn.ConvTranspose3d(cin, cout, 2, stride=2, bias=False)
    xt = torch.from_numpy(x).movedim(-1, 1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            _zoo_kernel(k, transposed=True))))
        got = conv(xt).movedim(1, -1).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        # the same weights unflipped are wrong
        conv.weight.copy_(torch.from_numpy(np.transpose(k, (3, 4, 0, 1, 2))
                                           .copy()))
        assert np.abs(conv(xt).movedim(1, -1).numpy() - ref).max() > 0.1


@pytest.mark.parametrize("in_hw,out_hw", [((5, 7), (3, 9)), ((1, 4), (6, 1)),
                                          ((4, 4), (1, 1)), ((8, 8), (2, 2)),
                                          ((2, 3), (7, 7))])
def test_resizes_match_jax(in_hw, out_hw):
    x = np.random.RandomState(0).rand(2, *in_hw, 3).astype(np.float32)
    ref = np.asarray(jresize.resize_bilinear_ac(jnp.asarray(x), out_hw))
    got = presize.resize_bilinear_ac(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    # NCHW axes give the same values
    nchw = presize.resize_bilinear_ac(torch.from_numpy(x).movedim(-1, 1),
                                      out_hw, h_axis=-2, w_axis=-1)
    np.testing.assert_allclose(nchw.movedim(1, -1).numpy(), ref,
                               rtol=1e-6, atol=1e-6)
    ref = np.asarray(jresize.resize_nearest(jnp.asarray(x), out_hw))
    got = presize.resize_nearest(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="ndim >= 3"):
        presize.resize_nearest(torch.zeros(4, 4), (2, 2))


def test_cen_exchange_ring_matches_jax():
    """At S = 3 stream i takes channel c from stream (i + 1) mod 3 where
    its own |γ| is under the threshold."""
    rs = np.random.RandomState(0)
    s, b, h, w, c = 3, 2, 3, 3, 8
    x = rs.rand(s, b, h, w, c).astype(np.float32)
    scales = np.where(rs.rand(s, c) < 0.5, 0.01, 1.0).astype(np.float32)
    ref = np.asarray(jcen._exchange(jnp.asarray(x), jnp.asarray(scales),
                                    2e-2))
    xt = torch.from_numpy(x).movedim(-1, 2).reshape(s * b, c, h, w)
    got = pcen._exchange(xt, torch.from_numpy(scales), 2e-2)
    got = got.view(s, b, c, h, w).movedim(2, -1).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got != x).any() and (got == x).any()
