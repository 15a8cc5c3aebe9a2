"""The port's fused IEKD stem (glfusion_tpu_torch/experiments/stem_fused.py
and stem_module.py) against the JAX package on the CPU.

On the CPU the port's stem takes its plain versions (the CUDA kernels run
only on the card, where chip_smoke.py holds them against the same plain
versions). The JAX side is the package's IEKDStem and the Pallas kernels'
plain reference ``experiments/stem_pallas.reference_stem``, differentiated
by JAX through the batch statistics; the Pallas kernels themselves run only
in interpret mode on the CPU, which the tier-1 suite does not pay for.

Tolerances (float32): values and statistics atol = rtol = 1e-4 (the
experiments' own), gradients atol 2e-4 × max|grad| (+ rtol 2e-4); the
conv-bias gradient, which train-mode BN cancels to reassociation noise,
atol 5e-3 as in experiments/test_stem_pallas.py:167-171.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (TINY_MODEL, one_torch_thread,  # noqa: F401
                                tiny_flagship)
from experiments.stem_pallas import reference_stem
from glfusion_tpu.models.resnet import IEKDStem
from glfusion_tpu_torch.config import ModelConfig
from glfusion_tpu_torch.experiments import stem_fused
from glfusion_tpu_torch.experiments.stem_fused import (batch_moments,
                                                       fused_stem_eval,
                                                       fused_stem_train,
                                                       geometry)
from glfusion_tpu_torch.experiments.stem_module import (FusedIEKDStem,
                                                        swap_in_fused_stems)
from glfusion_tpu_torch.models import GlobalAndLocal
from glfusion_tpu_torch.utils.convert import state_dict_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)


def _params(rs, c):
    """JAX layouts: kernel (7, 7, 1, C), bias, gamma, beta (C,)."""
    return (rs.randn(7, 7, 1, c).astype(np.float32) * 0.2,
            rs.randn(c).astype(np.float32) * 0.1,
            (rs.rand(c) + 0.5).astype(np.float32),
            rs.randn(c).astype(np.float32) * 0.1)


def _torch_args(x, kernel, bias, gamma, beta):
    """NHWC x and HWIO kernel → the port's NCHW x and (C, 1, 7, 7)."""
    return [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)
            for a in (np.transpose(x, (0, 3, 1, 2)),
                      np.transpose(kernel, (3, 2, 0, 1)), bias, gamma, beta)]


def _jax_loss(x, kernel, bias, gamma, beta, dy):
    """Σ out·dy through the JAX reference (conv → batch statistics →
    reference_stem), with the output and the batch moments."""
    z = jax.lax.conv_general_dilated(
        x, kernel, (1, 1), ((2, 2), (2, 2)),
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + bias
    mu, var = jnp.mean(z, axis=(0, 1, 2)), jnp.var(z, axis=(0, 1, 2))
    out = reference_stem(x, kernel, bias, gamma, beta, mu, var)
    return jnp.sum(out * dy), (out, mu, var)


_JAX_GRAD = jax.jit(jax.value_and_grad(_jax_loss, argnums=(0, 1, 2, 3, 4),
                                       has_aux=True))


def _jax_train(x, kernel, bias, gamma, beta, dy):
    """Value, batch moments and the five gradients (one compile a shape)."""
    (_, (out, mu, var)), grads = _JAX_GRAD(x, kernel, bias, gamma, beta, dy)
    return out, mu, var, grads


# (B, H, W, C): the per-view frame size of the tiny flagship, and ragged
# sizes of experiments/test_stem_banded.py (odd conv maps, H != W)
SHAPES = [(2, 32, 32, 8), (2, 21, 19, 16), (1, 16, 30, 8)]


@pytest.mark.parametrize("shape", SHAPES)
def test_stem_train_matches_jax(shape):
    """Pooled output, batch mean and variance, and the gradients of x,
    kernel, bias, gamma and beta."""
    b, h, w, c = shape
    rs = np.random.RandomState(0)
    x = rs.randn(b, h, w, 1).astype(np.float32)
    params = _params(rs, c)
    _, _, hp, wp, _ = geometry(h, w)
    dy = rs.randn(b, hp, wp, c).astype(np.float32)
    out_j, mu_j, var_j, grads_j = _jax_train(x, *params, dy)

    args = _torch_args(x, *params)
    out, mu, var = fused_stem_train(*args)
    (out * torch.from_numpy(dy).permute(0, 3, 1, 2)).sum().backward()

    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(out_j), **TOL)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), **TOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_j), **TOL)
    layouts = (lambda g: g.permute(0, 2, 3, 1), lambda g: g.permute(2, 3, 1, 0),
               lambda g: g, lambda g: g, lambda g: g)
    for name, a, to_jax, want in zip(("x", "kernel", "bias", "gamma", "beta"),
                                     args, layouts, grads_j):
        want = np.asarray(want)
        atol = 5e-3 if name == "bias" else 2e-4 * np.abs(want).max()
        np.testing.assert_allclose(to_jax(a.grad).numpy(), want, atol=atol,
                                   rtol=2e-4, err_msg=name)


def test_stem_values_match_jax_iekd_stem():
    """The port's train and eval stem give the JAX IEKDStem's outputs and
    its updated running mean (the variance follows torch's unbiased update,
    the factor n/(n−1), ROADMAP Queue 3)."""
    rs = np.random.RandomState(1)
    x = rs.rand(2, 20, 20, 1).astype(np.float32)
    kernel, bias, gamma, beta = _params(rs, 8)
    mean, var = (rs.randn(8) * 0.1).astype(np.float32), \
        (rs.rand(8) + 0.5).astype(np.float32)
    jm = IEKDStem(stem_width=8)
    v = {"params": {"stem_conv": {"kernel": kernel, "bias": bias},
                    "stem_bn": {"scale": gamma, "bias": beta}},
         "batch_stats": {"stem_bn": {"mean": mean, "var": var}}}
    m = FusedIEKDStem(8)
    m.load_state_dict({
        "0.weight": torch.from_numpy(np.transpose(kernel, (3, 2, 0, 1)).copy()),
        "0.bias": torch.from_numpy(bias), "1.weight": torch.from_numpy(gamma),
        "1.bias": torch.from_numpy(beta),
        "1.running_mean": torch.from_numpy(mean),
        "1.running_var": torch.from_numpy(var),
        "1.num_batches_tracked": torch.tensor(0)})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        got_eval = m.eval()(xt)
        got_train = m.train()(xt)
    want_eval = jm.apply(v, jnp.asarray(x), False)
    want_train, upd = jm.apply(v, jnp.asarray(x), True,
                               mutable=["batch_stats"])
    for got, want in ((got_eval, want_eval), (got_train, want_train)):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), **TOL)
    np.testing.assert_allclose(m[1].running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["stem_bn"]
                                          ["mean"]), **TOL)
    # flax: var ← 0.9·var + 0.1·σ²_b; torch: the same with σ²_b·n/(n−1)
    n = 2 * 18 * 18
    sb = (np.asarray(upd["batch_stats"]["stem_bn"]["var"]) - 0.9 * var) / 0.1
    np.testing.assert_allclose(m[1].running_var.numpy(),
                               0.9 * var + 0.1 * sb * n / (n - 1), **TOL)
    assert int(m[1].num_batches_tracked) == 1


@pytest.mark.parametrize("train", [True, False])
def test_fused_module_swaps_into_flagship(train):
    """``swap_in_fused_stems`` replaces every view's init_block by state
    dict: the flagship's outputs and its running statistics are unchanged
    (both run the plain versions on the CPU; rtol 1e-6 covers the
    unbiased-variance factor applied in another order)."""
    _, v = tiny_flagship()
    cfg = ModelConfig(**TINY_MODEL)
    ref, fused = GlobalAndLocal(cfg), GlobalAndLocal(cfg)
    sd = state_dict_from_jax(v, cfg)
    ref.load_state_dict(sd)
    fused.load_state_dict(sd)
    swap_in_fused_stems(fused)
    assert all(isinstance(m, FusedIEKDStem)
               for m in fused.init_block.values())
    ref.train(train)
    fused.train(train)
    x = torch.from_numpy(np.random.RandomState(2).rand(3, 2, 16, 16, 1)
                         .astype(np.float32))
    with torch.no_grad():
        want, got = ref(x), fused(x)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
    sd_ref, sd_fused = ref.state_dict(), fused.state_dict()
    assert list(sd_ref) == list(sd_fused)
    for k in sd_ref:
        np.testing.assert_allclose(sd_fused[k].numpy(), sd_ref[k].numpy(),
                                   atol=1e-7, rtol=1e-6, err_msg=k)


def test_per_view_weights_match_a_per_view_loop():
    """The contract of experiments/test_stem_banded.py:86-101: three views,
    each with its own weights, give what each view's call gives alone —
    here as three FusedIEKDStem modules in a flagship's ModuleDict."""
    cfg = dataclasses.replace(ModelConfig(**TINY_MODEL), stem_width=8)
    model = GlobalAndLocal(cfg)
    rs = np.random.RandomState(3)
    with torch.no_grad():
        for stem in model.init_block.values():
            stem[0].weight.copy_(torch.from_numpy(
                rs.randn(8, 1, 7, 7).astype(np.float32) * 0.2))
    swap_in_fused_stems(model)
    x = torch.from_numpy(rs.randn(3, 2, 1, 32, 32).astype(np.float32))
    for i, (vname, stem) in enumerate(model.init_block.items()):
        conv, bn = stem[0], stem[1]
        out, mu, var = fused_stem_train(x[i], conv.weight, conv.bias,
                                        bn.weight, bn.bias)
        k = conv.weight.detach().permute(2, 3, 1, 0).numpy()
        x_j = x[i].permute(0, 2, 3, 1).numpy()
        _, mu_j, var_j, _ = _jax_train(
            x_j, k, conv.bias.detach().numpy(), bn.weight.detach().numpy(),
            bn.bias.detach().numpy(), np.zeros((2, 15, 15, 8), np.float32))
        np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), **TOL,
                                   err_msg=vname)
        np.testing.assert_allclose(var.numpy(), np.asarray(var_j), **TOL,
                                   err_msg=vname)


def test_batch_moments_merge_blocks():
    """The merge of per-block (count, mean, M2) — the reduction the stats
    kernel's partials go through — gives torch's batch mean and biased
    variance, also for values far from zero where E[z²] − E[z]² cancels."""
    rs = np.random.RandomState(4)
    z = torch.from_numpy(rs.randn(6, 37, 8).astype(np.float32) * 0.1 + 50.0)
    counts = torch.tensor([37.0, 30.0, 20.0, 37.0, 5.0, 1.0])
    blocks = [z[i, :int(n)] for i, n in enumerate(counts)]
    part = torch.stack([
        torch.stack([torch.full((8,), float(len(bk))) for bk in blocks]),
        torch.stack([bk.mean(0) for bk in blocks]),
        torch.stack([((bk - bk.mean(0)) ** 2).sum(0) for bk in blocks]),
    ])[:, :, None, :]  # (3, B, slabs, C)
    mean, var = batch_moments(part)
    allz = torch.cat(blocks).double()
    np.testing.assert_allclose(mean.numpy(), allz.mean(0).numpy(), rtol=1e-6)
    np.testing.assert_allclose(var.numpy(), allz.var(0, unbiased=False)
                               .numpy(), rtol=1e-4)


def test_geometry_and_launchers():
    """Pooled sizes follow MaxPool2d(3, 2, 1) on the 7×7 p2 conv map; the
    kernels' four launchers start with a zero count; a tensor that is not
    on the CPU never takes the plain version."""
    assert geometry(112, 112) == (110, 110, 55, 55, 14)
    assert geometry(21, 19)[:4] == (19, 17, 10, 9)
    assert [f.launches for f in stem_fused.KERNELS] == [0, 0, 0, 0]
    x = torch.zeros(2, 1, 16, 16, device="meta")
    w = torch.zeros(8, 1, 7, 7, device="meta")
    c = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_stem_train(x, w, c, c, c)
    with pytest.raises(ValueError, match="CUDA"):
        fused_stem_eval(x, w, c, c, c, c, c)
