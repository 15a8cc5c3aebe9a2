"""The port's ASPP (clipped taps and fused centres, ``models/aspp.py``)
against the JAX package on the CPU: in float32, forward and gradients,
train and eval; and the rounding point of the tap partials in bfloat16.

Same numpy inputs through both packages; each test states its tolerance.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (FAST_COMPILE, one_torch_thread,  # noqa: F401
                                random_variables)
from glfusion_tpu.models.aspp import ASPP as JASPP
from glfusion_tpu.models.aspp import DilatedConv3x3 as JDilatedConv3x3
from glfusion_tpu_torch.models.aspp import ASPP, add_taps, decomposes
from glfusion_tpu_torch.utils.convert import aspp_state_dict

KEY = jax.random.PRNGKey(0)
CIN, CH = 16, 8

# (rates, h = w, JAX's form per rate, fused centres): the tiny model's rates
# at 4², where every rate clips and the centres fuse; and (1, 4, 6) at 6²,
# the flagship's (12, 24, 36) at 28² in miniature: a plain conv, border
# taps 2 wide, the centre tap alone
CASES = [((2, 4, 6), 4, (True, True, True)),
         ((1, 4, 6), 6, (False, True, True))]


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _nhwc(y: torch.Tensor) -> np.ndarray:
    return y.detach().permute(0, 2, 3, 1).numpy()


def _close(got, want, rel: float, what: str) -> None:
    """|got − want| ≤ rel · max|want|, elementwise."""
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max() / np.abs(want).max()
    assert err <= rel, f"{what}: {err} > {rel}"


def _plain(m: ASPP) -> ASPP:
    """The same module computing its branches as plain convolutions."""
    m.branch_convs = m.dilated_convs
    return m


@pytest.mark.parametrize("rates,hw,split", CASES)
def test_aspp_matches_jax(rates, hw, split):
    """Eval and train: the forward, the input gradient and every weight
    gradient against JAX's ``ASPP`` (and against the port's own plain
    dilated form), with the updated BN running means in train mode.
    float32; 1e-5 of the largest reference magnitude, JAX's own form being
    a regrouped sum of the same products (batch 6, so that the pooling
    branch's BN, over 6 samples, does not cancel in flax's one-pass
    variance)."""
    assert [decomposes(r, hw, hw) for r in rates] == list(split)
    rs = np.random.RandomState(20)
    x = rs.standard_normal((6, hw, hw, CIN)).astype(np.float32)
    dy = rs.standard_normal((6, hw, hw, CH)).astype(np.float32)
    jm = JASPP(channels=CH, rates=rates, dropout=0.0)
    v = random_variables(lambda: jm.init(KEY, jnp.asarray(x), False), 21)

    def grads(params, xx):
        def loss(params, xx, train):
            y, upd = jm.apply({"params": params,
                               "batch_stats": v["batch_stats"]},
                              xx, train, mutable=["batch_stats"])
            return jnp.sum(y * dy), (y, upd["batch_stats"])
        return [jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            params, xx, train) for train in (False, True)]

    jax_runs = jax.jit(grads, compiler_options=FAST_COMPILE)(
        v["params"], jnp.asarray(x))
    for train, ((_, (ref, stats)), (g_params, g_x)) in zip((False, True),
                                                            jax_runs):
        want_grads = aspp_state_dict(g_params, v["batch_stats"], len(rates))
        want_stats = aspp_state_dict(v["params"], stats, len(rates))
        for form in ("clipped", "plain"):
            m = ASPP(CIN, CH, rates, dropout=0.0)
            m.load_state_dict(aspp_state_dict(v["params"], v["batch_stats"],
                                              len(rates)))
            m.train(train)
            if form == "plain":
                _plain(m)
            xt = _nchw(x).requires_grad_(True)
            y = m(xt)
            (y * _nchw(dy)).sum().backward()
            what = f"{form}, train={train}"
            _close(_nhwc(y), ref, 1e-5, f"{what}: out")
            _close(_nhwc(xt.grad), g_x, 1e-5, f"{what}: dx")
            for name, p in m.named_parameters():
                _close(p.grad.numpy(), want_grads[name].numpy(), 1e-5,
                       f"{what}: d{name}")
            if train:
                for name, b in m.named_buffers():
                    if name.endswith("running_mean"):
                        _close(b.numpy(), want_stats[name].numpy(), 1e-5,
                               f"{what}: {name}")


def _bf16_round(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def test_tap_partials_round_once_as_in_jax():
    """bfloat16: a clipped-tap branch sums its tap partials in float32 and
    rounds once, as JAX's ``DilatedConv3x3`` does (rate 3 at 6²: eight
    border taps and the centre). The port must give JAX's bfloat16 bits but
    for rare float32 sums that land on the other side of a rounding edge:
    at most 1 % of the outputs differ, by one bfloat16 step (2⁻⁸
    relative). Rounding each tap's partial to bfloat16 before the sum
    differs from JAX at a third of the outputs (test below the assert)."""
    rs = np.random.RandomState(22)
    x = _bf16_round(rs.standard_normal((2, 6, 6, 64)).astype(np.float32))
    jm = JDilatedConv3x3(32, 3, dtype="bfloat16")
    v = random_variables(lambda: jm.init(KEY, jnp.asarray(x)), 23)
    ref = np.asarray(jax.jit(jm.apply, compiler_options=FAST_COMPILE)(
        v, jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    xh = torch.from_numpy(x).to(torch.bfloat16)
    weight = torch.from_numpy(np.transpose(
        np.asarray(v["params"]["kernel"]), (3, 2, 0, 1))).to(torch.bfloat16)
    assert decomposes(3, 6, 6)
    acc = torch.zeros(2, 6, 6, 32)
    got = add_taps(acc, xh, weight, 3, True).to(torch.bfloat16).float()
    differ = got.numpy() != ref
    assert differ.mean() <= 0.01, differ.mean()
    step = np.abs(got.numpy() - ref)[differ] / np.abs(ref)[differ]
    assert (step <= 2 ** -7).all(), step.max()

    # the same sum with each tap's partial rounded to bfloat16 first
    per_tap = torch.zeros(2, 6, 6, 32)
    for ti in range(3):
        for tj in range(3):
            one = torch.zeros_like(weight)
            one[:, :, ti, tj] = weight[:, :, ti, tj]
            part = add_taps(torch.zeros(2, 6, 6, 32), xh, one, 3, True)
            per_tap += part.to(torch.bfloat16).float()
    bad = per_tap.to(torch.bfloat16).float().numpy() != ref
    assert bad.mean() > 0.1, bad.mean()
