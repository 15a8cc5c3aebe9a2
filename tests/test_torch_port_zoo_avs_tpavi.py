"""The zoo's TPAVI-fused AVS flavours against the JAX package's on the
CPU: eval and train parity of ``avs_model17`` (per-view backbones, TPAVI
over the V·h·w tokens; 2 views of 3 frames) and ``avs_pred_endecoder``
(cross-view TPAVI with φ from the other view; 3 views of 2 frames, so its
ring of (main, other) pairs is not symmetric; trained at module level on
one pair) at 34² (``_torch_port_zoo_common``), and the optimizer step of
the parameters no loss reaches (CEN's ``alpha``, the B2ResNet second
fork), held against JAX's optax chain on those leaves alone."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_common import one_torch_thread  # noqa: F401
from _torch_port_zoo_common import (TINY, check_eval,
                                    check_train, references_ahead)
from glfusion_tpu import config as jconfig
from glfusion_tpu.train.train_state import make_optimizer as j_make_optimizer
from glfusion_tpu_torch.models import build_model
from glfusion_tpu_torch.train.step import make_train_step
from glfusion_tpu_torch.train.train_state import make_optimizer

ARCHS = ("avs_model17", "avs_pred_endecoder")


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_eval_matches_jax(arch, request):
    check_eval(arch, ahead=references_ahead(request))


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_train_grads_match_jax(arch):
    check_train(arch)


def _outside_the_loss(arch, model):
    if arch == "cen":
        return {"net.alpha": model.net.alpha}
    return {k: p for k, p in model.named_parameters()
            if k.startswith(("net.resnet.layer3_2", "net.resnet.layer4_2"))}


@pytest.mark.parametrize("arch", ["cen", "avs_transfusion"])
def test_step_moves_parameters_outside_the_loss_as_optax(arch):
    """One port train step: every parameter no loss reaches (CEN's ensemble
    logits ``alpha``, the B2ResNet second fork) equals JAX's optax chain
    (``make_optimizer``: L2, then Adam) applied to the same leaves with a
    zero gradient, within 1e-7 relative; torch's Adam alone would skip
    them. The chain is elementwise, so it runs on the leaves flattened into
    one, in float64, and the port's float32 parameters must lie within one
    float32 ulp of it (1.2e-7 relative at most; measured: 2 of 119 680
    elements at 1.006e-7). In float32 optax's own bias corrections round up
    to 10 ulps from the exact update (7e-7 relative)."""
    cfg = TINY.replace(
        model=dataclasses.replace(TINY.model, arch=arch),
        train=dataclasses.replace(TINY.train, use_cycle=False))
    torch.manual_seed(0)
    hw = 8 if arch == "cen" else 16  # CEN's widths are the reference's
    model, _ = build_model(cfg.model, hw=hw)
    outside = _outside_the_loss(arch, model)
    assert outside
    before = {k: p.detach().numpy().copy() for k, p in outside.items()}
    rs = np.random.RandomState(0)
    batch = {"images": torch.from_numpy(rs.rand(3, 2, hw, hw, 1).astype(
                 np.float32)),
             "masks": torch.from_numpy((rs.rand(3, 2, hw, hw, 5) > 0.7)
                                       .astype(np.float32))}
    step = make_train_step(cfg, model, make_optimizer(cfg, model.parameters()))
    step(batch, torch.Generator())
    tx = j_make_optimizer(jconfig.Config(), steps_per_epoch=1)
    with jax.enable_x64(True):
        leaf = jnp.asarray(np.concatenate([a.ravel() for a in
                                           before.values()]), jnp.float64)
        upd, _ = tx.update(jnp.zeros_like(leaf), tx.init(leaf), leaf)
        want = np.asarray(optax.apply_updates(leaf, upd))
    got = np.concatenate([p.detach().numpy().ravel()
                          for p in outside.values()])
    start = np.asarray(leaf)
    assert (got[start != 0] != start[start != 0]).all()  # a zero stays 0
    np.testing.assert_array_max_ulp(got, want.astype(np.float32), maxulp=1)
