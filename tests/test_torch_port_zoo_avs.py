"""The zoo's AVS family (``--model avs_*``) against the JAX package's on
the CPU: eval and train parity of ``avs_baseline`` and ``avs_transfusion``
(``_torch_port_zoo_common``: JAX in float64, one compile an arch, 2 views
of 3 frames at 34²) and the pins of what a plain reading misses (the
channel transformer's parameter shapes, the second backbone fork's BN
statistics, model17's independent backbones). The TPAVI flavours and the
optimizer step of the parameters no loss reaches are in
test_torch_port_zoo_avs_tpavi.py, the legacy kinds in
test_torch_port_zoo_legacy.py: a file's JAX references share its worker,
and no file holds them all."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_port_common import init_shapes, one_torch_thread  # noqa: F401
from _torch_port_zoo_common import (TINY, check_eval,
                                    check_train, references_ahead)
from glfusion_tpu.models.avs import ViewChannelTransformer as JVCT
from glfusion_tpu_torch.config import Config
from glfusion_tpu_torch.models import build_model
from glfusion_tpu_torch.models.avs import (B2ResNet, ViewChannelTransformer,
                                           b2_stage_hw)

ARCHS = ("avs_baseline", "avs_transfusion")


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_eval_matches_jax(arch, request):
    check_eval(arch, ahead=references_ahead(request))


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_train_grads_match_jax(arch):
    check_train(arch)


def test_view_channel_transformer_shapes_match_jax():
    """Linear(h·w, h·w) sized by the grid, BN over the V·C tokens, the
    LayerNorm's affine over V alone (flax ``feature_axes=-1``); at a 112²
    crop the four stages' token dimensions are 784, 196, 49 and 16."""
    v, c, h, w = 3, 8, 5, 6
    shapes = init_shapes(lambda: JVCT().init(
        jax.random.PRNGKey(0), jnp.zeros((v, 2, h, w, c)), False))
    jp = {f"{m}.{k}": s.shape for m, d in shapes["params"].items()
          for k, s in d.items()}
    port = ViewChannelTransformer(v, c, h * w)
    got = {k: tuple(t.shape) for k, t in port.state_dict().items()}
    for m in ("query", "key", "value", "proj"):
        assert got[f"{m}.weight"] == jp[f"{m}.kernel"] == (h * w, h * w)
        assert got[f"{m}.bias"] == jp[f"{m}.bias"] == (h * w,)
    assert got["bn.weight"] == jp["bn.scale"] == (v * c,)
    assert got["bn.running_mean"] == (v * c,)
    assert got["norm.weight"] == jp["norm.scale"] == (v,)
    assert b2_stage_hw(112) == (28, 14, 7, 4)
    assert b2_stage_hw(34) == (9, 5, 3, 2)
    with torch.device("meta"):
        m, _ = build_model(dataclasses.replace(
            Config().model, arch="avs_transfusion"), hw=112)
    assert [m.net.get_submodule(f"attn{i}").query.weight.shape[0]
            for i in range(1, 5)] == [784, 196, 49, 16]


def test_second_fork_runs_for_its_statistics_in_train_mode():
    """Nothing reads layer3_2/layer4_2, but in train mode their BN running
    statistics move (JAX's do); in eval they are untouched, and neither
    mode gives the fork a gradient."""
    torch.manual_seed(0)
    net = B2ResNet((2, 4, 6, 8), (1, 1, 1, 1))
    x = torch.rand(2, 3, 34, 34)
    fork = [k for k in net.state_dict() if "running_mean" in k
            and k.startswith(("layer3_2", "layer4_2"))]
    assert len(fork) == 8
    before = {k: net.state_dict()[k].clone() for k in fork}
    with torch.no_grad():
        net.eval()(x)
    assert all(torch.equal(net.state_dict()[k], before[k]) for k in fork)
    sum(t.sum() for t in net.train()(x)).backward()
    assert all(not torch.equal(net.state_dict()[k], before[k]) for k in fork)
    assert all(p.grad is None for k, p in net.named_parameters()
               if k.startswith(("layer3_2", "layer4_2")))
    assert all(p.grad is not None for k, p in net.named_parameters()
               if k.startswith(("layer3_1", "layer4_1")))


def test_model17_draws_each_view_and_legacy_copies():
    """model17's resnet_{v} are drawn one after the other (independent
    weights); a legacy kind's per-view modules start equal."""
    torch.manual_seed(0)
    m17, _ = build_model(dataclasses.replace(TINY.model, arch="avs_model17"),
                         hw=32)
    w = [m17.net.get_submodule(f"resnet_{v}").conv1.weight for v in range(3)]
    assert not torch.equal(w[0], w[1]) and not torch.equal(w[1], w[2])
    leg, _ = build_model(dataclasses.replace(TINY.model, arch="legacy:none"),
                         hw=32)
    sd = leg.state_dict()
    for k in sd:
        if k.startswith("net.backbone.0."):
            for v in (1, 2):
                assert torch.equal(sd[k], sd[k.replace(".0.", f".{v}.", 1)])
