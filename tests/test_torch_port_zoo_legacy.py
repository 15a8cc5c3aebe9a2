"""The zoo's legacy kinds (``--model legacy:*``, JAX
``models/legacy_variants.py``) against the JAX package's on the CPU: eval
parity of all seven and train parity of four (``_torch_port_zoo_common``:
JAX in float64, one compile an arch, tiny_config() widths, 3 views at
16²), and the pins: ``SpatialConcatFusion`` and ``SpatialMLP`` (building
blocks the registry does not reach) and JAX's ``ValueError``s. The AVS
family is in test_torch_port_zoo_avs.py and
test_torch_port_zoo_avs_tpavi.py."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import one_torch_thread  # noqa: F401
from _torch_port_zoo_common import (TINY, _jcfg, check_eval,
                                    check_train, references_ahead)
from glfusion_tpu.models import legacy_variants as jleg
from glfusion_tpu_torch.models import (LegacyMultiviewSeg,
                                       SpatialConcatFusion, SpatialMLP)
from glfusion_tpu_torch.utils.convert import zoo_state_dict_from_jax

ARCHS = tuple(f"legacy:{k}" for k in ("none", "channel_transformer", "tpavi",
                                      "model18", "model20", "decouple",
                                      "mlp_concat"))
TRAIN = ("legacy:channel_transformer", "legacy:mlp_concat", "legacy:model20",
         "legacy:decouple")


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_eval_matches_jax(arch, request):
    check_eval(arch, ahead=references_ahead(request))


@pytest.mark.parametrize("arch", TRAIN)
def test_zoo_train_grads_match_jax(arch):
    check_train(arch)


@pytest.mark.parametrize("block", ["concat", "mlp"])
def test_spatial_blocks_match_jax(block):
    """concat_fusion (the views on the spatial axis, a Linear V·h·w → h·w)
    and MLP (a Linear over h·w, ReLU), JAX's Dense kernels transposed."""
    rs = np.random.RandomState(0)
    v, b, h, w, c = 3, 2, 4, 5, 6
    x = rs.rand(*((v, b, h, w, c) if block == "concat" else (b, h, w, c)))
    x = x.astype(np.float32)
    jm = jleg.SpatialConcatFusion() if block == "concat" else jleg.SpatialMLP()
    n = (v if block == "concat" else 1) * h * w
    params = {"fc": {"kernel": rs.standard_normal((n, h * w)).astype(
        np.float32) / np.sqrt(n), "bias": rs.uniform(-0.5, 0.5, h * w)
        .astype(np.float32)}}
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    pm = SpatialConcatFusion(v, h, w) if block == "concat" else SpatialMLP(
        h, w)
    pm.load_state_dict(zoo_state_dict_from_jax({"params": params},
                                               "legacy:none", per_view=False))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    if block == "mlp":
        assert (ref == 0).any()  # the ReLU clips


@pytest.mark.parametrize("fusion,stages", [
    ("none", (1, 4)), ("channel_transformer", (3,)),
    ("decouple_tpavi", (4, 4)), ("mlp_concat", ())])
def test_fusion_stages_refused_as_in_jax(fusion, stages):
    """Only tpavi fuses at several stages (model20); any other fusion at a
    stage but (4,) raises JAX's ValueError (a JAX init raises it before
    any compile). The port refuses an unknown fusion too."""
    jcfg = dataclasses.replace(_jcfg("legacy:none"), dtype="float32")
    jm = jleg.LegacyMultiviewSeg(jcfg, fusion=fusion, fusion_stages=stages)
    cfg = dataclasses.replace(TINY.model, views=jcfg.views)
    LegacyMultiviewSeg(cfg, 16, fusion="tpavi", fusion_stages=(2, 4))
    with pytest.raises(ValueError, match="unknown fusion"):
        LegacyMultiviewSeg(cfg, 16, fusion="bogus")
    with pytest.raises(ValueError) as jerr:
        jm.init(jax.random.PRNGKey(0), jnp.zeros((3, 1, 16, 16, 1)))
    with pytest.raises(ValueError) as err:
        LegacyMultiviewSeg(cfg, 16, fusion=fusion, fusion_stages=stages)
    assert str(err.value) == str(jerr.value)
