"""The port's flagship GlobalAndLocal against the JAX GlobalAndLocal on the
CPU, at the tiny widths of tests/test_full_model_torch_parity.py (32², 2
frames), with random BN statistics and a nonzero TPAVI W_z BN (at its zero
init the attention output would never reach the masks).

float32, atol = rtol = 2e-4.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (TINY_MODEL, TOL, one_torch_thread,  # noqa: F401
                                tiny_flagship, to_numpy)
from glfusion_tpu import config as jconfig
from glfusion_tpu.config import ModelConfig as JModelConfig
from glfusion_tpu.utils.torch_convert import convert_state_dict
from glfusion_tpu_torch import config as pconfig
from glfusion_tpu_torch.config import ModelConfig
from glfusion_tpu_torch.models import GlobalAndLocal
from glfusion_tpu_torch.utils.convert import (load_checkpoint,
                                              state_dict_from_jax)

JCFG = JModelConfig(**TINY_MODEL)
CFG = ModelConfig(**TINY_MODEL)
OUTPUTS = ("mask", "mask_bb", "f4_global", "f4_local")


@pytest.fixture(scope="module")
def jax_case():
    x = np.random.RandomState(0).rand(3, 2, 32, 32, 1).astype(np.float32)
    jm, v = tiny_flagship()
    return jm, v, x


@pytest.fixture(scope="module")
def jax_eval(jax_case):
    jm, v, x = jax_case
    return jax.jit(lambda v, x: jm.apply(v, x, False))(v, jnp.asarray(x))


def _port(v, use_pallas_fusion=False) -> GlobalAndLocal:
    m = GlobalAndLocal(dataclasses.replace(
        CFG, use_pallas_fusion=use_pallas_fusion))
    m.load_state_dict(state_dict_from_jax(v, CFG))
    return m


@pytest.mark.parametrize("use_pallas_fusion", [True, False])
def test_forward_eval_matches_jax(jax_case, jax_eval, use_pallas_fusion):
    """The port once through the kernel's path (its plain version on the
    CPU) and once through the reassociated default, against JAX's default
    (its Pallas path runs on the CPU only in interpret mode)."""
    _, v, x = jax_case
    ref = jax_eval
    m = _port(v, use_pallas_fusion).eval()
    assert (m.global_attn.W_z[1].weight != 0).all()
    with torch.no_grad():
        out = m(torch.from_numpy(x))
    for k in OUTPUTS:
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **TOL)


def test_forward_train_matches_jax(jax_case):
    """Train mode (batch-statistics BN, dropout 0): outputs and the updated
    BN running means. (Running variances follow torch's unbiased update;
    see tests/test_torch_port_modules.py::test_tpavi_train_matches_jax.)

    Tolerances: against JAX 2e-3, because flax computes the batch variance
    in one pass, E[x²] − E[x]², which cancels in float32 on the ASPP
    pooling branch's 2-sample batches (JAX's float32 mask_bb lies 1.3e-3
    from the float64 port, the float32 port 9e-5). Against the port itself
    in float64, the stated 2e-4.
    """
    jm, v, x = jax_case
    ref, upd = jax.jit(lambda v, x: jm.apply(v, x, True,
                                             mutable=["batch_stats"]))(
        v, jnp.asarray(x))
    m, m64 = _port(v).train(), _port(v).double().train()
    with torch.no_grad():
        out = m(torch.from_numpy(x))
        out64 = m64(torch.from_numpy(x).double())
    for k in OUTPUTS:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, atol=2e-3, rtol=2e-3)
        np.testing.assert_allclose(out[k].numpy(), out64[k].numpy(),
                                   err_msg=k, **TOL)
    got = convert_state_dict(m.state_dict(), JCFG)["batch_stats"]
    want = to_numpy(upd["batch_stats"])
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    means = [(p, a) for p, a in paths if p[-1].key == "mean"]
    assert len(means) == 33  # every BatchNorm of the tiny model
    for path, a in means:
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g, a, err_msg=str(path), **TOL)


def test_state_dict_round_trip(jax_case):
    """convert_state_dict (the JAX package's reader of reference state
    dicts) reads the port's state dict back into the exact JAX tree."""
    _, v, _ = jax_case
    back = convert_state_dict(_port(v).state_dict(), JCFG)
    want = jax.tree_util.tree_flatten_with_path(v)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_load_reference_checkpoint(jax_case, tmp_path):
    """A reference ``{'network': state_dict}`` file, with the DataParallel
    prefix, the constructor template and the dead audio path, loads
    strictly."""
    _, v, _ = jax_case
    sd = _port(v).state_dict()
    ref = {f"module.{k}": t for k, t in sd.items()}
    ref["module.network.conv1.weight"] = torch.zeros(2, 1, 3, 3)
    ref["module.global_attn.align_channel.weight"] = torch.zeros(64, 128)
    path = tmp_path / "net_00001.pth"
    torch.save({"network": ref}, path)
    m = GlobalAndLocal(CFG)
    m.load_state_dict(load_checkpoint(str(path)))
    for k, t in m.state_dict().items():
        assert torch.equal(t, sd[k]), k


@pytest.mark.parametrize("name", ["ModelConfig", "DataConfig", "OptConfig",
                                  "TrainConfig"])
def test_config_fields_and_defaults_match_jax(name):
    """One configuration describes the same model in both packages."""
    assert (dataclasses.asdict(getattr(pconfig, name)())
            == dataclasses.asdict(getattr(jconfig, name)()))


def test_config_constants_and_tiny_config_match_jax():
    for attr in ("STRUCTURES", "ALL_VIEWS", "VIEW_OUT_CHANNELS"):
        assert getattr(pconfig, attr) == getattr(jconfig, attr)
    assert (dataclasses.asdict(pconfig.tiny_config())
            == dataclasses.asdict(jconfig.tiny_config()))


def test_convolutions_run_in_nchw(jax_case):
    """Every convolution sees an NCHW-contiguous input, whatever the strides
    of the input's size-1 channel axis. (A (B, 1, H, W) view with
    channels-last strides made the whole network run channels-last, where
    cuDNN's float32 dilated convolutions take a direct kernel 6-25x
    slower: chip_smoke.py profile.)"""
    _, v, x = jax_case
    m = _port(v).eval()
    seen = []
    for mod in m.modules():
        if isinstance(mod, torch.nn.Conv2d):
            mod.register_forward_pre_hook(
                lambda _, args: seen.append(args[0]))
    with torch.no_grad():
        m(torch.from_numpy(x).clone())  # fresh, standard strides
    assert len(seen) > 100
    for t in seen:
        assert t.stride() == torch.empty(t.shape).stride(), t.shape


def test_carried_weights_stay_per_view(jax_case, jax_eval):
    """With every view deep-copied from one at init, weights carried from
    JAX (different in each view) still land in each view's own tensors and
    give the serving slice's outputs: the JAX eval forward,
    atol = rtol = 2e-4."""
    _, v, x = jax_case
    m = _port(v).eval()
    sd = state_dict_from_jax(v, CFG)
    for view in CFG.views:
        k = f"init_block.{view}.0.weight"
        assert torch.equal(m.state_dict()[k], sd[k])
    w1, w3 = (m.init_block[view][0].weight for view in ("1", "3"))
    assert not torch.equal(w1, w3) and w1.data_ptr() != w3.data_ptr()
    with torch.no_grad():
        out = m(torch.from_numpy(x))
    np.testing.assert_allclose(out["mask"].numpy(),
                               np.asarray(jax_eval["mask"]), **TOL)
