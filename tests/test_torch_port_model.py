"""The port's flagship GlobalAndLocal against the JAX GlobalAndLocal on the
CPU, at the tiny widths of tests/test_full_model_torch_parity.py (32², 2
frames), with random BN statistics and a nonzero TPAVI W_z BN (at its zero
init the attention output would never reach the masks).

float32, atol = rtol = 2e-4.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (FAST_COMPILE, TINY_MODEL, TOL,  # noqa: F401
                                init_shapes, one_torch_thread,
                                random_variables, tiny_flagship, to_numpy)
from glfusion_tpu import config as jconfig
from glfusion_tpu.config import ModelConfig as JModelConfig
from glfusion_tpu.models.glfusion import GlobalAndLocal as JGlobalAndLocal
from glfusion_tpu.models.glfusion import (
    GlobalAndLocalCPS as JGlobalAndLocalCPS)
from glfusion_tpu.utils.torch_convert import convert_state_dict
from glfusion_tpu_torch.train.trainer import Trainer
from glfusion_tpu_torch import config as pconfig
from glfusion_tpu_torch.config import ModelConfig
from glfusion_tpu_torch.models import GlobalAndLocal, GlobalAndLocalCPS
from glfusion_tpu_torch.utils.convert import (load_checkpoint,
                                              state_dict_from_jax)

JCFG = JModelConfig(**TINY_MODEL)
CFG = ModelConfig(**TINY_MODEL)
OUTPUTS = ("mask", "mask_bb", "f4_global", "f4_local")
# the flagship's ablations (JAX glfusion.py:168-326), at TINY_MODEL widths
# with the ASPP's 1×1 and pooling branches only (their JAX references
# compile in about half the time; the ablations leave the ASPP alone)
VARIANT_CFG = dict(TINY_MODEL, aspp_rates=())
VARIANTS = ("global_only", "local_only", "cyc_nofusion",
            "global_only_cyc_nofusion", "conv_merge", "fg_bg",
            "early_fusion", "late_fusion")


@pytest.fixture(scope="module")
def jax_case():
    x = np.random.RandomState(0).rand(3, 2, 32, 32, 1).astype(np.float32)
    jm, v = tiny_flagship()
    return jm, v, x


@pytest.fixture(scope="module")
def jax_apply(jax_case):
    jm = jax_case[0]
    return jax.jit(lambda v, x: jm.apply(v, x, False),
                   compiler_options=FAST_COMPILE)


@pytest.fixture(scope="module")
def jax_eval(jax_case, jax_apply):
    _, v, x = jax_case
    return jax_apply(v, jnp.asarray(x))


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
                                             mutable=["batch_stats"]),
                       compiler_options=FAST_COMPILE)(v, jnp.asarray(x))
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


def test_cycle_pass_forms(jax_case):
    """The cycle pass's training forms against the plain forward, on the
    port alone (the toy model of test_torch_port_options.py holds them
    against JAX's step). Eval, where BN is per frame: ``features_only`` on
    a clip gives the plain forward's ``f4_global``; ``sup_count`` on the
    supervised frames and the clip concatenated gives the supervised
    frames' ``mask``, ``mask_bb``, ``f4_local`` and the clip's
    ``f4_global`` (atol = rtol = 2e-4). Train: ``features_only`` moves the
    running statistics of the backbone and the global attention only, and
    ``sup_count`` moves those two by the merged batch's moments, as the
    plain train forward of the concatenation does."""
    _, v, x = jax_case
    clip = np.random.RandomState(9).rand(3, 3, 32, 32, 1).astype(np.float32)
    both = torch.from_numpy(np.concatenate([x, clip], axis=1))
    m = _port(v).eval()
    with torch.no_grad():
        sup, cyc = m(torch.from_numpy(x)), m(torch.from_numpy(clip))
        light = m(torch.from_numpy(clip), features_only=True)
        fused = m(both, sup_count=2)
    assert set(light) == {"f4_global"}
    np.testing.assert_allclose(light["f4_global"].numpy(),
                               cyc["f4_global"].numpy(), **TOL)
    for k in OUTPUTS:
        want = cyc[k] if k == "f4_global" else sup[k]
        np.testing.assert_allclose(fused[k].numpy(), want.numpy(),
                                   err_msg=k, **TOL)

    moved = ("init_block.", "layer", "global_attn.")
    for form, inp, kw in (("features_only", torch.from_numpy(clip),
                           dict(features_only=True)),
                          ("sup_count", both, dict(sup_count=2))):
        m = _port(v).train()
        before = {k: t.clone() for k, t in m.state_dict().items()}
        with torch.no_grad():
            m(inp, **kw)
        after = m.state_dict()
        if form == "sup_count":
            ref = _port(v).train()
            with torch.no_grad():
                ref(both)
            want = ref.state_dict()
        for k, t in after.items():
            if "running_" not in k:
                continue
            if not k.startswith(moved):
                if form == "features_only":
                    assert torch.equal(t, before[k]), k
            elif form == "features_only":
                assert not torch.equal(t, before[k]), k
            else:
                np.testing.assert_allclose(t.numpy(), want[k].numpy(),
                                           err_msg=k, **TOL)


def test_forward_bf16_matches_jax(jax_case):
    """``dtype="bfloat16"`` in eval against JAX's bfloat16 GlobalAndLocal
    on the same float32 weights, jitted with ``xla_allow_excess_precision``
    off so that each JAX operation rounds where it is written to (XLA's
    default fusions keep some bfloat16 intermediates in float32: its TPAVI
    output then differs from its own eager one at 28 % of the elements).
    Every output is bfloat16. ``f4_global`` and ``mask_bb`` (backbone,
    global attention, classifier, bilinear upsample) must give JAX's bits
    but for 1 % of the elements, one bfloat16 step apart (2⁻⁸ relative).
    ``mask`` and ``f4_local`` pass through the sigmoids of the centre-aware
    map, which PyTorch rounds once and XLA's CPU lowering rounds in its own
    steps (a quarter of them differ by one step): those two within 2e-2 in
    relative norm and 5e-2 of the largest reference magnitude (measured
    3.0e-3 and 0.125 / 8.9 on ``mask``)."""
    jm, v, x = jax_case
    jbf = type(jm)(dataclasses.replace(JCFG, dtype="bfloat16"))
    ref = jax.jit(lambda v, x: jbf.apply(v, x, False),
                  compiler_options={"xla_allow_excess_precision": False})(
        v, jnp.asarray(x))
    m = GlobalAndLocal(dataclasses.replace(CFG, dtype="bfloat16"))
    m.load_state_dict(state_dict_from_jax(v, CFG))
    with torch.no_grad():
        out = m.eval()(torch.from_numpy(x))
    for k in OUTPUTS:
        assert out[k].dtype == torch.bfloat16, k
        want = np.asarray(ref[k].astype(jnp.float32))
        got = out[k].float().numpy()
        if k in ("f4_global", "mask_bb"):
            differ = got != want
            assert differ.mean() <= 0.01, (k, differ.mean())
            step = np.abs(got - want)[differ] / np.abs(want)[differ]
            assert (step <= 2 ** -7).all(), (k, step.max())
        err = np.abs(got - want).max() / np.abs(want).max()
        norm = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= 5e-2 and norm <= 2e-2, (k, err, norm)


def test_forward_is_video_matches_jax(jax_case):
    """``is_video`` (the ``temporal`` option's cycle pass): the clip's 2
    frames join the attention's token axis, (2, 3, h, w, C) → (1, 6·h·w,
    C), in both attentions. Eval, through the kernel's path (its plain
    version on the CPU, at batch 1), against JAX's GlobalAndLocal with
    ``is_video=True`` on the same weights; every output within TOL. The
    fold is not the per-frame forward: ``f4_global`` moves."""
    jm, v, x = jax_case
    ref = jax.jit(lambda v, x: jm.apply(v, x, False, is_video=True),
                  compiler_options=FAST_COMPILE)(v, jnp.asarray(x))
    m = _port(v, use_pallas_fusion=True).eval()
    with torch.no_grad():
        out = m(torch.from_numpy(x), is_video=True)
        per_frame = m(torch.from_numpy(x))
    for k in OUTPUTS:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **TOL)
    assert not np.allclose(out["f4_global"].numpy(),
                           per_frame["f4_global"].numpy(), **TOL)


def test_cps_twin_matches_two_jax_flagships(jax_case, jax_apply):
    """The port's GlobalAndLocalCPS loaded from JAX GlobalAndLocalCPS
    variables: ``net1`` and ``net2`` trees (their structure from JAX's
    own module, traced with ``jax.eval_shape``), each JAX's flagship tree.
    ``mask`` is net 1's, ``mask_2`` net 2's, ``f4_global`` and ``f4_local``
    net 1's: each against JAX's flagship on that net's variables, within
    TOL, eval."""
    jm, v, x = jax_case
    v2 = random_variables(lambda: jm.init(jax.random.PRNGKey(0),
                                          jnp.asarray(x), False), 8)
    twin = {k: {"net1": v[k], "net2": v2[k]} for k in v}
    want_tree = init_shapes(lambda: JGlobalAndLocalCPS(JCFG).init(
        jax.random.PRNGKey(0), jnp.asarray(x), False))
    assert (jax.tree_util.tree_structure(twin)
            == jax.tree_util.tree_structure(
                {k: want_tree[k] for k in twin}))
    m = GlobalAndLocalCPS(CFG)
    m.load_state_dict(state_dict_from_jax(twin, CFG))
    with torch.no_grad():
        out = m.eval()(torch.from_numpy(x))
    r1, r2 = jax_apply(v, jnp.asarray(x)), jax_apply(v2, jnp.asarray(x))
    for k, ref in (("mask", r1["mask"]), ("mask_2", r2["mask"]),
                   ("f4_global", r1["f4_global"]),
                   ("f4_local", r1["f4_local"])):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref),
                                   err_msg=k, **TOL)


def _jax_variant(variant: str, x: np.ndarray, seed: int = 7):
    """JAX's GlobalAndLocal of ``variant`` at VARIANT_CFG and random
    variables (tree traced with ``jax.eval_shape``, no compile)."""
    jm = JGlobalAndLocal(JModelConfig(**VARIANT_CFG, variant=variant))
    return jm, random_variables(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(x), False), seed)


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_eval_matches_jax(jax_case, variant):
    """Each ablation's eval forward at VARIANT_CFG, the port through the
    kernel's path (its plain version on the CPU), against JAX's jitted
    default on the same variables: ``mask``, ``mask_bb``, ``f4_global``
    (each variant's cycle slot: raw f4 for the cyc_nofusion pair and
    early/late fusion, f4_fusion for fg_bg, the 1-channel atten map for
    local_only) and ``f4_local`` (raw f4 where the variant has no local
    branch), within TOL. The port holds exactly the modules JAX creates (a
    strict load of the bridged tree), and every TPAVI W_z BN has a nonzero
    scale."""
    _, _, x = jax_case
    jm, v = _jax_variant(variant, x)
    ref = jax.jit(lambda v, x: jm.apply(v, x, False),
                  compiler_options=FAST_COMPILE)(v, jnp.asarray(x))
    cfg = ModelConfig(**VARIANT_CFG, variant=variant, use_pallas_fusion=True)
    m = GlobalAndLocal(cfg)
    m.load_state_dict(state_dict_from_jax(v, cfg))
    for attn in ("global_attn", "local_attn"):
        assert hasattr(m, attn) == (attn in v["params"]), attn
        if hasattr(m, attn):
            assert (getattr(m, attn).W_z[1].weight != 0).all()
    with torch.no_grad():
        out = m.eval()(torch.from_numpy(x))
    for k in OUTPUTS:
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("variant,name,cin,cout", [
    ("conv_merge", "merge", 2 * 64, 64), ("early_fusion", "early_mix", 3, 1),
    ("late_fusion", "late_mix", 3 * 5, 5)])
def test_state_dict_from_jax_maps_the_pointwise_convs(variant, name, cin,
                                                      cout):
    """``state_dict_from_jax`` maps JAX's per-view ``PointwiseConv``
    ``{name}/conv`` (kernel (V, 1, 1, I, O), bias (V, O)) to the port's
    ``{name}.{v}.weight`` (O, I, 1, 1) and ``.bias``, each view its own
    slice, exactly; a new port model starts with the same conv in every
    view, as JAX's ``_per_view`` does. In bfloat16 every output has JAX's
    type."""
    jm, v = _jax_variant(variant, np.zeros((3, 1, 32, 32, 1), np.float32))
    cfg = ModelConfig(**VARIANT_CFG, variant=variant)
    sd = state_dict_from_jax(v, cfg)
    kernel = np.asarray(v["params"][name]["conv"]["kernel"])
    bias = np.asarray(v["params"][name]["conv"]["bias"])
    assert kernel.shape == (3, 1, 1, cin, cout)
    for i, view in enumerate(CFG.views):
        np.testing.assert_array_equal(sd[f"{name}.{view}.weight"].numpy(),
                                      kernel[i].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(sd[f"{name}.{view}.bias"].numpy(),
                                      bias[i])
    fresh = GlobalAndLocal(cfg)
    convs = [getattr(fresh, name)[view] for view in CFG.views]
    assert fresh.state_dict().keys() == sd.keys()
    for conv in convs[1:]:
        assert torch.equal(conv.weight, convs[0].weight)
        assert conv.weight.data_ptr() != convs[0].weight.data_ptr()

    # the conv takes no type from the model in JAX: float32 in a bfloat16
    # model, so late_fusion's mask is float32 there; every output's type
    # as JAX's (traced)
    x = torch.rand(3, 1, 32, 32, 1)
    jbf = JGlobalAndLocal(JModelConfig(**VARIANT_CFG, variant=variant,
                                       dtype="bfloat16"))
    want = jax.eval_shape(lambda: jbf.apply(v, jnp.asarray(x.numpy()),
                                            False))
    bf = GlobalAndLocal(dataclasses.replace(cfg, dtype="bfloat16")).eval()
    with torch.no_grad():
        out = bf(x)
    assert {k: str(t.dtype)[6:] for k, t in out.items()} == {
        k: str(a.dtype) for k, a in want.items()}


@pytest.mark.parametrize("variant", ["fg_bg", "local_only"])
def test_variants_refuse_the_cycle_forms_as_jax(jax_case, variant):
    """``features_only`` and ``sup_count`` are refused for the variants
    whose cycle slot needs the heads, with JAX's messages (JAX raises them
    while tracing: ``jax.eval_shape``)."""
    _, _, x = jax_case
    jm, v = _jax_variant(variant, x)
    m = GlobalAndLocal(ModelConfig(**VARIANT_CFG, variant=variant)).eval()
    both = np.concatenate([x, x], axis=1)
    for kw, inp in ((dict(features_only=True), x),
                    (dict(sup_count=2), both)):
        with pytest.raises(ValueError) as jerr:
            jax.eval_shape(lambda: jm.apply(v, jnp.asarray(inp), False,
                                            **kw))
        with pytest.raises(ValueError) as err:
            m(torch.from_numpy(inp), **kw)
        assert str(err.value) == str(jerr.value)
        assert "need the classifier heads" in str(err.value)


@pytest.mark.parametrize("variant,source,fails", [
    ("conv_merge", "conv_merge", "merge"),
    ("local_only", "global_only", "centerness"),
    ("global_only", "global_and_local", None)])
def test_torch_ckpt_follows_jax_for_variants(tmp_path, variant, source,
                                             fails):
    """``--torch-ckpt`` (``Trainer.load_torch_checkpoint``) on a reference
    ``{'network': ...}`` file of ``source``'s modules into ``variant``,
    against JAX's reader (``convert_state_dict``, then the first forward,
    traced): a tree the file does not cover fails in both, naming what is
    missing: JAX's converter cannot map the variants' 1×1 convs (its first
    forward finds no ``merge`` conv) nor a head the file lacks (its
    converter raises ``KeyError``); the port raises ``KeyError`` before
    anything is loaded. Entries the model does not have are ignored by
    both, and the rest loads exactly."""
    file_sd = GlobalAndLocal(ModelConfig(**VARIANT_CFG,
                                         variant=source)).state_dict()
    path = tmp_path / "net_00001.pth"
    torch.save({"network": {f"module.{k}": t for k, t in file_sd.items()}},
               path)
    jm = JGlobalAndLocal(JModelConfig(**VARIANT_CFG, variant=variant))

    def jax_load():
        v = convert_state_dict(file_sd, jm.cfg)
        return jax.eval_shape(lambda: jm.apply(
            v, jnp.zeros((3, 1, 32, 32, 1)), False))

    model = GlobalAndLocal(ModelConfig(**VARIANT_CFG, variant=variant))
    before = {k: t.clone() for k, t in model.state_dict().items()}
    trainer = SimpleNamespace(cps=False, model=model, _log=lambda m: None,
                              cfg=SimpleNamespace(model=model.cfg))
    if fails is None:
        jax_load()
        Trainer.load_torch_checkpoint(trainer, str(path))
        for k, t in model.state_dict().items():
            assert torch.equal(t, file_sd[k]), k
        return
    with pytest.raises(Exception, match=fails):
        jax_load()
    with pytest.raises(KeyError, match=fails):
        Trainer.load_torch_checkpoint(trainer, str(path))
    for k, t in model.state_dict().items():
        assert torch.equal(t, before[k]), k
