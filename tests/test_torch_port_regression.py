"""The mPAP regression path of the port against the JAX package's, on the CPU.

At JAX's own ``--tiny`` overrides (``cli.TINY_REG``, JAX ``cli.py:262-269``),
3 views, 2 clips of 8 frames at 32², random weights made with numpy from a
seed (every BN with random statistics, ECA's kernels and the cls tokens
random) and carried across with ``utils/convert.reg_state_dict_from_jax``.
JAX runs once a model (``jax_case``: the eval forward, and one train-mode
forward with its MSE loss, gradients and new batch statistics, in one
compile):

* eval: the port in float32 within ``EVAL_TOL`` in relative norm;
* train: the loss and every gradient within ``TRAIN_TOL`` (a conv bias
  before a train BN, whose true gradient is 0, is measured against its
  module's weight gradient). ``resnet50pah`` runs in float64 on both
  sides: at tiny size its last stage normalizes 2 values a channel, which
  carries float32 rounding to 4e-3 of max|g| in either package (in float64
  the two agree within 1.5e-11). The others run in float32;
* the BN running statistics: equal means, and torch's unbiased running
  variance against flax's biased one by n / (n − 1) (ROADMAP Queue 3).

Also: the loader's batches and the eval crop equal to JAX's bit for bit on
one synthetic corpus written by the port's generator, the train crop at
JAX's drawn offsets, ``utils/scores`` against JAX's, the parity traps
(tanh GELU, ConvTranspose taps, ECA over channels, the −inf max-pool pad),
a tiny ``--mode reg-train`` then ``reg-val`` through the port CLI, and
bfloat16 outputs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import FAST_COMPILE, _fill
from _torch_port_common import one_torch_thread  # noqa: F401
from glfusion_tpu import cli as jcli
from glfusion_tpu.config import tiny_config as j_tiny_config
from glfusion_tpu.data import infos as jinfos
from glfusion_tpu.data import pipeline as jpipe
from glfusion_tpu.models import resnet3d as jresnet3d
from glfusion_tpu.models import timesformer as jtimesformer
from glfusion_tpu.models.registry import build_reg_model as j_build
from glfusion_tpu.utils import scores as jscores
from glfusion_tpu_torch import cli
from glfusion_tpu_torch.arch_names import REG_ARCHS
from glfusion_tpu_torch.config import tiny_config
from glfusion_tpu_torch.data import infos as pinfos
from glfusion_tpu_torch.data import pipeline as ppipe
from glfusion_tpu_torch.data.synthetic import generate_synthetic_dataset
from glfusion_tpu_torch.models import resnet3d, timesformer
from glfusion_tpu_torch.models.registry import build_reg_model
from glfusion_tpu_torch.utils import scores as pscores
from glfusion_tpu_torch.utils.convert import reg_state_dict_from_jax

NAMES = ("resnet50pah", "r2plus1d", "timesformer", "resnet50pfs")
V, B, HW, T = 3, 2, 32, 8
FLOAT64 = ("resnet50pah",)  # see the module docstring
EVAL_TOL = 5e-5  # relative norm; measured at most 7.3e-6 (resnet50pfs)
# (loss relative, each gradient of max|g|); measured in float32: r2plus1d
# 1.2e-4, resnet50pfs 2.4e-4, timesformer 8.4e-7 of max|g|; in float64
# resnet50pah 1.5e-11
TRAIN_TOL = {"resnet50pah": (1e-10, 1e-8), "r2plus1d": (1e-5, 1e-3),
             "timesformer": (1e-5, 1e-5), "resnet50pfs": (1e-5, 1e-3)}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _reg_fill(path, shape, rs):
    if path[-1] in ("conv_kernel", "cls_token"):  # ECA's taps, cls tokens
        return rs.standard_normal(shape)
    return _fill(path, shape, rs)


@functools.lru_cache(maxsize=None)
def jax_case(name):
    """JAX's ``build_reg_model`` at the tiny overrides on seeded inputs, in
    one compile: (variables, clips, targets, eval output, train loss,
    gradients, new batch stats), numpy; float64 for ``FLOAT64``."""
    rs = np.random.RandomState(1)
    clips = rs.rand(V, B, HW, HW, T)
    targets = rs.uniform(20, 80, B)
    wide = name in FLOAT64
    ftype = np.float64 if wide else np.float32
    jm, adapter = j_build(name, V, dtype="float64" if wide else "float32",
                          **cli.TINY_REG[name])
    with jax.enable_x64(wide):
        x = adapter(jnp.asarray(clips, ftype))
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x,
                                                False))
        vrs = np.random.RandomState(3)
        v = jax.tree_util.tree_map_with_path(
            lambda p, s: _reg_fill(tuple(k.key for k in p), s.shape,
                                   vrs).astype(np.float32).astype(ftype),
            {k: s for k, s in shapes.items()
             if k in ("params", "batch_stats")})

        def loss_fn(params, stats):
            out, upd = jm.apply({"params": params, "batch_stats": stats}, x,
                                True, mutable=["batch_stats"])
            pred = out[0] if isinstance(out, tuple) else out
            return jnp.mean((pred[..., 0] - targets.astype(ftype)) ** 2), upd

        def run(v):
            ev = jm.apply(v, x, False)
            (loss, upd), g = jax.value_and_grad(loss_fn, has_aux=True)(
                v["params"], v.get("batch_stats", {}))
            return ev, loss, g, upd.get("batch_stats", {})

        # XLA's float64 convolutions run 20× faster under its full
        # optimization, which outweighs the longer compile (13.5 s against
        # 25 s on one core); the float32 references' compile dominates
        opts = None if wide else FAST_COMPILE
        out = jax.device_get(jax.jit(run, compiler_options=opts)(v))
    return (v, clips.astype(ftype), targets.astype(ftype)) + tuple(out)


def port_model(name, variables, dtype=torch.float32):
    m, adapter = build_reg_model(name, V, **cli.TINY_REG[name])
    m.load_state_dict(reg_state_dict_from_jax(variables, name))
    return m.to(dtype), adapter


@pytest.mark.parametrize("name", NAMES)
def test_reg_eval_matches_jax(name):
    """The eval forward (Resnet50PFS's seg maps too), the port in float32."""
    v, clips, _, ev, *_ = jax_case(name)
    m, adapter = port_model(name, v)
    m.eval()
    with torch.no_grad():
        out = m(adapter(torch.from_numpy(clips).float()))
    if name == "resnet50pfs":
        out, seg = out
        ev, jseg = ev
        assert seg.shape == (B * V, 1, T // 4, HW // 4, HW // 4)
        assert _rel(seg.movedim(1, -1).numpy(), jseg) <= EVAL_TOL
    assert out.shape == ev.shape == (B, 1)
    assert _rel(out.numpy(), ev) <= EVAL_TOL, _rel(out.numpy(), ev)


@pytest.mark.parametrize("name", NAMES)
def test_reg_train_step_matches_jax(name):
    """One train step's MSE loss, every parameter's gradient and the BN
    running statistics (torch's unbiased variance: n / (n − 1) × flax's
    batch term), within ``TRAIN_TOL``."""
    v, clips, targets, _, jl, jg, jstats = jax_case(name)
    dtype = torch.float64 if name in FLOAT64 else torch.float32
    m, adapter = port_model(name, v, dtype)
    counts = {}
    for mod_name, mod in m.named_modules():
        if isinstance(mod, torch.nn.BatchNorm3d):
            mod.register_forward_hook(
                lambda mod, args, out, k=mod_name: counts.__setitem__(
                    k, args[0].numel() // args[0].shape[1]))
    m.train()
    out = m(adapter(torch.from_numpy(clips)))
    pred = (out[0] if isinstance(out, tuple) else out)[..., 0]
    loss = torch.mean((pred - torch.from_numpy(targets)) ** 2)
    loss.backward()
    loss_tol, tol = TRAIN_TOL[name]
    assert abs(loss.item() - float(jl)) <= loss_tol * abs(float(jl))

    want = reg_state_dict_from_jax({"params": jg, "batch_stats": jstats},
                                   name)
    grads = dict(m.named_parameters())
    assert set(grads) <= set(want)
    for pname, p in grads.items():
        g, ref = p.grad.numpy(), want[pname].numpy()
        scale = np.abs(ref).max()
        owner = pname.rsplit(".", 1)[0] + ".weight"
        if pname.endswith(".bias") and owner in want:
            scale = max(scale, np.abs(want[owner].numpy()).max())
        assert np.abs(g - ref).max() <= tol * scale, (
            pname, np.abs(g - ref).max() / scale)

    old = reg_state_dict_from_jax(v, name)
    assert bool(counts) == (name != "timesformer")  # it has no BN
    for bn, n in counts.items():
        mean, var = (getattr(m.get_submodule(bn), f"running_{k}").detach()
                     .numpy() for k in ("mean", "var"))
        jmean, jvar = (want[f"{bn}.running_{k}"].numpy()
                       for k in ("mean", "var"))
        base = 0.9 * old[f"{bn}.running_var"].numpy()
        scale = np.abs(jvar).max()
        assert np.abs(mean - jmean).max() <= 1e-4 * np.abs(jmean).max()
        assert np.abs((var - base) - (jvar - base) * n / (n - 1)).max() \
            <= 1e-4 * scale, bn


@pytest.mark.parametrize("name", NAMES)
def test_reg_bf16_outputs(name):
    """--dtype bfloat16: finite outputs of that type (not held against
    JAX, as with the zoo)."""
    torch.manual_seed(0)
    m, adapter = build_reg_model(name, V, dtype="bfloat16",
                                 **cli.TINY_REG[name])
    m.eval()
    clips = torch.rand(V, 1, HW, HW, T)
    with torch.no_grad():
        out = m(adapter(clips))
    for t in out if isinstance(out, tuple) else (out,):
        assert t.dtype == torch.bfloat16
        assert torch.isfinite(t).all()
    assert (out[0] if isinstance(out, tuple) else out).shape == (1, 1)


def test_build_reg_model_names():
    assert REG_ARCHS == NAMES
    with pytest.raises(ValueError, match="unknown regression model"):
        build_reg_model("resnet18", V)
    with pytest.raises(ValueError, match="no mapping"):
        reg_state_dict_from_jax({"params": {}}, "unet")


# ------------------------------------------------------------- the data

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """One synthetic corpus written by the port's generator (10 patients:
    7 train, 1 val), with one patient's mPAP NaN, another's Vmax missing
    and a third's view 3 missing; both packages read it."""
    cfg = tiny_config()
    root = tmp_path_factory.mktemp("reg_corpus")
    data = dataclasses.replace(cfg.data, synthetic_num_patients=10)
    paths = generate_synthetic_dataset(root, data, seed=5)
    infos = np.load(paths["infos"], allow_pickle=True).item()
    infos["p001"]["mPAP"] = float("nan")
    infos["p002"]["Vmax"] = None
    infos["p004"]["views_images"]["3"] = None
    np.save(paths["infos"], infos)
    return paths


def _loaders(paths, label, is_train, split="train_list.npy"):
    ids = jinfos.load_split(Path(paths["data_list_dir"]) / split)
    jcfg, pcfg = j_tiny_config(), tiny_config()
    j = jpipe.RegressionClipLoader(
        jinfos.PatientIndex.from_infos(jinfos.load_infos(paths["infos"]),
                                       jcfg.data.use_data),
        ids, jcfg.model.views, jcfg, is_train=is_train, label_type=label,
        seed=11)
    p = ppipe.RegressionClipLoader(
        pinfos.PatientIndex.from_infos(pinfos.load_infos(paths["infos"]),
                                       pcfg.data.use_data),
        ids, pcfg.model.views, pcfg, is_train=is_train, label_type=label,
        seed=11)
    return j, p


@pytest.mark.parametrize("label", ["mPAP", "Vmax"])
def test_reg_loader_matches_jax(corpus, label):
    """Train (two epochs' shuffles, the last short batch dropped) and eval
    (the last batch short) batches equal JAX's bit for bit; patients whose
    target is NaN or missing are skipped; a missing view is zeros."""
    for is_train in (True, False):
        j, p = _loaders(corpus, label, is_train)
        assert p.ids == j.ids
        skipped = {"mPAP": "p001", "Vmax": "p002"}[label]
        assert skipped not in p.ids and len(p.ids) == 6
        for epoch in (0, 1) if is_train else (0,):
            jb = list(j.batches(4, epoch))
            pb = list(p.batches(4, epoch))
            assert len(pb) == len(jb) == (1 if is_train else 2)
            for a, b in zip(jb, pb):
                for k in ("clips_raw", "targets"):
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])
        shapes = [b["clips_raw"].shape for b in p.batches(4)]
        assert shapes[0] == (3, 4, 40, 40, 8)
    missing = p.ids.index("p004")
    batch = np.concatenate([b["clips_raw"] for b in p.batches(4)], axis=1)
    assert not batch[1, missing].any() and batch[0, missing].any()


def test_reg_crops_match_jax():
    """The eval crop equals JAX's bit for bit at (R − c) // 2, also where
    it is not MONAI's centre rule (R 40, c 31); the train crop at the
    offsets JAX draws equals JAX's, one window a sample for every view and
    frame."""
    rs = np.random.RandomState(4)
    raw = rs.randint(0, 256, (3, 4, 40, 40, 6)).astype(np.float32)
    for c in (32, 31):
        ref = np.asarray(jpipe.preprocess_regression_batch(
            jax.random.PRNGKey(0), jnp.asarray(raw), crop_hw=c,
            is_train=False))
        got = ppipe.preprocess_regression_batch(
            torch.from_numpy(raw), crop_hw=c, is_train=False).numpy()
        np.testing.assert_array_equal(got, ref)
    key = jax.random.PRNGKey(9)
    ref = np.asarray(jpipe.preprocess_regression_batch(
        key, jnp.asarray(raw), crop_hw=31, is_train=True))
    offsets = []
    for k in jax.random.split(key, 4):  # JAX's draws, as crop_one makes them
        kh, kw = jax.random.split(k, 2)
        offsets.append([int(jax.random.randint(kh, (), 0, 10)),
                        int(jax.random.randint(kw, (), 0, 10))])
    got = ppipe.preprocess_regression_batch(
        torch.from_numpy(raw), crop_hw=31, is_train=True,
        offsets=torch.tensor(offsets)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert len({tuple(o) for o in offsets}) > 1
    gen = torch.Generator().manual_seed(0)
    drawn = ppipe.preprocess_regression_batch(
        torch.from_numpy(raw), crop_hw=31, is_train=True, generator=gen)
    assert drawn.shape == (3, 4, 31, 31, 6) and float(drawn.max()) <= 1.0


def test_scores_match_jax():
    rs = np.random.RandomState(2)
    t = rs.uniform(20, 80, 9).astype(np.float32)
    p = t + rs.standard_normal(9).astype(np.float32) * 5
    p[3] = p[4]  # a tie in prediction
    t[5] = t[6]  # a pair that is not comparable
    for fn in ("mse", "mae", "rmse", "r2", "c_index"):
        for y, q in ((t, p), (torch.from_numpy(t), torch.from_numpy(p))):
            np.testing.assert_allclose(
                float(getattr(pscores, fn)(y, q)),
                float(getattr(jscores, fn)(t, p)), rtol=1e-6, err_msg=fn)
    const = np.full(4, 3.0, np.float32)
    for q in (const, const + 1):  # sklearn's constant-target edge
        assert float(pscores.r2(const, q)) == float(jscores.r2(const, q))
    labels = (rs.rand(3, 1, 5, 5) > 0.5).astype(np.int32)
    labels[1] = 0  # empty ground truth of class 1: left out of the mean
    logits = rs.standard_normal((3, 2, 5, 5)).astype(np.float32)
    np.testing.assert_allclose(
        float(pscores.dice_score_binary(labels, logits)),
        float(jscores.dice_score_binary(labels, logits)), rtol=1e-6)


# ------------------------------------------------------------- the traps

def test_geglu_uses_the_tanh_gelu():
    """flax ``nn.gelu`` is the tanh approximation by default; the port's
    GEGLU equals JAX's, and torch's exact GELU would not."""
    rs = np.random.RandomState(0)
    x = rs.standard_normal((2, 5, 8)).astype(np.float32) * 3
    jm = jtimesformer.GEGLUFeedForward(8, mult=2)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    m = timesformer.GEGLUFeedForward(8, mult=2)
    sd = reg_state_dict_from_jax(jax.device_get(variables), "timesformer")
    m.load_state_dict(sd)
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        y, gates = m.fc1(torch.from_numpy(x)).chunk(2, dim=-1)
        exact = m.fc2(y * torch.nn.functional.gelu(gates)).numpy()
    assert np.abs(exact - ref).max() > 1e-3


def test_seg_deconv_taps_are_flipped():
    """Resnet50PFS's ``seg_deconv`` is a flax ``ConvTranspose``, which does
    not flip its kernel; torch's ``ConvTranspose3d`` does, so the converter
    flips the taps. A kernel whose taps all differ pins it."""
    cin, cout = 2, 3
    k = np.arange(8 * cin * cout, dtype=np.float32).reshape(
        2, 2, 2, cin, cout) / 10 - 2
    bias = np.linspace(-1, 1, cout).astype(np.float32)
    x = np.random.RandomState(0).rand(1, 2, 3, 2, cin).astype(np.float32)
    layer = fnn.ConvTranspose(cout, (2, 2, 2), strides=(2, 2, 2),
                              padding="VALID")
    ref = np.asarray(layer.apply({"params": {"kernel": k, "bias": bias}}, x))
    sd = reg_state_dict_from_jax(
        {"params": {"seg_deconv": {"kernel": k, "bias": bias}}},
        "resnet50pfs")
    conv = torch.nn.ConvTranspose3d(cin, cout, 2, stride=2)
    conv.load_state_dict({"weight": sd["seg_deconv.weight"],
                          "bias": sd["seg_deconv.bias"]})
    with torch.no_grad():
        got = conv(torch.from_numpy(x).movedim(-1, 1)).movedim(1, -1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    with torch.no_grad():  # the same weights unflipped are wrong
        conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            np.transpose(k, (3, 4, 0, 1, 2)))))
        wrong = conv(torch.from_numpy(x).movedim(-1, 1)).movedim(1, -1)
    assert np.abs(wrong.numpy() - ref).max() > 0.1


def test_eca_convolves_over_channels():
    """ECA's flax (k, 1, 1) kernel is a same-padded 1-D conv over the
    CHANNEL axis of the pooled vector: with taps that all differ the port
    equals JAX, and the taps reversed do not."""
    rs = np.random.RandomState(0)
    x = rs.standard_normal((2, 3, 2, 2, 6)).astype(np.float32)  # NDHWC
    w = np.array([0.5, -1.0, 2.0], np.float32).reshape(3, 1, 1)
    ref = np.asarray(jresnet3d.ECALayer(3).apply(
        {"params": {"conv_kernel": w}}, jnp.asarray(x)))
    eca = resnet3d.ECALayer(3)
    sd = reg_state_dict_from_jax({"params": {"eca": {"conv_kernel": w}}},
                                 "resnet50pah")
    assert sd["eca.conv.weight"].shape == (1, 1, 3)
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        eca.conv.weight.copy_(sd["eca.conv.weight"])
        got = eca(xt).permute(0, 2, 3, 4, 1).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        eca.conv.weight.copy_(sd["eca.conv.weight"].flip(-1))
        assert np.abs(eca(xt).permute(0, 2, 3, 4, 1).numpy()
                      - ref).max() > 1e-2


def test_resnet3d_stem_pads_t_over_2():
    """ResNet3D's stem pads (t // 2, 3, 3), not 3 on every side: with a
    (5, 7, 7) stem and no max-pool (JAX's fields) the pooled features equal
    JAX's, a clip whose frames differ."""
    rs = np.random.RandomState(6)
    x = rs.rand(1, 6, 16, 16, 2).astype(np.float32)  # NDHWC
    jm = jresnet3d.ResNet3D(depth=10, widths=(4, 4, 4, 4), conv1_t_size=5,
                            no_max_pool=True)
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: _reg_fill(tuple(k.key for k in p), a.shape,
                               rs).astype(np.float32),
        {k: a for k, a in jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.asarray(x))).items()})
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    m = resnet3d.ResNet3D(2, depth=10, widths=(4, 4, 4, 4), conv1_t_size=5,
                          no_max_pool=True).eval()
    m.load_state_dict(reg_state_dict_from_jax(v, "resnet50pah"))
    assert m.conv1.padding == (2, 3, 3)
    with torch.no_grad():
        got = m(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).numpy()
    assert _rel(got, ref) <= EVAL_TOL


def test_stem_pool_pads_with_minus_inf():
    """flax ``max_pool`` pads with −inf: on negative inputs the border
    windows keep their own maximum, which a zero pad would replace."""
    x = -1 - np.random.RandomState(0).rand(1, 5, 6, 7, 2).astype(np.float32)
    ref = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3, 3), strides=(2,) * 3,
                                  padding=((1, 1),) * 3))
    got = resnet3d.max_pool_stem(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(), ref)
    assert ref.max() < 0


# -------------------------------------------------------------- the CLI

def test_cli_regression_flags_match_jax():
    """--mode, --reg-model and --label-type take JAX's choices and
    defaults."""
    ours = {a.dest: a for a in cli.build_parser()._actions}
    theirs = {a.dest: a for a in jcli.build_parser()._actions}
    for dest in ("reg_model", "label_type"):
        assert ours[dest].choices == theirs[dest].choices
        assert ours[dest].default == theirs[dest].default
    assert {"reg-train", "reg-val"} <= set(ours["mode"].choices)
    with pytest.raises(SystemExit, match="no reference checkpoint"):
        cli.main(["--mode", "reg-val", "--tiny", "--platform", "cpu",
                  "--torch-ckpt", "x.pth"])


def _run(argv) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return buf.getvalue().splitlines()


def test_cli_reg_train_then_val(corpus, tmp_path):
    """A tiny ``--mode reg-train`` writes a checkpoint an epoch; ``reg-val``
    restores the newest and scores what reg-train scored; on an empty save
    directory it says so and scores fresh weights. The last line is strict
    JSON."""
    common = ["--tiny", "--platform", "cpu", "--reg-model", "r2plus1d",
              "--data-root", corpus["root"], "--label-type", "Vmax",
              "--log-dir", str(tmp_path / "log")]
    trained = _run(["--mode", "reg-train", "--save-dir",
                    str(tmp_path / "ckpt")] + common)
    assert sum("reg epoch" in ln for ln in trained) == 2
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "net_00000.pth", "net_00001.pth", "state_00000.pth",
        "state_00001.pth"]
    scored = _run(["--mode", "reg-val", "--save-dir",
                   str(tmp_path / "ckpt")] + common)
    assert "scoring the checkpoint of epoch 1" in scored[-2]
    last = json.loads(scored[-1])
    assert set(last) == {"label", "mse", "mae", "rmse", "r2"}
    assert last == json.loads(trained[-1]) and last["label"] == "Vmax"
    fresh = _run(["--mode", "reg-val", "--save-dir",
                  str(tmp_path / "none")] + common)
    assert "no checkpoint found" in fresh[-2]
    assert json.loads(fresh[-1])["mse"] != last["mse"]
