"""The options of the JAX package's train step in the port, against the
JAX package on the CPU: one train step each under ``cycle_light`` with
``remat``, ``fuse_passes``, ``grad_accum`` with ``remat`` on the cycle pass
only, ``temporal`` and CPS; ``checkify``'s error on a NaN; remat against
no remat in the port; and the CLI's flags and exclusions.

The steps are the packages' own ``make_train_step`` around the smallest
model that has what the options act on, per view: the IEKD stem and one
bottleneck (rematted when asked), whose output is ``f4_global``, and a
head (1×1 conv + BN) whose logits, upsampled, are ``mask``. For
``temporal`` a TPAVI block attends over the bottleneck's output and gives
``f4_global`` (its frames folded into the tokens under ``is_video``); for
CPS two such models run as ``net1`` and ``net2``. Both packages
give the model JAX's ``features_only`` and ``sup_count`` contract; the
flagship's own forms are held against its plain forward in
test_torch_port_model.py.
(JAX compiles the tiny flagship's whole step in about a minute on one
core.) Same numpy inputs through both packages; tolerances are stated.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_common import (FAST_COMPILE, one_torch_thread,  # noqa: F401
                                random_variables)
from glfusion_tpu import config as jconfig
from glfusion_tpu.models.glfusion import _per_view
from glfusion_tpu.models.resnet import ResNetIEKD as JResNetIEKD
from glfusion_tpu.models.tpavi import TPAVI as JTPAVI
from glfusion_tpu.ops.resize import resize_bilinear as j_resize_bilinear
from glfusion_tpu.train.step import make_train_step as j_make_train_step
from glfusion_tpu.train.train_state import TrainState
from glfusion_tpu_torch import cli
from glfusion_tpu_torch import config as pconfig
from glfusion_tpu_torch.models.glfusion import (GlobalAndLocal,
                                                GlobalAndLocalCPS,
                                                build_model)
from glfusion_tpu_torch.models.resnet import ResNetIEKD
from glfusion_tpu_torch.models.tpavi import TPAVI
from glfusion_tpu_torch.ops.resize import resize_bilinear_nchw
from glfusion_tpu_torch.train.step import make_train_step
from glfusion_tpu_torch.train.trainer import Trainer
from glfusion_tpu_torch.utils.convert import _view, tpavi_state_dict

VIEWS = ("1", "3", "4")
C = 8  # stem width = the bottleneck's output (width 2, expansion 4)
ARCH = dict(stem_width=C, block_sizes=(1,), widths=(C // 4,),
            dilate_stages=(False,))
TOL = dict(atol=2e-4, rtol=2e-4)


class _CPS(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.net1, self.net2 = _Net(), _Net()

    def forward(self, x):
        out1, out2 = self.net1(x), self.net2(x)
        return {"mask": out1["mask"], "mask_2": out2["mask"],
                "f4_global": out1["f4_global"]}


class _JHead(fnn.Module):
    @fnn.compact
    def __call__(self, x, train):
        y = fnn.Conv(5, (1, 1), name="conv")(x)
        return fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                             epsilon=1e-5, name="bn")(y)


class _JNet(fnn.Module):
    remat: bool = False
    dtype: str = "float32"
    attn: bool = False

    @fnn.compact
    def __call__(self, x, train=False, features_only=False, sup_count=None,
                 is_video=False):
        f = _per_view(JResNetIEKD)(**ARCH, remat=self.remat, dtype=self.dtype,
                                   name="backbone")(x, train)
        if self.attn:  # JAX GlobalAndLocal's attend, is_video fold included
            y = jnp.swapaxes(f, 0, 1)
            attn = JTPAVI(inter_channels=C // 2, dtype=self.dtype,
                          name="attn")
            if is_video:
                bb, vv, fh, fw, fc = y.shape
                y = attn(y.reshape(1, bb * vv, fh, fw, fc),
                         train).reshape(bb, vv, fh, fw, fc)
            else:
                y = attn(y, train)
            f = jnp.swapaxes(y, 0, 1)
        if features_only:
            return {"f4_global": f}
        cyc = f
        if sup_count is not None:
            f, cyc = f[:, :sup_count], f[:, sup_count:]
        logits = _per_view(_JHead)(name="head")(f, train)
        return {"mask": j_resize_bilinear(logits, x.shape[2:4]),
                "f4_global": cyc}


class _JCPS(fnn.Module):
    """JAX GlobalAndLocalCPS's form around two _JNet."""
    dtype: str = "float32"

    @fnn.compact
    def __call__(self, x, train=False):
        out1 = _JNet(dtype=self.dtype, name="net1")(x, train)
        out2 = _JNet(dtype=self.dtype, name="net2")(x, train)
        return {"mask": out1["mask"], "mask_2": out2["mask"],
                "f4_global": out1["f4_global"]}


class _Net(torch.nn.Module):
    def __init__(self, remat: bool = False, attn: bool = False):
        super().__init__()
        self.backbone = torch.nn.ModuleDict(
            {v: ResNetIEKD(**ARCH, remat=remat) for v in VIEWS})
        self.head = torch.nn.ModuleDict(
            {v: torch.nn.Sequential(torch.nn.Conv2d(C, 5, 1),
                                    torch.nn.BatchNorm2d(5)) for v in VIEWS})
        self.attn = TPAVI(C, C // 2) if attn else None

    def forward(self, x, features_only=False, sup_count=None,
                is_video=False):
        f = torch.stack([self.backbone[v](x[i].permute(0, 3, 1, 2)
                                          .contiguous())
                         for i, v in enumerate(VIEWS)])  # (V, B, C, h, w)
        if self.attn is not None:  # the flagship's own fold
            y = GlobalAndLocal._attend(self.attn, list(f), is_video)
            f = y.permute(1, 0, 4, 2, 3)
        if features_only:
            return {"f4_global": f.permute(0, 1, 3, 4, 2)}
        cyc = f
        if sup_count is not None:
            f, cyc = f[:, :sup_count], f[:, sup_count:]
        logits = torch.stack([
            resize_bilinear_nchw(self.head[v](f[i]), x.shape[2:4])
            for i, v in enumerate(VIEWS)])
        return {"mask": logits.permute(0, 1, 3, 4, 2),
                "f4_global": cyc.permute(0, 1, 3, 4, 2)}


def _port_params(v) -> dict:
    """JAX stacked per-view variables → the port model's state dict, in
    the variables' own type (float32 or float64); the CPS twin's nets
    under their prefixes."""
    if "net1" in v["params"]:
        return {f"{net}.{k}": t for net in ("net1", "net2")
                for k, t in _port_params({
                    "params": v["params"][net],
                    "batch_stats": v["batch_stats"][net]}).items()}
    def t(a, conv=False):
        a = np.asarray(a)
        return torch.from_numpy((np.transpose(a, (3, 2, 0, 1)) if conv
                                 else a).copy())

    def bn(key, p, s):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = t(p["scale"]), t(p["bias"])
        sd[f"{key}.running_mean"] = t(s["mean"])
        sd[f"{key}.running_var"] = t(s["var"])
        sd[f"{key}.num_batches_tracked"] = torch.tensor(0)

    sd = {}
    for i, view in enumerate(VIEWS):
        p, s = _view(v["params"], i), _view(v["batch_stats"], i)
        bp, bs = p["backbone"], s["backbone"]
        root = f"backbone.{view}"
        sd[f"{root}.init_block.0.weight"] = t(bp["stem_conv"]["kernel"], 1)
        sd[f"{root}.init_block.0.bias"] = t(bp["stem_conv"]["bias"])
        bn(f"{root}.init_block.1", bp["stem_bn"], bs["stem_bn"])
        jp, js = bp["layer1_block0"], bs["layer1_block0"]
        for j in (1, 2, 3):
            sd[f"{root}.layer1.0.conv{j}.weight"] = t(jp[f"conv{j}"]["kernel"],
                                                       1)
            bn(f"{root}.layer1.0.bn{j}", jp[f"bn{j}"], js[f"bn{j}"])
        sd[f"head.{view}.0.weight"] = t(p["head"]["conv"]["kernel"], 1)
        sd[f"head.{view}.0.bias"] = t(p["head"]["conv"]["bias"])
        bn(f"head.{view}.1", p["head"]["bn"], s["head"]["bn"])
    if "attn" in v["params"]:  # float32 (the attention case runs in it)
        sd.update({f"attn.{k}": t for k, t in tpavi_state_dict(
            v["params"]["attn"], v["batch_stats"]["attn"]).items()})
    return sd


# case → (TrainConfig fields, model remat, the BN updates a step makes in
# (backbone and attention, head), the type JAX's step runs in: float64
# where its step can, float32 under grad_accum, whose scan carries a
# float32 loss, and with the attention, whose products JAX returns in
# float32; the model: plain, with the attention, or the CPS twin).
# cycle_light rematerializes, as bench.py's recorded cycle-light step does.
STEP_CASES = {
    "cycle_light": (dict(cycle_light=True), True, (2, 1), np.float64,
                    "plain"),
    "fuse_passes": (dict(fuse_passes=True), False, (1, 1), np.float64,
                    "plain"),
    "grad_accum_2": (dict(grad_accum=2, remat_supervised=False), True,
                     (3, 3), np.float32, "plain"),
    "temporal": (dict(temporal=True), False, (2, 2), np.float32, "attn"),
    "cps": (dict(), False, (2, 2), np.float64, "cps"),
}


@pytest.mark.parametrize("option", list(STEP_CASES))
def test_train_step_option_matches_jax(option):
    """One train step of each package under the option, on the same
    weights and batch (SGD at lr 1, so the update is the gradient): the
    supervised BCE-sum over test views '1' and '4', the dense cycle loss on
    an 8-frame clip of raw 0–255 frames (as the loaders give them), the
    confusion counts, every gradient and every BN running statistic (the
    head's left alone by the cycle pass under cycle_light and fuse_passes;
    remat's recompute moving none: every BN counts its updates).
    ``grad_accum_2`` splits a batch of 4 into two microbatches and runs the
    supervised passes without remat (``remat_supervised=False``, JAX's
    no-remat twin). (JAX's remat is its plain step's math recomputed;
    test_remat_equals_no_remat holds the port's to the same.)
    ``temporal`` attends over the 8 clip frames' 3·h·w tokens at once in
    the cycle pass (per frame in the supervised pass); ``cps`` adds both
    networks' BCE and the cross pseudo-supervision terms (cps_weight 1).

    The port runs in float64, JAX in float64 (under ``jax.enable_x64``)
    where its step can: float32 is ill-conditioned here by design. The
    fused pass's BN moments over 0–1 images and 0–255 clip frames leave
    the images' normalized activations a small difference of large sums
    (some gradients of view '4' lie 25 % from float64 in either package's
    float32 step), and flax's one-pass variance cancels on the clip (JAX's
    cycle-driven gradients lie up to 8.9e-3·max|g| from float64, the
    port's float32 step within 2e-5). Tolerances against JAX in float64:
    losses and counts rtol 1e-6 (JAX's step keeps float32 constants);
    gradients atol 1e-6·max|g| + rtol 1e-6, conv biases before a train BN
    and TPAVI's LayerNorm bias (gradients that cancel to noise: the
    port's float64 one is 5e-13 under ``temporal``, JAX's float32 one
    1.3e-4) against their weight's max|g|;
    running means rtol 1e-6. Against JAX in float32 (grad_accum_2):
    losses and counts rtol 1e-3, gradients atol 2e-2·max|g| + rtol 2e-2,
    running means 2e-4. Running variances rtol 2e-3 against float64 JAX:
    torch's unbiased update against flax's biased one (a factor n/(n−1),
    moving the average by at most 0.1/(n−1) = 6.2e-4 a pass at the
    smallest n, 2·9·9), 1/(2·9·9 − 1) under CPS, the bound that holds for
    any batch variance; 5e-3 against float32 JAX, whose one-pass variance
    of the clip adds up to 3e-3.
    """
    fields, remat, (n_backbone, n_head), jdt, net = STEP_CASES[option]
    train = dict(test_views=("1", "4"), dense_cyc=True, **fields)
    jcfg = jconfig.tiny_config()
    jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train, **train))
    cfg = pconfig.tiny_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, remat=remat),
                      train=dataclasses.replace(cfg.train, **train))
    b = 2 * cfg.train.grad_accum
    rs = np.random.RandomState(30)
    batch = {"images": rs.rand(3, b, 20, 20, 1).astype(jdt),
             "masks": (rs.rand(3, b, 20, 20, 5) > 0.7).astype(jdt),
             "clips": np.round(rs.rand(3, 8, 20, 20, 1) * 255).astype(jdt)}
    jm = (_JCPS(dtype=np.dtype(jdt).name) if net == "cps" else
          _JNet(remat=remat, dtype=np.dtype(jdt).name, attn=net == "attn"))
    twin = (_JNet(dtype=jm.dtype) if remat and not cfg.train.remat_supervised
            else None)
    with jax.enable_x64(jdt == np.float64):
        v = random_variables(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.asarray(batch["images"]), False), 31)
        v = jax.tree_util.tree_map(lambda a: a.astype(jdt), v)
        state = TrainState.create(apply_fn=jm.apply, params=v["params"],
                                  batch_stats=v["batch_stats"],
                                  tx=optax.sgd(1.0))
        jstate, jmet = j_make_train_step(jcfg, jm, cps=net == "cps",
                                         compiler_options=FAST_COMPILE,
                                         sup_model=twin)(
            state, {k: jnp.asarray(a) for k, a in batch.items()},
            jax.random.PRNGKey(1))
        jmet = jax.device_get(jmet)
        want = _port_params(jax.device_get(
            {"params": jstate.params, "batch_stats": jstate.batch_stats}))

    model = (_CPS() if net == "cps" else
             _Net(remat, attn=net == "attn")).double()
    v0 = {k: t.double() if t.is_floating_point() else t
          for k, t in _port_params(v).items()}
    model.load_state_dict(v0)
    got = make_train_step(cfg, model,
                          torch.optim.SGD(model.parameters(), lr=1.0),
                          cps=net == "cps")(
        {k: torch.from_numpy(a).double() for k, a in batch.items()},
        torch.Generator())
    after = model.state_dict()

    tight = jdt == np.float64
    loss_tol, grad_tol, mean_tol, var_tol = (
        (1e-6, 1e-6, 1e-6, 2e-3) if tight else (1e-3, 2e-2, 2e-4, 5e-3))
    if net == "cps":
        # each update adds m·var_b/(n − 1) to torch's average and nothing
        # to flax's, so the relative gap is at most 1/(n_min − 1) whatever
        # the batch variances (2e-3 above assumes var_b near the average;
        # net1's layer1 bn3 reads 2.1e-3 here)
        var_tol = 1 / (2 * 9 * 9 - 1)
    for k in ("loss", "seg_loss", "cyc_loss", "tp", "fp", "fn", "tn"):
        np.testing.assert_allclose(got[k].numpy(), jmet[k], rtol=loss_tol,
                                   err_msg=k)
    assert float(got["cyc_loss"]) > 0
    for k, w in want.items():
        w = w.double() if w.is_floating_point() else w
        if k.endswith("num_batches_tracked"):
            n = n_head if f".{k}".find(".head.") >= 0 else n_backbone
            assert int(after[k]) == n, (k, int(after[k]))
        elif k.endswith("running_var"):
            np.testing.assert_allclose(after[k].numpy(), w.numpy(),
                                       rtol=var_tol, err_msg=k)
        elif k.endswith("running_mean"):
            np.testing.assert_allclose(after[k].numpy(), w.numpy(),
                                       rtol=mean_tol, atol=mean_tol,
                                       err_msg=k)
        else:
            wk = k[:-len("bias")] + "weight"
            if not ((k.endswith("0.bias") or k.endswith("norm_layer.bias"))
                    and wk in want):
                wk = k  # not a conv bias or TPAVI's LayerNorm bias
            scale = np.abs((v0[wk] - want[wk].double()).numpy()).max()
            np.testing.assert_allclose((v0[k] - after[k]).numpy(),
                                       (v0[k] - w).numpy(),
                                       atol=grad_tol * scale, rtol=grad_tol,
                                       err_msg=k)


def test_remat_equals_no_remat():
    """The port's remat recomputes the same math: a forward and backward of
    a rematted backbone gives the gradients of the same backbone without
    remat exactly, and its BN running statistics move once, to the same
    values (the recompute's second update is put back)."""
    torch.manual_seed(0)
    plain = ResNetIEKD(stem_width=8, block_sizes=(2, 1, 1, 1),
                       widths=(2, 4, 6, 8))
    remat = ResNetIEKD(stem_width=8, block_sizes=(2, 1, 1, 1),
                       widths=(2, 4, 6, 8), remat=True)
    remat.load_state_dict(plain.state_dict())
    assert sum(getattr(m, "remat", False) for m in remat.modules()) == 5
    x = torch.rand(3, 1, 24, 24)
    for m in (plain, remat):
        m.train()
        (m(x) ** 2).sum().backward()
    got, want = remat.state_dict(), plain.state_dict()
    for k, t in want.items():
        assert torch.equal(got[k], t), k
        if k.endswith("num_batches_tracked"):
            assert int(t) == 1, k
    for (k, p), q in zip(plain.named_parameters(), remat.parameters()):
        assert torch.equal(p.grad, q.grad), k


def test_cli_takes_the_options_and_refuses_jax_exclusions(tmp_path):
    """``--dtype``, ``--remat``, ``--cycle-light``, ``--fuse-passes`` and
    ``--grad-accum`` reach the configuration with the JAX CLI's defaults;
    ``--variant temporal`` is a train switch on the flagship, ``cps`` the
    twin, the other variants refused; ``--checkify`` reaches the
    configuration; the step, the Trainer and the CLI refuse what JAX's
    do."""
    def cfg_of(*flags):
        return cli.config_from_args(cli.build_parser().parse_args(
            ["--tiny", *flags]))

    base = cfg_of()
    assert (base.model.dtype, base.model.remat, base.train.cycle_light,
            base.train.fuse_passes, base.train.grad_accum) == (
        "float32", False, False, False, 1)
    cfg = cfg_of("--dtype", "bfloat16", "--remat", "--cycle-light",
                 "--grad-accum", "2")
    assert (cfg.model.dtype, cfg.model.remat, cfg.train.cycle_light,
            cfg.train.grad_accum) == ("bfloat16", True, True, 2)
    assert cfg_of("--fuse-passes").train.fuse_passes
    with pytest.raises(SystemExit):
        cfg_of("--dtype", "float16")

    dummy = torch.nn.Linear(1, 1)
    opt = torch.optim.SGD(dummy.parameters(), lr=0.0)
    for flags, match in (
            (("--fuse-passes", "--grad-accum", "2"), "exclusive"),
            (("--grad-accum", "0"), ">= 1")):
        with pytest.raises(ValueError, match=match):
            make_train_step(cfg_of(*flags), dummy, opt)
    twin = cfg_of("--fuse-passes", "--remat")
    twin = twin.replace(train=dataclasses.replace(twin.train,
                                                  remat_supervised=False))
    with pytest.raises(ValueError, match="remat_supervised"):
        make_train_step(twin, dummy, opt)

    cfg = cfg_of("--variant", "temporal", "--checkify")
    assert (cfg.model.variant, cfg.train.temporal, cfg.train.checkify) == (
        "global_and_local", True, True)
    cps = cfg_of("--variant", "cps")
    assert (cps.model.variant, cps.train.temporal) == ("cps", False)
    model, is_cps = build_model(cps.model)
    assert is_cps and isinstance(model, GlobalAndLocalCPS)
    assert not torch.equal(model.net1.global_attn.theta.weight,
                           model.net2.global_attn.theta.weight)
    with pytest.raises(SystemExit):
        cfg_of("--variant", "conv_merge")

    with pytest.raises(ValueError, match="exclusive of CPS/temporal"):
        make_train_step(cfg_of("--variant", "temporal", "--fuse-passes"),
                        dummy, opt)
    with pytest.raises(ValueError, match="exclusive of CPS/temporal"):
        make_train_step(cfg_of("--fuse-passes"), dummy, opt, cps=True)
    for flag, match in (("--cycle-light", "cycle_light requires"),
                        ("--fuse-passes", "fuse_passes requires")):
        with pytest.raises(ValueError, match=match):
            Trainer._check_options(SimpleNamespace(
                cfg=cfg_of("--variant", "cps", flag), cps=True))
    temporal_cps = cps.replace(train=dataclasses.replace(cps.train,
                                                         temporal=True))
    with pytest.raises(ValueError, match="temporal .* requires"):
        Trainer._check_options(SimpleNamespace(cfg=temporal_cps, cps=True))

    run = ["--tiny", "--platform", "cpu", "--save-dir", str(tmp_path / "c"),
           "--log-dir", str(tmp_path / "l")]
    with pytest.raises(SystemExit, match="random-init"):
        cli.main(["--mode", "export", *run])
    with pytest.raises(SystemExit, match="found no weights"):
        cli.main(["--mode", "serve", "--http-port", "0", *run])


def test_checkify_raises_jax_message_on_nan():
    """``checkify``: a clean step passes; a batch with one NaN pixel makes
    both packages' checked steps raise by the flush at the latest, with
    JAX's message (up to the location JAX appends). float32, the _JNet
    model, SGD at lr 1."""
    train = dict(test_views=("1", "4"), dense_cyc=True, checkify=True)
    jcfg = jconfig.tiny_config()
    jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train, **train))
    cfg = pconfig.tiny_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, **train))
    rs = np.random.RandomState(32)
    clean = {"images": rs.rand(3, 2, 20, 20, 1).astype(np.float32),
             "masks": (rs.rand(3, 2, 20, 20, 5) > 0.7).astype(np.float32),
             "clips": np.round(rs.rand(3, 8, 20, 20, 1) * 255).astype(
                 np.float32)}
    bad = dict(clean, images=clean["images"].copy())
    bad["images"][0, 1, 3, 4, 0] = np.nan

    jm = _JNet()
    v = random_variables(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(clean["images"]), False), 31)
    state = TrainState.create(apply_fn=jm.apply, params=v["params"],
                              batch_stats=v["batch_stats"],
                              tx=optax.sgd(1.0))
    jstep = j_make_train_step(jcfg, jm, compiler_options=FAST_COMPILE)
    key = jax.random.PRNGKey(1)
    state, _ = jstep(state, {k: jnp.asarray(a) for k, a in clean.items()},
                     key)
    jstep.checkify_flush()
    jstep(state, {k: jnp.asarray(a) for k, a in bad.items()}, key)
    with pytest.raises(Exception) as jerr:
        jstep.checkify_flush()
    want = str(jerr.value)
    assert want.startswith("non-finite training loss nan"), want

    model = _Net()
    model.load_state_dict(_port_params(v))
    step = make_train_step(cfg, model,
                           torch.optim.SGD(model.parameters(), lr=1.0))
    step({k: torch.from_numpy(a) for k, a in clean.items()},
         torch.Generator())
    step.checkify_flush()
    with pytest.raises(RuntimeError) as err:
        step({k: torch.from_numpy(a) for k, a in bad.items()},
             torch.Generator())
        step.checkify_flush()
    got = str(err.value)
    assert got == want[:len(got)] and want[len(got)] == " ", (got, want)
