"""The options of the JAX package's recorded training configuration in the
port, against the JAX package on the CPU: one train step each under
``cycle_light`` with ``remat``, ``fuse_passes``, and ``grad_accum`` with
``remat`` on the cycle pass only; remat against no remat in the port; and
the CLI's flags and exclusions.

The steps are the packages' own ``make_train_step`` around the smallest
model that has what the options act on, per view: the IEKD stem and one
bottleneck (rematted when asked), whose output is ``f4_global``, and a
head (1×1 conv + BN) whose logits, upsampled, are ``mask``. Both packages
give the model JAX's ``features_only`` and ``sup_count`` contract; the
flagship's own forms are held against its plain forward in
test_torch_port_model.py.
(JAX compiles the tiny flagship's whole step in about a minute on one
core.) Same numpy inputs through both packages; tolerances are stated.
"""

from __future__ import annotations

import dataclasses

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
from glfusion_tpu.ops.resize import resize_bilinear as j_resize_bilinear
from glfusion_tpu.train.step import make_train_step as j_make_train_step
from glfusion_tpu.train.train_state import TrainState
from glfusion_tpu_torch import cli
from glfusion_tpu_torch import config as pconfig
from glfusion_tpu_torch.models.resnet import ResNetIEKD
from glfusion_tpu_torch.ops.resize import resize_bilinear_nchw
from glfusion_tpu_torch.train.step import make_train_step
from glfusion_tpu_torch.utils.convert import _view

VIEWS = ("1", "3", "4")
C = 8  # stem width = the bottleneck's output (width 2, expansion 4)
ARCH = dict(stem_width=C, block_sizes=(1,), widths=(C // 4,),
            dilate_stages=(False,))
TOL = dict(atol=2e-4, rtol=2e-4)


class _JHead(fnn.Module):
    @fnn.compact
    def __call__(self, x, train):
        y = fnn.Conv(5, (1, 1), name="conv")(x)
        return fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                             epsilon=1e-5, name="bn")(y)


class _JNet(fnn.Module):
    remat: bool = False
    dtype: str = "float32"

    @fnn.compact
    def __call__(self, x, train=False, features_only=False, sup_count=None):
        f = _per_view(JResNetIEKD)(**ARCH, remat=self.remat, dtype=self.dtype,
                                   name="backbone")(x, train)
        if features_only:
            return {"f4_global": f}
        cyc = f
        if sup_count is not None:
            f, cyc = f[:, :sup_count], f[:, sup_count:]
        logits = _per_view(_JHead)(name="head")(f, train)
        return {"mask": j_resize_bilinear(logits, x.shape[2:4]),
                "f4_global": cyc}


class _Net(torch.nn.Module):
    def __init__(self, remat: bool):
        super().__init__()
        self.backbone = torch.nn.ModuleDict(
            {v: ResNetIEKD(**ARCH, remat=remat) for v in VIEWS})
        self.head = torch.nn.ModuleDict(
            {v: torch.nn.Sequential(torch.nn.Conv2d(C, 5, 1),
                                    torch.nn.BatchNorm2d(5)) for v in VIEWS})

    def forward(self, x, features_only=False, sup_count=None):
        f = torch.stack([self.backbone[v](x[i].permute(0, 3, 1, 2)
                                          .contiguous())
                         for i, v in enumerate(VIEWS)])  # (V, B, C, h, w)
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
    the variables' own type (float32 or float64)."""
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
    return sd


# case → (TrainConfig fields, model remat, the BN updates a step makes in
# (backbone, head), the type JAX's step runs in: float64 where its step
# can, float32 under grad_accum, whose scan carries a float32 loss).
# cycle_light rematerializes, as bench.py's recorded cycle-light step does.
STEP_CASES = {
    "cycle_light": (dict(cycle_light=True), True, (2, 1), np.float64),
    "fuse_passes": (dict(fuse_passes=True), False, (1, 1), np.float64),
    "grad_accum_2": (dict(grad_accum=2, remat_supervised=False), True,
                     (3, 3), np.float32),
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
    (gradients that cancel to noise) against their weight's max|g|;
    running means rtol 1e-6. Against JAX in float32 (grad_accum_2):
    losses and counts rtol 1e-3, gradients atol 2e-2·max|g| + rtol 2e-2,
    running means 2e-4. Running variances rtol 2e-3 against float64 JAX:
    torch's unbiased update against flax's biased one (a factor n/(n−1),
    moving the average by at most 0.1/(n−1) = 6.2e-4 a pass at the
    smallest n, 2·9·9); 5e-3 against float32 JAX, whose one-pass variance
    of the clip adds up to 3e-3.
    """
    fields, remat, (n_backbone, n_head), jdt = STEP_CASES[option]
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
    jm = _JNet(remat=remat, dtype=np.dtype(jdt).name)
    twin = (_JNet(dtype=jm.dtype) if remat and not cfg.train.remat_supervised
            else None)
    with jax.enable_x64(jdt == np.float64):
        v = random_variables(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.asarray(batch["images"]), False), 31)
        v = jax.tree_util.tree_map(lambda a: a.astype(jdt), v)
        state = TrainState.create(apply_fn=jm.apply, params=v["params"],
                                  batch_stats=v["batch_stats"],
                                  tx=optax.sgd(1.0))
        jstate, jmet = j_make_train_step(jcfg, jm,
                                         compiler_options=FAST_COMPILE,
                                         sup_model=twin)(
            state, {k: jnp.asarray(a) for k, a in batch.items()},
            jax.random.PRNGKey(1))
        jmet = jax.device_get(jmet)
        want = _port_params(jax.device_get(
            {"params": jstate.params, "batch_stats": jstate.batch_stats}))

    model = _Net(remat).double()
    v0 = {k: t.double() if t.is_floating_point() else t
          for k, t in _port_params(v).items()}
    model.load_state_dict(v0)
    got = make_train_step(cfg, model,
                          torch.optim.SGD(model.parameters(), lr=1.0))(
        {k: torch.from_numpy(a).double() for k, a in batch.items()},
        torch.Generator())
    after = model.state_dict()

    tight = jdt == np.float64
    loss_tol, grad_tol, mean_tol, var_tol = (
        (1e-6, 1e-6, 1e-6, 2e-3) if tight else (1e-3, 2e-2, 2e-4, 5e-3))
    for k in ("loss", "seg_loss", "cyc_loss", "tp", "fp", "fn", "tn"):
        np.testing.assert_allclose(got[k].numpy(), jmet[k], rtol=loss_tol,
                                   err_msg=k)
    assert float(got["cyc_loss"]) > 0
    for k, w in want.items():
        w = w.double() if w.is_floating_point() else w
        if k.endswith("num_batches_tracked"):
            n = n_head if k.startswith("head") else n_backbone
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
            if not (k.endswith("0.bias") and wk in want):
                wk = k  # not a conv bias before a train BN
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


def test_cli_takes_the_options_and_refuses_jax_exclusions():
    """``--dtype``, ``--remat``, ``--cycle-light``, ``--fuse-passes`` and
    ``--grad-accum`` reach the configuration with the JAX CLI's defaults;
    the step refuses what the JAX step refuses."""
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
