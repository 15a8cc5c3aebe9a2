"""The port's library segmenters (``models/segmentation.py``) against JAX's.

JAX's ``tests/test_segmentation.py`` sizes (``_TINY``) on 2 frames of 16²
(3 channels for ``plain``, 1 for the others), weights random from a seed
through
``utils/convert.segmentation_state_dict_from_jax``. JAX runs in float64
(its ``ResNetIEKD`` and ``DeepLabHead`` made with ``dtype='float64'``, its
ASPP's float32 accumulations in float64), one jitted program a ctor with
the eval outputs, the train-mode loss, its gradients and the BatchNorm
update (the eval-only ``iekd``: the first alone), traced here and compiled
and run on a background thread while the next traces (the first eval
test starts the file's selected ctors). At 16² f4 is 4², where
every ASPP rate sums its in-bounds taps (JAX's float32 tap accumulator,
taken where only some rates do, would round a float64 run). JAX's graph
holds one backbone call a frame, so the multi-frame models take two
support frames, not the reference's three, through the first two stages
of the backbone (f4 is their output, 4² again): two supports still fix
the order of the attended maps in the concatenation and of the BatchNorm
updates, and the attention sees the same token grid.

* eval: every output of the port in float32 within the zoo's ``EVAL_TOL``
  in relative norm;
* train, both in float64: the outputs, the loss (a BCE-sum of ``out``
  plus a fixed random linear functional of every other output, so each
  head has a gradient) and every gradient within ``TRAIN_TOL``; the
  running means as JAX's, the running variances as JAX's times the
  n/(n − 1) of each BatchNorm's batch (flax's is biased, torch's not),
  after one update (single frame) or one a frame (the reference, then the
  supports, through the one backbone). Neither package can switch the
  heads' dropout of 0.5 off, so the port applies the mask JAX drew: JAX's
  ``Dropout`` runs on ones (its own mask, scaled by 1/keep) inside an
  interceptor that returns the input times it and sows it.
"""

from __future__ import annotations

import functools
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (FAST_COMPILE, compile_and_run,  # noqa: F401
                                one_torch_thread)
from _torch_port_zoo_common import (EVAL_TOL, TRAIN_TOL, _einsum64, _rel,
                                    _random_variables)
from glfusion_tpu.models import aspp as jaspp
from glfusion_tpu.models import resnet as jresnet
from glfusion_tpu.models import segmentation as jseg
from glfusion_tpu.train.losses import bce_with_logits_sum as j_bce
from glfusion_tpu_torch.models import segmentation as pseg
from glfusion_tpu_torch.train.losses import bce_with_logits_sum
from glfusion_tpu_torch.utils.convert import segmentation_state_dict_from_jax

_TINY = dict(stem_width=4, block_sizes=(1, 1, 1, 1), widths=(2, 4, 6, 8),
             aspp_rates=(2, 4, 6), aspp_channels=8)
_TINY_MULTI = dict(_TINY, block_sizes=(1, 1), widths=(2, 4))
HW, BATCH, SUPPORTS = 16, 2, 2
CTORS = {"plain": "deeplabv3_resnet50", "iekd": "deeplabv3_resnet50_iekd",
         "project": "deeplabv3_resnet50_iekd_project",
         "maxmod": "deeplabv3_resnet50_iekd_maxmod",
         "mltfrm": "deeplabv3_resnet50_mltfrm",
         "mltfrm_spatatt": "deeplabv3_resnet50_mltfrm_spatatt"}
MULTI = ("mltfrm", "mltfrm_spatatt")
TRAINED = ("plain", "project", "maxmod") + MULTI
KEYS = {"plain": {"out", "ctr_feat", "feat_mid"},
        "iekd": {"out", "x_layerbs", "x_layer1", "x_layer4", "maskfeat"},
        "project": {"out", "x_layerbs", "x_layer1", "x_layer4"},
        "maxmod": {"out", "xtest_layer1code"},
        "mltfrm": {"out"}, "mltfrm_spatatt": {"out"}}
BN_MOMENTUM = 0.9  # flax's, torch's 0.1


def _kw(name):
    return _TINY_MULTI if name in MULTI else _TINY


def _inputs(name):
    rs = np.random.RandomState(3)
    x = rs.rand(BATCH, HW, HW, 3 if name == "plain" else 1)
    sups = [rs.rand(BATCH, HW, HW, 1) for _ in range(SUPPORTS)] \
        if name in MULTI else []
    return rs, x, sups


def _dropout_as_mask(next_fun, args, kwargs, context):
    """flax ``Dropout``: its own mask (drawn from the ``dropout`` stream,
    on ones) times the input, the mask sown as ``intermediates``."""
    if isinstance(context.module, fnn.Dropout) and \
            context.method_name == "__call__":
        x = args[0]
        m = next_fun(jnp.ones_like(x), *args[1:], **kwargs)
        context.module.sow("intermediates", "mask", m)
        return x * m
    return next_fun(*args, **kwargs)


def _loss(out, masks, probes, bce):
    """BCE-sum of ``out`` plus Σ ⟨output, probe⟩ over the other outputs."""
    loss = bce(out["out"], masks)
    for k in sorted(probes):
        loss = loss + (out[k] * probes[k]).sum()
    return loss


_CASES: dict = {}


def start_references(names) -> None:
    """Trace and lower each ctor's reference not started yet, in order;
    each compiles and runs on the background thread while the next traces
    (``compile_and_run``)."""
    for name in names:
        if name not in _CASES:
            _CASES[name] = _start(name)


def jax_case(name):
    """JAX in float64, one compile: (variables, x, supports, masks,
    probes, eval outputs, train outputs, loss, gradients, updated batch
    stats, dropout mask), numpy; the train part None for ``iekd``."""
    start_references([name])
    return _CASES[name].result()


def _start(name):
    rs, x, sups = _inputs(name)
    f64 = dict(dtype="float64")
    with mock.patch.object(jseg, "ResNetIEKD",
                           functools.partial(jresnet.ResNetIEKD, **f64)), \
            mock.patch.object(jseg, "DeepLabHead",
                              functools.partial(jaspp.DeepLabHead, **f64)), \
            mock.patch.object(jnp, "einsum", _einsum64), \
            jax.enable_x64(True):
        jm = getattr(jseg, CTORS[name])(**_kw(name))
        args = (x, sups) if name in MULTI else (x,)
        v = _random_variables(lambda: jm.init(jax.random.PRNGKey(0),
                                              *args, False))
        v = jax.tree_util.tree_map(lambda a: a.astype(np.float64), v)
        shapes = jax.eval_shape(lambda: jm.apply(v, *args, False))
        masks = (rs.rand(*shapes["out"].shape) > 0.7).astype(np.float64)
        probes = {k: rs.standard_normal(s.shape)
                  for k, s in shapes.items() if k != "out"}

        def loss_fn(params):
            with fnn.intercept_methods(_dropout_as_mask):
                out, upd = jm.apply(
                    {"params": params, "batch_stats": v["batch_stats"]},
                    *args, True, mutable=["batch_stats", "intermediates"],
                    rngs={"dropout": jax.random.PRNGKey(5)})
            return _loss(out, masks, probes, j_bce), (out, upd)

        def run(v):
            ev = jm.apply(v, *args, False)
            if name not in TRAINED:
                return ev, None
            return ev, jax.value_and_grad(loss_fn, has_aux=True)(v["params"])

        lowered = jax.jit(run, compiler_options=FAST_COMPILE).lower(v)

    def results(res):
        ev, tr = res
        if tr is None:
            return v, x, sups, masks, probes, ev, None, None, None, None, None
        (loss, (out, upd)), g = tr
        (mask,) = jax.tree_util.tree_leaves(upd["intermediates"])
        return (v, x, sups, masks, probes, ev, out, float(loss), g,
                upd["batch_stats"], mask)
    return compile_and_run(lowered, v, x64=True, then=results)


def _variant(name):
    return "multiframe" if name in MULTI else name


def port_segmenter(name, variables):
    kw = dict(num_supports=SUPPORTS) if name in MULTI else {}
    m = getattr(pseg, CTORS[name])(**_kw(name), **kw)
    m.load_state_dict(segmentation_state_dict_from_jax(variables,
                                                       _variant(name)))
    return m


def _run(m, x, sups, dtype):
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dtype)  # noqa: E731
    return m(t(x), [t(s) for s in sups]) if sups else m(t(x))


@pytest.mark.parametrize("name", list(CTORS))
def test_segmenter_eval_matches_jax(name, request):
    start_references([name] + [
        item.callspec.params["name"] for item in request.session.items
        if getattr(item, "module", None) is request.module
        and item.originalname == "test_segmenter_eval_matches_jax"])
    v, x, sups, _, _, ref, *_ = jax_case(name)
    m = port_segmenter(name, v).eval()
    with torch.no_grad():
        out = _run(m, x, sups, torch.float32)
    assert set(out) == set(ref) == KEYS[name]
    for k in KEYS[name]:
        got = out[k].numpy()
        assert got.shape == ref[k].shape, (k, got.shape, ref[k].shape)
        assert _rel(got, ref[k]) <= EVAL_TOL, (k, _rel(got, ref[k]))


class _Mask(torch.nn.Module):
    """The head's dropout with JAX's drawn mask (NHWC, scaled by 1/keep)."""

    def __init__(self, mask):
        super().__init__()
        self.mask = torch.from_numpy(np.array(mask)).permute(0, 3, 1, 2)

    def forward(self, x):
        return x * self.mask


@pytest.mark.parametrize("name", TRAINED)
def test_segmenter_train_matches_jax(name):
    (v, x, sups, masks, probes, _, jout, jl, jg, jstats,
     jmask) = jax_case(name)
    m = port_segmenter(name, v).double().train()
    m.classifier[0].project[3] = _Mask(jmask)
    before = {k: b.clone() for k, b in m.state_dict().items()
              if k.endswith(("running_mean", "running_var"))}
    batch = {}  # each BatchNorm's n (its input's elements / channels)
    for key, mod in m.named_modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.register_forward_pre_hook(
                lambda mod, a, key=key: batch.__setitem__(
                    key, a[0].numel() // a[0].shape[1]))
    out = _run(m, x, sups, torch.float64)
    t = {k: torch.from_numpy(p) for k, p in probes.items()}
    loss = _loss(out, torch.from_numpy(masks), t, bce_with_logits_sum)
    loss.backward()
    out_tol, loss_tol, tol = TRAIN_TOL[None]
    assert abs(loss.item() - jl) <= loss_tol * abs(jl)
    for k in KEYS[name]:
        got = out[k].detach().numpy()
        assert got.shape == jout[k].shape, k
        assert _rel(got, jout[k]) <= out_tol, (k, _rel(got, jout[k]))
    want = segmentation_state_dict_from_jax(
        {"params": jg, "batch_stats": v["batch_stats"]}, _variant(name))
    grads = dict(m.named_parameters())
    assert set(grads) == {k for k in want if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))}
    for key, p in grads.items():
        ref = want[key].numpy()
        scale = np.abs(ref).max()
        owner = key.rsplit(".", 1)[0] + ".weight"
        if key.endswith(".bias") and owner in want:  # a bias before a BN
            scale = max(scale, np.abs(want[owner].numpy()).max())
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= tol * scale, (key, err / scale)
    # the BatchNorm update: once a backbone call, JAX's times n/(n-1)
    calls = 1 + SUPPORTS if name in MULTI else 1
    jnew = segmentation_state_dict_from_jax(
        {"params": v["params"], "batch_stats": jstats}, _variant(name))
    state = m.state_dict()
    for key in before:
        mod = key.rsplit(".", 1)[0]
        k = calls if mod.startswith("backbone.") else 1
        assert int(state[f"{mod}.num_batches_tracked"]) == k, mod
        decay = BN_MOMENTUM ** k
        ref = jnew[key].numpy()
        if key.endswith("running_var"):
            n = batch[mod]
            old = before[key].numpy()
            ref = decay * old + (ref - decay * old) * n / (n - 1)
        assert _rel(state[key].numpy(), ref) <= out_tol, (
            key, _rel(state[key].numpy(), ref))


@pytest.mark.parametrize("pin", ["maskfeat_56", "projection_slot",
                                 "in_channels", "no_epsilon"])
def test_segmenter_pins(pin):
    """The contracts JAX's module fixes, on the port alone: ``maskfeat``
    at 56² for a 40² input; ``project``'s ``x_layer4`` (B, 128, 1, 1) of
    unit norm; a frame of the wrong channels raises (plain's stem is
    3-channel, the others' 1); a zero projection divides by a zero norm:
    NaN, as JAX's ``ctr / norm(ctr)``."""
    torch.manual_seed(0)
    x = torch.rand(2, 40, 40, 1)
    if pin == "maskfeat_56":
        with torch.no_grad():
            out = pseg.deeplabv3_resnet50_iekd(**_TINY).eval()(x)
        assert out["maskfeat"].shape == (2, 56, 56, 5)
        assert out["out"].shape == (2, 40, 40, 5)
    elif pin == "projection_slot":
        with torch.no_grad():
            out = pseg.deeplabv3_resnet50_iekd_project(**_TINY).eval()(x)
        assert out["x_layer4"].shape == (2, 128, 1, 1)
        np.testing.assert_allclose(
            torch.linalg.norm(out["x_layer4"][..., 0, 0], dim=-1), 1.0,
            rtol=1e-6)
    elif pin == "in_channels":
        with pytest.raises(ValueError, match="channels"):
            pseg.deeplabv3_resnet50(**_TINY)(x)
        with pytest.raises(ValueError, match="channels"):
            pseg.deeplabv3_resnet50_mltfrm(**_TINY)(x, [x.repeat(
                1, 1, 1, 3)] * 3)
        assert pseg.deeplabv3_resnet50(**_TINY).backbone.init_block[
            0].weight.shape[1] == 3
    else:
        m = pseg.deeplabv3_resnet50(**_TINY).eval()
        with torch.no_grad():
            m.ctr_fc2.weight.zero_()
            m.ctr_fc2.bias.zero_()
            out = m(x.repeat(1, 1, 1, 3))
        assert torch.isnan(out["ctr_feat"]).all()
