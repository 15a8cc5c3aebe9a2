"""Shared helpers of the zoo's parity tests (tests/test_torch_port_zoo*.py):
the JAX references in float64 and the checks each arch runs.

At ``tiny_config()`` widths (stem_width 8: U-Nets 8..128, UTNet base 4,
ResUNet3D 2..32, the legacy kinds' ResNet-IEKD 8..64 with ASPP dropout 0;
CEN has fixed widths; the AVS family ``AVS_MODEL``), 2 views (``_views``:
3 for CEN, ``avs_pred_endecoder`` and the legacy kinds) of 2 frames (3
for the AVS family's 2-view flavours) at 16² (8² for CEN, 32² for UTNet,
whose attention needs a 2² key grid, 34² for the AVS family).
Weights are random numpy arrays made from a seed (every BN with random
statistics, UTNet's position tables and the PReLU slopes random, part of
CEN's bn2 scales under the exchange threshold, TPAVI's W_z BN nonzero) and
go across with ``utils/convert.zoo_state_dict_from_jax``. JAX runs in
float64 (``jax.enable_x64``), once per arch for both checks (``EVAL_ONLY``
archs: eval alone); for CEN, the AVS family and the legacy kinds its large
convolutions run as one product of their taps (``_conv64``), for the
latter two its float32 accumulations in float64 (``_einsum64``):

The first eval test of a file traces and lowers every reference its
file's selected tests ask for (``references_ahead``), in order; each
compiles and runs on a background thread while the next traces.

* ``check_eval``: the adapter's outputs, the port in float32, within 1e-4
  in relative norm of JAX's ``build_seg_model`` adapter.
* ``check_train``: the train-mode forward, the supervised loss (the
  BCE-sum over the views of ``mask`` and of every ``mask_aux`` map) and its
  gradients against ``jax.value_and_grad``, the port in float64
  (tolerances in ``TRAIN_TOL``). ``cen`` (dropout 0.5) and ``res3dunet``
  (0.2) cannot share a random stream with JAX, so they are held at module
  level without dropout (``CENRefineNet(dropout=0)`` with one block a
  stage, ``ResUNet3D(drop_rate=0)``); JAX's CEN there takes its StreamBN
  moments in float64 (``_StreamBN64``). ``avs_pred_endecoder`` is
  trained at module level on one (main, other) pair, its ring of pairs
  held in eval, as its adapter-level reference costs three times the
  compile.
"""

from __future__ import annotations

import dataclasses
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port_common import (FAST_COMPILE, _fill, compile_and_run,
                                init_shapes)
from glfusion_tpu.config import ModelConfig as JModelConfig
from glfusion_tpu.models import avs as javs
from glfusion_tpu.models import cen as jcen
from glfusion_tpu.models.registry import build_seg_model as j_build
from glfusion_tpu.models.res3dunet import ResUNet3D as JResUNet3D
from glfusion_tpu.train import losses as jlosses
from glfusion_tpu_torch.config import tiny_config
from glfusion_tpu_torch.models import build_model
from glfusion_tpu_torch.models import cen as pcen
from glfusion_tpu_torch.models.avs import PredEndecoder, b2_stage_hw
from glfusion_tpu_torch.models.res3dunet import ResUNet3D
from glfusion_tpu_torch.models.tpavi import TPAVI
from glfusion_tpu_torch.train.losses import bce_with_logits_sum
from glfusion_tpu_torch.utils.convert import zoo_state_dict_from_jax

TINY = tiny_config()
EVAL_TOL = 1e-4  # relative norm, the port's float32 against float64


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _zoo_fill(path, shape, rs):
    name = path[-1]
    if name == "table":  # UTNet's relative position bias: make it count
        return rs.standard_normal(shape) * 0.5
    if name == "alpha":  # PReLU slopes, CEN's ensemble logits
        return rs.uniform(0.1, 0.9, shape)
    if name == "scale" and len(shape) == 2:  # CEN's StreamBN: some
        # channels under the 2e-2 exchange threshold, so streams swap
        s = rs.uniform(0.5, 1.5, shape)
        return np.where(rs.rand(*shape) < 0.3, s * 0.01, s)
    return _fill(path, shape, rs)


def _random_variables(init_fn, seed: int = 0):
    shapes = init_shapes(init_fn)
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: _zoo_fill(tuple(k.key for k in p), s.shape, rs).astype(
            np.float32),
        {k: v for k, v in shapes.items() if k in ("params", "batch_stats")})


# the AVS family: widths (2, 4, 6, 8) (bottleneck outputs 8..32), one
# block a stage, channel 8 (``aspp_channels``), at 34²: the decoder's
# output is 36², so the adapter's final resize and the non-integer
# align_corners upsamples run; the legacy kinds: tiny_config() widths, ASPP
# dropout 0 (trained at adapter level)
AVS_MODEL = dict(widths=(2, 4, 6, 8), block_sizes=(1, 1, 1, 1),
                 aspp_channels=8)
LEGACY_MODEL = dict(aspp_dropout=0.0)


def _views(arch):
    """CEN's views are its exchange streams: 3, for the ring, and so for
    ``avs_pred_endecoder``'s (its ring neighbour is not symmetric at 3)
    and the legacy kinds; the other archs' views are independent but for
    multiview_unet's TPAVI: 2. The AVS family's per-view loops unroll in
    JAX's graph, so the other three flavours take 2 views of 3 frames
    (``_batch``): smaller references, with V ≠ B still."""
    if arch in ("cen", "avs_pred_endecoder") or arch.startswith("legacy:"):
        return ("1", "3", "4")
    return ("1", "3")


def _batch(arch):
    """Frames a view: 3 where the AVS family takes 2 views, else 2."""
    return 3 if arch.startswith("avs_") and len(_views(arch)) == 2 else 2


def _hw(arch):
    """The frames' side: 16² (the U-Nets' bottleneck 1², the legacy f4
    4²), 8² for CEN (its H/4 2²), 32² for UTNet, whose attention needs a
    2² key grid, 34² for the AVS family."""
    if arch.startswith("avs_"):
        return 34
    return {"utnet": 32, "cen": 8}.get(arch, 16)


def _model_kw(arch):
    """The arch's ModelConfig fields beside tiny_config()'s."""
    if arch.startswith("avs_"):
        return AVS_MODEL
    return LEGACY_MODEL if arch.startswith("legacy:") else {}


def _jcfg(arch):
    return JModelConfig(**{f.name: getattr(TINY.model, f.name)
                           for f in dataclasses.fields(JModelConfig)
                           if hasattr(TINY.model, f.name)
                           and f.name not in ("arch", "dtype", "views")
                           and f.name not in _model_kw(arch)},
                        arch=arch, dtype="float64", views=_views(arch),
                        **_model_kw(arch))


class _StreamBN64(jcen.StreamBN):
    """JAX's StreamBN with its batch moments in the input's type: JAX takes
    them in float32 whatever the run's type (``cen.py:76``), which leaves
    a float64 run's train-mode loss 1.5e-5 from float64 (and from the
    port); with this, 2e-14."""

    @fnn.compact
    def __call__(self, x, train: bool, return_scale: bool = False):
        s, c = x.shape[0], x.shape[-1]
        scale = self.param("scale", fnn.initializers.ones, (s, c))
        bias = self.param("bias", fnn.initializers.zeros, (s, c))
        ra_mean = self.variable("batch_stats", "mean",
                                lambda: jnp.zeros((s, c)))
        ra_var = self.variable("batch_stats", "var", lambda: jnp.ones((s, c)))
        if train:
            axes = tuple(range(1, x.ndim - 1))
            mean, var = jnp.mean(x, axis=axes), jnp.var(x, axis=axes)
            if not self.is_initializing():
                m = self.momentum
                ra_mean.value = m * ra_mean.value + (1 - m) * mean
                ra_var.value = m * ra_var.value + (1 - m) * var
        else:
            mean, var = ra_mean.value, ra_var.value
        shape = (s,) + (1,) * (x.ndim - 2) + (c,)
        y = (x - mean.reshape(shape)) * jax.lax.rsqrt(
            var.reshape(shape) + self.epsilon)
        y = y * scale.reshape(shape) + bias.reshape(shape)
        return (y, scale) if return_scale else y


class _JCENLevel(fnn.Module):
    """CEN's network at module level, without dropout, one block a stage."""

    @fnn.compact
    def __call__(self, x, train):
        return jcen.CENRefineNet(num_classes=5, block_sizes=(1, 1, 1, 1),
                                 dropout=0.0, dtype="float64",
                                 name="net")(x, train)


class _JRes3DLevel(fnn.Module):
    """ResUNet3D at module level without dropout: 8-frame volumes."""

    @fnn.compact
    def __call__(self, x, train):
        return JResUNet3D(out_channels=5, widths=(2, 4, 8, 16, 32),
                          drop_rate=0.0, return_logits=True,
                          return_features=True, dtype="float64",
                          name="net")(x, train)


_PRED_KW = dict(channel=AVS_MODEL["aspp_channels"], num_classes=5,
                widths=AVS_MODEL["widths"], blocks=AVS_MODEL["block_sizes"])


class _JPredLevel(fnn.Module):
    """PredEndecoder on one (main, other) pair: views 0 and 1."""

    @fnn.compact
    def __call__(self, x, train):
        return javs.PredEndecoder(**_PRED_KW, return_features=True,
                                  dtype="float64", name="net")(
                                      x[0], x[1], train)


class _PredLevel(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.net = PredEndecoder(**_PRED_KW)

    def forward(self, x):  # the contract's layouts, one view
        mask, feat = self.net(x[0], x[1])
        return {"mask": mask[None], "f4_global": feat[None]}


class _CENLevel(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.net = pcen.CENRefineNet(3, num_classes=5,
                                     block_sizes=(1, 1, 1, 1), dropout=0.0)

    def forward(self, x):  # the adapter's layouts, without its upsample
        v, b, h, w, _ = x.shape
        logits, ens, alpha = self.net(x[..., 0].reshape(v * b, 1, h, w))
        return {"mask": logits.view(v, b, *logits.shape[1:]).movedim(2, -1),
                "mask_ensemble": ens.movedim(1, -1), "alpha": alpha}


class _Res3DLevel(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.net = ResUNet3D(out_channels=5, widths=(2, 4, 8, 16, 32),
                             drop_rate=0.0, return_logits=True,
                             return_features=True)

    def forward(self, x):
        maps, feat = self.net(x.movedim(-1, 1))
        maps = [o.movedim(1, -1) for o in maps]
        return {"mask": maps[3], "mask_aux": tuple(maps[:3]),
                "f4_global": feat.movedim(1, -1)}


_EINSUM = jnp.einsum


def _einsum64(subscripts, *operands, preferred_element_type=None, **kw):
    """``jnp.einsum`` whose float32 accumulation (JAX's
    ``preferred_element_type=float32``: the ASPP's taps, TPAVI's products)
    stays float64 on float64 operands, so a float64 run is float64
    throughout; with it the AVS family and the legacy kinds match the
    float64 port at ``TRAIN_TOL[None]`` (measured without: outputs 9.4e-7,
    gradients 7.4e-5 of max|g| in ``legacy:model20``)."""
    if preferred_element_type == jnp.float32 and all(
            getattr(o, "dtype", None) == jnp.float64 for o in operands):
        preferred_element_type = None
    return _EINSUM(subscripts, *operands,
                   preferred_element_type=preferred_element_type, **kw)


_CONV = jax.lax.conv_general_dilated
_NHWC = ("NHWC", "HWIO", "NHWC")
_CONV64_MACS = 1 << 20


def _conv64(lhs, rhs, window_strides, padding, lhs_dilation=None,
            rhs_dilation=None, dimension_numbers=None,
            feature_group_count=1, batch_group_count=1, **kw):
    """``lax.conv_general_dilated`` of a large float64 2-D NHWC/HWIO
    convolution as one product of its (strided, dilated) taps: XLA:CPU has
    no library convolution in float64 and runs its own loop, about 100×
    slower than its float64 matrix product at the tests' compile level (the
    AVS output head's 128 → 32 conv at 36² took 20 s of a 30 s reference).
    Equal in real arithmetic. A convolution of under ``_CONV64_MACS``
    multiply-adds, or of another kind, goes to XLA's own (the product form
    compiles slower)."""
    dn = jax.lax.conv_dimension_numbers(lhs.shape, rhs.shape,
                                        dimension_numbers)
    macs = np.prod(lhs.shape[:-1]) * np.prod(rhs.shape) // np.prod(
        window_strides)
    if (lhs.dtype != jnp.float64 or lhs.ndim != 4 or macs < _CONV64_MACS
            or feature_group_count != 1
            or batch_group_count != 1 or tuple(lhs_dilation or (1, 1))
            != (1, 1) or dn != jax.lax.conv_dimension_numbers(
                lhs.shape, rhs.shape, _NHWC)):
        return _CONV(lhs, rhs, window_strides, padding, lhs_dilation,
                     rhs_dilation, dimension_numbers, feature_group_count,
                     batch_group_count, **kw)
    kh, kw_, cin, cout = rhs.shape
    (sh, sw), (dh, dw) = window_strides, tuple(rhs_dilation or (1, 1))
    if isinstance(padding, str):
        padding = jax.lax.padtype_to_pads(
            lhs.shape[1:3], ((kh - 1) * dh + 1, (kw_ - 1) * dw + 1),
            window_strides, padding)
    x = jnp.pad(lhs, ((0, 0), tuple(padding[0]), tuple(padding[1]), (0, 0)))
    ho = (x.shape[1] - (kh - 1) * dh - 1) // sh + 1
    wo = (x.shape[2] - (kw_ - 1) * dw - 1) // sw + 1
    taps = [x[:, i * dh:i * dh + (ho - 1) * sh + 1:sh,
              j * dw:j * dw + (wo - 1) * sw + 1:sw]
            for i in range(kh) for j in range(kw_)]
    return jnp.concatenate(taps, -1) @ rhs.reshape(kh * kw_ * cin, cout)


def _j_contract(arch, out):
    """A module-level JAX output as the contract's dict."""
    if arch == "cen":
        logits, ens, alpha = out
        return {"mask": logits, "mask_ensemble": ens, "alpha": alpha}
    if arch == "avs_pred_endecoder":
        mask, feat = out
        return {"mask": mask[None], "f4_global": feat[None]}
    (o1, o2, o3, o4), feat = out
    return {"mask": o4, "mask_aux": (o1, o2, o3), "f4_global": feat}


def _sup_loss(out, masks, bce):
    """The train step's supervised loss: BCE-sums of mask and mask_aux over
    the views (a module-level CEN also of its ensemble, so α learns)."""
    loss = sum(bce(out["mask"][vi], masks[vi]) for vi in range(len(masks)))
    for aux in out.get("mask_aux", ()):
        loss = loss + sum(bce(aux[vi], masks[vi])
                          for vi in range(len(masks)))
    if "mask_ensemble" in out:
        loss = loss + bce(out["mask_ensemble"], masks[0])
    return loss


def _outputs(out):
    """{name: array} of an adapter's outputs, mask_aux flattened."""
    flat = {}
    for k, v in out.items():
        for j, t in enumerate(v) if isinstance(v, tuple) else [(None, v)]:
            flat[k if j is None else f"{k}{j}"] = np.asarray(
                t.detach().numpy() if isinstance(t, torch.Tensor) else t)
    return flat


# trained at module level: CEN and res3dunet without their dropout;
# PredEndecoder on one (main, other) pair, a third of the adapter's
# reference (its ring of V pairs is held in eval)
MODULE_LEVEL = ("cen", "res3dunet", "avs_pred_endecoder")
_J_LEVEL = {"cen": _JCENLevel, "res3dunet": _JRes3DLevel,
            "avs_pred_endecoder": _JPredLevel}
_LEVEL = {"cen": _CENLevel, "res3dunet": _Res3DLevel,
          "avs_pred_endecoder": _PredLevel}
# held in eval alone: JAX's reference computes no train step for them
EVAL_ONLY = ("legacy:none", "legacy:tpavi", "legacy:model18")
# train parity, both in float64: (outputs in relative norm, the loss
# relative, each gradient of max|g|); multiview_unet's JAX TPAVI returns
# its products in float32 (preferred_element_type) in a float64 run
# (measured: outputs 3.4e-7, gradients 1.2e-5; the others at most 1e-10
# and 7.9e-8)
TRAIN_TOL = {None: (1e-8, 1e-9, 1e-6),
             "multiview_unet": (1e-6, 1e-6, 1e-4)}


_CASES: dict = {}
# the tests that ask for a reference, and the level each asks for
_EVAL_TEST, _TRAIN_TEST = ("test_zoo_eval_matches_jax",
                           "test_zoo_train_grads_match_jax")


def _level(test, arch) -> str:
    return "module" if test == _TRAIN_TEST and arch in MODULE_LEVEL \
        else "adapter"


def references_ahead(request) -> list:
    """The (arch, level) references that pytest's selected tests of the
    calling test's module ask for, in their order."""
    return [(item.callspec.params["arch"],
             _level(item.originalname, item.callspec.params["arch"]))
            for item in request.session.items
            if getattr(item, "module", None) is request.module
            and item.originalname in (_EVAL_TEST, _TRAIN_TEST)]


def start_references(cases) -> None:
    """Trace and lower each (arch, level) reference not started yet, in
    order, here; each compiles and runs on the background thread
    (``compile_and_run``) while the next one traces."""
    for key in cases:
        if key not in _CASES:
            _CASES[key] = _start(*key)


def jax_case(arch, level: str):
    """JAX in float64 (``jax.enable_x64``) on seeded numpy inputs, in one
    compile: at ``level='adapter'`` the adapter's eval outputs and (but for
    ``MODULE_LEVEL``) the train-mode outputs, the supervised loss and its
    gradients; at ``level='module'`` the latter of the module without
    dropout. Frames of ``_hw(arch)``². Returns (variables, x, masks, eval
    outputs, train outputs, loss, gradients), numpy; computed once."""
    start_references([(arch, level)])
    return _CASES[(arch, level)].result()


def _start(arch, level: str):
    """``jax_case``'s reference, traced and lowered here: a future."""
    rs = np.random.RandomState(1)
    module = level == "module"
    hw = _hw(arch)
    shape = (len(_views(arch)),
             8 if module and arch == "res3dunet" else _batch(arch),
             hw, hw, 1)
    x = rs.rand(*shape)
    out_hw, views = (hw, hw), shape[0]
    if module and arch == "cen":
        out_hw = (hw // 4,) * 2
    if module and arch == "avs_pred_endecoder":  # the decoder's own grid
        out_hw, views = (4 * b2_stage_hw(hw)[0],) * 2, 1
    masks = (rs.rand(views, shape[1], *out_hw, 5) > 0.7).astype(np.float64)
    jm = _J_LEVEL[arch]() if module else j_build(_jcfg(arch))[0]
    train = module or arch not in MODULE_LEVEL + EVAL_ONLY
    with jax.enable_x64(True):
        v = _random_variables(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros(shape), False))
        v = jax.tree_util.tree_map(lambda a: a.astype(np.float64), v)
        stats = v.get("batch_stats", {})

        def loss_fn(params):
            out, _ = jm.apply({"params": params, "batch_stats": stats}, x,
                              True, mutable=["batch_stats"])
            out = _j_contract(arch, out) if module else out
            return _sup_loss(out, masks, jlosses.bce_with_logits_sum), out

        def run(v):
            ev = None if module else jm.apply(v, x, False)
            tr = (jax.value_and_grad(loss_fn, has_aux=True)(v["params"])
                  if train else ((None, None), None))
            return ev, tr

        # CEN's large float64 convolutions run as products of their taps
        # too (XLA's own float64 loop at the low optimization level is
        # what made its reference slow), so it compiles as fast as the rest
        second_half = arch.startswith(("avs_", "legacy:"))
        with mock.patch.object(jcen, "StreamBN", _StreamBN64), \
                mock.patch.object(jnp, "einsum",
                                  _einsum64 if second_half else _EINSUM), \
                mock.patch.object(jax.lax, "conv_general_dilated",
                                  _conv64 if second_half or arch == "cen"
                                  else _CONV):
            lowered = jax.jit(run, compiler_options=FAST_COMPILE).lower(v)

    def results(out):
        ev, ((loss, tr), g) = out
        return v, x, masks, ev, tr, loss, g
    return compile_and_run(lowered, v, x64=True, then=results)


def port_zoo(arch, variables, dtype=torch.float32, hw=16):
    m, cps = build_model(dataclasses.replace(
        TINY.model, arch=arch, views=_views(arch), **_model_kw(arch)), hw=hw)
    assert not cps
    m.load_state_dict(zoo_state_dict_from_jax(variables, arch))
    return m.to(dtype)


def check_eval(arch, ahead=()):
    """The port's float32 adapter against JAX's float64 one; the
    references ``ahead`` (``references_ahead``) start behind it."""
    start_references([(arch, "adapter"), *ahead])
    v, x, _, ref, *_ = jax_case(arch, "adapter")
    ref = _outputs(ref)
    m = port_zoo(arch, v, hw=x.shape[2]).eval()
    for attn in m.modules():  # at init W_z's BN would hide TPAVI
        if isinstance(attn, TPAVI):
            bn = attn.W_z[1]
            assert (bn.weight != 0).all() and (bn.bias != 0).all()
    with torch.no_grad():
        out = _outputs(m(torch.from_numpy(x).float()))
    want = {"mask", "mask_bb", "f4_global", "f4_local"} | (
        {"mask_ensemble", "alpha"} if arch == "cen" else set()) | (
        {"mask_aux0", "mask_aux1", "mask_aux2"}
        if arch == "res3dunet" else set())
    assert set(out) == set(ref) == want
    for k in want:
        assert out[k].shape == ref[k].shape, k
        assert _rel(out[k], ref[k]) <= EVAL_TOL, (k, _rel(out[k], ref[k]))


def check_train(arch):
    """Train mode, both packages in float64: the outputs, the supervised
    loss and every parameter's gradient, within ``TRAIN_TOL``; a conv bias
    before a train BN (its true gradient 0, each package's a rounding
    residue) is measured against its module's weight gradient."""
    module = arch in MODULE_LEVEL
    v, x, masks, _, jout, jl, jg = jax_case(
        arch, "module" if module else "adapter")
    jl = float(jl)
    if module:
        m = _LEVEL[arch]()
        m.load_state_dict(zoo_state_dict_from_jax(v, arch, per_view=False))
        m = m.double()
    else:
        m = port_zoo(arch, v, torch.float64, hw=x.shape[2])
    m.train()
    out = m(torch.from_numpy(x))
    loss = _sup_loss(out, torch.from_numpy(masks), bce_with_logits_sum)
    loss.backward()
    out_tol, loss_tol, tol = TRAIN_TOL.get(arch, TRAIN_TOL[None])
    assert abs(loss.item() - jl) <= loss_tol * abs(jl)
    jo, po = _outputs(jout), _outputs(out)
    assert set(jo) == set(po)
    for k in jo:
        assert _rel(po[k], jo[k]) <= out_tol, (k, _rel(po[k], jo[k]))
    want = zoo_state_dict_from_jax({"params": jg,
                                    "batch_stats": v.get("batch_stats", {})},
                                   arch, per_view=not module)
    grads = dict(m.named_parameters())
    assert set(grads) <= set(want)
    for name, p in grads.items():
        # a parameter outside the loss: no gradient here, a zero one in JAX
        g = (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
        ref = want[name].numpy()
        scale = np.abs(ref).max()
        owner = name.rsplit(".", 1)[0] + ".weight"
        if name.endswith(".bias") and owner in want:
            scale = max(scale, np.abs(want[owner].numpy()).max())
        assert np.abs(g - ref).max() <= tol * scale, (
            name, np.abs(g - ref).max() / scale)
