"""Trainable-model registry: ``--model`` names → modules of the train
contract (port of ``glfusion_tpu/models/registry.py``).

Every architecture is adapted to ONE contract, so the same train and eval
steps drive the whole zoo:

    module(x: (V, B, H, W, 1)) -> {
        "mask":      (V, B, H, W, num_classes) logits,
        "mask_bb":   the same (backbone-only logits where the arch has them),
        "f4_global": (V, B|T, h, w, C) features for the cycle loss,
        "f4_local":  the same,
    }

plus ``mask_aux`` (the deep-supervision logits, which the train step adds
to the supervised loss) for ``res3dunet`` and ``mask_ensemble``/``alpha``
for ``cen``. Train or eval follows ``module.training``.

Views of the per-view adapters (``unet:*``, ``utnet``, ``res3dunet``) start
from the SAME initial weights (one network deep-copied, as JAX's
``split_rngs={'params': False}`` gives); ``unet`` and ``multiview_unet``
draw each view's encoder and decoder independently, as JAX's own
``_per_view`` does. The AVS family (``avs_*``) shares its heads and decoder
over the views (model17 draws a backbone a view); the legacy kinds
(``legacy:*``) copy their per-view modules as the flagship does.

``build_reg_model`` builds the four video regressors of ``--mode
reg-train|reg-val`` (``REG_ARCHS``) with their input adapters: clips
(V, B, H, W, T) → the model's (B, V, T, H, W).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from glfusion_tpu_torch.arch_names import (AVS_FLAVORS, LEGACY_KINDS,
                                           REG_ARCHS, SEG_ARCHS, UNET_KINDS)
from glfusion_tpu_torch.config import ModelConfig
from glfusion_tpu_torch.models.avs import (AVSBaseline, AVSTransfusion,
                                           PredEndecoder)
from glfusion_tpu_torch.models.cen import CENRefineNet
from glfusion_tpu_torch.models.glfusion import build_model
from glfusion_tpu_torch.models.legacy_variants import (LegacyMultiviewSeg,
                                                       per_view)
from glfusion_tpu_torch.models.mriresnet3d import Resnet50PFS
from glfusion_tpu_torch.models.multiview_unet import MultiviewUNet
from glfusion_tpu_torch.models.precision import compute_dtype
from glfusion_tpu_torch.models.r2plus1d import R2Plus1D18
from glfusion_tpu_torch.models.res3dunet import ResUNet3D
from glfusion_tpu_torch.models.resnet3d import Resnet50PAH
from glfusion_tpu_torch.models.timesformer import TimeSformer
from glfusion_tpu_torch.models.unet import UNet
from glfusion_tpu_torch.models.utnet import UTNet
from glfusion_tpu_torch.ops.resize import resize_bilinear_nchw


def _images(x: torch.Tensor, i: int) -> torch.Tensor:
    """View i of (V, B, H, W, 1) as (B, 1, H, W), NCHW-contiguous."""
    return x[i, ..., 0].unsqueeze(1)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """(..., C, H, W) → (..., H, W, C)."""
    return t.movedim(-3, -1)


def _contract(mask: torch.Tensor, feat: torch.Tensor, **extra) -> Dict:
    return {"mask": mask, "mask_bb": mask, "f4_global": feat,
            "f4_local": feat, **extra}


class MultiviewUNetAdapter(nn.Module):
    """baseline_unet / multiview_unet with the bottleneck as the cycle
    features; ``stem_width`` 64 gives the reference widths 64..1024."""

    def __init__(self, cfg: ModelConfig, fuse: bool):
        super().__init__()
        widths = tuple(cfg.stem_width * 2 ** i for i in range(5))
        self.net = MultiviewUNet(cfg.num_views, cfg.num_classes, widths,
                                 fuse, compute_dtype(cfg.dtype))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = self.net(x)
        return _contract(out["mask"], out["bottleneck"])


class UNetFamilyAdapter(nn.Module):
    """models/unet.py's four kinds per view; the H/16 deepest encoder stage
    is the cycle-feature tap."""

    def __init__(self, cfg: ModelConfig, recurrent: bool, attention: bool):
        super().__init__()
        widths = tuple(cfg.stem_width * 2 ** i for i in range(5))
        self.net = per_view(UNet(
            out_channels=cfg.num_classes, widths=widths, recurrent=recurrent,
            attention=attention, return_features=True,
            dtype=compute_dtype(cfg.dtype)), cfg.num_views)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        outs = [net(_images(x, i)) for i, net in enumerate(self.net)]
        return _contract(_nhwc(torch.stack([m for m, _ in outs])),
                         _nhwc(torch.stack([f for _, f in outs])))


class UTNetAdapter(nn.Module):
    """Per-view UTNet; the deepest encoder stage is the cycle-feature tap.
    The relative position bias needs every transformer stage's grid
    divisible by ``reduce_size``: H/16 of the configured crop."""

    def __init__(self, cfg: ModelConfig, hw: int):
        super().__init__()
        self.net = per_view(UTNet(
            num_classes=cfg.num_classes, base=max(cfg.stem_width // 2, 2),
            reduce_size=max(hw // 16, 1), return_features=True,
            dtype=compute_dtype(cfg.dtype)), cfg.num_views)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        outs = [net(_images(x, i)) for i, net in enumerate(self.net)]
        return _contract(_nhwc(torch.stack([m for m, _ in outs])),
                         _nhwc(torch.stack([f for _, f in outs])))


class CENAdapter(nn.Module):
    """CEN RefineNet with the views as its exchange streams; the H/4
    logits are upsampled (align_corners=False) to the input size. The
    per-stream logits are the per-view masks; the α-ensemble and α are
    extra outputs."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.net = CENRefineNet(cfg.num_views, num_classes=cfg.num_classes,
                                dtype=compute_dtype(cfg.dtype))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        v, b, hh, ww, _ = x.shape
        logits, ens, alpha = self.net(x[..., 0].reshape(v * b, 1, hh, ww))
        mask = resize_bilinear_nchw(logits, (hh, ww))
        return _contract(
            _nhwc(mask.view(v, b, *mask.shape[1:])),
            _nhwc(logits.view(v, b, *logits.shape[1:])),
            mask_ensemble=_nhwc(resize_bilinear_nchw(ens, (hh, ww))),
            alpha=alpha)


class Res3DUNetAdapter(nn.Module):
    """ResUNet3D per view, each view's frames folded into ONE volume
    (frames → depth, edge-padded to a multiple of 8), so the 3-D context
    spans the frames. The three coarse deep-supervision heads return as
    ``mask_aux`` (coarsest first); the 1/8-scale bottleneck, resized along
    depth back to the frame count (linear, half-pixel), is the cycle-feature
    tap. ``stem_width`` 64 gives the reference widths 16..256."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        base = max(cfg.stem_width // 4, 2)
        self.net = per_view(ResUNet3D(
            out_channels=cfg.num_classes,
            widths=tuple(base * 2 ** i for i in range(5)),
            return_logits=True, return_features=True,
            dtype=compute_dtype(cfg.dtype)), cfg.num_views)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        v, b = x.shape[:2]
        pad = (-b) % 8
        vol = x[..., 0]  # (V, D=b, H, W)
        if pad:  # edge padding along the frames
            vol = torch.cat([vol, vol[:, -1:].expand(-1, pad, -1, -1)], 1)
        maps, feats = [], []
        for i, net in enumerate(self.net):
            m, f = net(vol[i][None, None])  # (1, 1, D, H, W)
            maps.append([o[0, :, :b] for o in m])  # (C, b, H, W)
            if f.shape[2] != b:  # per-frame cycle features
                f = F.interpolate(f, size=(b,) + tuple(f.shape[3:]),
                                  mode="trilinear", align_corners=False)
            feats.append(f[0])  # (C, b, h, w)

        def stacked(k):  # (V, b, H, W, C)
            return torch.stack([m[k] for m in maps]).permute(0, 2, 3, 4, 1)

        return _contract(
            stacked(3), torch.stack(feats).permute(0, 2, 3, 4, 1),
            mask_aux=tuple(stacked(k) for k in range(3)))


class AVSAdapter(nn.Module):
    """The AVS family under the multi-view contract (``channel`` is
    ``aspp_channels``); the deepest post-fusion stage is the cycle-feature
    tap. ``baseline``: AVSBaseline; ``transfusion``: AVSTransfusion with
    the channel transformer; ``model17``: per-view backbones and TPAVI;
    ``pred_endecoder``: each view decoded as the main one with its ring
    neighbour (v + 1) mod V as the other, through one shared network. The
    mask is resized (align_corners=False) to the input only where the
    decoder's output differs from it."""

    def __init__(self, cfg: ModelConfig, flavor: str, hw: int):
        super().__init__()
        self.pred = flavor == "pred_endecoder"
        dt = compute_dtype(cfg.dtype)
        kw = dict(num_classes=cfg.num_classes, widths=tuple(cfg.widths),
                  blocks=tuple(cfg.block_sizes), dtype=dt)
        if flavor == "baseline":
            self.net = AVSBaseline(**kw)
        elif self.pred:
            self.net = PredEndecoder(channel=cfg.aspp_channels, **kw)
        else:
            self.net = AVSTransfusion(
                cfg.num_views, hw, channel=cfg.aspp_channels,
                fusion="transformer" if flavor == "transfusion" else "tpavi",
                per_view_params=flavor == "model17", **kw)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        v, b, hh, ww, _ = x.shape
        if self.pred:
            outs = [self.net(x[i], x[(i + 1) % v]) for i in range(v)]
            mask = torch.stack([m for m, _ in outs])
            feat = torch.stack([f for _, f in outs])
        else:
            mask, feat = self.net(x)
        if mask.shape[2:4] != (hh, ww):
            mask = resize_bilinear_nchw(
                mask.flatten(0, 1).movedim(-1, 1), (hh, ww))
            mask = _nhwc(mask).view(v, b, hh, ww, -1)
        return _contract(mask, feat)


# JAX's kinds of models/legacy_variants.py (reference ours.py's classes)
LEGACY_KIND_KW = {
    "none": dict(fusion="none"),  # Mutiview_Model / model6 / model7
    # model3 / model8 / model12
    "channel_transformer": dict(fusion="channel_transformer"),
    "tpavi": dict(fusion="tpavi"),  # model19
    "model18": dict(fusion="tpavi", shared_classifier=True),
    # model20: stage-interleaved fusion
    "model20": dict(fusion="tpavi", fusion_stages=(1, 2, 3, 4)),
    # model21 / model21_for_specific_view
    "decouple": dict(fusion="decouple_tpavi", shared_backbone=True,
                     shared_classifier=True),
    "mlp_concat": dict(fusion="mlp_concat"),  # MLP_fusion
}


class LegacyAdapter(nn.Module):
    """The model3..model21 family under the train contract; the
    post-fusion f4 is the cycle-feature tap."""

    def __init__(self, cfg: ModelConfig, kind: str, hw: int):
        super().__init__()
        self.net = LegacyMultiviewSeg(cfg, hw, **LEGACY_KIND_KW[kind])

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = self.net(x)
        return _contract(out["mask"], out["f4_fusion"])


def build_seg_model(cfg: ModelConfig, hw: int = 112
                    ) -> Tuple[nn.Module, bool]:
    """``(module, is_cps)`` of ``cfg.arch`` (JAX ``build_seg_model``).
    ``glfusion`` keeps the flagship, its ablations and the CPS twin
    (``variant='cps'``). ``hw``: the crop size the model will see (UTNet's
    attention grid, and the AVS and legacy channel transformers' Linear
    layers, are sized by it)."""
    arch = cfg.arch
    if arch == "glfusion":
        return build_model(cfg)
    if arch in ("unet", "multiview_unet"):
        return MultiviewUNetAdapter(cfg, fuse=arch == "multiview_unet"), False
    if arch == "utnet":
        return UTNetAdapter(cfg, hw), False
    if arch == "cen":
        return CENAdapter(cfg), False
    if arch == "res3dunet":
        return Res3DUNetAdapter(cfg), False
    if arch.startswith("unet:") and arch[5:] in UNET_KINDS:
        kind = arch[5:]
        return UNetFamilyAdapter(cfg, recurrent="r2" in kind,
                                 attention="att" in kind), False
    if arch.startswith("avs_") and arch[4:] in AVS_FLAVORS:
        return AVSAdapter(cfg, arch[4:], hw), False
    if arch.startswith("legacy:") and arch[7:] in LEGACY_KINDS:
        return LegacyAdapter(cfg, arch[7:], hw), False
    raise ValueError(f"unknown arch {arch!r}; choose from {SEG_ARCHS}")


# ------------------------------------------------------------- regression

def _views_to_channels(clips: torch.Tensor) -> torch.Tensor:
    """(V, B, H, W, T) → (B, V, T, H, W): the views are the Conv3d input
    channels (JAX's (B, T, H, W, V) in NCDHW). In NCDHW this is also the
    views axis of single-channel videos that TimeSformer and Resnet50PFS
    take (JAX's ``_views_axis``), so all four regressors share it."""
    return clips.permute(1, 0, 4, 2, 3).contiguous()


def build_reg_model(name: str, num_views: int, dtype: str = "float32",
                    **overrides) -> Tuple[nn.Module, Callable]:
    """``(module, input_adapter)`` of a ``--reg-model`` name for the
    ``RegressionTrainer`` (JAX ``build_reg_model``). ``overrides`` are the
    JAX modules' fields (``depth``, ``widths`` …); ``num_views`` sizes the
    input (JAX infers it); ``dtype`` is the compute type, parameters stay
    float32."""
    dt = compute_dtype(dtype)
    if name == "resnet50pah":
        return (Resnet50PAH(num_views, dtype=dt, **overrides),
                _views_to_channels)
    if name == "r2plus1d":
        return (R2Plus1D18(num_views, num_classes=1, dtype=dt, **overrides),
                _views_to_channels)
    if name == "timesformer":
        return (TimeSformer(num_views, num_classes=1, dtype=dt, **overrides),
                _views_to_channels)
    if name == "resnet50pfs":
        # the views are the PFS regressor's modality axis (reference
        # mriresnet3d.py:271,306-308)
        return (Resnet50PFS(num_views, n_outputs=1, dtype=dt, **overrides),
                _views_to_channels)
    raise ValueError(f"unknown regression model {name!r}; "
                     f"choose from {REG_ARCHS}")
