"""The legacy research variants, in PyTorch (port of
``glfusion_tpu/models/legacy_variants.py``; reference ``models/ours.py``
model3..model21).

One template covers the family: per-view (or shared) ResNet-50-IEKD
backbones → a fusion mechanism at f4 (or interleaved with the stages) →
per-view (or shared) DeepLab classifier → bilinear upsample to the input
(align_corners=False). The fusions:

* ``none``;
* ``channel_transformer``: ``avs.ViewChannelTransformer`` on f4
  (``attn4``, its Linear layers sized by f4's grid);
* ``tpavi``: TPAVI over the V·h·w tokens of f4 (``non_local``);
* ``mlp_concat``: a per-view 1×1 conv with bias (``fc.{v}.conv``) over the
  channel-concat of every view's f4;
* ``decouple_tpavi``: per-view 1×1 conv + BN "consistent" and
  "complementary" projections of f4; TPAVI over the complementary stack,
  the consistent one added back;
* ``tpavi`` with several ``fusion_stages`` (model20): the fusion is
  INTERLEAVED with the backbone: TPAVI ``non_local{k}`` after stage k
  feeds stage k + 1 (``backbone_stem``, ``backbone_layer{k}``). Only this
  form fuses at a stage other than 4; any other ``fusion_stages`` raises
  JAX's ``ValueError``.

Per-view modules are ``.{v}`` copies of one freshly built module, so every
view starts from the same weights (JAX's ``_per_view``,
``split_rngs={'params': False}``); a shared one runs once a view (its BNs
update once a view). The backbone, its stem and stages and the DeepLab
head are the flagship's modules (``models/resnet.py``, ``models/aspp.py``)
under the reference's state-dict names, so ``utils/convert``'s
``backbone_state_dict``, ``head_state_dict`` and ``tpavi_state_dict`` map
them. ``cfg.dtype`` is the compute type of every layer, ``fc`` included (JAX
builds it with ``dtype=cfg.dtype``). No TPAVI here takes an ``attn_impl``
(``"auto"``, as in JAX): ``use_pallas_fusion`` does not reach them.

``SpatialConcatFusion`` and ``SpatialMLP`` are exported building blocks the
registry does not reach, on JAX's (…, h, w, C) layout.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Sequence

import torch
import torch.nn as nn

from glfusion_tpu_torch.config import ModelConfig
from glfusion_tpu_torch.models.aspp import DeepLabHead
from glfusion_tpu_torch.models.avs import ViewChannelTransformer, attend
from glfusion_tpu_torch.models.precision import Conv2d, compute_dtype
from glfusion_tpu_torch.models.resnet import (ResNetIEKD, iekd_stem,
                                              make_stages, stage_plan)
from glfusion_tpu_torch.models.tpavi import TPAVI
from glfusion_tpu_torch.ops.resize import resize_bilinear_nchw

FUSIONS = ("none", "channel_transformer", "tpavi", "mlp_concat",
           "decouple_tpavi")
Maps = List[torch.Tensor]


class SpatialConcatFusion(nn.Module):
    """concat_fusion: the views concatenated on the SPATIAL axis, a Linear
    V·h·w → h·w per channel. x (V, B, h, w, C) → (B, h, w, C)."""

    def __init__(self, views: int, h: int, w: int):
        super().__init__()
        self.fc = nn.Linear(views * h * w, h * w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v, b, h, w, c = x.shape
        tok = x.permute(1, 4, 0, 2, 3).reshape(b, c, v * h * w)
        return self.fc(tok).view(b, c, h, w).permute(0, 2, 3, 1)


class SpatialMLP(nn.Module):
    """MLP: a Linear over the flattened h·w, then ReLU. x (B, h, w, C) →
    the same."""

    def __init__(self, h: int, w: int):
        super().__init__()
        self.fc = nn.Linear(h * w, h * w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        tok = x.permute(0, 3, 1, 2).reshape(b, c, h * w)
        return torch.relu(self.fc(tok)).view(b, c, h, w).permute(0, 2, 3, 1)


class _Proj(nn.Module):
    """A 1×1 conv with bias (``conv``), then BN (``bn``) where asked."""

    def __init__(self, cin: int, cout: int, bn: bool, dtype: torch.dtype):
        super().__init__()
        self.conv = Conv2d(cin, cout, 1, compute_dtype=dtype)
        self.bn = nn.BatchNorm2d(cout) if bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return y if self.bn is None else self.bn(y)


def per_view(net: nn.Module, views: int) -> nn.ModuleList:
    """``views`` copies of one freshly built network (``.{v}``, the same
    initial weights: JAX's ``split_rngs={'params': False}``)."""
    return nn.ModuleList([net] + [copy.deepcopy(net)
                                  for _ in range(views - 1)])


def _lift(mod: nn.Module, views: int, shared: bool) -> nn.Module:
    """The module itself (shared over the views) or its per-view copies."""
    return mod if shared else per_view(mod, views)


def _each(mod: nn.Module, maps: Maps) -> Maps:
    """Apply a lifted module to each view's map."""
    if isinstance(mod, nn.ModuleList):
        return [m(t) for m, t in zip(mod, maps)]
    return [mod(t) for t in maps]


def iekd_f4_hw(cfg: ModelConfig, hw: int) -> int:
    """The side of ``ResNetIEKD``'s f4 for an hw² input: the stem takes 2
    (7×7, pad 2), the pool and each stride-2 stage ⌈n/2⌉ (112 → 28)."""
    n = (hw - 2 + 1) // 2
    for _, _, stride, _, _ in stage_plan(cfg.block_sizes, cfg.widths,
                                         cfg.dilate_stages):
        n = (n + stride - 1) // stride
    return n


class _SharedOrPerViewHead(nn.Module):
    """The DeepLab classifier ``head``: one module for every view, or a
    copy a view."""

    def __init__(self, cfg: ModelConfig, cin: int, shared: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.head = _lift(DeepLabHead(
            cin, cfg.num_classes, cfg.aspp_channels, cfg.aspp_rates,
            cfg.aspp_dropout, dtype), cfg.num_views, shared)

    def forward(self, maps: Maps) -> Maps:
        return _each(self.head, maps)


class LegacyMultiviewSeg(nn.Module):
    """The model3..model21 family behind one configuration. ``hw``: the
    input's side, which sizes ``channel_transformer``'s Linear layers.
    x (V, B, H, W, 1) → {"mask": (V, B, H, W, classes), "f4": the
    pre-fusion layer4 (V, B, h, w, C), "f4_fusion": the fused f4}."""

    def __init__(self, cfg: ModelConfig, hw: int, fusion: str = "none",
                 fusion_stages: Sequence[int] = (4,),
                 shared_backbone: bool = False,
                 shared_classifier: bool = False):
        super().__init__()
        self.fusion, self.fusion_stages = fusion, tuple(fusion_stages)
        self.multi_stage = fusion == "tpavi" and len(self.fusion_stages) > 1
        if not self.multi_stage and self.fusion_stages != (4,):
            raise ValueError(
                f"fusion_stages={self.fusion_stages} is only "
                f"supported as multi-stage tpavi (model20); "
                f"fusion={fusion!r} fuses at stage 4 only — "
                f"use fusion_stages=(4,)")
        if fusion not in FUSIONS:
            raise ValueError(f"unknown fusion {fusion!r}")
        dt = compute_dtype(cfg.dtype)
        v, c = cfg.num_views, cfg.backbone_out_channels
        self.num_stages = len(cfg.block_sizes)

        def lift(mod):
            return _lift(mod, v, shared_backbone)

        if self.multi_stage:
            self.backbone_stem = lift(iekd_stem(cfg.stem_width, dt))
            stages = make_stages(cfg.stem_width, cfg.block_sizes, cfg.widths,
                                 cfg.expansion, cfg.dilate_stages, dt)
            for k, stage in enumerate(stages, 1):
                self.add_module(f"backbone_layer{k}", lift(stage))
                if k in self.fusion_stages:
                    self.add_module(f"non_local{k}", TPAVI(
                        cfg.widths[k - 1] * cfg.expansion, dtype=dt))
        else:
            self.backbone = lift(ResNetIEKD(
                cfg.stem_width, cfg.block_sizes, cfg.widths, cfg.expansion,
                cfg.dilate_stages, dt))
            if fusion == "channel_transformer":
                self.attn4 = ViewChannelTransformer(
                    v, c, iekd_f4_hw(cfg, hw) ** 2, dt)
            elif fusion == "mlp_concat":
                self.fc = per_view(_Proj(v * c, c, False, dt), v)
            elif fusion == "tpavi":
                self.non_local = TPAVI(c, dtype=dt)
            elif fusion == "decouple_tpavi":
                self.consistent_conv = per_view(_Proj(c, c, True, dt), v)
                self.complementary_conv = per_view(_Proj(c, c, True, dt), v)
                self.non_local = TPAVI(c, dtype=dt)
        self.classifier = _SharedOrPerViewHead(cfg, c, shared_classifier, dt)

    def _features(self, views: Maps):
        """(pre-fusion f4, fused f4), per-view NCHW maps."""
        if self.multi_stage:
            xk = _each(self.backbone_stem, views)
            for k in range(1, self.num_stages + 1):
                xk = _each(getattr(self, f"backbone_layer{k}"), xk)
                if k == self.num_stages:
                    f4 = xk
                if k in self.fusion_stages:
                    xk = attend(getattr(self, f"non_local{k}"), xk)
            return f4, xk
        feats = _each(self.backbone, views)
        if self.fusion == "channel_transformer":
            return feats, list(self.attn4(torch.stack(feats)).unbind(0))
        if self.fusion == "mlp_concat":
            cat = torch.cat(feats, dim=1)
            return feats, [fc(cat) for fc in self.fc]
        if self.fusion == "tpavi":
            return feats, attend(self.non_local, feats)
        if self.fusion == "decouple_tpavi":
            consistent = _each(self.consistent_conv, feats)
            fused = attend(self.non_local,
                          _each(self.complementary_conv, feats))
            return feats, [a + b for a, b in zip(fused, consistent)]
        return feats, feats

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        v, b, hh, ww, _ = x.shape
        f4, fused = self._features([x[i, ..., 0].unsqueeze(1)
                                    for i in range(v)])
        mask = torch.stack(self.classifier(fused))  # (V, B, classes, h, w)
        mask = resize_bilinear_nchw(mask.flatten(0, 1), (hh, ww))
        return {"mask": mask.view(v, b, *mask.shape[1:]).movedim(2, -1),
                "f4": torch.stack(f4).movedim(2, -1),
                "f4_fusion": torch.stack(fused).movedim(2, -1)}
