"""The library segmenters: single-view DeepLab variants and the multi-frame
segmenter, in PyTorch (port of ``glfusion_tpu/models/segmentation.py``).

They are not behind ``--model`` (JAX's registry has no name for them); a
user builds them through the ctors below. Like JAX's, each takes and
returns the NHWC layout: frames (B, H, W, C) in, a dict of (B, ..., C)
maps out. They compute in float32, as JAX's module has no ``dtype`` field.

* ``deeplabv3_resnet50`` (``variant='plain'``, 3 input channels, 21
  classes): ``out`` plus a contrastive centre head on f4 (global mean →
  Linear C→C → ReLU → Linear → 128 → divided by its L2 norm, with no
  epsilon: a zero vector gives NaN, as in JAX) as ``ctr_feat``, and f4 as
  ``feat_mid``.
* ``deeplabv3_resnet50_iekd`` (``'iekd'``): the layer taps ``x_layerbs``
  (the stem after its ReLU, before the max-pool), ``x_layer1``,
  ``x_layer4`` and ``maskfeat``, the logits resized to a fixed 56²
  whatever the input's size.
* ``deeplabv3_resnet50_iekd_project`` (``'project'``): the taps, with the
  normalized 128-d projection of f4 in the ``x_layer4`` slot, shaped
  (B, 128, 1, 1) as JAX's ``ctr[..., None, None]`` is.
* ``deeplabv3_resnet50_iekd_maxmod`` (``'maxmod'``): ``xtest_layer1code``,
  three 3×3 convolutions without bias on layer1, each followed by a
  LeakyReLU of slope 0.1, at the fixed widths 256, 64, 64.
* ``MultiFrameSegmenter``: one shared backbone runs the reference frame
  and each support frame (in train mode its BatchNorm statistics move once
  a call, the reference's first, then the supports' in order). Token
  attention: the dot products of the reference's and a support's f4
  tokens, softmaxed over the whole L·K matrix, and for each support token
  k the sum over l of the reference's tokens so weighted
  (``einsum("blc,blk->bkc")``); ``spatial_attention``: the channel sum of
  reference ⊙ support softmaxed over the whole h·w grid, which reweights
  the reference's f4. The reference and the attended maps are
  concatenated, reduced by a 1×1 convolution (``mlp_red``) and classified.

``in_channels`` sizes the backbone's stem (JAX's convolution takes the
input's channels); an input with other channels raises. Module names
follow JAX's (``backbone``, ``classifier``, ``ctr_fc1``, ``coder0``,
``mlp_red`` …); ``utils/convert.segmentation_state_dict_from_jax`` maps
JAX's variables onto them. Both heads keep their ASPP dropout of 0.5, as
JAX's have no field to change it.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from glfusion_tpu_torch.models.aspp import DeepLabHead
from glfusion_tpu_torch.models.resnet import ResNetIEKD
from glfusion_tpu_torch.ops.resize import resize_bilinear_nchw

VARIANTS = ("plain", "iekd", "project", "maxmod")
MASKFEAT_HW = (56, 56)
CODER_WIDTHS = (256, 64, 64)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def _nchw_input(x: torch.Tensor, in_channels: int) -> torch.Tensor:
    if x.shape[-1] != in_channels:
        raise ValueError(f"frames of {x.shape[-1]} channels for a stem of "
                         f"{in_channels} (shape {tuple(x.shape)}, NHWC)")
    return x.permute(0, 3, 1, 2)


def _l2_normalized(v: torch.Tensor) -> torch.Tensor:
    """v / ‖v‖ over the last axis, with no epsilon (JAX's)."""
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


class DeepLabV3Single(nn.Module):
    """Backbone + head + one variant's extra outputs."""

    def __init__(self, num_classes: int = 5, in_channels: int = 1,
                 variant: str = "iekd", stem_width: int = 64,
                 block_sizes: Sequence[int] = (3, 4, 6, 3),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 aspp_rates: Sequence[int] = (12, 24, 36),
                 aspp_channels: int = 256, ctr_dim: int = 128):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}")
        self.variant = variant
        self.in_channels = in_channels
        self.backbone = ResNetIEKD(stem_width, block_sizes, widths,
                                   in_channels=in_channels, return_taps=True)
        c4 = widths[-1] * 4
        self.classifier = DeepLabHead(c4, num_classes, aspp_channels,
                                      aspp_rates)
        if variant in ("plain", "project"):
            pre = "ctr" if variant == "plain" else "cntr"
            self.add_module(f"{pre}_fc1", nn.Linear(c4, c4))
            self.add_module(f"{pre}_fc2", nn.Linear(c4, ctr_dim))
        elif variant == "maxmod":
            cin = widths[0] * 4
            for i, ch in enumerate(CODER_WIDTHS):
                self.add_module(f"coder{i}", nn.Conv2d(cin, ch, 3, padding=1,
                                                       bias=False))
                cin = ch

    def _projection(self, f4: torch.Tensor, pre: str) -> torch.Tensor:
        h = getattr(self, f"{pre}_fc1")(f4.mean(dim=(-2, -1)))
        return _l2_normalized(getattr(self, f"{pre}_fc2")(F.relu(h)))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        hh, ww = x.shape[-3], x.shape[-2]
        taps = self.backbone(_nchw_input(x, self.in_channels))
        f4 = taps["layer4"]
        logits = self.classifier(f4)
        out = {"out": _nhwc(resize_bilinear_nchw(logits, (hh, ww)))}
        if self.variant == "plain":
            out["ctr_feat"] = self._projection(f4, "ctr")
            out["feat_mid"] = _nhwc(f4)
        elif self.variant == "iekd":
            out["x_layerbs"] = _nhwc(taps["stem"])
            out["x_layer1"] = _nhwc(taps["layer1"])
            out["x_layer4"] = _nhwc(f4)
            out["maskfeat"] = _nhwc(resize_bilinear_nchw(logits,
                                                         MASKFEAT_HW))
        elif self.variant == "project":
            out["x_layerbs"] = _nhwc(taps["stem"])
            out["x_layer1"] = _nhwc(taps["layer1"])
            out["x_layer4"] = self._projection(f4, "cntr")[..., None, None]
        else:
            code = taps["layer1"]
            for i in range(len(CODER_WIDTHS)):
                code = F.leaky_relu(getattr(self, f"coder{i}")(code), 0.1)
            out["xtest_layer1code"] = _nhwc(code)
        return out


def deeplabv3_resnet50(num_classes: int = 21, **kw) -> DeepLabV3Single:
    return DeepLabV3Single(num_classes=num_classes, in_channels=3,
                           variant="plain", **kw)


def deeplabv3_resnet50_iekd(num_classes: int = 5, **kw) -> DeepLabV3Single:
    return DeepLabV3Single(num_classes=num_classes, variant="iekd", **kw)


def deeplabv3_resnet50_iekd_project(num_classes: int = 5,
                                    **kw) -> DeepLabV3Single:
    return DeepLabV3Single(num_classes=num_classes, variant="project", **kw)


def deeplabv3_resnet50_iekd_maxmod(num_classes: int = 5,
                                   **kw) -> DeepLabV3Single:
    return DeepLabV3Single(num_classes=num_classes, variant="maxmod", **kw)


class MultiFrameSegmenter(nn.Module):
    """The reference frame and its support frames through one backbone,
    attention from each support, concatenation, 1×1 reduction, head."""

    def __init__(self, num_classes: int = 5, stem_width: int = 64,
                 block_sizes: Sequence[int] = (3, 4, 6, 3),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 aspp_rates: Sequence[int] = (12, 24, 36),
                 aspp_channels: int = 256, spatial_attention: bool = False,
                 num_supports: int = 3, in_channels: int = 1):
        super().__init__()
        self.spatial_attention = spatial_attention
        self.in_channels = in_channels
        c = widths[-1] * 4
        self.backbone = ResNetIEKD(stem_width, block_sizes, widths,
                                   in_channels=in_channels)
        self.mlp_red = nn.Conv2d(c * (1 + num_supports), c, 1, bias=False)
        self.classifier = DeepLabHead(c, num_classes, aspp_channels,
                                      aspp_rates)

    def _attend(self, f: torch.Tensor, fs: torch.Tensor) -> torch.Tensor:
        """Token attention (B, C, h, w) × (B, C, h, w) → (B, C, h, w)."""
        b, c, h, w = f.shape
        ft, fst = f.flatten(2), fs.flatten(2)           # (B, C, L), (B, C, K)
        dot = ft.transpose(1, 2) @ fst                   # (B, L, K)
        att = torch.softmax(dot.reshape(b, -1), dim=-1).reshape(dot.shape)
        return (ft @ att).reshape(b, c, h, w)            # Σ_l ft[l]·att[l, k]

    @staticmethod
    def _attend_spatial(f: torch.Tensor, fs: torch.Tensor) -> torch.Tensor:
        b = f.shape[0]
        dot = (f * fs).sum(dim=1)                        # (B, h, w)
        att = torch.softmax(dot.reshape(b, -1), dim=-1).reshape(dot.shape)
        return att[:, None] * f

    def forward(self, x: torch.Tensor, supports: Sequence[torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        hh, ww = x.shape[-3], x.shape[-2]
        f = self.backbone(_nchw_input(x, self.in_channels))
        attend = self._attend_spatial if self.spatial_attention else \
            self._attend
        attended = [attend(f, self.backbone(_nchw_input(s, self.in_channels)))
                    for s in supports]
        red = self.mlp_red(torch.cat([f] + attended, dim=1))
        logits = self.classifier(red)
        return {"out": _nhwc(resize_bilinear_nchw(logits, (hh, ww)))}


def deeplabv3_resnet50_mltfrm(num_classes: int = 5,
                              **kw) -> MultiFrameSegmenter:
    return MultiFrameSegmenter(num_classes=num_classes, **kw)


def deeplabv3_resnet50_mltfrm_spatatt(num_classes: int = 5,
                                      **kw) -> MultiFrameSegmenter:
    return MultiFrameSegmenter(num_classes=num_classes,
                               spatial_attention=True, **kw)
