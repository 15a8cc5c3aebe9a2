"""Global_and_Local, the GL-Fusion flagship, in PyTorch.

The port of ``glfusion_tpu/models/glfusion.py`` (variant
``global_and_local``):

  1. Per-view ResNet-50-IEKD backbones give f4 (B, C, h, w) per view.
  2. M_cls: the per-view classifier on f4 → sigmoid → max over the class
     channels. M_ctr: the per-view centerness head → sigmoid.
  3. Center-aware map atten = σ(w · M_cls · M_ctr); f4_local = f4 ⊙ atten.
  4. MGFM: TPAVI over the stacked f4; MLFM: TPAVI over the stacked f4_local.
  5. f4_fusion = global + local → per-view classifier → bilinear upsample to
     the input size; mask_bb = classifier(f4) upsampled.

The per-view backbones and heads are ``nn.ModuleDict``s under the
reference's names (``init_block.{v}``, ``layer{s}.{v}``, ``classifier.{v}``,
``centerness.{v}``), run in a Python loop over views. Every view starts from
the SAME initial weights: one view's stem, stages and heads are built and
``copy.deepcopy``-ed for the others, as the reference does
(``ours.py:1724-1744``) and as the JAX package does with
``split_rngs={'params': False}``. Views diverge only through their data.

At the public interface the layouts are the JAX ones: input (V, B, H, W, 1),
``mask``/``mask_bb`` (V, B, H, W, classes), ``f4_global``/``f4_local``
(V, B, h, w, C). Inside, the convolutions run in NCHW.
"""

from __future__ import annotations

import copy
from typing import Dict, List

import torch
import torch.nn as nn

from glfusion_tpu_torch.config import ModelConfig
from glfusion_tpu_torch.models.aspp import DeepLabHead
from glfusion_tpu_torch.models.resnet import iekd_stem, make_stages
from glfusion_tpu_torch.models.tpavi import TPAVI
from glfusion_tpu_torch.ops.resize import resize_bilinear_nchw


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.arch != "glfusion":
        raise NotImplementedError(
            f"arch {cfg.arch!r}: the segmentation zoo is ROADMAP M13")
    if cfg.variant != "global_and_local":
        raise NotImplementedError(
            f"variant {cfg.variant!r}: the other flagship variants are "
            "ROADMAP M11")
    if cfg.dtype != "float32":
        raise NotImplementedError(
            f"dtype {cfg.dtype!r}: bfloat16 compute is ROADMAP M10")
    if cfg.remat or cfg.remat_stages is not None:
        raise NotImplementedError("remat is ROADMAP M10")
    if len(cfg.block_sizes) != 4:
        raise ValueError("the reference names four stages, layer1..layer4")


class GlobalAndLocal(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        c = cfg.backbone_out_channels
        self.init_block = nn.ModuleDict()
        self.layer1 = nn.ModuleDict()
        self.layer2 = nn.ModuleDict()
        self.layer3 = nn.ModuleDict()
        self.layer4 = nn.ModuleDict()
        self.classifier = nn.ModuleDict()
        self.centerness = nn.ModuleDict()
        first = nn.ModuleDict({"init_block": iekd_stem(cfg.stem_width)})
        stages = make_stages(cfg.stem_width, cfg.block_sizes, cfg.widths,
                             cfg.expansion, cfg.dilate_stages)
        for s, stage in enumerate(stages, 1):
            first[f"layer{s}"] = stage
        for name, outs in (("classifier", cfg.num_classes),
                           ("centerness", 1)):
            first[name] = DeepLabHead(c, outs, cfg.aspp_channels,
                                      cfg.aspp_rates, cfg.aspp_dropout)
        for i, v in enumerate(cfg.views):
            view = first if i == 0 else copy.deepcopy(first)
            for name, mod in view.items():
                getattr(self, name)[v] = mod
        impl = "pallas" if cfg.use_pallas_fusion else "auto"
        self.global_attn = TPAVI(c, cfg.tpavi_inter_channels, impl)
        self.local_attn = TPAVI(c, cfg.tpavi_inter_channels, impl)

    def _backbone(self, v: str, x: torch.Tensor) -> torch.Tensor:
        x = self.init_block[v](x)
        for s in range(1, 5):
            x = getattr(self, f"layer{s}")[v](x)
        return x

    @staticmethod
    def _attend(attn: TPAVI, feats: List[torch.Tensor]) -> torch.Tensor:
        """TPAVI over per-view NCHW maps → (B, V, h, w, C)."""
        return attn(torch.stack(feats, dim=1).permute(0, 1, 3, 4, 2))

    def forward(self, x: torch.Tensor, is_video: bool = False,
                features_only: bool = False,
                sup_count: int | None = None) -> Dict[str, torch.Tensor]:
        """x: (V, B, H, W, 1) stacked views → dict of stacked outputs.

        Train or eval follows ``self.training``. ``is_video``,
        ``features_only`` and ``sup_count`` (the temporal, cycle-light and
        fused-pass training options) are ROADMAP M10.
        """
        if is_video or features_only or sup_count is not None:
            raise NotImplementedError(
                "is_video / features_only / sup_count are ROADMAP M10")
        cfg = self.cfg
        views = list(cfg.views)
        v_n, _, hh, ww, _ = x.shape
        if v_n != len(views):
            raise ValueError(f"input has {v_n} views, the model {len(views)}")

        # (B, 1, H, W) with standard NCHW strides. A permuted view would
        # carry channels-last strides on its size-1 channel axis, and the
        # convolutions would then run channels-last, where cuDNN's float32
        # dilated kernels are far slower (chip_smoke.py profile).
        f4 = [self._backbone(v, x[i, ..., 0].unsqueeze(1))
              for i, v in enumerate(views)]

        cls_f4, f4_local_in = [], []
        for i, v in enumerate(views):
            c = self.classifier[v](f4[i])
            cls_f4.append(c)
            m_cls = torch.sigmoid(c).amax(dim=1, keepdim=True)
            m_ctr = torch.sigmoid(self.centerness[v](f4[i]))
            atten = torch.sigmoid(cfg.center_aware_weight * m_cls * m_ctr)
            f4_local_in.append(f4[i] * atten)
        local = self._attend(self.local_attn, f4_local_in)
        glob = self._attend(self.global_attn, f4)

        masks, masks_bb = [], []
        for i, v in enumerate(views):
            # NCHW-contiguous, for the same reason as the backbone input
            fusion = (glob[:, i] + local[:, i]).permute(0, 3, 1,
                                                        2).contiguous()
            masks.append(resize_bilinear_nchw(self.classifier[v](fusion),
                                              (hh, ww)))
        for i, v in enumerate(views):
            # Eval reuses classifier(f4) from M_cls (BN frozen, dropout
            # off: the same values); train runs it again, as the reference
            # does (a second BN update, an independent dropout draw).
            bb = self.classifier[v](f4[i]) if self.training else cls_f4[i]
            masks_bb.append(resize_bilinear_nchw(bb, (hh, ww)))

        return {
            "mask": torch.stack(masks).permute(0, 1, 3, 4, 2),
            "mask_bb": torch.stack(masks_bb).permute(0, 1, 3, 4, 2),
            "f4_global": glob.transpose(0, 1),
            "f4_local": local.transpose(0, 1),
        }
