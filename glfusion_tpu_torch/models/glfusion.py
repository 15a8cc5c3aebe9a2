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

``cfg.dtype`` is the compute type of every layer (``models/precision.py``;
parameters stay float32), the outputs are in it; ``cfg.remat`` and
``cfg.remat_stages`` remat the backbone's bottlenecks
(``models/resnet.py``). The cycle pass's two training forms follow JAX
(``config.TrainConfig``): ``features_only`` computes only ``f4_global``
(backbone and global attention), so the skipped heads' BN statistics do
not move on cycle frames; ``sup_count`` runs the backbone and the global
attention once over the supervised frames and the clip concatenated, BN
moments over the merged batch, and the heads and the local attention on
the supervised frames only. ``is_video`` (the ``temporal`` train option)
folds a clip's T frames into the attention's token axis, as JAX does: each
attention sees (1, T·V·h·w, C) instead of T batches of V·h·w tokens.

``GlobalAndLocalCPS`` is the cross-pseudo-supervision twin (JAX
``GlobalAndLocalCPS``): two independently initialised flagships ``net1``
and ``net2`` on the same input. ``build_model`` maps ``variant='cps'`` to
it, as JAX ``models/registry.py::build_seg_model`` does.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from glfusion_tpu_torch.config import ModelConfig
from glfusion_tpu_torch.models.aspp import DeepLabHead
from glfusion_tpu_torch.models.precision import cast, compute_dtype
from glfusion_tpu_torch.models.resnet import (iekd_stem, make_stages,
                                              remat_mask)
from glfusion_tpu_torch.models.tpavi import TPAVI
from glfusion_tpu_torch.ops.resize import resize_bilinear_nchw


# the flagship variants the port builds; the others are ROADMAP Queue 1
# item 3 (M11)
VARIANTS = ("global_and_local", "cps")


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.arch != "glfusion":
        raise NotImplementedError(
            f"arch {cfg.arch!r}: the segmentation zoo is ROADMAP M13")
    if cfg.variant not in VARIANTS:
        raise NotImplementedError(
            f"variant {cfg.variant!r}: the other flagship variants are "
            "ROADMAP Queue 1 item 3 (M11)")
    if len(cfg.block_sizes) != 4:
        raise ValueError("the reference names four stages, layer1..layer4")


class GlobalAndLocal(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        _check_supported(cfg)
        if cfg.variant != "global_and_local":
            raise ValueError(f"GlobalAndLocal is the global_and_local "
                             f"variant; build {cfg.variant!r} with "
                             f"build_model")
        self.cfg = cfg
        self.dtype = dt = compute_dtype(cfg.dtype)
        c = cfg.backbone_out_channels
        self.init_block = nn.ModuleDict()
        self.layer1 = nn.ModuleDict()
        self.layer2 = nn.ModuleDict()
        self.layer3 = nn.ModuleDict()
        self.layer4 = nn.ModuleDict()
        self.classifier = nn.ModuleDict()
        self.centerness = nn.ModuleDict()
        first = nn.ModuleDict({"init_block": iekd_stem(cfg.stem_width, dt)})
        stages = make_stages(
            cfg.stem_width, cfg.block_sizes, cfg.widths, cfg.expansion,
            cfg.dilate_stages, dt,
            remat_mask(len(cfg.block_sizes), cfg.remat, cfg.remat_stages))
        for s, stage in enumerate(stages, 1):
            first[f"layer{s}"] = stage
        for name, outs in (("classifier", cfg.num_classes),
                           ("centerness", 1)):
            first[name] = DeepLabHead(c, outs, cfg.aspp_channels,
                                      cfg.aspp_rates, cfg.aspp_dropout, dt)
        for i, v in enumerate(cfg.views):
            view = first if i == 0 else copy.deepcopy(first)
            for name, mod in view.items():
                getattr(self, name)[v] = mod
        impl = "pallas" if cfg.use_pallas_fusion else "auto"
        self.global_attn = TPAVI(c, cfg.tpavi_inter_channels, impl, dt)
        self.local_attn = TPAVI(c, cfg.tpavi_inter_channels, impl, dt)

    def _backbone(self, v: str, x: torch.Tensor) -> torch.Tensor:
        # the fused stem takes x in the compute type (its weights float32)
        x = self.init_block[v](cast(x, self.dtype))
        for s in range(1, 5):
            x = getattr(self, f"layer{s}")[v](x)
        return x

    @staticmethod
    def _attend(attn: TPAVI, feats: List[torch.Tensor],
                is_video: bool = False) -> torch.Tensor:
        """TPAVI over per-view NCHW maps → (B, V, h, w, C); with
        ``is_video`` the B frames join the token axis (JAX ``attend``)."""
        y = torch.stack(feats, dim=1).permute(0, 1, 3, 4, 2)
        if not is_video:
            return attn(y)
        b, v, h, w, c = y.shape
        return attn(y.reshape(1, b * v, h, w, c)).reshape(b, v, h, w, c)

    def forward(self, x: torch.Tensor, is_video: bool = False,
                features_only: bool = False,
                sup_count: int | None = None) -> Dict[str, torch.Tensor]:
        """x: (V, B, H, W, 1) stacked views → dict of stacked outputs.

        Train or eval follows ``self.training``. ``features_only``: only
        ``{"f4_global"}``, the backbone and the global attention.
        ``sup_count``: x is the supervised batch (its first ``sup_count``
        frames) and the cycle clip concatenated on axis 1; ``mask``,
        ``mask_bb`` and ``f4_local`` cover the supervised frames,
        ``f4_global`` the clip's. ``is_video``: x is one clip (its frames on
        axis 1), and both attentions attend over all of its frames at once.
        """
        cfg = self.cfg
        views = list(cfg.views)
        v_n, b_n, hh, ww, _ = x.shape
        if v_n != len(views):
            raise ValueError(f"input has {v_n} views, the model {len(views)}")
        if sup_count is not None:
            if features_only or is_video:
                raise ValueError("sup_count is exclusive of features_only/"
                                 "is_video")
            if not 0 < sup_count < b_n:
                raise ValueError(f"sup_count={sup_count} must split the "
                                 f"batch axis ({b_n})")

        # (B, 1, H, W) with standard NCHW strides. A permuted view would
        # carry channels-last strides on its size-1 channel axis, and the
        # convolutions would then run channels-last, where cuDNN's float32
        # dilated kernels are far slower (chip_smoke.py profile).
        f4 = [self._backbone(v, x[i, ..., 0].unsqueeze(1))
              for i, v in enumerate(views)]
        if features_only:
            return {"f4_global": self._attend(self.global_attn, f4,
                                              is_video).transpose(0, 1)}
        glob = cycle = None
        if sup_count is not None:
            # the global attention over the merged batch, then the tail
            # on the supervised frames only
            both = self._attend(self.global_attn, f4)
            glob, cycle = both[:sup_count], both[sup_count:]
            f4 = [f[:sup_count] for f in f4]

        cls_f4, f4_local_in = [], []
        for i, v in enumerate(views):
            c = self.classifier[v](f4[i])
            cls_f4.append(c)
            m_cls = torch.sigmoid(c).amax(dim=1, keepdim=True)
            m_ctr = torch.sigmoid(self.centerness[v](f4[i]))
            atten = torch.sigmoid(cfg.center_aware_weight * m_cls * m_ctr)
            f4_local_in.append(f4[i] * atten)
        local = self._attend(self.local_attn, f4_local_in, is_video)
        if glob is None:
            glob = self._attend(self.global_attn, f4, is_video)

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
            "f4_global": (glob if cycle is None else cycle).transpose(0, 1),
            "f4_local": local.transpose(0, 1),
        }


class GlobalAndLocalCPS(nn.Module):
    """Cross-pseudo-supervision twin (JAX ``GlobalAndLocalCPS``, reference
    ``models/ours.py:3141-3351``): two independently initialised
    flagships on the same input. Returns both mask sets and network 1's
    ``f4_global`` and ``f4_local``; the train step supervises each network
    with the other's thresholded predictions."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        inner = dataclasses.replace(cfg, variant="global_and_local")
        self.cfg = inner
        self.net1 = GlobalAndLocal(inner)
        self.net2 = GlobalAndLocal(inner)  # drawn after net1: other weights

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out1, out2 = self.net1(x), self.net2(x)
        return {"mask": out1["mask"], "mask_2": out2["mask"],
                "f4_global": out1["f4_global"],
                "f4_local": out1["f4_local"]}


def build_model(cfg: ModelConfig) -> Tuple[nn.Module, bool]:
    """``(model, is_cps)`` of a model configuration (JAX
    ``build_seg_model`` for ``arch='glfusion'``): ``variant='cps'`` is the
    twin, ``global_and_local`` the flagship."""
    _check_supported(cfg)
    if cfg.variant == "cps":
        return GlobalAndLocalCPS(cfg), True
    return GlobalAndLocal(cfg), False
