"""Global_and_Local, the GL-Fusion flagship, and its ablation variants, in
PyTorch.

The port of ``glfusion_tpu/models/glfusion.py``. The flagship
(``variant='global_and_local'``):

  1. Per-view ResNet-50-IEKD backbones give f4 (B, C, h, w) per view.
  2. M_cls: the per-view classifier on f4 → sigmoid → max over the class
     channels. M_ctr: the per-view centerness head → sigmoid.
  3. Center-aware map atten = σ(w · M_cls · M_ctr); f4_local = f4 ⊙ atten.
  4. MGFM: TPAVI over the stacked f4; MLFM: TPAVI over the stacked f4_local.
  5. f4_fusion = global + local → per-view classifier → bilinear upsample to
     the input size; mask_bb = classifier(f4) upsampled.

The reference's ablations are configuration switches, as in JAX
(``cfg.variant``):

* ``global_only`` / ``local_only``: one branch; f4_fusion is its output.
  ``local_only``'s cycle slot (``f4_global``) is the 1-channel atten map.
* ``cyc_nofusion`` / ``global_only_cyc_nofusion``: the mask graph of
  ``global_and_local`` / ``global_only`` with raw f4 in the cycle slot.
* ``conv_merge``: f4_fusion = ReLU(``merge``(global ‖ local)), a per-view
  1×1 conv 2C → C.
* ``fg_bg``: the global branch attends over the background f4·(1 − atten);
  the cycle slot is f4_fusion.
* ``early_fusion``: no attention; the V view images, concatenated on the
  channel axis, go through a per-view 1×1 conv V → 1 (``early_mix``) before
  each view's backbone.
* ``late_fusion``: no attention; the V views' pre-upsample logits,
  concatenated, go through a per-view 1×1 conv 5V → 5 (``late_mix``).

Only the modules a variant runs exist (JAX creates a parameter at its first
use): ``centerness`` and ``local_attn`` with the local branch,
``global_attn`` with the global one, and the 1×1 convs ``merge.{v}``,
``early_mix.{v}`` and ``late_mix.{v}`` with their variant.

The per-view backbones, heads and 1×1 convs are ``nn.ModuleDict``s under
the reference's names (``init_block.{v}``, ``layer{s}.{v}``,
``classifier.{v}``, ``centerness.{v}``), run in a Python loop over views.
Every view starts from the SAME initial weights: one view's modules are
built and ``copy.deepcopy``-ed for the others, as the reference does
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
(backbone and, where the cycle slot is the global branch's, the global
attention), so the skipped heads' BN statistics do not move on cycle
frames; ``sup_count`` runs the backbone (and that attention) once over the
supervised frames and the clip concatenated, BN moments over the merged
batch, and the rest on the supervised frames only. Neither is defined for
``fg_bg`` or ``local_only``, whose cycle slot needs the heads.
``is_video`` (the ``temporal`` train option) folds a clip's T frames into
the attention's token axis, as JAX does: each attention sees
(1, T·V·h·w, C) instead of T batches of V·h·w tokens.

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

# the branches of each mask graph: (global attention, local attention)
BRANCHES = {"global_and_local": (True, True), "global_only": (True, False),
            "local_only": (False, True), "conv_merge": (True, True),
            "fg_bg": (True, True), "early_fusion": (False, False),
            "late_fusion": (False, False)}
# the cyc_nofusion pair: their base's mask graph, raw f4 in the cycle slot
# (JAX glfusion.py:169-177)
CYC_RAW = {"cyc_nofusion": "global_and_local",
           "global_only_cyc_nofusion": "global_only"}
# variants whose cycle slot needs the heads: no features_only, no sup_count
HEADS_IN_CYCLE = ("fg_bg", "local_only")


class PointwiseConv(nn.Conv2d):
    """JAX ``PointwiseConv`` (``glfusion.py:71-80``), the variants' 1×1
    conv. JAX builds it without the model's type, so it computes in
    flax's default float32 whatever ``cfg.dtype`` is: input, weight and
    bias in float32, the result float32 (``late_fusion``'s bfloat16
    ``mask`` is float32, as in JAX), or float64 for a float64 input, where
    JAX's float32 result promotes at its next use."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._conv_forward(x.float(), self.weight.float(),
                               self.bias.float())
        return y.to(torch.promote_types(x.dtype, torch.float32))


def _check_supported(cfg: ModelConfig) -> None:
    if len(cfg.block_sizes) != 4:
        raise ValueError("the reference names four stages, layer1..layer4")


class GlobalAndLocal(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        _check_supported(cfg)
        if cfg.variant == "cps":
            raise ValueError("GlobalAndLocal is one network; build the "
                             "'cps' twin with build_model")
        self.cyc_raw = cfg.variant in CYC_RAW
        self.base = CYC_RAW.get(cfg.variant, cfg.variant)
        if self.base not in BRANCHES:
            raise ValueError(f"unknown variant {cfg.variant!r}")
        self.use_global, self.use_local = BRANCHES[self.base]
        self.cfg = cfg
        self.dtype = dt = compute_dtype(cfg.dtype)
        c = cfg.backbone_out_channels
        n_views, n_cls = len(cfg.views), cfg.num_classes
        heads = [("classifier", n_cls)]
        if self.use_local:
            heads.append(("centerness", 1))
        for name in ("init_block", "layer1", "layer2", "layer3", "layer4"):
            setattr(self, name, nn.ModuleDict())
        for name, _ in heads:
            setattr(self, name, nn.ModuleDict())
        first = nn.ModuleDict({"init_block": iekd_stem(cfg.stem_width, dt)})
        stages = make_stages(
            cfg.stem_width, cfg.block_sizes, cfg.widths, cfg.expansion,
            cfg.dilate_stages, dt,
            remat_mask(len(cfg.block_sizes), cfg.remat, cfg.remat_stages))
        for s, stage in enumerate(stages, 1):
            first[f"layer{s}"] = stage
        for name, outs in heads:
            first[name] = DeepLabHead(c, outs, cfg.aspp_channels,
                                      cfg.aspp_rates, cfg.aspp_dropout, dt)
        # the variant's 1×1 conv, one per view
        mixes = {"early_fusion": ("early_mix", n_views, 1),
                 "conv_merge": ("merge", 2 * c, c),
                 "late_fusion": ("late_mix", n_cls * n_views, n_cls)}
        if self.base in mixes:
            name, cin, cout = mixes[self.base]
            setattr(self, name, nn.ModuleDict())
            first[name] = PointwiseConv(cin, cout)
        for i, v in enumerate(cfg.views):
            view = first if i == 0 else copy.deepcopy(first)
            for name, mod in view.items():
                getattr(self, name)[v] = mod
        impl = "pallas" if cfg.use_pallas_fusion else "auto"
        if self.use_global:
            self.global_attn = TPAVI(c, cfg.tpavi_inter_channels, impl, dt)
        if self.use_local:
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
        return attn(y.reshape(1, b * v, h, w, c),
                    frames_split=True).reshape(b, v, h, w, c)

    @staticmethod
    def _stacked(feats: List[torch.Tensor]) -> torch.Tensor:
        """Per-view NCHW maps → (V, B, h, w, C)."""
        return torch.stack(feats).permute(0, 1, 3, 4, 2)

    def forward(self, x: torch.Tensor, is_video: bool = False,
                features_only: bool = False,
                sup_count: int | None = None) -> Dict[str, torch.Tensor]:
        """x: (V, B, H, W, 1) stacked views → dict of stacked outputs.

        Train or eval follows ``self.training``. ``features_only``: only
        ``{"f4_global"}``, the backbone and, where the cycle slot is the
        global branch's, the global attention. ``sup_count``: x is the
        supervised batch (its first ``sup_count`` frames) and the cycle
        clip concatenated on axis 1; ``mask``, ``mask_bb`` and ``f4_local``
        cover the supervised frames, ``f4_global`` the clip's.
        ``is_video``: x is one clip (its frames on axis 1), and the
        attentions attend over all of its frames at once.
        """
        cfg, base = self.cfg, self.base
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
            if base in HEADS_IN_CYCLE:
                raise ValueError(
                    f"sup_count (fused passes) is unsupported for "
                    f"{cfg.variant!r} (its cycle features need the "
                    "classifier heads)")
        if features_only and base in HEADS_IN_CYCLE:
            raise ValueError(
                f"features_only is unsupported for {cfg.variant!r} "
                "(its cycle features need the classifier heads)")

        # (B, 1, H, W) with standard NCHW strides. A permuted view would
        # carry channels-last strides on its size-1 channel axis, and the
        # convolutions would then run channels-last, where cuDNN's float32
        # dilated kernels are far slower (chip_smoke.py profile).
        images = [x[i, ..., 0].unsqueeze(1) for i in range(v_n)]
        if base == "early_fusion":
            # the V view images as channels, mixed V → 1 in each view
            concat = x[..., 0].transpose(0, 1).contiguous()  # (B, V, H, W)
            images = [self.early_mix[v](concat) for v in views]
        f4 = [self._backbone(v, images[i]) for i, v in enumerate(views)]
        # the cycle slot is the global branch's output
        cycle_global = self.use_global and base != "fg_bg" and not self.cyc_raw
        if features_only:
            if cycle_global:
                return {"f4_global": self._attend(
                    self.global_attn, f4, is_video).transpose(0, 1)}
            return {"f4_global": self._stacked(f4)}
        glob = cycle = None
        if sup_count is not None:
            # the global attention over the merged batch (where the cycle
            # slot reads it), then the tail on the supervised frames only
            if cycle_global:
                both = self._attend(self.global_attn, f4)
                glob, cycle = both[:sup_count], both[sup_count:]
                cycle = cycle.transpose(0, 1)
            else:
                cycle = self._stacked([f[sup_count:] for f in f4])
            f4 = [f[:sup_count] for f in f4]

        cls_f4, atten = [], []
        local = None
        if self.use_local:
            f4_local_in = []
            for i, v in enumerate(views):
                c = self.classifier[v](f4[i])
                cls_f4.append(c)
                m_cls = torch.sigmoid(c).amax(dim=1, keepdim=True)
                m_ctr = torch.sigmoid(self.centerness[v](f4[i]))
                atten.append(torch.sigmoid(
                    cfg.center_aware_weight * m_cls * m_ctr))
                f4_local_in.append(f4[i] * atten[i])
            local = self._attend(self.local_attn, f4_local_in, is_video)
        if self.use_global and glob is None:
            g_in = ([f * (1.0 - a) for f, a in zip(f4, atten)]
                    if base == "fg_bg" else f4)
            glob = self._attend(self.global_attn, g_in, is_video)

        fusions, logits = [], []
        for i, v in enumerate(views):
            if base in ("early_fusion", "late_fusion"):
                fusion = f4[i]
            else:
                parts = ([glob[:, i]] if self.use_global else []) + (
                    [local[:, i]] if self.use_local else [])
                if base == "conv_merge":
                    fusion = torch.relu(self.merge[v](torch.cat(
                        parts, dim=-1).permute(0, 3, 1, 2).contiguous()))
                else:  # NCHW-contiguous, for the same reason as the input
                    fusion = sum(parts[1:], parts[0]).permute(
                        0, 3, 1, 2).contiguous()
            fusions.append(fusion)
            logits.append(self.classifier[v](fusion))
        if base in ("early_fusion", "late_fusion") and not self.training:
            # the pre-mix logits decode raw f4: classifier(f4) in eval
            cls_f4 = logits
        if base == "late_fusion":
            # the V views' logits as channels, mixed 5V → 5 in each view
            concat = torch.cat(logits, dim=1)
            logits = [self.late_mix[v](concat) for v in views]
        masks = [resize_bilinear_nchw(m, (hh, ww)) for m in logits]
        masks_bb = []
        for i, v in enumerate(views):
            # Eval reuses classifier(f4) (BN frozen, dropout off: the same
            # values); train runs it again, as the reference does (a second
            # BN update, an independent dropout draw).
            bb = (cls_f4[i] if cls_f4 and not self.training
                  else self.classifier[v](f4[i]))
            masks_bb.append(resize_bilinear_nchw(bb, (hh, ww)))

        # the cycle slot: each reference class's third return value
        if cycle is None:
            if self.cyc_raw or not (self.use_global or self.use_local):
                cycle = self._stacked(f4)
            elif base == "fg_bg":
                cycle = self._stacked(fusions)
            elif base == "local_only":
                cycle = self._stacked(atten)
            else:
                cycle = glob.transpose(0, 1)
        return {
            "mask": self._stacked(masks),
            "mask_bb": self._stacked(masks_bb),
            "f4_global": cycle,
            "f4_local": (local.transpose(0, 1) if local is not None
                         else self._stacked(f4)),
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
    twin, every other variant a ``GlobalAndLocal``."""
    _check_supported(cfg)
    if cfg.variant == "cps":
        return GlobalAndLocalCPS(cfg), True
    return GlobalAndLocal(cfg), False
