"""torchvision ImageNet ResNet-50 state dict → the flagship's backbones.

The port of ``glfusion_tpu/utils/imagenet_init.py``. The reference starts
from an ImageNet-pretrained backbone: ``_segm_model_iekd`` builds
``torchvision.models.resnet50(pretrained=True)`` (``models/segmentation.py:
197-207``), then replaces only ``conv1`` with a fresh 1-channel stride-1 conv
(``models/_utils.py:192``); every view's backbone is a deep copy of that one
template (``models/ours.py:1724-1734``).

The port keeps the reference's module names, so this is a renaming and a
filter, not a layout conversion, from a LOCAL torchvision ``resnet50`` file:

  * ``layer{s}.{b}.*`` → ``layer{s}.{view}.{b}.*`` in every view;
  * ``bn1.*`` → ``init_block.{view}.1.*`` (the stem's BN, JAX's
    ``backbone/stem_bn``); ``FusedIEKDStem`` has the same keys;
  * ``conv1.*`` (the replaced stem conv) and ``fc.*`` are skipped, and so is
    each BN's ``num_batches_tracked``: JAX has no such counter, and the
    model's own stays.

As in JAX, a missing key raises ``KeyError``, and a shape the model does not
have or a name it lacks raises ``ValueError``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from glfusion_tpu_torch.config import ModelConfig

_BN = ("weight", "bias", "running_mean", "running_var")


def convert_torchvision_resnet(sd: Mapping[str, torch.Tensor],
                               cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """torchvision resnet50-style state dict → the port's backbone keys of
    every view (no stem conv, no classifier)."""
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    out: Dict[str, torch.Tensor] = {}

    def put(tkey: str, dst: str, names) -> None:
        for view in cfg.views:
            for n in names:
                out[dst.format(view=view) + "." + n] = sd[f"{tkey}.{n}"]

    put("bn1", "init_block.{view}.1", _BN)
    for s, blocks in enumerate(cfg.block_sizes, start=1):
        for b in range(blocks):
            src, dst = f"layer{s}.{b}", f"layer{s}.{{view}}.{b}"
            for j in (1, 2, 3):
                put(f"{src}.conv{j}", f"{dst}.conv{j}", ("weight",))
                put(f"{src}.bn{j}", f"{dst}.bn{j}", _BN)
            if f"{src}.downsample.0.weight" in sd:
                put(f"{src}.downsample.0", f"{dst}.downsample.0",
                    ("weight",))
                put(f"{src}.downsample.1", f"{dst}.downsample.1", _BN)
    return out


def merge_backbone(state_dict: Mapping[str, torch.Tensor],
                   converted: Mapping[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """``state_dict`` with the converted entries put in, shape-checked and in
    the model's types; every other entry (the stem conv, the heads, the
    attentions) keeps its value."""
    out = dict(state_dict)
    for k, v in converted.items():
        if k not in out:
            raise ValueError(
                f"ImageNet backbone names a parameter the model lacks: {k}")
        if tuple(out[k].shape) != tuple(v.shape):
            raise ValueError(
                f"ImageNet backbone shape mismatch at {k}: model has "
                f"{tuple(out[k].shape)}, state dict gives {tuple(v.shape)} "
                f"— the file is not a torchvision resnet50 matching this "
                f"config")
        out[k] = v.to(out[k].dtype)
    return out


def load_imagenet_backbone(path: str, cfg: ModelConfig
                           ) -> Dict[str, torch.Tensor]:
    """Read a local torchvision ``resnet50`` .pth (the raw state dict or a
    ``{'state_dict': ...}`` wrapper) and convert it."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    sd = data.get("state_dict", data) if isinstance(data, dict) else data
    return convert_torchvision_resnet(sd, cfg)
