"""Segmentation overlap metrics from confusion counts.

The port of ``glfusion_tpu/train/metrics.py`` (reference ``main.py:800-815``
and the per-part Dice of ``main.py:537-543``): prediction = sigmoid(logit)
> 0.5, i.e. logit > 0; tp/fp/fn/tn summed on the device; ratios with
eps 1e-5 computed at report time (they work on tensors, numpy arrays and
floats alike).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

EPS = 1e-5


def confusion_counts(pred_binary: torch.Tensor, target: torch.Tensor,
                     dim=None) -> Dict[str, torch.Tensor]:
    """tp/fp/fn/tn sums; ``dim=None`` reduces everything."""
    p = pred_binary.float()
    t = target.float()

    def total(v):
        return v.sum() if dim is None else v.sum(dim=dim)

    return {"tp": total(p * t), "fp": total(p * (1.0 - t)),
            "fn": total((1.0 - p) * t), "tn": total((1.0 - p) * (1.0 - t))}


def overlap_metrics(counts: Dict) -> Dict:
    tp, fp, fn, tn = counts["tp"], counts["fp"], counts["fn"], counts["tn"]
    return {
        "pixel_acc": (tp + tn) / (tp + tn + fp + fn + EPS),
        "dice": (2 * tp) / (2 * tp + fp + fn + EPS),
        "precision": tp / (tp + fp + EPS),
        "specificity": tn / (tn + fp + EPS),
        "recall": tp / (tp + fn + EPS),
    }


def _logit(p: float) -> float:
    return math.log(p / (1.0 - p))


def per_part_dice(logits: torch.Tensor, target: torch.Tensor,
                  class_axis: int = -1, threshold: float = 0.5
                  ) -> torch.Tensor:
    """Dice per structure channel."""
    pred = (logits > _logit(threshold)).float()
    axes = tuple(i for i in range(logits.dim())
                 if i != class_axis % logits.dim())
    c = confusion_counts(pred, target, dim=axes)
    return (2 * c["tp"]) / (2 * c["tp"] + c["fp"] + c["fn"] + EPS)
