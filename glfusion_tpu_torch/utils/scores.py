"""Scalar evaluation metrics (port of ``glfusion_tpu/utils/scores.py``;
reference ``utils/metrics.py``).

The regression metrics of the mPAP path (``train/regression.py``), the
concordance index the reference intended (its ``C_index`` calls an
undefined ``concordance_index``; JAX implements it, and so does the port)
and the MONAI-style 2-class Dice. Each takes numpy arrays or tensors and
returns a 0-d tensor, computed in the inputs' floating type (float32 for
integer inputs).
"""

from __future__ import annotations

import torch


def _tensor(x) -> torch.Tensor:
    t = torch.as_tensor(x)
    return t if t.is_floating_point() else t.float()


def mse(y_true, y_pred) -> torch.Tensor:
    return torch.mean((_tensor(y_true) - _tensor(y_pred)) ** 2)


def mae(y_true, y_pred) -> torch.Tensor:
    return torch.mean(torch.abs(_tensor(y_true) - _tensor(y_pred)))


def rmse(y_true, y_pred) -> torch.Tensor:
    return torch.sqrt(mse(y_true, y_pred))


def r2(y_true, y_pred) -> torch.Tensor:
    """Coefficient of determination (sklearn ``r2_score`` semantics, with
    its constant-target edge: ss_tot == 0 gives 1.0 if ss_res == 0, else
    0.0, never inf or nan)."""
    y_true, y_pred = _tensor(y_true), _tensor(y_pred)
    ss_res = torch.sum((y_true - y_pred) ** 2)
    ss_tot = torch.sum((y_true - torch.mean(y_true)) ** 2)
    const = ss_tot == 0
    plain = 1.0 - ss_res / torch.where(const, torch.ones_like(ss_tot), ss_tot)
    return torch.where(const, (ss_res == 0).to(plain.dtype), plain)


def c_index(y_true, y_pred) -> torch.Tensor:
    """Concordance index × 100: the share of comparable pairs
    (y_true_i != y_true_j) whose predictions are ordered the same way, a
    tie in prediction counting 0.5."""
    y_true, y_pred = _tensor(y_true).ravel(), _tensor(y_pred).ravel()
    dt = y_true[:, None] - y_true[None, :]
    dp = y_pred[:, None] - y_pred[None, :]
    comparable = (dt != 0).float()
    agree = (torch.sign(dt) == torch.sign(dp)).float()
    tied = (dp == 0).float()
    num = torch.sum(comparable * (agree * (1 - tied) + 0.5 * tied))
    den = torch.sum(comparable)
    return num / torch.clamp(den, min=1.0) * 100.0


def dice_score_binary(y_true, y_pred_logits) -> torch.Tensor:
    """MONAI-style mean 2-class Dice (reference ``DiceScore``).

    y_true: (B, 1, ...) integer labels {0, 1}; y_pred_logits: (B, 2, ...)
    scores (argmax, both classes, mean over batch and classes). A sample
    whose ground truth lacks a class is NaN for it and left out of the mean
    (MONAI 1.1.0 ``DiceMetric``'s ``ignore_empty=True``)."""
    y_true = torch.as_tensor(y_true)
    pred_cls = torch.argmax(_tensor(y_pred_logits), dim=1)
    true_cls = y_true[:, 0] if y_true.dim() > pred_cls.dim() else y_true
    dices = []
    for cls in (0, 1):
        p = (pred_cls == cls).float()
        t = (true_cls == cls).float()
        axes = tuple(range(1, p.dim()))
        inter = torch.sum(p * t, dim=axes)
        t_sum = torch.sum(t, dim=axes)
        denom = torch.sum(p, dim=axes) + t_sum
        dices.append(torch.where(t_sum > 0,
                                 2 * inter / torch.clamp(denom, min=1),
                                 torch.full_like(t_sum, float("nan"))))
    return torch.nanmean(torch.stack(dices))
