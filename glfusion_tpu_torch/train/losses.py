"""Losses: sum-reduced BCE with logits and the temporal cycle-consistency
loss.

The port of ``glfusion_tpu/train/losses.py`` (reference ``main.py:87``,
``seg_cycle`` ``main.py:650-717``, ``dense_seg_cycle`` ``main.py:719-798``).
The sampled chunk start of ``seg_cycle_loss`` is drawn from a
``torch.Generator`` (the JAX function draws it from a PRNG key, so the two
agree only through ``dense_seg_cycle_loss`` or an explicit one-hot).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _bce_elems(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    # max(x, 0) − x·t + log1p(exp(−|x|)): torch's stable form
    return x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))


def bce_with_logits_sum(logits: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable sum-reduced binary cross entropy with logits."""
    return _bce_elems(logits, targets).sum()


def _windows(n: int, width: int, offset: int, device) -> torch.Tensor:
    """(n, width) indices (i + offset + j) mod n."""
    ar = torch.arange(n, device=device)[:, None]
    return (ar + offset + torch.arange(width, device=device)[None, :]) % n


def _cycle_from_start(feat: torch.Tensor, start_onehot: torch.Tensor,
                      target_region: int, cyc_off: int, chunk: int,
                      temperature: float,
                      bce_target: torch.Tensor | None = None) -> torch.Tensor:
    """Cycle-consistency BCE for one chunk start.

    feat: (T, D) per-frame pooled features; start_onehot: (S,) hard one-hot
    with S = target_region − (chunk + cyc_off) + 1 selecting the query
    window; ``bce_target`` (default the one-hot) is the BCE label only.
    """
    t_total, d = feat.shape
    dev = feat.device
    query = feat[:target_region]
    query_cyc = feat[cyc_off:target_region]
    key = feat[target_region:]
    k = t_total - target_region
    s = target_region - (chunk + cyc_off) + 1

    win_idx = (torch.arange(s, device=dev)[:, None]
               + torch.arange(chunk, device=dev)[None, :])
    query_feat = torch.einsum("s,scd->cd", start_onehot, query[win_idx])

    dist = ((key[:, None, :] - query_feat[None, :, :]) ** 2).sum(-1)
    dist_shft = torch.gather(dist, 0, _windows(k, chunk, 0, dev))
    window = dist_shft[:k - (chunk + cyc_off) + 1]
    sim = -window.sum(1)
    beta = F.softmax(sim / d / chunk * temperature, dim=0)

    key_windows = key[_windows(k, chunk, cyc_off, dev)][
        :k - (chunk + cyc_off) + 1]
    weighted = torch.einsum("k,kcd->cd", beta, key_windows)

    q = target_region - cyc_off
    qdist = ((query_cyc[:, None, :] - weighted[None, :, :]) ** 2).sum(-1)
    qdist_shft = torch.gather(qdist, 0, _windows(q, chunk, 0, dev))
    qwindow = qdist_shft[:q - chunk + 1]
    q_sim = -qwindow.sum(1) / d / chunk * temperature

    target = start_onehot if bce_target is None else bce_target
    return _bce_elems(q_sim, target).mean()


def seg_cycle_loss(generator: torch.Generator, feat: torch.Tensor, *,
                   target_region: int = 16, cyc_off: int = 2, chunk: int = 3,
                   temperature: float = 10.0) -> torch.Tensor:
    """Sampled-start cycle loss (reference ``seg_cycle``)."""
    s = target_region - (chunk + cyc_off) + 1
    start = torch.randint(0, s, (), generator=generator,
                          device=generator.device)
    onehot = F.one_hot(start.to(feat.device), s).to(feat.dtype)
    return _cycle_from_start(feat, onehot, target_region, cyc_off, chunk,
                             temperature)


def dense_seg_cycle_loss(feat: torch.Tensor, *, target_region: int = 16,
                         cyc_off: int = 2, chunk: int = 3,
                         temperature: float = 10.0, soft_label: bool = False,
                         is_overlap: bool = True) -> torch.Tensor:
    """All-starts cycle loss (reference ``dense_seg_cycle``); the summed
    loss is divided by S whatever the step, as the reference does."""
    s = target_region - (chunk + cyc_off) + 1
    step = 1 if is_overlap else chunk
    eye = torch.eye(s, dtype=feat.dtype, device=feat.device)
    total = feat.new_zeros(())
    for start in range(0, s, step):
        onehot = eye[start]
        target = onehot
        if soft_label:  # softens the BCE target only, never the selection
            target = torch.where(onehot == 1.0, 0.8, 0.2 / max(s - 1, 1))
        total = total + _cycle_from_start(feat, onehot, target_region,
                                          cyc_off, chunk, temperature,
                                          bce_target=target)
    return total / s
