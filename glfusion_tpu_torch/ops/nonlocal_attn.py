"""Dot-product non-local attention core, the TPAVI hot op, in plain matmuls.

The port of ``glfusion_tpu/ops/nonlocal_attn.py``. Over N tokens with C'
channels the reference computes ``y = (θφᵀ / N)·g``. Two orders:

* ``naive``: materialize the (B, N, N) map, the reference order;
* ``reassoc``: ``θ(φᵀg) / N`` through a (B, C', C') intermediate, equal in
  real arithmetic and cheaper when N > C'.

``auto`` takes ``reassoc`` when N > C'. As in JAX
(``preferred_element_type=float32``), both orders take float32 products of
the operands, keep the intermediate in float32 and return float32 whatever
the input type. The hand-written kernel of the same function, in the same
cheaper order, is ``glfusion_tpu_torch.ops.tpavi_fused``.
"""

from __future__ import annotations

import torch


def dot_nonlocal_attention(theta: torch.Tensor, phi: torch.Tensor,
                           g: torch.Tensor, *, impl: str = "auto"
                           ) -> torch.Tensor:
    """y[b,i,:] = sum_j <theta[b,i], phi[b,j]> / N * g[b,j] on (B, N, C'),
    float32 (float64 for float64 operands)."""
    n, c = theta.shape[-2], theta.shape[-1]
    if impl == "auto":
        impl = "reassoc" if n > c else "naive"
    acc = torch.promote_types(theta.dtype, torch.float32)
    theta, phi, g = (x.to(acc) for x in (theta, phi, g))
    if impl == "reassoc":
        pg = torch.bmm(phi.transpose(1, 2), g)   # (B, C', C')
        return torch.bmm(theta, pg) / n
    if impl == "naive":
        f = torch.bmm(theta, phi.transpose(1, 2))  # (B, N, N)
        return torch.bmm(f / n, g)
    raise ValueError(f"unknown impl {impl!r}")
