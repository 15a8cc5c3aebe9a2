"""TPAVI dot non-local attention: y = (θφᵀ / N)·g on (B, N, C').

The port of ``glfusion_tpu/ops/tpavi_pallas.py``. The forward is the
hand-written CUDA source ``glfusion_tpu_torch/csrc/tpavi_fused.cu``: the
TPU kernel's function in the cheaper contraction order, as two launches of
one batched-GEMM engine (FFMA register tiles for float32, wgmma fed by TMA
for bfloat16). At N > C' it forms M = φᵀg (C' × C') and then θM/N, so the
N×N map never exists; at N <= C' it forms S = θφᵀ (N × N) and then Sg/N.
The intermediate keeps float32 precision, as in the JAX package: float32
in a float32 call, a bfloat16 hi/lo pair (M_hi = bf16(M),
M_lo = bf16(M − M_hi)) in a bfloat16 call, whose two halves stage 2
contracts into one float32 sum. Accumulation is float32; operands and
output are float32 or bfloat16. The backward is the three reassociated
products of the JAX custom VJP, which are plain products there too.

``fused_dot_nonlocal`` takes the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch

from glfusion_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "tpavi_fused"
# bfloat16 operands go through TMA, which needs 16-byte aligned rows;
# float32 workspace rows are padded to 16 bytes for the vector copies
_ROW_ALIGN = {torch.float32: 4, torch.bfloat16: 8}


def reassociated(n: int, c: int) -> bool:
    """The kernel's order: θ(φᵀg) when N > C', else (θφᵀ)g."""
    return n > c


def fused_dot_nonlocal_naive(theta: torch.Tensor, phi: torch.Tensor,
                             g: torch.Tensor) -> torch.Tensor:
    """The reference's naive chain (θφᵀ/N)·g with the N×N map
    materialized, in float32 (float64 for float64 operands), cast back to
    the input type: the check independent of the kernel's order."""
    n = theta.shape[-2]
    acc = torch.promote_types(theta.dtype, torch.float32)
    f = torch.bmm(theta.to(acc), phi.to(acc).transpose(1, 2))
    return torch.bmm(f / n, g.to(acc)).to(theta.dtype)


def fused_dot_nonlocal_plain(theta: torch.Tensor, phi: torch.Tensor,
                             g: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: the same order, float32
    products and a float32 intermediate; the only rounding to the input
    type is the output's. (The bfloat16 kernel's hi/lo intermediate differs
    from float32 by about 2⁻¹⁷ relative.)"""
    n, c = theta.shape[-2:]
    f32 = torch.float32
    t, p, gg = (x.to(f32) for x in (theta, phi, g))
    if reassociated(n, c):
        y = torch.bmm(t, torch.bmm(p.transpose(1, 2), gg))
    else:
        y = torch.bmm(torch.bmm(t, p.transpose(1, 2)), gg)
    return (y / n).to(theta.dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    lib = _build.load(_SOURCE)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.tpavi_gemm.argtypes = [
        i, i, i, p, ll, ll, p, ll, ll, p, ll, ll, ll, i, i, i, i, i,
        ctypes.c_float, i, p]
    lib.tpavi_gemm.restype = i
    lib.tpavi_error_string.argtypes = [i]
    lib.tpavi_error_string.restype = ctypes.c_char_p
    return lib


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _strides(t: torch.Tensor) -> tuple[int, int]:
    """(batch stride, row stride); a batch of one gets a dense batch
    stride, whatever torch reports for it."""
    sb = t.stride(0) if t.shape[0] > 1 else t.shape[1] * t.stride(1)
    return sb, t.stride(1)


def _tma_ready(t: torch.Tensor) -> bool:
    """A bfloat16 operand whose base and strides are 16-byte multiples."""
    sb, ld = _strides(t)
    return t.data_ptr() % 16 == 0 and sb % 8 == 0 and ld % 8 == 0


def _gemm(a: torch.Tensor, a_mn: bool, b: torch.Tensor, b_mn: bool,
          c: torch.Tensor, m: int, n: int, k: int, div: float,
          c_lo: int = 0, split: int = 0) -> Callable[[], None]:
    """One launch of the engine, C = A·B / div, as a closure. A is (B, K, M)
    in memory if ``a_mn``, else (B, M, K); B is (B, K, N) if ``b_mn``, else
    (B, N, K); C is (B, M, ≥N). bfloat16 only: ``c_lo`` > 0 also writes
    bf16(C − bf16(C)) ``c_lo`` elements after each output; ``split`` = 1
    (2) takes A (B) as (2B, ...) hi/lo pairs and sums both products."""
    lib = _library()
    dev = c.device

    def run() -> None:  # holds a, b and c alive as long as it lives
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tpavi_gemm(
            _DTYPE_CODES[c.dtype], int(a_mn), int(b_mn), a.data_ptr(),
            *_strides(a), b.data_ptr(), *_strides(b), c.data_ptr(),
            *_strides(c), c_lo, split, c.shape[0], m, n, k, float(div),
            dev.index, stream)
        if err != 0:
            raise RuntimeError(
                f"fused_dot_nonlocal: kernel launch failed with CUDA error "
                f"{err} ({lib.tpavi_error_string(err).decode()})")

    return run


def _check(theta: torch.Tensor, phi: torch.Tensor, g: torch.Tensor) -> None:
    """Dtype, shape and channel stride, then the device."""
    if theta.dtype not in _DTYPE_CODES or not (
            theta.dtype == phi.dtype == g.dtype):
        raise TypeError(
            f"fused_dot_nonlocal: dtypes {theta.dtype}, {phi.dtype}, "
            f"{g.dtype}; the kernel takes float32 or bfloat16, all alike")
    if theta.dim() != 3 or not (theta.shape == phi.shape == g.shape):
        raise ValueError(
            f"fused_dot_nonlocal: shapes {tuple(theta.shape)}, "
            f"{tuple(phi.shape)}, {tuple(g.shape)}; need three equal "
            f"(B, N, C')")
    if min(theta.shape) <= 0:
        raise ValueError(
            f"fused_dot_nonlocal: (B, N, C') = {tuple(theta.shape)}; the "
            f"kernel takes no empty dimension")
    for name, t in (("theta", theta), ("phi", phi), ("g", g)):
        if t.stride(2) != 1:
            raise ValueError(
                f"fused_dot_nonlocal: {name} has channel stride "
                f"{t.stride(2)}; the kernel needs contiguous channels")
    dev = theta.device
    if dev.type != "cuda" or phi.device != dev or g.device != dev:
        raise ValueError(
            f"fused_dot_nonlocal: operands on {theta.device}, {phi.device}, "
            f"{g.device}; the kernel needs all three on one CUDA device")


def stages(theta: torch.Tensor, phi: torch.Tensor, g: torch.Tensor
           ) -> tuple[str, Callable[[], None], Callable[[], None],
                      torch.Tensor]:
    """The two launches of one call on CUDA operands, with the output they
    fill: ``(order, stage1, stage2, out)``. Run stage1, then stage2."""
    _check(theta, phi, g)
    b, n, c = theta.shape
    dt = theta.dtype
    c_pad = c
    if dt == torch.bfloat16 and not all(map(_tma_ready, (theta, phi, g))):
        # rows TMA cannot address in place: one zero-padded copy each
        c_pad = _round_up(c, _ROW_ALIGN[dt])
        theta, phi, g = (torch.nn.functional.pad(t, (0, c_pad - c))
                         for t in (theta, phi, g))
    out = torch.empty((b, n, c_pad), dtype=dt, device=theta.device)
    # the intermediate's workspace: (B, rows, ld) in float32; in bfloat16
    # (B, 2, rows, ld), the hi and lo halves, read by stage 2 as (2B, ...)
    rows = c_pad if reassociated(n, c) else n
    halves = 2 if dt == torch.bfloat16 else 1
    ws = torch.empty((b, halves, rows, _round_up(rows, _ROW_ALIGN[dt])),
                     dtype=dt, device=theta.device)
    c_lo = ws[0, 0].numel() if halves == 2 else 0
    split_ws = ws.view(b * halves, *ws.shape[2:])
    if reassociated(n, c):
        stage1 = _gemm(phi, True, g, True, ws[:, 0], c_pad, c_pad, n, 1.0,
                       c_lo=c_lo)
        stage2 = _gemm(theta, False, split_ws, True, out, n, c_pad, c_pad, n,
                       split=2 if c_lo else 0)
        order = "theta(phi^T g)"
    else:
        stage1 = _gemm(theta, False, phi, False, ws[:, 0], n, n, c_pad, 1.0,
                       c_lo=c_lo)
        stage2 = _gemm(split_ws, False, g, True, out, n, c_pad, n, n,
                       split=1 if c_lo else 0)
        order = "(theta phi^T)g"
    if c_pad != c:
        out = out[..., :c]
    return order, stage1, stage2, out


def _launch(theta: torch.Tensor, phi: torch.Tensor,
            g: torch.Tensor) -> torch.Tensor:
    """Check the operands and launch both stages on the current stream."""
    _, stage1, stage2, out = stages(theta, phi, g)
    stage1()
    stage2()
    fused_dot_nonlocal.launches += 1
    return out


class _FusedDotNonlocal(torch.autograd.Function):
    """Kernel forward, reassociated backward (no N×N map either way):
    dθ = dy(gᵀφ)/N, dφ = g(dyᵀθ)/N, dg = φ(θᵀdy)/N, in float32."""

    @staticmethod
    def forward(ctx, theta, phi, g):
        ctx.save_for_backward(theta, phi, g)
        if theta.device.type == "cpu":
            return fused_dot_nonlocal_plain(theta, phi, g)
        return _launch(theta, phi, g)

    @staticmethod
    def backward(ctx, dy):
        theta, phi, g = ctx.saved_tensors
        n = theta.shape[-2]
        f32 = torch.float32
        t, p, gg, d = (x.to(f32) for x in (theta, phi, g, dy))
        gtp = torch.bmm(gg.transpose(1, 2), p)     # (B, C', C') = gᵀφ
        dtheta = torch.bmm(d, gtp) / n
        dyt = torch.bmm(d.transpose(1, 2), t)      # dyᵀθ
        dphi = torch.bmm(gg, dyt) / n
        tdy = torch.bmm(t.transpose(1, 2), d)      # θᵀdy
        dg = torch.bmm(p, tdy) / n
        return (dtheta.to(theta.dtype), dphi.to(phi.dtype),
                dg.to(g.dtype))


def fused_dot_nonlocal(theta: torch.Tensor, phi: torch.Tensor,
                       g: torch.Tensor) -> torch.Tensor:
    """y[b] = (θ[b]·φ[b]ᵀ / N)·g[b] for (B, N, C') operands, trainable.

    CPU tensors take :func:`fused_dot_nonlocal_plain`; CUDA tensors launch
    the kernel (counted once a call in ``fused_dot_nonlocal.launches``) or
    raise.
    """
    return _FusedDotNonlocal.apply(theta, phi, g)


fused_dot_nonlocal.launches = 0
