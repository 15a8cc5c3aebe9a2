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

The function is a registered op (``torch.library.custom_op``,
``glfusion_tpu_torch::fused_dot_nonlocal``) with a fake implementation
and its autograd formula, so ``torch.export`` records the kernel as one
node and an exported serving program runs it after importing this module
alone. ``fused_dot_nonlocal`` takes the plain version only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.
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
# split K (csrc/tpavi_fused.cu): stage 1 over more than 2·SPLIT_K tokens
# runs as partial products over chunks of SPLIT_K tokens, then a fixed-order
# sum of the partials
SPLIT_K = 4096


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
    products and a float32 intermediate, and over a long token axis the
    same split K (partials over chunks of SPLIT_K tokens, summed in chunk
    order); the only rounding to the input type is the output's. (The
    bfloat16 kernel's hi/lo intermediate, and its hi/lo partials in split
    K, differ from float32 by about 2⁻¹⁷ relative.)"""
    n, c = theta.shape[-2:]
    f32 = torch.float32
    t, p, gg = (x.to(f32) for x in (theta, phi, g))
    if not reassociated(n, c):
        y = torch.bmm(torch.bmm(t, p.transpose(1, 2)), gg)
    elif n > 2 * SPLIT_K:
        m = None
        for first in range(0, n, SPLIT_K):
            chunk = slice(first, first + SPLIT_K)
            part = torch.bmm(p[:, chunk].transpose(1, 2), gg[:, chunk])
            m = part if m is None else m + part
        y = torch.bmm(t, m)
    else:
        y = torch.bmm(t, torch.bmm(p.transpose(1, 2), gg))
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
    lib.tpavi_split_reduce.argtypes = [
        i, p, ll, ll, ll, i, p, ll, ll, i, i, i, ll, i, p]
    lib.tpavi_split_reduce.restype = i
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
        _raise_on(lib, lib.tpavi_gemm(
            _DTYPE_CODES[c.dtype], int(a_mn), int(b_mn), a.data_ptr(),
            *_strides(a), b.data_ptr(), *_strides(b), c.data_ptr(),
            *_strides(c), c_lo, split, c.shape[0], m, n, k, float(div),
            dev.index, stream))

    return run


def _raise_on(lib, err: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"fused_dot_nonlocal: kernel launch failed with CUDA error "
            f"{err} ({lib.tpavi_error_string(err).decode()})")


def _split_stage1(phi: torch.Tensor, g: torch.Tensor, ws: torch.Tensor,
                  c_pad: int, c_lo: int) -> Callable[[], None]:
    """Stage 1 of the reassociated order, M = φᵀg, in split K: for each
    batch element the engine's partial products over the token chunks
    [0, SPLIT_K), [SPLIT_K, 2·SPLIT_K), ... (one batched launch) and the
    remainder (a second), into a (B, P, halves, rows, ld) workspace; then
    ``tpavi_split_reduce`` sums the P partials in chunk order into ``ws``."""
    lib = _library()
    b, n, _ = phi.shape
    full, rest = divmod(n, SPLIT_K)
    parts = full + (rest > 0)
    _, halves, rows, ld = ws.shape
    part = torch.empty((b, parts, halves, rows, ld), dtype=ws.dtype,
                       device=ws.device)
    runs = []
    for bi in range(b):
        chunks = [(0, full, SPLIT_K)] if full else []
        if rest:
            chunks.append((full, 1, rest))
        for first, count, k in chunks:
            a_op, b_op = (t[bi, first * SPLIT_K:first * SPLIT_K + count * k]
                          .view(count, k, t.shape[-1]) for t in (phi, g))
            runs.append(_gemm(a_op, True, b_op, True,
                              part[bi, first:first + count, 0], c_pad, c_pad,
                              k, 1.0, c_lo=c_lo))
    dev = ws.device

    def run() -> None:
        for r in runs:
            r()
        _raise_on(lib, lib.tpavi_split_reduce(
            _DTYPE_CODES[ws.dtype], part.data_ptr(), part.stride(0),
            part.stride(1), rows * ld, parts, ws.data_ptr(), ws.stride(0),
            rows * ld, b, c_pad, c_pad, ld, dev.index,
            torch.cuda.current_stream(dev).cuda_stream))

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
    """The two stages of one call on CUDA operands, with the output they
    fill: ``(order, stage1, stage2, out)``. Run stage1, then stage2. Stage
    1 is one launch, or in split K (N > 2·SPLIT_K in the reassociated
    order) the partial products' launches and their sum's."""
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
    if reassociated(n, c) and n > 2 * SPLIT_K:
        stage1 = _split_stage1(phi, g, ws, c_pad, c_lo)
        stage2 = _gemm(theta, False, split_ws, True, out, n, c_pad, c_pad, n,
                       split=2 if c_lo else 0)
        order = "theta(phi^T g), split K"
    elif reassociated(n, c):
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


@torch.library.custom_op("glfusion_tpu_torch::fused_dot_nonlocal",
                         mutates_args=())
def _fused_dot_nonlocal_op(theta: torch.Tensor, phi: torch.Tensor,
                           g: torch.Tensor) -> torch.Tensor:
    """The registered op: the plain version for CPU operands, the kernel
    (or an error) for any other."""
    if theta.device.type == "cpu":
        return fused_dot_nonlocal_plain(theta, phi, g)
    return _launch(theta, phi, g)


@_fused_dot_nonlocal_op.register_fake
def _(theta, phi, g):
    # shapes only: any batch (a symbolic frame axis under torch.export)
    if theta.dim() != 3 or theta.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_dot_nonlocal: {theta.dtype} "
                         f"{tuple(theta.shape)}; need (B, N, C') float32 "
                         f"or bfloat16")
    return theta.new_empty(theta.shape)


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, dy):
    """Reassociated backward (no N×N map): dθ = dy(gᵀφ)/N,
    dφ = g(dyᵀθ)/N, dg = φ(θᵀdy)/N, in float32 (JAX's ``_fdn_bwd``)."""
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
    return (dtheta.to(theta.dtype), dphi.to(phi.dtype), dg.to(g.dtype))


_fused_dot_nonlocal_op.register_autograd(_backward,
                                         setup_context=_setup_context)


def fused_dot_nonlocal(theta: torch.Tensor, phi: torch.Tensor,
                       g: torch.Tensor) -> torch.Tensor:
    """y[b] = (θ[b]·φ[b]ᵀ / N)·g[b] for (B, N, C') operands, trainable.

    The registered op ``torch.ops.glfusion_tpu_torch.fused_dot_nonlocal``,
    which ``torch.export`` records as one node (an exported program needs
    only this module to run it). CPU tensors take
    :func:`fused_dot_nonlocal_plain`; CUDA tensors launch the kernel
    (counted once a call in ``fused_dot_nonlocal.launches``) or raise;
    operands on any other device are refused here, before the op.
    """
    if theta.device.type != "cpu":
        _check(theta, phi, g)
    return torch.ops.glfusion_tpu_torch.fused_dot_nonlocal(theta, phi, g)


fused_dot_nonlocal.launches = 0
