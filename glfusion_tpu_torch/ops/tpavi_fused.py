"""Fused TPAVI dot non-local attention: y = (θφᵀ / N)·g on (B, N, C').

The port of ``glfusion_tpu/ops/tpavi_pallas.py``. The forward is the
hand-written CUDA kernel ``glfusion_tpu_torch/csrc/tpavi_fused.cu`` (naive
order, the N×N map never leaves the chip, float32 accumulation, float32 or
bfloat16 in and out). The backward is the three reassociated products of
the JAX custom VJP, which are plain products there too.

``fused_dot_nonlocal`` takes the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from glfusion_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHANNELS = 1024  # the kernel keeps 4 channels × 256 threads in registers
_SOURCE = "tpavi_fused"


def fused_dot_nonlocal_plain(theta: torch.Tensor, phi: torch.Tensor,
                             g: torch.Tensor) -> torch.Tensor:
    """The naive chain (θφᵀ/N)·g in float32, cast back to the input type.

    The reference order of the kernel; the N×N map is materialized.
    """
    n = theta.shape[-2]
    f32 = torch.float32
    f = torch.bmm(theta.to(f32), phi.to(f32).transpose(1, 2))
    return torch.bmm(f / n, g.to(f32)).to(theta.dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    lib = _build.load(_SOURCE)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.tpavi_fused_dot_nonlocal.argtypes = [
        p, p, p, p, i, i, i, i, ll, ll, ll, ll, ll, ll, i, p]
    lib.tpavi_fused_dot_nonlocal.restype = i
    lib.tpavi_error_string.argtypes = [i]
    lib.tpavi_error_string.restype = ctypes.c_char_p
    return lib


def _launch(theta: torch.Tensor, phi: torch.Tensor,
            g: torch.Tensor) -> torch.Tensor:
    """Check the operands and launch the CUDA kernel on the current stream."""
    dev = theta.device
    if dev.type != "cuda" or phi.device != dev or g.device != dev:
        raise ValueError(
            f"fused_dot_nonlocal: operands on {theta.device}, {phi.device}, "
            f"{g.device}; the kernel needs all three on one CUDA device")
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
    b, n, c = theta.shape
    if not (0 < c <= MAX_CHANNELS and n > 0 and 0 < b <= 65535):
        raise ValueError(
            f"fused_dot_nonlocal: (B, N, C') = {(b, n, c)}; the kernel takes "
            f"1 <= B <= 65535, N >= 1 and 1 <= C' <= {MAX_CHANNELS}")
    for name, t in (("theta", theta), ("phi", phi), ("g", g)):
        if t.stride(2) != 1:
            raise ValueError(
                f"fused_dot_nonlocal: {name} has channel stride "
                f"{t.stride(2)}; the kernel needs contiguous channels")
    out = torch.empty((b, n, c), dtype=theta.dtype, device=dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = ctypes.c_void_p
    err = lib.tpavi_fused_dot_nonlocal(
        ptr(theta.data_ptr()), ptr(phi.data_ptr()), ptr(g.data_ptr()),
        ptr(out.data_ptr()), b, n, c, _DTYPE_CODES[theta.dtype],
        theta.stride(0), theta.stride(1), phi.stride(0), phi.stride(1),
        g.stride(0), g.stride(1), dev.index, ptr(stream))
    if err != 0:
        raise RuntimeError(
            f"fused_dot_nonlocal: kernel launch failed with CUDA error {err} "
            f"({lib.tpavi_error_string(err).decode()})")
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
    the kernel (counted in ``fused_dot_nonlocal.launches``) or raise.
    """
    return _FusedDotNonlocal.apply(theta, phi, g)


fused_dot_nonlocal.launches = 0
