"""Fused IEKD stem: 7×7 s1 p2 conv (+bias) → BatchNorm → ReLU → 3×3 s2 p1
maxpool, forward and backward, in five hand-written CUDA kernels.

The port of ``experiments/stem_pallas.py`` (and, for the forward, of
``experiments/stem_banded.py``, whose kernels compute the same functions).
The kernels are ``glfusion_tpu_torch/csrc/stem_fused.cu``:

* ``stem_stats``: per-block (count, mean, M2) of z = conv(x) + bias per
  channel, merged here by Chan's formula into the batch mean and the biased
  batch variance (no one-pass E[z²] − E[z]²);
* ``stem_norm_pool``: maxpool(relu((z − μ)·a + β)) with
  a = γ·rsqrt(σ² + eps), from batch statistics in training and running
  statistics in eval;
* ``stem_bwd1``: Σdn and Σdn·x̂ per channel (dn = dy routed to each pool
  window's first maximum and gated by the ReLU), which give dβ and dγ;
* ``stem_bwd2``: dz = a·dn − a·(E[dn] + x̂·E[dn·x̂]), then dW, db and dx
  partials per block;
* ``stem_dx_reduce``: dx from ``stem_bwd2``'s partials, each pixel summed
  slab ascending, then chunk ascending, so dx has the same bits on every
  run (no atomics).

Layout. The JAX functions take NHWC; these take the model's NCHW: x
(B, 1, H, W), weight (C, 1, 7, 7) as ``nn.Conv2d`` holds it, output
(B, C, hp, wp) contiguous, which layer1's convolutions read without a copy
(an NHWC result would make them run channels-last, the layout trap of
PERF.md). The tests transpose to hold them against the JAX functions.

x and the output are float32 or bfloat16; weights, statistics and all
accumulation are float32, as in the Pallas kernel. ``fused_stem_train`` and
``fused_stem_eval`` take the plain versions for tensors on the CPU; for CUDA
tensors they launch the kernels (each launcher counts its launches in
``.launches``) or raise. Every kernel sums in a fixed order: two calls on
the same inputs give the same bits.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from glfusion_tpu_torch.ops import _build

EPS = 1e-5
CHANNEL_CHUNK = 8  # channels per kernel block; C must be a multiple
POOL_ROWS = 4      # pooled rows per kernel block (a slab)
DX_ROWS = 2 * POOL_ROWS + 6  # input rows of one block's dx partial
_SOURCE = "stem_fused"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ------------------------------------------------------------ plain versions

def _conv(x: torch.Tensor, weight: torch.Tensor,
          bias: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x.float(), weight.float(), bias.float(), padding=2)


def _pool(h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.max_pool2d(h, kernel_size=3, stride=2, padding=1).to(dtype)


def fused_stem_train_plain(x, weight, bias, gamma, beta, axis=None):
    """conv → BN on batch statistics → ReLU → maxpool, differentiable by
    autograd. Returns (pooled in x's type, batch mean, biased batch
    variance); the statistics carry no gradient. ``axis``: the batch is
    split over it, and the statistics are the global batch's (the
    cross-rank BatchNorm's)."""
    z = _conv(x, weight, bias)
    if axis is not None and axis.size > 1:
        from glfusion_tpu_torch.parallel.norm import sync_batch_norm
        y, mean, var = sync_batch_norm(z, gamma.float(), beta.float(), EPS,
                                       axis)
        return _pool(F.relu(y), x.dtype), mean, var
    with torch.no_grad():
        var, mean = torch.var_mean(z, dim=(0, 2, 3), unbiased=False)
    h = F.relu(F.batch_norm(z, None, None, gamma.float(), beta.float(),
                            training=True, eps=EPS))
    return _pool(h, x.dtype), mean, var


def fused_stem_eval_plain(x, weight, bias, gamma, beta, running_mean,
                          running_var):
    """conv → BN on running statistics → ReLU → maxpool."""
    z = _conv(x, weight, bias)
    h = F.relu(F.batch_norm(z, running_mean.float(), running_var.float(),
                            gamma.float(), beta.float(), training=False,
                            eps=EPS))
    return _pool(h, x.dtype)


# ----------------------------------------------------------------- kernels

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernels' library, built at first use, with its C signatures."""
    lib = _build.load(_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    geom = [i, i, i, i, i, i, p]  # B, H, W, C, dtype, device, stream
    lib.stem_stats.argtypes = [p, p, p, p] + geom
    lib.stem_norm_pool.argtypes = [p, p, p, p] + geom
    lib.stem_bwd1.argtypes = [p, p, p, p, p] + geom
    lib.stem_bwd2.argtypes = [p, p, p, p, p, p, p] + geom
    lib.stem_dx_reduce.argtypes = [p, p, i, i, i, i, i, p]
    for fn in (lib.stem_stats, lib.stem_norm_pool, lib.stem_bwd1,
               lib.stem_bwd2, lib.stem_dx_reduce):
        fn.restype = i
    lib.stem_error_string.argtypes = [i]
    lib.stem_error_string.restype = ctypes.c_char_p
    layout = [ctypes.c_int() for _ in range(3)]
    lib.stem_layout.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    lib.stem_layout.restype = None
    lib.stem_layout(*(ctypes.byref(v) for v in layout))
    ours = (POOL_ROWS, CHANNEL_CHUNK, DX_ROWS)
    if tuple(v.value for v in layout) != ours:
        raise RuntimeError(
            f"{_SOURCE}: the library's (R, CC, DXR) = "
            f"{tuple(v.value for v in layout)}, the wrappers' {ours}")
    return lib


def geometry(h: int, w: int) -> tuple[int, int, int, int, int]:
    """(hc, wc, hp, wp, slabs): conv map, pooled map, and the kernels'
    blocks along the pooled rows (4 pooled rows each)."""
    hc, wc = h - 2, w - 2
    hp, wp = (hc - 1) // 2 + 1, (wc - 1) // 2 + 1
    return hc, wc, hp, wp, -(-hp // POOL_ROWS)


def dx_slab_rows(slab: int, h: int) -> tuple[int, range]:
    """Where slab ``slab``'s dx partial lies: (the input row of its row 0,
    the image rows it covers). Its own conv rows [2·4·slab, 2·4·slab + 8)
    reach input rows 2 above to 4 below through the 7×7 p2 conv, so
    neighbouring slabs overlap by 6 rows; rows outside the image are not
    written."""
    first = 2 * POOL_ROWS * slab - 2
    return first, range(max(first, 0), min(first + DX_ROWS, h))


def _check(x: torch.Tensor, weight: torch.Tensor) -> None:
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError(f"fused stem: x on {x.device}, weight on "
                         f"{weight.device}; the kernels need one CUDA device")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused stem: x is {x.dtype}; the kernels take "
                        "float32 or bfloat16")
    b, cin, h, w = x.shape
    c = weight.shape[0]
    if cin != 1 or tuple(weight.shape) != (c, 1, 7, 7):
        raise ValueError(f"fused stem: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}; need (B, 1, H, W) and "
                         "(C, 1, 7, 7)")
    if (c % CHANNEL_CHUNK or h < 3 or w < 3 or not 0 < b <= 65535):
        raise ValueError(f"fused stem: B={b}, H={h}, W={w}, C={c}; the "
                         f"kernels take 1 <= B <= 65535, H, W >= 3 and C a "
                         f"multiple of {CHANNEL_CHUNK}")


def _call(fn, name: str, ptrs, x: torch.Tensor, c: int) -> None:
    b, _, h, w = x.shape
    dev = x.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in ptrs), b, h, w, c,
             _DTYPE_CODES[x.dtype], dev.index, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"{name}: kernel launch failed with CUDA error {err} "
            f"({_library().stem_error_string(err).decode()})")


def _chan(c: int, dev, bias, a=None, beta=None, mean=None, inv=None,
          edn=None, ednx=None) -> torch.Tensor:
    """The kernels' (7, C) float32 per-channel rows; unused rows are 0."""
    zero = torch.zeros(c, device=dev)
    rows = [bias, a, beta, mean, inv, edn, ednx]
    return torch.stack([zero if r is None else r.float() for r in rows])


def stem_stats(x, w49, chan) -> torch.Tensor:
    """K2a: (3, B, slabs, C) per-block count, mean and M2 of z."""
    b, _, h, w = x.shape
    c = w49.shape[0]
    part = torch.empty((3, b, geometry(h, w)[4], c), device=x.device)
    _call(_library().stem_stats, "stem_stats", (x, w49, chan, part), x, c)
    stem_stats.launches += 1
    return part


def stem_norm_pool(x, w49, chan) -> torch.Tensor:
    """K2b: maxpool(relu((z − μ)·a + β)), (B, C, hp, wp) in x's type."""
    b, _, h, w = x.shape
    c = w49.shape[0]
    _, _, hp, wp, _ = geometry(h, w)
    out = torch.empty((b, c, hp, wp), dtype=x.dtype, device=x.device)
    _call(_library().stem_norm_pool, "stem_norm_pool", (x, w49, chan, out),
          x, c)
    stem_norm_pool.launches += 1
    return out


def stem_bwd1(x, w49, chan, dy) -> torch.Tensor:
    """K2c: (2, B, slabs, C) per-block Σdn and Σdn·x̂."""
    b, _, h, w = x.shape
    c = w49.shape[0]
    part = torch.empty((2, b, geometry(h, w)[4], c), device=x.device)
    _call(_library().stem_bwd1, "stem_bwd1", (x, w49, chan, dy, part), x, c)
    stem_bwd1.launches += 1
    return part


def stem_bwd2(x, w49, chan, dy):
    """K2d: dW partials (B, slabs, C, 49), db partials (B, slabs, C) and dx
    partials (B, slabs, C / 8, 14, W) float32 (see :func:`dx_slab_rows`;
    rows outside the image are left unwritten), which
    :func:`stem_dx_reduce` sums."""
    b, _, h, w = x.shape
    c = w49.shape[0]
    slabs = geometry(h, w)[4]
    dwp = torch.empty((b, slabs, c, 49), device=x.device)
    dbp = torch.empty((b, slabs, c), device=x.device)
    dxp = torch.empty((b, slabs, c // CHANNEL_CHUNK, DX_ROWS, w),
                      device=x.device)
    _call(_library().stem_bwd2, "stem_bwd2",
          (x, w49, chan, dy, dwp, dbp, dxp), x, c)
    stem_bwd2.launches += 1
    return dwp, dbp, dxp


def stem_bwd2_plain(x, w49, chan, dy):
    """K2d's own output in plain PyTorch: the partials of ``stem_bwd2``,
    block by block (each slab's own conv rows, each chunk's channels),
    with the plain stem's routing (autograd of relu → max_pool2d: the
    first maximum, gated by n > 0). ``chan`` holds the kernels' rows bias,
    a, beta, mean, inv, E[dn], E[dn·x̂]. dx partial rows outside the image
    are NaN, where the kernel leaves them unwritten."""
    b, _, h, w = x.shape
    c = w49.shape[0]
    hc, wc, _, _, slabs = geometry(h, w)
    own = 2 * POOL_ROWS
    bias, a, beta, mu, inv, edn, ednx = (r.view(1, c, 1, 1)
                                         for r in chan.float())
    x = x.detach().float()
    weight = w49.detach().float().reshape(c, 1, 7, 7)
    z = F.conv2d(x, weight, bias.view(c), padding=2)
    with torch.enable_grad():
        n = ((z - mu) * a + beta).detach().requires_grad_(True)
        pooled = F.max_pool2d(F.relu(n), kernel_size=3, stride=2, padding=1)
        dn, = torch.autograd.grad(pooled, n, dy.detach().float())
    dz = a * dn - a * (edn + (z - mu) * inv * ednx)
    # own rows of each slab: (B, C, slabs, 8, wc), zero past the map
    dz = F.pad(dz, (0, 0, 0, slabs * own - hc)).view(b, c, slabs, own, wc)
    patches = F.pad(F.unfold(F.pad(x, (2, 2, 2, 2)), 7).view(b, 49, hc, wc),
                    (0, 0, 0, slabs * own - hc)).view(b, 49, slabs, own, wc)
    dwp = torch.einsum("bcsyx,bksyx->bsck", dz, patches)
    dbp = dz.sum((3, 4)).permute(0, 2, 1)
    # each slab's own rows through the transposed 7×7 p2 conv, one group
    # per channel chunk: input rows 8·s − 2 ..., DX_ROWS of them
    dxp = torch.stack([
        F.conv_transpose2d(dz[:, :, s], weight, padding=(0, 2),
                           groups=c // CHANNEL_CHUNK)
        for s in range(slabs)], dim=1)
    for s in range(slabs):
        first, rows = dx_slab_rows(s, h)
        dxp[:, s, :, :rows.start - first] = float("nan")
        dxp[:, s, :, rows.stop - first:] = float("nan")
    return dwp, dbp, dxp


def stem_dx_reduce_plain(dxp: torch.Tensor, h: int) -> torch.Tensor:
    """The reduce pass in plain PyTorch, in the kernel's order (slab
    ascending, then chunk ascending, from 0): (B, H, W) float32."""
    b, slabs, chunks, _, w = dxp.shape
    dx = dxp.new_zeros((b, h, w))
    for s in range(slabs):
        first, rows = dx_slab_rows(s, h)
        part = dxp[:, s, :, rows.start - first:rows.stop - first]
        for ch in range(chunks):
            dx[:, rows.start:rows.stop] += part[:, ch]
    return dx


def stem_dx_reduce(dxp: torch.Tensor, h: int) -> torch.Tensor:
    """K2d's second pass: dx (B, H, W) float32 from ``stem_bwd2``'s
    partials, each pixel summed slab ascending, then chunk ascending. A
    CPU tensor takes :func:`stem_dx_reduce_plain`."""
    b, slabs, chunks, rows, w = dxp.shape
    if (slabs, rows) != (geometry(h, w)[4], DX_ROWS):
        raise ValueError(f"stem_dx_reduce: partials {tuple(dxp.shape)} for "
                         f"H = {h}; need (B, {geometry(h, w)[4]}, C / "
                         f"{CHANNEL_CHUNK}, {DX_ROWS}, W)")
    if dxp.device.type == "cpu":
        return stem_dx_reduce_plain(dxp, h)
    if dxp.device.type != "cuda" or dxp.dtype != torch.float32 or \
            not dxp.is_contiguous():
        raise ValueError(f"stem_dx_reduce: partials {dxp.dtype} on "
                         f"{dxp.device}; the kernel takes contiguous float32 "
                         "on a CUDA device")
    dx = torch.empty((b, h, w), device=dxp.device)
    stream = torch.cuda.current_stream(dxp.device).cuda_stream
    err = _library().stem_dx_reduce(
        ctypes.c_void_p(dxp.data_ptr()), ctypes.c_void_p(dx.data_ptr()), b,
        h, w, chunks * CHANNEL_CHUNK, dxp.device.index,
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"stem_dx_reduce: kernel launch failed with CUDA error {err} "
            f"({_library().stem_error_string(err).decode()})")
    stem_dx_reduce.launches += 1
    return dx


KERNELS = (stem_stats, stem_norm_pool, stem_bwd1, stem_bwd2, stem_dx_reduce)
for _fn in KERNELS:
    _fn.launches = 0


def batch_moments(part: torch.Tensor):
    """Merge the per-block (count, mean, M2) of ``stem_stats`` (Chan et
    al.): the batch mean and the biased batch variance, float32."""
    n, m, m2 = (t.reshape(-1, t.shape[-1]) for t in part)
    total = n.sum(0)
    mean = (n * m).sum(0) / total
    var = (m2.sum(0) + (n * (m - mean) ** 2).sum(0)) / total
    return mean, var


class _FusedStemTrain(torch.autograd.Function):
    """The four kernels as one trainable function. Over a batch split
    between ranks (``axis``) the per-block partials of ``stem_stats`` and
    of ``stem_bwd1`` are gathered along their batch axis, in rank order,
    between the launches: every rank then merges one process's partials
    of the global batch, so the moments have its bits. The kernels do not
    change. Σdn and Σdn·x̂ feed ``stem_bwd2`` whole; the scale and shift
    gradients returned are this rank's own sums (the step sums gradients
    over the ranks)."""

    @staticmethod
    def forward(ctx, x, weight, bias, gamma, beta, axis):
        c = weight.shape[0]
        x = x.contiguous()
        w49 = weight.float().reshape(c, 49).contiguous()
        part = stem_stats(x, w49, _chan(c, x.device, bias))
        if axis is not None:
            part = axis.gather_(part, 1)
        mean, var = batch_moments(part)
        inv = torch.rsqrt(var + EPS)
        a = gamma.float() * inv
        out = stem_norm_pool(x, w49, _chan(c, x.device, bias, a, beta,
                                           mean))
        ctx.save_for_backward(x, w49, bias, gamma, beta, mean, inv, a)
        ctx.axis = axis
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        # the statistics feed only the running-average update: their
        # cotangents are dropped, as in the JAX custom VJP; the dependence
        # of the normalization on μ and σ² is differentiated below
        x, w49, bias, gamma, beta, mean, inv, a = ctx.saved_tensors
        b, _, h, w = x.shape
        c = w49.shape[0]
        hc, wc = h - 2, w - 2
        dy = dy.to(x.dtype).contiguous()
        chan = _chan(c, x.device, bias, a, beta, mean, inv)
        part = stem_bwd1(x, w49, chan, dy)
        dbeta = part[0].sum((0, 1))
        dgamma = part[1].sum((0, 1))
        n = b * hc * wc
        edn, ednx = dbeta, dgamma
        if ctx.axis is not None:
            whole = ctx.axis.gather_(part, 1)
            edn, ednx = whole[0].sum((0, 1)), whole[1].sum((0, 1))
            n *= ctx.axis.size
        chan = _chan(c, x.device, bias, a, beta, mean, inv, edn / n,
                     ednx / n)
        dwp, dbp, dxp = stem_bwd2(x, w49, chan, dy)
        dx = stem_dx_reduce(dxp, h)
        dweight = dwp.sum((0, 1)).reshape(c, 1, 7, 7)
        return (dx.to(x.dtype).unsqueeze(1), dweight, dbp.sum((0, 1)),
                dgamma.to(gamma.dtype), dbeta, None)


def fused_stem_train(x, weight, bias, gamma, beta, axis=None):
    """Training-mode stem. x (B, 1, H, W), weight (C, 1, 7, 7), bias, gamma,
    beta (C,). Returns (pooled (B, C, hp, wp) in x's type, batch mean,
    biased batch variance); the caller updates the running statistics.
    ``axis`` (``parallel.collectives.Axis``): the batch is split over its
    ranks and the statistics are the global batch's. CPU tensors take
    :func:`fused_stem_train_plain`."""
    if axis is not None and axis.size == 1:
        axis = None
    if x.device.type == "cpu":
        return fused_stem_train_plain(x, weight, bias, gamma, beta, axis)
    _check(x, weight)
    return _FusedStemTrain.apply(x, weight, bias, gamma, beta, axis)


def fused_stem_eval(x, weight, bias, gamma, beta, running_mean, running_var):
    """Eval-mode stem on running statistics (one kernel, ``stem_norm_pool``).
    CPU tensors take :func:`fused_stem_eval_plain`."""
    if x.device.type == "cpu":
        return fused_stem_eval_plain(x, weight, bias, gamma, beta,
                                     running_mean, running_var)
    _check(x, weight)
    c = weight.shape[0]
    inv = torch.rsqrt(running_var.float() + EPS)
    a = gamma.float() * inv
    return stem_norm_pool(x.contiguous(),
                          weight.float().reshape(c, 49).contiguous(),
                          _chan(c, x.device, bias, a, beta, running_mean))
