// Fused IEKD stem for Hopper (sm_90a): 7x7 s1 p2 conv (Cin = 1, with bias)
// -> BatchNorm affine -> ReLU -> 3x3 s2 p1 maxpool, forward and backward.
//
// Replaces the TPU kernels of experiments/stem_pallas.py (`_stats_kernel`,
// `_norm_pool_kernel`, `_bwd1_kernel`, `_bwd2_kernel`) and, for the forward,
// those of experiments/stem_banded.py (`_stats_kernel`, `_normpool_kernel`),
// which compute the same two functions. Five kernels (the last completes
// stem_bwd2's function, K2d):
//
//   stem_stats      per-block (count, mean, M2) of z = conv(x) + bias per
//                   channel; a torch reduction outside merges the blocks
//                   (Chan's formula), so the batch variance never takes the
//                   one-pass E[z^2] - E[z]^2 form, which cancels in float32
//                   over B * 110^2 samples a channel.
//   stem_norm_pool  out = maxpool(relu((z - mean) * a + beta)),
//                   a = gamma * inv (batch or running statistics).
//   stem_bwd1       per-block sums of dn and dn * xhat per channel, where dn
//                   is dy routed to each window's chosen position and gated
//                   by n = (z - mean) * a + beta > 0, and
//                   xhat = (z - mean) * inv.
//   stem_bwd2       dz = a * dn - a * (E[dn] + xhat * E[dn * xhat]); per-block
//                   partials of dW (C, 49) and db (C), and of dx by the
//                   transposed conv of dz.
//   stem_dx_reduce  dx from stem_bwd2's partials, in a fixed order.
//
// None of the 110^2 x C conv map goes to device memory: every kernel
// recomputes the conv rows it needs from the (B, H, W) input.
//
// Design. A block owns R = 4 pooled rows [p0, p0 + R) of one image, for a
// chunk of CC = 8 channels; grid (ceil(hp / R), C / CC, B). It stages the
// input rows it needs (zero padded) and the chunk's 7x7 weights in shared
// memory, computes the conv rows [2 p0 - 1, 2 p0 + 2 R + 2) into shared
// memory, and runs the epilogue from there. This is the halo the Pallas
// kernel recomputes (`_slab_h`); its parity split, one-hot matmuls and
// `_zpad` existed only because Mosaic forbids stride-2 vector ops and are
// not needed here.
//
// The conv engine (`stage`), shared by all four kernels. Warp w computes
// channel w of the chunk (CC = WARPS), so the channel is warp-uniform and
// its 49 weights are loaded into registers once. Each lane computes a
// strip of 8 consecutive outputs of one conv row: for each of the 7 kernel
// rows it loads the 14 inputs the strip needs as four 16-byte shared loads
// and runs 7 x 8 FMAs from registers, 14 FMAs per shared load (the first
// engine issued one shared load per FMA, which bound it by shared-memory
// issue at about a quarter of the FMA rate). Neighbouring lanes take
// neighbouring rows of one strip column, and the input row stride is an
// odd number of 16-byte words, so the eight lanes of a 16-byte load phase
// hit eight different bank groups. The last strip of a row is masked
// (110 = 13 x 8 + 6). Each output sums its 49 taps in the first engine's
// order (kernel row, then column, from the bias), so z keeps its bits.
//
// Max-pool routing follows torch's rule (the plain version's max_pool2d
// backward): one position per window, the first maximum of relu(n) in
// row-major order. stem_bwd2 gathers: each conv position of the block's
// own rows [2 p0, 2 p0 + 2 R) checks the at most 2 x 2 windows that contain
// it and takes dy from a window only if it is that window's chosen position,
// so routing needs no atomics. stem_bwd1 needs only two sums a channel, so
// it sums over the windows whose choice lies in its own rows (a warp per
// channel, a lane per window). The Pallas kernel sends dy to every tied
// position (stem_pallas.py:55-58); the two rules differ only on ties, and
// ties at zero are masked by the ReLU gate.
//
// dx is summed in a fixed order, without atomics. The input rows that a
// block's dz rows touch, [2 p0 - 2, 2 p0 + 2 R + 4), overlap the next
// slab's by 6 rows, and every channel chunk adds to the same pixels.
// Recomputing dz over a 6-pixel halo for all C channels in one block would
// need the whole channel range in shared memory (about 200 KB at C = 64).
// So stem_bwd2 writes each block's contribution, summed over its CC
// channels, to a partial buffer (B, slabs, C / CC, 2 R + 6, W), 28 MB at
// B = 40, and stem_dx_reduce adds each pixel's partials slab ascending,
// then chunk ascending: the same bits on every run. That pass moves the
// buffer once (about 9 us at 3.35 TB/s).
//
// The affine subtracts the mean before it scales, as torch's BatchNorm does:
// the folded form a * z + (beta - mean * a) cancels in float32 where
// |mean| >> std (a /255 frame through this conv), and that error was
// enough to decide near-tied pool windows other than the plain version.
//
// Types: x, the pooled output, dy and dx in float32 or bfloat16; weights,
// per-channel vectors, statistics and all accumulation in float32.
//
// Bound on an H100 at B = 40, 112^2, C = 64: the forward needs one conv,
// 2 * B * 110^2 * 64 * 49 = 3.04 GFLOP, 45 us at 67 TFLOP/s float32 FMA; its
// bytes (2 MB read, 31 MB written) take 10 us at 3.35 TB/s. The backward
// needs two conv-sized products (dW and dx), 91 us. The kernels recompute
// the conv in each of the four passes and use no tensor cores; stem_stats'
// two-pass moments and stem_bwd2's dW and dx loops still read both
// operands of every FMA from shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int KS = 7;          // kernel size
constexpr int KK = KS * KS;    // 49 taps
constexpr int R = 4;           // pooled rows per block
constexpr int CC = 8;          // channels per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STRIP = 8;       // conv outputs a lane computes along a row
constexpr int DXR = 2 * R + 6;  // input rows of a block's dx partial
static_assert(CC == WARPS, "the conv engine gives each warp one channel");
// Blocks per SM the register budget must allow: 3 caps a thread at 80
// registers, which the engine fits without spilling; shared memory allows
// 4 in the backward (about 50 KB a block), but at 64 registers the engine
// spills.
constexpr int MIN_BLOCKS = 3;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Geom {
  int b, h, w, c;      // batch, input height and width, channels
  int hc, wc, hp, wp;  // conv map and pooled map sizes
  int slabs;           // blocks along the pooled rows
  int xw;              // staged input row stride: w + 4 zero-padded
                       // columns, rounded up to an odd number of float4s
};

Geom make_geom(int b, int h, int w, int c) {
  Geom g;
  g.b = b; g.h = h; g.w = w; g.c = c;
  g.hc = h - 2; g.wc = w - 2;
  g.hp = (g.hc - 1) / 2 + 1; g.wp = (g.wc - 1) / 2 + 1;
  g.slabs = (g.hp + R - 1) / R;
  g.xw = (w + 4 + 3) / 4 * 4;
  if ((g.xw / 4) % 2 == 0) g.xw += 4;
  return g;
}

// Per-channel vectors, one row of C floats each, in one (CHAN_ROWS, C) array.
enum { CH_BIAS = 0, CH_A, CH_BETA, CH_MU, CH_INV, CH_EDN, CH_EDNX, CHAN_ROWS };

// Shared memory of a block whose conv rows are [zr0, zr0 + zrows).
struct Smem {
  float* xin;          // (zrows + 6, xw): input rows zr0 - 2 .., zero padded
  float* ws;           // (CC, 49) weights of the chunk
  float* zb;           // (CC, zrows, wc) conv values (dz in bwd2)
  float* red;          // (WARPS, CC) reduction scratch
  signed char* arg;    // (CC, R + 1, wp) chosen position of each window
};

size_t smem_bytes(const Geom& g, int zrows, bool with_arg) {
  size_t f = (size_t)(zrows + 6) * g.xw + CC * KK +
             (size_t)CC * zrows * g.wc + WARPS * CC;
  return f * sizeof(float) + (with_arg ? (size_t)CC * (R + 1) * g.wp : 0);
}

__device__ Smem carve(const Geom& g, int zrows) {
  extern __shared__ __align__(16) float smem[];
  Smem s;
  s.xin = smem;
  s.ws = s.xin + (zrows + 6) * g.xw;
  s.zb = s.ws + CC * KK;
  s.red = s.zb + CC * zrows * g.wc;
  s.arg = reinterpret_cast<signed char*>(s.red + WARPS * CC);
  return s;
}

// Stage the input rows and weights, then z for conv rows [zr0, zr0 + zrows)
// and all wc columns (rows outside [0, hc) are computed from zero padding
// and masked by the callers).
template <typename T>
__device__ void stage(const Geom& g, const Smem& s, const T* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ chan, int b, int c0, int zr0,
                      int zrows) {
  const int tid = threadIdx.x, cc = tid >> 5, lane = tid & 31;
  const T* xb = x + (long long)b * g.h * g.w;
  for (int r = cc; r < zrows + 6; r += WARPS) {  // a warp per input row
    const int row = zr0 + r - 2;
    const bool inside = row >= 0 && row < g.h;
    for (int q = lane; q < g.xw; q += 32) {
      const int col = q - 2;
      s.xin[r * g.xw + q] = inside && col >= 0 && col < g.w
                                ? to_f32(xb[(long long)row * g.w + col])
                                : 0.f;
    }
  }
  for (int e = tid; e < CC * KK; e += THREADS) s.ws[e] = w[c0 * KK + e];
  __syncthreads();
  // warp cc: channel cc; lane task t: conv row t % zrows, strip t / zrows.
  // A strip's 16-byte loads start at a multiple of 8 columns of a row whose
  // stride is a multiple of 4 floats; the last strip reads up to 9 floats
  // past its row (into the next row, or into `ws` after the last one),
  // which only masked outputs use.
  float wr[KK];
#pragma unroll
  for (int k = 0; k < KK; ++k) wr[k] = s.ws[cc * KK + k];
  const float bias = chan[CH_BIAS * g.c + c0 + cc];
  float* zc = s.zb + cc * zrows * g.wc;
  const int tasks = zrows * ((g.wc + STRIP - 1) / STRIP);
  for (int t = lane; t < tasks; t += 32) {
    const int lr = t % zrows, x0 = t / zrows * STRIP;
    const float* xr = s.xin + lr * g.xw + x0;
    float acc[STRIP];
#pragma unroll
    for (int k = 0; k < STRIP; ++k) acc[k] = bias;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      float in[STRIP + 8];  // the strip needs STRIP + KS - 1 = 14
#pragma unroll
      for (int q = 0; q < (STRIP + 8) / 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(xr + i * g.xw + 4 * q);
        in[4 * q] = v.x; in[4 * q + 1] = v.y;
        in[4 * q + 2] = v.z; in[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < KS; ++j)
#pragma unroll
        for (int k = 0; k < STRIP; ++k)
          acc[k] = fmaf(wr[i * KS + j], in[k + j], acc[k]);
    }
    float* zr = zc + lr * g.wc + x0;
    if (g.wc % 2 == 0) {  // pairs: 8-byte stores, conflict-free
#pragma unroll
      for (int k = 0; k < STRIP; k += 2)
        if (x0 + k < g.wc)
          *reinterpret_cast<float2*>(zr + k) = make_float2(acc[k], acc[k + 1]);
    } else {
#pragma unroll
      for (int k = 0; k < STRIP; ++k)
        if (x0 + k < g.wc) zr[k] = acc[k];
    }
  }
  __syncthreads();
}

// The sum of v over the 32 lanes of a warp, in a fixed order; lane 0
// holds it.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sums each of the CC values over the block; every thread gets the totals.
__device__ void block_sum(float (&v)[CC], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int cc = 0; cc < CC; ++cc) v[cc] = warp_sum(v[cc]);
  if (lane == 0)
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) red[warp * CC + cc] = v[cc];
  __syncthreads();
#pragma unroll
  for (int cc = 0; cc < CC; ++cc) {
    float t = 0.f;
    for (int k = 0; k < WARPS; ++k) t += red[k * CC + cc];
    v[cc] = t;
  }
  __syncthreads();
}

// ---------------------------------------------------------------- kernels

// part: (3, B, slabs, C) = count, mean, M2 of the block's own conv rows
// [2 p0, 2 p0 + 2 R) within [0, hc).
template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
stats_kernel(const T* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ chan, float* __restrict__ part,
             Geom g) {
  const int slab = blockIdx.x, c0 = blockIdx.y * CC, b = blockIdx.z;
  const int zr0 = 2 * slab * R, zrows = 2 * R;
  const Smem s = carve(g, zrows);
  stage(g, s, x, w, chan, b, c0, zr0, zrows);
  const int rows = min(zrows, g.hc - zr0);
  const int n = rows * g.wc;
  const int n_z = zrows * g.wc;
  float v[CC];
#pragma unroll
  for (int cc = 0; cc < CC; ++cc) {
    v[cc] = 0.f;
    for (int e = threadIdx.x; e < n; e += THREADS) v[cc] += s.zb[cc * n_z + e];
  }
  block_sum(v, s.red);
  float mean[CC];
#pragma unroll
  for (int cc = 0; cc < CC; ++cc) {
    mean[cc] = v[cc] / n;
    v[cc] = 0.f;
    for (int e = threadIdx.x; e < n; e += THREADS) {
      const float d = s.zb[cc * n_z + e] - mean[cc];
      v[cc] = fmaf(d, d, v[cc]);
    }
  }
  block_sum(v, s.red);
  if (threadIdx.x < CC) {
    const int cc = threadIdx.x;
    const long long plane = (long long)g.b * g.slabs * g.c;
    const long long i = ((long long)b * g.slabs + slab) * g.c + c0 + cc;
    part[i] = static_cast<float>(n);
    part[plane + i] = mean[cc];
    part[2 * plane + i] = v[cc];
  }
}

// out: (B, C, hp, wp) in x's type. After the conv, warp cc pools channel
// cc alone (the engine wrote its rows), a lane per pooled output.
template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
norm_pool_kernel(const T* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ chan, T* __restrict__ out,
                 Geom g) {
  const int slab = blockIdx.x, c0 = blockIdx.y * CC, b = blockIdx.z;
  const int p0 = slab * R;
  const int zr0 = 2 * p0 - 1, zrows = 2 * R + 1;
  const Smem s = carve(g, zrows);
  stage(g, s, x, w, chan, b, c0, zr0, zrows);
  const int cc = threadIdx.x >> 5, c = c0 + cc;
  const float a = chan[CH_A * g.c + c], be = chan[CH_BETA * g.c + c],
              mu = chan[CH_MU * g.c + c];
  const float* zc = s.zb + cc * zrows * g.wc;
  T* outc = out + ((long long)b * g.c + c) * g.hp * g.wp;
  const int items = min(R, g.hp - p0) * g.wp;
  for (int e = threadIdx.x & 31; e < items; e += 32) {
    const int py = p0 + e / g.wp, px = e % g.wp;
    float m = -INFINITY;
    for (int di = 0; di < 3; ++di) {
      const int y = 2 * py - 1 + di;
      if (y < 0 || y >= g.hc) continue;
      for (int dj = 0; dj < 3; ++dj) {
        const int xx = 2 * px - 1 + dj;
        if (xx < 0 || xx >= g.wc) continue;
        m = fmaxf(m, fmaf(zc[(y - zr0) * g.wc + xx] - mu, a, be));
      }
    }
    store_as(outc + py * g.wp + px, fmaxf(m, 0.f));
  }
}

// stem_bwd2's routing: stage conv rows [2 p0 - 1, 2 p0 + 2 R + 2), choose
// each window's position (windows p0 .. p0 + R), then visit each own conv
// position with its routed and gated gradient dn. `visit(cc, e, z, dn,
// valid)` runs once per own position (valid or not: dn = 0 and `valid`
// false outside the map).
template <typename T, typename Visit>
__device__ void backward_common(const Geom& g, const Smem& s,
                                const T* __restrict__ x,
                                const float* __restrict__ w,
                                const float* __restrict__ chan,
                                const T* __restrict__ dy, int b, int c0,
                                int p0, Visit visit) {
  const int zr0 = 2 * p0 - 1, zrows = 2 * R + 3;
  stage(g, s, x, w, chan, b, c0, zr0, zrows);
  const int n_z = zrows * g.wc;
  // 1. each window's chosen position: the first max of relu(n), row-major
  const int n_win = (R + 1) * g.wp;
  for (int cc = 0; cc < CC; ++cc) {
    const int c = c0 + cc;
    const float a = chan[CH_A * g.c + c], be = chan[CH_BETA * g.c + c],
                mu = chan[CH_MU * g.c + c];
    const float* zc = s.zb + cc * n_z;
    for (int e = threadIdx.x; e < n_win; e += THREADS) {
      const int wr = e / g.wp, px = e % g.wp, py = p0 + wr;
      int best = -1;
      if (py < g.hp) {
        float bv = -INFINITY;
        for (int di = 0; di < 3; ++di) {
          const int y = 2 * py - 1 + di;
          if (y < 0 || y >= g.hc) continue;
          for (int dj = 0; dj < 3; ++dj) {
            const int xx = 2 * px - 1 + dj;
            if (xx < 0 || xx >= g.wc) continue;
            const float hv =
                fmaxf(fmaf(zc[(y - zr0) * g.wc + xx] - mu, a, be), 0.f);
            if (hv > bv) {
              bv = hv;
              best = di * 3 + dj;
            }
          }
        }
      }
      s.arg[cc * n_win + e] = static_cast<signed char>(best);
    }
  }
  __syncthreads();
  // 2. own rows: gather dy from the windows that chose this position
  const int n_own = 2 * R * g.wc;
#pragma unroll
  for (int cc = 0; cc < CC; ++cc) {
    const int c = c0 + cc;
    const float a = chan[CH_A * g.c + c], be = chan[CH_BETA * g.c + c],
                mu = chan[CH_MU * g.c + c];
    const T* dyc = dy + ((long long)b * g.c + c) * g.hp * g.wp;
    const signed char* argc = s.arg + cc * n_win;
    for (int e = threadIdx.x; e < n_own; e += THREADS) {
      const int lr = 1 + e / g.wc, xx = e % g.wc, y = zr0 + lr;
      const float z = s.zb[cc * n_z + lr * g.wc + xx];
      float dn = 0.f;
      const bool valid = y < g.hc;
      if (valid && fmaf(z - mu, a, be) > 0.f) {
        // windows containing row y: py = y >> 1 (at offset 1 or 2), and
        // for odd y also py + 1 (offset 0); the same for the columns
        int pys[2], ris[2], nys = 0, pxs[2], cis[2], nxs = 0;
        pys[nys] = y >> 1; ris[nys++] = y - 2 * (y >> 1) + 1;
        if ((y & 1) && (y >> 1) + 1 < g.hp) { pys[nys] = (y >> 1) + 1; ris[nys++] = 0; }
        pxs[nxs] = xx >> 1; cis[nxs++] = xx - 2 * (xx >> 1) + 1;
        if ((xx & 1) && (xx >> 1) + 1 < g.wp) { pxs[nxs] = (xx >> 1) + 1; cis[nxs++] = 0; }
        for (int u = 0; u < nys; ++u)
          for (int q = 0; q < nxs; ++q)
            if (argc[(pys[u] - p0) * g.wp + pxs[q]] == ris[u] * 3 + cis[q])
              dn += to_f32(dyc[pys[u] * g.wp + pxs[q]]);
      }
      visit(cc, lr * g.wc + xx, z, dn, valid);
    }
  }
}

// part: (2, B, slabs, C) = sum of dn, sum of dn * xhat over own positions.
// Summed by window rather than by position: dn at a position is the sum of
// dy over the windows that chose it, gated by n > 0, so the block's sums
// are those of dy and dy * xhat over the windows p0 .. p0 + R whose chosen
// position lies in its own conv rows [2 p0, 2 p0 + 2 R) with n > 0 there.
// Each window's choice lies in exactly one slab's own rows, so across the
// grid every window counts once. After the conv, warp cc handles channel
// cc alone, a lane per window: no routing table, no block-wide reduction.
template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
bwd1_kernel(const T* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ chan, const T* __restrict__ dy,
            float* __restrict__ part, Geom g) {
  const int slab = blockIdx.x, c0 = blockIdx.y * CC, b = blockIdx.z;
  const int p0 = slab * R, zr0 = 2 * p0 - 1, zrows = 2 * R + 3;
  const Smem s = carve(g, zrows);
  stage(g, s, x, w, chan, b, c0, zr0, zrows);
  const int cc = threadIdx.x >> 5, lane = threadIdx.x & 31, c = c0 + cc;
  const float a = chan[CH_A * g.c + c], be = chan[CH_BETA * g.c + c],
              mu = chan[CH_MU * g.c + c], inv = chan[CH_INV * g.c + c];
  const float* zc = s.zb + cc * zrows * g.wc;
  const T* dyc = dy + ((long long)b * g.c + c) * g.hp * g.wp;
  float sdn = 0.f, sdnx = 0.f;
  const int n_win = (min(R, g.hp - 1 - p0) + 1) * g.wp;
  for (int e = lane; e < n_win; e += 32) {
    const int py = p0 + e / g.wp, px = e % g.wp;
    // the first max of relu(n), row-major, as the plain version's routing
    float bv = -INFINITY, bz = 0.f;
    int by = 0;
    for (int di = 0; di < 3; ++di) {
      const int y = 2 * py - 1 + di;
      if (y < 0 || y >= g.hc) continue;
      for (int dj = 0; dj < 3; ++dj) {
        const int xx = 2 * px - 1 + dj;
        if (xx < 0 || xx >= g.wc) continue;
        const float z = zc[(y - zr0) * g.wc + xx];
        const float hv = fmaxf(fmaf(z - mu, a, be), 0.f);
        if (hv > bv) {
          bv = hv;
          bz = z;
          by = y;
        }
      }
    }
    if (bv > 0.f && by >= 2 * p0 && by < 2 * p0 + 2 * R) {
      const float d = to_f32(dyc[py * g.wp + px]);
      sdn += d;
      sdnx = fmaf(d, (bz - mu) * inv, sdnx);
    }
  }
  sdn = warp_sum(sdn);
  sdnx = warp_sum(sdnx);
  if (lane == 0) {
    const long long plane = (long long)g.b * g.slabs * g.c;
    const long long i = ((long long)b * g.slabs + slab) * g.c + c;
    part[i] = sdn;
    part[plane + i] = sdnx;
  }
}

// dwp: (B, slabs, C, 49), dbp: (B, slabs, C), dxp: (B, slabs, C / CC, DXR,
// W), row r of a block's slice being input row 2 R slab - 2 + r; rows
// outside the image are not written.
template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
bwd2_kernel(const T* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ chan, const T* __restrict__ dy,
            float* __restrict__ dwp, float* __restrict__ dbp,
            float* __restrict__ dxp, Geom g) {
  const int slab = blockIdx.x, c0 = blockIdx.y * CC, b = blockIdx.z;
  const int p0 = slab * R, zr0 = 2 * p0 - 1, zrows = 2 * R + 3;
  const Smem s = carve(g, zrows);
  const int n_z = zrows * g.wc;
  float sdz[CC];
#pragma unroll
  for (int cc = 0; cc < CC; ++cc) sdz[cc] = 0.f;
  // dz overwrites z in place: each position reads only its own z
  backward_common(g, s, x, w, chan, dy, b, c0, p0,
                  [&](int cc, int e, float z, float dn, bool valid) {
                    const int c = c0 + cc;
                    float dz = 0.f;
                    if (valid) {
                      const float a = chan[CH_A * g.c + c];
                      const float xhat = (z - chan[CH_MU * g.c + c]) *
                                         chan[CH_INV * g.c + c];
                      dz = a * dn - a * fmaf(xhat, chan[CH_EDNX * g.c + c],
                                             chan[CH_EDN * g.c + c]);
                    }
                    s.zb[cc * n_z + e] = dz;
                    sdz[cc] += dz;
                  });
  // halo rows 0 and [2R + 1, 2R + 3) carry no dz
  for (int cc = 0; cc < CC; ++cc)
    for (int e = threadIdx.x; e < 3 * g.wc; e += THREADS) {
      const int lr = e < g.wc ? 0 : 2 * R + 1 + (e - g.wc) / g.wc;
      s.zb[cc * n_z + lr * g.wc + e % g.wc] = 0.f;
    }
  block_sum(sdz, s.red);  // its barriers also order the writes above
  const long long blk = (long long)b * g.slabs + slab;
  if (threadIdx.x < CC) dbp[blk * g.c + c0 + threadIdx.x] = sdz[threadIdx.x];
  // dW partials: sum over own rows of dz * x window
  for (int e = threadIdx.x; e < CC * KK; e += THREADS) {
    const int cc = e / KK, k = e % KK, i = k / KS, j = k % KS;
    const float* zc = s.zb + cc * n_z;
    float acc = 0.f;
    for (int lr = 1; lr <= 2 * R; ++lr) {
      const float* zr = zc + lr * g.wc;
      const float* xr = s.xin + (lr + i) * g.xw + j;
      for (int xx = 0; xx < g.wc; ++xx) acc = fmaf(zr[xx], xr[xx], acc);
    }
    dwp[(blk * g.c + c0 + cc) * KK + k] = acc;
  }
  // dx: padded input rows ir in [1, 2R + 7) receive the transposed conv of
  // the own dz rows lr = ir - i in [1, 2R]; partial row ir - 1
  float* dxb =
      dxp + (((long long)b * g.slabs + slab) * (g.c / CC) + c0 / CC) * DXR * g.w;
  const int n_dx = DXR * g.w;
  for (int e = threadIdx.x; e < n_dx; e += THREADS) {
    const int ir = 1 + e / g.w, col = e % g.w;
    const int row = zr0 + ir - 2;
    if (row < 0 || row >= g.h) continue;
    const int q = col + 2;  // padded column
    float acc = 0.f;
    for (int cc = 0; cc < CC; ++cc) {
      const float* zc = s.zb + cc * n_z;
      const float* wc_ = s.ws + cc * KK;
      for (int i = 0; i < KS; ++i) {
        const int lr = ir - i;
        if (lr < 1 || lr > 2 * R) continue;
        for (int j = 0; j < KS; ++j) {
          const int xx = q - j;
          if (xx < 0 || xx >= g.wc) continue;
          acc = fmaf(zc[lr * g.wc + xx], wc_[i * KS + j], acc);
        }
      }
    }
    dxb[(ir - 1) * g.w + col] = acc;
  }
}

// dx: (B, H, W) float32 from bwd2_kernel's partials. Slab s covers input
// rows [2 R s - 2, 2 R s - 2 + DXR); each pixel adds the partials of the
// (one or two) slabs that cover it, slab ascending, then chunk ascending.
__global__ void __launch_bounds__(THREADS)
dx_reduce_kernel(const float* __restrict__ dxp, float* __restrict__ dx,
                 Geom g) {
  const long long n = (long long)g.b * g.h * g.w;
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= n) return;
  const int col = static_cast<int>(e % g.w);
  const int row = static_cast<int>(e / g.w % g.h);
  const long long b = e / ((long long)g.h * g.w);
  const int chunks = g.c / CC;
  int s_hi = min(g.slabs - 1, (row + 2) / (2 * R));
  int s_lo = s_hi;
  while (s_lo > 0 && row - (2 * R * (s_lo - 1) - 2) < DXR) --s_lo;
  float acc = 0.f;
  for (int s = s_lo; s <= s_hi; ++s) {
    const float* p = dxp + (b * g.slabs + s) * chunks * DXR * g.w +
                     (row - (2 * R * s - 2)) * g.w + col;
    for (int ch = 0; ch < chunks; ++ch) acc += p[(long long)ch * DXR * g.w];
  }
  dx[e] = acc;
}

int check_geom(int b, int h, int w, int c) {
  if (b <= 0 || b > 65535 || h < 3 || w < 3 || c <= 0 || c % CC != 0 ||
      c / CC > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename K>
int prepare(K kernel, size_t bytes, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  return static_cast<int>(err);
}

template <typename T>
int launch_stats(const void* x, const float* w, const float* chan,
                 float* part, const Geom& g, int device, cudaStream_t s) {
  const size_t bytes = smem_bytes(g, 2 * R, false);
  if (int err = prepare(stats_kernel<T>, bytes, device)) return err;
  stats_kernel<T><<<dim3(g.slabs, g.c / CC, g.b), THREADS, bytes, s>>>(
      static_cast<const T*>(x), w, chan, part, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_norm_pool(const void* x, const float* w, const float* chan,
                     void* out, const Geom& g, int device, cudaStream_t s) {
  const size_t bytes = smem_bytes(g, 2 * R + 1, false);
  if (int err = prepare(norm_pool_kernel<T>, bytes, device)) return err;
  norm_pool_kernel<T><<<dim3(g.slabs, g.c / CC, g.b), THREADS, bytes, s>>>(
      static_cast<const T*>(x), w, chan, static_cast<T*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd1(const void* x, const float* w, const float* chan,
                const void* dy, float* part, const Geom& g, int device,
                cudaStream_t s) {
  const size_t bytes = smem_bytes(g, 2 * R + 3, false);
  if (int err = prepare(bwd1_kernel<T>, bytes, device)) return err;
  bwd1_kernel<T><<<dim3(g.slabs, g.c / CC, g.b), THREADS, bytes, s>>>(
      static_cast<const T*>(x), w, chan, static_cast<const T*>(dy), part, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd2(const void* x, const float* w, const float* chan,
                const void* dy, float* dwp, float* dbp, float* dxp,
                const Geom& g, int device, cudaStream_t s) {
  const size_t bytes = smem_bytes(g, 2 * R + 3, true);
  if (int err = prepare(bwd2_kernel<T>, bytes, device)) return err;
  bwd2_kernel<T><<<dim3(g.slabs, g.c / CC, g.b), THREADS, bytes, s>>>(
      static_cast<const T*>(x), w, chan, static_cast<const T*>(dy), dwp,
      dbp, dxp, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// All five launch on `stream` and return cudaGetLastError() after the launch
// (0 on success). dtype 0 = float32, 1 = bfloat16 for x, out, dy. x is a
// contiguous (B, H, W) tensor, w a contiguous float32 (C, 49), chan a
// float32 (7, C) array of rows bias, a, beta, mean, inv, E[dn], E[dn * xhat]
// (each kernel reads the rows it needs). slabs = ceil(hp / 4) with
// hp = (H - 3) / 2 + 1; C must be a multiple of 8.

// The partial buffers' layout, which the Python wrappers hold against their
// own constants when they load the library: pooled rows a block (R),
// channels a block (CC), input rows of a block's dx partial (DXR).
void stem_layout(int* r, int* cc, int* dxr) {
  *r = R;
  *cc = CC;
  *dxr = DXR;
}

int stem_stats(const void* x, const float* w, const float* chan, float* part,
               int b, int h, int wd, int c, int dtype, int device,
               void* stream) {
  if (int err = check_geom(b, h, wd, c)) return err;
  const Geom g = make_geom(b, h, wd, c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_stats<float>(x, w, chan, part, g, device, s);
  if (dtype == 1)
    return launch_stats<__nv_bfloat16>(x, w, chan, part, g, device, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int stem_norm_pool(const void* x, const float* w, const float* chan,
                   void* out, int b, int h, int wd, int c, int dtype,
                   int device, void* stream) {
  if (int err = check_geom(b, h, wd, c)) return err;
  const Geom g = make_geom(b, h, wd, c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_norm_pool<float>(x, w, chan, out, g, device, s);
  if (dtype == 1)
    return launch_norm_pool<__nv_bfloat16>(x, w, chan, out, g, device, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int stem_bwd1(const void* x, const float* w, const float* chan,
              const void* dy, float* part, int b, int h, int wd, int c,
              int dtype, int device, void* stream) {
  if (int err = check_geom(b, h, wd, c)) return err;
  const Geom g = make_geom(b, h, wd, c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd1<float>(x, w, chan, dy, part, g, device, s);
  if (dtype == 1)
    return launch_bwd1<__nv_bfloat16>(x, w, chan, dy, part, g, device, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dxp: the (B, slabs, C / 8, 14, W) float32 dx partials (torch.empty; rows
// outside the image are left unwritten), summed by stem_dx_reduce.
int stem_bwd2(const void* x, const float* w, const float* chan,
              const void* dy, float* dwp, float* dbp, float* dxp, int b,
              int h, int wd, int c, int dtype, int device, void* stream) {
  if (int err = check_geom(b, h, wd, c)) return err;
  const Geom g = make_geom(b, h, wd, c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd2<float>(x, w, chan, dy, dwp, dbp, dxp, g, device, s);
  if (dtype == 1)
    return launch_bwd2<__nv_bfloat16>(x, w, chan, dy, dwp, dbp, dxp, g,
                                      device, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dx: (B, H, W) float32 from stem_bwd2's partials dxp.
int stem_dx_reduce(const float* dxp, float* dx, int b, int h, int wd, int c,
                   int device, void* stream) {
  if (int err = check_geom(b, h, wd, c)) return err;
  const Geom g = make_geom(b, h, wd, c);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = (long long)b * h * wd;
  dx_reduce_kernel<<<static_cast<unsigned>((n + THREADS - 1) / THREADS),
                     THREADS, 0, static_cast<cudaStream_t>(stream)>>>(dxp, dx,
                                                                      g);
  return static_cast<int>(cudaGetLastError());
}

const char* stem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
