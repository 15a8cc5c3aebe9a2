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
// stem_bwd2 has the engine store z rows at the input's padded stride, so
// that its dz, written over z, is dx's zero-padded operand as it stands.
//
// Max-pool routing follows torch's rule (the plain version's max_pool2d
// backward): one position per window, the first maximum of relu(n) in
// row-major order. stem_bwd2 gathers, a warp per channel: a lane per
// window records its choice and its dy gated by the ReLU there, then each
// conv position of the block's own rows [2 p0, 2 p0 + 2 R) adds the gated
// dy of those of its at most 2 x 2 windows that chose it, in a fixed order,
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
// the conv in each of the four passes and use no tensor cores. stem_bwd2's
// dW and dx run the engine's discipline (16-byte shared loads into
// registers, 7 x 8 FMAs a kernel row, a warp per channel for dW, dx's rows
// balanced over the warps); stem_stats' moments are a warp per channel.
// Every kernel fits 80 registers without spilling, 3 blocks an SM; the
// backward's blocks take 47 KB (stem_bwd1) and 66 KB (stem_bwd2) of shared
// memory at W = 112.

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
// registers, which the engine and stem_bwd2's 49 dW accumulators fit
// without spilling; shared memory allows 4 blocks of stem_bwd1 and 3 of
// stem_bwd2, but at 64 registers the engine spills.
constexpr int MIN_BLOCKS = 3;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// max that keeps a NaN, as torch's relu and max_pool2d and JAX's maximum
// do (fmaxf would return the other operand)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
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

// Shared memory of a block whose conv rows are [zr0, zr0 + zrows), with
// z's rows zs floats apart. stem_bwd2 also carves `wf` and `dxs`.
struct Smem {
  float* xin;          // (zrows + 6, xw): input rows zr0 - 2 .., zero padded
  float* ws;           // (CC, 49) weights of the chunk
  float* zb;           // (CC, zrows, zs) conv values (dz in bwd2)
  float* wf;           // (CC, 7, 8) weights flipped 180 degrees, zero padded
  float* dxs;          // (2, DXR, xw) dx of the chunk's two channel halves
  signed char* arg;    // (CC, R + 1, wp) chosen position of each window
};

size_t smem_bytes(const Geom& g, int zrows, int zs, bool bwd2) {
  size_t f = (size_t)(zrows + 6) * g.xw + CC * KK + (size_t)CC * zrows * zs;
  if (bwd2) f += CC * KS * 8 + 2 * DXR * g.xw;
  return f * sizeof(float) + (bwd2 ? (size_t)CC * (R + 1) * g.wp : 0);
}

__device__ Smem carve(const Geom& g, int zrows, int zs) {
  extern __shared__ __align__(16) float smem[];
  Smem s;
  s.xin = smem;
  s.ws = s.xin + (zrows + 6) * g.xw;
  s.zb = s.ws + CC * KK;
  s.wf = s.zb + CC * zrows * zs;
  s.dxs = s.wf + CC * KS * 8;
  s.arg = reinterpret_cast<signed char*>(s.dxs + 2 * DXR * g.xw);
  return s;
}

// Stage the input rows and weights, then z for conv rows [zr0, zr0 + zrows)
// and all wc columns, column xx of row lr at zb[(cc * zrows + lr) * zs +
// zoff + xx] (rows outside [0, hc) are computed from zero padding and
// masked by the callers).
template <typename T>
__device__ void stage(const Geom& g, const Smem& s, const T* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ chan, int b, int c0, int zr0,
                      int zrows, int zs, int zoff) {
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
  float* zc = s.zb + cc * zrows * zs + zoff;
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
    float* zr = zc + lr * zs + x0;
    // pairs: 8-byte stores (zs and zoff are then even; conflict-free at
    // zs = wc)
    if (g.wc % 2 == 0) {
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

// ---------------------------------------------------------------- kernels

// part: (3, B, slabs, C) = count, mean, M2 of the block's own conv rows
// [2 p0, 2 p0 + 2 R) within [0, hc). After the conv, warp cc takes channel
// cc alone: its lanes stride the valid positions, a fixed-order warp_sum
// gives the mean, a second pass over shared z gives M2.
template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
stats_kernel(const T* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ chan, float* __restrict__ part,
             Geom g) {
  const int slab = blockIdx.x, c0 = blockIdx.y * CC, b = blockIdx.z;
  const int zr0 = 2 * slab * R, zrows = 2 * R;
  const Smem s = carve(g, zrows, g.wc);
  stage(g, s, x, w, chan, b, c0, zr0, zrows, g.wc, 0);
  const int cc = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = min(zrows, g.hc - zr0) * g.wc;
  const float* zc = s.zb + cc * zrows * g.wc;
  float v = 0.f;
  for (int e = lane; e < n; e += 32) v += zc[e];
  const float mean = __shfl_sync(0xffffffffu, warp_sum(v), 0) / n;
  v = 0.f;
  for (int e = lane; e < n; e += 32) {
    const float d = zc[e] - mean;
    v = fmaf(d, d, v);
  }
  v = warp_sum(v);
  if (lane == 0) {
    const long long plane = (long long)g.b * g.slabs * g.c;
    const long long i = ((long long)b * g.slabs + slab) * g.c + c0 + cc;
    part[i] = static_cast<float>(n);
    part[plane + i] = mean;
    part[2 * plane + i] = v;
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
  const Smem s = carve(g, zrows, g.wc);
  stage(g, s, x, w, chan, b, c0, zr0, zrows, g.wc, 0);
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
        m = nan_max(fmaf(zc[(y - zr0) * g.wc + xx] - mu, a, be), m);
      }
    }
    store_as(outc + py * g.wp + px, nan_max(m, 0.f));
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
  const Smem s = carve(g, zrows, g.wc);
  stage(g, s, x, w, chan, b, c0, zr0, zrows, g.wc, 0);
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

// The dx work of a block: its DXR = 14 partial rows as 7 row pairs, each
// summed over the chunk's channels in two halves of 4. Entry p + 7 h of a
// warp is pair p, half h (-1: none). Pair p reaches 2, 4, 6, 7, 6, 4, 2 of
// the 7 kernel rows (the rest fall outside the own dz rows), so the 14
// items are spread over the 8 warps by that count: 7 or 8 rows a warp.
constexpr int DX_PAIRS = DXR / 2;
static_assert(R == 4 && WARPS == 8 && CC == 8,
              "the dx schedule is written for 14 partial rows, 8 warps and "
              "8 channels");
__constant__ signed char kDxItems[WARPS][2] = {
    {3, -1}, {10, -1}, {2, 0}, {9, 7}, {4, 6}, {11, 13}, {1, 5}, {8, 12}};

// dwp: (B, slabs, C, 49), dbp: (B, slabs, C), dxp: (B, slabs, C / CC, DXR,
// W), row r of a block's slice being input row 2 R slab - 2 + r; rows
// outside the image are not written.
//
// The block stages conv rows [2 p0 - 1, 2 p0 + 2 R + 2), z's rows zs = xw
// floats apart with 4 zero columns on the left and zeros right of wc, so
// that dz, written over z in place, is already the zero-padded operand of
// dx. Then, warp cc for channel cc alone:
//   1. chooses each window's position (windows p0 .. p0 + R, a lane per
//      window): the first max of relu(n), row-major, as torch's max_pool2d
//      backward routes, and records the window's dy gated by the ReLU
//      there (one read of dy per window);
//   2. gathers dn at each own position (conv rows [2 p0, 2 p0 + 2 R)) from
//      the at most 2 x 2 windows that chose it, writes dz over z, zeroes
//      the halo rows, and sums db with a fixed-order warp_sum;
//   3. sums dW over its own rows: a lane task is (own row, 8-wide strip);
//      per kernel row it loads the strip's 8 dz values and the 16 inputs
//      around them as 16-byte loads and runs 7 x 8 FMAs from registers.
// After a barrier, dx is the correlation of the padded dz with the weights
// flipped 180 degrees: a lane takes a strip of 8 outputs of one partial
// row and, for each channel of its half and each kernel row that reaches
// an own dz row, runs 7 x 8 FMAs from four 16-byte dz loads and two
// warp-uniform weight loads. The two halves are added in a fixed order.
// (Running the engine per channel into per-warp dx partials instead would
// reuse stage() but needs CC x DXR x W floats, 50 KB at W = 112, more a
// block: 2 blocks an SM instead of 3. The two halves take 13 KB.)
template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
bwd2_kernel(const T* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ chan, const T* __restrict__ dy,
            float* __restrict__ dwp, float* __restrict__ dbp,
            float* __restrict__ dxp, Geom g) {
  const int slab = blockIdx.x, c0 = blockIdx.y * CC, b = blockIdx.z;
  const int p0 = slab * R, zr0 = 2 * p0 - 1, zrows = 2 * R + 3;
  const int tid = threadIdx.x, cc = tid >> 5, lane = tid & 31, c = c0 + cc;
  const int zs = g.xw;
  const Smem s = carve(g, zrows, zs);
  // z's pad columns and the flipped weights (stage()'s barrier orders them)
  const int pad = zs - g.wc;
  for (int e = tid; e < CC * zrows * pad; e += THREADS) {
    const int q = e % pad;
    s.zb[e / pad * zs + (q < 4 ? q : q + g.wc)] = 0.f;
  }
  for (int e = tid; e < CC * KS * 8; e += THREADS) {
    const int ch = e / (KS * 8), i = e / 8 % KS, j = e % 8;
    s.wf[e] = j < KS ? w[(c0 + ch) * KK + (KS - 1 - i) * KS + KS - 1 - j]
                     : 0.f;
  }
  stage(g, s, x, w, chan, b, c0, zr0, zrows, zs, 4);
  const float a = chan[CH_A * g.c + c], be = chan[CH_BETA * g.c + c],
              mu = chan[CH_MU * g.c + c], inv = chan[CH_INV * g.c + c];
  float* zc = s.zb + cc * zrows * zs + 4;  // row lr, column xx: lr * zs + xx
  // 1. each window's chosen position, and its dy gated by the ReLU there
  //    (dxs is free until dx: (R + 1) wp <= 2 DXR xw / CC)
  const T* dyc = dy + ((long long)b * g.c + c) * g.hp * g.wp;
  signed char* argc = s.arg + cc * (R + 1) * g.wp;
  float* dyg = s.dxs + cc * (R + 1) * g.wp;
  for (int wr = 0; wr <= R; ++wr) {
    const int py = p0 + wr;
    for (int px = lane; px < g.wp; px += 32) {
      int best = -1;
      float gated = 0.f;
      if (py < g.hp) {
        float bv = -INFINITY;
        for (int di = 0; di < 3; ++di) {
          const int y = 2 * py - 1 + di;
          if (y < 0 || y >= g.hc) continue;
          for (int dj = 0; dj < 3; ++dj) {
            const int xx = 2 * px - 1 + dj;
            if (xx < 0 || xx >= g.wc) continue;
            const float hv =
                fmaxf(fmaf(zc[(y - zr0) * zs + xx] - mu, a, be), 0.f);
            if (hv > bv) {
              bv = hv;
              best = di * 3 + dj;
            }
          }
        }
        if (bv > 0.f) gated = to_f32(dyc[py * g.wp + px]);
      }
      argc[wr * g.wp + px] = static_cast<signed char>(best);
      dyg[wr * g.wp + px] = gated;
    }
  }
  __syncwarp();
  // 2. dz over the own rows; dz = 0 on rows past the map. dn sums the
  //    gated dy of the windows that chose the position (a window chooses a
  //    position with n > 0 exactly when its gated dy is nonzero).
  const float edn = chan[CH_EDN * g.c + c], ednx = chan[CH_EDNX * g.c + c];
  float sdz = 0.f;
  for (int lr = 1; lr <= 2 * R; ++lr) {
    const int y = zr0 + lr;
    float* zr = zc + lr * zs;
    if (y >= g.hc) {
      for (int xx = lane; xx < g.wc; xx += 32) zr[xx] = 0.f;
      continue;
    }
    // the windows containing row y: py = y >> 1 (at offset 1 or 2), and
    // for odd y also py + 1 (offset 0); the same for the columns
    const int py = y >> 1, ri = y - 2 * py + 1;
    const bool py2 = (y & 1) && py + 1 < g.hp;
    const signed char* a0 = argc + (py - p0) * g.wp;
    const signed char* a1 = a0 + g.wp;
    const float* d0 = dyg + (py - p0) * g.wp;
    const float* d1 = d0 + g.wp;
    for (int xx = lane; xx < g.wc; xx += 32) {
      const float z = zr[xx];
      const int px = xx >> 1, ci = xx - 2 * px + 1;
      const bool px2 = (xx & 1) && px + 1 < g.wp;
      float dn = 0.f;
      if (a0[px] == ri * 3 + ci) dn += d0[px];
      if (px2 && a0[px + 1] == ri * 3) dn += d0[px + 1];
      if (py2) {
        if (a1[px] == ci) dn += d1[px];
        if (px2 && a1[px + 1] == 0) dn += d1[px + 1];
      }
      const float xhat = (z - mu) * inv;
      const float dz = a * dn - a * fmaf(xhat, ednx, edn);
      zr[xx] = dz;
      sdz += dz;
    }
  }
  // the halo rows 0 and 2 R + 1 become dx's zero rows
  for (int xx = lane; xx < g.wc; xx += 32) {
    zc[xx] = 0.f;
    zc[(2 * R + 1) * zs + xx] = 0.f;
  }
  sdz = warp_sum(sdz);
  const long long blk = (long long)b * g.slabs + slab;
  if (lane == 0) dbp[blk * g.c + c] = sdz;
  __syncwarp();
  // 3. dW[i][j] = sum over own rows lr and columns xx of
  //    dz[lr][xx] * xin[lr + i][xx + j], all 49 in registers (7 a pass,
  //    re-loading dz, ran 6 % slower). The ragged last strip reads dz's
  //    zero pad (or the next row's left pad).
  {
    const int tasks = 2 * R * ((g.wc + STRIP - 1) / STRIP);
    float acc[KK];
#pragma unroll
    for (int k = 0; k < KK; ++k) acc[k] = 0.f;
    for (int t = lane; t < tasks; t += 32) {
      const int lr = 1 + t % (2 * R), x0 = t / (2 * R) * STRIP;
      const float* dzr = zc + lr * zs + x0;
      float d[STRIP];
#pragma unroll
      for (int q = 0; q < STRIP / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(dzr + 4 * q);
        d[4 * q] = v.x; d[4 * q + 1] = v.y;
        d[4 * q + 2] = v.z; d[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        const float* xr = s.xin + (lr + i) * g.xw + x0;
        float in[STRIP + 8];
#pragma unroll
        for (int q = 0; q < (STRIP + 8) / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(xr + 4 * q);
          in[4 * q] = v.x; in[4 * q + 1] = v.y;
          in[4 * q + 2] = v.z; in[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < KS; ++j)
#pragma unroll
          for (int k = 0; k < STRIP; ++k)
            acc[i * KS + j] = fmaf(d[k], in[k + j], acc[i * KS + j]);
      }
    }
    float* dwc = dwp + (blk * g.c + c) * KK;
#pragma unroll
    for (int k = 0; k < KK; ++k) {
      const float v = warp_sum(acc[k]);
      if (lane == 0) dwc[k] = v;
    }
  }
  __syncthreads();  // dx reads every channel's dz
  // dx partial row r, column col: sum over channels, kernel rows i and
  // columns j of wf[i][j] * dzpad[r + i - (KS - 2)][col + j], where
  // dzpad's row lr is dz's own row lr (zero at 0 and 2 R + 1) and its
  // column col + j is zb's column col + j (dz column col + j - 4).
  const int nstrips = (g.w + STRIP - 1) / STRIP;
  for (int it = 0; it < 2; ++it) {
    const int item = kDxItems[cc][it];
    if (item < 0) break;
    const int pair = item % DX_PAIRS, h = item / DX_PAIRS;
    const int r = 2 * pair + (lane & 1);
    const int lo = max(0, KS - 2 - 2 * pair);
    const int hi = min(KS - 1, 2 * R + KS - 2 - 2 * pair);
    float* out = s.dxs + (h * DXR + r) * g.xw;
    for (int x0 = (lane >> 1) * STRIP; x0 < nstrips * STRIP;
         x0 += 16 * STRIP) {
      float acc[STRIP];
#pragma unroll
      for (int k = 0; k < STRIP; ++k) acc[k] = 0.f;
      for (int ch = h * (CC / 2); ch < (h + 1) * (CC / 2); ++ch) {
        const float* dzc = s.zb + ch * zrows * zs + x0;
        const float* wfc = s.wf + ch * KS * 8;
        for (int i = lo; i <= hi; ++i) {
          const float* dr = dzc + (r + i - (KS - 2)) * zs;
          float in[STRIP + 8], wv[8];
#pragma unroll
          for (int q = 0; q < (STRIP + 8) / 4; ++q) {
            const float4 v = *reinterpret_cast<const float4*>(dr + 4 * q);
            in[4 * q] = v.x; in[4 * q + 1] = v.y;
            in[4 * q + 2] = v.z; in[4 * q + 3] = v.w;
          }
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float4 v =
                *reinterpret_cast<const float4*>(wfc + i * 8 + 4 * q);
            wv[4 * q] = v.x; wv[4 * q + 1] = v.y;
            wv[4 * q + 2] = v.z; wv[4 * q + 3] = v.w;
          }
#pragma unroll
          for (int j = 0; j < KS; ++j)
#pragma unroll
            for (int k = 0; k < STRIP; ++k)
              acc[k] = fmaf(wv[j], in[k + j], acc[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < STRIP; ++k)
        if (x0 + k < g.w) out[x0 + k] = acc[k];
    }
  }
  __syncthreads();
  float* dxb = dxp + (blk * (g.c / CC) + c0 / CC) * DXR * g.w;
  for (int r = cc; r < DXR; r += WARPS) {
    const int row = zr0 + r - 1;
    if (row < 0 || row >= g.h) continue;
    const float* h0 = s.dxs + r * g.xw;
    const float* h1 = h0 + DXR * g.xw;
    for (int col = lane; col < g.w; col += 32)
      dxb[r * g.w + col] = h0[col] + h1[col];
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
  const size_t bytes = smem_bytes(g, 2 * R, g.wc, false);
  if (int err = prepare(stats_kernel<T>, bytes, device)) return err;
  stats_kernel<T><<<dim3(g.slabs, g.c / CC, g.b), THREADS, bytes, s>>>(
      static_cast<const T*>(x), w, chan, part, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_norm_pool(const void* x, const float* w, const float* chan,
                     void* out, const Geom& g, int device, cudaStream_t s) {
  const size_t bytes = smem_bytes(g, 2 * R + 1, g.wc, false);
  if (int err = prepare(norm_pool_kernel<T>, bytes, device)) return err;
  norm_pool_kernel<T><<<dim3(g.slabs, g.c / CC, g.b), THREADS, bytes, s>>>(
      static_cast<const T*>(x), w, chan, static_cast<T*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd1(const void* x, const float* w, const float* chan,
                const void* dy, float* part, const Geom& g, int device,
                cudaStream_t s) {
  const size_t bytes = smem_bytes(g, 2 * R + 3, g.wc, false);
  if (int err = prepare(bwd1_kernel<T>, bytes, device)) return err;
  bwd1_kernel<T><<<dim3(g.slabs, g.c / CC, g.b), THREADS, bytes, s>>>(
      static_cast<const T*>(x), w, chan, static_cast<const T*>(dy), part, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd2(const void* x, const float* w, const float* chan,
                const void* dy, float* dwp, float* dbp, float* dxp,
                const Geom& g, int device, cudaStream_t s) {
  const size_t bytes = smem_bytes(g, 2 * R + 3, g.xw, true);
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
