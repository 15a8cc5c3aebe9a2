// Fused IEKD stem for Hopper (sm_90a): 7x7 s1 p2 conv (Cin = 1, with bias)
// -> BatchNorm affine -> ReLU -> 3x3 s2 p1 maxpool, forward and backward.
//
// Replaces the TPU kernels of experiments/stem_pallas.py (`_stats_kernel`,
// `_norm_pool_kernel`, `_bwd1_kernel`, `_bwd2_kernel`) and, for the forward,
// those of experiments/stem_banded.py (`_stats_kernel`, `_normpool_kernel`),
// which compute the same two functions. Four kernels:
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
//                   partials of dW (C, 49) and db (C); dx by the transposed
//                   conv of dz.
//
// None of the 110^2 x C conv map goes to device memory: every kernel
// recomputes the conv rows it needs from the (B, H, W) input.
//
// Design. A block owns R = 4 pooled rows [p0, p0 + R) of one image, for a
// chunk of CC = 8 channels; grid (ceil(hp / R), C / CC, B). It stages the
// input rows it needs (zero padded) and the chunk's 7x7 weights in shared
// memory, computes the conv rows [2 p0 - 1, 2 p0 + 2 R + 2) into shared
// memory (each thread keeps one channel's 49 weights in registers and walks
// the row-major conv positions, so a warp reads 32 neighbouring inputs and
// no bank conflicts), and runs the epilogue from there. This is the halo the
// Pallas kernel recomputes (`_slab_h`); its parity split, one-hot matmuls
// and `_zpad` existed only because Mosaic forbids stride-2 vector ops and
// are not needed here.
//
// Max-pool routing follows torch's rule (the plain version's max_pool2d
// backward): one position per window, the first maximum of relu(n) in
// row-major order. The backward gathers: each conv position of the block's
// own rows [2 p0, 2 p0 + 2 R) checks the at most 2 x 2 windows that contain
// it and takes dy from a window only if it is that window's chosen position,
// so routing needs no atomics. The Pallas kernel sends dy to every tied
// position (stem_pallas.py:55-58); the two rules differ only on ties, and
// ties at zero are masked by the ReLU gate.
//
// dx accumulates with float32 atomicAdd into a zeroed (B, H, W) buffer: the
// input rows a block's dz rows touch overlap the next block's by 6 rows, and
// every channel chunk adds to the same pixels. Recomputing dz over a 6-pixel
// halo for all C channels in one block would need the whole channel range
// in shared memory (about 200 KB at C = 64); atomics cost one add per pixel
// per block after a shared-memory pre-sum. The summation order of dx varies
// from run to run.
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
// needs two conv-sized products (dW and dx), 91 us. This first kernel
// recomputes the conv in each of the four passes, reads its operands from
// shared memory on every FMA and uses no tensor cores; it is written to be
// right, not to reach the bound.

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
  int xw;              // padded input row width, w + 4
};

Geom make_geom(int b, int h, int w, int c) {
  Geom g;
  g.b = b; g.h = h; g.w = w; g.c = c;
  g.hc = h - 2; g.wc = w - 2;
  g.hp = (g.hc - 1) / 2 + 1; g.wp = (g.wc - 1) / 2 + 1;
  g.slabs = (g.hp + R - 1) / R;
  g.xw = w + 4;
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
  const int tid = threadIdx.x;
  const T* xb = x + (long long)b * g.h * g.w;
  const int n_in = (zrows + 6) * g.xw;
  for (int e = tid; e < n_in; e += THREADS) {
    const int row = zr0 + e / g.xw - 2, col = e % g.xw - 2;
    s.xin[e] = (row >= 0 && row < g.h && col >= 0 && col < g.w)
                   ? to_f32(xb[row * g.w + col])
                   : 0.f;
  }
  for (int e = tid; e < CC * KK; e += THREADS) s.ws[e] = w[c0 * KK + e];
  __syncthreads();
  const int n_z = zrows * g.wc;
  for (int cc = 0; cc < CC; ++cc) {
    float wr[KK];
#pragma unroll
    for (int k = 0; k < KK; ++k) wr[k] = s.ws[cc * KK + k];
    const float bias = chan[CH_BIAS * g.c + c0 + cc];
    float* zc = s.zb + cc * n_z;
    for (int e = tid; e < n_z; e += THREADS) {
      const int lr = e / g.wc, xo = e % g.wc;
      const float* xr = s.xin + lr * g.xw + xo;
      float acc = bias;
#pragma unroll
      for (int i = 0; i < KS; ++i)
#pragma unroll
        for (int j = 0; j < KS; ++j)
          acc = fmaf(wr[i * KS + j], xr[i * g.xw + j], acc);
      zc[e] = acc;
    }
  }
  __syncthreads();
}

// Sums each of the CC values over the block; every thread gets the totals.
__device__ void block_sum(float (&v)[CC], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int cc = 0; cc < CC; ++cc)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[cc] += __shfl_down_sync(0xffffffffu, v[cc], off);
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
__global__ void __launch_bounds__(THREADS)
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

// out: (B, C, hp, wp) in x's type.
template <typename T>
__global__ void __launch_bounds__(THREADS)
norm_pool_kernel(const T* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ chan, T* __restrict__ out,
                 Geom g) {
  const int slab = blockIdx.x, c0 = blockIdx.y * CC, b = blockIdx.z;
  const int p0 = slab * R;
  const int zr0 = 2 * p0 - 1, zrows = 2 * R + 1;
  const Smem s = carve(g, zrows);
  stage(g, s, x, w, chan, b, c0, zr0, zrows);
  const int n_z = zrows * g.wc;
  const int items = R * g.wp;
  for (int cc = 0; cc < CC; ++cc) {
    const int c = c0 + cc;
    const float a = chan[CH_A * g.c + c], be = chan[CH_BETA * g.c + c],
                mu = chan[CH_MU * g.c + c];
    const float* zc = s.zb + cc * n_z;
    for (int e = threadIdx.x; e < items; e += THREADS) {
      const int pr = e / g.wp, px = e % g.wp, py = p0 + pr;
      if (py >= g.hp) continue;
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
      store_as(out + (((long long)b * g.c + c) * g.hp + py) * g.wp + px,
               fmaxf(m, 0.f));
    }
  }
}

// Shared part of both backward kernels: stage conv rows [2 p0 - 1,
// 2 p0 + 2 R + 2), choose each window's position (windows p0 .. p0 + R),
// then visit each own conv position with its routed and gated gradient dn.
// `visit(cc, e, lr, xx, z, dn)` runs once per own position (valid or not:
// dn = 0 and `valid` false outside the map).
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
template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd1_kernel(const T* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ chan, const T* __restrict__ dy,
            float* __restrict__ part, Geom g) {
  const int slab = blockIdx.x, c0 = blockIdx.y * CC, b = blockIdx.z;
  const Smem s = carve(g, 2 * R + 3);
  float sdn[CC], sdnx[CC];
#pragma unroll
  for (int cc = 0; cc < CC; ++cc) sdn[cc] = sdnx[cc] = 0.f;
  backward_common(g, s, x, w, chan, dy, b, c0, slab * R,
                  [&](int cc, int, float z, float dn, bool) {
                    const int c = c0 + cc;
                    const float xhat = (z - chan[CH_MU * g.c + c]) *
                                       chan[CH_INV * g.c + c];
                    sdn[cc] += dn;
                    sdnx[cc] = fmaf(dn, xhat, sdnx[cc]);
                  });
  block_sum(sdn, s.red);
  block_sum(sdnx, s.red);
  if (threadIdx.x < CC) {
    const int cc = threadIdx.x;
    const long long plane = (long long)g.b * g.slabs * g.c;
    const long long i = ((long long)b * g.slabs + slab) * g.c + c0 + cc;
    part[i] = sdn[cc];
    part[plane + i] = sdnx[cc];
  }
}

// dwp: (B, slabs, C, 49), dbp: (B, slabs, C), dx: (B, H, W) float32, zeroed
// by the caller and accumulated atomically.
template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd2_kernel(const T* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ chan, const T* __restrict__ dy,
            float* __restrict__ dwp, float* __restrict__ dbp,
            float* __restrict__ dx, Geom g) {
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
  // the own dz rows lr = ir - i in [1, 2R]
  float* dxb = dx + (long long)b * g.h * g.w;
  const int n_dx = (2 * R + 6) * g.w;
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
    if (acc != 0.f) atomicAdd(dxb + row * g.w + col, acc);
  }
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
  const size_t bytes = smem_bytes(g, 2 * R + 3, true);
  if (int err = prepare(bwd1_kernel<T>, bytes, device)) return err;
  bwd1_kernel<T><<<dim3(g.slabs, g.c / CC, g.b), THREADS, bytes, s>>>(
      static_cast<const T*>(x), w, chan, static_cast<const T*>(dy), part, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd2(const void* x, const float* w, const float* chan,
                const void* dy, float* dwp, float* dbp, float* dx,
                const Geom& g, int device, cudaStream_t s) {
  const size_t bytes = smem_bytes(g, 2 * R + 3, true);
  if (int err = prepare(bwd2_kernel<T>, bytes, device)) return err;
  bwd2_kernel<T><<<dim3(g.slabs, g.c / CC, g.b), THREADS, bytes, s>>>(
      static_cast<const T*>(x), w, chan, static_cast<const T*>(dy), dwp,
      dbp, dx, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// All four launch on `stream` and return cudaGetLastError() after the launch
// (0 on success). dtype 0 = float32, 1 = bfloat16 for x, out, dy. x is a
// contiguous (B, H, W) tensor, w a contiguous float32 (C, 49), chan a
// float32 (7, C) array of rows bias, a, beta, mean, inv, E[dn], E[dn * xhat]
// (each kernel reads the rows it needs). slabs = ceil(hp / 4) with
// hp = (H - 3) / 2 + 1; C must be a multiple of 8.

int stem_slabs(int h) { return ((h - 3) / 2 + 1 + R - 1) / R; }

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

int stem_bwd2(const void* x, const float* w, const float* chan,
              const void* dy, float* dwp, float* dbp, float* dx, int b, int h,
              int wd, int c, int dtype, int device, void* stream) {
  if (int err = check_geom(b, h, wd, c)) return err;
  const Geom g = make_geom(b, h, wd, c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd2<float>(x, w, chan, dy, dwp, dbp, dx, g, device, s);
  if (dtype == 1)
    return launch_bwd2<__nv_bfloat16>(x, w, chan, dy, dwp, dbp, dx, g,
                                      device, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* stem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
