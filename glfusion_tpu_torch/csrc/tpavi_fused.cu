// Fused TPAVI dot non-local attention for Hopper (sm_90a):
//
//     y[b] = (theta[b] · phi[b]^T) · g[b] / N          operands (B, N, C')
//
// Replaces the TPU kernel glfusion_tpu/ops/tpavi_pallas.py (`_kernel`,
// launched by `_fused_dot_nonlocal_fwd_impl`). Like that kernel it keeps the
// reference's naive contraction order, never writes the N x N similarity map
// to device memory, accumulates in float32, keeps the similarity tile in
// float32 for the second product, and divides by the TRUE token count N.
// Inputs are float32 or bfloat16; the output has the input's type.
//
// Bound on an H100 at the serving shape B = 40, N = 2352, C' = 1024. The
// function needs 4·B·N·C'·min(N, C') = 3.95e11 FLOP per call (the
// reassociated order θ(φᵀg)/N, since N > C'), while the bytes it must move
// are 4·B·N·C'·itemsize = 1.54 GB in float32. At 67 TFLOP/s (float32
// outside the tensor cores) against 3.35 TB/s the call is compute-bound:
// 5.9 ms of FMA against 0.46 ms of memory. In bfloat16 against the 989
// TFLOP/s tensor-core peak the bound is 0.40 ms. This kernel keeps the naive
// order, 4·B·N²·C' = 9.06e11 FLOP (13.5 ms of FMA at best), so it cannot
// reach the function's bound at N > C'; nor does it use the tensor cores
// yet (plain FMA on float32 values in both types), so bfloat16 gains
// nothing over float32.
//
// Design. The Pallas kernel keeps whole (T, C'_pad) rows in 14 MiB of VMEM;
// a Hopper block cannot. This kernel takes design (a): one block owns
// BM = 32 query rows of one batch element and the WHOLE C' of their output,
// so the similarity map is computed exactly once (design (b), a C'-column
// tile per block, would recompute θφᵀ C'/BD times). The (32, C') float32
// accumulator does not live in shared memory but in registers, spread over
// the block: each of the 256 threads owns 4 output channels of all 32 rows
// (128 registers), which caps C' at 4·256 = 1024, the model's width. The
// block walks the keys in tiles of BK = 128:
//   1. S[32, 128] = θ[rows] · φ[keys]ᵀ, looping over C' in chunks of 32
//      staged through shared memory (θ and φ stored channel-major so each
//      warp reads its 4 θ rows as one broadcast float4); each thread owns a
//      4 x 4 piece of S. The next chunk's global loads are issued before the
//      current chunk is multiplied.
//   2. S goes to shared memory key-major; every thread then reads S[k, 0:32]
//      as eight broadcast float4 and multiplies it by its 4 channels of
//      g[k] (read straight from global memory, prefetched one step ahead):
//      128 FMAs per key per thread against 9 loads.
// Rows and keys past N are loaded as zero and never stored, so ragged N
// needs no padding. The grid is (ceil(N/32), B): 2960 independent blocks at
// the serving shape, about 22 waves over 132 SMs. Shared memory is 39 KB
// (static), one block of 8 warps per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 32;                 // query rows per block
constexpr int BK = 128;                // keys per key tile
constexpr int KC = 32;                 // channels per θφᵀ chunk
constexpr int THREADS = 256;           // 8 warps
constexpr int COLS = 4;                // output channels per thread
constexpr int MAX_C = THREADS * COLS;  // 1024
constexpr int TP = BM + 4;             // padded row: θ chunk and S tile
constexpr int PP = BK + 4;             // padded row: φ chunk
constexpr int KG = 2;                  // keys of g per prefetch step
constexpr int TH_PER = BM * KC / THREADS;  // θ values staged per thread (4)
constexpr int PH_PER = BK * KC / THREADS;  // φ values staged per thread (16)

static_assert(BM == 32 && THREADS == 256, "warp w owns S rows 4w..4w+3");
static_assert(BK == 128, "lane l owns S keys l + 32j, j < 4");
static_assert(BK % KG == 0, "prefetch steps tile the key tile");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
fused_dot_nonlocal_kernel(const T* __restrict__ theta,
                          const T* __restrict__ phi,
                          const T* __restrict__ g, T* __restrict__ out, int n,
                          int c, long long theta_sb, long long theta_sn,
                          long long phi_sb, long long phi_sn, long long g_sb,
                          long long g_sn) {
  __shared__ __align__(16) float th_s[KC][TP];  // θ chunk, [channel][row]
  __shared__ __align__(16) float ph_s[KC][PP];  // φ chunk, [channel][key]
  __shared__ __align__(16) float s_s[BK][TP];   // S tile, [key][row]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * BM;
  const long long b = blockIdx.y;
  const T* th_b = theta + b * theta_sb;
  const T* ph_b = phi + b * phi_sb;
  const T* g_b = g + b * g_sb;
  const int col0 = tid * COLS;  // this thread's output channels

  float acc[BM][COLS];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[r][j] = 0.f;

  float th_r[TH_PER];
  float ph_r[PH_PER];

  for (int key0 = 0; key0 < n; key0 += BK) {
    const int kn = min(BK, n - key0);

    // Global -> registers for the chunk of channels starting at c0;
    // consecutive threads read consecutive channels of one row.
    auto load_chunk = [&](int c0) {
#pragma unroll
      for (int i = 0; i < TH_PER; ++i) {
        const int e = tid + i * THREADS;
        const int r = e / KC, cc = e % KC;
        th_r[i] = (row0 + r < n && c0 + cc < c)
                      ? to_f32(th_b[(row0 + r) * theta_sn + c0 + cc])
                      : 0.f;
      }
#pragma unroll
      for (int i = 0; i < PH_PER; ++i) {
        const int e = tid + i * THREADS;
        const int k = e / KC, cc = e % KC;
        ph_r[i] = (k < kn && c0 + cc < c)
                      ? to_f32(ph_b[(key0 + k) * phi_sn + c0 + cc])
                      : 0.f;
      }
    };

    // ---- 1. S = θ[rows] · φ[keys]ᵀ over all C' channels.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;

    load_chunk(0);
    for (int c0 = 0; c0 < c; c0 += KC) {
      __syncthreads();  // the previous chunk has been read by every warp
#pragma unroll
      for (int i = 0; i < TH_PER; ++i) {
        const int e = tid + i * THREADS;
        th_s[e % KC][e / KC] = th_r[i];
      }
#pragma unroll
      for (int i = 0; i < PH_PER; ++i) {
        const int e = tid + i * THREADS;
        ph_s[e % KC][e / KC] = ph_r[i];
      }
      __syncthreads();
      if (c0 + KC < c) load_chunk(c0 + KC);  // in flight during the FMAs
#pragma unroll 8
      for (int cc = 0; cc < KC; ++cc) {
        const float4 t = *reinterpret_cast<const float4*>(&th_s[cc][warp * 4]);
        const float tv[4] = {t.x, t.y, t.z, t.w};
        float pv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) pv[j] = ph_s[cc][lane + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(tv[i], pv[j], s[i][j]);
      }
    }
    // Every thread has passed the chunk loop's barriers since it last read
    // s_s, so the tile can be overwritten.
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&s_s[lane + 32 * j][warp * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // ---- 2. acc[rows, my channels] += S · g[keys, my channels].
    if (col0 < c) {
      auto load_g = [&](float (&dst)[KG][COLS], int k) {
#pragma unroll
        for (int u = 0; u < KG; ++u)
#pragma unroll
          for (int j = 0; j < COLS; ++j)
            dst[u][j] = (k + u < kn && col0 + j < c)
                            ? to_f32(g_b[(key0 + k + u) * g_sn + col0 + j])
                            : 0.f;
      };
      float gr[KG][COLS];
      load_g(gr, 0);
      for (int k = 0; k < kn; k += KG) {
        float gnext[KG][COLS];
        load_g(gnext, k + KG);
#pragma unroll
        for (int u = 0; u < KG; ++u) {
#pragma unroll
          for (int q = 0; q < BM / 4; ++q) {
            const float4 sv =
                *reinterpret_cast<const float4*>(&s_s[k + u][4 * q]);
            const float svv[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < COLS; ++j)
                acc[4 * q + i][j] = fmaf(svv[i], gr[u][j], acc[4 * q + i][j]);
          }
        }
#pragma unroll
        for (int u = 0; u < KG; ++u)
#pragma unroll
          for (int j = 0; j < COLS; ++j) gr[u][j] = gnext[u][j];
      }
    }
  }

  if (col0 >= c) return;
  const float nf = static_cast<float>(n);
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    if (row0 + r < n) {
      T* dst = out + (b * n + row0 + r) * static_cast<long long>(c) + col0;
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        if (col0 + j < c) store_as(dst + j, acc[r][j] / nf);
    }
  }
}

}  // namespace

extern "C" {

// Launches y = (θφᵀ)·g / N on `stream`. dtype 0 = float32, 1 = bfloat16.
// θ, φ and g are (batch, n, c) with unit channel stride and the given batch
// and row strides (in elements); `out` is a contiguous (batch, n, c) tensor.
// Returns cudaGetLastError() after the launch (0 on success).
int tpavi_fused_dot_nonlocal(const void* theta, const void* phi,
                             const void* g, void* out, int batch, int n,
                             int c, int dtype, long long theta_sb,
                             long long theta_sn, long long phi_sb,
                             long long phi_sn, long long g_sb, long long g_sn,
                             int device, void* stream) {
  if (batch <= 0 || batch > 65535 || n <= 0 || c <= 0 || c > MAX_C)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BM - 1) / BM, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    fused_dot_nonlocal_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(theta), static_cast<const float*>(phi),
        static_cast<const float*>(g), static_cast<float*>(out), n, c,
        theta_sb, theta_sn, phi_sb, phi_sn, g_sb, g_sn);
  } else if (dtype == 1) {
    fused_dot_nonlocal_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(theta),
        static_cast<const __nv_bfloat16*>(phi),
        static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(out), n, c, theta_sb, theta_sn, phi_sb,
        phi_sn, g_sb, g_sn);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tpavi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
