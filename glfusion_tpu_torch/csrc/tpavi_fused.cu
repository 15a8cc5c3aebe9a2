// TPAVI dot non-local attention for Hopper (sm_90a):
//
//     y[b] = (theta[b] · phi[b]^T) · g[b] / N          operands (B, N, C')
//
// Replaces the TPU kernel glfusion_tpu/ops/tpavi_pallas.py (`_kernel`,
// launched by `_fused_dot_nonlocal_fwd_impl`). It computes that kernel's
// function in the cheaper of the two contraction orders, as two launches of
// one batched-GEMM engine:
//
//   N > C'  (every shape the model gives it):  M = φᵀ·g   (C' x C', over N)
//                                              y = θ·M / N
//   N <= C' (small frames):                    S = θ·φᵀ   (N x N, over C')
//                                              y = S·g / N
//
// At N > C' the N x N similarity map is never formed, in memory or on the
// chip. The intermediate (M or S) goes through a workspace the caller
// allocates. It keeps float32 precision, as the JAX package's products do
// (`preferred_element_type=float32`; the Pallas kernel contracts a float32
// similarity tile): float32 in a float32 call; in a bfloat16 call, where
// wgmma takes bfloat16 operands, a hi/lo pair, M_hi = bf16(M) and
// M_lo = bf16(M - M_hi), which carries 16 of float32's 24 significand bits
// (relative error about 2^-17, against 2^-9 for M_hi alone). Accumulation
// is float32 throughout; the division is by the TRUE token count N; the
// output has the input's type.
//
// Bound. Each stage is 2·B·N·C'·min(N, C') FLOP, so the call needs
// 4·B·N·C'·min(N, C'): 3.95e11 at the serving shape B = 40, N = 2352,
// C' = 1024, i.e. 5.89 ms of float32 FMA at 67 TFLOP/s (TF32 stays off) and
// 0.40 ms of bfloat16 tensor-core work at 989 TFLOP/s, against 0.46 ms
// (float32) of memory traffic at 3.35 TB/s for its 4·B·N·C' operands. The
// call is bound by operations in both types.
//
// Engines (the GEMM C[b] = A[b]·B[b] / div, A: M x K, B: K x N; A is either
// K-major or M-major in memory, B either K-major or N-major, rows strided):
//
//  * float32, FFMA (`ffma_gemm`): 128 x 128 output tile per block of 256
//    threads, 8 x 8 accumulators per thread, 2 blocks per SM. K-slices of
//    16 are staged by cp.async (16 bytes a copy where rows and bases are
//    16-byte aligned, 4 bytes otherwise, zero-filled past the edges) in a
//    ring of 3, each operand in its own majorness. A K-major A slice (θ in
//    y = θ·M) is transposed once in shared memory after it lands, so every
//    fragment read is a 128-bit load: 16 FMAs per shared load.
//  * bfloat16, tensor cores (`wgmma_gemm`): 128 x 256 output tiles, each
//    computed by two consumer warpgroups with wgmma.mma_async m64n256k16
//    (operands in shared memory, float32 accumulators in registers, one
//    K-slice's products kept in flight), fed by one producer thread that
//    issues TMA loads into a ring of 4 K-slices of 64 with mbarriers. One
//    persistent block per SM walks the tiles, so the producer fetches the
//    next tile while the consumers write the last one out. TMA reads the
//    strided views in place (128-byte swizzle, zero fill of the ragged
//    edges); the M- and N-major operands use wgmma's transpose bits. The
//    tensor maps are encoded on the host by cuTensorMapEncodeTiled, reached
//    through cudaGetDriverEntryPoint (no link against libcuda).
//    The hi/lo intermediate: stage 1's epilogue writes both halves from its
//    float32 accumulators into a (B, 2, rows, ld) workspace. Stage 2 runs
//    two accumulating passes over K into the same accumulators, the first
//    over the hi half, the second over the lo half, re-reading the other
//    operand's K-slices: the workspace is read through one tensor map as a
//    (2B, rows, ld) tensor, batch coordinate 2b + pass. Two passes rather
//    than one K loop of 2C' over [M_hi; M_lo]: K-slices of 64 would straddle
//    the hi/lo seam wherever C' is not a multiple of 64, and the pass index
//    costs the producer one batch coordinate. Stage 2 does twice the
//    tensor-core work; it stays bound by operations.
//
// Batch and output tile share one linear tile index, so the batch is not
// limited by gridDim.y; C' has no cap.
//
// Split K. Stage 1 of the reassociated order reduces over the N tokens. At
// batch 1 and a long token axis (the `temporal` option's clip: N = 94 080)
// one batched launch would give 64 output tiles, half the SMs idle, each
// summing 94 080 products in one register accumulator, whose float32
// rounding then grows past the plain version's (measured 5.8e-6 relative
// norm against 4.6e-8 at N = 4 800). There the caller runs stage 1 as P
// partial products over consecutive chunks of the tokens, each its own
// batch element of the engine (chunks of 4 096 tokens, and the
// remainder), and `split_reduce` sums the P partials, partial 0 first, in
// float32 into the workspace stage 2 reads, as float32 or as the hi/lo
// pair. A bfloat16 partial is itself a hi/lo pair: hi + lo first, then the
// running sum. The pass moves P·C'² floats, a few hundredths of a ms.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// float32 engine: FFMA register tiles
// ---------------------------------------------------------------------------
namespace ff {

constexpr int BM = 128, BN = 128, BK = 16, STAGES = 3, THREADS = 256;
constexpr int KPAD = BK + 4;  // row of a K-major tile: 20 floats, 16B-aligned

// Floats of one staged operand tile: MN-major [BK][128], K-major [128][KPAD].
template <bool MN>
__host__ __device__ constexpr int tile_floats() {
  return MN ? BK * 128 : 128 * KPAD;
}

template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int valid) {
  // copies `valid` floats (0..VEC) and zero-fills the rest of the VEC
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid * 4));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid * 4));
  }
}

// Stage rows [r0, r0 + 128) x K-slice [k0, k0 + BK) of one operand. X(r, k)
// lies at x[k·ld + r] when MN (M- or N-major), at x[r·ld + k] otherwise;
// `rows` and `kdim` are the operand's extents for masking.
template <bool MN, int VEC>
__device__ __forceinline__ void stage_tile(float* s, const float* x,
                                           long long ld, int r0, int rows,
                                           int k0, int kdim, int tid) {
  constexpr int PER_LINE = MN ? 128 / VEC : BK / VEC;  // copies per line
  constexpr int COPIES = BK * 128 / VEC;
  static_assert(COPIES % THREADS == 0, "every thread issues the same count");
#pragma unroll
  for (int q = 0; q < COPIES / THREADS; ++q) {
    const int v = tid + q * THREADS;
    const int line = v / PER_LINE, off = (v % PER_LINE) * VEC;
    int valid;
    const float* src;
    float* dst;
    if constexpr (MN) {  // line = k, off = r
      const int k = k0 + line, r = r0 + off;
      valid = k < kdim ? max(0, min(VEC, rows - r)) : 0;
      src = valid ? x + static_cast<long long>(k) * ld + r : x;
      dst = s + line * 128 + off;
    } else {  // line = r, off = k
      const int r = r0 + line, k = k0 + off;
      valid = r < rows ? max(0, min(VEC, kdim - k)) : 0;
      src = valid ? x + static_cast<long long>(r) * ld + k : x;
      dst = s + line * KPAD + off;
    }
    cp_async<VEC>(dst, src, valid);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// C[b] = A[b]·B[b] / div over a 128 x 128 tile per block. Thread (ty, tx)
// owns rows ty·4 + i + 64·h (i < 4, h < 2) and, for an N-major B, columns
// tx·4 + j + 64·h, for a K-major B columns tx + 16·j (j < 8): each choice
// keeps its 128-bit fragment reads free of bank conflicts. A is always read
// M-major: a K-major slice, once landed, is transposed into `at` in shared
// memory (two 128-bit loads and eight stores a thread per slice): the
// fragment reads of a K-major A cost more than that.
template <bool A_MN, bool B_MN, int VEC>
__global__ void __launch_bounds__(THREADS, 2)
ffma_gemm(const float* __restrict__ a, long long a_sb, long long a_ld,
          const float* __restrict__ b, long long b_sb, long long b_ld,
          float* __restrict__ c, long long c_sb, long long c_ld, int m, int n,
          int k, int tiles_m, int tiles_n, float div) {
  extern __shared__ __align__(16) float ff_smem[];
  constexpr int A_FLOATS = tile_floats<A_MN>(), B_FLOATS = tile_floats<B_MN>();
  float* sa = ff_smem;
  float* sb = sa + STAGES * A_FLOATS;
  float* at = sb + STAGES * B_FLOATS;  // [BK][128], for a K-major A only

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long tile = blockIdx.x;
  const int tn = static_cast<int>(tile % tiles_n);
  const long long rest = tile / tiles_n;
  const int tm = static_cast<int>(rest % tiles_m);
  const long long bi = rest / tiles_m;
  const int m0 = tm * BM, n0 = tn * BN;
  const float* a_b = a + bi * a_sb;
  const float* b_b = b + bi * b_sb;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int ktiles = (k + BK - 1) / BK;
  auto load = [&](int kt) {
    const int st = kt % STAGES;
    stage_tile<A_MN, VEC>(sa + st * A_FLOATS, a_b, a_ld, m0, m, kt * BK, k,
                          tid);
    stage_tile<B_MN, VEC>(sb + st * B_FLOATS, b_b, b_ld, n0, n, kt * BK, k,
                          tid);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();  // slice kt has landed; slice kt-1's stage is free
    if (kt + STAGES - 1 < ktiles) load(kt + STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::);

    const float* as = sa + (kt % STAGES) * A_FLOATS;
    const float* bs = sb + (kt % STAGES) * B_FLOATS;
    if constexpr (!A_MN) {
      // a warp takes 32 consecutive rows of one 4-k chunk: conflict-free
      // reads (row stride KPAD) and writes (consecutive words)
#pragma unroll
      for (int q = 0; q < BK * 128 / 4 / THREADS; ++q) {
        const int v = tid + q * THREADS, r = v % 128, k4 = (v / 128) * 4;
        const float4 x = ld4(as + r * KPAD + k4);
        at[(k4 + 0) * 128 + r] = x.x;
        at[(k4 + 1) * 128 + r] = x.y;
        at[(k4 + 2) * 128 + r] = x.z;
        at[(k4 + 3) * 128 + r] = x.w;
      }
      __syncthreads();
      as = at;
    }
#pragma unroll
    for (int kc = 0; kc < BK; kc += 4) {
      float bf[4][8];  // B fragment: 4 k x this thread's 8 columns
      if constexpr (B_MN) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 lo = ld4(bs + (kc + kk) * 128 + tx * 4);
          const float4 hi = ld4(bs + (kc + kk) * 128 + 64 + tx * 4);
          bf[kk][0] = lo.x; bf[kk][1] = lo.y; bf[kk][2] = lo.z;
          bf[kk][3] = lo.w; bf[kk][4] = hi.x; bf[kk][5] = hi.y;
          bf[kk][6] = hi.z; bf[kk][7] = hi.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 v = ld4(bs + (tx + 16 * j) * KPAD + kc);
          bf[0][j] = v.x; bf[1][j] = v.y; bf[2][j] = v.z; bf[3][j] = v.w;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 v = ld4(as + (kc + kk) * 128 + 64 * h + ty * 4);
          const float av[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[4 * h + i][j] = fmaf(av[i], bf[kk][j], acc[4 * h + i][j]);
        }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  float* c_b = c + bi * c_sb;
  const bool vec_out = B_MN && c_ld % 4 == 0 && c_sb % 4 == 0 &&
                       (reinterpret_cast<uintptr_t>(c) & 15) == 0;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = m0 + 64 * (r / 4) + ty * 4 + (r % 4);
    if (row >= m) continue;
    float* dst = c_b + static_cast<long long>(row) * c_ld;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (vec_out && n0 + 64 * h + tx * 4 + 3 < n) {  // 4 columns at once
        *reinterpret_cast<float4*>(dst + n0 + 64 * h + tx * 4) =
            make_float4(acc[r][4 * h] / div, acc[r][4 * h + 1] / div,
                        acc[r][4 * h + 2] / div, acc[r][4 * h + 3] / div);
        continue;
      }
#pragma unroll
      for (int j = 4 * h; j < 4 * h + 4; ++j) {
        const int col = B_MN ? n0 + 64 * (j / 4) + tx * 4 + (j % 4)
                             : n0 + tx + 16 * j;
        if (col < n) dst[col] = acc[r][j] / div;
      }
    }
  }
}

template <bool A_MN, bool B_MN>
constexpr int ffma_smem_bytes() {
  return (STAGES * (tile_floats<A_MN>() + tile_floats<B_MN>()) +
          (A_MN ? 0 : BK * 128)) * 4;
}

}  // namespace ff

// ---------------------------------------------------------------------------
// bfloat16 engine: wgmma fed by TMA
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4, CONSUMERS = 2;
constexpr int THREADS = CONSUMERS * 128 + 32;  // two warpgroups + a producer
constexpr int SLICE_A = BM * BK * 2;  // A's K-slice: 16 KB
constexpr int SLICE_B = BN * BK * 2;  // B's K-slice: 32 KB
constexpr int BOX = 64 * BK * 2;      // one 64-wide 128B-swizzled box: 8 KB
constexpr int SWIZZLE_ATOM = 1024;    // 8 rows of 128 bytes
constexpr int SMEM_BYTES =
    SWIZZLE_ATOM + STAGES * (SLICE_A + SLICE_B) + 2 * STAGES * 8;

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// One box of a 3-D tensor map (inner, rows, batch) into shared memory;
// completion is reported to `bar` in bytes. Out-of-range elements are zero.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle. For a K-major
// operand (rows of 64 K values, 128 B) SBO is the 8-row step and LBO is
// unused; for an MN-major one (rows of 64 M or N values at one k) LBO is
// the step between 64-wide boxes and SBO the step between 8-row k groups.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= 1ull << 62;  // SWIZZLE_128B
  return d;
}

// D[64 x 256] += A[64 x 16] · B[16 x 256]; TA, TB = 1 for an MN-major
// operand (wgmma's transpose bits).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// C[b] = A[b]·B[b] / div in bfloat16, in 128 x 256 output tiles. The grid
// is persistent (one block per SM): block i takes tiles i, i + gridDim.x,
// ..., and its producer runs ahead into the next tile's K-slices while the
// consumers write the last tile out. Shared slices: a K-major operand is one
// box of 128 (A) or 256 (B) rows x 64 K values; an MN-major one is 2 (A) or
// 4 (B) boxes of 64 k-rows x 64 M or N values, 8 KB apart. Either way
// consumer warpgroup w finds its 64 rows of A at w·8 KB.
template <bool A_MN, bool B_MN>
__global__ void __launch_bounds__(THREADS, 1)
wgmma_gemm(const __grid_constant__ CUtensorMap map_a,
           const __grid_constant__ CUtensorMap map_b,
           __nv_bfloat16* __restrict__ c, long long c_sb, long long c_ld,
           long long c_lo, int split, int m, int n, int k, int tiles_m,
           int tiles_n, long long tiles, float div) {
  extern __shared__ __align__(1024) uint8_t tc_smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(tc_smem_raw) + SWIZZLE_ATOM - 1) &
      ~static_cast<uintptr_t>(SWIZZLE_ATOM - 1));
  uint8_t* sa = smem;
  uint8_t* sb = smem + STAGES * SLICE_A;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + STAGES * (SLICE_A + SLICE_B));
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int ktiles = (k + BK - 1) / BK;
  // split = 1 (2) : A (B) is a hi/lo pair, a second pass over K reads lo
  const int kslices = split ? 2 * ktiles : ktiles;
  // tile t: column tile fastest, then row tile, then batch element
  auto origin = [&](long long t, int& m0, int& n0, int& bi) {
    n0 = static_cast<int>(t % tiles_n) * BN;
    const long long rest = t / tiles_n;
    m0 = static_cast<int>(rest % tiles_m) * BM;
    bi = static_cast<int>(rest / tiles_m);
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // `it` counts K-slices over all of this block's tiles: slot it % STAGES,
  // round it / STAGES (the barriers' phase parity)
  const int wg = tid / 128;
  if (wg == CONSUMERS) {  // producer warp: one thread issues every load
    if (tid != CONSUMERS * 128) return;
    int it = 0;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      int m0, n0, bi;
      origin(t, m0, n0, bi);
      for (int kt = 0; kt < kslices; ++kt, ++it) {
        const int s = it % STAGES, k0 = (kt % ktiles) * BK;
        const int pass = kt / ktiles;
        const int ba = split == 1 ? 2 * bi + pass : bi;
        const int bb = split == 2 ? 2 * bi + pass : bi;
        if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], SLICE_A + SLICE_B);
        uint8_t* a_dst = sa + s * SLICE_A;
        uint8_t* b_dst = sb + s * SLICE_B;
        if constexpr (A_MN) {
          tma_load(a_dst, &map_a, m0, k0, ba, &full[s]);
          tma_load(a_dst + BOX, &map_a, m0 + 64, k0, ba, &full[s]);
        } else {
          tma_load(a_dst, &map_a, k0, m0, ba, &full[s]);
        }
        if constexpr (B_MN) {
          for (int h = 0; h < BN / 64; ++h)
            tma_load(b_dst + h * BOX, &map_b, n0 + 64 * h, k0, bb, &full[s]);
        } else {
          tma_load(b_dst, &map_b, k0, n0, bb, &full[s]);
        }
      }
    }
    return;
  }

  const int lane = tid % 32, q = (tid % 128) / 32;
  const bool pairs = (c_ld % 2) == 0;
  // the bfloat16 rounding of the output dwarfs the float32 ulp that a
  // multiply by 1/N differs from the division by N
  const float inv = 1.f / div;
  float d[128];
  int it = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    int m0, n0, bi;
    origin(t, m0, n0, bi);
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    for (int kt = 0; kt < kslices; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const uint32_t a_base = smem_addr(sa + s * SLICE_A) + wg * BOX;
      const uint32_t b_base = smem_addr(sb + s * SLICE_B);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // a k-step of 16 is 32 bytes along a K-major row, or 16 rows of
        // 128 bytes in an MN-major box
        const uint64_t da = A_MN ? make_desc(a_base + kk * 2048, BOX, 1024)
                                 : make_desc(a_base + kk * 32, 16, 1024);
        const uint64_t db = B_MN ? make_desc(b_base + kk * 2048, BOX, 1024)
                                 : make_desc(b_base + kk * 32, 16, 1024);
        wgmma_m64n256k16<A_MN ? 1 : 0, B_MN ? 1 : 0>(d, da, db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // keep this slice's products in flight; the previous slice's are done
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (kt > 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    mbar_arrive(&empty[(it - 1) % STAGES]);  // the tile's last slice

    // accumulator layout: warp q of the warpgroup holds rows 16q..16q+15;
    // d[4j + 2h + e] is row lane/4 + 8h, column 8j + 2(lane % 4) + e.
    // c_lo > 0: also the residual's rounding, c_lo elements further on
    const int row_base = m0 + 64 * wg + 16 * q + lane / 4;
    __nv_bfloat16* c_b = c + static_cast<long long>(bi) * c_sb;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row_base + 8 * h;
        if (row >= m || col >= n) continue;
        __nv_bfloat16* dst = c_b + static_cast<long long>(row) * c_ld + col;
        const float v0 = d[4 * j + 2 * h] * inv;
        const float v1 = d[4 * j + 2 * h + 1] * inv;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            v0 - __low2float(hi), v1 - __high2float(hi));
        if (pairs && col + 1 < n) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = hi;
          if (c_lo) *reinterpret_cast<__nv_bfloat162*>(dst + c_lo) = lo;
        } else {
          dst[0] = hi.x;
          if (c_lo) dst[c_lo] = lo.x;
          if (col + 1 < n) {
            dst[1] = hi.y;
            if (c_lo) dst[c_lo + 1] = lo.y;
          }
        }
      }
    }
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// split K: the partials' sum, in a fixed order
// ---------------------------------------------------------------------------
namespace sk {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
split_reduce_f32(const float* part, long long p_bsb, long long p_sb,
                 int parts, float* out, long long o_bsb, int rows, int cols,
                 long long ld) {
  const long long b = blockIdx.y;
  const long long total = static_cast<long long>(rows) * cols;
  for (long long e = blockIdx.x * static_cast<long long>(THREADS) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * THREADS) {
    const long long off = (e / cols) * ld + e % cols;
    const float* src = part + b * p_bsb + off;
    float acc = 0.f;
    for (int p = 0; p < parts; ++p) acc += src[p * p_sb];
    out[b * o_bsb + off] = acc;
  }
}

__global__ void __launch_bounds__(THREADS)
split_reduce_bf16(const __nv_bfloat16* part, long long p_bsb, long long p_sb,
                  long long p_lo, int parts, __nv_bfloat16* out,
                  long long o_bsb, long long o_lo, int rows, int cols,
                  long long ld) {
  const long long b = blockIdx.y;
  const long long total = static_cast<long long>(rows) * cols;
  for (long long e = blockIdx.x * static_cast<long long>(THREADS) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * THREADS) {
    const long long off = (e / cols) * ld + e % cols;
    const __nv_bfloat16* src = part + b * p_bsb + off;
    float acc = 0.f;
    for (int p = 0; p < parts; ++p)
      acc += __bfloat162float(src[p * p_sb]) +
             __bfloat162float(src[p * p_sb + p_lo]);
    const __nv_bfloat16 hi = __float2bfloat16_rn(acc);
    __nv_bfloat16* dst = out + b * o_bsb + off;
    dst[0] = hi;
    dst[o_lo] = __float2bfloat16_rn(acc - __bfloat162float(hi));
  }
}

}  // namespace sk

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bfloat16 operand (inner, rows, batch) with row and batch strides in
// elements, as boxes of (box_inner, box_rows), 128-byte swizzle.
cudaError_t make_map(CUtensorMap* map, const void* base, int inner, int rows,
                     int batch, long long ld, long long sb, int box_inner,
                     int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool A_MN, bool B_MN>
cudaError_t launch_ffma(const float* a, long long a_sb, long long a_ld,
                        const float* b, long long b_sb, long long b_ld,
                        float* c, long long c_sb, long long c_ld, int m, int n,
                        int k, int tiles_m, int tiles_n, long long blocks,
                        float div, cudaStream_t s) {
  const bool vec4 = aligned16(a) && aligned16(b) && a_ld % 4 == 0 &&
                    a_sb % 4 == 0 && b_ld % 4 == 0 && b_sb % 4 == 0;
  auto kern = vec4 ? &ff::ffma_gemm<A_MN, B_MN, 4> : &ff::ffma_gemm<A_MN, B_MN, 1>;
  constexpr int bytes = ff::ffma_smem_bytes<A_MN, B_MN>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(blocks), ff::THREADS, bytes, s>>>(
      a, a_sb, a_ld, b, b_sb, b_ld, c, c_sb, c_ld, m, n, k, tiles_m, tiles_n,
      div);
  return cudaGetLastError();
}

template <bool A_MN, bool B_MN>
cudaError_t launch_wgmma(const void* a, long long a_sb, long long a_ld,
                         const void* b, long long b_sb, long long b_ld,
                         __nv_bfloat16* c, long long c_sb, long long c_ld,
                         long long c_lo, int split, int batch, int m, int n,
                         int k, int tiles_m, int tiles_n, long long blocks,
                         float div, cudaStream_t s) {
  // TMA needs 16-byte aligned bases and strides
  if (!aligned16(a) || !aligned16(b) || a_ld % 8 || a_sb % 8 || b_ld % 8 ||
      b_sb % 8)
    return cudaErrorMisalignedAddress;
  // a hi/lo operand is (2 batch, rows, ld), a_sb / b_sb apart
  const int batch_a = split == 1 ? 2 * batch : batch;
  const int batch_b = split == 2 ? 2 * batch : batch;
  CUtensorMap map_a, map_b;
  cudaError_t err =
      A_MN ? make_map(&map_a, a, m, k, batch_a, a_ld, a_sb, 64, tc::BK)
           : make_map(&map_a, a, k, m, batch_a, a_ld, a_sb, tc::BK, tc::BM);
  if (err != cudaSuccess) return err;
  err = B_MN ? make_map(&map_b, b, n, k, batch_b, b_ld, b_sb, 64, tc::BK)
             : make_map(&map_b, b, k, n, batch_b, b_ld, b_sb, tc::BK, tc::BN);
  if (err != cudaSuccess) return err;
  auto kern = &tc::wgmma_gemm<A_MN, B_MN>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tc::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  static int sms = 0;  // one persistent block per SM
  if (sms == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const long long grid = blocks < sms ? blocks : sms;
  kern<<<static_cast<unsigned>(grid), tc::THREADS, tc::SMEM_BYTES, s>>>(
      map_a, map_b, c, c_sb, c_ld, c_lo, split, m, n, k, tiles_m, tiles_n,
      blocks, div);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One batched GEMM on `stream`: C[b] = A[b]·B[b] / div, A (m x k), B (k x n),
// C (m x n) with unit column stride. dtype 0 = float32 (FFMA engine),
// 1 = bfloat16 (wgmma engine; C is bfloat16, accumulation float32).
// a_mn = 1: A[i][l] lies at a[l·a_ld + i] (M-major), else at a[i·a_ld + l];
// b_mn = 1: B[l][j] lies at b[l·b_ld + j] (N-major), else at b[j·b_ld + l].
// Strides are in elements; *_sb is the batch stride. The combination
// (a_mn = 1, b_mn = 0) is not built. bfloat16 only: c_lo > 0 also writes
// bf16(C - bf16(C)) c_lo elements after each output; split = 1 (2) reads A
// (B) as hi/lo pairs, batch element b's halves at 2b and 2b + 1, *_sb apart,
// and sums both products. Returns a cudaError_t (0 on success).
int tpavi_gemm(int dtype, int a_mn, int b_mn, const void* a, long long a_sb,
               long long a_ld, const void* b, long long b_sb, long long b_ld,
               void* c, long long c_sb, long long c_ld, long long c_lo,
               int split, int batch, int m, int n, int k, float div,
               int device, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0 || k <= 0 || (a_mn && !b_mn) ||
      c_lo < 0 || split < 0 || split > 2 || (dtype != 1 && (c_lo || split)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bn = dtype == 1 ? tc::BN : ff::BN;  // both engines: BM = 128
  const int tiles_m = (m + 127) / 128, tiles_n = (n + bn - 1) / bn;
  const long long blocks = static_cast<long long>(batch) * tiles_m * tiles_n;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const float* fa = static_cast<const float*>(a);
    const float* fb = static_cast<const float*>(b);
    float* fc = static_cast<float*>(c);
    if (a_mn)
      err = launch_ffma<true, true>(fa, a_sb, a_ld, fb, b_sb, b_ld, fc, c_sb,
                                    c_ld, m, n, k, tiles_m, tiles_n, blocks,
                                    div, s);
    else if (b_mn)
      err = launch_ffma<false, true>(fa, a_sb, a_ld, fb, b_sb, b_ld, fc, c_sb,
                                     c_ld, m, n, k, tiles_m, tiles_n, blocks,
                                     div, s);
    else
      err = launch_ffma<false, false>(fa, a_sb, a_ld, fb, b_sb, b_ld, fc,
                                      c_sb, c_ld, m, n, k, tiles_m, tiles_n,
                                      blocks, div, s);
  } else if (dtype == 1) {
    __nv_bfloat16* bc = static_cast<__nv_bfloat16*>(c);
    if (a_mn)
      err = launch_wgmma<true, true>(a, a_sb, a_ld, b, b_sb, b_ld, bc, c_sb,
                                     c_ld, c_lo, split, batch, m, n, k,
                                     tiles_m, tiles_n, blocks, div, s);
    else if (b_mn)
      err = launch_wgmma<false, true>(a, a_sb, a_ld, b, b_sb, b_ld, bc, c_sb,
                                      c_ld, c_lo, split, batch, m, n, k,
                                      tiles_m, tiles_n, blocks, div, s);
    else
      err = launch_wgmma<false, false>(a, a_sb, a_ld, b, b_sb, b_ld, bc, c_sb,
                                       c_ld, c_lo, split, batch, m, n, k,
                                       tiles_m, tiles_n, blocks, div, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Split K's second pass on `stream`: for each of `batch` outputs, the sum
// over p = 0 .. parts - 1 (in that order, float32) of the partials
// part[b·p_bsb + p·p_sb + i·ld + j], for i < rows, j < cols, into
// out[b·o_bsb + i·ld + j]. dtype 0: float32. dtype 1: bfloat16 hi/lo pairs,
// each partial's lo half p_lo elements after its hi half; the sum is
// written as a hi/lo pair, its lo half o_lo elements on. Strides in
// elements. Returns a cudaError_t (0 on success).
int tpavi_split_reduce(int dtype, const void* part, long long p_bsb,
                       long long p_sb, long long p_lo, int parts, void* out,
                       long long o_bsb, long long o_lo, int batch, int rows,
                       int cols, long long ld, int device, void* stream) {
  if (batch <= 0 || batch > 65535 || rows <= 0 || cols <= 0 || parts <= 0 ||
      ld < cols || (dtype == 1 && (p_lo <= 0 || o_lo <= 0)) ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(rows) * cols;
  long long blocks = (total + sk::THREADS - 1) / sk::THREADS;
  if (blocks > 4096) blocks = 4096;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(batch));
  if (dtype == 0)
    sk::split_reduce_f32<<<grid, sk::THREADS, 0, s>>>(
        static_cast<const float*>(part), p_bsb, p_sb, parts,
        static_cast<float*>(out), o_bsb, rows, cols, ld);
  else
    sk::split_reduce_bf16<<<grid, sk::THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(part), p_bsb, p_sb, p_lo, parts,
        static_cast<__nv_bfloat16*>(out), o_bsb, o_lo, rows, cols, ld);
  return static_cast<int>(cudaGetLastError());
}

const char* tpavi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
