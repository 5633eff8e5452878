// Building blocks of the attention kernels (flash_mha.cu, bsr_softmax.cu):
// a CTA-wide product of two tiles held in shared memory, the row-wise
// reductions over the four lanes that share a score row, and the masks and
// sentinels of the JAX package's attention kernels.
//
// A CTA is 256 threads (8 warps). The row-wise work maps 4 consecutive
// threads to one row of a 64-row tile: thread t owns row t / 4 and the
// columns 4 j + t % 4.
#pragma once

#include "bsr_tile.cuh"

namespace attn {

using bf16 = __nv_bfloat16;
constexpr int BS = 128;  // topology block size
constexpr int TM = 64;   // rows of a CTA's tile
constexpr int THREADS = bsr::THREADS;
constexpr float NEG_INF = -1e30f;  // finite mask value: a fully masked row gives p = 0
constexpr float POS_BIG = 1e30f;   // lse of a row with no mass: exp(s - POS_BIG) = 0

static_assert(THREADS == 4 * TM, "row-wise work maps 4 threads to a row");

template <typename T>
constexpr int pad() {  // 16 bytes of row padding
  return 16 / int(sizeof(T));
}
constexpr int align128(int bytes) { return (bytes + 127) & ~127; }

// --------------------------------------------------------------- products --
// C[M x N] = op(A)[M x K] . op(B)[K x N] with both operands in shared
// memory. TA: A is stored K x M (row stride lda); TB: B is stored N x K.
template <typename T, int M, int N, bool TA, bool TB>
struct Mma;

// bf16: warps in a 4 x 2 grid of 16 x 16 fragments, or 4 x 1 when N is an
// odd multiple of 16 (a head dim of 48, 80 or 112); warps 4-7 then idle.
template <int M, int N, bool TA, bool TB>
struct Mma<bf16, M, N, TA, TB> {
  static constexpr int WARPS_N = N % 32 == 0 ? 2 : 1;
  static constexpr int WM = M / 4, WN = N / WARPS_N;
  static constexpr int FM = WM / 16, FN = WN / 16;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "bf16 tiles split into 16 x 16 fragments");
  using LA = typename std::conditional<TA, nvcuda::wmma::col_major,
                                       nvcuda::wmma::row_major>::type;
  using LB = typename std::conditional<TB, nvcuda::wmma::col_major,
                                       nvcuda::wmma::row_major>::type;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[FM][FN];

  __device__ bool active() const { return threadIdx.x / 32 < 4 * WARPS_N; }
  __device__ int wm() const { return (threadIdx.x / 32 / WARPS_N) * WM; }
  __device__ int wn() const { return (threadIdx.x / 32 % WARPS_N) * WN; }

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.0f);
  }

  template <int K>
  __device__ void run(const bf16* A, int lda, const bf16* B, int ldb) {
    static_assert(K % 16 == 0, "bf16 contraction in steps of 16");
    if (!active()) return;
    const int m0 = wm(), n0 = wn();
#pragma unroll 2
    for (int kk = 0; kk < K; kk += 16) {
      nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, bf16, LA> fa[FM];
      nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, bf16, LB> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const int m = m0 + 16 * i;
        nvcuda::wmma::load_matrix_sync(fa[i], TA ? A + kk * lda + m : A + m * lda + kk, lda);
      }
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int n = n0 + 16 * j;
        nvcuda::wmma::load_matrix_sync(fb[j], TB ? B + n * ldb + kk : B + kk * ldb + n, ldb);
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) nvcuda::wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }

  // C into fp32 shared memory, row stride ldc.
  __device__ void store(float* C, int ldc) {
    if (!active()) return;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        nvcuda::wmma::store_matrix_sync(C + (wm() + 16 * i) * ldc + wn() + 16 * j, acc[i][j],
                                        ldc, nvcuda::wmma::mem_row_major);
  }

  // scale * C into global memory (row stride ldg, bf16 or fp32), through a
  // per-warp 16x16 fp32 scratch (8 KB of shared memory in all).
  __device__ void store_out(void* g, int64_t ldg, float scale, bool out_f32, float* scratch) {
    if (!active()) return;
    const int lane = threadIdx.x % 32;
    float* ws = scratch + (threadIdx.x / 32) * 256;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        nvcuda::wmma::store_matrix_sync(ws, acc[i][j], 16, nvcuda::wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = wm() + 16 * i + e / 16;
          const int c = wn() + 16 * j + e % 16;
          bsr::store_one(g, r * ldg + c, ws[e] * scale, out_f32);
        }
        __syncwarp();
      }
  }
};

template <int M, int N, bool TA, bool TB>
struct Mma<float, M, N, TA, TB> {
  // Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i, columns
  // tx + 16 j.
  static constexpr int RM = M / 16, RN = N / 16;
  static_assert(M % 16 == 0 && N % 16 == 0, "fp32 tiles split over 16 x 16 threads");
  float acc[RM][RN];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;
  }

  template <int K>
  __device__ void run(const float* A, int lda, const float* B, int ldb) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float a[RM], b[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int m = ty + 16 * i;
        a[i] = TA ? A[k * lda + m] : A[m * lda + k];
      }
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int n = tx + 16 * j;
        b[j] = TB ? B[n * ldb + k] : B[k * ldb + n];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  __device__ void store(float* C, int ldc) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) C[(ty + 16 * i) * ldc + tx + 16 * j] = acc[i][j];
  }

  __device__ void store_out(void* g, int64_t ldg, float scale, bool out_f32, float*) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j)
        bsr::store_one(g, (ty + 16 * i) * ldg + tx + 16 * j, acc[i][j] * scale, out_f32);
  }
};

// Reductions over the 4 consecutive lanes that share a row.
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// _keep_mask (sputnik_tpu/kernels/flash_attention.py:243): query row qi of
// block-row r against key kj of block-column c, both within their block.
__device__ __forceinline__ bool keep(bool causal, int r, int c, int qi, int kj) {
  return !causal || r > c || (r == c && qi >= kj);
}

}  // namespace attn
