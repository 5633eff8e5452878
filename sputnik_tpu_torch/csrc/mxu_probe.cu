// mxu_probe: three dense probes of C = A . B on the tensor cores (bf16
// operands, wmma 16x16x16) or the CUDA cores (fp32 operands, FMA without
// TF32), each with an fp32 accumulator and the output in the operand dtype.
// A is (M, K), B (K, N), C (M, N), all row-major and contiguous.
//
// Replaces the three Pallas kernels of sputnik_tpu/bench/mxu_probe.py:
//
// * mxu_dense_stream (_probe_kernel, dense_stream): a dense kernel with the
//   stream DSD's structure. One CTA per 128-row x n_tile output (n_tile /
//   128 tiles of 128 x 128 walked in turn). The TPU revisits its fp32
//   acc_ref in VMEM once per grid step of contraction `depth`; here the
//   accumulator tile lives in SHARED MEMORY (acc_s, 64 KB fp32), and every
//   `depth` of contraction the warps' register sums are flushed into it: a
//   read-modify-write of the shared tile (accumulate) or a plain store
//   (overwrite, accumulate = 0, which leaves A[:, -depth:] . B[-depth:, :]
//   as the TPU's does). Inside a step, A and B are staged in 32-deep
//   k-chunks through a 3-stage cp.async ring (cp_async.cuh).
// * mxu_resident_stream (_resident_kernel, resident_stream): the same step
//   structure with B "resident". No SM holds the TPU's whole 4096^2 B, so
//   resident means here: B (32 MB in bf16 at 4096^2) held in the 50 MB L2,
//   its copies carrying an evict_last L2 policy and A's evict_first, so that
//   every CTA reads B from L2 after its first touch. At these shapes no
//   CTA's slab of A or B fits shared memory across steps (a 128-wide slab
//   of K = 4096 is 1 MB), so nothing stays in shared memory between steps
//   but the accumulator. `mt` (the TPU's output m-tile) sets the rows per
//   CTA: mt / 128 row tiles of 128 x 128 walked in turn.
// * mxu_tiled_matmul (_sweep_kernel, tiled_matmul): a plain tiled product at
//   an explicit CTA tile (BM, BK, BN), one of the instantiated set, register
//   accumulators flushed to C once.
//
// What bounds them on the H100: operations. At M = 1024, K = N = 4096 a
// product is 34.4 GFLOP (34.7 us at 989 TFLOP/s bf16) against 50 MB of
// compulsory traffic (15 us at 3.35 TB/s). What these probes measure is how
// far wmma from a cp.async ring (no wgmma, no TMA) gets towards that, and
// what the per-step shared-memory read-modify-write costs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "cp_async.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int STAGES = 3;

struct ProbeParams {
  const void* a;
  const void* b;
  void* c;
  int m, n, k;
  int depth;       // contraction per accumulator step (stream probes)
  int accumulate;  // 1: acc_s += step sum, 0: acc_s = step sum
  int m_sub, n_sub;  // 128 x 128 tiles walked by one CTA along M / N
  int resident;    // L2 policies: B evict_last, A evict_first
};

template <typename T, int BM, int BN, int BK>
struct Geo {
  static constexpr int PAD = 16 / sizeof(T);  // 16 bytes of row padding
  static constexpr int LDA = BK + PAD;
  static constexpr int LDB = BN + PAD;
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int B_ELEMS = BK * LDB;
  static constexpr int STAGE_ELEMS = A_ELEMS + B_ELEMS;
  static constexpr size_t RING_BYTES = size_t(STAGES) * STAGE_ELEMS * sizeof(T);
  static_assert(RING_BYTES % 128 == 0, "what follows the ring must stay aligned");
};

__device__ __forceinline__ void store_out(__nv_bfloat16* c, int64_t off, float v) {
  c[off] = __float2bfloat16(v);
}
__device__ __forceinline__ void store_out(float* c, int64_t off, float v) { c[off] = v; }

template <typename T, int BM, int BN, int BK>
struct Acc;

// ------------------------------------------------------------------ bf16 --
// Warps 2 (M) x 4 (N), each a (BM / 2) x (BN / 4) sub-tile of 16 x 16
// fragments.
template <int BM, int BN, int BK>
struct Acc<__nv_bfloat16, BM, BN, BK> {
  using T = __nv_bfloat16;
  using G = Geo<T, BM, BN, BK>;
  static constexpr int WM = BM / 2, WN = BN / 4;
  static constexpr int FM = WM / 16, FN = WN / 16;
  static constexpr int SCRATCH_FLOATS = (THREADS / 32) * 256;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> f[FM][FN];

  __device__ int wm() const { return (threadIdx.x / 32 / 4) * WM; }
  __device__ int wn() const { return (threadIdx.x / 32 % 4) * WN; }

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) nvcuda::wmma::fill_fragment(f[i][j], 0.0f);
  }

  __device__ void mma(const T* As, const T* Bs) {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, T, nvcuda::wmma::row_major> fa[FM];
      nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, T, nvcuda::wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        nvcuda::wmma::load_matrix_sync(fa[i], As + (wm() + i * 16) * G::LDA + kk, G::LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        nvcuda::wmma::load_matrix_sync(fb[j], Bs + kk * G::LDB + wn() + j * 16, G::LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) nvcuda::wmma::mma_sync(f[i][j], fa[i], fb[j], f[i][j]);
    }
  }

  // acc_s (BM x BN fp32, row stride BN) += or = the register sums; each
  // warp touches only its own sub-tile.
  __device__ void flush(float* acc_s, bool accumulate) {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        float* p = acc_s + (wm() + i * 16) * BN + wn() + j * 16;
        if (accumulate) {
          nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> old;
          nvcuda::wmma::load_matrix_sync(old, p, BN, nvcuda::wmma::mem_row_major);
#pragma unroll
          for (int e = 0; e < old.num_elements; ++e) f[i][j].x[e] += old.x[e];
        }
        nvcuda::wmma::store_matrix_sync(p, f[i][j], BN, nvcuda::wmma::mem_row_major);
      }
  }

  // Write the register sums to c_tile (row stride ldc) through the warp's
  // 16 x 16 fp32 scratch.
  __device__ void store(T* c_tile, int64_t ldc, float* scratch) {
    const int lane = threadIdx.x % 32;
    float* ws = scratch + (threadIdx.x / 32) * 256;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        nvcuda::wmma::store_matrix_sync(ws, f[i][j], 16, nvcuda::wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32)
          store_out(c_tile, int64_t(wm() + i * 16 + e / 16) * ldc + wn() + j * 16 + e % 16, ws[e]);
        __syncwarp();
      }
  }
};

// ------------------------------------------------------------------ fp32 --
// Threads 16 x 16, each owning (BM / 16) x (BN / 16) outputs strided by 16
// so that loads and stores coalesce.
template <int BM, int BN, int BK>
struct Acc<float, BM, BN, BK> {
  using T = float;
  using G = Geo<T, BM, BN, BK>;
  static constexpr int TM = BM / 16, TN = BN / 16;
  static constexpr int SCRATCH_FLOATS = 0;
  float f[TM][TN];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) f[i][j] = 0.0f;
  }

  __device__ void mma(const T* As, const T* Bs) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[(ty + 16 * i) * G::LDA + k];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[k * G::LDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) f[i][j] = fmaf(a[i], b[j], f[i][j]);
    }
  }

  __device__ void flush(float* acc_s, bool accumulate) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float& d = acc_s[(ty + 16 * i) * BN + tx + 16 * j];
        d = accumulate ? d + f[i][j] : f[i][j];
      }
  }

  __device__ void store(T* c_tile, int64_t ldc, float*) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) c_tile[int64_t(ty + 16 * i) * ldc + tx + 16 * j] = f[i][j];
  }
};

// Shared memory of a kernel: the ring, then (STREAM) the fp32 accumulator
// tile, else the bf16 store scratch.
template <typename T, int BM, int BN, int BK, bool STREAM>
constexpr size_t smem_bytes() {
  return Geo<T, BM, BN, BK>::RING_BYTES +
         (STREAM ? size_t(BM) * BN * sizeof(float)
                 : size_t(Acc<T, BM, BN, BK>::SCRATCH_FLOATS) * sizeof(float));
}

// One CTA computes m_sub x n_sub tiles of BM x BN in turn. STREAM: the
// register sums are flushed into the shared accumulator every `depth` of
// contraction (dense / resident stream probes); else they run over all of
// K and are stored once (the tile sweep).
template <typename T, int BM, int BN, int BK, bool STREAM>
__global__ void __launch_bounds__(THREADS) probe_kernel(ProbeParams p) {
  using G = Geo<T, BM, BN, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* extra = reinterpret_cast<float*>(smem + G::RING_BYTES);  // acc_s or scratch

  const T* a = static_cast<const T*>(p.a);
  const T* b = static_cast<const T*>(p.b);
  T* c = static_cast<T*>(p.c);
  const int total = p.k / BK;  // k-chunks per tile
  const int chunks_per_step = p.depth / BK;
  const uint64_t keep = p.resident ? async_copy::l2_evict_last() : 0;
  const uint64_t drop = p.resident ? async_copy::l2_evict_first() : 0;

  for (int ms = 0; ms < p.m_sub; ++ms)
    for (int ns = 0; ns < p.n_sub; ++ns) {
      const int m0 = (blockIdx.y * p.m_sub + ms) * BM;
      const int n0 = (blockIdx.x * p.n_sub + ns) * BN;
      const T* a_tile = a + int64_t(m0) * p.k;
      const T* b_tile = b + n0;
      __syncthreads();  // the previous tile is done with the ring and acc_s
      if (STREAM)
        for (int e = threadIdx.x; e < BM * BN; e += THREADS) extra[e] = 0.0f;

      auto issue = [&](int it) {
        if (it < total) {
          const int k0 = it * BK;
          T* As = ring + (it % STAGES) * G::STAGE_ELEMS;
          async_copy::copy_tile_async<T, BM, BK, THREADS>(As, G::LDA, a_tile + k0, p.k, p.resident, drop);
          async_copy::copy_tile_async<T, BK, BN, THREADS>(As + G::A_ELEMS, G::LDB, b_tile + int64_t(k0) * p.n,
                                                          p.n, p.resident, keep);
        }
        async_copy::cp_async_commit();
      };

      Acc<T, BM, BN, BK> acc;
      acc.zero();
#pragma unroll
      for (int i = 0; i < STAGES - 1; ++i) issue(i);
      for (int it = 0; it < total; ++it) {
        async_copy::cp_async_wait<STAGES - 2>();
        __syncthreads();
        issue(it + STAGES - 1);
        const T* As = ring + (it % STAGES) * G::STAGE_ELEMS;
        acc.mma(As, As + G::A_ELEMS);
        if (STREAM && (it + 1) % chunks_per_step == 0) {  // the step's end
          acc.flush(extra, p.accumulate);
          acc.zero();
        }
      }
      async_copy::cp_async_wait<0>();
      if (STREAM) {
        __syncthreads();  // acc_s complete
        for (int e = threadIdx.x; e < BM * BN; e += THREADS)
          store_out(c, int64_t(m0 + e / BN) * p.n + n0 + e % BN, extra[e]);
      } else {
        acc.store(c + int64_t(m0) * p.n + n0, p.n, extra);
      }
    }
}

template <typename T, int BM, int BN, int BK, bool STREAM>
cudaError_t launch(const ProbeParams& p, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<T, BM, BN, BK, STREAM>();
  auto kernel = probe_kernel<T, BM, BN, BK, STREAM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid(p.n / (BN * p.n_sub), p.m / (BM * p.m_sub));
  kernel<<<grid, THREADS, bytes, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tiled(const ProbeParams& p, int bm, int bk, int bn, cudaStream_t st) {
  // The sweep's tiles (bench/mxu_probe.py SWEEP_CONFIGS), as (bm, bk, bn).
  if (bm == 64 && bk == 32 && bn == 64) return launch<T, 64, 64, 32, false>(p, st);
  if (bm == 64 && bk == 32 && bn == 128) return launch<T, 64, 128, 32, false>(p, st);
  if (bm == 128 && bk == 32 && bn == 128) return launch<T, 128, 128, 32, false>(p, st);
  if (bm == 128 && bk == 64 && bn == 128) return launch<T, 128, 128, 64, false>(p, st);
  if (bm == 128 && bk == 32 && bn == 256) return launch<T, 128, 256, 32, false>(p, st);
  if (bm == 256 && bk == 32 && bn == 128) return launch<T, 256, 128, 32, false>(p, st);
  return cudaErrorInvalidValue;
}

ProbeParams params(const void* a, const void* b, void* c, int m, int n, int k) {
  ProbeParams p{};
  p.a = a;
  p.b = b;
  p.c = c;
  p.m = m;
  p.n = n;
  p.k = k;
  p.depth = k;
  p.accumulate = 1;
  p.m_sub = 1;
  p.n_sub = 1;
  p.resident = 0;
  return p;
}

int finish(cudaError_t err) { return static_cast<int>(err == cudaSuccess ? cudaGetLastError() : err); }

}  // namespace

// kind: 0 bf16, 1 fp32 (operands and output). The wrappers check shapes
// (M, N, K multiples of the tile; depth a multiple of 32 dividing K).
// Each returns the error of the attribute call or of the launch.
extern "C" int mxu_dense_stream(const void* a, const void* b, void* c, int m, int n, int k, int depth,
                                int accumulate, int n_sub, int kind, void* stream) {
  ProbeParams p = params(a, b, c, m, n, k);
  p.depth = depth;
  p.accumulate = accumulate;
  p.n_sub = n_sub;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return finish(kind == 1 ? launch<float, 128, 128, 32, true>(p, st)
                          : launch<__nv_bfloat16, 128, 128, 32, true>(p, st));
}

extern "C" int mxu_resident_stream(const void* a, const void* b, void* c, int m, int n, int k, int depth,
                                   int m_sub, int kind, void* stream) {
  ProbeParams p = params(a, b, c, m, n, k);
  p.depth = depth;
  p.m_sub = m_sub;
  p.resident = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return finish(kind == 1 ? launch<float, 128, 128, 32, true>(p, st)
                          : launch<__nv_bfloat16, 128, 128, 32, true>(p, st));
}

extern "C" int mxu_tiled_matmul(const void* a, const void* b, void* c, int m, int n, int k, int bm, int bk,
                                int bn, int kind, void* stream) {
  ProbeParams p = params(a, b, c, m, n, k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return finish(kind == 1 ? launch_tiled<float>(p, bm, bk, bn, st)
                          : launch_tiled<__nv_bfloat16>(p, bm, bk, bn, st));
}
