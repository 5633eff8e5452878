// One 128x128 output tile of C = op(A) . op(B), accumulated in fp32 over
// k-chunks staged in shared memory. Shared by bsr_dsd.cu and bsr_sdd.cu,
// which differ only in where the A and B tiles of each chunk come from.
//
// Layouts follow the JAX package: "transposed" means the operand is stored
// (K, M) / (N, K) and the math uses its transpose. Chunks are copied as
// stored (16-byte vectors along the contiguous axis, no transpose on the
// way in); the transpose lives in the fragment layout (wmma col_major) or in
// the index math (fp32 path).
//
// bf16: nvcuda::wmma 16x16x16 on the tensor cores, fp32 accumulate. Eight
//       warps, each owning a 32x64 sub-tile (2x4 fragments).
// fp32: plain FMA, no TF32, so the sums are full fp32 products as in
//       JAX's preferred_element_type=float32. Each of 256 threads owns an
//       8x8 set of outputs strided by 16 so that stores coalesce.
// int8: wmma 16x16x16 on signed char fragments with an int accumulator, so
//       the int32 sum is exact (the JAX package's int8 path). A fragment
//       pointer must be 32-byte aligned, and one 16-deep int8 step is only
//       16 bytes, so int8 chunks are staged "tiled": the stored matrix's
//       contiguous axis is cut into 16-element columns, each column a
//       ROWS x 16 array of its own, and every fragment reads one of them
//       with a row stride of 16 bytes.
// The flush writes bf16, fp32 or (int8 operands) int32, after multiplying
// by a scale (the int8 dequantization; 1 otherwise).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace bsr {

constexpr int BS = 128;       // block size = output tile edge
constexpr int THREADS = 256;  // 8 warps

// Output element kinds of store_one.
constexpr int OUT_BF16 = 0, OUT_F32 = 1, OUT_I32 = 2;

template <typename T>
struct Chunk;
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int KC = 32;  // contraction depth staged per step
  static constexpr int PAD = 8;  // 16 bytes of row padding
};
template <>
struct Chunk<float> {
  static constexpr int KC = 16;
  static constexpr int PAD = 4;
};
template <>
struct Chunk<signed char> {
  static constexpr int KC = 64;
  static constexpr int PAD = 0;  // tiled layout, no row padding
};

// Shared-memory geometry of one staged chunk. A is op(A)[128 x KC],
// B is op(B)[KC x 128]; each is kept in its stored orientation.
template <typename T, bool TA, bool TB>
struct Smem {
  static constexpr int KC = Chunk<T>::KC;
  static constexpr int PAD = Chunk<T>::PAD;
  static constexpr bool TILED = sizeof(T) == 1;
  static constexpr int A_ROWS = TA ? KC : BS;  // stored rows of the chunk
  static constexpr int A_COLS = TA ? BS : KC;
  static constexpr int B_ROWS = TB ? BS : KC;
  static constexpr int B_COLS = TB ? KC : BS;
  static constexpr int LDA = A_COLS + PAD;
  static constexpr int LDB = B_COLS + PAD;
  static constexpr int A_ELEMS = A_ROWS * LDA;
  static constexpr int B_ELEMS = B_ROWS * LDB;
};

// Copy a ROWS x COLS tile, row stride ldg in global memory, into shared
// memory with row stride lds, or (TILED) as COLS / 16 arrays of ROWS x 16.
// 16-byte vectors; the caller guarantees 16-byte alignment of g, of
// ldg * sizeof(T) and of lds * sizeof(T).
template <typename T, int ROWS, int COLS, bool TILED = false>
__device__ __forceinline__ void copy_tile(T* __restrict__ s, int lds,
                                          const T* __restrict__ g,
                                          int64_t ldg) {
  constexpr int V = 16 / sizeof(T);
  constexpr int VPR = COLS / V;
  constexpr int TOTAL = ROWS * VPR;
  for (int v = threadIdx.x; v < TOTAL; v += THREADS) {
    const int r = v / VPR;
    const int c = (v % VPR) * V;
    T* dst = TILED ? s + (c / 16) * (ROWS * 16) + r * 16 + c % 16 : s + r * lds + c;
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(g + r * ldg + c);
  }
}

// Stage the chunk [k0, k0 + KC) of the contraction. a_tile points at
// op(A)'s tile origin (element (m0, kbase) in op(A) coordinates, i.e.
// &A[m0][kbase] or, transposed, &A[kbase][m0]); b_tile likewise for op(B).
template <typename T, bool TA, bool TB>
__device__ __forceinline__ void stage(T* As, T* Bs, const T* a_tile,
                                      int64_t lda, const T* b_tile,
                                      int64_t ldb, int k0) {
  using S = Smem<T, TA, TB>;
  copy_tile<T, S::A_ROWS, S::A_COLS, S::TILED>(
      As, S::LDA, TA ? a_tile + k0 * lda : a_tile + k0, lda);
  copy_tile<T, S::B_ROWS, S::B_COLS, S::TILED>(
      Bs, S::LDB, TB ? b_tile + k0 : b_tile + k0 * ldb, ldb);
}

// out_kind: OUT_BF16 or OUT_F32 (a bool out_f32 reads as one of the two).
__device__ __forceinline__ void store_one(void* c, int64_t off, float v,
                                          int out_kind) {
  if (out_kind == OUT_F32)
    static_cast<float*>(c)[off] = v;
  else
    static_cast<__nv_bfloat16*>(c)[off] = __float2bfloat16(v);
}

// An exact int32 sum: stored as is, or float(v) * scale in fp32, then cast.
__device__ __forceinline__ void store_int(void* c, int64_t off, int v,
                                          int out_kind, float scale) {
  if (out_kind == OUT_I32)
    static_cast<int*>(c)[off] = v;
  else
    store_one(c, off, static_cast<float>(v) * scale, out_kind);
}

template <typename T, bool TA, bool TB>
struct Tile;

// ---------------------------------------------------------------- bf16 ----
template <bool TA, bool TB>
struct Tile<__nv_bfloat16, TA, TB> {
  using T = __nv_bfloat16;
  using S = Smem<T, TA, TB>;
  using LayoutA = typename std::conditional<TA, nvcuda::wmma::col_major,
                                            nvcuda::wmma::row_major>::type;
  using LayoutB = typename std::conditional<TB, nvcuda::wmma::col_major,
                                            nvcuda::wmma::row_major>::type;
  // Per-warp fp32 scratch for the epilogue, 16x16 floats per warp.
  static constexpr int SCRATCH_FLOATS = (THREADS / 32) * 256;

  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[2][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.0f);
  }

  __device__ void mma_chunk(const T* As, const T* Bs) {
    const int warp = threadIdx.x / 32;
    const int wm = (warp / 2) * 32;  // warp's first output row
    const int wn = (warp % 2) * 64;  // warp's first output column
#pragma unroll
    for (int kk = 0; kk < S::KC; kk += 16) {
      nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, T, LayoutA> fa[2];
      nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, T, LayoutB> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = wm + i * 16;
        const T* p = TA ? As + kk * S::LDA + m : As + m * S::LDA + kk;
        nvcuda::wmma::load_matrix_sync(fa[i], p, S::LDA);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + j * 16;
        const T* p = TB ? Bs + n * S::LDB + kk : Bs + kk * S::LDB + n;
        nvcuda::wmma::load_matrix_sync(fb[j], p, S::LDB);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          nvcuda::wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }

  // Write the tile times `scale`: element (r, c) of the tile goes to
  // c_tile[r * row_stride + c * col_stride].
  __device__ void store(void* c_tile, int64_t row_stride, int64_t col_stride,
                        int out_kind, float* scratch, float scale = 1.0f) {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int wm = (warp / 2) * 32;
    const int wn = (warp % 2) * 64;
    float* ws = scratch + warp * 256;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        nvcuda::wmma::store_matrix_sync(ws, acc[i][j], 16,
                                        nvcuda::wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int e = lane; e < 256; e += 32) {
          const int r = wm + i * 16 + e / 16;
          const int c = wn + j * 16 + e % 16;
          store_one(c_tile, r * row_stride + c * col_stride, ws[e] * scale,
                    out_kind);
        }
        __syncwarp();
      }
  }
};

// ---------------------------------------------------------------- int8 ----
template <bool TA, bool TB>
struct Tile<signed char, TA, TB> {
  using T = signed char;
  using S = Smem<T, TA, TB>;
  using LayoutA = typename std::conditional<TA, nvcuda::wmma::col_major,
                                            nvcuda::wmma::row_major>::type;
  using LayoutB = typename std::conditional<TB, nvcuda::wmma::col_major,
                                            nvcuda::wmma::row_major>::type;
  static constexpr int SCRATCH_FLOATS = (THREADS / 32) * 256;  // used as int

  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, int> acc[2][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0);
  }

  // In the tiled layout the stored (r, c) sits at
  // (c / 16) * (ROWS * 16) + r * 16 + c % 16; each fragment below is one
  // 16-column array read with ldm 16.
  __device__ void mma_chunk(const T* As, const T* Bs) {
    const int warp = threadIdx.x / 32;
    const int wm = (warp / 2) * 32;
    const int wn = (warp % 2) * 64;
#pragma unroll
    for (int kk = 0; kk < S::KC; kk += 16) {
      nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, T, LayoutA> fa[2];
      nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, T, LayoutB> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = wm + i * 16;  // stored (k, m) when TA, else (m, k)
        const T* p = TA ? As + (m / 16) * (S::KC * 16) + kk * 16
                        : As + (kk / 16) * (BS * 16) + m * 16;
        nvcuda::wmma::load_matrix_sync(fa[i], p, 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + j * 16;  // stored (n, k) when TB, else (k, n)
        const T* p = TB ? Bs + (kk / 16) * (BS * 16) + n * 16
                        : Bs + (n / 16) * (S::KC * 16) + kk * 16;
        nvcuda::wmma::load_matrix_sync(fb[j], p, 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          nvcuda::wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }

  __device__ void store(void* c_tile, int64_t row_stride, int64_t col_stride,
                        int out_kind, float* scratch, float scale = 1.0f) {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int wm = (warp / 2) * 32;
    const int wn = (warp % 2) * 64;
    int* ws = reinterpret_cast<int*>(scratch) + warp * 256;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        nvcuda::wmma::store_matrix_sync(ws, acc[i][j], 16,
                                        nvcuda::wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int e = lane; e < 256; e += 32) {
          const int r = wm + i * 16 + e / 16;
          const int c = wn + j * 16 + e % 16;
          store_int(c_tile, r * row_stride + c * col_stride, ws[e], out_kind,
                    scale);
        }
        __syncwarp();
      }
  }
};

// ---------------------------------------------------------------- fp32 ----
template <bool TA, bool TB>
struct Tile<float, TA, TB> {
  using T = float;
  using S = Smem<T, TA, TB>;
  static constexpr int SCRATCH_FLOATS = 1;

  float acc[8][8];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  __device__ void mma_chunk(const T* As, const T* Bs) {
    const int ty = threadIdx.x / 16;
    const int tx = threadIdx.x % 16;
#pragma unroll 4
    for (int k = 0; k < S::KC; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = ty + 16 * i;
        a[i] = TA ? As[k * S::LDA + m] : As[m * S::LDA + k];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        b[j] = TB ? Bs[n * S::LDB + k] : Bs[k * S::LDB + n];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  __device__ void store(void* c_tile, int64_t row_stride, int64_t col_stride,
                        int out_kind, float*, float scale = 1.0f) {
    const int ty = threadIdx.x / 16;
    const int tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store_one(c_tile, (ty + 16 * i) * row_stride + (tx + 16 * j) * col_stride,
                  acc[i][j] * scale, out_kind);
  }
};

// Accumulate op(A)[m0:m0+128, kbase:kbase+k_extent] . op(B)[kbase:..., n0:n0+128]
// into the tile, one staged chunk at a time.
template <typename T, bool TA, bool TB>
__device__ __forceinline__ void accumulate(Tile<T, TA, TB>& tile, T* As, T* Bs,
                                           const T* a_tile, int64_t lda,
                                           const T* b_tile, int64_t ldb,
                                           int k_extent) {
  for (int k0 = 0; k0 < k_extent; k0 += Smem<T, TA, TB>::KC) {
    __syncthreads();  // the previous chunk is consumed
    stage<T, TA, TB>(As, Bs, a_tile, lda, b_tile, ldb, k0);
    __syncthreads();
    tile.mma_chunk(As, Bs);
  }
}

}  // namespace bsr
