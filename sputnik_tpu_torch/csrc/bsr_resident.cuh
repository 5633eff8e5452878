// The column-slab walk of the accumulator-resident DSD schedules (bsr_cres,
// bsr_gres in bsr_cres.cu; bsr_cstack in bsr_cstack.cu): one CTA owns a slab
// of W output columns (of C^T for DDS) and walks a contraction-major stream
// of sparse blocks; for each new strip key it stages the dense strip's slab
// (128 x W) once in shared memory, and each block once, through a two-stage
// cp.async double buffer (the next block and, at a new strip key, the next
// strip load while this block computes); the product of a block and the
// strip slab is added into the accumulator rows of the block's output
// block-row (wmma accumulator fragments loaded, accumulated over k = 128 and
// stored back in bf16; FMA without TF32 in fp32); the flush casts the slab's
// rows to the output type. Only the CTA that owns a slab touches its
// accumulator rows, so the sums repeat bitwise from run to run.
//
// A Stream tells the walk which entries are live and what they hold:
//   begin, end         the entry range;
//   live(i)            whether entry i is walked;
//   dep(i), data(i)    its contraction block and its block's position;
//   strip_key(i)       a new key stages a new strip (cres / gres: the dep, so
//                      a strip is staged once per run of equal k; cstack: the
//                      plan step, so once per step of q slots);
//   row(i)             its block-row within the CTA's accumulator rows.
#pragma once

#include "bsr_tile.cuh"
#include "cp_async.cuh"

namespace resident {

using bsr::BS;
using bsr::THREADS;

template <typename T>
struct Pad;
template <>
struct Pad<__nv_bfloat16> {
  static constexpr int V = 8;  // 16 bytes of row padding
};
template <>
struct Pad<float> {
  static constexpr int V = 4;
};

// Shared-memory geometry: two block buffers (128 x 128 as stored) and two
// strip buffers (op(D)[k-block, slab]: 128 x W stored (K, N), W x 128
// stored (N, K)), then (gres) the accumulator rows.
template <typename T, bool TB, int W>
struct Geo {
  static constexpr int PAD = Pad<T>::V;
  static constexpr int LD_BLK = BS + PAD;
  static constexpr int BLK_ELEMS = BS * LD_BLK;
  static constexpr int STRIP_ROWS = TB ? W : BS;
  static constexpr int STRIP_COLS = TB ? BS : W;
  static constexpr int LD_STRIP = STRIP_COLS + PAD;
  static constexpr int STRIP_ELEMS = STRIP_ROWS * LD_STRIP;
  static constexpr size_t STAGING_BYTES = size_t(2 * BLK_ELEMS + 2 * STRIP_ELEMS) * sizeof(T);
  static_assert((BLK_ELEMS * sizeof(T)) % 128 == 0 && (STRIP_ELEMS * sizeof(T)) % 128 == 0,
                "staging buffers must stay 128-byte aligned");
};

// acc[0:128, 0:W] (row stride ld) += op(blk) . strip, for one staged block.
template <typename T, bool TA, bool TB, int W>
struct Product;

template <bool TA, bool TB, int W>
struct Product<__nv_bfloat16, TA, TB, W> {
  using T = __nv_bfloat16;
  using G = Geo<T, TB, W>;
  using LayoutA = typename std::conditional<TA, nvcuda::wmma::col_major, nvcuda::wmma::row_major>::type;
  using LayoutB = typename std::conditional<TB, nvcuda::wmma::col_major, nvcuda::wmma::row_major>::type;
  static constexpr int NF = W / 16;

  // Warp w owns rows 16w .. 16w + 15 of the block's 128 x W product.
  static __device__ __forceinline__ void run(float* acc, int64_t ld, const T* blk, const T* strip) {
    const int m = (threadIdx.x / 32) * 16;
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> c[NF];
#pragma unroll
    for (int j = 0; j < NF; ++j)
      nvcuda::wmma::load_matrix_sync(c[j], acc + m * ld + j * 16, unsigned(ld), nvcuda::wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BS; kk += 16) {
      nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, T, LayoutA> a;
      nvcuda::wmma::load_matrix_sync(a, TA ? blk + kk * G::LD_BLK + m : blk + m * G::LD_BLK + kk, G::LD_BLK);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, T, LayoutB> b;
        const T* pb = TB ? strip + (j * 16) * G::LD_STRIP + kk : strip + kk * G::LD_STRIP + j * 16;
        nvcuda::wmma::load_matrix_sync(b, pb, G::LD_STRIP);
        nvcuda::wmma::mma_sync(c[j], a, b, c[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NF; ++j)
      nvcuda::wmma::store_matrix_sync(acc + m * ld + j * 16, c[j], unsigned(ld), nvcuda::wmma::mem_row_major);
  }
};

template <bool TA, bool TB, int W>
struct Product<float, TA, TB, W> {
  using G = Geo<float, TB, W>;
  static constexpr int RSTEP = THREADS / W;  // rows between a thread's outputs
  static constexpr int NR = BS / RSTEP;      // outputs per thread

  // Thread t owns column t % W of rows t / W + RSTEP * i.
  static __device__ __forceinline__ void run(float* acc, int64_t ld, const float* blk, const float* strip) {
    const int c = threadIdx.x % W;
    const int r0 = threadIdx.x / W;
    float v[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) v[i] = acc[(r0 + RSTEP * i) * ld + c];
#pragma unroll 4
    for (int k = 0; k < BS; ++k) {
      const float b = TB ? strip[c * G::LD_STRIP + k] : strip[k * G::LD_STRIP + c];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int r = r0 + RSTEP * i;
        v[i] = fmaf(TA ? blk[k * G::LD_BLK + r] : blk[r * G::LD_BLK + k], b, v[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < NR; ++i) acc[(r0 + RSTEP * i) * ld + c] = v[i];
  }
};

struct ResParams {
  const void* sparse;  // (nnz, 128, 128) blocks
  const int* deps;     // contraction block of each stream entry (cstack: of each plan slot)
  const int* rows;     // cres / cstack: output block-row; gres: row within its plan group
  const int* datas;    // block of each stream entry
  const int* flags;    // gres: 0 for a padding slot; cstack: the live slots of each plan step (nv)
  const void* dense;
  float* acc;          // (R, N) fp32 scratch (unused by a gres launch with the rows in shared memory)
  void* c;
  int row_blocks;      // R / 128
  int rows_per_cta;    // cres / cstack: block-rows of a range; gres: group_rows
  int stream_len;      // cres: nnz; gres: s_max; cstack: n_steps * q
  int q;               // cstack: slots per plan step
  int64_t ld_dense, ld_acc;
  int64_t c_row_stride, c_col_stride;  // of the DSD view's (R, N) output
  int out_kind;
};

template <class Stream>
__device__ __forceinline__ int next_live(const Stream& s, int i) {
  ++i;
  while (i < s.end && !s.live(i)) ++i;
  return i;
}

// Zero the accumulator rows [0, n_rows) x [0, W), walk the stream adding
// each live block's product into its rows, then flush them to the output
// rows starting at out_row0, columns col0 .. col0 + W.
template <typename T, bool TA, bool TB, int W, class Stream>
__device__ void resident_slab(const ResParams& p, const Stream& s, unsigned char* smem, float* acc, int64_t ld_acc,
                              int n_rows, int64_t out_row0, int64_t col0) {
  using G = Geo<T, TB, W>;
  T* blk_buf = reinterpret_cast<T*>(smem);
  T* strip_buf = blk_buf + 2 * G::BLK_ELEMS;
  const T* sparse = static_cast<const T*>(p.sparse);
  const T* dense = static_cast<const T*>(p.dense);

  for (int e = threadIdx.x; e < n_rows * W; e += THREADS) acc[(e / W) * ld_acc + e % W] = 0.0f;

  int issued_key = -1, sbuf = 1;
  int stage_strip[2] = {0, 0};
  // Stage entry i's block (and, at a new strip key, its strip) into `stage`.
  auto issue = [&](int i, int stage) {
    async_copy::copy_tile_async<T, BS, BS, THREADS>(blk_buf + stage * G::BLK_ELEMS, G::LD_BLK,
                                                    sparse + int64_t(s.data(i)) * BS * BS, BS);
    const int key = s.strip_key(i);
    if (key != issued_key) {
      sbuf ^= 1;
      issued_key = key;
      const int64_t dep = s.dep(i);
      const T* g = TB ? dense + col0 * p.ld_dense + dep * BS : dense + dep * BS * p.ld_dense + col0;
      async_copy::copy_tile_async<T, G::STRIP_ROWS, G::STRIP_COLS, THREADS>(strip_buf + sbuf * G::STRIP_ELEMS,
                                                                           G::LD_STRIP, g, p.ld_dense);
    }
    stage_strip[stage] = sbuf;
    async_copy::cp_async_commit();
  };

  int cur = next_live(s, s.begin - 1);
  int stage = 0;
  if (cur < s.end) issue(cur, 0);
  while (cur < s.end) {
    const int nxt = next_live(s, cur);
    async_copy::cp_async_wait<0>();  // entry cur has landed for this thread
    __syncthreads();                 // ... for every thread; the previous entry's product is stored
    if (nxt < s.end) issue(nxt, stage ^ 1);
    Product<T, TA, TB, W>::run(acc + int64_t(s.row(cur)) * BS * ld_acc, ld_acc, blk_buf + stage * G::BLK_ELEMS,
                               strip_buf + stage_strip[stage] * G::STRIP_ELEMS);
    cur = nxt;
    stage ^= 1;
  }
  async_copy::cp_async_wait<0>();
  __syncthreads();

  // Row-major output: consecutive threads take consecutive columns;
  // transposed (DDS): consecutive rows, contiguous there.
  const bool by_row = p.c_col_stride == 1;
  const int n = n_rows * W;
  for (int e = threadIdx.x; e < n; e += THREADS) {
    const int r = by_row ? e / W : e % n_rows;
    const int c = by_row ? e % W : e / n_rows;
    const int64_t off = (out_row0 + r) * p.c_row_stride + (col0 + c) * p.c_col_stride;
    bsr::store_one(p.c, off, acc[r * ld_acc + c], p.out_kind);
  }
}

// Launch `kernel` over `grid` with the staging buffers of <T, TB, W> and
// `extra_smem` more bytes of dynamic shared memory.
template <typename T, bool TB, int W>
cudaError_t launch_slabs(void (*kernel)(ResParams), const ResParams& p, dim3 grid, size_t extra_smem,
                         cudaStream_t st) {
  const size_t bytes = Geo<T, TB, W>::STAGING_BYTES + extra_smem;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, bytes, st>>>(p);
  return cudaGetLastError();
}

}  // namespace resident
