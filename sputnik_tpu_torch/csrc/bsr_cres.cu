// bsr_cres and bsr_gres: DSD, and DDS through it as C^T = op(B)^T . op(A)^T,
// with the sparse blocks streamed contraction-major, so that each dense
// strip is staged once for all the blocks that share its contraction block,
// and the fp32 accumulator of a column slab of the output kept until a
// single flush.
//
// Replaces sputnik_tpu/kernels/bsr_cres.py::_cres_kernel (reached from
// dsd_cres and dds_cres, the JAX package's DDS first fit) and ::_gres_kernel
// (reached from dsd_gres and dds_gres). On the TPU the whole (m, n) fp32
// accumulator (cres), or that of a group of output block-rows (gres), sits
// in VMEM; the grid walks the blocks sorted by contraction block k, so the
// index map of the dense strip repeats and its fetch is elided, and each
// block's product is added into its output rows; flush steps appended to the
// grid write the output once. The H100 has no on-chip memory for a 16 MB
// (d = 2048) or 64 MB (d = 4096) accumulator, and its CTAs run in parallel
// in no order. Here:
//
// * one CTA owns a slab of W output columns (of C^T for DDS) and walks the
//   whole contraction-major stream (cres: the dep-major arrays; gres: its
//   plan group's s_max slots, skipping flag-0 padding), so that only this
//   CTA ever touches its slab and the sums are the same from run to run;
// * for each run of equal k it stages the dense strip's slab (128 x W) once
//   in shared memory, and each block once, through a two-stage cp.async
//   double buffer (the next block and, at a change of k, the next strip
//   load while this block computes);
// * the product of a block and the strip slab (128 x W) is added into the
//   accumulator rows of the block's output block-row: loaded, accumulated
//   over k = 128 and stored back, by wmma accumulator fragments (bf16) or
//   by FMA (fp32, no TF32);
// * the flush casts the slab to the output type; rows with no block flush
//   the zeros the CTA wrote first.
//
// cres keeps the accumulator in device memory, an (R, N) fp32 scratch that
// stays in the 50 MB L2 at d = 2048 (16 MB); gres keeps a group's rows in
// shared memory when they fit beside the staging buffers, and in the same
// device scratch otherwise.
//
// Parallelism: W = 32 columns give only N / 32 slabs (64 at d = 2048 for
// the 132 SMs), so cres also splits the output block-rows into `parts`
// ranges, a CTA per (slab, range), each walking the whole stream and
// skipping the blocks of other ranges: deterministic still, since a range
// and a slab partition the output. gres takes one CTA per (plan group,
// slab), as its plan's groups are its split; at d <= 4096 and 25% the JAX
// package's group size gives a single group, so the wrapper picks W = 16
// there (N / 16 slabs) and W = 32 where N / 32 slabs fill the card.
//
// What bounds it on the H100: every CTA of a slab column reads every block
// of its range (32 KB in bf16) from L2 for 2 * 128 * 128 * W FLOP (16
// FLOP/byte at W = 32), and the accumulator rows move 2 x 128 x W x 4 bytes
// of L2 traffic per block; the L2, not device memory, bounds it. Wider
// slabs with the accumulator in registers, wgmma and TMA are later work.
#include "bsr_tile.cuh"
#include "cp_async.cuh"

namespace {

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
  const int* deps;     // contraction block of each stream entry, non-decreasing within a walk
  const int* rows;     // cres: output block-row; gres: row within its plan group
  const int* datas;    // block of each stream entry
  const int* flags;    // gres: 0 for a padding slot
  const void* dense;
  float* acc;          // (R, N) fp32 scratch (unused by a gres launch with the rows in shared memory)
  void* c;
  int row_blocks;      // R / 128
  int rows_per_cta;    // cres: block-rows of a range; gres: group_rows
  int stream_len;      // cres: nnz; gres: s_max
  int64_t ld_dense, ld_acc;
  int64_t c_row_stride, c_col_stride;  // of the DSD view's (R, N) output
  int out_kind;
};

// The dep-major stream of one cres CTA: every block, live when its output
// block-row is in the CTA's range [lo, hi).
struct CresStream {
  const int* deps;
  const int* rows;
  const int* datas;
  int begin, end, lo, hi;
  __device__ bool live(int i) const { return rows[i] >= lo && rows[i] < hi; }
  __device__ int row(int i) const { return rows[i] - lo; }
};

// One gres plan group's slots, live when flagged.
struct GresStream {
  const int* deps;
  const int* rows;
  const int* datas;
  const int* flags;
  int begin, end;
  __device__ bool live(int i) const { return flags[i] != 0; }
  __device__ int row(int i) const { return rows[i]; }
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

  int issued_dep = -1, sbuf = 1;
  int stage_strip[2] = {0, 0};
  // Stage entry i's block (and, at a change of k, its strip) into `stage`.
  auto issue = [&](int i, int stage) {
    async_copy::copy_tile_async<T, BS, BS, THREADS>(blk_buf + stage * G::BLK_ELEMS, G::LD_BLK,
                                                    sparse + int64_t(s.datas[i]) * BS * BS, BS);
    const int dep = s.deps[i];
    if (dep != issued_dep) {
      sbuf ^= 1;
      issued_dep = dep;
      const T* g = TB ? dense + col0 * p.ld_dense + int64_t(dep) * BS : dense + int64_t(dep) * BS * p.ld_dense + col0;
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

// Grid (N / W slabs, ranges): the range's rows of the device scratch.
template <typename T, bool TA, bool TB, int W>
__global__ void __launch_bounds__(THREADS) bsr_cres_kernel(ResParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t col0 = int64_t(blockIdx.x) * W;
  const int lo = blockIdx.y * p.rows_per_cta;
  const int hi = min(lo + p.rows_per_cta, p.row_blocks);
  if (lo >= hi) return;
  CresStream s{p.deps, p.rows, p.datas, 0, p.stream_len, lo, hi};
  float* acc = p.acc + int64_t(lo) * BS * p.ld_acc + col0;
  resident_slab<T, TA, TB, W>(p, s, smem, acc, p.ld_acc, (hi - lo) * BS, int64_t(lo) * BS, col0);
}

// Grid (N / W slabs, plan groups): the group's rows in shared memory after
// the staging buffers when p.acc is null, else in the device scratch.
template <typename T, bool TA, bool TB, int W>
__global__ void __launch_bounds__(THREADS) bsr_gres_kernel(ResParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t col0 = int64_t(blockIdx.x) * W;
  const int g = blockIdx.y;
  const int row0 = g * p.rows_per_cta;
  const int n_blocks = min(p.rows_per_cta, p.row_blocks - row0);
  GresStream s{p.deps, p.rows, p.datas, p.flags, g * p.stream_len, (g + 1) * p.stream_len};
  float* acc;
  int64_t ld;
  if (p.acc == nullptr) {
    acc = reinterpret_cast<float*>(smem + Geo<T, TB, W>::STAGING_BYTES);
    ld = W;
  } else {
    acc = p.acc + int64_t(row0) * BS * p.ld_acc + col0;
    ld = p.ld_acc;
  }
  resident_slab<T, TA, TB, W>(p, s, smem, acc, ld, n_blocks * BS, int64_t(row0) * BS, col0);
}

template <typename T, bool TA, bool TB, int W>
cudaError_t launch_mode(bool gres, const ResParams& p, dim3 grid, size_t acc_smem, cudaStream_t st) {
  const size_t bytes = Geo<T, TB, W>::STAGING_BYTES + acc_smem;
  auto kernel = gres ? bsr_gres_kernel<T, TA, TB, W> : bsr_cres_kernel<T, TA, TB, W>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, bytes, st>>>(p);
  return cudaGetLastError();
}

template <typename T, int W>
cudaError_t launch(bool gres, const ResParams& p, dim3 grid, size_t acc_smem, cudaStream_t st, bool ta, bool tb) {
  if (ta && tb) return launch_mode<T, true, true, W>(gres, p, grid, acc_smem, st);
  if (ta) return launch_mode<T, true, false, W>(gres, p, grid, acc_smem, st);
  if (tb) return launch_mode<T, false, true, W>(gres, p, grid, acc_smem, st);
  return launch_mode<T, false, false, W>(gres, p, grid, acc_smem, st);
}

template <typename T>
cudaError_t launch_width(bool gres, int width, const ResParams& p, dim3 grid, size_t acc_smem, cudaStream_t st,
                         bool ta, bool tb) {
  return width == 16 ? launch<T, 16>(gres, p, grid, acc_smem, st, ta, tb)
                     : launch<T, 32>(gres, p, grid, acc_smem, st, ta, tb);
}

size_t staging_bytes(int in_kind, int width, bool tb) {
  if (in_kind == 1)
    return width == 16 ? (tb ? Geo<float, true, 16>::STAGING_BYTES : Geo<float, false, 16>::STAGING_BYTES)
                       : (tb ? Geo<float, true, 32>::STAGING_BYTES : Geo<float, false, 32>::STAGING_BYTES);
  return width == 16 ? (tb ? Geo<__nv_bfloat16, true, 16>::STAGING_BYTES : Geo<__nv_bfloat16, false, 16>::STAGING_BYTES)
                     : (tb ? Geo<__nv_bfloat16, true, 32>::STAGING_BYTES : Geo<__nv_bfloat16, false, 32>::STAGING_BYTES);
}

int run(bool gres, const ResParams& p, int width, int n_cols, int grid_y, size_t acc_smem, int in_kind,
        int transpose_a, int transpose_b, void* stream) {
  cudaError_t err = cudaSuccess;
  if (width != 16 && width != 32) return int(cudaErrorInvalidValue);
  if (n_cols > 0 && grid_y > 0 && p.row_blocks > 0) {
    dim3 grid(n_cols / width, grid_y);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    err = in_kind == 1 ? launch_width<float>(gres, width, p, grid, acc_smem, st, transpose_a, transpose_b)
                       : launch_width<__nv_bfloat16>(gres, width, p, grid, acc_smem, st, transpose_a, transpose_b);
  }
  return static_cast<int>(err == cudaSuccess ? cudaGetLastError() : err);
}

}  // namespace

// Shared memory the staging buffers of one CTA take (the gres wrapper adds
// the accumulator rows and decides whether they fit).
extern "C" long long bsr_resident_staging_bytes(int in_kind, int width, int transpose_b) {
  return static_cast<long long>(staging_bytes(in_kind, width, transpose_b));
}

// DSD view: C'(R, N) = op(S)(R, K) . op(D)(K, N), element (r, n) of C' at
// c[r * c_row_stride + n * c_col_stride]. The stream (deps, rows, datas) is
// sorted by dep; CTAs cover N / 32 slabs x ceil(R / 128 / rows_per_range)
// ranges. acc: an (R, N) fp32 scratch. in_kind: 0 bf16, 1 fp32; out_kind:
// 0 bf16, 1 fp32. Returns the error of the shared-memory attribute call or
// cudaGetLastError() after the launch.
extern "C" int bsr_cres(const void* sparse, const void* deps, const void* rows, const void* datas, int nnz,
                        const void* dense, void* acc, void* c, int row_blocks, int n_cols, int rows_per_range,
                        long long ld_dense, long long c_row_stride, long long c_col_stride, int in_kind,
                        int out_kind, int transpose_a, int transpose_b, void* stream) {
  ResParams p{sparse, static_cast<const int*>(deps), static_cast<const int*>(rows), static_cast<const int*>(datas),
              nullptr, dense, static_cast<float*>(acc), c, row_blocks, rows_per_range, nnz, ld_dense, n_cols,
              c_row_stride, c_col_stride, out_kind};
  if (rows_per_range <= 0) return int(cudaErrorInvalidValue);
  const int ranges = (row_blocks + rows_per_range - 1) / rows_per_range;
  return run(false, p, 32, nnz > 0 ? n_cols : 0, ranges, 0, in_kind, transpose_a, transpose_b, stream);
}

// The same on a gres plan: n_groups groups of s_max slots (deps, subs,
// datas, flags), group g owning output block-rows g * group_rows onward.
// acc: an (R, N) fp32 scratch, or null to keep a group's rows in shared
// memory (group_rows * 128 * width * 4 bytes after the staging buffers).
extern "C" int bsr_gres(const void* sparse, const void* deps, const void* subs, const void* datas,
                        const void* flags, int n_groups, int s_max, int group_rows, const void* dense, void* acc,
                        void* c, int row_blocks, int n_cols, int width, long long ld_dense, long long c_row_stride,
                        long long c_col_stride, int in_kind, int out_kind, int transpose_a, int transpose_b,
                        void* stream) {
  ResParams p{sparse, static_cast<const int*>(deps), static_cast<const int*>(subs), static_cast<const int*>(datas),
              static_cast<const int*>(flags), dense, static_cast<float*>(acc), c, row_blocks, group_rows, s_max,
              ld_dense, n_cols, c_row_stride, c_col_stride, out_kind};
  const size_t acc_smem = acc == nullptr ? size_t(group_rows) * BS * width * sizeof(float) : 0;
  return run(true, p, width, n_cols, n_groups, acc_smem, in_kind, transpose_a, transpose_b, stream);
}
