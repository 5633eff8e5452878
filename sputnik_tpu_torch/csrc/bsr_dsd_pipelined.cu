// bsr_dsd_pipelined: C = op(A_bsr) . op(B) (DSD), and DDS through the same
// kernel as C^T = op(B_bsr)^T . op(A)^T with swapped operands and output
// strides, on a ring of asynchronous copies.
//
// Replaces sputnik_tpu/kernels/bsr_dsd_pipelined.py::_pipelined_kernel
// (reached from dsd and dds). There one program owns one output tile, reads
// its trip count from the scalar-prefetched offsets and keeps S = 4 slots
// of (sparse block, dense panel) DMAs in flight, refilling slot i % S with
// block i + S before feeding the MXU. Here one CTA owns one 128 x 128
// output tile (block-row g, n-tile), reads offsets[g]..offsets[g+1] (or the
// transpose metadata offsets_t / indices_t / block_offsets for a transposed
// A) on the card, and runs an S = 4 stage cp.async ring over its row's
// (block, k-chunk) sequence: a stage is one k-chunk of the sparse block and
// the matching k-chunk of the dense slab its column index selects (32 deep
// in bf16, 16 in fp32, bsr_tile.cuh's chunks), so S - 1 chunks are in
// flight while one computes, and the next block's first chunks load while
// the current block's last chunk computes. No copy is issued past the
// row's last step (the TPU kernel clamps to nnz - 1 instead); an empty row
// stores zeros from the kernel. Transposed operands are staged as stored,
// 16-byte cp.async vectors along the contiguous axis, and the transpose
// lives in the fragment layout (bsr_tile.cuh). The grid's z axis is a batch
// of matrices sharing one topology (vmap in JAX). The sums are fp32: wmma
// 16x16x16 bf16 fragments accumulated in registers, or fp32 FMA without
// TF32; the tile is stored once, in the output dtype.
//
// What bounds it on the H100: a stage moves 16 KB (bf16) for 1 MFLOP, and
// every k-chunk of the row is staged once per 128-column n-tile, so the
// kernel does ~64 FLOP per staged byte, under the card's ~295 FLOP/byte
// ridge: the staged bytes and how well their latency hides behind the math
// bound it, which is what the ring is for. Ring smem (76 KB bf16, 75 KB
// fp32, above the 48 KB static limit: dynamic shared memory after
// cudaFuncSetAttribute) leaves room for two CTAs per SM. wgmma, TMA with
// mbarriers and wider n-tiles (more FLOP per staged byte) are later work.
#include "bsr_tile.cuh"
#include "cp_async.cuh"

namespace {

constexpr int STAGES = 4;

struct PipeParams {
  const void* a;             // ([batch,] nnz, 128, 128) sparse blocks
  const int* group_offsets;  // (n_groups + 1,) steps of each output block-row
  const int* dep_ids;        // (nnz,) contraction block id of each step
  const int* data_ids;       // (nnz,) block position of each step; null = identity
  const void* b;             // dense operand
  void* c;                   // output
  int64_t ldb;
  int64_t c_row_stride, c_col_stride;
  int64_t a_batch_stride, b_batch_stride, c_batch_stride;  // in elements
  int out_kind;              // bsr::OUT_BF16 / OUT_F32
};

template <typename T, bool TA, bool TB>
struct Ring {
  using S = bsr::Smem<T, TA, TB>;
  static constexpr int STAGE_ELEMS = S::A_ELEMS + S::B_ELEMS;
  static constexpr size_t RING_BYTES = size_t(STAGES) * STAGE_ELEMS * sizeof(T);
  static constexpr size_t BYTES = RING_BYTES + bsr::Tile<T, TA, TB>::SCRATCH_FLOATS * sizeof(float);
  static_assert(RING_BYTES % 128 == 0, "the epilogue scratch must stay aligned");
};

template <typename T, bool TA, bool TB>
__global__ void __launch_bounds__(bsr::THREADS)
    bsr_dsd_pipelined_kernel(PipeParams p) {
  using S = bsr::Smem<T, TA, TB>;
  using R = Ring<T, TA, TB>;
  constexpr int CHUNKS = bsr::BS / S::KC;  // k-chunks per block
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* scratch = reinterpret_cast<float*>(smem + R::RING_BYTES);

  const int n0 = blockIdx.x * bsr::BS;
  const int g = blockIdx.y;
  const int64_t z = blockIdx.z;
  const T* a = static_cast<const T*>(p.a) + z * p.a_batch_stride;
  const T* b = static_cast<const T*>(p.b) + z * p.b_batch_stride;
  const int s0 = p.group_offsets[g];
  const int total = (p.group_offsets[g + 1] - s0) * CHUNKS;  // ring items of this row

  // Issue item `it` (block s0 + it / CHUNKS, k-chunk it % CHUNKS) into its
  // stage, then commit: a group is committed for every item index, past
  // the end an empty one, so cp_async_wait counts stay uniform.
  auto issue = [&](int it) {
    if (it < total) {
      const int s = s0 + it / CHUNKS;
      const int k0 = (it % CHUNKS) * S::KC;
      const int64_t pos = p.data_ids ? p.data_ids[s] : s;
      const int64_t dep = p.dep_ids[s];
      const T* a_tile = a + pos * bsr::BS * bsr::BS;
      const T* b_tile = TB ? b + n0 * p.ldb + dep * bsr::BS : b + dep * bsr::BS * p.ldb + n0;
      T* As = ring + (it % STAGES) * R::STAGE_ELEMS;
      T* Bs = As + S::A_ELEMS;
      async_copy::copy_tile_async<T, S::A_ROWS, S::A_COLS, bsr::THREADS>(
          As, S::LDA, TA ? a_tile + k0 * bsr::BS : a_tile + k0, bsr::BS);
      async_copy::copy_tile_async<T, S::B_ROWS, S::B_COLS, bsr::THREADS>(
          Bs, S::LDB, TB ? b_tile + k0 : b_tile + k0 * p.ldb, p.ldb);
    }
    async_copy::cp_async_commit();
  };

  bsr::Tile<T, TA, TB> tile;
  tile.zero();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  for (int it = 0; it < total; ++it) {
    async_copy::cp_async_wait<STAGES - 2>();  // item `it` has landed for this thread
    __syncthreads();                     // ... for every thread; item it-1's stage is free
    issue(it + STAGES - 1);              // refill that stage before computing
    const T* As = ring + (it % STAGES) * R::STAGE_ELEMS;
    tile.mma_chunk(As, As + S::A_ELEMS);
  }
  async_copy::cp_async_wait<0>();

  const int64_t c_off = z * p.c_batch_stride + int64_t(g) * bsr::BS * p.c_row_stride +
                        int64_t(n0) * p.c_col_stride;
  char* c = static_cast<char*>(p.c) + c_off * (p.out_kind == bsr::OUT_BF16 ? 2 : 4);
  tile.store(c, p.c_row_stride, p.c_col_stride, p.out_kind, scratch);
}

template <typename T, bool TA, bool TB>
cudaError_t launch_mode(const PipeParams& p, dim3 grid, cudaStream_t st) {
  constexpr size_t bytes = Ring<T, TA, TB>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(bsr_dsd_pipelined_kernel<T, TA, TB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  bsr_dsd_pipelined_kernel<T, TA, TB><<<grid, bsr::THREADS, bytes, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const PipeParams& p, dim3 grid, cudaStream_t st, bool ta, bool tb) {
  if (ta && tb) return launch_mode<T, true, true>(p, grid, st);
  if (ta) return launch_mode<T, true, false>(p, grid, st);
  if (tb) return launch_mode<T, false, true>(p, grid, st);
  return launch_mode<T, false, false>(p, grid, st);
}

}  // namespace

// Output block-row g, column n of op(A) . op(B) lands at
// c[g * 128 * c_row_stride + n * c_col_stride] (plus the batch offset).
// in_kind: 0 bf16, 1 fp32; out_kind: 0 bf16, 1 fp32. Returns the error of
// the shared-memory attribute call or cudaGetLastError() after the launch.
extern "C" int bsr_dsd_pipelined(const void* a, const void* group_offsets, const void* dep_ids,
                                 const void* data_ids, const void* b, void* c, int n_groups, int n_cols,
                                 int batch, long long ldb, long long c_row_stride, long long c_col_stride,
                                 long long a_batch_stride, long long b_batch_stride,
                                 long long c_batch_stride, int in_kind, int out_kind, int transpose_a,
                                 int transpose_b, void* stream) {
  PipeParams p{a,
               static_cast<const int*>(group_offsets),
               static_cast<const int*>(dep_ids),
               static_cast<const int*>(data_ids),
               b,
               c,
               ldb,
               c_row_stride,
               c_col_stride,
               a_batch_stride,
               b_batch_stride,
               c_batch_stride,
               out_kind};
  cudaError_t err = cudaSuccess;
  if (n_groups > 0 && n_cols > 0 && batch > 0) {
    dim3 grid(n_cols / bsr::BS, n_groups, batch);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    err = in_kind == 1 ? launch<float>(p, grid, st, transpose_a, transpose_b)
                       : launch<__nv_bfloat16>(p, grid, st, transpose_a, transpose_b);
  }
  return static_cast<int>(err == cudaSuccess ? cudaGetLastError() : err);
}
