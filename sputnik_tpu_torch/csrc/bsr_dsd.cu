// bsr_dsd_stream: C = op(A_bsr) . op(B) (DSD), and DDS through the same
// kernel as C^T = op(B_bsr)^T . op(A)^T with swapped operands and output
// strides.
//
// Replaces sputnik_tpu/kernels/bsr_dsd.py::_stream_kernel (reached from
// dsd and dds). There the TPU grid walks the nonzero blocks in order and
// carries an fp32 accumulator in VMEM from one grid step to the next,
// flushing when the output tile changes, and empty rows are masked after
// the call. Here one CTA owns one output tile (block-row g, n-tile) and
// loops over its row's blocks itself: offsets[g]..offsets[g+1], or the
// transpose metadata (offsets_t / indices_t / block_offsets) for a
// transposed A. A row with no blocks stores zeros from the kernel. The
// grid's z axis is a batch of matrices that share one topology (the heads
// of an attention layer, vmapped in JAX).
//
// What bounds it on the H100: every step reads one 128x128 block and one
// 128x128 slab of B (64 KB in bf16) for 4.2 MFLOP, ~64 FLOP/byte, under
// the card's ~295 FLOP/byte ridge, so it is bound by memory and by how
// well loads overlap the math. At the attention shapes the grid is also
// small (N = 128 gives one n-tile: 8 heads x 8..16 block-rows = 64..128
// CTAs for 132 SMs), so latency dominates. This first version stages each
// k-chunk synchronously through static shared memory (< 48 KB) and does
// not overlap loads with math; cp.async / TMA pipelines, wgmma and a
// split of the block loop across CTAs are later work.
#include "bsr_tile.cuh"

namespace {

struct DsdParams {
  const void* a;             // ([batch,] nnz, 128, 128) sparse blocks
  const int* group_offsets;  // (n_groups + 1,) steps of each output block-row
  const int* dep_ids;        // (nnz,) contraction block id of each step
  const int* data_ids;       // (nnz,) block position of each step; null = identity
  const void* b;             // dense operand
  void* c;                   // output
  int64_t ldb;
  int64_t c_row_stride, c_col_stride;
  int64_t a_batch_stride, b_batch_stride, c_batch_stride;  // in elements
  int out_f32;
};

template <typename T, bool TA, bool TB>
__global__ void __launch_bounds__(bsr::THREADS)
    bsr_dsd_stream_kernel(DsdParams p) {
  using S = bsr::Smem<T, TA, TB>;
  using TileT = bsr::Tile<T, TA, TB>;
  __shared__ __align__(128) T As[S::A_ELEMS];
  __shared__ __align__(128) T Bs[S::B_ELEMS];
  __shared__ __align__(128) float scratch[TileT::SCRATCH_FLOATS];

  const int n0 = blockIdx.x * bsr::BS;
  const int g = blockIdx.y;
  const int64_t z = blockIdx.z;
  const T* a = static_cast<const T*>(p.a) + z * p.a_batch_stride;
  const T* b = static_cast<const T*>(p.b) + z * p.b_batch_stride;

  TileT tile;
  tile.zero();
  const int s_end = p.group_offsets[g + 1];
  for (int s = p.group_offsets[g]; s < s_end; ++s) {
    const int64_t pos = p.data_ids ? p.data_ids[s] : s;
    const int64_t dep = p.dep_ids[s];
    const T* a_tile = a + pos * bsr::BS * bsr::BS;
    const T* b_tile = TB ? b + n0 * p.ldb + dep * bsr::BS
                         : b + dep * bsr::BS * p.ldb + n0;
    bsr::accumulate<T, TA, TB>(tile, As, Bs, a_tile, bsr::BS, b_tile, p.ldb,
                               bsr::BS);
  }
  const int64_t c_off = z * p.c_batch_stride +
                        int64_t(g) * bsr::BS * p.c_row_stride +
                        int64_t(n0) * p.c_col_stride;
  char* c = static_cast<char*>(p.c) + c_off * (p.out_f32 ? 4 : 2);
  tile.store(c, p.c_row_stride, p.c_col_stride, p.out_f32, scratch);
}

template <typename T>
void launch(const DsdParams& p, dim3 grid, cudaStream_t st, bool ta, bool tb) {
  if (ta && tb)
    bsr_dsd_stream_kernel<T, true, true><<<grid, bsr::THREADS, 0, st>>>(p);
  else if (ta)
    bsr_dsd_stream_kernel<T, true, false><<<grid, bsr::THREADS, 0, st>>>(p);
  else if (tb)
    bsr_dsd_stream_kernel<T, false, true><<<grid, bsr::THREADS, 0, st>>>(p);
  else
    bsr_dsd_stream_kernel<T, false, false><<<grid, bsr::THREADS, 0, st>>>(p);
}

}  // namespace

// Output block-row g, column n of op(A) . op(B) lands at
// c[g * 128 * c_row_stride + n * c_col_stride] (plus the batch offset).
// Returns cudaGetLastError() after the launch.
extern "C" int bsr_dsd_stream(const void* a, const void* group_offsets,
                              const void* dep_ids, const void* data_ids,
                              const void* b, void* c, int n_groups, int n_cols,
                              int batch, long long ldb, long long c_row_stride,
                              long long c_col_stride, long long a_batch_stride,
                              long long b_batch_stride,
                              long long c_batch_stride, int in_f32, int out_f32,
                              int transpose_a, int transpose_b, void* stream) {
  DsdParams p{a,
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
              out_f32};
  if (n_groups > 0 && n_cols > 0 && batch > 0) {
    dim3 grid(n_cols / bsr::BS, n_groups, batch);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (in_f32)
      launch<float>(p, grid, st, transpose_a, transpose_b);
    else
      launch<__nv_bfloat16>(p, grid, st, transpose_a, transpose_b);
  }
  return static_cast<int>(cudaGetLastError());
}
