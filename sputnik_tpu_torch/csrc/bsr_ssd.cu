// bsr_sparse_out: SSD (sparse = sparse . dense) and SDS (sparse = dense .
// sparse), output-stationary over the sparse operand's metadata as it
// lies on the card.
//
// Replaces sputnik_tpu/kernels/bsr_ssd.py::_sparse_out_kernel (reached
// from ssd and sds). There the TPU grid is (nnz_out, max_steps): the step
// axis is bounded by the stream operand's static row / column hint, steps
// past an output block's extent fetch a clamped block and are masked, and
// an fp32 accumulator is carried across the sequential step axis. Here
// one CTA owns one output block and loops over the stream operand's blocks
// in that block's row (SSD) or column (SDS) itself: the trip count
// offs[g]..offs[g+1] is read on the device, Sputnik's data-dependent
// StepsK, so no masked steps exist; a given max_steps caps it as the
// TPU's grid does. A transposed stream (SSD with op(A) = A^T, SDS with
// B not transposed) iterates through the transpose metadata (offsets_t,
// indices_t, block_offsets). An empty row or column stores zeros. No
// atomics: each output block is written once, bitwise the same run to run.
//
// What bounds it on the H100: as bsr_flat.cu, ~64 FLOP per byte read per
// step, under the ~295 FLOP/byte ridge: memory and load/math overlap. It
// needs no host plan, so it is the route for metadata built on the card.
#include "bsr_item.cuh"

namespace {

struct SparseOutParams {
  const void* stream;   // (nnz_stream, 128, 128) stream operand blocks
  const void* dense;    // SSD: B, SDS: A
  void* out;            // (nnz_out, 128, 128)
  const int* group_of;  // (nnz_out,) stream group (row / column) of each output block
  const int* c_other;   // (nnz_out,) the output block's other coordinate
  const int* offs;      // (groups + 1,) stream group offsets
  const int* dep;       // (nnz_stream,) contraction block id, iteration order
  const int* data_ids;  // (nnz_stream,) block position, iteration order; null = identity
  int max_steps;
  int kind;
  int64_t ld_dense;
  int out_f32;
};

template <typename T, bool TA, bool TB>
__global__ void __launch_bounds__(bsr::THREADS)
    bsr_sparse_out_kernel(SparseOutParams p) {
  using S = bsr::Smem<T, TA, TB>;
  using TileT = bsr::Tile<T, TA, TB>;
  __shared__ __align__(128) T As[S::A_ELEMS];
  __shared__ __align__(128) T Bs[S::B_ELEMS];
  __shared__ __align__(128) float scratch[TileT::SCRATCH_FLOATS];

  const int b = blockIdx.x;
  const int g = p.group_of[b];
  const int64_t other = p.c_other[b];
  const T* stream = static_cast<const T*>(p.stream);
  TileT tile;
  tile.zero();
  const int start = p.offs[g];
  const int end = start + min(p.offs[g + 1] - start, p.max_steps);
  for (int s = start; s < end; ++s) {
    const int64_t pos = p.data_ids ? p.data_ids[s] : s;
    bsr::accumulate_item<T, TA, TB>(tile, As, Bs, p.kind,
                                    stream + pos * bsr::BS * bsr::BS,
                                    static_cast<const T*>(p.dense), p.ld_dense,
                                    p.dep[s], other);
  }
  bsr::store_tile(tile, p.out, int64_t(b) * bsr::BS * bsr::BS, bsr::BS,
                  p.out_f32, scratch);
}

}  // namespace

// kind: 0 SSD (stream = A, dense = B), 1 SDS (stream = B, dense = A).
// Returns cudaGetLastError() after the launch.
extern "C" int bsr_sparse_out(const void* stream_blocks, const void* dense,
                              void* out, const void* group_of,
                              const void* c_other, const void* offs,
                              const void* dep, const void* data_ids, int nnz_out,
                              int max_steps, int kind, long long ld_dense,
                              int in_f32, int out_f32, int transpose_a,
                              int transpose_b, void* stream) {
  SparseOutParams p{stream_blocks,
                    dense,
                    out,
                    static_cast<const int*>(group_of),
                    static_cast<const int*>(c_other),
                    static_cast<const int*>(offs),
                    static_cast<const int*>(dep),
                    static_cast<const int*>(data_ids),
                    max_steps,
                    kind,
                    ld_dense,
                    out_f32};
  if (nnz_out > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (in_f32)
      BSR_LAUNCH_MODES(bsr_sparse_out_kernel, float, transpose_a, transpose_b, nnz_out, st, p);
    else
      BSR_LAUNCH_MODES(bsr_sparse_out_kernel, __nv_bfloat16, transpose_a, transpose_b, nnz_out, st, p);
  }
  return static_cast<int>(cudaGetLastError());
}
