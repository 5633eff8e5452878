// bsr_bres: DSD, and DDS through it, on the q-batched plan of the JAX
// package's dense-resident schedule: a step is q blocks of one output
// block-row, contracted as one product of depth q * 128, with out_scale at
// the flush. bf16, fp32 and int8 (exact int32 accumulation) operands.
//
// Replaces sputnik_tpu/kernels/bsr_qstream.py::_bres_kernel (reached from
// dsd_bres and dds_bres, the "bres" kernel of ops/quant.py). On the TPU the
// whole dense operand sits in VMEM for the kernel's lifetime (fetched
// once), and the grid walks the plan's steps in order, carrying the
// accumulator from step to step and flushing when the output tile changes.
// The H100 has no on-chip memory that large. Here one CTA owns one output
// tile (block-row g, 128-column n-tile) and walks the plan's steps of its
// block-row (their range comes from the plan's per-row step offsets, built
// on the host for host-known metadata and on the card for metadata built
// there); a step stages its q live blocks and the q dense panels their dep
// ids select, chunk by chunk, and contracts them into the tile. Padding
// slots (past the step's valid count) are skipped. A block-row with no
// step stores zeros. At the headline shape (4096^2, 25%) the dense operand
// is 32 MB in bf16 and 16 MB in int8, so it stays in the 50 MB L2 across
// CTAs: the residency the TPU kernel builds by hand, left to the cache.
//
// What bounds it: as bsr_dsd_stream, each (128 x 128) block and panel pair
// is 4.2 MFLOP for 64 KB (bf16), under the ~295 FLOP/byte ridge of device
// memory, so the synchronous chunk staging and L2 latency bound it; a
// pipelined wgmma ring is later work.
#include "bsr_tile.cuh"

namespace {

struct BresParams {
  const void* a;            // (nnz, 128, 128) blocks
  const int* step_offsets;  // (n_groups + 1,) step range of each output block-row
  const int* dep_q;         // (n_steps * q,) contraction block of each slot
  const int* data_q;        // (n_steps * q,) block of each slot
  const int* nv;            // (n_steps,) live slots of each step
  const void* b;            // dense operand
  void* c;
  int q;
  int64_t ldb, c_row_stride, c_col_stride;
  int out_kind;
  float out_scale;
};

template <typename T, bool TA, bool TB>
__global__ void __launch_bounds__(bsr::THREADS) bsr_bres_kernel(BresParams p) {
  using S = bsr::Smem<T, TA, TB>;
  using TileT = bsr::Tile<T, TA, TB>;
  __shared__ __align__(128) T As[S::A_ELEMS];
  __shared__ __align__(128) T Bs[S::B_ELEMS];
  __shared__ __align__(128) float scratch[TileT::SCRATCH_FLOATS];

  const int64_t n0 = int64_t(blockIdx.x) * bsr::BS;
  const int g = blockIdx.y;
  const T* a = static_cast<const T*>(p.a);
  const T* b = static_cast<const T*>(p.b);

  TileT tile;
  tile.zero();
  const int j_end = p.step_offsets[g + 1];
  for (int j = p.step_offsets[g]; j < j_end; ++j) {
    // One step: its live slots' blocks against their panels, a depth
    // nv[j] * 128 contraction.
    const int live = p.nv[j];
    for (int qi = 0; qi < live; ++qi) {
      const int64_t slot = int64_t(j) * p.q + qi;
      const int64_t pos = p.data_q[slot];
      const int64_t dep = p.dep_q[slot];
      const T* a_tile = a + pos * bsr::BS * bsr::BS;
      const T* b_tile = TB ? b + n0 * p.ldb + dep * bsr::BS : b + dep * bsr::BS * p.ldb + n0;
      bsr::accumulate<T, TA, TB>(tile, As, Bs, a_tile, bsr::BS, b_tile, p.ldb, bsr::BS);
    }
  }
  const int64_t c_off = int64_t(g) * bsr::BS * p.c_row_stride + n0 * p.c_col_stride;
  char* c = static_cast<char*>(p.c) + c_off * (p.out_kind == bsr::OUT_BF16 ? 2 : 4);
  tile.store(c, p.c_row_stride, p.c_col_stride, p.out_kind, scratch, p.out_scale);
}

template <typename T>
void launch(const BresParams& p, dim3 grid, cudaStream_t st, bool ta, bool tb) {
  if (ta && tb)
    bsr_bres_kernel<T, true, true><<<grid, bsr::THREADS, 0, st>>>(p);
  else if (ta)
    bsr_bres_kernel<T, true, false><<<grid, bsr::THREADS, 0, st>>>(p);
  else if (tb)
    bsr_bres_kernel<T, false, true><<<grid, bsr::THREADS, 0, st>>>(p);
  else
    bsr_bres_kernel<T, false, false><<<grid, bsr::THREADS, 0, st>>>(p);
}

}  // namespace

// Output block-row g, column n of op(A) . op(B) lands at
// c[g * 128 * c_row_stride + n * c_col_stride]. in_kind: 0 bf16, 1 fp32,
// 2 int8; out_kind: 0 bf16, 1 fp32, 2 int32. Returns cudaGetLastError().
extern "C" int bsr_bres(const void* a, const void* step_offsets, const void* dep_q, const void* data_q,
                        const void* nv, const void* b, void* c, int n_groups, int n_cols, int q, long long ldb,
                        long long c_row_stride, long long c_col_stride, int in_kind, int out_kind,
                        float out_scale, int transpose_a, int transpose_b, void* stream) {
  BresParams p{a,
               static_cast<const int*>(step_offsets),
               static_cast<const int*>(dep_q),
               static_cast<const int*>(data_q),
               static_cast<const int*>(nv),
               b,
               c,
               q,
               ldb,
               c_row_stride,
               c_col_stride,
               out_kind,
               out_scale};
  if (n_groups > 0 && n_cols > 0) {
    dim3 grid(n_cols / bsr::BS, n_groups);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (in_kind == 2)
      launch<signed char>(p, grid, st, transpose_a, transpose_b);
    else if (in_kind == 1)
      launch<float>(p, grid, st, transpose_a, transpose_b);
    else
      launch<__nv_bfloat16>(p, grid, st, transpose_a, transpose_b);
  }
  return static_cast<int>(cudaGetLastError());
}
