// bsr_sdd: C.data[i] = (op(A) . op(B)) at block (row_ids[i], col_ids[i])
// for every nonzero block i of the output topology (SDD, sampled dense x
// dense).
//
// Replaces sputnik_tpu/kernels/bsr_sdd.py::_sdd_panel_kernel (the JAX
// first-fit at the attention shapes) and ::_sdd_kernel (the same function
// with a k-tiled grid). The panel kernel keeps a row group of A resident in
// VMEM and sorts its work items so consecutive grid steps reuse a B strip,
// then scatters the results back to the topology's order through
// `positions`. Here one CTA computes one nonzero output block with a full-K
// loop and writes it straight to its slot in the topology's packed data
// order, so there is no plan and no scatter; reuse of A and B strips
// between CTAs is left to the 50 MB L2. The grid's z axis is a batch of
// problems sharing one topology (attention heads).
//
// What bounds it on the H100: each CTA reads a 128xK strip of A and of B
// for 2*128*128*K FLOP (64 FLOP/byte in bf16, at any K), so on its own it
// is bound by memory unless L2 serves the strips that neighbouring blocks
// share. At K = d_head = 128 the loop is four chunks deep and the CTA's
// fixed costs (index loads, the epilogue) are a large share. Chunks are
// staged synchronously through static shared memory; a pipelined wgmma
// version is later work.
#include "bsr_tile.cuh"

namespace {

struct SddParams {
  const void* a;
  const void* b;
  const int* row_ids;  // (nnz,) output block-row of each block
  const int* col_ids;  // (nnz,) output block-column of each block
  void* out;           // ([batch,] nnz, 128, 128)
  int k;
  int64_t lda, ldb;
  int64_t a_batch_stride, b_batch_stride, out_batch_stride;  // in elements
  int out_f32;
};

template <typename T, bool TA, bool TB>
__global__ void __launch_bounds__(bsr::THREADS) bsr_sdd_kernel(SddParams p) {
  using S = bsr::Smem<T, TA, TB>;
  using TileT = bsr::Tile<T, TA, TB>;
  __shared__ __align__(128) T As[S::A_ELEMS];
  __shared__ __align__(128) T Bs[S::B_ELEMS];
  __shared__ __align__(128) float scratch[TileT::SCRATCH_FLOATS];

  const int64_t i = blockIdx.x;
  const int64_t z = blockIdx.z;
  const int64_t m0 = int64_t(p.row_ids[i]) * bsr::BS;
  const int64_t n0 = int64_t(p.col_ids[i]) * bsr::BS;
  const T* a = static_cast<const T*>(p.a) + z * p.a_batch_stride;
  const T* b = static_cast<const T*>(p.b) + z * p.b_batch_stride;
  const T* a_tile = TA ? a + m0 : a + m0 * p.lda;  // (K, M) or (M, K)
  const T* b_tile = TB ? b + n0 * p.ldb : b + n0;  // (N, K) or (K, N)

  TileT tile;
  tile.zero();
  bsr::accumulate<T, TA, TB>(tile, As, Bs, a_tile, p.lda, b_tile, p.ldb, p.k);
  const int64_t o_off = z * p.out_batch_stride + i * bsr::BS * bsr::BS;
  char* out = static_cast<char*>(p.out) + o_off * (p.out_f32 ? 4 : 2);
  tile.store(out, bsr::BS, 1, p.out_f32, scratch);
}

template <typename T>
void launch(const SddParams& p, dim3 grid, cudaStream_t st, bool ta, bool tb) {
  if (ta && tb)
    bsr_sdd_kernel<T, true, true><<<grid, bsr::THREADS, 0, st>>>(p);
  else if (ta)
    bsr_sdd_kernel<T, true, false><<<grid, bsr::THREADS, 0, st>>>(p);
  else if (tb)
    bsr_sdd_kernel<T, false, true><<<grid, bsr::THREADS, 0, st>>>(p);
  else
    bsr_sdd_kernel<T, false, false><<<grid, bsr::THREADS, 0, st>>>(p);
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int bsr_sdd(const void* a, const void* b, const void* row_ids,
                       const void* col_ids, void* out, int nnz, int k,
                       int batch, long long lda, long long ldb,
                       long long a_batch_stride, long long b_batch_stride,
                       long long out_batch_stride, int in_f32, int out_f32,
                       int transpose_a, int transpose_b, void* stream) {
  SddParams p{a,
              b,
              static_cast<const int*>(row_ids),
              static_cast<const int*>(col_ids),
              out,
              k,
              lda,
              ldb,
              a_batch_stride,
              b_batch_stride,
              out_batch_stride,
              out_f32};
  if (nnz > 0 && batch > 0) {
    dim3 grid(nnz, 1, batch);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (in_f32)
      launch<float>(p, grid, st, transpose_a, transpose_b);
    else
      launch<__nv_bfloat16>(p, grid, st, transpose_a, transpose_b);
  }
  return static_cast<int>(cudaGetLastError());
}
