// bsr_cstack: DSD (op(A) = A, not transposed) on the JAX package's
// column-stacked q-slot plan, with the fp32 accumulator of a column slab of
// the output kept until one flush.
//
// Replaces sputnik_tpu/kernels/bsr_cstack.py::_cstack_kernel (reached from
// dsd_cstack, the registry's pallas_cstack / pallas_cstack_q4). On the TPU
// the blocks are walked contraction-major through bsr_qstream's padded slot
// plan (groups = contraction blocks k): grid step j holds up to q live slots
// (nv[j]) of one k, the q blocks are stacked into one (q * 128, 128) lhs so
// that the MXU streams q * 128 rows against the strip B[k, tile] fetched
// once for the step, and the row slices of the product are added into a
// VMEM-resident (m_blocks, 128, n_tile) fp32 accumulator; m_blocks flush
// steps then write the output once. The H100 has no on-chip memory for
// that accumulator (at m = 4096 even a 32-column tile is 512 KB).
//
// Here, as in bsr_cres (bsr_resident.cuh's slab walk, shared with it): one
// CTA owns a slab of 32 output columns and a range of output block-rows,
// its accumulator rows in an (M, N) fp32 device scratch that stays in the
// 50 MB L2 at d <= 4096, touched by that CTA only, so the sums repeat
// bitwise. The CTA executes the q-slot plan: for every plan step with a
// live slot in its range it stages the strip B[k, slab] (128 x 32, or
// 32 x 128 for B stored (N, K)) once into shared memory, and the step's
// live slots' blocks stream through a two-stage cp.async double buffer, each
// block's product with the strip added into its rows (wmma in bf16, FMA
// without TF32 in fp32). Padding slots (qi >= nv[j]) and the all-padding
// steps a plan built on the card ends with are skipped. The flush (the TPU's
// frows steps) casts the slab's rows; rows with no block flush the zeros
// the CTA wrote first.
//
// What the q-slot plan changes against bsr_cres on this card: cres stages a
// strip once per run of equal k; cstack once per plan step, so a
// contraction block with more than q blocks stages its strip ceil(count /
// q) times. The MXU's fill / drain, which stacking amortizes on the TPU, has
// no counterpart in wmma, whose fragments are 16 rows. What bounds it is
// cres's: every slab's CTA reads every block of its range from L2 (32 KB in
// bf16 for 1 MFLOP at W = 32) and moves its accumulator rows through L2.
#include "bsr_resident.cuh"

namespace {

using bsr::BS;
using bsr::THREADS;
using resident::ResParams;

constexpr int W = 32;  // output columns of a slab

// The q-slot plan of one cstack CTA: slot i of step i / q is live when
// i % q < nv[i / q] and its output block-row is in the CTA's range.
struct CstackStream {
  const int* ks;
  const int* rows;
  const int* datas;
  const int* nv;
  int q, begin, end, lo, hi;
  __device__ bool live(int i) const { return i % q < nv[i / q] && rows[i] >= lo && rows[i] < hi; }
  __device__ int row(int i) const { return rows[i] - lo; }
  __device__ int dep(int i) const { return ks[i]; }
  __device__ int data(int i) const { return datas[i]; }
  __device__ int strip_key(int i) const { return i / q; }
};

// Grid (N / W slabs, ranges): the range's rows of the device scratch.
template <typename T, bool TB>
__global__ void __launch_bounds__(THREADS) bsr_cstack_kernel(ResParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t col0 = int64_t(blockIdx.x) * W;
  const int lo = blockIdx.y * p.rows_per_cta;
  const int hi = min(lo + p.rows_per_cta, p.row_blocks);
  if (lo >= hi) return;
  CstackStream s{p.deps, p.rows, p.datas, p.flags, p.q, 0, p.stream_len, lo, hi};
  float* acc = p.acc + int64_t(lo) * BS * p.ld_acc + col0;
  resident::resident_slab<T, false, TB, W>(p, s, smem, acc, p.ld_acc, (hi - lo) * BS, int64_t(lo) * BS, col0);
}

template <typename T>
cudaError_t launch(const ResParams& p, dim3 grid, cudaStream_t st, bool tb) {
  return tb ? resident::launch_slabs<T, true, W>(bsr_cstack_kernel<T, true>, p, grid, 0, st)
            : resident::launch_slabs<T, false, W>(bsr_cstack_kernel<T, false>, p, grid, 0, st);
}

}  // namespace

// C(M, N) = A(M, K) . op(B)(K, N) on a q-slot plan of n_steps steps: slot s
// (step s / q) holds contraction block k_q[s], output block-row row_q[s] and
// block data_q[s]; step j's first nv[j] slots are live. CTAs cover N / 32
// slabs x ceil(M / 128 / rows_per_range) ranges. acc: an (M, N) fp32
// scratch. in_kind: 0 bf16, 1 fp32; out_kind: 0 bf16, 1 fp32. Returns the
// error of the shared-memory attribute call or cudaGetLastError() after the
// launch.
extern "C" int bsr_cstack(const void* sparse, const void* k_q, const void* row_q, const void* data_q,
                          const void* nv, int n_steps, int q, const void* dense, void* acc, void* c, int row_blocks,
                          int n_cols, int rows_per_range, long long ld_dense, int in_kind, int out_kind,
                          int transpose_b, void* stream) {
  if (rows_per_range <= 0 || q <= 0 || n_cols % W) return int(cudaErrorInvalidValue);
  ResParams p{sparse, static_cast<const int*>(k_q), static_cast<const int*>(row_q),
              static_cast<const int*>(data_q), static_cast<const int*>(nv), dense, static_cast<float*>(acc), c,
              row_blocks, rows_per_range, n_steps * q, q, ld_dense, n_cols, n_cols, 1, out_kind};
  cudaError_t err = cudaSuccess;
  const int ranges = (row_blocks + rows_per_range - 1) / rows_per_range;
  if (n_cols > 0 && ranges > 0 && n_steps > 0) {
    dim3 grid(n_cols / W, ranges);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    err = in_kind == 1 ? launch<float>(p, grid, st, transpose_b) : launch<__nv_bfloat16>(p, grid, st, transpose_b);
  }
  return static_cast<int>(err == cudaSuccess ? cudaGetLastError() : err);
}
