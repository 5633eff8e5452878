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
// The slab walk and the flush are bsr_resident.cuh's, shared with
// bsr_cstack.cu. cres keeps the accumulator in device memory, an (R, N) fp32 scratch that
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
#include "bsr_resident.cuh"

namespace {

using bsr::BS;
using bsr::THREADS;
using resident::Geo;
using resident::ResParams;

// The dep-major stream of one cres CTA: every block, live when its output
// block-row is in the CTA's range [lo, hi).
struct CresStream {
  const int* deps;
  const int* rows;
  const int* datas;
  int begin, end, lo, hi;
  __device__ bool live(int i) const { return rows[i] >= lo && rows[i] < hi; }
  __device__ int row(int i) const { return rows[i] - lo; }
  __device__ int dep(int i) const { return deps[i]; }
  __device__ int data(int i) const { return datas[i]; }
  __device__ int strip_key(int i) const { return deps[i]; }
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
  __device__ int dep(int i) const { return deps[i]; }
  __device__ int data(int i) const { return datas[i]; }
  __device__ int strip_key(int i) const { return deps[i]; }
};

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
  resident::resident_slab<T, TA, TB, W>(p, s, smem, acc, p.ld_acc, (hi - lo) * BS, int64_t(lo) * BS, col0);
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
  resident::resident_slab<T, TA, TB, W>(p, s, smem, acc, ld, n_blocks * BS, int64_t(row0) * BS, col0);
}

template <typename T, bool TA, bool TB, int W>
cudaError_t launch_mode(bool gres, const ResParams& p, dim3 grid, size_t acc_smem, cudaStream_t st) {
  return resident::launch_slabs<T, TB, W>(gres ? bsr_gres_kernel<T, TA, TB, W> : bsr_cres_kernel<T, TA, TB, W>, p,
                                          grid, acc_smem, st);
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
              nullptr, dense, static_cast<float*>(acc), c, row_blocks, rows_per_range, nnz, 1, ld_dense, n_cols,
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
              static_cast<const int*>(flags), dense, static_cast<float*>(acc), c, row_blocks, group_rows, s_max, 1,
              ld_dense, n_cols, c_row_stride, c_col_stride, out_kind};
  const size_t acc_smem = acc == nullptr ? size_t(group_rows) * BS * width * sizeof(float) : 0;
  return run(true, p, width, n_cols, n_groups, acc_smem, in_kind, transpose_a, transpose_b, stream);
}
