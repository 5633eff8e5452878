// bsr_sdd_bres: SDD, C.data[i] = (op(A) . op(B)) at output block i of the
// topology, on the JAX package's input-resident plan: a plan step is up to
// `pack` consecutive nonzero output blocks of one block-row, whose products
// share one strip of op(A).
//
// Replaces sputnik_tpu/kernels/bsr_sdd.py::_sdd_bres_kernel (reached from
// sdd_bres). On the TPU both dense operands sit whole in VMEM (each fetched
// once from HBM); a grid step reads one (128, K) strip of op(A) and `pack`
// strips of op(B), contracts them over the full K into a (128, pack * 128)
// step-major tile, and an XLA gather (`src`) moves the real blocks into the
// topology's packed order. Here the operands stay where they are (the 50 MB
// L2 serves the strips that steps share), and:
//
// * a CTA takes BPC = min(pack, 2) blocks of one plan step (the grid's y
//   axis covers the step's pack slots), since pack = 4 tiles of 128 x 128
//   fp32 are 256 KB of accumulators, more than a CTA's registers; two
//   tiles (two bsr::Tile register sets, 128 floats a thread) are the most
//   that stays in registers;
// * the CTA streams the K dimension in k-chunks through an S = 3 stage
//   cp.async ring, each stage one chunk of the A strip, staged once for
//   both blocks, and one chunk of each block's B strip;
// * each real block is stored straight into the packed (nnz, 128, 128)
//   output at the slot's block index (the inverse of the plan's `src`), so
//   there is no step-major intermediate and no gather; padding slots issue
//   no copy and compute nothing;
// * all four transpose modes are taken by strides: chunks are staged as
//   stored and the transpose lives in the fragment layout (bsr_tile.cuh).
//
// What bounds it on the H100: a CTA does 2 * 128 * 128 * K FLOP per block
// for one A and BPC B strips of 128 x K, ~85 FLOP per staged byte in bf16
// at BPC = 2, under the card's ~295 FLOP/byte ridge: the staged bytes and
// how well the ring hides them bound it. wgmma and TMA are later work.
#include "bsr_tile.cuh"
#include "cp_async.cuh"

namespace {

constexpr int STAGES = 3;

struct SddBresParams {
  const void* a;
  const void* b;
  const int* rows;  // (n_steps,) output block-row of each step
  const int* cols;  // (n_steps * pack,) output block-column of each slot
  const int* dst;   // (n_steps * pack,) output block of each slot, -1 for padding
  void* out;        // (nnz, 128, 128)
  int pack;
  int k;
  int64_t lda, ldb;
  int out_kind;
};

template <typename T, bool TA, bool TB, int BPC>
struct Ring {
  using S = bsr::Smem<T, TA, TB>;
  static constexpr int STAGE_ELEMS = S::A_ELEMS + BPC * S::B_ELEMS;
  static constexpr size_t RING_BYTES = size_t(STAGES) * STAGE_ELEMS * sizeof(T);
  static constexpr size_t BYTES = RING_BYTES + bsr::Tile<T, TA, TB>::SCRATCH_FLOATS * sizeof(float);
  static_assert(RING_BYTES % 128 == 0, "the epilogue scratch must stay aligned");
};

template <typename T, bool TA, bool TB, int BPC>
__global__ void __launch_bounds__(bsr::THREADS) bsr_sdd_bres_kernel(SddBresParams p) {
  using S = bsr::Smem<T, TA, TB>;
  using R = Ring<T, TA, TB, BPC>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* scratch = reinterpret_cast<float*>(smem + R::RING_BYTES);

  const int64_t j = blockIdx.x;
  const T* a = static_cast<const T*>(p.a);
  const T* b = static_cast<const T*>(p.b);
  const int64_t m0 = int64_t(p.rows[j]) * bsr::BS;
  const T* a_tile = TA ? a + m0 : a + m0 * p.lda;  // op(A) rows m0.. stored (K, M) or (M, K)
  int dst[BPC];
  const T* b_tile[BPC];
  bool any = false;
#pragma unroll
  for (int h = 0; h < BPC; ++h) {
    const int slot_in_step = blockIdx.y * BPC + h;
    const int64_t slot = j * p.pack + slot_in_step;
    dst[h] = slot_in_step < p.pack ? p.dst[slot] : -1;
    const int64_t n0 = dst[h] >= 0 ? int64_t(p.cols[slot]) * bsr::BS : 0;
    b_tile[h] = TB ? b + n0 * p.ldb : b + n0;  // op(B) columns n0.. stored (N, K) or (K, N)
    any = any || dst[h] >= 0;
  }
  if (!any) return;

  const int chunks = p.k / S::KC;
  auto issue = [&](int it) {
    if (it < chunks) {
      const int k0 = it * S::KC;
      T* As = ring + (it % STAGES) * R::STAGE_ELEMS;
      async_copy::copy_tile_async<T, S::A_ROWS, S::A_COLS, bsr::THREADS>(
          As, S::LDA, TA ? a_tile + k0 * p.lda : a_tile + k0, p.lda);
#pragma unroll
      for (int h = 0; h < BPC; ++h)
        if (dst[h] >= 0)
          async_copy::copy_tile_async<T, S::B_ROWS, S::B_COLS, bsr::THREADS>(
              As + S::A_ELEMS + h * S::B_ELEMS, S::LDB, TB ? b_tile[h] + k0 : b_tile[h] + k0 * p.ldb, p.ldb);
    }
    async_copy::cp_async_commit();
  };

  bsr::Tile<T, TA, TB> tile[BPC];
#pragma unroll
  for (int h = 0; h < BPC; ++h) tile[h].zero();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  for (int it = 0; it < chunks; ++it) {
    async_copy::cp_async_wait<STAGES - 2>();  // chunk `it` has landed for this thread
    __syncthreads();                          // ... for every thread; chunk it-1's stage is free
    issue(it + STAGES - 1);
    const T* As = ring + (it % STAGES) * R::STAGE_ELEMS;
#pragma unroll
    for (int h = 0; h < BPC; ++h)
      if (dst[h] >= 0) tile[h].mma_chunk(As, As + S::A_ELEMS + h * S::B_ELEMS);
  }
  async_copy::cp_async_wait<0>();

  const int isz = p.out_kind == bsr::OUT_BF16 ? 2 : 4;
#pragma unroll
  for (int h = 0; h < BPC; ++h)
    if (dst[h] >= 0) {
      char* c = static_cast<char*>(p.out) + int64_t(dst[h]) * bsr::BS * bsr::BS * isz;
      tile[h].store(c, bsr::BS, 1, p.out_kind, scratch);
    }
}

template <typename T, bool TA, bool TB, int BPC>
cudaError_t launch_mode(const SddBresParams& p, dim3 grid, cudaStream_t st) {
  constexpr size_t bytes = Ring<T, TA, TB, BPC>::BYTES;
  auto kernel = bsr_sdd_bres_kernel<T, TA, TB, BPC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, bsr::THREADS, bytes, st>>>(p);
  return cudaGetLastError();
}

template <typename T, int BPC>
cudaError_t launch(const SddBresParams& p, dim3 grid, cudaStream_t st, bool ta, bool tb) {
  if (ta && tb) return launch_mode<T, true, true, BPC>(p, grid, st);
  if (ta) return launch_mode<T, true, false, BPC>(p, grid, st);
  if (tb) return launch_mode<T, false, true, BPC>(p, grid, st);
  return launch_mode<T, false, false, BPC>(p, grid, st);
}

}  // namespace

// rows / cols / dst: the plan (step rows, slot columns, slot -> output
// block or -1). K a multiple of 128; lda / ldb the stored row lengths of A
// and B. in_kind: 0 bf16, 1 fp32; out_kind: 0 bf16, 1 fp32. Returns the
// error of the shared-memory attribute call or cudaGetLastError() after
// the launch.
extern "C" int bsr_sdd_bres(const void* a, const void* b, const void* rows, const void* cols, const void* dst,
                            void* out, int n_steps, int pack, int k, long long lda, long long ldb, int in_kind,
                            int out_kind, int transpose_a, int transpose_b, void* stream) {
  SddBresParams p{a, b, static_cast<const int*>(rows), static_cast<const int*>(cols), static_cast<const int*>(dst),
                  out, pack, k, lda, ldb, out_kind};
  cudaError_t err = cudaSuccess;
  if (n_steps > 0 && pack > 0 && k > 0) {
    const int bpc = pack >= 2 ? 2 : 1;
    dim3 grid(n_steps, (pack + bpc - 1) / bpc);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (in_kind == 1)
      err = bpc == 2 ? launch<float, 2>(p, grid, st, transpose_a, transpose_b)
                     : launch<float, 1>(p, grid, st, transpose_a, transpose_b);
    else
      err = bpc == 2 ? launch<__nv_bfloat16, 2>(p, grid, st, transpose_a, transpose_b)
                     : launch<__nv_bfloat16, 1>(p, grid, st, transpose_a, transpose_b);
  }
  return static_cast<int>(err == cudaSuccess ? cudaGetLastError() : err);
}
