// bsr_qstream: DSD and DDS on the q-batched slot plan of the JAX package's
// q-stream schedule, its slots' (block, dense panel) pairs streamed through
// a ring of asynchronous copies.
//
// Replaces sputnik_tpu/kernels/bsr_qstream.py::_qstream_kernel (reached
// from dsd_q, dds_q and dds_ct). On the TPU a grid step takes q blocks of
// one output tile with their q dense panels, so that the fixed cost of a
// grid step is paid once per q blocks; the accumulator sits in VMEM and is
// carried from step to step until the output tile changes. Its `accum`
// option picks how a step adds its q dots into that VMEM accumulator (one
// read-modify-write per dot, one per step, or one dot of depth q * 128);
// here the accumulator lives in registers for the whole tile, so the three
// are one computation and the wrapper only validates the name.
//
// Here one CTA owns one 128 x 128 output tile: output group g (a block-row
// of op(A) for DSD, a block-column of op(B) for DDS) times the 128-wide
// tile p of the dense operand's other dimension. It walks its group's plan
// steps (the plan's step_offsets[g] .. step_offsets[g + 1], built on the
// host for host-known metadata and on the card otherwise) and, for every
// live slot of a step (qi < nv[j]), the slot's block and the dense panel
// its dep id selects, one k-chunk at a time through an S = 4 stage cp.async
// ring (bsr_tile.cuh's chunks: 32 deep in bf16, 16 in fp32), so that the
// next slot's chunks load while this slot's last chunk computes. Padding
// slots issue no copy and compute nothing. A group with no step stores
// zeros.
//
// SPARSE_A puts the sparse block on the tile's A side: DSD, and DDS with
// the JAX package's transposed accumulator (dds_ct: the tile accumulated as
// (n, m) = op(B)^T . op(A)^T and stored transposed through the output
// strides). Without it (dds_q) the dense panel is the A side and the tile
// is (m, n) = op(A) . op(B) as it is stored.
//
// What bounds it on the H100: as bsr_dsd_pipelined, every k-chunk of a
// slot is staged once per 128-wide tile, ~64 FLOP per staged byte in bf16,
// under the card's ~295 FLOP/byte ridge, so the staged bytes and how well
// the ring hides their latency bound it. wgmma and TMA are later work.
#include "bsr_tile.cuh"
#include "cp_async.cuh"

namespace {

constexpr int STAGES = 4;

struct QParams {
  const void* sparse;        // (nnz, 128, 128) blocks
  const int* step_offsets;   // (n_groups + 1,) step range of each output group
  const int* dep_q;          // (n_steps * q,) contraction block of each slot
  const int* data_q;         // (n_steps * q,) block of each slot
  const int* nv;             // (n_steps,) live slots of each step
  const void* dense;
  void* c;
  int q;
  int64_t ld_dense;
  int64_t c_row_stride, c_col_stride;  // of the tile as computed
  int out_kind;                        // bsr::OUT_BF16 / OUT_F32
};

template <typename T, bool TA, bool TB>
struct Ring {
  using S = bsr::Smem<T, TA, TB>;
  static constexpr int STAGE_ELEMS = S::A_ELEMS + S::B_ELEMS;
  static constexpr size_t RING_BYTES = size_t(STAGES) * STAGE_ELEMS * sizeof(T);
  static constexpr size_t BYTES = RING_BYTES + bsr::Tile<T, TA, TB>::SCRATCH_FLOATS * sizeof(float);
  static_assert(RING_BYTES % 128 == 0, "the epilogue scratch must stay aligned");
};

// TA / TB: the stored orientation of the tile's A and B operands, as in
// bsr_tile.cuh (which operand is the sparse block depends on SPARSE_A).
template <typename T, bool TA, bool TB, bool SPARSE_A>
__global__ void __launch_bounds__(bsr::THREADS) bsr_qstream_kernel(QParams p) {
  using S = bsr::Smem<T, TA, TB>;
  using R = Ring<T, TA, TB>;
  constexpr int CHUNKS = bsr::BS / S::KC;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* scratch = reinterpret_cast<float*>(smem + R::RING_BYTES);

  const int64_t p0 = int64_t(blockIdx.x) * bsr::BS;  // the dense operand's tile
  const int g = blockIdx.y;
  const T* sparse = static_cast<const T*>(p.sparse);
  const T* dense = static_cast<const T*>(p.dense);
  const int64_t slot0 = int64_t(p.step_offsets[g]) * p.q;
  const int total = int((int64_t(p.step_offsets[g + 1]) * p.q - slot0) * CHUNKS);  // ring items

  // Whether ring item `it` is a live slot's chunk (uniform across the CTA).
  auto live = [&](int it) {
    const int64_t slot = slot0 + it / CHUNKS;
    return it < total && int(slot % p.q) < p.nv[slot / p.q];
  };
  // Issue item `it` into its stage, then commit: one group per item index,
  // empty for a padding slot or past the end, so cp_async_wait counts stay
  // uniform.
  auto issue = [&](int it) {
    if (live(it)) {
      const int64_t slot = slot0 + it / CHUNKS;
      const int k0 = (it % CHUNKS) * S::KC;
      const int64_t dep = p.dep_q[slot];
      const T* blk = sparse + int64_t(p.data_q[slot]) * bsr::BS * bsr::BS;
      // The dense panel: rows dep * 128 of op(dense) in the DSD view, or
      // for dds_q op(A)'s tile p0 of rows at contraction block dep.
      const T* pan;
      if (SPARSE_A)
        pan = TB ? dense + p0 * p.ld_dense + dep * bsr::BS : dense + dep * bsr::BS * p.ld_dense + p0;
      else
        pan = TA ? dense + dep * bsr::BS * p.ld_dense + p0 : dense + p0 * p.ld_dense + dep * bsr::BS;
      const T* a_tile = SPARSE_A ? blk : pan;
      const T* b_tile = SPARSE_A ? pan : blk;
      const int64_t lda = SPARSE_A ? bsr::BS : p.ld_dense;
      const int64_t ldb = SPARSE_A ? p.ld_dense : bsr::BS;
      T* As = ring + (it % STAGES) * R::STAGE_ELEMS;
      T* Bs = As + S::A_ELEMS;
      async_copy::copy_tile_async<T, S::A_ROWS, S::A_COLS, bsr::THREADS>(
          As, S::LDA, TA ? a_tile + k0 * lda : a_tile + k0, lda);
      async_copy::copy_tile_async<T, S::B_ROWS, S::B_COLS, bsr::THREADS>(
          Bs, S::LDB, TB ? b_tile + k0 : b_tile + k0 * ldb, ldb);
    }
    async_copy::cp_async_commit();
  };

  bsr::Tile<T, TA, TB> tile;
  tile.zero();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  for (int it = 0; it < total; ++it) {
    async_copy::cp_async_wait<STAGES - 2>();  // item `it` has landed for this thread
    __syncthreads();                          // ... for every thread; item it-1's stage is free
    issue(it + STAGES - 1);
    if (live(it)) {
      const T* As = ring + (it % STAGES) * R::STAGE_ELEMS;
      tile.mma_chunk(As, As + S::A_ELEMS);
    }
  }
  async_copy::cp_async_wait<0>();

  const int64_t row0 = SPARSE_A ? int64_t(g) * bsr::BS : p0;
  const int64_t col0 = SPARSE_A ? p0 : int64_t(g) * bsr::BS;
  const int64_t c_off = row0 * p.c_row_stride + col0 * p.c_col_stride;
  char* c = static_cast<char*>(p.c) + c_off * (p.out_kind == bsr::OUT_BF16 ? 2 : 4);
  tile.store(c, p.c_row_stride, p.c_col_stride, p.out_kind, scratch);
}

template <typename T, bool TA, bool TB, bool SPARSE_A>
cudaError_t launch_mode(const QParams& p, dim3 grid, cudaStream_t st) {
  constexpr size_t bytes = Ring<T, TA, TB>::BYTES;
  auto kernel = bsr_qstream_kernel<T, TA, TB, SPARSE_A>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, bsr::THREADS, bytes, st>>>(p);
  return cudaGetLastError();
}

template <typename T, bool SPARSE_A>
cudaError_t launch(const QParams& p, dim3 grid, cudaStream_t st, bool ta, bool tb) {
  if (ta && tb) return launch_mode<T, true, true, SPARSE_A>(p, grid, st);
  if (ta) return launch_mode<T, true, false, SPARSE_A>(p, grid, st);
  if (tb) return launch_mode<T, false, true, SPARSE_A>(p, grid, st);
  return launch_mode<T, false, false, SPARSE_A>(p, grid, st);
}

}  // namespace

// The tile of output group g and dense tile t lands at
// c[row0 * c_row_stride + col0 * c_col_stride] with (row0, col0) = (g, t) * 128
// when sparse_a, else (t, g) * 128. transpose_a / transpose_b are the tile's
// A and B operands' stored orientations. in_kind: 0 bf16, 1 fp32; out_kind:
// 0 bf16, 1 fp32. Returns the error of the shared-memory attribute call or
// cudaGetLastError() after the launch.
extern "C" int bsr_qstream(const void* sparse, const void* step_offsets, const void* dep_q, const void* data_q,
                           const void* nv, const void* dense, void* c, int n_groups, int n_tiles, int q,
                           long long ld_dense, long long c_row_stride, long long c_col_stride, int in_kind,
                           int out_kind, int sparse_a, int transpose_a, int transpose_b, void* stream) {
  QParams p{sparse,
            static_cast<const int*>(step_offsets),
            static_cast<const int*>(dep_q),
            static_cast<const int*>(data_q),
            static_cast<const int*>(nv),
            dense,
            c,
            q,
            ld_dense,
            c_row_stride,
            c_col_stride,
            out_kind};
  cudaError_t err = cudaSuccess;
  if (n_groups > 0 && n_tiles > 0) {
    dim3 grid(n_tiles, n_groups);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (in_kind == 1)
      err = sparse_a ? launch<float, true>(p, grid, st, transpose_a, transpose_b)
                     : launch<float, false>(p, grid, st, transpose_a, transpose_b);
    else
      err = sparse_a ? launch<__nv_bfloat16, true>(p, grid, st, transpose_a, transpose_b)
                     : launch<__nv_bfloat16, false>(p, grid, st, transpose_a, transpose_b);
  }
  return static_cast<int>(err == cudaSuccess ? cudaGetLastError() : err);
}
