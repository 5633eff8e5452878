// bsr_panel: C = op(A_bsr) . op(B) (DSD) with a full-K panel of the dense
// operand resident in shared memory, and DDS through the same kernel as
// C^T = op(B_bsr)^T . op(A)^T with swapped operands and output strides.
//
// Replaces sputnik_tpu/kernels/bsr_panel.py::_panel_kernel (reached from
// dsd_panel and dds_panel, the registry's pallas_panel). On the TPU a grid
// program owns an output-panel tile of bn columns (bn from _pick_panel_tile:
// 1024 at d = 2048), pins the (K, bn) dense panel in VMEM once (restaged
// k-major when B is stored (N, K), its "klast" layout), and walks the
// sparse blocks group-major through the flat schedule (plan_stream: `group`
// items per grid step, padding flag-masked), flushing its fp32 accumulator
// at the last step of each output block-row; rows with no block are zeroed
// after the call. The dense operand is then read once per output-panel tile
// instead of once per nonzero block.
//
// The H100 has 227 KB of shared memory per CTA, so the panel here is W
// columns wide, the widest of 64 / 32 / 16 / 8 that divides N and fits
// beside the ring (the wrapper asks bsr_panel_smem_bytes): every problem
// JAX's panel_fits admits has K * itemsize <= 16 KB, so W = 8 always fits
// (16 at K = 4096 bf16, 8 at K = 8192). One CTA owns a slab of W output
// columns and a range of output block-rows. It stages its panel
// op(B)[0:K, slab] once, as stored: (K, W) rows for B stored (K, N), W rows
// of K for B stored (N, K), the TPU's klast restage living in the fragment
// layout (wmma col_major). It then walks the schedule items of its rows
// (item offsets per output block-row, derived on the host from the plan's
// non-decreasing out_ids: an output block-row's first and last items are
// JAX's first / last steps), streaming each live item's sparse block in
// k-chunks through a 4-stage cp.async ring (bsr_tile.cuh's chunks: 32 deep
// in bf16, 16 in fp32) and multiplying it by panel rows dep * 128 onward
// from shared memory. Flag-0 padding items issue no copy and compute
// nothing. At an output block-row's last item the 128 x W tile is stored
// once; a row with no item stores zeros from the kernel. No atomics: the
// sums repeat bitwise.
//
// The product: bf16 on wmma with fp32 accumulators held in registers for
// the whole row (W >= 16: eight warps of 16 rows x W; W = 8: four warps of
// 32 rows on m32n8k16 fragments, the other four only copy); fp32 by FMA
// without TF32, thread t owning column t % W of every (256 / W)-th row.
//
// What bounds it on the H100: a narrow panel re-reads every sparse block of
// its rows once per slab, 32 KB (bf16) for 2 * 128 * 128 * W FLOP (W = 16:
// 16 FLOP per staged byte), so the L2 traffic of the blocks bounds it
// (4096^2, 25%, bf16, W = 16: 8 MB x 256 slabs). Splitting the rows into
// ranges fills the card at the price of one panel load per range.
#include "bsr_tile.cuh"
#include "cp_async.cuh"

namespace {

using bsr::BS;
using bsr::THREADS;

constexpr int STAGES = 4;

struct PanelParams {
  const void* a;             // (nnz, 128, 128) sparse blocks
  const int* item_offsets;   // (row_blocks + 1,) schedule items of each output block-row
  const int* dep_ids;        // contraction block of each item
  const int* data_ids;       // block position of each item
  const int* flags;          // 0: a padding item
  const void* b;             // dense operand
  void* c;                   // output
  int k_dim;                 // contraction length (the panel's depth)
  int row_blocks;
  int rows_per_cta;
  int64_t ldb;
  int64_t c_row_stride, c_col_stride;  // of the DSD view's output
  int out_kind;
};

// Shared-memory geometry: the ring of op(A) chunks, the epilogue scratch
// (bf16: one 256-float tile per warp), then the panel.
template <typename T, bool TA, bool TB, int W>
struct Geo {
  using S = bsr::Smem<T, TA, false>;
  static constexpr int KC = S::KC;
  static constexpr size_t RING_BYTES = size_t(STAGES) * S::A_ELEMS * sizeof(T);
  static constexpr size_t SCRATCH_BYTES = sizeof(T) == 2 ? (THREADS / 32) * 256 * sizeof(float) : 0;
  // Panel rows: (K, W) padded by 16 bytes where a bf16 row is 64 bytes or
  // more (bank conflicts of the fragment loads), or (W, K) padded by 16 bytes.
  static constexpr int PAD_NN = (sizeof(T) == 2 && W >= 32) ? 8 : 0;
  static constexpr int PAD_T = 16 / int(sizeof(T));
  static __host__ __device__ int ld_panel(int k_dim) { return TB ? k_dim + PAD_T : W + PAD_NN; }
  static __host__ __device__ size_t panel_elems(int k_dim) {
    return TB ? size_t(W) * ld_panel(k_dim) : size_t(k_dim) * ld_panel(k_dim);
  }
  static __host__ __device__ size_t bytes(int k_dim) {
    return RING_BYTES + SCRATCH_BYTES + panel_elems(k_dim) * sizeof(T);
  }
  static_assert(RING_BYTES % 128 == 0, "the scratch and the panel must stay aligned");
};

// The accumulated 128 x W tile of one output block-row.
template <typename T, bool TA, bool TB, int W, typename Enable = void>
struct Acc;

// bf16, W >= 16: warp w owns rows 16w .. 16w + 15.
template <bool TA, bool TB, int W>
struct Acc<__nv_bfloat16, TA, TB, W, typename std::enable_if<(W >= 16)>::type> {
  using T = __nv_bfloat16;
  using G = Geo<T, TA, TB, W>;
  using LayoutA = typename std::conditional<TA, nvcuda::wmma::col_major, nvcuda::wmma::row_major>::type;
  using LayoutB = typename std::conditional<TB, nvcuda::wmma::col_major, nvcuda::wmma::row_major>::type;
  static constexpr int NF = W / 16;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> c[NF];

  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < NF; ++j) nvcuda::wmma::fill_fragment(c[j], 0.0f);
  }

  // += op(A chunk) . panel rows [kbase, kbase + KC).
  __device__ void mma_chunk(const T* As, const T* panel, int ldp, int kbase) {
    const int m = (threadIdx.x / 32) * 16;
#pragma unroll
    for (int kk = 0; kk < G::KC; kk += 16) {
      nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, T, LayoutA> a;
      nvcuda::wmma::load_matrix_sync(a, TA ? As + kk * G::S::LDA + m : As + m * G::S::LDA + kk, G::S::LDA);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, T, LayoutB> b;
        const T* pb = TB ? panel + int64_t(j * 16) * ldp + kbase + kk : panel + int64_t(kbase + kk) * ldp + j * 16;
        nvcuda::wmma::load_matrix_sync(b, pb, ldp);
        nvcuda::wmma::mma_sync(c[j], a, b, c[j]);
      }
    }
  }

  // Element (r, cc) of the tile goes to out[r * row_stride + cc * col_stride].
  __device__ void store(void* out, int64_t off0, int64_t row_stride, int64_t col_stride, int out_kind,
                        float* scratch) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float* ws = scratch + warp * 256;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      nvcuda::wmma::store_matrix_sync(ws, c[j], 16, nvcuda::wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = warp * 16 + e / 16, cc = j * 16 + e % 16;
        bsr::store_one(out, off0 + r * row_stride + cc * col_stride, ws[e], out_kind);
      }
      __syncwarp();
    }
  }
};

// bf16, W = 8: warps 0..3 own rows 32w .. 32w + 31 on m32n8k16 fragments.
template <bool TA, bool TB, int W>
struct Acc<__nv_bfloat16, TA, TB, W, typename std::enable_if<(W == 8)>::type> {
  using T = __nv_bfloat16;
  using G = Geo<T, TA, TB, W>;
  using LayoutA = typename std::conditional<TA, nvcuda::wmma::col_major, nvcuda::wmma::row_major>::type;
  using LayoutB = typename std::conditional<TB, nvcuda::wmma::col_major, nvcuda::wmma::row_major>::type;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 32, 8, 16, float> c;

  __device__ void zero() { nvcuda::wmma::fill_fragment(c, 0.0f); }

  __device__ void mma_chunk(const T* As, const T* panel, int ldp, int kbase) {
    const int warp = threadIdx.x / 32;
    if (warp >= 4) return;
    const int m = warp * 32;
#pragma unroll
    for (int kk = 0; kk < G::KC; kk += 16) {
      nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 32, 8, 16, T, LayoutA> a;
      nvcuda::wmma::load_matrix_sync(a, TA ? As + kk * G::S::LDA + m : As + m * G::S::LDA + kk, G::S::LDA);
      nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 32, 8, 16, T, LayoutB> b;
      nvcuda::wmma::load_matrix_sync(b, TB ? panel + kbase + kk : panel + int64_t(kbase + kk) * ldp, ldp);
      nvcuda::wmma::mma_sync(c, a, b, c);
    }
  }

  __device__ void store(void* out, int64_t off0, int64_t row_stride, int64_t col_stride, int out_kind,
                        float* scratch) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp >= 4) return;
    float* ws = scratch + warp * 256;
    nvcuda::wmma::store_matrix_sync(ws, c, 8, nvcuda::wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = warp * 32 + e / 8, cc = e % 8;
      bsr::store_one(out, off0 + r * row_stride + cc * col_stride, ws[e], out_kind);
    }
    __syncwarp();
  }
};

// fp32: thread t owns column t % W of rows t / W + RSTEP * i.
template <bool TA, bool TB, int W>
struct Acc<float, TA, TB, W, void> {
  using G = Geo<float, TA, TB, W>;
  static constexpr int RSTEP = THREADS / W;
  static constexpr int NR = BS / RSTEP;
  float v[NR];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < NR; ++i) v[i] = 0.0f;
  }

  __device__ void mma_chunk(const float* As, const float* panel, int ldp, int kbase) {
    const int c = threadIdx.x % W, r0 = threadIdx.x / W;
#pragma unroll 4
    for (int k = 0; k < G::KC; ++k) {
      const float b = TB ? panel[int64_t(c) * ldp + kbase + k] : panel[int64_t(kbase + k) * ldp + c];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int r = r0 + RSTEP * i;
        v[i] = fmaf(TA ? As[k * G::S::LDA + r] : As[r * G::S::LDA + k], b, v[i]);
      }
    }
  }

  __device__ void store(void* out, int64_t off0, int64_t row_stride, int64_t col_stride, int out_kind, float*) {
    const int c = threadIdx.x % W, r0 = threadIdx.x / W;
#pragma unroll
    for (int i = 0; i < NR; ++i)
      bsr::store_one(out, off0 + (r0 + RSTEP * i) * row_stride + c * col_stride, v[i], out_kind);
  }
};

// Grid (N / W slabs, row ranges).
template <typename T, bool TA, bool TB, int W>
__global__ void __launch_bounds__(THREADS) bsr_panel_kernel(PanelParams p) {
  using G = Geo<T, TA, TB, W>;
  using S = typename G::S;
  constexpr int CHUNKS = BS / G::KC;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* scratch = reinterpret_cast<float*>(smem + G::RING_BYTES);
  T* panel = reinterpret_cast<T*>(smem + G::RING_BYTES + G::SCRATCH_BYTES);
  const int ldp = G::ld_panel(p.k_dim);
  const int64_t n0 = int64_t(blockIdx.x) * W;
  const int lo = blockIdx.y * p.rows_per_cta;
  const int hi = min(lo + p.rows_per_cta, p.row_blocks);
  if (lo >= hi) return;
  const T* a = static_cast<const T*>(p.a);
  const T* b = static_cast<const T*>(p.b);

  // The panel op(B)[0:K, n0:n0 + W], as stored, once.
  {
    constexpr int V = 16 / sizeof(T);
    const int rows = TB ? W : p.k_dim;
    const int vpr = (TB ? p.k_dim : W) / V;
    const T* g = TB ? b + n0 * p.ldb : b + n0;
    for (int v = threadIdx.x; v < rows * vpr; v += THREADS) {
      const int r = v / vpr, col = (v % vpr) * V;
      async_copy::cp_async16(panel + int64_t(r) * ldp + col, g + r * p.ldb + col);
    }
    async_copy::cp_async_commit();
  }

  const int item0 = p.item_offsets[lo];
  const int total = (p.item_offsets[hi] - item0) * CHUNKS;  // ring items of the range
  // Issue ring item `it` (schedule item item0 + it / CHUNKS, k-chunk
  // it % CHUNKS) into its stage, then commit: a group is committed for every
  // ring item, empty past the end or for a padding item.
  auto issue = [&](int it) {
    if (it < total) {
      const int item = item0 + it / CHUNKS;
      if (p.flags[item]) {
        const int k0 = (it % CHUNKS) * G::KC;
        const T* blk = a + int64_t(p.data_ids[item]) * BS * BS;
        async_copy::copy_tile_async<T, S::A_ROWS, S::A_COLS, THREADS>(
            ring + (it % STAGES) * S::A_ELEMS, S::LDA, TA ? blk + k0 * BS : blk + k0, BS);
      }
    }
    async_copy::cp_async_commit();
  };

  int row = lo;
  // Store zeros for the rows from `row` on that have no item.
  auto skip_empty = [&]() {
    while (row < hi && p.item_offsets[row + 1] == p.item_offsets[row]) {
      const int64_t off0 = int64_t(row) * BS * p.c_row_stride + n0 * p.c_col_stride;
      const bool by_row = p.c_col_stride == 1;
      for (int e = threadIdx.x; e < BS * W; e += THREADS) {
        const int r = by_row ? e / W : e % BS, cc = by_row ? e % W : e / BS;
        bsr::store_one(p.c, off0 + r * p.c_row_stride + cc * p.c_col_stride, 0.0f, p.out_kind);
      }
      ++row;
    }
  };
  skip_empty();

  Acc<T, TA, TB, W> acc;
  acc.zero();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  for (int it = 0; it < total; ++it) {
    async_copy::cp_async_wait<STAGES - 2>();  // the panel and ring item `it` have landed for this thread
    __syncthreads();                          // ... for every thread; item it-1's stage is free
    issue(it + STAGES - 1);
    const int item = item0 + it / CHUNKS;
    const int chunk = it % CHUNKS;
    if (p.flags[item])
      acc.mma_chunk(ring + (it % STAGES) * S::A_ELEMS, panel, ldp, p.dep_ids[item] * BS + chunk * G::KC);
    if (chunk == CHUNKS - 1 && item + 1 == p.item_offsets[row + 1]) {
      acc.store(p.c, int64_t(row) * BS * p.c_row_stride + n0 * p.c_col_stride, p.c_row_stride, p.c_col_stride,
                p.out_kind, scratch);
      acc.zero();
      ++row;
      skip_empty();
    }
  }
  async_copy::cp_async_wait<0>();
}

template <typename T, bool TA, bool TB, int W>
cudaError_t launch_mode(const PanelParams& p, dim3 grid, cudaStream_t st) {
  const size_t bytes = Geo<T, TA, TB, W>::bytes(p.k_dim);
  cudaError_t err =
      cudaFuncSetAttribute(bsr_panel_kernel<T, TA, TB, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  bsr_panel_kernel<T, TA, TB, W><<<grid, THREADS, bytes, st>>>(p);
  return cudaGetLastError();
}

template <typename T, int W>
cudaError_t launch_width(const PanelParams& p, dim3 grid, cudaStream_t st, bool ta, bool tb) {
  if (ta && tb) return launch_mode<T, true, true, W>(p, grid, st);
  if (ta) return launch_mode<T, true, false, W>(p, grid, st);
  if (tb) return launch_mode<T, false, true, W>(p, grid, st);
  return launch_mode<T, false, false, W>(p, grid, st);
}

template <typename T>
cudaError_t launch(const PanelParams& p, int width, dim3 grid, cudaStream_t st, bool ta, bool tb) {
  switch (width) {
    case 8: return launch_width<T, 8>(p, grid, st, ta, tb);
    case 16: return launch_width<T, 16>(p, grid, st, ta, tb);
    case 32: return launch_width<T, 32>(p, grid, st, ta, tb);
    default: return launch_width<T, 64>(p, grid, st, ta, tb);
  }
}

template <typename T, bool TA>
size_t smem_of(int width, int k_dim, bool tb) {
  switch (width) {
    case 8: return tb ? Geo<T, TA, true, 8>::bytes(k_dim) : Geo<T, TA, false, 8>::bytes(k_dim);
    case 16: return tb ? Geo<T, TA, true, 16>::bytes(k_dim) : Geo<T, TA, false, 16>::bytes(k_dim);
    case 32: return tb ? Geo<T, TA, true, 32>::bytes(k_dim) : Geo<T, TA, false, 32>::bytes(k_dim);
    default: return tb ? Geo<T, TA, true, 64>::bytes(k_dim) : Geo<T, TA, false, 64>::bytes(k_dim);
  }
}

bool valid_width(int width) { return width == 8 || width == 16 || width == 32 || width == 64; }

}  // namespace

// Dynamic shared memory of one CTA at panel width `width` (8, 16, 32 or 64)
// and contraction length k_dim; -1 for another width.
extern "C" long long bsr_panel_smem_bytes(int in_kind, int width, int k_dim, int transpose_a, int transpose_b) {
  if (!valid_width(width)) return -1;
  size_t bytes;
  if (in_kind == 1)
    bytes = transpose_a ? smem_of<float, true>(width, k_dim, transpose_b) : smem_of<float, false>(width, k_dim, transpose_b);
  else
    bytes = transpose_a ? smem_of<__nv_bfloat16, true>(width, k_dim, transpose_b)
                        : smem_of<__nv_bfloat16, false>(width, k_dim, transpose_b);
  return static_cast<long long>(bytes);
}

// DSD view: C'(R, N) = op(S)(R, K) . op(D)(K, N), element (r, n) of C' at
// c[r * c_row_stride + n * c_col_stride]. Output block-row g's schedule
// items are item_offsets[g] .. item_offsets[g + 1] of (dep_ids, data_ids,
// flags). CTAs cover N / width slabs x ceil(R / 128 / rows_per_range) row
// ranges. in_kind: 0 bf16, 1 fp32; out_kind: 0 bf16, 1 fp32. Returns the
// error of the shared-memory attribute call or cudaGetLastError() after the
// launch.
extern "C" int bsr_panel(const void* sparse, const void* item_offsets, const void* dep_ids, const void* data_ids,
                         const void* flags, const void* dense, void* c, int row_blocks, int n_cols, int k_dim,
                         int width, int rows_per_range, long long ld_dense, long long c_row_stride,
                         long long c_col_stride, int in_kind, int out_kind, int transpose_a, int transpose_b,
                         void* stream) {
  if (!valid_width(width) || rows_per_range <= 0 || n_cols % width || k_dim % BS) return int(cudaErrorInvalidValue);
  PanelParams p{sparse,
                static_cast<const int*>(item_offsets),
                static_cast<const int*>(dep_ids),
                static_cast<const int*>(data_ids),
                static_cast<const int*>(flags),
                dense,
                c,
                k_dim,
                row_blocks,
                rows_per_range,
                ld_dense,
                c_row_stride,
                c_col_stride,
                out_kind};
  cudaError_t err = cudaSuccess;
  const int ranges = (row_blocks + rows_per_range - 1) / rows_per_range;
  if (n_cols > 0 && ranges > 0) {
    dim3 grid(n_cols / width, ranges);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    err = in_kind == 1 ? launch<float>(p, width, grid, st, transpose_a, transpose_b)
                       : launch<__nv_bfloat16>(p, width, grid, st, transpose_a, transpose_b);
  }
  return static_cast<int>(err == cudaSuccess ? cudaGetLastError() : err);
}
