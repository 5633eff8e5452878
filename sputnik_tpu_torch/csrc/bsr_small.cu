// bsr_small_dsd and bsr_small_sdd: DSD (and DDS through it) and SDD at
// block sizes 16, 32 and 64, where a block is smaller than a 128-wide
// output tile.
//
// Replace sputnik_tpu/kernels/bsr_small.py::_small_kernel and
// ::_sdd_small_kernel. On the TPU a grid step packs PACK = 128 / BS blocks
// of one block-row into one depth-128 MXU product, PACK block-rows share
// one (128, n) output tile in VMEM, and padding slots read an appended
// zero block. Here:
//
// * bsr_small_dsd: one CTA per (super-row of PACK block-rows = 128 output
//   rows, 128-column n-tile). It walks the super-row's steps of the host
//   plan (plan_smallblock: steps of up to PACK blocks of one block-row,
//   rows in order), so its range comes from the plan's per-super-row step
//   offsets and nothing is read back. A step stages its PACK blocks as one
//   (BS x 128) A tile and the PACK dense panels its dep ids select as one
//   (128 x 128) B tile, in k-chunks, and adds their product into the
//   (BS x 128) slice of its block-row. The slice is stored once, when the
//   block-row's steps are done; a block-row without steps stores zeros.
//   Padding slots carry the data id nnz and stage zeros for their block.
//   DDS is C^T = dsd(B, A) with flipped flags, stored transposed by the
//   output strides (no extra pass).
// * bsr_small_sdd: one CTA per plan step (plan_sdd_smallblock: up to PACK
//   output blocks of one block-row): the row's (BS x K) A strip against
//   the PACK (BS x K) B strips, K in chunks, each of the PACK (BS x BS)
//   results stored straight into its block's packed slot through the
//   plan's slot -> block map; padding slots store nothing.
//
// All four transpose modes: chunks are staged as stored (16-byte vectors
// along the contiguous axis) and the transpose lives in the fragment
// layout (bf16) or the index math (fp32), as in bsr_tile.cuh. bf16 runs on
// wmma 16x16x16 with fp32 accumulators, each warp owning one 16-column
// strip of the slice; fp32 runs on FMA without TF32.
//
// What bounds it on the H100: a DSD step moves a 32 KB (bf16) B tile for
// BS x 128 x 128 MACs, BS FLOP per byte, far below the ~295 FLOP/byte
// ridge, so it is bound by memory and the latency of the synchronous
// chunk staging; the dense panels of neighbouring steps are served by the
// 50 MB L2 when they repeat. SDD reads BS x K of A and 128 x K of B per
// step, the same ratio. A cp.async / TMA pipeline is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int SUPER = 128;   // packed depth of a DSD step, slice width
constexpr int THREADS = 256;  // 8 warps

template <typename T>
struct Chunk;
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int KC = 32;  // contraction depth staged at a time
  static constexpr int PAD = 8;
};
template <>
struct Chunk<float> {
  static constexpr int KC = 16;
  static constexpr int PAD = 4;
};

// One staged chunk: op(A) (BS x KC) and op(B) (KC x 128), each in its
// stored orientation.
template <typename T, int BS, bool TA, bool TB>
struct Smem {
  static constexpr int KC = Chunk<T>::KC;
  static constexpr int A_ROWS = TA ? KC : BS;
  static constexpr int A_COLS = TA ? BS : KC;
  static constexpr int B_ROWS = TB ? SUPER : KC;
  static constexpr int B_COLS = TB ? KC : SUPER;
  static constexpr int LDA = A_COLS + Chunk<T>::PAD;
  // fp32 with B stored (N, K): the FMA loop reads B down a stored column,
  // so an odd row stride puts the 32 lanes on 32 banks; that chunk is then
  // staged element by element.
  static constexpr bool B_SCALAR = std::is_same<T, float>::value && TB;
  static constexpr int LDB = B_SCALAR ? B_COLS + 1 : B_COLS + Chunk<T>::PAD;
  static constexpr int VB = B_SCALAR ? 1 : 16 / sizeof(T);
  static constexpr int A_ELEMS = A_ROWS * LDA;
  static constexpr int B_ELEMS = B_ROWS * LDB;
};

// Copy a ROWS x COLS tile into shared memory (row stride lds) in vectors of
// V elements: src(r, c) is the global address of element (r, c), or null
// for zeros. The caller's source segments are multiples of V long and
// aligned, so a vector never crosses one.
template <typename T, int ROWS, int COLS, int V, typename Src>
__device__ __forceinline__ void stage(T* __restrict__ s, int lds, Src src) {
  constexpr int VPR = COLS / V;
  for (int v = threadIdx.x; v < ROWS * VPR; v += THREADS) {
    const int r = v / VPR;
    const int c = (v % VPR) * V;
    const T* g = src(r, c);
    if constexpr (V * sizeof(T) == 16) {
      const uint4 x = g ? *reinterpret_cast<const uint4*>(g) : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(s + r * lds + c) = x;
    } else {
      static_assert(V == 1, "scalar staging copies one element");
      s[r * lds + c] = g ? *g : T(0);
    }
  }
}

__device__ __forceinline__ void store_one(void* c, int64_t off, float v, int out_f32) {
  if (out_f32)
    static_cast<float*>(c)[off] = v;
  else
    static_cast<__nv_bfloat16*>(c)[off] = __float2bfloat16(v);
}

// The (BS x 128) output slice, accumulated in fp32 over staged chunks.
template <typename T, int BS, bool TA, bool TB>
struct Slice;

template <int BS, bool TA, bool TB>
struct Slice<__nv_bfloat16, BS, TA, TB> {
  using T = __nv_bfloat16;
  using S = Smem<T, BS, TA, TB>;
  using LayoutA = typename std::conditional<TA, nvcuda::wmma::col_major,
                                            nvcuda::wmma::row_major>::type;
  using LayoutB = typename std::conditional<TB, nvcuda::wmma::col_major,
                                            nvcuda::wmma::row_major>::type;
  static constexpr int FR = BS / 16;  // fragment rows; warp w owns columns 16w..16w+15
  static constexpr int SCRATCH_FLOATS = (THREADS / 32) * 256;

  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[FR];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < FR; ++i) nvcuda::wmma::fill_fragment(acc[i], 0.0f);
  }

  __device__ void mma_chunk(const T* As, const T* Bs) {
    const int n = (threadIdx.x / 32) * 16;
#pragma unroll
    for (int kk = 0; kk < S::KC; kk += 16) {
      nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, T, LayoutB> fb;
      nvcuda::wmma::load_matrix_sync(fb, TB ? Bs + n * S::LDB + kk : Bs + kk * S::LDB + n, S::LDB);
#pragma unroll
      for (int i = 0; i < FR; ++i) {
        nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, T, LayoutA> fa;
        nvcuda::wmma::load_matrix_sync(fa, TA ? As + kk * S::LDA + 16 * i : As + 16 * i * S::LDA + kk,
                                       S::LDA);
        nvcuda::wmma::mma_sync(acc[i], fa, fb, acc[i]);
      }
    }
  }

  // dst(r, c, v) stores slice element (r, c).
  template <typename Dst>
  __device__ void store(Dst dst, float* scratch) {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    float* ws = scratch + warp * 256;
#pragma unroll
    for (int i = 0; i < FR; ++i) {
      nvcuda::wmma::store_matrix_sync(ws, acc[i], 16, nvcuda::wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) dst(16 * i + e / 16, 16 * warp + e % 16, ws[e]);
      __syncwarp();
    }
  }
};

template <int BS, bool TA, bool TB>
struct Slice<float, BS, TA, TB> {
  using T = float;
  using S = Smem<T, BS, TA, TB>;
  static constexpr int RI = BS / 8;  // rows ty + 8 i; columns tx + 32 j
  static constexpr int SCRATCH_FLOATS = 1;

  float acc[RI][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  __device__ void mma_chunk(const T* As, const T* Bs) {
    const int ty = threadIdx.x / 32;
    const int tx = threadIdx.x % 32;
#pragma unroll 4
    for (int k = 0; k < S::KC; ++k) {
      float a[RI], b[4];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int m = ty + 8 * i;
        a[i] = TA ? As[k * S::LDA + m] : As[m * S::LDA + k];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tx + 32 * j;
        b[j] = TB ? Bs[n * S::LDB + k] : Bs[k * S::LDB + n];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  template <typename Dst>
  __device__ void store(Dst dst, float*) {
    const int ty = threadIdx.x / 32;
    const int tx = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dst(ty + 8 * i, tx + 32 * j, acc[i][j]);
  }
};

// ------------------------------------------------------------------- DSD --
struct DsdParams {
  const void* a;             // (nnz, BS, BS) blocks
  const int* super_offsets;  // (n_super + 1,) step range of each super-row
  const int* subs;           // (n_steps,) block-row within the super-row
  const int* deps;           // (n_steps * PACK,) contraction block of each slot
  const int* datas;          // (n_steps * PACK,) block of each slot; nnz = padding
  const void* b;
  void* c;
  int nnz, n_rows;           // blocks, output block-rows
  int64_t ldb, c_row_stride, c_col_stride;
  int out_f32;
};

template <typename T, int BS, bool TA, bool TB>
__global__ void __launch_bounds__(THREADS) bsr_small_dsd_kernel(DsdParams p) {
  using S = Smem<T, BS, TA, TB>;
  using SliceT = Slice<T, BS, TA, TB>;
  constexpr int PACK = SUPER / BS;
  constexpr int V = 16 / sizeof(T);
  __shared__ __align__(128) T As[S::A_ELEMS];
  __shared__ __align__(128) T Bs[S::B_ELEMS];
  __shared__ __align__(128) float scratch[SliceT::SCRATCH_FLOATS];

  const int64_t n0 = int64_t(blockIdx.x) * SUPER;
  const int sup = blockIdx.y;
  const T* a = static_cast<const T*>(p.a);
  const T* b = static_cast<const T*>(p.b);
  int j = p.super_offsets[sup];
  const int j_end = p.super_offsets[sup + 1];
  for (int sub = 0; sub < PACK; ++sub) {
    const int r = sup * PACK + sub;
    if (r >= p.n_rows) break;
    SliceT slice;
    slice.zero();
    for (; j < j_end && p.subs[j] == sub; ++j) {
      const int* deps = p.deps + int64_t(j) * PACK;
      const int* datas = p.datas + int64_t(j) * PACK;
      for (int k0 = 0; k0 < SUPER; k0 += S::KC) {
        __syncthreads();  // the previous chunk is consumed
        // op(A)'s packed columns k0 .. k0 + KC: slot g = k / BS, row or
        // column k % BS of its block (zeros for a padding slot).
        auto a_src = [&](int rr, int c) -> const T* {
          const int k = k0 + (TA ? rr : c);
          const int blk = datas[k / BS];
          if (blk == p.nnz) return nullptr;
          const T* block = a + int64_t(blk) * BS * BS;
          return TA ? block + (k % BS) * BS + c : block + rr * BS + k % BS;
        };
        stage<T, S::A_ROWS, S::A_COLS, V>(As, S::LDA, a_src);
        // op(B)'s rows k0 .. k0 + KC: row k % BS of panel deps[k / BS].
        auto b_src = [&](int rr, int c) -> const T* {
          const int k = k0 + (TB ? c : rr);
          const int64_t kb = int64_t(deps[k / BS]) * BS + k % BS;
          return TB ? b + (n0 + rr) * p.ldb + kb : b + kb * p.ldb + n0 + c;
        };
        stage<T, S::B_ROWS, S::B_COLS, S::VB>(Bs, S::LDB, b_src);
        __syncthreads();
        slice.mma_chunk(As, Bs);
      }
    }
    // Rows r * BS .. r * BS + BS of the output, zeros for a row without steps.
    slice.store(
        [&](int i, int c, float v) {
          store_one(p.c, (int64_t(r) * BS + i) * p.c_row_stride + (n0 + c) * p.c_col_stride, v, p.out_f32);
        },
        scratch);
  }
}

// ------------------------------------------------------------------- SDD --
struct SddParams {
  const void* a;
  const void* b;
  const int* rows;         // (n_steps,) output block-row of each step
  const int* cols;         // (n_steps * PACK,) output block-column of each slot
  const int* slot_blocks;  // (n_steps * PACK,) packed block of each slot; -1 = padding
  void* out;               // (nnz, BS, BS)
  int k;
  int64_t lda, ldb;
  int out_f32;
};

template <typename T, int BS, bool TA, bool TB>
__global__ void __launch_bounds__(THREADS) bsr_small_sdd_kernel(SddParams p) {
  using S = Smem<T, BS, TA, TB>;
  using SliceT = Slice<T, BS, TA, TB>;
  constexpr int PACK = SUPER / BS;
  constexpr int V = 16 / sizeof(T);
  __shared__ __align__(128) T As[S::A_ELEMS];
  __shared__ __align__(128) T Bs[S::B_ELEMS];
  __shared__ __align__(128) float scratch[SliceT::SCRATCH_FLOATS];

  const int64_t step = blockIdx.x;
  const int64_t m0 = int64_t(p.rows[step]) * BS;
  const int* cols = p.cols + step * PACK;
  const T* a = static_cast<const T*>(p.a);
  const T* b = static_cast<const T*>(p.b);

  SliceT slice;
  slice.zero();
  for (int k0 = 0; k0 < p.k; k0 += S::KC) {
    __syncthreads();
    // op(A) rows m0 .. m0 + BS, columns k0 .. k0 + KC (zeros past K).
    auto a_src = [&](int rr, int c) -> const T* {
      const int k = k0 + (TA ? rr : c);
      if (k >= p.k) return nullptr;
      return TA ? a + int64_t(k) * p.lda + m0 + c : a + (m0 + rr) * p.lda + k;
    };
    stage<T, S::A_ROWS, S::A_COLS, V>(As, S::LDA, a_src);
    // op(B) rows k0 .. k0 + KC, packed columns: slot g = n / BS is output
    // block-column cols[g].
    auto b_src = [&](int rr, int c) -> const T* {
      const int k = k0 + (TB ? c : rr);
      if (k >= p.k) return nullptr;
      const int n = TB ? rr : c;
      const int64_t col = int64_t(cols[n / BS]) * BS + n % BS;
      return TB ? b + col * p.ldb + k : b + int64_t(k) * p.ldb + col;
    };
    stage<T, S::B_ROWS, S::B_COLS, S::VB>(Bs, S::LDB, b_src);
    __syncthreads();
    slice.mma_chunk(As, Bs);
  }
  slice.store(
      [&](int i, int c, float v) {
        const int blk = p.slot_blocks[step * PACK + c / BS];
        if (blk >= 0) store_one(p.out, (int64_t(blk) * BS + i) * BS + c % BS, v, p.out_f32);
      },
      scratch);
}

// The kernel for (T, BS, TA, TB) through one switch.
template <template <typename, int, bool, bool> class Launch, typename Params>
void dispatch(const Params& p, dim3 grid, cudaStream_t st, int in_f32, int bs, bool ta, bool tb) {
  auto by_mode = [&](auto tag, auto bs_tag) {
    using T = decltype(tag);
    constexpr int B = decltype(bs_tag)::value;
    if (ta && tb)
      Launch<T, B, true, true>::run(p, grid, st);
    else if (ta)
      Launch<T, B, true, false>::run(p, grid, st);
    else if (tb)
      Launch<T, B, false, true>::run(p, grid, st);
    else
      Launch<T, B, false, false>::run(p, grid, st);
  };
  auto by_bs = [&](auto tag) {
    if (bs == 16)
      by_mode(tag, std::integral_constant<int, 16>{});
    else if (bs == 32)
      by_mode(tag, std::integral_constant<int, 32>{});
    else
      by_mode(tag, std::integral_constant<int, 64>{});
  };
  if (in_f32)
    by_bs(float{});
  else
    by_bs(__nv_bfloat16{});
}

template <typename T, int BS, bool TA, bool TB>
struct DsdLaunch {
  static void run(const DsdParams& p, dim3 grid, cudaStream_t st) {
    bsr_small_dsd_kernel<T, BS, TA, TB><<<grid, THREADS, 0, st>>>(p);
  }
};

template <typename T, int BS, bool TA, bool TB>
struct SddLaunch {
  static void run(const SddParams& p, dim3 grid, cudaStream_t st) {
    bsr_small_sdd_kernel<T, BS, TA, TB><<<grid, THREADS, 0, st>>>(p);
  }
};

}  // namespace

// C = op(A) . op(B) at block size bs (16, 32 or 64): output block-row r,
// column n lands at c[r * bs * c_row_stride + n * c_col_stride]. Grid:
// (n_cols / 128, n_super). Returns cudaGetLastError() after the launch.
extern "C" int bsr_small_dsd(const void* a, const void* super_offsets, const void* subs, const void* deps,
                             const void* datas, const void* b, void* c, int nnz, int n_rows, int n_super,
                             int n_cols, long long ldb, long long c_row_stride, long long c_col_stride, int bs,
                             int in_f32, int out_f32, int transpose_a, int transpose_b, void* stream) {
  DsdParams p{a,
              static_cast<const int*>(super_offsets),
              static_cast<const int*>(subs),
              static_cast<const int*>(deps),
              static_cast<const int*>(datas),
              b,
              c,
              nnz,
              n_rows,
              ldb,
              c_row_stride,
              c_col_stride,
              out_f32};
  if (n_super > 0 && n_cols > 0)
    dispatch<DsdLaunch>(p, dim3(n_cols / SUPER, n_super), static_cast<cudaStream_t>(stream), in_f32, bs,
                        transpose_a, transpose_b);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of op(A) . op(B) at a bs-block topology, one CTA per plan
// step. Returns cudaGetLastError() after the launch.
extern "C" int bsr_small_sdd(const void* a, const void* b, const void* rows, const void* cols,
                             const void* slot_blocks, void* out, int n_steps, int k, long long lda,
                             long long ldb, int bs, int in_f32, int out_f32, int transpose_a, int transpose_b,
                             void* stream) {
  SddParams p{a,
              b,
              static_cast<const int*>(rows),
              static_cast<const int*>(cols),
              static_cast<const int*>(slot_blocks),
              out,
              k,
              lda,
              ldb,
              out_f32};
  if (n_steps > 0)
    dispatch<SddLaunch>(p, dim3(n_steps), static_cast<cudaStream_t>(stream), in_f32, bs, transpose_a,
                        transpose_b);
  return static_cast<int>(cudaGetLastError());
}
