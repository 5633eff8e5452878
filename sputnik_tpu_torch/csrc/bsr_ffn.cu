// bsr_ffn: the fused block-sparse FFN of a MoE layer,
//
//     y[rows of a tile] = sum_j act(x[rows] . W1[:, c_j]) . W2[c_j, :]
//
// over the 128-wide ff blocks c_j of the tile's column run, in two entry
// points that share one kernel:
//
//   bsr_ffn_group     the column run of each group of `rows_per_group`
//                     block-rows comes from a plan (`cols`, f_blocks ids per
//                     group, in any order: a group-structured topology may
//                     permute its expert runs).
//   bsr_ffn_dropless  the expert of each tile of `rows_per_tile` block-rows
//                     is read on the device (`expert_of_tile`), and its
//                     ff blocks are the contiguous e * f_blocks + j; tiles
//                     at or past `*live_tiles` return at once and leave
//                     their output rows unwritten.
//
// Replaces sputnik_tpu/kernels/bsr_ffn.py::_ffn_kernel (the pallas_call at
// :188) and ::_dropless_kernel (:334). The TPU kernels keep a whole group's
// (tile_rows, d_model) fp32 accumulator in VMEM (2 MB at the bench shape)
// and walk the ff chunks on a sequential grid, so every W strip is read
// once and h never leaves VMEM. An SM holds 228 KB of shared memory and
// 256 KB of registers, so here the output is split: one CTA owns 128 rows
// (one block-row) and NT * 128 output columns, keeps their fp32
// accumulators in registers, and loops over the ff blocks itself. For each
// block it computes the 128 x 128 hidden tile h = x . W1[:, c] with the full
// d_model contraction, applies the activation in fp32, rounds h to x's
// dtype into shared memory (the JAX kernels' `act(h).astype(x.dtype)`), and
// adds h . W2[c, n0 : n0 + NT * 128] to its accumulators. h never goes to
// device memory, and the sums are deterministic (no atomics). The price is
// recomputing the first product once per column tile: d_model / (NT * 128)
// times, 4x at d_model 1024 with NT = 2, so a forward does
// (d_model / (NT * 128) + 1) / 2 times the useful FLOP (2.5x at the bench
// shape). Sharing h across a cluster through distributed shared memory
// would remove the recompute; that is later work.
//
// What bounds it on the H100: the tensor-core rate of the synchronous
// pipeline. Chunks of x, W1 and W2 are staged through shared memory with
// no overlap of loads and math (bsr_tile.cuh, as bsr_dsd.cu does); x and
// the W strips are re-read from L2 by the CTAs that share them.
//
// Numerics: bf16 on the tensor cores (nvcuda::wmma 16x16x16, fp32
// accumulate), fp32 in plain FMA without TF32. "gelu" is jax.nn.gelu's
// default tanh form.
#include "bsr_tile.cuh"

namespace {

constexpr int BS = bsr::BS;

enum Act { kGelu = 0, kRelu = 1, kIdentity = 2 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kGelu) {
    // 0.5 v (1 + tanh(sqrt(2 / pi) (v + 0.044715 v^3)))
    const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
    return 0.5f * v * (1.0f + tanhf(u));
  }
  if (act == kRelu) return fmaxf(v, 0.0f);
  return v;
}

struct FfnParams {
  const void* x;               // (n_row_blocks * 128, d_model)
  const void* w1;              // (d_model, ff_total)
  const void* w2;              // (ff_total, d_model)
  const int* cols;             // group: (n_groups * f_blocks,) ff block ids
  const int* expert_of_tile;   // dropless: (n_tiles,) expert of each tile
  const int* live_tiles;       // dropless: device scalar, or null = all live
  void* out;                   // (n_row_blocks * 128, d_model)
  int d_model, ff_total, f_blocks;
  int rows_per_group;          // block-rows per group (per tile, dropless)
  int act, out_f32;
};

constexpr int up128(int bytes) { return (bytes + 127) / 128 * 128; }

// Shared-memory layout: the x / W1 chunk pair of the first product (A, B),
// NT W2 chunks of the second (B2), the activated hidden tile H and the
// per-warp epilogue scratch. Offsets are 128-byte aligned (wmma wants 32).
template <typename T, int NT>
struct Layout {
  using S = bsr::Smem<T, false, false>;
  using TileT = bsr::Tile<T, false, false>;
  static constexpr int LDH = BS + S::PAD;
  static constexpr int A = 0;
  static constexpr int B = A + up128(S::A_ELEMS * int(sizeof(T)));
  static constexpr int B2 = B + up128(S::B_ELEMS * int(sizeof(T)));
  static constexpr int H = B2 + NT * up128(S::B_ELEMS * int(sizeof(T)));
  static constexpr int SCRATCH = H + up128(BS * LDH * int(sizeof(T)));
  static constexpr int BYTES = SCRATCH + up128(TileT::SCRATCH_FLOATS * 4);
  static constexpr int B2_STRIDE = up128(S::B_ELEMS * int(sizeof(T))) / int(sizeof(T));
};

// h = act(tile) rounded to T, into H (128 x 128, row stride LDH).
template <bool TA, bool TB>
__device__ void store_hidden(bsr::Tile<__nv_bfloat16, TA, TB>& tile, __nv_bfloat16* hs,
                             int ldh, int act, float* scratch) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 64;
  float* ws = scratch + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      nvcuda::wmma::store_matrix_sync(ws, tile.acc[i][j], 16, nvcuda::wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = wm + i * 16 + e / 16;
        const int c = wn + j * 16 + e % 16;
        hs[r * ldh + c] = __float2bfloat16(activate(ws[e], act));
      }
      __syncwarp();
    }
}

template <bool TA, bool TB>
__device__ void store_hidden(bsr::Tile<float, TA, TB>& tile, float* hs, int ldh, int act,
                             float*) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      hs[(ty + 16 * i) * ldh + tx + 16 * j] = activate(tile.acc[i][j], act);
}

// Grid: (d_model / (NT * 128), n_row_blocks). One CTA: block-row
// blockIdx.y, output columns [blockIdx.x * NT * 128, + NT * 128).
template <typename T, bool DROPLESS, int NT>
__global__ void __launch_bounds__(bsr::THREADS) bsr_ffn_kernel(FfnParams p) {
  using L = Layout<T, NT>;
  using S = typename L::S;
  using TileT = typename L::TileT;
  extern __shared__ __align__(128) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem + L::A);
  T* Bs = reinterpret_cast<T*>(smem + L::B);
  T* B2s = reinterpret_cast<T*>(smem + L::B2);
  T* Hs = reinterpret_cast<T*>(smem + L::H);
  float* scratch = reinterpret_cast<float*>(smem + L::SCRATCH);

  const int row_block = blockIdx.y;
  const int group = row_block / p.rows_per_group;
  const int* cols = DROPLESS ? nullptr : p.cols + int64_t(group) * p.f_blocks;
  int first_col = 0;
  if (DROPLESS) {
    // A dead tile computes and writes nothing (the whole CTA returns
    // before its first barrier).
    if (p.live_tiles != nullptr && group >= *p.live_tiles) return;
    const int n_experts = p.ff_total / (p.f_blocks * BS);
    // Clamped so that an id out of range reads no memory out of bounds;
    // callers pass ids in [0, n_experts).
    const int e = min(max(p.expert_of_tile[group], 0), n_experts - 1);
    first_col = e * p.f_blocks;
  }
  const int n0 = blockIdx.x * NT * BS;
  const int64_t d = p.d_model;
  const T* x_tile = static_cast<const T*>(p.x) + int64_t(row_block) * BS * d;
  const T* w1 = static_cast<const T*>(p.w1);
  const T* w2 = static_cast<const T*>(p.w2);

  TileT acc[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) acc[t].zero();

  for (int j = 0; j < p.f_blocks; ++j) {
    const int64_t c = DROPLESS ? first_col + j : cols[j];
    // h = x[rows] . W1[:, c * 128 : (c + 1) * 128], full d_model depth.
    TileT h;
    h.zero();
    bsr::accumulate<T, false, false>(h, As, Bs, x_tile, d, w1 + c * BS, p.ff_total, p.d_model);
    // H was last read before the first barrier of the product above.
    store_hidden(h, Hs, L::LDH, p.act, scratch);
    // acc[t] += H . W2[c * 128 : (c + 1) * 128, n0 + t * 128 : + 128]
    const T* w2_rows = w2 + c * BS * d + n0;
    for (int k0 = 0; k0 < BS; k0 += S::KC) {
      __syncthreads();  // H is complete; the previous chunk is consumed
      bsr::copy_tile<T, BS, S::KC>(As, S::LDA, Hs + k0, L::LDH);
#pragma unroll
      for (int t = 0; t < NT; ++t)
        bsr::copy_tile<T, S::KC, BS>(B2s + t * L::B2_STRIDE, S::LDB, w2_rows + k0 * d + t * BS, d);
      __syncthreads();
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[t].mma_chunk(As, B2s + t * L::B2_STRIDE);
    }
  }
  char* out = static_cast<char*>(p.out) +
              (int64_t(row_block) * BS * d + n0) * (p.out_f32 ? 4 : 2);
#pragma unroll
  for (int t = 0; t < NT; ++t)
    acc[t].store(out + int64_t(t) * BS * (p.out_f32 ? 4 : 2), d, 1, p.out_f32, scratch);
}

template <typename T, bool DROPLESS, int NT>
int launch_nt(const FfnParams& p, int n_row_blocks, cudaStream_t st) {
  auto kernel = bsr_ffn_kernel<T, DROPLESS, NT>;
  constexpr int bytes = Layout<T, NT>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_row_blocks > 0 && p.f_blocks > 0)
    kernel<<<dim3(p.d_model / (NT * BS), n_row_blocks), bsr::THREADS, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Two 128-column accumulators per CTA where d_model allows, else one.
template <bool DROPLESS>
int launch(const FfnParams& p, int n_row_blocks, int in_f32, cudaStream_t st) {
  const bool wide = p.d_model % (2 * BS) == 0;
  if (in_f32)
    return wide ? launch_nt<float, DROPLESS, 2>(p, n_row_blocks, st)
                : launch_nt<float, DROPLESS, 1>(p, n_row_blocks, st);
  return wide ? launch_nt<__nv_bfloat16, DROPLESS, 2>(p, n_row_blocks, st)
              : launch_nt<__nv_bfloat16, DROPLESS, 1>(p, n_row_blocks, st);
}

}  // namespace

// Both entry points return cudaGetLastError() after the launch (or the
// error of setting the shared-memory size). d_model and ff_total are
// multiples of 128; x, w1, w2 and out are contiguous and 16-byte aligned;
// act is 0 gelu (tanh form), 1 relu, 2 identity.
extern "C" int bsr_ffn_group(const void* x, const void* w1, const void* w2, const void* cols,
                             void* out, int n_row_blocks, int d_model, int ff_total,
                             int f_blocks, int rows_per_group, int in_f32, int out_f32, int act,
                             void* stream) {
  FfnParams p{x, w1, w2, static_cast<const int*>(cols), nullptr, nullptr, out,
              d_model, ff_total, f_blocks, rows_per_group, act, out_f32};
  return launch<false>(p, n_row_blocks, in_f32, static_cast<cudaStream_t>(stream));
}

extern "C" int bsr_ffn_dropless(const void* x, const void* w1, const void* w2,
                                const void* expert_of_tile, const void* live_tiles, void* out,
                                int n_row_blocks, int d_model, int ff_total, int f_blocks,
                                int rows_per_tile, int in_f32, int out_f32, int act,
                                void* stream) {
  FfnParams p{x, w1, w2, nullptr, static_cast<const int*>(expert_of_tile),
              static_cast<const int*>(live_tiles), out, d_model, ff_total, f_blocks,
              rows_per_tile, act, out_f32};
  return launch<true>(p, n_row_blocks, in_f32, static_cast<cudaStream_t>(stream));
}
