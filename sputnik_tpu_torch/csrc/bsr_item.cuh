// One work item of the sparse-output and sparse x sparse kernels
// (bsr_flat.cu, bsr_ssd.cu, bsr_dss.cu): op(A) . op(B) of two 128x128
// tiles, accumulated into a bsr::Tile. What the two tiles are depends on
// the op:
//
//   SSD     op(A) = a stream block,        op(B) = the dense tile (k, n) of B
//   SDS     op(A) = the dense tile (m, k)  op(B) = a stream block
//   BLOCKS  op(A) = a block of A,          op(B) = a block of B  (DSS, SSS)
//
// A dense operand is contiguous with row length ld; "transposed" means it
// is stored (N, K) for B or (K, M) for A, as in bsr_tile.cuh.
#pragma once

#include "bsr_tile.cuh"

namespace bsr {

enum ItemKind : int { ITEM_SSD = 0, ITEM_SDS = 1, ITEM_BLOCKS = 2 };

// Accumulate one item into `tile`: the stream block `blk`; `dep` is the
// contraction block id (SSD, SDS) or B's block index (BLOCKS); `other` is
// the output block's other coordinate (n for SSD, m for SDS).
template <typename T, bool TA, bool TB>
__device__ __forceinline__ void accumulate_item(Tile<T, TA, TB>& tile, T* As,
                                                T* Bs, int kind, const T* blk,
                                                const T* operand, int64_t ld,
                                                int64_t dep, int64_t other) {
  const T* a_tile = blk;
  const T* b_tile = operand + dep * BS * BS;
  int64_t lda = BS, ldb = BS;
  if (kind == ITEM_SSD) {
    b_tile = TB ? operand + other * BS * ld + dep * BS
                : operand + dep * BS * ld + other * BS;
    ldb = ld;
  } else if (kind == ITEM_SDS) {
    a_tile = TA ? operand + dep * BS * ld + other * BS
                : operand + other * BS * ld + dep * BS;
    lda = ld;
    b_tile = blk;
  }
  accumulate<T, TA, TB>(tile, As, Bs, a_tile, lda, b_tile, ldb, BS);
}

// Store a finished tile of the output type at c (element offset c_off).
template <typename T, bool TA, bool TB>
__device__ __forceinline__ void store_tile(Tile<T, TA, TB>& tile, void* c,
                                           int64_t c_off, int64_t ld_c,
                                           bool out_f32, float* scratch) {
  char* p = static_cast<char*>(c) + c_off * (out_f32 ? 4 : 2);
  tile.store(p, ld_c, 1, out_f32, scratch);
}

}  // namespace bsr

// Instantiate KERNEL<T, TA, TB> for the four transpose modes and launch it
// with `grid` and the arguments that follow.
#define BSR_LAUNCH_MODES(KERNEL, T, ta, tb, grid, st, ...)                 \
  do {                                                                     \
    if ((ta) && (tb))                                                      \
      KERNEL<T, true, true><<<(grid), bsr::THREADS, 0, (st)>>>(__VA_ARGS__); \
    else if (ta)                                                           \
      KERNEL<T, true, false><<<(grid), bsr::THREADS, 0, (st)>>>(__VA_ARGS__); \
    else if (tb)                                                           \
      KERNEL<T, false, true><<<(grid), bsr::THREADS, 0, (st)>>>(__VA_ARGS__); \
    else                                                                   \
      KERNEL<T, false, false><<<(grid), bsr::THREADS, 0, (st)>>>(__VA_ARGS__); \
  } while (0)
