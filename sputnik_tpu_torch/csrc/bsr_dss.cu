// DSS (dense = sparse . sparse) on metadata that is not planned on the
// host: two kernels.
//
// bsr_dss_masked replaces sputnik_tpu/kernels/bsr_dss.py::_dss_kernel
// (reached from dss). There the TPU grid is (m_blocks, n_blocks,
// max_steps): each step fetches op(A) row m's next block and op(B)'s block
// at (k, n) through a dense position map, masks the step when that block
// is absent or past the row's extent, and carries an fp32 accumulator
// across the step axis. Here one CTA owns one (m, n) tile and walks op(A)
// row m itself (offsets / indices, or the transpose metadata for a
// transposed A; capped at max_steps as the TPU grid is), looks each k up
// in op(B)'s position map and skips the -1 entries: absent blocks cost a
// load of one int, not a tile product. The tile is stored once, zeros when
// nothing matched.
//
// bsr_dss_worklist replaces sputnik_tpu/kernels/bsr_dss.py::_worklist_kernel
// (reached from dss_worklist). The intersection is enumerated on the
// device by torch ops (kernels/bsr_dss.py::build_dss_worklist) into a list
// of W items sorted by output tile, W a static bound from the nnz hints;
// dead slots past the true total carry the last real item's tile and
// flag 0. There the TPU walks the list in order and flushes at each run's
// last item, then masks unvisited tiles in a second XLA pass. Here CTA t
// of the first W returns at once unless item t starts its tile's run; a
// run's first CTA walks forward while the tile is unchanged and adds the
// flag-1 items, so the forward-filled dead slots neither end a run early
// nor write twice. The last n_tiles CTAs each store zeros in one tile that
// no item visits. Nothing reads the card back.
//
// Neither kernel uses atomics: every tile is written by one CTA, bitwise
// the same from run to run. What bounds them on the H100 is what bounds
// bsr_flat.cu: ~64 FLOP per byte read per product, memory and load/math
// overlap; bsr_dss_masked also pays a position-map probe per op(A) block
// and (m, n) tile, and bsr_dss_worklist one CTA per list slot.
#include "bsr_item.cuh"

namespace {

struct MaskedParams {
  const void* a;        // (nnz_a, 128, 128)
  const void* b;        // (nnz_b, 128, 128)
  void* out;            // (M, N)
  const int* a_offs;    // (m_blocks + 1,) op(A) row offsets
  const int* a_dep;     // (nnz_a,) k of each op(A) block, iteration order
  const int* a_data;    // (nnz_a,) block position, iteration order; null = identity
  const int* b_pos;     // op(B)'s (k, n) block: b_pos[k * pos_k + n * pos_n], or -1
  int max_steps;
  int64_t pos_k, pos_n;
  int64_t ld_out;
  int out_f32;
};

template <typename T, bool TA, bool TB>
__global__ void __launch_bounds__(bsr::THREADS)
    bsr_dss_masked_kernel(MaskedParams p) {
  using S = bsr::Smem<T, TA, TB>;
  using TileT = bsr::Tile<T, TA, TB>;
  __shared__ __align__(128) T As[S::A_ELEMS];
  __shared__ __align__(128) T Bs[S::B_ELEMS];
  __shared__ __align__(128) float scratch[TileT::SCRATCH_FLOATS];

  const int n = blockIdx.x;
  const int m = blockIdx.y;
  const T* a = static_cast<const T*>(p.a);
  const T* b = static_cast<const T*>(p.b);
  TileT tile;
  tile.zero();
  const int start = p.a_offs[m];
  const int end = start + min(p.a_offs[m + 1] - start, p.max_steps);
  for (int s = start; s < end; ++s) {
    const int bp = p.b_pos[p.a_dep[s] * p.pos_k + n * p.pos_n];
    if (bp < 0) continue;
    const int64_t ap = p.a_data ? p.a_data[s] : s;
    bsr::accumulate_item<T, TA, TB>(tile, As, Bs, bsr::ITEM_BLOCKS,
                                    a + ap * bsr::BS * bsr::BS, b, bsr::BS, bp, 0);
  }
  bsr::store_tile(tile, p.out,
                  int64_t(m) * bsr::BS * p.ld_out + int64_t(n) * bsr::BS,
                  p.ld_out, p.out_f32, scratch);
}

struct WorklistParams {
  const void* a;
  const void* b;
  void* out;                     // (M, N)
  const int* out_sorted;         // (W,) output tile of each item, non-decreasing
  const int* a_ids;              // (W,) A block of each item
  const int* b_ids;              // (W,) B block of each item
  const int* flags;              // (W,) 1 = real item
  const unsigned char* visited;  // (n_tiles,) tile has a real item
  int w;
  int n_blocks;
  int64_t ld_out;
  int out_f32;
};

template <typename T, bool TA, bool TB>
__global__ void __launch_bounds__(bsr::THREADS)
    bsr_dss_worklist_kernel(WorklistParams p) {
  using S = bsr::Smem<T, TA, TB>;
  using TileT = bsr::Tile<T, TA, TB>;
  __shared__ __align__(128) T As[S::A_ELEMS];
  __shared__ __align__(128) T Bs[S::B_ELEMS];
  __shared__ __align__(128) float scratch[TileT::SCRATCH_FLOATS];

  const int t = blockIdx.x;
  int o;
  TileT tile;
  tile.zero();
  if (t < p.w) {
    o = p.out_sorted[t];
    // Only the first item of a visited tile's run computes it.
    if ((t > 0 && p.out_sorted[t - 1] == o) || !p.visited[o]) return;
    const T* a = static_cast<const T*>(p.a);
    const T* b = static_cast<const T*>(p.b);
    for (int u = t; u < p.w && p.out_sorted[u] == o; ++u) {
      if (!p.flags[u]) continue;  // a dead slot past the true total
      bsr::accumulate_item<T, TA, TB>(tile, As, Bs, bsr::ITEM_BLOCKS,
                                      a + int64_t(p.a_ids[u]) * bsr::BS * bsr::BS,
                                      b, bsr::BS, p.b_ids[u], 0);
    }
  } else {
    o = t - p.w;  // the zero-fill CTAs: one per tile, for unvisited tiles
    if (p.visited[o]) return;
  }
  bsr::store_tile(tile, p.out,
                  int64_t(o / p.n_blocks) * bsr::BS * p.ld_out +
                      int64_t(o % p.n_blocks) * bsr::BS,
                  p.ld_out, p.out_f32, scratch);
}

}  // namespace

// out is the dense (m_blocks * 128, n_blocks * 128) result with row length
// ld_out. Each returns cudaGetLastError() after the launch.
extern "C" int bsr_dss_masked(const void* a, const void* b, void* out,
                              const void* a_offs, const void* a_dep,
                              const void* a_data, const void* b_pos,
                              int m_blocks, int n_blocks, int max_steps,
                              long long pos_k, long long pos_n, long long ld_out,
                              int in_f32, int out_f32, int transpose_a,
                              int transpose_b, void* stream) {
  MaskedParams p{a, b, out,
                 static_cast<const int*>(a_offs),
                 static_cast<const int*>(a_dep),
                 static_cast<const int*>(a_data),
                 static_cast<const int*>(b_pos),
                 max_steps, pos_k, pos_n, ld_out, out_f32};
  if (m_blocks > 0 && n_blocks > 0) {
    dim3 grid(n_blocks, m_blocks);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (in_f32)
      BSR_LAUNCH_MODES(bsr_dss_masked_kernel, float, transpose_a, transpose_b, grid, st, p);
    else
      BSR_LAUNCH_MODES(bsr_dss_masked_kernel, __nv_bfloat16, transpose_a, transpose_b, grid, st, p);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bsr_dss_worklist(const void* a, const void* b, void* out,
                                const void* out_sorted, const void* a_ids,
                                const void* b_ids, const void* flags,
                                const void* visited, int w, int m_blocks,
                                int n_blocks, long long ld_out, int in_f32,
                                int out_f32, int transpose_a, int transpose_b,
                                void* stream) {
  WorklistParams p{a, b, out,
                   static_cast<const int*>(out_sorted),
                   static_cast<const int*>(a_ids),
                   static_cast<const int*>(b_ids),
                   static_cast<const int*>(flags),
                   static_cast<const unsigned char*>(visited),
                   w, n_blocks, ld_out, out_f32};
  const long long ctas = static_cast<long long>(w) + static_cast<long long>(m_blocks) * n_blocks;
  if (m_blocks > 0 && n_blocks > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const unsigned int grid = static_cast<unsigned int>(ctas);
    if (in_f32)
      BSR_LAUNCH_MODES(bsr_dss_worklist_kernel, float, transpose_a, transpose_b, grid, st, p);
    else
      BSR_LAUNCH_MODES(bsr_dss_worklist_kernel, __nv_bfloat16, transpose_a, transpose_b, grid, st, p);
  }
  return static_cast<int>(cudaGetLastError());
}
