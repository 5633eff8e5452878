// bsr_flat: SSD, SDS, DSS and SSS over an exact work list planned on the
// host (kernels/bsr_flat.py).
//
// Replaces sputnik_tpu/kernels/bsr_flat.py::_flat_kernel (reached from
// ssd_flat, sds_flat, dss_flat and sss_flat). There the TPU walks a 1-D
// grid of steps of `group` items in order, carries an fp32 accumulator in
// VMEM from step to step while the output block stays the same, flushes at
// the run's last step, and zeroes unvisited output blocks in a second XLA
// pass. Here one CTA owns one output block: it reads its run of items from
// per-output item offsets (derived at plan time from the schedule's
// non-decreasing out_ids), skips the flag-0 items (the TPU's group
// padding), accumulates the real ones in fp32 in registers and stores the
// block once. A block with an empty run stores zeros, so the kernel writes
// every output block exactly once and no atomics are needed: the sums are
// bitwise the same from run to run.
//
// What bounds it on the H100: each item reads two 128x128 tiles (64 KB in
// bf16) for 4.2 MFLOP, ~64 FLOP/byte, under the card's ~295 FLOP/byte
// ridge, so it is bound by memory and by how well loads overlap the math.
// The distinct bytes are far fewer than the bytes read (a dense tile is
// read by every output block that needs it), so L2 hits decide. Like
// bsr_dsd.cu this first version stages each k-chunk synchronously through
// static shared memory and uses wmma (bf16) or plain fp32 FMA; cp.async /
// TMA pipelining and wgmma are later work.
#include "bsr_item.cuh"

namespace {

struct FlatParams {
  const void* stream;      // (nnz_stream, 128, 128) blocks of the stream operand
  const void* operand;     // dense (SSD: B, SDS: A) or (nnz_b, 128, 128) blocks
  void* out;               // packed (n_out, 128, 128) or dense (M, N)
  const int* out_offsets;  // (n_out + 1,) item range of each output block
  const int* dep_ids;      // per item
  const int* data_ids;
  const int* other_ids;
  const int* flags;
  int kind;
  int n_blocks_out;  // > 0: dense output with this many tiles per row
  int64_t ld_operand, ld_out;
  int out_f32;
};

template <typename T, bool TA, bool TB>
__global__ void __launch_bounds__(bsr::THREADS) bsr_flat_kernel(FlatParams p) {
  using S = bsr::Smem<T, TA, TB>;
  using TileT = bsr::Tile<T, TA, TB>;
  __shared__ __align__(128) T As[S::A_ELEMS];
  __shared__ __align__(128) T Bs[S::B_ELEMS];
  __shared__ __align__(128) float scratch[TileT::SCRATCH_FLOATS];

  const int o = blockIdx.x;
  const T* stream = static_cast<const T*>(p.stream);
  const T* operand = static_cast<const T*>(p.operand);
  TileT tile;
  tile.zero();
  const int end = p.out_offsets[o + 1];
  for (int i = p.out_offsets[o]; i < end; ++i) {
    if (!p.flags[i]) continue;  // group padding
    bsr::accumulate_item<T, TA, TB>(
        tile, As, Bs, p.kind, stream + int64_t(p.data_ids[i]) * bsr::BS * bsr::BS,
        operand, p.ld_operand, p.dep_ids[i], p.other_ids[i]);
  }
  int64_t c_off;
  if (p.n_blocks_out > 0)
    c_off = int64_t(o / p.n_blocks_out) * bsr::BS * p.ld_out +
            int64_t(o % p.n_blocks_out) * bsr::BS;
  else
    c_off = int64_t(o) * bsr::BS * bsr::BS;
  bsr::store_tile(tile, p.out, c_off, p.ld_out, p.out_f32, scratch);
}

}  // namespace

// kind: 0 SSD, 1 SDS, 2 DSS / SSS (bsr::ItemKind). n_blocks_out > 0 writes
// output block o at tile (o / n_blocks_out, o % n_blocks_out) of a dense
// (M, N) output with row length ld_out; 0 writes packed blocks. Returns
// cudaGetLastError() after the launch.
extern "C" int bsr_flat(const void* stream_blocks, const void* operand, void* out,
                        const void* out_offsets, const void* dep_ids,
                        const void* data_ids, const void* other_ids,
                        const void* flags, int n_out, int kind, int n_blocks_out,
                        long long ld_operand, long long ld_out, int in_f32,
                        int out_f32, int transpose_a, int transpose_b,
                        void* stream) {
  FlatParams p{stream_blocks,
               operand,
               out,
               static_cast<const int*>(out_offsets),
               static_cast<const int*>(dep_ids),
               static_cast<const int*>(data_ids),
               static_cast<const int*>(other_ids),
               static_cast<const int*>(flags),
               kind,
               n_blocks_out,
               ld_operand,
               n_blocks_out > 0 ? ld_out : bsr::BS,
               out_f32};
  if (n_out > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (in_f32)
      BSR_LAUNCH_MODES(bsr_flat_kernel, float, transpose_a, transpose_b, n_out, st, p);
    else
      BSR_LAUNCH_MODES(bsr_flat_kernel, __nv_bfloat16, transpose_a, transpose_b, n_out, st, p);
  }
  return static_cast<int>(cudaGetLastError());
}
