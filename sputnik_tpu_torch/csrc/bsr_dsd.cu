// bsr_dsd_stream: C = op(A_bsr) . op(B) (DSD), and DDS through the same
// kernel as C^T = op(B_bsr)^T . op(A)^T with swapped operands and output
// strides.
//
// Replaces sputnik_tpu/kernels/bsr_dsd.py::_stream_kernel (reached from
// dsd and dds). There the TPU grid walks the nonzero blocks in order and
// carries an fp32 accumulator in VMEM from one grid step to the next,
// flushing when the output tile changes, and empty rows are masked after
// the call. Here one CTA owns one output tile and loops over its block-row's
// blocks itself: offsets[g]..offsets[g+1], or the transpose metadata
// (offsets_t / indices_t / block_offsets) for a transposed A. A row with no
// blocks stores zeros from the kernel. The grid's z axis is a batch of
// matrices that share one topology (the heads of an attention layer,
// vmapped in JAX). No block-row is split across CTAs and nothing is
// accumulated with atomics, so every result is bitwise equal from run to
// run.
//
// bf16 operands (bf16 or fp32 output): a TMA ring feeding wgmma
// (hopper.cuh). One CTA owns a BM x BN tile of the output (BM 64 or 128
// rows of one block-row, BN 128 or 256 columns, chosen by the wrapper from
// the shapes, kernels/bsr_dsd.py::stream_plan): BM / 64 consumer
// warpgroups and one producer warp. The producer reads the block-row's
// step list on the device and, per 64-deep half of a block, loads the
// sparse block's (BM x 64) slice and the dense operand's (64 x BN) slice
// by TMA into a ring of STAGES stages (full / empty mbarriers); it issues
// nothing past the row's last step. Each consumer warpgroup runs four
// wgmma m64nBNk16 on an arrived stage, the fp32 accumulator in registers,
// and keeps that batch in flight while it waits for the next stage,
// releasing a stage once the batch after it is issued. Every mode stages
// its tiles as stored: wgmma reads either major-ness of A and B from
// shared memory through the descriptor's transpose bits, so no mode
// restages a tile. The epilogue writes the tile through shared memory in the output's own
// orientation (row-major for DSD, column-major for DDS's C^T), so every
// store is a coalesced 16-byte vector.
//
// What bounds it on the H100: a step reads a 128 x 128 block and a 128 x BN
// slab of B for 2 * 128 * 128 * BN FLOP, 64-85 FLOP per byte moved from L2,
// under the card's ~295 FLOP/byte ridge for device memory but above it
// from L2: at the headline (4096^2, 25%, N 4096: 128 x 256 tiles, ~8 blocks
// a row) the tensor cores and the L2 stream together; at the attention
// shapes (N = d_head = 128, 3-4 blocks a block-row, one 128-wide tile)
// each CTA has 6-8 k-slices to do and latency dominates, which BM = 64
// (twice the CTAs, 128-256 for 132 SMs) and the ring address. Later work:
// a persistent grid whose epilogue overlaps the next tile's loads.
//
// fp32 operands keep the FMA body of bsr_tile.cuh (no TF32: fp32 has no
// tensor-core path that keeps its numbers), int8 its wmma body (an exact
// int32 sum; the flush multiplies by out_scale in fp32, JAX's
// `acc.astype(f32) * out_scale`, and writes bf16, fp32 or the raw int32
// sum). Both stage each k-chunk synchronously through static shared memory.
#include "bsr_tile.cuh"
#include "hopper.cuh"

namespace {

// --------------------------------------------------------- fp32 and int8 --
struct DsdParams {
  const void* a;             // ([batch,] nnz, 128, 128) sparse blocks
  const int* group_offsets;  // (n_groups + 1,) steps of each output block-row
  const int* dep_ids;        // (nnz,) contraction block id of each step
  const int* data_ids;       // (nnz,) block position of each step; null = identity
  const void* b;             // dense operand
  void* c;                   // output
  int64_t ldb;
  int64_t c_row_stride, c_col_stride;
  int64_t a_batch_stride, b_batch_stride, c_batch_stride;  // in elements
  int out_kind;              // bsr::OUT_BF16 / OUT_F32 / OUT_I32
  float out_scale;
};

template <typename T, bool TA, bool TB>
__global__ void __launch_bounds__(bsr::THREADS)
    bsr_dsd_stream_kernel(DsdParams p) {
  using S = bsr::Smem<T, TA, TB>;
  using TileT = bsr::Tile<T, TA, TB>;
  __shared__ __align__(128) T As[S::A_ELEMS];
  __shared__ __align__(128) T Bs[S::B_ELEMS];
  __shared__ __align__(128) float scratch[TileT::SCRATCH_FLOATS];

  const int n0 = blockIdx.x * bsr::BS;
  const int g = blockIdx.y;
  const int64_t z = blockIdx.z;
  const T* a = static_cast<const T*>(p.a) + z * p.a_batch_stride;
  const T* b = static_cast<const T*>(p.b) + z * p.b_batch_stride;

  TileT tile;
  tile.zero();
  const int s_end = p.group_offsets[g + 1];
  for (int s = p.group_offsets[g]; s < s_end; ++s) {
    const int64_t pos = p.data_ids ? p.data_ids[s] : s;
    const int64_t dep = p.dep_ids[s];
    const T* a_tile = a + pos * bsr::BS * bsr::BS;
    const T* b_tile = TB ? b + n0 * p.ldb + dep * bsr::BS
                         : b + dep * bsr::BS * p.ldb + n0;
    bsr::accumulate<T, TA, TB>(tile, As, Bs, a_tile, bsr::BS, b_tile, p.ldb,
                               bsr::BS);
  }
  const int64_t c_off = z * p.c_batch_stride +
                        int64_t(g) * bsr::BS * p.c_row_stride +
                        int64_t(n0) * p.c_col_stride;
  char* c = static_cast<char*>(p.c) + c_off * (p.out_kind == bsr::OUT_BF16 ? 2 : 4);
  tile.store(c, p.c_row_stride, p.c_col_stride, p.out_kind, scratch, p.out_scale);
}

template <typename T>
void launch(const DsdParams& p, dim3 grid, cudaStream_t st, bool ta, bool tb) {
  if (ta && tb)
    bsr_dsd_stream_kernel<T, true, true><<<grid, bsr::THREADS, 0, st>>>(p);
  else if (ta)
    bsr_dsd_stream_kernel<T, true, false><<<grid, bsr::THREADS, 0, st>>>(p);
  else if (tb)
    bsr_dsd_stream_kernel<T, false, true><<<grid, bsr::THREADS, 0, st>>>(p);
  else
    bsr_dsd_stream_kernel<T, false, false><<<grid, bsr::THREADS, 0, st>>>(p);
}

// ------------------------------------------------------ bf16: TMA + wgmma --
constexpr int BK = 64;      // k-slice of a stage: one 128-byte swizzle row of bf16
constexpr int STAGES = 4;   // ring depth
constexpr int BOX = 64;     // TMA box edge along a 128-byte swizzled axis
constexpr int BOX_BYTES = BOX * BK * 2;

template <int BM, int BN>
struct Cfg {
  static constexpr int CONSUMERS = BM / 64;               // consumer warpgroups
  static constexpr int THREADS = CONSUMERS * 128 + 32;    // + one producer warp
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;   // multiple of 1024
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  // The epilogue's fp32 tile, row- or column-major, padded by 4 floats.
  static constexpr int EPI_BYTES = 4 * (BM * (BN + 4) > BN * (BM + 4) ? BM * (BN + 4) : BN * (BM + 4));
  static constexpr int SMEM_BYTES = (RING_BYTES > EPI_BYTES ? RING_BYTES : EPI_BYTES) + 1024;  // + alignment
};

struct WgParams {
  const int* group_offsets;
  const int* dep_ids;
  const int* data_ids;  // null = identity
  void* c;
  int64_t c_row_stride, c_col_stride, c_batch_stride;  // in elements
  int a_blocks_per_z;   // blocks of A per batch entry; 0 when A is shared
  int b_batched;        // the batch index is the B map's third coordinate
  int out_kind;
  float out_scale;
};

// Element (r, c) of the CTA's BM x BN fp32 tile in the epilogue's shared
// memory: row-major when the output's columns are contiguous, else
// column-major.
template <int BM, int BN>
__device__ __forceinline__ int epi_index(bool col_major, int r, int c) {
  return col_major ? c * (BM + 4) + r : r * (BN + 4) + c;
}

template <int BM, int BN, bool TA, bool TB>
__global__ void __launch_bounds__(Cfg<BM, BN>::THREADS, 1)
    bsr_dsd_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_b,
                         WgParams p) {
  using C = Cfg<BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled TMA boxes need 1024-byte aligned destinations.
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];

  const int g = blockIdx.y / (128 / BM);         // block-row
  const int m0 = (blockIdx.y % (128 / BM)) * BM;  // first row of the tile within the block-row
  const int n0 = blockIdx.x * BN;
  const int z = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], C::CONSUMERS * 4);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int s_begin = p.group_offsets[g], s_end = p.group_offsets[g + 1];
  const int iters = 2 * (s_end - s_begin);  // two 64-deep slices of each 128-deep block

  if (warp == C::CONSUMERS * 4) {
    // ---- producer warp: lane 0 issues, the 32 lanes fetch the step list.
    if (lane == 0) {
      hopper::prefetch_tensormap(&tma_a);
      hopper::prefetch_tensormap(&tma_b);
    }
    const int a_base = z * p.a_blocks_per_z;
    const int zb = p.b_batched ? z : 0;
    for (int base = s_begin; base < s_end; base += 32) {
      int pos = 0, dep = 0;
      if (base + lane < s_end) {
        pos = p.data_ids ? p.data_ids[base + lane] : base + lane;
        dep = p.dep_ids[base + lane];
      }
      const int count = min(32, s_end - base);
      for (int j = 0; j < count; ++j) {
        const int blk = a_base + __shfl_sync(0xffffffffu, pos, j);
        const int kb = __shfl_sync(0xffffffffu, dep, j) * 128;
        if (lane == 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int it = 2 * (base - s_begin + j) + h;
            const int stage = it % STAGES;
            hopper::mbar_wait(&empty[stage], ((it / STAGES) & 1) ^ 1);
            hopper::mbar_arrive_expect_tx(&full[stage], C::STAGE_BYTES);
            uint8_t* a_s = smem + stage * C::STAGE_BYTES;
            uint8_t* b_s = a_s + C::A_BYTES;
            const int k0 = h * BK;
            if (TA) {  // stored (k, m): boxes of 64 m x 64 k, one per consumer warpgroup
#pragma unroll
              for (int w = 0; w < BM / BOX; ++w)
                hopper::tma_load_3d(a_s + w * BOX_BYTES, &tma_a, &full[stage], m0 + w * BOX, k0, blk);
            } else {   // stored (m, k): one box of 64 k x BM m
              hopper::tma_load_3d(a_s, &tma_a, &full[stage], k0, m0, blk);
            }
            if (TB) {  // stored (n, k): one box of 64 k x BN n
              hopper::tma_load_3d(b_s, &tma_b, &full[stage], kb + k0, n0, zb);
            } else {   // stored (k, n): boxes of 64 n x 64 k
#pragma unroll
              for (int w = 0; w < BN / BOX; ++w)
                hopper::tma_load_3d(b_s + w * BOX_BYTES, &tma_b, &full[stage], n0 + w * BOX, kb + k0, zb);
            }
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: wg owns rows wg * 64 .. wg * 64 + 63 of the tile.
  const int wg = warp >> 2;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < iters; ++it) {
    const int stage = it % STAGES;
    hopper::mbar_wait(&full[stage], (it / STAGES) & 1);
    const uint8_t* a_s = smem + stage * C::STAGE_BYTES + wg * BOX_BYTES;  // this warpgroup's 64 rows
    const uint8_t* b_s = smem + stage * C::STAGE_BYTES + C::A_BYTES;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = TA ? hopper::desc_sw128(a_s + kk * 2048, BOX_BYTES, 1024)
                             : hopper::desc_sw128(a_s + kk * 32, 16, 1024);
      const uint64_t db = TB ? hopper::desc_sw128(b_s + kk * 32, 16, 1024)
                             : hopper::desc_sw128(b_s + kk * 2048, BOX_BYTES, 1024);
      if constexpr (BN == 256)
        hopper::wgmma_m64n256k16<TA ? 1 : 0, TB ? 0 : 1>(acc, da, db);
      else
        hopper::wgmma_m64n128k16<TA ? 1 : 0, TB ? 0 : 1>(acc, da, db);
    }
    hopper::wgmma_commit();
    // Keep this batch in flight; the previous one is done, so its stage is free.
    hopper::wgmma_wait<1>();
    hopper::fence_regs(acc);
    __syncwarp();
    if (it > 0 && lane == 0) hopper::mbar_arrive(&empty[(it + STAGES - 1) % STAGES]);
  }
  hopper::wgmma_wait<0>();  // the last stage needs no release: nothing more is loaded
  hopper::fence_regs(acc);

  // ---- epilogue: every consumer is past its last product, and the producer
  // issued nothing past the last stage, so the ring is free for the tile.
  hopper::named_barrier(1, C::CONSUMERS * 128);
  hopper::fence_proxy_async();
  const bool col_major = p.c_row_stride == 1;
  float* tile = reinterpret_cast<float*>(smem);
  {
    // wgmma's accumulator layout: register 4i + e of thread t holds row
    // 16 (t / 32) + (t % 32) / 4 + 8 (e / 2), column 8i + 2 (t % 4) + e % 2.
    const int t = threadIdx.x & 127;
    const int r0 = wg * 64 + (t >> 5) * 16 + ((t & 31) >> 2);
    const int c0 = 2 * (t & 3);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 8 * (e >> 1), c = 8 * i + c0 + (e & 1);
        tile[epi_index<BM, BN>(col_major, r, c)] = acc[4 * i + e] * p.out_scale;
      }
    }
  }
  hopper::named_barrier(1, C::CONSUMERS * 128);
  const bool bf16_out = p.out_kind == bsr::OUT_BF16;
  const int vec = bf16_out ? 8 : 4;  // elements per 16-byte store
  const int inner = col_major ? BM : BN, outer = col_major ? BN : BM;
  const int64_t row0 = int64_t(g) * 128 + m0;
  const int64_t c_base = int64_t(z) * p.c_batch_stride + row0 * p.c_row_stride + int64_t(n0) * p.c_col_stride;
  for (int v = threadIdx.x; v < inner * outer / vec; v += C::CONSUMERS * 128) {
    const int o = v / (inner / vec), in0 = (v % (inner / vec)) * vec;
    const float* src = tile + (col_major ? o * (BM + 4) : o * (BN + 4)) + in0;
    // (o, in0) is (column, row) of the tile when column-major, else (row, column).
    const int64_t off = c_base + (col_major ? int64_t(o) * p.c_col_stride + in0
                                            : int64_t(o) * p.c_row_stride + in0);
    if (bf16_out) {
      __align__(16) __nv_bfloat16 out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e] = __float2bfloat16(src[e]);
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.c) + off) = *reinterpret_cast<const uint4*>(out);
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(p.c) + off) = *reinterpret_cast<const float4*>(src);
    }
  }
}

template <int BM, int BN, bool TA, bool TB>
int wgmma_launch(const CUtensorMap& ta_map, const CUtensorMap& tb_map, const WgParams& p, dim3 grid,
                 cudaStream_t st) {
  using C = Cfg<BM, BN>;
  auto kernel = bsr_dsd_wgmma_kernel<BM, BN, TA, TB>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  kernel<<<grid, C::THREADS, C::SMEM_BYTES, st>>>(ta_map, tb_map, p);
  return 0;
}

template <int BM, int BN>
int wgmma_modes(const CUtensorMap& a, const CUtensorMap& b, const WgParams& p, dim3 grid, cudaStream_t st,
                bool ta, bool tb) {
  if (ta && tb) return wgmma_launch<BM, BN, true, true>(a, b, p, grid, st);
  if (ta) return wgmma_launch<BM, BN, true, false>(a, b, p, grid, st);
  if (tb) return wgmma_launch<BM, BN, false, true>(a, b, p, grid, st);
  return wgmma_launch<BM, BN, false, false>(a, b, p, grid, st);
}

// The bf16 path: encodes the two tensor maps with the boxes the wrapper
// chose (checked against the tile they must fill) and launches the (bm, bn)
// kernel. Returns a cudaError_t value (cudaErrorInvalidValue for a plan the
// kernel does not have or a map the CUDA driver refuses).
int launch_bf16(const DsdParams& p, int n_groups, int n_cols, int batch, int nnz, int k_dim, int bm, int bn,
                int a_box0, int a_box1, int b_box0, int b_box1, bool ta, bool tb, cudaStream_t st) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (!((bm == 64 || bm == 128) && (bn == 128 || bn == 256) && n_cols % bn == 0)) return bad;
  if (a_box0 != BOX || a_box1 != (ta ? BOX : bm) || b_box0 != BOX || b_box1 != (tb ? bn : BOX)) return bad;
  const bool a_batched = p.a_batch_stride != 0, b_batched = p.b_batch_stride != 0;
  CUtensorMap a_map, b_map;
  // The sparse data: (blocks, 128, 128), all batch entries' blocks in a row.
  const uint64_t blocks = uint64_t(nnz) * (a_batched ? batch : 1);
  if (!hopper::encode(&a_map, p.a, 128, 128, blocks, 128, 128 * 128, a_box0, a_box1)) return bad;
  // The dense operand as stored: (batch, K, N) or, transposed, (batch, N, K).
  const uint64_t inner = tb ? k_dim : n_cols, outer = tb ? n_cols : k_dim;
  const uint64_t b_stride2 = b_batched ? uint64_t(p.b_batch_stride) : uint64_t(p.ldb) * outer;
  if (!hopper::encode(&b_map, p.b, inner, outer, b_batched ? batch : 1, p.ldb, b_stride2, b_box0, b_box1)) return bad;
  const WgParams wp{p.group_offsets, p.dep_ids, p.data_ids, p.c, p.c_row_stride, p.c_col_stride,
                    p.c_batch_stride, a_batched ? nnz : 0, b_batched ? 1 : 0, p.out_kind, p.out_scale};
  const dim3 grid(n_cols / bn, n_groups * (128 / bm), batch);
  if (bm == 64)
    return bn == 256 ? wgmma_modes<64, 256>(a_map, b_map, wp, grid, st, ta, tb)
                     : wgmma_modes<64, 128>(a_map, b_map, wp, grid, st, ta, tb);
  return bn == 256 ? wgmma_modes<128, 256>(a_map, b_map, wp, grid, st, ta, tb)
                   : wgmma_modes<128, 128>(a_map, b_map, wp, grid, st, ta, tb);
}

}  // namespace

// Output block-row g, column n of op(A) . op(B) lands at
// c[g * 128 * c_row_stride + n * c_col_stride] (plus the batch offset).
// in_kind: 0 bf16, 1 fp32, 2 int8; out_kind: 0 bf16, 1 fp32, 2 int32.
// nnz: blocks per batch entry of A; k_dim: the contraction length. bm, bn
// and the two TMA boxes (innermost first) are the bf16 path's plan
// (kernels/bsr_dsd.py::stream_plan); the other paths ignore them.
// Returns cudaGetLastError() after the launch, or the error of preparing it.
extern "C" int bsr_dsd_stream(const void* a, const void* group_offsets,
                              const void* dep_ids, const void* data_ids,
                              const void* b, void* c, int n_groups, int n_cols,
                              int batch, long long ldb, long long c_row_stride,
                              long long c_col_stride, long long a_batch_stride,
                              long long b_batch_stride,
                              long long c_batch_stride, int nnz, int k_dim, int bm, int bn,
                              int a_box0, int a_box1, int b_box0, int b_box1,
                              int in_kind, int out_kind,
                              float out_scale, int transpose_a, int transpose_b,
                              void* stream) {
  DsdParams p{a,
              static_cast<const int*>(group_offsets),
              static_cast<const int*>(dep_ids),
              static_cast<const int*>(data_ids),
              b,
              c,
              ldb,
              c_row_stride,
              c_col_stride,
              a_batch_stride,
              b_batch_stride,
              c_batch_stride,
              out_kind,
              out_scale};
  if (n_groups > 0 && n_cols > 0 && batch > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (in_kind == 0) {
      const int err = launch_bf16(p, n_groups, n_cols, batch, nnz, k_dim, bm, bn, a_box0, a_box1, b_box0,
                                  b_box1, transpose_a, transpose_b, st);
      if (err) return err;
    } else {
      dim3 grid(n_cols / bsr::BS, n_groups, batch);
      if (in_kind == 2)
        launch<signed char>(p, grid, st, transpose_a, transpose_b);
      else
        launch<float>(p, grid, st, transpose_a, transpose_b);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
