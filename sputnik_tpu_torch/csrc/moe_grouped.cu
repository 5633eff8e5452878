// moe_grouped: the grouped expert products of the capacity-routed MoE FFN
// (models/moe.py::moe_forward, impl "grouped"), forward and backward, on
// Hopper's tensor cores from the bf16 weights where they lie.
//
// Replaces no Pallas kernel: the JAX package computes these products as
// two bf16 einsums with fp32 accumulation (sputnik_tpu/models/moe.py:
// 201-205) and leaves them to XLA. The port had run them as fp32 bmm on
// fp32 copies of every expert's weights (SIMT, ~29 TFLOP/s on the H100);
// a bf16 product is exact in fp32, so the copies bought nothing.
//
// One launch is one grouped GEMM, C[e] = sum_t A_t[e] . B_t[e] over the
// experts e (blockIdx.z), in BM x BN tiles of C[e] (M x N), K in 64-deep
// slices. Each operand is a bf16 matrix in device memory, read in place
// through a 3-d tensor map (terms, rows, columns) whose coordinates move by
// (row step, column step) per expert: expert e's column slab of w1 (d, E F)
// and row slab of w2 (E F, d) are read where they are, with no permuted or
// fp32 copy. Three layouts (KIND):
//   FORWARD      A (M, K) stored K-major, B stored (K, N):
//                h = gelu(x w1[e]), y = h w2[e];
//   DATA_GRAD    A (M, K) K-major in three terms, B stored (N, K):
//                dh = g_y w2[e]^T, dx = g_pre w1[e]^T;
//   WEIGHT_GRAD  A stored (K, M), B stored (K, N) in three terms:
//                dw2[e] = h^T g_y, dw1[e] = x^T g_pre.
// The three terms are the hi / mid / lo bf16 split of an fp32 cotangent
// (split3 below; their sum is the fp32 value exactly: 3 x 8 significand
// bits). Their products accumulate in the same fp32 accumulator, so the
// backward's fp32 x bf16 products are exact up to the order of the fp32
// sum, as the fp32 bmm they replace.
//
// Ragged groups (the dropless top-k MoE, models/moe.py::topk_moe_forward):
// with tile_expert given, the launch is one expert-less grid over every row
// tile of A and C, and each row tile reads the expert of its B from
// tile_expert[blockIdx.y], on the device (a group is padded to whole row
// tiles, so a tile never holds two experts); a tile past the routed rows
// (expert -1) returns at once.
//
// SwiGLU (glu > 0, FORWARD only): B holds each expert's gate columns and,
// glu columns further, its up columns. A CTA's BN columns of B are BN / 2
// gate columns and the same BN / 2 up columns, so the accumulator holds
// both halves of the same outputs, and the SWIGLU epilogue writes the BN / 2
// columns silu(gate) * up of h in bf16.
//
// Epilogues (epi), on the fp32 accumulator staged row-major through shared
// memory, each thread storing 8 consecutive elements:
//   F32        stored as is (y);
//   BF16       rounded to bf16 (dx, dw1, dw2);
//   GELU       gelu-tanh in fp32, then bf16 (h, JAX's gelu(...).astype);
//              where aux is given (training) the fp32 pre-activation too;
//   GELU_GRAD  dh rounded to bf16 (where autograd of the plain version
//              rounds it), times gelu'(pre) read from aux, stored as its
//              three-term split (g_pre, the next products' operand);
//   SWIGLU     silu(gate) * up in fp32, then bf16 (with glu).
//
// What bounds it on the H100: at the MegaBlocks widths (d 768 / 1024, F 4 d,
// 64 experts of 128 slots) a forward product is 2 x 64 x 128 x d x F FLOP
// against the expert's d x F weights read once: 128 FLOP per weight byte,
// under the card's ~295 FLOP/byte ridge, so the weight bytes bound it
// (0.09 ms for w1 of MoE-Small at 3.35 TB/s against 0.04 ms of
// operations). The design follows: every CTA of an expert streams that
// expert's weight slab once per M tile (one M tile at capacity 128), the
// ring keeps 2-4 stages of loads in flight (as many as fit the 227 KB), and
// the tile's N width (chosen by the wrapper from the shapes,
// kernels/moe_grouped.py::plan) keeps the last wave full. The backward's
// split terms share the weight tile of their stage: three products per
// weight byte loaded.
//
// Warp-specialised as bsr_dsd.cu's bf16 path: BM / 64 consumer warpgroups
// each own 64 rows of the tile with the accumulator in registers, one
// producer warp (lane 0) issues the TMA loads of each stage (full / empty
// mbarriers), and a consumer keeps one batch of wgmma in flight while it
// waits for the next stage.
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int BK = 64;                  // k-slice of a stage: one 128-byte swizzle row of bf16
constexpr int BOX = 64;                 // TMA box edge along a 128-byte swizzled axis
constexpr int BOX_BYTES = BOX * BK * 2;
constexpr int SMEM_LIMIT = 232448;      // shared memory a block may take on the H100

enum Kind { FORWARD = 0, DATA_GRAD = 1, WEIGHT_GRAD = 2 };
enum Epi { EPI_F32 = 0, EPI_BF16 = 1, EPI_GELU = 2, EPI_GELU_GRAD = 3, EPI_SWIGLU = 4 };

template <int KIND, int BM, int BN>
struct Cfg {
  static constexpr bool A_MN = KIND == WEIGHT_GRAD;  // A stored (K, M)
  static constexpr bool B_MN = KIND != DATA_GRAD;    // B stored (K, N)
  static constexpr int TERMS_A = KIND == DATA_GRAD ? 3 : 1;
  static constexpr int TERMS_B = KIND == WEIGHT_GRAD ? 3 : 1;
  static constexpr int TERMS = TERMS_A * TERMS_B;
  static constexpr int CONSUMERS = BM / 64;              // consumer warpgroups
  static constexpr int THREADS = CONSUMERS * 128 + 32;   // + one producer warp
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = TERMS_A * A_BYTES + TERMS_B * B_BYTES;  // multiple of 1024
  static constexpr int FIT = (SMEM_LIMIT - 2048) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int EPI_BYTES = 4 * BM * (BN + 4);    // the fp32 tile, rows padded by 4 floats
  static constexpr int SMEM_BYTES = (RING_BYTES > EPI_BYTES ? RING_BYTES : EPI_BYTES) + 1024;  // + alignment
  static_assert(STAGES >= 2, "two stages must fit in shared memory");
};

struct Params {
  int k_iters;              // K / BK
  int a_step0, a_step1;     // per-expert offsets of A's column (0) and row (1) coordinates
  int b_step0, b_step1;
  void* c;                  // (terms, rows, c_ld) output, bf16 or fp32
  float* aux;               // the fp32 pre-activation, addressed as one term of c; may be null for GELU
  long long c_ld, c_expert, c_term;  // in elements
  int epi;
  const int* tile_expert;   // ragged: the expert of B of each row tile (-1: none); null: blockIdx.z
  int glu;                  // SwiGLU: columns from an expert's gate to its up columns in B; 0: none
};

// gelu-tanh and its derivative in fp32, as PyTorch's CUDA kernels compute
// them (ActivationGeluKernel.cu).
constexpr float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kKappa = 0.044715f;

__device__ __forceinline__ float gelu(float x) {
  const float inner = kBeta * (x + kKappa * (x * x * x));
  return 0.5f * x * (1.f + tanhf(inner));
}

__device__ __forceinline__ float gelu_backward(float dy, float x) {
  const float x_sq = x * x;
  const float inner = kBeta * (x + kKappa * (x_sq * x));
  const float th = tanhf(inner);
  const float left = 0.5f * x;
  const float right = 1.f + th;
  const float left_derivative = 0.5f * right;
  const float right_derivative = left * (1.f - th * th) * (kBeta * (1.f + 3.f * kKappa * x_sq));
  return dy * (left_derivative + right_derivative);
}

// g = hi + mid + lo exactly (for |g| from 2^-110, where lo is still a normal
// number, to bf16's largest finite value): each term takes the next 8
// significand bits of what the ones before left (round to nearest), and 24
// bits are all an fp32 value has.
__device__ __forceinline__ void split3(float g, __nv_bfloat16& hi, __nv_bfloat16& mid, __nv_bfloat16& lo) {
  hi = __float2bfloat16(g);
  const float r = g - __bfloat162float(hi);
  mid = __float2bfloat16(r);
  lo = __float2bfloat16(r - __bfloat162float(mid));
}

__device__ __forceinline__ void load8(const float* src, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0], b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const __nv_bfloat16 (&v)[8]) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

// The epilogue of 8 consecutive elements v of C at element offset off.
__device__ __forceinline__ void epilogue8(const Params& p, long long off, float (&v)[8]) {
  __align__(16) __nv_bfloat16 o[3][8];
  if (p.epi == EPI_F32) {
    store8(static_cast<float*>(p.c) + off, v);
    return;
  }
  if (p.epi == EPI_GELU_GRAD) {
    float pre[8];
    load8(p.aux + off, pre);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float dh = __bfloat162float(__float2bfloat16(v[i]));
      split3(gelu_backward(dh, pre[i]), o[0][i], o[1][i], o[2][i]);
    }
    __nv_bfloat16* c = static_cast<__nv_bfloat16*>(p.c) + off;
#pragma unroll
    for (int t = 0; t < 3; ++t) store8(c + t * p.c_term, o[t]);
    return;
  }
  if (p.epi == EPI_GELU) {
    if (p.aux) store8(p.aux + off, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = gelu(v[i]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) o[0][i] = __float2bfloat16(v[i]);
  store8(static_cast<__nv_bfloat16*>(p.c) + off, o[0]);
}

// silu(gate) * up of 8 consecutive outputs, in bf16.
__device__ __forceinline__ void swiglu8(const Params& p, long long off, const float (&g)[8], const float (&u)[8]) {
  __align__(16) __nv_bfloat16 o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = __float2bfloat16(g[i] / (1.f + expf(-g[i])) * u[i]);
  store8(static_cast<__nv_bfloat16*>(p.c) + off, o);
}

template <int KIND, int BM, int BN>
__global__ void __launch_bounds__(Cfg<KIND, BM, BN>::THREADS, 1)
    moe_grouped_kernel(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_b,
                       Params p) {
  using C = Cfg<KIND, BM, BN>;
  constexpr int STAGES = C::STAGES;
  // The expert of B: the grid's, or in a ragged launch the row tile's.
  const int eb = p.tile_expert ? p.tile_expert[blockIdx.y] : static_cast<int>(blockIdx.z);
  if (eb < 0) return;  // a row tile past the routed rows: the whole CTA leaves before any barrier
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled TMA boxes need 1024-byte aligned destinations.
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, ex = blockIdx.z;
  const int nh = blockIdx.x * (BN / 2);  // SwiGLU: the tile's first gate (and up) column, and output column
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], C::CONSUMERS * 4);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == C::CONSUMERS * 4) {
    // ---- producer warp: lane 0 issues every load.
    if (lane == 0) {
      hopper::prefetch_tensormap(&tma_a);
      hopper::prefetch_tensormap(&tma_b);
      const int a0 = ex * p.a_step0, a1 = ex * p.a_step1, b0 = eb * p.b_step0, b1 = eb * p.b_step1;
      for (int it = 0; it < p.k_iters; ++it) {
        const int stage = it % STAGES;
        hopper::mbar_wait(&empty[stage], ((it / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[stage], C::STAGE_BYTES);
        uint8_t* a_s = smem + stage * C::STAGE_BYTES;
        uint8_t* b_s = a_s + C::TERMS_A * C::A_BYTES;
        const int k0 = it * BK;
#pragma unroll
        for (int t = 0; t < C::TERMS_A; ++t) {
          if (C::A_MN) {  // stored (k, m): boxes of 64 m x 64 k, one per consumer warpgroup
#pragma unroll
            for (int w = 0; w < BM / BOX; ++w)
              hopper::tma_load_3d(a_s + t * C::A_BYTES + w * BOX_BYTES, &tma_a, &full[stage], a0 + m0 + w * BOX,
                                  a1 + k0, t);
          } else {        // stored (m, k): one box of 64 k x BM m
            hopper::tma_load_3d(a_s + t * C::A_BYTES, &tma_a, &full[stage], a0 + k0, a1 + m0, t);
          }
        }
#pragma unroll
        for (int t = 0; t < C::TERMS_B; ++t) {
          if (C::B_MN) {  // stored (k, n): boxes of 64 n x 64 k
#pragma unroll
            for (int w = 0; w < BN / BOX; ++w) {
              // SwiGLU: the first half of the boxes from the gate columns, the second from the up columns.
              const int col = !p.glu ? n0 + w * BOX
                                     : (w < BN / BOX / 2 ? nh + w * BOX : p.glu + nh + (w - BN / BOX / 2) * BOX);
              hopper::tma_load_3d(b_s + t * C::B_BYTES + w * BOX_BYTES, &tma_b, &full[stage], b0 + col, b1 + k0, t);
            }
          } else {        // stored (n, k): one box of 64 k x BN n
            hopper::tma_load_3d(b_s + t * C::B_BYTES, &tma_b, &full[stage], b0 + k0, b1 + n0, t);
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
  for (int it = 0; it < p.k_iters; ++it) {
    const int stage = it % STAGES;
    hopper::mbar_wait(&full[stage], (it / STAGES) & 1);
    const uint8_t* a_s = smem + stage * C::STAGE_BYTES + wg * BOX_BYTES;  // this warpgroup's 64 rows
    const uint8_t* b_s = smem + stage * C::STAGE_BYTES + C::TERMS_A * C::A_BYTES;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int t = 0; t < C::TERMS; ++t) {
        const uint8_t* at = a_s + (C::TERMS_A > 1 ? t : 0) * C::A_BYTES;
        const uint8_t* bt = b_s + (C::TERMS_B > 1 ? t : 0) * C::B_BYTES;
        const uint64_t da = C::A_MN ? hopper::desc_sw128(at + kk * 2048, BOX_BYTES, 1024)
                                    : hopper::desc_sw128(at + kk * 32, 16, 1024);
        const uint64_t db = C::B_MN ? hopper::desc_sw128(bt + kk * 2048, BOX_BYTES, 1024)
                                    : hopper::desc_sw128(bt + kk * 32, 16, 1024);
        if constexpr (BN == 256)
          hopper::wgmma_m64n256k16<C::A_MN ? 1 : 0, C::B_MN ? 1 : 0>(acc, da, db);
        else
          hopper::wgmma_m64n128k16<C::A_MN ? 1 : 0, C::B_MN ? 1 : 0>(acc, da, db);
      }
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
      for (int e = 0; e < 4; ++e) tile[(r0 + 8 * (e >> 1)) * (BN + 4) + 8 * i + c0 + (e & 1)] = acc[4 * i + e];
    }
  }
  hopper::named_barrier(1, C::CONSUMERS * 128);
  if (p.glu) {
    const long long base = ex * p.c_expert + static_cast<long long>(m0) * p.c_ld + nh;
    for (int v = threadIdx.x; v < BM * BN / 16; v += C::CONSUMERS * 128) {
      const int r = v / (BN / 16), col = (v % (BN / 16)) * 8;
      float g[8], u[8];
      load8(tile + r * (BN + 4) + col, g);
      load8(tile + r * (BN + 4) + BN / 2 + col, u);
      swiglu8(p, base + static_cast<long long>(r) * p.c_ld + col, g, u);
    }
    return;
  }
  const long long base = ex * p.c_expert + static_cast<long long>(m0) * p.c_ld + n0;
  for (int v = threadIdx.x; v < BM * BN / 8; v += C::CONSUMERS * 128) {
    const int r = v / (BN / 8), col = (v % (BN / 8)) * 8;
    float x[8];
    load8(tile + r * (BN + 4) + col, x);
    epilogue8(p, base + static_cast<long long>(r) * p.c_ld + col, x);
  }
}

__global__ void split3_kernel(const float4* __restrict__ g, uint2* __restrict__ out, long long n4) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n4; i += stride) {
    const float4 v = g[i];
    __align__(8) __nv_bfloat16 t[3][4];
    split3(v.x, t[0][0], t[1][0], t[2][0]);
    split3(v.y, t[0][1], t[1][1], t[2][1]);
    split3(v.z, t[0][2], t[1][2], t[2][2]);
    split3(v.w, t[0][3], t[1][3], t[2][3]);
#pragma unroll
    for (int k = 0; k < 3; ++k) out[k * n4 + i] = *reinterpret_cast<const uint2*>(t[k]);
  }
}

template <int KIND, int BM, int BN>
int launch(const CUtensorMap& a, const CUtensorMap& b, const Params& p, dim3 grid, cudaStream_t st) {
  using C = Cfg<KIND, BM, BN>;
  auto kernel = moe_grouped_kernel<KIND, BM, BN>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  kernel<<<grid, C::THREADS, C::SMEM_BYTES, st>>>(a, b, p);
  return 0;
}

template <int KIND>
int launch_tiles(const CUtensorMap& a, const CUtensorMap& b, const Params& p, dim3 grid, cudaStream_t st, int bm,
                 int bn) {
  if (bm == 64) return bn == 256 ? launch<KIND, 64, 256>(a, b, p, grid, st) : launch<KIND, 64, 128>(a, b, p, grid, st);
  return bn == 256 ? launch<KIND, 128, 256>(a, b, p, grid, st) : launch<KIND, 128, 128>(a, b, p, grid, st);
}

}  // namespace

// One grouped GEMM of layout `kind` (FORWARD 0, DATA_GRAD 1, WEIGHT_GRAD 2)
// over `experts` experts, each M x N x K, in bm x bn tiles (bm 64 / 128, bn
// 128 / 256; M, N, K multiples of bm, bn, 64). Operand X (A or B) is a
// contiguous bf16 (x_terms, x_rows, x_cols) array; expert e's matrix starts
// e * x_step_rows rows and e * x_step_cols columns in. The output's element
// (term t, row r, column j) of expert e is at c[e * c_expert + r * c_ld + j +
// t * c_term]; aux (fp32) is addressed as one term of it. epi: F32 0, BF16 1,
// GELU 2, GELU_GRAD 3, SWIGLU 4. A ragged launch (tile_expert, m / bm int
// entries on the device) takes experts 1 and reads B's expert per row tile.
// SwiGLU (glu > 0, FORWARD, epi SWIGLU) writes n outputs per row from 2 n
// columns of B: outputs j of a tile from gate columns j and up columns
// glu + j; each CTA covers bn / 2 outputs. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a problem the kernel does not
// take or a tensor map the CUDA driver refuses.
extern "C" int moe_grouped_gemm(int kind, int bm, int bn, int experts, int m, int n, int k, const void* a,
                                long long a_terms, long long a_rows, long long a_cols, int a_step_rows,
                                int a_step_cols, const void* b, long long b_terms, long long b_rows,
                                long long b_cols, int b_step_rows, int b_step_cols, void* c, long long c_ld,
                                long long c_expert, long long c_term, void* aux, int epi,
                                const void* tile_expert, int glu, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (kind < FORWARD || kind > WEIGHT_GRAD || epi < EPI_F32 || epi > EPI_SWIGLU) return bad;
  if (!((bm == 64 || bm == 128) && (bn == 128 || bn == 256))) return bad;
  if ((epi == EPI_SWIGLU) != (glu > 0) || (glu && (kind != FORWARD || glu % BOX))) return bad;
  if (tile_expert && experts != 1) return bad;
  const int nb = glu ? bn / 2 : bn;  // outputs a CTA covers
  if (experts < 1 || experts > 65535 || m < bm || m % bm || n < nb || n % nb || k < BK || k % BK) return bad;
  if (m / bm > 65535 || c_ld % 8 || c_expert % 8 || c_term % 8) return bad;
  if (epi == EPI_GELU_GRAD && !aux) return bad;
  const int terms_a = kind == DATA_GRAD ? 3 : 1, terms_b = kind == WEIGHT_GRAD ? 3 : 1;
  if (a_terms != terms_a || b_terms != terms_b) return bad;
  const bool a_mn = kind == WEIGHT_GRAD, b_mn = kind != DATA_GRAD;
  CUtensorMap a_map, b_map;
  if (!hopper::encode(&a_map, a, a_cols, a_rows, a_terms, a_cols, a_cols * a_rows, BOX, a_mn ? BOX : bm)) return bad;
  if (!hopper::encode(&b_map, b, b_cols, b_rows, b_terms, b_cols, b_cols * b_rows, BOX, b_mn ? BOX : bn)) return bad;
  const Params p{k / BK, a_step_cols, a_step_rows, b_step_cols, b_step_rows, c, static_cast<float*>(aux),
                 c_ld, c_expert, c_term, epi, static_cast<const int*>(tile_expert), glu};
  const dim3 grid(n / nb, m / bm, experts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (kind == FORWARD)
    err = launch_tiles<FORWARD>(a_map, b_map, p, grid, st, bm, bn);
  else if (kind == DATA_GRAD)
    err = launch_tiles<DATA_GRAD>(a_map, b_map, p, grid, st, bm, bn);
  else
    err = launch_tiles<WEIGHT_GRAD>(a_map, b_map, p, grid, st, bm, bn);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// out (3, n) bf16 = the three-term split of g (n fp32, n a multiple of 4,
// both 16-byte aligned): out[0] + out[1] + out[2] == g exactly.
extern "C" int moe_split3(const void* g, void* out, long long n, void* stream) {
  if (n % 4) return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = n / 4;
  if (n4 > 0) {
    const long long blocks = (n4 + 255) / 256;
    split3_kernel<<<static_cast<int>(blocks < 2112 ? blocks : 2112), 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(g), static_cast<uint2*>(out), n4);
  }
  return static_cast<int>(cudaGetLastError());
}
