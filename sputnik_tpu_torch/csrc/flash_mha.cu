// flash_mha: fused block-sparse multi-head attention with its flash-2
// backward. Three kernels, one per pass:
//
//   flash_mha_fwd  out = softmax(Q K^T * scale, masked to the topology) V,
//                  and lse = m + log(l) per query row (fp32).
//   flash_mha_dq   dQ = scale * sum_blocks dS K, dS = P (dO V^T - dvec),
//                  P = exp(S - lse), walking each query block-row's blocks.
//   flash_mha_dkv  dV = sum P^T dO, dK = scale * sum dS^T Q, walking each key
//                  block-column's blocks through the transpose metadata.
//
// Replaces sputnik_tpu/kernels/flash_mha.py::_fwd_kernel (the pallas_call
// at :240), ::_dq_kernel (:419) and ::_dkv_kernel (:450). The TPU kernels
// run a sequential grid over a host plan of row strips (rows_per_step
// query block-rows sharing the union of their columns, `group` columns per
// step) and carry the running max, sum and accumulator in VMEM from one
// grid step to the next. GPU blocks run in no order, so here each CTA owns
// one output tile and loops over its blocks itself, with the running state
// in registers: no plan, no cross-CTA reduction, no atomics (dK / dV are
// deterministic), and an empty row or column stores zeros because its loop
// runs zero times.
//
// Head dim: a template parameter (DH), instantiated at every multiple of 16
// up to 128 (the repo's configs use 64 and 128); the largest, 128 in fp32,
// takes 135 KB of shared memory in the forward.
//
// Tiles: a CTA owns 64 query rows (fwd, dQ: half of a 128 query block,
// walking 128-key blocks) or 64 keys (dK/dV: half of a key block, walking
// the column's query blocks in two 64-row halves). 8 warps. Operand tiles
// are staged synchronously in dynamic shared memory (above the 48 KB static
// limit), the score and dP tiles are kept in fp32 shared memory for the
// row-wise softmax work.
//
// Numerics follow the JAX kernels: scores in fp32, masked to the finite
// -1e30 (never -inf, so a fully masked row gives p = 0 and not NaN),
// p = 0 where s <= -5e29, lse = +1e30 for a row with no mass; p is cast to
// the value dtype before P V, dS to the key dtype before dS K, p to dO's
// dtype before P^T dO and dS to Q's dtype before dS^T Q. bf16 runs on the
// tensor cores (nvcuda::wmma 16x16x16, fp32 accumulate), which gives the
// same products as JAX's fp32 copies of bf16 dO and V for dP; fp32 runs in
// plain FMA with no TF32.
//
// What bounds it on the H100: per 64x128 query tile and 128-key block the
// forward does 2 * 2 * 64 * 128 * 128 FLOP against 64 KB of K and V (bf16),
// 64 FLOP/byte; L2 serves the K/V blocks that neighbouring tiles share.
// This first version does not overlap loads with math (no cp.async / TMA
// pipeline, wmma rather than wgmma), so it is bound by load latency.
//
// flash_mha_fwd_wgmma replaces that forward for bf16 at head dim 128, the
// prefill attention of a model with 128-wide heads (Mellum2), where it is
// also the unfused chain's replacement (models/attention.py: SDD, the
// softmax and DSD wrote and re-read every score block in device memory).
// At a 16k prompt a full layer is 2.2 TFLOP against ~70 MB of q, k, v and
// out, ~30,000 FLOP a byte, so it is bound by operations, and what holds it
// back is keeping the tensor cores fed: one CTA owns a 128-row query tile
// of one head, two consumer warpgroups of 64 rows and one producer warp.
// The producer TMA-loads Q once and keeps a ring of K and V tiles in flight
// (separate barriers, so Q K^T starts before V lands), walking the row's
// block-columns on the device. A consumer runs S = Q K^T as wgmma into fp32
// registers, masks only the blocks the causal diagonal or the window's
// first block cut, keeps the softmax online with the scale folded into
// exp2, rounds P to bf16 in registers and feeds it as the register A
// operand of P V: no score leaves the chip. While one warpgroup is in its
// softmax the other's products run. GQA reads key / value head h /
// kv_group in place; the grid runs the heads of one block-row next to
// each other (the query heads of a group share K and V in L2) and the
// longest causal rows first. Numerics as above: -1e30 for masked scores,
// p rounded to bf16 before P V (S itself stays fp32), a row with no mass
// gives zeros and lse = 1e30.
#include "attn_tile.cuh"
#include "hopper.cuh"

namespace {

using namespace attn;

struct Args {
  const void* q;  // (H, T, DH)
  const void* k;  // (H, Tk, DH)
  const void* v;
  const void* dout;  // (H, T, DH), backward only
  const float* lse;  // (H, T), written by the forward
  const float* dvec;  // (H, T) rowsum(dO * O), backward only
  const int* groups;  // offsets (by block-row) or offsets_t (by block-column)
  const int* members;  // indices (block-columns) or indices_t (block-rows)
  void* out;   // out (fwd), dQ (dq) or dK (dkv)
  void* out2;  // dV (dkv)
  float* lse_out;
  int t, tk;
  float scale;
  int causal, out_f32;
};

// ---------------------------------------------------------------- forward --
template <typename T, int DH>
struct FwdSmem {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int LQ = DH + pad<T>(), LK = LQ, LS = BS + 4;
  static constexpr int LP = F32 ? LS : BS + pad<T>();  // fp32: P overwrites S
  static constexpr int Q = 0;
  static constexpr int KV = Q + align128(TM * LQ * sizeof(T));
  static constexpr int S = KV + align128(BS * LK * sizeof(T));
  static constexpr int P = F32 ? S : S + align128(TM * LS * 4);
  static constexpr int BYTES = F32 ? P + align128(TM * LS * 4) : P + align128(TM * LP * sizeof(T));
};

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) fwd_kernel(Args a) {
  using L = FwdSmem<T, DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::Q);
  T* KVs = reinterpret_cast<T*>(smem + L::KV);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  T* Ps = reinterpret_cast<T*>(smem + L::P);

  const int r = blockIdx.x / (BS / TM);  // query block-row
  const int q_in_block = (blockIdx.x % (BS / TM)) * TM;
  const int64_t h = blockIdx.y;
  const int64_t q0 = int64_t(r) * BS + q_in_block;
  const T* k = static_cast<const T*>(a.k) + h * a.tk * DH;
  const T* v = static_cast<const T*>(a.v) + h * a.tk * DH;
  bsr::copy_tile<T, TM, DH>(Qs, L::LQ, static_cast<const T*>(a.q) + (h * a.t + q0) * DH, DH);

  const int row = threadIdx.x / 4, lane4 = threadIdx.x % 4;
  const int qi = q_in_block + row;
  float m = NEG_INF, l = 0.0f;
  float o[DH / 4];  // columns 4 j + lane4 of this row
#pragma unroll
  for (int j = 0; j < DH / 4; ++j) o[j] = 0.0f;

  const int end = a.groups[r + 1];
  for (int s = a.groups[r]; s < end; ++s) {
    const int c = a.members[s];
    __syncthreads();  // the previous block's P and V are consumed
    bsr::copy_tile<T, BS, DH>(KVs, L::LK, k + int64_t(c) * BS * DH, DH);
    __syncthreads();
    {
      Mma<T, TM, BS, false, true> mm;
      mm.zero();
      mm.template run<DH>(Qs, L::LQ, KVs, L::LK);
      mm.store(Ss, L::LS);
    }
    __syncthreads();
    float sv[BS / 4];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < BS / 4; ++j) {
      const int col = 4 * j + lane4;
      const float sc = Ss[row * L::LS + col] * a.scale;
      sv[j] = keep(a.causal, r, c, qi, col) ? sc : NEG_INF;
      mx = fmaxf(mx, sv[j]);
    }
    const float m_new = fmaxf(m, row_max(mx));
    const float corr = expf(m - m_new);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < BS / 4; ++j) {
      const float pj = sv[j] > 0.5f * NEG_INF ? expf(sv[j] - m_new) : 0.0f;
      sum += pj;
      Ps[row * L::LP + 4 * j + lane4] = from_float<T>(pj);
    }
    l = l * corr + row_sum(sum);
    m = m_new;
    __syncthreads();  // P is complete and K is consumed
    bsr::copy_tile<T, BS, DH>(KVs, L::LK, v + int64_t(c) * BS * DH, DH);
    __syncthreads();
    {
      Mma<T, TM, DH, false, false> mm;
      mm.zero();
      mm.template run<BS>(Ps, L::LP, KVs, L::LK);
      __syncthreads();  // in fp32 P lives in S
      mm.store(Ss, L::LS);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < DH / 4; ++j) o[j] = o[j] * corr + Ss[row * L::LS + 4 * j + lane4];
  }

  const float denom = fmaxf(l, 1e-30f);
  const int64_t orow = (h * a.t + q0 + row) * DH;
#pragma unroll
  for (int j = 0; j < DH / 4; ++j) bsr::store_one(a.out, orow + 4 * j + lane4, o[j] / denom, a.out_f32);
  if (lane4 == 0) a.lse_out[h * a.t + q0 + row] = l > 0.0f ? m + logf(fmaxf(l, 1e-30f)) : POS_BIG;
}

// --------------------------------------------------------------------- dQ --
template <typename T, int DH>
struct DqSmem {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int LQ = DH + pad<T>(), LK = LQ, LS = BS + 4;
  static constexpr int LP = F32 ? LS : BS + pad<T>();  // fp32: dS overwrites S
  static constexpr int Q = 0;
  static constexpr int DO = Q + align128(TM * LQ * sizeof(T));
  static constexpr int KV = DO + align128(TM * LQ * sizeof(T));
  static constexpr int S = KV + align128(BS * LK * sizeof(T));
  static constexpr int D = S + align128(TM * LS * 4);
  static constexpr int DS = F32 ? S : D + align128(TM * LS * 4);
  static constexpr int BYTES = F32 ? D + align128(TM * LS * 4) : DS + align128(TM * LP * sizeof(T));
};

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) dq_kernel(Args a) {
  using L = DqSmem<T, DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::Q);
  T* dOs = reinterpret_cast<T*>(smem + L::DO);
  T* KVs = reinterpret_cast<T*>(smem + L::KV);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  float* Ds = reinterpret_cast<float*>(smem + L::D);
  T* dSs = reinterpret_cast<T*>(smem + L::DS);

  const int r = blockIdx.x / (BS / TM);
  const int q_in_block = (blockIdx.x % (BS / TM)) * TM;
  const int64_t h = blockIdx.y;
  const int64_t q0 = int64_t(r) * BS + q_in_block;
  const T* k = static_cast<const T*>(a.k) + h * a.tk * DH;
  const T* v = static_cast<const T*>(a.v) + h * a.tk * DH;
  bsr::copy_tile<T, TM, DH>(Qs, L::LQ, static_cast<const T*>(a.q) + (h * a.t + q0) * DH, DH);
  bsr::copy_tile<T, TM, DH>(dOs, L::LQ, static_cast<const T*>(a.dout) + (h * a.t + q0) * DH, DH);

  const int row = threadIdx.x / 4, lane4 = threadIdx.x % 4;
  const int qi = q_in_block + row;
  const float lse = a.lse[h * a.t + q0 + row];
  const float dvec = a.dvec[h * a.t + q0 + row];

  Mma<T, TM, DH, false, false> dq;
  dq.zero();
  const int end = a.groups[r + 1];
  for (int s = a.groups[r]; s < end; ++s) {
    const int c = a.members[s];
    __syncthreads();  // the previous block's dS and K are consumed
    bsr::copy_tile<T, BS, DH>(KVs, L::LK, v + int64_t(c) * BS * DH, DH);
    __syncthreads();
    {
      Mma<T, TM, BS, false, true> mm;  // dP = dO V^T
      mm.zero();
      mm.template run<DH>(dOs, L::LQ, KVs, L::LK);
      mm.store(Ds, L::LS);
    }
    __syncthreads();
    bsr::copy_tile<T, BS, DH>(KVs, L::LK, k + int64_t(c) * BS * DH, DH);
    __syncthreads();
    {
      Mma<T, TM, BS, false, true> mm;  // S = Q K^T
      mm.zero();
      mm.template run<DH>(Qs, L::LQ, KVs, L::LK);
      mm.store(Ss, L::LS);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BS / 4; ++j) {
      const int col = 4 * j + lane4;
      const float p = keep(a.causal, r, c, qi, col) ? expf(Ss[row * L::LS + col] * a.scale - lse) : 0.0f;
      dSs[row * L::LP + col] = from_float<T>(p * (Ds[row * L::LS + col] - dvec));
    }
    __syncthreads();
    dq.template run<BS>(dSs, L::LP, KVs, L::LK);  // dQ += dS K
  }
  __syncthreads();  // S is free for the epilogue's scratch
  dq.store_out(static_cast<char*>(a.out) + (h * a.t + q0) * DH * (a.out_f32 ? 4 : 2), DH, a.scale,
               a.out_f32, Ss);
}

// ------------------------------------------------------------------- dK/dV --
template <typename T, int DH>
struct DkvSmem {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int LQ = DH + pad<T>(), LK = LQ, LS = TM + 4;
  static constexpr int LP = F32 ? LS : TM + pad<T>();  // fp32: P / dS overwrite S / dP
  static constexpr int K = 0;
  static constexpr int V = K + align128(TM * LK * sizeof(T));
  static constexpr int Q = V + align128(TM * LK * sizeof(T));
  static constexpr int DO = Q + align128(TM * LQ * sizeof(T));
  static constexpr int S = DO + align128(TM * LQ * sizeof(T));
  static constexpr int D = S + align128(TM * LS * 4);
  static constexpr int P = F32 ? S : D + align128(TM * LS * 4);
  static constexpr int DS = F32 ? D : P + align128(TM * LP * sizeof(T));
  static constexpr int ROWS = F32 ? D + align128(TM * LS * 4) : DS + align128(TM * LP * sizeof(T));
  static constexpr int BYTES = ROWS + 2 * TM * 4;  // lse and dvec of the query rows
  static_assert(2 * TM * LS * 4 >= 8 * 256 * 4, "S and dP hold the epilogue's scratch");
};

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) dkv_kernel(Args a) {
  using L = DkvSmem<T, DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + L::K);
  T* Vs = reinterpret_cast<T*>(smem + L::V);
  T* Qs = reinterpret_cast<T*>(smem + L::Q);
  T* dOs = reinterpret_cast<T*>(smem + L::DO);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  float* Ds = reinterpret_cast<float*>(smem + L::D);
  T* Ps = reinterpret_cast<T*>(smem + L::P);
  T* dSs = reinterpret_cast<T*>(smem + L::DS);
  float* lse_s = reinterpret_cast<float*>(smem + L::ROWS);
  float* dvec_s = lse_s + TM;

  const int c = blockIdx.x / (BS / TM);  // key block-column
  const int k_in_block = (blockIdx.x % (BS / TM)) * TM;
  const int64_t h = blockIdx.y;
  const int64_t k0 = int64_t(c) * BS + k_in_block;
  const T* q = static_cast<const T*>(a.q) + h * a.t * DH;
  const T* dout = static_cast<const T*>(a.dout) + h * a.t * DH;
  bsr::copy_tile<T, TM, DH>(Ks, L::LK, static_cast<const T*>(a.k) + (h * a.tk + k0) * DH, DH);
  bsr::copy_tile<T, TM, DH>(Vs, L::LK, static_cast<const T*>(a.v) + (h * a.tk + k0) * DH, DH);

  const int row = threadIdx.x / 4, lane4 = threadIdx.x % 4;  // a query row of the step
  Mma<T, TM, DH, true, false> dk, dv;
  dk.zero();
  dv.zero();
  const int end = a.groups[c + 1];
  for (int s = a.groups[c]; s < end; ++s) {
    const int r = a.members[s];  // query block-row
    for (int half = 0; half < BS / TM; ++half) {
      const int q_in_block = half * TM;
      const int64_t q0 = int64_t(r) * BS + q_in_block;
      __syncthreads();  // the previous step's operands are consumed
      bsr::copy_tile<T, TM, DH>(Qs, L::LQ, q + q0 * DH, DH);
      bsr::copy_tile<T, TM, DH>(dOs, L::LQ, dout + q0 * DH, DH);
      if (threadIdx.x < TM) {
        lse_s[threadIdx.x] = a.lse[h * a.t + q0 + threadIdx.x];
        dvec_s[threadIdx.x] = a.dvec[h * a.t + q0 + threadIdx.x];
      }
      __syncthreads();
      {
        Mma<T, TM, TM, false, true> mm;  // S = Q K^T (queries x keys)
        mm.zero();
        mm.template run<DH>(Qs, L::LQ, Ks, L::LK);
        mm.store(Ss, L::LS);
      }
      {
        Mma<T, TM, TM, false, true> mm;  // dP = dO V^T
        mm.zero();
        mm.template run<DH>(dOs, L::LQ, Vs, L::LK);
        mm.store(Ds, L::LS);
      }
      __syncthreads();
      const int qi = q_in_block + row;
      const float lse = lse_s[row], dvec = dvec_s[row];
#pragma unroll
      for (int j = 0; j < TM / 4; ++j) {
        const int col = 4 * j + lane4;
        const float p =
            keep(a.causal, r, c, qi, k_in_block + col) ? expf(Ss[row * L::LS + col] * a.scale - lse) : 0.0f;
        const float ds = p * (Ds[row * L::LS + col] - dvec);
        Ps[row * L::LP + col] = from_float<T>(p);
        dSs[row * L::LP + col] = from_float<T>(ds);
      }
      __syncthreads();
      dv.template run<TM>(Ps, L::LP, dOs, L::LQ);  // dV += P^T dO
      dk.template run<TM>(dSs, L::LP, Qs, L::LQ);  // dK += dS^T Q
    }
  }
  __syncthreads();  // S and dP are free for the epilogue's scratch
  const int64_t esize = a.out_f32 ? 4 : 2;
  dk.store_out(static_cast<char*>(a.out) + (h * a.tk + k0) * DH * esize, DH, a.scale, a.out_f32, Ss);
  dv.store_out(static_cast<char*>(a.out2) + (h * a.tk + k0) * DH * esize, DH, 1.0f, a.out_f32, Ss);
}

template <typename T, typename Smem>
int launch(void (*kernel)(Args), const Args& a, int tiles, int heads, cudaStream_t st) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tiles > 0 && heads > 0) kernel<<<dim3(tiles, heads), THREADS, Smem::BYTES, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

enum Pass { FWD, DQ, DKV };

template <typename T, int DH>
int launch_pass(Pass pass, const Args& a, int tiles, int heads, cudaStream_t st) {
  switch (pass) {
    case FWD:
      return launch<T, FwdSmem<T, DH>>(fwd_kernel<T, DH>, a, tiles, heads, st);
    case DQ:
      return launch<T, DqSmem<T, DH>>(dq_kernel<T, DH>, a, tiles, heads, st);
    default:
      return launch<T, DkvSmem<T, DH>>(dkv_kernel<T, DH>, a, tiles, heads, st);
  }
}

// The head dims instantiated: every multiple of 16 up to 128. Each is six
// kernels of build time.
template <typename T>
int launch_dh(Pass pass, int dh, const Args& a, int tiles, int heads, cudaStream_t st) {
  switch (dh) {
    case 16:
      return launch_pass<T, 16>(pass, a, tiles, heads, st);
    case 32:
      return launch_pass<T, 32>(pass, a, tiles, heads, st);
    case 48:
      return launch_pass<T, 48>(pass, a, tiles, heads, st);
    case 64:
      return launch_pass<T, 64>(pass, a, tiles, heads, st);
    case 80:
      return launch_pass<T, 80>(pass, a, tiles, heads, st);
    case 96:
      return launch_pass<T, 96>(pass, a, tiles, heads, st);
    case 112:
      return launch_pass<T, 112>(pass, a, tiles, heads, st);
    case 128:
      return launch_pass<T, 128>(pass, a, tiles, heads, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int run(Pass pass, int in_f32, int dh, const Args& a, int tiles, int heads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return in_f32 ? launch_dh<float>(pass, dh, a, tiles, heads, st)
                : launch_dh<bf16>(pass, dh, a, tiles, heads, st);
}

// ------------------------------------------- forward, bf16 at DH 128: wgmma --
namespace wg {

constexpr int DH = 128;
constexpr int CONSUMERS = 2;                        // warpgroups of 64 query rows
constexpr int THREADS = CONSUMERS * 128 + 32;       // + one producer warp
constexpr int STAGES = 2;                           // K / V ring depth
constexpr int SLAB = 128 * 128;                     // bytes of 128 rows x 64 columns (one swizzled box)
constexpr int TILE = 2 * SLAB;                      // a 128 x 128 bf16 tile: two slabs of 64 columns
constexpr int KV_OFF = TILE;                        // stage s: K at KV_OFF + 2 s TILE, V one TILE after it
constexpr int SMEM_BYTES = KV_OFF + STAGES * 2 * TILE + 1024;  // + alignment
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Args {
  const int* offsets;  // (n_rows + 1,) block-row starts
  const int* indices;  // block-columns
  void* out;           // (H, T, DH), bf16 or fp32
  float* lse;          // (H, T)
  int heads, kv_group, t, n_rows;
  float scale_log2;    // scale * log2(e)
  int causal, window, out_f32;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit (flushes denormals; 2^-1e30 is 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The two consumer warpgroups take turns to issue their products (named
// barriers 1 and 2, one per warpgroup, each over both): warpgroup w waits
// on its barrier before issuing and arrives on the other's after, so one
// warpgroup's softmax runs while the other's products hold the tensor cores.
__device__ __forceinline__ void turn_wait(int wgi) { hopper::named_barrier(1 + wgi, CONSUMERS * 128); }

__device__ __forceinline__ void turn_pass(int wgi) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wgi), "r"(CONSUMERS * 128) : "memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__global__ void __launch_bounds__(THREADS, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map, Args a) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled TMA boxes need 1024-byte aligned destinations.
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __shared__ __align__(8) uint64_t q_full, k_full[STAGES], v_full[STAGES], empty[STAGES];
  __shared__ int stage_col[STAGES];  // the block-column each stage holds

  const int h = blockIdx.x % a.heads;
  const int r = a.n_rows - 1 - blockIdx.x / a.heads;  // the last (longest causal) block-rows first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int s_begin = a.offsets[r], n = a.offsets[r + 1] - s_begin;

  if (warp == CONSUMERS * 4) {
    // ---- producer warp: lane 0 loads Q, then K and V of each block in turn.
    if (lane == 0 && n > 0) {
      hopper::prefetch_tensormap(&q_map);
      hopper::prefetch_tensormap(&k_map);
      hopper::prefetch_tensormap(&v_map);
      const int hk = h / a.kv_group;
      hopper::mbar_arrive_expect_tx(&q_full, TILE);
      hopper::tma_load_3d(smem, &q_map, &q_full, 0, r * 128, h);
      hopper::tma_load_3d(smem + SLAB, &q_map, &q_full, 64, r * 128, h);
      for (int i = 0; i < n; ++i) {
        const int c = a.indices[s_begin + i];
        const int stage = i % STAGES;
        hopper::mbar_wait(&empty[stage], ((i / STAGES) & 1) ^ 1);
        stage_col[stage] = c;  // published by the arrivals below
        uint8_t* ks = smem + KV_OFF + stage * 2 * TILE;
        hopper::mbar_arrive_expect_tx(&k_full[stage], TILE);
        hopper::tma_load_3d(ks, &k_map, &k_full[stage], 0, c * 128, hk);
        hopper::tma_load_3d(ks + SLAB, &k_map, &k_full[stage], 64, c * 128, hk);
        hopper::mbar_arrive_expect_tx(&v_full[stage], TILE);
        hopper::tma_load_3d(ks + TILE, &v_map, &v_full[stage], 0, c * 128, hk);
        hopper::tma_load_3d(ks + TILE + SLAB, &v_map, &v_full[stage], 64, c * 128, hk);
      }
    }
    return;
  }

  // ---- consumer warpgroups: wg owns rows wg * 64 .. wg * 64 + 63 of the tile.
  // wgmma's accumulator layout: register 4 j + e of thread t holds row
  // 16 (t / 32) + (t % 32) / 4 + 8 (e / 2), column 8 j + 2 (t % 4) + e % 2.
  const int wgi = warp >> 2, t = threadIdx.x & 127;
  const int row0 = wgi * 64 + (t >> 5) * 16 + ((t & 31) >> 2);  // rows row0 (e < 2) and row0 + 8
  const int qi0 = r * 128 + row0;
  const int col0 = 2 * (t & 3);
  const uint8_t* qs = smem + wgi * 64 * 128;  // this warpgroup's 64 rows of slab 0; slab 1 one SLAB on
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // m in the exp2 domain; l this thread's columns only
  if (n > 0) hopper::mbar_wait(&q_full, 0);
  if (n > 0 && wgi == 1) turn_pass(wgi);  // warpgroup 0 issues first

  for (int i = 0; i < n; ++i) {
    const int stage = i % STAGES;
    const uint32_t parity = (i / STAGES) & 1;
    const uint8_t* ks = smem + KV_OFF + stage * 2 * TILE;
    const uint8_t* vs = ks + TILE;

    // S = Q K^T: Q and K both K-major (head dim contiguous), 8 k16 steps.
    float s[64];
    hopper::mbar_wait(&k_full[stage], parity);
    turn_wait(wgi);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int off = (kk >> 2) * SLAB + (kk & 3) * 32;
      hopper::wgmma_m64n128k16<0, 0>(s, hopper::desc_sw128(qs + off, 16, 1024),
                                     hopper::desc_sw128(ks + off, 16, 1024), kk > 0);
    }
    hopper::wgmma_commit();
    turn_pass(wgi);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);

    // The online softmax in the exp2 domain. Only a block the causal
    // diagonal or the window's edge cuts is masked element by element.
    const int c = stage_col[stage];
    const bool cut = (a.causal && c >= r) || (a.window > 0 && c * 128 <= r * 128 + 127 - a.window);
    float m_new[2] = {m[0], m[1]};
    if (cut) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qi0 + 8 * (e >> 1), kj = c * 128 + 8 * j + col0 + (e & 1);
          const bool keep = (!a.causal || kj <= qi) && (a.window <= 0 || qi - kj < a.window);
          s[4 * j + e] = keep ? s[4 * j + e] * a.scale_log2 : NEG_INF;
          m_new[e >> 1] = fmaxf(m_new[e >> 1], s[4 * j + e]);
        }
      }
    } else {
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
      }
      // scale > 0: the scaled row max is the scaled max
      m_new[0] = fmaxf(m_new[0], mx[0] * a.scale_log2);
      m_new[1] = fmaxf(m_new[1], mx[1] * a.scale_log2);
    }
    m_new[0] = quad_max(m_new[0]);
    m_new[1] = quad_max(m_new[1]);
    const float corr[2] = {exp2_approx(m[0] - m_new[0]), exp2_approx(m[1] - m_new[1])};
    m[0] = m_new[0];
    m[1] = m_new[1];
    uint32_t p[32];  // P in bf16, two columns a register, in the register A operand's order
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int e = j & 1;  // registers 2 j, 2 j + 1 of S: row row0 + 8 e
      float p0, p1;
      if (cut) {
        p0 = s[2 * j] > 0.5f * NEG_INF ? exp2_approx(s[2 * j] - m_new[e]) : 0.f;
        p1 = s[2 * j + 1] > 0.5f * NEG_INF ? exp2_approx(s[2 * j + 1] - m_new[e]) : 0.f;
      } else {
        p0 = exp2_approx(fmaf(s[2 * j], a.scale_log2, -m_new[e]));
        p1 = exp2_approx(fmaf(s[2 * j + 1], a.scale_log2, -m_new[e]));
      }
      sum[e] += p0 + p1;
      p[j] = pack_bf16(p0, p1);
    }
    l[0] = l[0] * corr[0] + sum[0];
    l[1] = l[1] * corr[1] + sum[1];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e >> 1];
    }

    // O += P V: P from registers, V MN-major (head dim contiguous), 8 k16
    // steps of 16 keys (2048 bytes of each slab), the two 64-wide slabs of
    // the head dim one SLAB apart.
    hopper::mbar_wait(&v_full[stage], parity);
    hopper::fence_regs(o);
    turn_wait(wgi);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t pa[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
      hopper::wgmma_m64n128k16_rs<1>(o, pa, hopper::desc_sw128(vs + kk * 2048, SLAB, 1024));
    }
    hopper::wgmma_commit();
    if (wgi == 0 || i + 1 < n) turn_pass(wgi);  // the turns balance: warpgroup 1 passed first
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[stage]);
  }

  // ---- epilogue: O / l straight from the registers; lse = m ln 2 + log l.
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const float total = quad_sum(l[e2]);
    const float inv = 1.0f / fmaxf(total, 1e-30f);
    const int64_t row = int64_t(h) * a.t + qi0 + 8 * e2;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float x0 = o[4 * j + 2 * e2] * inv, x1 = o[4 * j + 2 * e2 + 1] * inv;
      const int64_t off = row * DH + 8 * j + col0;
      if (a.out_f32) {
        *reinterpret_cast<float2*>(static_cast<float*>(a.out) + off) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.out) + off) = pack_bf16(x0, x1);
      }
    }
    if ((t & 3) == 0) a.lse[row] = total > 0.f ? m[e2] * LN2 + logf(total) : POS_BIG;
  }
}

// The maps: q (heads, t, 128) and k, v (heads / kv_group, tk, 128), bf16,
// contiguous, in boxes of 64 columns x 128 rows. Returns a cudaError_t value.
int launch(const void* q, const void* k, const void* v, const Args& a, int tk, cudaStream_t st) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const uint64_t kv_heads = uint64_t(a.heads / a.kv_group);
  CUtensorMap q_map, k_map, v_map;
  if (!hopper::encode(&q_map, q, DH, a.t, a.heads, DH, uint64_t(a.t) * DH, 64, 128) ||
      !hopper::encode(&k_map, k, DH, tk, kv_heads, DH, uint64_t(tk) * DH, 64, 128) ||
      !hopper::encode(&v_map, v, DH, tk, kv_heads, DH, uint64_t(tk) * DH, 64, 128))
    return bad;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  fwd_kernel<<<a.n_rows * a.heads, THREADS, SMEM_BYTES, st>>>(q_map, k_map, v_map, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

}  // namespace

// Each entry point returns cudaGetLastError() after the launch (or the
// error of setting the shared-memory size; cudaErrorInvalidValue for a
// head dim that is not instantiated). t and tk are multiples of 128; all
// tensors contiguous.
extern "C" int flash_mha_fwd(const void* q, const void* k, const void* v, const void* offsets,
                             const void* indices, void* out, void* lse, int heads, int t, int tk,
                             int dh, float scale, int causal, int in_f32, int out_f32,
                             void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, static_cast<const int*>(offsets),
         static_cast<const int*>(indices), out, nullptr, static_cast<float*>(lse), t, tk, scale,
         causal, out_f32};
  return run(FWD, in_f32, dh, a, t / TM, heads, stream);
}

extern "C" int flash_mha_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* dvec, const void* offsets,
                            const void* indices, void* dq, int heads, int t, int tk, int dh,
                            float scale, int causal, int in_f32, int out_f32, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(dvec),
         static_cast<const int*>(offsets), static_cast<const int*>(indices), dq, nullptr, nullptr,
         t, tk, scale, causal, out_f32};
  return run(DQ, in_f32, dh, a, t / TM, heads, stream);
}

extern "C" int flash_mha_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* dvec, const void* offsets_t,
                             const void* indices_t, void* dk, void* dv, int heads, int t, int tk,
                             int dh, float scale, int causal, int in_f32, int out_f32,
                             void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(dvec),
         static_cast<const int*>(offsets_t), static_cast<const int*>(indices_t), dk, dv, nullptr,
         t, tk, scale, causal, out_f32};
  return run(DKV, in_f32, dh, a, tk / TM, heads, stream);
}

// The bf16 forward at head dim 128 on TMA + wgmma (namespace wg above): q
// (heads, t, 128), k and v (heads / kv_group, tk, 128), all bf16 and
// contiguous; query head h reads key / value head h / kv_group. window > 0
// keeps key j of query i only where i - window < j (under causal, j <= i
// too). out (heads, t, 128) in bf16 or fp32, lse (heads, t) fp32, as
// flash_mha_fwd writes them. t and tk are multiples of 128.
extern "C" int flash_mha_fwd_wgmma(const void* q, const void* k, const void* v, const void* offsets,
                                   const void* indices, void* out, void* lse, int heads, int kv_group, int t,
                                   int tk, float scale, int causal, int window, int out_f32, void* stream) {
  if (heads <= 0 || kv_group <= 0 || heads % kv_group || t % 128 || tk % 128 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (t == 0) return static_cast<int>(cudaGetLastError());
  wg::Args a{static_cast<const int*>(offsets), static_cast<const int*>(indices), out, static_cast<float*>(lse),
             heads, kv_group, t, t / 128, scale * wg::LOG2E, causal, window, out_f32};
  return wg::launch(q, k, v, a, tk, static_cast<cudaStream_t>(stream));
}
