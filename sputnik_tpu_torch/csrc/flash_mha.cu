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
#include "attn_tile.cuh"

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
