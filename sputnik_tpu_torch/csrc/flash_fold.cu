// flash_fold: one ring-attention band fold. It folds one K/V band into an
// UNnormalized online-softmax state (acc, m, l):
//
//   for each real slot (flag > 0) of block-row r, in slot order:
//     s     = q_blk . k_blk^T * scale  (fp32), masked at GLOBAL block ids
//     m_new = max(m, rowmax s);  corr = exp(m - m_new)
//     p     = exp(s - m_new), 0 where s <= -5e29
//     l     = l * corr + rowsum p
//     acc   = acc * corr + p.astype(v.dtype) . v_blk
//     m     = m_new
//
// Replaces sputnik_tpu/kernels/flash_attention.py::_fold_kernel (the
// pallas_call of flash_band_fold at :530). The TPU kernel walks the slot list
// as a sequential grid, one slot per step, and carries the state in VMEM from
// a block-row's first slot to its last; a select after the call gives rows
// with no real slot their input state back. GPU blocks run in no order, so
// here a CTA owns 64 query rows (half of a 128-row block-row, as
// flash_mha.cu's forward) and walks its block-row's slots itself, with the
// state in registers. Its slot range is found on the device by two binary
// searches in `rows` (non-decreasing, as the TPU kernel requires), so a slot
// list built on the card is never read back. Padding slots (flag 0) are
// skipped: in the TPU kernel they are exact no-ops (corr = 1, p = 0).
//
// The state is updated IN PLACE: the wrapper hands the kernel clones of the
// input state. A CTA whose block-row has no real slot returns without a
// store, so such rows keep their input state, and only lane 0 of m / l (the
// live lane; the TPU kernel carries lanes 1-127 through from its input) is
// ever written. Both give the TPU kernel's outputs with no second pass.
//
// Causal masking: attn::keep at global block ids (band-local id plus
// row_off / col_off), as _keep_mask (:243). Numerics: scores in fp32, masked
// to the finite -1e30; bf16 on the tensor cores (nvcuda::wmma 16x16x16, fp32
// accumulate), fp32 in plain FMA with no TF32; p rounded to v's dtype before
// P V, as the TPU kernel does.
//
// Head dim: a template parameter, every multiple of 16 up to 128, as
// flash_mha.cu. What bounds it on the H100: per 64-row tile and real slot,
// 2 * 2 * 64 * 128 * dh FLOP against 64 KB of K and V (bf16, dh 128), 64
// FLOP/byte, below the card's ridge; this first version stages K and V
// synchronously (no cp.async / TMA ring, wmma rather than wgmma), so it is
// bound by load latency, as flash_mha_fwd is.
#include "attn_tile.cuh"

namespace {

using namespace attn;

constexpr int LANES = 128;  // row stride of m and l: the TPU kernel's (t, 128) stats

struct Args {
  const void* q;  // (t, dh)
  const void* k;  // (tk, dh)
  const void* v;
  const int* rows;   // (p,) band-local block-row per slot, non-decreasing
  const int* cols;   // (p,) band-local block-column per slot
  const int* flags;  // (p,) > 0: a real slot
  float* acc;        // (t, dh) fp32, the state, updated in place
  float* m;          // (t, 128) fp32, lane 0 live
  float* l;
  int p;
  float scale;
  int causal, row_off, col_off;
};

template <typename T, int DH>
struct FoldSmem {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int LQ = DH + pad<T>(), LK = LQ, LS = BS + 4;
  static constexpr int LP = F32 ? LS : BS + pad<T>();  // fp32: P overwrites S
  static constexpr int Q = 0;
  static constexpr int KV = Q + align128(TM * LQ * sizeof(T));
  static constexpr int S = KV + align128(BS * LK * sizeof(T));
  static constexpr int P = F32 ? S : S + align128(TM * LS * 4);
  static constexpr int BYTES = F32 ? P + align128(TM * LS * 4) : P + align128(TM * LP * sizeof(T));
};

// The first index of rows[0, n) that is not below x.
__device__ __forceinline__ int lower_bound(const int* rows, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (rows[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) fold_kernel(Args a) {
  using L = FoldSmem<T, DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::Q);
  T* KVs = reinterpret_cast<T*>(smem + L::KV);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  T* Ps = reinterpret_cast<T*>(smem + L::P);

  const int r = blockIdx.x / (BS / TM);  // band-local query block-row
  const int q_in_block = (blockIdx.x % (BS / TM)) * TM;
  const int64_t q0 = int64_t(r) * BS + q_in_block;
  const int begin = lower_bound(a.rows, a.p, r), end = lower_bound(a.rows, a.p, r + 1);
  bool any = false;
  for (int s = begin; s < end && !any; ++s) any = a.flags[s] > 0;
  if (!any) return;  // the rows keep their input state

  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  bsr::copy_tile<T, TM, DH>(Qs, L::LQ, static_cast<const T*>(a.q) + q0 * DH, DH);

  const int row = threadIdx.x / 4, lane4 = threadIdx.x % 4;
  const int qi = q_in_block + row;
  const int64_t grow = q0 + row;
  float m = a.m[grow * LANES], l = a.l[grow * LANES];
  float o[DH / 4];  // columns 4 j + lane4 of this row
#pragma unroll
  for (int j = 0; j < DH / 4; ++j) o[j] = a.acc[grow * DH + 4 * j + lane4];

  const int gr = r + a.row_off;
  for (int s = begin; s < end; ++s) {
    if (a.flags[s] <= 0) continue;  // a padding slot: the same for the whole CTA
    const int c = a.cols[s];
    const int gc = c + a.col_off;
    __syncthreads();  // the previous slot's P and V are consumed
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
      sv[j] = keep(a.causal, gr, gc, qi, col) ? sc : NEG_INF;
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

#pragma unroll
  for (int j = 0; j < DH / 4; ++j) a.acc[grow * DH + 4 * j + lane4] = o[j];
  if (lane4 == 0) {
    a.m[grow * LANES] = m;
    a.l[grow * LANES] = l;
  }
}

template <typename T, int DH>
int launch(const Args& a, int tiles, cudaStream_t st) {
  using L = FoldSmem<T, DH>;
  cudaError_t err =
      cudaFuncSetAttribute(fold_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tiles > 0) fold_kernel<T, DH><<<tiles, THREADS, L::BYTES, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Every multiple of 16 up to 128, as flash_mha.cu.
template <typename T>
int launch_dh(int dh, const Args& a, int tiles, cudaStream_t st) {
  switch (dh) {
    case 16:
      return launch<T, 16>(a, tiles, st);
    case 32:
      return launch<T, 32>(a, tiles, st);
    case 48:
      return launch<T, 48>(a, tiles, st);
    case 64:
      return launch<T, 64>(a, tiles, st);
    case 80:
      return launch<T, 80>(a, tiles, st);
    case 96:
      return launch<T, 96>(a, tiles, st);
    case 112:
      return launch<T, 112>(a, tiles, st);
    case 128:
      return launch<T, 128>(a, tiles, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (or the error of setting the
// shared-memory size; cudaErrorInvalidValue for a head dim that is not
// instantiated). t is a multiple of 128; acc / m / l hold the input state
// and receive the output; all tensors contiguous.
extern "C" int flash_band_fold(const void* q, const void* k, const void* v, const void* rows, const void* cols,
                               const void* flags, void* acc, void* m, void* l, int t, int p, int dh, float scale,
                               int causal, int row_off, int col_off, int in_f32, void* stream) {
  Args a{q, k, v, static_cast<const int*>(rows), static_cast<const int*>(cols), static_cast<const int*>(flags),
         static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l), p, scale, causal, row_off,
         col_off};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return in_f32 ? launch_dh<float>(dh, a, t / TM, st) : launch_dh<bf16>(dh, a, t / TM, st);
}
