// bsr_softmax: the row softmax over a BSR matrix's stored blocks, in two
// passes, and the fused score pass of SDD + softmax. Three kernels:
//
//   bsr_softmax_stats      per element-row, the online (max, sum) of the
//                          scaled, causally masked scores over the row's
//                          stored blocks: m, l (fp32).
//   bsr_softmax_normalize  each stored block again: exp(s - m) / max(l, 1e-30)
//                          into its packed slot, in the output dtype.
//   sdd_softmax            scores = q k^T * scale per stored block (masked),
//                          written in fp32 in the topology's packed order,
//                          with the same online (m, l); bsr_softmax_normalize
//                          with scale 1 and no mask is its epilogue.
//
// Replaces sputnik_tpu/kernels/bsr_softmax.py::_stats_kernel (the
// pallas_call at :103), ::_normalize_kernel (:126) and
// sputnik_tpu/kernels/flash_attention.py::_sdd_softmax_kernel (:354). The
// TPU kernels walk the stored blocks in one sequential grid and carry the
// running (m, l) of a block-row in VMEM from step to step, flushing them
// when the row id changes. Here one CTA owns 64 rows of one block-row (one
// half of a 128-block) and walks offsets[r] .. offsets[r + 1] itself, with
// (m, l) in registers: the metadata is read on the card, so a topology
// built there needs no max_row_nnz hint, and an empty row stores the
// empty-row values (m = -1e30, l = 0) because its loop runs zero times. No
// atomics: every run gives the same bits.
//
// Numerics are JAX's: scores in fp32, masked lanes the finite -1e30,
// p = 0 where s <= -5e29, so a fully masked row gives zeros, not NaN.
//
// What bounds it on the H100: the softmax does ~5 operations per score and
// moves 2 bytes (bf16) in each pass, far below the card's balance point:
// bytes bound it. The stats pass reads each block once, the normalize pass
// reads it again and writes it (3 crossings of the data; the unfused torch
// chain makes ~6 in fp32). A thread reads 64 contiguous bytes of one row per
// block; L2 serves the second read when the data fits its 50 MB. The score
// pass is the flash forward's first product (wmma bf16, FFMA fp32) with the
// scores written once in fp32 instead of multiplied by V.
#include "attn_tile.cuh"

namespace {

using namespace attn;

struct SoftmaxArgs {
  const void* data;     // ([batch,] nnz, 128, 128) scores, bf16 or fp32
  const float* m;       // (batch, T) row max, written by the stats pass
  const float* l;       // (batch, T) row sum
  const int* offsets;   // (block_rows + 1,)
  const int* row_ids;   // (nnz,) block-row of each block
  const int* col_ids;   // (nnz,) block-column of each block
  void* out;            // ([batch,] nnz, 128, 128), bf16 or fp32
  float* m_out;
  float* l_out;
  int64_t batch_stride;  // elements of one batch entry of data / out
  int t;                 // element rows: block_rows * 128
  float scale;
  int causal, out_f32;
};

// Eight consecutive values of a row, as fp32.
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&a);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
}
__device__ __forceinline__ void store8(void* out, int64_t off, const float* v, bool out_f32) {
  if (out_f32) {
    float4* p = reinterpret_cast<float4*>(static_cast<float*>(out) + off);
    p[0] = make_float4(v[0], v[1], v[2], v[3]);
    p[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    uint4 a;
    bf16* h = reinterpret_cast<bf16*>(&a);
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16(v[i]);
    *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + off) = a;
  }
}

// ------------------------------------------------------------------ stats --
// Grid (block_rows * 2, batch). Thread t owns row t / 4 of the CTA's half
// block and the 32 contiguous columns 32 (t % 4) .. 32 (t % 4) + 31.
template <typename T>
__global__ void __launch_bounds__(THREADS) stats_kernel(SoftmaxArgs a) {
  const int r = blockIdx.x / (BS / TM);
  const int row = threadIdx.x / 4, lane4 = threadIdx.x % 4;
  const int qi = (blockIdx.x % (BS / TM)) * TM + row;  // row within the block
  const int64_t b = blockIdx.y;
  const T* data = static_cast<const T*>(a.data) + b * a.batch_stride;
  float m = NEG_INF, l = 0.0f;
  const int end = a.offsets[r + 1];
  for (int s = a.offsets[r]; s < end; ++s) {
    const int c = a.col_ids[s];
    const T* src = data + (int64_t(s) * BS + qi) * BS + 32 * lane4;
    float v[32];
#pragma unroll
    for (int i = 0; i < 4; ++i) load8(src + 8 * i, v + 8 * i);
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      v[j] = keep(a.causal, r, c, qi, 32 * lane4 + j) ? v[j] * a.scale : NEG_INF;
      mx = fmaxf(mx, v[j]);
    }
    const float m_new = fmaxf(m, row_max(mx));
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) sum += v[j] > 0.5f * NEG_INF ? expf(v[j] - m_new) : 0.0f;
    l = l * expf(m - m_new) + row_sum(sum);
    m = m_new;
  }
  if (lane4 == 0) {
    const int64_t at = b * a.t + int64_t(r) * BS + qi;
    a.m_out[at] = m;
    a.l_out[at] = l;
  }
}

// -------------------------------------------------------------- normalize --
// Grid (nnz, batch): one CTA per stored block, 8 values per thread and step.
template <typename T>
__global__ void __launch_bounds__(THREADS) normalize_kernel(SoftmaxArgs a) {
  const int64_t s = blockIdx.x, b = blockIdx.y;
  const int r = a.row_ids[s], c = a.col_ids[s];
  const int64_t blk = b * a.batch_stride + s * BS * BS;
  const T* src = static_cast<const T*>(a.data) + blk;
  const float* m = a.m + b * a.t + int64_t(r) * BS;
  const float* l = a.l + b * a.t + int64_t(r) * BS;
  for (int v8 = threadIdx.x; v8 < BS * BS / 8; v8 += THREADS) {
    const int row = v8 / (BS / 8), col = (v8 % (BS / 8)) * 8;
    float v[8];
    load8(src + row * BS + col, v);
    const float mr = m[row], denom = fmaxf(l[row], 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float sc = keep(a.causal, r, c, row, col + j) ? v[j] * a.scale : NEG_INF;
      v[j] = sc > 0.5f * NEG_INF ? expf(sc - mr) / denom : 0.0f;
    }
    store8(a.out, blk + row * BS + col, v, a.out_f32);
  }
}

// ------------------------------------------------------------ score pass --
struct ScoreArgs {
  const void* q;        // (batch, T, DH)
  const void* k;        // (batch, Tk, DH)
  const int* offsets;   // (block_rows + 1,)
  const int* col_ids;   // (nnz,)
  float* scores;        // (batch, nnz, 128, 128) fp32
  float* m_out;         // (batch, T)
  float* l_out;
  int64_t nnz;
  int t, tk;
  float scale;
  int causal;
};

template <typename T, int DH>
struct ScoreSmem {
  static constexpr int LQ = DH + pad<T>(), LS = BS + 4;
  static constexpr int Q = 0;
  static constexpr int K = Q + align128(TM * LQ * sizeof(T));
  static constexpr int S = K + align128(BS * LQ * sizeof(T));
  static constexpr int BYTES = S + align128(TM * LS * 4);
};

// Grid (block_rows * 2, batch): the CTA's 64 query rows against each of
// the block-row's key blocks.
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) score_kernel(ScoreArgs a) {
  using L = ScoreSmem<T, DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::Q);
  T* Ks = reinterpret_cast<T*>(smem + L::K);
  float* Ss = reinterpret_cast<float*>(smem + L::S);

  const int r = blockIdx.x / (BS / TM);
  const int q_in_block = (blockIdx.x % (BS / TM)) * TM;
  const int64_t b = blockIdx.y;
  const T* k = static_cast<const T*>(a.k) + b * a.tk * DH;
  bsr::copy_tile<T, TM, DH>(Qs, L::LQ, static_cast<const T*>(a.q) + (b * a.t + int64_t(r) * BS + q_in_block) * DH,
                            DH);
  const int row = threadIdx.x / 4, lane4 = threadIdx.x % 4;
  const int qi = q_in_block + row;
  float m = NEG_INF, l = 0.0f;
  const int end = a.offsets[r + 1];
  for (int s = a.offsets[r]; s < end; ++s) {
    const int c = a.col_ids[s];
    __syncthreads();  // the previous block's K and scores are consumed
    bsr::copy_tile<T, BS, DH>(Ks, L::LQ, k + int64_t(c) * BS * DH, DH);
    __syncthreads();
    {
      Mma<T, TM, BS, false, true> mm;
      mm.zero();
      mm.template run<DH>(Qs, L::LQ, Ks, L::LQ);
      mm.store(Ss, L::LS);
    }
    __syncthreads();
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < BS / 4; ++j) {
      const int col = 4 * j + lane4;
      const float sc = keep(a.causal, r, c, qi, col) ? Ss[row * L::LS + col] * a.scale : NEG_INF;
      Ss[row * L::LS + col] = sc;
      mx = fmaxf(mx, sc);
    }
    const float m_new = fmaxf(m, row_max(mx));
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < BS / 4; ++j) {
      const float sc = Ss[row * L::LS + 4 * j + lane4];
      sum += sc > 0.5f * NEG_INF ? expf(sc - m_new) : 0.0f;
    }
    l = l * expf(m - m_new) + row_sum(sum);
    m = m_new;
    __syncthreads();  // the masked scores are complete
    float* dst = a.scores + ((b * a.nnz + s) * BS + q_in_block) * BS;
    for (int v4 = threadIdx.x; v4 < TM * BS / 4; v4 += THREADS) {
      const int rr = v4 / (BS / 4), cc = (v4 % (BS / 4)) * 4;
      *reinterpret_cast<float4*>(dst + rr * BS + cc) = *reinterpret_cast<const float4*>(Ss + rr * L::LS + cc);
    }
  }
  if (lane4 == 0) {
    const int64_t at = b * a.t + int64_t(r) * BS + qi;
    a.m_out[at] = m;
    a.l_out[at] = l;
  }
}

template <typename T, int DH>
int launch_scores(const ScoreArgs& a, int tiles, int batch, cudaStream_t st) {
  using L = ScoreSmem<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(score_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tiles > 0 && batch > 0) score_kernel<T, DH><<<dim3(tiles, batch), THREADS, L::BYTES, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The head dims of flash_mha.cu: every multiple of 16 up to 128.
template <typename T>
int launch_scores_dh(int dh, const ScoreArgs& a, int tiles, int batch, cudaStream_t st) {
  switch (dh) {
    case 16:
      return launch_scores<T, 16>(a, tiles, batch, st);
    case 32:
      return launch_scores<T, 32>(a, tiles, batch, st);
    case 48:
      return launch_scores<T, 48>(a, tiles, batch, st);
    case 64:
      return launch_scores<T, 64>(a, tiles, batch, st);
    case 80:
      return launch_scores<T, 80>(a, tiles, batch, st);
    case 96:
      return launch_scores<T, 96>(a, tiles, batch, st);
    case 112:
      return launch_scores<T, 112>(a, tiles, batch, st);
    case 128:
      return launch_scores<T, 128>(a, tiles, batch, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Each entry point returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for a head dim that is not instantiated). All
// tensors contiguous; data, scores and out 16-byte aligned.
extern "C" int bsr_softmax_stats(const void* data, const void* offsets, const void* col_ids, void* m,
                                 void* l, int block_rows, int batch, long long batch_stride, float scale,
                                 int causal, int in_f32, void* stream) {
  SoftmaxArgs a{data, nullptr, nullptr, static_cast<const int*>(offsets), nullptr,
                static_cast<const int*>(col_ids), nullptr, static_cast<float*>(m), static_cast<float*>(l),
                batch_stride, block_rows * BS, scale, causal, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(block_rows * (BS / TM), batch);
  if (block_rows > 0 && batch > 0) {
    if (in_f32)
      stats_kernel<float><<<grid, THREADS, 0, st>>>(a);
    else
      stats_kernel<bf16><<<grid, THREADS, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bsr_softmax_normalize(const void* data, const void* m, const void* l, const void* row_ids,
                                     const void* col_ids, void* out, int nnz, int block_rows, int batch,
                                     long long batch_stride, float scale, int causal, int in_f32, int out_f32,
                                     void* stream) {
  SoftmaxArgs a{data, static_cast<const float*>(m), static_cast<const float*>(l), nullptr,
                static_cast<const int*>(row_ids), static_cast<const int*>(col_ids), out, nullptr, nullptr,
                batch_stride, block_rows * BS, scale, causal, out_f32};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(nnz, batch);
  if (nnz > 0 && batch > 0) {
    if (in_f32)
      normalize_kernel<float><<<grid, THREADS, 0, st>>>(a);
    else
      normalize_kernel<bf16><<<grid, THREADS, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sdd_softmax(const void* q, const void* k, const void* offsets, const void* col_ids, void* scores,
                           void* m, void* l, int nnz, int block_rows, int tk, int dh, int batch, float scale,
                           int causal, int in_f32, void* stream) {
  ScoreArgs a{q, k, static_cast<const int*>(offsets), static_cast<const int*>(col_ids),
              static_cast<float*>(scores), static_cast<float*>(m), static_cast<float*>(l),
              nnz, block_rows * BS, tk, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = block_rows * (BS / TM);
  return in_f32 ? launch_scores_dh<float>(dh, a, tiles, batch, st)
                : launch_scores_dh<bf16>(dh, a, tiles, batch, st);
}
