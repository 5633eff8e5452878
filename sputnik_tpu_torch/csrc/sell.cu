// The sliced-ELL (SELL) CSR engine on Hopper: sell_spmm, sell_spmm_t,
// sell_sddmm and sell_softmax.
//
// Replaces sputnik_tpu/kernels/sell.py: _spmm_fused_kernel and _spmm_kernel
// (sell_spmm), _spmm_t_kernel (sell_spmm_t, a gather over the transposed
// plan), _sddmm_fused_kernel and _sddmm_kernel (sell_sddmm),
// _softmax_counts_kernel and _softmax_kernel (sell_softmax, validity from
// slot_counts or from the sentinel).
//
// The layout: values / indices are (n_chunks, width, rows_padded); slot w of
// (chunk kc, storage row r) sits at (kc * width + w) * rows_padded + r, its
// column is kc * chunk + indices[...] unless indices[...] == chunk (padding).
// slot_counts (n_chunks, rows_padded), when given, bounds each (chunk, row)'s
// slot loop: its valid slots are a prefix of the width axis. row_perm, when
// given, maps storage row r to logical row row_perm[r]; the kernels read and
// write logical rows through it, which takes the place of the JAX package's
// row gathers before and after its kernels.
//
// The TPU kernels densify a (chunk x 128-row) panel with one compare-select
// per slot and hand it to the MXU, because element gathers are slow there.
// A GPU gathers well, and at DLMC sizes (n = 64, 70-98% sparsity) these
// products do 2 FLOP per 4-byte element gathered: they are bound by bytes
// and, at these small sizes, by launch latency, never by FLOPs. So these
// are Sputnik's own GPU shape (SURVEY.md section 2.6): each valid slot is
// read once, and the dense row it selects is read along N in vectors of up
// to 16 bytes, the sum in fp32 FMA (no tensor cores, no TF32). No kernel
// uses atomics: every sum is taken in a fixed order, so results are
// bitwise equal from run to run, and every output element is written by
// the kernel (no zero fill, no cast pass). Nothing is read back to the host.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int UNROLL = 4;  // slots in flight per warp
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ void store(void* base, int64_t i, float v, int out_f32) {
  if (out_f32)
    static_cast<float*>(base)[i] = v;
  else
    static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16(v);
}

// EPT consecutive elements, one load of EPT * sizeof(T) <= 16 bytes.
template <typename T, int EPT>
struct alignas(EPT * sizeof(T)) Vec {
  T v[EPT];
};

template <typename T, int EPT>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[EPT]) {
  const Vec<T, EPT> u = *reinterpret_cast<const Vec<T, EPT>*>(p);
#pragma unroll
  for (int i = 0; i < EPT; ++i) out[i] = to_f(u.v[i]);
}

template <typename T, int EPT>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[EPT]) {
  Vec<T, EPT> u;
#pragma unroll
  for (int i = 0; i < EPT; ++i) u.v[i] = from_f<T>(in[i]);
  *reinterpret_cast<Vec<T, EPT>*>(p) = u;
}

struct Sell {
  const void* values;   // (n_chunks, width, rows_padded), V; null for sddmm
  const int* indices;   // (n_chunks, width, rows_padded)
  const int* counts;    // (n_chunks, rows_padded) or null
  const int* row_perm;  // (rows_padded,) or null
  int n_chunks, width, rows_padded, chunk, rows, cols;
};

__device__ __forceinline__ int64_t slot_base(const Sell& s, int kc, int r) {
  return int64_t(kc) * s.width * s.rows_padded + r;
}

// ---------------------------------------------------------------- sell_spmm --
// C[row_perm[r], n] = sum_kc sum_w values[kc, w, r] * B[kc * chunk + idx, n].
// One CTA per (storage row, N tile of 32 * EPT columns). Its 8 warps split
// the row's slots (warp j takes slots j, j + 8, ... of every chunk, UNROLL of
// them in flight), each lane holding EPT columns of an fp32 partial sum; the
// partials are added in warp order through shared memory. What bounds it:
// one gathered B row segment per valid slot (n * sizeof(D) bytes) against 2n
// FLOP, and the latency of the dependent index -> B-row load; the eight warps
// and the unrolled slots keep enough loads in flight at DLMC row counts.
template <typename V, typename D, int EPT>
__global__ void __launch_bounds__(THREADS) sell_spmm_kernel(Sell s, const D* __restrict__ b, void* c,
                                                            int n, int out_f32) {
  __shared__ float part[WARPS][32 * EPT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x;
  const int lr = s.row_perm ? s.row_perm[r] : r;
  if (lr >= s.rows) return;  // a padding row, for the whole CTA
  const int n0 = (blockIdx.y * 32 + lane) * EPT;
  const bool active = n0 < n;
  const V* vals = static_cast<const V*>(s.values);
  const int64_t rp = s.rows_padded;
  float acc[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) acc[i] = 0.f;
  for (int kc = 0; kc < s.n_chunks; ++kc) {
    const int bound = s.counts ? s.counts[kc * rp + r] : s.width;
    const int64_t base = slot_base(s, kc, r);
    const D* b_chunk = b + int64_t(kc) * s.chunk * n + n0;
    for (int w0 = warp; w0 < bound; w0 += WARPS * UNROLL) {
      int idx[UNROLL];
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int w = w0 + u * WARPS;
        const bool ok = w < bound;
        idx[u] = ok ? s.indices[base + w * rp] : s.chunk;
        v[u] = ok ? to_f(vals[base + w * rp]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (active && idx[u] < s.chunk) {
          float bv[EPT];
          load_vec<D, EPT>(b_chunk + int64_t(idx[u]) * n, bv);
#pragma unroll
          for (int i = 0; i < EPT; ++i) acc[i] = fmaf(v[u], bv[i], acc[i]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < EPT; ++i) part[warp][lane * EPT + i] = acc[i];
  __syncthreads();
  if (warp != 0 || !active) return;
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    float sum = part[0][lane * EPT + i];
#pragma unroll
    for (int j = 1; j < WARPS; ++j) sum += part[j][lane * EPT + i];
    acc[i] = sum;
  }
  const int64_t off = int64_t(lr) * n + n0;
  if (out_f32)
    store_vec<float, EPT>(static_cast<float*>(c) + off, acc);
  else
    store_vec<__nv_bfloat16, EPT>(static_cast<__nv_bfloat16*>(c) + off, acc);
}

// -------------------------------------------------------------- sell_spmm_t --
// C[c, n] = sum over the nonzeros (r, c) of A of A[r, c] * X[r, n], i.e. C =
// A^T X, as a gather over the transposed plan t (formats.SellTranspose, the
// SELL layout of A^T): output row c of C is storage row s of t with
// t.row_perm[s] = c, and its slots (kc, w, s), w < counts[kc, s], name the X
// row kc * chunk + indices[...] and the value values[positions[...]] of A.
// Replaces the TPU's _spmm_t_kernel, which densifies a (chunk x rows) panel
// of A^T per chunk for the MXU. The earlier port scattered into a shared-
// memory accumulator (a read-modify-write per slot and column); this
// kernel writes each output element once, zeros included for a column of A
// with no nonzero, and sums every row in a fixed order (chunks, then slots),
// so results are bitwise equal from run to run and need no atomics.
//
// One CTA of 8 warps per 8 storage rows of t (neighbours in the sorted
// order have similar lengths) x one N tile of 32 * EPT columns; warp j owns
// row 8 * blockIdx.x + j and each lane EPT columns of its fp32 sum. The
// warp walks its row's slots 32 at a time: the lanes read 32 (position,
// index) pairs across the chunks of a 32-chunk window of counts (a shuffle
// search of the window's prefix sums finds each lane's chunk) and the
// values they point at, and stage (value, X row) in a per-warp list in
// shared memory. Each lane then copies its 16 bytes of the next X row into
// a per-warp ring of RING stages with cp.async, so that RING X rows are in
// flight per warp while the oldest is summed. What bounds it: each slot
// re-reads one X row segment (n * sizeof(D) bytes in all N tiles) from L2,
// about nnz * n * sizeof(D) bytes a call, far above the bytes-once bound;
// the ring keeps those loads in flight. Later work: X rows shared in shared
// memory by the rows of a CTA that gather them (Sputnik's row tiles).
constexpr int RING = 8;        // X rows in flight per warp
constexpr int LIST_SIZE = 64;  // staged slots per warp
static_assert(32 + RING <= LIST_SIZE, "a fill of 32 must not overwrite a slot still in the ring");

template <typename D, int EPT>
__device__ __forceinline__ void copy_lane(D* dst, const D* src) {
  constexpr int BYTES = EPT * int(sizeof(D));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src) : "memory");
  } else if constexpr (BYTES >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src), "n"(BYTES) : "memory");
  } else {
    *dst = *src;  // a 2-byte lane (bf16, odd n): cp.async takes 4 bytes or more
  }
}

template <typename V, typename D, int EPT>
__global__ void __launch_bounds__(THREADS) sell_spmm_t_kernel(Sell t, const int* __restrict__ positions,
                                                              const D* __restrict__ x, void* c, int n,
                                                              int out_f32) {
  __shared__ __align__(16) D ring[WARPS][RING][32 * EPT];
  __shared__ float2 list[WARPS][LIST_SIZE];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + warp;
  const int lc = t.row_perm ? t.row_perm[r] : r;
  if (lc >= t.rows) return;  // a padding row of the plan: no output row
  const int n0 = (blockIdx.y * 32 + lane) * EPT;
  const bool active = n0 < n;
  const V* vals = static_cast<const V*>(t.values);
  const int64_t rp = t.rows_padded;
  D* my_ring = &ring[warp][0][lane * EPT];
  float2* my_list = list[warp];

  float acc[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) acc[i] = 0.f;

  // The slot walk: a window of 32 chunks (lane j holds chunk kc0 + j's count
  // and its inclusive prefix), `done` slots of it taken so far.
  int kc0 = 0, done = 0, cnt = 0, incl = 0, window = 0;
  auto load_window = [&]() {
    cnt = kc0 + lane < t.n_chunks ? t.counts[(kc0 + lane) * rp + r] : 0;
    incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    window = __shfl_sync(0xffffffffu, incl, 31);
    done = 0;
  };
  load_window();
  // Stage the next up to 32 slots at list[q % LIST_SIZE ...]; returns how many.
  auto fill = [&](int q) -> int {
    while (done == window) {
      kc0 += 32;
      if (kc0 >= t.n_chunks) return 0;
      load_window();
    }
    const int take = min(32, window - done);
    // Lane l takes the window's flat slot done + l: find its chunk j, the
    // number of chunks whose inclusive prefix is at most that slot.
    const int f = done + min(lane, take - 1);
    int j = 0;
#pragma unroll
    for (int bit = 16; bit > 0; bit >>= 1) {
      const int at = __shfl_sync(0xffffffffu, incl, j + bit - 1);
      if (at <= f) j += bit;
    }
    const int excl = __shfl_sync(0xffffffffu, incl - cnt, j);
    __syncwarp();  // every lane is past its reads of the entries overwritten here
    if (lane < take) {
      const int kc = kc0 + j, w = f - excl;
      const int64_t slot = (int64_t(kc) * t.width + w) * rp + r;
      const int xrow = kc * t.chunk + t.indices[slot];
      my_list[(q + lane) % LIST_SIZE] = make_float2(to_f(vals[positions[slot]]), __int_as_float(xrow));
    }
    __syncwarp();
    done += take;
    return take;
  };
  auto consume = [&](int q) {
    const float v = my_list[q % LIST_SIZE].x;
    if (active) {
      const D* row = my_ring + (q % RING) * 32 * EPT;
#pragma unroll
      for (int i = 0; i < EPT; ++i) acc[i] = fmaf(v, to_f(row[i]), acc[i]);
    }
  };

  int filled = 0, issued = 0, consumed = 0;
  while (true) {
    if (issued == filled) {
      const int got = fill(filled);
      if (got == 0) break;
      filled += got;
    }
    const int xrow = __float_as_int(my_list[issued % LIST_SIZE].y);
    if (active) copy_lane<D, EPT>(my_ring + (issued % RING) * 32 * EPT, x + int64_t(xrow) * n + n0);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    ++issued;
    if (issued - consumed == RING) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(RING - 1) : "memory");
      consume(consumed++);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  while (consumed < issued) consume(consumed++);
  if (!active) return;
  const int64_t off = int64_t(lc) * n + n0;
  if (out_f32)
    store_vec<float, EPT>(static_cast<float*>(c) + off, acc);
  else
    store_vec<__nv_bfloat16, EPT>(static_cast<__nv_bfloat16*>(c) + off, acc);
}

// --------------------------------------------------------------- sell_sddmm --
// out[kc, w, r] = A[row_perm[r]] . B[kc * chunk + idx[kc, w, r]] at valid
// slots, 0 at every other slot (padding slots and padding rows). One CTA per
// (32 storage rows, chunk kc): it first writes the zeros past each row's
// bound (neighbouring threads on neighbouring rows, coalesced), then each
// warp takes four of the rows and walks their valid slots UNROLL at a time,
// its lanes splitting k in vectors of EPT; each A segment is loaded once for
// the UNROLL slots, and each dot product is reduced across the warp by a
// fixed butterfly. What bounds it: one gathered B row (k * sizeof(D) bytes)
// per valid slot against 2k FLOP, and the latency of the index -> B-row
// load, which the unrolled slots overlap.
template <typename D, int EPT>
__global__ void __launch_bounds__(THREADS) sell_sddmm_kernel(Sell s, const D* __restrict__ a,
                                                             const D* __restrict__ b, void* out, int k,
                                                             int out_f32) {
  __shared__ int bound_s[32];
  __shared__ int lr_s[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kc = blockIdx.y, r0 = blockIdx.x * 32;
  const int64_t rp = s.rows_padded;
  if (threadIdx.x < 32) {
    const int r = r0 + threadIdx.x;
    const int lr = s.row_perm ? s.row_perm[r] : r;
    bound_s[threadIdx.x] = lr >= s.rows ? 0 : (s.counts ? s.counts[kc * rp + r] : s.width);
    lr_s[threadIdx.x] = lr;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < s.width * 32; e += THREADS) {
    const int w = e >> 5, rr = e & 31;
    if (w >= bound_s[rr]) store(out, slot_base(s, kc, r0 + rr) + int64_t(w) * rp, 0.f, out_f32);
  }
  for (int rr = warp; rr < 32; rr += WARPS) {
    const int bound = bound_s[rr];
    const int64_t base = slot_base(s, kc, r0 + rr);
    const D* a_row = a + int64_t(lr_s[rr]) * k;
    for (int w0 = 0; w0 < bound; w0 += UNROLL) {
      int idx[UNROLL];
      float dot[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        idx[u] = w0 + u < bound ? s.indices[base + int64_t(w0 + u) * rp] : s.chunk;
        dot[u] = 0.f;
      }
      for (int k0 = lane * EPT; k0 < k; k0 += 32 * EPT) {
        float av[EPT];
        load_vec<D, EPT>(a_row + k0, av);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (idx[u] < s.chunk) {
            float bv[EPT];
            load_vec<D, EPT>(b + (int64_t(kc) * s.chunk + idx[u]) * k + k0, bv);
#pragma unroll
            for (int i = 0; i < EPT; ++i) dot[u] = fmaf(av[i], bv[i], dot[u]);
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (w0 + u < bound) store(out, base + int64_t(w0 + u) * rp, dot[u], out_f32);
      }
    }
  }
}

// ------------------------------------------------------------- sell_softmax --
// Row softmax over each storage row's valid slots, in fp32, as the JAX
// kernel computes it: invalid slots take -1e30, the row max is clamped at
// -3e38, a slot at or below -5e29 gets 0, the sum is clamped at 1e-30 (an
// empty row is all 0). One CTA per 32 storage rows: the lane is the row, so
// every read and write is coalesced along the rows_padded axis, and the 8
// warps split the row's n_chunks * width slots, their maxima and sums
// combined in warp order through shared memory. Validity comes from
// slot_counts (indices never read) or, without them, from the sentinel.
// Bound by bytes: the values are read three times (max, sum, normalise;
// from L2 at these sizes) and written once.
template <typename V>
__global__ void __launch_bounds__(THREADS) sell_softmax_kernel(Sell s, V* out, float scale) {
  __shared__ float red[WARPS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * 32 + lane;
  const V* vals = static_cast<const V*>(s.values);
  const int64_t rp = s.rows_padded;
  // The scaled, masked value of slot w of chunk kc (cnt: that chunk's count).
  auto masked = [&](int kc, int w, int cnt) -> float {
    const int64_t i = slot_base(s, kc, r) + int64_t(w) * rp;
    const bool valid = s.counts ? w < cnt : s.indices[i] != s.chunk;
    return valid ? to_f(vals[i]) * scale : NEG;
  };
  float m = __int_as_float(0xff800000);  // -inf
  for (int kc = 0; kc < s.n_chunks; ++kc) {
    const int cnt = s.counts ? s.counts[kc * rp + r] : 0;
    for (int w = warp; w < s.width; w += WARPS) m = fmaxf(m, masked(kc, w, cnt));
  }
  red[warp][lane] = m;
  __syncthreads();
  m = red[0][lane];
  for (int j = 1; j < WARPS; ++j) m = fmaxf(m, red[j][lane]);
  m = fmaxf(m, -3e38f);
  __syncthreads();
  float sum = 0.f;
  for (int kc = 0; kc < s.n_chunks; ++kc) {
    const int cnt = s.counts ? s.counts[kc * rp + r] : 0;
    for (int w = warp; w < s.width; w += WARPS) {
      const float v = masked(kc, w, cnt);
      sum += v > 0.5f * NEG ? expf(v - m) : 0.f;
    }
  }
  red[warp][lane] = sum;
  __syncthreads();
  sum = red[0][lane];
  for (int j = 1; j < WARPS; ++j) sum += red[j][lane];
  sum = fmaxf(sum, 1e-30f);
  for (int kc = 0; kc < s.n_chunks; ++kc) {
    const int cnt = s.counts ? s.counts[kc * rp + r] : 0;
    for (int w = warp; w < s.width; w += WARPS) {
      const float v = masked(kc, w, cnt);
      const float e = v > 0.5f * NEG ? expf(v - m) : 0.f;
      out[slot_base(s, kc, r) + int64_t(w) * rp] = from_f<V>(e / sum);
    }
  }
}

// ----------------------------------------------------------------- launches --
template <typename V, typename D, int EPT>
void spmm_launch(const Sell& s, const void* b, void* c, int n, int out_f32, cudaStream_t st) {
  const dim3 grid(s.rows_padded, (n + 32 * EPT - 1) / (32 * EPT));
  sell_spmm_kernel<V, D, EPT><<<grid, THREADS, 0, st>>>(s, static_cast<const D*>(b), c, n, out_f32);
}

template <typename V, typename D>
void spmm_dispatch_ept(const Sell& s, const void* b, void* c, int n, int ept, int out_f32,
                       cudaStream_t st) {
  switch (ept) {
    case 8:
      if constexpr (sizeof(D) == 2) spmm_launch<V, D, 8>(s, b, c, n, out_f32, st);
      break;
    case 4: spmm_launch<V, D, 4>(s, b, c, n, out_f32, st); break;
    case 2: spmm_launch<V, D, 2>(s, b, c, n, out_f32, st); break;
    default: spmm_launch<V, D, 1>(s, b, c, n, out_f32, st); break;
  }
}

template <typename V, typename D, int EPT>
void spmm_t_launch(const Sell& t, const int* positions, const void* x, void* c, int n, int out_f32,
                   cudaStream_t st) {
  const dim3 grid(t.rows_padded / WARPS, (n + 32 * EPT - 1) / (32 * EPT));
  sell_spmm_t_kernel<V, D, EPT><<<grid, THREADS, 0, st>>>(t, positions, static_cast<const D*>(x), c, n, out_f32);
}

template <typename V, typename D>
void spmm_t_dispatch_ept(const Sell& t, const int* positions, const void* x, void* c, int n, int ept, int out_f32,
                         cudaStream_t st) {
  switch (ept) {
    case 8:
      if constexpr (sizeof(D) == 2) spmm_t_launch<V, D, 8>(t, positions, x, c, n, out_f32, st);
      break;
    case 4: spmm_t_launch<V, D, 4>(t, positions, x, c, n, out_f32, st); break;
    case 2: spmm_t_launch<V, D, 2>(t, positions, x, c, n, out_f32, st); break;
    default: spmm_t_launch<V, D, 1>(t, positions, x, c, n, out_f32, st); break;
  }
}

template <typename D, int EPT>
void sddmm_launch(const Sell& s, const void* a, const void* b, void* out, int k, int out_f32,
                  cudaStream_t st) {
  const dim3 grid(s.rows_padded / 32, s.n_chunks);
  sell_sddmm_kernel<D, EPT><<<grid, THREADS, 0, st>>>(s, static_cast<const D*>(a),
                                                       static_cast<const D*>(b), out, k, out_f32);
}

template <typename D>
void sddmm_dispatch_ept(const Sell& s, const void* a, const void* b, void* out, int k, int ept,
                        int out_f32, cudaStream_t st) {
  switch (ept) {
    case 8:
      if constexpr (sizeof(D) == 2) sddmm_launch<D, 8>(s, a, b, out, k, out_f32, st);
      break;
    case 4: sddmm_launch<D, 4>(s, a, b, out, k, out_f32, st); break;
    case 2: sddmm_launch<D, 2>(s, a, b, out, k, out_f32, st); break;
    default: sddmm_launch<D, 1>(s, a, b, out, k, out_f32, st); break;
  }
}

Sell make_sell(const void* values, const void* indices, const void* counts, const void* row_perm,
               int n_chunks, int width, int rows_padded, int chunk, int rows, int cols) {
  return Sell{values, static_cast<const int*>(indices), static_cast<const int*>(counts),
              static_cast<const int*>(row_perm), n_chunks, width, rows_padded, chunk, rows, cols};
}

}  // namespace

// Every entry point returns cudaGetLastError() after its launch. counts and
// row_perm may be null (sell_spmm_t's counts may not); the
// dense operands are contiguous, row-major, and aligned to ept elements
// (ept in {1, 2, 4, 8}, at most 16 bytes, dividing n or k). rows_padded is a
// multiple of 128.

// C (rows, n) = A @ B, B (cols, n).
extern "C" int sell_spmm(const void* values, const void* indices, const void* counts,
                         const void* row_perm, const void* b, void* c, int n_chunks, int width,
                         int rows_padded, int chunk, int rows, int cols, int n, int v_f32, int d_f32,
                         int out_f32, int ept, void* stream) {
  const Sell s = make_sell(values, indices, counts, row_perm, n_chunks, width, rows_padded, chunk, rows, cols);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0 && rows > 0) {
    if (v_f32 && d_f32)
      spmm_dispatch_ept<float, float>(s, b, c, n, ept, out_f32, st);
    else if (v_f32)
      spmm_dispatch_ept<float, __nv_bfloat16>(s, b, c, n, ept, out_f32, st);
    else if (d_f32)
      spmm_dispatch_ept<__nv_bfloat16, float>(s, b, c, n, ept, out_f32, st);
    else
      spmm_dispatch_ept<__nv_bfloat16, __nv_bfloat16>(s, b, c, n, ept, out_f32, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// C (t_rows, n) = A^T @ X, X (t_cols, n), over the transposed plan of A: the
// plan's positions / indices / counts / row_perm with its n_chunks, width,
// rows_padded, chunk and logical shape (t_rows = A's cols, t_cols = A's
// rows); values are A's own.
extern "C" int sell_spmm_t(const void* values, const void* positions, const void* indices, const void* counts,
                           const void* row_perm, const void* x, void* c, int n_chunks, int width, int rows_padded,
                           int chunk, int t_rows, int t_cols, int n, int v_f32, int d_f32, int out_f32, int ept,
                           void* stream) {
  const Sell t = make_sell(values, indices, counts, row_perm, n_chunks, width, rows_padded, chunk, t_rows, t_cols);
  const int* pos = static_cast<const int*>(positions);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0 && t_rows > 0) {
    if (v_f32 && d_f32)
      spmm_t_dispatch_ept<float, float>(t, pos, x, c, n, ept, out_f32, st);
    else if (v_f32)
      spmm_t_dispatch_ept<float, __nv_bfloat16>(t, pos, x, c, n, ept, out_f32, st);
    else if (d_f32)
      spmm_t_dispatch_ept<__nv_bfloat16, float>(t, pos, x, c, n, ept, out_f32, st);
    else
      spmm_t_dispatch_ept<__nv_bfloat16, __nv_bfloat16>(t, pos, x, c, n, ept, out_f32, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// out (n_chunks, width, rows_padded) = A (rows, k) . B (cols, k) at the slots.
extern "C" int sell_sddmm(const void* indices, const void* counts, const void* row_perm, const void* a,
                          const void* b, void* out, int n_chunks, int width, int rows_padded, int chunk,
                          int rows, int cols, int k, int d_f32, int out_f32, int ept, void* stream) {
  const Sell s = make_sell(nullptr, indices, counts, row_perm, n_chunks, width, rows_padded, chunk, rows, cols);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_chunks > 0 && width > 0 && rows_padded > 0) {
    if (d_f32)
      sddmm_dispatch_ept<float>(s, a, b, out, k, ept, out_f32, st);
    else
      sddmm_dispatch_ept<__nv_bfloat16>(s, a, b, out, k, ept, out_f32, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// out = row softmax of values * scale over the valid slots, in values' dtype.
extern "C" int sell_softmax(const void* values, const void* indices, const void* counts, void* out,
                            int n_chunks, int width, int rows_padded, int chunk, float scale, int v_f32,
                            void* stream) {
  const Sell s = make_sell(values, indices, counts, nullptr, n_chunks, width, rows_padded, chunk, 0, 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_chunks > 0 && width > 0 && rows_padded > 0) {
    const dim3 grid(rows_padded / 32);
    if (v_f32)
      sell_softmax_kernel<float><<<grid, THREADS, 0, st>>>(s, static_cast<float*>(out), scale);
    else
      sell_softmax_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(s, static_cast<__nv_bfloat16*>(out),
                                                                   scale);
  }
  return static_cast<int>(cudaGetLastError());
}
