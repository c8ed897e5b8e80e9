// Fixed-order reductions over batch rows, shared by the backward kernels.
//
// The TPU kernels accumulate their weight gradients in a VMEM-resident block
// across a grid that runs in order on one core.  On the H100 blocks run in
// parallel and in no order, so a sum over the batch is taken in two passes:
// each block sums a fixed group of batch rows into its own slot of a partial
// buffer, then a second kernel adds the groups in index order.  No float
// atomics: two runs on the same inputs give the same bits.
//
// An operand is a functor ``float operator()(int p, int b, int m, int t)``:
// problem p (a head, or 0), batch row b, output index m, summed index t.
// The functor applies the reference's roundings and layout, so one tiled
// product serves every weight gradient of the port.
//
// Two forms of the tiled product, both on the tensor cores (the attention,
// FFN and NLL backwards): 3xTF32 on mma.sync m16n8k8 in f32, bf16 mma.sync
// m16n8k16 with f32 accumulation in bf16, where every operand is already a
// bf16 value (the reference's casts), so each product is exact and only the
// order of the f32 sums differs from an f32 loop.  reduce_outer_mma takes
// functor operands; reduce_outer_copy takes operands that lie contiguous in
// t (Rows) and stages them by raw copies.  The warp-level products
// (mma_step, mma_step_s8) serve the attention passes too.
#pragma once

#include "common.cuh"

#include <stddef.h>
#include <stdint.h>

namespace commu {

constexpr int kRedThreads = 256;
constexpr int kRedBM = 64;  // output rows per block
constexpr int kRedBN = 64;  // output columns per block
constexpr int kMmaBK = 32;           // summed indices per chunk, tensor-core form
constexpr int kMmaPad = kMmaBK + 4;  // its row stride: 4 mod 32 words

// ---- warp-level tensor-core products on operands staged as f32 in shared
// memory.  Fragments of m16n8 (g = lane / 4, q = lane % 4): A rows g, g + 8;
// B column g; C rows g, g + 8 x columns 2q, 2q + 1.

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (finite x): to nearest,
// ties away from zero, the low 13 bits cleared
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// the 3xTF32 split of x: hi = rna(x), lo = rna(x - hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// two bf16 values in one register, the lower depth index in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// int8 x int8 -> int32: exact, so the order of the sums changes no bit
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// depth of one step: 8 in f32 (TF32), 16 in bf16
template <typename S>
constexpr int kMmaK = sizeof(S) == 4 ? 8 : 16;

// One depth step of a warp's MI x NI tiles of m16n8: acc[mi][ni] += A B over
// depth [0, kMmaK<S>), with A's element (m, k) at a[m * a_m + k * a_k] (tile
// mi at rows 16 mi) and B's element (k, n) at b[k * b_k + n * b_n] (tile ni
// at columns 8 ni).  f32: 3xTF32, the small terms first, each pass over all
// the warp's accumulators; bf16: the staged values are bf16 values already.
// The staged operands are f32, or bf16 (TA, TB), widened as they are read;
// a bf16 operand is exact in TF32, so its lo part is zero and the f32 form
// skips the pass that multiplies it (the sums keep every bit).
template <typename S, int MI, int NI, typename TA, typename TB>
__device__ __forceinline__ void mma_step(float (&acc)[MI][NI][4], const TA* a, int a_m, int a_k,
                                         const TB* b, int b_k, int b_n, int lane) {
  const int g = lane / 4, q = lane % 4;
  if constexpr (sizeof(S) == 4) {
    uint32_t ah[MI][4], al[MI][4], bh[NI][2], bl[NI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const TA* p = a + (16 * mi + g) * a_m + q * a_k;
      split_tf32(to_f(p[0]), ah[mi][0], al[mi][0]);
      split_tf32(to_f(p[8 * a_m]), ah[mi][1], al[mi][1]);
      split_tf32(to_f(p[4 * a_k]), ah[mi][2], al[mi][2]);
      split_tf32(to_f(p[8 * a_m + 4 * a_k]), ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const TB* p = b + q * b_k + (8 * ni + g) * b_n;
      split_tf32(to_f(p[0]), bh[ni][0], bl[ni][0]);
      split_tf32(to_f(p[4 * b_k]), bh[ni][1], bl[ni][1]);
    }
    if constexpr (sizeof(TA) == 4) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_tf32(acc[mi][ni], al[mi], bh[ni]);
    }
    if constexpr (sizeof(TB) == 4) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_tf32(acc[mi][ni], ah[mi], bl[ni]);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_tf32(acc[mi][ni], ah[mi], bh[ni]);
  } else {
    uint32_t af[MI][4], bf[NI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const TA* p = a + (16 * mi + g) * a_m + 2 * q * a_k;
      af[mi][0] = pack_bf16(to_f(p[0]), to_f(p[a_k]));
      af[mi][1] = pack_bf16(to_f(p[8 * a_m]), to_f(p[8 * a_m + a_k]));
      af[mi][2] = pack_bf16(to_f(p[8 * a_k]), to_f(p[9 * a_k]));
      af[mi][3] = pack_bf16(to_f(p[8 * a_m + 8 * a_k]), to_f(p[8 * a_m + 9 * a_k]));
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const TB* p = b + 2 * q * b_k + (8 * ni + g) * b_n;
      bf[ni][0] = pack_bf16(to_f(p[0]), to_f(p[b_k]));
      bf[ni][1] = pack_bf16(to_f(p[8 * b_k]), to_f(p[9 * b_k]));
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
  }
}

// One 32-deep step of int8 products: A as words of four consecutive depth
// values of a row, word (m, w) at a[m * a_m + w]; B as words of four
// consecutive depth values of a column, word (w, n) at b[w * b_w + n].
template <int MI, int NI>
__device__ __forceinline__ void mma_step_s8(int (&acc)[MI][NI][4], const int* a, int a_m,
                                            const int* b, int b_w, int lane) {
  const int g = lane / 4, q = lane % 4;
  uint32_t af[MI][4], bf[NI][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int* p = a + (16 * mi + g) * a_m + q;
    af[mi][0] = static_cast<uint32_t>(p[0]);
    af[mi][1] = static_cast<uint32_t>(p[8 * a_m]);
    af[mi][2] = static_cast<uint32_t>(p[4]);
    af[mi][3] = static_cast<uint32_t>(p[8 * a_m + 4]);
  }
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int* p = b + q * b_w + 8 * ni + g;
    bf[ni][0] = static_cast<uint32_t>(p[0]);
    bf[ni][1] = static_cast<uint32_t>(p[4 * b_w]);
  }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
}

// partial[p][g][m][n] = sum over rows b of group g, t < len, of
//                       A(p, b, m, t) * B(p, b, n, t)
// on the tensor cores (S = float: 3xTF32; bf16: bf16 products).  A block's 64 x 64 tile takes 8 warps, 2 down x 4 across, each
// 32 x 16; the summed index is staged 32 at a time, t fastest across threads
// (t-minor operands load coalesced), both tiles t-minor with a row stride of
// 4 mod 32 words, so every fragment load hits 32 distinct banks.
template <typename S, class OpA, class OpB>
__global__ void __launch_bounds__(kRedThreads)
outer_partial_mma_kernel(OpA op_a, OpB op_b, float* __restrict__ partial, int M, int N,
                         int rows, int len, int groups, int rows_per_group) {
  __shared__ __align__(16) float a_s[kRedBM][kMmaPad];
  __shared__ __align__(16) float b_s[kRedBN][kMmaPad];
  const int m0 = blockIdx.x * kRedBM;
  const int n0 = blockIdx.y * kRedBN;
  const int p = blockIdx.z / groups;
  const int g = blockIdx.z - p * groups;
  const int b_begin = g * rows_per_group;
  const int b_end = min(rows, b_begin + rows_per_group);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  float acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int b = b_begin; b < b_end; ++b) {
    for (int t0 = 0; t0 < len; t0 += kMmaBK) {
#pragma unroll
      for (int e = 0; e < kMmaBK * kRedBM / kRedThreads; ++e) {
        const int idx = tid + kRedThreads * e;
        const int tt = idx % kMmaBK;
        const int mm = idx / kMmaBK;
        const int t = t0 + tt;
        a_s[mm][tt] = (m0 + mm < M && t < len) ? op_a(p, b, m0 + mm, t) : 0.f;
        b_s[mm][tt] = (n0 + mm < N && t < len) ? op_b(p, b, n0 + mm, t) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kMmaBK; kk += kMmaK<S>)
        mma_step<S>(acc, &a_s[32 * wm][kk], kMmaPad, 1, &b_s[16 * wn][kk], 1, kMmaPad, lane);
      __syncthreads();
    }
  }
  float* out = partial + static_cast<size_t>(blockIdx.z) * M * N;
  const int gr = lane / 4, q = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + 32 * wm + 16 * mi + gr + 8 * half;
      if (m >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = n0 + 16 * wn + 8 * ni + 2 * q + c;
          if (n < N) out[static_cast<size_t>(m) * N + n] = acc[mi][ni][2 * half + c];
        }
    }
}

// ---- the same sums for operands that lie contiguous in t: staged by raw
// 16-byte cp.async copies through a ring of kCpStages shared-memory tiles
// (the next chunks in flight while the warps multiply the current one), a
// 128 x 128 tile a block, 8 warps of 64 x 32.  Element (b, m, t) of an
// operand of storage type T lies at ptr[b sb + m sm + (t / run) sr + t % run]
// (a ring read by layer: run = Tb, one slab after another); run and len are
// whole chunks.  A rounding the reference applies (rnd<bf16> of an f32
// workspace) happens where a fragment is built from the staged value.
constexpr int kCpBM = 128;   // output rows and columns per block
constexpr int kCpBK = 32;    // t per chunk
constexpr int kCpStages = 3;

template <typename T>
struct Rows {
  const T* ptr;
  long long sb, sm, sr;
  int run;
};

// staged row stride in elements: 4 mod 32 words (36 floats, 40 bf16), a
// whole number of 16-byte copies
template <typename T>
__host__ __device__ constexpr int cp_stride() {
  return sizeof(T) == 4 ? kCpBK + 4 : kCpBK + 8;
}

template <typename TA, typename TB>
__host__ __device__ constexpr int cp_stage_bytes() {
  return kCpBM * (cp_stride<TA>() * static_cast<int>(sizeof(TA)) +
                  cp_stride<TB>() * static_cast<int>(sizeof(TB)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows r0 .. r0 + 127 (zeros from rows_lim on), t0 .. t0 + kCpBK - 1 of
// batch row b into dst [kCpBM][cp_stride<T>()]
template <typename T>
__device__ __forceinline__ void cp_tile(T* dst, const Rows<T>& op, int b, int r0, int rows_lim,
                                        int t0, int tid) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kPerRow = kCpBK / kVec;
  const long long toff = static_cast<long long>(t0 / op.run) * op.sr + t0 % op.run;
  const T* base = op.ptr + b * op.sb + toff;
#pragma unroll
  for (int i = 0; i < kCpBM * kPerRow / kRedThreads; ++i) {
    const int idx = tid + kRedThreads * i;
    const int r = idx / kPerRow, c = (idx % kPerRow) * kVec;
    const bool in = r0 + r < rows_lim;
    cp_async16(dst + r * cp_stride<T>() + c, in ? base + (r0 + r) * op.sm + c : op.ptr, in);
  }
}

// the bf16 pair (k, k + 1) at p as one register: an f32 value rounds to
// bf16 here, a bf16 pair is read as it lies
__device__ __forceinline__ uint32_t pair_bf16(const float* p) { return pack_bf16(p[0], p[1]); }
__device__ __forceinline__ uint32_t pair_bf16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename S, typename TA, typename TB>
__global__ void __launch_bounds__(kRedThreads, 2)
outer_partial_copy_kernel(Rows<TA> op_a, Rows<TB> op_b, float* __restrict__ partial, int M,
                          int N, int rows, int len, int groups, int rows_per_group) {
  extern __shared__ __align__(16) unsigned char cp_smem[];
  constexpr int kSA = cp_stride<TA>(), kSB = cp_stride<TB>();
  const int m0 = blockIdx.x * kCpBM, n0 = blockIdx.y * kCpBM;
  const int g = blockIdx.z;
  const int b_begin = g * rows_per_group;
  const int b_end = min(rows, b_begin + rows_per_group);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;  // rows 64 wm, columns 32 wn
  const int gr = lane / 4, q = lane % 4;
  auto a_tile = [&](int s) {
    return reinterpret_cast<TA*>(cp_smem + s * cp_stage_bytes<TA, TB>());
  };
  auto b_tile = [&](int s) { return reinterpret_cast<TB*>(a_tile(s) + kCpBM * kSA); };
  const int chunks = len / kCpBK;
  const int total = (b_end - b_begin) * chunks;
  auto fetch = [&](int kt) {
    const int b = b_begin + kt / chunks, t0 = (kt % chunks) * kCpBK, s = kt % kCpStages;
    cp_tile(a_tile(s), op_a, b, m0, M, t0, tid);
    cp_tile(b_tile(s), op_b, b, n0, N, t0, tid);
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int kt = 0; kt < kCpStages - 1; ++kt) {
    if (kt < total) fetch(kt);
    cp_async_commit();
  }
  for (int kt = 0; kt < total; ++kt) {
    cp_async_wait<kCpStages - 2>();  // chunk kt has landed (this thread's copies)
    __syncthreads();                 // ... everyone's; stage (kt - 1) is free
    if (kt + kCpStages - 1 < total) fetch(kt + kCpStages - 1);
    cp_async_commit();
    const TA* a_s = a_tile(kt % kCpStages) + 64 * wm * kSA;
    const TB* b_s = b_tile(kt % kCpStages) + 32 * wn * kSB;
    if constexpr (sizeof(S) == 4) {
#pragma unroll
      for (int kb = 0; kb < kCpBK; kb += 8)
        mma_step<S>(acc, a_s + kb, kSA, 1, b_s + kb, 1, kSB, lane);
    } else {
#pragma unroll
      for (int kb = 0; kb < kCpBK; kb += 16) {
        uint32_t af[4][4], bf[4][2];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const TA* p = a_s + (16 * mi + gr) * kSA + kb + 2 * q;
          af[mi][0] = pair_bf16(p);
          af[mi][1] = pair_bf16(p + 8 * kSA);
          af[mi][2] = pair_bf16(p + 8);
          af[mi][3] = pair_bf16(p + 8 * kSA + 8);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const TB* p = b_s + (8 * ni + gr) * kSB + kb + 2 * q;
          bf[ni][0] = pair_bf16(p);
          bf[ni][1] = pair_bf16(p + 8);
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
      }
    }
  }
  cp_async_wait<0>();

  float* out = partial + static_cast<size_t>(g) * M * N;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + 64 * wm + 16 * mi + gr + 8 * half;
      if (m >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = n0 + 32 * wn + 8 * ni + 2 * q + c;
          if (n < N) out[static_cast<size_t>(m) * N + n] = acc[mi][ni][2 * half + c];
        }
    }
}

// out[p][i] = sum over g, in index order, of partial[p][g][i]  (i < n)
static __global__ void __launch_bounds__(kRedThreads)
sum_groups_kernel(const float* __restrict__ partial, float* __restrict__ out, int n, int groups,
                  int problems) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kRedThreads + threadIdx.x;
  if (idx >= static_cast<size_t>(n) * problems) return;
  const size_t p = idx / n;
  const size_t i = idx - p * n;
  const float* src = partial + p * groups * static_cast<size_t>(n) + i;
  float s = 0.f;
  for (int g = 0; g < groups; ++g) s += src[static_cast<size_t>(g) * n];
  out[idx] = s;
}

// How a sum over ``rows`` batch rows splits into groups: enough blocks to
// fill the card about four times over, at most one group per row.
struct Split {
  int groups;
  int rows_per_group;
};

// The most terms (rows x len) one group's partial sum takes: the tensor
// cores' f32 accumulation drifts with the depth it sums (by 2e-4 of the
// largest sum over 29,696 terms, dWk at units 1024), so a deep sum is split
// into more groups.  ModelConfig()'s deepest sum (dWk: 8 rows of 1024) sits
// at the cap, so its groups are what they were without one.
constexpr int kMaxGroupTerms = 8192;

// About four blocks an SM over the tiles, each group at most
// kMaxGroupTerms / len rows.
inline Split split_rows(int rows, int tiles, int len) {
  const int want = (4 * 132 + tiles - 1) / tiles;
  int groups = want < rows ? want : rows;
  if (groups < 1) groups = 1;
  int rpg = (rows + groups - 1) / groups;
  const int cap = len > 0 && len < kMaxGroupTerms ? kMaxGroupTerms / len : 1;
  if (rpg > cap) rpg = cap;
  return Split{(rows + rpg - 1) / rpg, rpg};
}

inline int outer_tiles(int M, int N) {
  return ((M + kRedBM - 1) / kRedBM) * ((N + kRedBN - 1) / kRedBN);
}

// Bytes of partial buffer that reduce_outer_mma needs (len: the summed
// index's extent).
inline size_t outer_scratch(int P, int M, int N, int rows, int len) {
  const Split s = split_rows(rows, P * outer_tiles(M, N), len);
  return sizeof(float) * static_cast<size_t>(P) * s.groups * M * N;
}

inline cudaError_t sum_groups(const float* partial, float* out, int n, int groups, int problems,
                              cudaStream_t stream) {
  const size_t total = static_cast<size_t>(n) * problems;
  const unsigned blocks = static_cast<unsigned>((total + kRedThreads - 1) / kRedThreads);
  sum_groups_kernel<<<blocks, kRedThreads, 0, stream>>>(partial, out, n, groups, problems);
  return cudaGetLastError();
}

// out[p][m][n] = sum over b < rows, t < len of A(p, b, m, t) * B(p, b, n, t)
// on the tensor cores, for operands of storage type S, in a fixed order;
// ``scratch`` holds outer_scratch(P, M, N, rows) bytes.
template <typename S, class OpA, class OpB>
cudaError_t reduce_outer_mma(OpA op_a, OpB op_b, float* out, float* scratch, int P, int M, int N,
                             int rows, int len, cudaStream_t stream) {
  const Split s = split_rows(rows, P * outer_tiles(M, N), len);
  const dim3 grid((M + kRedBM - 1) / kRedBM, (N + kRedBN - 1) / kRedBN, P * s.groups);
  outer_partial_mma_kernel<S><<<grid, kRedThreads, 0, stream>>>(op_a, op_b, scratch, M, N, rows,
                                                                len, s.groups, s.rows_per_group);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_groups(scratch, out, M * N, s.groups, P, stream);
}

inline int copy_tiles(int M, int N) {
  return ((M + kCpBM - 1) / kCpBM) * ((N + kCpBM - 1) / kCpBM);
}

// Whether two t-contiguous operands can take reduce_outer_copy: whole
// chunks in every run and in len (16-byte copies stay aligned then).
template <typename TA, typename TB>
inline bool copyable(const Rows<TA>& a, const Rows<TB>& b, int len) {
  return len % kCpBK == 0 && a.run % kCpBK == 0 && b.run % kCpBK == 0;
}

// Bytes of partial buffer that reduce_outer_copy needs (len: the summed
// index's extent).
inline size_t copy_scratch(int M, int N, int rows, int len) {
  const Split s = split_rows(rows, copy_tiles(M, N), len);
  return sizeof(float) * static_cast<size_t>(s.groups) * M * N;
}

// out[m][n] = sum over b < rows, t < len of A(b, m, t) * B(b, n, t) on the
// tensor cores (S as in reduce_outer_mma), from operands staged by raw
// copies; ``scratch`` holds copy_scratch(M, N, rows) bytes.
template <typename S, typename TA, typename TB>
cudaError_t reduce_outer_copy(const Rows<TA>& a, const Rows<TB>& b, float* out, float* scratch,
                              int M, int N, int rows, int len, cudaStream_t stream) {
  const Split s = split_rows(rows, copy_tiles(M, N), len);
  const dim3 grid((M + kCpBM - 1) / kCpBM, (N + kCpBM - 1) / kCpBM, s.groups);
  constexpr size_t smem = static_cast<size_t>(kCpStages) * cp_stage_bytes<TA, TB>();
  cudaError_t err = allow_smem(outer_partial_copy_kernel<S, TA, TB>, smem);
  if (err != cudaSuccess) return err;
  outer_partial_copy_kernel<S, TA, TB><<<grid, kRedThreads, smem, stream>>>(
      a, b, scratch, M, N, rows, len, s.groups, s.rows_per_group);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_groups(scratch, out, M * N, s.groups, 1, stream);
}

// A bump allocator over a caller-provided workspace (256-byte aligned
// slices); with a null base it only counts the bytes.
struct Workspace {
  char* base;
  size_t used;
  template <typename T>
  T* take(size_t count) {
    const size_t bytes = (count * sizeof(T) + 255) / 256 * 256;
    T* ptr = base ? reinterpret_cast<T*>(base + used) : nullptr;
    used += bytes;
    return ptr;
  }
};

}  // namespace commu
