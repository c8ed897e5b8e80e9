// The attention backward passes at the wide widths, and the launches that
// choose a pass's form by shape.
//
// ModelConfig()'s widths (dh <= 64, 2F 256 or 512) run the first forms of
// rel_attention_bwd_passes.cuh.  Every other width runs the forms here:
// Transformer-XL's published widths at ComMU's depth (units 768 / 12 heads:
// dh 64, 2F 768; 1024 / 8: dh 128, 2F 1024; 1024 / 4: dh 256, 2F 1024;
// 1536 / 12: dh 128, 2F 1536) and any dh up to 256 with any 2F a multiple
// of 256 (narrow_widths picks the form; the dh bound of a form is its
// template's):
//   (A) bwd_rows_kernel, then bwd_keys_wide_kernel<S, 64, 128 or 256>;
//   (B) bwd_queries_split_kernel<S, 64, 128 or 256>, then dq_finish_kernel.
// They compute what the first forms compute, with the same roundings (see
// rel_attention_bwd_passes.cuh's header), and feed the same batch sums.
//
// What bounds them on the H100 (chip_smoke.py --passes --wide, PERF.md §6):
// neither the products nor the bytes.  A form that stages its operands by
// scalar loads with nothing in flight, re-reads ds for every 2F chunk, or
// forms dP twice a key tile runs at 3-15% of its bound; so the design keeps
// loads in flight under the products and each operand read once a block.
//
// Design.  Both passes run 16 warps an SM and bring their operands in
// through a cp.async ring (16-byte copies, up to three stages where shared
// memory holds them) in the operand's own type: bf16 stays
// bf16 in shared memory and reaches mma.sync through ldmatrix; f32 keeps
// reduce.cuh's 3xTF32 fragments.  Shapes whose rows and 16-byte vectors do
// not lie aligned (T or a ring slab no multiple of 8 keys, an operand off a
// 16-byte boundary: vec_rows) stage the same tiles by plain loads.
//   (A) bwd_rows_kernel forms each query's Dr = rowsum(dO * O), summed over
//       d in order as the first form sums it (to the bit), and qw =
//       rnd(rnd(q * scale) + rwbs) [B, H, dh, T], once, where every key
//       tile formed both again.  bwd_keys_wide_kernel then runs one block a
//       (b, h, 64 keys) over the queries 32 at a time, each chunk's dO, qw,
//       S tile, lse and Dr through the ring: dP once per tile at every dh
//       (f32: the FMA loop over d in the first form's order, whose bits the
//       int8 quantiser of ds needs; bf16 on mma.sync), P and ds where dP
//       lies, then dk and dv split over head dims and keys across the warps
//       (4 x kDh / 4 dims by 16 or 32 keys: 32 accumulators a thread at dh
//       128 in bf16, 64 at dh 256 and in f32).  bf16 and f32 at dh 256 run
//       one block of 16 warps an SM (f32 at dh 256 with one stage: v and a
//       chunk's dO and qw take 147 KB); f32 up to dh 128 two blocks of 8
//       warps an SM, one stage at dh 128, so one block's loads run under
//       the other's products.
//   (B) bwd_queries_split_kernel takes 2F's chunks of 256 columns (128 of
//       the cos half, the same 128 of the sin half, so a thread holds both
//       terms of its du) as a grid dimension, and k ds_c^T as one more
//       block beside them: block x of (x, 128-query tile, b h) runs chunk x,
//       or k ds_c^T for x = 2F / 256.  The blocks of one query tile launch
//       side by side, so ds comes from HBM once and from L2 for the others
//       (a tile's ds is 128 x K x 4 bytes, 590 KB at K = 1152).  A chunk
//       block forms dphi over every key (16 warps of 32 rows x 32 columns
//       of each half: 64 accumulators a thread, against 32 of a 64-row
//       block, which read psi twice as often from L2 and loaded twice the
//       fragments a product; psi's columns staged so each warp's cos and
//       sin columns lie side by side), then du (written, with its
//       per-block row sums) and its share of W_r du^T into a workspace slot
//       of its own [2F / 256][B, H, dh, T]; the k block writes k ds_c^T
//       [B, H, dh, T] and its row sums.  dq_finish_kernel adds the chunks'
//       shares in chunk order, then k ds_c^T: dq = scale (k ds_c^T + sum_c
//       pos_c).  No float atomics: two runs give the same bits.  The int8
//       form quantises its stage of ds once (each row's scale from pass
//       A's per-64-key-tile maxima, the whole row's, as before) and sums on
//       mma.sync m16n8k32.  (In f32, splitting ds into 3xTF32's hi and lo
//       once a stage, where each column warp splits it again, gained 1-3%
//       on 64-row blocks, and once a key step for both halves nothing on
//       these: neither the splits nor their loads bound the loop.)
//       The bias gradients run as bias_sums_kernel (one thread a column)
//       and bias_rr_kernel (a warp a row of W_r), where the first form's
//       one block a head took up to 0.84 ms a launch.
// ds stays f32 in the workspace in every form: the int8 and lever forms
// quantise it unrounded, and in the exact bf16 form halving it would save
// one write and one HBM read of B H T K x 2 bytes, 1.8 GB a launch at 1536
// / 12, about 0.5 ms at the card's 3.35 TB/s, of a bf16 launch of 42 ms
// (PERF.md §6).
// Everything here has internal linkage: each source that includes this file
// compiles its own copy.
#pragma once

#include "rel_attention_bwd_passes.cuh"

#include <stdint.h>

namespace {

constexpr int kWThreads = 512;  // threads a block of the wide passes: 16 warps
constexpr int kWAQ = 32;        // queries a chunk of the wide pass A
constexpr int kFC = 256;        // 2F columns a chunk block of the wide pass B

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The shapes whose staged rows lie 16-byte aligned and whose vectors of 8
// keys lie within one ring slab (or the window): cp.async; else plain loads.
inline bool vec_rows(int T, int R, int Tb) { return T % 8 == 0 && (R == 0 || Tb % 8 == 0); }

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ int zero_of<int>() { return 0; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() { return __float2bfloat16(0.f); }

// One 16-byte vector into shared memory: src[e] for e < n, zeros past n (n
// is 0 or the whole vector where ``vec``).  ``any``: a valid address for a
// copy that reads nothing.
template <typename T>
__device__ __forceinline__ void stage_vec(T* dst, const T* src, int n, bool vec,
                                          const void* any) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  if (vec) {
    commu::cp_async16(dst, n > 0 ? static_cast<const void*>(src) : any, n > 0);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[e] = e < n ? src[e] : zero_of<T>();
  }
}

// 16 keys (kAK / 4 vectors of 4 f32, or of 8 bf16) of one head dim of key
// tile j0 of (b, h) into dst[0 ..): the vector at key j0 + e0 from the ring
// slab or the window key_column finds (one slab holds it where ``vec``).
template <typename S>
__device__ __forceinline__ void stage_keys(S* dst, const S* mem, const S* win, int b, int h,
                                           int j, int d, int H, int dh, int R, int Tb, int T,
                                           int M, int K, bool vec, const void* any) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(S));
  if (vec) {
    const bool in = j < K && d < dh;
    int stride = 0;
    const S* col = commu::key_column(mem, win, b, h, in ? j : 0, H, dh, R, Tb, T, M, &stride);
    commu::cp_async16(dst, in ? static_cast<const void*>(col + static_cast<size_t>(d) * stride)
                              : any, in);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      S x = zero_of<S>();
      if (j + e < K && d < dh) {
        int stride = 0;
        const S* col = commu::key_column(mem, win, b, h, j + e, H, dh, R, Tb, T, M, &stride);
        x = col[static_cast<size_t>(d) * stride];
      }
      dst[e] = x;
    }
  }
}

// ---- bf16 fragments through ldmatrix (m16n8k16: A rows g, g + 8 and depth
// 2q, 2q + 1, + 8; B depth 2q, 2q + 1, + 8 of column g).  P1: lane l gives
// row l % 16, column 8 (l / 16); P2: row l % 8 + 8 (l / 16), column
// 8 ((l / 8) % 2).
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// A [m][k] (k contiguous, row stride ld) at its 16 x 16 tile's origin: P1
__device__ __forceinline__ void frag_a_mk(uint32_t (&a)[4], const __nv_bfloat16* p, int ld,
                                          int lane) {
  ldsm_x4(a, p + (lane % 16) * ld + (lane / 16) * 8);
}

// A [k][m] (m contiguous): P2, transposed
__device__ __forceinline__ void frag_a_km(uint32_t (&a)[4], const __nv_bfloat16* p, int ld,
                                          int lane) {
  ldsm_x4_t(a, p + (lane % 8 + (lane / 16) * 8) * ld + ((lane / 8) % 2) * 8);
}

// B [k][n] (n contiguous) of two n-tiles: P1, transposed
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[2][2], const __nv_bfloat16* p, int ld,
                                          int lane) {
  uint32_t r[4];
  ldsm_x4_t(r, p + (lane % 16) * ld + (lane / 16) * 8);
  b[0][0] = r[0], b[0][1] = r[1], b[1][0] = r[2], b[1][1] = r[3];
}

// B [n][k] (k contiguous) of two n-tiles: P2
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[2][2], const __nv_bfloat16* p, int ld,
                                          int lane) {
  uint32_t r[4];
  ldsm_x4(r, p + (lane % 8 + (lane / 16) * 8) * ld + ((lane / 8) % 2) * 8);
  b[0][0] = r[0], b[0][1] = r[1], b[1][0] = r[2], b[1][1] = r[3];
}

// A [m][k] f32 (k contiguous, even ld), rounded to bf16 pairs (values that
// are bf16 already stay as they are; ds before its rounding rounds here, as
// rnd<S> rounds it)
__device__ __forceinline__ void frag_a_f32(uint32_t (&a)[4], const float* p, int ld, int lane) {
  const int g = lane / 4, q = lane % 4;
  const float* r0 = p + g * ld + 2 * q;
  const float* r1 = r0 + 8 * ld;
  const float2 x0 = *reinterpret_cast<const float2*>(r0);
  const float2 x1 = *reinterpret_cast<const float2*>(r1);
  const float2 x2 = *reinterpret_cast<const float2*>(r0 + 8);
  const float2 x3 = *reinterpret_cast<const float2*>(r1 + 8);
  a[0] = commu::pack_bf16(x0.x, x0.y);
  a[1] = commu::pack_bf16(x1.x, x1.y);
  a[2] = commu::pack_bf16(x2.x, x2.y);
  a[3] = commu::pack_bf16(x3.x, x3.y);
}

// two S values, already rounded to S, as one aligned pair
template <typename S>
__device__ __forceinline__ void store_pair(S* p, float x, float y) {
  if constexpr (sizeof(S) == 4) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  }
}

// ---- pass A past dh 64

// Dr = rowsum(dO * O) over d in order, and qw = rnd(rnd(q * scale) + rwbs)
// in S: one thread a query of (b, h)
template <typename S>
__global__ void __launch_bounds__(128)
bwd_rows_kernel(const S* __restrict__ q, const S* __restrict__ rwbs, const S* __restrict__ out,
                const S* __restrict__ dout, float* __restrict__ dr, S* __restrict__ qw, int H,
                int dh, int T, float scale) {
  const int bh = blockIdx.y, h = bh % H;
  const int i = blockIdx.x * 128 + threadIdx.x;
  if (i >= T) return;
  const size_t off = static_cast<size_t>(bh) * dh * T + i;
  const float scale_s = commu::rnd<S>(scale);
  float acc = 0.f;
  for (int d = 0; d < dh; ++d) {
    const size_t at = off + static_cast<size_t>(d) * T;
    acc = fmaf(commu::to_f(dout[at]), commu::to_f(out[at]), acc);
    const float qs = commu::rnd<S>(commu::to_f(q[at]) * scale_s);
    qw[at] = commu::from_f<S>(qs + commu::to_f(rwbs[h * dh + d]));
  }
  dr[static_cast<size_t>(bh) * T + i] = acc;
}

// Shared memory of bwd_keys_wide_kernel, in elements of S: v [kDh][kVs],
// the ring of kStages chunks (dO and qw [kDh][kQs] each), rnd(probs) and
// ds_c [kWAQ][kPs]; then f32: the ring's S tiles [kStages][kWAQ][kSs], lse
// and Dr [kStages][2][kWAQ], and the row maxima of the 8 key groups
// [8][kWAQ].  Row strides 4 or 8 mod 32 words (f32: the fragments' banks;
// bf16: ldmatrix's 16-byte rows).
template <typename S, int kDh>
struct WideA {
  // f32 up to dh 128: two blocks of 8 warps an SM (one stage at dh 128,
  // where two fit 227 KB); else one block of 16 warps
  static constexpr bool kPair = sizeof(S) == 4 && kDh <= 128;
  static constexpr int kThreads = kPair ? 256 : kWThreads;
  static constexpr int kBlocks = kPair ? 2 : 1;
  static constexpr int kStages = sizeof(S) == 4 ? (kDh <= 64 ? 2 : 1) : 3;
  static constexpr int kVs = kAK + 8;
  static constexpr int kQs = kWAQ + (sizeof(S) == 4 ? 4 : 8);
  static constexpr int kPs = kAK + 8;
  static constexpr int kSs = kAK + 8;
  static constexpr int kStage = 2 * kDh * kQs;
  static constexpr size_t kBytes =
      sizeof(S) * (static_cast<size_t>(kDh) * kVs + kStages * kStage + 2 * kWAQ * kPs) +
      sizeof(float) * (kStages * (kWAQ * kSs + 2 * kWAQ) + 8 * kWAQ);
};

template <typename S, int kDh, bool kNoDk = false>
__global__ void __launch_bounds__(WideA<S, kDh>::kThreads, WideA<S, kDh>::kBlocks)
bwd_keys_wide_kernel(const S* __restrict__ qw_buf, const S* __restrict__ v_mem,
                     const S* __restrict__ v_win, const float* __restrict__ s_res,
                     const float* __restrict__ lse, const float* __restrict__ dr_buf,
                     const S* __restrict__ dout, float* __restrict__ ds_buf,
                     float* __restrict__ amax_buf, float* __restrict__ dk_mem,
                     float* __restrict__ dv_mem, S* __restrict__ dk_win, S* __restrict__ dv_win,
                     int H, int dh, int T, int R, int Tb, int seed, commu::Plane plane,
                     bool raw_ds, bool vec) {
  using L = WideA<S, kDh>;
  constexpr int kNT = L::kThreads;
  constexpr int kMI = kDh / 64;          // 16-row tiles of dims a warp, in dk and dv
  constexpr int kPN = 16 * 32 / kNT;     // n-tiles of 8 keys a warp in dP: 1 or 2
  constexpr int kKW = 64 * 128 / kNT;    // keys a warp in dk and dv: 16 or 32
  constexpr int kNK = kKW / 8;           // ... as n-tiles
  constexpr int kV = 16 / static_cast<int>(sizeof(S));
  static_assert(sizeof(S) == 4 || kNT == kWThreads, "bf16 runs 16 warps a block");
  extern __shared__ __align__(16) unsigned char wide_a_smem[];
  S* v_s = reinterpret_cast<S*>(wide_a_smem);   // [kDh][kVs]: v[d][key]
  S* ring = v_s + kDh * L::kVs;                 // [kStages]: dO, qw [kDh][kQs] each
  S* p_s = ring + L::kStages * L::kStage;       // [kWAQ][kPs]: rnd(probs)[query][key]
  S* ds_s = p_s + kWAQ * L::kPs;                // [kWAQ][kPs]: ds_c[query][key]
  float* sres_s = reinterpret_cast<float*>(ds_s + kWAQ * L::kPs);  // [kStages][kWAQ][kSs]
  float* rows_s = sres_s + L::kStages * kWAQ * L::kSs;             // [kStages][2][kWAQ]
  float* rmax_s = rows_s + L::kStages * 2 * kWAQ;                  // [8][kWAQ]
  const int M = R * Tb;
  const int K = M + T;
  const int KT = amax_tiles(K);
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * kAK;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, qd = lane % 4;
  const size_t q_off = static_cast<size_t>(bh) * dh * T;
  const bool drop = plane.thresh > 0;
  const uint32_t drop_seed = commu::plane_seed(seed, b, 4096, h);
  const void* any = dout;
  const int nq = (T + kWAQ - 1) / kWAQ;

  // v of the tile: it joins chunk 0's copies
  for (int idx = tid; idx < kDh * (kAK / kV); idx += kNT) {
    const int d = idx / (kAK / kV), e0 = (idx % (kAK / kV)) * kV;
    stage_keys<S>(v_s + d * L::kVs + e0, v_mem, v_win, b, h, k0 + e0, d, H, dh, R, Tb, T, M, K,
                  vec, any);
  }
  // chunk c's dO, qw, S tile, lse and Dr into stage s
  auto issue = [&](int c, int s) {
    if (c >= nq) return;
    const int i0 = c * kWAQ;
    S* st = ring + s * L::kStage;
    constexpr int kPer = kWAQ / kV;  // vectors a row
    for (int idx = tid; idx < 2 * kDh * kPer; idx += kNT) {
      const int which = idx / (kDh * kPer);  // 0: dO, 1: qw
      const int rem = idx - which * kDh * kPer;
      const int d = rem / kPer, e0 = (rem % kPer) * kV;
      const int n = d < dh ? min(max(T - i0 - e0, 0), kV) : 0;
      stage_vec<S>(st + (which * kDh + d) * L::kQs + e0,
                   (which ? qw_buf : dout) + q_off + static_cast<size_t>(d) * T + i0 + e0, n, vec,
                   any);
    }
    for (int idx = tid; idx < kWAQ * (kAK / 4); idx += kNT) {  // the S tile [kWAQ][kAK]
      const int r = idx / (kAK / 4), e0 = (idx % (kAK / 4)) * 4;
      const int i = i0 + r;
      stage_vec<float>(sres_s + (s * kWAQ + r) * L::kSs + e0,
                       s_res + (static_cast<size_t>(bh) * T + (i < T ? i : 0)) * K + k0 + e0,
                       i < T ? min(max(K - k0 - e0, 0), 4) : 0, vec, any);
    }
    if (tid < 2 * kWAQ / 4) {
      const int which = tid / (kWAQ / 4), e0 = (tid % (kWAQ / 4)) * 4;
      stage_vec<float>(rows_s + (s * 2 + which) * kWAQ + e0,
                       (which ? dr_buf : lse) + static_cast<size_t>(bh) * T + i0 + e0,
                       min(max(T - i0 - e0, 0), 4), vec, any);
    }
  };

  float acc_k[kMI][kNK][4], acc_v[kMI][kNK][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNK; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[mi][ni][e] = acc_v[mi][ni][e] = 0.f;
  const int pm = warp / (8 / kPN), pn = warp % (8 / kPN);  // dP: queries 16 pm, keys 8 kPN pn
  const int wm = warp % 4, wn = warp / 4;  // dk, dv: dims kDh / 4 wm, keys kKW wn
  const int d0 = wm * (kDh / 4);
  const bool pairs = (K & 1) == 0;

#pragma unroll
  for (int s = 0; s < L::kStages - 1; ++s) {
    issue(s, s);
    commu::cp_async_commit();
  }
  for (int c = 0; c < nq; ++c) {
    const int st = c % L::kStages;
    if constexpr (L::kStages == 1) {
      __syncthreads();  // the previous chunk's readers are done
      issue(c, 0);
      commu::cp_async_commit();
      commu::cp_async_wait<0>();
    } else {
      commu::cp_async_wait<L::kStages - 2>();
    }
    __syncthreads();  // chunk c (and v) arrived; the previous chunk's readers are done
    if constexpr (L::kStages > 1) {
      issue(c + L::kStages - 1, (c + L::kStages - 1) % L::kStages);
      commu::cp_async_commit();
    }
    const S* do_st = ring + st * L::kStage;
    const S* qw_st = do_st + kDh * L::kQs;
    const float* lse_st = rows_s + st * 2 * kWAQ;
    const float* dr_st = lse_st + kWAQ;
    const float* sres_st = sres_s + st * kWAQ * L::kSs;
    const int i0 = c * kWAQ;

    // dP = dO^T v, queries 16 pm, keys 8 kPN pn, in the C fragment's
    // places.  f32: an FMA loop over d in order (the first form's bits,
    // which the int8 form's quantiser of ds needs); bf16: on the tensor
    // cores.
    float dp[kPN][4];
#pragma unroll
    for (int ni = 0; ni < kPN; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[ni][e] = 0.f;
    if constexpr (sizeof(S) == 4) {
      for (int d = 0; d < dh; ++d) {
        const float a0 = do_st[d * L::kQs + 16 * pm + g];
        const float a1 = do_st[d * L::kQs + 16 * pm + g + 8];
#pragma unroll
        for (int ni = 0; ni < kPN; ++ni) {
          const float2 v = *reinterpret_cast<const float2*>(
              &v_s[d * L::kVs + 8 * (kPN * pn + ni) + 2 * qd]);
          dp[ni][0] = fmaf(a0, v.x, dp[ni][0]);
          dp[ni][1] = fmaf(a0, v.y, dp[ni][1]);
          dp[ni][2] = fmaf(a1, v.x, dp[ni][2]);
          dp[ni][3] = fmaf(a1, v.y, dp[ni][3]);
        }
      }
    } else {  // over dh padded to 16; the padding is zeros
      const int depth = (dh + 15) / 16 * 16;
      for (int kk = 0; kk < depth; kk += 16) {
        uint32_t a[4], bv[2];
        frag_a_km(a, do_st + kk * L::kQs + 16 * pm, L::kQs, lane);
        ldsm_x2_t(bv, v_s + (kk + lane % 16) * L::kVs + 8 * pn);
        commu::mma_bf16(dp[0], a, bv);
      }
    }
    // P and ds where dP lies: rows g, g + 8, keys 2 qd, 2 qd + 1 of each n-tile
#pragma unroll
    for (int ni = 0; ni < kPN; ++ni)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * pm + g + 8 * half;
      const int row = i0 + r;
      const int kc = 8 * (kPN * pn + ni) + 2 * qd;
      const int j = k0 + kc;
      const size_t at = (static_cast<size_t>(bh) * T + row) * K + j;
      const bool both = row < T && j + 1 < K;
      const float2 s2 = *reinterpret_cast<const float2*>(&sres_st[r * L::kSs + kc]);
      float p2[2], dsc2[2], out2[2], amax = 0.f;
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        float p = 0.f, dsc = 0.f, ds_f = 0.f;
        if (row < T && j + c2 < K) {
          const float dpv = dp[ni][2 * half + c2];
          p = commu::rnd<S>(expf((c2 ? s2.y : s2.x) - lse_st[r]));
          if (drop) {
            const float probs =
                commu::keep(plane, drop_seed, row, j + c2) ? p * plane.scale : 0.f;
            ds_f = probs * dpv - p * dr_st[r];
            p = commu::rnd<S>(probs);  // dv takes the dropped probabilities
          } else {
            ds_f = p * (dpv - dr_st[r]);
          }
          dsc = commu::rnd<S>(ds_f);
          amax = fmaxf(amax, fabsf(ds_f));
        }
        p2[c2] = p, dsc2[c2] = dsc;
        out2[c2] = raw_ds ? ds_f : dsc;  // the int8 forms quantise ds before its rounding
      }
      if (pairs && both) {
        *reinterpret_cast<float2*>(&ds_buf[at]) = make_float2(out2[0], out2[1]);
      } else {
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2)
          if (row < T && j + c2 < K) ds_buf[at + c2] = out2[c2];
      }
      store_pair<S>(p_s + r * L::kPs + kc, p2[0], p2[1]);
      store_pair<S>(ds_s + r * L::kPs + kc, dsc2[0], dsc2[1]);
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
      if (qd == 0) rmax_s[(kPN * pn + ni) * kWAQ + r] = amax;
    }
    __syncthreads();  // P, ds_c and the row maxima written
    if (raw_ds && tid < kWAQ && i0 + tid < T) {
      float m = rmax_s[tid];
#pragma unroll
      for (int p = 1; p < 8; ++p) m = fmaxf(m, rmax_s[p * kWAQ + tid]);
      amax_buf[(static_cast<size_t>(bh) * T + i0 + tid) * KT + blockIdx.x] = m;
    }
    // dv[d, j] += sum_i dO[d, i] P[i, j];  dk[d, j] += sum_i qw[d, i] ds_c[i, j]
    if (d0 < dh) {
#pragma unroll
      for (int kk = 0; kk < kWAQ; kk += commu::kMmaK<S>) {
        if constexpr (sizeof(S) == 4) {
          if constexpr (!kNoDk)
            commu::mma_step<S>(acc_k, qw_st + d0 * L::kQs + kk, L::kQs, 1,
                               ds_s + kk * L::kPs + kKW * wn, L::kPs, 1, lane);
          commu::mma_step<S>(acc_v, do_st + d0 * L::kQs + kk, L::kQs, 1,
                             p_s + kk * L::kPs + kKW * wn, L::kPs, 1, lane);
        } else {
          uint32_t bp[2][2], bd[2][2];  // kNK is 2 at 16 warps
          frag_b_kn(bp, p_s + kk * L::kPs + kKW * wn, L::kPs, lane);
          if constexpr (!kNoDk) frag_b_kn(bd, ds_s + kk * L::kPs + kKW * wn, L::kPs, lane);
#pragma unroll
          for (int mi = 0; mi < kMI; ++mi) {
            uint32_t a[4];
            frag_a_mk(a, do_st + (d0 + 16 * mi) * L::kQs + kk, L::kQs, lane);
#pragma unroll
            for (int ni = 0; ni < 2; ++ni) commu::mma_bf16(acc_v[mi][ni], a, bp[ni]);
            if constexpr (!kNoDk) {
              frag_a_mk(a, qw_st + (d0 + 16 * mi) * L::kQs + kk, L::kQs, lane);
#pragma unroll
              for (int ni = 0; ni < 2; ++ni) commu::mma_bf16(acc_k[mi][ni], a, bd[ni]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int d = d0 + 16 * mi + g + 8 * half;
      if (d >= dh) continue;
#pragma unroll
      for (int ni = 0; ni < kNK; ++ni)
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) {
          const int j = k0 + kKW * wn + 8 * ni + 2 * qd + c2;
          if (j >= K) continue;
          const float kv = acc_k[mi][ni][2 * half + c2], vv = acc_v[mi][ni][2 * half + c2];
          if (j < M) {
            const size_t at = (static_cast<size_t>(bh) * dh + d) * M + j;
            if constexpr (!kNoDk) dk_mem[at] = kv;
            dv_mem[at] = vv;
          } else {
            const size_t at = q_off + static_cast<size_t>(d) * T + (j - M);
            if constexpr (!kNoDk) dk_win[at] = commu::from_f<S>(kv);
            dv_win[at] = commu::from_f<S>(vv);
          }
        }
    }
}

template <typename S, int kDh>
cudaError_t launch_pass_a_wide(const S* q, const S* rwbs, const S* v_mem, const S* v_win,
                               const float* s_res, const float* lse, const S* out, const S* dout,
                               S* qw_buf, float* dr_buf, float* ds, float* amax, float* dk_mem,
                               float* dv_mem, S* dk_win, S* dv_win, int B, int H, int dh, int T,
                               int R, int Tb, float scale, int seed, const commu::Plane& plane,
                               bool raw_ds, int levers, cudaStream_t stream) {
  bwd_rows_kernel<S><<<dim3((T + 127) / 128, B * H), 128, 0, stream>>>(q, rwbs, out, dout, dr_buf,
                                                                       qw_buf, H, dh, T, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = bwd_keys_wide_kernel<S, kDh>;
  if constexpr (commu::kLeverBuild)
    if (levers & kLeverInt8Dk) kernel = bwd_keys_wide_kernel<S, kDh, true>;
  using L = WideA<S, kDh>;
  constexpr size_t smem = L::kBytes;
  err = commu::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const bool vec = vec_rows(T, R, Tb) && aligned16(qw_buf) && aligned16(dout) &&
                   aligned16(lse) && aligned16(dr_buf) && aligned16(s_res) &&
                   aligned16(v_win) && (R == 0 || aligned16(v_mem));
  kernel<<<dim3(amax_tiles(R * Tb + T), B * H), L::kThreads, smem, stream>>>(
      qw_buf, v_mem, v_win, s_res, lse, dr_buf, dout, ds, amax, dk_mem, dv_mem, dk_win, dv_win, H,
      dh, T, R, Tb, seed, plane, raw_ds, vec);
  return cudaGetLastError();
}

// Pass A over every (b, h, 64 keys), at the form the widths take:
// ModelConfig()'s where narrow_widths, else the wide form for dh <= 64, 128
// or 256.  At dh <= 64 both forms compute the same outputs; the first stays
// on ModelConfig()'s widths, whose forms are held to their SASS, and the
// wide form's workspace (qw, Dr) is taken only past them (wide_workspace),
// so the choice follows narrow_widths, not dh alone.  ``raw_ds``: the int8
// dphi and int8 dq / dk forms (ds left unrounded, and the per-tile row
// maxima written); ``levers`` (the lever build only): under the int8 dk, no
// dk.  ``qw_buf``, ``dr_buf``: the wide form's workspace.
template <typename S>
cudaError_t launch_pass_a_at(const S* q, const S* rwbs, const S* k_mem, const S* k_win,
                             const S* v_mem, const S* v_win, const float* s_res, const float* lse,
                             const S* out, const S* dout, S* qw_buf, float* dr_buf, float* ds,
                             float* amax, float* dk_mem, float* dv_mem, S* dk_win, S* dv_win,
                             int B, int H, int dh, int T, int R, int Tb, int F2, float scale,
                             int seed, const commu::Plane& plane, bool raw_ds, int levers,
                             cudaStream_t stream) {
  if (narrow_widths(dh, F2))
    return launch_pass_a<S>(q, rwbs, k_mem, k_win, v_mem, v_win, s_res, lse, out, dout, ds, amax,
                            dk_mem, dv_mem, dk_win, dv_win, B, H, dh, T, R, Tb, scale, seed,
                            plane, raw_ds, levers, stream);
  if (dh <= 64)
    return launch_pass_a_wide<S, 64>(q, rwbs, v_mem, v_win, s_res, lse, out, dout, qw_buf,
                                     dr_buf, ds, amax, dk_mem, dv_mem, dk_win, dv_win, B, H, dh,
                                     T, R, Tb, scale, seed, plane, raw_ds, levers, stream);
  if (dh <= 128)
    return launch_pass_a_wide<S, 128>(q, rwbs, v_mem, v_win, s_res, lse, out, dout, qw_buf,
                                      dr_buf, ds, amax, dk_mem, dv_mem, dk_win, dv_win, B, H, dh,
                                      T, R, Tb, scale, seed, plane, raw_ds, levers, stream);
  return launch_pass_a_wide<S, 256>(q, rwbs, v_mem, v_win, s_res, lse, out, dout, qw_buf, dr_buf,
                                    ds, amax, dk_mem, dv_mem, dk_win, dv_win, B, H, dh, T, R, Tb,
                                    scale, seed, plane, raw_ds, levers, stream);
}

// ---- pass B past ModelConfig()'s widths

// Shared memory of bwd_queries_split_kernel.  Region 0, during the key
// loop: the ring of kStages stages, each ds [kWBQ][kDsS] f32 and either a
// chunk block's psi^T [kBJ][kPs] in S (psi_q: [kBJ / 4][kPs] words), its
// columns laid out so that each column warp's 32 cos and 32 sin columns lie
// side by side (psi_col), or the k block's k [kDh][kKs] in S.  After the key
// loop: a chunk block's du [kWBQ][kDuS] in S and its W_r ring [2][kDh][kKs]
// in S; the k block's k ds_c^T [kWBQ][kDh + 1] f32.  Then the int8 form's
// ds_q words [kWBQ][kQW] and the row scales.
constexpr int kWBQ = 128;  // query rows a block of the wide pass B

template <typename S, int kDh, bool kInt8>
struct WideB {
  static constexpr int kStages = 3;
  static constexpr int kDsS = sizeof(S) == 4 ? kBJ + 4 : kBJ + 8;  // f32 pairs: 8 mod 32
  static constexpr int kPs = kFC + 8;
  static constexpr int kKs = sizeof(S) == 4 ? kBJ + 4 : kBJ + 8;
  static constexpr int kDuS = kFC + (sizeof(S) == 4 ? 4 : 8);
  static constexpr size_t kDsBytes = sizeof(float) * kWBQ * kDsS;
  static constexpr size_t kPsiBytes =
      kInt8 ? sizeof(int) * (kBJ / 4) * kPs : sizeof(S) * kBJ * kPs;
  static constexpr size_t kKBytes = sizeof(S) * kDh * kKs;
  static constexpr size_t kStageBytes = kDsBytes + (kPsiBytes > kKBytes ? kPsiBytes : kKBytes);
  static constexpr size_t kRing = kStages * kStageBytes;
  static constexpr size_t kDuBytes = sizeof(S) * kWBQ * kDuS;
  static constexpr size_t kChunkAfter = kDuBytes + 2 * kKBytes;
  static constexpr size_t kQaBytes = sizeof(float) * kWBQ * (kDh + 1);
  static constexpr size_t kAfter = kChunkAfter > kQaBytes ? kChunkAfter : kQaBytes;
  static constexpr size_t kRegion = ((kRing > kAfter ? kRing : kAfter) + 15) / 16 * 16;
  static constexpr size_t kDsqBytes = kInt8 ? sizeof(int) * kWBQ * kQW : 0;
  static constexpr size_t kBytes = kRegion + kDsqBytes + sizeof(float) * 2 * kWBQ;
};

// Where a chunk's column c (< 128: the cos half) lies in a staged psi row:
// column warp w = (c % 128) / 32 takes [64 w, 64 w + 64), its cos columns
// first
__device__ __forceinline__ int psi_col(int c) {
  return (c % (kFC / 2)) / 32 * 64 + (c / (kFC / 2)) * 32 + c % 32;
}

template <typename S, int kDh, bool kInt8, bool kRaw = false, bool kNoDq = false>
__global__ void __launch_bounds__(kWThreads, 1)
bwd_queries_split_kernel(const S* __restrict__ k_mem, const S* __restrict__ k_win,
                         const S* __restrict__ w_r, const S* __restrict__ trig_a,
                         const S* __restrict__ psi_t, const int* __restrict__ psi_qw,
                         const float* __restrict__ ds_buf, const float* __restrict__ amax_buf,
                         float* __restrict__ du_buf, float* __restrict__ pos,
                         float* __restrict__ qa, float* __restrict__ dqac_sum,
                         float* __restrict__ du_sum, int H, int dh, int T, int R, int Tb, int F2,
                         bool vec) {
  using L = WideB<S, kDh, kInt8>;
  constexpr int kNQ = kDh / 16;  // n-tiles of 8 dims a warp in k ds_c^T and W_r du^T
  constexpr int kNG = kNQ / 4;   // ... in groups of 4
  constexpr int kV = 16 / static_cast<int>(sizeof(S));
  extern __shared__ __align__(16) unsigned char wide_b_smem[];
  int* dsq_s = reinterpret_cast<int*>(wide_b_smem + L::kRegion);             // [kWBQ][kQW]
  float* sc_s = reinterpret_cast<float*>(wide_b_smem + L::kRegion + L::kDsqBytes);  // [kWBQ]
  float* inv_sc_s = sc_s + kWBQ;                                             // [kWBQ]
  const int M = R * Tb;
  const int K = M + T;
  const int fpad = F2 / 2;
  const int NC = F2 / kFC;
  const int role = blockIdx.x;  // < NC: chunk role of dphi; NC: k ds_c^T
  const int qt = blockIdx.y;
  const int i0 = qt * kWBQ;
  const int bh = blockIdx.z;
  const int b = bh / H;
  const int h = bh - b * H;
  const size_t blk = static_cast<size_t>(bh) * gridDim.y + qt;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, qd = lane % 4;
  const int wm = warp % 8;  // k ds_c^T, W_r du^T: rows 16 wm ...
  const int wd = warp / 8;  // ... dims kDh / 2 wd
  const void* any = ds_buf;
  const int nk = (K + kBJ - 1) / kBJ;
  auto ds_st = [&](int s) {
    return reinterpret_cast<float*>(wide_b_smem + static_cast<size_t>(s) * L::kStageBytes);
  };
  auto op_st = [&](int s) {
    return wide_b_smem + static_cast<size_t>(s) * L::kStageBytes + L::kDsBytes;
  };
  // the [kWBQ][kBJ] ds tile of key step kc: 8 vectors a row, two a thread
  auto issue_ds = [&](int kc, int s) {
#pragma unroll
    for (int e = 0; e < kWBQ * (kBJ / 4) / kWThreads; ++e) {
      const int idx = tid + e * kWThreads;
      const int r = idx / 8, e0 = (idx % 8) * 4;
      const int i = i0 + r, j = kc * kBJ + e0;
      stage_vec<float>(ds_st(s) + r * L::kDsS + e0,
                       ds_buf + (static_cast<size_t>(bh) * T + (i < T ? i : 0)) * K + j,
                       i < T ? min(max(K - j, 0), 4) : 0, vec, any);
    }
  };

  if (role == NC) {
    // ---- k ds_c^T [kWBQ][dh] over every key, and its per-block row sums
    auto issue = [&](int kc, int s) {
      if (kc >= nk) return;
      issue_ds(kc, s);
      S* k_s = reinterpret_cast<S*>(op_st(s));
      for (int idx = tid; idx < kDh * (kBJ / kV); idx += kWThreads) {
        const int d = idx / (kBJ / kV), e0 = (idx % (kBJ / kV)) * kV;
        stage_keys<S>(k_s + d * L::kKs + e0, k_mem, k_win, b, h, kc * kBJ + e0, d, H, dh, R, Tb,
                      T, M, K, vec, any);
      }
    };
    float acc_q[kNG][1][4][4];
#pragma unroll
    for (int gi = 0; gi < kNG; ++gi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_q[gi][0][ni][e] = 0.f;
#pragma unroll
    for (int s = 0; s < L::kStages - 1; ++s) {
      issue(s, s);
      commu::cp_async_commit();
    }
    for (int kc = 0; kc < nk; ++kc) {
      commu::cp_async_wait<L::kStages - 2>();
      __syncthreads();  // step kc arrived; the previous step's readers are done
      issue(kc + L::kStages - 1, (kc + L::kStages - 1) % L::kStages);
      commu::cp_async_commit();
      const float* ds = ds_st(kc % L::kStages) + 16 * wm * L::kDsS;
      const S* k_s =
          reinterpret_cast<const S*>(op_st(kc % L::kStages)) + (kDh / 2) * wd * L::kKs;
#pragma unroll
      for (int kk = 0; kk < kBJ; kk += commu::kMmaK<S>) {
        if constexpr (sizeof(S) == 4) {
#pragma unroll
          for (int gi = 0; gi < kNG; ++gi)
            commu::mma_step<S>(acc_q[gi], ds + kk, L::kDsS, 1, k_s + 32 * gi * L::kKs + kk, 1,
                               L::kKs, lane);
        } else {  // ds rounds to bf16 as it is packed (rnd<S>)
          uint32_t a[4];
          frag_a_f32(a, ds + kk, L::kDsS, lane);
#pragma unroll
          for (int np = 0; np < kNQ / 2; ++np) {
            uint32_t bk[2][2];
            frag_b_nk(bk, k_s + 16 * np * L::kKs + kk, L::kKs, lane);
            commu::mma_bf16(acc_q[np / 2][0][2 * (np % 2)], a, bk[0]);
            commu::mma_bf16(acc_q[np / 2][0][2 * (np % 2) + 1], a, bk[1]);
          }
        }
      }
    }
    commu::cp_async_wait<0>();
    __syncthreads();  // the ring's readers are done: k ds_c^T takes region 0
    float* qa_s = reinterpret_cast<float*>(wide_b_smem);  // [kWBQ][kDh + 1]
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 16 * wm + g + 8 * half;
      const int i = i0 + row;
#pragma unroll
      for (int ni = 0; ni < kNQ; ++ni)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int d = (kDh / 2) * wd + 8 * ni + 2 * qd + c;
          const float v = i < T ? acc_q[ni / 4][0][ni % 4][2 * half + c] : 0.f;
          qa_s[row * (kDh + 1) + d] = v;
          if (!kNoDq && i < T && d < dh) qa[(static_cast<size_t>(bh) * dh + d) * T + i] = v;
        }
    }
    __syncthreads();
    for (int d = tid; d < dh; d += kWThreads) {  // per-block sums over the rows, in row order
      float s = 0.f;
      for (int r = 0; r < kWBQ; ++r) s += qa_s[r * (kDh + 1) + d];
      dqac_sum[blk * dh + d] = s;
    }
    return;
  }

  // ---- a chunk of 2F: columns fc .. fc + 127 of the cos half and of the sin
  // half; a thread's dphi: rows 32 wrow + 16 mi + g (+ 8), columns cw + 8 ni
  // + 2 qd (+ 1) of each half
  const int fc = role * (kFC / 2);
  const int wrow = warp / 4;
  const int cw = (warp % 4) * 32;
  auto col = [&](int c) { return c < kFC / 2 ? fc + c : fpad + fc + (c - kFC / 2); };
  const int Kw = (K + 3) / 4;
  if constexpr (kInt8) {
    // each row's absolute maximum over all K keys: the largest of pass A's
    // per-tile maxima
    if (tid < kWBQ) {
      const int i = i0 + tid;
      const int KT = amax_tiles(K);
      float amax = 0.f;
      if (i < T) {
        const float* row = amax_buf + (static_cast<size_t>(bh) * T + i) * KT;
        for (int t = 0; t < KT; ++t) amax = fmaxf(amax, row[t]);
      }
      quant_scale(amax, &sc_s[tid], &inv_sc_s[tid]);
    }
  }
  auto issue = [&](int kc, int s) {
    if (kc >= nk) return;
    issue_ds(kc, s);
    if constexpr (kInt8) {  // psi_q words of 4 keys: [kBJ / 4][kFC]
      int* dst = reinterpret_cast<int*>(op_st(s));
      for (int idx = tid; idx < (kBJ / 4) * (kFC / 4); idx += kWThreads) {
        const int gw = idx / (kFC / 4), e0 = (idx % (kFC / 4)) * 4;
        const int jw = kc * (kBJ / 4) + gw;
        stage_vec<int>(dst + gw * L::kPs + psi_col(e0),
                       psi_qw + static_cast<size_t>(jw) * F2 + col(e0), jw < Kw ? 4 : 0, vec,
                       any);
      }
    } else {  // psi^T rows of the chunk's columns: [kBJ][kFC]
      S* dst = reinterpret_cast<S*>(op_st(s));
      for (int idx = tid; idx < kBJ * (kFC / kV); idx += kWThreads) {
        const int jj = idx / (kFC / kV), e0 = (idx % (kFC / kV)) * kV;
        const int j = kc * kBJ + jj;
        stage_vec<S>(dst + jj * L::kPs + psi_col(e0), psi_t + static_cast<size_t>(j) * F2 + col(e0),
                     j < K ? kV : 0, vec, any);
      }
    }
  };
  // dphi: [cos, sin][m tile][n tile]; the int8 form sums in int32 first
  float acc[2][2][4][4];
  int acc_i[2][2][4][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][mi][ni][e] = 0.f, acc_i[s][mi][ni][e] = 0;
#pragma unroll
  for (int s = 0; s < L::kStages - 1; ++s) {
    issue(s, s);
    commu::cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    commu::cp_async_wait<L::kStages - 2>();
    __syncthreads();  // step kc arrived (and the scales written); the previous step's readers done
    issue(kc + L::kStages - 1, (kc + L::kStages - 1) % L::kStages);
    commu::cp_async_commit();
    const float* ds = ds_st(kc % L::kStages);
    if constexpr (kInt8) {
#pragma unroll
      for (int e = 0; e < kWBQ * (kBJ / 4) / kWThreads; ++e) {
        // ds_q = rint(ds * (1 / sc)): words of four keys, two a thread
        const int idx = tid + e * kWThreads;
        const int r = idx / (kBJ / 4), gw = idx % (kBJ / 4);
        const float4 v4 = *reinterpret_cast<const float4*>(ds + r * L::kDsS + 4 * gw);
        const float v[4] = {v4.x, v4.y, v4.z, v4.w};
        dsq_s[r * kQW + gw] = static_cast<int>(quant_word(v, inv_sc_s[r]));
      }
      __syncthreads();
      const int* psiq = reinterpret_cast<const int*>(op_st(kc % L::kStages)) + 64 * (warp % 4);
#pragma unroll
      for (int s = 0; s < 2; ++s)
        commu::mma_step_s8(acc_i[s], dsq_s + 32 * wrow * kQW, kQW, psiq + 32 * s, L::kPs,
                           lane);
    } else {
      const S* psi = reinterpret_cast<const S*>(op_st(kc % L::kStages)) + 64 * (warp % 4);
#pragma unroll
      for (int kk = 0; kk < kBJ; kk += commu::kMmaK<S>) {
        if constexpr (sizeof(S) == 4) {
#pragma unroll
          for (int s = 0; s < 2; ++s)
            commu::mma_step<S>(acc[s], ds + 32 * wrow * L::kDsS + kk, L::kDsS, 1,
                               psi + kk * L::kPs + 32 * s, L::kPs, 1, lane);
        } else {  // ds rounds to bf16 as it is packed (rnd<S>)
          uint32_t a[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            frag_a_f32(a[mi], ds + (32 * wrow + 16 * mi) * L::kDsS + kk, L::kDsS, lane);
#pragma unroll
          for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int np = 0; np < 2; ++np) {
              uint32_t bq[2][2];
              frag_b_kn(bq, psi + kk * L::kPs + 32 * s + 16 * np, L::kPs, lane);
#pragma unroll
              for (int mi = 0; mi < 2; ++mi) {
                commu::mma_bf16(acc[s][mi][2 * np], a[mi], bq[0]);
                commu::mma_bf16(acc[s][mi][2 * np + 1], a[mi], bq[1]);
              }
            }
        }
      }
    }
  }
  commu::cp_async_wait<0>();
  __syncthreads();  // the ring's readers are done: du and the W_r ring take region 0
  S* du_s = reinterpret_cast<S*>(wide_b_smem);                    // [kWBQ][kDuS]
  S* wr_s = reinterpret_cast<S*>(wide_b_smem + L::kDuBytes);      // [2][kDh][kKs]
  const S* wr_h = w_r + static_cast<size_t>(h) * dh * F2;
  // W_r's [dh][32] chunk of columns c0 (of this block's) into stage s
  auto issue_wr = [&](int c0, int s) {
    S* dst = wr_s + s * kDh * L::kKs;
    for (int idx = tid; idx < kDh * (kBJ / kV); idx += kWThreads) {
      const int d = idx / (kBJ / kV), e0 = (idx % (kBJ / kV)) * kV;
      stage_vec<S>(dst + d * L::kKs + e0, wr_h + static_cast<size_t>(d < dh ? d : 0) * F2 +
                   col(c0 + e0), d < dh ? kV : 0, vec, any);
    }
  };
  if constexpr (!kNoDq) {
    issue_wr(0, 0);
    commu::cp_async_commit();
  }
  // du = rnd(trig_combine_bwd(dphi)) where the C fragment lies
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 32 * wrow + 16 * mi + g + 8 * half;
      const int i = i0 + row;
      float back = 0.f;
      if constexpr (kInt8) back = sc_s[row] * static_cast<float>(1.0 / 127.0);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        float du2[2][2];  // [cos, sin column][c]
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * half + c;
          const int f = fc + cw + 8 * ni + 2 * qd + c;
          float d_cos = acc[0][mi][ni][e], d_sin = acc[1][mi][ni][e];
          if constexpr (kInt8) {
            // dphi = float(int32 sum) * (sc * (1 / 127)), as the reference scales it
            d_cos = static_cast<float>(acc_i[0][mi][ni][e]) * back;
            d_sin = static_cast<float>(acc_i[1][mi][ni][e]) * back;
          }
          float du_a = 0.f, du_b = 0.f;
          if (i < T) {
            const float s_a = commu::to_f(trig_a[static_cast<size_t>(i) * F2 + f]);
            const float c_a = commu::to_f(trig_a[static_cast<size_t>(i) * F2 + fpad + f]);
            du_a = commu::rnd<S>(d_cos * s_a - d_sin * c_a);
            du_b = commu::rnd<S>(d_cos * c_a + d_sin * s_a);
            if constexpr (kRaw) {  // the raw du, which the int8 dq quantises
              du_buf[(static_cast<size_t>(bh) * F2 + f) * T + i] = d_cos * s_a - d_sin * c_a;
              du_buf[(static_cast<size_t>(bh) * F2 + fpad + f) * T + i] =
                  d_cos * c_a + d_sin * s_a;
            } else {
              du_buf[(static_cast<size_t>(bh) * F2 + f) * T + i] = du_a;
              du_buf[(static_cast<size_t>(bh) * F2 + fpad + f) * T + i] = du_b;
            }
          }
          du2[0][c] = du_a, du2[1][c] = du_b;
        }
        const int cc = cw + 8 * ni + 2 * qd;
        store_pair<S>(du_s + row * L::kDuS + cc, du2[0][0], du2[0][1]);
        store_pair<S>(du_s + row * L::kDuS + kFC / 2 + cc, du2[1][0], du2[1][1]);
      }
    }
  if constexpr (!kNoDq) {
    // this chunk's share of W_r du^T: rows 16 wm, dims kDh / 2 wd, over its
    // columns 32 at a time through a ring of two stages
    float acc_pos[kNG][1][4][4];
#pragma unroll
    for (int gi = 0; gi < kNG; ++gi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_pos[gi][0][ni][e] = 0.f;
    constexpr int kSteps = kFC / kBJ;
    for (int st = 0; st < kSteps; ++st) {
      commu::cp_async_wait<0>();
      __syncthreads();  // du written; step st arrived; the previous step's readers are done
      if (st + 1 < kSteps) {
        issue_wr((st + 1) * kBJ, (st + 1) % 2);
        commu::cp_async_commit();
      }
      const S* wr = wr_s + (st % 2) * kDh * L::kKs + (kDh / 2) * wd * L::kKs;
      const S* du = du_s + 16 * wm * L::kDuS + st * kBJ;
#pragma unroll
      for (int kk = 0; kk < kBJ; kk += commu::kMmaK<S>) {
        if constexpr (sizeof(S) == 4) {
#pragma unroll
          for (int gi = 0; gi < kNG; ++gi)
            commu::mma_step<S>(acc_pos[gi], du + kk, L::kDuS, 1, wr + 32 * gi * L::kKs + kk, 1,
                               L::kKs, lane);
        } else {
          uint32_t a[4];
          frag_a_mk(a, du + kk, L::kDuS, lane);
#pragma unroll
          for (int np = 0; np < kNQ / 2; ++np) {
            uint32_t bw[2][2];
            frag_b_nk(bw, wr + 16 * np * L::kKs + kk, L::kKs, lane);
            commu::mma_bf16(acc_pos[np / 2][0][2 * (np % 2)], a, bw[0]);
            commu::mma_bf16(acc_pos[np / 2][0][2 * (np % 2) + 1], a, bw[1]);
          }
        }
      }
    }
    float* slot = pos + static_cast<size_t>(role) * gridDim.z * dh * T;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = i0 + 16 * wm + g + 8 * half;
      if (i >= T) continue;
#pragma unroll
      for (int ni = 0; ni < kNQ; ++ni)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int d = (kDh / 2) * wd + 8 * ni + 2 * qd + c;
          if (d < dh)
            slot[(static_cast<size_t>(bh) * dh + d) * T + i] =
                acc_pos[ni / 4][0][ni % 4][2 * half + c];
        }
    }
  } else {
    __syncthreads();  // du written
  }
  // per-block sums of the chunk's du columns over the tile's rows, in row order
  for (int c = tid; c < kFC; c += kWThreads) {
    float s = 0.f;
    for (int r = 0; r < kWBQ; ++r) s += commu::to_f(du_s[r * L::kDuS + c]);
    du_sum[blk * F2 + col(c)] = s;
  }
}

// dq = scale (k ds_c^T + sum over the chunks, in chunk order, of their
// shares of W_r du^T): one thread an element of [B, H, dh, T]
template <typename S>
__global__ void __launch_bounds__(256)
dq_finish_kernel(const float* __restrict__ qa, const float* __restrict__ pos, S* __restrict__ dq,
                 int chunks, size_t n, float scale) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (idx >= n) return;
  float p = pos[idx];
  for (int c = 1; c < chunks; ++c) p += pos[static_cast<size_t>(c) * n + idx];
  dq[idx] = commu::from_f<S>(scale * (qa[idx] + p));
}

template <typename S, int kDh, bool kInt8>
cudaError_t launch_pass_b_split_at(const S* k_mem, const S* k_win, const S* w_r,
                                   const S* trig_a, const S* psi_t, const int* psi_qw,
                                   const float* ds, const float* amax, S* dq, float* du,
                                   float* pos, float* qa, float* dqac_sum, float* du_sum, int B,
                                   int H, int dh, int T, int R, int Tb, int F2, float scale,
                                   int levers, cudaStream_t stream) {
  auto kernel = bwd_queries_split_kernel<S, kDh, kInt8>;
  bool no_dq = false;
  if constexpr (commu::kLeverBuild) {
    if (levers & kLeverInt8Dq) {
      kernel = bwd_queries_split_kernel<S, kDh, kInt8, true, true>;
      no_dq = true;
    } else if (levers) {
      kernel = bwd_queries_split_kernel<S, kDh, kInt8, true>;
    }
  }
  constexpr size_t smem = WideB<S, kDh, kInt8>::kBytes;
  cudaError_t err = commu::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const bool vec = vec_rows(T, R, Tb) && aligned16(ds) && aligned16(k_win) &&
                   (R == 0 || aligned16(k_mem)) && aligned16(w_r) &&
                   (kInt8 ? aligned16(psi_qw) : aligned16(psi_t));
  const int tiles = (T + kWBQ - 1) / kWBQ;
  kernel<<<dim3(F2 / kFC + 1, tiles, B * H), kWThreads, smem, stream>>>(
      k_mem, k_win, w_r, trig_a, psi_t, psi_qw, ds, amax, du, pos, qa, dqac_sum, du_sum, H, dh, T,
      R, Tb, F2, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || no_dq) return err;
  const size_t n = static_cast<size_t>(B) * H * dh * T;
  dq_finish_kernel<S><<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      qa, pos, dq, F2 / kFC, n, scale);
  return cudaGetLastError();
}

template <typename S, int kDh>
cudaError_t launch_pass_b_split(const S* k_mem, const S* k_win, const S* w_r, const S* trig_a,
                                const S* psi_t, const int* psi_qw, const float* ds,
                                const float* amax, S* dq, float* du, float* pos, float* qa,
                                float* dqac_sum, float* du_sum, int B, int H, int dh, int T,
                                int R, int Tb, int F2, float scale, int levers,
                                cudaStream_t stream) {
  if (psi_qw != nullptr)
    return launch_pass_b_split_at<S, kDh, true>(k_mem, k_win, w_r, trig_a, psi_t, psi_qw, ds,
                                                amax, dq, du, pos, qa, dqac_sum, du_sum, B, H, dh,
                                                T, R, Tb, F2, scale, levers, stream);
  return launch_pass_b_split_at<S, kDh, false>(k_mem, k_win, w_r, trig_a, psi_t, psi_qw, ds,
                                               amax, dq, du, pos, qa, dqac_sum, du_sum, B, H, dh,
                                               T, R, Tb, F2, scale, levers, stream);
}

// Pass B over every (b, h, 64 queries): ModelConfig()'s form where the
// widths take it, else the split form sized for dh <= 64, 128 or 256; the
// exact form, or with ``psi_qw`` (psi_q as [ceil(K / 4)][2F] words) the
// int8 dphi form; with ``levers`` (the lever build only) its raw form
// (kRaw), and under the int8 dq without dq (kNoDq).  ``pos``, ``qa``: the
// split form's workspace.
template <typename S>
cudaError_t launch_pass_b(const S* k_mem, const S* k_win, const S* w_r, const S* trig_a,
                          const S* psi_t, const int* psi_qw, const float* ds, const float* amax,
                          S* dq, float* du, float* pos, float* qa, float* dqac_sum, float* du_sum,
                          int B, int H, int dh, int T, int R, int Tb, int F2, float scale,
                          int levers, cudaStream_t stream) {
  if (narrow_widths(dh, F2))
    return launch_pass_b_narrow<S>(k_mem, k_win, w_r, trig_a, psi_t, psi_qw, ds, amax, dq, du,
                                   dqac_sum, du_sum, B, H, dh, T, R, Tb, F2, scale, levers,
                                   stream);
  if (dh <= 64)
    return launch_pass_b_split<S, 64>(k_mem, k_win, w_r, trig_a, psi_t, psi_qw, ds, amax, dq, du,
                                      pos, qa, dqac_sum, du_sum, B, H, dh, T, R, Tb, F2, scale,
                                      levers, stream);
  if (dh <= 128)
    return launch_pass_b_split<S, 128>(k_mem, k_win, w_r, trig_a, psi_t, psi_qw, ds, amax, dq,
                                       du, pos, qa, dqac_sum, du_sum, B, H, dh, T, R, Tb, F2,
                                       scale, levers, stream);
  return launch_pass_b_split<S, 256>(k_mem, k_win, w_r, trig_a, psi_t, psi_qw, ds, amax, dq, du,
                                     pos, qa, dqac_sum, du_sum, B, H, dh, T, R, Tb, F2, scale,
                                     levers, stream);
}

// ---- the bias gradients at the wide widths: the first form runs one block
// a head (12 blocks at 1536 / 12, 0.84 ms of a #4 launch on an H100); here
// one thread a column sums du_sum or dqac_sum over the batch rows and
// tiles in bias_grad_kernel's order, then one warp a row of W_r takes d
// r_r_bias = scale W_r sum du, its lanes over f and a fixed tree across
// them
__global__ void __launch_bounds__(256)
bias_sums_kernel(const float* __restrict__ dqac_sum, const float* __restrict__ du_sum,
                 float* __restrict__ sdu, float* __restrict__ drwb, int B, int H, int tiles,
                 int dh, int F2, float scale) {
  const int h = blockIdx.y;
  const int c = blockIdx.x * 256 + threadIdx.x;  // f < 2F, then 2F + d
  if (c >= F2 + dh) return;
  const int n_all = B * tiles;  // (batch row, tile) pairs, batch-major
  const bool du = c < F2;
  const int w = du ? F2 : dh;
  const float* src = (du ? du_sum : dqac_sum) + (du ? c : c - F2);
  float s = 0.f;
#pragma unroll 8
  for (int n = 0; n < n_all; ++n) {
    const int b = n / tiles, t = n - b * tiles;
    s += src[((static_cast<size_t>(b) * H + h) * tiles + t) * w];
  }
  if (du)
    sdu[h * F2 + c] = s;
  else
    drwb[h * dh + c - F2] = scale * s;
}

template <typename S>
__global__ void __launch_bounds__(256)
bias_rr_kernel(const S* __restrict__ w_r, const float* __restrict__ sdu,
               float* __restrict__ drrb, int dh, int F2, float scale) {
  const int h = blockIdx.y;
  const int d = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (d >= dh) return;
  const S* wr_d = w_r + (static_cast<size_t>(h) * dh + d) * F2;
  const float* s_h = sdu + static_cast<size_t>(h) * F2;
  float r = 0.f;
  for (int f = lane; f < F2; f += 32) r = fmaf(commu::to_f(wr_d[f]), s_h[f], r);
  r = commu::warp_sum(r);
  if (lane == 0) drrb[h * dh + d] = scale * r;
}

// The two bias gradients at the form the widths take (``sdu``: the wide
// form's workspace, [H][2F])
template <typename S>
cudaError_t launch_bias_grads(const float* dqac_sum, const float* du_sum, const S* w_r,
                              float* sdu, float* drwb, float* drrb, int B, int H, int dh, int T,
                              int F2, float scale, cudaStream_t stream) {
  if (narrow_widths(dh, F2)) {
    bias_grad_kernel<S><<<H, kThreads, sizeof(float) * F2, stream>>>(
        dqac_sum, du_sum, w_r, drwb, drrb, B, H, (T + kBQ - 1) / kBQ, dh, F2, scale);
    return cudaGetLastError();
  }
  bias_sums_kernel<<<dim3((F2 + dh + 255) / 256, H), 256, 0, stream>>>(
      dqac_sum, du_sum, sdu, drwb, B, H, (T + kWBQ - 1) / kWBQ, dh, F2, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bias_rr_kernel<S><<<dim3((dh + 7) / 8, H), 256, 0, stream>>>(w_r, sdu, drrb, dh, F2, scale);
  return cudaGetLastError();
}

// The wide forms' workspace beside the first forms': qw [B, H, dh, T] (in
// f32's size, for either dtype) and Dr [B, H, T] for the wide pass A; the
// chunks' shares of W_r du^T [2F / 256][B, H, dh, T] and k ds_c^T for the
// split pass B; sum du [H][2F] for the bias gradients.  None at
// ModelConfig()'s widths.
struct WideBuffers {
  void* qw;
  float *dr, *pos, *qa, *sdu;
};

inline void wide_workspace(commu::Workspace& ws, WideBuffers* w, int B, int H, int dh, int T,
                           int F2) {
  const size_t bhdt = static_cast<size_t>(B) * H * dh * T;
  const bool wide = !narrow_widths(dh, F2);
  w->qw = wide ? ws.take<float>(bhdt) : nullptr;
  w->dr = wide ? ws.take<float>(static_cast<size_t>(B) * H * T) : nullptr;
  w->pos = wide ? ws.take<float>(bhdt * (F2 / kFC)) : nullptr;
  w->qa = wide ? ws.take<float>(bhdt) : nullptr;
  w->sdu = wide ? ws.take<float>(static_cast<size_t>(H) * F2) : nullptr;
}

}  // namespace
