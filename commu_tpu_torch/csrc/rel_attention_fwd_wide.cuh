// The attention forward on the tensor cores at the wide widths: heads up to
// 256 wide and any even 2F up to 2048 (and past it where shared memory fits),
// the body of rel_attention_mem_fwd.cu, of rel_attention_proj_fwd.cu's wide
// form and, with R = 0, of rel_attention_fwd.cu wherever their
// ModelConfig()-width body (rel_attention_fwd_mma.cuh: dh <= 64, 2F a
// multiple of 128 up to 512) does not take the widths.  Transformer-XL's published widths (d_model
// 768 / 12 heads, 1024 / 8, 1024 / 4, 1536 / 12) run here.
//
// What it computes is rel_attention_fwd_mma.cuh's, per (b, h):
//   S = qw^T k + phi psi + mask[reset[b]],  O = v softmax_rows(S)^T
// with the same query side, the same masks, roundings and lever forms.
//
// Design.  One block of 64 query rows of one (b, h), 256 threads, 8 warps:
// warp w takes query rows 16 (w % 4) .. + 15 (its row group) against keys
// 32 (w / 4) .. + 31 of every 64-key tile for S, as the narrow body does.
// What differs:
//   - The two warps of a row group share one running maximum: after a
//     tile's S each hands the other its rows' tile maxima (a barrier of the
//     pair's 64 threads), so both exponentiate against the same m, and both
//     write their P (rounded to S) into a [16][64] plane of the row group.
//     Then each warp takes O = P v over all 64 keys for half of the head
//     dims (n-tiles of 8 dims, interleaved: warp w / 4 takes the n-tiles
//     of its parity), so a thread holds 16 rows x dh / 2 / 32 output floats:
//     32 at dh 128, 64 at dh 256, where holding all dims would take 128
//     (the pair's keys in their own warps) and spill.  The row sums stay a
//     warp's own and add once at the end; no output merge is left.
//   - BD runs over 2F in chunks through the cp.async ring, as the narrow
//     body's does (psi_q in 32-word chunks on mma.sync m16n8k32 s8 with an
//     exact int32 sum, psi in 32 f32 rows on 3xTF32 m16n8k8 or 64 bf16 rows
//     on m16n8k16); AC = qw^T k over dh in chunks the same way, qw in
//     shared memory at any dh up to 256.  A 2F that is no whole number of
//     chunks is zero-padded on both sides.
//   - The query side.  Where it fits a block's shared memory beside the
//     ring and qw (wide_choose: the int8 forms' phi_q, 64 x 2F bytes, at the
//     four published widths; bf16 phi to 2F 1024), phi stays there for the
//     whole key loop (the resident form).  Elsewhere (f32 phi past 2F 512;
//     bf16 phi past 1024; phi_q at 2F 2048 in f32, or with dh 256 in bf16)
//     the block writes its query side once to a workspace slot of its own
//     ([64][2F] in S, or phi_q's words) and stages it beside psi: each BD
//     chunk of a tile is preceded by the matching 64-row chunk of phi,
//     [64][36] words, in the same ring (the streamed form).  Where both
//     fit, streaming cost the int8 and bf16 forms 3-21% on an H100
//     (PERF.md §6), so the resident form runs wherever it fits.  The other
//     way to fit, fewer query rows a block, was not built: the key side
//     (psi, k, v: 2F + 2 dh rows a key) is staged once per block, so 16
//     rows a block (what f32 phi at 1536 needs) stages it four times as
//     often, 4 x (2F + 2 dh) rows a key per 64 query rows, against 2 x 2F
//     + 2 dh for the streamed query side: at 1536 / 12 in f32, 7,168
//     against 3,328 rows a key.
//   - u = qr^T W_r stays an FMA loop in the first design's order, its
//     rows kGroup at a time (16, or 8 where the int8 form's f32 scratch
//     [kGroup][2F] must fit), so phi and phi_q keep their bits; the int8
//     row maximum runs over all of 2F.  Masks (NEG_INF from the bf16 table,
//     added in f32), the unnormalised tile dropped, P rounded to S, one
//     division at the end, the masked-tile and row-group skips (kSkip, the
//     no-memory forward's), and the lever forms (kSoft, compiled in only by
//     the lever build: commu::kSoftForm) as rel_attention_fwd_mma.cuh has
//     them.  Under kSkip a row group's P v is skipped where both warps' P
//     of the tile are all zeros.
// Shared memory: region 0 (the ring of kWideStages chunks of 9,216 bytes,
// then the P planes [64][72] in S; before the key loop the query side's
// scratch), the resident query side, qw [64][kc * chunk + 4 or 8] and a few
// row vectors.  Every row stride is 4 (A) or 8 (B) mod 32 words.
// Everything here has internal linkage: each source that includes this file
// compiles its own copy.
#pragma once

#include "rel_attention_fwd_mma.cuh"

namespace {

constexpr int kWideStages = 6;     // ring chunks: three steps of two
constexpr int kWideMaxDh = 256;
constexpr int kWidePStride = 72;   // a P plane's row stride in S: 8 (f32) / 4 (bf16 words) mod 32
constexpr int kWideAStride = 36;   // a streamed query chunk's row stride in words

// depth of the BD operand a chunk holds: 128 (psi_q, 32 words), 32 f32 or 64 bf16
template <typename S, bool kInt8>
__host__ __device__ constexpr int wide_bd_depth() {
  return kInt8 ? 4 * chunk_rows<int>() : chunk_rows<S>();
}

// rows of the query side formed at a time: 16, 8 in the int8 forms past 2F
// 1024 (their f32 scratch [kGroup][2F] shares region 0)
__host__ __device__ inline int wide_group(bool int8, int F2) {
  return !int8 || F2 <= 1024 ? 16 : 8;
}

// Where the block's pieces lie in its shared memory (bytes), at these
// widths; ``streamed``: the query side lies in the workspace.
struct WideLayout {
  int nbd;        // BD chunks a tile
  int kc;         // k chunks (and v chunks) a tile
  int sa;         // the resident query side's row stride, in its elements
  int qws;        // qw's row stride, in S
  int group;      // kGroup of the query side
  bool streamed;
  size_t region0, a_off, qw_off, misc_off, total;
  size_t slot_bytes;  // a streamed block's workspace slot
};

template <typename S, bool kInt8>
__host__ __device__ inline WideLayout wide_layout(int dh, int F2, bool streamed) {
  constexpr int kRowsS = chunk_rows<S>();
  constexpr int kDepth = wide_bd_depth<S, kInt8>();
  WideLayout w{};
  w.nbd = (F2 + kDepth - 1) / kDepth;
  w.kc = (dh + kRowsS - 1) / kRowsS;
  const int f2p = w.nbd * kDepth;
  w.sa = kInt8 ? f2p / 4 + 4 : (sizeof(S) == 4 ? f2p + 4 : f2p + 8);
  w.qws = w.kc * kRowsS + (sizeof(S) == 4 ? 4 : 8);
  w.group = wide_group(kInt8, F2);
  w.streamed = streamed;
  const size_t ring = static_cast<size_t>(kWideStages) * kChunkBytes +
                      static_cast<size_t>(kFwdRows) * kWidePStride * sizeof(S);
  const size_t scratch = sizeof(float) * w.group * (dh + (kInt8 ? F2 : 0));
  w.region0 = ring > scratch ? ring : (scratch + 15) / 16 * 16;
  const size_t a_bytes = streamed ? 0
                                  : static_cast<size_t>(kFwdRows) * w.sa *
                                        (kInt8 ? sizeof(int) : sizeof(S));
  w.a_off = w.region0;
  w.qw_off = w.a_off + a_bytes;
  w.misc_off = w.qw_off + static_cast<size_t>(kFwdRows) * w.qws * sizeof(S);
  // m exchange [2][64], row sums [2][64], amax [64], P-zero flags [8]
  w.total = w.misc_off + sizeof(float) * 5 * kFwdRows + sizeof(int) * 8;
  w.slot_bytes = static_cast<size_t>(kFwdRows) * f2p * (kInt8 ? 1 : sizeof(S));
  return w;
}

// The form a launch runs: the resident query side where it fits a block's
// shared memory, else the streamed one.
template <typename S, bool kInt8>
inline WideLayout wide_choose(int dh, int F2) {
  const WideLayout r = wide_layout<S, kInt8>(dh, F2, false);
  return r.total <= commu::kMaxSmemBytes ? r : wide_layout<S, kInt8>(dh, F2, true);
}

// The forwards' rule, which the launches of #1, #2 and #6 share: every
// width they take runs on the tensor cores, in the narrow body
// (rel_attention_fwd_mma.cuh: ModelConfig()'s widths, dh <= 64 and whole
// 128-deep chunks of the BD depth up to 512) where fwd_narrow holds, else
// in the wide body here.
inline bool fwd_on_tensor_cores(int dh, int F2) {
  return dh >= 1 && dh <= kWideMaxDh && F2 >= 2 && F2 % 2 == 0;
}
inline bool fwd_narrow(int dh, int F2) {
  return dh >= 1 && dh <= kFwdMaxDh && F2 % 128 == 0 && F2 <= kFwdMaxF2;
}

// Blocks an SM the kernel is compiled for (its register budget: 128 a
// thread at two).  The f32 float form at dh <= 128 streams its query side
// (108 KB of shared memory a block) and takes two, spilling 170-300 bytes
// a thread: 15-25% faster than one on an H100 (PERF.md §6).  The other forms
// take one: most keep their query side resident, and two such blocks do
// not fit an SM.
template <typename S, bool kInt8, int kDhCap>
__host__ __device__ constexpr int wide_min_blocks() {
  return kDhCap <= 128 && !kInt8 && sizeof(S) == 4 ? 2 : 1;
}

// s += a chunk's f32 products t, in round-to-nearest on the CUDA cores.
// The tensor cores truncate what an mma.sync adds below its accumulator's
// last bit, toward zero: over 2F + dh = 1,664 of depth (1536 / 12) the
// scores, left in one accumulator, fell short by up to 1.6e-4, which exp
// carries into P (the clamped form's out then missed 1e-4 of its twin).
// A chunk's 32-deep sum in a fresh accumulator truncates against its own,
// smaller, magnitude.
__device__ __forceinline__ void add_chunk(float (&s)[kNT][4], const float (&t)[1][kNT][4]) {
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] += t[0][n][e];
}

// a barrier of the two warps of row group ``rg`` (64 threads; id 0 is
// __syncthreads')
__device__ __forceinline__ void pair_sync(int rg) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(rg + 1) : "memory");
}

// O[:, this warp's n-tiles of v chunk kCv] += P v over the 64 keys of a
// tile, 3xTF32: P from the row group's plane (f32, rows g, g + 8; key 2q +
// c of a k8 step in slot q + 4 c), v's B fragments in the same order.  The
// chunk holds head dims 32 kCv .. + 31; the warp takes n-tiles kh, kh + 2.
template <int kCv, int kO>
__device__ __forceinline__ void pv_wide_f32(float (&o)[kO][4], const float* p_s,
                                            const float* v_s, int kh, int ndt, int lane) {
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int kk = 0; kk < kFwdKeys / 8; ++kk) {
    const float2 p0 = *reinterpret_cast<const float2*>(p_s + g * kWidePStride + 8 * kk + 2 * q);
    const float2 p1 =
        *reinterpret_cast<const float2*>(p_s + (g + 8) * kWidePStride + 8 * kk + 2 * q);
    uint32_t ah[4], al[4];
    commu::split_tf32(p0.x, ah[0], al[0]);
    commu::split_tf32(p1.x, ah[1], al[1]);
    commu::split_tf32(p0.y, ah[2], al[2]);
    commu::split_tf32(p1.y, ah[3], al[3]);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int nl = kh + 2 * x;
      if (4 * kCv + nl >= ndt) continue;
      const float2 v2 =
          *reinterpret_cast<const float2*>(v_s + (8 * nl + g) * kChunkStride + 8 * kk + 2 * q);
      uint32_t bh[2], bl[2];
      commu::split_tf32(v2.x, bh[0], bl[0]);
      commu::split_tf32(v2.y, bh[1], bl[1]);
      commu::mma_tf32(o[2 * kCv + x], al, bh);
      commu::mma_tf32(o[2 * kCv + x], ah, bl);
      commu::mma_tf32(o[2 * kCv + x], ah, bh);
    }
  }
}

// the same in bf16: P pairs from the plane (m16n8k16 A fragments), v chunk
// kCv holding head dims 64 kCv .. + 63, the warp's n-tiles kh + 2 x
template <int kCv, int kO>
__device__ __forceinline__ void pv_wide_bf16(float (&o)[kO][4], const __nv_bfloat16* p_s,
                                             const __nv_bfloat16* v_s, int kh, int ndt,
                                             int lane) {
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int kk = 0; kk < kFwdKeys / 16; ++kk) {
    const __nv_bfloat16* pr = p_s + 16 * kk + 2 * q;
    const uint32_t af[4] = {
        *reinterpret_cast<const uint32_t*>(pr + g * kWidePStride),
        *reinterpret_cast<const uint32_t*>(pr + (g + 8) * kWidePStride),
        *reinterpret_cast<const uint32_t*>(pr + g * kWidePStride + 8),
        *reinterpret_cast<const uint32_t*>(pr + (g + 8) * kWidePStride + 8)};
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int nl = kh + 2 * x;
      if (8 * kCv + nl >= ndt) continue;
      const __nv_bfloat16* vr = v_s + (8 * nl + g) * kChunkStride + 16 * kk + 2 * q;
      const uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(vr),
                              *reinterpret_cast<const uint32_t*>(vr + 8)};
      commu::mma_bf16(o[4 * kCv + x], af, bf);
    }
  }
}

// P v over v chunk cv (a runtime index): the accumulators it reaches are
// chosen at compile time, so O stays in registers
template <typename S, int kO, int kCv = 0>
__device__ __forceinline__ void pv_wide(float (&o)[kO][4], const S* p_s, const S* v_s, int cv,
                                        int kh, int ndt, int lane) {
  constexpr int kPer = sizeof(S) == 4 ? 2 : 4;  // a warp's n-tiles a chunk
  if constexpr (kCv * kPer < kO) {
    if (cv == kCv) {
      if constexpr (sizeof(S) == 4)
        pv_wide_f32<kCv>(o, p_s, v_s, kh, ndt, lane);
      else
        pv_wide_bf16<kCv>(o, p_s, v_s, kh, ndt, lane);
      return;
    }
    pv_wide<S, kO, kCv + 1>(o, p_s, v_s, cv, kh, ndt, lane);
  }
}

// The query side of rows q0 .. q0 + 63, kGroup rows at a time: qw into
// qw_s; phi (or phi_q's words and the row maxima) into ``a_dst`` with row
// stride ``a_stride`` (the resident plane, or the block's workspace slot).
// u = qr^T W_r in the first design's FMA order (rel_attention_fwd_mma.cuh).
template <typename S, bool kInt8, bool kSkip, int kGroup>
__device__ __forceinline__ void wide_query_side(
    unsigned char* scratch, S* qw_s, int qws, int kcw, void* a_dst, int a_stride, int a_cols,
    float* amax_s, const S* q, const S* rwbs, const S* rrbs, const S* w_r, const S* trig_a,
    int bh, int q0, int H, int dh, int T, int F2, float scale) {
  using E = typename std::conditional<kInt8, int, S>::type;
  E* a_bd = static_cast<E*>(a_dst);
  const int h = bh % H;
  const int fpad = F2 / 2;
  const int tid = threadIdx.x;
  float* qr_s = reinterpret_cast<float*>(scratch);  // [dh][kGroup]
  float* phig = qr_s + dh * kGroup;                 // int8: [kGroup][F2]
  const size_t q_off = static_cast<size_t>(bh) * dh * T;
  const float scale_s = commu::rnd<S>(scale);
  const S* wr_h = w_r + static_cast<size_t>(h) * dh * F2;
  // the zero padding past 2F (the resident plane or the slot) and past dh
  const int a_used = kInt8 ? F2 / 4 : F2;
  for (int idx = tid; idx < kFwdRows * (a_cols - a_used); idx += kFwdThreads) {
    const int r = idx / (a_cols - a_used), c = a_used + idx % (a_cols - a_used);
    a_bd[static_cast<size_t>(r) * a_stride + c] = zero_of<E>();
  }
  for (int r0 = 0; r0 < kFwdRows; r0 += kGroup) {
    for (int idx = tid; idx < kGroup * kcw; idx += kFwdThreads) {
      const int r = idx / kcw, d = idx % kcw;
      const int i = q0 + r0 + r;
      float qw = 0.f, qr = 0.f;
      if (i < T && d < dh) {
        const float qs =
            commu::rnd<S>(commu::to_f(q[q_off + static_cast<size_t>(d) * T + i]) * scale_s);
        qw = commu::rnd<S>(qs + commu::to_f(rwbs[h * dh + d]));
        qr = commu::rnd<S>(qs + commu::to_f(rrbs[h * dh + d]));
      }
      qw_s[(r0 + r) * qws + d] = commu::from_f<S>(qw);
      if (d < dh) qr_s[d * kGroup + r] = qr;
    }
    __syncthreads();
    const bool group_live = !kSkip || q0 + r0 < T;
    for (int f = tid; f < fpad; f += kFwdThreads) {
      float us[kGroup], uc[kGroup];
#pragma unroll
      for (int r = 0; r < kGroup; ++r) us[r] = uc[r] = 0.f;
      float ws[8], wc[8];
      auto load_w = [&](int d0, float (&ws_)[8], float (&wc_)[8]) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int d = d0 + e < dh ? d0 + e : dh - 1;
          ws_[e] = commu::to_f(wr_h[d * F2 + f]);
          wc_[e] = commu::to_f(wr_h[d * F2 + fpad + f]);
        }
      };
      if (group_live) load_w(0, ws, wc);
      for (int d0 = 0; group_live && d0 < dh; d0 += 8) {
        float ws_next[8], wc_next[8];  // the next 8 head dims in flight
        load_w(d0 + 8 < dh ? d0 + 8 : d0, ws_next, wc_next);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (d0 + e >= dh) break;
          const float4* qv4 = reinterpret_cast<const float4*>(qr_s + (d0 + e) * kGroup);
#pragma unroll
          for (int r4 = 0; r4 < kGroup / 4; ++r4) {
            const float4 qv = qv4[r4];
            const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              us[4 * r4 + x] = fmaf(qa[x], ws[e], us[4 * r4 + x]);
              uc[4 * r4 + x] = fmaf(qa[x], wc[e], uc[4 * r4 + x]);
            }
          }
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) ws[e] = ws_next[e], wc[e] = wc_next[e];
      }
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        const int i = q0 + r0 + r;
        float pc = 0.f, ps = 0.f;
        if (i < T) {
          const float sa_ = commu::to_f(trig_a[i * F2 + f]);
          const float ca = commu::to_f(trig_a[i * F2 + fpad + f]);
          pc = us[r] * sa_ + uc[r] * ca;  // pairs with cos(w j)
          ps = uc[r] * sa_ - us[r] * ca;  // pairs with sin(w j)
        }
        if constexpr (kInt8) {  // the int8 form quantises the unrounded phi
          phig[r * F2 + f] = pc;
          phig[r * F2 + fpad + f] = ps;
        } else {
          a_bd[static_cast<size_t>(r0 + r) * a_stride + f] = commu::from_f<S>(pc);
          a_bd[static_cast<size_t>(r0 + r) * a_stride + fpad + f] = commu::from_f<S>(ps);
        }
      }
    }
    __syncthreads();
    if constexpr (kInt8) {
      // row r's maximum over all of 2F: its kParts threads take every
      // kParts-th column, then a shuffle (kParts <= 32: one warp)
      constexpr int kParts = kFwdThreads / kGroup;
      const int r = tid / kParts, part = tid % kParts;
      float amax = 0.f;
      for (int f = part; f < F2; f += kParts) amax = fmaxf(amax, fabsf(phig[r * F2 + f]));
#pragma unroll
      for (int off = 1; off < kParts; off <<= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      const float qscale = 127.f / fmaxf(amax, 1e-20f);
      if (part == 0) amax_s[r0 + r] = amax;
      // word w of the row holds depth 4 w .. 4 w + 3
      for (int w = part; w < F2 / 4; w += kParts) {
        uint32_t word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          word |= (static_cast<uint32_t>(__float2int_rn(phig[r * F2 + 4 * w + e] * qscale)) &
                   0xFFu) << (8 * e);
        a_bd[static_cast<size_t>(r0 + r) * a_stride + w] = static_cast<int>(word);
      }
      __syncthreads();  // phig is free for the next group
    }
  }
}

// One block: query rows q0 .. q0 + 63 of head bh = b * H + h.  ``slot``:
// the block's workspace slot in the streamed form (L.streamed), else
// unused.  ``aligned``: every 16-byte group of keys lies whole in one slab
// or the window (cp.async); else plain loads.  kDhCap: 128 or 256, the
// output registers a thread holds (dh / 2 / 32 x 16 rows ... 64).  No
// parameter carries __restrict__: the slot is written and read back by the
// block; the kernels that call this say so on their own parameters.
template <typename S, bool kInt8, int kDhCap, bool kSkip = false, int kSoft = 0>
__device__ __forceinline__ void attend_rows_wide(
    unsigned char* smem, const WideLayout& L, const S* q, const S* rwbs, const S* rrbs,
    const S* k_mem, const S* k_win, const S* v_mem, const S* v_win, const S* w_r,
    const S* trig_a, const S* psi, const int* psi_q, const __nv_bfloat16* mask, const int* reset,
    S* out, float* s_res, float* lse, unsigned char* slot, int bh, int q0, int H, int dh, int T,
    int R, int Tb, int F2, float scale, int seed, const commu::Plane& plane, bool aligned) {
  using E = typename std::conditional<kInt8, int, S>::type;  // the BD operand's element
  constexpr int kO = kDhCap / 16;  // a warp's output n-tiles
  constexpr bool kClamp = (kSoft & commu::kSoftClamp) != 0;
  constexpr bool kAfter = (kSoft & commu::kSoftAfter) != 0;
  constexpr int kRowsS = chunk_rows<S>();
  constexpr int kRowsE = chunk_rows<E>();
  const int M = R * Tb;
  const int K = M + T;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, qd = lane % 4;
  const bool streamed = L.streamed;

  unsigned char* ring = smem;
  S* p_all = reinterpret_cast<S*>(ring + kWideStages * kChunkBytes);  // [64][72]
  E* a_bd = reinterpret_cast<E*>(smem + L.a_off);                     // resident phi
  S* qw_s = reinterpret_cast<S*>(smem + L.qw_off);
  float* mx_s = reinterpret_cast<float*>(smem + L.misc_off);  // [2][64]: tile maxima
  float* l_s = mx_s + 2 * kFwdRows;                           // [2][64]: row sums
  float* amax_s = l_s + 2 * kFwdRows;                         // [64]
  int* zf_s = reinterpret_cast<int*>(amax_s + kFwdRows);      // [8]: P all zeros

  // ---- the query side (region 0 is its scratch)
  const int a_cols = kInt8 ? L.nbd * chunk_rows<int>() : L.nbd * kRowsS;  // per row, in E
  void* a_dst = streamed ? static_cast<void*>(slot) : static_cast<void*>(a_bd);
  const int a_stride = streamed ? a_cols : L.sa;
  const int kcw = L.kc * kRowsS;
  if (L.group == 16)
    wide_query_side<S, kInt8, kSkip, 16>(smem, qw_s, L.qws, kcw, a_dst, a_stride, a_cols, amax_s,
                                         q, rwbs, rrbs, w_r, trig_a, bh, q0, H, dh, T, F2, scale);
  else
    wide_query_side<S, kInt8, kSkip, 8>(smem, qw_s, L.qws, kcw, a_dst, a_stride, a_cols, amax_s,
                                        q, rwbs, rrbs, w_r, trig_a, bh, q0, H, dh, T, F2, scale);
  if (streamed) __threadfence_block();  // the slot, before the barrier below

  // ---- the key side: per tile, the BD chunks (each after its query chunk
  // when streamed), kc of k, kc of v
  const int nbd = L.nbd, kc = L.kc;
  const int bd_span = streamed ? 2 * nbd : nbd;
  const int per_tile = bd_span + 2 * kc;  // even when streamed: a pair shares a step
  const int tiles = (K + kFwdKeys - 1) / kFwdKeys;
  const int total = tiles * per_tile;
  const int bd_rows = kInt8 ? F2 / 4 : F2;  // rows of the BD operand in memory

  constexpr int kPE = kFwdKeys * static_cast<int>(sizeof(E)) / 16;  // copies a row
  constexpr int kPS = kFwdKeys * static_cast<int>(sizeof(S)) / 16;
  const int rE = tid / kPE, jjE = tid % kPE * (16 / static_cast<int>(sizeof(E)));
  const int rS = tid / kPS, jjS = tid % kPS * (16 / static_cast<int>(sizeof(S)));
  const E* bd_src = kInt8 ? reinterpret_cast<const E*>(psi_q) : reinterpret_cast<const E*>(psi);
  const size_t slot_row = static_cast<size_t>(a_cols) * sizeof(E);  // bytes
  int is_ci = 0, is_tile = 0, is_c = 0, kv_stride = 0;
  bool inE = false, inS = false;
  const S* col_k = k_win;
  const S* col_v = v_win;
  auto issue_next = [&]() {
    const int k0 = is_tile * kFwdKeys;
    const int c = is_c;
    unsigned char* dst = ring + (is_ci % kWideStages) * kChunkBytes;
    if (c == 0) {
      inE = k0 + jjE < K;
      inS = k0 + jjS < K;
      col_k = commu::key_column(k_mem, k_win, b, h, inS ? k0 + jjS : 0, H, dh, R, Tb, T, M,
                                &kv_stride);
      col_v = commu::key_column(v_mem, v_win, b, h, inS ? k0 + jjS : 0, H, dh, R, Tb, T, M,
                                &kv_stride);
    }
    ++is_ci;
    if (++is_c == per_tile) is_c = 0, ++is_tile;
    if (c < bd_span) {
      if (streamed && c % 2 == 0) {  // the query side's chunk c / 2: [64][128 bytes]
        const unsigned char* src = slot + static_cast<size_t>(c / 2) * 128;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = tid / 8 + 32 * i, piece = tid % 8;
          commu::cp_async16(dst + r * kWideAStride * 4 + piece * 16,
                            src + r * slot_row + piece * 16, true);
        }
        return;
      }
      const int cb = streamed ? c / 2 : c;
      E* d_s = reinterpret_cast<E*>(dst);
      if (aligned) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = rE + i * (kFwdThreads / kPE);
          const int row = cb * kRowsE + r;
          const bool in = inE && row < bd_rows;
          commu::cp_async16(d_s + r * kChunkStride + jjE,
                            in ? bd_src + static_cast<size_t>(row) * K + k0 + jjE : bd_src, in);
        }
      } else {
        for (int e = tid; e < kRowsE * kFwdKeys; e += kFwdThreads) {
          const int r = e / kFwdKeys, jj = e % kFwdKeys;
          const int j = k0 + jj, row = cb * kRowsE + r;
          d_s[r * kChunkStride + jj] = j < K && row < bd_rows
                                           ? bd_src[static_cast<size_t>(row) * K + j]
                                           : zero_of<E>();
        }
      }
      return;
    }
    const bool is_k = c < bd_span + kc;
    const int row0 = (is_k ? c - bd_span : c - bd_span - kc) * kRowsS;
    S* d_s = reinterpret_cast<S*>(dst);
    if (aligned) {
      const S* col = is_k ? col_k : col_v;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = rS + i * (kFwdThreads / kPS);
        const int d = row0 + r;
        const bool in = inS && d < dh;
        commu::cp_async16(d_s + r * kChunkStride + jjS,
                          in ? col + static_cast<size_t>(d) * kv_stride : col, in);
      }
    } else {
      const S* mem = is_k ? k_mem : v_mem;
      const S* win = is_k ? k_win : v_win;
      for (int e = tid; e < kRowsS * kFwdKeys; e += kFwdThreads) {
        const int r = e / kFwdKeys, jj = e % kFwdKeys;
        const int j = k0 + jj, d = row0 + r;
        S val = commu::from_f<S>(0.f);
        if (j < K && d < dh) {
          int stride = 0;
          const S* col = commu::key_column(mem, win, b, h, j, H, dh, R, Tb, T, M, &stride);
          val = col[static_cast<size_t>(d) * stride];
        }
        d_s[r * kChunkStride + jj] = val;
      }
    }
  };

  const __nv_bfloat16* mask_b = mask + (reset[b] != 0 ? static_cast<size_t>(T) * K : 0);
  const bool drop = plane.thresh > 0;
  const uint32_t drop_seed = commu::plane_seed(seed, b, 4096, h);
  const int ndt = (dh + 7) / 8;    // head-dim n-tiles of O
  const int rg = warp % 4;         // the warp's row group
  const int kh = warp / 4;         // its key half, and its n-tiles' parity
  const int rw = 16 * rg;          // its first row in the block
  const int kw = 32 * kh;          // its first key in a tile
  S* p_s = p_all + rw * kWidePStride;  // the row group's P plane [16][72]
  float m_run[2] = {-FLT_MAX, -FLT_MAX};
  float l_run[2] = {0.f, 0.f};
  float back[2] = {0.f, 0.f};  // the int8 form's amax / (127 * 127) of rows g, g + 8
  float s[kNT][4], o[kO][4];
  int si[kNT][4];
  uint32_t mpair[2][kNT];
  bool skip_s = false, skip_pv = false;
  // the tile's mask pairs (j, j + 1) of the thread's rows: read where the
  // tile starts under kSkip (its skip needs them), else where S is
  // complete, so they hold no registers across the BD chunks (the f32
  // float form at 128 registers spilled less: 11-13% faster on an H100)
  auto read_mask = [&](int k0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + rw + g + 8 * half;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        mpair[half][n] = row < T ? mask_pair(mask_b + static_cast<size_t>(row) * K,
                                             k0 + kw + 8 * n + 2 * qd, K) : 0u;
    }
  };
#pragma unroll
  for (int n = 0; n < kO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  __syncthreads();  // the query side is complete; region 0 is free
  if constexpr (kInt8) {
    back[0] = amax_s[rw + g] * static_cast<float>(1.0 / (127.0 * 127.0));
    back[1] = amax_s[rw + g + 8] * static_cast<float>(1.0 / (127.0 * 127.0));
  }
  constexpr int kStep = 2;
  constexpr int kGroups = kWideStages / kStep;
#pragma unroll 1
  for (int gi = 0; gi < kGroups - 1; ++gi) {
#pragma unroll
    for (int u = 0; u < kStep; ++u)
      if (is_ci < total) issue_next();
    commu::cp_async_commit();
  }
  int tile = 0, c = -1;
  const unsigned char* a_buf = ring;  // the streamed query chunk of this BD chunk
#pragma unroll 1
  for (int ci = 0; ci < total; ++ci) {
    if (ci % kStep == 0) {
      commu::cp_async_wait<kGroups - 2>();
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kStep; ++u)
        if (is_ci < total) issue_next();
      commu::cp_async_commit();
    }
    if (++c == per_tile) c = 0, ++tile;
    const int k0 = tile * kFwdKeys;
    const unsigned char* buf = ring + (ci % kWideStages) * kChunkBytes;
    if (c == 0) {
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f, si[n][e] = 0;
      if constexpr (kSkip) {
        read_mask(k0);
        bool masked = true;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = q0 + rw + g + 8 * half;
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            const int j = k0 + kw + 8 * n + 2 * qd;
            if (row < T) {
              masked &= j >= K || __uint_as_float(mpair[half][n] << 16) <= kMaskedBelow;
              masked &= j + 1 >= K || __uint_as_float(mpair[half][n] & 0xffff0000u) <= kMaskedBelow;
            }
          }
        }
        skip_s = __all_sync(0xffffffffu, masked);
      }
    }
    if (c < bd_span) {  // BD over this chunk's depth
      if (streamed && c % 2 == 0) {
        a_buf = buf;  // the query chunk; its product comes with psi's
        continue;
      }
      if (skip_s) continue;
      const int cb = streamed ? c / 2 : c;
      const int as = streamed ? kWideAStride * 4 / static_cast<int>(sizeof(E)) : L.sa;
      if constexpr (kInt8) {
        const int* bw = reinterpret_cast<const int*>(buf) + kw;
        const int* aw = streamed ? reinterpret_cast<const int*>(a_buf) + rw * as
                                 : reinterpret_cast<const int*>(a_bd) + rw * as + cb * kRowsE;
#pragma unroll
        for (int ks = 0; ks < kRowsE / 8; ++ks)
          commu::mma_step_s8<1, kNT>(reinterpret_cast<int(&)[1][kNT][4]>(si), aw + 8 * ks, as,
                                     bw + 8 * ks * kChunkStride, kChunkStride, lane);
      } else if constexpr (sizeof(S) == 4) {
        const float* bf = reinterpret_cast<const float*>(buf) + kw;
        const float* af = streamed ? reinterpret_cast<const float*>(a_buf) + rw * as
                                   : reinterpret_cast<const float*>(a_bd) + rw * as + cb * kRowsS;
        float t[1][kNT][4] = {};  // the chunk's products, promoted (see add_chunk)
#pragma unroll
        for (int kk = 0; kk < kRowsS; kk += 8)
          commu::mma_step<float, 1, kNT>(t, af + kk, as, 1, bf + kk * kChunkStride, kChunkStride,
                                         1, lane);
        add_chunk(s, t);
      } else {
        const __nv_bfloat16* bf = reinterpret_cast<const __nv_bfloat16*>(buf) + kw;
        const __nv_bfloat16* af =
            streamed ? reinterpret_cast<const __nv_bfloat16*>(a_buf) + rw * as
                     : reinterpret_cast<const __nv_bfloat16*>(a_bd) + rw * as + cb * kRowsS;
#pragma unroll
        for (int kk = 0; kk < kRowsS; kk += 16)
          step_bf16(s, af + kk, as, bf + kk * kChunkStride, lane);
      }
    } else if (c < bd_span + kc) {  // AC = qw^T k over this chunk's head dims
      const int d0 = (c - bd_span) * kRowsS;
      if (skip_s) {
        // every score here is masked: S stays 0 + mask
      } else if constexpr (sizeof(S) == 4) {
        const float* bf = reinterpret_cast<const float*>(buf) + kw;
        const float* af = reinterpret_cast<const float*>(qw_s) + rw * L.qws + d0;
        float t[1][kNT][4] = {};
#pragma unroll
        for (int kk = 0; kk < kRowsS; kk += 8)
          if (d0 + kk < dh)
            commu::mma_step<float, 1, kNT>(t, af + kk, L.qws, 1, bf + kk * kChunkStride,
                                           kChunkStride, 1, lane);
        add_chunk(s, t);
      } else {
        const __nv_bfloat16* bf = reinterpret_cast<const __nv_bfloat16*>(buf) + kw;
        const __nv_bfloat16* af =
            reinterpret_cast<const __nv_bfloat16*>(qw_s) + rw * L.qws + d0;
#pragma unroll
        for (int kk = 0; kk < kRowsS; kk += 16)
          if (d0 + kk < dh) step_bf16(s, af + kk, L.qws, bf + kk * kChunkStride, lane);
      }
      if (c == bd_span + kc - 1) {
        // S complete: the int8 BD term, the mask, the residual and the
        // tile's row maxima; the pair agrees on m; P into the plane
        if constexpr (!kSkip) read_mask(k0);
        float tmax[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = q0 + rw + g + 8 * half;
          const bool live_row = row < T;
          float mx = -INFINITY;
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            const int j = k0 + kw + 8 * n + 2 * qd;
            float v2[2];
            const float mk[2] = {__uint_as_float(mpair[half][n] << 16),
                                 __uint_as_float(mpair[half][n] & 0xffff0000u)};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float v = s[n][2 * half + e];
              if constexpr (kInt8) v += static_cast<float>(si[n][2 * half + e]) * back[half];
              if (j + e >= K) {
                v = -INFINITY;
              } else if (live_row) {
                v += mk[e];
              }
              if constexpr (kClamp) v = fminf(v, 60.f);
              v2[e] = v;
              mx = fmaxf(mx, v);
            }
            s[n][2 * half] = v2[0];
            s[n][2 * half + 1] = v2[1];
            if (s_res != nullptr && live_row) {
              float* at = s_res + (static_cast<size_t>(bh) * T + row) * K + j;
              if ((K & 1) == 0 && j + 1 < K) {
                *reinterpret_cast<float2*>(at) = make_float2(v2[0], v2[1]);
              } else {
                if (j < K) at[0] = v2[0];
                if (j + 1 < K) at[1] = v2[1];
              }
            }
          }
          tmax[half] = quad_max(mx);
          if constexpr (!kClamp) {
            if (qd == 0) mx_s[kh * kFwdRows + rw + g + 8 * half] = tmax[half];
          }
        }
        if constexpr (!kClamp) pair_sync(rg);  // the partner's tile maxima
        bool zero_p = true;  // the live rows' P of the warp's keys is all zeros
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = rw + g + 8 * half;
          const int row = q0 + r;
          const bool live_row = row < T;
          float m_new = 0.f, alpha = 1.f;  // kClamp: no maximum, no rescale
          if constexpr (!kClamp) {
            m_new = fmaxf(m_run[half], fmaxf(tmax[half], mx_s[(1 - kh) * kFwdRows + r]));
            alpha = expf(m_run[half] - m_new);
          }
          float psum = 0.f;
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            float pr[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = expf(s[n][2 * half + e] - m_new);
              psum += p;
              float pd = p;
              if (drop && (!kSkip || p != 0.f)) {  // a zero stays zero, kept or not
                const int j = k0 + kw + 8 * n + 2 * qd + e;
                pd = (live_row && j < K && commu::keep(plane, drop_seed, row, j))
                         ? (kAfter ? p : p * plane.scale) : 0.f;
              }
              pr[e] = commu::rnd<S>(pd);
              if constexpr (kSkip) zero_p &= !live_row || pr[e] == 0.f;
            }
            S* at = p_s + (g + 8 * half) * kWidePStride + kw + 8 * n + 2 * qd;
            if constexpr (sizeof(S) == 4) {
              *reinterpret_cast<float2*>(at) = make_float2(pr[0], pr[1]);
            } else {
              *reinterpret_cast<uint32_t*>(at) = commu::pack_bf16(pr[0], pr[1]);
            }
          }
          if constexpr (kClamp) {
            l_run[half] += quad_sum(psum);
          } else {
            l_run[half] = l_run[half] * alpha + quad_sum(psum);
            m_run[half] = m_new;
#pragma unroll
            for (int n = 0; n < kO; ++n) {
              o[n][2 * half] *= alpha;
              o[n][2 * half + 1] *= alpha;
            }
          }
        }
        if constexpr (kSkip) {
          const bool all_zero = __all_sync(0xffffffffu, zero_p);
          if (lane == 0) zf_s[2 * rg + kh] = all_zero;
        }
        pair_sync(rg);  // the row group's P plane is whole
        if constexpr (kSkip) skip_pv = zf_s[2 * rg] && zf_s[2 * rg + 1];
      }
    } else if (!skip_pv) {  // O += P v over this chunk's head dims, all 64 keys
      pv_wide<S, kO>(o, p_s, reinterpret_cast<const S*>(buf), c - bd_span - kc, kh, ndt, lane);
    }
  }
  commu::cp_async_wait<0>();

  // ---- the end: the pair's row sums add; each warp writes its head dims
#pragma unroll
  for (int half = 0; half < 2; ++half)
    if (qd == 0) l_s[kh * kFwdRows + rw + g + 8 * half] = l_run[half];
  pair_sync(rg);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = rw + g + 8 * half;
    const int i = q0 + r;
    if (i >= T) continue;
    float l = l_s[r] + l_s[kFwdRows + r];
    if constexpr (kClamp) l = fmaxf(l, 1e-30f);
    float inv = 1.f / l;
    if constexpr (kAfter) inv *= plane.scale;  // 1 without dropout
    const size_t q_off = static_cast<size_t>(bh) * dh * T;
#pragma unroll
    for (int n = 0; n < kO; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * (2 * n + kh) + 2 * qd + e;
        if (d < dh) out[q_off + static_cast<size_t>(d) * T + i] =
            commu::from_f<S>(o[n][2 * half + e] * inv);
      }
    if (lse != nullptr && kh == 0 && qd == 0)
      lse[static_cast<size_t>(bh) * T + i] = kClamp ? logf(l) : m_run[half] + logf(l);
  }
}

}  // namespace
