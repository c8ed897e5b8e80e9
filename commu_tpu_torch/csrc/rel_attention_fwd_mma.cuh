// The attention forward on the tensor cores: one block of 64 query rows of
// one (batch row, head) against the keys [ring slabs | window], the body of
// rel_attention_mem_fwd.cu and, with R = 0 (no slabs: every key from the
// window), of rel_attention_fwd.cu.
//
// Per (b, h), keys j over [ring slabs 0..R-1 | window], K = M + T (see
// rel_attention_mem_fwd.cu for the operands):
//   S = qw^T k + phi psi + mask[reset[b]],  O = v softmax_rows(S)^T
//
// Design, flash-attention-2 style.  256 threads, 8 warps: warp w takes
// query rows 16 (w % 4) .. + 15 against keys 32 (w / 4) .. + 31 of every
// tile, as an attention of its own with its own running maxima, sums and
// output; the two warps of a row group merge theirs once at the end (O = (O1
// e^(m1 - m) + O2 e^(m2 - m)) / (l1 e^(m1 - m) + l2 e^(m2 - m))), so the
// softmax never leaves a warp inside the key loop.
//   - The query side is formed once per block, in shared memory: qw, and u =
//     qr^T W_r with the trig combine into phi, in the FMA order of the first
//     design (one fmaf chain a (row, f) over the head dims in order, which
//     the wide body keeps), so phi, and the int8 form's phi_q, keep their
//     bits.  The int8 form forms phi 16 rows at a time, in
//     f32, takes each row's absolute maximum and packs phi_q = rint(phi *
//     (127 / max(amax, 1e-20))) four depth bytes a word.  The float forms
//     keep phi in S (f32, or bf16 rounded as the reference rounds it).
//   - The key side streams in tiles of 64 keys, ring slabs first, through a
//     ring of 4 to 8 chunks of 9,216 bytes fed by 16-byte cp.async: per
//     tile the BD operand (psi_q words [2F / 4][K] in 32-word chunks, or psi
//     in 32 f32 or 64 bf16 depth rows a chunk), then k, then v, each staged
//     as it lies in memory, [depth][key].  A shape whose key groups are no
//     whole 16 bytes (T or Tb not a multiple of 16 / sizeof(S)) takes plain
//     loads into the same ring.  Two chunks are issued and consumed between
//     two barriers (one in the bf16 float form, whose ring holds 4).
//   - S of a warp's 16 rows x 32 keys lives in mma accumulators, 16 floats a
//     thread.  BD int8: mma.sync m16n8k32 s8.s8.s32, the int32 sum exact in
//     any order, then float(sum) * (amax / (127 * 127)); BD float and AC =
//     qw^T k: 3xTF32 on m16n8k8 in f32 (reduce.cuh's mma_step), bf16
//     m16n8k16 with f32 sums in bf16 (B fragments by ldmatrix.trans); dh is
//     zero-padded to 56 (k8) or 64 (k16).
//   - The mask is added to the accumulators, the S residual written from
//     them, and the online softmax runs on them: row maxima and sums across
//     the quad of lanes that shares a row, the output rescaled in registers.
//     The tile's P stays in the accumulators and is the A operand of O += P
//     v: bf16 pairs of two n-tiles make an m16n8k16 A fragment; in f32 a k8
//     step takes keys (2q, 2q + 1) into its slots (q, q + 4), and v's B
//     fragments are read in the same order.
//   - Dropout, masking and rounding as in the first design: commu::keep at
//     each element's (row, j); the unnormalised tile dropped and scaled, the
//     running sum taking the undropped exponentials, P rounded to S before
//     the one division at the end; NEG_INF from the bf16 table added in f32;
//     a first tile whose columns are all masked is wiped by exp(NEG_INF - m)
//     = 0 when a real key arrives.
//   - Masked tiles (kSkip): where a warp's 16 rows x 32 keys of a tile are
//     all masked (mask <= -1e30: over the window alone, the causal upper
//     triangle), the warp takes no BD or AC product there; its accumulators stay 0, so S = 0 + mask, what the
//     products give too (|AC + BD| is far below half an ulp of NEG_INF,
//     2^103).  Where the warp's P of a tile is all zeros (exp underflows
//     behind a live maximum), it takes no P v there.  Neither changes a bit
//     of out, lse or S.  The tile is still staged: the ring is the block's.
//   - A row group (kGroup rows) at or past T forms no u (kSkip): a short
//     window (the serving prefill, T = 11) pays for one group, not four.
//   - The lever forms (kSoft, commu::kSoftForm of the lever build).  The
//     default form already computes the order of the reference's deferred
//     normalisation (COMMU_DEFER_NORM, fused_attention.py:609-620): P v runs
//     on the unnormalised exps, rounded to S, and the one division by the
//     row sum comes after it (the merge below).  kSoftAfter moves the
//     keep-scale there too: the dropped tile is not scaled, the output is
//     scaled by (1 / l) * keep_scale (COMMU_DEFER_NORM and
//     COMMU_SCALE_HOIST under dropout, :626-634, :660-667; 1 without
//     dropout).  kSoftClamp (COMMU_SOFTMAX=clamp, :597-602) keeps no
//     maximum: each score is clamped at 60 (and saved so in S), p = exp(s),
//     nothing is rescaled, the merge adds the two halves' sums, and the row
//     sum is guarded at 1e-30 (lse = log of it), so a row whose scores all
//     underflow gives zeros.
// Shared memory: the ring (36-72 KB), the query side ([64][F2 + 4] f32 phi
// 129 KB in the f32 float form, [64][F2 + 8] bf16 65 KB in bf16, [64][F2 / 4
// + 4] words 33 KB in the int8 forms) and qw: two blocks (16 warps) an SM
// but in the f32 float form (one).  Every row stride is 4 (A) or 8 (B) mod
// 32 words, so the fragment loads hit distinct banks.
// Everything here has internal linkage: each source that includes this file
// compiles its own copy.
#pragma once

#include "mma_tile.cuh"
#include "prng.cuh"

#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kFwdThreads = 256;  // 8 warps: 4 row groups x 2 key halves
constexpr int kFwdRows = 64;      // query rows a block, 16 a row group
constexpr int kNT = 4;            // n-tiles of 8 keys a warp takes of a tile
constexpr int kFwdKeys = 64;      // keys a tile
constexpr int kChunkBytes = 9216;  // a chunk: 32 rows of 72 words, or 64 of 72 bf16
constexpr int kChunkStride = 72;   // a chunk's row stride in elements: 8 mod 32 words (4-byte)
constexpr int kGroup = 16;         // query rows whose phi is formed at a time
constexpr int kFwdMaxDh = 64;
constexpr int kFwdMaxF2 = 512;
constexpr int kQwStrideF = 68;     // qw [row][d], f32: 4 mod 32 words
constexpr int kQwStrideB = 72;     // qw [row][d], bf16: 36 words
// a mask value at or below this blocks its score (NEG_INF = -0.7 FLT_MAX;
// the backward's live test is S > -1e30)
constexpr float kMaskedBelow = -1e30f;

// rows of one chunk of 4-byte (32) or 2-byte (64) elements
template <typename E>
__host__ __device__ constexpr int chunk_rows() {
  return kChunkBytes / (kChunkStride * static_cast<int>(sizeof(E)));
}

// The query side's row strides in elements.
template <typename S, bool kInt8>
__host__ __device__ constexpr int a_stride(int F2) {
  return kInt8 ? F2 / 4 + 4 : (sizeof(S) == 4 ? F2 + 4 : F2 + 8);
}

// Chunks in flight on the key side: as many as leave room for two blocks
// an SM (one in the f32 float form, whose phi takes 129 KB).
template <typename S, bool kInt8>
__host__ __device__ constexpr int fwd_stages() {
  return kInt8 ? 6 : (sizeof(S) == 2 ? 4 : 8);
}

// Chunks consumed between two barriers: a step's chunks are issued and
// waited for together (a tile is a whole number of steps: its chunk counts
// are even).  The bf16 float form, whose ring holds only 4, takes them one
// at a time.
template <typename S, bool kInt8>
__host__ __device__ constexpr int fwd_step() {
  return !kInt8 && sizeof(S) == 2 ? 1 : 2;
}

template <typename S, bool kInt8>
__host__ __device__ inline size_t fwd_mma_smem(int F2) {
  const size_t a_bytes = static_cast<size_t>(kFwdRows) * a_stride<S, kInt8>(F2) *
                         (kInt8 ? 4 : sizeof(S));
  const size_t qw_bytes = static_cast<size_t>(kFwdRows) *
                          (sizeof(S) == 4 ? kQwStrideF * 4 : kQwStrideB * 2);
  return static_cast<size_t>(fwd_stages<S, kInt8>()) * kChunkBytes + a_bytes + qw_bytes +
         sizeof(float) * kFwdRows;
}

template <typename E>
__device__ __forceinline__ E zero_of() {
  return commu::from_f<E>(0.f);
}
template <>
__device__ __forceinline__ int zero_of<int>() {
  return 0;
}

// The mask's bf16 pair (j, j + 1) of a row as one word, j in the low half
// (zeros past K)
__device__ __forceinline__ uint32_t mask_pair(const __nv_bfloat16* row, int j, int K) {
  if ((K & 1) == 0 && j + 1 < K) return *reinterpret_cast<const uint32_t*>(row + j);
  const uint16_t* r16 = reinterpret_cast<const uint16_t*>(row);
  const uint32_t lo = j < K ? r16[j] : 0u, hi = j + 1 < K ? r16[j + 1] : 0u;
  return lo | (hi << 16);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One k16 step of bf16 products into a warp's 16 x 32 accumulators: A rows
// [16][sa] bf16 (depth contiguous), B 16 depth rows of a chunk, stride
// kChunkStride bf16 (keys contiguous), read by ldmatrix.trans.
__device__ __forceinline__ void step_bf16(float (&acc)[kNT][4], const __nv_bfloat16* a, int sa,
                                          const __nv_bfloat16* b, int lane) {
  const int g = lane / 4, q = lane % 4;
  uint32_t af[4];
  af[0] = *reinterpret_cast<const uint32_t*>(a + g * sa + 2 * q);
  af[1] = *reinterpret_cast<const uint32_t*>(a + (g + 8) * sa + 2 * q);
  af[2] = *reinterpret_cast<const uint32_t*>(a + g * sa + 8 + 2 * q);
  af[3] = *reinterpret_cast<const uint32_t*>(a + (g + 8) * sa + 8 + 2 * q);
  const int tile = lane / 8, row = lane % 8;
#pragma unroll
  for (int np = 0; np < kNT / 2; ++np) {  // tiles (k0, n0) = (0, 0) (8, 0) (0, 8) (8, 8)
    uint32_t r[4];
    ldsm_x4_trans(r, b + ((tile % 2) * 8 + row) * kChunkStride + np * 16 + (tile / 2) * 8);
    const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
    commu::mma_bf16(acc[2 * np], af, b0);
    commu::mma_bf16(acc[2 * np + 1], af, b1);
  }
}

// O[:, 8 nd ..] += P v over one f32 v chunk (head dims 32 kPart .. + 31) and
// the warp's 32 keys (v_s at its first key), 3xTF32: A from the P
// accumulators, key 2q + c of a k8 step in slot q + 4 c; v's B fragments in
// the same order, one float2 a lane.
template <int kPart>
__device__ __forceinline__ void pv_f32(float (&o)[8][4], const float (&p)[kNT][4],
                                       const float* v_s, int ndt, int lane) {
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int kk = 0; kk < kNT; ++kk) {
    uint32_t ah[4], al[4];
    commu::split_tf32(p[kk][0], ah[0], al[0]);
    commu::split_tf32(p[kk][2], ah[1], al[1]);
    commu::split_tf32(p[kk][1], ah[2], al[2]);
    commu::split_tf32(p[kk][3], ah[3], al[3]);
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int nl = 0; nl < 4; ++nl) {
      const float2 v2 =
          *reinterpret_cast<const float2*>(v_s + (8 * nl + g) * kChunkStride + 8 * kk + 2 * q);
      commu::split_tf32(v2.x, bh[nl][0], bl[nl][0]);
      commu::split_tf32(v2.y, bh[nl][1], bl[nl][1]);
    }
#pragma unroll
    for (int nl = 0; nl < 4; ++nl)
      if (4 * kPart + nl < ndt) commu::mma_tf32(o[4 * kPart + nl], al, bh[nl]);
#pragma unroll
    for (int nl = 0; nl < 4; ++nl)
      if (4 * kPart + nl < ndt) commu::mma_tf32(o[4 * kPart + nl], ah, bl[nl]);
#pragma unroll
    for (int nl = 0; nl < 4; ++nl)
      if (4 * kPart + nl < ndt) commu::mma_tf32(o[4 * kPart + nl], ah, bh[nl]);
  }
}

// O += P v over the bf16 v chunk (all head dims) and the warp's 32 keys: the
// P pairs of n-tiles 2kk and 2kk + 1 are the A fragment of key step kk.
__device__ __forceinline__ void pv_bf16(float (&o)[8][4], const float (&p)[kNT][4],
                                        const __nv_bfloat16* v_s, int ndt, int lane) {
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int kk = 0; kk < kNT / 2; ++kk) {
    const uint32_t af[4] = {commu::pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            commu::pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            commu::pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            commu::pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) {
      if (nd >= ndt) continue;
      const __nv_bfloat16* vr = v_s + (8 * nd + g) * kChunkStride + 16 * kk + 2 * q;
      const uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(vr),
                              *reinterpret_cast<const uint32_t*>(vr + 8)};
      commu::mma_bf16(o[nd], af, bf);
    }
  }
}

// One block: query rows q0 .. q0 + 63 of head bh = b * H + h.  ``aligned``:
// every 16-byte group of keys of the key side lies whole in one slab or the
// window (cp.async); else plain loads.  ``kSkip``: the masked-tile and
// row-group skips (see the header); the no-memory forward compiles them in,
// the memory forward does not (with them its int8 form ran 4% slower).
// No parameter carries __restrict__: the projecting forward
// (rel_attention_proj_fwd.cu) reads slabs that its own block wrote, which
// the read-only path (ld.global.nc) may serve stale; a kernel whose
// operands are all read-only says so on its own parameters.
template <typename S, bool kInt8, bool kSkip = false, int kSoft = 0>
__device__ __forceinline__ void attend_rows_mma(
    unsigned char* smem, const S* q, const S* rwbs, const S* rrbs, const S* k_mem,
    const S* k_win, const S* v_mem, const S* v_win, const S* w_r, const S* trig_a, const S* psi,
    const int* psi_q, const __nv_bfloat16* mask, const int* reset, S* out, float* s_res,
    float* lse, int bh, int q0, int H, int dh, int T, int R, int Tb, int F2, float scale,
    int seed, const commu::Plane& plane, bool aligned) {
  using E = typename std::conditional<kInt8, int, S>::type;  // the BD operand's element
  constexpr int kFwdStages = fwd_stages<S, kInt8>();
  constexpr bool kClamp = (kSoft & commu::kSoftClamp) != 0;
  constexpr bool kAfter = (kSoft & commu::kSoftAfter) != 0;
  const int M = R * Tb;
  const int K = M + T;
  const int fpad = F2 / 2;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, qd = lane % 4;
  const int sa = a_stride<S, kInt8>(F2);

  unsigned char* ring = smem;
  unsigned char* a_raw = ring + kFwdStages * kChunkBytes;
  E* a_bd = reinterpret_cast<E*>(a_raw);  // phi_q words, or phi in S
  S* qw_s = reinterpret_cast<S*>(a_raw + static_cast<size_t>(kFwdRows) * sa * sizeof(E));
  constexpr int kQw = sizeof(S) == 4 ? kQwStrideF : kQwStrideB;
  float* amax_s = reinterpret_cast<float*>(qw_s + kFwdRows * kQw);
  float* phig = reinterpret_cast<float*>(ring);  // [kGroup][F2], the int8 form's f32 phi
  float* qr_s = phig + kGroup * kFwdMaxF2;       // [dh][kGroup]: qr of the group's rows

  // ---- the query side, kGroup rows at a time
  const size_t q_off = static_cast<size_t>(bh) * dh * T;
  const float scale_s = commu::rnd<S>(scale);
  const S* wr_h = w_r + static_cast<size_t>(h) * dh * F2;
  for (int r0 = 0; r0 < kFwdRows; r0 += kGroup) {
    for (int idx = tid; idx < kGroup * kFwdMaxDh; idx += kFwdThreads) {
      const int r = idx / kFwdMaxDh, d = idx % kFwdMaxDh;
      const int i = q0 + r0 + r;
      float qw = 0.f, qr = 0.f;
      if (i < T && d < dh) {
        const float qs =
            commu::rnd<S>(commu::to_f(q[q_off + static_cast<size_t>(d) * T + i]) * scale_s);
        qw = commu::rnd<S>(qs + commu::to_f(rwbs[h * dh + d]));
        qr = commu::rnd<S>(qs + commu::to_f(rrbs[h * dh + d]));
      }
      qw_s[(r0 + r) * kQw + d] = commu::from_f<S>(qw);
      if (d < dh) qr_s[d * kGroup + r] = qr;
    }
    __syncthreads();
    // u = qr^T W_r[h] (sin half f, cos half fpad + f), then the per-query
    // trig rotation into phi; each W_r load serves the group's rows.  W_r
    // is read 8 head dims ahead of the sums, which run over d in order.  A
    // group that starts at or past T (a short window: the serving prefill)
    // takes no product: its phi, phi_q and amax are zeros.
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
          a_bd[(r0 + r) * sa + f] = commu::from_f<S>(pc);
          a_bd[(r0 + r) * sa + fpad + f] = commu::from_f<S>(ps);
        }
      }
    }
    __syncthreads();
    if constexpr (kInt8) {
      // row r's maximum: its 16 lanes take every 16th column, then a shuffle
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
        a_bd[(r0 + r) * sa + w] = static_cast<int>(word);
      }
      __syncthreads();  // phig is free for the next group
    }
  }

  // ---- the key side: per tile, bd chunks of the BD operand, kc of k, kc of v
  constexpr int kRowsS = chunk_rows<S>();
  const int bd = kInt8 ? F2 / 4 / chunk_rows<int>() : F2 / kRowsS;
  const int kc = (dh + kRowsS - 1) / kRowsS;
  const int per_tile = bd + 2 * kc;
  const int tiles = (K + kFwdKeys - 1) / kFwdKeys;
  const int total = tiles * per_tile;

  // The issue cursor: the next chunk to issue (is_ci), its tile and place in
  // the tile, and the key columns the thread's copies read in that tile,
  // found once a tile.  A chunk holds 64 keys x 128 bytes: two 16-byte
  // copies a thread, rows r + 0 and r + kFwdThreads / (pieces a row).  The
  // BD operand's rows are of E, k's and v's of S.
  constexpr int kPE = kFwdKeys * static_cast<int>(sizeof(E)) / 16;  // copies a row
  constexpr int kPS = kFwdKeys * static_cast<int>(sizeof(S)) / 16;
  const int rE = tid / kPE, jjE = tid % kPE * (16 / static_cast<int>(sizeof(E)));
  const int rS = tid / kPS, jjS = tid % kPS * (16 / static_cast<int>(sizeof(S)));
  const E* bd_src = kInt8 ? reinterpret_cast<const E*>(psi_q) : reinterpret_cast<const E*>(psi);
  int is_ci = 0, is_tile = 0, is_c = 0, kv_stride = 0;
  bool inE = false, inS = false;
  const S* col_k = k_win;
  const S* col_v = v_win;
  // chunk is_ci into its stage: rows of psi_q words / psi, of k or of v,
  // keys k0 .. k0 + 63 (zeros past K and past dh); then the cursor moves on
  auto issue_next = [&]() {
    const int k0 = is_tile * kFwdKeys;
    const int c = is_c;
    unsigned char* dst = ring + (is_ci % kFwdStages) * kChunkBytes;
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
    if (c < bd) {
      constexpr int rows = chunk_rows<E>();
      E* d_s = reinterpret_cast<E*>(dst);
      if (aligned) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = rE + i * (kFwdThreads / kPE);
          commu::cp_async16(d_s + r * kChunkStride + jjE,
                            inE ? bd_src + static_cast<size_t>(c * rows + r) * K + k0 + jjE
                                : bd_src, inE);
        }
      } else {
        for (int e = tid; e < rows * kFwdKeys; e += kFwdThreads) {
          const int r = e / kFwdKeys, jj = e % kFwdKeys;
          const int j = k0 + jj;
          d_s[r * kChunkStride + jj] =
              j < K ? bd_src[static_cast<size_t>(c * rows + r) * K + j] : zero_of<E>();
        }
      }
      return;
    }
    const bool is_k = c < bd + kc;
    const int row0 = (is_k ? c - bd : c - bd - kc) * kRowsS;
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
  const int ndt = (dh + 7) / 8;  // head-dim n-tiles of O
  const int rw = 16 * (warp % 4);  // the warp's first row in the block
  const int kw = 32 * (warp / 4);  // its first key in a tile
  float m_run[2] = {-FLT_MAX, -FLT_MAX};
  float l_run[2] = {0.f, 0.f};
  float back[2] = {0.f, 0.f};  // the int8 form's amax / (127 * 127) of rows g, g + 8
  if constexpr (kInt8) {
    back[0] = amax_s[rw + g] * static_cast<float>(1.0 / (127.0 * 127.0));
    back[1] = amax_s[rw + g + 8] * static_cast<float>(1.0 / (127.0 * 127.0));
  }
  float s[kNT][4], o[8][4];
  int si[kNT][4];
  uint32_t mpair[2][kNT];  // the tile's mask pairs (j, j + 1), read when it starts
  bool skip_s = false;     // the warp's scores of this tile are all masked
  bool skip_pv = false;    // ... its P is all zeros
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  __syncthreads();  // the query side is complete; the ring is free
  // the ring holds kGroups steps of kStep chunks
  constexpr int kStep = fwd_step<S, kInt8>();
  constexpr int kGroups = kFwdStages / kStep;
#pragma unroll 1
  for (int gi = 0; gi < kGroups - 1; ++gi) {
#pragma unroll
    for (int u = 0; u < kStep; ++u)
      if (is_ci < total) issue_next();
    commu::cp_async_commit();
  }
  int tile = 0, c = -1;  // the chunk consumed: its tile and place in the tile
#pragma unroll 1
  for (int ci = 0; ci < total; ++ci) {
    if (ci % kStep == 0) {
      commu::cp_async_wait<kGroups - 2>();  // this step has landed (this thread's copies)
      __syncthreads();                      // ... everyone's; the previous step is free
#pragma unroll
      for (int u = 0; u < kStep; ++u)
        if (is_ci < total) issue_next();
      commu::cp_async_commit();
    }
    if (++c == per_tile) c = 0, ++tile;
    const int k0 = tile * kFwdKeys;
    const unsigned char* buf = ring + (ci % kFwdStages) * kChunkBytes;
    if (c == 0) {
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f, si[n][e] = 0;
      bool masked = true;  // every score of the warp's 16 rows x 32 keys here
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = q0 + rw + g + 8 * half;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const int j = k0 + kw + 8 * n + 2 * qd;
          mpair[half][n] = row < T ? mask_pair(mask_b + static_cast<size_t>(row) * K, j, K) : 0u;
          if (kSkip && row < T) {
            masked &= j >= K || __uint_as_float(mpair[half][n] << 16) <= kMaskedBelow;
            masked &= j + 1 >= K || __uint_as_float(mpair[half][n] & 0xffff0000u) <= kMaskedBelow;
          }
        }
      }
      skip_s = kSkip && __all_sync(0xffffffffu, masked);
    }
    if (c < bd) {  // BD over this chunk's depth
      if (skip_s) {
        // every score here is masked: S stays 0 + mask
      } else if constexpr (kInt8) {
        const int* bw = reinterpret_cast<const int*>(buf) + kw;
        const int* aw = reinterpret_cast<const int*>(a_bd) + rw * sa + c * chunk_rows<int>();
#pragma unroll
        for (int ks = 0; ks < chunk_rows<int>() / 8; ++ks)
          commu::mma_step_s8<1, kNT>(reinterpret_cast<int(&)[1][kNT][4]>(si), aw + 8 * ks, sa,
                                     bw + 8 * ks * kChunkStride, kChunkStride, lane);
      } else if constexpr (sizeof(S) == 4) {
        const float* bf = reinterpret_cast<const float*>(buf) + kw;
        const float* af = reinterpret_cast<const float*>(a_bd) + rw * sa + c * kRowsS;
#pragma unroll
        for (int kk = 0; kk < kRowsS; kk += 8)
          commu::mma_step<float, 1, kNT>(reinterpret_cast<float(&)[1][kNT][4]>(s), af + kk, sa,
                                         1, bf + kk * kChunkStride, kChunkStride, 1, lane);
      } else {
        const __nv_bfloat16* bf = reinterpret_cast<const __nv_bfloat16*>(buf) + kw;
        const __nv_bfloat16* af =
            reinterpret_cast<const __nv_bfloat16*>(a_bd) + rw * sa + c * kRowsS;
#pragma unroll
        for (int kk = 0; kk < kRowsS; kk += 16)
          step_bf16(s, af + kk, sa, bf + kk * kChunkStride, lane);
      }
    } else if (c < bd + kc) {  // AC = qw^T k over this chunk's head dims
      const int d0 = (c - bd) * kRowsS;
      if (skip_s) {
        // as above
      } else if constexpr (sizeof(S) == 4) {
        const float* bf = reinterpret_cast<const float*>(buf) + kw;
        const float* af = reinterpret_cast<const float*>(qw_s) + rw * kQw + d0;
#pragma unroll
        for (int kk = 0; kk < kRowsS; kk += 8)
          if (d0 + kk < dh)
            commu::mma_step<float, 1, kNT>(reinterpret_cast<float(&)[1][kNT][4]>(s), af + kk,
                                           kQw, 1, bf + kk * kChunkStride, kChunkStride, 1,
                                           lane);
      } else {
        const __nv_bfloat16* bf = reinterpret_cast<const __nv_bfloat16*>(buf) + kw;
        const __nv_bfloat16* af = reinterpret_cast<const __nv_bfloat16*>(qw_s) + rw * kQw + d0;
#pragma unroll
        for (int kk = 0; kk < kRowsS; kk += 16)
          if (d0 + kk < dh) step_bf16(s, af + kk, kQw, bf + kk * kChunkStride, lane);
      }
      if (c == bd + kc - 1) {
        // S complete: the int8 BD term, the mask, the residual, then the
        // online softmax; P replaces S in the accumulators
        bool zero_p = true;  // the live rows' P of this tile is all zeros
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = q0 + rw + g + 8 * half;
          const bool live_row = row < T;
          float tmax = -INFINITY;
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
              tmax = fmaxf(tmax, v);
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
          float m_new = 0.f, alpha = 1.f;  // kClamp: no maximum, no rescale
          if constexpr (!kClamp) {
            m_new = fmaxf(m_run[half], quad_max(tmax));
            alpha = expf(m_run[half] - m_new);
          }
          float psum = 0.f;
#pragma unroll
          for (int n = 0; n < kNT; ++n)
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
              s[n][2 * half + e] = commu::rnd<S>(pd);
              if constexpr (kSkip) zero_p &= !live_row || s[n][2 * half + e] == 0.f;
            }
          if constexpr (kClamp) {
            l_run[half] += quad_sum(psum);
          } else {
            l_run[half] = l_run[half] * alpha + quad_sum(psum);
            m_run[half] = m_new;
#pragma unroll
            for (int n = 0; n < 8; ++n) {
              o[n][2 * half] *= alpha;
              o[n][2 * half + 1] *= alpha;
            }
          }
        }
        skip_pv = kSkip && __all_sync(0xffffffffu, zero_p);
      }
    } else {  // O += P v over this chunk's head dims and the warp's keys
      if (skip_pv) {
        // P is all zeros here: it adds nothing
      } else if constexpr (sizeof(S) == 4) {
        const float* v_s = reinterpret_cast<const float*>(buf) + kw;
        if (c == bd + kc)
          pv_f32<0>(o, s, v_s, ndt, lane);
        else
          pv_f32<1>(o, s, v_s, ndt, lane);
      } else {
        pv_bf16(o, s, reinterpret_cast<const __nv_bfloat16*>(buf) + kw, ndt, lane);
      }
    }
  }
  commu::cp_async_wait<0>();
  __syncthreads();  // every warp is past its last chunk: the ring is free

  // ---- the merge: the second key half's warps hand over (m, l, O) of
  // their rows, the first's combine and write
  constexpr int kOs = kFwdMaxDh + 1;
  float* o_s = reinterpret_cast<float*>(ring);  // [kFwdRows][kOs]
  float* ml_s = o_s + kFwdRows * kOs;           // [2][kFwdRows]: m, l
  if (kw != 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = rw + g + 8 * half;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) o_s[r * kOs + 8 * n + 2 * qd + e] = o[n][2 * half + e];
      if (qd == 0) {
        ml_s[r] = m_run[half];
        ml_s[kFwdRows + r] = l_run[half];
      }
    }
  }
  __syncthreads();
  if (kw != 0) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = rw + g + 8 * half;
    const int i = q0 + r;
    if (i >= T) continue;
    const float m2 = ml_s[r], l2 = ml_s[kFwdRows + r];
    float m = 0.f, a1 = 1.f, a2 = 1.f, l, inv;
    if constexpr (kClamp) {
      l = fmaxf(l_run[half] + l2, 1e-30f);
    } else {
      m = fmaxf(m_run[half], m2);
      a1 = expf(m_run[half] - m), a2 = expf(m2 - m);
      l = l_run[half] * a1 + l2 * a2;
    }
    inv = 1.f / l;
    if constexpr (kAfter) inv *= plane.scale;  // 1 without dropout
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * n + 2 * qd + e;
        if (d < dh)
          out[q_off + static_cast<size_t>(d) * T + i] =
              commu::from_f<S>((o[n][2 * half + e] * a1 + o_s[r * kOs + d] * a2) * inv);
      }
    if (lse != nullptr && qd == 0)
      lse[static_cast<size_t>(bh) * T + i] = kClamp ? logf(l) : m + logf(l);
  }
}

}  // namespace
