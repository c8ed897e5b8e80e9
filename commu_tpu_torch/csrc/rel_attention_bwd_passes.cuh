// The passes that the two attention backward kernels share.
//
// rel_attention_mem_bwd.cu (keys over [ring slabs | window]) and
// rel_attention_bwd.cu (the window alone: R = 0, so M = 0 and every key is a
// window key) run the same three kernels, as the reference's _bwd_kernel_mem
// and _bwd_kernel share _bwd_stage_a and _bwd_stage_b
// (commu_tpu/ops/fused_attention.py:888, :931):
//   (A) bwd_keys_kernel: one block per (b, h, 64 keys), looping over the
//       queries 64 at a time: dP = dO^T v, P, ds (written to a [B, H, T, K]
//       workspace), the block-local sums dk = qw ds_c, dv = dO rnd(probs) of
//       its keys, and each row's max |ds| over its 64 keys;
//   (B) bwd_queries_kernel: one block per (b, h, 64 queries), looping over
//       the keys 32 at a time: dphi = ds_c psi^T and k ds_c^T; then du,
//       W_r du^T, dq, and the per-block sums of k ds_c^T and du for the bias
//       gradients;
//   bias_grad_kernel: one block per head, batch rows and tiles in order.
// QrOp and DuOp are the operands of dW_r = sum_b qr du (reduce.cuh).
// ModelConfig()'s widths (dh <= 64, 2F 256 or 512) run these forms; every
// other width up to dh 128 and any 2F a multiple of 256 (Transformer-XL's
// published widths: 2F 768 at units 768, 1024 at 1024) runs pass A sized
// for dh <= 128 (bwd_keys_kernel<S, 128>) and bwd_queries_wide_kernel,
// which takes 2F in chunks of 256 columns (narrow_widths picks the form).
//
// Every product runs on the tensor cores (reduce.cuh's mma_step): 3xTF32 on
// mma.sync m16n8k8 in f32, bf16 mma.sync m16n8k16 in bf16, where each
// operand is a bf16 value already (the reference's casts: dO, v, k, psi, W_r
// are inputs, probs, qw, ds_c and du are rounded by rnd<S>), so the products
// are exact and only the order of the f32 sums differs from an FMA loop.
// One exception: in f32, dP = dO^T v stays an FMA loop (see pass A).
// Operands are staged as f32 in shared memory, zero-padded to the MMA widths
// (the head width dh to 8 or 16 as depth, to 64 as a row count), with row
// strides of 4 or 8 mod 32 words chosen for the fragment loads' banks.
//
// The int8 dphi form (the reference's _bwd_stage_b :975-984 under
// COMMU_BD_INT8_BWD=1; bwd_queries_kernel<S, kNH, true>): pass A then leaves
// ds in the workspace before its rounding and writes, per (row, 64-key tile),
// the maximum of |ds| over the tile into a [B, H, T, ceil(K / 64)] buffer;
// pass B takes each row's maximum of those, the whole row's as the reference
// takes it (the same f32 value a sweep of the row gives), sc = max(amax,
// 1e-30) * (1 / 127), quantises each ds element once as it stages the tile,
// ds_q = rint(ds * (1 / sc)), and sums ds_q psi_q^T on
// mma.sync m16n8k32 s8.s8.s32: psi_q arrives as [ceil(K / 4)][2F] words of
// four keys (a B fragment register each), the staged ds_q as words of four
// keys of a row (an A fragment register each).  Integer sums are exact in any
// order, so dphi = float(sum) * (sc * (1 / 127)) and du are what any order
// of the same products gives, bit for bit.  k ds_c^T, and all of pass A,
// take the rounded float ds as in the exact form.
// Everything here has internal linkage: each source that includes this file
// compiles its own copy.
#pragma once

#include "prng.cuh"
#include "reduce.cuh"

#include <float.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDh = 64;
constexpr int kAK = 64;   // keys per block in pass A: also the tile of the row maxima
constexpr int kAQ = 64;   // queries per chunk in pass A
constexpr int kAS8 = 72;  // pass A row strides: 8 mod 32 words ...
constexpr int kAS4 = 68;  // ... and 4 mod 32
constexpr int kBQ = 64;   // queries per block in pass B
constexpr int kBThreads = 512;  // threads a block in pass B: two row halves of 8 warps
constexpr int kBJ = 32;   // keys per staged chunk in pass B
constexpr int kBS = kBJ + 4;       // row stride of pass B's ds tile [query][key]
constexpr int kKS = kMaxDh + 8;    // row stride of its k tile [key][d]
constexpr int kQW = kBJ / 4 + 4;   // row stride of its ds_q words [query][4 keys]
constexpr int kWF = 32;            // f per staged chunk of W_r
constexpr int kWS = kWF + 4;       // row stride of a W_r chunk [d][f]
constexpr int kQS = kMaxDh + 1;    // row stride of k ds_c^T [query][d]
constexpr int kMaxC = 4;  // 2F <= 512
constexpr int kWideMaxDh = 128;  // the wide form's head widths

__host__ __device__ inline int amax_tiles(int K) { return (K + kAK - 1) / kAK; }

// ModelConfig()'s form (dh <= 64, 2F 256 or 512); every other width runs the
// wide form (pass A sized for dh <= 128, bwd_queries_wide_kernel), which
// takes dh <= 128 and any 2F a multiple of 256.
inline bool narrow_widths(int dh, int F2) { return dh <= kMaxDh && F2 % 256 == 0 && F2 <= 128 * kMaxC; }
inline bool backward_widths(int dh, int F2) {
  return dh >= 1 && dh <= kWideMaxDh && F2 >= 256 && F2 % 256 == 0;
}

// ---- pass A: P, ds, dk, dv over one key tile
// Shared memory, f32: v [d][key], dO and qw [d][query], probs and ds_c
// [query][key], all 64 x 64.  Warps: dP over (4 x 16 queries) x (2 x 32
// keys); dk and dv over (4 x 16 dims) x (2 x 32 keys), accumulated over the
// chunks in registers.
// kDh: the head width the tiles are sized for, 64 (ModelConfig()'s form) or
// 128 (the wide form: each warp's dk and dv take two 16-row tiles of dims).
template <int kDh = kMaxDh>
inline size_t pass_a_smem() {
  return sizeof(float) * (static_cast<size_t>(kDh) * (3 * kAS8 + kAS4) + kAQ * kAS8 +
                          4 * kAQ);
}

template <typename S, int kDh = kMaxDh>
__global__ void __launch_bounds__(kThreads, kDh == kMaxDh ? 2 : 1)
bwd_keys_kernel(const S* __restrict__ q, const S* __restrict__ rwbs, const S* __restrict__ k_mem,
                const S* __restrict__ k_win, const S* __restrict__ v_mem,
                const S* __restrict__ v_win, const float* __restrict__ s_res,
                const float* __restrict__ lse, const S* __restrict__ out,
                const S* __restrict__ dout, float* __restrict__ ds_buf,
                float* __restrict__ amax_buf, float* __restrict__ dk_mem,
                float* __restrict__ dv_mem, S* __restrict__ dk_win, S* __restrict__ dv_win, int H,
                int dh, int T, int R, int Tb, float scale, int seed, commu::Plane plane,
                bool raw_ds) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kMI = kDh / 64;          // 16-row tiles of dims a warp, in dk and dv
  float* vt_s = smem;                   // [kDh][kAS8]: v[d][key]
  float* do_s = vt_s + kDh * kAS8;      // [kDh][kAS8]: dO[d][query]
  float* p_s = do_s + kDh * kAS8;       // [kDh][kAS8]: O[d][query], then rnd(probs)[query][key]
  float* ds_s = p_s + kDh * kAS8;       // [kAQ][kAS8]: ds_c[query][key]
  float* qw_s = ds_s + kAQ * kAS8;      // [kDh][kAS4]: qw[d][query]
  float* dr_s = qw_s + kDh * kAS4;      // [kAQ]
  float* lse_s = dr_s + kAQ;            // [kAQ]
  float* rmax_s = lse_s + kAQ;          // [2][kAQ]: row maxima of the two key halves
  const int M = R * Tb;
  const int K = M + T;
  const int KT = amax_tiles(K);
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * kAK;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, qd = lane % 4;
  const int wr = warp / 2;  // dP: queries 16 wr; dk, dv: dims 16 kMI wr
  const int wj = warp % 2;  // keys 32 wj
  const size_t q_off = static_cast<size_t>(bh) * dh * T;
  const float scale_s = commu::rnd<S>(scale);
  const bool drop = plane.thresh > 0;
  const uint32_t drop_seed = commu::plane_seed(seed, b, 4096, h);

  {  // v of the tile: one key a thread slot, its column found once
    const int jj = tid % kAK;
    const int j = k0 + jj;
    int stride = 0;
    const S* col =
        commu::key_column(v_mem, v_win, b, h, j < K ? j : 0, H, dh, R, Tb, T, M, &stride);
#pragma unroll
    for (int e = 0; e < kDh * kAK / kThreads; ++e) {
      const int d = tid / kAK + e * (kThreads / kAK);
      vt_s[d * kAS8 + jj] =
          j < K && d < dh ? commu::to_f(col[static_cast<size_t>(d) * stride]) : 0.f;
    }
  }
  float acc_k[kMI][4][4], acc_v[kMI][4][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[mi][ni][e] = acc_v[mi][ni][e] = 0.f;

  for (int i0 = 0; i0 < T; i0 += kAQ) {
    __syncthreads();  // the previous chunk's readers are done
    // dO, qw and (in probs' place until P is formed) O of the chunk
#pragma unroll 8
    for (int e = 0; e < kDh * kAQ / kThreads; ++e) {
      const int idx = tid + e * kThreads;
      const int d = idx / kAQ;
      const int r = idx - d * kAQ;
      const int i = i0 + r;
      float dov = 0.f, ov = 0.f, qw = 0.f;
      if (i < T && d < dh) {
        const size_t at = q_off + static_cast<size_t>(d) * T + i;
        dov = commu::to_f(dout[at]);
        ov = commu::to_f(out[at]);
        const float qs = commu::rnd<S>(commu::to_f(q[at]) * scale_s);
        qw = commu::rnd<S>(qs + commu::to_f(rwbs[h * dh + d]));
      }
      do_s[d * kAS8 + r] = dov;
      p_s[d * kAS8 + r] = ov;
      qw_s[d * kAS4 + r] = qw;
    }
    if (tid < kAQ) lse_s[tid] = i0 + tid < T ? lse[static_cast<size_t>(bh) * T + i0 + tid] : 0.f;
    __syncthreads();
    if (tid < kAQ) {  // Dr = rowsum(dO * O), over d in order
      float dr = 0.f;
      for (int d = 0; d < dh; ++d) dr = fmaf(do_s[d * kAS8 + tid], p_s[d * kAS8 + tid], dr);
      dr_s[tid] = dr;
    }
    // dP = dO^T v over the 64 x 64 tile: queries 16 wr, keys 32 wj, in the
    // C fragment's places.  bf16: on the tensor cores (exact products).
    // f32: an FMA loop over d in order, as the first form of this pass
    // summed it, so ds is that form's to the bit: ds feeds the int8 form's
    // quantiser, where 3xTF32's ~2^-22 product error moved ten times more
    // values across a rounding step of ds_q than the twin's order does, and
    // one step moves a whole row of dphi.
    float dp[1][4][4];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[0][ni][e] = 0.f;
    if constexpr (sizeof(S) == 4) {
      for (int d = 0; d < dh; ++d) {
        const float a0 = do_s[d * kAS8 + 16 * wr + g];
        const float a1 = do_s[d * kAS8 + 16 * wr + g + 8];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const float2 v =
              *reinterpret_cast<const float2*>(&vt_s[d * kAS8 + 32 * wj + 8 * ni + 2 * qd]);
          dp[0][ni][0] = fmaf(a0, v.x, dp[0][ni][0]);
          dp[0][ni][1] = fmaf(a0, v.y, dp[0][ni][1]);
          dp[0][ni][2] = fmaf(a1, v.x, dp[0][ni][2]);
          dp[0][ni][3] = fmaf(a1, v.y, dp[0][ni][3]);
        }
      }
    } else {  // over dh padded to the depth of a step; the padding is zeros
      const int depth = (dh + commu::kMmaK<S> - 1) / commu::kMmaK<S> * commu::kMmaK<S>;
      for (int kk = 0; kk < depth; kk += commu::kMmaK<S>)
        commu::mma_step<S>(dp, do_s + kk * kAS8 + 16 * wr, 1, kAS8,
                           vt_s + kk * kAS8 + 32 * wj, kAS8, 1, lane);
    }
    __syncthreads();  // Dr is written and O's readers are done: P takes its place
    // P and ds where the C fragment lies: rows g, g + 8, keys 2 qd, 2 qd + 1
    // (read and written as pairs where K is even, so a pair is aligned)
    const bool pairs = (K & 1) == 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * wr + g + 8 * half;
      const int row = i0 + r;
      float amax = 0.f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int kc = 32 * wj + 8 * ni + 2 * qd;
        const int j = k0 + kc;
        const size_t at = (static_cast<size_t>(bh) * T + row) * K + j;
        const bool both = row < T && j + 1 < K;
        float s2[2] = {0.f, 0.f};
        if (pairs && both) {
          const float2 v = *reinterpret_cast<const float2*>(&s_res[at]);
          s2[0] = v.x, s2[1] = v.y;
        } else {
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (row < T && j + c < K) s2[c] = s_res[at + c];
        }
        float p2[2], dsc2[2], out2[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float p = 0.f, dsc = 0.f, ds_f = 0.f;
          if (row < T && j + c < K) {
            const float dpv = dp[0][ni][2 * half + c];
            p = commu::rnd<S>(expf(s2[c] - lse_s[r]));
            if (drop) {
              const float probs =
                  commu::keep(plane, drop_seed, row, j + c) ? p * plane.scale : 0.f;
              ds_f = probs * dpv - p * dr_s[r];
              p = commu::rnd<S>(probs);  // dv takes the dropped probabilities
            } else {
              ds_f = p * (dpv - dr_s[r]);
            }
            dsc = commu::rnd<S>(ds_f);
            amax = fmaxf(amax, fabsf(ds_f));
          }
          p2[c] = p, dsc2[c] = dsc;
          out2[c] = raw_ds ? ds_f : dsc;  // the int8 form quantises ds before its rounding
        }
        if (pairs && both) {
          *reinterpret_cast<float2*>(&ds_buf[at]) = make_float2(out2[0], out2[1]);
        } else {
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (row < T && j + c < K) ds_buf[at + c] = out2[c];
        }
        *reinterpret_cast<float2*>(&p_s[r * kAS8 + kc]) = make_float2(p2[0], p2[1]);
        *reinterpret_cast<float2*>(&ds_s[r * kAS8 + kc]) = make_float2(dsc2[0], dsc2[1]);
      }
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
      if (qd == 0) rmax_s[wj * kAQ + r] = amax;
    }
    __syncthreads();
    if (raw_ds && tid < kAQ && i0 + tid < T)
      amax_buf[(static_cast<size_t>(bh) * T + i0 + tid) * KT + blockIdx.x] =
          fmaxf(rmax_s[tid], rmax_s[kAQ + tid]);
    // dk[d, j] += sum_i qw[d, i] ds_c[i, j];  dv[d, j] += sum_i dO[d, i] P[i, j]
    if (16 * kMI * wr < dh) {
#pragma unroll 4
      for (int kk = 0; kk < kAQ; kk += commu::kMmaK<S>) {
        commu::mma_step<S>(acc_k, qw_s + 16 * kMI * wr * kAS4 + kk, kAS4, 1,
                           ds_s + kk * kAS8 + 32 * wj, kAS8, 1, lane);
        commu::mma_step<S>(acc_v, do_s + 16 * kMI * wr * kAS8 + kk, kAS8, 1,
                           p_s + kk * kAS8 + 32 * wj, kAS8, 1, lane);
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int d = 16 * (kMI * wr + mi) + g + 8 * half;
    if (d >= dh) continue;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = k0 + 32 * wj + 8 * ni + 2 * qd + c;
        if (j >= K) continue;
        const float kv = acc_k[mi][ni][2 * half + c], vv = acc_v[mi][ni][2 * half + c];
        if (j < M) {
          const size_t at = (static_cast<size_t>(bh) * dh + d) * M + j;
          dk_mem[at] = kv;
          dv_mem[at] = vv;
        } else {
          const size_t at = q_off + static_cast<size_t>(d) * T + (j - M);
          dk_win[at] = commu::from_f<S>(kv);
          dv_win[at] = commu::from_f<S>(vv);
        }
      }
  }
}

// ---- pass B: dphi, du, dq over one query tile; kNH = 2F / 128
// Shared memory, f32 unless said: ds_c [query][key]; a [key][d] tile of k
// (after the key loop: a [d][f] chunk of W_r); the psi^T chunk [key][2F] (in
// the int8 form: psi_q words [4 keys][2F] and ds_q words [query][4 keys];
// after the key loop: du [query][2F]); k ds_c^T [query][d].
// Warps (16): dphi over (2 x 32 rows) x (8 kNH columns of the cos half and
// the same columns of the sin half, so a thread holds both terms of its du);
// k ds_c^T and W_r du^T over (4 x 16 rows) x (4 x 16 dims).  64 rows a block
// halve the psi (psi_q) and k tiles staged per row against 32, at the same
// 16 warps an SM.
__host__ __device__ inline size_t pass_b_big(int F2) {
  const size_t psi = static_cast<size_t>(kBJ) * (F2 + 8);
  const size_t du = static_cast<size_t>(kBQ) * (F2 + 4);
  return psi > du ? psi : du;
}

inline size_t pass_b_smem(int F2) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * kBS + kBJ * kKS + pass_b_big(F2) +
                          kBQ * kQS + 2 * kBQ);
}

template <typename S, int kNH, bool kInt8>
__global__ void __launch_bounds__(kBThreads, 1)
bwd_queries_kernel(const S* __restrict__ k_mem, const S* __restrict__ k_win,
                   const S* __restrict__ w_r, const S* __restrict__ trig_a,
                   const S* __restrict__ psi_t, const int* __restrict__ psi_qw,
                   const float* __restrict__ ds_buf, const float* __restrict__ amax_buf,
                   S* __restrict__ dq, float* __restrict__ du_buf, float* __restrict__ dqac_sum,
                   float* __restrict__ du_sum, int H, int dh, int T, int R, int Tb,
                   float scale) {
  constexpr int F2 = 128 * kNH;  // 2F, a constant so the staging loops unroll
  extern __shared__ __align__(16) float smem[];
  const int M = R * Tb;
  const int K = M + T;
  const int fpad = F2 / 2;
  const int ps = F2 + 8;   // row stride of the psi^T chunk and of psi_q's words
  const int dus = F2 + 4;  // row stride of du
  float* ds_s = smem;                       // [kBQ][kBS]
  float* k_s = ds_s + kBQ * kBS;            // [kBJ][kKS]; then W_r [kMaxDh][kWS]
  float* big = k_s + kBJ * kKS;             // psi^T [kBJ][ps]; then du [kBQ][dus]
  float* qa_s = big + pass_b_big(F2);       // [kBQ][kQS]
  float* sc_s = qa_s + kBQ * kQS;           // [kBQ]: the int8 form's row scales
  float* inv_sc_s = sc_s + kBQ;             // [kBQ]
  float* psi_s = big;
  int* psiq_s = reinterpret_cast<int*>(big);  // [kBJ / 4][ps]
  int* dsq_s = psiq_s + (kBJ / 4) * ps;       // [kBQ][kQW]
  float* du_s = big;
  float* wr_s = k_s;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qt = blockIdx.x;
  const int i0 = qt * kBQ;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, qd = lane % 4;
  const int wrow = warp / 8;             // dphi: rows 32 wrow ...
  const int cw = (warp % 8) * 8 * kNH;   // ... and this first column of each half
  const int wm = warp % 4;               // k ds_c^T, W_r du^T: rows 16 wm ...
  const int wd = warp / 4;               // ... dims 16 wd

  // dphi: [half][m tile][n tile]; the int8 form sums in int32 first
  float acc[2][2][kNH][4];
  int acc_i[2][2][kNH][4];
  float acc_q[1][2][4], acc_pos[1][2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNH; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][mi][ni][e] = 0.f, acc_i[s][mi][ni][e] = 0;
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_q[0][ni][e] = acc_pos[0][ni][e] = 0.f;
  const int Kw = (K + 3) / 4;
  if constexpr (kInt8) {
    // each row's absolute maximum over all K keys: the largest of pass A's
    // per-tile maxima
    if (tid < kBQ) {
      const int i = i0 + tid;
      const int KT = amax_tiles(K);
      float amax = 0.f;
      if (i < T) {
        const float* row = amax_buf + (static_cast<size_t>(bh) * T + i) * KT;
        for (int t = 0; t < KT; ++t) amax = fmaxf(amax, row[t]);
      }
      const float sc = fmaxf(amax, 1e-30f) * static_cast<float>(1.0 / 127.0);
      sc_s[tid] = sc;
      inv_sc_s[tid] = 1.f / sc;
    }
  }

  for (int j0 = 0; j0 < K; j0 += kBJ) {
    __syncthreads();  // the previous chunk's readers are done (and the scales written)
    if constexpr (kInt8) {
      // one thread a (row, four keys): the rounded ds for k ds_c^T, and the
      // quantised word for dphi, each from one read of ds
      {
        const int r = tid / (kBJ / 4);
        const int gw = tid - r * (kBJ / 4);
        const int i = i0 + r;
        const float inv = inv_sc_s[r];
        const int jq = j0 + gw * 4;
        const float* src = ds_buf + (static_cast<size_t>(bh) * T + i) * K + jq;
        float v4[4] = {0.f, 0.f, 0.f, 0.f};
        if ((K & 3) == 0 && i < T && jq + 3 < K) {  // an aligned quad
          const float4 v = *reinterpret_cast<const float4*>(src);
          v4[0] = v.x, v4[1] = v.y, v4[2] = v.z, v4[3] = v.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (i < T && jq + e < K) v4[e] = src[e];
        }
        uint32_t word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = v4[e];
          ds_s[r * kBS + gw * 4 + e] = commu::rnd<S>(v);
          word |= (static_cast<uint32_t>(__float2int_rn(v * inv)) & 0xFFu) << (8 * e);
        }
        dsq_s[r * kQW + gw] = static_cast<int>(word);
      }
#pragma unroll 8
      for (int e = 0; e < (kBJ / 4) * F2 / kBThreads; ++e) {
        const int idx = tid + e * kBThreads;
        const int gw = idx / F2;
        const int f = idx - gw * F2;
        const int jw = j0 / 4 + gw;
        psiq_s[gw * ps + f] = jw < Kw ? psi_qw[static_cast<size_t>(jw) * F2 + f] : 0;
      }
    } else {
      for (int idx = tid; idx < kBQ * kBJ; idx += kBThreads) {
        const int r = idx / kBJ;
        const int jj = idx - r * kBJ;
        const int i = i0 + r;
        const int j = j0 + jj;
        ds_s[r * kBS + jj] =
            (i < T && j < K) ? ds_buf[(static_cast<size_t>(bh) * T + i) * K + j] : 0.f;
      }
#pragma unroll 8
      for (int e = 0; e < kBJ * F2 / kBThreads; ++e) {
        const int idx = tid + e * kBThreads;
        const int jj = idx / F2;
        const int f = idx - jj * F2;
        const int j = j0 + jj;
        psi_s[jj * ps + f] = j < K ? commu::to_f(psi_t[static_cast<size_t>(j) * F2 + f]) : 0.f;
      }
    }
    {  // k of the chunk: one key a thread slot, its column found once
      const int jj = tid % kBJ;
      const int j = j0 + jj;
      int stride = 0;
      const S* col =
          commu::key_column(k_mem, k_win, b, h, j < K ? j : 0, H, dh, R, Tb, T, M, &stride);
      for (int d = tid / kBJ; d < kMaxDh; d += kBThreads / kBJ)
        k_s[jj * kKS + d] =
            j < K && d < dh ? commu::to_f(col[static_cast<size_t>(d) * stride]) : 0.f;
    }
    __syncthreads();
    if constexpr (kInt8) {
#pragma unroll
      for (int s = 0; s < 2; ++s)
        commu::mma_step_s8(acc_i[s], dsq_s + 32 * wrow * kQW, kQW, psiq_s + s * fpad + cw, ps,
                           lane);
    } else {
#pragma unroll
      for (int kk = 0; kk < kBJ; kk += commu::kMmaK<S>)
#pragma unroll
        for (int s = 0; s < 2; ++s)
          commu::mma_step<S>(acc[s], ds_s + 32 * wrow * kBS + kk, kBS, 1,
                             psi_s + kk * ps + s * fpad + cw, ps, 1, lane);
    }
#pragma unroll
    for (int kk = 0; kk < kBJ; kk += commu::kMmaK<S>)
      commu::mma_step<S>(acc_q, ds_s + 16 * wm * kBS + kk, kBS, 1, k_s + kk * kKS + 16 * wd,
                         kKS, 1, lane);
  }
  __syncthreads();  // psi's readers are done: du takes its place

  // du = rnd(trig_combine_bwd(dphi)), where the C fragment lies: rows
  // 32 wrow + 16 mi + g (+ 8), columns f of the cos half, f + fpad of the sin
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 32 * wrow + 16 * mi + g + 8 * half;
      const int i = i0 + row;
      float back = 0.f;
      if constexpr (kInt8) back = sc_s[row] * static_cast<float>(1.0 / 127.0);
#pragma unroll
      for (int ni = 0; ni < kNH; ++ni)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * half + c;
          const int f = cw + 8 * ni + 2 * qd + c;
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
            du_buf[(static_cast<size_t>(bh) * F2 + f) * T + i] = du_a;
            du_buf[(static_cast<size_t>(bh) * F2 + fpad + f) * T + i] = du_b;
          }
          du_s[row * dus + f] = du_a;
          du_s[row * dus + fpad + f] = du_b;
        }
    }
  // k ds_c^T where its C fragment lies: rows 16 wm + g (+ 8), dims 16 wd + ...
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = 16 * wm + g + 8 * half;
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        qa_s[row * kQS + 16 * wd + 8 * ni + 2 * qd + c] =
            i0 + row < T ? acc_q[0][ni][2 * half + c] : 0.f;
  }

  // W_r du^T: W_r's [dh, 2F] slab of the head, kWF columns at a time
  const S* wr_h = w_r + static_cast<size_t>(h) * dh * F2;
  for (int f0 = 0; f0 < F2; f0 += kWF) {
    __syncthreads();  // du written (first chunk); the previous chunk's readers done
#pragma unroll
    for (int e = 0; e < kMaxDh * kWF / kBThreads; ++e) {
      const int idx = tid + e * kBThreads;
      const int d = idx / kWF;
      const int ff = idx - d * kWF;
      wr_s[d * kWS + ff] = d < dh ? commu::to_f(wr_h[static_cast<size_t>(d) * F2 + f0 + ff]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWF; kk += commu::kMmaK<S>)
      commu::mma_step<S>(acc_pos, du_s + 16 * wm * dus + f0 + kk, dus, 1,
                         wr_s + 16 * wd * kWS + kk, 1, kWS, lane);
  }

  // dq = scale (k ds_c^T + W_r du^T)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + 16 * wm + g + 8 * half;
    if (i >= T) continue;
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = 16 * wd + 8 * ni + 2 * qd + c;
        if (d < dh)
          dq[(static_cast<size_t>(bh) * dh + d) * T + i] = commu::from_f<S>(
              scale * (acc_q[0][ni][2 * half + c] + acc_pos[0][ni][2 * half + c]));
      }
  }
  // per-block sums over the tile's rows, in row order, for the bias gradients
  const int tiles = gridDim.x;
  const size_t blk = static_cast<size_t>(bh) * tiles + qt;
  for (int d = tid; d < dh; d += kBThreads) {
    float s = 0.f;
    for (int r = 0; r < kBQ; ++r) s += qa_s[r * kQS + d];
    dqac_sum[blk * dh + d] = s;
  }
  for (int f = tid; f < F2; f += kBThreads) {
    float s = 0.f;
    for (int r = 0; r < kBQ; ++r) s += du_s[r * dus + f];
    du_sum[blk * F2 + f] = s;
  }
}

// ---- pass B at the wide widths: dh up to 128, any 2F a multiple of 256
// (every 2F that _fpad gives past 512: 768 at units 768, 1024 at 1024).
// The dphi accumulators of a row tile over all of 2F do not fit a thread's
// registers past 2F = 512 (nor its psi^T chunk 227 KB of shared memory past
// 1024), so the block takes 2F in chunks of kWideF2 columns, 128 of the cos
// half and the same 128 of the sin half, so a thread still holds both terms
// of its du.  Per chunk it streams every key again (ds and the chunk's psi^T
// columns; the int8 form quantises ds again with the row scales it took
// once, over the whole row, before the first chunk), forms dphi and du of
// the chunk's columns, writes them and their per-block row sums, and adds W_r
// du^T over those columns into registers that persist across the chunks:
// dq's position term is summed over 2F in a fixed order (chunk by chunk, the
// cos columns before the sin columns of each), so two runs give the same
// bits.  k ds_c^T is formed in the first chunk's key loop only.  Warps and
// fragments as bwd_queries_kernel's; k ds_c^T and W_r du^T over (4 x 16
// rows) x (4 x 8 kDh / 32 dims).
constexpr int kWideNH = 2;                 // n tiles of 8 columns a warp, each half
constexpr int kWideF2 = 128 * kWideNH;     // 2F columns a chunk
template <int kDh>
__host__ __device__ inline size_t pass_b_wide_floats() {
  const size_t ks = static_cast<size_t>(kBJ) * (kDh + 8);
  const size_t ws = static_cast<size_t>(kDh) * kWS;
  return static_cast<size_t>(kBQ) * kBS + (ks > ws ? ks : ws) + pass_b_big(kWideF2) +
         static_cast<size_t>(kBQ) * (kDh + 1) + 2 * kBQ;
}

template <typename S, bool kInt8, int kDh>
__global__ void __launch_bounds__(kBThreads, 1)
bwd_queries_wide_kernel(const S* __restrict__ k_mem, const S* __restrict__ k_win,
                        const S* __restrict__ w_r, const S* __restrict__ trig_a,
                        const S* __restrict__ psi_t, const int* __restrict__ psi_qw,
                        const float* __restrict__ ds_buf, const float* __restrict__ amax_buf,
                        S* __restrict__ dq, float* __restrict__ du_buf,
                        float* __restrict__ dqac_sum, float* __restrict__ du_sum, int H, int dh,
                        int T, int R, int Tb, int F2, float scale) {
  constexpr int FC = kWideF2;
  constexpr int kNQ = kDh / 32;  // n tiles of 8 dims a warp in k ds_c^T and W_r du^T
  constexpr int kKSw = kDh + 8;  // row stride of the k tile [key][d]
  constexpr int kQSw = kDh + 1;  // row stride of k ds_c^T [query][d]
  extern __shared__ __align__(16) float smem[];
  const int M = R * Tb;
  const int K = M + T;
  const int fpad = F2 / 2;
  constexpr int ps = FC + 8;   // row stride of the psi^T chunk and of psi_q's words
  constexpr int dus = FC + 4;  // row stride of du
  const size_t k_floats = static_cast<size_t>(kBJ) * kKSw > static_cast<size_t>(kDh) * kWS
                              ? static_cast<size_t>(kBJ) * kKSw
                              : static_cast<size_t>(kDh) * kWS;
  float* ds_s = smem;                       // [kBQ][kBS]
  float* k_s = ds_s + kBQ * kBS;            // [kBJ][kKSw]; then W_r [kDh][kWS]
  float* big = k_s + k_floats;              // psi^T [kBJ][ps]; then du [kBQ][dus]
  float* qa_s = big + pass_b_big(FC);       // [kBQ][kQSw]
  float* sc_s = qa_s + kBQ * kQSw;          // [kBQ]: the int8 form's row scales
  float* inv_sc_s = sc_s + kBQ;             // [kBQ]
  float* psi_s = big;
  int* psiq_s = reinterpret_cast<int*>(big);  // [kBJ / 4][ps]
  int* dsq_s = psiq_s + (kBJ / 4) * ps;       // [kBQ][kQW]
  float* du_s = big;
  float* wr_s = k_s;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qt = blockIdx.x;
  const int i0 = qt * kBQ;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, qd = lane % 4;
  const int wrow = warp / 8;                // dphi: rows 32 wrow ...
  const int cw = (warp % 8) * 8 * kWideNH;  // ... and this first column of each half
  const int wm = warp % 4;                  // k ds_c^T, W_r du^T: rows 16 wm ...
  const int wd = warp / 4;                  // ... dims 8 kNQ wd
  // a chunk's column c (< FC) is 2F column fc + c of the cos half, or of the
  // sin half past FC / 2
  auto col = [&](int fc, int c) { return c < FC / 2 ? fc + c : fpad + fc + (c - FC / 2); };

  float acc_q[1][kNQ][4], acc_pos[1][kNQ][4];
#pragma unroll
  for (int ni = 0; ni < kNQ; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_q[0][ni][e] = acc_pos[0][ni][e] = 0.f;
  const int Kw = (K + 3) / 4;
  if constexpr (kInt8) {
    // each row's absolute maximum over all K keys: the largest of pass A's
    // per-tile maxima
    if (tid < kBQ) {
      const int i = i0 + tid;
      const int KT = amax_tiles(K);
      float amax = 0.f;
      if (i < T) {
        const float* row = amax_buf + (static_cast<size_t>(bh) * T + i) * KT;
        for (int t = 0; t < KT; ++t) amax = fmaxf(amax, row[t]);
      }
      const float sc = fmaxf(amax, 1e-30f) * static_cast<float>(1.0 / 127.0);
      sc_s[tid] = sc;
      inv_sc_s[tid] = 1.f / sc;
    }
  }

  for (int fc = 0; fc < fpad; fc += FC / 2) {
    const bool first = fc == 0;
    float acc[2][2][kWideNH][4];
    int acc_i[2][2][kWideNH][4];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < kWideNH; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[s][mi][ni][e] = 0.f, acc_i[s][mi][ni][e] = 0;

    for (int j0 = 0; j0 < K; j0 += kBJ) {
      __syncthreads();  // the previous chunk's readers are done (and the scales written)
      if constexpr (kInt8) {
        {  // one thread a (row, four keys): rounded ds and its quantised word
          const int r = tid / (kBJ / 4);
          const int gw = tid - r * (kBJ / 4);
          const int i = i0 + r;
          const float inv = inv_sc_s[r];
          const int jq = j0 + gw * 4;
          const float* src = ds_buf + (static_cast<size_t>(bh) * T + i) * K + jq;
          float v4[4] = {0.f, 0.f, 0.f, 0.f};
          if ((K & 3) == 0 && i < T && jq + 3 < K) {  // an aligned quad
            const float4 v = *reinterpret_cast<const float4*>(src);
            v4[0] = v.x, v4[1] = v.y, v4[2] = v.z, v4[3] = v.w;
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (i < T && jq + e < K) v4[e] = src[e];
          }
          uint32_t word = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = v4[e];
            ds_s[r * kBS + gw * 4 + e] = commu::rnd<S>(v);
            word |= (static_cast<uint32_t>(__float2int_rn(v * inv)) & 0xFFu) << (8 * e);
          }
          dsq_s[r * kQW + gw] = static_cast<int>(word);
        }
#pragma unroll 4
        for (int e = 0; e < (kBJ / 4) * FC / kBThreads; ++e) {
          const int idx = tid + e * kBThreads;
          const int gw = idx / FC;
          const int c = idx - gw * FC;
          const int jw = j0 / 4 + gw;
          psiq_s[gw * ps + c] = jw < Kw ? psi_qw[static_cast<size_t>(jw) * F2 + col(fc, c)] : 0;
        }
      } else {
        for (int idx = tid; idx < kBQ * kBJ; idx += kBThreads) {
          const int r = idx / kBJ;
          const int jj = idx - r * kBJ;
          const int i = i0 + r;
          const int j = j0 + jj;
          ds_s[r * kBS + jj] =
              (i < T && j < K) ? ds_buf[(static_cast<size_t>(bh) * T + i) * K + j] : 0.f;
        }
#pragma unroll 4
        for (int e = 0; e < kBJ * FC / kBThreads; ++e) {
          const int idx = tid + e * kBThreads;
          const int jj = idx / FC;
          const int c = idx - jj * FC;
          const int j = j0 + jj;
          psi_s[jj * ps + c] =
              j < K ? commu::to_f(psi_t[static_cast<size_t>(j) * F2 + col(fc, c)]) : 0.f;
        }
      }
      if (first) {  // k of the chunk: one key a thread slot, its column found once
        const int jj = tid % kBJ;
        const int j = j0 + jj;
        int stride = 0;
        const S* kcol =
            commu::key_column(k_mem, k_win, b, h, j < K ? j : 0, H, dh, R, Tb, T, M, &stride);
        for (int d = tid / kBJ; d < kDh; d += kBThreads / kBJ)
          k_s[jj * kKSw + d] =
              j < K && d < dh ? commu::to_f(kcol[static_cast<size_t>(d) * stride]) : 0.f;
      }
      __syncthreads();
      if constexpr (kInt8) {
#pragma unroll
        for (int s = 0; s < 2; ++s)
          commu::mma_step_s8(acc_i[s], dsq_s + 32 * wrow * kQW, kQW,
                             psiq_s + s * (FC / 2) + cw, ps, lane);
      } else {
#pragma unroll
        for (int kk = 0; kk < kBJ; kk += commu::kMmaK<S>)
#pragma unroll
          for (int s = 0; s < 2; ++s)
            commu::mma_step<S>(acc[s], ds_s + 32 * wrow * kBS + kk, kBS, 1,
                               psi_s + kk * ps + s * (FC / 2) + cw, ps, 1, lane);
      }
      if (first) {
#pragma unroll
        for (int kk = 0; kk < kBJ; kk += commu::kMmaK<S>)
          commu::mma_step<S>(acc_q, ds_s + 16 * wm * kBS + kk, kBS, 1,
                             k_s + kk * kKSw + 8 * kNQ * wd, kKSw, 1, lane);
      }
    }
    __syncthreads();  // psi's readers are done: du takes its place

    // du of the chunk's columns, where the C fragment lies
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 32 * wrow + 16 * mi + g + 8 * half;
        const int i = i0 + row;
        float back = 0.f;
        if constexpr (kInt8) back = sc_s[row] * static_cast<float>(1.0 / 127.0);
#pragma unroll
        for (int ni = 0; ni < kWideNH; ++ni)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 2 * half + c;
            const int cc = cw + 8 * ni + 2 * qd + c;  // < FC / 2
            const int f = fc + cc;
            float d_cos = acc[0][mi][ni][e], d_sin = acc[1][mi][ni][e];
            if constexpr (kInt8) {
              d_cos = static_cast<float>(acc_i[0][mi][ni][e]) * back;
              d_sin = static_cast<float>(acc_i[1][mi][ni][e]) * back;
            }
            float du_a = 0.f, du_b = 0.f;
            if (i < T) {
              const float s_a = commu::to_f(trig_a[static_cast<size_t>(i) * F2 + f]);
              const float c_a = commu::to_f(trig_a[static_cast<size_t>(i) * F2 + fpad + f]);
              du_a = commu::rnd<S>(d_cos * s_a - d_sin * c_a);
              du_b = commu::rnd<S>(d_cos * c_a + d_sin * s_a);
              du_buf[(static_cast<size_t>(bh) * F2 + f) * T + i] = du_a;
              du_buf[(static_cast<size_t>(bh) * F2 + fpad + f) * T + i] = du_b;
            }
            du_s[row * dus + cc] = du_a;
            du_s[row * dus + FC / 2 + cc] = du_b;
          }
      }
    if (first) {  // k ds_c^T where its C fragment lies
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 16 * wm + g + 8 * half;
#pragma unroll
        for (int ni = 0; ni < kNQ; ++ni)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            qa_s[row * kQSw + 8 * kNQ * wd + 8 * ni + 2 * qd + c] =
                i0 + row < T ? acc_q[0][ni][2 * half + c] : 0.f;
      }
    }

    // W_r du^T over the chunk's columns, kWF at a time
    const S* wr_h = w_r + static_cast<size_t>(h) * dh * F2;
    for (int c0 = 0; c0 < FC; c0 += kWF) {
      __syncthreads();  // du written (first chunk); the previous chunk's readers done
#pragma unroll 4
      for (int e = 0; e < kDh * kWF / kBThreads; ++e) {
        const int idx = tid + e * kBThreads;
        const int d = idx / kWF;
        const int ff = idx - d * kWF;
        wr_s[d * kWS + ff] =
            d < dh ? commu::to_f(wr_h[static_cast<size_t>(d) * F2 + col(fc, c0 + ff)]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kWF; kk += commu::kMmaK<S>)
        commu::mma_step<S>(acc_pos, du_s + 16 * wm * dus + c0 + kk, dus, 1,
                           wr_s + 8 * kNQ * wd * kWS + kk, 1, kWS, lane);
    }
    // per-block sums of the chunk's du columns over the tile's rows, in row order
    const size_t blk = static_cast<size_t>(bh) * gridDim.x + qt;
    for (int c = tid; c < FC; c += kBThreads) {
      float s = 0.f;
      for (int r = 0; r < kBQ; ++r) s += du_s[r * dus + c];
      du_sum[blk * F2 + col(fc, c)] = s;
    }
  }

  // dq = scale (k ds_c^T + W_r du^T)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + 16 * wm + g + 8 * half;
    if (i >= T) continue;
#pragma unroll
    for (int ni = 0; ni < kNQ; ++ni)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = 8 * kNQ * wd + 8 * ni + 2 * qd + c;
        if (d < dh)
          dq[(static_cast<size_t>(bh) * dh + d) * T + i] = commu::from_f<S>(
              scale * (acc_q[0][ni][2 * half + c] + acc_pos[0][ni][2 * half + c]));
      }
  }
  // per-block sums of k ds_c^T over the tile's rows, in row order
  const size_t blk = static_cast<size_t>(bh) * gridDim.x + qt;
  for (int d = tid; d < dh; d += kBThreads) {
    float s = 0.f;
    for (int r = 0; r < kBQ; ++r) s += qa_s[r * kQSw + d];
    dqac_sum[blk * dh + d] = s;
  }
}

// ---- the two bias gradients: one block per head, batch and tiles in order
template <typename S>
__global__ void __launch_bounds__(kThreads)
bias_grad_kernel(const float* __restrict__ dqac_sum, const float* __restrict__ du_sum,
                 const S* __restrict__ w_r, float* __restrict__ drwb, float* __restrict__ drrb,
                 int B, int H, int tiles, int dh, int F2, float scale) {
  extern __shared__ float sdu[];  // [F2]
  const int h = blockIdx.x;
  const int n_all = B * tiles;  // (batch row, tile) pairs, batch-major
  for (int f = threadIdx.x; f < F2; f += kThreads) {
    float s = 0.f;
#pragma unroll 8
    for (int n = 0; n < n_all; ++n) {
      const int b = n / tiles, t = n - b * tiles;
      s += du_sum[((static_cast<size_t>(b) * H + h) * tiles + t) * F2 + f];
    }
    sdu[f] = s;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < dh; d += kThreads) {
    float s = 0.f;
#pragma unroll 8
    for (int n = 0; n < n_all; ++n) {
      const int b = n / tiles, t = n - b * tiles;
      s += dqac_sum[((static_cast<size_t>(b) * H + h) * tiles + t) * dh + d];
    }
    drwb[h * dh + d] = scale * s;
    const S* wr_d = w_r + (static_cast<size_t>(h) * dh + d) * F2;
    float r = 0.f;
#pragma unroll 8
    for (int f = 0; f < F2; ++f) r = fmaf(commu::to_f(wr_d[f]), sdu[f], r);
    drrb[h * dh + d] = scale * r;
  }
}

template <typename S>
struct QrOp {  // qr = rnd(rnd(q * scale) + rrbs), head p
  const S* q;
  const S* rrbs;
  int H, dh, T;
  float scale;
  __device__ float operator()(int p, int b, int d, int i) const {
    const float qv = commu::to_f(q[((static_cast<size_t>(b) * H + p) * dh + d) * T + i]);
    const float qs = commu::rnd<S>(qv * commu::rnd<S>(scale));
    return commu::rnd<S>(qs + commu::to_f(rrbs[p * dh + d]));
  }
};

struct DuOp {  // du [B, H, 2F, T], head p
  const float* du;
  int H, F2, T;
  __device__ float operator()(int p, int b, int f, int i) const {
    return du[((static_cast<size_t>(b) * H + p) * F2 + f) * T + i];
  }
};

// Launch pass A over every (b, h, 64 keys); ``raw_ds``: the int8 dphi form
// (ds left unrounded, and the per-tile row maxima written).
template <typename S, int kDh = kMaxDh>
cudaError_t launch_pass_a(const S* q, const S* rwbs, const S* k_mem, const S* k_win,
                          const S* v_mem, const S* v_win, const float* s_res, const float* lse,
                          const S* out, const S* dout, float* ds, float* amax, float* dk_mem,
                          float* dv_mem, S* dk_win, S* dv_win, int B, int H, int dh, int T, int R,
                          int Tb, float scale, int seed, const commu::Plane& plane, bool raw_ds,
                          cudaStream_t stream) {
  const size_t smem = pass_a_smem<kDh>();
  cudaError_t err = commu::allow_smem(bwd_keys_kernel<S, kDh>, smem);
  if (err != cudaSuccess) return err;
  bwd_keys_kernel<S, kDh><<<dim3(amax_tiles(R * Tb + T), B * H), kThreads, smem, stream>>>(
      q, rwbs, k_mem, k_win, v_mem, v_win, s_res, lse, out, dout, ds, amax, dk_mem, dv_mem,
      dk_win, dv_win, H, dh, T, R, Tb, scale, seed, plane, raw_ds);
  return cudaGetLastError();
}

// pass A at the form the widths take: ModelConfig()'s, or sized for dh <= 128
template <typename S>
cudaError_t launch_pass_a_at(const S* q, const S* rwbs, const S* k_mem, const S* k_win,
                             const S* v_mem, const S* v_win, const float* s_res, const float* lse,
                             const S* out, const S* dout, float* ds, float* amax, float* dk_mem,
                             float* dv_mem, S* dk_win, S* dv_win, int B, int H, int dh, int T,
                             int R, int Tb, float scale, int seed, const commu::Plane& plane,
                             bool raw_ds, cudaStream_t stream) {
  if (dh <= kMaxDh)
    return launch_pass_a<S>(q, rwbs, k_mem, k_win, v_mem, v_win, s_res, lse, out, dout, ds, amax,
                            dk_mem, dv_mem, dk_win, dv_win, B, H, dh, T, R, Tb, scale, seed,
                            plane, raw_ds, stream);
  return launch_pass_a<S, kWideMaxDh>(q, rwbs, k_mem, k_win, v_mem, v_win, s_res, lse, out, dout,
                                      ds, amax, dk_mem, dv_mem, dk_win, dv_win, B, H, dh, T, R,
                                      Tb, scale, seed, plane, raw_ds, stream);
}

// Launch pass B over every (b, h, 64 queries): the exact form, or with
// ``psi_qw`` (psi_q as [ceil(K / 4)][2F] words) the int8 dphi form.
template <typename S>
cudaError_t launch_pass_b(const S* k_mem, const S* k_win, const S* w_r, const S* trig_a,
                          const S* psi_t, const int* psi_qw, const float* ds, const float* amax,
                          S* dq, float* du, float* dqac_sum, float* du_sum, int B, int H, int dh,
                          int T, int R, int Tb, int F2, float scale, cudaStream_t stream) {
  const int tiles = (T + kBQ - 1) / kBQ;
  if (!narrow_widths(dh, F2)) {  // the wide form, in chunks of 2F
    constexpr int kDh = kWideMaxDh;
    const size_t smem = sizeof(float) * pass_b_wide_floats<kDh>();
    auto kernel = psi_qw != nullptr ? bwd_queries_wide_kernel<S, true, kDh>
                                    : bwd_queries_wide_kernel<S, false, kDh>;
    cudaError_t err = commu::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(tiles, B * H), kBThreads, smem, stream>>>(
        k_mem, k_win, w_r, trig_a, psi_t, psi_qw, ds, amax, dq, du, dqac_sum, du_sum, H, dh, T,
        R, Tb, F2, scale);
    return cudaGetLastError();
  }
  const size_t smem = pass_b_smem(F2);
  auto kernel_b = psi_qw != nullptr
      ? (F2 == 512 ? bwd_queries_kernel<S, 4, true> : bwd_queries_kernel<S, 2, true>)
      : (F2 == 512 ? bwd_queries_kernel<S, 4, false> : bwd_queries_kernel<S, 2, false>);
  cudaError_t err = commu::allow_smem(kernel_b, smem);
  if (err != cudaSuccess) return err;
  kernel_b<<<dim3(tiles, B * H), kBThreads, smem, stream>>>(
      k_mem, k_win, w_r, trig_a, psi_t, psi_qw, ds, amax, dq, du, dqac_sum, du_sum, H, dh, T, R,
      Tb, scale);
  return cudaGetLastError();
}

}  // namespace
