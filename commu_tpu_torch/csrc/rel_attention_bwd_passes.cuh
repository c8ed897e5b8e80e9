// The passes that the two attention backward kernels share.
//
// rel_attention_mem_bwd.cu (keys over [ring slabs | window]) and
// rel_attention_bwd.cu (the window alone: R = 0, so M = 0 and every key is a
// window key) run the same three kernels, as the reference's _bwd_kernel_mem
// and _bwd_kernel share _bwd_stage_a and _bwd_stage_b
// (commu_tpu/ops/fused_attention.py:888, :931):
//   (A) bwd_keys_kernel: one block per (b, h, 64 keys), looping over the
//       queries 16 at a time: P, ds (written to a [B, H, T, K] workspace),
//       and the block-local sums dk, dv of its keys;
//   (B) bwd_queries_kernel: one block per (b, h, 32 queries), looping over
//       the keys 16 at a time: dphi, du, dq, and the per-block sums of
//       k ds_c^T and du for the bias gradients;
//   bias_grad_kernel: one block per head, batch rows and tiles in order.
// QrOp and DuOp are the operands of dW_r = sum_b qr du (reduce.cuh).
//
// The int8 dphi form (the reference's _bwd_stage_b :975-984 under
// COMMU_BD_INT8_BWD=1; bwd_queries_kernel<S, kC, true>): pass A then leaves
// ds in the workspace before its rounding, and pass B first sweeps its 32
// rows over all K keys for each row's absolute maximum, the whole row, as the
// reference takes it, never a tile's, then quantises the copy of ds that
// enters ds psi^T, sc = max(amax, 1e-30) * (1 / 127), ds_q = rint(ds * (1 /
// sc)), and sums ds_q psi_q^T in int32 with __dp4a, four keys a word: psi_q
// arrives as [ceil(K / 4)][2F] words.  dphi = float(sum) * (sc * (1 / 127)).
// k ds_c^T, and all of pass A, take the rounded float ds as in the exact form.
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
constexpr int kAK = 64;   // keys per block in pass A
constexpr int kAQ = 16;   // queries per chunk in pass A
constexpr int kBQ = 32;   // queries per block in pass B
constexpr int kBJ = 16;   // keys per chunk in pass B
constexpr int kMaxC = 4;  // 2F <= 512: at most 4 column groups of 128 in pass B

// Key j's column of head (b, h) in the ring slabs or the window (as in
// rel_attention_mem_fwd.cu): the address of head dim 0 and the stride.
template <typename S>
__device__ __forceinline__ const S* key_column(const S* __restrict__ mem,
                                               const S* __restrict__ win, int b, int h, int j,
                                               int H, int dh, int R, int Tb, int T, int M,
                                               int* stride) {
  if (j < M) {
    const int r = j / Tb;
    *stride = Tb;
    return mem + (((static_cast<size_t>(b) * R + r) * H + h) * dh) * Tb + (j - r * Tb);
  }
  *stride = T;
  return win + ((static_cast<size_t>(b) * H + h) * dh) * T + (j - M);
}

// ---- pass A: P, ds, dk, dv over one key tile
template <typename S>
__global__ void __launch_bounds__(kThreads)
bwd_keys_kernel(const S* __restrict__ q, const S* __restrict__ rwbs, const S* __restrict__ k_mem,
                const S* __restrict__ k_win, const S* __restrict__ v_mem,
                const S* __restrict__ v_win, const float* __restrict__ s_res,
                const float* __restrict__ lse, const S* __restrict__ out,
                const S* __restrict__ dout, float* __restrict__ ds_buf,
                float* __restrict__ dk_mem, float* __restrict__ dv_mem, S* __restrict__ dk_win,
                S* __restrict__ dv_win, int H, int dh, int T, int R, int Tb, float scale, int seed,
                commu::Plane plane, bool raw_ds) {
  __shared__ __align__(16) float vt_s[kMaxDh][kAK];   // v of the tile, [d][key]
  __shared__ __align__(16) float do_s[kMaxDh][kAQ];   // dO of the chunk, [d][query]
  __shared__ __align__(16) float qw_s[kMaxDh][kAQ];   // qw of the chunk
  __shared__ float p_s[kAQ][kAK + 1];
  __shared__ float ds_s[kAQ][kAK + 1];
  __shared__ float dr_s[kAQ], lse_s[kAQ];
  const int M = R * Tb;
  const int K = M + T;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * kAK;
  const int tid = threadIdx.x;
  const size_t q_off = static_cast<size_t>(bh) * dh * T;
  const float scale_s = commu::rnd<S>(scale);
  const bool drop = plane.thresh > 0;
  const uint32_t drop_seed = commu::plane_seed(seed, b, 4096, h);

  {  // the tile's v, one key column per thread slot
    const int jj = tid % kAK;
    const int j = k0 + jj;
    int stride = 0;
    const S* col = key_column(v_mem, v_win, b, h, j < K ? j : 0, H, dh, R, Tb, T, M, &stride);
    for (int d = tid / kAK; d < dh; d += kThreads / kAK)
      vt_s[d][jj] = j < K ? commu::to_f(col[static_cast<size_t>(d) * stride]) : 0.f;
  }
  const int ty = tid / 16;  // row ty of the chunk
  const int tx = tid % 16;  // keys 4 tx + {0..3} of the tile
  const int jj = tid % kAK;  // accumulation: key jj, dims tid / 64 + 4 g
  float acc_k[kMaxDh / 4], acc_v[kMaxDh / 4];
#pragma unroll
  for (int g = 0; g < kMaxDh / 4; ++g) acc_k[g] = acc_v[g] = 0.f;

  for (int i0 = 0; i0 < T; i0 += kAQ) {
    __syncthreads();  // the previous chunk's readers are done
    for (int idx = tid; idx < dh * kAQ; idx += kThreads) {
      const int d = idx / kAQ;
      const int r = idx - d * kAQ;
      const int i = i0 + r;
      float dov = 0.f, qw = 0.f;
      if (i < T) {
        const size_t at = q_off + static_cast<size_t>(d) * T + i;
        dov = commu::to_f(dout[at]);
        const float qs = commu::rnd<S>(commu::to_f(q[at]) * scale_s);
        qw = commu::rnd<S>(qs + commu::to_f(rwbs[h * dh + d]));
      }
      do_s[d][r] = dov;
      qw_s[d][r] = qw;
    }
    if (tid < kAQ) {
      const int i = i0 + tid;
      float dr = 0.f, l = 0.f;
      if (i < T) {
        for (int d = 0; d < dh; ++d) {
          const size_t at = q_off + static_cast<size_t>(d) * T + i;
          dr = fmaf(commu::to_f(dout[at]), commu::to_f(out[at]), dr);
        }
        l = lse[static_cast<size_t>(bh) * T + i];
      }
      dr_s[tid] = dr;
      lse_s[tid] = l;
    }
    __syncthreads();
    // dP = dO^T v over the 16 x 64 tile, then P and ds
    float dp[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < dh; ++d) {
      const float a = do_s[d][ty];
      const float4 v = *reinterpret_cast<const float4*>(&vt_s[d][tx * 4]);
      dp[0] = fmaf(a, v.x, dp[0]);
      dp[1] = fmaf(a, v.y, dp[1]);
      dp[2] = fmaf(a, v.z, dp[2]);
      dp[3] = fmaf(a, v.w, dp[3]);
    }
    const int row = i0 + ty;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kc = tx * 4 + c;
      const int j = k0 + kc;
      float p = 0.f, dsc = 0.f;
      if (row < T && j < K) {
        const size_t at = (static_cast<size_t>(bh) * T + row) * K + j;
        p = commu::rnd<S>(expf(s_res[at] - lse_s[ty]));
        float ds_f;
        if (drop) {
          const float probs = commu::keep(plane, drop_seed, row, j) ? p * plane.scale : 0.f;
          ds_f = probs * dp[c] - p * dr_s[ty];
          p = commu::rnd<S>(probs);  // dv takes the dropped probabilities
        } else {
          ds_f = p * (dp[c] - dr_s[ty]);
        }
        dsc = commu::rnd<S>(ds_f);
        // the int8 dphi form quantises ds before its rounding
        ds_buf[at] = raw_ds ? ds_f : dsc;
      }
      p_s[ty][kc] = p;
      ds_s[ty][kc] = dsc;
    }
    __syncthreads();
    // dk[j] += sum_i qw[:, i] ds_c[i, j];  dv[j] += sum_i dO[:, i] P[i, j]
    for (int r = 0; r < kAQ; ++r) {
      const float dsv = ds_s[r][jj];
      const float pv = p_s[r][jj];
#pragma unroll
      for (int g = 0; g < kMaxDh / 4; ++g) {
        const int d = tid / kAK + 4 * g;
        if (d < dh) {
          acc_k[g] = fmaf(qw_s[d][r], dsv, acc_k[g]);
          acc_v[g] = fmaf(do_s[d][r], pv, acc_v[g]);
        }
      }
    }
  }

  const int j = k0 + jj;
  if (j >= K) return;
#pragma unroll
  for (int g = 0; g < kMaxDh / 4; ++g) {
    const int d = tid / kAK + 4 * g;
    if (d >= dh) continue;
    if (j < M) {
      const size_t at = (static_cast<size_t>(bh) * dh + d) * M + j;
      dk_mem[at] = acc_k[g];
      dv_mem[at] = acc_v[g];
    } else {
      const size_t at = q_off + static_cast<size_t>(d) * T + (j - M);
      dk_win[at] = commu::from_f<S>(acc_k[g]);
      dv_win[at] = commu::from_f<S>(acc_v[g]);
    }
  }
}

// ---- pass B: dphi, du, dq over one query tile; kC = 2F / 128 column groups
template <typename S, int kC, bool kInt8>
__global__ void __launch_bounds__(kThreads)
bwd_queries_kernel(const S* __restrict__ k_mem, const S* __restrict__ k_win,
                   const S* __restrict__ w_r, const S* __restrict__ trig_a,
                   const S* __restrict__ psi_t, const int* __restrict__ psi_qw,
                   const float* __restrict__ ds_buf,
                   S* __restrict__ dq, float* __restrict__ du_buf, float* __restrict__ dqac_sum,
                   float* __restrict__ du_sum, int H, int dh, int T, int R, int Tb, int F2,
                   float scale) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float inv_sc_s[kBQ], sc_s[kBQ];  // the int8 form's row scales
  const int M = R * Tb;
  const int K = M + T;
  const int fpad = F2 / 2;
  const int dus = F2 + 4;     // row stride of du_s
  float* ds_s = smem;                    // [kBJ][kBQ]: ds_c, key-major
  float* psi_s = ds_s + kBJ * kBQ;       // [kBJ][F2]: psi^T rows of the chunk
  float* k_s = psi_s + kBJ * F2;         // [kBJ][kMaxDh]
  float* du_s = k_s + kBJ * kMaxDh;      // [kBQ][F2 + 4]
  float* qa_s = du_s + kBQ * dus;        // [kBQ][kMaxDh]: k ds_c^T
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qt = blockIdx.x;
  const int i0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid / 32;  // dphi rows 4 ty + {0..3}
  const int tx = tid % 32;  // dphi columns 4 tx + {0..3} + 128 c
  const int ro = tid / 8;   // dq row
  const int og = tid % 8;   // dq dims og + 8 g

  float acc[4][kC * 4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < kC * 4; ++e) acc[r][e] = 0.f;
  float acc_q[kMaxDh / 8];
#pragma unroll
  for (int g = 0; g < kMaxDh / 8; ++g) acc_q[g] = 0.f;
  // the int8 form: int32 sums, four keys a word; the staged words take the
  // place of psi_s
  int acc_i[4][kC * 4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < kC * 4; ++e) acc_i[r][e] = 0;
  int* psiq_s = reinterpret_cast<int*>(psi_s);  // [kBJ / 4][F2]
  int* dsq_s = psiq_s + (kBJ / 4) * F2;         // [kBJ / 4][kBQ]
  const int Kw = (K + 3) / 4;
  if constexpr (kInt8) {
    // each row's absolute maximum over all K keys: 4 rows a warp
    const int lane = tid % 32;
    for (int r = tid / 32; r < kBQ; r += kThreads / 32) {
      const int i = i0 + r;
      float amax = 0.f;
      if (i < T) {
        const float* row = ds_buf + (static_cast<size_t>(bh) * T + i) * K;
        for (int j = lane; j < K; j += 32) amax = fmaxf(amax, fabsf(row[j]));
      }
      amax = commu::warp_max(amax);
      if (lane == 0) {
        const float sc = fmaxf(amax, 1e-30f) * static_cast<float>(1.0 / 127.0);
        sc_s[r] = sc;
        inv_sc_s[r] = 1.f / sc;
      }
    }
    __syncthreads();
  }

  for (int j0 = 0; j0 < K; j0 += kBJ) {
    if constexpr (kInt8) {
      // one thread a (row, four keys): the rounded ds for k ds_c^T, and the
      // quantised word for dphi
      for (int idx = tid; idx < kBQ * (kBJ / 4); idx += kThreads) {
        const int r = idx / (kBJ / 4);
        const int g = idx - r * (kBJ / 4);
        const int i = i0 + r;
        const float inv = inv_sc_s[r];
        uint32_t word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + g * 4 + e;
          const float v =
              (i < T && j < K) ? ds_buf[(static_cast<size_t>(bh) * T + i) * K + j] : 0.f;
          ds_s[(g * 4 + e) * kBQ + r] = commu::rnd<S>(v);
          word |= (static_cast<uint32_t>(__float2int_rn(v * inv)) & 0xFFu) << (8 * e);
        }
        dsq_s[g * kBQ + r] = static_cast<int>(word);
      }
      for (int idx = tid; idx < (kBJ / 4) * F2; idx += kThreads) {
        const int g = idx / F2;
        const int jw = j0 / 4 + g;
        psiq_s[idx] = jw < Kw ? psi_qw[static_cast<size_t>(jw) * F2 + (idx - g * F2)] : 0;
      }
    } else {
      for (int idx = tid; idx < kBJ * kBQ; idx += kThreads) {
        const int r = idx / kBJ;
        const int jj = idx - r * kBJ;
        const int i = i0 + r;
        const int j = j0 + jj;
        ds_s[jj * kBQ + r] =
            (i < T && j < K) ? ds_buf[(static_cast<size_t>(bh) * T + i) * K + j] : 0.f;
      }
      for (int idx = tid; idx < kBJ * F2; idx += kThreads) {
        const int jj = idx / F2;
        const int f = idx - jj * F2;
        const int j = j0 + jj;
        psi_s[idx] = j < K ? commu::to_f(psi_t[static_cast<size_t>(j) * F2 + f]) : 0.f;
      }
    }
    for (int idx = tid; idx < kBJ * dh; idx += kThreads) {
      const int d = idx / kBJ;
      const int jj = idx - d * kBJ;
      const int j = j0 + jj;
      float kv = 0.f;
      if (j < K) {
        int stride = 0;
        const S* col = key_column(k_mem, k_win, b, h, j, H, dh, R, Tb, T, M, &stride);
        kv = commu::to_f(col[static_cast<size_t>(d) * stride]);
      }
      k_s[jj * kMaxDh + d] = kv;
    }
    __syncthreads();
    if constexpr (kInt8) {
#pragma unroll
      for (int g = 0; g < kBJ / 4; ++g) {
        const int4 dv = *reinterpret_cast<const int4*>(&dsq_s[g * kBQ + ty * 4]);
        const int dr[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const int4 pv = *reinterpret_cast<const int4*>(&psiq_s[g * F2 + c * 128 + tx * 4]);
          const int pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc_i[r][c * 4 + e] = __dp4a(dr[r], pr[e], acc_i[r][c * 4 + e]);
        }
      }
    }
#pragma unroll 4
    for (int jj = 0; jj < kBJ; ++jj) {
      if constexpr (!kInt8) {
        const float4 dv = *reinterpret_cast<const float4*>(&ds_s[jj * kBQ + ty * 4]);
        const float dr[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const float4 pv = *reinterpret_cast<const float4*>(&psi_s[jj * F2 + c * 128 + tx * 4]);
          const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][c * 4 + e] = fmaf(dr[r], pr[e], acc[r][c * 4 + e]);
        }
      }
      const float dsq = ds_s[jj * kBQ + ro];
#pragma unroll
      for (int g = 0; g < kMaxDh / 8; ++g) {
        const int d = og + 8 * g;
        if (d < dh) acc_q[g] = fmaf(dsq, k_s[jj * kMaxDh + d], acc_q[g]);
      }
    }
    __syncthreads();
  }

  if constexpr (kInt8) {
    // dphi = float(int32 sum) * (sc * (1 / 127)), as the reference scales it
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float back = sc_s[ty * 4 + r] * static_cast<float>(1.0 / 127.0);
#pragma unroll
      for (int e = 0; e < kC * 4; ++e) acc[r][e] = static_cast<float>(acc_i[r][e]) * back;
    }
  }
  // du = rnd(trig_combine_bwd(dphi)): column f of the cos half (group c <
  // kC / 2) pairs with f + fpad (group c + kC / 2) of the same thread
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty * 4 + r;
    const int i = i0 + row;
#pragma unroll
    for (int c = 0; c < kC / 2; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = c * 128 + tx * 4 + e;
        float du_a = 0.f, du_b = 0.f;
        if (i < T) {
          const float d_cos = acc[r][c * 4 + e];
          const float d_sin = acc[r][(c + kC / 2) * 4 + e];
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
  }
#pragma unroll
  for (int g = 0; g < kMaxDh / 8; ++g) {
    const int d = og + 8 * g;
    if (d < dh) qa_s[ro * kMaxDh + d] = i0 + ro < T ? acc_q[g] : 0.f;
  }
  __syncthreads();

  // dq = scale (k ds_c^T + W_r du^T)
  const int i = i0 + ro;
  const S* wr_h = w_r + static_cast<size_t>(h) * dh * F2;
#pragma unroll
  for (int g = 0; g < kMaxDh / 8; ++g) {
    const int d = og + 8 * g;
    if (d >= dh || i >= T) continue;
    float pos = 0.f;
    const S* wr_d = wr_h + static_cast<size_t>(d) * F2;
    for (int f = 0; f < F2; ++f) pos = fmaf(commu::to_f(wr_d[f]), du_s[ro * dus + f], pos);
    dq[(static_cast<size_t>(bh) * dh + d) * T + i] = commu::from_f<S>(scale * (acc_q[g] + pos));
  }
  // per-block sums over the tile's rows, in row order, for the bias gradients
  const int tiles = gridDim.x;
  const size_t blk = static_cast<size_t>(bh) * tiles + qt;
  for (int d = tid; d < dh; d += kThreads) {
    float s = 0.f;
    for (int r = 0; r < kBQ; ++r) s += qa_s[r * kMaxDh + d];
    dqac_sum[blk * dh + d] = s;
  }
  for (int f = tid; f < F2; f += kThreads) {
    float s = 0.f;
    for (int r = 0; r < kBQ; ++r) s += du_s[r * dus + f];
    du_sum[blk * F2 + f] = s;
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
  for (int f = threadIdx.x; f < F2; f += kThreads) {
    float s = 0.f;
    for (int b = 0; b < B; ++b)
      for (int t = 0; t < tiles; ++t)
        s += du_sum[((static_cast<size_t>(b) * H + h) * tiles + t) * F2 + f];
    sdu[f] = s;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < dh; d += kThreads) {
    float s = 0.f;
    for (int b = 0; b < B; ++b)
      for (int t = 0; t < tiles; ++t)
        s += dqac_sum[((static_cast<size_t>(b) * H + h) * tiles + t) * dh + d];
    drwb[h * dh + d] = scale * s;
    const S* wr_d = w_r + (static_cast<size_t>(h) * dh + d) * F2;
    float r = 0.f;
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

inline size_t pass_b_smem(int F2) {
  return sizeof(float) * (static_cast<size_t>(kBJ) * kBQ + kBJ * F2 + kBJ * kMaxDh +
                          kBQ * (F2 + 4) + kBQ * kMaxDh);
}

// Launch pass B over every (b, h, 32 queries): the exact form, or with
// ``psi_qw`` (psi_q as [ceil(K / 4)][2F] words) the int8 dphi form.
template <typename S>
cudaError_t launch_pass_b(const S* k_mem, const S* k_win, const S* w_r, const S* trig_a,
                          const S* psi_t, const int* psi_qw, const float* ds, S* dq, float* du,
                          float* dqac_sum, float* du_sum, int B, int H, int dh, int T, int R,
                          int Tb, int F2, float scale, cudaStream_t stream) {
  const size_t smem = pass_b_smem(F2);
  auto kernel_b = psi_qw != nullptr
      ? (F2 == 512 ? bwd_queries_kernel<S, 4, true> : bwd_queries_kernel<S, 2, true>)
      : (F2 == 512 ? bwd_queries_kernel<S, 4, false> : bwd_queries_kernel<S, 2, false>);
  cudaError_t err = commu::allow_smem(kernel_b, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (T + kBQ - 1) / kBQ;
  kernel_b<<<dim3(tiles, B * H), kThreads, smem, stream>>>(
      k_mem, k_win, w_r, trig_a, psi_t, psi_qw, ds, dq, du, dqac_sum, du_sum, H, dh, T, R, Tb, F2,
      scale);
  return cudaGetLastError();
}

}  // namespace
