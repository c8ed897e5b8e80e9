// The first design of the attention forward over the XL memory, the body
// of the projecting forward (rel_attention_proj_fwd.cu) and of both
// attention forwards at the widths their tensor-core body does not take
// (rel_attention_mem_fwd.cu; rel_attention_fwd.cu with R = 0, the window
// alone): one tile of 32 query rows of one (batch row, head) against the
// keys [ring slabs | window].  rel_attention_proj_fwd.cu projects the slabs
// of its head inside the same kernel and then runs it for every query tile.
//
// Flash-attention style, f32 FMA products: the query side [phi | qw] (32 x
// (2F + dh) f32, zero-padded to a whole number of depth chunks) is built
// once and stays in shared memory; keys stream in tiles of 64 (the ring
// slabs, then the window), and each tile's scores are ONE product of depth
// 2F + dh over [psi ; k] chunks of 32 rows staged in shared memory.  The
// chunks are double-buffered: each thread loads its 8 values of chunk c + 1
// into registers before the product over chunk c, and stores them after it,
// so the L2 latency of psi hides behind the FMAs and one barrier per chunk
// suffices.  A thread always loads the same key column, so the ring-slab
// address of its key is computed once per tile.  Each thread owns 2 rows x 4
// keys of the tile.  The softmax is online: a running row max and sum, the
// output accumulator rescaled as the max grows, one division at the end.
// Each thread then owns one query row x 16 head dims of the output and
// accumulates P v from the tile's P and v in shared memory.  Masking,
// dropout and rounding as rel_attention_mem_fwd.cu states them.  Neither
// the key count nor T bounds its shared memory: only 2F and dh do (2F =
// 1024 at dh = 128 takes 205 KB).
//
// The int8 BD form (kInt8; the reference's _bd_matmul under
// COMMU_BD_INT8=1; 2F a multiple of 32, a whole number of chunks): phi stays
// unrounded f32 until each row is quantised by its absolute maximum over all
// of 2F, phi_q = rint(phi * (127 / max(amax, 1e-20))), kept in the same
// shared-memory slots as small integers in f32; psi_q's words of four depth
// rows [2F / 4][K] are loaded as words and their bytes staged into the same
// chunks as f32.  A product of two such values is exact in f32, and so
// is a chunk's sum of 32 of them (|sum| <= 32 * 127 * 127 < 2^24), so each
// chunk's partial sum is converted to int32 and added there: the BD sum is
// the exact int32 sum, at any 2F, and BD = float(sum) * (amax / (127 *
// 127)) is the tensor-core body's value to the bit.  qw^T k stays f32 and
// BD is added to it.
//
// The memory forward itself runs on the tensor cores (rel_attention_fwd_mma.cuh)
// wherever its widths allow, so the projecting forward agrees with it to the
// tolerance, not bit for bit.
// Everything here has internal linkage: each source that includes this file
// compiles its own copy.
#pragma once

#include "common.cuh"
#include "prng.cuh"

#include <float.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQT = 32;    // query rows per block
constexpr int kKT = 64;    // keys per tile
constexpr int kBK = 32;    // depth rows per staged [psi ; k] chunk
constexpr int kMaxDh = 128;  // head dims per output thread: 16 groups of 8

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// One tile of kQT query rows from q0 of head bh = b * H + h.  ``smem`` holds
// attend_smem_bytes(dh, F2) bytes; every thread of the block calls this, and
// a block may call it again for its next tile.  k_mem and v_mem carry no
// __restrict__: the projecting kernel reads slabs that its own block wrote.
// kInt8: the int8 BD form, from psi_q's words [2F / 4][K] (psi unread).
template <typename S, bool kInt8 = false>
__device__ __forceinline__ void attend_query_tile(
    float* smem, const S* __restrict__ q, const S* __restrict__ rwbs,
    const S* __restrict__ rrbs, const S* k_mem, const S* __restrict__ k_win, const S* v_mem,
    const S* __restrict__ v_win, const S* __restrict__ w_r, const S* __restrict__ trig_a,
    const S* __restrict__ psi, const int* __restrict__ psi_q,
    const __nv_bfloat16* __restrict__ mask,
    const int* __restrict__ reset, S* __restrict__ out, float* __restrict__ s_res,
    float* __restrict__ lse, int bh, int q0, int H, int dh, int T, int R, int Tb, int F2,
    float scale, int seed, commu::Plane plane) {
  __syncthreads();  // a previous tile's readers of smem are done
  const int M = R * Tb;
  const int K = M + T;
  const int fpad = F2 / 2;
  const int depth = F2 + dh;
  const int chunks = (depth + kBK - 1) / kBK;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;

  float* a_s = smem;                       // [chunks * kBK][kQT]: phi, qw, zeros
  float* b_s = a_s + chunks * kBK * kQT;   // [2][kBK][kKT]: chunks of [psi ; k]
  float* p_s = b_s + 2 * kBK * kKT;        // [kQT][kKT + 1]: the tile's P
  float* v_s = p_s + kQT * (kKT + 1);      // [kKT][dh]: the tile's v, key-major
  float* qr_s = b_s;                       // [kQT][dh], before the key loop only
  float* alpha_s = v_s + kKT * dh;         // [kQT]: this tile's rescale factor
  float* l_s = alpha_s + kQT;              // [kQT]: the final row sums
  float* m_s = l_s + kQT;                  // [kQT]: the final row maxima
  float* back_s = m_s + kQT;               // [kQT]: the int8 form's BD scale a row

  // --- the query side: qw into a_s, qr into qr_s (rounded like the reference)
  const size_t q_off = static_cast<size_t>(bh) * dh * T;
  const float scale_s = commu::rnd<S>(scale);
  for (int idx = tid; idx < kQT * dh; idx += kThreads) {
    const int r = idx / dh;
    const int d = idx - r * dh;
    const int i = q0 + r;
    float qw = 0.f, qr = 0.f;
    if (i < T) {
      const float qs = commu::rnd<S>(commu::to_f(q[q_off + static_cast<size_t>(d) * T + i]) * scale_s);
      qw = commu::rnd<S>(qs + commu::to_f(rwbs[h * dh + d]));
      qr = commu::rnd<S>(qs + commu::to_f(rrbs[h * dh + d]));
    }
    a_s[(F2 + d) * kQT + r] = qw;
    qr_s[r * dh + d] = qr;
  }
  for (int idx = depth * kQT + tid; idx < chunks * kBK * kQT; idx += kThreads) a_s[idx] = 0.f;
  __syncthreads();
  // u = qr^T W_r[h] (sin half f, cos half fpad + f), then the per-query trig
  // rotation into phi; each W_r load serves all kQT rows
  const S* wr_h = w_r + static_cast<size_t>(h) * dh * F2;
  for (int f = tid; f < fpad; f += kThreads) {
    float us[kQT], uc[kQT];
#pragma unroll
    for (int r = 0; r < kQT; ++r) us[r] = uc[r] = 0.f;
    for (int d = 0; d < dh; ++d) {
      const float ws = commu::to_f(wr_h[d * F2 + f]);
      const float wc = commu::to_f(wr_h[d * F2 + fpad + f]);
#pragma unroll
      for (int r = 0; r < kQT; ++r) {
        const float qv = qr_s[r * dh + d];
        us[r] = fmaf(qv, ws, us[r]);
        uc[r] = fmaf(qv, wc, uc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kQT; ++r) {
      const int i = q0 + r;
      float pc = 0.f, ps = 0.f;
      if (i < T) {
        const float sa = commu::to_f(trig_a[i * F2 + f]);
        const float ca = commu::to_f(trig_a[i * F2 + fpad + f]);
        pc = us[r] * sa + uc[r] * ca;  // pairs with cos(w j)
        ps = uc[r] * sa - us[r] * ca;  // pairs with sin(w j)
        if constexpr (!kInt8) {  // the int8 form quantises the unrounded phi
          pc = commu::rnd<S>(pc);
          ps = commu::rnd<S>(ps);
        }
      }
      a_s[f * kQT + r] = pc;
      a_s[(fpad + f) * kQT + r] = ps;
    }
  }
  __syncthreads();
  if constexpr (kInt8) {
    // each row's absolute maximum over all of 2F (8 threads a row, lanes of
    // one warp), then phi_q in place
    const int r = tid / 8;
    const int part = tid % 8;
    float amax = 0.f;
    for (int f = part; f < F2; f += 8) amax = fmaxf(amax, fabsf(a_s[f * kQT + r]));
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float qscale = 127.f / fmaxf(amax, 1e-20f);
    for (int f = part; f < F2; f += 8)
      a_s[f * kQT + r] = static_cast<float>(__float2int_rn(a_s[f * kQT + r] * qscale));
    if (part == 0) back_s[r] = amax * static_cast<float>(1.0 / (127.0 * 127.0));
    __syncthreads();
  }
  // score layout: rows 2 ty + {0, 1}, keys 4 tx + {0..3}; a row's 16 threads
  // are one half-warp.  Output layout: row orow, head dims og + 8 g.
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int orow = tid / 8;
  const int og = tid % 8;
  const __nv_bfloat16* mask_b = mask + (reset[b] != 0 ? static_cast<size_t>(T) * K : 0);
  const bool drop = plane.thresh > 0;
  const uint32_t drop_seed = commu::plane_seed(seed, b, 4096, h);
  float m_run[2] = {-FLT_MAX, -FLT_MAX};
  float l_run[2] = {0.f, 0.f};
  float o_acc[kMaxDh / 8];
#pragma unroll
  for (int g = 0; g < kMaxDh / 8; ++g) o_acc[g] = 0.f;
  // the chunk loader: thread tid always loads key column ld_j of the tile,
  // depth rows ld_r + 4 e (e < 8) of each chunk
  constexpr int kLoads = kBK * kKT / kThreads;
  const int ld_j = tid % kKT;
  const int ld_r = tid / kKT;
  for (int k0 = 0; k0 < K; k0 += kKT) {
    const int j = k0 + ld_j;
    const bool j_in = j < K;
    int k_stride = 0, v_stride = 0;
    const S* k_col =
        commu::key_column(k_mem, k_win, b, h, j_in ? j : 0, H, dh, R, Tb, T, M, &k_stride);
    const S* v_col =
        commu::key_column(v_mem, v_win, b, h, j_in ? j : 0, H, dh, R, Tb, T, M, &v_stride);
    // raw values in flight: converted to f32 only when stored, so no
    // conversion waits on a load before the product over the current chunk
    // (the int8 form's BD chunks: psi_q's words, byte f % 4 taken at the
    // store; F2 is a whole number of chunks there, so a chunk is all BD or
    // all k)
    S ld[kLoads];
    int ldw[kLoads];
    auto load_chunk = [&](int c0) {
      const bool words = kInt8 && c0 < F2;
#pragma unroll
      for (int e = 0; e < kLoads; ++e) {
        const int f = c0 + ld_r + (kThreads / kKT) * e;
        S val = commu::from_f<S>(0.f);
        int word = 0;
        if (j_in && f < depth) {
          if (words) {
            word = psi_q[static_cast<size_t>(f >> 2) * K + j];
          } else {
            val = f < F2 ? psi[static_cast<size_t>(f) * K + j]
                         : k_col[static_cast<size_t>(f - F2) * k_stride];
          }
        }
        ld[e] = val;
        ldw[e] = word;
      }
    };
    auto store_chunk = [&](float* buf, int c0) {
      const bool words = kInt8 && c0 < F2;
#pragma unroll
      for (int e = 0; e < kLoads; ++e) {
        const int row = ld_r + (kThreads / kKT) * e;
        // byte (row % 4) of the word: c0 and the row stride are multiples of 4
        buf[row * kKT + ld_j] =
            words ? static_cast<float>(static_cast<signed char>(ldw[e] >> (8 * (ld_r & 3))))
                  : commu::to_f(ld[e]);
      }
    };

    float s[2][4];
    int si[2][4];  // the int8 form's BD sums
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f, si[i][c] = 0;
    // acc += this chunk's 2 x 4 products
    auto fma_chunk = [&](float (&acc)[2][4], const float* a_c, const float* cur) {
#pragma unroll
      for (int rr = 0; rr < kBK; ++rr) {
        const float2 a = *reinterpret_cast<const float2*>(&a_c[rr * kQT + ty * 2]);
        const float4 bv = *reinterpret_cast<const float4*>(&cur[rr * kKT + tx * 4]);
        acc[0][0] = fmaf(a.x, bv.x, acc[0][0]);
        acc[0][1] = fmaf(a.x, bv.y, acc[0][1]);
        acc[0][2] = fmaf(a.x, bv.z, acc[0][2]);
        acc[0][3] = fmaf(a.x, bv.w, acc[0][3]);
        acc[1][0] = fmaf(a.y, bv.x, acc[1][0]);
        acc[1][1] = fmaf(a.y, bv.y, acc[1][1]);
        acc[1][2] = fmaf(a.y, bv.z, acc[1][2]);
        acc[1][3] = fmaf(a.y, bv.w, acc[1][3]);
      }
    };
    // S tile = [phi | qw] [psi ; k], depth chunk by depth chunk, the next
    // chunk in flight while this one is multiplied
    load_chunk(0);
    store_chunk(b_s, 0);
    __syncthreads();
    for (int c = 0; c < chunks; ++c) {
      const float* cur = b_s + (c & 1) * kBK * kKT;
      if (c + 1 < chunks) load_chunk((c + 1) * kBK);
      const float* a_c = a_s + c * kBK * kQT;
      if (kInt8 && c * kBK < F2) {  // a chunk of BD: exact in f32, summed in int32
        float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        fma_chunk(part, a_c, cur);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) si[i][cc] += __float2int_rn(part[i][cc]);
      } else {
        fma_chunk(s, a_c, cur);
      }
      if (c + 1 < chunks) store_chunk(b_s + ((c + 1) & 1) * kBK * kKT, (c + 1) * kBK);
      __syncthreads();
    }
    if constexpr (kInt8) {  // S = qw^T k + float(sum) * (amax / (127 * 127))
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float back = back_s[ty * 2 + i];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) s[i][cc] += static_cast<float>(si[i][cc]) * back;
      }
    }
    // the tile's v, key-major (the previous tile's readers passed the
    // barriers above)
    for (int d = ld_r; d < dh; d += kThreads / kKT)
      v_s[ld_j * dh + d] = j_in ? commu::to_f(v_col[static_cast<size_t>(d) * v_stride]) : 0.f;
    // mask, then the online softmax update of the tile's rows
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty * 2 + i;
      const int row = q0 + r;
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx * 4 + c;
        if (j >= K) {
          s[i][c] = -INFINITY;
        } else if (row < T) {
          s[i][c] += __bfloat162float(mask_b[static_cast<size_t>(row) * K + j]);
        }
        tmax = fmaxf(tmax, s[i][c]);
        if (s_res != nullptr && row < T && j < K)
          s_res[(static_cast<size_t>(bh) * T + row) * K + j] = s[i][c];
      }
      const float m_new = fmaxf(m_run[i], half_warp_max(tmax));
      const float alpha = expf(m_run[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[i][c] - m_new);
        psum += p;
        float pd = p;
        if (drop) {
          const int j = k0 + tx * 4 + c;
          pd = (row < T && j < K && commu::keep(plane, drop_seed, row, j)) ? p * plane.scale : 0.f;
        }
        p_s[r * (kKT + 1) + tx * 4 + c] = commu::rnd<S>(pd);
      }
      l_run[i] = l_run[i] * alpha + half_warp_sum(psum);
      m_run[i] = m_new;
      if (tx == 0) alpha_s[r] = alpha;
    }
    __syncthreads();
    // O = O * alpha + P v over the tile
    const float alpha_o = alpha_s[orow];
#pragma unroll
    for (int g = 0; g < kMaxDh / 8; ++g) o_acc[g] *= alpha_o;
    const float* p_row = p_s + orow * (kKT + 1);
    for (int jj = 0; jj < kKT; ++jj) {
      const float p = p_row[jj];
      const float* v_row = v_s + jj * dh;
#pragma unroll
      for (int g = 0; g < kMaxDh / 8; ++g) {
        const int d = og + 8 * g;
        if (d < dh) o_acc[g] = fmaf(p, v_row[d], o_acc[g]);
      }
    }
  }

  if (tx == 0) {
    l_s[ty * 2] = l_run[0];
    l_s[ty * 2 + 1] = l_run[1];
    m_s[ty * 2] = m_run[0];
    m_s[ty * 2 + 1] = m_run[1];
  }
  __syncthreads();
  const int i = q0 + orow;
  if (i < T) {
    const float inv = 1.f / l_s[orow];
#pragma unroll
    for (int g = 0; g < kMaxDh / 8; ++g) {
      const int d = og + 8 * g;
      if (d < dh) out[q_off + static_cast<size_t>(d) * T + i] = commu::from_f<S>(o_acc[g] * inv);
    }
    if (lse != nullptr && og == 0) lse[static_cast<size_t>(bh) * T + i] = m_s[orow] + logf(l_s[orow]);
  }
}

inline size_t attend_smem_bytes(int dh, int F2) {
  const size_t padded = (static_cast<size_t>(F2 + dh) + kBK - 1) / kBK * kBK;
  // qr_s lives in b_s and must fit there: kQT * dh <= 2 * kBK * kKT
  return sizeof(float) * (padded * kQT + 2 * kBK * kKT + kQT * (kKT + 1) +
                          static_cast<size_t>(kKT) * dh + 4 * kQT);
}

}  // namespace
