// The first design of the attention forward over the XL memory, the body
// of the projecting forward (rel_attention_proj_fwd.cu), its only user
// since the two attention forwards run on the tensor cores at every width
// (rel_attention_fwd_mma.cuh, rel_attention_fwd_wide.cuh): one tile of 32
// query rows of one (batch row, head) against the keys [ring slabs |
// window].  rel_attention_proj_fwd.cu projects the slabs of its head inside
// the same kernel and then runs it for every query tile.
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
// The projecting forward has no int8 BD form (nor has the reference's), so
// neither has this body.
//
// The streamed form (kStream), for what the form above refuses: heads up to
// 256 wide (kStreamMaxDh; 32 output accumulators a thread) and a query side
// past 227 KB (2F past 1024 at dh 128: units 1536; 2F 2048 at units 2048).
// phi no longer stays in shared memory: the block writes its [2F][32] phi
// to a workspace slot of its own, and the product stages phi in chunks of 32 depth rows beside the [psi ; k] chunks,
// from that slot, double-buffered the same way; qw stays in shared memory.
// The slot is read back on the coherent path after the barrier (no
// __restrict__, no read-only loads).  Shared memory then grows with dh
// alone: 129 KB at dh 256, 81 KB at dh 128.  2F must be a whole number of
// chunks (every 2F of _fpad is).
//
// The lever forms (kSoft, commu::kSoftForm of the lever build) change the
// softmax as rel_attention_fwd_mma.cuh's do: this body too divides by the
// row sum once, after P v (the order of the reference's deferred
// normalisation); kSoftAfter scales the output by the keep-scale there
// instead of the tile, kSoftClamp clamps each score at 60 (so in S too) and
// keeps no maximum, its row sum guarded at 1e-30.
//
// The memory forward itself runs on the tensor cores at every width, so the
// projecting forward agrees with it to the tolerance, not bit for bit.
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
constexpr int kStreamMaxDh = 256;  // the streamed form's: 32 groups of 8

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
// kStream: the streamed form; phi_g is this tile's workspace slot, [2F][kQT]
// floats, which no other block touches (the block may reuse it for its next
// tile).
template <typename S, bool kStream = false, int kSoft = 0>
__device__ __forceinline__ void attend_query_tile(
    float* smem, const S* __restrict__ q, const S* __restrict__ rwbs,
    const S* __restrict__ rrbs, const S* k_mem, const S* __restrict__ k_win, const S* v_mem,
    const S* __restrict__ v_win, const S* __restrict__ w_r, const S* __restrict__ trig_a,
    const S* __restrict__ psi, const __nv_bfloat16* __restrict__ mask,
    const int* __restrict__ reset, S* __restrict__ out, float* __restrict__ s_res,
    float* __restrict__ lse, int bh, int q0, int H, int dh, int T, int R, int Tb, int F2,
    float scale, int seed, commu::Plane plane, float* phi_g = nullptr) {
  constexpr int kDhCap = kStream ? kStreamMaxDh : kMaxDh;
  constexpr bool kClamp = (kSoft & commu::kSoftClamp) != 0;
  constexpr bool kAfter = (kSoft & commu::kSoftAfter) != 0;
  __syncthreads();  // a previous tile's readers of smem are done
  const int M = R * Tb;
  const int K = M + T;
  const int fpad = F2 / 2;
  const int depth = F2 + dh;
  const int chunks = (depth + kBK - 1) / kBK;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;

  // streamed: a_s holds qw and zeros only, phi lies in phi_g
  const int qw_row0 = kStream ? 0 : F2;    // qw's first depth row in a_s
  const int a_rows = chunks * kBK - (kStream ? F2 : 0);
  float* a_s = smem;                       // [a_rows][kQT]: phi, qw, zeros
  float* b_s = a_s + a_rows * kQT;         // [2][kBK][kKT]: chunks of [psi ; k]
  float* p_s = b_s + 2 * kBK * kKT;        // [kQT][kKT + 1]: the tile's P
  float* v_s = p_s + kQT * (kKT + 1);      // [kKT][dh]: the tile's v, key-major
  float* qr_s = kStream ? v_s : b_s;       // [kQT][dh], before the key loop only
  float* alpha_s = v_s + kKT * dh;         // [kQT]: this tile's rescale factor
  float* l_s = alpha_s + kQT;              // [kQT]: the final row sums
  float* m_s = l_s + kQT;                  // [kQT]: the final row maxima
  float* phi_c = m_s + kQT;                // streamed: [2][kBK][kQT], phi's chunks
  float* phi_s = kStream ? phi_g : a_s;    // [2F][kQT]: phi

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
    a_s[(qw_row0 + d) * kQT + r] = qw;
    qr_s[r * dh + d] = qr;
  }
  for (int idx = (qw_row0 + dh) * kQT + tid; idx < a_rows * kQT; idx += kThreads) a_s[idx] = 0.f;
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
        pc = commu::rnd<S>(us[r] * sa + uc[r] * ca);  // pairs with cos(w j)
        ps = commu::rnd<S>(uc[r] * sa - us[r] * ca);  // pairs with sin(w j)
      }
      phi_s[f * kQT + r] = pc;
      phi_s[(fpad + f) * kQT + r] = ps;
    }
  }
  __syncthreads();
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
  float o_acc[kDhCap / 8];
#pragma unroll
  for (int g = 0; g < kDhCap / 8; ++g) o_acc[g] = 0.f;
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
    S ld[kLoads];
    // streamed: phi's chunk too, 4 values a thread, coalesced along rows
    constexpr int kPhiLoads = kBK * kQT / kThreads;
    float ldp[kPhiLoads];
    auto load_chunk = [&](int c0) {
      if constexpr (kStream) {
        if (c0 < F2) {
#pragma unroll
          for (int e = 0; e < kPhiLoads; ++e) ldp[e] = phi_g[c0 * kQT + tid + kThreads * e];
        }
      }
#pragma unroll
      for (int e = 0; e < kLoads; ++e) {
        const int f = c0 + ld_r + (kThreads / kKT) * e;
        S val = commu::from_f<S>(0.f);
        if (j_in && f < depth)
          val = f < F2 ? psi[static_cast<size_t>(f) * K + j]
                       : k_col[static_cast<size_t>(f - F2) * k_stride];
        ld[e] = val;
      }
    };
    auto store_chunk = [&](float* buf, int c0) {
      if constexpr (kStream) {
        if (c0 < F2) {
          float* dst = phi_c + ((c0 / kBK) & 1) * kBK * kQT;
#pragma unroll
          for (int e = 0; e < kPhiLoads; ++e) dst[tid + kThreads * e] = ldp[e];
        }
      }
#pragma unroll
      for (int e = 0; e < kLoads; ++e)
        buf[(ld_r + (kThreads / kKT) * e) * kKT + ld_j] = commu::to_f(ld[e]);
    };

    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
    // S tile = [phi | qw] [psi ; k], depth chunk by depth chunk, the next
    // chunk in flight while this one is multiplied
    load_chunk(0);
    store_chunk(b_s, 0);
    __syncthreads();
    for (int c = 0; c < chunks; ++c) {
      const float* cur = b_s + (c & 1) * kBK * kKT;
      if (c + 1 < chunks) load_chunk((c + 1) * kBK);
      const float* a_c = kStream && c * kBK < F2 ? phi_c + (c & 1) * kBK * kQT
                                                 : a_s + (c * kBK - F2 + qw_row0) * kQT;
      // s += this chunk's 2 x 4 products
#pragma unroll
      for (int rr = 0; rr < kBK; ++rr) {
        const float2 a = *reinterpret_cast<const float2*>(&a_c[rr * kQT + ty * 2]);
        const float4 bv = *reinterpret_cast<const float4*>(&cur[rr * kKT + tx * 4]);
        s[0][0] = fmaf(a.x, bv.x, s[0][0]);
        s[0][1] = fmaf(a.x, bv.y, s[0][1]);
        s[0][2] = fmaf(a.x, bv.z, s[0][2]);
        s[0][3] = fmaf(a.x, bv.w, s[0][3]);
        s[1][0] = fmaf(a.y, bv.x, s[1][0]);
        s[1][1] = fmaf(a.y, bv.y, s[1][1]);
        s[1][2] = fmaf(a.y, bv.z, s[1][2]);
        s[1][3] = fmaf(a.y, bv.w, s[1][3]);
      }
      if (c + 1 < chunks) store_chunk(b_s + ((c + 1) & 1) * kBK * kKT, (c + 1) * kBK);
      __syncthreads();
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
        if constexpr (kClamp) s[i][c] = fminf(s[i][c], 60.f);
        tmax = fmaxf(tmax, s[i][c]);
        if (s_res != nullptr && row < T && j < K)
          s_res[(static_cast<size_t>(bh) * T + row) * K + j] = s[i][c];
      }
      float m_new = 0.f, alpha = 1.f;  // kClamp: no maximum, no rescale
      if constexpr (!kClamp) {
        m_new = fmaxf(m_run[i], half_warp_max(tmax));
        alpha = expf(m_run[i] - m_new);
      }
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[i][c] - m_new);
        psum += p;
        float pd = p;
        if (drop) {
          const int j = k0 + tx * 4 + c;
          pd = (row < T && j < K && commu::keep(plane, drop_seed, row, j))
                   ? (kAfter ? p : p * plane.scale) : 0.f;
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
    for (int g = 0; g < kDhCap / 8; ++g) o_acc[g] *= alpha_o;
    const float* p_row = p_s + orow * (kKT + 1);
    for (int jj = 0; jj < kKT; ++jj) {
      const float p = p_row[jj];
      const float* v_row = v_s + jj * dh;
#pragma unroll
      for (int g = 0; g < kDhCap / 8; ++g) {
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
    const float l = kClamp ? fmaxf(l_s[orow], 1e-30f) : l_s[orow];
    float inv = 1.f / l;
    if constexpr (kAfter) inv *= plane.scale;  // 1 without dropout
#pragma unroll
    for (int g = 0; g < kDhCap / 8; ++g) {
      const int d = og + 8 * g;
      if (d < dh) out[q_off + static_cast<size_t>(d) * T + i] = commu::from_f<S>(o_acc[g] * inv);
    }
    if (lse != nullptr && og == 0)
      lse[static_cast<size_t>(bh) * T + i] = kClamp ? logf(l) : m_s[orow] + logf(l);
  }
}

inline size_t attend_smem_bytes(int dh, int F2) {
  const size_t padded = (static_cast<size_t>(F2 + dh) + kBK - 1) / kBK * kBK;
  // qr_s lives in b_s and must fit there: kQT * dh <= 2 * kBK * kKT
  return sizeof(float) * (padded * kQT + 2 * kBK * kKT + kQT * (kKT + 1) +
                          static_cast<size_t>(kKT) * dh + 3 * kQT);
}

// the streamed form's: qw's chunks, phi's two, no phi (qr_s lives in v_s)
inline size_t attend_stream_smem_bytes(int dh, int F2) {
  const size_t qw_rows = (static_cast<size_t>(F2 + dh) + kBK - 1) / kBK * kBK - F2;
  return sizeof(float) * (qw_rows * kQT + 2 * kBK * kKT + kQT * (kKT + 1) +
                          static_cast<size_t>(kKT) * dh + 3 * kQT + 2 * kBK * kQT);
}

// Whether (dh, 2F) takes the streamed form: a head past kMaxDh, or a query
// side the first form's shared memory cannot hold.
inline bool attend_streams(int dh, int F2) {
  return dh > kMaxDh || attend_smem_bytes(dh, F2) > static_cast<size_t>(commu::kMaxSmemBytes);
}

// what the streamed form takes: heads up to kStreamMaxDh, 2F in whole chunks
inline bool attend_stream_widths(int dh, int F2) {
  return dh >= 1 && dh <= kStreamMaxDh && F2 >= kBK && F2 % kBK == 0;
}

// floats of phi workspace the streamed form takes per query tile
__host__ __device__ inline size_t attend_phi_floats(int F2) {
  return static_cast<size_t>(F2) * kQT;
}

}  // namespace
