// Relative-position attention forward with no XL memory (prefill).
//
// Replaces: commu_tpu/ops/fused_attention.py::_fwd_kernel (:698) through
//   _fwd_body / _attn_scores / _attn_softmax, as launched by _fused_call
//   (:1174) for fused_core (:1082) <- attention (:1697), and for its VJP
//   forward _fused_core_fwd (:1310, save_e=True) with the backward's
//   residual and the attention dropout (:621-638).  The reference saves the
//   sign-encoded normalised probabilities e; here, as in
//   rel_attention_mem_fwd.cu, the residual is the masked f32 score plane
//   S [B, H, T, T] and each row's log-sum-exp [B, H, T], and the backward
//   (rel_attention_bwd.cu) forms P = exp(S - lse) and recomputes the mask.
//   Without the residual nothing extra is written.
//
// Per (batch row b, head h), with the 1/sqrt(dh) scale folded into q:
//   qw = q*scale + r_w_bias*scale,  qr = q*scale + r_r_bias*scale   [dh, T]
//   AC = qw^T k                                                     [T, T]
//   u  = qr^T W_r[h],  phi = trig_combine(u, trig_a)                [T, 2F]
//   BD = phi psi                                                    [T, T]
//   S  = AC + BD + mask[reset[b]];  P = softmax_rows(S);  O = v P^T [dh, T]
// With dropout (thresh > 0), P becomes keep ? P * keep_scale : 0 before its
// rounding, with the plane [T, T] of head h of row b seeded with
// seed + b * 4096 + h (prng.cuh).
// With psi_q (the reference's _bd_matmul :486-499 under COMMU_BD_INT8=1) the
// BD product takes its int8 form: phi stays unrounded f32, each query row is
// quantised by its absolute maximum over the 2F columns,
//   phi_q = rint(phi * (127 / max(amax, 1e-20))),
// and BD = float(int32 phi_q psi_q) * (amax * (1 / (127 * 127))), the int32
// sum exact in any order (mma.sync s8 in the tensor-core body, __dp4a in the
// FMA body) over words of four depth rows: psi_q arrives as [2F / 4][T]
// words (quantize_psi_int8 on the host side, once per call).
//
// What bounds it on the H100: the products.  Training without XL memory
// runs it at B = 256, T = 128, 2F = 512, dh = 50: over the 8,256 unmasked
// scores of a head a launch has 21.6 G operations of BD (int8 in the fast
// numerics) and 4.2 GFLOP of qw^T k and P v, then 16.8 GFLOP of u = qr^T
// W_r, and writes the 168 MB f32 residual S (0.05 ms at 3.35 TB/s).  The serving prefill (T =
// 11, G = 8) is a few MFLOP a head: latency.
//
// Design: two bodies, chosen by width.
//   - The tensor-core body (rel_attention_fwd_mma.cuh, #2's) where dh <= 64
//     and 2F is a multiple of 128 up to 512 (ModelConfig(): dh 50, 2F 512):
//     one block per (b, h, 64 query rows), 8 warps of 16 rows x half of each
//     64-key tile, flash-attention-2 style; the int8 BD on mma.sync m16n8k32
//     s8, the float BD, qw^T k and P v on 3xTF32 (f32) or bf16 mma.sync; u
//     and the row quantiser on FMA in the first design's order, so phi and
//     phi_q keep their bits.  It is #2's body with R = 0: k_mem and v_mem
//     point at the window (commu::key_column never reads them), the plane
//     is make_plane(T, T, ...) and the seed seed + b * 4096 + h, so the
//     masks are the same bits.  It streams its keys, so T has no limit.
//     The causal upper triangle is skipped warp by warp (no BD, AC or P v
//     where a warp's 16 x 32 scores are all masked; out, lse and S keep
//     their bits), and a window shorter than 64 rows forms u for its live
//     row groups only.  It rounds P before its one division, as #2 does.
//   - The first design's FMA body, below, for every other shape (dh > 64,
//     2F past 512): one block per (b, h), 256 threads, k and v staged in
//     shared memory as f32 (v transposed so the output loop reads it
//     conflict-free); query rows in tiles of 8, one warp per row for the
//     scores, the softmax and the output.  W_r is not staged (100 KB at
//     f32); each tile streams it once from L2 for all 8 rows.  Its shared
//     memory grows with T: a T past 227 KB returns commu::kRefusedSmem.
//     It rounds the normalised P, as the reference does.
// Scores, the softmax and every accumulation are f32; the additive mask is
// read from its bf16 table and added in f32, so NEG_INF = -0.7 * FLT_MAX is
// never formed in a narrower type.  In bf16 mode q*scale, qw, qr, phi and P
// are rounded to bf16 at the same places as the reference (rnd<S>).
#include "rel_attention_fwd_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = kThreads / 32;  // query rows per tile: one warp each

template <typename S, bool kInt8>
__global__ void __launch_bounds__(kThreads)
rel_attention_fwd_kernel(const S* __restrict__ q, const S* __restrict__ k,
                         const S* __restrict__ v, const S* __restrict__ rwbs,
                         const S* __restrict__ rrbs, const S* __restrict__ w_r,
                         const S* __restrict__ trig_a, const S* __restrict__ psi,
                         const int* __restrict__ psi_q, const __nv_bfloat16* __restrict__ mask,
                         const int* __restrict__ reset, S* __restrict__ out,
                         float* __restrict__ s_res, float* __restrict__ lse,
                         int H, int dh, int T, int F2, float scale, int seed,
                         commu::Plane plane) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh % H;
  const int fpad = F2 / 2;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  float* k_s = smem;                 // [dh][T]
  float* v_t = k_s + dh * T;         // [T][dh]
  float* qw_t = v_t + T * dh;        // [kRows][dh]
  float* qr_t = qw_t + kRows * dh;   // [kRows][dh]
  float* phi_t = qr_t + kRows * dh;  // [kRows][F2]
  float* p_t = phi_t + kRows * F2;   // [kRows][T]
  int* phiq_t = reinterpret_cast<int*>(p_t + kRows * T);  // [kRows][F2 / 4], int8 form only
  constexpr bool int8 = kInt8;  // a kernel of its own: the exact form keeps its registers

  const size_t off = static_cast<size_t>(bh) * dh * T;
  for (int idx = tid; idx < dh * T; idx += kThreads) {
    const int d = idx / T;
    const int j = idx - d * T;
    k_s[idx] = commu::to_f(k[off + idx]);
    v_t[j * dh + d] = commu::to_f(v[off + idx]);
  }
  const float scale_s = commu::rnd<S>(scale);
  const __nv_bfloat16* mask_b = mask + (reset[b] != 0 ? static_cast<size_t>(T) * T : 0);
  const S* wr_h = w_r + static_cast<size_t>(h) * dh * F2;
  const bool drop = plane.thresh > 0;
  const uint32_t drop_seed = commu::plane_seed(seed, b, 4096, h);

  for (int i0 = 0; i0 < T; i0 += kRows) {
    __syncthreads();  // staging done / previous tile's readers done
    // the two query streams, biases folded in (rounded like the reference)
    for (int idx = tid; idx < kRows * dh; idx += kThreads) {
      const int r = idx / dh;
      const int d = idx - r * dh;
      const int i = i0 + r;
      float qw = 0.f, qr = 0.f;
      if (i < T) {
        const float qs = commu::rnd<S>(commu::to_f(q[off + d * T + i]) * scale_s);
        qw = commu::rnd<S>(qs + commu::to_f(rwbs[h * dh + d]));
        qr = commu::rnd<S>(qs + commu::to_f(rrbs[h * dh + d]));
      }
      qw_t[idx] = qw;
      qr_t[idx] = qr;
    }
    __syncthreads();
    // u = qr^T W_r[h] (sin half f, cos half fpad + f), then the per-query
    // trig rotation into phi; each W_r load serves all rows of the tile
    for (int f = tid; f < fpad; f += kThreads) {
      float us[kRows], uc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) us[r] = uc[r] = 0.f;
      for (int d = 0; d < dh; ++d) {
        const float ws = commu::to_f(wr_h[d * F2 + f]);
        const float wc = commu::to_f(wr_h[d * F2 + fpad + f]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float qv = qr_t[r * dh + d];
          us[r] = fmaf(qv, ws, us[r]);
          uc[r] = fmaf(qv, wc, uc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r;
        float pc = 0.f, ps = 0.f;
        if (i < T) {
          const float sa = commu::to_f(trig_a[i * F2 + f]);
          const float ca = commu::to_f(trig_a[i * F2 + fpad + f]);
          pc = us[r] * sa + uc[r] * ca;  // pairs with cos(w j)
          ps = uc[r] * sa - us[r] * ca;  // pairs with sin(w j)
          if constexpr (!int8) {  // the int8 form quantises the unrounded phi
            pc = commu::rnd<S>(pc);
            ps = commu::rnd<S>(ps);
          }
        }
        phi_t[r * F2 + f] = pc;
        phi_t[r * F2 + fpad + f] = ps;
      }
    }
    __syncthreads();

    const int i = i0 + warp;
    if (i < T) {
      const float* qw_r = qw_t + warp * dh;
      const float* phi_r = phi_t + warp * F2;
      float* p_r = p_t + warp * T;
      const int* phiq_r = phiq_t + warp * (F2 / 4);
      float bd_back = 0.f;
      if constexpr (int8) {
        float amax = 0.f;
        for (int f = lane; f < F2; f += 32) amax = fmaxf(amax, fabsf(phi_r[f]));
        amax = commu::warp_max(amax);
        const float qscale = 127.f / fmaxf(amax, 1e-20f);
        for (int w = lane; w < F2 / 4; w += 32) {
          uint32_t word = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            word |= (static_cast<uint32_t>(__float2int_rn(phi_r[4 * w + e] * qscale)) & 0xFFu)
                    << (8 * e);
          phiq_t[warp * (F2 / 4) + w] = static_cast<int>(word);
        }
        __syncwarp();
        bd_back = amax * static_cast<float>(1.0 / (127.0 * 127.0));
      }
      float mx = -FLT_MAX;
      for (int j = lane; j < T; j += 32) {
        float ac = 0.f;
        for (int d = 0; d < dh; ++d) ac = fmaf(qw_r[d], k_s[d * T + j], ac);
        float bd = 0.f;
        if constexpr (int8) {
          int sum = 0;
          for (int w = 0; w < F2 / 4; ++w) sum = __dp4a(phiq_r[w], psi_q[w * T + j], sum);
          bd = static_cast<float>(sum) * bd_back;
        } else {
          for (int f = 0; f < F2; ++f) bd = fmaf(phi_r[f], commu::to_f(psi[f * T + j]), bd);
        }
        const float s = ac + bd + __bfloat162float(mask_b[i * T + j]);
        p_r[j] = s;
        if (s_res != nullptr) s_res[(static_cast<size_t>(bh) * T + i) * T + j] = s;
        mx = fmaxf(mx, s);
      }
      mx = commu::warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < T; j += 32) {
        const float e = expf(p_r[j] - mx);
        p_r[j] = e;
        sum += e;
      }
      sum = commu::warp_sum(sum);
      if (lse != nullptr && lane == 0) lse[static_cast<size_t>(bh) * T + i] = mx + logf(sum);
      const float inv = 1.f / sum;
      for (int j = lane; j < T; j += 32) {
        float pv = p_r[j] * inv;
        if (drop) pv = commu::keep(plane, drop_seed, i, j) ? pv * plane.scale : 0.f;
        p_r[j] = commu::rnd<S>(pv);
      }
      __syncwarp();
      for (int d = lane; d < dh; d += 32) {
        float o = 0.f;
        for (int j = 0; j < T; ++j) o = fmaf(v_t[j * dh + d], p_r[j], o);
        out[off + d * T + i] = commu::from_f<S>(o);
      }
    }
  }
}

// The tensor-core body over the window alone (R = 0).
template <typename S, bool kInt8>
__global__ void __launch_bounds__(kFwdThreads, (kInt8 || sizeof(S) == 2) ? 2 : 1)
rel_attention_fwd_mma_kernel(const S* __restrict__ q, const S* __restrict__ k,
                             const S* __restrict__ v, const S* __restrict__ rwbs,
                             const S* __restrict__ rrbs, const S* __restrict__ w_r,
                             const S* __restrict__ trig_a, const S* __restrict__ psi,
                             const int* __restrict__ psi_q,
                             const __nv_bfloat16* __restrict__ mask,
                             const int* __restrict__ reset, S* __restrict__ out,
                             float* __restrict__ s_res, float* __restrict__ lse, int H, int dh,
                             int T, int F2, float scale, int seed, commu::Plane plane,
                             bool aligned) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  attend_rows_mma<S, kInt8, true>(smem_mma, q, rwbs, rrbs, k, k, v, v, w_r, trig_a, psi, psi_q,
                                  mask, reset, out, s_res, lse, blockIdx.y, blockIdx.x * kFwdRows,
                                  H, dh, T, 0, T, F2, scale, seed, plane, aligned);
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename S, bool kInt8>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* rwbs,
                       const void* rrbs, const void* w_r, const void* trig_a, const void* psi,
                       const void* psi_q, const void* mask, const void* reset, void* out,
                       void* s_res, void* lse, int B, int H, int dh, int T, int F2, float scale,
                       int seed, int thresh, float keep_scale, int bits, cudaStream_t stream) {
  const size_t smem = fwd_mma_smem<S, kInt8>(F2);
  auto kernel = rel_attention_fwd_mma_kernel<S, kInt8>;
  cudaError_t err = commu::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // 16-byte key groups (cp.async), else plain loads
  constexpr int kVec = 16 / sizeof(S);
  const bool aligned = T % kVec == 0 && aligned16(k) && aligned16(v) &&
                       aligned16(kInt8 ? psi_q : psi);
  const dim3 grid((T + kFwdRows - 1) / kFwdRows, B * H);
  kernel<<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const S*>(q), static_cast<const S*>(k), static_cast<const S*>(v),
      static_cast<const S*>(rwbs), static_cast<const S*>(rrbs), static_cast<const S*>(w_r),
      static_cast<const S*>(trig_a), static_cast<const S*>(psi), static_cast<const int*>(psi_q),
      static_cast<const __nv_bfloat16*>(mask), static_cast<const int*>(reset),
      static_cast<S*>(out), static_cast<float*>(s_res), static_cast<float*>(lse), H, dh, T, F2,
      scale, seed, commu::make_plane(T, T, thresh, keep_scale, bits), aligned);
  return cudaGetLastError();
}

// The tensor-core body's widths: head dims up to 64, whole 128-deep chunks
// of the BD depth.  Every other width runs the FMA body.
inline bool on_tensor_cores(int dh, int F2) {
  return dh >= 1 && dh <= kFwdMaxDh && F2 % 128 == 0 && F2 <= kFwdMaxF2;
}

template <typename S>
int launch(const void* q, const void* k, const void* v, const void* rwbs, const void* rrbs,
           const void* w_r, const void* trig_a, const void* psi, const void* psi_q,
           const void* mask, const void* reset, void* out, void* s_res, void* lse, int B, int H,
           int dh, int T, int F2, float scale, int seed, int thresh, float keep_scale, int bits,
           cudaStream_t stream) {
  if (on_tensor_cores(dh, F2)) {
    if (psi_q != nullptr)
      return launch_mma<S, true>(q, k, v, rwbs, rrbs, w_r, trig_a, psi, psi_q, mask, reset, out,
                                 s_res, lse, B, H, dh, T, F2, scale, seed, thresh, keep_scale,
                                 bits, stream);
    return launch_mma<S, false>(q, k, v, rwbs, rrbs, w_r, trig_a, psi, psi_q, mask, reset, out,
                                s_res, lse, B, H, dh, T, F2, scale, seed, thresh, keep_scale,
                                bits, stream);
  }
  const size_t smem = sizeof(float) *
      (2 * static_cast<size_t>(dh) * T + 2 * kRows * dh + kRows * F2 + kRows * T +
       (psi_q != nullptr ? kRows * F2 / 4 : 0));
  if (smem > commu::kMaxSmemBytes) return commu::kRefusedSmem;  // T too long
  auto kernel = psi_q != nullptr ? rel_attention_fwd_kernel<S, true>
                                 : rel_attention_fwd_kernel<S, false>;
  cudaError_t err = commu::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, kThreads, smem, stream>>>(
      static_cast<const S*>(q), static_cast<const S*>(k), static_cast<const S*>(v),
      static_cast<const S*>(rwbs), static_cast<const S*>(rrbs), static_cast<const S*>(w_r),
      static_cast<const S*>(trig_a), static_cast<const S*>(psi), static_cast<const int*>(psi_q),
      static_cast<const __nv_bfloat16*>(mask), static_cast<const int*>(reset),
      static_cast<S*>(out), static_cast<float*>(s_res), static_cast<float*>(lse), H, dh, T, F2,
      scale, seed, commu::make_plane(T, T, thresh, keep_scale, bits));
  return cudaGetLastError();
}

}  // namespace

extern "C" int commu_rel_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                       const void* rwbs, const void* rrbs, const void* w_r,
                                       const void* trig_a, const void* psi, const void* psi_q,
                                       const void* mask, const void* reset, void* out, void* s_res, void* lse,
                                       int B, int H, int dh, int T, int F2, float scale,
                                       int seed, int thresh, float keep_scale, int bits,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == commu::kFloat32)
    return launch<float>(q, k, v, rwbs, rrbs, w_r, trig_a, psi, psi_q, mask, reset, out, s_res, lse,
                         B, H, dh, T, F2, scale, seed, thresh, keep_scale, bits, s);
  if (dtype == commu::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, rwbs, rrbs, w_r, trig_a, psi, psi_q, mask, reset, out,
                                 s_res, lse, B, H, dh, T, F2, scale, seed, thresh, keep_scale, bits,
                                 s);
  return cudaErrorInvalidValue;
}

// 1 where commu_rel_attention_fwd runs the tensor-core body at these widths
// (at any T), 0 where it runs the FMA body (up to the T its shared memory
// takes)
extern "C" int commu_rel_attention_fwd_on_tensor_cores(int dh, int F2) {
  return on_tensor_cores(dh, F2);
}

extern "C" const char* commu_error_string(int err) {
  if (err == commu::kRefusedSmem)
    return "the shape needs more shared memory per block than the kernel may use (227 KB)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
