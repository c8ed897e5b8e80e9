// Relative-position attention forward over the XL memory and the window.
//
// Replaces: commu_tpu/ops/fused_attention.py::_fwd_kernel (:698) with memory
//   (_head_kv :384 joins the ring slabs and the window; _attn_scores :502,
//   _attn_softmax :585, _fwd_body :641), as launched by _fused_call (:1174)
//   from _fused_fwd (:1287) <- fused_core_mem (:1620) <- attention_mem
//   (:1718): in eval mode (no dropout, no probability checkpoint), and for
//   the training forward (_fused_fwd_mem :1651, save_e=True) with the
//   backward's residual and the attention dropout (:621-638).  The reference saves the normalised probabilities
//   e; the online softmax here has no normalised P until a row ends, so the
//   residual is the masked f32 score plane S [B, H, T, K] plus each row's
//   log-sum-exp lse [B, H, T], and the backward forms P = exp(S - lse)
//   (rel_attention_mem_bwd.cu).  Without the residual nothing extra is
//   written.
//
// Per (batch row b, head h), keys j over [ring slabs 0..R-1 | window], K = M + T:
//   qw = q*scale + r_w_bias*scale,  qr = q*scale + r_r_bias*scale   [dh, T]
//   u  = qr^T W_r[h],  phi = trig_combine(u, trig_a)                [T, 2F]
//   S  = qw^T k + phi psi + mask[reset[b]]                          [T, K]
//   O  = v softmax_rows(S)^T                                        [dh, T]
// psi comes already permuted into ring order (ring_psi) and the mask is in
// ring coordinates, so slot j of the ring is simply key j.
// With dropout (thresh > 0), head h of row b draws the plane [T, K] in these
// ring coordinates, seeded with seed + b * 4096 + h (prng.cuh):
//   O = v rnd(keep ? softmax_rows(S) * keep_scale : 0)^T
// The reference drops the normalised probabilities.  Here the unnormalised
// tile is dropped and scaled, the running row sum takes the UNDROPPED
// exponentials, and the one division at the end normalises: the same thing.
// The residual (S, lse) holds no mask; the backward recomputes it.
//
// What bounds it on the H100: the products and the residual.  At the
// training shape (B = 256, H = 10, dh = 50, T = 128, M = 1024, 2F = 512) a
// launch has 386 G operations of BD (int8 in the fast numerics), 75 GFLOP
// of qw^T k and P v, 17 GFLOP of u = qr^T W_r, and writes the 1.51 GB f32
// residual S (0.45 ms at 3.35 TB/s).  psi (or psi_q) is shared by every block
// and read from L2; a [T, K] score plane does not fit a block's shared
// memory.
//
// Design: flash-attention-2 style on the tensor cores, one block per (b, h,
// 64 query rows), 8 warps of 16 rows x half of each 64-key tile; see
// rel_attention_fwd_mma.cuh.  The
// int8 BD runs on mma.sync m16n8k32 s8, the float BD and qw^T k and P v on
// 3xTF32 (f32) or bf16 mma.sync; u and the row quantiser keep the FMA order
// of the first design, so phi_q keeps its bits.
//
// bf16 rounding: q*scale, qw, qr, phi and P round to bf16 where the
// reference rounds them (rnd<S>).  One difference is inherent to the online
// softmax: P is rounded BEFORE normalisation (exp(s - m_running)), where the
// reference rounds the normalised probability.  Both are one bf16 rounding of
// each weight; the plain twin follows the reference's order.
//
// With psi_q (COMMU_BD_INT8=1) the body takes its int8 BD form
// (rel_attention_mem_fwd_kernel<S, true>): psi_q arrives as words of four
// depth rows [2F / 4][K], and S = AC + float(sum) * (amax / (127 * 127)) +
// mask.
//
// Wide widths: the tensor-core body holds the query side of 64 rows in
// shared memory, which takes head widths up to 64 and 2F up to 512 in whole
// chunks of 128.  Every other width (dh up to 128, 2F past 512 or no
// multiple of 128: Transformer-XL's published widths, d_model 768 and 1024,
// d_head 64 and 128, give 2F = 768 and 1024) runs the first design's FMA
// body (rel_attention_mem_fwd_body.cuh, the projecting forward's), 32 query
// rows a block, in both forms: its int8 BD form sums phi_q psi_q exactly,
// as the tensor-core body does.  Its shared memory grows with 2F and dh
// alone (205 KB at 2F = 1024, dh = 128).
#include "rel_attention_fwd_mma.cuh"
#include "rel_attention_mem_fwd_body.cuh"

namespace {

template <typename S, bool kInt8>
__global__ void __launch_bounds__(kFwdThreads, (kInt8 || sizeof(S) == 2) ? 2 : 1)
rel_attention_mem_fwd_kernel(const S* __restrict__ q, const S* __restrict__ rwbs,
                             const S* __restrict__ rrbs, const S* __restrict__ k_mem,
                             const S* __restrict__ k_win, const S* __restrict__ v_mem,
                             const S* __restrict__ v_win, const S* __restrict__ w_r,
                             const S* __restrict__ trig_a, const S* __restrict__ psi,
                             const __nv_bfloat16* __restrict__ mask,
                             const int* __restrict__ reset, S* __restrict__ out,
                             float* __restrict__ s_res, float* __restrict__ lse, int H, int dh,
                             int T, int R, int Tb, int F2, float scale, int seed,
                             commu::Plane plane, const int* __restrict__ psi_q, bool aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  attend_rows_mma<S, kInt8>(smem, q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a, psi,
                            psi_q, mask, reset, out, s_res, lse, blockIdx.y, blockIdx.x * kFwdRows,
                            H, dh, T, R, Tb, F2, scale, seed, plane, aligned);
}

template <typename S, bool kInt8>
__global__ void __launch_bounds__(kThreads, 2)
rel_attention_mem_fwd_wide_kernel(const S* __restrict__ q, const S* __restrict__ rwbs,
                                  const S* __restrict__ rrbs, const S* __restrict__ k_mem,
                                  const S* __restrict__ k_win, const S* __restrict__ v_mem,
                                  const S* __restrict__ v_win, const S* __restrict__ w_r,
                                  const S* __restrict__ trig_a, const S* __restrict__ psi,
                                  const int* __restrict__ psi_q,
                                  const __nv_bfloat16* __restrict__ mask,
                                  const int* __restrict__ reset, S* __restrict__ out,
                                  float* __restrict__ s_res, float* __restrict__ lse, int H,
                                  int dh, int T, int R, int Tb, int F2, float scale, int seed,
                                  commu::Plane plane) {
  extern __shared__ __align__(16) float smem_wide[];
  attend_query_tile<S, kInt8>(smem_wide, q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a,
                              psi, psi_q, mask, reset, out, s_res, lse, blockIdx.y,
                              blockIdx.x * kQT, H, dh, T, R, Tb, F2, scale, seed, plane);
}

template <typename S, bool kInt8>
int launch_wide(const void* q, const void* rwbs, const void* rrbs, const void* k_mem,
                const void* k_win, const void* v_mem, const void* v_win, const void* w_r,
                const void* trig_a, const void* psi, const void* psi_q, const void* mask,
                const void* reset, void* out, void* s_res, void* lse, int B, int H, int dh,
                int T, int R, int Tb, int F2, float scale, int seed, int thresh,
                float keep_scale, int bits, cudaStream_t stream) {
  const size_t smem = attend_smem_bytes(dh, F2);
  if (smem > commu::kMaxSmemBytes) return commu::kRefusedSmem;  // 2F and dh too wide
  auto kernel = rel_attention_mem_fwd_wide_kernel<S, kInt8>;
  cudaError_t err = commu::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kQT - 1) / kQT, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const S*>(q), static_cast<const S*>(rwbs), static_cast<const S*>(rrbs),
      static_cast<const S*>(k_mem), static_cast<const S*>(k_win), static_cast<const S*>(v_mem),
      static_cast<const S*>(v_win), static_cast<const S*>(w_r), static_cast<const S*>(trig_a),
      static_cast<const S*>(psi), static_cast<const int*>(psi_q),
      static_cast<const __nv_bfloat16*>(mask), static_cast<const int*>(reset),
      static_cast<S*>(out), static_cast<float*>(s_res), static_cast<float*>(lse), H, dh, T, R,
      Tb, F2, scale, seed, commu::make_plane(T, R * Tb + T, thresh, keep_scale, bits));
  return cudaGetLastError();
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename S, bool kInt8>
cudaError_t launch_form(const void* q, const void* rwbs, const void* rrbs, const void* k_mem,
                        const void* k_win, const void* v_mem, const void* v_win, const void* w_r,
                        const void* trig_a, const void* psi, const void* mask, const void* reset,
                        void* out, void* s_res, void* lse, const void* psi_q, int B, int H,
                        int dh, int T, int R, int Tb, int F2, float scale, int seed, int thresh,
                        float keep_scale, int bits, cudaStream_t stream) {
  const size_t smem = fwd_mma_smem<S, kInt8>(F2);
  auto kernel = rel_attention_mem_fwd_kernel<S, kInt8>;
  cudaError_t err = commu::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // 16-byte key groups: whole in one slab or the window, aligned
  constexpr int kVec = 16 / sizeof(S);
  const bool aligned = T % kVec == 0 && (R == 0 || Tb % kVec == 0) && aligned16(k_mem) &&
                       aligned16(k_win) && aligned16(v_mem) && aligned16(v_win) &&
                       aligned16(kInt8 ? psi_q : psi);
  const dim3 grid((T + kFwdRows - 1) / kFwdRows, B * H);
  kernel<<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const S*>(q), static_cast<const S*>(rwbs), static_cast<const S*>(rrbs),
      static_cast<const S*>(k_mem), static_cast<const S*>(k_win), static_cast<const S*>(v_mem),
      static_cast<const S*>(v_win), static_cast<const S*>(w_r), static_cast<const S*>(trig_a),
      static_cast<const S*>(psi), static_cast<const __nv_bfloat16*>(mask),
      static_cast<const int*>(reset), static_cast<S*>(out), static_cast<float*>(s_res),
      static_cast<float*>(lse), H, dh, T, R, Tb, F2, scale, seed,
      commu::make_plane(T, R * Tb + T, thresh, keep_scale, bits), static_cast<const int*>(psi_q),
      aligned);
  return cudaGetLastError();
}

template <typename S>
int launch(const void* q, const void* rwbs, const void* rrbs, const void* k_mem, const void* k_win,
           const void* v_mem, const void* v_win, const void* w_r, const void* trig_a,
           const void* psi, const void* mask, const void* reset, void* out, void* s_res,
           void* lse, const void* psi_q, int B, int H, int dh, int T, int R, int Tb, int F2,
           float scale, int seed, int thresh, float keep_scale, int bits, cudaStream_t stream) {
  if (dh < 1 || dh > kMaxDh) return cudaErrorInvalidValue;
  // the tensor-core body: dh <= 64, whole chunks of the BD depth (32 words
  // of psi_q, 32 or 64 rows of psi) up to 512
  const bool mma = dh <= kFwdMaxDh && F2 % 128 == 0 && F2 <= kFwdMaxF2;
  if (!mma) {
    if (psi_q != nullptr && F2 % 32 != 0) return cudaErrorInvalidValue;  // whole BD chunks
    if (psi_q != nullptr)
      return launch_wide<S, true>(q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a, psi,
                                  psi_q, mask, reset, out, s_res, lse, B, H, dh, T, R, Tb, F2,
                                  scale, seed, thresh, keep_scale, bits, stream);
    return launch_wide<S, false>(q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a, psi,
                                 psi_q, mask, reset, out, s_res, lse, B, H, dh, T, R, Tb, F2,
                                 scale, seed, thresh, keep_scale, bits, stream);
  }
  if (psi_q != nullptr)
    return launch_form<S, true>(q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a, psi,
                                mask, reset, out, s_res, lse, psi_q, B, H, dh, T, R, Tb, F2,
                                scale, seed, thresh, keep_scale, bits, stream);
  return launch_form<S, false>(q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a, psi, mask,
                               reset, out, s_res, lse, psi_q, B, H, dh, T, R, Tb, F2, scale,
                               seed, thresh, keep_scale, bits, stream);
}

}  // namespace

extern "C" int commu_rel_attention_mem_fwd(int dtype, const void* q, const void* rwbs,
                                           const void* rrbs, const void* k_mem, const void* k_win,
                                           const void* v_mem, const void* v_win, const void* w_r,
                                           const void* trig_a, const void* psi, const void* mask,
                                           const void* reset, void* out, void* s_res, void* lse,
                                           const void* psi_q, int B, int H, int dh,
                                           int T, int R, int Tb, int F2, float scale,
                                           int seed, int thresh, float keep_scale, int bits,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == commu::kFloat32)
    return launch<float>(q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a, psi, mask,
                         reset, out, s_res, lse, psi_q, B, H, dh, T, R, Tb, F2, scale, seed, thresh,
                         keep_scale, bits, s);
  if (dtype == commu::kBFloat16)
    return launch<__nv_bfloat16>(q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a, psi,
                                 mask, reset, out, s_res, lse, psi_q, B, H, dh, T, R, Tb, F2, scale, seed,
                                 thresh, keep_scale, bits, s);
  return cudaErrorInvalidValue;
}
