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
// sum exact in any order (mma.sync s8 in both tensor-core bodies) over words of four depth rows: psi_q arrives as [2F / 4][T]
// words (quantize_psi_int8 on the host side, once per call).
//
// What bounds it on the H100: the products.  Training without XL memory
// runs it at B = 256, T = 128, 2F = 512, dh = 50: over the 8,256 unmasked
// scores of a head a launch has 21.6 G operations of BD (int8 in the fast
// numerics) and 4.2 GFLOP of qw^T k and P v, then 16.8 GFLOP of u = qr^T
// W_r, and writes the 168 MB f32 residual S (0.05 ms at 3.35 TB/s).  The serving prefill (T =
// 11, G = 8) is a few MFLOP a head: latency.
//
// Design: two tensor-core bodies, chosen by width.
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
//   - At every other width (heads up to 256, any even 2F), the wide body
//     (rel_attention_fwd_wide.cuh, #2's at those widths) with R = 0: the
//     same products and skips, the two warps of a row group sharing one
//     running maximum and splitting P v by head dims; where the query side
//     passes a block's shared memory it lies in a workspace slot a block
//     (commu_rel_attention_fwd_workspace), staged beside psi.  Any T.
// Scores, the softmax and every accumulation are f32; the additive mask is
// read from its bf16 table and added in f32, so NEG_INF = -0.7 * FLT_MAX is
// never formed in a narrower type.  In bf16 mode q*scale, qw, qr, phi and P
// are rounded to bf16 at the same places as the reference (rnd<S>).
#include "rel_attention_fwd_wide.cuh"

namespace {

// The wide body over the window alone (R = 0: k_mem and v_mem point at the
// window and are never read); ``work``: the streamed form's workspace, a
// slot of L.slot_bytes per block (no __restrict__: the block writes its slot
// and reads it back).
template <typename S, bool kInt8, int kDhCap>
__global__ void __launch_bounds__(kFwdThreads, wide_min_blocks<S, kInt8, kDhCap>())
rel_attention_fwd_wide_kernel(const S* __restrict__ q, const S* __restrict__ k,
                              const S* __restrict__ v, const S* __restrict__ rwbs,
                              const S* __restrict__ rrbs, const S* __restrict__ w_r,
                              const S* __restrict__ trig_a, const S* __restrict__ psi,
                              const int* __restrict__ psi_q,
                              const __nv_bfloat16* __restrict__ mask,
                              const int* __restrict__ reset, S* __restrict__ out,
                              float* __restrict__ s_res, float* __restrict__ lse, int H, int dh,
                              int T, int F2, float scale, int seed, commu::Plane plane,
                              bool aligned, WideLayout L, unsigned char* work) {
  extern __shared__ __align__(16) unsigned char smem_wide[];
  unsigned char* slot =
      L.streamed ? work + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * L.slot_bytes
                 : nullptr;
  attend_rows_wide<S, kInt8, kDhCap, true, commu::kSoftForm>(
      smem_wide, L, q, rwbs, rrbs, k, k, v, v, w_r, trig_a, psi, psi_q, mask, reset, out, s_res,
      lse, slot, blockIdx.y, blockIdx.x * kFwdRows, H, dh, T, 0, T, F2, scale, seed, plane,
      aligned);
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
  attend_rows_mma<S, kInt8, true, commu::kSoftForm>(smem_mma, q, rwbs, rrbs, k, k, v, v, w_r, trig_a, psi, psi_q,
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

template <typename S, bool kInt8>
int launch_wide(const void* q, const void* k, const void* v, const void* rwbs,
                        const void* rrbs, const void* w_r, const void* trig_a, const void* psi,
                        const void* psi_q, const void* mask, const void* reset, void* out,
                        void* s_res, void* lse, void* work, int B, int H, int dh, int T, int F2,
                        float scale, int seed, int thresh, float keep_scale, int bits,
                        cudaStream_t stream) {
  const WideLayout L = wide_choose<S, kInt8>(dh, F2);
  if (L.total > commu::kMaxSmemBytes) return commu::kRefusedSmem;
  if (L.streamed && work == nullptr) return cudaErrorInvalidValue;
  auto kernel = dh <= 128 ? rel_attention_fwd_wide_kernel<S, kInt8, 128>
                          : rel_attention_fwd_wide_kernel<S, kInt8, 256>;
  cudaError_t err = commu::allow_smem(kernel, L.total);
  if (err != cudaSuccess) return err;
  constexpr int kVec = 16 / sizeof(S);
  const bool aligned = T % kVec == 0 && aligned16(k) && aligned16(v) &&
                       aligned16(kInt8 ? psi_q : psi);
  const dim3 grid((T + kFwdRows - 1) / kFwdRows, B * H);
  kernel<<<grid, kFwdThreads, L.total, stream>>>(
      static_cast<const S*>(q), static_cast<const S*>(k), static_cast<const S*>(v),
      static_cast<const S*>(rwbs), static_cast<const S*>(rrbs), static_cast<const S*>(w_r),
      static_cast<const S*>(trig_a), static_cast<const S*>(psi), static_cast<const int*>(psi_q),
      static_cast<const __nv_bfloat16*>(mask), static_cast<const int*>(reset),
      static_cast<S*>(out), static_cast<float*>(s_res), static_cast<float*>(lse), H, dh, T, F2,
      scale, seed, commu::make_plane(T, T, thresh, keep_scale, bits), aligned, L,
      static_cast<unsigned char*>(work));
  return cudaGetLastError();
}

template <typename S>
int launch(const void* q, const void* k, const void* v, const void* rwbs, const void* rrbs,
           const void* w_r, const void* trig_a, const void* psi, const void* psi_q,
           const void* mask, const void* reset, void* out, void* s_res, void* lse, void* work,
           int B, int H, int dh, int T, int F2, float scale, int seed, int thresh,
           float keep_scale, int bits, cudaStream_t stream) {
  if (!fwd_on_tensor_cores(dh, F2)) return cudaErrorInvalidValue;
  if (psi_q != nullptr && F2 % 32 != 0) return cudaErrorInvalidValue;  // whole psi_q words
  if (fwd_narrow(dh, F2)) {
    if (psi_q != nullptr)
      return launch_mma<S, true>(q, k, v, rwbs, rrbs, w_r, trig_a, psi, psi_q, mask, reset, out,
                                 s_res, lse, B, H, dh, T, F2, scale, seed, thresh, keep_scale,
                                 bits, stream);
    return launch_mma<S, false>(q, k, v, rwbs, rrbs, w_r, trig_a, psi, psi_q, mask, reset, out,
                                s_res, lse, B, H, dh, T, F2, scale, seed, thresh, keep_scale,
                                bits, stream);
  }
  return psi_q != nullptr
      ? launch_wide<S, true>(q, k, v, rwbs, rrbs, w_r, trig_a, psi, psi_q, mask, reset, out,
                             s_res, lse, work, B, H, dh, T, F2, scale, seed, thresh, keep_scale,
                             bits, stream)
      : launch_wide<S, false>(q, k, v, rwbs, rrbs, w_r, trig_a, psi, psi_q, mask, reset, out,
                              s_res, lse, work, B, H, dh, T, F2, scale, seed, thresh, keep_scale,
                              bits, stream);
}

// bytes of the query-side workspace of the wide body's streamed form
// (``dtype``, ``int8``: the form), none for the other forms
template <typename S>
long long wide_workspace(bool int8, int B, int H, int dh, int T, int F2) {
  const WideLayout L = int8 ? wide_choose<S, true>(dh, F2) : wide_choose<S, false>(dh, F2);
  if (!L.streamed) return 0;
  return static_cast<long long>(L.slot_bytes) * B * H * ((T + kFwdRows - 1) / kFwdRows);
}

}  // namespace

extern "C" int COMMU_ENTRY(commu_rel_attention_fwd)(int dtype, const void* q, const void* k, const void* v,
                                       const void* rwbs, const void* rrbs, const void* w_r,
                                       const void* trig_a, const void* psi, const void* psi_q,
                                       const void* mask, const void* reset, void* out, void* s_res, void* lse,
                                       int B, int H, int dh, int T, int F2, float scale,
                                       int seed, int thresh, float keep_scale, int bits,
                                       void* work, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == commu::kFloat32)
    return launch<float>(q, k, v, rwbs, rrbs, w_r, trig_a, psi, psi_q, mask, reset, out, s_res, lse,
                         work, B, H, dh, T, F2, scale, seed, thresh, keep_scale, bits, s);
  if (dtype == commu::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, rwbs, rrbs, w_r, trig_a, psi, psi_q, mask, reset, out,
                                 s_res, lse, work, B, H, dh, T, F2, scale, seed, thresh,
                                 keep_scale, bits, s);
  return cudaErrorInvalidValue;
}

extern "C" long long COMMU_ENTRY(commu_rel_attention_fwd_workspace)(int dtype, int int8, int B,
                                                                  int H, int dh, int T, int F2) {
  if (!fwd_on_tensor_cores(dh, F2) || fwd_narrow(dh, F2)) return 0;
  return dtype == commu::kFloat32 ? wide_workspace<float>(int8 != 0, B, H, dh, T, F2)
                                  : wide_workspace<__nv_bfloat16>(int8 != 0, B, H, dh, T, F2);
}

// 1 where commu_rel_attention_fwd takes these widths: every one runs on
// the tensor cores (the narrow or the wide body, at any T)
extern "C" int COMMU_ENTRY(commu_rel_attention_fwd_on_tensor_cores)(int dh, int F2) {
  return fwd_on_tensor_cores(dh, F2);
}

extern "C" const char* COMMU_ENTRY(commu_error_string)(int err) {
  if (err == commu::kRefusedSmem)
    return "the widths need more shared memory per block than the kernel may use (227 KB)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
