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
// What bounds it on the H100: arithmetic, and the BD term most of all.  At
// the eval shape (B = 10, H = 10, dh = 50, T = 128, M = 2048, 2F = 512) a
// (row, head) costs ~285 MFLOP of phi psi against ~28 of qw^T k and ~28 of
// P v; 35 GFLOP per call.  psi [512, 2176] (4.5 MB f32) is shared by every
// block and read from L2.  A [T, K] f32 score plane is 1.1 MB and one head's
// K/V 0.87 MB: neither fits the 227 KB a block may use.
//
// Design: flash-attention style.  One block per (b, h, 32 query rows), 256
// threads.  The query side [phi | qw] (32 x 562 f32, 72 KB, zero-padded to a
// whole number of depth chunks) is built once and stays in shared memory;
// keys stream in tiles of 64 (the ring slabs, then the window), and each
// tile's scores are ONE product of depth 2F + dh over [psi ; k] chunks of 32
// rows staged in shared memory.  The chunks are double-buffered: each thread
// loads its 8 values of chunk c + 1 into registers before the product over
// chunk c, and stores them after it, so the L2 latency of psi hides behind
// the FMAs and one barrier per chunk suffices.  A thread always loads the
// same key column, so the ring-slab address of its key is computed once per
// tile.  Each thread owns 2 rows x 4 keys of the tile.  The softmax is
// online: a running row max and sum, the output accumulator rescaled as the
// max grows, one division at the end.  Each thread then owns one query row x
// 7 head dims of the output and accumulates P v from the tile's P and v in
// shared memory.  Products are f32 FMA loops: f32 must stay f32, and dh = 50
// is no MMA width.
//
// Masking: NEG_INF = -0.7 * FLT_MAX, read from the bf16 table and added in
// f32.  A tile whose columns are all masked (the empty memory of a fresh
// sequence) sets the running max to ~NEG_INF; its terms are then scaled by
// exp(NEG_INF - m) = 0 as soon as a real key arrives, and every row has one
// (its own diagonal window key), so no row ends empty and nothing overflows.
// Columns past K score -inf and weigh exactly 0.
//
// bf16 rounding: q*scale, qw, qr, phi and P round to bf16 where the
// reference rounds them (rnd<S>).  One difference is inherent to the online
// softmax: P is rounded BEFORE normalisation (exp(s - m_running)), where the
// reference rounds the normalised probability.  Both are one bf16 rounding of
// each weight; the plain twin follows the reference's order.
//
// With psi_q (COMMU_BD_INT8=1) the body takes its int8 BD form
// (rel_attention_mem_fwd_kernel<S, true>): the same tiles and the same
// double buffering, the first 2F / 4 / 32 chunks of each key tile being words
// of psi_q summed with __dp4a.  See rel_attention_mem_fwd_body.cuh.
#include "rel_attention_mem_fwd_body.cuh"

namespace {

template <typename S, bool kInt8>
__global__ void __launch_bounds__(kThreads, 2)
rel_attention_mem_fwd_kernel(const S* __restrict__ q, const S* __restrict__ rwbs,
                             const S* __restrict__ rrbs, const S* __restrict__ k_mem,
                             const S* __restrict__ k_win, const S* __restrict__ v_mem,
                             const S* __restrict__ v_win, const S* __restrict__ w_r,
                             const S* __restrict__ trig_a, const S* __restrict__ psi,
                             const __nv_bfloat16* __restrict__ mask,
                             const int* __restrict__ reset, S* __restrict__ out,
                             float* __restrict__ s_res, float* __restrict__ lse, int H, int dh,
                             int T, int R, int Tb, int F2, float scale, int seed,
                             commu::Plane plane, const int* __restrict__ psi_q) {
  extern __shared__ __align__(16) float smem[];
  attend_query_tile<S, kInt8>(smem, q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a, psi,
                              mask, reset, out, s_res, lse, blockIdx.y, blockIdx.x * kQT, H, dh, T,
                              R, Tb, F2, scale, seed, plane, psi_q);
}

template <typename S>
int launch(const void* q, const void* rwbs, const void* rrbs, const void* k_mem, const void* k_win,
           const void* v_mem, const void* v_win, const void* w_r, const void* trig_a,
           const void* psi, const void* mask, const void* reset, void* out, void* s_res,
           void* lse, const void* psi_q, int B, int H, int dh, int T, int R, int Tb, int F2,
           float scale, int seed, int thresh, float keep_scale, int bits, cudaStream_t stream) {
  if (dh > kMaxDh) return cudaErrorInvalidValue;
  // the int8 form packs 2F / 4 words of 32 rows in the registers of 256 threads
  if (psi_q != nullptr && (F2 % (4 * kBK) != 0 || F2 > 512)) return cudaErrorInvalidValue;
  const size_t smem = attend_smem_bytes(dh, F2);
  auto kernel = psi_q != nullptr ? rel_attention_mem_fwd_kernel<S, true>
                                 : rel_attention_mem_fwd_kernel<S, false>;
  cudaError_t err = commu::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kQT - 1) / kQT, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const S*>(q), static_cast<const S*>(rwbs), static_cast<const S*>(rrbs),
      static_cast<const S*>(k_mem), static_cast<const S*>(k_win), static_cast<const S*>(v_mem),
      static_cast<const S*>(v_win), static_cast<const S*>(w_r), static_cast<const S*>(trig_a),
      static_cast<const S*>(psi), static_cast<const __nv_bfloat16*>(mask),
      static_cast<const int*>(reset), static_cast<S*>(out), static_cast<float*>(s_res),
      static_cast<float*>(lse), H, dh, T, R, Tb, F2, scale, seed,
      commu::make_plane(T, R * Tb + T, thresh, keep_scale, bits), static_cast<const int*>(psi_q));
  return cudaGetLastError();
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
