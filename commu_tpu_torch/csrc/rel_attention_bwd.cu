// Relative-position attention over the window alone (no XL memory), backward.
//
// Replaces: commu_tpu/ops/fused_attention.py::_bwd_kernel (:854, with
//   _bwd_stage_a :888 and _bwd_stage_b :931), as launched through _fused_call
//   (:1174) by fused_core's backward _fused_bwd (:1328), with the attention
//   dropout's branch (:913-928, :949-958) and the sum of dW_r over the batch
//   that the reference takes outside its kernel (:1347).
//
// The forward (rel_attention_fwd.cu, save outputs) is, per (b, h), with
// qw = q*scale + rwbs, qr = q*scale + rrbs and keys j over the window (K = T):
//   S = qw^T k + phi psi + mask,  P = softmax_rows(S),  O = v P^T
// with phi = trig_combine(qr^T W_r, trig_a).  It saved S (f32, mask included)
// and each row's log-sum-exp.  Given dO, this kernel forms
//   P   = exp(S - lse), rounded to S            (the reference's saved e)
//   dP  = dO^T v;  Dr = rowsum(dO * O);  ds = P (dP - Dr), ds_c = rnd(ds)
//   dv  = dO P;    dk = qw ds_c                                   [dh, T]
//   dphi = ds_c psi^T;  du = rnd(trig_combine_bwd(dphi))          [T, 2F]
//   dq  = scale (k ds_c^T + W_r du^T)                             [dh, T]
//   dW_r = sum_b qr du,  d r_w_bias = scale sum k ds_c^T,
//   d r_r_bias = scale W_r sum du                                 (:1008-1021)
// With dropout (thresh > 0) the mask of head h of row b, the plane [T, T] seeded
// with seed + b * 4096 + h, is recomputed from the hash (prng.cuh): probs =
// keep ? P * keep_scale : 0, dv = dO rnd(probs), ds = probs dP - P Dr.  There
// is no dWk or dWv: every key is a window key, and its dk, dv reach the qkv
// weight through the window projection's own backward.
//
// What bounds it on the H100: tensor-core arithmetic.  At the training shape
// without memory (B = 256, H = 10, dh = 50, T = 128, 2F = 512) the causal
// half of the [T, T] plane costs about 0.030 TFLOP a layer (ds_c psi^T over
// 2F = 512 is two thirds of it), and W_r du^T and qr du, which no mask thins,
// 0.034 TFLOP: the position terms per query row weigh as much as the scores.
//
// Design: the passes of rel_attention_bwd_passes.cuh with an empty ring
// (R = 0): (A) one block per (b, h, 64 keys) forms P, ds, dk and dv; (B) one
// block per (b, h, 64 queries) forms dphi, du and dq; the batch sum for dW_r
// is reduce.cuh's fixed-order two-pass reduction on the tensor cores, and one
// block per head sums the bias gradients.  Every product on mma.sync (3xTF32
// in f32, bf16 in bf16); no float atomics, so two runs give the same bits.
// With psi_q (COMMU_BD_INT8_BWD=1) pass (B) takes its int8 dphi form on the
// int8 tensor cores, as in rel_attention_mem_bwd.cu.
// At widths past ModelConfig()'s (dh up to 128, 2F past 512) the passes
// run their wide forms (rel_attention_bwd_passes.cuh: pass A sized for dh
// 128, pass B over 2F in chunks of 256 columns, its position term summed
// over the chunks in a fixed order); the batch sums are the same.
#include "rel_attention_bwd_passes.cuh"

namespace {

struct Buffers {
  float *ds, *amax, *du, *dqac_sum, *du_sum, *scratch;
};

size_t workspace(commu::Workspace& ws, Buffers* buf, int B, int H, int dh, int T, int F2) {
  const int tiles = (T + kBQ - 1) / kBQ;
  buf->ds = ws.take<float>(static_cast<size_t>(B) * H * T * T);
  buf->amax = ws.take<float>(static_cast<size_t>(B) * H * T * amax_tiles(T));
  buf->du = ws.take<float>(static_cast<size_t>(B) * H * F2 * T);
  buf->dqac_sum = ws.take<float>(static_cast<size_t>(B) * H * tiles * dh);
  buf->du_sum = ws.take<float>(static_cast<size_t>(B) * H * tiles * F2);
  buf->scratch = ws.take<float>(commu::outer_scratch(H, dh, F2, B, T) / sizeof(float));
  return ws.used;
}

template <typename S>
int launch(const void* q_, const void* rwbs, const void* rrbs, const void* k_, const void* v,
           const void* w_r_, const void* trig_a, const void* psi_t, const float* s_res,
           const float* lse, const void* out, const void* dout, void* dq, void* dk, void* dv,
           float* dwr, float* drwb, float* drrb, void* work, const int* psi_qw, int B, int H,
           int dh, int T, int F2, float scale, int seed, int thresh, float keep_scale, int bits, cudaStream_t stream) {
  if (!backward_widths(dh, F2)) return cudaErrorInvalidValue;
  commu::Workspace ws{static_cast<char*>(work), 0};
  Buffers buf;
  workspace(ws, &buf, B, H, dh, T, F2);
  const S* q = static_cast<const S*>(q_);
  const S* k = static_cast<const S*>(k_);
  const S* w_r = static_cast<const S*>(w_r_);
  const S* none = nullptr;  // no ring slabs: R = 0, so no key is read from them

  cudaError_t err = launch_pass_a_at<S>(
      q, static_cast<const S*>(rwbs), none, k, none, static_cast<const S*>(v), s_res, lse,
      static_cast<const S*>(out), static_cast<const S*>(dout), buf.ds, buf.amax, nullptr, nullptr,
      static_cast<S*>(dk), static_cast<S*>(dv), B, H, dh, T, 0, 1, scale, seed,
      commu::make_plane(T, T, thresh, keep_scale, bits), psi_qw != nullptr, stream);
  if (err != cudaSuccess) return err;

  const int tiles = (T + kBQ - 1) / kBQ;
  err = launch_pass_b<S>(none, k, w_r, static_cast<const S*>(trig_a),
                         static_cast<const S*>(psi_t), psi_qw, buf.ds, buf.amax,
                         static_cast<S*>(dq), buf.du,
                         buf.dqac_sum, buf.du_sum, B, H, dh, T, 0, 1, F2, scale, stream);
  if (err != cudaSuccess) return err;

  err = commu::reduce_outer_mma<S>(QrOp<S>{q, static_cast<const S*>(rrbs), H, dh, T, scale},
                            DuOp{buf.du, H, F2, T}, dwr, buf.scratch, H, dh, F2, B, T, stream);
  if (err != cudaSuccess) return err;
  bias_grad_kernel<S><<<H, kThreads, sizeof(float) * F2, stream>>>(
      buf.dqac_sum, buf.du_sum, w_r, drwb, drrb, B, H, tiles, dh, F2, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" long long commu_rel_attention_bwd_workspace(int B, int H, int dh, int T, int F2) {
  commu::Workspace ws{nullptr, 0};
  Buffers buf;
  return static_cast<long long>(workspace(ws, &buf, B, H, dh, T, F2));
}

extern "C" int commu_rel_attention_bwd(int dtype, const void* q, const void* rwbs,
                                       const void* rrbs, const void* k, const void* v,
                                       const void* w_r, const void* trig_a, const void* psi_t,
                                       const void* s_res, const void* lse, const void* out,
                                       const void* dout, void* dq, void* dk, void* dv, void* dwr,
                                       void* drwb, void* drrb, void* work, const void* psi_qw,
                                       int B, int H, int dh, int T, int F2, float scale, int seed, int thresh,
                                       float keep_scale, int bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sr = static_cast<const float*>(s_res);
  const float* ls = static_cast<const float*>(lse);
  float* wr = static_cast<float*>(dwr);
  float* rwb = static_cast<float*>(drwb);
  float* rrb = static_cast<float*>(drrb);
  const int* qw = static_cast<const int*>(psi_qw);
  if (dtype == commu::kFloat32)
    return launch<float>(q, rwbs, rrbs, k, v, w_r, trig_a, psi_t, sr, ls, out, dout, dq, dk, dv,
                         wr, rwb, rrb, work, qw, B, H, dh, T, F2, scale, seed, thresh, keep_scale,
                         bits, s);
  if (dtype == commu::kBFloat16)
    return launch<__nv_bfloat16>(q, rwbs, rrbs, k, v, w_r, trig_a, psi_t, sr, ls, out, dout, dq,
                                 dk, dv, wr, rwb, rrb, work, qw, B, H, dh, T, F2, scale, seed, thresh,
                                 keep_scale, bits, s);
  return cudaErrorInvalidValue;
}
