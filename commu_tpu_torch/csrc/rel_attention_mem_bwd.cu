// Relative-position attention over the XL memory and the window, backward.
//
// Replaces: commu_tpu/ops/fused_attention.py::_bwd_kernel_mem (:1363, with
//   _bwd_stage_a :888 and _bwd_stage_b :931), as launched by _bwd_call_mem
//   (:1465) from fused_core_mem's backward _fused_bwd_mem (:1669), with the
//   attention dropout's branch (:913-928, :949-958).
//
// The forward (rel_attention_mem_fwd.cu) is, per (b, h), with keys j over
// [ring slabs | window] (K = M + T) and qw = q*scale + rwbs, qr = q*scale +
// rrbs:  S = qw^T k + phi psi + mask,  P = softmax_rows(S),  O = v P^T, with
// phi = trig_combine(qr^T W_r, trig_a).  It saved S (f32, mask included) and
// each row's log-sum-exp.  Given dO, this kernel forms
//   P   = exp(S - lse), rounded to S            (the reference's saved e)
//   dP  = dO^T v;  Dr = rowsum(dO * O);  ds = P (dP - Dr), ds_c = rnd(ds)
//   dv  = dO P;    dk = qw ds_c               [dh, K]  (window part out)
//   dphi = ds_c psi^T;  du = rnd(trig_combine_bwd(dphi))          [T, 2F]
//   dq  = scale (k ds_c^T + W_r du^T)                             [dh, T]
//   dWk = sum_b rnd(dk_mem) mem[layer, b]^T,  dWv likewise        [H, dh, D]
//   dW_r = sum_b qr du,  d r_w_bias = scale sum k ds_c^T,
//   d r_r_bias = scale W_r sum du                                 (:1008-1021)
// Dr = rowsum(dO * O) equals the reference's rowsum(P * dP) when dropout is
// off.  With dropout (thresh > 0) the mask of head h of row b, the plane [T, K]
// seeded with seed + b * 4096 + h, is recomputed from the hash (prng.cuh; the
// reference reads it off its sign-encoded probabilities, this residual has
// none): probs = keep ? P * keep_scale : 0, dv = dO rnd(probs), and
//   ds = probs dP - P Dr
// so a dropped position still receives the -P Dr term.  Dr = rowsum(dO * O)
// stays the reference's rowsum(probs * dP), since O was formed from the
// dropped probabilities.  Masked entries and reset rows (mask row 1) have S = NEG_INF, so P = 0
// and ds = 0.  The memory gets no gradient.  Products accumulate in f32;
// rnd() marks the reference's casts to the compute dtype.
//
// What bounds it on the H100: tensor-core arithmetic.  At the training shape
// (B = 256, H = 10, dh = 50, T = 128, M = 1024, 2F = 512, D = 500) a layer
// costs about 0.57 TFLOP of attention backward (the position term ds_c psi^T
// over 2F = 512 is two thirds of it) plus 0.26 TFLOP for dWk and dWv, a
// reduction over B x M = 262,144 memory slots.  The [T, K] planes of a head
// (590 KB in f32) do not fit a block's shared memory.
//
// Design (passes (A) and (B) live in rel_attention_bwd_passes.cuh, shared
// with the no-memory backward; every product on mma.sync, 3xTF32 in f32 and
// bf16 in bf16, as the reference runs them on the MXU):
// (A) one block per (b, h, 64 keys), looping over the queries 64 at a time:
//     dP on the tensor cores, then P and ds where its accumulators lie; ds_c
//     goes to a [B, H, T, K] workspace; dk and dv of its keys are block-local
//     products over all queries (the memory part to an f32 workspace, the
//     window part out).  (B) one block per (b, h, 64 queries), looping over
//     the keys 32 at a time: dphi [64 x 2F] and k ds_c^T in registers; then
//     du, W_r du^T (W_r's slab staged in shared memory), dq, and the
//     per-block sums of k ds_c^T and du for the bias gradients.  (C) the
//     weight gradients are sums over the batch: reduce.cuh's fixed-order
//     two-pass reductions on the tensor cores, reading mem by layer index
//     (no slice copy): dWk and dWv from operands staged by 16-byte cp.async
//     copies of the dk/dv workspace and the ring's slabs (reduce_outer_copy;
//     slabs of no whole number of 32-token chunks take reduce_outer_mma's
//     functor loads), dW_r by reduce_outer_mma; a last block per head for the
//     two bias gradients.  No float atomics: two runs give the same bits.
// With psi_q (COMMU_BD_INT8_BWD=1) pass (B) forms dphi on the int8 tensor
// cores (mma.sync m16n8k32), from the unrounded ds that pass (A) then leaves
// in the workspace, with the row maxima pass (A) wrote per 64-key tile: see
// rel_attention_bwd_passes.cuh.  dk, dv, dWk, dWv and k ds_c^T do not change
// by a bit.
// At widths past ModelConfig()'s (dh up to 128, 2F past 512) the passes
// run their wide forms (rel_attention_bwd_passes.cuh: pass A sized for dh
// 128, pass B over 2F in chunks of 256 columns, its position term summed
// over the chunks in a fixed order); the batch sums are the same.
#include "rel_attention_bwd_passes.cuh"

#include <algorithm>

namespace {

struct Operands {
  const void *q, *rwbs, *rrbs, *k_mem, *k_win, *v_mem, *v_win, *mem, *w_r, *trig_a, *psi_t;
  const int* psi_qw;  // the int8 dphi form's psi_q words, or null
  const float *s_res, *lse;
  const void *out, *dout;
};

struct Outputs {
  void *dq, *dk_win, *dv_win;
  float *dwk, *dwv, *dwr, *drwb, *drrb;
};

struct Buffers {
  float *ds, *amax, *dk_mem, *dv_mem, *du, *dqac_sum, *du_sum, *scratch;
};

// ---- operands of the batch sums
template <typename S>
struct DkMemOp {  // rnd(dk_mem[b, m, j]): the reference casts dkm to mem's dtype
  const float* x;
  int HD, M;
  __device__ float operator()(int, int b, int m, int j) const {
    return commu::rnd<S>(x[(static_cast<size_t>(b) * HD + m) * M + j]);
  }
};

template <typename S>
struct MemOp {  // mem[layer, j / Tb, b, d, j % Tb], the ring read by layer index
  const S* mem;
  int layer, R, B, D, Tb;
  __device__ float operator()(int, int b, int d, int j) const {
    const int r = j / Tb;
    return commu::to_f(
        mem[((((static_cast<size_t>(layer) * R + r) * B + b) * D + d) * Tb) + (j - r * Tb)]);
  }
};

size_t workspace(commu::Workspace& ws, Buffers* buf, int B, int H, int dh, int T, int R, int Tb,
                 int D, int F2) {
  const int M = R * Tb;
  const int K = M + T;
  const int tiles = (T + kBQ - 1) / kBQ;
  buf->ds = ws.take<float>(static_cast<size_t>(B) * H * T * K);
  buf->amax = ws.take<float>(static_cast<size_t>(B) * H * T * amax_tiles(K));
  buf->dk_mem = ws.take<float>(static_cast<size_t>(B) * H * dh * M);
  buf->dv_mem = ws.take<float>(static_cast<size_t>(B) * H * dh * M);
  buf->du = ws.take<float>(static_cast<size_t>(B) * H * F2 * T);
  buf->dqac_sum = ws.take<float>(static_cast<size_t>(B) * H * tiles * dh);
  buf->du_sum = ws.take<float>(static_cast<size_t>(B) * H * tiles * F2);
  // one scratch serves the three sums in turn: the largest of their forms
  const size_t a =
      std::max(commu::outer_scratch(1, H * dh, D, B, M), commu::copy_scratch(H * dh, D, B, M));
  buf->scratch = ws.take<float>(std::max(a, commu::outer_scratch(H, dh, F2, B, T)) / sizeof(float));
  return ws.used;
}

template <typename S>
int launch(const Operands& in, const Outputs& o, void* work, int layer, int B, int H, int dh,
           int T, int R, int Tb, int D, int F2, float scale, int seed, int thresh, float keep_scale, int bits,
           cudaStream_t stream) {
  if (!backward_widths(dh, F2)) return cudaErrorInvalidValue;
  commu::Workspace ws{static_cast<char*>(work), 0};
  Buffers buf;
  workspace(ws, &buf, B, H, dh, T, R, Tb, D, F2);
  const int M = R * Tb;
  const int K = M + T;
  const S* q = static_cast<const S*>(in.q);
  const S* w_r = static_cast<const S*>(in.w_r);
  const S* k_mem = static_cast<const S*>(in.k_mem);
  const S* k_win = static_cast<const S*>(in.k_win);

  cudaError_t err = launch_pass_a_at<S>(
      q, static_cast<const S*>(in.rwbs), k_mem, k_win, static_cast<const S*>(in.v_mem),
      static_cast<const S*>(in.v_win), in.s_res, in.lse, static_cast<const S*>(in.out),
      static_cast<const S*>(in.dout), buf.ds, buf.amax, buf.dk_mem, buf.dv_mem,
      static_cast<S*>(o.dk_win), static_cast<S*>(o.dv_win), B, H, dh, T, R, Tb, scale, seed,
      commu::make_plane(T, K, thresh, keep_scale, bits), in.psi_qw != nullptr, stream);
  if (err != cudaSuccess) return err;

  const int tiles = (T + kBQ - 1) / kBQ;
  err = launch_pass_b<S>(k_mem, k_win, w_r, static_cast<const S*>(in.trig_a),
                         static_cast<const S*>(in.psi_t), in.psi_qw, buf.ds, buf.amax,
                         static_cast<S*>(o.dq),
                         buf.du, buf.dqac_sum, buf.du_sum, B, H, dh, T, R, Tb, F2, scale, stream);
  if (err != cudaSuccess) return err;

  // dWk, dWv: by raw copies where the ring's slabs are whole chunks
  const S* ring = static_cast<const S*>(in.mem) + static_cast<size_t>(layer) * R * B * D * Tb;
  const commu::Rows<S> ring_rows{ring, static_cast<long long>(D) * Tb, Tb,
                                 static_cast<long long>(B) * D * Tb, Tb};
  const MemOp<S> mem_op{static_cast<const S*>(in.mem), layer, R, B, D, Tb};
  for (int w = 0; w < 2; ++w) {
    float* dmem = w == 0 ? buf.dk_mem : buf.dv_mem;
    float* dw = w == 0 ? o.dwk : o.dwv;
    const commu::Rows<float> d_rows{dmem, static_cast<long long>(H) * dh * M, M, 0, M};
    err = commu::copyable(d_rows, ring_rows, M)
        ? commu::reduce_outer_copy<S>(d_rows, ring_rows, dw, buf.scratch, H * dh, D, B, M,
                                      stream)
        : commu::reduce_outer_mma<S>(DkMemOp<S>{dmem, H * dh, M}, mem_op, dw, buf.scratch, 1,
                                     H * dh, D, B, M, stream);
    if (err != cudaSuccess) return err;
  }
  err = commu::reduce_outer_mma<S>(
      QrOp<S>{q, static_cast<const S*>(in.rrbs), H, dh, T, scale}, DuOp{buf.du, H, F2, T}, o.dwr,
      buf.scratch, H, dh, F2, B, T, stream);
  if (err != cudaSuccess) return err;
  bias_grad_kernel<S><<<H, kThreads, sizeof(float) * F2, stream>>>(
      buf.dqac_sum, buf.du_sum, w_r, o.drwb, o.drrb, B, H, tiles, dh, F2, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" long long commu_rel_attention_mem_bwd_workspace(int B, int H, int dh, int T, int R,
                                                           int Tb, int D, int F2) {
  commu::Workspace ws{nullptr, 0};
  Buffers buf;
  return static_cast<long long>(workspace(ws, &buf, B, H, dh, T, R, Tb, D, F2));
}

extern "C" int commu_rel_attention_mem_bwd(
    int dtype, const void* q, const void* rwbs, const void* rrbs, const void* k_mem,
    const void* k_win, const void* v_mem, const void* v_win, const void* mem, const void* w_r,
    const void* trig_a, const void* psi_t, const void* s_res, const void* lse, const void* out,
    const void* dout, void* dq, void* dk_win, void* dv_win, void* dwk, void* dwv, void* dwr,
    void* drwb, void* drrb, void* work, const void* psi_qw, int layer, int B, int H, int dh, int T, int R, int Tb,
    int D, int F2, float scale, int seed, int thresh, float keep_scale, int bits, void* stream) {
  const Operands in{q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, mem, w_r, trig_a, psi_t,
                    static_cast<const int*>(psi_qw), static_cast<const float*>(s_res), static_cast<const float*>(lse), out, dout};
  const Outputs o{dq, dk_win, dv_win, static_cast<float*>(dwk), static_cast<float*>(dwv),
                  static_cast<float*>(dwr), static_cast<float*>(drwb), static_cast<float*>(drrb)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == commu::kFloat32)
    return launch<float>(in, o, work, layer, B, H, dh, T, R, Tb, D, F2, scale, seed, thresh,
                         keep_scale, bits, s);
  if (dtype == commu::kBFloat16)
    return launch<__nv_bfloat16>(in, o, work, layer, B, H, dh, T, R, Tb, D, F2, scale, seed, thresh,
                                 keep_scale, bits, s);
  return cudaErrorInvalidValue;
}
