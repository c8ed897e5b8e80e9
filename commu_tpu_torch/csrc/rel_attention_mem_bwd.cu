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
// What bounds it on the H100: arithmetic.  At the training shape (B = 256,
// H = 10, dh = 50, T = 128, M = 1024, 2F = 512, D = 500) a layer costs about
// 0.57 TFLOP of attention backward (the position term ds_c psi^T over 2F =
// 512 is two thirds of it) plus 0.26 TFLOP for dWk and dWv, a reduction over
// B x M = 262,144 memory slots.  The [T, K] planes of a head (590 KB in f32)
// do not fit a block's shared memory.
//
// Design, f32 FMA throughout (f32 must stay f32; dh = 50 is no MMA width);
// passes (A) and (B) live in rel_attention_bwd_passes.cuh, shared with the
// no-memory backward:
// (A) one block per (b, h, 64 keys), looping over the queries 16 at a time:
//     it recomputes P, forms ds and writes ds_c to a [B, H, T, K] workspace;
//     dk and dv of its keys are block-local sums over all queries (the
//     memory part to an f32 workspace, the window part out).  (B) one block
//     per (b, h, 32 queries), looping over the keys 16 at a time: dphi
//     [32 x 2F] in registers (4 rows x 16 columns a thread, float4 reads of
//     the staged ds_c and psi^T), k ds_c^T beside it; then du, dq, and the
//     per-block sums of k ds_c^T and du for the bias gradients.  (C) the
//     weight gradients are sums over the batch: reduce.cuh's fixed-order
//     two-pass reduction, reading mem by layer index (no slice copy), and a
//     last block per head for the two bias gradients.  No float atomics: two
//     runs give the same bits.
// With psi_q (COMMU_BD_INT8_BWD=1) pass (B) forms dphi on int8 operands with
// __dp4a, from the unrounded ds that pass (A) then leaves in the workspace:
// see rel_attention_bwd_passes.cuh.  dk, dv, dWk, dWv and k ds_c^T do not
// change by a bit.
#include "rel_attention_bwd_passes.cuh"

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
  float *ds, *dk_mem, *dv_mem, *du, *dqac_sum, *du_sum, *scratch;
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
  buf->dk_mem = ws.take<float>(static_cast<size_t>(B) * H * dh * M);
  buf->dv_mem = ws.take<float>(static_cast<size_t>(B) * H * dh * M);
  buf->du = ws.take<float>(static_cast<size_t>(B) * H * F2 * T);
  buf->dqac_sum = ws.take<float>(static_cast<size_t>(B) * H * tiles * dh);
  buf->du_sum = ws.take<float>(static_cast<size_t>(B) * H * tiles * F2);
  const size_t a = commu::outer_scratch(1, H * dh, D, B);
  const size_t c = commu::outer_scratch(H, dh, F2, B);
  buf->scratch = ws.take<float>((a > c ? a : c) / sizeof(float));
  return ws.used;
}

template <typename S>
int launch(const Operands& in, const Outputs& o, void* work, int layer, int B, int H, int dh,
           int T, int R, int Tb, int D, int F2, float scale, int seed, int thresh, float keep_scale, int bits,
           cudaStream_t stream) {
  if (dh > kMaxDh || F2 % 256 != 0 || F2 > 128 * kMaxC) return cudaErrorInvalidValue;
  commu::Workspace ws{static_cast<char*>(work), 0};
  Buffers buf;
  workspace(ws, &buf, B, H, dh, T, R, Tb, D, F2);
  const int M = R * Tb;
  const int K = M + T;
  const S* q = static_cast<const S*>(in.q);
  const S* w_r = static_cast<const S*>(in.w_r);
  const S* k_mem = static_cast<const S*>(in.k_mem);
  const S* k_win = static_cast<const S*>(in.k_win);

  bwd_keys_kernel<S><<<dim3((K + kAK - 1) / kAK, B * H), kThreads, 0, stream>>>(
      q, static_cast<const S*>(in.rwbs), k_mem, k_win, static_cast<const S*>(in.v_mem),
      static_cast<const S*>(in.v_win), in.s_res, in.lse, static_cast<const S*>(in.out),
      static_cast<const S*>(in.dout), buf.ds, buf.dk_mem, buf.dv_mem, static_cast<S*>(o.dk_win),
      static_cast<S*>(o.dv_win), H, dh, T, R, Tb, scale, seed,
      commu::make_plane(T, K, thresh, keep_scale, bits), in.psi_qw != nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int tiles = (T + kBQ - 1) / kBQ;
  err = launch_pass_b<S>(k_mem, k_win, w_r, static_cast<const S*>(in.trig_a),
                         static_cast<const S*>(in.psi_t), in.psi_qw, buf.ds, static_cast<S*>(o.dq),
                         buf.du, buf.dqac_sum, buf.du_sum, B, H, dh, T, R, Tb, F2, scale, stream);
  if (err != cudaSuccess) return err;

  const MemOp<S> mem_op{static_cast<const S*>(in.mem), layer, R, B, D, Tb};
  err = commu::reduce_outer(DkMemOp<S>{buf.dk_mem, H * dh, M}, mem_op, o.dwk, buf.scratch, 1,
                            H * dh, D, B, M, stream);
  if (err != cudaSuccess) return err;
  err = commu::reduce_outer(DkMemOp<S>{buf.dv_mem, H * dh, M}, mem_op, o.dwv, buf.scratch, 1,
                            H * dh, D, B, M, stream);
  if (err != cudaSuccess) return err;
  err = commu::reduce_outer(
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
