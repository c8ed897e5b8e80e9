// Tied-embedding logits and per-token NLL, backward.
//
// Replaces: commu_tpu/ops/fused_nll.py::_nll_bwd_kernel (:78), as launched by
//   _nll_bwd_call (:162) from fused_token_nll's backward (:205).
//
// For every batch row b and token t, with h = hidden[b, :, t], the saved
// log-normaliser lse[b, t] (nll_fwd.cu) and the incoming cotangent dnll[b, t]:
//   logits[v]   = emb[v] . h + bias[v]                        (f32, recomputed)
//   dlogits[v]  = (exp(logits[v] - lse) - [v == target]) * dnll
//   dh[b, :, t] = emb^T dlogits                              (in h's dtype)
//   demb        = sum over (b, t) of dlogits h^T              [V, D] f32
//   dbias       = sum over (b, t) of dlogits                  [V] f32
// dnll is whatever the caller passes: the train step's loss gives 0 at PAD
// targets, and the kernel assumes no mask.  A target outside [0, V) selects
// no logit, as in the forward.
//
// What bounds it on the H100: tensor-core arithmetic.  At the training shape
// (B = 256, T = 128, D = 500, V = 729) the logits, dh and demb are three
// products of 2 B T D V = 23.9 GFLOP each (12 G multiply-adds), 0.43 ms at
// the dense TF32 rate with the three passes of 3xTF32 counted; the [B, T, V]
// logits are recomputed, not stored by the forward.
//
// Design, six launches, every product on mma.sync (nll_pad.cuh):
//   (1) nll_pad: the hidden state and emb into zero-padded copies (x, the
//       logits' A, and emb [Vp][Dm] as the dh product's A);
//   (2) tile_product_kernel: the logits, as the forward takes them (3xTF32
//       in f32, h e_hi + h e_lo on bf16 in bf16); the epilogue forms
//       dlogits in f32 into a [B][Vp][Tp] workspace (95.6 MB at the training
//       shape; zeros in the padding) and the tile's row sums over its tokens
//       (dbias partials [B x token tiles][V]: a thread's 8 values, its quad,
//       the 4 warps across, in that order);
//   (3) tile_product_kernel<float>: dh = emb^T dlogits per batch row, the
//       depth Vp, 3xTF32 in both dtypes (dlogits is f32); the epilogue
//       rounds to h's dtype;
//   (4) demb by reduce.cuh's reduce_outer_copy<float> on the dlogits
//       workspace and x (both contiguous in t), 3xTF32: f32 sums of f32
//       dlogits in both dtypes, as the reference takes them; two launches;
//   (5) dbias: the partials of (2) added in index order (sum_groups).
// No float atomics: two runs on the same inputs give the same bits.
#include "nll_pad.cuh"

#include <math.h>

namespace {

// The epilogue of (2): dlogits of the tile into the workspace, and the
// tile's row sums over its tokens.
struct DlogitsOut {
  const float* bias;
  const int* targets;  // [B][T]
  const float* lse;    // [B][T]
  const float* dnll;   // [B][T]
  float* dl;           // [B][Vp][Tp]
  float* part;         // [B x token tiles][V]
  NllDims z;

  __device__ __forceinline__ void store(const float (&acc)[4][4][4], int b, int m0, int n0,
                                        int tile, float* red) const {
    const Frag f;
    float norm[4][2], grad[4][2];
    int tgt[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int t = n0 + f.col(ni, c);
        const size_t bt = static_cast<size_t>(b) * z.T + t;
        const bool in = t < z.T;
        norm[ni][c] = in ? lse[bt] : 0.f;
        grad[ni][c] = in ? dnll[bt] : 0.f;
        tgt[ni][c] = in ? targets[bt] : -1;
      }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = f.row(mi, half), v = m0 + row;
        const bool live = v < z.V;
        const float bv = live ? bias[v] : 0.f;
        float* dst = dl + (static_cast<size_t>(b) * z.Vp + v) * z.Tp;
        float rs = 0.f;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int t = n0 + f.col(ni, 0);
          float x[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            x[c] = 0.f;
            if (live && t + c < z.T) {
              const float p = expf(acc[mi][ni][2 * half + c] + bv - norm[ni][c]);
              x[c] = (p - (tgt[ni][c] == v ? 1.f : 0.f)) * grad[ni][c];
            }
            rs += x[c];
          }
          if (t < z.Tp) store_pair(dst + t, x[0], x[1]);
        }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        if (f.q == 0) red[f.wn * kBM + row] = rs;
      }
    __syncthreads();
    const int row = threadIdx.x;
    if (row < kBM && m0 + row < z.V)
      part[(static_cast<size_t>(b) * z.t_tiles() + tile) * z.V + m0 + row] =
          red[row] + red[kBM + row] + red[2 * kBM + row] + red[3 * kBM + row];
  }
};

// The epilogue of (3): dh in h's dtype.
template <typename S>
struct DhOut {
  S* dh;  // [B][D][T]
  NllDims z;

  __device__ __forceinline__ void store(const float (&acc)[4][4][4], int b, int m0, int n0, int,
                                        float*) const {
    const Frag f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = m0 + f.row(mi, half);
        if (d >= z.D) continue;
        S* dst = dh + (static_cast<size_t>(b) * z.D + d) * z.T;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int t = n0 + f.col(ni, c);
            if (t < z.T) dst[t] = commu::from_f<S>(acc[mi][ni][2 * half + c]);
          }
      }
  }
};

template <typename S>
struct Buffers {
  S *x, *al;
  float *ad, *dl, *part, *scratch, *deep;
};

template <typename S>
size_t workspace(commu::Workspace& ws, Buffers<S>* buf, const NllDims& z) {
  const size_t kl = static_cast<size_t>(kSplits<S>) * z.Dp;
  buf->x = ws.take<S>(static_cast<size_t>(z.B) * kl * z.Tp);
  buf->al = ws.take<S>(kl * z.Vp);
  buf->ad = ws.take<float>(static_cast<size_t>(z.Vp) * z.Dm);
  buf->dl = ws.take<float>(static_cast<size_t>(z.B) * z.Vp * z.Tp);
  buf->part = ws.take<float>(static_cast<size_t>(z.B) * z.t_tiles() * z.V);
  buf->scratch = ws.take<float>(commu::copy_scratch(z.V, z.D, z.B, z.Tp) / sizeof(float));
  // the tile's second level, for the deeper of the logits and dh products
  size_t deep = logits_deep_floats<S>(z);
  if (tile_deep_floats<float>(z.Vp, z.Dm, z.Tp, z.B) > deep)
    deep = tile_deep_floats<float>(z.Vp, z.Dm, z.Tp, z.B);
  buf->deep = deep > 0 ? ws.take<float>(deep) : nullptr;
  return ws.used;
}

template <typename S>
int launch(const void* hidden, const void* emb, const void* bias, const void* targets,
           const void* lse, const void* dnll, void* dh, void* demb, void* dbias, void* work,
           int B, int D, int T, int V, cudaStream_t stream) {
  if (B < 1 || D < 1 || T < 1 || V < 1) return cudaErrorInvalidValue;
  const NllDims z = nll_dims(B, D, T, V);
  commu::Workspace ws{static_cast<char*>(work), 0};
  Buffers<S> buf;
  workspace(ws, &buf, z);
  RETURN_ON_ERROR(nll_pad(static_cast<const S*>(hidden), static_cast<const float*>(emb), buf.x,
                          buf.al, buf.ad, z, stream));
  static_assert(tile_product_smem<S>() >= sizeof(float) * 4 * kBM, "the dbias sums reuse the ring");
  RETURN_ON_ERROR(run_logits(
      buf.al, buf.x, z,
      DlogitsOut{static_cast<const float*>(bias), static_cast<const int*>(targets),
                 static_cast<const float*>(lse), static_cast<const float*>(dnll), buf.dl,
                 buf.part, z},
      buf.deep, stream));
  RETURN_ON_ERROR(run_tile_product(static_cast<const float*>(buf.ad),
                                   static_cast<const float*>(buf.dl), z.Vp, z.Dm, z.Tp, B,
                                   DhOut<S>{static_cast<S*>(dh), z}, buf.deep, stream));
  // demb = sum dlogits x^T over the B x Tp tokens: both operands contiguous
  // in t, Tp whole chunks, the padding zero
  const long long kl = static_cast<long long>(kSplits<S>) * z.Dp;
  const commu::Rows<float> dl_rows{buf.dl, static_cast<long long>(z.Vp) * z.Tp, z.Tp, 0, z.Tp};
  const commu::Rows<S> x_rows{buf.x, kl * z.Tp, z.Tp, 0, z.Tp};
  RETURN_ON_ERROR(commu::reduce_outer_copy<float>(dl_rows, x_rows, static_cast<float*>(demb),
                                                  buf.scratch, V, D, B, z.Tp, stream));
  return commu::sum_groups(buf.part, static_cast<float*>(dbias), V, B * z.t_tiles(), 1, stream);
}

}  // namespace

extern "C" long long commu_nll_bwd_workspace(int B, int D, int T, int V) {
  // the f32 and bf16 copies take the same bytes (nll_pad.cuh)
  commu::Workspace ws{nullptr, 0};
  Buffers<float> buf;
  return static_cast<long long>(workspace(ws, &buf, nll_dims(B, D, T, V)));
}

extern "C" int commu_nll_bwd(int dtype, const void* hidden, const void* emb, const void* bias,
                             const void* targets, const void* lse, const void* dnll, void* dh,
                             void* demb, void* dbias, void* work, int B, int D, int T, int V,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == commu::kFloat32)
    return launch<float>(hidden, emb, bias, targets, lse, dnll, dh, demb, dbias, work, B, D, T, V,
                         s);
  if (dtype == commu::kBFloat16)
    return launch<__nv_bfloat16>(hidden, emb, bias, targets, lse, dnll, dh, demb, dbias, work, B,
                                 D, T, V, s);
  return cudaErrorInvalidValue;
}
