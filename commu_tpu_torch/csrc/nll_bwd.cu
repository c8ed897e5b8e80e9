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
// What bounds it on the H100: arithmetic.  At the training shape (B = 256,
// T = 128, D = 500, V = 729) the logits, dh and demb are three products of
// 12 GFLOP each; the [B, T, V] logits are recomputed, not stored by the
// forward.
//
// Design: a row pass, then the batch sums.  (1) One block per (b, 8 tokens), 256 threads, as
// nll_fwd.cu: the hidden tile and the tile's logits live in shared memory;
// the logits become dlogits in place, are written to a [B, V, T] f32
// workspace (95 MB at the training shape), and each thread forms dh for its
// features d with emb read coalesced along d.  (2) demb and dbias are sums
// over the batch: reduce.cuh's fixed-order two-pass reduction (a tiled
// product per group of rows, then the groups added in order; no atomics).
#include "reduce.cuh"

#include <float.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTT = 8;  // tokens per block

template <typename S>
__global__ void __launch_bounds__(kThreads)
nll_bwd_rows_kernel(const S* __restrict__ hidden, const float* __restrict__ emb,
                    const float* __restrict__ bias, const int* __restrict__ targets,
                    const float* __restrict__ lse, const float* __restrict__ dnll,
                    S* __restrict__ dh, float* __restrict__ dlogits, int D, int T, int V) {
  extern __shared__ float smem[];
  const int tiles = (T + kTT - 1) / kTT;
  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - b * tiles) * kTT;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int dp = D + 1;
  float* h_s = smem;                 // [kTT][D + 1]
  float* logit_s = h_s + kTT * dp;   // [kTT][V]: logits, then dlogits

  const S* hb = hidden + static_cast<size_t>(b) * D * T;
  for (int idx = tid; idx < D * kTT; idx += kThreads) {
    const int d = idx / kTT;
    const int tt = idx - d * kTT;
    const int t = t0 + tt;
    h_s[tt * dp + d] = t < T ? commu::to_f(hb[static_cast<size_t>(d) * T + t]) : 0.f;
  }
  __syncthreads();

  for (int v = warp; v < V; v += kWarps) {
    const float* e = emb + static_cast<size_t>(v) * D;
    float acc[kTT];
#pragma unroll
    for (int tt = 0; tt < kTT; ++tt) acc[tt] = 0.f;
#pragma unroll 4
    for (int d = lane; d < D; d += 32) {
      const float ev = e[d];
#pragma unroll
      for (int tt = 0; tt < kTT; ++tt) acc[tt] = fmaf(ev, h_s[tt * dp + d], acc[tt]);
    }
    float mine = 0.f;
#pragma unroll
    for (int tt = 0; tt < kTT; ++tt) {
      const float total = commu::warp_sum(acc[tt]);
      if (lane == tt) mine = total;
    }
    if (lane < kTT) logit_s[lane * V + v] = mine + bias[v];
  }
  __syncthreads();

  // dlogits in place, and to the [B, V, T] workspace for the batch sums
  for (int idx = tid; idx < kTT * V; idx += kThreads) {
    const int tt = idx / V;
    const int v = idx - tt * V;
    const int t = t0 + tt;
    float dl = 0.f;
    if (t < T) {
      const size_t bt = static_cast<size_t>(b) * T + t;
      const float p = expf(logit_s[idx] - lse[bt]);
      dl = (p - (targets[bt] == v ? 1.f : 0.f)) * dnll[bt];
      dlogits[(static_cast<size_t>(b) * V + v) * T + t] = dl;
    }
    logit_s[idx] = dl;
  }
  __syncthreads();

  for (int d = tid; d < D; d += kThreads) {
    float acc[kTT];
#pragma unroll
    for (int tt = 0; tt < kTT; ++tt) acc[tt] = 0.f;
    for (int v = 0; v < V; ++v) {
      const float ev = emb[static_cast<size_t>(v) * D + d];
#pragma unroll
      for (int tt = 0; tt < kTT; ++tt) acc[tt] = fmaf(ev, logit_s[tt * V + v], acc[tt]);
    }
#pragma unroll
    for (int tt = 0; tt < kTT; ++tt) {
      const int t = t0 + tt;
      if (t < T) dh[(static_cast<size_t>(b) * D + d) * T + t] = commu::from_f<S>(acc[tt]);
    }
  }
}

// operands of the batch sums: dlogits [B, V, T] and the hidden state [B, D, T]
struct DlogitsOp {
  const float* dl;
  int V, T;
  __device__ float operator()(int, int b, int v, int t) const {
    return dl[(static_cast<size_t>(b) * V + v) * T + t];
  }
};

template <typename S>
struct HiddenOp {
  const S* h;
  int D, T;
  __device__ float operator()(int, int b, int d, int t) const {
    return commu::to_f(h[(static_cast<size_t>(b) * D + d) * T + t]);
  }
};

size_t workspace(commu::Workspace& ws, float** dlogits, float** scratch, int B, int D, int T,
                 int V) {
  *dlogits = ws.take<float>(static_cast<size_t>(B) * V * T);
  const size_t red = commu::outer_scratch(1, V, D, B) > commu::rowsum_scratch(1, V, B)
                         ? commu::outer_scratch(1, V, D, B)
                         : commu::rowsum_scratch(1, V, B);
  *scratch = ws.take<float>(red / sizeof(float));
  return ws.used;
}

template <typename S>
int launch(const void* hidden, const void* emb, const void* bias, const void* targets,
           const void* lse, const void* dnll, void* dh, void* demb, void* dbias, void* work,
           int B, int D, int T, int V, cudaStream_t stream) {
  commu::Workspace ws{static_cast<char*>(work), 0};
  float *dlogits, *scratch;
  workspace(ws, &dlogits, &scratch, B, D, T, V);
  const size_t smem = sizeof(float) * static_cast<size_t>(kTT) * (D + 1 + V);
  cudaError_t err = commu::allow_smem(nll_bwd_rows_kernel<S>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (T + kTT - 1) / kTT;
  const S* h = static_cast<const S*>(hidden);
  nll_bwd_rows_kernel<S><<<B * tiles, kThreads, smem, stream>>>(
      h, static_cast<const float*>(emb), static_cast<const float*>(bias),
      static_cast<const int*>(targets), static_cast<const float*>(lse),
      static_cast<const float*>(dnll), static_cast<S*>(dh), dlogits, D, T, V);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const DlogitsOp dl{dlogits, V, T};
  err = commu::reduce_outer(dl, HiddenOp<S>{h, D, T}, static_cast<float*>(demb), scratch, 1, V,
                            D, B, T, stream);
  if (err != cudaSuccess) return err;
  return commu::reduce_rows(dl, static_cast<float*>(dbias), scratch, 1, V, B, T, stream);
}

}  // namespace

extern "C" long long commu_nll_bwd_workspace(int B, int D, int T, int V) {
  commu::Workspace ws{nullptr, 0};
  float *a, *b;
  return static_cast<long long>(workspace(ws, &a, &b, B, D, T, V));
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
