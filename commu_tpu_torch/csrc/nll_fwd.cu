// Tied-embedding logits and per-token NLL, forward.
//
// Replaces: commu_tpu/ops/fused_nll.py::_nll_fwd_kernel (:58, through
//   _row_nll :48), as launched by _nll_fwd_call (:137) from fused_token_nll
//   (:188), and with save=True (:200), which also writes the log-normaliser
//   lse [B, T] (f32) that the backward (nll_bwd.cu) recomputes the
//   probabilities from.
//
// For every batch row b and token t, with h = hidden[b, :, t] (the layer
// stack's [B, D, T] orientation, read as it is: no transpose is copied):
//   logits[v] = emb[v] . h + bias[v]                 (f32, no TF32)
//   nll[b, t] = logsumexp_v(logits) - logits[target[b, t]]
// A target outside [0, V) selects no logit (nll = the log-sum-exp), as the
// reference's one-hot select does.  PAD targets are computed like any other;
// the eval step masks them.
//
// What bounds it on the H100: little.  At the eval shape (B = 10, T = 128,
// D = 500, V = 729) it is 0.93 GFLOP and reads emb [729, 500] f32 (1.46 MB,
// from L2 after the first block) and 2.56 MB of hidden states; the [B, T, V]
// logits (3.7 MB) never reach device memory.
//
// Design: one block per (b, 8 tokens), 8 warps.  The block's hidden tile is
// staged in shared memory as f32 [8][D + 1]; each warp walks its share of
// the vocabulary one row at a time, its lanes splitting D so each emb row is
// read coalesced (unrolled by 4, so four loads are in flight per lane), and
// reduces its 8 partial dots with shuffles.  The logits
// [8][V] stay in shared memory; then one warp per token takes the max, the
// sum of exp and the target's logit.
#include "common.cuh"

#include <float.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTT = 8;  // tokens per block

template <typename S>
__global__ void __launch_bounds__(kThreads)
nll_fwd_kernel(const S* __restrict__ hidden, const float* __restrict__ emb,
               const float* __restrict__ bias, const int* __restrict__ targets,
               float* __restrict__ nll, float* __restrict__ lse, int D, int T, int V) {
  extern __shared__ float smem[];
  const int tiles = (T + kTT - 1) / kTT;
  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - b * tiles) * kTT;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int dp = D + 1;
  float* h_s = smem;             // [kTT][D + 1]
  float* logit_s = h_s + kTT * dp;  // [kTT][V]

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

  for (int tt = warp; tt < kTT; tt += kWarps) {
    const int t = t0 + tt;
    if (t >= T) continue;
    const float* lg = logit_s + tt * V;
    float mx = -FLT_MAX;
    for (int v = lane; v < V; v += 32) mx = fmaxf(mx, lg[v]);
    mx = commu::warp_max(mx);
    float sum = 0.f;
    for (int v = lane; v < V; v += 32) sum += expf(lg[v] - mx);
    sum = commu::warp_sum(sum);
    if (lane == 0) {
      const int tgt = targets[static_cast<size_t>(b) * T + t];
      const float tl = (tgt >= 0 && tgt < V) ? lg[tgt] : 0.f;
      const float norm = mx + logf(sum);
      nll[static_cast<size_t>(b) * T + t] = norm - tl;
      if (lse != nullptr) lse[static_cast<size_t>(b) * T + t] = norm;
    }
  }
}

template <typename S>
int launch(const void* hidden, const void* emb, const void* bias, const void* targets, void* nll,
           void* lse, int B, int D, int T, int V, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(kTT) * (D + 1 + V);
  cudaError_t err = commu::allow_smem(nll_fwd_kernel<S>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (T + kTT - 1) / kTT;
  nll_fwd_kernel<S><<<B * tiles, kThreads, smem, stream>>>(
      static_cast<const S*>(hidden), static_cast<const float*>(emb),
      static_cast<const float*>(bias), static_cast<const int*>(targets),
      static_cast<float*>(nll), static_cast<float*>(lse), D, T, V);
  return cudaGetLastError();
}

}  // namespace

extern "C" int commu_nll_fwd(int dtype, const void* hidden, const void* emb, const void* bias,
                             const void* targets, void* nll, void* lse, int B, int D, int T,
                             int V, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == commu::kFloat32)
    return launch<float>(hidden, emb, bias, targets, nll, lse, B, D, T, V, s);
  if (dtype == commu::kBFloat16)
    return launch<__nv_bfloat16>(hidden, emb, bias, targets, nll, lse, B, D, T, V, s);
  return cudaErrorInvalidValue;
}
