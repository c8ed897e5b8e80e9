// Gradient of the scaled token-embedding lookup.
//
// Replaces: commu_tpu/ops/embed.py::_embed_grad_kernel (:27), as launched by
//   _embed_grad (:48, pallas_call :57) from embed_bdt's backward (:80).
//
//   demb[v, :] = scale * sum over (b, t) with tokens[b, t] == v of g[b, :, t]
//
// g [B, D, T] is the cotangent of the [B, D, T] embedding output, in the
// compute dtype; demb [V, D] is f32.  PAD input tokens count like any other.
// The reference computes it as a one-hot [V, T] x [T, D] product per row,
// accumulated in f32 across the batch; the same sums are formed here.
//
// What bounds it on the H100: memory.  At the training shape (B = 256,
// T = 128, D = 500, V = 729) every g value is read once (65.5 MB in f32) and
// every token is read once per vocabulary block (729 x 128 KB, from L2); a
// one-hot product would spend 12 GFLOP on zeros.
//
// Design: one block per vocabulary entry v, 256 threads.  The block walks the
// tokens in chunks of 256 and compacts the positions holding v into a list in
// shared memory, in token order (a warp ballot and a prefix over the warps),
// then every thread adds g[b, d, t] over the list for its features d.  The
// sum runs in token order whatever the launch order: no atomics, the same
// bits every run.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename S>
__global__ void __launch_bounds__(kThreads)
embed_grad_kernel(const int* __restrict__ tokens, const S* __restrict__ g,
                  float* __restrict__ demb, int N, int D, int T, float scale) {
  __shared__ int hits[kThreads];
  __shared__ int warp_hits[kWarps];
  const int v = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  constexpr int kPerThread = 4;  // features per thread (D <= 1024)
  float acc[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) acc[e] = 0.f;

  for (int n0 = 0; n0 < N; n0 += kThreads) {
    const int n = n0 + tid;
    const bool hit = n < N && tokens[n] == v;
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_hits[w] : 0;
      total += warp_hits[w];
    }
    if (hit) hits[before + __popc(ballot & ((1u << lane) - 1u))] = n;
    __syncthreads();
    for (int k = 0; k < total; ++k) {
      const int pos = hits[k];
      const int b = pos / T;
      const S* gb = g + static_cast<size_t>(b) * D * T + (pos - b * T);
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) {
        const int d = tid + kThreads * e;
        if (d < D) acc[e] += commu::to_f(gb[static_cast<size_t>(d) * T]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int d = tid + kThreads * e;
    if (d < D) demb[static_cast<size_t>(v) * D + d] = acc[e] * scale;
  }
}

template <typename S>
int launch(const void* tokens, const void* g, void* demb, int B, int D, int T, int V, float scale,
           cudaStream_t stream) {
  if (D > 4 * kThreads) return cudaErrorInvalidValue;
  embed_grad_kernel<S><<<V, kThreads, 0, stream>>>(
      static_cast<const int*>(tokens), static_cast<const S*>(g), static_cast<float*>(demb),
      B * T, D, T, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int commu_embed_grad(int dtype, const void* tokens, const void* g, void* demb, int B,
                                int D, int T, int V, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == commu::kFloat32) return launch<float>(tokens, g, demb, B, D, T, V, scale, s);
  if (dtype == commu::kBFloat16)
    return launch<__nv_bfloat16>(tokens, g, demb, B, D, T, V, scale, s);
  return cudaErrorInvalidValue;
}
