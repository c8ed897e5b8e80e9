// Fused post-attention block forward, with the block's three dropouts in
// training.
//
// Replaces: commu_tpu/ops/fused_ffn.py::_ffn_fwd_kernel (:120), as launched
//   by _ffn_fwd_call (:352) for ffn_block (:446) with save=False, and for its
//   VJP forward (:457) with save=True: then it also writes what the backward
//   (ffn_block_bwd.cu) reads, as :367-375 does: the normalised LN inputs
//   norm1 = (z1 - mean) rstd1 and norm2 (in S), the post-relu h1 (in S) and
//   the rstds [B, 2, T] (f32).  With ``wo`` it is the fuse_o form of the same
//   kernel (:122-127, :145-148), as ffn_block_fused_o (:482) launches it:
//   ``o`` is then the attention vector before its output projection,
//   vec [B, HD, T], and the kernel forms o = Wo^T vec itself (Wo [HD, D]).
//   That o stays f32 until mask O and the residual, where the unfused path's
//   o was rounded to S by the projection outside.
//
// Per token column t of a batch row (x, o: [B, D, T], feature-major):
//   z1 = x + o;  a = LN1(z1)                  (f32, fast variance, eps 1e-5)
//   h1 = relu(W1^T a_c + b1)                  (a_c = a rounded to S)
//   f  = W2^T h1_c + b2;  y = LN2(a + f)      (residual uses a in f32)
// With dropout (thresh > 0; :151-153, :165-174, :178-180) three masks apply, the
// planes [D, T], [F, T], [D, T] of row b seeded with seed + b * 8192 + salt *
// 2048, salts O = 0, H = 1, F = 2 (prng.cuh): o is dropped before the first
// residual, h1 after the ReLU (the dropped h1 rounded to S feeds W2), f
// before the second residual.  The saved h1 then carries mask H in its sign
// (h1 kept, -h1 dropped), as the reference's does, so the backward never
// recomputes that mask.
//
// What bounds it on the H100: on the serving path T = 11, so the two
// products are matrix-vector shaped (2 x D x F x T = 11 MFLOP per row) and
// the kernel is bound by reading W1 and W2 (D x F each, 2 MB at f32) from
// L2 once per block, plus launch latency.
//
// Design: one block per (batch row, tile of 4 tokens), 256 threads.  The
// tile's z, a and h1 live in shared memory (32 KB at D = 500, F = 1000).
// Each thread owns one hidden unit (first product) or one output feature
// (second product) and keeps the tile's 4 accumulators in registers, so
// every weight element is loaded once per block, coalesced across threads.
// LayerNorm statistics are one warp per token.  All accumulation is f32.
// The fuse_o product is a third one of the same shape (one output feature a
// thread, Wo read once per block, coalesced), over the tile's vec staged in
// the shared memory that h1 takes later.
#include "common.cuh"
#include "prng.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTok = 4;  // token columns per block
constexpr int kSaltO = 0, kSaltH = 1, kSaltF = 2;
constexpr float kEps = 1e-5f;

// mean and 1/std of each token row of z [kTok][D] (fast variance, as
// flax's LayerNorm and the reference kernel's _ln_fwd); rows past the end
// of the sequence are zeros and get finite statistics
__device__ void ln_stats(const float* z, int D, float* mean, float* rstd) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp < kTok) {
    const float* zr = z + warp * D;
    float s = 0.f, sq = 0.f;
    for (int d = lane; d < D; d += 32) {
      s += zr[d];
      sq = fmaf(zr[d], zr[d], sq);
    }
    s = commu::warp_sum(s);
    sq = commu::warp_sum(sq);
    if (lane == 0) {
      const float m = s * (1.f / D);
      const float var = fmaxf(sq * (1.f / D) - m * m, 0.f);
      mean[warp] = m;
      rstd[warp] = 1.f / sqrtf(var + kEps);
    }
  }
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
ffn_block_fwd_kernel(const S* __restrict__ x, const S* __restrict__ o,
                     const S* __restrict__ wo, const S* __restrict__ w1, const float* __restrict__ b1,
                     const S* __restrict__ w2, const float* __restrict__ b2,
                     const float* __restrict__ g1, const float* __restrict__ be1,
                     const float* __restrict__ g2, const float* __restrict__ be2,
                     S* __restrict__ y, S* __restrict__ norm1_out, S* __restrict__ norm2_out,
                     S* __restrict__ h1_out, float* __restrict__ stats, int D, int F, int T,
                     int HD, int seed, commu::Plane plane_d, commu::Plane plane_f) {
  extern __shared__ float smem[];
  __shared__ float mean[kTok], rstd[kTok];
  float* z = smem;            // [kTok][D]: z1, later z2
  float* a = z + kTok * D;    // [kTok][D]: LN1 output, f32
  float* h = a + kTok * D;    // [kTok][F]: relu(W1^T a_c + b1) rounded to S
  float* vec = h;             // [kTok][HD]: the tile's attention vector (fuse_o), before h
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kTok;
  const int nt = min(kTok, T - t0);
  const size_t base = static_cast<size_t>(blockIdx.y) * D * T;
  // plane_d and plane_f share thresh and the scale; they differ in their rows
  const bool drop = plane_d.thresh > 0;
  const float keep_scale = plane_d.scale;
  const uint32_t seed_o = commu::plane_seed(seed, blockIdx.y, 8192, kSaltO * 2048);
  const uint32_t seed_h = commu::plane_seed(seed, blockIdx.y, 8192, kSaltH * 2048);
  const uint32_t seed_f = commu::plane_seed(seed, blockIdx.y, 8192, kSaltF * 2048);

  if (wo != nullptr) {
    // o = Wo^T vec in f32, then mask O and the residual
    const size_t base_v = static_cast<size_t>(blockIdx.y) * HD * T;
    for (int idx = tid; idx < kTok * HD; idx += kThreads) {
      const int r = idx / HD;
      const int c = idx - r * HD;
      vec[idx] = r < nt ? commu::to_f(o[base_v + static_cast<size_t>(c) * T + t0 + r]) : 0.f;
    }
    __syncthreads();
    for (int d = tid; d < D; d += kThreads) {
      float acc[kTok];
#pragma unroll
      for (int r = 0; r < kTok; ++r) acc[r] = 0.f;
      for (int c = 0; c < HD; ++c) {
        const float w = commu::to_f(wo[static_cast<size_t>(c) * D + d]);
#pragma unroll
        for (int r = 0; r < kTok; ++r) acc[r] = fmaf(w, vec[r * HD + c], acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kTok; ++r) {
        float v = 0.f;
        if (r < nt) {
          float ov = acc[r];
          if (drop) ov = commu::keep(plane_d, seed_o, d, t0 + r) ? ov * keep_scale : 0.f;
          v = commu::to_f(x[base + static_cast<size_t>(d) * T + t0 + r]) + ov;
        }
        z[r * D + d] = v;
      }
    }
  } else {
    for (int idx = tid; idx < kTok * D; idx += kThreads) {
      const int r = idx / D;
      const int d = idx - r * D;
      float v = 0.f;
      if (r < nt) {
        const size_t at = base + static_cast<size_t>(d) * T + t0 + r;
        float ov = commu::to_f(o[at]);
        if (drop) ov = commu::keep(plane_d, seed_o, d, t0 + r) ? ov * keep_scale : 0.f;
        v = commu::to_f(x[at]) + ov;
      }
      z[idx] = v;
    }
  }
  __syncthreads();
  ln_stats(z, D, mean, rstd);
  __syncthreads();
  for (int idx = tid; idx < kTok * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const float norm = (z[idx] - mean[r]) * rstd[r];
    a[idx] = norm * g1[d] + be1[d];
    if (norm1_out != nullptr && r < nt)
      norm1_out[base + static_cast<size_t>(d) * T + t0 + r] = commu::from_f<S>(norm);
  }
  if (stats != nullptr && tid < nt)
    stats[(static_cast<size_t>(blockIdx.y) * 2) * T + t0 + tid] = rstd[tid];
  __syncthreads();

  for (int f = tid; f < F; f += kThreads) {
    float acc[kTok];
#pragma unroll
    for (int r = 0; r < kTok; ++r) acc[r] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float w = commu::to_f(w1[static_cast<size_t>(d) * F + f]);
#pragma unroll
      for (int r = 0; r < kTok; ++r) acc[r] = fmaf(w, commu::rnd<S>(a[r * D + d]), acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kTok; ++r) {
      const float hv = fmaxf(acc[r] + b1[f], 0.f);
      const bool kept = !drop || r >= nt || commu::keep(plane_f, seed_h, f, t0 + r);
      h[r * F + f] = commu::rnd<S>(kept ? hv * keep_scale : 0.f);
      if (h1_out != nullptr && r < nt)
        h1_out[static_cast<size_t>(blockIdx.y) * F * T + static_cast<size_t>(f) * T + t0 + r] =
            commu::from_f<S>(kept ? hv : -hv);
    }
  }
  __syncthreads();

  for (int d = tid; d < D; d += kThreads) {
    float acc[kTok];
#pragma unroll
    for (int r = 0; r < kTok; ++r) acc[r] = 0.f;
    for (int fi = 0; fi < F; ++fi) {
      const float w = commu::to_f(w2[static_cast<size_t>(fi) * D + d]);
#pragma unroll
      for (int r = 0; r < kTok; ++r) acc[r] = fmaf(w, h[r * F + fi], acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kTok; ++r) {
      float fv = acc[r] + b2[d];
      if (drop && r < nt) fv = commu::keep(plane_d, seed_f, d, t0 + r) ? fv * keep_scale : 0.f;
      z[r * D + d] = a[r * D + d] + fv;
    }
  }
  __syncthreads();
  ln_stats(z, D, mean, rstd);
  __syncthreads();
  for (int idx = tid; idx < kTok * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    if (r < nt) {
      const float norm = (z[idx] - mean[r]) * rstd[r];
      y[base + static_cast<size_t>(d) * T + t0 + r] = commu::from_f<S>(norm * g2[d] + be2[d]);
      if (norm2_out != nullptr)
        norm2_out[base + static_cast<size_t>(d) * T + t0 + r] = commu::from_f<S>(norm);
    }
  }
  if (stats != nullptr && tid < nt)
    stats[(static_cast<size_t>(blockIdx.y) * 2 + 1) * T + t0 + tid] = rstd[tid];
}

template <typename S>
int launch(const void* x, const void* o, const void* wo, const void* w1, const void* b1,
           const void* w2, const void* b2, const void* g1, const void* be1, const void* g2,
           const void* be2, void* y, void* norm1, void* norm2, void* h1, void* stats, int B, int D,
           int F, int T, int HD, int seed, int thresh, float keep_scale, int bits, cudaStream_t stream) {
  if (wo != nullptr && HD < 1) return cudaErrorInvalidValue;
  const int wide = wo != nullptr && HD > F ? HD : F;  // vec shares h's shared memory
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(kTok) * D + kTok * wide);
  cudaError_t err = commu::allow_smem(ffn_block_fwd_kernel<S>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kTok - 1) / kTok, B);
  ffn_block_fwd_kernel<S><<<grid, kThreads, smem, stream>>>(
      static_cast<const S*>(x), static_cast<const S*>(o), static_cast<const S*>(wo),
      static_cast<const S*>(w1),
      static_cast<const float*>(b1), static_cast<const S*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(g1), static_cast<const float*>(be1),
      static_cast<const float*>(g2), static_cast<const float*>(be2), static_cast<S*>(y),
      static_cast<S*>(norm1), static_cast<S*>(norm2), static_cast<S*>(h1),
      static_cast<float*>(stats), D, F, T, HD, seed, commu::make_plane(D, T, thresh, keep_scale, bits),
      commu::make_plane(F, T, thresh, keep_scale, bits));
  return cudaGetLastError();
}

}  // namespace

// wo: null for the plain form (o [B, D, T]); else Wo [HD, D], and o is the
// attention vector [B, HD, T]
extern "C" int commu_ffn_block_fwd(int dtype, const void* x, const void* o, const void* wo,
                                   const void* w1, const void* b1, const void* w2,
                                   const void* b2, const void* g1, const void* be1,
                                   const void* g2, const void* be2, void* y, void* norm1,
                                   void* norm2, void* h1, void* stats, int B, int D, int F, int T,
                                   int HD, int seed, int thresh, float keep_scale, int bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == commu::kFloat32)
    return launch<float>(x, o, wo, w1, b1, w2, b2, g1, be1, g2, be2, y, norm1, norm2, h1, stats,
                         B, D, F, T, HD, seed, thresh, keep_scale, bits, s);
  if (dtype == commu::kBFloat16)
    return launch<__nv_bfloat16>(x, o, wo, w1, b1, w2, b2, g1, be1, g2, be2, y, norm1, norm2,
                                 h1, stats, B, D, F, T, HD, seed, thresh, keep_scale, bits, s);
  return cudaErrorInvalidValue;
}
