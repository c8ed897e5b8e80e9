// Tied-embedding logits and per-token NLL, forward.
//
// Replaces: commu_tpu/ops/fused_nll.py::_nll_fwd_kernel (:58, through
//   _row_nll :48), as launched by _nll_fwd_call (:137) from fused_token_nll
//   (:188), and with save=True (:200), which also writes the log-normaliser
//   lse [B, T] (f32) that the backward (nll_bwd.cu) recomputes the
//   probabilities from.
//
// For every batch row b and token t, with h = hidden[b, :, t] (the layer
// stack's [B, D, T] orientation):
//   logits[v] = emb[v] . h + bias[v]                 (f32 products)
//   nll[b, t] = logsumexp_v(logits) - logits[target[b, t]]
// A target outside [0, V) selects no logit (nll = the log-sum-exp), as the
// reference's one-hot select does.  PAD targets are computed like any other;
// the eval step masks them.
//
// What bounds it on the H100: tensor-core arithmetic.  At the training shape
// (B = 256, T = 128, D = 500, V = 729) the logits are 2 B T D V = 23.9
// GFLOP, 0.145 ms at the dense TF32 rate with the three passes of 3xTF32
// counted (f32); the bytes (hidden 65.5 MB in f32, emb 1.46 MB) take 0.02
// ms.  The [B, T, V] logits (95.6 MB) never reach device memory.
//
// Design, three launches (every product on mma.sync: 3xTF32 in f32, a
// split emb on bf16 in bf16; nll_pad.cuh):
//   (1) nll_pad: the hidden state and emb into zero-padded copies that the
//       tile reads by 16-byte cp.async (x [B][Dp][Tp], emb depth-major);
//   (2) tile_product_kernel (mma_tile.cuh): the logits of each batch row in
//       128-vocabulary x 128-token tiles; the epilogue adds the bias and
//       reduces each token column of the tile to its maximum and the sum of
//       exp(logit - maximum) over the tile's real rows (v < V: padded rows
//       count for nothing), in a fixed order (a thread's 8 rows, the 8
//       lanes of its column by shuffles, the two warps down), into
//       per-tile partials [B][V tiles][Tp]; the one thread that holds a
//       token's target logit writes it;
//   (3) nll_finish_kernel: a thread a token merges its V / 128 partials in
//       index order, lse = m + log(sum), nll = lse - target logit.
// No float atomics: two runs on the same inputs give the same bits.  No
// [V]-long row lives in shared memory, so V and D are bounded only by the
// workspace.
#include "nll_pad.cuh"

#include <float.h>
#include <math.h>

namespace {

// The epilogue of (2): per (b, vocabulary tile, token column) the maximum
// and the sum of exponentials over the tile's real rows; the target's logit.
struct FwdOut {
  const float* bias;
  const int* targets;  // [B][T]
  float* part_m;       // [B][V tiles][Tp]
  float* part_s;       // [B][V tiles][Tp]
  float* picked;       // [B][T]: the target's logit, where it is in [0, V)
  NllDims z;

  __device__ __forceinline__ void store(const float (&acc)[4][4][4], int b, int m0, int n0, int,
                                        float* red) const {
    const Frag f;
    float bias_r[4][2];
    bool live[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int v = m0 + f.row(mi, half);
        live[mi][half] = v < z.V;
        bias_r[mi][half] = v < z.V ? bias[v] : 0.f;
      }
    float* red_m = red;            // [2][kBN]: each warp row's column maxima
    float* red_s = red + 2 * kBN;  // [2][kBN]: and sums
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = f.col(ni, c), t = n0 + col;
        const int tgt = t < z.T ? targets[static_cast<size_t>(b) * z.T + t] : -1;
        float mx = -FLT_MAX;
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            if (!live[mi][half]) continue;
            const float logit = acc[mi][ni][2 * half + c] + bias_r[mi][half];
            mx = fmaxf(mx, logit);
            if (m0 + f.row(mi, half) == tgt) picked[static_cast<size_t>(b) * z.T + t] = logit;
          }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        float sum = 0.f;
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            if (live[mi][half]) sum += expf(acc[mi][ni][2 * half + c] + bias_r[mi][half] - mx);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (f.g == 0) {
          red_m[f.wm * kBN + col] = mx;
          red_s[f.wm * kBN + col] = sum;
        }
      }
    __syncthreads();
    const int col = threadIdx.x;
    if (col < kBN && n0 + col < z.Tp) {
      const float m_a = red_m[col], m_b = red_m[kBN + col];
      const float mx = fmaxf(m_a, m_b);
      const size_t at = (static_cast<size_t>(b) * z.v_tiles() + m0 / kBM) * z.Tp + n0 + col;
      part_m[at] = mx;
      part_s[at] = red_s[col] * expf(m_a - mx) + red_s[kBN + col] * expf(m_b - mx);
    }
  }
};

// (3) one thread a token: the V tiles' partials merged in index order
__global__ void __launch_bounds__(256)
nll_finish_kernel(const float* __restrict__ part_m, const float* __restrict__ part_s,
                  const float* __restrict__ picked, const int* __restrict__ targets,
                  float* __restrict__ nll, float* __restrict__ lse, NllDims z) {
  const long long idx = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (idx >= static_cast<long long>(z.B) * z.T) return;
  const int b = static_cast<int>(idx / z.T), t = static_cast<int>(idx % z.T);
  const int tiles = z.v_tiles();
  const size_t base = static_cast<size_t>(b) * tiles * z.Tp + t;
  float mx = -FLT_MAX;
  for (int j = 0; j < tiles; ++j) mx = fmaxf(mx, part_m[base + static_cast<size_t>(j) * z.Tp]);
  float sum = 0.f;
  for (int j = 0; j < tiles; ++j) {
    const size_t at = base + static_cast<size_t>(j) * z.Tp;
    sum += part_s[at] * expf(part_m[at] - mx);
  }
  const float norm = mx + logf(sum);
  const int tgt = targets[idx];
  nll[idx] = norm - (tgt >= 0 && tgt < z.V ? picked[idx] : 0.f);
  if (lse != nullptr) lse[idx] = norm;
}

template <typename S>
struct Buffers {
  S *x, *al;
  float *part_m, *part_s, *picked;
};

template <typename S>
size_t workspace(commu::Workspace& ws, Buffers<S>* buf, const NllDims& z) {
  const size_t kl = static_cast<size_t>(kSplits<S>) * z.Dp;
  const size_t parts = static_cast<size_t>(z.B) * z.v_tiles() * z.Tp;
  buf->x = ws.take<S>(static_cast<size_t>(z.B) * kl * z.Tp);
  buf->al = ws.take<S>(kl * z.Vp);
  buf->part_m = ws.take<float>(parts);
  buf->part_s = ws.take<float>(parts);
  buf->picked = ws.take<float>(static_cast<size_t>(z.B) * z.T);
  return ws.used;
}

template <typename S>
int launch(const void* hidden, const void* emb, const void* bias, const void* targets, void* nll,
           void* lse, void* work, int B, int D, int T, int V, cudaStream_t stream) {
  if (B < 1 || D < 1 || T < 1 || V < 1) return cudaErrorInvalidValue;
  const NllDims z = nll_dims(B, D, T, V);
  commu::Workspace ws{static_cast<char*>(work), 0};
  Buffers<S> buf;
  workspace(ws, &buf, z);
  const int* tgt = static_cast<const int*>(targets);
  RETURN_ON_ERROR(nll_pad(static_cast<const S*>(hidden), static_cast<const float*>(emb), buf.x,
                          buf.al, static_cast<float*>(nullptr), z, stream));
  static_assert(tile_product_smem<S>() >= sizeof(float) * 4 * kBN, "the merge reuses the ring");
  RETURN_ON_ERROR(run_logits(
      buf.al, buf.x, z,
      FwdOut{static_cast<const float*>(bias), tgt, buf.part_m, buf.part_s, buf.picked, z},
      stream));
  const long long tokens = static_cast<long long>(B) * T;
  nll_finish_kernel<<<static_cast<unsigned>((tokens + 255) / 256), 256, 0, stream>>>(
      buf.part_m, buf.part_s, buf.picked, tgt, static_cast<float*>(nll),
      static_cast<float*>(lse), z);
  return cudaGetLastError();
}

}  // namespace

extern "C" long long commu_nll_fwd_workspace(int B, int D, int T, int V) {
  // the f32 and bf16 copies take the same bytes: bf16 stacks two copies of
  // the depth
  commu::Workspace ws{nullptr, 0};
  Buffers<float> buf;
  return static_cast<long long>(workspace(ws, &buf, nll_dims(B, D, T, V)));
}

// lse: null without save; work: commu_nll_fwd_workspace bytes
extern "C" int commu_nll_fwd(int dtype, const void* hidden, const void* emb, const void* bias,
                             const void* targets, void* nll, void* lse, void* work, int B, int D,
                             int T, int V, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == commu::kFloat32)
    return launch<float>(hidden, emb, bias, targets, nll, lse, work, B, D, T, V, s);
  if (dtype == commu::kBFloat16)
    return launch<__nv_bfloat16>(hidden, emb, bias, targets, nll, lse, work, B, D, T, V, s);
  return cudaErrorInvalidValue;
}
