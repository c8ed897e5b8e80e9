// What the tied-embedding NLL kernels (nll_fwd.cu, nll_bwd.cu) share: the
// padded extents, the zero-padded operand copies that tile_product_kernel
// (mma_tile.cuh) reads, and the product of the logits.
//
// The logits of batch row b are the tile's product
//   logits[v][t] = sum_k A[k][v] X[b][k][t] + bias[v]
// with A a depth-major copy of emb and X the hidden state, both padded with
// zeros (depth D to Dp, rows V to Vp, tokens T to Tp).  The JAX kernel reads
// emb in f32 and casts the hidden state to f32, so every logit is an f32
// product of f32 operands:
//   f32:  A = emb^T [Dp][Vp], X = h [B][Dp][Tp], 3xTF32 (warp_tile<float>).
//   bf16: a bf16 h is exact in bf16, so the product splits only emb:
//         emb = e_hi + e_lo + O(2^-18 |emb|), e_hi = bf16(emb) and e_lo =
//         bf16(emb - e_hi), each product h e exact in f32.  The two halves
//         stack along the depth: A = [e_hi^T; e_lo^T] [2 Dp][Vp], X = [h; h]
//         [B][2 Dp][Tp], so one bf16 pass of depth 2 Dp (warp_tile<bf16>)
//         sums h e_hi + h e_lo.  X takes the bytes an f32 copy would, and
//         the bf16 tile runs at twice the TF32 rate with two passes for
//         3xTF32's three.
// Everything here has internal linkage: each source that includes this file
// compiles its own copy.
#pragma once

#include "ffn_pad.cuh"

namespace {

// how many copies of the depth the logits product stacks: 1 in f32, 2
// (e_hi, e_lo) in bf16
template <typename S>
constexpr int kSplits = sizeof(S) == 4 ? 1 : 2;

// Tp: T rounded up to 32 (whole chunks of reduce_outer_copy's t, whole
// 16-byte copies of the tile); Dp: D to 32 (whole depth chunks); Vp: V to
// whole 128-row tiles (every A tile in bounds); Dm: D to 128 (the rows of
// the dh product's A).
struct NllDims {
  int B, D, T, V, Tp, Dp, Vp, Dm;
  __host__ __device__ int v_tiles() const { return Vp / kBM; }
  __host__ __device__ int t_tiles() const { return (Tp + kBN - 1) / kBN; }
};

inline NllDims nll_dims(int B, int D, int T, int V) {
  return NllDims{B, D, T, V, round_up(T, kPad), round_up(D, kPad), round_up(V, kBM),
                 round_up(D, kBM)};
}

constexpr int kPadWarps = 8;

// The operand copies, one warp a row (lanes along it, coalesced where the
// source row is contiguous), rows in three runs:
//   x  [B][kSplits Dp][Tp] (S):    x[b][s Dp + d][t] = h[b][d][t];
//   al [kSplits Dp][Vp] (S):       al[d][v] = e_hi, al[Dp + d][v] = e_lo
//                                  (f32: al[d][v] = emb[v][d]);
//   ad [Vp][Dm] (f32, or null):    ad[v][d] = emb[v][d], the dh product's A;
// zeros outside D, T and V.
template <typename S>
__global__ void __launch_bounds__(kPadWarps * 32)
nll_pad_kernel(const S* __restrict__ hidden, const float* __restrict__ emb, S* __restrict__ x,
               S* __restrict__ al, float* __restrict__ ad, NllDims z) {
  const int lane = threadIdx.x % 32;
  const int kl = kSplits<S> * z.Dp;
  const long long x_rows = static_cast<long long>(z.B) * kl;
  const long long rows = x_rows + kl + (ad != nullptr ? z.Vp : 0);
  const S zero = commu::from_f<S>(0.f);
  for (long long r = static_cast<long long>(blockIdx.x) * kPadWarps + threadIdx.x / 32; r < rows;
       r += static_cast<long long>(gridDim.x) * kPadWarps) {
    if (r < x_rows) {
      const int b = static_cast<int>(r / kl), d = static_cast<int>(r % kl) % z.Dp;
      const S* src = hidden + (static_cast<size_t>(b) * z.D + d) * z.T;
      S* dst = x + static_cast<size_t>(r) * z.Tp;
      for (int t = lane; t < z.Tp; t += 32) dst[t] = d < z.D && t < z.T ? src[t] : zero;
    } else if (r < x_rows + kl) {
      const int k = static_cast<int>(r - x_rows), d = k % z.Dp;
      const bool lo = k >= z.Dp;
      S* dst = al + static_cast<size_t>(k) * z.Vp;
      for (int v = lane; v < z.Vp; v += 32) {
        const float e = d < z.D && v < z.V ? emb[static_cast<size_t>(v) * z.D + d] : 0.f;
        const S hi = commu::from_f<S>(e);
        dst[v] = lo ? commu::from_f<S>(e - commu::to_f(hi)) : hi;
      }
    } else {
      const int v = static_cast<int>(r - x_rows - kl);
      float* dst = ad + static_cast<size_t>(v) * z.Dm;
      for (int d = lane; d < z.Dm; d += 32)
        dst[d] = v < z.V && d < z.D ? emb[static_cast<size_t>(v) * z.D + d] : 0.f;
    }
  }
}

template <typename S>
cudaError_t nll_pad(const S* hidden, const float* emb, S* x, S* al, float* ad, const NllDims& z,
                    cudaStream_t stream) {
  const long long rows = static_cast<long long>(z.B + 1) * kSplits<S> * z.Dp +
                         (ad != nullptr ? z.Vp : 0);
  const long long want = (rows + kPadWarps - 1) / kPadWarps;
  const unsigned blocks = static_cast<unsigned>(want < 132 * 16 ? want : 132 * 16);
  nll_pad_kernel<S><<<blocks, kPadWarps * 32, 0, stream>>>(hidden, emb, x, al, ad, z);
  return cudaGetLastError();
}

// the logits product of every batch row, with the epilogue ``out``
template <typename S, class Out>
cudaError_t run_logits(const S* al, const S* x, const NllDims& z, const Out& out,
                       cudaStream_t stream) {
  return run_tile_product(al, x, kSplits<S> * z.Dp, z.Vp, z.Tp, z.B, out, stream);
}

// The (column, row) coordinates of a thread's accumulators in the tile
// (mma_tile.cuh): acc[mi][ni][2 half + c] is row wm 64 + mi 16 + g + 8 half,
// column wn 32 + ni 8 + 2q + c of the block's 128 x 128 tile.
struct Frag {
  int wm, wn, g, q;
  __device__ __forceinline__ Frag() {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    wm = warp / 4, wn = warp % 4, g = lane / 4, q = lane % 4;
  }
  __device__ __forceinline__ int row(int mi, int half) const {
    return wm * kWM + mi * 16 + g + 8 * half;
  }
  __device__ __forceinline__ int col(int ni, int c) const { return wn * kWN + ni * 8 + 2 * q + c; }
};

}  // namespace
