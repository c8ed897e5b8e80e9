// The padding that the plain forms of ffn_block_fwd.cu and ffn_block_bwd.cu
// share: the padded extents of their operands and the zero-padded,
// depth-major weight copies that tile_product_kernel (mma_tile.cuh) reads.
// nll_pad.cuh builds on its round_up, kPad and RETURN_ON_ERROR.
// Everything here has internal linkage: each source that includes this file
// compiles its own copy.
#pragma once

#include "mma_tile.cuh"

#define RETURN_ON_ERROR(call)           \
  do {                                  \
    const cudaError_t e_ = (call);      \
    if (e_ != cudaSuccess) return e_;   \
  } while (0)

namespace {

constexpr int kPad = 32;   // T, D and F round up to whole 32s: Tp, Dp, Fp
constexpr int kCols = 32;  // token columns a LayerNorm block takes: one a lane

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The padded extents: Tp, Dp, Fp to whole 32s (whole chunks of the product
// depth and of reduce_outer_copy's t); Dm, Fm to whole 128-row tiles (the
// weight copies' rows, so every weight tile is in bounds).
struct Dims {
  int B, D, F, T, Tp, Dp, Fp, Dm, Fm;
};

inline Dims dims(int B, int D, int F, int T) {
  return Dims{B, D, F, T, round_up(T, kPad), round_up(D, kPad), round_up(F, kPad),
              round_up(D, kBM), round_up(F, kBM)};
}

constexpr int kPadThreads = 256;

// The weights as the products read them, depth-major and zero-padded: wdf
// [Dp][Fm] and wfd [Fp][Dm].  kForward: wdf = W1 and wfd = W2 (the depths
// of h1 = W1^T a_c and f = W2^T h1_d); else wdf = W2^T and wfd = W1^T (of
// dh1 = W2 df_c and da = W1 dh1_c).  W1 is [D][F], W2 [F][D].
template <typename S, bool kForward>
__global__ void __launch_bounds__(kPadThreads)
pad_weights_kernel(const S* __restrict__ w1, const S* __restrict__ w2, S* __restrict__ wdf,
                   S* __restrict__ wfd, Dims z) {
  const long long idx = static_cast<long long>(blockIdx.x) * kPadThreads + threadIdx.x;
  const long long n1 = static_cast<long long>(z.Dp) * z.Fm;
  const S zero = commu::from_f<S>(0.f);
  if (idx < n1) {
    const int d = static_cast<int>(idx / z.Fm), f = static_cast<int>(idx % z.Fm);
    wdf[idx] = d < z.D && f < z.F ? (kForward ? w1[static_cast<size_t>(d) * z.F + f]
                                              : w2[static_cast<size_t>(f) * z.D + d])
                                  : zero;
  } else if (idx < n1 + static_cast<long long>(z.Fp) * z.Dm) {
    const long long j = idx - n1;
    const int f = static_cast<int>(j / z.Dm), d = static_cast<int>(j % z.Dm);
    wfd[j] = f < z.F && d < z.D ? (kForward ? w2[static_cast<size_t>(f) * z.D + d]
                                            : w1[static_cast<size_t>(d) * z.F + f])
                                : zero;
  }
}

template <typename S, bool kForward>
cudaError_t pad_weights(const S* w1, const S* w2, S* wdf, S* wfd, const Dims& z,
                        cudaStream_t stream) {
  const long long cells =
      static_cast<long long>(z.Dp) * z.Fm + static_cast<long long>(z.Fp) * z.Dm;
  pad_weights_kernel<S, kForward>
      <<<static_cast<unsigned>((cells + kPadThreads - 1) / kPadThreads), kPadThreads, 0,
         stream>>>(w1, w2, wdf, wfd, z);
  return cudaGetLastError();
}

}  // namespace
