// The padding that ffn_block_fwd.cu and ffn_block_bwd.cu share: the padded
// extents of their operands and the zero-padded, depth-major copies that
// tile_product_kernel (mma_tile.cuh) reads.
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

// The padded extents: Tp, Dp, Fp, HDp to whole 32s (whole chunks of the
// product depth and of reduce_outer_copy's t); Dm, Fm, HDm to whole 128-row
// tiles (the weight copies' rows, so every weight tile is in bounds).  HD:
// the rows of Wo in the fuse_o form, 0 in the plain form.
struct Dims {
  int B, D, F, T, Tp, Dp, Fp, Dm, Fm, HD, HDp, HDm;
};

inline Dims dims(int B, int D, int F, int T, int HD = 0) {
  return Dims{B, D, F, T, round_up(T, kPad), round_up(D, kPad), round_up(F, kPad),
              round_up(D, kBM), round_up(F, kBM), HD, round_up(HD, kPad), round_up(HD, kBM)};
}

constexpr int kPadThreads = 256;

// dst [N][Rp][Cp], zero-padded: element (n, i, j) is src's (n, i, j) for i
// < R and j < C, with src [N][R][C], or (kTranspose) src's (n, j, i), with
// src [N][C][R]; else 0.  The weights as the products read them,
// depth-major, once a call: W1 [D][F] and W2 [F][D] as they lie for the
// forward's h1 = W1^T a_c and f = W2^T h1_d, transposed for the backward's
// dh1 = W2 df_c and da = W1 dh1_c; Wo, and the fuse_o form's padded vec.
template <typename S, bool kTranspose>
__global__ void __launch_bounds__(kPadThreads)
pad_matrix_kernel(const S* __restrict__ src, S* __restrict__ dst, int R, int C, int Rp, int Cp,
                  long long cells) {
  const long long idx = static_cast<long long>(blockIdx.x) * kPadThreads + threadIdx.x;
  if (idx >= cells) return;
  const int j = static_cast<int>(idx % Cp);
  const long long rest = idx / Cp;
  const int i = static_cast<int>(rest % Rp);
  const long long n = rest / Rp;
  S val = commu::from_f<S>(0.f);
  if (i < R && j < C)
    val = src[kTranspose ? (n * C + j) * R + i : (n * R + i) * C + j];
  dst[idx] = val;
}

template <typename S, bool kTranspose>
cudaError_t pad_matrix(const S* src, S* dst, int N, int R, int C, int Rp, int Cp,
                       cudaStream_t stream) {
  const long long cells = static_cast<long long>(N) * Rp * Cp;
  pad_matrix_kernel<S, kTranspose>
      <<<static_cast<unsigned>((cells + kPadThreads - 1) / kPadThreads), kPadThreads, 0,
         stream>>>(src, dst, R, C, Rp, Cp, cells);
  return cudaGetLastError();
}

}  // namespace
