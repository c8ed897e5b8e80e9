// The shared deep sums alone, for the tests that hold them against f64.
//
// Replaces no TPU kernel: reduce.cuh's batch sums (reduce_outer_copy,
// reduce_outer_mma) and mma_tile.cuh's tile (tile_product_kernel) carry the
// weight gradients of #3, #4, #8, #9 and #11 and the products of #5, #7,
// #8, #10 and #11 inside those kernels.  These entry points run each one on
// plain operands, so a test can hold a sum over tens of thousands of terms
// against the same sum in f64 without the rest of a kernel around it.
//   sum_outer_copy / sum_outer_mma: out[m][n] = sum over b < rows, t < len
//     of A[b][m][t] B[b][n][t], A [rows][M][len] and B [rows][N][len] in S
//     (len a multiple of 32 for the copy form), f32 out [M][N].
//   tile_product: out[b][m][t] = sum over k < Kp of A[k][m] X[b][k][t],
//     A [Kp][Mm] (Mm a multiple of 128, Kp a whole number of chunks), X
//     [B][Kp][Tp] (Tp a multiple of 32), f32 out [B][Mm][Tp].
// The workspace queries give the scratch bytes of each (the tile's: its
// second level past the fold depth, 0 below it).
#include "mma_tile.cuh"

namespace {

template <typename S>
struct RowOp {  // element (b, m, t) of a [rows][M][len] operand
  const S* ptr;
  int M, len;
  __device__ float operator()(int, int b, int m, int t) const {
    return commu::to_f(ptr[(static_cast<size_t>(b) * M + m) * len + t]);
  }
};

struct PlainOut {  // the tile's f32 sums as they are
  float* out;  // [B][Mm][Tp]
  int Mm, Tp;
  __device__ __forceinline__ void store(const float (&acc)[4][4][4], int b, int m0, int n0, int,
                                        float*) const {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int wm = warp / 4, wn = warp % 4, g = lane / 4, q = lane % 4;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm * kWM + mi * 16 + g + 8 * half;
        float* dst = out + (static_cast<size_t>(b) * Mm + m) * Tp;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int t = n0 + wn * kWN + ni * 8 + 2 * q + c;
            if (t < Tp) dst[t] = acc[mi][ni][2 * half + c];
          }
      }
  }
};

template <typename S>
int outer_copy(const void* a, const void* b, void* out, void* scratch, int M, int N, int rows,
               int len, cudaStream_t stream) {
  const commu::Rows<S> ra{static_cast<const S*>(a), static_cast<long long>(M) * len, len, len,
                          len};
  const commu::Rows<S> rb{static_cast<const S*>(b), static_cast<long long>(N) * len, len, len,
                          len};
  if (!commu::copyable(ra, rb, len)) return cudaErrorInvalidValue;
  return commu::reduce_outer_copy<S>(ra, rb, static_cast<float*>(out),
                                     static_cast<float*>(scratch), M, N, rows, len, stream);
}

template <typename S>
int outer_mma(const void* a, const void* b, void* out, void* scratch, int M, int N, int rows,
              int len, cudaStream_t stream) {
  return commu::reduce_outer_mma<S>(RowOp<S>{static_cast<const S*>(a), M, len},
                                    RowOp<S>{static_cast<const S*>(b), N, len},
                                    static_cast<float*>(out), static_cast<float*>(scratch), 1,
                                    M, N, rows, len, stream);
}

}  // namespace

extern "C" long long commu_sum_outer_copy_workspace(int M, int N, int rows, int len) {
  return static_cast<long long>(commu::copy_scratch(M, N, rows, len));
}

extern "C" long long commu_sum_outer_mma_workspace(int M, int N, int rows, int len) {
  return static_cast<long long>(commu::outer_scratch(1, M, N, rows, len));
}

extern "C" int commu_sum_outer_copy(int dtype, const void* a, const void* b, void* out,
                                    void* scratch, int M, int N, int rows, int len,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == commu::kFloat32) return outer_copy<float>(a, b, out, scratch, M, N, rows, len, s);
  if (dtype == commu::kBFloat16)
    return outer_copy<__nv_bfloat16>(a, b, out, scratch, M, N, rows, len, s);
  return cudaErrorInvalidValue;
}

extern "C" int commu_sum_outer_mma(int dtype, const void* a, const void* b, void* out,
                                   void* scratch, int M, int N, int rows, int len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == commu::kFloat32) return outer_mma<float>(a, b, out, scratch, M, N, rows, len, s);
  if (dtype == commu::kBFloat16)
    return outer_mma<__nv_bfloat16>(a, b, out, scratch, M, N, rows, len, s);
  return cudaErrorInvalidValue;
}

extern "C" long long commu_tile_product_workspace(int dtype, int Kp, int Mm, int Tp, int B) {
  const size_t floats = dtype == commu::kFloat32 ? tile_deep_floats<float>(Kp, Mm, Tp, B) : 0;
  return static_cast<long long>(floats * sizeof(float));
}

extern "C" int commu_tile_product(int dtype, const void* a, const void* x, void* out,
                                  void* scratch, int Kp, int Mm, int Tp, int B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PlainOut o{static_cast<float*>(out), Mm, Tp};
  if (dtype == commu::kFloat32) {
    if (Mm % kBM || Kp % kDepth<float> || Tp % 32) return cudaErrorInvalidValue;
    return run_tile_product(static_cast<const float*>(a), static_cast<const float*>(x), Kp, Mm,
                            Tp, B, o, static_cast<float*>(scratch), s);
  }
  if (dtype == commu::kBFloat16) {
    if (Mm % kBM || Kp % kDepth<__nv_bfloat16> || Tp % 32) return cudaErrorInvalidValue;
    return run_tile_product(static_cast<const __nv_bfloat16*>(a),
                            static_cast<const __nv_bfloat16*>(x), Kp, Mm, Tp, B, o,
                            static_cast<float*>(nullptr), s);
  }
  return cudaErrorInvalidValue;
}
