// The shared deep sums alone, for the tests that hold them against f64.
//
// Replaces no TPU kernel: reduce.cuh's batch sums (reduce_outer_copy,
// reduce_outer_mma), mma_tile.cuh's tile (tile_product_kernel) and
// wgmma_product.cuh's warpgroup product carry the weight gradients of #3,
// #4, #8, #9 and #11 and the products of #5, #7, #8, #10 and #11 inside
// those kernels.  These entry points run each one on plain operands, so a
// test can hold a sum over tens of thousands of terms against the same sum
// in f64 without the rest of a kernel around it, and hold the warpgroup
// product against the mma.sync tile bit for bit.
//   sum_outer_copy / sum_outer_mma: out[m][n] = sum over b < rows, t < len
//     of A[b][m][t] B[b][n][t], A [rows][M][len] and B [rows][N][len] in S
//     (len a multiple of 32 for the copy form), f32 out [M][N].
//   sum_outer_wg: the same on the warpgroup product (#4's dWk / dWv form),
//     A in f32 (rounded to bf16 on load where S is bf16), B in S, len a
//     multiple of 32; ``parts`` (1 or 2) such sums over one B in one
//     launch, A [parts][rows][M][len] and out [parts][M][N], as #4 takes
//     dk and dv.
//   tile_product: out[b][m][t] = sum over k < Kp of A[k][m] X[b][k][t],
//     A [Kp][Mm] (Mm a multiple of 128, Kp a whole number of chunks), X
//     [B][Kp][Tp] (Tp a multiple of 32), f32 out [B][Mm][Tp].
//   kv_product: the same on the warpgroup product (#5's form), any Kp, Mm
//     and Tp, its sums written in f32.
// The workspace queries give the scratch bytes of each (the tile's: its
// second level past the fold depth, 0 below it; the warpgroup product's:
// its weight copy, or its partial sums).
#include "mma_tile.cuh"
#include "wgmma_product.cuh"

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

template <typename S>
int outer_wg(const void* a, const void* b, void* out, void* scratch, int M, int N, int rows,
             int len, int parts, cudaStream_t stream) {
  const float* af = static_cast<const float*>(a);
  float* o = static_cast<float*>(out);
  const size_t part = parts > 1 ? static_cast<size_t>(rows) * M * len : 0;
  return wg::run_dw_sums<S>(af, af + part, parts, static_cast<const S*>(b),
                            static_cast<long long>(N) * len,
                            static_cast<long long>(N) * len * rows, o,
                            o + (parts > 1 ? static_cast<size_t>(M) * N : 0),
                            static_cast<float*>(scratch), M, N, rows, len, len, stream);
}

template <typename S>
int kv_product(const void* a, const void* x, void* out, void* scratch, int Kp, int Mm, int Tp,
               int B, cudaStream_t stream) {
  const S* w = static_cast<const S*>(a);
  float* o = static_cast<float*>(out);
  return wg::run_kv_product<S, float>(static_cast<const S*>(x), w, w, o, o, scratch, 1, B, Kp, Tp,
                                      Mm, Mm, stream);
}

}  // namespace

extern "C" long long commu_sum_outer_wg_workspace(int M, int N, int rows, int len, int parts) {
  return static_cast<long long>(wg::sums_scratch(parts, M, N, rows, len));
}

extern "C" int commu_sum_outer_wg(int dtype, const void* a, const void* b, void* out,
                                  void* scratch, int M, int N, int rows, int len, int parts,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == commu::kFloat32)
    return outer_wg<float>(a, b, out, scratch, M, N, rows, len, parts, s);
  if (dtype == commu::kBFloat16)
    return outer_wg<__nv_bfloat16>(a, b, out, scratch, M, N, rows, len, parts, s);
  return cudaErrorInvalidValue;
}

extern "C" long long commu_kv_product_workspace(int dtype, int Kp, int Mm) {
  if (dtype == commu::kFloat32) return static_cast<long long>(wg::kv_workspace<float>(Kp, Mm));
  return static_cast<long long>(wg::kv_workspace<__nv_bfloat16>(Kp, Mm));
}

extern "C" int commu_kv_product(int dtype, const void* a, const void* x, void* out, void* scratch,
                                int Kp, int Mm, int Tp, int B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == commu::kFloat32) return kv_product<float>(a, x, out, scratch, Kp, Mm, Tp, B, s);
  if (dtype == commu::kBFloat16)
    return kv_product<__nv_bfloat16>(a, x, out, scratch, Kp, Mm, Tp, B, s);
  return cudaErrorInvalidValue;
}

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
