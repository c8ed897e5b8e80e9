// Inverted dropout on [B, D, T] activations, mask from (seed, row, salt).
//
// Replaces: commu_tpu/ops/dropout.py::_drop_kernel (:40), as launched by
//   _drop_call (:51) for dropout_bdt (:70) and its backward (:80), which
//   applies the same mask to the cotangent.
//
// Batch row b draws the plane [D, T] seeded with seed + b * 16384 + salt * 512
// (:35-37); y = x * scale where kept, 0 elsewhere, with the scale rounded to
// S first and the product rounded to S (the reference multiplies in x's
// dtype, :47).
//
// What bounds it on the H100: bytes.  Each element is read once and written
// once (131 MB at B = 256, D = 500, T = 128 in f32); the hash is a dozen
// integer operations per element.
//
// Design: one thread per element, neighbouring threads on neighbouring
// tokens, so loads and stores coalesce; the mask bit is computed where the
// element is used and never stored.
#include "common.cuh"
#include "prng.cuh"

namespace {

constexpr int kThreads = 256;

template <typename S>
__global__ void __launch_bounds__(kThreads)
dropout_bdt_kernel(const S* __restrict__ x, S* __restrict__ y, int seed, int salt,
                   commu::Plane plane, int D, int T, size_t total) {
  const size_t at = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (at >= total) return;
  const size_t row = at / T;  // b * D + d
  const int t = static_cast<int>(at - row * T);
  const int b = static_cast<int>(row / D);
  const int d = static_cast<int>(row - static_cast<size_t>(b) * D);
  const uint32_t s = commu::plane_seed(seed, b, 16384, salt * 512);
  const float scale = commu::rnd<S>(plane.scale);
  y[at] = commu::from_f<S>(commu::keep(plane, s, d, t) ? commu::to_f(x[at]) * scale : 0.f);
}

template <typename S>
int launch(const void* x, void* y, int seed, int salt, int thresh, float scale, int bits, int B, int D, int T,
           cudaStream_t stream) {
  const size_t total = static_cast<size_t>(B) * D * T;
  if (total == 0) return cudaSuccess;
  const size_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFull) return cudaErrorInvalidValue;
  dropout_bdt_kernel<S><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const S*>(x), static_cast<S*>(y), seed, salt,
      commu::make_plane(D, T, thresh, scale, bits), D, T, total);
  return cudaGetLastError();
}

}  // namespace

extern "C" int commu_dropout_bdt(int dtype, const void* x, void* y, int salt, int seed, int thresh,
                                 float scale, int bits, int B, int D, int T, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == commu::kFloat32) return launch<float>(x, y, seed, salt, thresh, scale, bits, B, D, T, s);
  if (dtype == commu::kBFloat16)
    return launch<__nv_bfloat16>(x, y, seed, salt, thresh, scale, bits, B, D, T, s);
  return cudaErrorInvalidValue;
}
