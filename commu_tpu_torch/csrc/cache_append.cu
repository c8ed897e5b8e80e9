// Decode KV-cache append, in place.
//
// Replaces: commu_tpu/ops/layout.py::_cache_append_kernel (:126), as
//   launched by cache_append (:151).
//
// For every (layer l, row g) with advance[g] and 0 <= length[g] < M:
//   k[l, g, :, :, length[g]] = k_self[l, g];  v likewise.
// Other rows, and a row already at capacity (length == M), are untouched.
//
// The reference kernel aliases its outputs to the cache inputs
// (input_output_aliases) so XLA updates the buffer in place; here the
// kernel writes straight into the caller's k and v, which the PyTorch
// wrapper documents as an in-place update.
//
// What bounds it on the H100: it moves 2 x L x G x H x dh values (48 KB at
// L = 6, G = 8, f32) with a stride of M between neighbours, so it is bound
// by launch latency and by one 32-byte sector per value written.
//
// Design: grid (G, L), one block per (row, layer); each thread copies raw
// values (bit-exact, no conversion) for a slice of the H x dh lanes.
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename E>
__global__ void __launch_bounds__(kThreads)
cache_append_kernel(E* __restrict__ k, E* __restrict__ v, const E* __restrict__ k_self,
                    const E* __restrict__ v_self, const int* __restrict__ length,
                    const bool* __restrict__ advance, int G, int HD, int M) {
  const int g = blockIdx.x;
  const int len = length[g];
  if (!advance[g] || len < 0 || len >= M) return;
  const size_t row = static_cast<size_t>(blockIdx.y) * G + g;
  E* k_row = k + row * HD * M + len;
  E* v_row = v + row * HD * M + len;
  const E* ks = k_self + row * HD;
  const E* vs = v_self + row * HD;
  for (int e = threadIdx.x; e < HD; e += kThreads) {
    k_row[static_cast<size_t>(e) * M] = ks[e];
    v_row[static_cast<size_t>(e) * M] = vs[e];
  }
}

template <typename E>
int launch(void* k, void* v, const void* k_self, const void* v_self, const void* length,
           const void* advance, int L, int G, int HD, int M, cudaStream_t stream) {
  cache_append_kernel<E><<<dim3(G, L), kThreads, 0, stream>>>(
      static_cast<E*>(k), static_cast<E*>(v), static_cast<const E*>(k_self),
      static_cast<const E*>(v_self), static_cast<const int*>(length),
      static_cast<const bool*>(advance), G, HD, M);
  return cudaGetLastError();
}

}  // namespace

// elem_bytes: 4 (float32) or 2 (bfloat16); values are copied as raw bits
extern "C" int commu_cache_append(int elem_bytes, void* k, void* v, const void* k_self,
                                  const void* v_self, const void* length, const void* advance,
                                  int L, int G, int HD, int M, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return launch<uint32_t>(k, v, k_self, v_self, length, advance, L, G, HD, M, s);
  if (elem_bytes == 2)
    return launch<uint16_t>(k, v, k_self, v_self, length, advance, L, G, HD, M, s);
  return cudaErrorInvalidValue;
}
