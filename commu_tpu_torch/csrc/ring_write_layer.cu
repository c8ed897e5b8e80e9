// One layer's slab write into the blocked XL-memory ring, in place.
//
// Replaces: commu_tpu/ops/layout.py::_ring_write_kernel (:70), as launched by
//   ring_write_layer (:75, pallas_call :119) with layer_axis=0, ring_axis=1.
//
//   buf[layer, block] = rows      buf [L+1, R, B, D, Tb], rows [B, D, Tb]
//
// The reference kernel aliases its output to the buffer
// (input_output_aliases={1: 0}) so only the one slab is written; here the
// kernel writes straight into the caller's buffer, which the PyTorch wrapper
// documents as an in-place update.
//
// What bounds it on the H100: it is a contiguous copy of B x D x Tb values
// (2.56 MB at B = 10, D = 500, Tb = 128, f32), so HBM bandwidth, read plus
// write: about 1.5 us at 3.35 TB/s, under the launch latency.
//
// Design: a grid-stride copy of raw words (bit-exact, no conversion), 16 bytes
// a thread when both ends are 16-byte aligned and the slab is a whole number
// of 16-byte words, else one value a thread.
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename W>
__global__ void __launch_bounds__(kThreads)
copy_kernel(W* __restrict__ dst, const W* __restrict__ src, size_t n) {
  for (size_t i = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * kThreads)
    dst[i] = src[i];
}

template <typename W>
int launch(void* dst, const void* src, size_t n, cudaStream_t stream) {
  const size_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 4096 ? (want > 0 ? want : 1) : 4096);
  copy_kernel<W><<<blocks, kThreads, 0, stream>>>(static_cast<W*>(dst),
                                                  static_cast<const W*>(src), n);
  return cudaGetLastError();
}

}  // namespace

// elem_bytes: 4 (float32) or 2 (bfloat16); slab = B * D * Tb values
extern "C" int commu_ring_write_layer(int elem_bytes, void* buf, const void* rows, int layer,
                                      int block, int R, int slab, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes != 4 && elem_bytes != 2) return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(slab) * elem_bytes;
  char* dst = static_cast<char*>(buf) + (static_cast<size_t>(layer) * R + block) * bytes;
  if (bytes % 16 == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(rows) % 16 == 0)
    return launch<uint4>(dst, rows, bytes / 16, s);
  if (elem_bytes == 4) return launch<uint32_t>(dst, rows, slab, s);
  return launch<uint16_t>(dst, rows, slab, s);
}
