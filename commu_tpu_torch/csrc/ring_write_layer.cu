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
// What bounds it on the H100: it is a contiguous copy of B x D x Tb values,
// so HBM bandwidth, read plus write: 2.56 MB at the eval shape (B = 10,
// D = 500, Tb = 128, f32; about 1.5 us at 3.35 TB/s, under the launch
// latency) and 65.5 MB at the training shape (B = 256: 39 us).
//
// Design: a copy of raw words (bit-exact, no conversion), 16 bytes a word
// when both ends are 16-byte aligned and the slab is a whole number of
// 16-byte words, else one value a word.  One word a thread and a grid that
// covers the slab once: no grid-stride loop, no cap on the block count.
// The block size follows the slab: 1,024 threads where the slab fills the
// card's resident threads several times over (fewer blocks to schedule: the
// training slab, where it beats the slab copy_), 256 below that (the eval
// slab, where 512-thread blocks measured slower than the copy_).  Four
// words a thread, loads before stores, measured slower than the copy_ at
// both shapes (PERF.md, section 6).
#include "common.cuh"

#include <stdint.h>

namespace {

// words from which the 1,024-thread blocks pay: four fills of 132 SMs x
// 2,048 resident threads
constexpr size_t kLargeSlab = 4ull * 132 * 2048;

template <typename W, int kThreads>
__global__ void __launch_bounds__(kThreads)
copy_kernel(W* __restrict__ dst, const W* __restrict__ src, size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) dst[i] = src[i];
}

template <typename W, int kThreads>
int launch_blocks(void* dst, const void* src, size_t n, cudaStream_t stream) {
  const size_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffu) return cudaErrorInvalidValue;
  copy_kernel<W, kThreads><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<W*>(dst), static_cast<const W*>(src), n);
  return cudaGetLastError();
}

template <typename W>
int launch(void* dst, const void* src, size_t n, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  return n >= kLargeSlab ? launch_blocks<W, 1024>(dst, src, n, stream)
                         : launch_blocks<W, 256>(dst, src, n, stream);
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
