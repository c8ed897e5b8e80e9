// Slab write of every stream of the blocked XL-memory ring in one call, in
// place.
//
// Replaces: commu_tpu/ops/layout.py::_ring_write_kernel (:70), as launched by
//   ring_write (:203, pallas_call :257) for a ring dimension at any ``axis``
//   before the trailing [D, T] pair.
//
//   buf[..., block, ...] = rows     e.g. buf [L+1, R, B, D, T], axis = 1,
//                                   rows [L+1, B, D, T]
//
// With ``outer`` = the product of the dims before the ring axis and ``inner``
// = the product of those after it (D and T included), buf is [outer, R, inner]
// and rows [outer, inner]: piece o of rows goes to buf[o, block].  The
// reference aliases its output to the buffer so only the slab's blocks are
// written; here the kernel writes straight into the caller's buffer.
//
// What bounds it on the H100: a strided copy of outer x inner values (at
// L+1 = 7, B = 256, D = 500, T = 128 in bf16, 229 MB read and as much
// written), so HBM bandwidth: about 0.14 ms at 3.35 TB/s.
//
// Design: grid (blocks along a piece, outer); a grid-stride copy of raw words
// (bit-exact, no conversion), 16 bytes a thread when both ends of every piece
// are 16-byte aligned, else one value a thread.
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename W>
__global__ void __launch_bounds__(kThreads)
ring_write_kernel(W* __restrict__ buf, const W* __restrict__ rows, size_t inner, int R,
                  int block) {
  const size_t o = blockIdx.y;
  W* dst = buf + (o * R + block) * inner;
  const W* src = rows + o * inner;
  for (size_t i = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x; i < inner;
       i += static_cast<size_t>(gridDim.x) * kThreads)
    dst[i] = src[i];
}

template <typename W>
int launch(void* buf, const void* rows, int outer, size_t inner, int R, int block,
           cudaStream_t stream) {
  const size_t want = (inner + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < 2048 ? (want > 0 ? want : 1) : 2048);
  ring_write_kernel<W><<<dim3(blocks, outer), kThreads, 0, stream>>>(
      static_cast<W*>(buf), static_cast<const W*>(rows), inner, R, block);
  return cudaGetLastError();
}

}  // namespace

// elem_bytes: 4 (float32) or 2 (bfloat16); inner in values
extern "C" int commu_ring_write(int elem_bytes, void* buf, const void* rows, int outer,
                                long long inner, int R, int block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes != 4 && elem_bytes != 2) return cudaErrorInvalidValue;
  if (outer < 1 || outer > 65535 || inner < 1 || block < 0 || block >= R)
    return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(inner) * elem_bytes;
  if (bytes % 16 == 0 && reinterpret_cast<uintptr_t>(buf) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(rows) % 16 == 0)
    return launch<uint4>(buf, rows, outer, bytes / 16, R, block, s);
  if (elem_bytes == 4) return launch<uint32_t>(buf, rows, outer, inner, R, block, s);
  return launch<uint16_t>(buf, rows, outer, inner, R, block, s);
}
