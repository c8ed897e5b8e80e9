// Dropout masks from a counter hash, one element at a time.
//
// Replaces: the mask contract of commu_tpu/ops/fused_attention.py in its
//   off-TPU form: _prng_seed / _prng_random_bits (:140-162, a splitmix32-style
//   hash of seed, draw count and element index) and the 16-bit branch of
//   random_keep (:337-358).  ops/prng.py::keep_mask is the plain version; a
//   kernel calls keep() where it uses the element, so no mask tensor is ever
//   written to memory.  The 8-bit draw variant (:306-336) is not ported.
//
// The reference draws a whole plane per (site, batch row[, head]) after
// seeding with an int32 sum; every site seeds and then draws once, so the
// draw count is 1.  One 32-bit word serves two mask elements where the plane
// splits cleanly: see Plane.
#pragma once

#include <stdint.h>

namespace commu {

// How a [rows, cols] mask plane maps onto the drawn words, with the compare
// threshold and the keep-scale: built on the host (make_plane), passed to the
// kernel by value.  t16 == 0 means no dropout: keep() is then always true.
struct Plane {
  int mode;      // 0: columns split at half; 1: rows split at half; 2: no split
  int half;      // cols / 2 (mode 0) or rows / 2 (mode 1)
  int cols;      // columns of the plane
  uint32_t t16;  // keep where the 16-bit half >= t16 (unsigned)
  float scale;   // 1 / (1 - t16 / 65536), or 1 without dropout
};

inline Plane make_plane(int rows, int cols, int t16, float scale) {
  Plane p{2, 0, cols, static_cast<uint32_t>(t16), scale};
  if (cols % 2 == 0 && (cols / 2) % 128 == 0) {
    p.mode = 0;
    p.half = cols / 2;
  } else if (rows % 2 == 0) {
    p.mode = 1;
    p.half = rows / 2;
  }
  return p;
}

// The reference's seed sums are int32 with wraparound, read as uint32:
// unsigned arithmetic gives the same bits.
__device__ __forceinline__ uint32_t plane_seed(int seed, int a, int a_stride, int b) {
  return static_cast<uint32_t>(seed) + static_cast<uint32_t>(a) * static_cast<uint32_t>(a_stride) +
         static_cast<uint32_t>(b);
}

__device__ __forceinline__ uint32_t hash_word(uint32_t idx, uint32_t seed) {
  uint32_t x = idx + seed * 0x9E3779B9u + 0x85EBCA6Bu;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// The keep bit of element (i, j) of the plane seeded with ``seed``.
__device__ __forceinline__ bool keep(const Plane& p, uint32_t seed, int i, int j) {
  uint32_t idx;
  bool high = true;
  if (p.mode == 0) {
    high = j >= p.half;
    idx = static_cast<uint32_t>(i) * p.half + (high ? j - p.half : j);
  } else if (p.mode == 1) {
    high = i >= p.half;
    idx = static_cast<uint32_t>(high ? i - p.half : i) * p.cols + j;
  } else {
    idx = static_cast<uint32_t>(i) * p.cols + j;
  }
  const uint32_t x = hash_word(idx, seed);
  return (high ? x >> 16 : x & 0xFFFFu) >= p.t16;
}

}  // namespace commu
