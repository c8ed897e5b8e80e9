// Dropout masks from a counter hash, one element at a time.
//
// Replaces: the mask contract of commu_tpu/ops/fused_attention.py in its
//   off-TPU form: _prng_seed / _prng_random_bits (:140-162, a splitmix32-style
//   hash of seed, draw count and element index) and random_keep (:290-358) at
//   both draw widths: 16 bits a decision (the default) and 8
//   (COMMU_DROPOUT_BITS=8, :306-336).  ops/prng.py::keep_mask is the plain
//   version; a kernel calls keep() where it uses the element, so no mask
//   tensor is ever written to memory.
//
// The reference draws a whole plane per (site, batch row[, head]) after
// seeding with an int32 sum; every site seeds and then draws once, so the
// draw count is 1.  One 32-bit word serves four or two mask elements where
// the plane splits cleanly: see Plane.
#pragma once

#include <stdint.h>

namespace commu {

// How a [rows, cols] mask plane maps onto the drawn words, with the compare
// threshold and the keep-scale: built on the host (make_plane), passed to the
// kernel by value.  thresh == 0 means no dropout: keep() is then always true.
//
// Modes 0 and 1 cut the plane into 32 / width pieces of ``part`` columns
// (mode 0) or rows (mode 1); piece n of element (i, j) reads bits
// [n * width, (n + 1) * width) of the word at its place inside the piece.
// Mode 2 draws the whole plane and reads the high 16 bits.
struct Plane {
  int mode;         // 0: columns cut; 1: rows cut; 2: no cut
  int part;         // columns (mode 0) or rows (mode 1) of one piece
  int cols;         // columns of the plane
  int width;        // bits of a piece's value: 8 or 16
  uint32_t thresh;  // keep where the value >= thresh (unsigned, both masked)
  float scale;      // 1 / (1 - rate), or 1 without dropout
};

// ``t`` is the threshold at the draw width ``bits`` (8 or 16): the rate is
// t / 2^bits on every branch.  random_keep's order at 8 bits: columns
// quartered, rows quartered, then the 16-bit geometries with t << 8.
inline Plane make_plane(int rows, int cols, int t, float scale, int bits) {
  Plane p{2, 0, cols, 16, static_cast<uint32_t>(t), scale};
  if (bits == 8) {
    if (cols % 4 == 0 && (cols / 4) % 128 == 0) {
      p.mode = 0, p.part = cols / 4, p.width = 8;
      return p;
    }
    if (rows % 4 == 0) {
      p.mode = 1, p.part = rows / 4, p.width = 8;
      return p;
    }
    p.thresh = static_cast<uint32_t>(t) << 8;
  }
  if (cols % 2 == 0 && (cols / 2) % 128 == 0) {
    p.mode = 0, p.part = cols / 2;
  } else if (rows % 2 == 0) {
    p.mode = 1, p.part = rows / 2;
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

// Which piece coordinate c falls into: c / part for c < 4 * part, with no
// division.
__device__ __forceinline__ int piece_of(int c, int part) {
  return (c >= part) + (c >= 2 * part) + (c >= 3 * part);
}

// The keep bit of element (i, j) of the plane seeded with ``seed``.
__device__ __forceinline__ bool keep(const Plane& p, uint32_t seed, int i, int j) {
  if (p.mode == 2)
    return (hash_word(static_cast<uint32_t>(i) * p.cols + j, seed) >> 16) >= p.thresh;
  uint32_t idx;
  int piece;
  if (p.mode == 0) {
    piece = piece_of(j, p.part);
    idx = static_cast<uint32_t>(i) * p.part + (j - piece * p.part);
  } else {
    piece = piece_of(i, p.part);
    idx = static_cast<uint32_t>(i - piece * p.part) * p.cols + j;
  }
  const uint32_t value = (hash_word(idx, seed) >> (piece * p.width)) & ((1u << p.width) - 1u);
  return value >= p.thresh;
}

}  // namespace commu
