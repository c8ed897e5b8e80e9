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
// once (131 MB at B = 256, D = 500, T = 128 in f32: 0.039 ms at 3.35 TB/s).
//
// Design: one thread per drawn word (commu::Plane).  The plane is drawn as
// words [wrows][wcols]: [D][T / 4 or T / 2] where its columns are cut (mode
// 0), [D / 4 or D / 2][T] where its rows are (mode 1; ModelConfig()'s D =
// 500, T = 128 at both widths), [D][T] uncut (mode 2).  Word (r, c) serves
// element (r, c + n * part), (r + n * part, c) or (r, c) for its pieces n =
// 0 .. 32 / width - 1, so a thread hashes its word once and handles its 4
// (8-bit) or 2 (16-bit) elements.  Neighbouring lanes take neighbouring
// word columns, so each piece's loads and stores coalesce; a thread takes
// kVec consecutive words (16-byte vectors: 4 f32 or 8 bf16 elements a
// piece) where the rows and the pointers allow it, one word elsewhere
// (ragged T, odd D).  The grid is (word-column tiles, word-row tiles, B):
// 32-bit index math inside a plane, no division.
#include "common.cuh"
#include "prng.cuh"

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPieces = 4;  // elements a word serves: 32 bits / 8

// kVec elements of S as one 16-byte vector, or one element
template <typename S, int kVec>
struct alignas(sizeof(S) * kVec) Pack {
  S e[kVec];
};

template <typename S, int kVec>
__global__ void __launch_bounds__(kThreads)
dropout_bdt_kernel(const S* __restrict__ x, S* __restrict__ y, int seed, int salt,
                   commu::Plane plane, int D, int T, int wrows, int wcols) {
  // block (tx, ty): tx lanes along the word columns, ty word rows
  const int tx = blockDim.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  const int c = (blockIdx.x * tx + threadIdx.x) * kVec;
  if (r >= wrows || c >= wcols) return;
  const int b = blockIdx.z;
  const uint32_t s = commu::plane_seed(seed, b, 16384, salt * 512);
  const float scale = commu::rnd<S>(plane.scale);
  const size_t base = static_cast<size_t>(b) * D * T;
  const int pieces = plane.mode == 2 ? 1 : plane.width == 8 ? 4 : 2;
  // the element offset between pieces of a word
  const int step = plane.mode == 0 ? plane.part : plane.mode == 1 ? plane.part * T : 0;
  const uint32_t vmask = (1u << plane.width) - 1u;
  const int shift0 = plane.mode == 2 ? 16 : 0;  // mode 2 reads the high half
  uint32_t words[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v)
    words[v] = commu::hash_word(static_cast<uint32_t>(r) * wcols + c + v, s);
  const S* xs = x + base + r * T + c;
  S* ys = y + base + r * T + c;
  // every piece's load in flight before the first store
  Pack<S, kVec> in[kMaxPieces];
#pragma unroll
  for (int n = 0; n < kMaxPieces; ++n)
    if (n < pieces) in[n] = *reinterpret_cast<const Pack<S, kVec>*>(xs + n * step);
#pragma unroll
  for (int n = 0; n < kMaxPieces; ++n) {
    if (n >= pieces) break;
    const int sh = shift0 + n * plane.width;
    Pack<S, kVec> out;
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const bool kept = ((words[v] >> sh) & vmask) >= plane.thresh;
      out.e[v] = commu::from_f<S>(kept ? commu::to_f(in[n].e[v]) * scale : 0.f);
    }
    *reinterpret_cast<Pack<S, kVec>*>(ys + n * step) = out;
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename S, int kVec>
cudaError_t launch_vec(const S* x, S* y, int seed, int salt, const commu::Plane& plane, int B,
                       int D, int T, int wrows, int wcols, cudaStream_t stream) {
  // lanes along the columns: the fewest whole powers of two that cover a
  // row of words, at most a block
  const int need = (wcols + kVec - 1) / kVec;
  int tx = 1;
  while (tx < need && tx < kThreads) tx *= 2;
  const dim3 block(tx, kThreads / tx);
  const dim3 grid((need + tx - 1) / tx, (wrows + block.y - 1) / block.y, B);
  if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidValue;
  dropout_bdt_kernel<S, kVec><<<grid, block, 0, stream>>>(x, y, seed, salt, plane, D, T, wrows,
                                                          wcols);
  return cudaGetLastError();
}

template <typename S>
int launch(const void* x_, void* y_, int seed, int salt, int thresh, float scale, int bits,
           int B, int D, int T, cudaStream_t stream) {
  if (static_cast<long long>(B) * D * T == 0) return cudaSuccess;
  if (static_cast<long long>(D) * T > 0x7FFFFFFFll) return cudaErrorInvalidValue;
  const S* x = static_cast<const S*>(x_);
  S* y = static_cast<S*>(y_);
  const commu::Plane plane = commu::make_plane(D, T, thresh, scale, bits);
  const int wrows = plane.mode == 1 ? plane.part : D;
  const int wcols = plane.mode == 0 ? plane.part : T;
  // 16-byte vectors: a thread's words in one row of the plane, every row
  // (and piece) starting on 16 bytes
  constexpr int kVec = 16 / sizeof(S);
  if (T % kVec == 0 && wcols % kVec == 0 && aligned16(x) && aligned16(y))
    return launch_vec<S, kVec>(x, y, seed, salt, plane, B, D, T, wrows, wcols, stream);
  return launch_vec<S, 1>(x, y, seed, salt, plane, B, D, T, wrows, wcols, stream);
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
