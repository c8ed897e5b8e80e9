// The 128 x 128 tensor-core tile of a product A X that project_mem_kv.cu,
// ffn_block_bwd.cu and ffn_block_fwd.cu share, and (tile_product_kernel) the
// whole product per batch row that the two FFN kernels and the two NLL
// kernels (nll_fwd.cu, nll_bwd.cu) run.
//
// A block of 256 threads computes a 128-row x 128-token output tile with 8
// warps (2 down x 4 across, each 64 x 32).  The depth arrives in chunks of
// 64 bytes a row (16 values in f32, 32 in bf16), both operands staged as
// they lie in memory, the row or token index contiguous ("MN-major"): A as
// [kDepth][kStride] (depth-major weights), X as [kDepth][kStride].
//   bf16: mma.sync m16n8k16 with f32 accumulation, fragments from
//     ldmatrix.trans (the instruction transposes the MN-major 8 x 8 tiles
//     into the k-pairs the product wants).
//   f32: 3xTF32 on mma.sync m16n8k8: each fragment value split as it is
//     loaded, hi = rna_tf32(x), lo = rna_tf32(x - hi), and every product
//     summing a_lo b_hi + a_hi b_lo + a_hi b_hi in f32, each pass over all 16
//     accumulators of a warp before the next (the dropped a_lo b_lo is 2^-22
//     of a product); ops/fused_attention.py::tf32_split_product_plain
//     emulates it for the CPU tests.
// Everything here has internal linkage: each source that includes this file
// compiles its own copy.
#pragma once

#include "reduce.cuh"

#include <stdint.h>

namespace {

using commu::cp_async16;
using commu::cp_async_commit;
using commu::cp_async_wait;
using commu::mma_bf16;
using commu::mma_tf32;
using commu::split_tf32;

constexpr int kBM = 128;  // output rows per block
constexpr int kBN = 128;  // tokens per block
constexpr int kWM = 64;   // rows per warp (2 warps down)
constexpr int kWN = 32;   // tokens per warp (4 warps across)

// row stride of a staged tile, in elements: 8 mod 32 words in f32 (the
// fragment loads hit 32 distinct banks); 272-byte rows in bf16 (16-byte
// aligned for ldmatrix, its eight row addresses on distinct banks)
constexpr int kStride = kBN + 8;
// depth of a staged chunk: 64 bytes of each row, 16 in f32, 32 in bf16
template <typename S>
constexpr int kDepth = 64 / static_cast<int>(sizeof(S));

// one stage: the A tile, then the X tile, both [kDepth][kStride]
template <typename S>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * kDepth<S> * kStride * static_cast<int>(sizeof(S));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// One staged depth chunk into a warp's 64 x 32 accumulators, f32 (3xTF32).
// a_s, b_s [kBK][kStride] floats, depth-major, split as they are loaded.
// Fragments of m16n8k8 (g = lane / 4, q = lane % 4): A (g | g+8, q | q+4),
// B (q | q+4, g), C (g | g+8, 2q, 2q+1).
__device__ __forceinline__ void warp_tile(const float* a_s, const float* b_s,
                                          float (&acc)[4][4][4], int wm, int wn, int lane) {
  constexpr int kBK = kDepth<float>, kS = kStride;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int kb = 0; kb < kBK; kb += 8) {
    uint32_t ah[4][4], al[4][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int m = wm * kWM + mi * 16 + g;
      const float e[4] = {a_s[(kb + q) * kS + m], a_s[(kb + q) * kS + m + 8],
                          a_s[(kb + q + 4) * kS + m], a_s[(kb + q + 4) * kS + m + 8]};
#pragma unroll
      for (int j = 0; j < 4; ++j) split_tf32(e[j], ah[mi][j], al[mi][j]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = wn * kWN + ni * 8 + g;
      split_tf32(b_s[(kb + q) * kS + n], bh[ni][0], bl[ni][0]);
      split_tf32(b_s[(kb + q + 4) * kS + n], bh[ni][1], bl[ni][1]);
    }
    // small terms first, each pass over all 16 accumulators: the three
    // products into one accumulator never issue back to back
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], al[mi], bh[ni]);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], ah[mi], bl[ni]);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_tf32(acc[mi][ni], ah[mi], bh[ni]);
  }
}

// The same in bf16 (m16n8k16).  ldmatrix.trans of the 8 x 8 tile at depth
// rows k0 .. k0+7, columns c0 .. c0+7 gives lane (g, q) the pair at depth
// k0 + 2q, k0 + 2q + 1 of column c0 + g: an A register for (rows c0, depth
// k0), a B register for (tokens c0, depth k0).
__device__ __forceinline__ void warp_tile(const __nv_bfloat16* a_s, const __nv_bfloat16* b_s,
                                          float (&acc)[4][4][4], int wm, int wn, int lane) {
  constexpr int kBK = kDepth<__nv_bfloat16>, kS = kStride;
  const int tile = lane / 8, row = lane % 8;
#pragma unroll
  for (int kb = 0; kb < kBK; kb += 16) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)  // tiles: (k0, m0) = (0, 0) (0, 8) (8, 0) (8, 8)
      ldsm_x4_trans(a[mi], a_s + (kb + (tile / 2) * 8 + row) * kS + wm * kWM + mi * 16 +
                               (tile % 2) * 8);
#pragma unroll
    for (int np = 0; np < 2; ++np) {  // tiles: (k0, n0) = (0, 0) (8, 0) (0, 8) (8, 8)
      uint32_t r[4];
      ldsm_x4_trans(r, b_s + (kb + (tile % 2) * 8 + row) * kS + wn * kWN + np * 16 +
                           (tile / 2) * 8);
      b[2 * np][0] = r[0], b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2], b[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
  }
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// ---- acc[m][t] = sum_k A[k][m] X[b][k][t] over 128-row x 128-token tiles:
// A [Kp][Mm] a depth-major weight copy (Mm whole tiles), X [B][Kp][Tp] an
// activation padded with zeros (Kp whole chunks, Tp whole 32s).  Two blocks
// to an SM; the depth through a ring of kTileStages chunks fed by 16-byte
// cp.async (tokens past Tp zero-filled by the copy).  The epilogue is the
// functor's: out.store(acc, b, m0, n0, tile, red), with red the ring's
// shared memory, free again.
constexpr int kTileStages = 4;

template <typename S>
constexpr size_t tile_product_smem() {
  return static_cast<size_t>(kTileStages) * stage_bytes<S>();
}

// grid: (Mm / 128) x (token tiles) x B blocks, the row tiles of one (b,
// token tile) next to each other, so X's tile comes from device memory once
// and from L2 after
template <typename S, class Out>
__global__ void __launch_bounds__(256, 2)
tile_product_kernel(const S* __restrict__ a, const S* __restrict__ x, int Kp, int Mm, int Tp,
                    Out out) {
  constexpr int kThreads = 256;
  constexpr int kBK = kDepth<S>, kS = kStride;
  constexpr int kVec = 16 / sizeof(S);                  // elements a copy
  constexpr int kCopies = kBK * kBM / kVec / kThreads;  // per operand, thread and chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m_tiles = Mm / kBM, n_tiles = (Tp + kBN - 1) / kBN;
  const int m0 = (blockIdx.x % m_tiles) * kBM;
  const int rest = blockIdx.x / m_tiles;
  const int tile = rest % n_tiles, n0 = tile * kBN;
  const int b = rest / n_tiles;
  const S* xb = x + static_cast<size_t>(b) * Kp * Tp;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;

  auto a_tile = [&](int stage) {
    return reinterpret_cast<S*>(smem_raw + stage * stage_bytes<S>());
  };
  auto x_tile = [&](int stage) { return a_tile(stage) + kBK * kS; };
  auto issue = [&](int kt) {
    const int k0 = kt * kBK, stage = kt % kTileStages;
    S* a_s = a_tile(stage);
    S* x_s = x_tile(stage);
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int idx = tid + kThreads * i;
      const int kk = idx / (kBM / kVec), cc = idx % (kBM / kVec) * kVec;
      cp_async16(a_s + kk * kS + cc, a + static_cast<size_t>(k0 + kk) * Mm + m0 + cc, true);
      const int t = n0 + cc;
      const bool in = t < Tp;
      cp_async16(x_s + kk * kS + cc, in ? xb + static_cast<size_t>(k0 + kk) * Tp + t : xb, in);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  const int chunks = Kp / kBK;
#pragma unroll
  for (int kt = 0; kt < kTileStages - 1; ++kt) {
    if (kt < chunks) issue(kt);
    cp_async_commit();
  }
  for (int kt = 0; kt < chunks; ++kt) {
    cp_async_wait<kTileStages - 2>();  // chunk kt has landed (this thread's copies)
    __syncthreads();                   // ... everyone's; stage (kt - 1) is free
    if (kt + kTileStages - 1 < chunks) issue(kt + kTileStages - 1);
    cp_async_commit();
    warp_tile(a_tile(kt % kTileStages), x_tile(kt % kTileStages), acc, wm, wn, lane);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is past its last chunk: the ring is free
  out.store(acc, b, m0, n0, tile, reinterpret_cast<float*>(smem_raw));
}

template <typename S, class Out>
cudaError_t run_tile_product(const S* a, const S* x, int Kp, int Mm, int Tp, int B, const Out& out,
                             cudaStream_t stream) {
  constexpr size_t smem = tile_product_smem<S>();
  const cudaError_t err = commu::allow_smem(tile_product_kernel<S, Out>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(Mm / kBM) * ((Tp + kBN - 1) / kBN) * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  tile_product_kernel<S, Out><<<static_cast<unsigned>(blocks), 256, smem, stream>>>(a, x, Kp, Mm,
                                                                                   Tp, out);
  return cudaGetLastError();
}

}  // namespace
