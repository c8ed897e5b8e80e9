// Memory K/V projection of one layer's blocked XL-memory ring.
//
// Replaces: commu_tpu/ops/fused_attention.py::_proj_mem_kernel (:1539), as
//   launched by project_mem_kv (:1576, pallas_call :1608).
//
// For every batch row b and ring slab r, with X = mem[layer, r, b] [D, Tb]:
//   k[b, r] = Wk^T X,  v[b, r] = Wv^T X          Wk, Wv [D, H*dh] -> [H*dh, Tb]
// written as k, v [B, R, H, dh, Tb] in the memory's dtype; products
// accumulate in f32.  The layer is block-indexed inside the buffer: no
// mem[layer] copy is made, and the ring is only read.
//
// What bounds it on the H100: tensor-core arithmetic.  At the training shape
// (B = 256, R = 8, D = H*dh = 500, Tb = 128) it is 2 x 2048 products of
// [500 x 500][500 x 128], 262 GFLOP, against 0.52 GB read and 1.05 GB written
// in f32 (0.47 ms at 3.35 TB/s).  The TPU kernel runs these products on the
// MXU (:1555-1558); the first form here ran them as f32 FMA loops (bound
// 3.9 ms at 67 TFLOP/s) and lost to one cuBLAS SGEMM.
//
// Design: one tiled product A x X per slab, A = [Wk | Wv]^T the joint
// [2*H*dh, D] weight.  A small kernel first writes A once per call into the
// workspace, depth-major and zero-padded to whole tiles ([Dp, Mp]: 1 MB in
// bf16, 2 MB in f32; it stays in L2), so every weight tile is a plain aligned
// copy.  A block computes a 128-row x 128-token tile of one slab with 8 warps
// (2 x 4, each 64 x 32; the tile of mma_tile.cuh, which ffn_block_bwd.cu
// shares), two blocks to an SM; the grid is flat with a slab's
// row tiles next to each other, so its X tile comes from device memory once
// and from L2 after.  The depth runs through a ring of kStages shared-memory
// tiles fed by cp.async (16-byte copies; X's ragged rows and tokens
// zero-filled by the copy), the next chunks in flight while the warps
// multiply the current one.  Both operands are staged as they lie in memory
// (the row or token index contiguous, "MN-major") with a row stride that
// keeps every fragment load free of bank conflicts.  Where a row of X is no
// whole number of 16-byte copies (Tb * sizeof(S) % 16 != 0), X's tiles are
// loaded by plain loads.
//   bf16: mma.sync m16n8k16 with f32 accumulation, as the MXU does; the
//     fragments come from ldmatrix.trans (the instruction transposes the
//     MN-major 8 x 8 tiles into the k-pairs the product wants).
//   f32: 3xTF32 on mma.sync m16n8k8.  Single-pass TF32 keeps 11 significant
//     bits, about 5e-4 relative over 500 terms, outside the port's 1e-4.
//     Each fragment value is split as it is loaded, a_hi = rna_tf32(a) and
//     a_lo = rna_tf32(a - a_hi) (the rounding of cvt.rna.tf32.f32), and every
//     product sums a_lo b_hi + a_hi b_lo + a_hi b_hi in f32, each pass over
//     all 16 accumulators of a warp before the next; the dropped a_lo b_lo
//     term is 2^-22 of a product.  ops/fused_attention.py::
//     tf32_split_product_plain emulates this arithmetic for the CPU tests.
//     Staging f32 values and splitting in registers moves half the bytes
//     through L2 and shared memory that staged (hi, lo) pairs would.
// The sums run in another order than the FMA loops of
// rel_attention_proj_fwd.cu's projection, so the two agree to the f32
// tolerance, not bit for bit.
#include "mma_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;
constexpr int kMinBlocks = 2;  // blocks an SM holds: 128 registers a thread

// the joint weight's padded extent: depth to whole chunks, rows to whole tiles
template <typename S>
int depth_padded(int D) {
  return (D + kDepth<S> - 1) / kDepth<S> * kDepth<S>;
}
__host__ __device__ int rows_padded(int HD) { return (2 * HD + kBM - 1) / kBM * kBM; }

// wcat [Dp, Mp]: row d holds Wk[d, :] then Wv[d, :], zeros past D and 2*HD
template <typename S>
__global__ void __launch_bounds__(kThreads)
project_weights_kernel(const S* __restrict__ wk, const S* __restrict__ wv,
                       S* __restrict__ wcat, int D, int HD, int Dp, int Mp) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(Dp) * Mp) return;
  const int d = static_cast<int>(idx / Mp), o = static_cast<int>(idx % Mp);
  const size_t at = static_cast<size_t>(d) * HD + (o < HD ? o : o - HD);
  const S zero = commu::from_f<S>(0.f);
  wcat[idx] = d < D && o < 2 * HD ? (o < HD ? wk[at] : wv[at]) : zero;
}

template <typename S, bool kVecX>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
project_mem_kv_kernel(const S* __restrict__ mem, const S* __restrict__ wcat,
                      S* __restrict__ k_out, S* __restrict__ v_out, int layer, int R, int B,
                      int D, int Tb, int HD) {
  constexpr int kBK = kDepth<S>, kS = kStride;
  constexpr int kAVec = 16 / sizeof(S), kXVec = kAVec;    // elements a copy
  constexpr int kACopies = kBK * kBM / kAVec / kThreads;  // per thread and chunk
  constexpr int kXCopies = kBK * kBN / kXVec / kThreads;
  constexpr int kXLoads = kBK * kBN / kThreads;  // the plain-load form
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int rows = 2 * HD, mp = rows_padded(HD);
  const int m_tiles = mp / kBM, n_tiles = (Tb + kBN - 1) / kBN;
  const int m0 = (blockIdx.x % m_tiles) * kBM;
  const int rest = blockIdx.x / m_tiles;
  const int n0 = (rest % n_tiles) * kBN;
  const int slab = rest / n_tiles;  // b * R + r: the output's order
  const int b = slab / R, r = slab - b * R;
  const S* x = mem + ((static_cast<size_t>(layer) * R + r) * B + b) * D * Tb;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;

  auto a_tile = [&](int stage) {
    return reinterpret_cast<S*>(smem_raw + stage * stage_bytes<S>());
  };
  auto x_tile = [&](int stage) { return a_tile(stage) + kBK * kS; };
  // issue chunk kt's copies into stage kt % kStages
  auto issue = [&](int kt) {
    const int k0 = kt * kBK, stage = kt % kStages;
    S* a_s = a_tile(stage);
    S* x_s = x_tile(stage);
#pragma unroll
    for (int i = 0; i < kACopies; ++i) {
      const int idx = tid + kThreads * i;
      const int kk = idx / (kBM / kAVec), cc = idx % (kBM / kAVec) * kAVec;
      cp_async16(a_s + kk * kS + cc, wcat + static_cast<size_t>(k0 + kk) * mp + m0 + cc, true);
    }
    if constexpr (kVecX) {
#pragma unroll
      for (int i = 0; i < kXCopies; ++i) {
        const int idx = tid + kThreads * i;
        const int kk = idx / (kBN / kXVec), cc = idx % (kBN / kXVec) * kXVec;
        const int d = k0 + kk, t = n0 + cc;
        const bool in = d < D && t < Tb;
        cp_async16(x_s + kk * kS + cc, in ? x + static_cast<size_t>(d) * Tb + t : x, in);
      }
    } else {
      const S zero = commu::from_f<S>(0.f);
#pragma unroll 4
      for (int i = 0; i < kXLoads; ++i) {
        const int idx = tid + kThreads * i;
        const int kk = idx / kBN, cc = idx % kBN;
        const int d = k0 + kk, t = n0 + cc;
        x_s[kk * kS + cc] = d < D && t < Tb ? x[static_cast<size_t>(d) * Tb + t] : zero;
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  const int chunks = (D + kBK - 1) / kBK;
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < chunks) issue(kt);
    cp_async_commit();
  }
  for (int kt = 0; kt < chunks; ++kt) {
    cp_async_wait<kStages - 2>();  // chunk kt has landed (this thread's copies)
    __syncthreads();               // ... everyone's; stage (kt - 1) is free
    if (kt + kStages - 1 < chunks) issue(kt + kStages - 1);
    cp_async_commit();
    warp_tile(a_tile(kt % kStages), x_tile(kt % kStages), acc, wm, wn, lane);
  }

  // C fragment: rows g and g + 8, tokens 2q and 2q + 1; Tb even keeps pairs
  // aligned (a row starts at o * Tb)
  const int g = lane / 4, q = lane % 4;
  const size_t out_off = static_cast<size_t>(slab) * HD * Tb;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int o = m0 + wm * kWM + mi * 16 + g + 8 * half;
      if (o >= rows) continue;
      S* dst = (o < HD ? k_out + static_cast<size_t>(o) * Tb
                       : v_out + static_cast<size_t>(o - HD) * Tb) + out_off;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int t = n0 + wn * kWN + ni * 8 + 2 * q;
        const float c0 = acc[mi][ni][2 * half], c1 = acc[mi][ni][2 * half + 1];
        if (Tb % 2 == 0) {
          if (t < Tb) store_pair(dst + t, c0, c1);
        } else {
          if (t < Tb) dst[t] = commu::from_f<S>(c0);
          if (t + 1 < Tb) dst[t + 1] = commu::from_f<S>(c1);
        }
      }
    }
}

template <typename S>
size_t workspace_bytes(int D, int HD) {
  return static_cast<size_t>(depth_padded<S>(D)) * rows_padded(HD) * sizeof(S);
}

template <typename S, bool kVecX>
cudaError_t run_product(const S* mem, const S* wcat, S* k_out, S* v_out,
                        int layer, int R, int B, int D, int Tb, int HD, unsigned blocks,
                        cudaStream_t stream) {
  constexpr size_t smem = static_cast<size_t>(kStages) * stage_bytes<S>();
  const cudaError_t err = commu::allow_smem(project_mem_kv_kernel<S, kVecX>, smem);
  if (err != cudaSuccess) return err;
  project_mem_kv_kernel<S, kVecX><<<blocks, kThreads, smem, stream>>>(
      mem, wcat, k_out, v_out, layer, R, B, D, Tb, HD);
  return cudaGetLastError();
}

template <typename S>
int launch(const void* mem, const void* wk, const void* wv, void* k_out, void* v_out, void* work,
           int layer, int R, int B, int D, int Tb, int HD, cudaStream_t stream) {
  const int dp = depth_padded<S>(D), mp = rows_padded(HD);
  const long long blocks =
      static_cast<long long>(mp / kBM) * ((Tb + kBN - 1) / kBN) * B * R;
  if (blocks < 1 || blocks > 0x7fffffffLL || D < 1) return cudaErrorInvalidValue;
  S* wcat = static_cast<S*>(work);
  const long long cells = static_cast<long long>(dp) * mp;
  project_weights_kernel<S><<<static_cast<unsigned>((cells + kThreads - 1) / kThreads),
                              kThreads, 0, stream>>>(static_cast<const S*>(wk),
                                                     static_cast<const S*>(wv), wcat, D, HD,
                                                     dp, mp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const S* m = static_cast<const S*>(mem);
  S* k = static_cast<S*>(k_out);
  S* v = static_cast<S*>(v_out);
  const unsigned n = static_cast<unsigned>(blocks);
  if ((static_cast<size_t>(Tb) * sizeof(S)) % 16 == 0)
    return run_product<S, true>(m, wcat, k, v, layer, R, B, D, Tb, HD, n, stream);
  return run_product<S, false>(m, wcat, k, v, layer, R, B, D, Tb, HD, n, stream);
}

}  // namespace

extern "C" long long commu_project_mem_kv_workspace(int dtype, int D, int HD) {
  if (dtype == commu::kFloat32) return static_cast<long long>(workspace_bytes<float>(D, HD));
  return static_cast<long long>(workspace_bytes<__nv_bfloat16>(D, HD));
}

extern "C" int commu_project_mem_kv(int dtype, const void* mem, const void* wk, const void* wv,
                                    void* k_out, void* v_out, void* work, int layer, int R,
                                    int B, int D, int Tb, int HD, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == commu::kFloat32)
    return launch<float>(mem, wk, wv, k_out, v_out, work, layer, R, B, D, Tb, HD, s);
  if (dtype == commu::kBFloat16)
    return launch<__nv_bfloat16>(mem, wk, wv, k_out, v_out, work, layer, R, B, D, Tb, HD, s);
  return cudaErrorInvalidValue;
}
