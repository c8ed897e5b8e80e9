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
// 3.9 ms at 67 TFLOP/s), the second (PR 7) on mma.sync, which lost to one
// torch.matmul by 2.3x in bf16 at Transformer-XL's widths.
//
// Design: wgmma_product.cuh's warpgroup product (run_kv_product): a small
// kernel writes the joint weight [Wk | Wv] once a call into the workspace,
// K-major [rows][Dp] (f32: its TF32 hi and raw lo as two planes, 4 MB at
// the training widths, in L2); then a persistent grid of one block an SM,
// a producer warp keeping TMA loads of X and the weight tiles in flight
// and two consumer warpgroups on wgmma.mma_async, X as A from registers
// (64 tokens a warpgroup), the weight as B (256 rows a block in bf16, 128
// in f32); bf16 with f32 sums in the accumulator, f32 as 3xTF32 whose
// every 8-deep step is added to the sums in round-to-nearest f32, in the
// passes' order of the mma.sync tile it replaces (ops/fused_attention.py::
// tf32_split_product_plain(raw_lo=True) emulates the arithmetic on the
// CPU).  A slab whose rows are no whole 16 bytes (Tb * sizeof(S) % 16 != 0)
// stages X by plain loads into the same layout.
#include "wgmma_product.cuh"

namespace {

template <typename S>
int launch(const void* mem, const void* wk, const void* wv, void* k_out, void* v_out, void* work,
           int layer, int R, int B, int D, int Tb, int HD, cudaStream_t stream) {
  const S* ring = static_cast<const S*>(mem) + static_cast<size_t>(layer) * R * B * D * Tb;
  return wg::run_kv_product<S, S>(ring, static_cast<const S*>(wk), static_cast<const S*>(wv),
                                  static_cast<S*>(k_out), static_cast<S*>(v_out), work, R, B, D,
                                  Tb, HD, 2 * HD, stream);
}

}  // namespace

extern "C" long long commu_project_mem_kv_workspace(int dtype, int D, int HD) {
  if (dtype == commu::kFloat32) return static_cast<long long>(wg::kv_workspace<float>(D, 2 * HD));
  return static_cast<long long>(wg::kv_workspace<__nv_bfloat16>(D, 2 * HD));
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
