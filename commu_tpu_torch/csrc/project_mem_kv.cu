// Memory K/V projection of one layer's blocked XL-memory ring.
//
// Replaces: commu_tpu/ops/fused_attention.py::_proj_mem_kernel (:1539), as
//   launched by project_mem_kv (:1576, pallas_call :1608).
//
// For every batch row b and ring slab r, with X = mem[layer, r, b] [D, Tb]:
//   k[b, r] = Wk^T X,  v[b, r] = Wv^T X          Wk, Wv [D, H*dh] -> [H*dh, Tb]
// written as k, v [B, R, H, dh, Tb] in the memory's dtype; products
// accumulate in f32.  The layer is block-indexed inside the buffer: no
// mem[layer] copy is made.
//
// What bounds it on the H100: arithmetic.  At the eval shape (B = 10, R = 16,
// D = H*dh = 500, Tb = 128) it is 2 x 160 products of [500 x 500][500 x 128],
// about 20 GFLOP per layer, against 2 x 64 MB read and written (f32) -- about
// 160 FLOP per byte, above the bandwidth line for the FMA units.
//
// Design: a shared-memory tiled product with FMA (no tensor cores: f32 must
// stay f32, and dh = 50 is no MMA width).  One block per (64 output rows,
// 64 tokens, slab); each depth chunk of 16 loads one X tile and the matching
// Wk and Wv tiles, so the memory is read once for both K and V.  256 threads,
// each owning a 4 x 4 tile of K and of V (32 accumulators): every shared
// load feeds 8 FMAs.  Ragged edges (D = 500, H*dh = 500) are zero-filled.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;  // output rows (h, c) per block
constexpr int kBN = 64;  // tokens per block
constexpr int kBK = 16;  // depth (d) per chunk

template <typename S>
__global__ void __launch_bounds__(kThreads)
project_mem_kv_kernel(const S* __restrict__ mem, const S* __restrict__ wk,
                      const S* __restrict__ wv, S* __restrict__ k_out, S* __restrict__ v_out,
                      int layer, int R, int B, int D, int Tb, int HD) {
  __shared__ __align__(16) float wk_s[kBK][kBM];
  __shared__ __align__(16) float wv_s[kBK][kBM];
  __shared__ __align__(16) float x_s[kBK][kBN];
  const int o0 = blockIdx.x * kBM;
  const int t0 = blockIdx.y * kBN;
  const int slab = blockIdx.z;  // b * R + r: the output's order
  const int b = slab / R;
  const int r = slab - b * R;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // output rows o0 + 4 ty ..
  const int tx = tid % 16;  // tokens t0 + 4 tx ..
  const S* x = mem + ((static_cast<size_t>(layer) * R + r) * B + b) * D * Tb;

  float acc_k[4][4], acc_v[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int d0 = 0; d0 < D; d0 += kBK) {
    for (int idx = tid; idx < kBK * kBM; idx += kThreads) {
      const int dd = idx / kBM;
      const int oo = idx - dd * kBM;
      const int d = d0 + dd;
      const int o = o0 + oo;
      const bool in = d < D && o < HD;
      wk_s[dd][oo] = in ? commu::to_f(wk[static_cast<size_t>(d) * HD + o]) : 0.f;
      wv_s[dd][oo] = in ? commu::to_f(wv[static_cast<size_t>(d) * HD + o]) : 0.f;
    }
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      const int dd = idx / kBN;
      const int tt = idx - dd * kBN;
      const int d = d0 + dd;
      const int t = t0 + tt;
      x_s[dd][tt] = (d < D && t < Tb) ? commu::to_f(x[static_cast<size_t>(d) * Tb + t]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int dd = 0; dd < kBK; ++dd) {
      const float4 a_k = *reinterpret_cast<const float4*>(&wk_s[dd][ty * 4]);
      const float4 a_v = *reinterpret_cast<const float4*>(&wv_s[dd][ty * 4]);
      const float4 xv = *reinterpret_cast<const float4*>(&x_s[dd][tx * 4]);
      const float ak[4] = {a_k.x, a_k.y, a_k.z, a_k.w};
      const float av[4] = {a_v.x, a_v.y, a_v.z, a_v.w};
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc_k[i][c] = fmaf(ak[i], xs[c], acc_k[i][c]);
          acc_v[i][c] = fmaf(av[i], xs[c], acc_v[i][c]);
        }
    }
    __syncthreads();
  }

  const size_t out_off = static_cast<size_t>(slab) * HD * Tb;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = o0 + ty * 4 + i;
    if (o >= HD) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int t = t0 + tx * 4 + c;
      if (t >= Tb) continue;
      k_out[out_off + static_cast<size_t>(o) * Tb + t] = commu::from_f<S>(acc_k[i][c]);
      v_out[out_off + static_cast<size_t>(o) * Tb + t] = commu::from_f<S>(acc_v[i][c]);
    }
  }
}

template <typename S>
int launch(const void* mem, const void* wk, const void* wv, void* k_out, void* v_out, int layer,
           int R, int B, int D, int Tb, int HD, cudaStream_t stream) {
  const dim3 grid((HD + kBM - 1) / kBM, (Tb + kBN - 1) / kBN, B * R);
  project_mem_kv_kernel<S><<<grid, kThreads, 0, stream>>>(
      static_cast<const S*>(mem), static_cast<const S*>(wk), static_cast<const S*>(wv),
      static_cast<S*>(k_out), static_cast<S*>(v_out), layer, R, B, D, Tb, HD);
  return cudaGetLastError();
}

}  // namespace

extern "C" int commu_project_mem_kv(int dtype, const void* mem, const void* wk, const void* wv,
                                    void* k_out, void* v_out, int layer, int R, int B, int D,
                                    int Tb, int HD, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == commu::kFloat32)
    return launch<float>(mem, wk, wv, k_out, v_out, layer, R, B, D, Tb, HD, s);
  if (dtype == commu::kBFloat16)
    return launch<__nv_bfloat16>(mem, wk, wv, k_out, v_out, layer, R, B, D, Tb, HD, s);
  return cudaErrorInvalidValue;
}
