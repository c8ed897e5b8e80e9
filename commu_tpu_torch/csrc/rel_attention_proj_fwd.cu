// Relative-position attention forward over the XL memory and the window, with
// the memory's K/V projection inside the kernel.
//
// Replaces: commu_tpu/ops/fused_attention.py::_fwd_kernel_proj (:728), as
//   launched by _fused_fwd_proj (:784, pallas_call :845) from fused_core_mem
//   (:1638) and its VJP forward _fused_fwd_mem (:1655) when
//   COMMU_PROJ_IN_FWD=1: project_mem_kv.cu and rel_attention_mem_fwd.cu in one
//   kernel.  It reads the raw ring mem [L+1, R, B, D, Tb] at ``layer``,
//   projects this layer's K and V slabs, scores the queries against them and
//   the window, and writes the output, the projected slabs k_mem, v_mem
//   [B, R, H, dh, Tb] (the backward, rel_attention_mem_bwd.cu, reuses them
//   and does not project again) and, for a training forward, the residual
//   (S, lse).
//
// Per (batch row b, head h), with X_r = mem[layer, r, b] [D, Tb]:
//   k_mem[b, r, h] = rnd(Wk[:, h]^T X_r),  v_mem[b, r, h] = rnd(Wv[:, h]^T X_r)
// (Wk[:, h]: the dh columns of head h of Wk [D, H*dh], in the ring's dtype;
// f32 accumulation, rounded to the ring's dtype), then the forward of
// rel_attention_mem_fwd.cu over keys [ring slabs | window].
//
// What bounds it on the H100: arithmetic.  At the training shape (B = 256,
// H = 10, dh = 50, T = 128, M = 1024, D = 500, 2F = 512) the projection is
// 0.26 TFLOP a layer and the attention 0.45 TFLOP; the ring's layer is read
// once (262 MB in bf16), where the two-kernel path also writes the slabs and
// reads them back from device memory.
//
// Design: one block per (b, h), 256 threads.  The TPU kernel projects all
// heads of a batch row in one full-width product (an MXU matter); head h's
// keys need only columns h*dh .. (h+1)*dh of Wk, so a block projects its own
// [dh, M] slices and no product is done twice.  Phase 1: for every slab and
// every 64 tokens of it, a tile of [k dims | v dims] (two halves of 64 rows,
// the rows past dh zero) x 64 tokens, depth D in chunks of 16 staged in shared
// memory; a thread owns 8 rows x 4 tokens.  Each output is one fmaf chain over
// d = 0 .. D-1; project_mem_kv.cu sums on tensor cores in another order, so
// the slabs agree with its to the f32 tolerance, not bit for bit.  The block
// writes its slabs to k_mem, v_mem and, after
// a barrier, runs phase 2 on them: the first design of the memory forward
// (rel_attention_mem_fwd_body.cuh, FMA products), once per tile of 32 query
// rows; the memory forward itself runs on the tensor cores, so the two
// agree to the tolerance.  The
// slabs it reads back are its own writes (0.4 MB a block in f32: L2, not
// device memory); k_mem and v_mem carry no __restrict__, so those loads stay
// on the coherent path.
#include "rel_attention_mem_fwd_body.cuh"

namespace {

constexpr int kPK = 16;  // depth (d) per staged chunk of the projection
constexpr int kPN = 64;  // tokens per projection tile
constexpr int kPM = 2 * kMaxDh;  // rows per projection tile: k dims | v dims

template <typename S>
__global__ void __launch_bounds__(kThreads, 2)
rel_attention_proj_fwd_kernel(const S* __restrict__ q, const S* __restrict__ rwbs,
                              const S* __restrict__ rrbs, const S* __restrict__ mem,
                              const S* __restrict__ wk, const S* __restrict__ wv,
                              const S* __restrict__ k_win, const S* __restrict__ v_win,
                              const S* __restrict__ w_r, const S* __restrict__ trig_a,
                              const S* __restrict__ psi, const __nv_bfloat16* __restrict__ mask,
                              const int* __restrict__ reset, S* __restrict__ out, S* k_mem,
                              S* v_mem, float* __restrict__ s_res, float* __restrict__ lse,
                              int layer, int B, int H, int dh, int T, int R, int Tb, int D,
                              int F2, float scale, int seed, commu::Plane plane) {
  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int HD = H * dh;
  const int tid = threadIdx.x;

  // ---- phase 1: this head's K and V slabs
  float* w_s = smem;             // [kPK][kPM]: Wk columns of head h | Wv columns
  float* x_s = w_s + kPK * kPM;  // [kPK][kPN]
  const int ty = tid / 16;       // rows 8 ty + {0..7}: k dims below kMaxDh, v dims above
  const int tx = tid % 16;       // tokens 4 tx + {0..3}
  for (int r = 0; r < R; ++r) {
    const S* x = mem + ((static_cast<size_t>(layer) * R + r) * B + b) * D * Tb;
    const size_t slab = ((static_cast<size_t>(b) * R + r) * H + h) * dh * Tb;
    for (int t0 = 0; t0 < Tb; t0 += kPN) {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
      for (int d0 = 0; d0 < D; d0 += kPK) {
        __syncthreads();  // the previous chunk's readers are done
        for (int idx = tid; idx < kPK * kPM; idx += kThreads) {
          const int dd = idx / kPM;
          const int row = idx - dd * kPM;
          const int c = row % kMaxDh;
          const int d = d0 + dd;
          float w = 0.f;
          if (d < D && c < dh) {
            const S* src = row < kMaxDh ? wk : wv;
            w = commu::to_f(src[static_cast<size_t>(d) * HD + h * dh + c]);
          }
          w_s[idx] = w;
        }
        for (int idx = tid; idx < kPK * kPN; idx += kThreads) {
          const int dd = idx / kPN;
          const int tt = idx - dd * kPN;
          const int d = d0 + dd;
          const int t = t0 + tt;
          x_s[idx] = (d < D && t < Tb) ? commu::to_f(x[static_cast<size_t>(d) * Tb + t]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int dd = 0; dd < kPK; ++dd) {
          const float4 a0 = *reinterpret_cast<const float4*>(&w_s[dd * kPM + ty * 8]);
          const float4 a1 = *reinterpret_cast<const float4*>(&w_s[dd * kPM + ty * 8 + 4]);
          const float4 xv = *reinterpret_cast<const float4*>(&x_s[dd * kPN + tx * 4]);
          const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(a[i], xs[c], acc[i][c]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = ty * 8 + i;
        const int c = row % kMaxDh;
        if (c >= dh) continue;
        S* dst = (row < kMaxDh ? k_mem : v_mem) + slab + static_cast<size_t>(c) * Tb;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + tx * 4 + e;
          if (t < Tb) dst[t] = commu::from_f<S>(acc[i][e]);
        }
      }
    }
  }
  // the slabs this block wrote are visible to all of its threads after the
  // barrier; no other block reads or writes them
  __syncthreads();

  // ---- phase 2: the memory forward over them, one query tile at a time
  for (int q0 = 0; q0 < T; q0 += kQT)
    attend_query_tile<S>(smem, q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a, psi, mask,
                         reset, out, s_res, lse, bh, q0, H, dh, T, R, Tb, F2, scale, seed, plane);
}

template <typename S>
int launch(const void* q, const void* rwbs, const void* rrbs, const void* mem, const void* wk,
           const void* wv, const void* k_win, const void* v_win, const void* w_r,
           const void* trig_a, const void* psi, const void* mask, const void* reset, void* out,
           void* k_mem, void* v_mem, void* s_res, void* lse, int layer, int B, int H, int dh, int T,
           int R, int Tb, int D, int F2, float scale, int seed, int thresh, float keep_scale, int bits,
           cudaStream_t stream) {
  if (dh > kMaxDh) return cudaErrorInvalidValue;
  size_t smem = attend_smem_bytes(dh, F2);
  const size_t proj = sizeof(float) * (kPK * kPM + kPK * kPN);
  if (proj > smem) smem = proj;
  cudaError_t err = commu::allow_smem(rel_attention_proj_fwd_kernel<S>, smem);
  if (err != cudaSuccess) return err;
  rel_attention_proj_fwd_kernel<S><<<B * H, kThreads, smem, stream>>>(
      static_cast<const S*>(q), static_cast<const S*>(rwbs), static_cast<const S*>(rrbs),
      static_cast<const S*>(mem), static_cast<const S*>(wk), static_cast<const S*>(wv),
      static_cast<const S*>(k_win), static_cast<const S*>(v_win), static_cast<const S*>(w_r),
      static_cast<const S*>(trig_a), static_cast<const S*>(psi),
      static_cast<const __nv_bfloat16*>(mask), static_cast<const int*>(reset),
      static_cast<S*>(out), static_cast<S*>(k_mem), static_cast<S*>(v_mem),
      static_cast<float*>(s_res), static_cast<float*>(lse), layer, B, H, dh, T, R, Tb, D, F2,
      scale, seed, commu::make_plane(T, R * Tb + T, thresh, keep_scale, bits));
  return cudaGetLastError();
}

}  // namespace

extern "C" int commu_rel_attention_proj_fwd(
    int dtype, const void* q, const void* rwbs, const void* rrbs, const void* mem, const void* wk,
    const void* wv, const void* k_win, const void* v_win, const void* w_r, const void* trig_a,
    const void* psi, const void* mask, const void* reset, void* out, void* k_mem, void* v_mem,
    void* s_res, void* lse, int layer, int B, int H, int dh, int T, int R, int Tb, int D, int F2,
    float scale, int seed, int thresh, float keep_scale, int bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == commu::kFloat32)
    return launch<float>(q, rwbs, rrbs, mem, wk, wv, k_win, v_win, w_r, trig_a, psi, mask, reset,
                         out, k_mem, v_mem, s_res, lse, layer, B, H, dh, T, R, Tb, D, F2, scale,
                         seed, thresh, keep_scale, bits, s);
  if (dtype == commu::kBFloat16)
    return launch<__nv_bfloat16>(q, rwbs, rrbs, mem, wk, wv, k_win, v_win, w_r, trig_a, psi, mask,
                                 reset, out, k_mem, v_mem, s_res, lse, layer, B, H, dh, T, R, Tb,
                                 D, F2, scale, seed, thresh, keep_scale, bits, s);
  return cudaErrorInvalidValue;
}
