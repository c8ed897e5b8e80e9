// Fused post-attention block, backward, with the block's three dropouts.
//
// Replaces: commu_tpu/ops/fused_ffn.py::_ffn_bwd_kernel (:198), as launched
//   by _ffn_bwd_call (:397) from ffn_block's backward (:466).
//
// The forward (ffn_block_fwd.cu) is  z1 = x + o, a = LN1(z1),
// h1 = relu(W1^T a_c + b1), f = W2^T h1 + b2, y = LN2(a + f); it saved
// norm1, norm2, h1 (in S) and the rstds.  Per token column, with dy in:
//   dz2 = LN2'(dy)                        (_ln_bwd :82 on norm2, rstd2, g2)
//   dh1 = [h1 > 0] W2 dz2_c               [F]
//   da  = W1 dh1_c + dz2                  [D]  (the residual a + f)
//   dz1 = LN1'(da);  dx = do = dz1        (in S)
// and over all (b, t), in f32:
//   dW1 = sum a_c dh1_c^T [D, F],  dW2 = sum h1 dz2_c^T [F, D],
//   db1 = sum dh1, db2 = sum dz2, dg2 = sum dy norm2, dbe2 = sum dy,
//   dg1 = sum da norm1, dbe1 = sum da
// where a = norm1 g1 + be1 and _c marks a rounding to S, as the reference's
// casts to the compute dtype do (:228, :250, :267).
// With dropout (thresh > 0) the forward's masks O, H and F come back (prng.cuh,
// planes seeded with seed + b * 8192 + salt * 2048):
//   df  = mask_F(dz2) * scale feeds db2, dW2 and the W2 product (:246-255),
//         while the residual da = W1 dh1_c + dz2 keeps the unmasked dz2;
//   dh1 = [h1 > 0] W2 df_c * scale: the saved h1 carries mask H in its sign,
//         so the ReLU and the mask are one compare (:262-266);
//   dW2 takes the dropped h1 rebuilt as rnd(max(h1, 0) * scale) (:230-235);
//   do  = mask_O(dz1) * scale, a second output, while dx = dz1 (:280-284).
// With ``wo`` it is the fuse_o form (:288-299), the backward of
// ffn_block_fused_o (:505): the forward formed o = Wo^T vec itself from the
// attention vector vec [B, HD, T], so the row cotangent that leaves is
//   dvec = Wo do_c  [HD]   (do_c = do rounded to S; takes do's place)
// and over all (b, t)  dWo = sum vec do_c^T  [HD, D], f32.
//
// What bounds it on the H100: arithmetic.  Per token the two products with
// W2 and W1 cost 2 x D x F, and the weight gradients another 2 x D x F per
// token summed over B x T = 32,768 tokens at the training shape: 131 GFLOP a
// layer-step in all.
//
// Design: (1) one block per (b, 4 tokens), 256 threads: the tile's dy, norms,
// dz2 and dh1 live in shared memory; each product runs one warp per output
// row with the lanes along the weight row, so W1 and W2 are read coalesced
// from L2 and the dot products end in a warp sum; LayerNorm statistics are
// one warp per token.  It writes dx and the f32 dz2, dh1 and da to a
// workspace.  (2) The weight and vector gradients are sums over the batch:
// reduce.cuh's fixed-order two-pass reduction (no atomics).  The fuse_o form
// keeps do_c in the workspace and adds (1b), a kernel of the same tiling for
// the product Wo do_c with one warp per row of Wo, and one batch sum to (2).
// (Appended to kernel (1), that product made the compiler give its float32
// form 32 registers, and the whole kernel ran 2.3 times slower.)
#include "prng.cuh"
#include "reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTok = 4;  // token columns per block
constexpr int kSaltO = 0, kSaltF = 2;

// LayerNorm backward of kTok token rows in place: dn holds dy * g on entry
// and dz on exit; n holds the normalised values (reference _ln_bwd).
__device__ void ln_bwd_rows(float* dn, const float* n, const float* rstd, int D, int nt,
                            float* m1, float* m2) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp < kTok) {
    float s1 = 0.f, s2 = 0.f;
    if (warp < nt) {
      for (int d = lane; d < D; d += 32) {
        s1 += dn[warp * D + d];
        s2 = fmaf(dn[warp * D + d], n[warp * D + d], s2);
      }
    }
    s1 = commu::warp_sum(s1);
    s2 = commu::warp_sum(s2);
    if (lane == 0) {
      m1[warp] = s1 * (1.f / D);
      m2[warp] = s2 * (1.f / D);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kTok * D; idx += kThreads) {
    const int r = idx / D;
    dn[idx] = r < nt ? rstd[r] * (dn[idx] - m1[r] - n[idx] * m2[r]) : 0.f;
  }
  __syncthreads();
}

// kFuseO: the fuse_o form, a template parameter so that the plain form's code
// is what it was before the form existed
template <typename S, bool kFuseO>
__global__ void __launch_bounds__(kThreads)
ffn_block_bwd_rows_kernel(const S* __restrict__ w1, const S* __restrict__ w2,
                          const float* __restrict__ g1, const float* __restrict__ g2,
                          const S* __restrict__ norm1, const S* __restrict__ norm2,
                          const S* __restrict__ h1, const float* __restrict__ stats,
                          const S* __restrict__ dy, S* __restrict__ dx, S* __restrict__ do_out,
                          float* __restrict__ dz2_g, float* __restrict__ dh1_g,
                          float* __restrict__ da_g, float* __restrict__ doc_g, int D, int F,
                          int T, int seed, commu::Plane plane_d) {
  extern __shared__ float smem[];
  __shared__ float rstd[kTok], m1[kTok], m2[kTok];
  float* dz = smem;           // [kTok][D]: dz2 (f32), later da, then dz1
  float* n_s = dz + kTok * D;  // [kTok][D]: norm2, later norm1
  float* c_s = n_s + kTok * D;  // [kTok][D]: df (dz2 under mask F) rounded to S
  float* dh = c_s + kTok * D;   // [kTok][F]: dh1 rounded to S
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTok;
  const int nt = min(kTok, T - t0);
  const size_t base_d = static_cast<size_t>(b) * D * T;
  const size_t base_f = static_cast<size_t>(b) * F * T;
  const bool drop = plane_d.thresh > 0;
  const float keep_scale = plane_d.scale;
  const uint32_t seed_o = commu::plane_seed(seed, b, 8192, kSaltO * 2048);
  const uint32_t seed_f = commu::plane_seed(seed, b, 8192, kSaltF * 2048);

  // ---- LN2 backward
  for (int idx = tid; idx < kTok * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const size_t at = base_d + static_cast<size_t>(d) * T + t0 + r;
    dz[idx] = r < nt ? commu::to_f(dy[at]) * g2[d] : 0.f;
    n_s[idx] = r < nt ? commu::to_f(norm2[at]) : 0.f;
  }
  if (tid < kTok) rstd[tid] = tid < nt ? stats[(static_cast<size_t>(b) * 2 + 1) * T + t0 + tid] : 0.f;
  __syncthreads();
  ln_bwd_rows(dz, n_s, rstd, D, nt, m1, m2);
  for (int idx = tid; idx < kTok * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    float df = dz[idx];
    if (drop && r < nt) df = commu::keep(plane_d, seed_f, d, t0 + r) ? df * keep_scale : 0.f;
    c_s[idx] = commu::rnd<S>(df);
    if (r < nt) dz2_g[base_d + static_cast<size_t>(d) * T + t0 + r] = df;
  }
  __syncthreads();

  // ---- dh1 = [h1 > 0] W2 df_c * scale: one warp per hidden unit f, lanes along d
  for (int f = warp; f < F; f += kWarps) {
    const S* wrow = w2 + static_cast<size_t>(f) * D;
    float acc[kTok];
#pragma unroll
    for (int r = 0; r < kTok; ++r) acc[r] = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float w = commu::to_f(wrow[d]);
#pragma unroll
      for (int r = 0; r < kTok; ++r) acc[r] = fmaf(w, c_s[r * D + d], acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kTok; ++r) {
      const float sum = commu::warp_sum(acc[r]);
      if (lane == r) {
        float val = 0.f;
        if (r < nt) {
          const size_t at = base_f + static_cast<size_t>(f) * T + t0 + r;
          val = commu::to_f(h1[at]) > 0.f ? sum * keep_scale : 0.f;
          dh1_g[at] = val;
        }
        dh[r * F + f] = commu::rnd<S>(val);
      }
    }
  }
  __syncthreads();

  // ---- da = W1 dh1_c + dz2: one warp per feature d, lanes along f
  for (int d = warp; d < D; d += kWarps) {
    const S* wrow = w1 + static_cast<size_t>(d) * F;
    float acc[kTok];
#pragma unroll
    for (int r = 0; r < kTok; ++r) acc[r] = 0.f;
    for (int f = lane; f < F; f += 32) {
      const float w = commu::to_f(wrow[f]);
#pragma unroll
      for (int r = 0; r < kTok; ++r) acc[r] = fmaf(w, dh[r * F + f], acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kTok; ++r) {
      const float sum = commu::warp_sum(acc[r]);
      if (lane == r) dz[r * D + d] += sum;  // now da
    }
  }
  __syncthreads();

  // ---- LN1 backward: da -> dz1
  for (int idx = tid; idx < kTok * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const size_t at = base_d + static_cast<size_t>(d) * T + t0 + r;
    n_s[idx] = r < nt ? commu::to_f(norm1[at]) : 0.f;
    if (r < nt) da_g[at] = dz[idx];
    dz[idx] *= g1[d];
  }
  if (tid < kTok) rstd[tid] = tid < nt ? stats[(static_cast<size_t>(b) * 2) * T + t0 + tid] : 0.f;
  __syncthreads();
  ln_bwd_rows(dz, n_s, rstd, D, nt, m1, m2);
  for (int idx = tid; idx < kTok * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    if (r < nt) {
      const size_t at = base_d + static_cast<size_t>(d) * T + t0 + r;
      dx[at] = commu::from_f<S>(dz[idx]);
      float dov = dz[idx];
      if (drop) dov = commu::keep(plane_d, seed_o, d, t0 + r) ? dz[idx] * keep_scale : 0.f;
      if (kFuseO) {
        doc_g[at] = commu::rnd<S>(dov);  // do_c, for dvec and dWo
      } else if (drop) {
        do_out[at] = commu::from_f<S>(dov);
      }
    }
  }
}

// ---- fuse_o: dvec = Wo do_c over one (b, kTok tokens) tile: do_c staged in
// shared memory, one warp per row c of Wo, lanes along d
template <typename S>
__global__ void __launch_bounds__(kThreads)
ffn_block_bwd_dvec_kernel(const S* __restrict__ wo, const float* __restrict__ doc_g,
                          S* __restrict__ dvec, int D, int T, int HD) {
  extern __shared__ float c_s[];  // [kTok][D]
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTok;
  const int nt = min(kTok, T - t0);
  const size_t base_d = static_cast<size_t>(b) * D * T;
  for (int idx = tid; idx < kTok * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    c_s[idx] = r < nt ? doc_g[base_d + static_cast<size_t>(d) * T + t0 + r] : 0.f;
  }
  __syncthreads();
  for (int c = warp; c < HD; c += kWarps) {
    const S* wrow = wo + static_cast<size_t>(c) * D;
    float acc[kTok];
#pragma unroll
    for (int r = 0; r < kTok; ++r) acc[r] = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float w = commu::to_f(wrow[d]);
#pragma unroll
      for (int r = 0; r < kTok; ++r) acc[r] = fmaf(w, c_s[r * D + d], acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kTok; ++r) {
      const float sum = commu::warp_sum(acc[r]);
      if (lane == r && r < nt)
        dvec[(static_cast<size_t>(b) * HD + c) * T + t0 + r] = commu::from_f<S>(sum);
    }
  }
}

// [B, M, T] operand of the batch sums, optionally rounded to S, optionally
// times a second [B, M, T] tensor or scaled and shifted per row m
template <typename V, typename S, bool kRound>
struct Field {
  const V* x;
  int M, T;
  __device__ float operator()(int, int b, int m, int t) const {
    const float v = commu::to_f(x[(static_cast<size_t>(b) * M + m) * T + t]);
    return kRound ? commu::rnd<S>(v) : v;
  }
};

template <typename V, typename W>
struct Product {
  const V* x;
  const W* y;
  int M, T;
  __device__ float operator()(int, int b, int m, int t) const {
    const size_t at = (static_cast<size_t>(b) * M + m) * T + t;
    return commu::to_f(x[at]) * commu::to_f(y[at]);
  }
};

// The dropped h1 the forward fed W2, rebuilt from the saved (sign-encoded)
// one: rnd(max(h1, 0) * scale); without dropout h1 itself
template <typename S>
struct DroppedH1 {
  const S* h1;
  float scale;
  int M, T;
  __device__ float operator()(int, int b, int m, int t) const {
    const float v = commu::to_f(h1[(static_cast<size_t>(b) * M + m) * T + t]);
    return commu::rnd<S>(fmaxf(v, 0.f) * scale);
  }
};

// a_c = rnd(norm1 * g1 + be1), the forward's rounded LN1 output
template <typename S>
struct LnOut {
  const S* norm;
  const float* g;
  const float* be;
  int M, T;
  __device__ float operator()(int, int b, int m, int t) const {
    const float n = commu::to_f(norm[(static_cast<size_t>(b) * M + m) * T + t]);
    return commu::rnd<S>(n * g[m] + be[m]);
  }
};

struct Buffers {
  float *dz2, *dh1, *da, *doc, *scratch;
};

// HD: rows of Wo in the fuse_o form, 0 in the plain form
size_t workspace(commu::Workspace& ws, Buffers* buf, int B, int D, int F, int T, int HD) {
  buf->dz2 = ws.take<float>(static_cast<size_t>(B) * D * T);
  buf->dh1 = ws.take<float>(static_cast<size_t>(B) * F * T);
  buf->da = ws.take<float>(static_cast<size_t>(B) * D * T);
  buf->doc = ws.take<float>(HD > 0 ? static_cast<size_t>(B) * D * T : 0);
  size_t red = commu::outer_scratch(1, D, F, B);
  const size_t sizes[4] = {commu::outer_scratch(1, F, D, B), commu::rowsum_scratch(1, F, B),
                           commu::rowsum_scratch(1, D, B),
                           HD > 0 ? commu::outer_scratch(1, HD, D, B) : 0};
  for (size_t s : sizes) red = s > red ? s : red;
  buf->scratch = ws.take<float>(red / sizeof(float));
  return ws.used;
}

template <typename S>
int launch(const void* w1_, const void* w2_, const void* g1_, const void* be1_, const void* g2_,
           const void* norm1_, const void* norm2_, const void* h1_, const void* stats,
           const void* dy_, const void* vec_, const void* wo_, void* dx, void* do_out,
           void* dvec, void* dw1, void* db1, void* dw2, void* db2, void* dg1, void* dbe1,
           void* dg2, void* dbe2, void* dwo, void* work, int B, int D, int F, int T, int HD,
           int seed, int thresh, float keep_scale, int bits, cudaStream_t stream) {
  const bool fuse_o = wo_ != nullptr;
  if (fuse_o ? (HD < 1 || vec_ == nullptr || dvec == nullptr || dwo == nullptr)
             : (thresh > 0 && do_out == nullptr))
    return cudaErrorInvalidValue;
  if (!fuse_o) HD = 0;
  commu::Workspace ws{static_cast<char*>(work), 0};
  Buffers buf;
  workspace(ws, &buf, B, D, F, T, HD);
  const S* norm1 = static_cast<const S*>(norm1_);
  const S* norm2 = static_cast<const S*>(norm2_);
  const S* h1 = static_cast<const S*>(h1_);
  const S* dy = static_cast<const S*>(dy_);
  const float* g1 = static_cast<const float*>(g1_);
  const size_t smem = sizeof(float) * (3 * static_cast<size_t>(kTok) * D + kTok * F);
  auto rows_kernel =
      fuse_o ? ffn_block_bwd_rows_kernel<S, true> : ffn_block_bwd_rows_kernel<S, false>;
  cudaError_t err = commu::allow_smem(rows_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kTok - 1) / kTok, B);
  rows_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const S*>(w1_), static_cast<const S*>(w2_), g1,
      static_cast<const float*>(g2_), norm1, norm2, h1, static_cast<const float*>(stats), dy,
      static_cast<S*>(dx), static_cast<S*>(do_out), buf.dz2, buf.dh1, buf.da, buf.doc, D, F, T,
      seed, commu::make_plane(D, T, thresh, keep_scale, bits));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (fuse_o) {
    const size_t smem_c = sizeof(float) * kTok * D;
    err = commu::allow_smem(ffn_block_bwd_dvec_kernel<S>, smem_c);
    if (err != cudaSuccess) return err;
    ffn_block_bwd_dvec_kernel<S><<<grid, kThreads, smem_c, stream>>>(
        static_cast<const S*>(wo_), buf.doc, static_cast<S*>(dvec), D, T, HD);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  float* scr = buf.scratch;
  const LnOut<S> a_c{norm1, g1, static_cast<const float*>(be1_), D, T};
  const Field<float, S, true> dh1_c{buf.dh1, F, T};
  const Field<float, S, true> dz2_c{buf.dz2, D, T};
  const DroppedH1<S> h1_d{h1, keep_scale, F, T};
#define COMMU_TRY(call)            \
  do {                             \
    err = (call);                  \
    if (err != cudaSuccess) return err; \
  } while (0)
  COMMU_TRY(commu::reduce_outer(a_c, dh1_c, static_cast<float*>(dw1), scr, 1, D, F, B, T, stream));
  COMMU_TRY(commu::reduce_outer(h1_d, dz2_c, static_cast<float*>(dw2), scr, 1, F, D, B, T, stream));
  COMMU_TRY(commu::reduce_rows(Field<float, S, false>{buf.dh1, F, T}, static_cast<float*>(db1),
                               scr, 1, F, B, T, stream));
  COMMU_TRY(commu::reduce_rows(Field<float, S, false>{buf.dz2, D, T}, static_cast<float*>(db2),
                               scr, 1, D, B, T, stream));
  COMMU_TRY(commu::reduce_rows(Product<S, S>{dy, norm2, D, T}, static_cast<float*>(dg2), scr, 1,
                               D, B, T, stream));
  COMMU_TRY(commu::reduce_rows(Field<S, S, false>{dy, D, T}, static_cast<float*>(dbe2), scr, 1,
                               D, B, T, stream));
  COMMU_TRY(commu::reduce_rows(Product<float, S>{buf.da, norm1, D, T}, static_cast<float*>(dg1),
                               scr, 1, D, B, T, stream));
  COMMU_TRY(commu::reduce_rows(Field<float, S, false>{buf.da, D, T}, static_cast<float*>(dbe1),
                               scr, 1, D, B, T, stream));
  if (fuse_o)
    COMMU_TRY(commu::reduce_outer(Field<S, S, false>{static_cast<const S*>(vec_), HD, T},
                                  Field<float, S, false>{buf.doc, D, T},
                                  static_cast<float*>(dwo), scr, 1, HD, D, B, T, stream));
#undef COMMU_TRY
  return cudaSuccess;
}

}  // namespace

extern "C" long long commu_ffn_block_bwd_workspace(int B, int D, int F, int T, int HD) {
  commu::Workspace ws{nullptr, 0};
  Buffers buf;
  return static_cast<long long>(workspace(ws, &buf, B, D, F, T, HD));
}

extern "C" int commu_ffn_block_bwd(int dtype, const void* w1, const void* w2, const void* g1,
                                   const void* be1, const void* g2, const void* norm1,
                                   const void* norm2, const void* h1, const void* stats,
                                   const void* dy, const void* vec, const void* wo, void* dx,
                                   void* do_out, void* dvec, void* dw1, void* db1, void* dw2,
                                   void* db2, void* dg1, void* dbe1, void* dg2, void* dbe2,
                                   void* dwo, void* work, int B, int D, int F, int T, int HD,
                                   int seed, int thresh, float keep_scale, int bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == commu::kFloat32)
    return launch<float>(w1, w2, g1, be1, g2, norm1, norm2, h1, stats, dy, vec, wo, dx, do_out,
                         dvec, dw1, db1, dw2, db2, dg1, dbe1, dg2, dbe2, dwo, work, B, D, F, T,
                         HD, seed, thresh, keep_scale, bits, s);
  if (dtype == commu::kBFloat16)
    return launch<__nv_bfloat16>(w1, w2, g1, be1, g2, norm1, norm2, h1, stats, dy, vec, wo, dx,
                                 do_out, dvec, dw1, db1, dw2, db2, dg1, dbe1, dg2, dbe2, dwo,
                                 work, B, D, F, T, HD, seed, thresh, keep_scale, bits, s);
  return cudaErrorInvalidValue;
}
