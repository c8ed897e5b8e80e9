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
// What bounds it on the H100: tensor-core arithmetic.  The products with W2
// and W1 cost 2 x D x F a token each, and the weight gradients as much
// again: 8 x D x F x B x T = 131 GFLOP a layer-step at the training shape
// (B = 256, T = 128, D = 500, F = 1000), 0.79 ms at the dense TF32 rate with
// the three passes of 3xTF32 counted (f32) and 0.13 ms at the bf16 rate;
// the bytes it must move take 0.14 ms in f32.
//
// Design of the plain form, the operands lying [B, ., T] with T contiguous;
// every product on the tensor cores (3xTF32 on mma.sync m16n8k8 in f32, bf16
// m16n8k16 with f32 accumulation in bf16, where every operand is an S value
// already, so each product is exact):
//   (0) pad_weights (ffn_pad.cuh): W2^T and W1^T, depth-major and
//       zero-padded to whole tiles, into the workspace once a call (2 MB
//       each in f32, in L2);
//   (1) ln2_bwd_kernel: one block per (b, 32 token columns), a lane a column
//       and the warps over d, every load a coalesced row piece; the column
//       sums over D in registers, then across the warps in a fixed order.
//       Writes df_c (S) and the unmasked f32 dz2, and per block the sums of
//       dy, dy norm2 and df over its columns (dbe2, dg2, db2);
//   (2) tile_product_kernel: dh1 = W2 df_c per batch row in 128 x 128 tiles
//       (mma_tile.cuh, the tile of project_mem_kv.cu), the depth through a
//       4-stage cp.async ring; the epilogue reads h1, applies
//       the select and writes dh1_c, the rebuilt h1_d and the tile's row
//       sums of dh1 (db1);
//   (3) tile_product_kernel: da = W1 dh1_c + dz2, dz2 added in f32;
//   (4) ln1_bwd_kernel, as (1): dx, do, a_c, and the sums for dg1 and dbe1;
//   (5) dW1 = sum a_c dh1_c^T, dW2 = sum h1_d df_c^T over the B x T tokens:
//       reduce.cuh's reduce_outer_copy, 128 x 128 tiles from cp.async-staged
//       t-contiguous operands on the same tensor cores;
//   (6) sum_partials_kernel: the six vector sums from the per-block
//       sums, in a fixed order, in one launch.
// df_c, dh1_c, h1_d and a_c lie [B][rows rounded up to 32][Tp], Tp = T
// rounded up to 32, with zeros in the padding, so every staged copy is a
// whole, aligned 16 bytes and any T takes the copy form of the sums.
// No float atomics anywhere: two runs on the same inputs give the same bits.
//
// The fuse_o form keeps the first design: (1) one block per (b, 4 tokens),
// 256 threads: the tile's dy, norms, dz2 and dh1 live in shared memory; each
// product runs one warp per output row with the lanes along the weight row,
// so W1 and W2 are read coalesced from L2 and the dot products end in a warp
// sum; LayerNorm statistics are one warp per token.  It writes dx and the f32
// dz2, dh1, da and do_c to a workspace; (1b) a kernel of the same tiling for
// the product Wo do_c with one warp per row of Wo; (2) the weight and vector
// gradients by reduce.cuh's f32 FMA reduce_outer and reduce_rows.  (Appended
// to kernel (1), the Wo product made the compiler give its float32 form 32
// registers, and the whole kernel ran 2.3 times slower.)
#include "ffn_pad.cuh"
#include "prng.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSaltO = 0, kSaltF = 2;

// ---- the fuse_o form

constexpr int kTok = 4;  // token columns per block

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

template <typename S>
__global__ void __launch_bounds__(kThreads)
ffn_block_bwd_rows_kernel(const S* __restrict__ w1, const S* __restrict__ w2,
                          const float* __restrict__ g1, const float* __restrict__ g2,
                          const S* __restrict__ norm1, const S* __restrict__ norm2,
                          const S* __restrict__ h1, const float* __restrict__ stats,
                          const S* __restrict__ dy, S* __restrict__ dx,
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
      doc_g[at] = commu::rnd<S>(dov);  // do_c, for dvec and dWo
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

// HD: rows of Wo
size_t workspace(commu::Workspace& ws, Buffers* buf, int B, int D, int F, int T, int HD) {
  buf->dz2 = ws.take<float>(static_cast<size_t>(B) * D * T);
  buf->dh1 = ws.take<float>(static_cast<size_t>(B) * F * T);
  buf->da = ws.take<float>(static_cast<size_t>(B) * D * T);
  buf->doc = ws.take<float>(static_cast<size_t>(B) * D * T);
  size_t red = commu::outer_scratch(1, D, F, B);
  const size_t sizes[4] = {commu::outer_scratch(1, F, D, B), commu::rowsum_scratch(1, F, B),
                           commu::rowsum_scratch(1, D, B),
                           commu::outer_scratch(1, HD, D, B)};
  for (size_t s : sizes) red = s > red ? s : red;
  buf->scratch = ws.take<float>(red / sizeof(float));
  return ws.used;
}

template <typename S>
int launch_fused_o(const void* w1_, const void* w2_, const void* g1_, const void* be1_,
                   const void* g2_, const void* norm1_, const void* norm2_, const void* h1_,
                   const void* stats, const void* dy_, const void* vec_, const void* wo_,
                   void* dx, void* dvec, void* dw1, void* db1, void* dw2,
                   void* db2, void* dg1, void* dbe1, void* dg2, void* dbe2, void* dwo,
                   void* work, int B, int D, int F, int T, int HD, int seed, int thresh,
                   float keep_scale, int bits, cudaStream_t stream) {
  if (HD < 1 || vec_ == nullptr || dvec == nullptr || dwo == nullptr)
    return cudaErrorInvalidValue;
  commu::Workspace ws{static_cast<char*>(work), 0};
  Buffers buf;
  workspace(ws, &buf, B, D, F, T, HD);
  const S* norm1 = static_cast<const S*>(norm1_);
  const S* norm2 = static_cast<const S*>(norm2_);
  const S* h1 = static_cast<const S*>(h1_);
  const S* dy = static_cast<const S*>(dy_);
  const float* g1 = static_cast<const float*>(g1_);
  const size_t smem = sizeof(float) * (3 * static_cast<size_t>(kTok) * D + kTok * F);
  cudaError_t err = commu::allow_smem(ffn_block_bwd_rows_kernel<S>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kTok - 1) / kTok, B);
  ffn_block_bwd_rows_kernel<S><<<grid, kThreads, smem, stream>>>(
      static_cast<const S*>(w1_), static_cast<const S*>(w2_), g1,
      static_cast<const float*>(g2_), norm1, norm2, h1, static_cast<const float*>(stats), dy,
      static_cast<S*>(dx), buf.dz2, buf.dh1, buf.da, buf.doc, D, F, T, seed,
      commu::make_plane(D, T, thresh, keep_scale, bits));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_c = sizeof(float) * kTok * D;
  err = commu::allow_smem(ffn_block_bwd_dvec_kernel<S>, smem_c);
  if (err != cudaSuccess) return err;
  ffn_block_bwd_dvec_kernel<S><<<grid, kThreads, smem_c, stream>>>(
      static_cast<const S*>(wo_), buf.doc, static_cast<S*>(dvec), D, T, HD);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

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
  COMMU_TRY(commu::reduce_outer(Field<S, S, false>{static_cast<const S*>(vec_), HD, T},
                                Field<float, S, false>{buf.doc, D, T},
                                static_cast<float*>(dwo), scr, 1, HD, D, B, T, stream));
#undef COMMU_TRY
  return cudaSuccess;
}

// ---- the plain form

// The per-column sums of a LayerNorm backward over the D rows: each warp
// sums its rows d = warp, warp + 8, ... in order, then the warps in order.
__device__ __forceinline__ void column_means(float s1, float s2, int D, float* m1, float* m2) {
  __shared__ float s1_s[kWarps][kCols], s2_s[kWarps][kCols];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  s1_s[warp][lane] = s1;
  s2_s[warp][lane] = s2;
  __syncthreads();
  float a = 0.f, c = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    a += s1_s[w][lane];
    c += s2_s[w][lane];
  }
  *m1 = a * (1.f / D);
  *m2 = c * (1.f / D);
}

// (1) LN2 backward: one block per (b, 32 token columns), a lane a column,
// the warps over d, so every load is a coalesced row piece.  Writes df_c
// (S, [B][Dp][Tp], zero-padded: the dh1 product's operand and dW2's), the
// unmasked f32 dz2 ([B][D][Tp], the residual), and per block its columns'
// sums of dy, dy norm2 and df for dbe2, dg2 and db2 (part [groups][D],
// group = b * Tp / 32 + column chunk = blockIdx.x).
template <typename S>
__global__ void __launch_bounds__(kThreads)
ln2_bwd_kernel(const float* __restrict__ g2, const S* __restrict__ norm2,
               const float* __restrict__ stats, const S* __restrict__ dy, S* __restrict__ dfc,
               float* __restrict__ dz2, float* __restrict__ part_dbe2,
               float* __restrict__ part_dg2, float* __restrict__ part_db2, Dims z, int seed,
               commu::Plane plane) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = z.Tp / kCols;
  const int b = blockIdx.x / chunks;
  const int t = (blockIdx.x - b * chunks) * kCols + lane;
  const bool live = t < z.T;
  const int D = z.D;
  const size_t at_in = static_cast<size_t>(b) * D * z.T + t;     // + d T: dy, norm2
  const size_t at_dz = static_cast<size_t>(b) * D * z.Tp + t;    // + d Tp: dz2
  const size_t at_c = static_cast<size_t>(b) * z.Dp * z.Tp + t;  // + d Tp: df_c
  const size_t part_at = static_cast<size_t>(blockIdx.x) * D;
  float s1 = 0.f, s2 = 0.f;
  for (int d = warp; d < D; d += kWarps) {
    const float y = live ? commu::to_f(dy[at_in + static_cast<size_t>(d) * z.T]) : 0.f;
    const float n = live ? commu::to_f(norm2[at_in + static_cast<size_t>(d) * z.T]) : 0.f;
    const float dn = y * g2[d];
    s1 += dn;
    s2 = fmaf(dn, n, s2);
    const float sum_y = commu::warp_sum(y), sum_yn = commu::warp_sum(y * n);
    if (lane == 0) {
      part_dbe2[part_at + d] = sum_y;
      part_dg2[part_at + d] = sum_yn;
    }
  }
  float m1, m2;
  column_means(s1, s2, D, &m1, &m2);
  const float rstd = live ? stats[(static_cast<size_t>(b) * 2 + 1) * z.T + t] : 0.f;
  const bool drop = plane.thresh > 0;
  const uint32_t seed_f = commu::plane_seed(seed, b, 8192, kSaltF * 2048);
  for (int d = warp; d < z.Dp; d += kWarps) {
    float df = 0.f;
    if (d < D) {
      if (live) {
        const float y = commu::to_f(dy[at_in + static_cast<size_t>(d) * z.T]);
        const float n = commu::to_f(norm2[at_in + static_cast<size_t>(d) * z.T]);
        const float dz = rstd * (y * g2[d] - m1 - n * m2);
        dz2[at_dz + static_cast<size_t>(d) * z.Tp] = dz;
        df = dz;
        if (drop) df = commu::keep(plane, seed_f, d, t) ? dz * plane.scale : 0.f;
      }
      const float sum_df = commu::warp_sum(df);
      if (lane == 0) part_db2[part_at + d] = sum_df;
    }
    dfc[at_c + static_cast<size_t>(d) * z.Tp] = commu::from_f<S>(df);
  }
}

// (4) LN1 backward, as (1) on da and norm1: writes dx, do (dropout only),
// a_c = rnd(norm1 g1 + be1) (S, [B][Dp][Tp], zero columns past T: dW1's
// operand) and per block its columns' sums of da norm1 and da (dg1, dbe1).
template <typename S>
__global__ void __launch_bounds__(kThreads)
ln1_bwd_kernel(const float* __restrict__ g1, const float* __restrict__ be1,
               const S* __restrict__ norm1, const float* __restrict__ stats,
               const float* __restrict__ da, S* __restrict__ dx, S* __restrict__ do_out,
               S* __restrict__ ac, float* __restrict__ part_dg1, float* __restrict__ part_dbe1,
               Dims z, int seed, commu::Plane plane) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = z.Tp / kCols;
  const int b = blockIdx.x / chunks;
  const int t = (blockIdx.x - b * chunks) * kCols + lane;
  const bool live = t < z.T;
  const int D = z.D;
  const size_t at_in = static_cast<size_t>(b) * D * z.T + t;     // + d T: norm1, dx, do
  const size_t at_da = static_cast<size_t>(b) * D * z.Tp + t;    // + d Tp: da
  const size_t at_c = static_cast<size_t>(b) * z.Dp * z.Tp + t;  // + d Tp: a_c
  const size_t part_at = static_cast<size_t>(blockIdx.x) * D;
  float s1 = 0.f, s2 = 0.f;
  for (int d = warp; d < D; d += kWarps) {
    const float a = live ? da[at_da + static_cast<size_t>(d) * z.Tp] : 0.f;
    const float n = live ? commu::to_f(norm1[at_in + static_cast<size_t>(d) * z.T]) : 0.f;
    const float dn = a * g1[d];
    s1 += dn;
    s2 = fmaf(dn, n, s2);
    const float sum_an = commu::warp_sum(a * n), sum_a = commu::warp_sum(a);
    if (lane == 0) {
      part_dg1[part_at + d] = sum_an;
      part_dbe1[part_at + d] = sum_a;
    }
  }
  float m1, m2;
  column_means(s1, s2, D, &m1, &m2);
  const float rstd = live ? stats[static_cast<size_t>(b) * 2 * z.T + t] : 0.f;
  const bool drop = plane.thresh > 0;
  const uint32_t seed_o = commu::plane_seed(seed, b, 8192, kSaltO * 2048);
  for (int d = warp; d < D; d += kWarps) {
    float a_c = 0.f;
    if (live) {
      const size_t at = at_in + static_cast<size_t>(d) * z.T;
      const float a = da[at_da + static_cast<size_t>(d) * z.Tp];
      const float n = commu::to_f(norm1[at]);
      const float dz1 = rstd * (a * g1[d] - m1 - n * m2);
      dx[at] = commu::from_f<S>(dz1);
      if (drop)
        do_out[at] = commu::from_f<S>(commu::keep(plane, seed_o, d, t) ? dz1 * plane.scale : 0.f);
      // the reference's a = norm1 g1 + be1 (two roundings), cast to S
      a_c = __fadd_rn(__fmul_rn(n, g1[d]), be1[d]);
    }
    ac[at_c + static_cast<size_t>(d) * z.Tp] = commu::from_f<S>(a_c);
  }
}

// ---- (2), (3): the tiled product acc[m][t] = sum_k A[k][m] X[b][k][t] of a
// 128-row x 128-token tile (mma_tile.cuh), A [Kp][Mm] a depth-major weight
// copy, X [B][Kp][Tp] a padded activation.  As project_mem_kv.cu: two blocks
// to an SM, the depth through a ring of kTileStages tiles fed by 16-byte
// cp.async (tokens past Tp zero-filled by the copy).

// The epilogue of (2): dh1 = [h1 > 0] acc scale (the saved h1 carries mask
// H in its sign), written as dh1_c (S, [B][Fp][Tp], zeros in the padding);
// the dropped h1 rebuilt as rnd(max(h1, 0) scale) into h1_d (the same
// layout: dW2's operand); and the tile's row sums of the unrounded dh1 over
// its tokens (db1), in a fixed order: the 8 values of a thread, its quad,
// then the 4 warps across.
template <typename S>
struct Dh1Out {
  const S* h1;   // [B][F][T]
  S* dh1c;       // [B][Fp][Tp]
  S* h1d;        // [B][Fp][Tp]
  float* part;   // [B * token tiles][F]
  float scale;
  Dims z;

  __device__ __forceinline__ void store(const float (&acc)[4][4][4], int b, int m0, int n0,
                                        int tile, float* red) const;
};

// The epilogue of (3): da = acc + dz2 (f32, [B][D][Tp]).
struct DaOut {
  const float* dz2;
  float* da;
  Dims z;

  __device__ __forceinline__ void store(const float (&acc)[4][4][4], int b, int m0, int n0, int,
                                        float*) const;
};

template <typename S>
__device__ __forceinline__ void Dh1Out<S>::store(const float (&acc)[4][4][4], int b, int m0,
                                                 int n0, int tile, float* red) const {
  const Dh1Out<S>& out = *this;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4, g = lane / 4, q = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = wm * kWM + mi * 16 + g + 8 * half;
      const int f = m0 + row;
      const S* h1_row = out.h1 + (static_cast<size_t>(b) * z.F + f) * z.T;
      const size_t at = (static_cast<size_t>(b) * z.Fp + f) * z.Tp;
      float rs = 0.f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int t = n0 + wn * kWN + ni * 8 + 2 * q;
        float dh[2], hd[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float h = f < z.F && t + c < z.T ? commu::to_f(h1_row[t + c]) : 0.f;
          dh[c] = h > 0.f ? acc[mi][ni][2 * half + c] * out.scale : 0.f;
          hd[c] = fmaxf(h, 0.f) * out.scale;
          rs += dh[c];
        }
        if (f < z.Fp && t < z.Tp) {
          store_pair(out.dh1c + at + t, dh[0], dh[1]);
          store_pair(out.h1d + at + t, hd[0], hd[1]);
        }
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      if (q == 0) red[wn * kBM + row] = rs;
    }
  __syncthreads();
  if (tid < kBM && m0 + tid < z.F)
    out.part[static_cast<size_t>(b * ((z.Tp + kBN - 1) / kBN) + tile) * z.F + m0 + tid] =
        red[tid] + red[kBM + tid] + red[2 * kBM + tid] + red[3 * kBM + tid];
}

__device__ __forceinline__ void DaOut::store(const float (&acc)[4][4][4], int b, int m0, int n0,
                                             int, float*) const {
  const DaOut& out = *this;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4, g = lane / 4, q = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int d = m0 + wm * kWM + mi * 16 + g + 8 * half;
      if (d >= z.D) continue;
      const size_t at = (static_cast<size_t>(b) * z.D + d) * z.Tp;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int t = n0 + wn * kWN + ni * 8 + 2 * q;
        if (t >= z.T) continue;
        const float r1 = t + 1 < z.T ? out.dz2[at + t + 1] : 0.f;
        store_pair(out.da + at + t, acc[mi][ni][2 * half] + out.dz2[at + t],
                   acc[mi][ni][2 * half + 1] + r1);
      }
    }
}

// (6) the six vector sums in one launch: out[i] = sum over groups g of
// part[g][i] for each of them (blockIdx.y), in a fixed order: warp w of a
// block of 32 columns sums g = w, w + 32, ... in order, then the warps in
// order
constexpr int kSumWarps = 32;
constexpr int kSums = 6;

struct VecSum {
  const float* part;  // [groups][n]
  float* out;         // [n]
  int n, groups;
};

struct VecSums {
  VecSum v[kSums];
};

__global__ void __launch_bounds__(kSumWarps * 32)
sum_partials_kernel(VecSums sums) {
  __shared__ float s[kSumWarps][32];
  const VecSum job = sums.v[blockIdx.y];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (i < job.n) {
#pragma unroll 4
    for (int g = warp; g < job.groups; g += kSumWarps)
      acc += job.part[static_cast<size_t>(g) * job.n + i];
  }
  s[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && i < job.n) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kSumWarps; ++w) total += s[w][lane];
    job.out[i] = total;
  }
}

template <typename S>
struct Plain {
  S *wt1, *wt2, *dfc, *dh1c, *h1d, *ac;
  float *dz2, *da, *part_d, *part_f, *scratch;
};

// the plain form's workspace: the weight copies, the padded operands, the
// f32 dz2 and da, the per-block sums (five of [B * Tp / 32][D], one of
// [B * token tiles][F]) and reduce_outer_copy's partial buffer
template <typename S>
size_t plain_workspace(commu::Workspace& ws, Plain<S>* buf, const Dims& z) {
  const size_t dt = static_cast<size_t>(z.Dp) * z.Tp * z.B;
  const size_t ft = static_cast<size_t>(z.Fp) * z.Tp * z.B;
  buf->wt2 = ws.take<S>(static_cast<size_t>(z.Dp) * z.Fm);
  buf->wt1 = ws.take<S>(static_cast<size_t>(z.Fp) * z.Dm);
  buf->dfc = ws.take<S>(dt);
  buf->dh1c = ws.take<S>(ft);
  buf->h1d = ws.take<S>(ft);
  buf->ac = ws.take<S>(dt);
  buf->dz2 = ws.take<float>(static_cast<size_t>(z.B) * z.D * z.Tp);
  buf->da = ws.take<float>(static_cast<size_t>(z.B) * z.D * z.Tp);
  buf->part_d = ws.take<float>(5 * static_cast<size_t>(z.B) * (z.Tp / kCols) * z.D);
  buf->part_f = ws.take<float>(static_cast<size_t>(z.B) * ((z.Tp + kBN - 1) / kBN) * z.F);
  const size_t red = commu::copy_scratch(z.D, z.F, z.B);
  const size_t red2 = commu::copy_scratch(z.F, z.D, z.B);
  buf->scratch = ws.take<float>((red > red2 ? red : red2) / sizeof(float));
  return ws.used;
}

template <typename S>
cudaError_t launch_plain(const S* w1, const S* w2, const float* g1, const float* be1,
                         const float* g2, const S* norm1, const S* norm2, const S* h1,
                         const float* stats, const S* dy, S* dx, S* do_out, float* dw1,
                         float* db1, float* dw2, float* db2, float* dg1, float* dbe1, float* dg2,
                         float* dbe2, void* work, const Dims& z, int seed,
                         const commu::Plane& plane, cudaStream_t stream) {
  commu::Workspace ws{static_cast<char*>(work), 0};
  Plain<S> buf;
  plain_workspace(ws, &buf, z);
  RETURN_ON_ERROR((pad_weights<S, false>(w1, w2, buf.wt2, buf.wt1, z, stream)));

  const int ln_groups = z.B * (z.Tp / kCols);
  const size_t pn = static_cast<size_t>(ln_groups) * z.D;
  float* part_dbe2 = buf.part_d;
  float* part_dg2 = part_dbe2 + pn;
  float* part_db2 = part_dg2 + pn;
  float* part_dg1 = part_db2 + pn;
  float* part_dbe1 = part_dg1 + pn;
  ln2_bwd_kernel<S><<<ln_groups, kThreads, 0, stream>>>(g2, norm2, stats, dy, buf.dfc, buf.dz2,
                                                        part_dbe2, part_dg2, part_db2, z, seed,
                                                        plane);
  RETURN_ON_ERROR(cudaGetLastError());
  static_assert(tile_product_smem<S>() >= sizeof(float) * 4 * kBM, "the db1 sums reuse the ring");
  RETURN_ON_ERROR(run_tile_product(buf.wt2, buf.dfc, z.Dp, z.Fm, z.Tp, z.B,
                                   Dh1Out<S>{h1, buf.dh1c, buf.h1d, buf.part_f, plane.scale, z},
                                   stream));
  RETURN_ON_ERROR(run_tile_product(buf.wt1, buf.dh1c, z.Fp, z.Dm, z.Tp, z.B,
                                   DaOut{buf.dz2, buf.da, z}, stream));
  ln1_bwd_kernel<S><<<ln_groups, kThreads, 0, stream>>>(g1, be1, norm1, stats, buf.da, dx, do_out,
                                                        buf.ac, part_dg1, part_dbe1, z, seed,
                                                        plane);
  RETURN_ON_ERROR(cudaGetLastError());

  // dW1 = sum a_c dh1_c^T [D, F] and dW2 = sum h1_d df_c^T [F, D]: every
  // operand t-contiguous with Tp a whole number of chunks (zero columns past T)
  const long long sd = static_cast<long long>(z.Dp) * z.Tp, sf = static_cast<long long>(z.Fp) * z.Tp;
  const commu::Rows<S> a_c{buf.ac, sd, z.Tp, 0, z.Tp}, dh1_c{buf.dh1c, sf, z.Tp, 0, z.Tp};
  const commu::Rows<S> h1_d{buf.h1d, sf, z.Tp, 0, z.Tp}, df_c{buf.dfc, sd, z.Tp, 0, z.Tp};
  RETURN_ON_ERROR(commu::reduce_outer_copy<S>(a_c, dh1_c, dw1, buf.scratch, z.D, z.F, z.B, z.Tp, stream));
  RETURN_ON_ERROR(commu::reduce_outer_copy<S>(h1_d, df_c, dw2, buf.scratch, z.F, z.D, z.B, z.Tp, stream));

  const VecSums sums{{{buf.part_f, db1, z.F, z.B * ((z.Tp + kBN - 1) / kBN)},
                      {part_db2, db2, z.D, ln_groups},
                      {part_dg1, dg1, z.D, ln_groups},
                      {part_dbe1, dbe1, z.D, ln_groups},
                      {part_dg2, dg2, z.D, ln_groups},
                      {part_dbe2, dbe2, z.D, ln_groups}}};
  const int n_max = z.F > z.D ? z.F : z.D;
  const dim3 grid((n_max + 31) / 32, kSums);
  sum_partials_kernel<<<grid, kSumWarps * 32, 0, stream>>>(sums);
  return cudaGetLastError();
}

template <typename S>
int launch(const void* w1, const void* w2, const void* g1, const void* be1, const void* g2,
           const void* norm1, const void* norm2, const void* h1, const void* stats,
           const void* dy, const void* vec, const void* wo, void* dx, void* do_out, void* dvec,
           void* dw1, void* db1, void* dw2, void* db2, void* dg1, void* dbe1, void* dg2,
           void* dbe2, void* dwo, void* work, int B, int D, int F, int T, int HD, int seed,
           int thresh, float keep_scale, int bits, cudaStream_t stream) {
  if (wo != nullptr)
    return launch_fused_o<S>(w1, w2, g1, be1, g2, norm1, norm2, h1, stats, dy, vec, wo, dx,
                             dvec, dw1, db1, dw2, db2, dg1, dbe1, dg2, dbe2, dwo, work, B, D,
                             F, T, HD, seed, thresh, keep_scale, bits, stream);
  if (B < 1 || D < 1 || F < 1 || T < 1 || (thresh > 0 && do_out == nullptr))
    return cudaErrorInvalidValue;
  return launch_plain<S>(
      static_cast<const S*>(w1), static_cast<const S*>(w2), static_cast<const float*>(g1),
      static_cast<const float*>(be1), static_cast<const float*>(g2),
      static_cast<const S*>(norm1), static_cast<const S*>(norm2), static_cast<const S*>(h1),
      static_cast<const float*>(stats), static_cast<const S*>(dy), static_cast<S*>(dx),
      static_cast<S*>(do_out), static_cast<float*>(dw1), static_cast<float*>(db1),
      static_cast<float*>(dw2), static_cast<float*>(db2), static_cast<float*>(dg1),
      static_cast<float*>(dbe1), static_cast<float*>(dg2), static_cast<float*>(dbe2), work,
      dims(B, D, F, T), seed, commu::make_plane(D, T, thresh, keep_scale, bits), stream);
}

}  // namespace

// HD: rows of Wo in the fuse_o form, 0 in the plain form
extern "C" long long commu_ffn_block_bwd_workspace(int dtype, int B, int D, int F, int T,
                                                   int HD) {
  commu::Workspace ws{nullptr, 0};
  if (HD > 0) {
    Buffers buf;
    return static_cast<long long>(workspace(ws, &buf, B, D, F, T, HD));
  }
  if (dtype == commu::kFloat32) {
    Plain<float> buf;
    return static_cast<long long>(plain_workspace(ws, &buf, dims(B, D, F, T)));
  }
  Plain<__nv_bfloat16> buf;
  return static_cast<long long>(plain_workspace(ws, &buf, dims(B, D, F, T)));
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
