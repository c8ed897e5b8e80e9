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
// Design, the operands lying [B, ., T] with T contiguous;
// every product on the tensor cores (3xTF32 on mma.sync m16n8k8 in f32, bf16
// m16n8k16 with f32 accumulation in bf16, where every operand is an S value
// already, so each product is exact):
//   (0) pad_matrix (ffn_pad.cuh): W2^T and W1^T, depth-major and
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
// The fuse_o form runs the same passes with its two products added:
//   (4) ln1_bwd_kernel also writes do_c = rnd(do) (S, [B][Dp][Tp], zeros in
//       the padding), rounded once, for both products;
//   (4b) tile_product_kernel: dvec = Wo do_c per batch row from Wo^T,
//       zero-padded to [Dp][HDm] in step (0), rounded to S in its epilogue;
//   (5) dWo = sum vec do_c^T on reduce_outer_copy beside dW1 and dW2 (vec
//       zero-padded to [B][HDp][Tp] first where T is no whole 32).
#include "ffn_pad.cuh"
#include "prng.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSaltO = 0, kSaltF = 2;

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
// kFusedO: do goes to do_out as do_c [B][Dp][Tp] instead, with and without
// dropout, zeros in the padding (the depth of the dvec product).
template <typename S, bool kFusedO>
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
  for (int d = warp; d < (kFusedO ? z.Dp : D); d += kWarps) {
    float a_c = 0.f, dov = 0.f;
    if (live && (!kFusedO || d < D)) {
      const size_t at = at_in + static_cast<size_t>(d) * z.T;
      const float a = da[at_da + static_cast<size_t>(d) * z.Tp];
      const float n = commu::to_f(norm1[at]);
      const float dz1 = rstd * (a * g1[d] - m1 - n * m2);
      dx[at] = commu::from_f<S>(dz1);
      dov = dz1;
      if (drop) dov = commu::keep(plane, seed_o, d, t) ? dz1 * plane.scale : 0.f;
      if (!kFusedO && drop) do_out[at] = commu::from_f<S>(dov);
      // the reference's a = norm1 g1 + be1 (two roundings), cast to S
      a_c = __fadd_rn(__fmul_rn(n, g1[d]), be1[d]);
    }
    if (!kFusedO || d < D) ac[at_c + static_cast<size_t>(d) * z.Tp] = commu::from_f<S>(a_c);
    if (kFusedO) do_out[at_c + static_cast<size_t>(d) * z.Tp] = commu::from_f<S>(dov);
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

// The epilogue of (4b), the fuse_o form: dvec = acc rounded to S ([B][HD][T]).
template <typename S>
struct DvecOut {
  S* dvec;
  Dims z;

  __device__ __forceinline__ void store(const float (&acc)[4][4][4], int b, int m0, int n0, int,
                                        float*) const {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int wm = warp / 4, wn = warp % 4, g = lane / 4, q = lane % 4;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = m0 + wm * kWM + mi * 16 + g + 8 * half;
        if (c >= z.HD) continue;
        S* row = dvec + (static_cast<size_t>(b) * z.HD + c) * z.T;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int t = n0 + wn * kWN + ni * 8 + 2 * q;
          const float c0 = acc[mi][ni][2 * half], c1 = acc[mi][ni][2 * half + 1];
          if (z.T % 2 == 0) {
            if (t < z.T) store_pair(row + t, c0, c1);
          } else {
            if (t < z.T) row[t] = commu::from_f<S>(c0);
            if (t + 1 < z.T) row[t + 1] = commu::from_f<S>(c1);
          }
        }
      }
  }
};

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
struct Buffers {
  S *wt1, *wt2, *dfc, *dh1c, *h1d, *ac;
  float *dz2, *da, *part_d, *part_f, *scratch;
  S *wot, *doc, *vecp;  // the fuse_o form: Wo^T [Dp][HDm], do_c and vec padded
};

// the workspace: the weight copies, the padded operands, the f32 dz2 and
// da, the per-block sums (five of [B * Tp / 32][D], one of [B * token
// tiles][F]) and reduce_outer_copy's partial buffer; in the fuse_o form
// (z.HD > 0) Wo^T's copy, do_c [B][Dp][Tp] and, where T is no whole 32, vec
// [B][HDp][Tp] too
template <typename S>
size_t workspace(commu::Workspace& ws, Buffers<S>* buf, const Dims& z) {
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
  size_t red = commu::copy_scratch(z.D, z.F, z.B, z.Tp);
  const size_t red2 = commu::copy_scratch(z.F, z.D, z.B, z.Tp);
  if (red2 > red) red = red2;
  if (z.HD > 0 && commu::copy_scratch(z.HD, z.D, z.B, z.Tp) > red)
    red = commu::copy_scratch(z.HD, z.D, z.B, z.Tp);
  buf->scratch = ws.take<float>(red / sizeof(float));
  buf->wot = buf->doc = buf->vecp = nullptr;
  if (z.HD > 0) {
    buf->wot = ws.take<S>(static_cast<size_t>(z.Dp) * z.HDm);
    buf->doc = ws.take<S>(dt);
    if (z.T % kPad != 0) buf->vecp = ws.take<S>(static_cast<size_t>(z.B) * z.HDp * z.Tp);
  }
  return ws.used;
}

// vec, wo, dvec, dwo: the fuse_o form's (null in the plain form)
template <typename S>
cudaError_t launch_passes(const S* w1, const S* w2, const float* g1, const float* be1,
                          const float* g2, const S* norm1, const S* norm2, const S* h1,
                          const float* stats, const S* dy, const S* vec, const S* wo, S* dx,
                          S* do_out, S* dvec, float* dw1, float* db1, float* dw2, float* db2,
                          float* dg1, float* dbe1, float* dg2, float* dbe2, float* dwo,
                          void* work, const Dims& z, int seed, const commu::Plane& plane,
                          cudaStream_t stream) {
  commu::Workspace ws{static_cast<char*>(work), 0};
  Buffers<S> buf;
  workspace(ws, &buf, z);
  const bool fused = wo != nullptr;
  RETURN_ON_ERROR((pad_matrix<S, true>(w2, buf.wt2, 1, z.D, z.F, z.Dp, z.Fm, stream)));
  RETURN_ON_ERROR((pad_matrix<S, true>(w1, buf.wt1, 1, z.F, z.D, z.Fp, z.Dm, stream)));
  if (fused) RETURN_ON_ERROR((pad_matrix<S, true>(wo, buf.wot, 1, z.D, z.HD, z.Dp, z.HDm, stream)));

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
  if (fused) {
    ln1_bwd_kernel<S, true><<<ln_groups, kThreads, 0, stream>>>(
        g1, be1, norm1, stats, buf.da, dx, buf.doc, buf.ac, part_dg1, part_dbe1, z, seed, plane);
    RETURN_ON_ERROR(cudaGetLastError());
    RETURN_ON_ERROR(run_tile_product(buf.wot, buf.doc, z.Dp, z.HDm, z.Tp, z.B,
                                     DvecOut<S>{dvec, z}, stream));
  } else {
    ln1_bwd_kernel<S, false><<<ln_groups, kThreads, 0, stream>>>(
        g1, be1, norm1, stats, buf.da, dx, do_out, buf.ac, part_dg1, part_dbe1, z, seed, plane);
    RETURN_ON_ERROR(cudaGetLastError());
  }

  // dW1 = sum a_c dh1_c^T [D, F] and dW2 = sum h1_d df_c^T [F, D]: every
  // operand t-contiguous with Tp a whole number of chunks (zero columns past T)
  const long long sd = static_cast<long long>(z.Dp) * z.Tp, sf = static_cast<long long>(z.Fp) * z.Tp;
  const commu::Rows<S> a_c{buf.ac, sd, z.Tp, 0, z.Tp}, dh1_c{buf.dh1c, sf, z.Tp, 0, z.Tp};
  const commu::Rows<S> h1_d{buf.h1d, sf, z.Tp, 0, z.Tp}, df_c{buf.dfc, sd, z.Tp, 0, z.Tp};
  RETURN_ON_ERROR(commu::reduce_outer_copy<S>(a_c, dh1_c, dw1, buf.scratch, z.D, z.F, z.B, z.Tp, stream));
  RETURN_ON_ERROR(commu::reduce_outer_copy<S>(h1_d, df_c, dw2, buf.scratch, z.F, z.D, z.B, z.Tp, stream));
  if (fused) {
    // dWo = sum vec do_c^T [HD, D]: vec as it lies where T is a whole 32
    const S* vp = vec;
    long long sv = static_cast<long long>(z.HD) * z.T;
    if (buf.vecp != nullptr) {
      RETURN_ON_ERROR((pad_matrix<S, false>(vec, buf.vecp, z.B, z.HD, z.T, z.HDp, z.Tp, stream)));
      vp = buf.vecp;
      sv = static_cast<long long>(z.HDp) * z.Tp;
    }
    const commu::Rows<S> vec_r{vp, sv, z.Tp, 0, z.Tp}, do_c{buf.doc, sd, z.Tp, 0, z.Tp};
    RETURN_ON_ERROR(commu::reduce_outer_copy<S>(vec_r, do_c, dwo, buf.scratch, z.HD, z.D, z.B, z.Tp, stream));
  }

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
  const bool fused = wo != nullptr;
  if (B < 1 || D < 1 || F < 1 || T < 1 || (!fused && thresh > 0 && do_out == nullptr) ||
      (fused && (HD < 1 || vec == nullptr || dvec == nullptr || dwo == nullptr)))
    return cudaErrorInvalidValue;
  return launch_passes<S>(
      static_cast<const S*>(w1), static_cast<const S*>(w2), static_cast<const float*>(g1),
      static_cast<const float*>(be1), static_cast<const float*>(g2),
      static_cast<const S*>(norm1), static_cast<const S*>(norm2), static_cast<const S*>(h1),
      static_cast<const float*>(stats), static_cast<const S*>(dy), static_cast<const S*>(vec),
      static_cast<const S*>(wo), static_cast<S*>(dx), static_cast<S*>(do_out),
      static_cast<S*>(dvec), static_cast<float*>(dw1), static_cast<float*>(db1),
      static_cast<float*>(dw2), static_cast<float*>(db2), static_cast<float*>(dg1),
      static_cast<float*>(dbe1), static_cast<float*>(dg2), static_cast<float*>(dbe2),
      static_cast<float*>(dwo), work, dims(B, D, F, T, fused ? HD : 0), seed,
      commu::make_plane(D, T, thresh, keep_scale, bits), stream);
}

}  // namespace

// HD: rows of Wo in the fuse_o form, 0 in the plain form
extern "C" long long commu_ffn_block_bwd_workspace(int dtype, int B, int D, int F, int T,
                                                   int HD) {
  commu::Workspace ws{nullptr, 0};
  if (dtype == commu::kFloat32) {
    Buffers<float> buf;
    return static_cast<long long>(workspace(ws, &buf, dims(B, D, F, T, HD)));
  }
  Buffers<__nv_bfloat16> buf;
  return static_cast<long long>(workspace(ws, &buf, dims(B, D, F, T, HD)));
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
