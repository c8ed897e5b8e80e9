// Fused post-attention block forward, with the block's three dropouts in
// training.
//
// Replaces: commu_tpu/ops/fused_ffn.py::_ffn_fwd_kernel (:120), as launched
//   by _ffn_fwd_call (:352) for ffn_block (:446) with save=False, and for its
//   VJP forward (:457) with save=True: then it also writes what the backward
//   (ffn_block_bwd.cu) reads, as :367-375 does: the normalised LN inputs
//   norm1 = (z1 - mean) rstd1 and norm2 (in S), the post-relu h1 (in S) and
//   the rstds [B, 2, T] (f32).  With ``wo`` it is the fuse_o form of the same
//   kernel (:122-127, :145-148), as ffn_block_fused_o (:482) launches it:
//   ``o`` is then the attention vector before its output projection,
//   vec [B, HD, T], and the kernel forms o = Wo^T vec itself (Wo [HD, D]).
//   That o stays f32 until mask O and the residual, where the unfused path's
//   o was rounded to S by the projection outside.

// Per token column t of a batch row (x, o: [B, D, T], feature-major):
//   z1 = x + o;  a = LN1(z1)                  (f32, fast variance, eps 1e-5)
//   h1 = relu(W1^T a_c + b1)                  (a_c = a rounded to S)
//   f  = W2^T h1_c + b2;  y = LN2(a + f)      (residual uses a in f32)
// With dropout (thresh > 0; :151-153, :165-174, :178-180) three masks apply, the
// planes [D, T], [F, T], [D, T] of row b seeded with seed + b * 8192 + salt *
// 2048, salts O = 0, H = 1, F = 2 (prng.cuh): o is dropped before the first
// residual, h1 after the ReLU (the dropped h1 rounded to S feeds W2), f
// before the second residual.  The saved h1 then carries mask H in its sign
// (h1 kept, -h1 dropped), as the reference's does, so the backward never
// recomputes that mask.
//
// What bounds it on the H100: tensor-core arithmetic at the training shape
// (B = 256, T = 128, D = 500, F = 1000): the two products cost 4 x D x F
// operations a token, 65.5 GFLOP a launch, 0.40 ms at the dense TF32 rate
// with the three passes of 3xTF32 counted (f32) and 0.07 ms at the bf16
// rate; the bytes it must move take about 0.1 ms.  On the serving path (T =
// 11) the products are matrix-vector shaped and the kernel is bound by
// reading W1 and W2 (2 MB each at f32) and by launch latency.  The fuse_o
// form adds o = Wo^T vec, 2 HD D operations a token (16.4 GFLOP at HD = 500).
//
// Design of the plain form, as ffn_block_bwd.cu's (every product on the
// tensor cores: 3xTF32 on mma.sync m16n8k8 in f32, bf16 m16n8k16 with f32
// accumulation in bf16, where every operand is an S value already):
//   (0) pad_matrix (ffn_pad.cuh): W1 and W2, already depth-major,
//       zero-padded to whole tiles into the workspace once a call;
//   (1) ln1_kernel: one block per (b, 32 token columns), a lane a column
//       and the warps over d, every load a coalesced row piece: z1 = x +
//       mask_O(o), the column sums over D in registers, then across the warps
//       in a fixed order; a = norm1 g1 + be1 in f32 (for the residual),
//       a_c = a rounded to S into [B][Dp][Tp] (zeros in the padding),
//       norm1 and rstd1;
//   (2) tile_product_kernel (mma_tile.cuh): h1 = W1^T a_c per batch row in
//       128 x 128 tiles, the depth through a 4-stage cp.async ring; the
//       epilogue adds b1, applies the ReLU and mask H, writes the saved h1
//       with mask H in its sign and the dropped h1 rounded to S into
//       [B][Fp][Tp] (zeros in the padding);
//   (3) tile_product_kernel: f = W2^T h1_d; the epilogue adds b2, applies
//       mask F and adds a in f32: z2 = a + f, in a's place;
//   (4) ln2_kernel, as (1) on z2: y, norm2 and rstd2.
// Tp = T rounded up to 32, Dp and Fp to 32, Dm and Fm to 128, so every
// staged copy is a whole, aligned 16 bytes and no tile reads out of bounds.
// No float atomics: two runs on the same inputs give the same bits.
//
// The fuse_o form runs the same passes with two steps in front:
//   (0b) pad_matrix (ffn_pad.cuh): Wo, already depth-major, zero-padded into
//       [HDp][Dm], and vec into [B][HDp][Tp] (zeros in the padding, as a_c);
//   (0c) tile_product_kernel: o = Wo^T vec per batch row into an f32
//       [B][D][T] workspace, no rounding in its epilogue;
// and (1) reads that f32 o in o's place.
#include "ffn_pad.cuh"
#include "prng.cuh"

namespace {

constexpr int kSaltO = 0, kSaltH = 1, kSaltF = 2;
constexpr float kEps = 1e-5f;

constexpr int kLnWarps = 16;  // a LayerNorm block's warps, over the rows d

// mean and 1/std of each column from its sums over the D rows: each warp
// summed its rows d = warp, warp + kLnWarps, ... in order; the warps add in
// order (fast variance, as flax's LayerNorm and the reference's _ln_fwd)
__device__ __forceinline__ void column_stats(float s, float sq, int D, float* mean, float* rstd) {
  __shared__ float s_s[kLnWarps][kCols], sq_s[kLnWarps][kCols];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  s_s[warp][lane] = s;
  sq_s[warp][lane] = sq;
  __syncthreads();
  float a = 0.f, c = 0.f;
#pragma unroll
  for (int w = 0; w < kLnWarps; ++w) {
    a += s_s[w][lane];
    c += sq_s[w][lane];
  }
  const float m = a * (1.f / D);
  const float var = fmaxf(c * (1.f / D) - m * m, 0.f);
  *mean = m;
  *rstd = 1.f / sqrtf(var + kEps);
}

// (1) LN1: one block per (b, 32 token columns).  Writes a_c (S, [B][Dp][Tp],
// zeros in the padding), a (f32, [B][D][Tp]: the residual, later z2), norm1
// (save) and rstd1.  z1 is formed twice, for the sums and for the output,
// rather than held: the second read comes from L2.  o [B][D][T] is S, or
// (the fuse_o form) the f32 o of step (0c).
template <typename S, typename O>
__global__ void __launch_bounds__(kLnWarps * 32)
ln1_kernel(const S* __restrict__ x, const O* __restrict__ o, const float* __restrict__ g1,
           const float* __restrict__ be1, S* __restrict__ ac, float* __restrict__ za,
           S* __restrict__ norm1, float* __restrict__ stats, Dims z, int seed,
           commu::Plane plane) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = z.Tp / kCols;
  const int b = blockIdx.x / chunks;
  const int t = (blockIdx.x - b * chunks) * kCols + lane;
  const bool live = t < z.T;
  const int D = z.D;
  const size_t at_in = static_cast<size_t>(b) * D * z.T + t;     // + d T: x, o, norm1
  const size_t at_a = static_cast<size_t>(b) * D * z.Tp + t;     // + d Tp: a
  const size_t at_c = static_cast<size_t>(b) * z.Dp * z.Tp + t;  // + d Tp: a_c
  const bool drop = plane.thresh > 0;
  const uint32_t seed_o = commu::plane_seed(seed, b, 8192, kSaltO * 2048);
  auto z1 = [&](int d) {
    const size_t at = at_in + static_cast<size_t>(d) * z.T;
    float ov = commu::to_f(o[at]);
    if (drop) ov = commu::keep(plane, seed_o, d, t) ? ov * plane.scale : 0.f;
    return commu::to_f(x[at]) + ov;
  };
  float s = 0.f, sq = 0.f;
  if (live) {
#pragma unroll 4
    for (int d = warp; d < D; d += kLnWarps) {
      const float v = z1(d);
      s += v;
      sq = fmaf(v, v, sq);
    }
  }
  float mean, rstd;
  column_stats(s, sq, D, &mean, &rstd);
  if (live && warp == 0 && stats != nullptr) stats[static_cast<size_t>(b) * 2 * z.T + t] = rstd;
#pragma unroll 4
  for (int d = warp; d < z.Dp; d += kLnWarps) {
    float a = 0.f;
    if (d < D) {
      if (live) {
        const float norm = (z1(d) - mean) * rstd;
        a = __fadd_rn(__fmul_rn(norm, g1[d]), be1[d]);
        if (norm1 != nullptr) norm1[at_in + static_cast<size_t>(d) * z.T] = commu::from_f<S>(norm);
      }
      za[at_a + static_cast<size_t>(d) * z.Tp] = a;
    }
    ac[at_c + static_cast<size_t>(d) * z.Tp] = commu::from_f<S>(a);
  }
}

// (4) LN2 on z2 = a + f: y, norm2 (save) and rstd2.
template <typename S>
__global__ void __launch_bounds__(kLnWarps * 32)
ln2_kernel(const float* __restrict__ za, const float* __restrict__ g2,
           const float* __restrict__ be2, S* __restrict__ y, S* __restrict__ norm2,
           float* __restrict__ stats, Dims z) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = z.Tp / kCols;
  const int b = blockIdx.x / chunks;
  const int t = (blockIdx.x - b * chunks) * kCols + lane;
  const bool live = t < z.T;
  const int D = z.D;
  const size_t at_in = static_cast<size_t>(b) * D * z.T + t;  // + d T: y, norm2
  const size_t at_a = static_cast<size_t>(b) * D * z.Tp + t;  // + d Tp: z2
  float s = 0.f, sq = 0.f;
  if (live) {
#pragma unroll 4
    for (int d = warp; d < D; d += kLnWarps) {
      const float v = za[at_a + static_cast<size_t>(d) * z.Tp];
      s += v;
      sq = fmaf(v, v, sq);
    }
  }
  float mean, rstd;
  column_stats(s, sq, D, &mean, &rstd);
  if (!live) return;
  if (warp == 0 && stats != nullptr) stats[(static_cast<size_t>(b) * 2 + 1) * z.T + t] = rstd;
#pragma unroll 4
  for (int d = warp; d < D; d += kLnWarps) {
    const float norm = (za[at_a + static_cast<size_t>(d) * z.Tp] - mean) * rstd;
    const size_t at = at_in + static_cast<size_t>(d) * z.T;
    y[at] = commu::from_f<S>(__fadd_rn(__fmul_rn(norm, g2[d]), be2[d]));
    if (norm2 != nullptr) norm2[at] = commu::from_f<S>(norm);
  }
}

// The epilogue of (2): h1 = relu(acc + b1); the dropped h1 rounded to S into
// h1d [B][Fp][Tp] (zeros in the padding: the next product's operand); the
// saved h1 [B][F][T] with mask H in its sign (save).
template <typename S>
struct H1Out {
  const float* b1;
  S* h1d;
  S* h1;  // null without save
  uint32_t seed_base;  // the row's seed is seed_base + b * 8192
  commu::Plane plane;
  Dims z;

  __device__ __forceinline__ void store(const float (&acc)[4][4][4], int b, int m0, int n0, int,
                                        float*) const {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int wm = warp / 4, wn = warp % 4, g = lane / 4, q = lane % 4;
    const bool drop = plane.thresh > 0;
    const uint32_t seed_h = seed_base + static_cast<uint32_t>(b) * 8192u;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int f = m0 + wm * kWM + mi * 16 + g + 8 * half;
        if (f >= z.Fp) continue;
        const float bias = f < z.F ? b1[f] : 0.f;
        const size_t at = (static_cast<size_t>(b) * z.Fp + f) * z.Tp;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int t = n0 + wn * kWN + ni * 8 + 2 * q;
          if (t >= z.Tp) continue;
          float hd[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            hd[c] = 0.f;
            if (f < z.F && t + c < z.T) {
              const float hv = fmaxf(acc[mi][ni][2 * half + c] + bias, 0.f);
              const bool kept = !drop || commu::keep(plane, seed_h, f, t + c);
              hd[c] = kept ? hv * plane.scale : 0.f;
              if (h1 != nullptr)
                h1[(static_cast<size_t>(b) * z.F + f) * z.T + t + c] =
                    commu::from_f<S>(kept ? hv : -hv);
            }
          }
          store_pair(h1d + at + t, hd[0], hd[1]);
        }
      }
  }
};

// The epilogue of (0c): o = acc, f32, [B][D][T] (the fuse_o form).
struct OOut {
  float* o;
  Dims z;

  __device__ __forceinline__ void store(const float (&acc)[4][4][4], int b, int m0, int n0, int,
                                        float*) const {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int wm = warp / 4, wn = warp % 4, g = lane / 4, q = lane % 4;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = m0 + wm * kWM + mi * 16 + g + 8 * half;
        if (d >= z.D) continue;
        float* row = o + (static_cast<size_t>(b) * z.D + d) * z.T;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int t = n0 + wn * kWN + ni * 8 + 2 * q;
          const float c0 = acc[mi][ni][2 * half], c1 = acc[mi][ni][2 * half + 1];
          if (z.T % 2 == 0) {
            if (t < z.T) store_pair(row + t, c0, c1);
          } else {
            if (t < z.T) row[t] = c0;
            if (t + 1 < z.T) row[t + 1] = c1;
          }
        }
      }
  }
};

// The epilogue of (3): z2 = a + mask_F(acc + b2), in a's place (f32,
// [B][D][Tp]).
struct Z2Out {
  const float* b2;
  float* za;
  uint32_t seed_base;  // the row's seed is seed_base + b * 8192
  commu::Plane plane;
  Dims z;

  __device__ __forceinline__ void store(const float (&acc)[4][4][4], int b, int m0, int n0, int,
                                        float*) const {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int wm = warp / 4, wn = warp % 4, g = lane / 4, q = lane % 4;
    const bool drop = plane.thresh > 0;
    const uint32_t seed_f = seed_base + static_cast<uint32_t>(b) * 8192u;
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
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            if (t + c >= z.T) continue;
            float fv = acc[mi][ni][2 * half + c] + b2[d];
            if (drop) fv = commu::keep(plane, seed_f, d, t + c) ? fv * plane.scale : 0.f;
            za[at + t + c] += fv;
          }
        }
      }
  }
};

template <typename S>
struct Buffers {
  S *wt1, *wt2, *ac, *h1d;
  float* za;
  S *wop, *vecp;  // the fuse_o form: Wo [HDp][Dm], vec [B][HDp][Tp]
  float* of;      // ... and its f32 o [B][D][T]
  float* deep;    // the tile's second level, for the deepest of its products
};

// the workspace: the weight copies, the padded operands a_c and h1_d, and
// the f32 a (later z2); in the fuse_o form (z.HD > 0) Wo's copy, the padded
// vec and the f32 o too; then the tile's second level (f32 products past
// its fold depth)
template <typename S>
size_t workspace(commu::Workspace& ws, Buffers<S>* buf, const Dims& z) {
  buf->wt1 = ws.take<S>(static_cast<size_t>(z.Dp) * z.Fm);
  buf->wt2 = ws.take<S>(static_cast<size_t>(z.Fp) * z.Dm);
  buf->ac = ws.take<S>(static_cast<size_t>(z.B) * z.Dp * z.Tp);
  buf->h1d = ws.take<S>(static_cast<size_t>(z.B) * z.Fp * z.Tp);
  buf->za = ws.take<float>(static_cast<size_t>(z.B) * z.D * z.Tp);
  buf->wop = buf->vecp = nullptr;
  buf->of = nullptr;
  if (z.HD > 0) {
    buf->wop = ws.take<S>(static_cast<size_t>(z.HDp) * z.Dm);
    buf->vecp = ws.take<S>(static_cast<size_t>(z.B) * z.HDp * z.Tp);
    buf->of = ws.take<float>(static_cast<size_t>(z.B) * z.D * z.T);
  }
  size_t deep = tile_deep_floats<S>(z.Dp, z.Fm, z.Tp, z.B);
  if (tile_deep_floats<S>(z.Fp, z.Dm, z.Tp, z.B) > deep)
    deep = tile_deep_floats<S>(z.Fp, z.Dm, z.Tp, z.B);
  if (z.HD > 0 && tile_deep_floats<S>(z.HDp, z.Dm, z.Tp, z.B) > deep)
    deep = tile_deep_floats<S>(z.HDp, z.Dm, z.Tp, z.B);
  buf->deep = deep > 0 ? ws.take<float>(deep) : nullptr;
  return ws.used;
}

// o: [B][D][T], or with wo (the fuse_o form) vec [B][HD][T]
template <typename S>
cudaError_t launch_passes(const S* x, const S* o, const S* wo, const S* w1, const float* b1,
                          const S* w2, const float* b2, const float* g1, const float* be1,
                          const float* g2, const float* be2, S* y, S* norm1, S* norm2, S* h1,
                          float* stats, void* work, const Dims& z, int seed, int thresh,
                          float keep_scale, int bits, cudaStream_t stream) {
  commu::Workspace ws{static_cast<char*>(work), 0};
  Buffers<S> buf;
  workspace(ws, &buf, z);
  RETURN_ON_ERROR((pad_matrix<S, false>(w1, buf.wt1, 1, z.D, z.F, z.Dp, z.Fm, stream)));
  RETURN_ON_ERROR((pad_matrix<S, false>(w2, buf.wt2, 1, z.F, z.D, z.Fp, z.Dm, stream)));
  const commu::Plane plane_d = commu::make_plane(z.D, z.T, thresh, keep_scale, bits);
  const commu::Plane plane_f = commu::make_plane(z.F, z.T, thresh, keep_scale, bits);
  const int ln_blocks = z.B * (z.Tp / kCols);
  if (wo != nullptr) {
    RETURN_ON_ERROR((pad_matrix<S, false>(wo, buf.wop, 1, z.HD, z.D, z.HDp, z.Dm, stream)));
    RETURN_ON_ERROR((pad_matrix<S, false>(o, buf.vecp, z.B, z.HD, z.T, z.HDp, z.Tp, stream)));
    RETURN_ON_ERROR(run_tile_product(buf.wop, buf.vecp, z.HDp, z.Dm, z.Tp, z.B,
                                     OOut{buf.of, z}, buf.deep, stream));
    ln1_kernel<S, float><<<ln_blocks, kLnWarps * 32, 0, stream>>>(
        x, buf.of, g1, be1, buf.ac, buf.za, norm1, stats, z, seed, plane_d);
  } else {
    ln1_kernel<S, S><<<ln_blocks, kLnWarps * 32, 0, stream>>>(x, o, g1, be1, buf.ac, buf.za,
                                                               norm1, stats, z, seed, plane_d);
  }
  RETURN_ON_ERROR(cudaGetLastError());
  RETURN_ON_ERROR(run_tile_product(
      buf.wt1, buf.ac, z.Dp, z.Fm, z.Tp, z.B,
      H1Out<S>{b1, buf.h1d, h1, static_cast<uint32_t>(seed) + kSaltH * 2048u, plane_f, z},
      buf.deep, stream));
  RETURN_ON_ERROR(run_tile_product(
      buf.wt2, buf.h1d, z.Fp, z.Dm, z.Tp, z.B,
      Z2Out{b2, buf.za, static_cast<uint32_t>(seed) + kSaltF * 2048u, plane_d, z}, buf.deep,
      stream));
  ln2_kernel<S><<<ln_blocks, kLnWarps * 32, 0, stream>>>(buf.za, g2, be2, y, norm2, stats, z);
  return cudaGetLastError();
}

template <typename S>
int launch(const void* x, const void* o, const void* wo, const void* w1, const void* b1,
           const void* w2, const void* b2, const void* g1, const void* be1, const void* g2,
           const void* be2, void* y, void* norm1, void* norm2, void* h1, void* stats, void* work,
           int B, int D, int F, int T, int HD, int seed, int thresh, float keep_scale, int bits,
           cudaStream_t stream) {
  if (B < 1 || D < 1 || F < 1 || T < 1 || (wo != nullptr && HD < 1))
    return cudaErrorInvalidValue;
  return launch_passes<S>(
      static_cast<const S*>(x), static_cast<const S*>(o), static_cast<const S*>(wo),
      static_cast<const S*>(w1), static_cast<const float*>(b1), static_cast<const S*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(g1),
      static_cast<const float*>(be1), static_cast<const float*>(g2),
      static_cast<const float*>(be2), static_cast<S*>(y), static_cast<S*>(norm1),
      static_cast<S*>(norm2), static_cast<S*>(h1), static_cast<float*>(stats), work,
      dims(B, D, F, T, wo != nullptr ? HD : 0), seed, thresh, keep_scale, bits, stream);
}

}  // namespace

// the scratch of either form; HD: the rows of Wo in the fuse_o form, 0 in the
// plain form
extern "C" long long commu_ffn_block_fwd_workspace(int dtype, int B, int D, int F, int T,
                                                   int HD) {
  commu::Workspace ws{nullptr, 0};
  if (dtype == commu::kFloat32) {
    Buffers<float> buf;
    return static_cast<long long>(workspace(ws, &buf, dims(B, D, F, T, HD)));
  }
  Buffers<__nv_bfloat16> buf;
  return static_cast<long long>(workspace(ws, &buf, dims(B, D, F, T, HD)));
}

// wo: null for the plain form (o [B, D, T]); else Wo [HD, D], and o is the
// attention vector [B, HD, T]; work: commu_ffn_block_fwd_workspace bytes at
// the same HD (0 for the plain form)
extern "C" int commu_ffn_block_fwd(int dtype, const void* x, const void* o, const void* wo,
                                   const void* w1, const void* b1, const void* w2,
                                   const void* b2, const void* g1, const void* be1,
                                   const void* g2, const void* be2, void* y, void* norm1,
                                   void* norm2, void* h1, void* stats, void* work, int B, int D,
                                   int F, int T, int HD, int seed, int thresh, float keep_scale,
                                   int bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == commu::kFloat32)
    return launch<float>(x, o, wo, w1, b1, w2, b2, g1, be1, g2, be2, y, norm1, norm2, h1, stats,
                         work, B, D, F, T, HD, seed, thresh, keep_scale, bits, s);
  if (dtype == commu::kBFloat16)
    return launch<__nv_bfloat16>(x, o, wo, w1, b1, w2, b2, g1, be1, g2, be2, y, norm1, norm2,
                                 h1, stats, work, B, D, F, T, HD, seed, thresh, keep_scale, bits,
                                 s);
  return cudaErrorInvalidValue;
}
