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
// What bounds it on the H100: tensor-core arithmetic.  At the training
// shape (B = 256, H = 10, dh = 50, T = 128, M = 1024, D = 500, 2F = 512)
// the projection is 0.26 TFLOP a layer and the attention 0.45 TFLOP (17
// GFLOP of it, u = qr^T W_r, on FMA); the ring's layer is read once (0.52
// GB in f32), where the two-kernel path also writes the slabs and reads
// them back from device memory.
//
// Design (dh <= 64, 2F a multiple of 128 up to 512: ModelConfig()'s widths;
// the C launch owns the rule): one block per (b, h), 256 threads, two
// phases.  Each slab of a (b, h) is projected once, never once per query
// tile.
//   (0) proj_weights_kernel writes head h's columns of Wk and Wv once a call
//       into a head-major, zero-padded copy in the workspace, wpad [H][Dp]
//       [128]: row d holds Wk[d, h dh ..] then Wv[d, h dh ..] (2 dh values),
//       zeros past them and past D (Dp: D rounded up to a whole chunk).
//       Head h's columns start at byte h dh sizeof(S) of a row of Wk, no
//       whole 16 bytes for odd h at dh = 50, so cp.async cannot stage them
//       where they lie; the copy (2.6 MB in f32 at the training widths)
//       stays in L2.
//   (1) the projection on the tensor cores: for every slab and token tile
//       of 128, the 128 x 128 tile [k dims | v dims | zeros] x tokens of
//       mma_tile.cuh (warp_tile: 3xTF32 on mma.sync m16n8k8 in f32, bf16
//       m16n8k16 with f32 sums in bf16), the depth through a ring of 4
//       chunks fed by 16-byte cp.async (X_r's ragged rows and tokens
//       zero-filled by the copy; a Tb whose rows are no whole 16 bytes
//       takes plain loads); the ring runs on across slabs, so it never
//       drains between them.  The k-steps, the depth padding and the order
//       of the three passes are project_mem_kv.cu's, so the slabs equal its
//       slabs bit for bit.  The sums are rounded to S and written to k_mem
//       and v_mem.  The tile's rows past 2 dh are zeros (28 of 128 at dh =
//       50); skipping a warp's all-zero 16-row tiles together with a ring of
//       8 (f32) or 6 (bf16) chunks ran slower (24.55 against 23.07 ms in f32
//       at the training shape), so the tile stays whole.
//   (2) after a barrier, rel_attention_fwd_mma.cuh's attend_rows_mma (#2's
//       body, with #2's plane and seeds, so the masks are the same bits)
//       for each 64-row query tile over the block's own slabs, a barrier
//       between tiles.
// Reading back its own writes: phase 2 reads slabs that the block wrote in
// phase 1.  Those reads go through cp.async.cg (L2) or, for a shape whose
// key groups are no whole 16 bytes, plain coherent loads after the
// barrier, never through the read-only path (ld.global.nc), which may hold
// stale lines: no pointer of this kernel or of the body carries
// __restrict__, so the compiler never proves one read-only (chip_smoke.py
// counts the LDG.E.CONSTANT of its SASS: none).
// Shared memory: the larger of phase 1's ring (68 KB) and #2's body (218 KB
// in f32: one block an SM; 110 KB in bf16: two).
//
// Every other width (dh past 64 up to 128, 2F past 512 or no multiple of
// 128) runs the first design, rel_attention_proj_fwd_kernel below: the
// projection as f32 FMA loops and the FMA body of
// rel_attention_mem_fwd_body.cuh.
#include "rel_attention_fwd_mma.cuh"
#include "rel_attention_mem_fwd_body.cuh"

namespace {

// ---- the tensor-core form

constexpr int kProjStages = 4;  // depth chunks of phase 1 in flight

// the weight copy's depth: D rounded up to whole chunks, as project_mem_kv.cu
// pads it
template <typename S>
int proj_depth(int D) {
  return (D + kDepth<S> - 1) / kDepth<S> * kDepth<S>;
}

// The C launch's rule for the tensor-core form: #2's widths.
inline bool proj_on_tensor_cores(int dh, int F2) {
  return dh >= 1 && dh <= kFwdMaxDh && F2 % 128 == 0 && F2 <= kFwdMaxF2;
}

// (0) wpad [H][Dp][kBM]: element (h, d, c) is Wk[d, h dh + c] for c < dh,
// Wv[d, h dh + c - dh] for dh <= c < 2 dh, else 0; 0 for d >= D
template <typename S>
__global__ void __launch_bounds__(kFwdThreads)
proj_weights_kernel(const S* wk, const S* wv, S* wpad, int D, int H, int dh, int Dp) {
  const long long idx = static_cast<long long>(blockIdx.x) * kFwdThreads + threadIdx.x;
  if (idx >= static_cast<long long>(H) * Dp * kBM) return;
  const int c = static_cast<int>(idx % kBM);
  const long long row = idx / kBM;
  const int d = static_cast<int>(row % Dp), h = static_cast<int>(row / Dp);
  S val = commu::from_f<S>(0.f);
  if (d < D && c < 2 * dh)
    val = (c < dh ? wk : wv)[static_cast<size_t>(d) * H * dh + h * dh + (c < dh ? c : c - dh)];
  wpad[idx] = val;
}

// (1) the slabs of head h of batch row b: for r < R and token tiles n0,
// acc[o][t] = sum_d wh[d][o] X_r[d][n0 + t] over Dp / kDepth chunks, then
// rows o < dh to k_mem, dh <= o < 2 dh to v_mem, rounded to S
template <typename S, bool kVecX>
__device__ __forceinline__ void project_slabs(unsigned char* smem, const S* mem, const S* wh,
                                              S* k_mem, S* v_mem, int layer, int b, int h,
                                              int B, int H, int dh, int R, int Tb, int D,
                                              int Dp) {
  constexpr int kBKd = kDepth<S>, kS = kStride;
  constexpr int kVec = 16 / static_cast<int>(sizeof(S));  // elements a copy
  constexpr int kCopies = kBKd * kBM / kVec / kFwdThreads;  // per operand, thread and chunk
  constexpr int kXLoads = kBKd * kBN / kFwdThreads;         // the plain-load form
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int chunks = Dp / kBKd;
  const int n_tiles = (Tb + kBN - 1) / kBN;
  const int total = R * n_tiles * chunks;

  auto a_tile = [&](int stage) { return reinterpret_cast<S*>(smem + stage * stage_bytes<S>()); };
  auto x_tile = [&](int stage) { return a_tile(stage) + kBKd * kS; };
  // chunk kt (slab kt / chunks / n_tiles, its token tile, depth chunk kt %
  // chunks) into stage kt % kProjStages
  auto issue = [&](int kt) {
    const int unit = kt / chunks, k0 = (kt - unit * chunks) * kBKd;
    const int r = unit / n_tiles, n0 = (unit - r * n_tiles) * kBN;
    const S* x = mem + ((static_cast<size_t>(layer) * R + r) * B + b) * D * Tb;
    S* a_s = a_tile(kt % kProjStages);
    S* x_s = x_tile(kt % kProjStages);
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int idx = tid + kFwdThreads * i;
      const int kk = idx / (kBM / kVec), cc = idx % (kBM / kVec) * kVec;
      cp_async16(a_s + kk * kS + cc, wh + static_cast<size_t>(k0 + kk) * kBM + cc, true);
      if constexpr (kVecX) {
        const int d = k0 + kk, t = n0 + cc;
        const bool in = d < D && t < Tb;
        cp_async16(x_s + kk * kS + cc, in ? x + static_cast<size_t>(d) * Tb + t : x, in);
      }
    }
    if constexpr (!kVecX) {
      const S zero = commu::from_f<S>(0.f);
#pragma unroll 4
      for (int i = 0; i < kXLoads; ++i) {
        const int idx = tid + kFwdThreads * i;
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

#pragma unroll
  for (int kt = 0; kt < kProjStages - 1; ++kt) {
    if (kt < total) issue(kt);
    cp_async_commit();
  }
  const int g = lane / 4, q = lane % 4;
  for (int kt = 0; kt < total; ++kt) {
    cp_async_wait<kProjStages - 2>();  // chunk kt has landed (this thread's copies)
    __syncthreads();                   // ... everyone's; stage (kt - 1) is free
    if (kt + kProjStages - 1 < total) issue(kt + kProjStages - 1);
    cp_async_commit();
    warp_tile(a_tile(kt % kProjStages), x_tile(kt % kProjStages), acc, wm, wn, lane);
    const int unit = kt / chunks;
    if (kt - unit * chunks != chunks - 1) continue;
    // the tile is complete: C fragment rows g and g + 8, tokens 2q, 2q + 1
    const int r = unit / n_tiles, n0 = (unit - r * n_tiles) * kBN;
    const size_t slab = ((static_cast<size_t>(b) * R + r) * H + h) * dh * Tb;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int o = wm * kWM + mi * 16 + g + 8 * half;
        if (o < 2 * dh) {
          S* dst = (o < dh ? k_mem + static_cast<size_t>(o) * Tb
                           : v_mem + static_cast<size_t>(o - dh) * Tb) + slab;
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
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          acc[mi][ni][2 * half] = acc[mi][ni][2 * half + 1] = 0.f;
      }
  }
  cp_async_wait<0>();
  // the slabs this block wrote are visible to all of its threads after the
  // barrier, and the ring is free; no other block reads or writes them
  __syncthreads();
}

template <typename S, bool kVecX>
__global__ void __launch_bounds__(kFwdThreads, sizeof(S) == 2 ? 2 : 1)
rel_attention_proj_fwd_mma_kernel(const S* q, const S* rwbs, const S* rrbs, const S* mem,
                                  const S* wpad, const S* k_win, const S* v_win, const S* w_r,
                                  const S* trig_a, const S* psi, const __nv_bfloat16* mask,
                                  const int* reset, S* out, S* k_mem, S* v_mem, float* s_res,
                                  float* lse, int layer, int B, int H, int dh, int T, int R,
                                  int Tb, int D, int Dp, int F2, float scale, int seed,
                                  commu::Plane plane, bool aligned) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh - b * H;
  project_slabs<S, kVecX>(smem_mma, mem, wpad + static_cast<size_t>(h) * Dp * kBM, k_mem, v_mem,
                          layer, b, h, B, H, dh, R, Tb, D, Dp);
  for (int q0 = 0; q0 < T; q0 += kFwdRows) {
    attend_rows_mma<S, false>(smem_mma, q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a, psi,
                              nullptr, mask, reset, out, s_res, lse, bh, q0, H, dh, T, R, Tb, F2,
                              scale, seed, plane, aligned);
    __syncthreads();  // the next tile reuses the shared memory
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename S, bool kVecX>
cudaError_t launch_mma(const void* q, const void* rwbs, const void* rrbs, const void* mem,
                       const void* k_win, const void* v_win, const void* w_r,
                       const void* trig_a, const void* psi, const void* mask, const void* reset,
                       void* out, void* k_mem, void* v_mem, void* s_res, void* lse,
                       const S* wpad, int layer, int B, int H, int dh, int T, int R, int Tb, int D,
                       int F2, float scale, int seed, int thresh, float keep_scale, int bits,
                       cudaStream_t stream) {
  size_t smem = fwd_mma_smem<S, false>(F2);
  const size_t ring = static_cast<size_t>(kProjStages) * stage_bytes<S>();
  if (ring > smem) smem = ring;
  auto kernel = rel_attention_proj_fwd_mma_kernel<S, kVecX>;
  const cudaError_t err = commu::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // 16-byte key groups of phase 2: whole in one slab or the window, aligned
  constexpr int kVec = 16 / sizeof(S);
  const bool aligned = T % kVec == 0 && Tb % kVec == 0 && aligned16(k_mem) &&
                       aligned16(k_win) && aligned16(v_mem) && aligned16(v_win) &&
                       aligned16(psi);
  kernel<<<B * H, kFwdThreads, smem, stream>>>(
      static_cast<const S*>(q), static_cast<const S*>(rwbs), static_cast<const S*>(rrbs),
      static_cast<const S*>(mem), wpad, static_cast<const S*>(k_win),
      static_cast<const S*>(v_win), static_cast<const S*>(w_r), static_cast<const S*>(trig_a),
      static_cast<const S*>(psi), static_cast<const __nv_bfloat16*>(mask),
      static_cast<const int*>(reset), static_cast<S*>(out), static_cast<S*>(k_mem),
      static_cast<S*>(v_mem), static_cast<float*>(s_res), static_cast<float*>(lse), layer, B, H,
      dh, T, R, Tb, D, proj_depth<S>(D), F2, scale, seed,
      commu::make_plane(T, R * Tb + T, thresh, keep_scale, bits), aligned);
  return cudaGetLastError();
}

template <typename S>
size_t workspace_bytes(int D, int H, int dh, int F2) {
  if (!proj_on_tensor_cores(dh, F2)) return 0;
  return static_cast<size_t>(H) * proj_depth<S>(D) * kBM * sizeof(S);
}

// ---- the first design, at every other width: one block per (b, h), 256
// threads.  Phase 1: for every slab and every 64 tokens of it, the rows [k
// dims | v dims] (kMaxDh each, the rows past dh zero) in two tiles of 128
// rows x 64 tokens, depth D in chunks of 16 staged in shared memory by
// scalar loads; a thread owns 8 rows x 4 tokens of a tile, each output one
// fmaf chain over d = 0 .. D-1.  Phase 2, after a barrier: the first design
// of the memory forward (rel_attention_mem_fwd_body.cuh, FMA products) once
// per tile of 32 query rows, its slabs read back on the coherent path (k_mem
// and v_mem carry no __restrict__).
constexpr int kPK = 16;   // depth (d) per staged chunk of the projection
constexpr int kPN = 64;   // tokens per projection tile
constexpr int kPM = 128;  // rows per projection tile: of [k dims | v dims]

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
  float* w_s = smem;             // [kPK][kPM]: a tile of [Wk columns of head h | Wv columns]
  float* x_s = w_s + kPK * kPM;  // [kPK][kPN]
  const int ty = tid / 16;       // rows 8 ty + {0..7} of the tile
  const int tx = tid % 16;       // tokens 4 tx + {0..3}
  for (int r = 0; r < R; ++r) {
    const S* x = mem + ((static_cast<size_t>(layer) * R + r) * B + b) * D * Tb;
    const size_t slab = ((static_cast<size_t>(b) * R + r) * H + h) * dh * Tb;
    for (int m0 = 0; m0 < 2 * kMaxDh; m0 += kPM)  // k dims below kMaxDh, v dims above
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
            const int row = m0 + idx - dd * kPM;
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
          const int row = m0 + ty * 8 + i;
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
    attend_query_tile<S>(smem, q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a, psi,
                         nullptr, mask, reset, out, s_res, lse, bh, q0, H, dh, T, R, Tb, F2,
                         scale, seed, plane);
}

template <typename S>
int launch_fma(const void* q, const void* rwbs, const void* rrbs, const void* mem,
                       const void* wk, const void* wv, const void* k_win, const void* v_win,
                       const void* w_r, const void* trig_a, const void* psi, const void* mask,
                       const void* reset, void* out, void* k_mem, void* v_mem, void* s_res,
                       void* lse, int layer, int B, int H, int dh, int T, int R, int Tb, int D,
                       int F2, float scale, int seed, int thresh, float keep_scale, int bits,
                       cudaStream_t stream) {
  if (dh > kMaxDh) return cudaErrorInvalidValue;
  size_t smem = attend_smem_bytes(dh, F2);
  if (smem > commu::kMaxSmemBytes) return commu::kRefusedSmem;  // 2F and dh too wide
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

template <typename S>
int launch(const void* q, const void* rwbs, const void* rrbs, const void* mem, const void* wk,
           const void* wv, const void* k_win, const void* v_win, const void* w_r,
           const void* trig_a, const void* psi, const void* mask, const void* reset, void* out,
           void* k_mem, void* v_mem, void* s_res, void* lse, void* work, int layer, int B, int H,
           int dh, int T, int R, int Tb, int D, int F2, float scale, int seed, int thresh,
           float keep_scale, int bits, cudaStream_t stream) {
  if (B < 1 || H < 1 || dh < 1 || T < 1 || R < 1 || Tb < 1 || D < 1)
    return cudaErrorInvalidValue;
  if (!proj_on_tensor_cores(dh, F2))
    return launch_fma<S>(q, rwbs, rrbs, mem, wk, wv, k_win, v_win, w_r, trig_a, psi, mask, reset,
                         out, k_mem, v_mem, s_res, lse, layer, B, H, dh, T, R, Tb, D, F2, scale,
                         seed, thresh, keep_scale, bits, stream);
  S* wpad = static_cast<S*>(work);
  const int dp = proj_depth<S>(D);
  const long long cells = static_cast<long long>(H) * dp * kBM;
  proj_weights_kernel<S><<<static_cast<unsigned>((cells + kFwdThreads - 1) / kFwdThreads),
                           kFwdThreads, 0, stream>>>(static_cast<const S*>(wk),
                                                     static_cast<const S*>(wv), wpad, D, H, dh,
                                                     dp);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if ((static_cast<size_t>(Tb) * sizeof(S)) % 16 == 0)
    return launch_mma<S, true>(q, rwbs, rrbs, mem, k_win, v_win, w_r, trig_a, psi, mask, reset,
                               out, k_mem, v_mem, s_res, lse, wpad, layer, B, H, dh, T, R, Tb, D,
                               F2, scale, seed, thresh, keep_scale, bits, stream);
  return launch_mma<S, false>(q, rwbs, rrbs, mem, k_win, v_win, w_r, trig_a, psi, mask, reset,
                              out, k_mem, v_mem, s_res, lse, wpad, layer, B, H, dh, T, R, Tb, D,
                              F2, scale, seed, thresh, keep_scale, bits, stream);
}

}  // namespace

// bytes of scratch the launch needs at these widths: the head-major weight
// copy of the tensor-core form, none for the first design
extern "C" long long commu_rel_attention_proj_fwd_workspace(int dtype, int D, int H, int dh,
                                                             int F2) {
  if (dtype == commu::kFloat32) return static_cast<long long>(workspace_bytes<float>(D, H, dh, F2));
  return static_cast<long long>(workspace_bytes<__nv_bfloat16>(D, H, dh, F2));
}

extern "C" int commu_rel_attention_proj_fwd(
    int dtype, const void* q, const void* rwbs, const void* rrbs, const void* mem, const void* wk,
    const void* wv, const void* k_win, const void* v_win, const void* w_r, const void* trig_a,
    const void* psi, const void* mask, const void* reset, void* out, void* k_mem, void* v_mem,
    void* s_res, void* lse, void* work, int layer, int B, int H, int dh, int T, int R, int Tb,
    int D, int F2, float scale, int seed, int thresh, float keep_scale, int bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == commu::kFloat32)
    return launch<float>(q, rwbs, rrbs, mem, wk, wv, k_win, v_win, w_r, trig_a, psi, mask, reset,
                         out, k_mem, v_mem, s_res, lse, work, layer, B, H, dh, T, R, Tb, D, F2,
                         scale, seed, thresh, keep_scale, bits, s);
  if (dtype == commu::kBFloat16)
    return launch<__nv_bfloat16>(q, rwbs, rrbs, mem, wk, wv, k_win, v_win, w_r, trig_a, psi, mask,
                                 reset, out, k_mem, v_mem, s_res, lse, work, layer, B, H, dh, T,
                                 R, Tb, D, F2, scale, seed, thresh, keep_scale, bits, s);
  return cudaErrorInvalidValue;
}
