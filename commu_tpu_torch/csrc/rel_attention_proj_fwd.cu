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
// Design, the narrow form (dh <= 64, 2F a multiple of 128 up to 512:
// ModelConfig()'s widths): one block per (b, h), 256 threads, two
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
//       drains between them.  The 8-deep (f32) and 16-deep (bf16) steps and
//       the order of the three passes are those of project_mem_kv.cu's
//       warpgroup product (wgmma_product.cuh), whose wgmma gives this
//       mma.sync tile's bits step for step (tests/test_torch_kernels_cuda.py
//       -k warpgroup_product), so the slabs equal its slabs bit for bit.  The sums are rounded to S and written to k_mem
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
// The wide form (every other width the forwards take: heads up to 256,
// any even 2F; Transformer-XL's published widths, and a ModelConfig()
// variant whose 2F is no multiple of 128): the same two phases, one block
// per (b, h), by the rule fwd_narrow of rel_attention_fwd_wide.cuh, which
// #2's launch shares.
//   (0) proj_weights_wide_kernel: the same copy, its rows [k dims | v dims]
//       padded to whole tiles of 128 (wpad [H][Dp][Mp]).  At dh 64-256 head
//       h's columns start on 16 bytes and could be staged where they lie,
//       but the copy costs 7-24 us a launch at the published widths on an
//       H100 (chip_smoke.py --wide --proj, [passes]), under 0.05% of it, and
//       keeps one staging path for every width (dh 50 at a 2F of 600 takes
//       this form too).
//   (1) the projection as in the narrow form, over Mp / 128 row tiles (one
//       at dh 64, two at 128, four at 256) of each token tile, so the slabs
//       equal project_mem_kv.cu's bit for bit here too.  Where a block has
//       its SM alone (bf16, and f32 at dh 256) it finds each chunk's place by
//       counters and takes two chunks between barriers (project_slabs'
//       kAlone): with the narrow form's four divisions a chunk the bf16
//       forms took 1.24-1.30x #5 + #2's time, with the counters and the
//       two-chunk steps 1.14-1.20x (H100, chip_smoke.py --wide --proj).
//   (2) #2's wide body (rel_attention_fwd_wide.cuh: attend_rows_wide, with
//       #2's template choice by dh, its layout wide_choose, plane and
//       seeds, so out, S, lse and the masks are #2's bits over #5's slabs)
//       for each 64-row query tile; where the layout streams the query side
//       (f32 past 2F 512, bf16 past 1024) it lies in a workspace slot a (b,
//       h) after the weight copy, reused by the block's query tiles in turn.
//   Shared memory: the larger of phase 1's ring and the body's layout; the
//   launch bounds are #2's wide kernel's (wide_min_blocks: two blocks an SM
//   for the f32 form at dh <= 128).
//   The grid: a thread-block cluster of a (b, h)'s query tiles, each block
//   projecting every other unit, a cluster barrier, then its own tile, ran
//   within -4..+5% of one block per (b, h) in turns at the four published
//   widths on an H100, slower in bf16 at all four; the grid stays one block
//   per (b, h).
// No width runs an FMA projection or an FMA attention body.
#include "rel_attention_fwd_wide.cuh"

namespace {

// ---- the narrow form, and what both forms share

constexpr int kProjStages = 4;  // depth chunks of phase 1 in flight
// the same where a block has its SM alone (project_slabs' kAlone): a ring
// of 6, taken 2 chunks between two barriers
constexpr int kAloneStages = 6;
constexpr int kAloneStep = 2;

// the weight copy's depth: D rounded up to whole chunks of the tile (zero
// steps past D add nothing to the sums)
template <typename S>
int proj_depth(int D) {
  return (D + kDepth<S> - 1) / kDepth<S> * kDepth<S>;
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

// (1) the slabs of head h of batch row b: for r < R, token tiles n0 and
// row tiles m0 (m_tiles of 128 rows; wh's row stride mp = 128 m_tiles),
// acc[o][t] = sum_d wh[d][m0 + o] X_r[d][n0 + t] over Dp / kDepth chunks,
// then rows m0 + o < dh to k_mem, dh <= m0 + o < 2 dh to v_mem, rounded to
// S.  kAlone: a block that has its SM alone (the wide form where
// wide_min_blocks is 1) keeps each chunk's place (depth chunk, row tile,
// token tile, slab) in counters that step with the chunks, where the other
// forms divide the chunk index (the counters' registers spill where two
// blocks share an SM), and takes kAloneStep chunks between two barriers.
template <typename S, bool kVecX, bool kAlone = false>
__device__ __forceinline__ void project_slabs(unsigned char* smem, const S* mem, const S* wh,
                                              S* k_mem, S* v_mem, int layer, int b, int h,
                                              int B, int H, int dh, int R, int Tb, int D,
                                              int Dp, int m_tiles, int mp) {
  constexpr int kStages = kAlone ? kAloneStages : kProjStages;
  constexpr int kBKd = kDepth<S>, kS = kStride;
  constexpr int kVec = 16 / static_cast<int>(sizeof(S));  // elements a copy
  constexpr int kCopies = kBKd * kBM / kVec / kFwdThreads;  // per operand, thread and chunk
  constexpr int kXLoads = kBKd * kBN / kFwdThreads;         // the plain-load form
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int chunks = Dp / kBKd;
  const int n_tiles = (Tb + kBN - 1) / kBN;
  const int total = R * n_tiles * m_tiles * chunks;

  auto a_tile = [&](int stage) { return reinterpret_cast<S*>(smem + stage * stage_bytes<S>()); };
  auto x_tile = [&](int stage) { return a_tile(stage) + kBKd * kS; };
  // a chunk's place: depth chunk, row tile, token tile, slab (the order
  // of the chunks)
  struct Place {
    int k = 0, m = 0, n = 0, r = 0;
  };
  auto step = [&](Place& at) {
    if (++at.k < chunks) return;
    at.k = 0;
    if (++at.m < m_tiles) return;
    at.m = 0;
    if (++at.n < n_tiles) return;
    at.n = 0;
    ++at.r;
  };
  Place issued, taken;  // kAlone: the next chunk to issue, and to multiply
  // chunk kt (unit kt / chunks: its row tile, then token tile, then slab;
  // depth chunk kt % chunks) into stage kt % kStages
  auto issue = [&](int kt) {
    int k0, m, r, n0;
    if constexpr (kAlone) {
      k0 = issued.k * kBKd, m = issued.m, r = issued.r, n0 = issued.n * kBN;
      step(issued);
    } else {
      const int unit = kt / chunks;
      k0 = (kt - unit * chunks) * kBKd;
      m = unit % m_tiles;
      const int rest = unit / m_tiles;
      r = rest / n_tiles, n0 = (rest - r * n_tiles) * kBN;
    }
    const S* x = mem + ((static_cast<size_t>(layer) * R + r) * B + b) * D * Tb;
    S* a_s = a_tile(kt % kStages);
    S* x_s = x_tile(kt % kStages);
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int idx = tid + kFwdThreads * i;
      const int kk = idx / (kBM / kVec), cc = idx % (kBM / kVec) * kVec;
      cp_async16(a_s + kk * kS + cc, wh + static_cast<size_t>(k0 + kk) * mp + m * kBM + cc, true);
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

  // kAlone: groups of kAloneStep chunks, one commit a group
  constexpr int kGroups = kAloneStages / kAloneStep;
  if constexpr (kAlone) {
    for (int kt = 0; kt < (kGroups - 1) * kAloneStep; ++kt) {
      if (kt < total) issue(kt);
      if (kt % kAloneStep == kAloneStep - 1) cp_async_commit();
    }
  } else {
#pragma unroll
    for (int kt = 0; kt < kStages - 1; ++kt) {
      if (kt < total) issue(kt);
      cp_async_commit();
    }
  }
  const int g = lane / 4, q = lane % 4;
  for (int kt = 0; kt < total; ++kt) {
    if constexpr (kAlone) {
      if (kt % kAloneStep == 0) {
        cp_async_wait<kGroups - 2>();  // chunks kt .. kt + kAloneStep - 1 have landed
        __syncthreads();               // ... everyone's; the last step's stages are free
#pragma unroll
        for (int u = 0; u < kAloneStep; ++u)
          if (kt + (kGroups - 1) * kAloneStep + u < total)
            issue(kt + (kGroups - 1) * kAloneStep + u);
        cp_async_commit();
      }
    } else {
      cp_async_wait<kStages - 2>();  // chunk kt has landed (this thread's copies)
      __syncthreads();                   // ... everyone's; stage (kt - 1) is free
      if (kt + kStages - 1 < total) issue(kt + kStages - 1);
      cp_async_commit();
    }
    warp_tile(a_tile(kt % kStages), x_tile(kt % kStages), acc, wm, wn, lane);
    int m, r, n0;
    if constexpr (kAlone) {
      const Place done = taken;
      step(taken);
      if (done.k != chunks - 1) continue;
      m = done.m, r = done.r, n0 = done.n * kBN;
    } else {
      const int unit = kt / chunks;
      if (kt - unit * chunks != chunks - 1) continue;
      m = unit % m_tiles;
      const int rest = unit / m_tiles;
      r = rest / n_tiles, n0 = (rest - r * n_tiles) * kBN;
    }
    // the tile is complete: C fragment rows g and g + 8, tokens 2q, 2q + 1
    const size_t slab = ((static_cast<size_t>(b) * R + r) * H + h) * dh * Tb;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int o = m * kBM + wm * kWM + mi * 16 + g + 8 * half;
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
                          layer, b, h, B, H, dh, R, Tb, D, Dp, 1, kBM);
  for (int q0 = 0; q0 < T; q0 += kFwdRows) {
    attend_rows_mma<S, false, false, commu::kSoftForm>(smem_mma, q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a, psi,
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

// ---- the wide form, at every other width (fwd_narrow false)

// rows of the projection tile column: [k dims | v dims] in whole tiles of
// 128 (one at dh <= 64, two at 128, four at 256)
__host__ __device__ inline int proj_rows(int dh) { return (2 * dh + kBM - 1) / kBM * kBM; }

// (0) wpad [H][Dp][Mp] (Mp = proj_rows(dh)): element (h, d, c) is Wk[d, h
// dh + c] for c < dh, Wv[d, h dh + c - dh] for dh <= c < 2 dh, else 0; 0
// for d >= D
template <typename S>
__global__ void __launch_bounds__(kFwdThreads)
proj_weights_wide_kernel(const S* wk, const S* wv, S* wpad, int D, int H, int dh, int Dp,
                         int Mp) {
  const long long idx = static_cast<long long>(blockIdx.x) * kFwdThreads + threadIdx.x;
  if (idx >= static_cast<long long>(H) * Dp * Mp) return;
  const int c = static_cast<int>(idx % Mp);
  const long long row = idx / Mp;
  const int d = static_cast<int>(row % Dp), h = static_cast<int>(row / Dp);
  S val = commu::from_f<S>(0.f);
  if (d < D && c < 2 * dh)
    val = (c < dh ? wk : wv)[static_cast<size_t>(d) * H * dh + h * dh + (c < dh ? c : c - dh)];
  wpad[idx] = val;
}

// (1) as the narrow form, over proj_rows(dh) / 128 row tiles; (2) #2's wide
// body (rel_attention_fwd_wide.cuh) for each 64-row query tile, with #2's
// layout L, plane and seeds; a streamed query side in the block's slot of
// ``slots`` (L.slot_bytes a (b, h), reused by its query tiles in turn).
// No pointer carries __restrict__ (see the header).
template <typename S, int kDhCap, bool kVecX>
__global__ void __launch_bounds__(kFwdThreads, wide_min_blocks<S, false, kDhCap>())
rel_attention_proj_fwd_wide_kernel(const S* q, const S* rwbs, const S* rrbs, const S* mem,
                                   const S* wpad, const S* k_win, const S* v_win, const S* w_r,
                                   const S* trig_a, const S* psi, const __nv_bfloat16* mask,
                                   const int* reset, S* out, S* k_mem, S* v_mem, float* s_res,
                                   float* lse, int layer, int B, int H, int dh, int T, int R,
                                   int Tb, int D, int Dp, int F2, float scale, int seed,
                                   commu::Plane plane, bool aligned, WideLayout L,
                                   unsigned char* slots) {
  extern __shared__ __align__(16) unsigned char smem_proj[];
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh - b * H;
  const int mp = proj_rows(dh);
  constexpr bool kAlone = wide_min_blocks<S, false, kDhCap>() == 1;
  project_slabs<S, kVecX, kAlone>(smem_proj, mem, wpad + static_cast<size_t>(h) * Dp * mp,
                                  k_mem, v_mem, layer, b, h, B, H, dh, R, Tb, D, Dp, mp / kBM,
                                  mp);
  unsigned char* slot = L.streamed ? slots + static_cast<size_t>(bh) * L.slot_bytes : nullptr;
  for (int q0 = 0; q0 < T; q0 += kFwdRows) {
    attend_rows_wide<S, false, kDhCap, false, commu::kSoftForm>(
        smem_proj, L, q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a, psi, nullptr, mask,
        reset, out, s_res, lse, slot, bh, q0, H, dh, T, R, Tb, F2, scale, seed, plane, aligned);
    __syncthreads();  // the next tile reuses the shared memory and the slot
  }
}

template <typename S, bool kVecX>
int launch_wide(const void* q, const void* rwbs, const void* rrbs, const void* mem,
                const void* k_win, const void* v_win, const void* w_r, const void* trig_a,
                const void* psi, const void* mask, const void* reset, void* out, void* k_mem,
                void* v_mem, void* s_res, void* lse, const S* wpad, unsigned char* slots,
                int layer, int B, int H, int dh, int T, int R, int Tb, int D, int F2, float scale,
                int seed, int thresh, float keep_scale, int bits, cudaStream_t stream) {
  const WideLayout L = wide_choose<S, false>(dh, F2);
  if (L.total > commu::kMaxSmemBytes) return commu::kRefusedSmem;
  size_t smem = L.total;
  const bool alone = (dh <= 128 ? wide_min_blocks<S, false, 128>()
                                : wide_min_blocks<S, false, 256>()) == 1;
  const size_t ring =
      static_cast<size_t>(alone ? kAloneStages : kProjStages) * stage_bytes<S>();
  if (ring > smem) smem = ring;
  auto kernel = dh <= 128 ? rel_attention_proj_fwd_wide_kernel<S, 128, kVecX>
                          : rel_attention_proj_fwd_wide_kernel<S, 256, kVecX>;
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
      commu::make_plane(T, R * Tb + T, thresh, keep_scale, bits), aligned, L, slots);
  return cudaGetLastError();
}

// the weight copy's bytes: [H][Dp][128] for the narrow form, [H][Dp][Mp]
// for the wide one (the same at dh <= 64)
template <typename S>
size_t weights_bytes(int D, int H, int dh) {
  return static_cast<size_t>(H) * proj_depth<S>(D) * proj_rows(dh) * sizeof(S);
}

// the weight copy, then (the wide form's streamed query side) a slot a (b, h)
template <typename S>
size_t workspace_bytes(int B, int D, int H, int dh, int F2) {
  size_t bytes = weights_bytes<S>(D, H, dh);
  if (!fwd_narrow(dh, F2)) {
    const WideLayout L = wide_choose<S, false>(dh, F2);
    if (L.streamed) bytes += L.slot_bytes * B * H;
  }
  return bytes;
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
  if (!fwd_on_tensor_cores(dh, F2)) return cudaErrorInvalidValue;
  S* wpad = static_cast<S*>(work);
  const int dp = proj_depth<S>(D);
  const bool vec_x = (static_cast<size_t>(Tb) * sizeof(S)) % 16 == 0;
  if (fwd_narrow(dh, F2)) {
    const long long cells = static_cast<long long>(H) * dp * kBM;
    proj_weights_kernel<S><<<static_cast<unsigned>((cells + kFwdThreads - 1) / kFwdThreads),
                             kFwdThreads, 0, stream>>>(static_cast<const S*>(wk),
                                                       static_cast<const S*>(wv), wpad, D, H, dh,
                                                       dp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (vec_x)
      return launch_mma<S, true>(q, rwbs, rrbs, mem, k_win, v_win, w_r, trig_a, psi, mask, reset,
                                 out, k_mem, v_mem, s_res, lse, wpad, layer, B, H, dh, T, R, Tb,
                                 D, F2, scale, seed, thresh, keep_scale, bits, stream);
    return launch_mma<S, false>(q, rwbs, rrbs, mem, k_win, v_win, w_r, trig_a, psi, mask, reset,
                                out, k_mem, v_mem, s_res, lse, wpad, layer, B, H, dh, T, R, Tb, D,
                                F2, scale, seed, thresh, keep_scale, bits, stream);
  }
  const int mp = proj_rows(dh);
  const long long cells = static_cast<long long>(H) * dp * mp;
  proj_weights_wide_kernel<S><<<static_cast<unsigned>((cells + kFwdThreads - 1) / kFwdThreads),
                                kFwdThreads, 0, stream>>>(static_cast<const S*>(wk),
                                                          static_cast<const S*>(wv), wpad, D, H,
                                                          dh, dp, mp);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  unsigned char* slots = static_cast<unsigned char*>(work) + weights_bytes<S>(D, H, dh);
  if (vec_x)
    return launch_wide<S, true>(q, rwbs, rrbs, mem, k_win, v_win, w_r, trig_a, psi, mask, reset,
                                out, k_mem, v_mem, s_res, lse, wpad, slots, layer, B, H, dh, T, R,
                                Tb, D, F2, scale, seed, thresh, keep_scale, bits, stream);
  return launch_wide<S, false>(q, rwbs, rrbs, mem, k_win, v_win, w_r, trig_a, psi, mask, reset,
                               out, k_mem, v_mem, s_res, lse, wpad, slots, layer, B, H, dh, T, R,
                               Tb, D, F2, scale, seed, thresh, keep_scale, bits, stream);
}

}  // namespace

// bytes of scratch the launch needs at these widths: the head-major weight
// copy, and in the wide form's streamed query side a slot a (b, h)
extern "C" long long COMMU_ENTRY(commu_rel_attention_proj_fwd_workspace)(int dtype, int B, int D, int H,
                                                             int dh, int F2) {
  if (dtype == commu::kFloat32)
    return static_cast<long long>(workspace_bytes<float>(B, D, H, dh, F2));
  return static_cast<long long>(workspace_bytes<__nv_bfloat16>(B, D, H, dh, F2));
}

extern "C" int COMMU_ENTRY(commu_rel_attention_proj_fwd)(
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
