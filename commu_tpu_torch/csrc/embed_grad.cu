// Gradient of the scaled token-embedding lookup.
//
// Replaces: commu_tpu/ops/embed.py::_embed_grad_kernel (:27), as launched by
//   _embed_grad (:48, pallas_call :57) from embed_bdt's backward (:80).
//
//   demb[v, :] = scale * sum over (b, t) with tokens[b, t] == v of g[b, :, t]
//
// g [B, D, T] is the cotangent of the [B, D, T] embedding output, in the
// compute dtype; demb [V, D] is f32.  PAD input tokens count like any other;
// a token outside [0, V) adds to no row.  The reference forms the sums as
// one-hot [V, T] x [T, D] MXU products accumulated in f32 across the batch.
//
// What bounds it on the H100: memory.  At the training shape (B = 256,
// T = 128, D = 500, V = 729) g is 65.5 MB in f32 and everything else is
// small: 0.02 ms at 3.35 TB/s.  What held the first form back was not bytes
// but balance: one block per vocabulary entry walked all B*T tokens and summed
// its hits one position after another, so the PAD block (about 4,650
// positions of a padded batch) ran alone for 1.5 ms while 728 blocks idled,
// and its loads of g[b, d, t] were strided by T.
//
// Design: a deterministic segmented sum in six small launches, with no float
// atomics (the same bits every run):
//   1. count: one block per tile of 1024 positions histograms its tokens
//      (integer shared-memory atomics: a count has no order);
//   2. scan: one block turns the per-tile counts into each tile's first slot
//      in each token's segment of the sorted list, and cuts every token's
//      segment into chunks of kChunk positions (a chunk table);
//   3. scatter: one warp per tile walks its positions in order and writes
//      each to its slot (a warp match gives the rank among equal tokens), so
//      a token's positions sit in position order: a counting sort;
//   4. transpose: g's [D, T] planes become [B*T, Dp] f32 rows through shared
//      memory, coalesced on both sides (Dp: D rounded up to 4, zero-padded);
//   5. chunk sums: one block per chunk adds its <= kChunk rows in a fixed
//      order with 16-byte loads into a partial row, so a hot token (PAD) is
//      spread over many blocks on all SMs;
//   6. finish: one block per token adds its chunks' partials in a fixed
//      order, scales and writes demb; a token without hits gets zeros.
#include "common.cuh"
#include "reduce.cuh"

namespace {

constexpr int kTile = 1024;  // positions per count / scatter tile
constexpr int kPerLane = kTile / 32;
constexpr int kCountThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kChunk = 64;   // positions per chunk sum
constexpr int kSumThreads = 128;  // >= kChunk: a position index each
constexpr int kMaxVec = 2;   // float4 per thread in the sums: Dp <= 1024
constexpr int kMaxVocab = 10240;  // a [V] int table in shared memory (40 KB)

struct Layout {
  int* hist;     // [tiles, V]: counts, then each tile's first slot per token
  int* start;    // [V + 1]: first slot of each token's segment; [V] = hits
  int* chunk0;   // [V + 1]: first chunk of each token; [V] = chunks in all
  int2* chunks;  // [max_chunks]: slot range of each chunk
  int* order;    // [N]: positions sorted by token, in position order
  float* rows;   // [N, Dp]
  float* partial;  // [max_chunks, Dp]
};

int tiles_of(int n) { return (n + kTile - 1) / kTile; }
int max_chunks(int n, int V) { return (n + kChunk - 1) / kChunk + V; }
int padded(int D) { return (D + 3) / 4 * 4; }

size_t carve(commu::Workspace& ws, Layout* l, int B, int D, int T, int V) {
  const int n = B * T;
  const size_t dp = padded(D);
  l->hist = ws.take<int>(static_cast<size_t>(tiles_of(n)) * V);
  l->start = ws.take<int>(V + 1);
  l->chunk0 = ws.take<int>(V + 1);
  l->chunks = ws.take<int2>(max_chunks(n, V));
  l->order = ws.take<int>(n);
  l->rows = ws.take<float>(static_cast<size_t>(n) * dp);
  l->partial = ws.take<float>(static_cast<size_t>(max_chunks(n, V)) * dp);
  return ws.used;
}

__global__ void __launch_bounds__(kCountThreads)
embed_count_kernel(const int* __restrict__ tokens, int* __restrict__ hist, int n, int V) {
  extern __shared__ int count[];
  const int tile = blockIdx.x;
  for (int v = threadIdx.x; v < V; v += kCountThreads) count[v] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < kTile; i += kCountThreads) {
    const int pos = tile * kTile + i;
    const int v = pos < n ? tokens[pos] : -1;
    if (v >= 0 && v < V) atomicAdd(&count[v], 1);
  }
  __syncthreads();
  for (int v = threadIdx.x; v < V; v += kCountThreads)
    hist[static_cast<size_t>(tile) * V + v] = count[v];
}

// exclusive prefix sums over the block of a pair of ints (blockDim 1024)
__device__ int2 block_exclusive_scan(int2 x, int2* warp_sums) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int2 inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, inc.x, off);
    const int b = __shfl_up_sync(0xffffffffu, inc.y, off);
    if (lane >= off) inc.x += a, inc.y += b;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int2 w = warp_sums[lane];
    int2 s = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int a = __shfl_up_sync(0xffffffffu, s.x, off);
      const int b = __shfl_up_sync(0xffffffffu, s.y, off);
      if (lane >= off) s.x += a, s.y += b;
    }
    warp_sums[lane] = make_int2(s.x - w.x, s.y - w.y);
  }
  __syncthreads();
  const int2 base = warp_sums[warp];
  return make_int2(base.x + inc.x - x.x, base.y + inc.y - x.y);
}

__global__ void __launch_bounds__(kScanThreads)
embed_scan_kernel(int* __restrict__ hist, int* __restrict__ start, int* __restrict__ chunk0,
                  int2* __restrict__ chunks, int tiles, int V) {
  extern __shared__ int cnt[];  // [V]
  __shared__ int2 warp_sums[32];
  for (int v = threadIdx.x; v < V; v += kScanThreads) {
    int off = 0;
    for (int t0 = 0; t0 < tiles; t0 += 8) {  // loads first: 8 in flight
      int h[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        h[i] = t0 + i < tiles ? hist[static_cast<size_t>(t0 + i) * V + v] : 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (t0 + i < tiles) hist[static_cast<size_t>(t0 + i) * V + v] = off;
        off += h[i];
      }
    }
    cnt[v] = off;
  }
  __syncthreads();
  // each thread owns a contiguous run of tokens
  const int per = (V + kScanThreads - 1) / kScanThreads;
  const int lo = min(V, threadIdx.x * per), hi = min(V, lo + per);
  int2 own = make_int2(0, 0);
  for (int v = lo; v < hi; ++v) own.x += cnt[v], own.y += (cnt[v] + kChunk - 1) / kChunk;
  int2 at = block_exclusive_scan(own, warp_sums);
  if (threadIdx.x == kScanThreads - 1) {
    start[V] = at.x + own.x;
    chunk0[V] = at.y + own.y;
  }
  for (int v = lo; v < hi; ++v) {
    start[v] = at.x;
    chunk0[v] = at.y;
    const int end = at.x + cnt[v];
    for (int s = at.x; s < end; s += kChunk) chunks[at.y++] = make_int2(s, min(end, s + kChunk));
    at.x = end;
  }
}

__global__ void __launch_bounds__(32)
embed_scatter_kernel(const int* __restrict__ tokens, const int* __restrict__ hist,
                     const int* __restrict__ start, int* __restrict__ order, int n, int V) {
  extern __shared__ int slot[];  // [V]: the next free slot of each token
  const int tile = blockIdx.x, lane = threadIdx.x;
  int tok[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int pos = tile * kTile + k * 32 + lane;
    tok[k] = pos < n ? tokens[pos] : -1;
  }
  for (int v = lane; v < V; v += 32)
    slot[v] = start[v] + hist[static_cast<size_t>(tile) * V + v];
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int v = tok[k];
    const bool valid = v >= 0 && v < V;
    const unsigned same = __match_any_sync(0xffffffffu, valid ? v : -1);
    const int base = valid ? slot[v] : 0;
    __syncwarp();
    if (valid) {
      order[base + __popc(same & below)] = tile * kTile + k * 32 + lane;
      if (lane == 31 - __clz(same)) slot[v] = base + __popc(same);
    }
    __syncwarp();
  }
}

template <typename S>
__global__ void __launch_bounds__(256)
embed_transpose_kernel(const S* __restrict__ g, float* __restrict__ rows, int D, int T, int Dp) {
  __shared__ float tile[32][33];
  const int b = blockIdx.z, t0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = d0 + ty + 8 * i, t = t0 + tx;
    tile[ty + 8 * i][tx] =
        d < D && t < T ? commu::to_f(g[(static_cast<size_t>(b) * D + d) * T + t]) : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 8 * i, d = d0 + tx;
    if (t < T && d < Dp) rows[(static_cast<size_t>(b) * T + t) * Dp + d] = tile[tx][ty + 8 * i];
  }
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
}

// acc = the sum of rows row_at(0 .. count-1), each a [Dp] f32 row, in that
// order; kAhead rows are loaded before they are added
template <class RowAt>
__device__ __forceinline__ void ordered_row_sum(RowAt row_at, int count, int vecs,
                                                float4 (&acc)[kMaxVec]) {
  constexpr int kAhead = 8;
#pragma unroll
  for (int e = 0; e < kMaxVec; ++e) acc[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < count; s += kAhead) {
    float4 x[kAhead][kMaxVec];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const float4* row = reinterpret_cast<const float4*>(row_at(s + i < count ? s + i : s));
#pragma unroll
      for (int e = 0; e < kMaxVec; ++e) {
        const int j = threadIdx.x + kSumThreads * e;
        x[i][e] = j < vecs ? row[j] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
#pragma unroll
      for (int e = 0; e < kMaxVec; ++e)
        if (s + i < count) add4(acc[e], x[i][e]);
  }
}

__global__ void __launch_bounds__(kSumThreads)
embed_chunk_sum_kernel(const int* __restrict__ chunk0, const int2* __restrict__ chunks,
                       const int* __restrict__ order, const float* __restrict__ rows,
                       float* __restrict__ partial, int V, int Dp) {
  __shared__ int pos[kChunk];
  const int c = blockIdx.x;
  if (c >= chunk0[V]) return;
  const int2 range = chunks[c];
  const int len = range.y - range.x;
  if (threadIdx.x < len) pos[threadIdx.x] = order[range.x + threadIdx.x];
  __syncthreads();
  const int vecs = Dp / 4;
  float4 acc[kMaxVec];
  ordered_row_sum([&](int k) { return rows + static_cast<size_t>(pos[k]) * Dp; }, len, vecs,
                  acc);
  float4* out = reinterpret_cast<float4*>(partial + static_cast<size_t>(c) * Dp);
#pragma unroll
  for (int e = 0; e < kMaxVec; ++e) {
    const int j = threadIdx.x + kSumThreads * e;
    if (j < vecs) out[j] = acc[e];
  }
}

__global__ void __launch_bounds__(kSumThreads)
embed_finish_kernel(const int* __restrict__ chunk0, const float* __restrict__ partial,
                    float* __restrict__ demb, int D, int Dp, float scale) {
  const int v = blockIdx.x;
  const int c_lo = chunk0[v], c_hi = chunk0[v + 1];
  const int vecs = Dp / 4;
  float4 acc[kMaxVec];
  ordered_row_sum([&](int k) { return partial + static_cast<size_t>(c_lo + k) * Dp; },
                  c_hi - c_lo, vecs, acc);
#pragma unroll
  for (int e = 0; e < kMaxVec; ++e) {
    const int j = threadIdx.x + kSumThreads * e;
    const float vals[4] = {acc[e].x, acc[e].y, acc[e].z, acc[e].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int d = 4 * j + q;
      if (j < vecs && d < D) demb[static_cast<size_t>(v) * D + d] = vals[q] * scale;
    }
  }
}

template <typename S>
int launch(const void* tokens_, const void* g, void* demb, void* work, int B, int D, int T,
           int V, float scale, cudaStream_t stream) {
  const int dp = padded(D);
  if (dp > 4 * kSumThreads * kMaxVec || V < 1 || V > kMaxVocab || B * T < 1)
    return cudaErrorInvalidValue;
  commu::Workspace ws{static_cast<char*>(work), 0};
  Layout l;
  carve(ws, &l, B, D, T, V);
  const int n = B * T, tiles = tiles_of(n);
  const size_t vbytes = sizeof(int) * static_cast<size_t>(V);
  const int* tokens = static_cast<const int*>(tokens_);
  embed_count_kernel<<<tiles, kCountThreads, vbytes, stream>>>(tokens, l.hist, n, V);
  embed_scan_kernel<<<1, kScanThreads, vbytes, stream>>>(l.hist, l.start, l.chunk0, l.chunks,
                                                          tiles, V);
  embed_scatter_kernel<<<tiles, 32, vbytes, stream>>>(tokens, l.hist, l.start, l.order, n, V);
  const dim3 tgrid((T + 31) / 32, (dp + 31) / 32, B);
  embed_transpose_kernel<S><<<tgrid, 256, 0, stream>>>(static_cast<const S*>(g), l.rows, D, T,
                                                        dp);
  embed_chunk_sum_kernel<<<max_chunks(n, V), kSumThreads, 0, stream>>>(
      l.chunk0, l.chunks, l.order, l.rows, l.partial, V, dp);
  embed_finish_kernel<<<V, kSumThreads, 0, stream>>>(l.chunk0, l.partial,
                                                     static_cast<float*>(demb), D, dp, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" long long commu_embed_grad_workspace(int B, int D, int T, int V) {
  commu::Workspace ws{nullptr, 0};
  Layout l;
  return static_cast<long long>(carve(ws, &l, B, D, T, V));
}

extern "C" int commu_embed_grad(int dtype, const void* tokens, const void* g, void* demb,
                                void* work, int B, int D, int T, int V, float scale,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == commu::kFloat32)
    return launch<float>(tokens, g, demb, work, B, D, T, V, scale, s);
  if (dtype == commu::kBFloat16)
    return launch<__nv_bfloat16>(tokens, g, demb, work, B, D, T, V, scale, s);
  return cudaErrorInvalidValue;
}
