// Fixed-order reductions over batch rows, shared by the backward kernels.
//
// The TPU kernels accumulate their weight gradients in a VMEM-resident block
// across a grid that runs in order on one core.  On the H100 blocks run in
// parallel and in no order, so a sum over the batch is taken in two passes:
// each block sums a fixed group of batch rows into its own slot of a partial
// buffer, then a second kernel adds the groups in index order.  No float
// atomics: two runs on the same inputs give the same bits.
//
// An operand is a functor ``float operator()(int p, int b, int m, int t)``:
// problem p (a head, or 0), batch row b, output index m, summed index t.
// The functor applies the reference's roundings and layout, so one tiled
// product serves every weight gradient of the port.
#pragma once

#include "common.cuh"

#include <stddef.h>

namespace commu {

constexpr int kRedThreads = 256;
constexpr int kRedBM = 64;  // output rows per block
constexpr int kRedBN = 64;  // output columns per block
constexpr int kRedBK = 16;  // summed indices per staged chunk
constexpr int kRedPad = kRedBM + 4;  // row stride of the staged tiles

// partial[p][g][m][n] = sum over rows b of group g, t < len, of
//                       A(p, b, m, t) * B(p, b, n, t)
// grid (ceil(M / 64), ceil(N / 64), P * groups); each thread owns 4 x 4
// outputs; the chunk's t runs fastest across threads, so t-minor operands
// load coalesced.
template <class OpA, class OpB>
__global__ void __launch_bounds__(kRedThreads)
outer_partial_kernel(OpA op_a, OpB op_b, float* __restrict__ partial, int M, int N, int rows,
                     int len, int groups, int rows_per_group) {
  __shared__ __align__(16) float a_s[kRedBK][kRedPad];
  __shared__ __align__(16) float b_s[kRedBK][kRedPad];
  const int m0 = blockIdx.x * kRedBM;
  const int n0 = blockIdx.y * kRedBN;
  const int p = blockIdx.z / groups;
  const int g = blockIdx.z - p * groups;
  const int b_begin = g * rows_per_group;
  const int b_end = min(rows, b_begin + rows_per_group);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int b = b_begin; b < b_end; ++b) {
    for (int t0 = 0; t0 < len; t0 += kRedBK) {
#pragma unroll
      for (int e = 0; e < kRedBK * kRedBM / kRedThreads; ++e) {
        const int idx = tid + kRedThreads * e;
        const int tt = idx % kRedBK;
        const int mm = idx / kRedBK;
        const int t = t0 + tt;
        const int m = m0 + mm;
        const int n = n0 + mm;
        a_s[tt][mm] = (m < M && t < len) ? op_a(p, b, m, t) : 0.f;
        b_s[tt][mm] = (n < N && t < len) ? op_b(p, b, n, t) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kRedBK; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&a_s[kk][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(ar[i], br[c], acc[i][c]);
      }
      __syncthreads();
    }
  }
  float* out = partial + static_cast<size_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx * 4 + c;
      if (n < N) out[static_cast<size_t>(m) * N + n] = acc[i][c];
    }
  }
}

// partial[p][g][m] = sum over rows b of group g, t < len, of A(p, b, m, t)
// grid (ceil(M / 8), P * groups): one warp per m, lanes over t.
template <class OpA>
__global__ void __launch_bounds__(kRedThreads)
rowsum_partial_kernel(OpA op_a, float* __restrict__ partial, int M, int rows, int len,
                      int groups, int rows_per_group) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * (kRedThreads / 32) + warp;
  const int p = blockIdx.y / groups;
  const int g = blockIdx.y - p * groups;
  if (m >= M) return;
  const int b_end = min(rows, (g + 1) * rows_per_group);
  float s = 0.f;
  for (int b = g * rows_per_group; b < b_end; ++b)
    for (int t = lane; t < len; t += 32) s += op_a(p, b, m, t);
  s = warp_sum(s);
  if (lane == 0) partial[static_cast<size_t>(blockIdx.y) * M + m] = s;
}

// out[p][i] = sum over g, in index order, of partial[p][g][i]  (i < n)
static __global__ void __launch_bounds__(kRedThreads)
sum_groups_kernel(const float* __restrict__ partial, float* __restrict__ out, int n, int groups,
                  int problems) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kRedThreads + threadIdx.x;
  if (idx >= static_cast<size_t>(n) * problems) return;
  const size_t p = idx / n;
  const size_t i = idx - p * n;
  const float* src = partial + p * groups * static_cast<size_t>(n) + i;
  float s = 0.f;
  for (int g = 0; g < groups; ++g) s += src[static_cast<size_t>(g) * n];
  out[idx] = s;
}

// How a sum over ``rows`` batch rows splits into groups: enough blocks to
// fill the card about four times over, at most one group per row.
struct Split {
  int groups;
  int rows_per_group;
};

inline Split split_rows(int rows, int tiles) {
  const int want = (4 * 132 + tiles - 1) / tiles;
  int groups = want < rows ? want : rows;
  if (groups < 1) groups = 1;
  const int rpg = (rows + groups - 1) / groups;
  return Split{(rows + rpg - 1) / rpg, rpg};
}

inline int outer_tiles(int M, int N) {
  return ((M + kRedBM - 1) / kRedBM) * ((N + kRedBN - 1) / kRedBN);
}

inline int rowsum_tiles(int M) { return (M + kRedThreads / 32 - 1) / (kRedThreads / 32); }

// Bytes of partial buffer that reduce_outer / reduce_rows need.
inline size_t outer_scratch(int P, int M, int N, int rows) {
  const Split s = split_rows(rows, P * outer_tiles(M, N));
  return sizeof(float) * static_cast<size_t>(P) * s.groups * M * N;
}

inline size_t rowsum_scratch(int P, int M, int rows) {
  const Split s = split_rows(rows, P * rowsum_tiles(M));
  return sizeof(float) * static_cast<size_t>(P) * s.groups * M;
}

inline cudaError_t sum_groups(const float* partial, float* out, int n, int groups, int problems,
                              cudaStream_t stream) {
  const size_t total = static_cast<size_t>(n) * problems;
  const unsigned blocks = static_cast<unsigned>((total + kRedThreads - 1) / kRedThreads);
  sum_groups_kernel<<<blocks, kRedThreads, 0, stream>>>(partial, out, n, groups, problems);
  return cudaGetLastError();
}

// out[p][m][n] = sum over b < rows, t < len of A(p, b, m, t) * B(p, b, n, t),
// f32, in a fixed order; ``scratch`` holds outer_scratch(P, M, N, rows) bytes.
template <class OpA, class OpB>
cudaError_t reduce_outer(OpA op_a, OpB op_b, float* out, float* scratch, int P, int M, int N,
                         int rows, int len, cudaStream_t stream) {
  const Split s = split_rows(rows, P * outer_tiles(M, N));
  const dim3 grid((M + kRedBM - 1) / kRedBM, (N + kRedBN - 1) / kRedBN, P * s.groups);
  outer_partial_kernel<<<grid, kRedThreads, 0, stream>>>(op_a, op_b, scratch, M, N, rows, len,
                                                         s.groups, s.rows_per_group);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_groups(scratch, out, M * N, s.groups, P, stream);
}

// out[p][m] = sum over b < rows, t < len of A(p, b, m, t), f32, fixed order;
// ``scratch`` holds rowsum_scratch(P, M, rows) bytes.
template <class OpA>
cudaError_t reduce_rows(OpA op_a, float* out, float* scratch, int P, int M, int rows, int len,
                        cudaStream_t stream) {
  const Split s = split_rows(rows, P * rowsum_tiles(M));
  const dim3 grid(rowsum_tiles(M), P * s.groups);
  rowsum_partial_kernel<<<grid, kRedThreads, 0, stream>>>(op_a, scratch, M, rows, len, s.groups,
                                                          s.rows_per_group);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_groups(scratch, out, M, s.groups, P, stream);
}

// A bump allocator over a caller-provided workspace (256-byte aligned
// slices); with a null base it only counts the bytes.
struct Workspace {
  char* base;
  size_t used;
  template <typename T>
  T* take(size_t count) {
    const size_t bytes = (count * sizeof(T) + 255) / 256 * 256;
    T* ptr = base ? reinterpret_cast<T*>(base + used) : nullptr;
    used += bytes;
    return ptr;
  }
};

}  // namespace commu
