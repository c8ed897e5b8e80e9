// One warpgroup product for the memory's K/V on Hopper's wgmma, fed by TMA:
// #5's projection (project_mem_kv.cu) and its transpose, #4's dWk / dWv
// batch sums (rel_attention_mem_bwd.cu); csrc/sums.cu exposes both to the
// tests.  Everything here has internal linkage: each source that includes
// this file compiles its own copy.
//
// Replaces, as a design: mma_tile.cuh's 128 x 128 mma.sync tile for #5
// (commu_tpu/ops/fused_attention.py::_proj_mem_kernel :1539) and
// reduce.cuh's reduce_outer_copy for dWk, dWv (_bwd_kernel_mem's
// dot_general(dk_g, mem_r), accumulated across the batch grid, :1425-1460).
// Both are one GEMM over the ring's slabs ([D, Tb], tokens contiguous):
//   #5:   out[o][t]  = sum_d Wcat[d][o] X[d][t], X = mem[layer, r, b], for
//         every slab, Wcat = [Wk | Wv] (2 H dh rows), rounded to the ring's
//         dtype into k, v [B, R, H, dh, Tb];
//   sums: out[o][d] = sum_b sum_t A[b][o][t] mem[layer][b][d][t], A the f32
//         dk_mem and dv_mem workspaces taken as one stacked operand, rounded
//         to bf16 on load in bf16 (the reference's cast), f32 out.
//
// What bounds it on the H100: tensor-core arithmetic (bf16 at 989 TFLOP/s,
// 3xTF32 at a third of 495), except the bf16 sums at ModelConfig()'s
// widths, whose f32 dk_mem and dv_mem bind by bytes.  mma.sync reaches the
// tensor cores at a fraction of their rate on this card; wgmma is the way
// to all of it.
//
// Design: a block of two consumer warpgroups and a producer warpgroup, one
// block an SM over a persistent grid that walks the output tiles (the
// producer runs ahead into the next tile's loads while the consumers finish
// the last one); setmaxnreg moves the producer's registers to the consumers
// (40 and 232 a thread; ptxas holds each thread of three warpgroups to 168
// otherwise).  One producer lane keeps a ring of shared-memory stages full
// with TMA loads (128-byte swizzle; 64-byte for the 32-deep bf16 sums'
// ring rows), each completing on a full mbarrier; each consumer warp
// releases a stage on an empty mbarrier.  No block-wide barrier in the
// loop.  Each consumer warpgroup runs wgmma.mma_async on 64 rows of A at a
// time, B (and #5's bf16 A) through shared-memory descriptors.  wgmma takes
// TF32 only K-major from shared memory, and the slabs lie tokens-contiguous,
// so the f32 forms and the bf16 sums take A from registers, loaded from the
// staged tile:
//   #5 f32: A = X (64 tokens a warpgroup, 128 a block, split hi / lo in
//     registers), B = the weight copy's hi and lo planes, K-major [rows][D],
//     128 rows a block, written once a call by kv_weights_kernel (hi =
//     rna_tf32(w), lo = w - hi raw, as split_tf32_raw_lo splits).
//   #5 bf16: A = the weight copy (128 rows a warpgroup as two m64 tiles, 256
//     a block), B = X as it lies (MN-major, imm-trans-b), 128 tokens; each
//     thread holds neighbouring tokens of four rows, stored through a
//     swizzled staging tile by TMA (below).
//   sums: A = dk / dv (128 rows a block, 64 a warpgroup, rows of one of
//     the two), B = the ring's rows (256 d a block in bf16, one m64n256k16
//     a step; 128 in f32), summed over t in chunks of 32 (bf16: 64 where
//     the slabs allow) across the group's batch rows.  f32: both warpgroups
//     split the landed B tile once into hi and lo planes (hi rna, lo raw;
//     two sets in turn, so a set is rewritten only after every group that
//     read it has landed); A splits in registers.  bf16: A is rounded to
//     bf16 as it is loaded.
// bf16 keeps one chunk's group in flight while the next is issued.  The
// first design, 128 x 128 tiles with a wait on every group and 128
// scattered stores a thread a tile, ran #5 bf16 at 24-46% of its bound;
// the tiles here, the TMA stores under the next tile's products and the
// f32 halves below took it to 42-68% (PERF.md, PR 24's design rounds).
// Numerics: f32 keeps 3xTF32 in a fresh accumulator for every depth step
// of 8 (scale-d 0 on the first of the three passes), waited on and added
// to the tile's sums in round-to-nearest f32 on the CUDA cores
// (add_promoted's arithmetic, reduce.cuh), the passes in the order of the
// mma.sync forms they replace: #5 w_lo x_hi, w_hi x_lo, w_hi x_hi; the
// sums a_lo b_hi, a_hi b_lo, a_hi b_hi.  A step runs as two n64 halves,
// each its own group: while one half's product is added, the other's is on
// the tensor cores (chunk_f32).  On the same fragments a wgmma depth step
// gives an mma.sync step's bits (the probe, tests/test_torch_kernels_cuda.py
// -k warpgroup_product), so #5's slabs equal #6's, which project on
// mma_tile.cuh's tile.  bf16 sums stay in the accumulator.  The batch sums
// keep split_rows' fixed groups (at most kMaxGroupTerms terms a group) into
// a partial buffer and sum_groups in index order: no atomics, no TMA
// reduce-add, so two runs give the same bits.
// TMA's descriptors come from cuTensorMapEncodeTiled, which the library
// takes from the driver through cudaGetDriverEntryPointByVersion (it links
// no -lcuda); a failure to find or encode one is an error the entry
// returns.  TMA wants 16-byte global strides: a slab whose rows are no
// whole 16 bytes (Tb * sizeof(S) % 16 != 0) takes #5's form that stages X
// by plain loads of the producer warp into the same swizzled layout, and
// stores its sums from registers; the batch sums run here only where
// reduce.cuh's copyable() holds (whole 32-token chunks), and
// reduce_outer_mma otherwise.
#pragma once

#include "reduce.cuh"

#include <cuda.h>
#include <stdint.h>

#include <algorithm>

namespace {
namespace wg {

using commu::pack_bf16;
using commu::split_tf32_raw_lo;
using commu::tf32_rna;

constexpr int kConsumers = 2;                     // warpgroups that multiply
constexpr int kThreads = 128 * (kConsumers + 1);  // and a producer warpgroup
constexpr int kProducerWarp = 4 * kConsumers;     // its one warp that loads
constexpr int kRow = 128;                         // bytes of a swizzled row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
// the 128 threads of consumer warpgroup w (named barrier 1 + w)
__device__ __forceinline__ void group_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
}

// ---- TMA loads into shared memory, completing on ``bar``
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// a TMA store of a box from shared memory, in this thread's bulk group;
// elements past the tensor's dims (before its start too) are not written
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// until they are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// byte offset of byte b of row ``row`` in a tile of 128-byte rows that TMA
// wrote with CU_TENSOR_MAP_SWIZZLE_128B from a 1024-byte-aligned base: the
// 16-byte chunk index XORed with the row's index mod 8
__device__ __forceinline__ int sw128(int row, int b) {
  return row * kRow + ((((b >> 4) ^ row) & 7) << 4) + (b & 15);
}

// ---- wgmma
// a K-major operand in shared memory with the 128-byte (layout 1) or
// 64-byte (layout 2) swizzle, rows of that many bytes, 8-row groups sbo
// bytes apart; the depth steps inside a swizzled row advance the start
// address
__device__ __forceinline__ uint64_t desc(const void* p, int layout, int sbo, int lbo = 16) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}
// the registers a thread may hold: the producer warpgroup gives its share
// to the consumer warpgroups (three warpgroups share the register file at
// 168 a thread otherwise)
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving a register's use across the asynchronous
// product that writes it, or a register's write past the wgmma.fence that
// must follow it
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void hold(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (+)= A B over one depth step: m64n64k8 TF32 or m64n256k16 bf16, A from
// registers (the mma.sync m16n8 A fragment of each warp's 16 rows), B
// [n rows][depth] K-major through its descriptor; accumulator element i of
// lane (g, q) of warp wi is row 16 wi + g + 8 ((i / 2) % 2), column 8 (i /
// 4) + 2 q + i % 2.  scale_d 0: d = A B
__device__ __forceinline__ void mma_tf32_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}


__device__ __forceinline__ void mma_bf16_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// m64n128k16 bf16 with both operands from shared memory, A K-major and B
// MN-major (imm-trans-b 1): #5 with the weight as A and X as it lies as B
__device__ __forceinline__ void mma_bf16_n128_tb(float (&d)[64], uint64_t a, uint64_t b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// generic-proxy writes to shared memory made visible to the async proxy
// (wgmma's and TMA stores' reads)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the TF32 split of four values into registers: hi rna, lo raw
__device__ __forceinline__ void split4(const float (&e)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) split_tf32_raw_lo(e[j], hi[j], lo[j]);
}

// the base of the dynamic shared memory rounded up to 1,024 bytes (the
// 128-byte swizzle's period)
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// two sums at p, p + 1 in O (a pair at an even place)
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty, int stages,
                                              int full_count) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(&full[s], full_count);
      bar_init(&empty[s], 4 * kConsumers);  // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// a consumer warp's release of a stage it has done with
__device__ __forceinline__ void release(uint64_t* empty, int stage) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) bar_arrive(&empty[stage]);
}

// A chunk of kSteps f32 depth steps of 8, each as two n64 halves: three
// TF32 passes into a fresh accumulator (the first at scale-d 0) added to
// its half of the sums in round-to-nearest f32.  The halves' groups go in
// turns, one in flight while the other's product is added, so the tensor
// cores have the next one queued.  The chunk starts with no group in
// flight and drains at its end: straight code, in which ptxas sees the
// wait before every read of t (where it cannot, it serialises the groups).
// load_a(s, e): the step's A values (the m16n8k8 A fragment); desc_b(s, hi,
// lo): the descriptors of the step's B hi and lo planes, 128 rows (half h
// at + 64 h rows).  kHiLoFirst: a_hi b_lo first (#5's x_hi w_lo), else a_lo
// b_hi first (the sums).
template <bool kHiLoFirst, int kSteps, class LoadA, class DescB>
__device__ __forceinline__ void chunk_f32(float (&acc)[2][32], float (&t)[2][32],
                                          const LoadA& load_a, const DescB& desc_b) {
  constexpr uint64_t kHalf = (64 * kRow) >> 4;  // 64 rows of B, in descriptor units
  uint32_t ah[2][4], al[2][4];
  auto load = [&](int s) {
    float e[4];
    load_a(s, e);
    split4(e, ah[s & 1], al[s & 1]);
    hold(ah[s & 1]);
    hold(al[s & 1]);
  };
  auto issue = [&](int s, int h) {
    uint64_t b_hi, b_lo;
    desc_b(s, b_hi, b_lo);
    b_hi += h * kHalf;
    b_lo += h * kHalf;
    wg_fence();
    if constexpr (kHiLoFirst) {
      mma_tf32_n64(t[h], ah[s & 1], b_lo, 0);
      mma_tf32_n64(t[h], al[s & 1], b_hi, 1);
    } else {
      mma_tf32_n64(t[h], al[s & 1], b_hi, 0);
      mma_tf32_n64(t[h], ah[s & 1], b_lo, 1);
    }
    mma_tf32_n64(t[h], ah[s & 1], b_hi, 1);
    wg_commit();
  };
  auto add = [&](int h) {
    hold(t[h]);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] += t[h][i];
  };
  load(0);
  issue(0, 0);
  issue(0, 1);
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    wg_wait<1>();  // step s, half 0
    add(0);
    if (s + 1 < kSteps) {
      load(s + 1);
      issue(s + 1, 0);
      wg_wait<1>();  // step s, half 1
    } else {
      wg_wait<0>();
    }
    add(1);
    if (s + 1 < kSteps) issue(s + 1, 1);
  }
}

// ============================================================ #5's product
// out[o][t] = sum_d wt[d][o] X[slab][d][t] for every slab of the layer:
// rows o < HD to k_out, HD <= o < rows to v_out, each [slab][HD][Tb] with
// slab = b R + r (the ring holds slab r B + b).  A block: 128 tokens x
// kRows weight rows.
//   f32: X as A from registers (64 tokens a warpgroup, split hi / lo), the
//     weight's hi and lo planes as B, 128 rows; steps in two n64 halves
//     (chunk_f32).
//   bf16: the weight as A (K-major, 128 rows a warpgroup as two m64 tiles),
//     X as B (MN-major, imm-trans-b; both from shared memory), 256 rows a
//     block, so each thread holds pairs of neighbouring tokens of four
//     rows; one chunk's group in flight while the next is issued.
// Where the output's type is the ring's and its rows whole 16 bytes, each
// warpgroup writes its sums, 64 rows at a time, into a swizzled staging
// tile (f32 transposed to [o][t]) and one thread stores it by TMA into k
// or v (rows astride HD, whose box would start before v's first row, store
// from registers), so the stores run under the next tile's products:
// storing from registers left the card's writes after every tile (about
// 11.7 K clocks a bf16 tile at every depth).
template <typename S>
struct Kv {
  static constexpr bool kF32 = sizeof(S) == 4;
  static constexpr int kBK = kRow / static_cast<int>(sizeof(S));  // depth a chunk: 32 f32, 64 bf16
  static constexpr int kBoxT = kBK;                               // tokens a TMA box of X
  static constexpr int kTokens = 128;                             // tokens a block
  static constexpr int kBoxes = kTokens / kBoxT;
  static constexpr int kBoxBytes = kBK * kRow;                    // [kBK depth rows][kBoxT tokens]
  static constexpr int kXBytes = kBoxes * kBoxBytes;              // 16 KB
  static constexpr int kRows = kF32 ? 128 : 256;                  // weight rows a block
  static constexpr int kWBytes = kRows * kRow;                    // a plane: 16 KB f32, 32 KB bf16
  static constexpr int kPlanes = kF32 ? 2 : 1;                    // f32: hi, lo
  static constexpr int kStageBytes = kXBytes + kPlanes * kWBytes;  // 48 KB
  static constexpr int kStages = 4;
  // a warpgroup's staged sums, 64 rows at a time, in boxes of [64 rows]
  // [one swizzled row of tokens]: two boxes (bf16: 128 tokens; f32: the
  // warpgroup's 64)
  static constexpr int kOutBox = 64 * kRow;  // 8 KB
  static constexpr int kStaging = kConsumers * 2 * kOutBox;
  static constexpr size_t kSmem =
      static_cast<size_t>(kStages) * kStageBytes + kStaging + 16 * kStages + 1024;
};

// the weight copy wt [kPlanes][Op][Dp], K-major: plane 0 holds Wcat[d][o]
// (f32: its hi = rna_tf32), plane 1 (f32) lo = w - hi; Wcat[d][o] =
// wk[d][o] for o < HD, wv[d][o - HD] for HD <= o < rows; zeros past rows
// and D (Op: rows in whole tiles of kRows, Dp: D in whole chunks)
template <typename S>
__global__ void __launch_bounds__(256)
kv_weights_kernel(const S* __restrict__ wk, const S* __restrict__ wv, S* __restrict__ wt, int D,
                  int HD, int rows, int Op, int Dp) {
  const long long idx = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const long long cells = static_cast<long long>(Op) * Dp;
  if (idx >= cells) return;
  const int o = static_cast<int>(idx / Dp), d = static_cast<int>(idx % Dp);
  float w = 0.f;
  if (o < rows && d < D)
    w = commu::to_f(o < HD ? wk[static_cast<size_t>(d) * HD + o]
                           : wv[static_cast<size_t>(d) * HD + (o - HD)]);
  if constexpr (sizeof(S) == 4) {
    const float hi = __uint_as_float(tf32_rna(w));
    wt[idx] = hi;
    wt[idx + cells] = w - hi;
  } else {
    wt[idx] = commu::from_f<S>(w);
  }
}

// kTmaX: X by TMA (Tb * sizeof(S) a multiple of 16), else by the producer
// warp's plain loads into the same swizzled layout.  O: the output's type
// (S; f32 for the tests' entry in sums.cu).  map_k, map_v: the outputs'
// maps where the bf16 sums are stored by TMA (kTmaX, O bf16).
template <typename S, typename O, bool kTmaX>
__global__ void __launch_bounds__(kThreads, 1)
kv_product_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  const S* __restrict__ ring, O* __restrict__ k_out, O* __restrict__ v_out, int R,
                  int B, int D, int Tb, int HD, int rows, int o_tiles, int t_tiles, int tiles) {
  using K = Kv<S>;
  constexpr bool kTmaStore = sizeof(O) == sizeof(S) && kTmaX;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_smem(smem_raw);
  unsigned char* staging = base + K::kStages * K::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + K::kStaging);
  uint64_t* empty = full + K::kStages;
  // the plain form: lane 0's expect_tx and the warp's 32 arrivals
  init_barriers(full, empty, K::kStages, kTmaX ? 1 : 33);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = (D + K::kBK - 1) / K::kBK;
  // a tile's place: weight rows fastest, so a slab's tiles run side by
  // side and its X comes from device memory once
  auto place = [&](int tile, int& ot, int& t0, int& slab) {
    ot = tile % o_tiles;
    const int unit = tile / o_tiles;
    t0 = unit % t_tiles * K::kTokens;
    slab = unit / t_tiles;
  };

  if (warp >= kProducerWarp) {
    producer_regs();
    if (warp != kProducerWarp) return;
    int stage = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int ot, t0, slab;
      place(tile, ot, t0, slab);
      const int b = slab / R, r = slab - b * R;
      const int s_mem = r * B + b;
      for (int kc = 0; kc < chunks; ++kc) {
        bar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = base + stage * K::kStageBytes;
        if (lane == 0) {
          bar_expect(&full[stage], (kTmaX ? K::kXBytes : 0) + K::kPlanes * K::kWBytes);
          if constexpr (kTmaX) {
#pragma unroll
            for (int j = 0; j < K::kBoxes; ++j)
              tma_3d(st + j * K::kBoxBytes, &map_x, &full[stage], t0 + j * K::kBoxT,
                     kc * K::kBK, s_mem);
          }
#pragma unroll
          for (int p = 0; p < K::kPlanes; ++p)
            tma_3d(st + K::kXBytes + p * K::kWBytes, &map_w, &full[stage], kc * K::kBK,
                   ot * K::kRows, p);
        }
        if constexpr (!kTmaX) {
          const S* x = ring + static_cast<size_t>(s_mem) * D * Tb;
          const S zero = commu::from_f<S>(0.f);
          for (int i = lane; i < K::kBK * K::kTokens; i += 32) {
            const int dd = i / K::kTokens, tt = i % K::kTokens;
            const int d = kc * K::kBK + dd, t = t0 + tt;
            *reinterpret_cast<S*>(st + tt / K::kBoxT * K::kBoxBytes +
                                  sw128(dd, tt % K::kBoxT * static_cast<int>(sizeof(S)))) =
                d < D && t < Tb ? x[static_cast<size_t>(d) * Tb + t] : zero;
          }
          bar_arrive(&full[stage]);
        }
        if (++stage == K::kStages) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  consumer_regs();
  const int w = warp / 4, wi = warp % 4, g = lane / 4, q = lane % 4;
  int stage = 0, phase = 0;
  auto next = [&] {
    if (++stage == K::kStages) stage = 0, phase ^= 1;
  };
  // the row o of the outputs, or null past rows
  auto out_row = [&](int o, size_t out0) -> O* {
    if (o >= rows) return nullptr;
    return (o < HD ? k_out + static_cast<size_t>(o) * Tb
                   : v_out + static_cast<size_t>(o - HD) * Tb) + out0;
  };
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int ot, t0, slab;
    place(tile, ot, t0, slab);
    const size_t out0 = static_cast<size_t>(slab) * HD * Tb;
    const int o0 = ot * K::kRows;
    if constexpr (K::kF32) {
      // tokens m .. m + 15 of this warp: A's rows
      const int m = 64 * w + 16 * wi;
      float acc[2][32], t[2][32];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
      for (int kc = 0; kc < chunks; ++kc) {
        bar_wait(&full[stage], phase);
        const unsigned char* st = base + stage * K::kStageBytes;
        const unsigned char* wt = st + K::kXBytes;
        // A: tokens m + g (+8), depth 8 s + q (+4)
        chunk_f32<true, K::kBK / 8>(
            acc, t,
            [&](int s, float (&e)[4]) {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int tok = m + g + 8 * (j & 1), d = 8 * s + q + 4 * (j >> 1);
                e[j] = *reinterpret_cast<const float*>(st + tok / K::kBoxT * K::kBoxBytes +
                                                       sw128(d, tok % K::kBoxT * 4));
              }
            },
            [&](int s, uint64_t& hi, uint64_t& lo) {
              hi = desc(wt + 32 * s, 1, 1024);
              lo = desc(wt + K::kWBytes + 32 * s, 1, 1024);
            });
        release(empty, stage);
        next();
      }
      // element i of half h: row o0 + 64 h + 8 (i / 4) + 2 q (+1), token
      // t0 + m + g (+8).  By TMA where the half's 64 rows lie in k alone or
      // in v alone, through a staging tile [64 rows][2 boxes of 32 tokens]
      // written transposed (row o, the warpgroup's token 16 wi + g (+8))
      unsigned char* stg = staging + w * 2 * K::kOutBox;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int first = o0 + 64 * h;
        if (kTmaStore && (first + 64 <= HD || first >= HD)) {
          if (threadIdx.x % 128 == 0) bulk_wait_read();  // the last stores have read it
          group_sync(w);
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int tok = 16 * wi + g + 8 * ((i >> 1) & 1);
            *reinterpret_cast<float*>(stg + tok / 32 * K::kOutBox +
                                      sw128(8 * (i / 4) + 2 * q + (i & 1), 4 * (tok % 32))) =
                acc[h][i];
          }
          fence_async_smem();
          group_sync(w);
          if (threadIdx.x % 128 == 0) {
#pragma unroll
            for (int box = 0; box < 2; ++box) {
              const int tok = t0 + 64 * w + 32 * box;
              if (first < HD)
                tma_store_3d(&map_k, stg + box * K::kOutBox, tok, first, slab);
              else if (first < rows)
                tma_store_3d(&map_v, stg + box * K::kOutBox, tok, first - HD, slab);
            }
            bulk_commit();
          }
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            O* dst = out_row(first + 8 * (i / 4) + 2 * q + (i & 1), out0);
            const int tok = t0 + m + g + 8 * ((i >> 1) & 1);
            if (dst != nullptr && tok < Tb) dst[tok] = commu::from_f<O>(acc[h][i]);
          }
        }
      }
    } else {
      // weight rows 128 w + 64 i of the block's 256 as two m64n128 tiles
      // over its 128 tokens; B: X [kBK depth rows][two boxes of 64 tokens],
      // MN-major, the boxes kBoxBytes apart
      float acc[2][64];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[i][e] = 0.f;
      int prev = -1;
      for (int kc = 0; kc < chunks; ++kc) {
        bar_wait(&full[stage], phase);
        const unsigned char* st = base + stage * K::kStageBytes;
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < K::kBK / 16; ++ks)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            mma_bf16_n128_tb(acc[i], desc(st + K::kXBytes + (128 * w + 64 * i) * kRow + 32 * ks,
                                          1, 1024),
                             desc(st + 16 * kRow * ks, 1, 1024, K::kBoxBytes), 1);
        wg_commit();
        wg_wait<1>();
        if (prev >= 0) release(empty, prev);
        prev = stage;
        next();
      }
      wg_wait<0>();
      hold(acc[0]);
      hold(acc[1]);
      release(empty, prev);
      // element 4 j + 2 h (+1) of tile i: row 128 w + 64 i + 16 wi + g +
      // 8 h of the block's, tokens 8 j + 2 q (+1).  By TMA, 64 rows at a
      // time, where they lie in k alone or in v alone (a box's rows start
      // on a row of the tensor); the one astride HD by the threads' own
      // stores
      const int o_s = o0 + 128 * w;
      auto whole = [&](int i) {
        const int first = o_s + 64 * i;
        return first + 64 <= HD || first >= HD;
      };
      if (kTmaStore && whole(0) && whole(1)) {
        unsigned char* stg = staging + w * 2 * K::kOutBox;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (threadIdx.x % 128 == 0) bulk_wait_read();  // the last stores have read it
          group_sync(w);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * wi + g + 8 * h;
#pragma unroll
            for (int j = 0; j < 16; ++j)
              *reinterpret_cast<__nv_bfloat162*>(stg + j / 8 * K::kOutBox +
                                                 sw128(r, 16 * (j % 8) + 4 * q)) =
                  __floats2bfloat162_rn(acc[i][4 * j + 2 * h], acc[i][4 * j + 2 * h + 1]);
          }
          fence_async_smem();
          group_sync(w);
          if (threadIdx.x % 128 == 0) {
            const int first = o_s + 64 * i;
#pragma unroll
            for (int box = 0; box < 2; ++box) {
              if (first < HD)
                tma_store_3d(&map_k, stg + box * K::kOutBox, t0 + 64 * box, first, slab);
              else if (first < rows)
                tma_store_3d(&map_v, stg + box * K::kOutBox, t0 + 64 * box, first - HD, slab);
            }
            bulk_commit();
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            O* dst = out_row(o0 + 128 * w + 64 * i + 16 * wi + g + 8 * h, out0);
            if (dst == nullptr) continue;
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int tok = t0 + 8 * j + 2 * q;
              const float x = acc[i][4 * j + 2 * h], y = acc[i][4 * j + 2 * h + 1];
              if (Tb % 2 == 0) {
                if (tok < Tb) store_pair(dst + tok, x, y);
              } else {
                if (tok < Tb) dst[tok] = commu::from_f<O>(x);
                if (tok + 1 < Tb) dst[tok + 1] = commu::from_f<O>(y);
              }
            }
          }
      }
    }
  }
  if constexpr (kTmaStore) {
    if (threadIdx.x % 128 == 0) bulk_wait();  // the last stores have landed
  }
}

// ========================================================= the batch sums
// out_p[m][n] = sum over b < rows, t < len of A_p[b][m][t] B[b][n][t] for
// the parts p < P (1 or 2; A_p f32 [rows][M][len]), tiles of 128 rows of
// one part (64 a warpgroup) x kCols columns (bf16: 256, one m64n256k16 a
// depth step; f32: 128, two n64 halves promoted in turns, the B tile split
// into hi and lo planes once for both warpgroups), the batch rows in
// split_rows' groups, into partial [P][groups][M][N].  kDeep (bf16, where
// the ring's runs are whole 64s): chunks of 64 t, B's rows 128 bytes, in
// three stages, against 32 t in six (1.17 / 2.08 / 5.33 against 1.24 /
// 2.29 / 5.98 ms at units 768 / 1024 / 1536 on an H100, in turns).
template <typename S, bool kDeep = false>
struct Sums {
  static constexpr bool kF32 = sizeof(S) == 4;
  static constexpr int kBK = !kF32 && kDeep ? 64 : 32;  // t a chunk
  static constexpr int kARows = 128;                   // rows of A a block, 64 a warpgroup
  static constexpr int kCols = kF32 ? 128 : 256;       // columns (B rows) a block
  static constexpr int kABox = kARows * 32 * 4;        // A's boxes: 32 t, 128-byte rows
  static constexpr int kABytes = kARows * kBK * 4;     // 16 KB a 32 t
  static constexpr int kBRow = kBK * static_cast<int>(sizeof(S));  // 128 B f32, 64 B bf16
  static constexpr int kBBytes = kCols * kBRow;        // 16 KB
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = kF32 ? 5 : kBK == 64 ? 3 : 6;
  static constexpr int kSets = 2;                      // f32: hi and lo planes in turns
  static constexpr int kPrivate = kF32 ? kSets * 2 * kBBytes : 0;
  static constexpr int kLayout = kBRow == 128 ? 1 : 2;  // B's swizzle: 128 or 64 bytes
  static constexpr int kSbo = 8 * kBRow;
  static constexpr size_t kSmem =
      static_cast<size_t>(kStages) * kStageBytes + kPrivate + 16 * kStages + 1024;
};

template <typename S, bool kDeep>
__global__ void __launch_bounds__(kThreads, 1)
dw_sums_kernel(const __grid_constant__ CUtensorMap map_a0,
               const __grid_constant__ CUtensorMap map_a1,
               const __grid_constant__ CUtensorMap map_b, float* __restrict__ partial, int M,
               int N, int rows, int len, int run, int m_tiles, int n_tiles, int parts, int groups,
               int rpg, int tiles) {
  using K = Sums<S, kDeep>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_smem(smem_raw);
  unsigned char* planes = base + K::kStages * K::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(planes + K::kPrivate);
  uint64_t* empty = full + K::kStages;
  init_barriers(full, empty, K::kStages, 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = len / K::kBK;
  // a tile's place: the columns fastest, then 128 rows, the part, the
  // group (column-first ran 0-22% faster in bf16 than rows-first, level in
  // f32)
  auto place = [&](int tile, int& mt, int& nt, int& p, int& g) {
    int rest = tile / n_tiles;
    nt = tile - rest * n_tiles;
    mt = rest % m_tiles;
    rest /= m_tiles;
    p = rest % parts;
    g = rest / parts;
  };

  if (warp >= kProducerWarp) {
    producer_regs();
    if (warp != kProducerWarp) return;
    if (lane == 0) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int mt, nt, p, g;
        place(tile, mt, nt, p, g);
        const int b1 = min(rows, (g + 1) * rpg);
        for (int b = g * rpg; b < b1; ++b)
          for (int c = 0; c < chunks; ++c) {
            bar_wait(&empty[stage], phase ^ 1);
            unsigned char* st = base + stage * K::kStageBytes;
            const int t = c * K::kBK;
            bar_expect(&full[stage], K::kStageBytes);
#pragma unroll
            for (int j = 0; j < K::kBK / 32; ++j)
              tma_3d(st + j * K::kABox, p ? &map_a1 : &map_a0, &full[stage], t + 32 * j,
                     mt * K::kARows, b);
            tma_4d(st + K::kABytes, &map_b, &full[stage], t % run, nt * K::kCols, b, t / run);
            if (++stage == K::kStages) stage = 0, phase ^= 1;
          }
      }
    }
    return;
  }

  // consumer warpgroup w: rows 64 w .. of the block's 128, warp wi the 16
  // at r0; A's fragments from the staged tile
  consumer_regs();
  const int w = warp / 4, wi = warp % 4, g4 = lane / 4, q = lane % 4;
  const int r0 = 64 * w + 16 * wi;
  int stage = 0, phase = 0;
  auto next = [&] {
    if (++stage == K::kStages) stage = 0, phase ^= 1;
  };
  auto store = [&](float* out, int o, int n, float x, float y) {
    if (o >= M || n >= N) return;
    float* dst = out + static_cast<size_t>(o) * N + n;
    if (N % 2 == 0) {
      *reinterpret_cast<float2*>(dst) = make_float2(x, y);
    } else {
      dst[0] = x;
      if (n + 1 < N) dst[1] = y;
    }
  };
  [[maybe_unused]] int set = 0;  // f32: the hi / lo plane set of this chunk
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int mt, nt, p, g;
    place(tile, mt, nt, p, g);
    const int steps = (min(rows, (g + 1) * rpg) - g * rpg) * chunks;
    float* out = partial + static_cast<size_t>(p * groups + g) * M * N;
    const int o0 = mt * K::kARows + r0, n0 = nt * K::kCols;
    if constexpr (K::kF32) {
      float acc[2][32], t[2][32];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
      for (int kc = 0; kc < steps; ++kc) {
        bar_wait(&full[stage], phase);
        const unsigned char* st = base + stage * K::kStageBytes;
        // the B tile into this chunk's hi and lo planes, by both warpgroups
        // (the other set may still be read by the other warpgroup's last
        // chunk; this one's groups drained before that chunk began)
        unsigned char* hi = planes + set * 2 * K::kBBytes;
        unsigned char* lo = hi + K::kBBytes;
        const float4* raw = reinterpret_cast<const float4*>(st + K::kABytes);
#pragma unroll
        for (int i = 0; i < K::kBBytes / 16 / 256; ++i) {
          const int idx = threadIdx.x + 256 * i;
          const float4 v = raw[idx];
          float4 h, l;
          h.x = __uint_as_float(tf32_rna(v.x)), l.x = v.x - h.x;
          h.y = __uint_as_float(tf32_rna(v.y)), l.y = v.y - h.y;
          h.z = __uint_as_float(tf32_rna(v.z)), l.z = v.z - h.z;
          h.w = __uint_as_float(tf32_rna(v.w)), l.w = v.w - h.w;
          reinterpret_cast<float4*>(hi)[idx] = h;
          reinterpret_cast<float4*>(lo)[idx] = l;
        }
        fence_async_smem();
        asm volatile("bar.sync 1, 256;\n" ::: "memory");  // both warpgroups
        // A: rows r0 + g (+8), t 8 s + q (+4)
        chunk_f32<false, K::kBK / 8>(
            acc, t,
            [&](int s, float (&e)[4]) {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                e[j] = *reinterpret_cast<const float*>(
                    st + sw128(r0 + g4 + 8 * (j & 1), 4 * (8 * s + q + 4 * (j >> 1))));
            },
            [&](int s, uint64_t& b_hi, uint64_t& b_lo) {
              b_hi = desc(hi + 32 * s, 1, 1024);
              b_lo = desc(lo + 32 * s, 1, 1024);
            });
        release(empty, stage);
        if (++set == K::kSets) set = 0;
        next();
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            store(out, o0 + g4 + 8 * half, n0 + 64 * h + 8 * j + 2 * q, acc[h][4 * j + 2 * half],
                  acc[h][4 * j + 2 * half + 1]);
    } else {
      float acc[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      uint32_t a0[K::kBK / 16][4], a1[K::kBK / 16][4];
      int prev = -1;
      // A: rows r0 + g (+8), t pairs 16 ks + 2 q (+8), rounded to bf16; one
      // chunk's group in flight while the next is issued
      auto chunk = [&](uint32_t (&a)[K::kBK / 16][4]) {
        bar_wait(&full[stage], phase);
        const unsigned char* st = base + stage * K::kStageBytes;
#pragma unroll
        for (int ks = 0; ks < K::kBK / 16; ++ks) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int tt = 16 * ks + 2 * q + 8 * (j >> 1);
            const float2 v = *reinterpret_cast<const float2*>(
                st + tt / 32 * K::kABox + sw128(r0 + g4 + 8 * (j & 1), 4 * (tt % 32)));
            a[ks][j] = pack_bf16(v.x, v.y);
          }
          hold(a[ks]);
        }
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < K::kBK / 16; ++ks)
          mma_bf16_n256(acc, a[ks], desc(st + K::kABytes + 32 * ks, K::kLayout, K::kSbo), 1);
        wg_commit();
        wg_wait<1>();
        if (prev >= 0) release(empty, prev);
        prev = stage;
        next();
      };
      int kc = 0;
      for (; kc + 1 < steps; kc += 2) {
        chunk(a0);
        chunk(a1);
      }
      if (kc < steps) chunk(a0);
      wg_wait<0>();
      hold(acc);
      if (prev >= 0) release(empty, prev);
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          store(out, o0 + g4 + 8 * half, n0 + 8 * j + 2 * q, acc[4 * j + 2 * half],
                acc[4 * j + 2 * half + 1]);
    }
  }
}

// ================================================================ the host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found once a process through the
// runtime (null if the driver has none)
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a tiled TMA map of a dense tensor of T: dims innermost first, strides in
// bytes for dims 1.. (multiples of 16), the box in elements; elements past
// the dims load as zeros
template <typename T, int kRank>
cudaError_t make_map(CUtensorMap* map, const T* base, const cuuint64_t (&dims)[kRank],
                     const cuuint64_t (&strides)[kRank - 1], const cuuint32_t (&box)[kRank],
                     CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint32_t ones[kRank];
  for (int i = 0; i < kRank; ++i) ones[i] = 1;
  const CUresult res = encode(
      map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      kRank, const_cast<T*>(base), dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the persistent grids' block count: one block an SM
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
    return 132;
  return n;
}

// #5's weight copy: its depth (D in whole chunks) and rows (whole tiles)
template <typename S>
int kv_depth(int D) {
  return (D + Kv<S>::kBK - 1) / Kv<S>::kBK * Kv<S>::kBK;
}
template <typename S>
int kv_rows(int rows) {
  return (rows + Kv<S>::kRows - 1) / Kv<S>::kRows * Kv<S>::kRows;
}

// bytes of workspace run_kv_product needs (the weight copy)
template <typename S>
size_t kv_workspace(int D, int rows) {
  return static_cast<size_t>(Kv<S>::kPlanes) * kv_rows<S>(rows) * kv_depth<S>(D) * sizeof(S);
}

// k_out, v_out [B R][HD][Tb] = rows o < HD and HD <= o < rows of
// Wcat^T X over the layer's slabs ``ring`` [R][B][D][Tb], Wcat = [wk | wv]
// (wk, wv [D][HD]; wv unread where rows = HD); ``work``: kv_workspace bytes
template <typename S, typename O>
cudaError_t run_kv_product(const S* ring, const S* wk, const S* wv, O* k_out, O* v_out, void* work,
                           int R, int B, int D, int Tb, int HD, int rows, cudaStream_t stream) {
  using K = Kv<S>;
  const int dp = kv_depth<S>(D), op = kv_rows<S>(rows);
  const int o_tiles = op / K::kRows, t_tiles = (Tb + K::kTokens - 1) / K::kTokens;
  const long long tiles = static_cast<long long>(o_tiles) * t_tiles * B * R;
  if (tiles < 1 || tiles > 0x7fffffffLL || D < 1 || rows > 2 * HD) return cudaErrorInvalidValue;
  S* wt = static_cast<S*>(work);
  const long long cells = static_cast<long long>(op) * dp;
  kv_weights_kernel<S><<<static_cast<unsigned>((cells + 255) / 256), 256, 0, stream>>>(
      wk, wv, wt, D, HD, rows, op, dp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr cuuint64_t sz = sizeof(S);
  CUtensorMap map_x{}, map_w{};
  const bool tma_x = static_cast<size_t>(Tb) * sizeof(S) % 16 == 0;
  if (tma_x) {
    err = make_map<S, 3>(&map_x, ring,
                         {static_cast<cuuint64_t>(Tb), static_cast<cuuint64_t>(D),
                          static_cast<cuuint64_t>(R) * B},
                         {Tb * sz, static_cast<cuuint64_t>(D) * Tb * sz},
                         {static_cast<cuuint32_t>(K::kBoxT), static_cast<cuuint32_t>(K::kBK), 1},
                         CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  }
  err = make_map<S, 3>(&map_w, wt,
                       {static_cast<cuuint64_t>(dp), static_cast<cuuint64_t>(op),
                        static_cast<cuuint64_t>(K::kPlanes)},
                       {dp * sz, static_cast<cuuint64_t>(op) * dp * sz},
                       {static_cast<cuuint32_t>(K::kBK), static_cast<cuuint32_t>(K::kRows), 1},
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  // the outputs' maps where the sums leave by TMA, [slab][HD][Tb], boxes
  // of 64 rows x one swizzled row of tokens
  CUtensorMap map_k{}, map_v{};
  if (sizeof(O) == sizeof(S) && tma_x) {
    for (int p = 0; p < 2; ++p) {
      err = make_map<O, 3>(p ? &map_v : &map_k, p ? v_out : k_out,
                           {static_cast<cuuint64_t>(Tb), static_cast<cuuint64_t>(HD),
                            static_cast<cuuint64_t>(R) * B},
                           {Tb * sz, static_cast<cuuint64_t>(HD) * Tb * sz},
                           {static_cast<cuuint32_t>(kRow / sizeof(O)), 64, 1},
                           CU_TENSOR_MAP_SWIZZLE_128B);
      if (err != cudaSuccess) return err;
    }
  }
  const unsigned grid = static_cast<unsigned>(std::min<long long>(tiles, sm_count()));
  const int n = static_cast<int>(tiles);
  if (tma_x) {
    err = commu::allow_smem(kv_product_kernel<S, O, true>, K::kSmem);
    if (err != cudaSuccess) return err;
    kv_product_kernel<S, O, true><<<grid, kThreads, K::kSmem, stream>>>(
        map_x, map_w, map_k, map_v, ring, k_out, v_out, R, B, D, Tb, HD, rows, o_tiles, t_tiles,
        n);
  } else {
    err = commu::allow_smem(kv_product_kernel<S, O, false>, K::kSmem);
    if (err != cudaSuccess) return err;
    kv_product_kernel<S, O, false><<<grid, kThreads, K::kSmem, stream>>>(
        map_x, map_w, map_k, map_v, ring, k_out, v_out, R, B, D, Tb, HD, rows, o_tiles, t_tiles,
        n);
  }
  return cudaGetLastError();
}

// the batch sums' tiles and groups
template <typename S>
int sums_m_tiles(int M) {
  return (M + Sums<S>::kARows - 1) / Sums<S>::kARows;
}
template <typename S>
int sums_n_tiles(int N) {
  return (N + Sums<S>::kCols - 1) / Sums<S>::kCols;
}
template <typename S>
commu::Split sums_split(int parts, int M, int N, int rows, int len) {
  return commu::split_rows(rows, parts * sums_m_tiles<S>(M) * sums_n_tiles<S>(N), len);
}

// bytes of partial buffer run_dw_sums needs, either storage type
inline size_t sums_scratch(int parts, int M, int N, int rows, int len) {
  const int groups = std::max(sums_split<float>(parts, M, N, rows, len).groups,
                              sums_split<__nv_bfloat16>(parts, M, N, rows, len).groups);
  return sizeof(float) * static_cast<size_t>(parts) * groups * M * N;
}

// Whether run_dw_sums takes these operands: whole chunks of t in every
// run of B and in len (reduce.cuh's copyable)
inline bool sums_take(int len, int run) {
  return len % Sums<float>::kBK == 0 && run % Sums<float>::kBK == 0 && len % run == 0;
}

template <typename S, bool kDeep>
cudaError_t run_dw_sums_as(const float* a0, const float* a1, int parts, const S* bm,
                           long long s_b, long long s_r, float* out0, float* out1,
                           float* scratch, int M, int N, int rows, int len, int run,
                           cudaStream_t stream) {
  using K = Sums<S, kDeep>;
  constexpr cuuint64_t sz = sizeof(S);
  CUtensorMap map_a[2] = {}, map_b{};
  for (int p = 0; p < parts; ++p) {
    const cudaError_t err = make_map<float, 3>(
        &map_a[p], p ? a1 : a0,
        {static_cast<cuuint64_t>(len), static_cast<cuuint64_t>(M), static_cast<cuuint64_t>(rows)},
        {static_cast<cuuint64_t>(len) * 4, static_cast<cuuint64_t>(M) * len * 4},
        {32, static_cast<cuuint32_t>(K::kARows), 1},
        CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  }
  const int runs = len / run;
  cudaError_t err = make_map<S, 4>(
      &map_b, bm,
      {static_cast<cuuint64_t>(run), static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(rows),
       static_cast<cuuint64_t>(runs)},
      {run * sz, static_cast<cuuint64_t>(s_b) * sz,
       static_cast<cuuint64_t>(runs > 1 ? s_r : s_b * rows) * sz},
      {static_cast<cuuint32_t>(K::kBK), static_cast<cuuint32_t>(K::kCols), 1, 1},
      K::kBRow == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return err;
  const commu::Split s = sums_split<S>(parts, M, N, rows, len);
  const int m_tiles = sums_m_tiles<S>(M), n_tiles = sums_n_tiles<S>(N);
  const long long tiles = static_cast<long long>(s.groups) * parts * m_tiles * n_tiles;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  err = commu::allow_smem(dw_sums_kernel<S, kDeep>, K::kSmem);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>(std::min<long long>(tiles, sm_count()));
  dw_sums_kernel<S, kDeep><<<grid, kThreads, K::kSmem, stream>>>(
      map_a[0], map_a[parts - 1], map_b, scratch, M, N, rows, len, run, m_tiles, n_tiles, parts,
      s.groups, s.rows_per_group, static_cast<int>(tiles));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t plane = static_cast<size_t>(s.groups) * M * N;
  err = commu::sum_groups(scratch, out0, M * N, s.groups, 1, stream);
  if (err != cudaSuccess || parts == 1) return err;
  return commu::sum_groups(scratch + plane, out1, M * N, s.groups, 1, stream);
}

// out_p[m][n] = sum over b < rows, t < len of a_p[b][m][t] B(b, n, t) for
// p < parts (a_p f32 [rows][M][len], a1 unread where parts is 1; element
// (b, n, t) of B at bm[(t / run) s_r + b s_b + n run + t % run], in S),
// f32 out [M][N] each, in a fixed order; ``scratch``: sums_scratch bytes
template <typename S>
cudaError_t run_dw_sums(const float* a0, const float* a1, int parts, const S* bm, long long s_b,
                        long long s_r, float* out0, float* out1, float* scratch, int M, int N,
                        int rows, int len, int run, cudaStream_t stream) {
  if (!sums_take(len, run) || parts < 1 || parts > 2 || M < 1 || N < 1 || rows < 1)
    return cudaErrorInvalidValue;
  if constexpr (sizeof(S) == 2) {
    if (run % 64 == 0)
      return run_dw_sums_as<S, true>(a0, a1, parts, bm, s_b, s_r, out0, out1, scratch, M, N,
                                     rows, len, run, stream);
  }
  return run_dw_sums_as<S, false>(a0, a1, parts, bm, s_b, s_r, out0, out1, scratch, M, N, rows,
                                  len, run, stream);
}

}  // namespace wg
}  // namespace
