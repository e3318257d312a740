// Hopper building blocks shared by the tensor-core kernels
// (conv3x3_wgmma.cu, conv3x3_tf32x3.cu, gram_wgmma.cu, gram_tf32x3.cu,
// pool_route_wgmma.cu, pool_route_tf32x3.cu, conv1_1_stats_wgmma.cu,
// conv1_1_bwd_wgmma.cu, conv1_1_stats_tf32x3.cu, conv1_1_bwd_tf32x3.cu,
// conv1_1_gram_wgmma.cu, conv1_1_gram_bwd_wgmma.cu,
// conv1_1_gram_tf32x3.cu, conv1_1_gram_bwd_tf32x3.cu, gram_narrow.cu and,
// through conv_narrow.cuh, conv3x3_narrow_wgmma.cu and
// conv3x3_narrow_tf32x3.cu),
// from raw PTX: mbarriers, cp.async, TMA tile loads and stores, named
// barriers, the proxy fence, setmaxnreg, wgmma shared-memory descriptors
// and the wgmma instructions; the Grams' second pass; conv1_1's patch rows and stage 1
// v3's y in bf16 and in float32; and, on the host, the tensor maps the
// convolutions share.
// kernels/build.py folds every csrc/*.cuh into each library's hash, so an
// edit here rebuilds the kernels that include it.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// A cuTensorMapEncodeTiled failure is returned as this plus its CUresult.
constexpr int ENCODE_ERROR = 10000;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Returns once the phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// The warpgroup's registers a thread (setmaxnreg; a multiple of 8 from 24
// to 256, executed by all four warps): a producer lowers its budget so
// that consumers can raise theirs.
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// TMA tile loads of the box at the given coordinates (innermost first) into
// shared memory; completion is counted in bytes on the mbarrier. Elements
// outside the tensor are filled with zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ``bytes`` (a multiple of 16) from global ``src`` to shared ``dst`` by one
// bulk copy, both 16-byte aligned; completion is counted in bytes on the
// mbarrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// TMA tile store of the shared-memory box at ``src`` to the given
// coordinates (innermost first); elements outside the tensor are not
// written. Committed as a bulk async-group by bulk_commit.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"((uint64_t)map),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Returns once at most N of this thread's bulk groups still read shared
// memory (their sources may then be overwritten).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// Returns once at most N of this thread's bulk groups are incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(N) : "memory");
}

// Barrier ``id`` (1-15; 0 is __syncthreads) over ``count`` threads, a
// multiple of 32.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy accesses (wgmma operand reads, TMA writes) to the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma shared-memory descriptor of a tile written by TMA with the 128-byte
// swizzle (1024-byte aligned, rows of 128 bytes): start address >> 4; the
// leading offset (unused for K-major tiles; for MN-major ones the bytes from
// one 64-element MN block to the next); stride 1024 bytes from one group of
// 8 rows to the next; swizzle mode 1 in bits 62-63. A wrong field gives
// wrong numbers, not a fault.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lead) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Byte offset of 16-byte chunk j (0-7) of row r in a tile of 128-byte rows
// with the 128-byte swizzle, as TMA writes it and desc_sw128 reads it (the
// tile 1024-byte aligned): the chunk moves to j ^ (r % 8).
__device__ __forceinline__ uint32_t sw128_chunk(int r, int j) {
  return (uint32_t)(r * 128 + ((j ^ (r & 7)) << 4));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator registers across the
// asynchronous wgmma (as CUTLASS's warpgroup_fence_operand does).
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D += A * B, bf16 in, f32 accumulators, A 64 x 16 and B 16 x N from shared
// memory; TA / TB = 1 reads A / B MN-major (16-bit inputs only).
// Accumulator v of thread (warp w, lane l) of the warpgroup is row
// 16w + 8*((v >> 1) & 1) + l/4, column 8*(v >> 2) + 2*(l & 3) + (v & 1).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, "
      "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

// D += A * B, tf32 in (f32 words in shared memory, of which the tensor core
// uses the sign, the exponent and the top 10 mantissa bits; whether it
// truncates or rounds the low 13 is not relied on), f32 accumulators,
// A 64 x 8 and B 8 x N from shared memory, both K-major: the tf32 form has
// no transpose operands. Accumulator layout as in the bf16 forms.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], uint64_t a,
                                                     uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32], uint64_t a,
                                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n32k8_tf32(float (&d)[16], uint64_t a,
                                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// The tf32 forms with A from registers (B from shared memory, K-major):
// a[v] of thread (warp w, lane l) of the warpgroup holds the tf32 bits of
// row 16w + l/4 + 8*(v & 1), column l%4 + 4*(v >> 1) of the 64 x 8 A tile
// (PTX ISA's register fragment of .tf32 A, CUTLASS's ALayout_64x8). The
// registers are read while the wgmma runs: keep them (fence_regs after the
// wait) until wgmma_wait has returned.
__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(
    float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// The m64n256k8 form: 128 accumulators a thread, the layout above with v
// up to 127 (column 8*(v >> 2) + 2*(l & 3) + (v & 1)).
__device__ __forceinline__ void wgmma_m64n256k8_tf32_rs(
    float (&d)[128], const uint32_t (&a)[4], uint64_t b, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32],
                                                       const uint32_t (&a)[4],
                                                       uint64_t b,
                                                       int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n32k8_tf32_rs(float (&d)[16],
                                                       const uint32_t (&a)[4],
                                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n16k8_tf32_rs(float (&d)[8],
                                                       const uint32_t (&a)[4],
                                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n8k8_tf32_rs(float (&d)[4],
                                                      const uint32_t (&a)[4],
                                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The bf16 forms with A from registers (B from shared memory, K-major):
// a[v] of thread (warp w, lane l) of the warpgroup holds the two bf16 of
// row 16w + l/4 + 8*(v & 1), columns 2*(l%4) + 8*(v >> 1) and the next one
// (low half first) of the 64 x 16 A tile (PTX ISA's register fragment of
// .bf16 A). As with the tf32 forms, keep the registers until wgmma_wait.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n8k16_rs(float (&d)[4],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// 16 bytes from global to shared memory, asynchronously (cp.async, L2
// only); of the source, ``src_bytes`` (0-16) are read and the rest of the
// destination is zero-filled. Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Returns once at most N of this thread's cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from reusing A-fragment registers before the wgmma
// that reads them has been waited for (fence_acc's twin).
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// The exact split of a float32 into tf32 parts: hi is v with its low 13
// mantissa bits cleared, lo = v - hi (exact in float32), as
// kernels/conv.py::split_tf32.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  const float h = __uint_as_float(__float_as_uint(v) & 0xffffe000u);
  hi = __float_as_uint(h);
  lo = __float_as_uint(v - h);
}

// conv1_1's patch rows (conv1_1_stats_wgmma.cu, conv1_1_bwd_wgmma.cu and
// their tf32x3 twins). XWindow holds the x window a tile's patches read:
// HY x HX pixels x 3 channels of the NHWC image xb (H, W, 3) from pixel
// (x0, y0), T the bits of one element (unsigned short for bf16, float),
// zero outside the image (the SAME padding), ITEMS values a thread
// (entries tid, tid + THREADS, ...: coalesced loads) so that the next
// tile's window can be loaded while this tile's products run, then stored
// to shared memory. TMA's 16-byte inner box does not fit a 6- or 12-byte
// pixel.
template <int HX, int HY, int THREADS, typename T = unsigned short>
struct XWindow {
  static constexpr int VALUES = HX * HY * 3;
  static constexpr int ITEMS = (VALUES + THREADS - 1) / THREADS;
  T v[ITEMS];

  __device__ __forceinline__ void load(const T* xb, int H, int W, int x0,
                                       int y0, int tid) {
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      const int i = tid + THREADS * q;
      const int wy = i / (HX * 3), rem = i - wy * (HX * 3);
      const int yy = y0 + wy, xx = x0 + rem / 3;
      v[q] = (i < VALUES && yy >= 0 && yy < H && xx >= 0 && xx < W)
                 ? __ldg(xb + ((long long)yy * W + x0) * 3 + rem)
                 : T(0);
    }
  }

  __device__ __forceinline__ void store(T* win, int tid) const {
#pragma unroll
    for (int q = 0; q < ITEMS; ++q)
      if (tid + THREADS * q < VALUES) win[tid + THREADS * q] = v[q];
  }
};

// Value k (0-31) of the float32 patch row whose 3 x 3 window starts at
// (wy, wx) of a window of WX pixels a row in shared memory: column
// (dy*3 + dx)*3 + c < 27 holds win[wy + dy][wx + dx][c], column 27 holds 1
// (the bias column of the products), columns 28-31 hold 0; ``valid`` false
// (a pixel outside the image) gives 0 in every column, the ones included.
template <int WX>
__device__ __forceinline__ float patch_value(const float* win, int wy, int wx,
                                             int k, bool valid) {
  if (!valid || k > 27) return 0.f;
  if (k == 27) return 1.f;
  return win[((wy + k / 9) * WX + wx + (k / 3) % 3) * 3 + k % 3];
}

// Chunk J (columns 8J .. 8J+7) of the bf16 patch row whose 3 x 3 window
// starts at (wy, wx) of a window of HX pixels a row in shared memory, as
// 16 bytes: column (dy*3 + dx)*3 + c < 27 holds win[wy + dy][wx + dx][c],
// column 27 holds 1 (the bias column of the products), columns 28-31 hold
// 0; ``valid`` false (a pixel outside the image) gives a zero row, ones
// column included.
template <int HX, int J>
__device__ __forceinline__ uint4 patch_row_chunk(const unsigned short* win,
                                                 int wy, int wx,
                                                 bool valid) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (valid) {
    const unsigned short* p = win + (wy * HX + wx) * 3;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      constexpr int K0 = 8 * J;
      const int k = K0 + e;
      uint32_t bits = 0u;
      if (k < 27) {
        bits = p[((k / 9) * HX + (k / 3) % 3) * 3 + k % 3];
      } else if (k == 27) {
        bits = 0x3F80u;                          // bf16 1.0
      }
      w[e >> 1] |= bits << (16 * (e & 1));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Stage 1 v3's pre-ReLU y = P W' of 64 conv1_1 channels
// (conv1_1_gram_wgmma.cu, conv1_1_gram_bwd_wgmma.cu): both kernels lay out
// W' and issue y's products through these two functions, so that the
// backward's ReLU mask and y_r equal the forward's bit for bit.
//
// W' as the K-major wgmma B tile at ``dst`` (1024-byte aligned, 64 rows of
// 128 bytes, the 128-byte swizzle): row n holds W[k][n] of the (27, 64)
// bf16 weights in column k < 27, b[n] in column 27 (the patch tile's ones
// column adds the bias), zeros after.
template <int THREADS>
__device__ __forceinline__ void load_conv1_1_wb(uint8_t* dst,
                                                const unsigned short* w16,
                                                const unsigned short* b16,
                                                int tid) {
  for (int i = tid; i < 64 * 8; i += THREADS) {
    const int n = i >> 3, j = i & 7;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = 8 * j + e;
      const uint32_t bits = k < 27 ? __ldg(w16 + k * 64 + n)
                            : k == 27 ? __ldg(b16 + n)
                                      : 0u;
      v[e >> 1] |= bits << (16 * (e & 1));
    }
    *reinterpret_cast<uint4*>(dst + sw128_chunk(n, j)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// acc += the 64 patch rows at ``p_rows`` (K-major, 128-byte swizzle,
// columns 0-31 as patch_row_chunk builds them) times W' at ``wb``: two k16
// steps. The caller zeroes acc, fences, commits and waits.
__device__ __forceinline__ void conv1_1_y(float (&acc)[32], uint32_t p_rows,
                                          uint32_t wb) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    wgmma_m64n64k16<0, 0>(acc, desc_sw128(p_rows + kk * 32, 16),
                          desc_sw128(wb + kk * 32, 16));
}

// Stage 1 v3's y in float32 by the 3xTF32 split (conv1_1_gram_tf32x3.cu,
// conv1_1_gram_bwd_tf32x3.cu): both kernels lay out W' and issue y's
// products through the three functions below, so that the backward's ReLU
// mask equals the forward's z > 0 bit for bit. The k order of the 32 patch
// columns is kernel A f32's (conv1_1_stats_tf32x3.cu's z_column): position
// p = 8kk + t + 4h, j = 2kk + h, holds patch column 3j + t (tap j, channel
// t) for t < 3; for t = 3, tap 8's channel j (j < 3), the ones column (j =
// 3) or zero. Thread (l/4, t = l%4) then reads tap j's channel t of its
// pixel: a compile-time offset plus t.
__host__ __device__ constexpr int tf32_patch_column(int p) {
  return (p & 3) < 3 ? 3 * (2 * (p >> 3) + ((p >> 2) & 1)) + (p & 3)
                     : 24 + 2 * (p >> 3) + ((p >> 2) & 1);
}

// W' hi and lo as K-major wgmma B tiles at ``dst`` (1024-byte aligned; hi,
// then lo 8 KB later; 64 rows of 128 bytes, the 128-byte swizzle): row n
// holds, at position p, W[k][n] of the (27, 64) float32 weights for k =
// tf32_patch_column(p) < 27, b[n] for k = 27, zeros after; each value split
// exactly into tf32 hi + lo.
template <int THREADS>
__device__ __forceinline__ void load_conv1_1_wb_tf32x3(uint8_t* dst,
                                                       const float* w,
                                                       const float* b,
                                                       int tid) {
  for (int i = tid; i < 64 * 8; i += THREADS) {
    const int n = i >> 3, j = i & 7;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = tf32_patch_column(4 * j + e);
      const float v = k < 27 ? __ldg(w + k * 64 + n)
                      : k == 27 ? __ldg(b + n)
                                : 0.f;
      split_tf32(v, hi[e], lo[e]);
    }
    *reinterpret_cast<uint4*>(dst + sw128_chunk(n, j)) =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(dst + 64 * 128 + sw128_chunk(n, j)) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// The value at tap J of the k order (lane column t) of the patch row whose
// 3 x 3 window starts at float ``pix`` of a window WX pixels wide: 0 for an
// invalid row (a pixel outside the image), the ones column included.
template <int WX, int J>
__device__ __forceinline__ float tf32_patch_value(const float* win, int pix,
                                                  int t, bool valid) {
  constexpr int TAP = ((J / 3) * WX + J % 3) * 3;
  constexpr int TAP8 = (2 * WX + 2) * 3 + J;
  if (!valid) return 0.f;
  if (t < 3) return win[pix + TAP + t];
  if (J < 3) return win[pix + TAP8];
  return J == 3 ? 1.f : 0.f;
}

// acc = y = P' W' of a warpgroup's 64 rows: this thread's rows are the
// patch rows whose windows start at floats pix0 (row l/4 of its warp's 16)
// and pix1 (row l/4 + 8) of the float32 window ``win`` (WX pixels a row, 3
// channels), t4 = l % 4. Each thread reads its tf32 A fragments from the
// window and splits them in registers; 12 wgmma m64n64k8 (per k8 step lo
// x hi, hi x lo, hi x hi) against W' hi and lo at ``wb`` (as
// load_conv1_1_wb_tf32x3 lays them out). Returns once acc holds y.
template <int WX>
__device__ __forceinline__ void conv1_1_y_tf32x3(float (&acc)[32],
                                                 const float* win, int pix0,
                                                 int pix1, bool valid0,
                                                 bool valid1, int t4,
                                                 uint32_t wb) {
  // a[kk][v] holds position 8kk + t4 + 4*(v >> 1) of row (v & 1).
  uint32_t ahi[4][4], alo[4][4];
#pragma unroll
  for (int rsel = 0; rsel < 2; ++rsel) {
    const int pix = rsel ? pix1 : pix0;
    const bool valid = rsel ? valid1 : valid0;
    const int v0 = rsel, v1 = rsel + 2;
    split_tf32(tf32_patch_value<WX, 0>(win, pix, t4, valid), ahi[0][v0],
               alo[0][v0]);
    split_tf32(tf32_patch_value<WX, 1>(win, pix, t4, valid), ahi[0][v1],
               alo[0][v1]);
    split_tf32(tf32_patch_value<WX, 2>(win, pix, t4, valid), ahi[1][v0],
               alo[1][v0]);
    split_tf32(tf32_patch_value<WX, 3>(win, pix, t4, valid), ahi[1][v1],
               alo[1][v1]);
    split_tf32(tf32_patch_value<WX, 4>(win, pix, t4, valid), ahi[2][v0],
               alo[2][v0]);
    split_tf32(tf32_patch_value<WX, 5>(win, pix, t4, valid), ahi[2][v1],
               alo[2][v1]);
    split_tf32(tf32_patch_value<WX, 6>(win, pix, t4, valid), ahi[3][v0],
               alo[3][v0]);
    split_tf32(tf32_patch_value<WX, 7>(win, pix, t4, valid), ahi[3][v1],
               alo[3][v1]);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    fence_regs(ahi[kk]);
    fence_regs(alo[kk]);
  }
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t bh = desc_sw128(wb + kk * 32, 16);
    const uint64_t bl = desc_sw128(wb + 64 * 128 + kk * 32, 16);
    wgmma_m64n64k8_tf32_rs(acc, alo[kk], bh);
    wgmma_m64n64k8_tf32_rs(acc, ahi[kk], bl);
    wgmma_m64n64k8_tf32_rs(acc, ahi[kk], bh);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    fence_regs(ahi[kk]);
    fence_regs(alo[kk]);
  }
}

// The channel at k position p of a product whose A operand is an m64nN
// f32 accumulator (or data read in its layout), fed to tf32 m64nNk8
// without moving a value between threads: the accumulator holds columns
// 8j + 2t + {0, 1} where the A fragment of k8 step j wants positions 8j +
// t + {0, 4}, so position p = 8kk + t + 4h holds channel 8kk + 2t + h, and
// a[kk][rsel + 2h] = acc[4kk + 2rsel + h]. A B tile of such a product
// holds, at position p, the row of channel acc_k_channel(p).
__host__ __device__ constexpr int acc_k_channel(int p) {
  return (p & ~7) + 2 * (p & 3) + ((p >> 2) & 1);
}

// Two floats as the two bf16 halves of a word, ``lo`` in the low half,
// each rounded to nearest even: a wgmma A-fragment register.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The bf16 A fragments of k16 steps j = 0 .. N/16 - 1 from an m64nN f32
// accumulator, rounded once: for m64nNk16 the accumulator's columns 16j ..
// 16j + 15 sit in the registers where k-step j's A fragment wants them
// (acc[8j + 2v], acc[8j + 2v + 1] are a[j][v]'s two halves, row and columns
// as wgmma_m64n64k16_rs states).
template <int R>
__device__ __forceinline__ void acc_to_a_bf16(const float (&acc)[R],
                                              uint32_t (&a)[R / 8][4]) {
#pragma unroll
  for (int j = 0; j < R / 8; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      a[j][v] = pack_bf16x2(acc[8 * j + 2 * v], acc[8 * j + 2 * v + 1]);
}

// Pass 2 of the tensor-core Grams (gram_wgmma.cu, gram_tf32x3.cu), whose
// pass 1 writes the upper TILE x TILE tiles of each slice's partial Gram:
// one thread per (b, i, j) of an upper tile adds the S slices in order and
// writes G[b][i][j] and, off the diagonal tiles, G[b][j][i]. No atomics, so
// the Gram is the same on every run.
template <int TILE>
__global__ void gram_reduce_upper_kernel(const float* __restrict__ partial,
                                         float* __restrict__ g, int B, int C,
                                         int S) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long cc = (long long)C * C;
  if (idx >= (long long)B * cc) return;
  const long long b = idx / cc;
  const int i = (int)((idx % cc) / C);
  const int j = (int)(idx % C);
  if (i / TILE > j / TILE) return;
  const float* src = partial + b * S * cc + (long long)i * C + j;
  float sum = 0.f;
  for (int s = 0; s < S; ++s) sum += src[s * cc];
  g[b * cc + (long long)i * C + j] = sum;
  if (i / TILE < j / TILE) g[b * cc + (long long)j * C + i] = sum;
}

// Host: launches gram_reduce_upper_kernel on ``stream``; returns the
// launch's cudaError_t.
template <int TILE>
inline int gram_reduce_upper(const void* partial, void* g, int B, int C,
                             int S, cudaStream_t stream) {
  const long long n = (long long)B * C * C;
  gram_reduce_upper_kernel<TILE><<<(unsigned)((n + 255) / 256), 256, 0,
                                   stream>>>((const float*)partial,
                                             (float*)g, B, C, S);
  return (int)cudaGetLastError();
}

// Host: the tensor map of conv weights laid out (N, 9, K), K innermost (e
// bytes an element), with the box (bk, 1, bn) and the 128-byte swizzle:
// per tap, a [bn x bk] K-major wgmma B tile.
inline CUresult encode_weights(CUtensorMap* map, const void* w,
                               CUtensorMapDataType dt, cuuint64_t e, int K,
                               int N, int bk, int bn) {
  const cuuint32_t ones[3] = {1, 1, 1};
  const cuuint64_t dim[3] = {(cuuint64_t)K, 9, (cuuint64_t)N};
  const cuuint64_t stride[2] = {K * e, 9 * K * e};
  const cuuint32_t box[3] = {(cuuint32_t)bk, 1, (cuuint32_t)bn};
  return cuTensorMapEncodeTiled(
      map, dt, 3, const_cast<void*>(w), dim, stride, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Host: the tensor map of a 2x2 pool's (C, W/2, H/2, B) tensor t (e bytes
// an element) with the box (bc, pw, ph, 1), unswizzled: the pooled
// footprint of a full-resolution tile (the routed backward kernels).
inline CUresult encode_pooled(CUtensorMap* map, const void* t,
                              CUtensorMapDataType dt, cuuint64_t e, int B,
                              int Hp, int Wp, int C, int bc, int pw, int ph) {
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const cuuint64_t dim[4] = {(cuuint64_t)C, (cuuint64_t)Wp, (cuuint64_t)Hp,
                             (cuuint64_t)B};
  const cuuint64_t stride[3] = {C * e, (cuuint64_t)Wp * C * e,
                                (cuuint64_t)Hp * Wp * C * e};
  const cuuint32_t box[4] = {(cuuint32_t)bc, (cuuint32_t)pw, (cuuint32_t)ph,
                             1};
  return cuTensorMapEncodeTiled(
      map, dt, 4, const_cast<void*>(t), dim, stride, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace hopper
