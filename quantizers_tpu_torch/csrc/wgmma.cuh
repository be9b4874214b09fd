// Hopper warpgroup matrix multiply (wgmma) helpers (sm_90a only).
//
// A warpgroup (4 consecutive warps, 128 threads) starts one asynchronous
// m64nNk16 product: D (64 x N, f32, in registers) += A (64 x 16) . B (16 x N).
// B always lies in shared memory, addressed by a 64-bit matrix descriptor; A
// lies in shared memory (the "ss" forms) or in registers (the "rs" forms).
//
// Shared-memory layout: every operand here uses the 128-byte swizzle. A
// [rows][W] bf16 tile is stored as W / 64 column blocks of rows x 64
// elements; each row of a block is 128 bytes, and its eight 16-byte pieces
// are permuted by XOR with the row's index mod 8: piece c of row r lies at
// (c / 8) * rows * 128 + r * 128 + ((c % 8) ^ (r % 8)) * 16 bytes, which is
// what a TMA load with CU_TENSOR_MAP_SWIZZLE_128B and 64-wide boxes writes.
// Eight rows make one 1024-byte swizzle atom, which must start on a
// 1024-byte boundary (the hardware applies the XOR to address bits 4-6 from
// bits 7-9).
// - K-major (the reduction dim contiguous, e.g. Q or K for Q . K^T): SBO =
//   1024 (one 8-row group to the next), LBO unused; the k16 slice kk of a
//   block starts 32 * (kk % 4) bytes into it.
// - MN-major (the output dim contiguous, e.g. V as stored for P . V, with
//   the transpose immediate): LBO = the column block's size (one 64-wide
//   block of N to the next), SBO = 1024 (one group of 8 reduction rows to
//   the next); the k16 slice kk starts 2048 * kk bytes in.
//
// Accumulator layout (m64nN, f32): thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 and that + 8; register 4 j + e is column
// 8 j + 2 (t % 4) + (e & 1) of row (e < 2 ? first : second). A register A
// fragment of one k16 slice is the same as mma.sync's m16n8k16 A fragment,
// per warp: {row g, k 2c..2c+1}, {row g + 8, k 2c..}, {row g, k 2c+8..},
// {row g + 8, k 2c+8..} (g = lane / 4, c = lane % 4), so the accumulator of
// two neighbouring 8-column blocks, rounded to bf16 pairs, is the A
// fragment of a product over those 16 columns.
//
// Ordering: wgmma_fence() before the first product of a batch (and after any
// register write the batch reads); wgmma_commit() closes a group;
// wgmma_wait<N>() waits until at most N groups are in flight; then
// fence_operands() pins the accumulator so the compiler does not move reads
// of it above the wait. Shared memory written by threads (st.shared or
// cp.async) is made visible to wgmma by `fence.proxy.async.shared::cta` in
// each writing thread, then a barrier; TMA writes need only the mbarrier
// they complete.
// ptxas serializes every wgmma of a kernel (warning C7520) if one sits
// on a branch it cannot prove warpgroup-uniform: keep them off branches.
#pragma once

#include <stdint.h>

namespace qtt {

// A shared-memory matrix descriptor with the 128-byte swizzle; lbo and sbo
// in bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* smem, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// The descriptor of the same layout `bytes` further on (a multiple of 16).
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The products. N is given by the accumulator: N / 2 registers a thread.
// scale_d = 0 overwrites D, 1 adds to it; TB = 1 reads B MN-major.

// D (64 x 64) (+)= A . B, bf16 -> f32, A and B from shared memory.
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// D (64 x 128) (+)= A . B, bf16 -> f32, A and B from shared memory.
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// D (64 x 128) (+)= A . B, bf16 -> f32, A from registers (the fragment
// above), B from shared memory.
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

}  // namespace qtt
