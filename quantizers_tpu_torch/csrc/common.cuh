// Shared pieces of the weight-only matmul and slot-FFN kernels.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qtt {

constexpr int kMTile = 8;    // activation rows per block
constexpr int kMaxSeg = 32;  // most K rows a warp sums before it applies a scale

// Rows of one warp segment: the largest divisor of the group g that is at
// most kMaxSeg, so that no segment straddles a group boundary.
static inline int segment_rows(int g) {
  int s = g < kMaxSeg ? g : kMaxSeg;
  while (g % s) --s;
  return s;
}

static inline int gcd_int(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Stage x[m0 : m0+8, k0 : k0+rows] of a row-major bf16 (M, K) activation
// into shared memory as f32, transposed to [row][m] so that the inner loop
// reads the 8 activations of one K row as two float4. Rows m >= M are zero.
__device__ __forceinline__ void stage_x(float* __restrict__ xs,
                                        const __nv_bfloat16* __restrict__ x,
                                        int M, int K, int m0, int k0, int rows) {
  for (int i = threadIdx.x; i < rows * kMTile; i += blockDim.x) {
    const int r = i % rows;  // consecutive threads read consecutive K
    const int m = i / rows;
    float v = 0.f;
    if (m0 + m < M) v = __bfloat162float(x[(size_t)(m0 + m) * K + k0 + r]);
    xs[r * kMTile + m] = v;
  }
}

__device__ __forceinline__ void load_x8(const float* __restrict__ row, float (&v)[kMTile]) {
  const float4 a = reinterpret_cast<const float4*>(row)[0];
  const float4 b = reinterpret_cast<const float4*>(row)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// d += a . b on the tensor cores: one warp-level m16n8k16 bf16 product with
// f32 sums (a: 16x16 row-major fragment, b: 16x8 column-major fragment).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a . b on the tensor cores into a fresh f32 fragment (C = 0).
__device__ __forceinline__ void mma_bf16_fresh(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// acc += p * scale for an m16n8 fragment whose A rows are output columns:
// c0, c1 are column col's (scale s.x), c2, c3 col + 1's.
__device__ __forceinline__ void fold(float (&acc)[4], const float (&p)[4], float2 s) {
  acc[0] = fmaf(p[0], s.x, acc[0]);
  acc[1] = fmaf(p[1], s.x, acc[1]);
  acc[2] = fmaf(p[2], s.y, acc[2]);
  acc[3] = fmaf(p[3], s.y, acc[3]);
}

// The scales of columns col, col + 1 as f32.
__device__ __forceinline__ float2 scale_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 scale_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Two floats as a bf16 pair, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four 8x8 b16 matrices whose rows start at the addresses of lanes 0-7,
// 8-15, 16-23 and 24-31, transposed: from matrix q, lane i receives
// element i/4 of rows 2(i%4) and 2(i%4)+1 (low and high half of r[q]).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The same four 8x8 b16 matrices, not transposed: from matrix q, lane i
// receives elements 2(i%4) and 2(i%4)+1 of row i/4 (low and high half of r[q]).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// An asynchronous 16-byte copy from device to shared memory; !valid writes
// 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(addr), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Staged weight tiles of the tensor-core matmuls: one 128-byte line a K
// row (128 columns of one-byte weights).
constexpr int kLine = 128;

// Byte offset of 16-byte piece c (columns 16c ..) of K row r in a staged
// tile: piece c of row r sits in slot c ^ (r % 8), so the 8 rows of one
// ldmatrix matrix (one piece each) fall in 8 distinct 4-bank groups.
__device__ __forceinline__ int w_off(int r, int c) {
  return r * kLine + ((c ^ (r & 7)) << 4);
}

// The B fragment register of x row 8 mg + gid, K columns 8c + 2t, + 1 of
// an x box staged by TMA in the 128-byte swizzle, [8 MG rows][64 bf16] (xp:
// the box plus gid * 128 + 4t): 16-byte piece c of that row, swizzled by
// the row mod 8.
__device__ __forceinline__ uint32_t x_frag(const uint8_t* xp, int mg, int c, int gid) {
  return *reinterpret_cast<const uint32_t*>(xp + mg * 8 * 128 + ((c ^ gid) << 4));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}

// --- weight decodes in registers (the tensor-core matmuls and K6) ----------
//
// Each takes one ldmatrix.trans register of a staged one-byte-per-column
// tile: bytes (k, c0), (k, c1), (k+1, c0), (k+1, c1) for a lane's columns
// c0, c1 and K rows k, k+1 (packed layouts: packed row p, p+1).

// int8-doubled values |v| <= 12 as the bf16 pairs
// lo = (v(k, c0), v(k+1, c0)) * s0 and hi = (v(k, c1), v(k+1, c1)) * s1.
__device__ __forceinline__ void dequant_pairs(uint32_t r, __nv_bfloat162 s0, __nv_bfloat162 s1,
                                              uint32_t& lo, uint32_t& hi) {
  const uint32_t u = (r & 0x7F7F7F7Fu) ^ 0x40404040u;  // each byte v + 64, in 0..127
  const __nv_bfloat162 off = __floats2bfloat162_rn(192.f, 192.f);
  // 0x43 above a byte u is the bf16 128 + u = 192 + v
  const __nv_bfloat162 v0 = __hsub2(as_bf162(__byte_perm(u, 0x43434343u, 0x4240)), off);
  const __nv_bfloat162 v1 = __hsub2(as_bf162(__byte_perm(u, 0x43434343u, 0x4341)), off);
  lo = as_u32(__hmul2(v0, s0));
  hi = as_u32(__hmul2(v1, s1));
}

// The E2M1 codes in the top nibble of each 16-bit half of q (bits 12-15 and
// 28-31) as a bf16 pair times the scale pair s: the sign goes to bit 15, the
// magnitude code (e, m) to bits 6-8, which is the bf16 of value * 2^-126
// (code 1, 0.5, the subnormal 2^-127); times 2^126 is exact, times s rounds
// the exact product once.
__device__ __forceinline__ uint32_t e2m1_pair(uint32_t q, __nv_bfloat162 s) {
  const uint32_t bits = (q & 0x80008000u) | ((q >> 6) & 0x01C001C0u);
  const __nv_bfloat162 two126 = as_bf162(0x7E807E80u);  // 2^126 in both halves
  return as_u32(__hmul2(__hmul2(as_bf162(bits), two126), s));
}

// Packed E2M1 (split-half): the A pairs of both planes, lo-plane K rows p,
// p+1 from the low nibbles, hi-plane rows from the high nibbles, each times
// its column's scale pair (sl0, sl1: lo plane, columns c0, c1; sh0, sh1: hi).
__device__ __forceinline__ void dequant_packed(uint32_t r, __nv_bfloat162 sl0,
                                               __nv_bfloat162 sl1, __nv_bfloat162 sh0,
                                               __nv_bfloat162 sh1, uint32_t& lo0, uint32_t& lo1,
                                               uint32_t& hi0, uint32_t& hi1) {
  hi1 = e2m1_pair(r, sh1);        // high nibbles of bytes 1, 3
  lo1 = e2m1_pair(r << 4, sl1);   // low nibbles of bytes 1, 3
  hi0 = e2m1_pair(r << 8, sh0);   // high nibbles of bytes 0, 2
  lo0 = e2m1_pair(r << 12, sl0);  // low nibbles of bytes 0, 2
}

// The nibbles at bits 0-3 and 16-19 of q, codes c, as the bf16 pair c - 8:
// 0x43 above the nibble is the bf16 128 + c, and 136 (0x4308) off it is exact.
__device__ __forceinline__ uint32_t w4_pair(uint32_t q) {
  const uint32_t v = (q & 0x000F000Fu) | 0x43004300u;
  return as_u32(__hsub2(as_bf162(v), as_bf162(0x43084308u)));
}

// Packed w4 (split-half): the exact codes c - 8 of both planes, lo-plane K
// rows p, p+1 from the low nibbles, hi-plane rows from the high nibbles, of
// columns c0 and c1.
__device__ __forceinline__ void decode_w4(uint32_t r, uint32_t& lo0, uint32_t& lo1, uint32_t& hi0,
                                          uint32_t& hi1) {
  lo0 = w4_pair(r);        // low nibbles of bytes 0, 2
  hi0 = w4_pair(r >> 4);   // high nibbles of bytes 0, 2
  lo1 = w4_pair(r >> 8);   // low nibbles of bytes 1, 3
  hi1 = w4_pair(r >> 12);  // high nibbles of bytes 1, 3
}

// int8 codes over their full range (-128..127) as exact bf16 pairs:
// lo = (v(k, c0), v(k+1, c0)), hi = (v(k, c1), v(k+1, c1)). A bf16 holds
// each code exactly, but a bf16 magic number holds only 7 bits of it
// (dequant_pairs); an f32 one holds all 8: 0x4B000000 | u, u = v ^ 0x80, is
// the f32 2^23 + 128 + v, 2^23 + 128 off it is v, exactly, and the high
// half of that f32 is the bf16 of v.
__device__ __forceinline__ void decode_i8(uint32_t r, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = r ^ 0x80808080u;
  const float m = 8388736.f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - m;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - m;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - m;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - m;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f2), 0x7632);
  hi = __byte_perm(__float_as_uint(f1), __float_as_uint(f3), 0x7632);
}

// The scale pairs of the k16 step whose rows start at K row k (lo plane;
// the hi plane's at K/2 + k) for a lane's columns: rows k + 2t, +1 (a0, a1)
// and k + 8 + 2t, +1 (a2, a3), each as (column c0 pair, column c1 pair),
// read from device memory (any g). Rows at or past `end` read 0.
__device__ __forceinline__ void row_scales(const __nv_bfloat16* __restrict__ scale, int k, int end,
                                           int g, int N, int c, __nv_bfloat162& s0a,
                                           __nv_bfloat162& s1a, __nv_bfloat162& s0b,
                                           __nv_bfloat162& s1b) {
  const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
  __nv_bfloat162 row[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kj = k + (j & 1) + (j >> 1) * 8;
    row[j] = kj < end ? __ldg(reinterpret_cast<const __nv_bfloat162*>(
                            scale + (size_t)(kj / g) * N + c))
                      : zero;
  }
  s0a = __lows2bfloat162(row[0], row[1]);
  s1a = __highs2bfloat162(row[0], row[1]);
  s0b = __lows2bfloat162(row[2], row[3]);
  s1b = __highs2bfloat162(row[2], row[3]);
}

// Is p 16-byte aligned (cp.async's 16-byte copies and TMA's bases need it)?
static inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// --- mbarriers and TMA tensor maps ---------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive and expect `bytes` of copies to complete on the barrier.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The address of `p` (this block's shared memory) in the shared memory of
// block `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}

// Store two floats at `addr` in the shared memory of a block of the
// cluster, completing their 8 bytes on that block's mbarrier at `bar`.
__device__ __forceinline__ void st_async_f32x2(uint32_t addr, float a, float b, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(
          addr),
      "f"(a), "f"(b), "r"(bar)
      : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime
// (so the library needs no -lcuda).
static inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map of a row-major (rows, cols) matrix of `type`, `row_bytes`
// apart, read in boxes of box_rows x box_cols; rows past `rows` read as
// zeros. With the 128-byte swizzle (the default) a box row is 128 bytes,
// and piece c of row r lands at c ^ (r % 8) (w_off's layout); with none, a
// box is stored row-major as it is.
static inline bool make_map_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                               int cols, int rows, long long row_bytes, int box_cols,
                               int box_rows,
                               CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiled fn = tensor_map_encoder();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One box of a 2-D tensor map (coordinates c0 innermost) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// Sum the partial results red[warp][m][c] (c < cols) of a block's WARPS
// warps in a fixed order and write rows m0.. of the bf16 output at col0.
template <int WARPS>
__device__ __forceinline__ void reduce_store(const float* __restrict__ red, int cols,
                                             __nv_bfloat16* __restrict__ out, int M, int N,
                                             int m0, int col0) {
  for (int i = threadIdx.x; i < kMTile * cols; i += blockDim.x) {
    const int m = i / cols, c = i % cols;
    if (m0 + m >= M) break;  // i grows with m
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[(w * kMTile + m) * cols + c];
    out[(size_t)(m0 + m) * N + col0 + c] = __float2bfloat16(s);
  }
}

}  // namespace qtt
