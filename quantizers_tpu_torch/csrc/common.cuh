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

// An E2M1 code (0..15) as a float. The eight magnitudes doubled,
// {0, 1, 2, 3, 4, 6, 8, 12}, sit in the nibbles of one 32-bit constant, so
// the decode is a shift and a mask in registers; bit 3 is the sign.
__device__ __forceinline__ float fp4_value(uint32_t code) {
  const float mag = (float)((0xC8643210u >> ((code & 7u) * 4u)) & 0xFu) * 0.5f;
  return (code & 8u) ? -mag : mag;
}

// Round an f32 to the nearest bf16 (ties to even) and widen it again: the
// point where the JAX kernels round a dequantized weight to bf16.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
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
