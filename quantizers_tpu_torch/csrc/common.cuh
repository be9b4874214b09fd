// Shared pieces of the weight-only matmul and slot-FFN kernels.
#pragma once

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
