// Shared pieces of the MoE slot-FFN kernels (moe_slot_ffn.cu, moe_slot_gu_ffn.cu).
//
// A slot is one (token, routed expert) pair: its row of x (bf16), and the
// id of the expert whose stacked weights it multiplies. Both kernels run a
// slot's gated FFN in two launches:
//
// 1. gate|up: grid (F/32 column tiles, S slots). Each lane owns one
//    column of the gate and of the up projection and sums x[k] * W[k, col]
//    over its warp's K segments; the warps' sums meet in shared memory in a
//    fixed order, and the block writes a = bf16(silu(g) * u) for its 32
//    columns into a (S, F) bf16 workspace: the point where the JAX kernels
//    round a to bf16 before the down product.
// 2. down: grid (D/32, S). The same over the workspace row a and the
//    expert's down matrix, writing y (S, D) f32.
//
// Each block reads only its slot's expert, so the bytes read are those of
// the routed experts (a repeated expert is read once per slot). Every sum
// runs in a fixed order: no atomics, the same bits on every run.

#pragma once

#include "common.cuh"

namespace qtt {
namespace {

enum Payload {
  kPackedW4 = 0,        // packed uint8 (K/2, N) split-half, value = nibble - 8, bf16 group scales
  kPackedFp4 = 1,       // packed uint8 (K/2, N) split-half E2M1 codes, bf16 group scales
  kInt8Scaled = 2,      // int8 (K, N) (2x the E2M1 value), bf16 (halved) group scales
  kInt8PerChannel = 3,  // int8 (K, N), f32 per-channel scales applied to the sums
};

constexpr int kSlotCols = 32;  // one column per lane
constexpr int kSlotWarps = 8;  // each on its own K segments
constexpr int kSlotThreads = 32 * kSlotWarps;

// One operand: a stack of E matrices of `rows` rows and `ld` stored columns.
struct SlotMat {
  const uint8_t* w;    // expert 0's payload
  const void* s;       // expert 0's scales
  long long w_stride;  // payload bytes per expert
  long long s_stride;  // scale elements per expert
  int ld;              // stored columns (the fused gate|up stack: 2F)
  int col0;            // this operand's first column (the fused up half: F)
};

template <int P>
__device__ __forceinline__ float dequant(int v, float s) {
  if (P == kPackedFp4) return round_bf16(fp4_value((uint32_t)v) * s);
  if (P == kPackedW4) return round_bf16((float)(v - 8) * s);
  if (P == kInt8Scaled) return round_bf16((float)v * s);
  return (float)v;  // per-channel: the scale multiplies the sum
}

// This lane's partial sum of xs[k] * W_e[k, col] over its warp's segments
// of seg rows (seg divides the group and, packed, K/2). xs is the slot's x
// row staged in shared memory as f32.
template <int P>
__device__ float slot_col_sum(const float* __restrict__ xs, const SlotMat& m, int e,
                              int col, int K, int g, int seg) {
  const int warp = threadIdx.x / 32;
  const uint8_t* w = m.w + (size_t)e * m.w_stride + m.col0 + col;
  const int rows = (P == kPackedW4 || P == kPackedFp4) ? K / 2 : K;
  float acc = 0.f;
  for (int r0 = warp * seg; r0 < rows; r0 += kSlotWarps * seg) {
    uint32_t b[kMaxSeg];
#pragma unroll
    for (int i = 0; i < kMaxSeg; ++i) b[i] = i < seg ? w[(size_t)(r0 + i) * m.ld] : 0u;
    if (P == kPackedW4 || P == kPackedFp4) {
      const __nv_bfloat16* s = static_cast<const __nv_bfloat16*>(m.s) +
                               (size_t)e * m.s_stride + m.col0 + col;
      const int half = K / 2;
      const float sl = __bfloat162float(s[(size_t)(r0 / g) * m.ld]);
      const float sh = __bfloat162float(s[(size_t)((half + r0) / g) * m.ld]);
#pragma unroll
      for (int i = 0; i < kMaxSeg; ++i) {
        if (i >= seg) break;
        acc = fmaf(xs[r0 + i], dequant<P>((int)(b[i] & 0xFu), sl), acc);
        acc = fmaf(xs[half + r0 + i], dequant<P>((int)(b[i] >> 4), sh), acc);
      }
    } else {
      float sv = 1.f;
      if (P == kInt8Scaled)
        sv = __bfloat162float(static_cast<const __nv_bfloat16*>(m.s)[
            (size_t)e * m.s_stride + (size_t)(r0 / g) * m.ld + m.col0 + col]);
#pragma unroll
      for (int i = 0; i < kMaxSeg; ++i) {
        if (i >= seg) break;
        acc = fmaf(xs[r0 + i], dequant<P>((int)(int8_t)(b[i] & 0xFFu), sv), acc);
      }
    }
  }
  return acc;
}

__device__ __forceinline__ void stage_row(float* __restrict__ xs,
                                          const __nv_bfloat16* __restrict__ row, int K) {
  for (int k = threadIdx.x; k < K; k += blockDim.x) xs[k] = __bfloat162float(row[k]);
}

// Sum red[w][lane] over the warps in a fixed order (called by warp 0).
__device__ __forceinline__ float warp_total(const float* __restrict__ red, int lane) {
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kSlotWarps; ++w) t += red[w * kSlotCols + lane];
  return t;
}

__device__ __forceinline__ float per_channel(const SlotMat& m, int e, int col) {
  return static_cast<const float*>(m.s)[(size_t)e * m.s_stride + m.col0 + col];
}

// Launch 1: a[s, col] = bf16(silu(x_s . G_e[:, col]) * (x_s . U_e[:, col])).
template <int P>
__global__ void __launch_bounds__(kSlotThreads)
slot_gate_up_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ idx, int E,
                    SlotMat G, SlotMat U, int K, int F, int g, int seg,
                    __nv_bfloat16* __restrict__ a_out) {
  extern __shared__ __align__(16) float smem[];
  float* red = smem;                            // [2][warp][lane]
  float* xs = smem + 2 * kSlotWarps * kSlotCols;  // [K]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s = blockIdx.y;
  const int col = blockIdx.x * kSlotCols + lane;
  const int e = idx[s];
  const bool bad = e < 0 || e >= E;  // the same for the whole block
  stage_row(xs, x + (size_t)s * K, K);
  __syncthreads();
  float gs = 0.f, us = 0.f;
  if (!bad) {
    gs = slot_col_sum<P>(xs, G, e, col, K, g, seg);
    us = slot_col_sum<P>(xs, U, e, col, K, g, seg);
  }
  red[warp * kSlotCols + lane] = gs;
  red[(kSlotWarps + warp) * kSlotCols + lane] = us;
  __syncthreads();
  if (warp != 0) return;
  float gv = warp_total(red, lane);
  float uv = warp_total(red + kSlotWarps * kSlotCols, lane);
  float a = __int_as_float(0x7fc00000);  // an expert id out of range gives NaN
  if (!bad) {
    if (P == kInt8PerChannel) {
      gv *= per_channel(G, e, col);
      uv *= per_channel(U, e, col);
    }
    a = gv * (1.f / (1.f + expf(-gv))) * uv;
  }
  a_out[(size_t)s * F + col] = __float2bfloat16_rn(a);
}

// Launch 2: y[s, col] = a_s . Dn_e[:, col], f32.
template <int P>
__global__ void __launch_bounds__(kSlotThreads)
slot_down_kernel(const __nv_bfloat16* __restrict__ a, const int* __restrict__ idx, int E,
                 SlotMat Dn, int K, int N, int g, int seg, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* red = smem;                        // [warp][lane]
  float* xs = smem + kSlotWarps * kSlotCols;  // [K]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s = blockIdx.y;
  const int col = blockIdx.x * kSlotCols + lane;
  const int e = idx[s];
  const bool bad = e < 0 || e >= E;
  stage_row(xs, a + (size_t)s * K, K);
  __syncthreads();
  red[warp * kSlotCols + lane] = bad ? 0.f : slot_col_sum<P>(xs, Dn, e, col, K, g, seg);
  __syncthreads();
  if (warp != 0) return;
  float y = warp_total(red, lane);
  if (P == kInt8PerChannel && !bad) y *= per_channel(Dn, e, col);
  out[(size_t)s * N + col] = bad ? __int_as_float(0x7fc00000) : y;
}

// Rows of a warp segment for a K-row operand with groups of g: it divides
// g and, for the split-half packed layouts, K/2 (so that neither plane's
// segment straddles a group).
static inline int slot_segment(int P, int K, int g) {
  if (P == kInt8PerChannel) return segment_rows(gcd_int(K, kMaxSeg));
  if (P == kPackedW4 || P == kPackedFp4) return segment_rows(gcd_int(g, K / 2));
  return segment_rows(gcd_int(g, K));
}

// Both launches on `stream`; returns the first CUDA error (0 if none).
template <int P>
int slot_ffn_launch(const __nv_bfloat16* x, const int* idx, int S, int D, int F, int E, int g,
                    SlotMat G, SlotMat U, SlotMat Dn, __nv_bfloat16* a_ws, float* out,
                    cudaStream_t stream) {
  const size_t smem1 = (size_t)(2 * kSlotWarps * kSlotCols + D) * sizeof(float);
  const size_t smem2 = (size_t)(kSlotWarps * kSlotCols + F) * sizeof(float);
  if (smem1 > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        slot_gate_up_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
    if (err != cudaSuccess) return (int)err;
  }
  if (smem2 > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        slot_down_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
    if (err != cudaSuccess) return (int)err;
  }
  slot_gate_up_kernel<P><<<dim3(F / kSlotCols, S), kSlotThreads, smem1, stream>>>(
      x, idx, E, G, U, D, F, g, slot_segment(P, D, g), a_ws);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  slot_down_kernel<P><<<dim3(D / kSlotCols, S), kSlotThreads, smem2, stream>>>(
      a_ws, idx, E, Dn, F, D, g, slot_segment(P, F, g), out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace qtt
