// NVFP4 weight-only matmul for Hopper (sm_90a): y = x @ W^T, bf16 out.
//
// Replaces quantizers_tpu/ops/kernels.py `_nvfp4_kernel` / `_nvfp4_matmul_2d`
// (packed E2M1 codes) and `_nvfp4_i8_kernel` / `_nvfp4_i8_matmul_2d` (the
// int8-doubled layout of the same weights). Two entry points:
//
// * qtt_nvfp4_matmul: packed uint8 (K/2, N), split-half: the low nibble of
//   row p is the E2M1 code of W[p, n], the high nibble that of W[K/2 + p, n].
//   Effective scales bf16 (K/g, N) (the global scale folded in), g = 16.
// * qtt_nvfp4_i8_matmul: int8 (K, N) holding 2x the E2M1 value, with the
//   scales halved, so value * scale is the same product.
//
// x bf16 (M, K), M <= 512. Both follow the JAX kernels' arithmetic: each
// weight is dequantized in f32 (value * scale, exact) and rounded to bf16
// once, then multiplied with the bf16 activation and summed in f32.
//
// What bounds it on the H100 SXM: bytes at decode. The dense Qwen3-4B
// gate|up call (K 2560, N 19456) reads 24.9 MB packed plus 6.2 MB of scales
// (9.3 us at 3.35 TB/s); the int8 layout reads twice the payload. This
// simple design does its arithmetic on the CUDA cores: a decode, a scale, a
// bf16 rounding and 8 FMAs per weight at M = 8, so it is bound by those
// operations before it reaches the memory bound.
//
// Design: the w4 kernel's (w4_matmul.cu) for the packed layout (32 columns
// per block, one per lane, 16 warps on disjoint K segments of every pass,
// two activation planes) and the w8 kernel's (w8_matmul.cu) for the int8
// layout (128 columns per block, four per lane, 8 warps). A segment lies in
// one scale group, so each lane loads one scale per segment. The E2M1 decode
// is a shift and a mask of a constant in registers (common.cuh: fp4_value).
// The warps' sums meet in shared memory and are added in a fixed order, so
// the result does not change from run to run. The packed weights are read
// as they are: unlike the compiled TPU path, nothing converts them per call.
//
// Left for later: tensor-core products (E2M1 -> bf16 in registers feeding
// mma), TMA / cp.async staging, and a Hopper relayout of the codes.

#include "common.cuh"

namespace {
using namespace qtt;

// --- packed E2M1 (K/2, N) ---------------------------------------------------

constexpr int kPCols = 32;  // one column per lane
constexpr int kPWarps = 16;
constexpr int kPThreads = 32 * kPWarps;
constexpr int kPChunk = kPWarps * kMaxSeg;  // K rows (of each plane) per pass
static_assert(2 * kPChunk * kMTile >= kPWarps * kMTile * kPCols, "shared buffer");

__global__ void __launch_bounds__(kPThreads)
nvfp4_packed_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
                    const __nv_bfloat16* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                    int M, int K, int N, int g, int seg) {
  __shared__ __align__(16) float smem[2 * kPChunk * kMTile];
  float* xs_lo = smem;
  float* xs_hi = smem + kPChunk * kMTile;
  const int half = K / 2;
  const int chunk = kPWarps * seg;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * kMTile;
  const int col0 = blockIdx.x * kPCols;
  const int col = col0 + lane;
  const int s0 = warp * seg;

  float acc[kMTile];
#pragma unroll
  for (int m = 0; m < kMTile; ++m) acc[m] = 0.f;

  for (int c0 = 0; c0 < half; c0 += chunk) {
    const int rows = min(chunk, half - c0);  // a multiple of seg
    const bool mine = s0 < rows;
    const uint8_t* wp = packed + (size_t)(c0 + s0) * N + col;
    uint32_t wb[kMaxSeg];
#pragma unroll
    for (int i = 0; i < kMaxSeg; ++i) wb[i] = (mine && i < seg) ? wp[(size_t)i * N] : 0u;
    float sl = 0.f, sh = 0.f;
    if (mine) {
      // a segment lies in one group of each plane (seg divides g and K/2)
      sl = __bfloat162float(scale[(size_t)((c0 + s0) / g) * N + col]);
      sh = __bfloat162float(scale[(size_t)((half + c0 + s0) / g) * N + col]);
    }
    __syncthreads();  // the previous pass is done with the staged x
    stage_x(xs_lo, x, M, K, m0, c0, rows);
    stage_x(xs_hi, x, M, K, m0, half + c0, rows);
    __syncthreads();
    if (!mine) continue;
#pragma unroll
    for (int i = 0; i < kMaxSeg; ++i) {
      if (i >= seg) break;
      const float wl = round_bf16(fp4_value(wb[i] & 0xFu) * sl);
      const float wh = round_bf16(fp4_value(wb[i] >> 4) * sh);
      float xl[kMTile], xh[kMTile];
      load_x8(xs_lo + (s0 + i) * kMTile, xl);
      load_x8(xs_hi + (s0 + i) * kMTile, xh);
#pragma unroll
      for (int m = 0; m < kMTile; ++m) acc[m] = fmaf(xh[m], wh, fmaf(xl[m], wl, acc[m]));
    }
  }
  __syncthreads();  // every warp is done with the staged x: reuse it
  float* red = smem;  // [warp][m][kPCols]
#pragma unroll
  for (int m = 0; m < kMTile; ++m) red[(warp * kMTile + m) * kPCols + lane] = acc[m];
  __syncthreads();
  reduce_store<kPWarps>(red, kPCols, out, M, N, m0, col0);
}

// --- int8-doubled (K, N) ----------------------------------------------------

constexpr int kICols = 4;  // columns per lane
constexpr int kIBlockCols = 32 * kICols;
constexpr int kIWarps = 8;
constexpr int kIThreads = 32 * kIWarps;
constexpr int kIChunk = kIWarps * kMaxSeg;
constexpr int kISmem = kIWarps * kMTile * kIBlockCols;
static_assert(kISmem >= kIChunk * kMTile, "shared buffer");

__global__ void __launch_bounds__(kIThreads)
nvfp4_i8_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w8,
                const __nv_bfloat16* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                int M, int K, int N, int g, int seg) {
  __shared__ __align__(16) float smem[kISmem];
  float* xs = smem;
  const int chunk = kIWarps * seg;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * kMTile;
  const int col0 = blockIdx.x * kIBlockCols;
  const int col = col0 + lane * kICols;
  const int s0 = warp * seg;

  float acc[kMTile][kICols];
#pragma unroll
  for (int m = 0; m < kMTile; ++m)
#pragma unroll
    for (int j = 0; j < kICols; ++j) acc[m][j] = 0.f;

  for (int c0 = 0; c0 < K; c0 += chunk) {
    const int rows = min(chunk, K - c0);
    const bool mine = s0 < rows;
    const int8_t* wp = w8 + (size_t)(c0 + s0) * N + col;
    uint32_t wr[kMaxSeg];
#pragma unroll
    for (int i = 0; i < kMaxSeg; ++i)
      wr[i] = (mine && i < seg) ? *reinterpret_cast<const uint32_t*>(wp + (size_t)i * N) : 0u;
    float sv[kICols] = {0.f, 0.f, 0.f, 0.f};
    if (mine) {
      const __nv_bfloat162* sp = reinterpret_cast<const __nv_bfloat162*>(
          scale + (size_t)((c0 + s0) / g) * N + col);
      const float2 sa = __bfloat1622float2(sp[0]);
      const float2 sb = __bfloat1622float2(sp[1]);
      sv[0] = sa.x; sv[1] = sa.y; sv[2] = sb.x; sv[3] = sb.y;
    }
    __syncthreads();
    stage_x(xs, x, M, K, m0, c0, rows);
    __syncthreads();
    if (!mine) continue;
#pragma unroll
    for (int i = 0; i < kMaxSeg; ++i) {
      if (i >= seg) break;
      float wv[kICols];
#pragma unroll
      for (int j = 0; j < kICols; ++j)
        wv[j] = round_bf16((float)(int8_t)((wr[i] >> (8 * j)) & 0xFF) * sv[j]);
      float xv[kMTile];
      load_x8(xs + (s0 + i) * kMTile, xv);
#pragma unroll
      for (int m = 0; m < kMTile; ++m)
#pragma unroll
        for (int j = 0; j < kICols; ++j) acc[m][j] = fmaf(xv[m], wv[j], acc[m][j]);
    }
  }
  __syncthreads();
  float* red = smem;  // [warp][m][kIBlockCols]
#pragma unroll
  for (int m = 0; m < kMTile; ++m)
#pragma unroll
    for (int j = 0; j < kICols; ++j)
      red[(warp * kMTile + m) * kIBlockCols + lane * kICols + j] = acc[m][j];
  __syncthreads();
  reduce_store<kIWarps>(red, kIBlockCols, out, M, N, m0, col0);
}

}  // namespace

extern "C" int qtt_nvfp4_matmul(const void* x, const void* packed, const void* scale, void* out,
                                int M, int K, int N, int g, void* stream) {
  if (M <= 0 || g <= 0 || K % (2 * g) || N % kPCols) return (int)cudaErrorInvalidValue;
  const dim3 grid(N / kPCols, (M + kMTile - 1) / kMTile);
  nvfp4_packed_kernel<<<grid, kPThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const __nv_bfloat16*>(scale), static_cast<__nv_bfloat16*>(out),
      M, K, N, g, segment_rows(g));
  return (int)cudaGetLastError();
}

extern "C" int qtt_nvfp4_i8_matmul(const void* x, const void* w8, const void* scale, void* out,
                                   int M, int K, int N, int g, void* stream) {
  if (M <= 0 || g <= 0 || K % g || N % kIBlockCols) return (int)cudaErrorInvalidValue;
  const dim3 grid(N / kIBlockCols, (M + kMTile - 1) / kMTile);
  nvfp4_i8_kernel<<<grid, kIThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w8),
      static_cast<const __nv_bfloat16*>(scale), static_cast<__nv_bfloat16*>(out),
      M, K, N, g, segment_rows(g));
  return (int)cudaGetLastError();
}
