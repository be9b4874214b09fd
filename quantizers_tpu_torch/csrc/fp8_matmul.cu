// FP8 E4M3 weight-only matmul with 128 x 128 block scales for Hopper
// (sm_90a): y = x @ W^T, bf16 out.
//
// Replaces quantizers_tpu/ops/kernels.py `_fp8_kernel` / `_fp8_matmul_2d`
// (reached through `fp8_matmul`).
//
// x bf16 (M, K), M <= 512; w float8_e4m3fn (K, N); s f32 (K/128, N/128),
// read as that grid (the TPU kernel expands it along N only for its
// tiling); out bf16 (M, N). 128 | K and 128 | N. Each weight is decoded to
// f32, multiplied by its block's scale and rounded to bf16, exactly where
// the TPU kernel and the reference dequantize round it; the products with
// x (bf16 x bf16, exact in f32) are summed in f32.
//
// What bounds it on the H100 SXM: bytes. On the FP8_BLOCK MLA serving path
// (M 8, DeepSeek-V2-Lite attention with the 8192-wide dense MLP) a decoder
// layer's four calls read 60.8 MB of fp8 weights, 18.2 us at 3.35 TB/s.
// The activations are bf16, so the FP8 tensor cores (which need both
// operands in E4M3) do not apply: that waits for dynamic FP8 activations.
//
// Design: the w8 kernel's, one launch per call. A block owns 128 output
// columns, exactly one column of scale blocks, and 8 activation rows; each
// lane owns four columns, so a warp reads 128 contiguous bytes of a weight
// row. A pass covers 512 K rows: each of the 8 warps requests its 64 rows
// (inside one 128-row scale block, so one scale per warp and pass) before
// the pass's barrier, which keeps 64 KB of weights in flight per block.
// Four codes decode in two hardware E4M3x2 -> f16x2 conversions (exact);
// the scaled pair rounds to bf16 in one conversion. The 8 warps' sums
// meet in shared memory and are added in a fixed order, so the result
// does not change from run to run.
//
// Left for later: mma.sync / wgmma products for M > 16, TMA staging, and
// more blocks for the narrow calls (N 2048 makes 16 blocks for 132 SMs).

#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "common.cuh"

namespace {
using namespace qtt;

constexpr int kCols = 4;
constexpr int kBlockCols = 32 * kCols;  // = the scale block's 128 columns
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSeg = 64;                 // K rows of one warp per pass
constexpr int kChunk = kWarps * kSeg;    // K rows per pass
constexpr int kScaleBlock = 128;
static_assert(kScaleBlock % kSeg == 0, "a warp segment stays inside one scale block");
constexpr int kSmem = kWarps * kMTile * kBlockCols;  // floats: the larger use
static_assert(kSmem >= kChunk * kMTile, "shared buffer");

// two E4M3 codes (low byte first) as floats, exactly
__device__ __forceinline__ float2 e4m3x2(uint32_t two) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(two & 0xFFFFu),
                                                   __NV_E4M3);
  return __half22float2(__half2(h));
}

// s * (a, b) rounded to bf16 and widened again
__device__ __forceinline__ float2 scaled_bf16(float2 v, float s) {
  return __bfloat1622float2(__float22bfloat162_rn(make_float2(v.x * s, v.y * s)));
}

__global__ void __launch_bounds__(kThreads)
fp8_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
           const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
           int M, int K, int N) {
  __shared__ __align__(16) float smem[kSmem];
  float* xs = smem;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * kMTile;
  const int col0 = blockIdx.x * kBlockCols;
  const int col = col0 + lane * kCols;
  const int s0 = warp * kSeg;  // this warp's segment of every pass
  const int n_sblocks = N / kScaleBlock;

  float acc[kMTile][kCols];
#pragma unroll
  for (int m = 0; m < kMTile; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0.f;

  for (int c0 = 0; c0 < K; c0 += kChunk) {
    const int rows = min(kChunk, K - c0);  // a multiple of 128, so of kSeg
    const bool mine = s0 < rows;
    const uint8_t* wp = w + (size_t)(c0 + s0) * N + col;
    uint32_t wr[kSeg];
#pragma unroll
    for (int i = 0; i < kSeg; ++i)
      wr[i] = mine ? *reinterpret_cast<const uint32_t*>(wp + (size_t)i * N) : 0u;
    __syncthreads();  // the previous pass is done with the staged x
    stage_x(xs, x, M, K, m0, c0, rows);
    __syncthreads();
    if (!mine) continue;
    const float s = scale[(size_t)((c0 + s0) / kScaleBlock) * n_sblocks + blockIdx.x];
#pragma unroll  // whole: wr[] stays in registers
    for (int i = 0; i < kSeg; ++i) {
      const float2 w01 = scaled_bf16(e4m3x2(wr[i]), s);
      const float2 w23 = scaled_bf16(e4m3x2(wr[i] >> 16), s);
      const float wv[kCols] = {w01.x, w01.y, w23.x, w23.y};
      float xv[kMTile];
      load_x8(xs + (s0 + i) * kMTile, xv);
#pragma unroll
      for (int m = 0; m < kMTile; ++m)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[m][j] = fmaf(xv[m], wv[j], acc[m][j]);
    }
  }
  __syncthreads();  // every warp is done with the staged x: reuse it
  float* red = smem;  // [warp][m][kBlockCols]
#pragma unroll
  for (int m = 0; m < kMTile; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      red[(warp * kMTile + m) * kBlockCols + lane * kCols + j] = acc[m][j];
  __syncthreads();
  reduce_store<kWarps>(red, kBlockCols, out, M, N, m0, col0);
}

}  // namespace

extern "C" int qtt_fp8_matmul(const void* x, const void* w, const void* scale, void* out,
                              int M, int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || K % kScaleBlock || N % kBlockCols) return (int)cudaErrorInvalidValue;
  const dim3 grid(N / kBlockCols, (M + kMTile - 1) / kMTile);
  fp8_kernel<<<grid, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), M, K, N);
  return (int)cudaGetLastError();
}
