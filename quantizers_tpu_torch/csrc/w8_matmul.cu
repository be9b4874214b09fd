// INT8 weight-only matmul for Hopper (sm_90a): y = x @ W^T, bf16 out.
//
// Replaces quantizers_tpu/ops/kernels.py `_w8_kernel` / `_w8_matmul_2d`.
// Weights int8 (K, N); bf16 or f32 scales per channel (1, N) or per group
// (K/g, N). A per-channel scale is passed as one group of g = K rows. The
// kernel is templated on the scale type: f32 scales (the w8pc expert
// layout's) are read as they are, never rounded to bf16.
// x bf16 (M, K), M <= 512. On the serving path it is the int8 logits head:
// M 8, K 2560, N 152064 (the vocab padded to a multiple of 1536).
//
// What bounds it on the H100 SXM: bytes. The head reads 389 MB of int8
// payload per decode step, 116 us at 3.35 TB/s. At M = 8 it does 8 f32
// FMAs per weight byte on the CUDA cores, close to the card's f32 rate
// for that stream, so operations may bound it before memory does.
//
// Design: one launch per call. A block owns 128 output columns and 8
// activation rows; each lane of a warp owns four columns, so a warp reads
// 128 contiguous bytes of a weight row. A pass covers 8 segments of K rows
// (32 rows at most, inside one group), one per warp. A warp requests all
// the rows of its segment before the pass's barrier, so that their latency
// overlaps the staging of the pass's activations in shared memory as f32. Products are summed per segment
// in f32, then scaled. The 8 warps' sums meet in shared memory and are
// added in a fixed order, so the result does not change from run to run.
//
// Left for later: tensor-core products (int8 x bf16 through mma after an
// in-register conversion), TMA / cp.async weight staging, and folding the
// per-channel scale into the epilogue only.

#include "common.cuh"

namespace {
using namespace qtt;

constexpr int kCols = 4;
constexpr int kBlockCols = 32 * kCols;
constexpr int kWarps = 8;  // each on its own K segment of a pass
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxChunk = kWarps * kMaxSeg;  // K rows per pass
// staged x, later the warps' partial sums: the larger of the two
constexpr int kSmem = kWarps * kMTile * kBlockCols;
static_assert(kSmem >= kMaxChunk * kMTile, "shared buffer");

__device__ __forceinline__ float s8(uint32_t w, int i) {
  return (float)(int8_t)((w >> (8 * i)) & 0xFF);
}

// the four scales of a lane's columns, widened to f32
__device__ __forceinline__ void load_scale4(const __nv_bfloat16* p, float (&sv)[kCols]) {
  const __nv_bfloat162* sp = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 sa = __bfloat1622float2(sp[0]);
  const float2 sb = __bfloat1622float2(sp[1]);
  sv[0] = sa.x; sv[1] = sa.y; sv[2] = sb.x; sv[3] = sb.y;
}

__device__ __forceinline__ void load_scale4(const float* p, float (&sv)[kCols]) {
#pragma unroll
  for (int j = 0; j < kCols; ++j) sv[j] = p[j];
}

template <typename ScaleT>
__global__ void __launch_bounds__(kThreads)
w8_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w8,
          const ScaleT* __restrict__ scale, __nv_bfloat16* __restrict__ out,
          int M, int K, int N, int g, int seg) {
  __shared__ __align__(16) float smem[kSmem];
  float* xs = smem;
  const int chunk = kWarps * seg;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * kMTile;
  const int col0 = blockIdx.x * kBlockCols;
  const int col = col0 + lane * kCols;
  const int s0 = warp * seg;  // this warp's segment of every pass

  float acc[kMTile][kCols];
#pragma unroll
  for (int m = 0; m < kMTile; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0.f;

  for (int c0 = 0; c0 < K; c0 += chunk) {
    const int rows = min(chunk, K - c0);  // a multiple of seg
    const bool mine = s0 < rows;
    // the segment's words are requested first: their latency overlaps the
    // staging of x and the barriers
    const int8_t* wp = w8 + (size_t)(c0 + s0) * N + col;
    uint32_t wr[kMaxSeg];
#pragma unroll
    for (int i = 0; i < kMaxSeg; ++i)
      wr[i] = (mine && i < seg) ? *reinterpret_cast<const uint32_t*>(wp + (size_t)i * N) : 0u;
    __syncthreads();  // the previous pass is done with the staged x
    stage_x(xs, x, M, K, m0, c0, rows);
    __syncthreads();
    if (!mine) continue;
    float part[kMTile][kCols];
#pragma unroll
    for (int m = 0; m < kMTile; ++m)
#pragma unroll
      for (int j = 0; j < kCols; ++j) part[m][j] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxSeg; ++i) {
      if (i >= seg) break;
      const float wv[kCols] = {s8(wr[i], 0), s8(wr[i], 1), s8(wr[i], 2), s8(wr[i], 3)};
      float xv[kMTile];
      load_x8(xs + (s0 + i) * kMTile, xv);
#pragma unroll
      for (int m = 0; m < kMTile; ++m)
#pragma unroll
        for (int j = 0; j < kCols; ++j) part[m][j] = fmaf(xv[m], wv[j], part[m][j]);
    }
    float sv[kCols];
    load_scale4(scale + (size_t)((c0 + s0) / g) * N + col, sv);
#pragma unroll
    for (int m = 0; m < kMTile; ++m)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[m][j] += part[m][j] * sv[j];
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

template <typename ScaleT>
int launch(const void* x, const void* w8, const void* scale, void* out, int M, int K, int N,
           int g, void* stream) {
  if (M <= 0 || g <= 0 || K % g || N % kBlockCols) return (int)cudaErrorInvalidValue;
  const dim3 grid(N / kBlockCols, (M + kMTile - 1) / kMTile);
  w8_kernel<ScaleT><<<grid, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w8),
      static_cast<const ScaleT*>(scale), static_cast<__nv_bfloat16*>(out),
      M, K, N, g, segment_rows(g));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int qtt_w8_matmul(const void* x, const void* w8, const void* scale, void* out,
                             int M, int K, int N, int g, void* stream) {
  return launch<__nv_bfloat16>(x, w8, scale, out, M, K, N, g, stream);
}

// the same with f32 scales
extern "C" int qtt_w8_matmul_f32s(const void* x, const void* w8, const void* scale, void* out,
                                  int M, int K, int N, int g, void* stream) {
  return launch<float>(x, w8, scale, out, M, K, N, g, stream);
}
