// W4A16 weight-only matmul for Hopper (sm_90a): y = x @ W^T, bf16 out.
//
// Replaces quantizers_tpu/ops/kernels.py `_w4_kernel` / `_w4_matmul_2d` (the
// packed-uint8 layout) and `_w4i_kernel` / `_w4i_matmul_2d` (the TPU's
// signed-int4 relayout of the same weights). There is no int4 compute type
// on this side, so one kernel reads the at-rest packed bytes directly.
//
// Layout: packed uint8 (K/2, N), split-half: the low nibble of row p is
// W[p, n] + 8 (group p / g), the high nibble W[K/2 + p, n] + 8 (group
// (K/2 + p) / g). Scales bf16 (K/g, N). x bf16 (M, K), M <= 512.
//
// What bounds it on the H100 SXM: bytes. The weights are read once per M
// tile of 8 rows; at decode (M = 8) the fused qkv call (K 2560, N 6144)
// reads 7.9 MB of payload plus 1.0 MB of scales, 2.6 us at 3.35 TB/s.
// This simple design does its arithmetic on the CUDA cores in f32: 8 FMAs
// per weight at M = 8, which asks more FMAs per second than the card's f32
// rate for the bytes it streams, so it is bound by those operations before
// it reaches the memory bound.
//
// Design: one launch per call. A block owns 32 output columns and 8
// activation rows; each lane of a warp owns one column, so a warp reads 32
// contiguous bytes (one sector) of a packed row. A pass covers 16 segments
// of K rows (32 rows each for g = 32), one per warp, so each column's K
// range is shared by the block's 16 warps without leaving the block. A
// warp requests all the bytes of its segment before the pass's barrier, so
// that their latency overlaps the staging of the pass's activations in
// shared memory as f32 (two planes: K rows p and K/2 + p). Each nibble becomes a signed value in registers; products are
// summed per segment in f32 and the group scale is applied to the
// segment's sum. At the end the 8 warps' sums meet in shared memory and are
// added in a fixed order, so the result does not change from run to run.
//
// Left for later: tensor-core products (mma with the nibbles converted to
// bf16 in registers), TMA / cp.async staging of the weights, more blocks
// for the small-N calls (o_proj and down make 80 blocks for 132 SMs), and
// a Hopper-specific relayout of the payload (the counterpart of the TPU's
// i4_device_layout).

#include "common.cuh"

namespace {
using namespace qtt;

constexpr int kBlockCols = 32;  // one column per lane
constexpr int kWarps = 16;      // each on its own K segment of a pass
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxChunk = kWarps * kMaxSeg;  // K rows (of each plane) per pass
static_assert(2 * kMaxChunk * kMTile >= kWarps * kMTile * kBlockCols, "shared buffer");

__global__ void __launch_bounds__(kThreads)
w4_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
          const __nv_bfloat16* __restrict__ scale, __nv_bfloat16* __restrict__ out,
          int M, int K, int N, int g, int seg) {
  // staged x (two planes), later the warps' partial sums
  __shared__ __align__(16) float smem[2 * kMaxChunk * kMTile];
  float* xs_lo = smem;
  float* xs_hi = smem + kMaxChunk * kMTile;
  const int half = K / 2;
  const int chunk = kWarps * seg;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * kMTile;
  const int col0 = blockIdx.x * kBlockCols;
  const int col = col0 + lane;
  const int s0 = warp * seg;  // this warp's segment of every pass

  float acc[kMTile];
#pragma unroll
  for (int m = 0; m < kMTile; ++m) acc[m] = 0.f;

  for (int c0 = 0; c0 < half; c0 += chunk) {
    const int rows = min(chunk, half - c0);  // a multiple of seg
    const bool mine = s0 < rows;
    // the segment's bytes are requested first: their latency overlaps the
    // staging of x and the barriers
    const uint8_t* wp = packed + (size_t)(c0 + s0) * N + col;
    uint32_t wb[kMaxSeg];
#pragma unroll
    for (int i = 0; i < kMaxSeg; ++i) wb[i] = (mine && i < seg) ? wp[(size_t)i * N] : 0u;
    __syncthreads();  // the previous pass is done with the staged x
    stage_x(xs_lo, x, M, K, m0, c0, rows);
    stage_x(xs_hi, x, M, K, m0, half + c0, rows);
    __syncthreads();
    if (!mine) continue;
    float lo[kMTile], hi[kMTile];
#pragma unroll
    for (int m = 0; m < kMTile; ++m) lo[m] = hi[m] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxSeg; ++i) {
      if (i >= seg) break;
      // low nibble: K row c0 + s0 + i; high nibble: K row half + c0 + s0 + i
      const float l = (float)((int)(wb[i] & 0xF) - 8);
      const float h = (float)((int)(wb[i] >> 4) - 8);
      float xl[kMTile], xh[kMTile];
      load_x8(xs_lo + (s0 + i) * kMTile, xl);
      load_x8(xs_hi + (s0 + i) * kMTile, xh);
#pragma unroll
      for (int m = 0; m < kMTile; ++m) {
        lo[m] = fmaf(xl[m], l, lo[m]);
        hi[m] = fmaf(xh[m], h, hi[m]);
      }
    }
    // a segment lies in one group of each plane (seg divides g, g divides K/2)
    const float sl = __bfloat162float(scale[(size_t)((c0 + s0) / g) * N + col]);
    const float sh = __bfloat162float(scale[(size_t)((half + c0 + s0) / g) * N + col]);
#pragma unroll
    for (int m = 0; m < kMTile; ++m) acc[m] += lo[m] * sl + hi[m] * sh;
  }
  __syncthreads();  // every warp is done with the staged x: reuse it
  float* red = smem;  // [warp][m][kBlockCols]
#pragma unroll
  for (int m = 0; m < kMTile; ++m) red[(warp * kMTile + m) * kBlockCols + lane] = acc[m];
  __syncthreads();
  reduce_store<kWarps>(red, kBlockCols, out, M, N, m0, col0);
}

}  // namespace

extern "C" int qtt_w4_matmul(const void* x, const void* packed, const void* scale, void* out,
                             int M, int K, int N, int g, void* stream) {
  if (M <= 0 || g <= 0 || K % (2 * g) || N % kBlockCols) return (int)cudaErrorInvalidValue;
  const dim3 grid(N / kBlockCols, (M + kMTile - 1) / kMTile);
  w4_kernel<<<grid, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const __nv_bfloat16*>(scale), static_cast<__nv_bfloat16*>(out),
      M, K, N, g, segment_rows(g));
  return (int)cudaGetLastError();
}

extern "C" const char* qtt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
