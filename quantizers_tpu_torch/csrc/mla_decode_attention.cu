// Absorbed-MLA one-token decode attention over the latent cache, with the
// new latent and rope rows written into the cache in place (sm_90a).
//
// Replaces quantizers_tpu/ops/kernels.py `_mla_dec_kernel` /
// `_mla_decode_call` (reached through `mla_decode_attention`).
//
// q_abs (B, H, r) and q_pe (B, H, dp) bf16: each head's absorbed nope
// query (W_uk^T q_nope) and its rope query padded to dp; new_c (B, r) and
// new_p (B, dp); the caches cache_c (B, 1, S, r) and cache_p (B, 1, S, dp),
// written at row L = min(lengths[b], S - 1); lengths (B,) int32. Every head
// attends positions 0..L of its row's one shared latent row per token:
//   scores[h, s] = (q_abs[h] . C[s] + q_pe[h] . P[s]) * sm_scale  (f32 sums)
//   p = softmax(scores) in f32, rounded to bf16 (as the TPU kernel does)
//   ctx_lat[h] = sum_s p[h, s] * C[s] in f32, rounded to bf16.
//
// What bounds it on the H100 SXM: bytes, the valid prefix of the latent
// cache, read once: on the FP8_BLOCK MLA serving path (B 8, H 16, r 512,
// dp 128, S 512) 8 * (L + 1) * 640 * 2 bytes, 2.0 MB at L = 192, 0.6 us at
// 3.35 TB/s. The call is short enough that its launch bounds it.
//
// Design: one block of 8 warps per (row, head), 128 blocks on the path, so
// the card's SMs stay busy where the TPU kernel's one grid step per row
// would leave 124 of them idle. The 16 blocks of a row read the same
// latent rows: the second and later reads come from the 50 MB L2. Position
// L is always taken from new_c / new_p, never from the cache; only the
// head-0 block of a row writes the new row, so no block reads a row that
// another block writes. Scores: one warp per position, 16-byte loads, the
// latent and rope dot products summed apart in f32 and added, as in the
// TPU kernel. The scores of positions 0..L stay in shared memory (S is at
// most 8192), so the softmax is exact, not online: block max, f32 exp and
// sum, p = bf16(e / sum). The weighted sum gives each thread two latent
// columns and walks the positions in order. Positions past L are never
// read, so stale or NaN rows cannot reach a product.
//
// Left for later: several heads per block (one read of each latent row per
// row of the batch), splitting S over blocks for long caches, cp.async
// staging.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxR = 1024;   // latent width (ops/kernels.py MLA_MAX_RANK)
constexpr int kMaxDP = 256;   // padded rope width (MLA_MAX_ROPE)
constexpr int kMaxS = 8192;   // cache slots (MLA_MAX_SLOTS)

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the dot product of 8 bf16 values (one 16-byte load) with 8 f32 values
__device__ __forceinline__ float dot8(uint4 v, const float* __restrict__ q, float a) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
    a = fmaf(q[2 * i], f.x, a);
    a = fmaf(q[2 * i + 1], f.y, a);
  }
  return a;
}

// one position's score: a warp's lanes over 16-byte chunks of the row
__device__ __forceinline__ float score_of(const bf16* __restrict__ crow,
                                          const bf16* __restrict__ prow,
                                          const float* __restrict__ qa,
                                          const float* __restrict__ qp, int r, int dp,
                                          float sm_scale, int lane) {
  float a = 0.f, p = 0.f;
  for (int c = lane; c < r / 8; c += 32)
    a = dot8(*reinterpret_cast<const uint4*>(crow + 8 * c), qa + 8 * c, a);
  for (int c = lane; c < dp / 8; c += 32)
    p = dot8(*reinterpret_cast<const uint4*>(prow + 8 * c), qp + 8 * c, p);
  return (warp_sum(a) + warp_sum(p)) * sm_scale;
}

__global__ void __launch_bounds__(kThreads)
mla_dec_kernel(const bf16* __restrict__ q_abs, const bf16* __restrict__ q_pe,
               const bf16* __restrict__ new_c, const bf16* __restrict__ new_p,
               bf16* __restrict__ cache_c, bf16* __restrict__ cache_p,
               const int* __restrict__ lengths, bf16* __restrict__ ctx,
               int H, int r, int dp, int S, float sm_scale) {
  __shared__ __align__(16) float qa[kMaxR];
  __shared__ __align__(16) float qp[kMaxDP];
  __shared__ float sc[kMaxS];
  __shared__ float red[kWarps];

  const int h = blockIdx.x, b = blockIdx.y;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int L = max(0, min(lengths[b], S - 1));
  const bf16* nc = new_c + (size_t)b * r;
  const bf16* np = new_p + (size_t)b * dp;
  bf16* cb = cache_c + (size_t)b * S * r;
  bf16* pb = cache_p + (size_t)b * S * dp;

  // the in-place write of the new row, by one block of the row
  if (h == 0) {
    for (int i = t; i < r; i += kThreads) cb[(size_t)L * r + i] = nc[i];
    for (int i = t; i < dp; i += kThreads) pb[(size_t)L * dp + i] = np[i];
  }
  const size_t qrow = (size_t)b * H + h;
  for (int i = t; i < r; i += kThreads) qa[i] = __bfloat162float(q_abs[qrow * r + i]);
  for (int i = t; i < dp; i += kThreads) qp[i] = __bfloat162float(q_pe[qrow * dp + i]);
  __syncthreads();

  // scores of positions 0..L; position L from the new rows
  for (int s = warp; s <= L; s += kWarps) {
    const bool last = s == L;
    const float v = score_of(last ? nc : cb + (size_t)s * r, last ? np : pb + (size_t)s * dp,
                             qa, qp, r, dp, sm_scale, lane);
    if (lane == 0) sc[s] = v;
  }
  __syncthreads();

  // the softmax over 0..L: block max, then f32 exp and sum in a fixed order
  float mx = -INFINITY;
  for (int s = t; s <= L; s += kThreads) mx = fmaxf(mx, sc[s]);
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[w]);
  __syncthreads();  // red is reused below
  float sum = 0.f;
  for (int s = t; s <= L; s += kThreads) {
    const float e = expf(sc[s] - mx);
    sc[s] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  sum = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) sum += red[w];
  for (int s = t; s <= L; s += kThreads)
    sc[s] = __bfloat162float(__float2bfloat16_rn(sc[s] / sum));
  __syncthreads();

  // ctx_lat: each thread owns latent columns 2j, 2j + 1
  for (int j = t; j < r / 2; j += kThreads) {
    float ax = 0.f, ay = 0.f;
#pragma unroll 4
    for (int s = 0; s < L; ++s) {
      const float2 c = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(cb + (size_t)s * r)[j]);
      ax = fmaf(sc[s], c.x, ax);
      ay = fmaf(sc[s], c.y, ay);
    }
    const float2 c = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(nc)[j]);
    ax = fmaf(sc[L], c.x, ax);
    ay = fmaf(sc[L], c.y, ay);
    reinterpret_cast<__nv_bfloat162*>(ctx + qrow * r)[j] = __floats2bfloat162_rn(ax, ay);
  }
}

}  // namespace

extern "C" int qtt_mla_decode_attention(const void* q_abs, const void* q_pe, const void* new_c,
                                        const void* new_p, void* cache_c, void* cache_p,
                                        const void* lengths, void* ctx, int B, int H, int r,
                                        int dp, int S, float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || S > kMaxS || r <= 0 || r % 128 || r > kMaxR ||
      dp <= 0 || dp % 128 || dp > kMaxDP)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(H, B);
  mla_dec_kernel<<<grid, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q_abs), static_cast<const bf16*>(q_pe),
      static_cast<const bf16*>(new_c), static_cast<const bf16*>(new_p),
      static_cast<bf16*>(cache_c), static_cast<bf16*>(cache_p),
      static_cast<const int*>(lengths), static_cast<bf16*>(ctx), H, r, dp, S, sm_scale);
  return (int)cudaGetLastError();
}
