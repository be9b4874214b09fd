// One-token GQA decode attention over a head-major bf16 KV cache, with the
// new K/V row written into the cache in place (sm_90a).
//
// Replaces quantizers_tpu/ops/kernels.py `_dec_attn_kernel` /
// `_decode_attention_call` (reached through `decode_attention`).
//
// q (B, KV, rep, 128) bf16; new_k / new_v (B, KV, 128); caches
// (B, KV, S, 128), written at row L = min(lengths[b], S - 1); lengths (B,)
// int32. Query head h*rep + r attends positions 0..L of KV head h.
// ctx (B, KV, rep, 128) bf16.
//
// What bounds it on the H100 SXM: bytes, the valid prefix of the cache.
// On the serving path (B 8, KV 8, rep 4, S 512) one call reads
// 8 * 8 * (L + 1) * 128 * 2 * 2 bytes: 8.4 MB at L = 255, 2.5 us at
// 3.35 TB/s.
//
// Design: one block per (row, KV head), one thread per head dimension.
// Positions 0..L go through shared memory in tiles of 64 rows; the scores
// of the rep query heads against a tile, an online softmax and the
// weighted sum of V are all kept in f32. Row L is taken from new_k / new_v,
// never from the cache row this block has just written. Positions past L
// are never loaded: their K and V tiles hold zeros and their scores are
// -inf, so a stale or NaN cache row cannot reach a product.
//
// Left for later: splitting S over blocks (flash-decoding) so that more
// than B * KV SMs stream the cache, cp.async / TMA double buffering of the
// tiles, and 16-byte loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHD = 128;          // head dim (ops/kernels.py DECODE_HEAD_DIM)
constexpr int kMaxRep = 8;        // query heads per KV head (DECODE_MAX_REP)
constexpr int kTP = 64;           // positions per tile
constexpr int kWords = kHD / 2;   // bf16 pairs per row
constexpr int kKStride = kWords + 1;  // padded K row: conflict-free column reads
constexpr int kWarps = kHD / 32;

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

__global__ void __launch_bounds__(kHD)
dec_attn_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ new_k,
                const __nv_bfloat16* __restrict__ new_v, __nv_bfloat16* __restrict__ cache_k,
                __nv_bfloat16* __restrict__ cache_v, const int* __restrict__ lengths,
                __nv_bfloat16* __restrict__ ctx, int KV, int rep, int S, float sm_scale) {
  __shared__ uint32_t ks[kTP * kKStride];
  __shared__ uint32_t vs[kTP * kWords];
  __shared__ float qs[kMaxRep * kHD];
  __shared__ float ps[kMaxRep * kTP];
  __shared__ float m_s[kMaxRep], l_s[kMaxRep], alpha_s[kMaxRep];

  const int bh = blockIdx.x;  // b * KV + h
  const int b = bh / KV;
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int L = max(0, min(lengths[b], S - 1));

  const size_t row0 = (size_t)bh * S * kHD;  // cache (b, h, 0, 0)
  const uint32_t* kc = reinterpret_cast<const uint32_t*>(cache_k + row0);
  const uint32_t* vc = reinterpret_cast<const uint32_t*>(cache_v + row0);
  const uint32_t* nk = reinterpret_cast<const uint32_t*>(new_k + (size_t)bh * kHD);
  const uint32_t* nv = reinterpret_cast<const uint32_t*>(new_v + (size_t)bh * kHD);

  // the in-place write of the new row
  cache_k[row0 + (size_t)L * kHD + t] = new_k[(size_t)bh * kHD + t];
  cache_v[row0 + (size_t)L * kHD + t] = new_v[(size_t)bh * kHD + t];

  for (int r = 0; r < rep; ++r)
    qs[r * kHD + t] = __bfloat162float(q[((size_t)bh * rep + r) * kHD + t]);
  if (t < rep) {
    m_s[t] = -INFINITY;
    l_s[t] = 0.f;
  }
  float acc[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) acc[r] = 0.f;

  for (int p0 = 0; p0 <= L; p0 += kTP) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = t; i < kTP * kWords; i += kHD) {
      const int row = i / kWords, w = i % kWords;
      const int p = p0 + row;
      uint32_t kw = 0u, vw = 0u;
      if (p < L) {
        kw = kc[(size_t)p * kWords + w];
        vw = vc[(size_t)p * kWords + w];
      } else if (p == L) {
        kw = nk[w];
        vw = nv[w];
      }
      ks[row * kKStride + w] = kw;
      vs[row * kWords + w] = vw;
    }
    __syncthreads();

    // scores: rep x kTP entries over kHD threads
    for (int e = t; e < rep * kTP; e += kHD) {
      const int r = e / kTP, p = e % kTP;
      float s = -INFINITY;
      if (p0 + p <= L) {
        const uint32_t* kr = ks + p * kKStride;
        const float* qr = qs + r * kHD;
        float a = 0.f;
#pragma unroll 16
        for (int w = 0; w < kWords; ++w) {
          const float2 kf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(kr + w));
          a = fmaf(qr[2 * w], kf.x, a);
          a = fmaf(qr[2 * w + 1], kf.y, a);
        }
        s = a * sm_scale;
      }
      ps[r * kTP + p] = s;
    }
    __syncthreads();

    // online softmax, one warp per query head; position p0 <= L is always
    // valid, so every tile max is finite
    for (int r = warp; r < rep; r += kWarps) {
      const float s0 = ps[r * kTP + lane], s1 = ps[r * kTP + lane + 32];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float e0 = expf(s0 - m_new), e1 = expf(s1 - m_new);
      ps[r * kTP + lane] = e0;
      ps[r * kTP + lane + 32] = e1;
      const float sum = warp_sum(e0 + e1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // weighted V: thread t owns dimension t
    const __nv_bfloat16* vt = reinterpret_cast<const __nv_bfloat16*>(vs) + t;
    for (int r = 0; r < rep; ++r) {
      const float* pr = ps + r * kTP;
      float a = 0.f;
#pragma unroll 16
      for (int p = 0; p < kTP; ++p) a = fmaf(pr[p], __bfloat162float(vt[p * kHD]), a);
      acc[r] = acc[r] * alpha_s[r] + a;
    }
  }

  for (int r = 0; r < rep; ++r)
    ctx[((size_t)bh * rep + r) * kHD + t] = __float2bfloat16(acc[r] / l_s[r]);
}

}  // namespace

extern "C" int qtt_decode_attention(const void* q, const void* new_k, const void* new_v,
                                    void* cache_k, void* cache_v, const void* lengths,
                                    void* ctx, int B, int KV, int rep, int S, int hd,
                                    float sm_scale, void* stream) {
  if (hd != kHD || rep <= 0 || rep > kMaxRep || B <= 0 || KV <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  dec_attn_kernel<<<B * KV, kHD, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(new_k),
      static_cast<const __nv_bfloat16*>(new_v), static_cast<__nv_bfloat16*>(cache_k),
      static_cast<__nv_bfloat16*>(cache_v), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(ctx), KV, rep, S, sm_scale);
  return (int)cudaGetLastError();
}
