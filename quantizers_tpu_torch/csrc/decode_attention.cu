// One-token GQA decode attention over a head-major bf16 KV cache, with the
// new K/V row written into the cache in place (sm_90a).
//
// Replaces quantizers_tpu/ops/kernels.py `_dec_attn_kernel` /
// `_decode_attention_call` (reached through `decode_attention`).
//
// q (B, KV, rep, 128) bf16; new_k / new_v (B, KV, 128); caches
// (B, KV, S, 128), written at row L = min(lengths[b], S - 1); lengths (B,)
// int32. Query head h*rep + r attends positions 0..L of KV head h, with f32
// scores and sums; p is rounded to bf16 before the value product, as in the
// JAX kernel. ctx (B, KV, rep, 128) bf16.
//
// What bounds it on the H100 SXM: bytes, the valid prefix of the cache.
// One call reads B * KV * (L + 1) * 128 * 2 * 2 bytes: at slice 1's shape
// (B 8, KV 8, rep 4, S 512) 8.4 MB at L = 255, 2.5 us at 3.35 TB/s; at path
// A's (B 8, KV 4, rep 8) 4.2 MB, 1.25 us. The work is too small to fill the
// card by (row, KV head) alone (64 and 32 pairs for 132 SMs), so the time
// is latency: how many copies are in flight and how few steps follow them.
//
// Design:
// - One thread-block cluster of `nsplit` blocks per (KV head h, row b);
//   every block reads lengths[b] and takes an even share of positions
//   0..L, rounded to 16 rows, so a block's work follows L, not S. The grid
//   depends on (B, KV, S) alone (nothing of L is read on the host).
//   nsplit is the fewest blocks (a power of two, at most 8, the portable
//   cluster limit) that put a block on every SM: 4 at slice 1's shape (256
//   blocks), 8 at path A's (256). Measured on an H100 80GB HBM3 at 700 W
//   (device time, every row at L 255): slice 1 0.0069-0.0072 ms at nsplit
//   4 against 0.0071-0.0075 at 8 and 0.0076 at 2; path A 0.0060 at 8 and
//   at 4, 0.0078 at 2; a full 2048-slot cache at slice 1's heads (L 2047)
//   0.0259 at 4 against 0.0267 at 8.
// - Each of a block's kWarps warps takes every kWarps-th 16-position chunk
//   of the share and stages it alone: a ring of kStages chunks of K and V
//   (16 rows x 256 bytes each), filled by 16-byte cp.async copies, the next
//   chunk in flight while one is computed; a warp waits on its own copies
//   (no block barrier in the loop). Rows past the share or past L are
//   zero-filled without a read, so a stale or NaN row never reaches a
//   product; row L is copied from new_k / new_v, never from the cache row
//   written in place (by the one block whose share holds L).
// - Products on the tensor cores, mma.sync m16n8k16 with f32 sums: scores
//   q k^T with q's rep rows (zero-padded to 16) as A and K through ldmatrix;
//   the values as ctx^T = V^T p^T, with V^T through ldmatrix.trans as A and
//   p, scaled and exponentiated (ex2.approx of a product with log2 e)
//   against the warp's running max, packed to bf16 straight from the score
//   fragment as B. Rows of a chunk are stored 16-byte piece c at slot
//   c ^ (row % 8), so both ldmatrix reads are free of bank conflicts.
// - The combine is pushed inside the cluster, in the same launch: rank r
//   owns ctx columns [r, r + 1) * 128 / nsplit of every query head; each
//   warp stores its f32 partial sums of those columns and its (m, l) pairs
//   into the owner's shared memory with st.async (splitk.cuh's pattern),
//   and the owner adds the nsplit * kWarps partials in a fixed order,
//   each rescaled by 2^(m - M), so repeated calls give the same bits. An
//   empty share sends m = -inf, l = 0, acc = 0; rank 0 always holds
//   position 0, so M is finite.

#include <math.h>

#include "splitk.cuh"

namespace {

using qtt::aligned16;

typedef __nv_bfloat16 bf16;

constexpr int kHD = 128;        // head dim (ops/kernels.py DECODE_HEAD_DIM)
constexpr int kMaxRep = 8;      // query heads per KV head (DECODE_MAX_REP)
constexpr int kChunk = 16;      // positions a warp computes at a time
// 2 warps a block and a ring of 2 chunks a warp: on the same H100 at slice
// 1's shape and nsplit 8, 4 warps took 0.0134 ms (0.0075 with 2) and a ring
// of 3 0.0095 (fewer blocks fit an SM); a diagnostic with no products (the
// copies and the combine) took 0.0070, and at nsplit 4 one with no copies
// either (the launch, the cluster barrier and the combine) 0.0035
constexpr int kWarps = 2;       // warps a block
constexpr int kStages = 2;      // chunks in each warp's ring
constexpr int kRowBytes = kHD * 2;
constexpr int kTileBytes = kChunk * kRowBytes;  // one chunk of K (or V)
constexpr int kStageBytes = 2 * kTileBytes;     // K, then V
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

// bytes of dynamic shared memory: the rings, the partial sums a rank owns
// (kWarps * nsplit partials of 128 / nsplit columns x 8 query heads, f32),
// the (m, l) pairs of every partial and query head, one mbarrier
constexpr int kRingBytes = kWarps * kStages * kStageBytes;
constexpr int kRedBytes = kWarps * kHD * kMaxRep * 4;
constexpr int kMlBytes = qtt::kMaxSplit * kWarps * kMaxRep * 8;
constexpr int kSmemBytes = kRingBytes + kRedBytes + kMlBytes + 8;

// 2^x (ex2.approx: 2 ulp; -inf gives 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The row this lane addresses in an ldmatrix x4 of a staged chunk, and its
// byte offset: matrices (rows 0-7, piece c0), (0-7, c0 + 1), (8-15, c0),
// (8-15, c0 + 1), each row's piece c at slot c ^ (row % 8).
__device__ __forceinline__ int frag_off(int lane, int c0) {
  const int row = ((lane >> 4) << 3) | (lane & 7);
  const int c = c0 + ((lane >> 3) & 1);
  return row * kRowBytes + ((c ^ (lane & 7)) << 4);
}

__global__ void __launch_bounds__(kThreads)
dec_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ new_k,
                const bf16* __restrict__ new_v, bf16* __restrict__ cache_k,
                bf16* __restrict__ cache_v, const int* __restrict__ lengths,
                bf16* __restrict__ ctx, int KV, int rep, int S, float c) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* red = reinterpret_cast<float*>(smem + kRingBytes);
  float2* ml = reinterpret_cast<float2*>(smem + kRingBytes + kRedBytes);
  uint64_t* reduced = reinterpret_cast<uint64_t*>(smem + kRingBytes + kRedBytes + kMlBytes);

  const int h = blockIdx.x, b = blockIdx.y, nsplit = gridDim.z, rank = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int cols = kHD / nsplit;  // ctx columns this rank owns
  // every partial's sums of this rank's columns, and its (m, l) pairs
  qtt::push_init(reduced, kWarps * (kHD * kMaxRep * 4 + nsplit * kMaxRep * 8));

  const int L = max(0, min(lengths[b], S - 1));
  const int n = L + 1;
  const int share = ((n + nsplit - 1) / nsplit + kChunk - 1) / kChunk * kChunk;
  const int p_lo = rank * share, p_hi = min(p_lo + share, n);
  const size_t bh = (size_t)b * KV + h;
  const bf16* nk = new_k + bh * kHD;
  const bf16* nv = new_v + bh * kHD;
  bf16* kc = cache_k + bh * S * kHD;
  bf16* vc = cache_v + bh * S * kHD;

  // the in-place write of the new row, by the block whose share holds L
  if (warp == 0 && L >= p_lo && L < p_hi) {
    const uint4* src = reinterpret_cast<const uint4*>(lane < 16 ? nk : nv);
    uint4* dst = reinterpret_cast<uint4*>((lane < 16 ? kc : vc) + (size_t)L * kHD);
    dst[lane & 15] = src[lane & 15];
  }

  // this warp's chunks of the share: warp, warp + kWarps, ...
  const int chunks = p_hi > p_lo ? (p_hi - p_lo + kChunk - 1) / kChunk : 0;
  const int mine = chunks > warp ? (chunks - warp + kWarps - 1) / kWarps : 0;
  uint8_t* ring = smem + warp * kStages * kStageBytes;
  auto load = [&](int i) {
    if (i < mine) {
      const int p0 = p_lo + kChunk * (warp + kWarps * i);
      uint8_t* st = ring + (i % kStages) * kStageBytes;
#pragma unroll
      for (int j = 0; j < kChunk * kRowBytes / 16 / 32; ++j) {
        const int idx = lane + 32 * j, r = idx / 16, pc = idx % 16;
        const int p = p0 + r;
        const bool valid = p < p_hi;
        const size_t row = (size_t)(valid ? p : 0) * kHD;
        const bf16* ks = (p == L ? nk : kc + row) + 8 * pc;
        const bf16* vs = (p == L ? nv : vc + row) + 8 * pc;
        const int off = r * kRowBytes + ((pc ^ (r & 7)) << 4);
        qtt::cp_async16(st + off, ks, valid);
        qtt::cp_async16(st + kTileBytes + off, vs, valid);
      }
    }
    qtt::cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load(i);

  // q as the A fragments of the scores: rows gid < rep, rows 8-15 zero
  uint32_t qa[kHD / 16][2];
  {
    const bf16* qr = q + (bh * rep + (gid < rep ? gid : 0)) * kHD + 2 * tig;
#pragma unroll
    for (int kk = 0; kk < kHD / 16; ++kk) {
      qa[kk][0] = gid < rep ? *reinterpret_cast<const uint32_t*>(qr + 16 * kk) : 0u;
      qa[kk][1] = gid < rep ? *reinterpret_cast<const uint32_t*>(qr + 16 * kk + 8) : 0u;
    }
  }

  // o[i16]: ctx^T rows (columns of ctx) 16i + gid (c0, c1) and 16i + gid + 8
  // (c2, c3), query heads 2 tig (c0, c2) and 2 tig + 1 (c1, c3); m, l: the
  // running max (in units of c) and this lane's share of the sum, query
  // head gid
  float o[kHD / 16][4] = {};
  float m = -INFINITY, l = 0.f;
  for (int i = 0; i < mine; ++i) {
    load(i + kStages - 1);
    qtt::cp_async_wait<kStages - 1>();
    __syncwarp();
    const uint8_t* st = ring + (i % kStages) * kStageBytes;
    const int p0 = p_lo + kChunk * (warp + kWarps * i);

    // s[j]: query head gid, positions p0 + 8j + 2 tig and + 1 (c0, c1)
    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < kHD / 16; ++kk) {
      uint32_t kb[4];
      qtt::ldmatrix_x4(kb, st + frag_off(lane, 2 * kk));
      const uint32_t a[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
      qtt::mma_bf16(s[0], a, kb[0], kb[1]);
      qtt::mma_bf16(s[1], a, kb[2], kb[3]);
    }
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + 8 * (e / 2) + 2 * tig + (e % 2);
      x[e] = p < p_hi ? s[e / 2][e % 2] * c : -INFINITY;
    }
    // position p0 is valid, so every row's max is finite
    float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = exp2_approx(m - m_new);  // 0 on the first chunk
    m = m_new;
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = exp2_approx(x[e] - m_new);
    l = l * alpha + ((p[0] + p[1]) + (p[2] + p[3]));
    const uint32_t pb0 = qtt::pack_bf16(p[0], p[1]), pb1 = qtt::pack_bf16(p[2], p[3]);
    // the rescale of query heads 2 tig and 2 tig + 1 (lanes 8 tig, 8 tig + 4)
    const float a0 = __shfl_sync(0xffffffffu, alpha, 8 * tig);
    const float a1 = __shfl_sync(0xffffffffu, alpha, 8 * tig + 4);
#pragma unroll
    for (int i16 = 0; i16 < kHD / 16; ++i16) {
      o[i16][0] *= a0;
      o[i16][1] *= a1;
      o[i16][2] *= a0;
      o[i16][3] *= a1;
      uint32_t va[4];
      qtt::ldmatrix_x4_trans(va, st + kTileBytes + frag_off(lane, 2 * i16));
      qtt::mma_bf16(o[i16], va, pb0, pb1);
    }
    __syncwarp();  // the stage is free for the next copy
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);

  // push: ctx column d of query head qh goes to rank d / cols, at slot
  // (partial, d % cols, qh) of its `red`; (m, l) of head gid to every rank
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const int part = rank * kWarps + warp;
#pragma unroll
  for (int i16 = 0; i16 < kHD / 16; ++i16)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int d = 16 * i16 + gid + 8 * hh;
      const int owner = d / cols;
      float* slot = red + (part * cols + d - owner * cols) * kMaxRep + 2 * tig;
      qtt::st_async_f32x2(qtt::map_rank(slot, owner), o[i16][2 * hh], o[i16][2 * hh + 1],
                          qtt::map_rank(reduced, owner));
    }
  if (tig == 0)
    for (int r = 0; r < nsplit; ++r)
      qtt::st_async_f32x2(qtt::map_rank(ml + part * kMaxRep + gid, r), m, l,
                          qtt::map_rank(reduced, r));

  // the owner's columns, partials added in a fixed order
  qtt::mbar_wait(reduced, 0);
  const int parts = nsplit * kWarps;
  for (int j = threadIdx.x; j < cols * rep; j += kThreads) {
    const int dl = j / rep, qh = j % rep;
    float M = -INFINITY;
    for (int pp = 0; pp < parts; ++pp) M = fmaxf(M, ml[pp * kMaxRep + qh].x);
    float sum = 0.f, lsum = 0.f;
    for (int pp = 0; pp < parts; ++pp) {
      const float2 v = ml[pp * kMaxRep + qh];
      const float w = exp2_approx(v.x - M);
      lsum += v.y * w;
      sum += red[(pp * cols + dl) * kMaxRep + qh] * w;
    }
    ctx[(bh * rep + qh) * kHD + rank * cols + dl] = __float2bfloat16(sum / lsum);
  }
}

qtt::DeviceOnce once;

}  // namespace

extern "C" int qtt_decode_attention(const void* q, const void* new_k, const void* new_v,
                                    void* cache_k, void* cache_v, const void* lengths,
                                    void* ctx, int B, int KV, int rep, int S, int hd,
                                    float sm_scale, void* stream) {
  if (hd != kHD || rep <= 0 || rep > kMaxRep || B <= 0 || KV <= 0 || S <= 0 || S % 8 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  // rows are copied 16 bytes at a time: every base must be 16-byte aligned
  if (!aligned16(q) || !aligned16(new_k) || !aligned16(new_v) || !aligned16(cache_k) ||
      !aligned16(cache_v) || !aligned16(ctx))
    return (int)cudaErrorMisalignedAddress;
  // launch_split's rule, not limited by S: the fewest ranks that put a
  // block on every SM
  return qtt::launch_split(once, dec_attn_kernel, KV, B, kThreads, kSmemBytes,
                           4 * qtt::kMaxSplit, false, reinterpret_cast<cudaStream_t>(stream),
                           static_cast<const bf16*>(q), static_cast<const bf16*>(new_k),
                           static_cast<const bf16*>(new_v), static_cast<bf16*>(cache_k),
                           static_cast<bf16*>(cache_v), static_cast<const int*>(lengths),
                           static_cast<bf16*>(ctx), KV, rep, S, sm_scale * kLog2e);
}
