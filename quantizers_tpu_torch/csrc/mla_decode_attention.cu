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
// What bounds it on the H100 SXM: latency, not bytes. On the FP8_BLOCK MLA
// serving path (B 8, H 16, r 512, dp 128, S 512) a call reads the valid
// prefix of the latent cache once, 8 * (L + 1) * 640 * 2 bytes: 2.0 MB at L
// 192 (0.68 us at 3.35 TB/s), 5.3 MB at L 511 (1.66 us). There are only 8
// (row, head tile) pairs for 132 SMs, so a call is the launch, one round of
// copies and a few dependent steps after them.
//
// Design (K2's skeleton, decode_attention.cu, with the heads as the MMA
// rows):
// - One block carries 16 heads of a row as the 16 A rows of mma.sync
//   m16n8k16 (heads in tiles of 16, zero rows past H), so each latent row
//   is read once per (row, head tile), not once per head.
// - One thread-block cluster of `nsplit` blocks per (head tile, row);
//   every block reads lengths[b] and takes an even share of positions
//   0..L, rounded to 16 rows, so a block's work follows L, not S, and the
//   grid depends on the shapes alone. nsplit is splitk.cuh's rule with no
//   stage limit: the fewest ranks (a power of two, at most 8) that put a
//   block on every SM, 8 at the path's shape (64 blocks, one an SM: each
//   takes 126 KB of shared memory).
// - Chunks of 16 positions x (r + dp) are staged by TMA, as boxes of 16
//   rows x 64 columns in the 128-byte swizzle (one box a lane of warp 0,
//   one mbarrier a stage), into a ring of up to 4 chunks, the deepest that
//   fits (3 at r 1024, dp 256). A box reads whatever rows follow the share
//   (stale ones, NaN included, or the next row's): their scores are set to
//   -inf and their rows zeroed in the value product's B fragments, so no
//   such row reaches a sum. Row L is patched in shared memory from new_c /
//   new_p once its chunk has landed, never taken from the cache row that
//   the block of head tile 0 holding L writes in place.
// - The depth r + dp is split over the block's W warps (8 at the path's
//   shape): warp w owns latent columns [w, w + 1) * r / W and a run of the
//   16-column rope steps. Scores on the tensor cores: each warp's partial
//   16 x 16 tile over its depth, q's A fragments held in registers, the B
//   fragments through ldmatrix; the W partials of each score are added in
//   warp order by one thread (two block barriers a chunk), so every warp
//   holds the same scores, running max and sum.
// - The softmax is K2's online one: p = 2^(s c - m), c =
//   sm_scale log2 e, against the running max m of the block's share,
//   packed to bf16 straight from the score fragment as the A operand of
//   the value product (FlashAttention-2's register reuse); C's rows through
//   ldmatrix.trans as B, into the warp's 16 x (its columns) f32 sums. The
//   rescale 2^(m_old - m_new) is a per-row factor of the accumulator (its
//   rows are the heads), so it needs no shuffle. The JAX kernel's exact
//   order (scores kept for the share, the max and sum
//   exchanged over the cluster, p = bf16(e / l) formed once) was not built:
//   the online one meets the 2e-2 limit (0.37 of it at the path's shape,
//   as K2), and a one-hot p reads out C[j] bit for bit either way.
// - The combine is pushed inside the cluster, in the same launch: rank q
//   owns ctx columns [q, q + 1) * r / nsplit of every head of the tile;
//   each warp stores its f32 sums of those columns, and warp 0 the block's
//   (m, l) pairs, into the owner's shared memory with st.async (splitk.cuh's
//   pattern); the owner adds the nsplit partials in a fixed order, each
//   rescaled by 2^(m - M), so repeated calls give the same bits. An empty
//   share sends m = -inf, l = 0, sums 0; rank 0 always holds position 0, so
//   M is finite.
//
// Measured on an H100 80GB HBM3 at 700 W (device time of one call at the
// path's shape, every row at L 192 / L 511; the first port, one block a
// (row, head) with serial walks, 0.0436-0.0459 / 0.1179-0.1219):
// - 4 warps of 128 columns, each staging its own columns by 16-byte
//   cp.async into a ring of 2: 0.0134 / 0.0217-0.0220; 8 warps of 64
//   columns 0.0102-0.0103 / 0.0157-0.0159;
// - one bulk copy a row (cp.async.bulk) and a ring of up to 4: 0.0094-
//   0.0098 / 0.0150-0.0153; TMA boxes (kept): 0.0088-0.0089 / 0.0136-0.0139;
// - lost: 16 ranks a cluster (non-portable; only 7 clusters of 16 fit at
//   once, so 8 take two waves: 0.0163 / 0.0203-0.0220), 16-byte or bulk
//   DSMEM pushes, a pull of the partials over DSMEM (0.0093 / 0.0139-
//   0.0142), 32-row chunks (0.0098 / 0.0129), every fragment loaded
//   before the products (0.0094 / 0.0134);
// - where the time goes (%globaltimer stamps, L 192): lengths[b] known at
//   1.0 us, the copies under way by 2.3, each 16-row chunk's products,
//   barriers and softmax 1.3 us, the pushes 1.8 us, the combine 0.8 us; a
//   cache read from L2 (one cache reused) is within 6% of one read from
//   device memory, so neither the bytes nor the TLB bound it.
//
// Left for later: slots past 8192 (the kernel keeps nothing S-sized; the
// cap is the wrapper's), the per-chunk steps (two block barriers and the
// mma.sync chains of a 16-row chunk), and the push of 32 KB a block over
// DSMEM.

#include <math.h>

#include "splitk.cuh"

namespace {

using qtt::aligned16;

typedef __nv_bfloat16 bf16;

constexpr int kHeads = 16;      // heads a block: the A rows of mma.sync m16n8k16
constexpr int kChunk = 16;      // positions a step
constexpr int kLat = 64;        // most latent columns a warp owns
constexpr int kRopeSteps = 4;   // most 16-column rope steps a warp owns
constexpr int kMaxStages = 4;   // most chunks in the ring
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block can have
constexpr int kMaxR = 1024;     // latent width (ops/kernels.py MLA_MAX_RANK)
constexpr int kMaxDP = 256;     // padded rope width (MLA_MAX_ROPE)
constexpr int kMaxS = 8192;     // cache slots (MLA_MAX_SLOTS)
constexpr int kMaxWarps = kMaxR / kLat > kMaxDP / (16 * kRopeSteps)
                              ? kMaxR / kLat : kMaxDP / (16 * kRopeSteps);
constexpr int kRanks = qtt::kMaxSplit;  // most blocks of a cluster
constexpr float kLog2e = 1.4426950408889634f;

// The warps of a block for latent width r and rope width dp: enough that
// none owns more than kLat latent columns or kRopeSteps rope steps.
__host__ __device__ __forceinline__ int warps_for(int r, int dp) {
  const int a = r / kLat, b = dp / (16 * kRopeSteps);
  return a > b ? a : b;
}

// Dynamic shared memory: room to align the ring to 1024 bytes, the ring of
// `stages` chunks (16 rows of r + dp bf16 each), the score partials (W x
// 256 f32) and their sums (256 f32), the partial sums a rank receives
// (kHeads x r f32, whatever nsplit), the (m, l) pairs of every rank and
// head, the combine's mbarrier and one a stage.
static inline int smem_bytes(int r, int dp, int stages) {
  return 1024 + stages * kChunk * (r + dp) * 2 + (warps_for(r, dp) + 1) * 256 * 4 +
         kHeads * r * 4 + kRanks * kHeads * 8 + 8 * (1 + kMaxStages);
}

// The deepest ring (at most kMaxStages chunks) that fits a block.
static inline int ring_stages(int r, int dp) {
  int stages = kMaxStages;
  while (stages > 2 && smem_bytes(r, dp, stages) > kSmemLimit) --stages;
  return stages;
}

// 2^x (ex2.approx: 2 ulp; -inf gives 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of 16-byte piece c (columns 8c..8c + 7 of the [C | P] row)
// of staged row `row`: a chunk is stored as TMA boxes of 16 rows x 64
// columns, one 128-byte line a row, in the 128-byte swizzle (piece c % 8 of
// a line at slot (c % 8) ^ (row % 8)), so the 8 rows of an ldmatrix matrix
// fall in 8 distinct 4-bank groups, for the plain and the transposed read.
__device__ __forceinline__ int piece_off(int row, int c) {
  return (c >> 3) * (kChunk * 128) + row * 128 + (((c & 7) ^ (row & 7)) << 4);
}

// This lane's row address in an ldmatrix x4 of a staged chunk: matrices
// (positions 0-7, piece c0), (0-7, c0 + 1), (8-15, c0), (8-15, c0 + 1), the
// B fragments of the scores' two n8 tiles of positions.
__device__ __forceinline__ int k_off(int lane, int c0) {
  return piece_off(((lane >> 4) << 3) | (lane & 7), c0 + ((lane >> 3) & 1));
}

// ... and in an ldmatrix x4 .trans: matrices (positions 0-7, piece c0),
// (8-15, c0), (0-7, c0 + 1), (8-15, c0 + 1), the B fragments of the value
// product's two n8 tiles of latent columns.
__device__ __forceinline__ int v_off(int lane, int c0) {
  return piece_off((((lane >> 3) & 1) << 3) | (lane & 7), c0 + (lane >> 4));
}

// Two bf16 of row h (zero past H) of a (B, H, width) query at column k.
__device__ __forceinline__ uint32_t q_pair(const bf16* __restrict__ q, int b, int h, int H,
                                           int width, int k) {
  return h < H ? *reinterpret_cast<const uint32_t*>(q + ((size_t)b * H + h) * width + k) : 0u;
}

__global__ void __launch_bounds__(32 * kMaxWarps)
mla_dec_kernel(const __grid_constant__ CUtensorMap map_c, const __grid_constant__ CUtensorMap map_p,
               const bf16* __restrict__ q_abs, const bf16* __restrict__ q_pe,
               const bf16* __restrict__ new_c, const bf16* __restrict__ new_p,
               bf16* __restrict__ cache_c, bf16* __restrict__ cache_p,
               const int* __restrict__ lengths, bf16* __restrict__ ctx, int H, int r, int dp,
               int S, float c, int stages) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the swizzle atoms start on 1024-byte boundaries
  uint8_t* smem = smem_raw + ((1024 - (qtt::smem_u32(smem_raw) & 1023)) & 1023);
  const int W = blockDim.x / 32;
  const int lat = r / W, nk = lat / 16;  // latent columns and k16 steps a warp
  const int rsteps = dp / 16, spw = (rsteps + W - 1) / W;
  const int boxes = (r + dp) / 64, stage_bytes = boxes * kChunk * 128;
  float* part = reinterpret_cast<float*>(smem + stages * stage_bytes);
  float* tot = part + W * 256;
  float* red = tot + 256;
  float2* ml = reinterpret_cast<float2*>(red + kHeads * r);
  uint64_t* reduced = reinterpret_cast<uint64_t*>(ml + kRanks * kHeads);
  uint64_t* full = reduced + 1;  // the ring's stages

  const int ht = blockIdx.x, b = blockIdx.y, nsplit = gridDim.z, rank = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int cols = r / nsplit;  // ctx columns this rank owns
  // this warp's depth: latent columns col0.., rope steps rope0.. (nr of them)
  const int col0 = warp * lat;
  const int rope0 = min(warp * spw, rsteps), nr = min(rope0 + spw, rsteps) - rope0;

  // q as the A fragments of the scores over this warp's depth: heads gid
  // (a0, a2) and gid + 8 (a1, a3) of the tile, zero past H; loaded while
  // lengths[b] is on its way
  const int len = lengths[b];
  uint32_t qa[kLat / 16][4] = {}, qr[kRopeSteps][4] = {};
  {
    const int h0 = ht * kHeads + gid, h1 = h0 + 8;
#pragma unroll
    for (int kk = 0; kk < kLat / 16; ++kk)
      if (kk < nk) {
        const int k = col0 + 16 * kk + 2 * tig;
        qa[kk][0] = q_pair(q_abs, b, h0, H, r, k);
        qa[kk][1] = q_pair(q_abs, b, h1, H, r, k);
        qa[kk][2] = q_pair(q_abs, b, h0, H, r, k + 8);
        qa[kk][3] = q_pair(q_abs, b, h1, H, r, k + 8);
      }
#pragma unroll
    for (int j = 0; j < kRopeSteps; ++j)
      if (j < nr) {
        const int k = 16 * (rope0 + j) + 2 * tig;
        qr[j][0] = q_pair(q_pe, b, h0, H, dp, k);
        qr[j][1] = q_pair(q_pe, b, h1, H, dp, k);
        qr[j][2] = q_pair(q_pe, b, h0, H, dp, k + 8);
        qr[j][3] = q_pair(q_pe, b, h1, H, dp, k + 8);
      }
  }

  const int L = max(0, min(len, S - 1));
  const int n = L + 1;
  const int share = ((n + nsplit - 1) / nsplit + kChunk - 1) / kChunk * kChunk;
  const int p_lo = rank * share, p_hi = min(p_lo + share, n);
  const int chunks = p_hi > p_lo ? (p_hi - p_lo + kChunk - 1) / kChunk : 0;
  const bf16* nc = new_c + (size_t)b * r;
  const bf16* np = new_p + (size_t)b * dp;
  bf16* cb = cache_c + (size_t)b * S * r;
  bf16* pb = cache_p + (size_t)b * S * dp;

  // chunk i of the share into its stage, by warp 0: the TMA boxes of rows
  // p0..p0 + 15 of the caches, 64 columns each (lane k: box k). Rows past
  // the share (stale, or another row's past S, or zero past the cache) are
  // masked in the products; row L is patched from new_c / new_p once the
  // chunk has landed.
  auto fetch = [&](int i) {
    const int p0 = p_lo + kChunk * i;
    uint8_t* st = smem + (i % stages) * stage_bytes;
    uint64_t* bar = full + i % stages;
    if (lane == 0) qtt::mbar_expect(bar, stage_bytes);
    __syncwarp();
    for (int k = lane; k < boxes; k += 32) {
      const bool lat_box = k < r / 64;
      qtt::tma_load_2d(st + k * kChunk * 128, lat_box ? &map_c : &map_p,
                       64 * (lat_box ? k : k - r / 64), b * S + p0, bar);
    }
  };
  if (warp == 0) {
    if (lane == 0) {
      qtt::mbar_init(reduced, 1);
      for (int s = 0; s < stages; ++s) qtt::mbar_init(full + s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      // every rank's sums of this rank's columns, and its (m, l) pairs
      qtt::mbar_expect(reduced, kHeads * r * 4 + nsplit * kHeads * 8);
    }
    __syncwarp();
    for (int i = 0; i < min(stages, chunks); ++i) fetch(i);
    // the in-place write of the new row, by the block of head tile 0 whose
    // share holds L
    if (ht == 0 && L >= p_lo && L < p_hi) {
      for (int i = lane; i < r / 8; i += 32)
        reinterpret_cast<uint4*>(cb + (size_t)L * r)[i] = reinterpret_cast<const uint4*>(nc)[i];
      for (int i = lane; i < dp / 8; i += 32)
        reinterpret_cast<uint4*>(pb + (size_t)L * dp)[i] = reinterpret_cast<const uint4*>(np)[i];
    }
  }
  __syncthreads();
  // the other ranks may push to `reduced` once every rank has passed here
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // o[j]: ctx of heads gid (c0, c1) and gid + 8 (c2, c3), columns col0 + 8j
  // + 2 tig, + 1; m, l: the running max (in units of c) and this lane's
  // share of the sum, heads gid (m0, l0) and gid + 8 (m1, l1)
  float o[kLat / 8][4] = {};
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int i = 0; i < chunks; ++i) {
    uint8_t* st = smem + (i % stages) * stage_bytes;
    const int p0 = p_lo + kChunk * i, nv = p_hi - p0;
    qtt::mbar_wait(full + i % stages, (i / stages) & 1);
    if (L >= p0 && L < p0 + kChunk) {
      // row L from new_c / new_p, never the cache row written in place
      for (int pc = threadIdx.x; pc < (r + dp) / 8; pc += blockDim.x)
        *reinterpret_cast<uint4*>(st + piece_off(L - p0, pc)) =
            *reinterpret_cast<const uint4*>(pc < r / 8 ? nc + 8 * pc : np + 8 * pc - r);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // before the next TMA
      __syncthreads();
    }

    // this warp's partial scores: s[j], heads gid (c0, c1) and gid + 8 (c2,
    // c3), positions p0 + 8j + 2 tig, + 1
    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < kLat / 16; ++kk)
      if (kk < nk) {
        uint32_t kb[4];
        qtt::ldmatrix_x4(kb, st + k_off(lane, col0 / 8 + 2 * kk));
        qtt::mma_bf16(s[0], qa[kk], kb[0], kb[1]);
        qtt::mma_bf16(s[1], qa[kk], kb[2], kb[3]);
      }
#pragma unroll
    for (int j = 0; j < kRopeSteps; ++j)
      if (j < nr) {
        uint32_t kb[4];
        qtt::ldmatrix_x4(kb, st + k_off(lane, r / 8 + 2 * (rope0 + j)));
        qtt::mma_bf16(s[0], qr[j], kb[0], kb[1]);
        qtt::mma_bf16(s[1], qr[j], kb[2], kb[3]);
      }
    // the block's scores: the W partials of each entry added in warp order
    // by one thread, then read back by every warp
#pragma unroll
    for (int e = 0; e < 8; ++e) part[warp * 256 + e * 32 + lane] = s[e / 4][e % 4];
    __syncthreads();
    // every warp is done with chunk i - 1: its stage takes the next chunk
    if (warp == 0 && i >= 1 && i - 1 + stages < chunks) fetch(i - 1 + stages);
    for (int j = threadIdx.x; j < 256; j += blockDim.x) {
      float v = 0.f;
      for (int w = 0; w < W; ++w) v += part[w * 256 + j];
      tot[j] = v;
    }
    __syncthreads();
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = tot[e * 32 + lane];

    // positions past the share score -inf, whatever their stale rows hold
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int p = 8 * (e / 4) + 2 * tig + (e & 1);
      x[e] = p < nv ? x[e] * c : -INFINITY;
    }
    // position p0 is valid, so every row's max is finite
    float mx0 = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[4], x[5]));
    float mx1 = fmaxf(fmaxf(x[2], x[3]), fmaxf(x[6], x[7]));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float a0 = exp2_approx(m0 - n0), a1 = exp2_approx(m1 - n1);  // 0 on the first chunk
    m0 = n0;
    m1 = n1;
    float p[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) p[e] = exp2_approx(x[e] - (e & 2 ? n1 : n0));
    l0 = l0 * a0 + ((p[0] + p[1]) + (p[4] + p[5]));
    l1 = l1 * a1 + ((p[2] + p[3]) + (p[6] + p[7]));
    // p as the A fragment of the value product: heads x the chunk's 16 positions
    const uint32_t pa[4] = {qtt::pack_bf16(p[0], p[1]), qtt::pack_bf16(p[2], p[3]),
                            qtt::pack_bf16(p[4], p[5]), qtt::pack_bf16(p[6], p[7])};
    // C's rows past the share zeroed in the B fragments (positions 2 tig, + 1
    // and 2 tig + 8, + 9), so a stale NaN never meets a p of 0
    const uint32_t mlo = (2 * tig < nv ? 0xFFFFu : 0u) | (2 * tig + 1 < nv ? 0xFFFF0000u : 0u);
    const uint32_t mhi =
        (2 * tig + 8 < nv ? 0xFFFFu : 0u) | (2 * tig + 9 < nv ? 0xFFFF0000u : 0u);
#pragma unroll
    for (int jj = 0; jj < kLat / 16; ++jj)
      if (jj < nk) {
        uint32_t vb[4];
        qtt::ldmatrix_x4_trans(vb, st + v_off(lane, col0 / 8 + 2 * jj));
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          float* acc = o[2 * jj + t];
          acc[0] *= a0;
          acc[1] *= a0;
          acc[2] *= a1;
          acc[3] *= a1;
        }
        qtt::mma_bf16(o[2 * jj], pa, vb[0] & mlo, vb[1] & mhi);
        qtt::mma_bf16(o[2 * jj + 1], pa, vb[2] & mlo, vb[3] & mhi);
      }
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  // push: ctx column d of head h goes to rank d / cols, at slot (rank, h,
  // d % cols) of its `red`; the (m, l) pairs of every head to every rank
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < kLat / 8; ++j)
    if (j < 2 * nk) {
      const int d = col0 + 8 * j + 2 * tig;
      const int owner = d / cols;
      float* slot = red + (rank * kHeads + gid) * cols + d - owner * cols;
      const uint32_t bar = qtt::map_rank(reduced, owner);
      qtt::st_async_f32x2(qtt::map_rank(slot, owner), o[j][0], o[j][1], bar);
      qtt::st_async_f32x2(qtt::map_rank(slot + 8 * cols, owner), o[j][2], o[j][3], bar);
    }
  if (warp == 0 && tig == 0)
    for (int q = 0; q < nsplit; ++q) {
      const uint32_t bar = qtt::map_rank(reduced, q);
      qtt::st_async_f32x2(qtt::map_rank(ml + rank * kHeads + gid, q), m0, l0, bar);
      qtt::st_async_f32x2(qtt::map_rank(ml + rank * kHeads + gid + 8, q), m1, l1, bar);
    }

  // the owner's columns: the partials added in rank order, each rescaled by
  // 2^(m_q - M)
  qtt::mbar_wait(reduced, 0);
  const int heads = min(kHeads, H - ht * kHeads), half = cols / 2;
  for (int j = threadIdx.x; j < heads * half; j += blockDim.x) {
    const int h = j / half, d = 2 * (j - h * half);
    float M = -INFINITY;
#pragma unroll
    for (int q = 0; q < kRanks; ++q)
      if (q < nsplit) M = fmaxf(M, ml[q * kHeads + h].x);
    float sx = 0.f, sy = 0.f, sl = 0.f;
#pragma unroll
    for (int q = 0; q < kRanks; ++q)
      if (q < nsplit) {
        const float2 m = ml[q * kHeads + h];
        const float2 v = *reinterpret_cast<const float2*>(red + (q * kHeads + h) * cols + d);
        const float w = exp2_approx(m.x - M);
        sl += m.y * w;
        sx += v.x * w;
        sy += v.y * w;
      }
    *reinterpret_cast<__nv_bfloat162*>(ctx + ((size_t)b * H + ht * kHeads + h) * r +
                                       rank * cols + d) = __floats2bfloat162_rn(sx / sl, sy / sl);
  }
}

qtt::DeviceOnce once;

}  // namespace

extern "C" int qtt_mla_decode_attention(const void* q_abs, const void* q_pe, const void* new_c,
                                        const void* new_p, void* cache_c, void* cache_p,
                                        const void* lengths, void* ctx, int B, int H, int r,
                                        int dp, int S, float sm_scale, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || S <= 0 || S > kMaxS || r <= 0 || r % 128 ||
      r > kMaxR || dp <= 0 || dp % 128 || dp > kMaxDP)
    return (int)cudaErrorInvalidValue;
  // TMA reads the caches and the new rows are read 16 bytes at a time:
  // every base must be 16-byte aligned
  if (!aligned16(q_abs) || !aligned16(q_pe) || !aligned16(new_c) || !aligned16(new_p) ||
      !aligned16(cache_c) || !aligned16(cache_p) || !aligned16(ctx))
    return (int)cudaErrorMisalignedAddress;
  // the shared-memory limit is raised once, to what a block can have
  int dev = 0;
  const cudaError_t e = qtt::raise_once(once, mla_dec_kernel, kSmemLimit, dev);
  if (e != cudaSuccess) return (int)e;
  const int stages = ring_stages(r, dp);
  // the caches as (B * S, r) and (B * S, dp) row-major matrices, read in
  // boxes of 16 rows x 64 columns
  CUtensorMap map_c, map_p;
  if (!qtt::make_map_2d(&map_c, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, cache_c, r, B * S, 2LL * r,
                        64, kChunk) ||
      !qtt::make_map_2d(&map_p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, cache_p, dp, B * S, 2LL * dp,
                        64, kChunk))
    return (int)cudaErrorInvalidValue;
  // launch_split's rule, not limited by S: the fewest ranks that put a
  // block on every SM
  return qtt::launch_split(once, mla_dec_kernel, (H + kHeads - 1) / kHeads, B,
                           32 * warps_for(r, dp), smem_bytes(r, dp, stages), 4 * qtt::kMaxSplit,
                           false,
                           reinterpret_cast<cudaStream_t>(stream), map_c, map_p,
                           static_cast<const bf16*>(q_abs), static_cast<const bf16*>(q_pe),
                           static_cast<const bf16*>(new_c), static_cast<const bf16*>(new_p),
                           static_cast<bf16*>(cache_c), static_cast<bf16*>(cache_p),
                           static_cast<const int*>(lengths), static_cast<bf16*>(ctx), H, r, dp,
                           S, sm_scale * kLog2e, stages);
}
