// Blockwise (flash) attention over bf16 heads, causal or not, with GQA
// (sm_90a).
//
// Replaces quantizers_tpu/ops/flash.py `_flash_kernel` / `_flash_call`
// (reached through `flash_attention`).
//
// q (B, H, T, d), k (B, KV, S, d), v (B, KV, S, dv) bf16, each addressed by
// its own (b, head, row) element strides with a contiguous last dim, so the
// (B, T, H, d) projections of the transformer are read in place through
// their transpose(1, 2) views (no copy of q: 67 MB at B 4, T 2048, H 32);
// o (B, H, T, dv) bf16, written through strides the same way. Query head h
// reads KV head h / rep; K and V are never repeated in memory. Built for
// (d, dv) = (128, 128) and (256, 128) (the MLA prefill's padded qk head);
// any other pair is refused, and so is a stride of 0 (an expanded view),
// which TMA cannot read.
//
// What bounds it on the H100 SXM: operations. On the perplexity path (B 4,
// H 32, KV 8, T = S = 2048, d = dv = 128, causal) one call does
// 4 * 32 * 2 * 2048^2 * 128 * 2 / 2 = 1.37e11 FLOP, 0.139 ms at 989
// TFLOP/s, and moves 168 MB, 0.050 ms at 3.35 TB/s. But each 128-row block
// reads every K/V tile up to its diagonal again, 64 KB from L2 a tile
// against 8.4 MFLOP: 1.14 GB a call, 7.7 TB/s of L2 reads at the tensor
// cores' rate. So what has to be hidden is the L2 feed (the more tiles in
// flight the faster) and the softmax (8,192 exp a warpgroup a tile, at 16 a
// clock an SM), not device memory.
//
// Design (the shape of FlashAttention-3): a work item is 128 query rows of
// one (b, h); one block of 384 threads on each SM walks its share of the
// items. Warpgroup 2 is the producer (24 registers a thread, setmaxnreg):
// one of its threads loads each item's q rows and then its K/V tiles of BK
// keys (128 at d 128, 64 at d 256) into a ring of 3 stages by TMA (4-D
// tensor maps over the strided views, in the 128-byte swizzle that the
// wgmma descriptors read; keys past S and rows past T arrive as zeros).
// Each stage, and the q buffer, has a "full" mbarrier that the copies
// complete and an "empty" one that the consumers release; the ring runs on
// from one item into the next, so the next item's tiles load while this
// one ends. Warpgroups 0 and 1 (240 registers) are the consumers, 64 rows
// each. Both products run on
// Hopper's warpgroup tensor-core instruction (wgmma, csrc/wgmma.cuh):
// s = q . k^T as m64nBKk16 with q and k K-major in shared memory; acc +=
// p . v as m64n128k16 with p from registers (s's accumulator rounded to
// bf16 pairs is the A fragment) and v read MN-major as stored (the
// transpose immediate), so v is never transposed. A consumer sends its
// products a unit at a time, p . v of tile j - 1 with q . k^T of tile j,
// and the two take turns (two named barriers), so that one's softmax runs
// while the other's unit holds the tensor cores. No wgmma sits on a
// branch (the first and last units are peeled off the loop): ptxas
// serializes every wgmma of a kernel that has one there.
//
// The rounding points are those of the TPU kernel: s = (f32 sum of bf16
// products) * sm_scale in f32; masked entries -1e30; m_new = max(m, rowmax
// s); p = exp(s - m_new) and corr = exp(m - m_new) in f32; l = l * corr +
// sum of the f32 p; acc = acc * corr + bf16(p) . v with f32 sums; out =
// acc / max(l, 1e-30), rounded to bf16. exp is computed as 2^(s c - m c),
// c = sm_scale * log2 e, one FMA and ex2.approx a term: a change of
// rounding (2 ulp), not of the function. Only the tile that holds S's end
// or (causal) crosses the diagonal tests each entry. A row's first tile
// holds key 0, so its running max is finite from the first tile on and
// every masked p is exactly 0; a consumer skips the tiles wholly above its
// rows, whose p would all be 0. Rows past T are computed on zero queries
// and never written, so any T and S are taken. No atomics and a fixed
// order of sums: two calls give the same bits.
//
// Work order: item w goes to block w % grid. The items of one (b, KV head)
// are neighbours, so its K/V tiles stay in L2 while they run, its rep
// query heads side by side (they read each tile at about the same time),
// and within it the heaviest (last) query blocks come first.

#include "common.cuh"
#include "wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kRows = 128;                  // query rows per item, 64 a warpgroup
constexpr int kStages = 3;                  // K/V tiles in flight
constexpr float kNegInf = -1e30f;           // the TPU kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, t;  // elements; the last dim is contiguous
};

using qtt::mbar_arrive;
using qtt::mbar_expect;
using qtt::mbar_init;
using qtt::mbar_wait;
using qtt::pack_bf16;
using qtt::smem_u32;

// keys a tile: 128 at d 128, 64 at d 256 (q and three K/V stages: 224 KB
// and 208 KB of shared memory)
template <int D>
__host__ __device__ constexpr int keys_per_tile() {
  return D == 128 ? 128 : 64;
}

template <int D, int DV>
__host__ __device__ constexpr int smem_bytes() {
  return (kRows * D + kStages * keys_per_tile<D>() * (D + DV)) * 2  // q, the ring
         + 2 * (1 + kStages) * 8                                   // the mbarriers
         + 1024;                                                   // alignment
}

// 2^x (ex2.approx: 2 ulp; -1e30 and below give 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                         int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// The two consumer warpgroups take turns at the tensor cores: warpgroup w
// waits on barrier 1 + w, and the other one arrives there.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kConsumers) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumers) : "memory");
}

// s = q . k^T over one tile: D / 16 k16 slices, each m64nBKk16 (q and k
// K-major, 64-column blocks BK * 128 bytes apart in k, kRows * 128 in q)
template <int D, int BK>
__device__ __forceinline__ void qk_tile(float (&s)[BK / 2], uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    qtt::wgmma_ss<0>(s, qtt::desc_add(dq, (kk / 4) * kRows * 128 + (kk % 4) * 32),
                     qtt::desc_add(dk, (kk / 4) * BK * 128 + (kk % 4) * 32), kk > 0);
}

// acc += p . v over one tile: BK / 16 k16 slices of m64n128k16, p from
// registers, v MN-major (the transpose immediate)
template <int BK>
__device__ __forceinline__ void pv_tile(float (&acc)[64], const uint32_t (&pa)[BK / 16][4],
                                        uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    qtt::wgmma_rs<1>(acc, pa[kk], qtt::desc_add(dv, kk * 2048), 1);
}

// One warpgroup's online softmax over its 64 rows (this thread: 2 rows, the
// quad's columns). The running max m is kept in units of the unscaled sums
// (sm_scale > 0 picks the same max), and p = 2^(s c - m c), c = sm_scale *
// log2 e; l holds this thread's share of the row sum until the end.
template <int BK, int DV>
struct Softmax {
  float c;
  int row[2];  // this thread's two rows
  int S, causal;
  float acc[DV / 2] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // Fold the tile of keys k0.. (the scores s) in: rescale acc and l, and
  // leave bf16(p) in pa as the A fragments of p . v.
  __device__ __forceinline__ void step(float (&s)[BK / 2], uint32_t (&pa)[BK / 16][4], int k0,
                                       int row0) {
    const int tq = threadIdx.x % 4;
    // mask only a tile that holds S's end or (causal) crosses the diagonal
    if (k0 + BK > S || (causal && k0 + BK - 1 > row0)) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + tq * 2 + (e & 1);
          if (col >= S || (causal && col > row[e >> 1])) s[4 * j + e] = kNegInf;
        }
      }
    }
    // the rows' new maxima (each row's entries lie in the 4 lanes of its quad)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
    float corr[2], mc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2_approx((m[i] - mx[i]) * c);
      m[i] = mx[i];
      mc[i] = mx[i] * c;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(fmaf(s[4 * j + e], c, -mc[e >> 1]));
        s[4 * j + e] = p;
        l[e >> 1] += p;
      }
    }
    // two 8-key blocks of p are the A fragment of one 16-key slice
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      acc[4 * n] *= corr[0];
      acc[4 * n + 1] *= corr[0];
      acc[4 * n + 2] *= corr[1];
      acc[4 * n + 3] *= corr[1];
    }
  }
};

// Work item w (the work order above): 128 query rows of one (b, h), and
// the K/V tiles they read.
struct Item {
  int b, h, kvh, q0, n_tiles;

  __device__ __forceinline__ Item(int w, int H, int rep, int S, int n_q, int causal, int BK) {
    const int g = w / (rep * n_q), idx = w % (rep * n_q);
    b = g / (H / rep);
    kvh = g % (H / rep);
    h = kvh * rep + idx % rep;
    q0 = (n_q - 1 - idx / rep) * kRows;
    const int kend = causal ? min(S, q0 + kRows) : S;
    n_tiles = (kend + BK - 1) / BK;
  }
};

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, Strides so, int H,
             int rep, int T, int S, int n_q, int items, float sm_scale, int causal) {
  constexpr int BK = keys_per_tile<D>();
  constexpr int kQ = kRows * D * 2;                           // bytes of q
  constexpr int kK = BK * D * 2, kStage = BK * (D + DV) * 2;  // bytes of a K tile, a stage
  static_assert(DV == 128, "the value product is m64n128");
  extern __shared__ unsigned char smem_raw[];
  // the swizzle atoms start on 1024-byte boundaries
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = qs + kQ;  // tile t in stage t % kStages: K [BK][D], then V [BK][DV]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + kStages * kStage);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_empty + 1;      // a stage's tile has arrived
  uint64_t* empty = full + kStages;  // every consumer is done with a stage

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup: one thread starts every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      int t = 0;  // tiles requested, over every item
      for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
        const Item it(w, H, rep, S, n_q, causal, BK);
        // q of item n, once item n - 1 is done with the buffer
        if (n > 0) mbar_wait(q_empty, (n - 1) & 1);
        mbar_expect(q_full, kQ);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load(qs + c * kRows * 128, &tq, c * 64, it.q0, it.h, it.b, q_full);
        for (int j = 0; j < it.n_tiles; ++j, ++t) {
          const int st = t % kStages;
          if (t >= kStages) mbar_wait(empty + st, (t / kStages - 1) & 1);
          unsigned char* kst = ring + st * kStage;
          mbar_expect(full + st, kStage);
#pragma unroll
          for (int c = 0; c < D / 64; ++c)
            tma_load(kst + c * BK * 128, &tk, c * 64, j * BK, it.kvh, it.b, full + st);
#pragma unroll
          for (int c = 0; c < DV / 64; ++c)
            tma_load(kst + kK + c * BK * 128, &tv, c * 64, j * BK, it.kvh, it.b, full + st);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const uint64_t dk = qtt::sw128_desc(ring, 16, 1024);
  const uint64_t dvv = qtt::sw128_desc(ring + kK, BK * 128, 1024);  // MN-major, dv blocks apart
  int t0 = 0;  // the first tile of this item, counted over every item
  for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
    const Item it(w, H, rep, S, n_q, causal, BK);
    const int n_tiles = it.n_tiles;
    const int row0 = it.q0 + wg * 64;  // this warpgroup's first row
    const int rows[2] = {row0 + warp * 16 + lane / 4, row0 + warp * 16 + lane / 4 + 8};
    // this warpgroup's 64 q rows
    const uint64_t dq = qtt::sw128_desc(qs + wg * 64 * 128, 16, 1024);
    // the tiles this warpgroup multiplies: (causal) none wholly above its
    // rows, whose p would all be 0; rows all past T take tile 0 alone (zero
    // queries, never written), so that every warpgroup has a first and a last
    const int mine = row0 >= T ? 1 : causal ? min(n_tiles, (row0 + 63) / BK + 1) : n_tiles;

    Softmax<BK, DV> sm{sm_scale * kLog2e, {rows[0], rows[1]}, S, causal};
    float s[BK / 2];
    uint32_t pa[BK / 16][4];  // bf16(p) of the previous tile, the A fragments of p . v

    mbar_wait(q_full, n & 1);
    if (wg == 1) named_arrive(1);  // warpgroup 0 goes first
    // unit 0: s = q . k^T of tile 0
    mbar_wait(full + t0 % kStages, (t0 / kStages) & 1);
    named_sync(1 + wg);
    qtt::wgmma_fence();
    qk_tile<D, BK>(s, dq, qtt::desc_add(dk, (t0 % kStages) * kStage));
    qtt::wgmma_commit();
    named_arrive(2 - wg);  // the other warpgroup's turn
    qtt::wgmma_wait<0>();
    qtt::fence_operands(s);
    sm.step(s, pa, 0, row0);
    // unit u: acc += p . v of tile u - 1, s = q . k^T of tile u
    for (int u = 1; u < mine; ++u) {
      const int t = t0 + u;
      mbar_wait(full + t % kStages, (t / kStages) & 1);
      named_sync(1 + wg);
      qtt::wgmma_fence();
      pv_tile<BK>(sm.acc, pa, qtt::desc_add(dvv, ((t - 1) % kStages) * kStage));
      qk_tile<D, BK>(s, dq, qtt::desc_add(dk, (t % kStages) * kStage));
      qtt::wgmma_commit();
      named_arrive(2 - wg);
      qtt::wgmma_wait<0>();
      qtt::fence_operands(sm.acc);
      qtt::fence_operands(s);
      mbar_arrive(empty + (t - 1) % kStages);  // tile t - 1 is no longer read
      sm.step(s, pa, u * BK, row0);
    }
    mbar_arrive(q_empty);  // this item's q is no longer read: the next one may load
    // unit `mine`: acc += p . v of the last tile
    const int tl = t0 + mine - 1;
    named_sync(1 + wg);
    qtt::wgmma_fence();
    pv_tile<BK>(sm.acc, pa, qtt::desc_add(dvv, (tl % kStages) * kStage));
    qtt::wgmma_commit();
    qtt::wgmma_wait<0>();
    qtt::fence_operands(sm.acc);
    // every warpgroup takes n_tiles + 1 turns; warpgroup 1's last arrival
    // would have no turn to open
    if (wg == 0 || mine < n_tiles) named_arrive(2 - wg);
    mbar_arrive(empty + tl % kStages);
    // the tiles this warpgroup skips: its turns, and their release
    for (int u = mine + 1; u <= n_tiles; ++u) {
      const int t = t0 + u - 1;
      mbar_wait(full + t % kStages, (t / kStages) & 1);
      named_sync(1 + wg);
      if (wg == 0 || u < n_tiles) named_arrive(2 - wg);
      mbar_arrive(empty + t % kStages);
    }
    t0 += n_tiles;

    bf16* ob = o + it.b * so.b + it.h * so.h;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = sm.l[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if (rows[i] >= T) continue;
      const float den = fmaxf(l, 1e-30f);
      uint32_t* orow = reinterpret_cast<uint32_t*>(ob + rows[i] * so.t);
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        orow[j * 4 + lane % 4] =
            pack_bf16(sm.acc[4 * j + 2 * i] / den, sm.acc[4 * j + 2 * i + 1] / den);
    }
  }
}

// A tensor map of a bf16 (n3, n2, rows, W) tensor with element strides
// (s3, s2, st) and a contiguous last dim, read in boxes of box_rows x 64
// with the 128-byte swizzle; rows past `rows` read as zeros. TMA takes no
// stride of 0 (an expanded view): the wrapper copies such a view first.
bool make_map(CUtensorMap* map, const void* base, int W, int rows, int n2, int n3, long long st,
              long long s2, long long s3, int box_rows) {
  qtt::EncodeTiled fn = qtt::tensor_map_encoder();
  if (!fn || st <= 0 || s2 <= 0 || s3 <= 0) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)rows, (cuuint64_t)n2, (cuuint64_t)n3};
  const cuuint64_t strides[3] = {(cuuint64_t)st * 2, (cuuint64_t)s2 * 2, (cuuint64_t)s3 * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, Strides sq, Strides sk,
           Strides sv, Strides so, int B, int H, int KV, int T, int S, float sm_scale, int causal,
           cudaStream_t stream) {
  constexpr int BK = keys_per_tile<D>();
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, D, T, H, B, sq.t, sq.h, sq.b, kRows) ||
      !make_map(&mk, k, D, S, KV, B, sk.t, sk.h, sk.b, BK) ||
      !make_map(&mv, v, DV, S, KV, B, sv.t, sv.h, sv.b, BK))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<D, DV>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  const int n_q = (T + kRows - 1) / kRows, items = B * H * n_q;
  flash_kernel<D, DV><<<min(items, sms), kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), so, H, H / KV, T, S, n_q, items, sm_scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int qtt_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   long long sqb, long long sqh, long long sqt, long long skb,
                                   long long skh, long long skt, long long svb, long long svh,
                                   long long svt, long long sob, long long soh, long long sot,
                                   int B, int H, int KV, int T, int S, int d, int dv,
                                   float sm_scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || T <= 0 || S <= 0 ||
      (long long)B * H * ((T + kRows - 1) / kRows) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Strides sq{sqb, sqh, sqt}, sk{skb, skh, skt}, sv{svb, svh, svt}, so{sob, soh, sot};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (d == 128 && dv == 128)
    return launch<128, 128>(q, k, v, o, sq, sk, sv, so, B, H, KV, T, S, sm_scale, causal, s);
  if (d == 256 && dv == 128)
    return launch<256, 128>(q, k, v, o, sq, sk, sv, so, B, H, KV, T, S, sm_scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
