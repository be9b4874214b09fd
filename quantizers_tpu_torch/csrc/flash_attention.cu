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
// any other pair is refused.
//
// What bounds it on the H100 SXM: operations. On the perplexity path (B 4,
// H 32, KV 8, T = S = 2048, d = dv = 128, causal) one call does
// 4 * 32 * 2 * 2048^2 * 128 * 2 / 2 = 1.37e11 FLOP, 0.139 ms at 989
// TFLOP/s, and moves 168 MB, 0.050 ms at 3.35 TB/s.
//
// Design: one block of 4 warps owns 64 query rows of one (b, h); each warp
// owns 16 rows and keeps their q fragments, running max m, sum l and f32
// accumulator in registers. The block walks 64-key tiles from key 0 upward
// (up to the diagonal when causal), staging each K and V tile in shared
// memory (rows padded by 16 bytes, so the fragment reads are free of bank
// conflicts). Both products run on the tensor cores as warp-level
// mma.sync.m16n8k16 bf16 -> f32: s = q . k, then p . v with the p fragment
// taken straight from s's accumulator registers and V's fragments loaded
// with ldmatrix.trans. The rounding points are those of the TPU kernel:
// s = (f32 sum of bf16 products) * sm_scale in f32; masked entries -1e30;
// m_new = max(m, rowmax s); p = exp(s - m_new) and corr = exp(m - m_new) in
// f32; l = l * corr + sum of the f32 p; acc = acc * corr + bf16(p) . v with
// f32 sums; out = acc / max(l, 1e-30), rounded to bf16. A row's first tile
// holds key 0, so its running max is finite from the first tile on and
// every masked p is exactly 0. Keys past S are staged as zeros and masked;
// rows past T are computed on zero queries and never written, so any T and
// S are taken. No atomics: two calls give the same bits.
//
// Left for later: wgmma with TMA-fed, double-buffered tiles; one K/V tile
// shared by the rep query heads of a KV head; heavy (late, causal) query
// blocks first.

#include <math.h>

#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // query rows per block
constexpr int kKeys = 64;           // keys per tile
constexpr int kPad = 8;             // bf16 padding per shared-memory row (16 bytes)
constexpr float kNegInf = -1e30f;   // the TPU kernel's mask value

struct Strides {
  long long b, h, t;  // elements; the last dim is contiguous
};

using qtt::mma_bf16;
using qtt::pack_bf16;

// Two 8x8 bf16 matrices whose rows (keys) start at the addresses of lanes
// 0-7 and 8-15, transposed: lane i receives rows 2(i%4), 2(i%4)+1 of column
// i/4 of each, which is the m16n8k16 B fragment of a row-major [key][dim]
// tile.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ uint32_t load_pair(const bf16* base, long long st, int row, int col,
                                              int rows) {
  if (row >= rows) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + row * st + col);
}

// Stage rows k0 .. k0 + kKeys of a (S, W) head into shared memory
// [kKeys][W + kPad], 16 bytes per thread and load; rows past S are zero.
template <int W>
__device__ __forceinline__ void stage(bf16* __restrict__ dst, const bf16* __restrict__ src,
                                      long long st, int k0, int S) {
  constexpr int kChunks = W / 8;
  for (int i = threadIdx.x; i < kKeys * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + r < S) val = *reinterpret_cast<const uint4*>(src + (k0 + r) * st + c * 8);
    *reinterpret_cast<uint4*>(dst + r * (W + kPad) + c * 8) = val;
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             bf16* __restrict__ o, Strides sq, Strides sk, Strides sv, Strides so, int H, int rep,
             int T, int S, float sm_scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [kKeys][D + kPad]
  bf16* vs = ks + kKeys * (D + kPad);        // [kKeys][DV + kPad]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / rep;
  const int q0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;  // the mma fragment's row group and column pair
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + kvh * sk.h;
  const bf16* vb = v + b * sv.b + kvh * sv.h;

  // this warp's 16 query rows as m16n8k16 A fragments, once
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + tq * 2;
    qf[kk][0] = load_pair(qb, sq.t, rows[0], c, T);
    qf[kk][1] = load_pair(qb, sq.t, rows[1], c, T);
    qf[kk][2] = load_pair(qb, sq.t, rows[0], c + 8, T);
    qf[kk][3] = load_pair(qb, sq.t, rows[1], c + 8, T);
  }

  float acc[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int kend = causal ? min(S, q0 + kRows) : S;
  for (int k0 = 0; k0 < kend; k0 += kKeys) {
    __syncthreads();  // the previous tile's readers are done
    stage<D>(ks, kb, sk.t, k0, S);
    stage<DV>(vs, vb, sv.t, k0, S);
    __syncthreads();

    // s = q . k^T over the tile: 8 column blocks of 8 keys
    float s[kKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        const bf16* kr = ks + (j * 8 + g) * (D + kPad) + kk * 16 + tq * 2;
        mma_bf16(s[j], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // scale, mask, and the rows' new maxima (each row's 64 entries lie in
    // the 4 lanes of its fragment group)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + tq * 2 + (e & 1);
        float x = s[j][e] * sm_scale;
        if (col >= S || (causal && col > rows[e >> 1])) x = kNegInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * corr[i] + sum[i];
    }
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += bf16(p) . v: the accumulator layout of two 8-key blocks of s
    // is the A fragment of one 16-key step
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const bf16* vrow = vs + (kk * 16 + (lane & 15)) * (DV + kPad);
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vrow + n * 8);
        mma_bf16(acc[n], a, b0, b1);
      }
    }
  }

  bf16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= T) continue;
    const float den = fmaxf(l[i], 1e-30f);
    uint32_t* orow = reinterpret_cast<uint32_t*>(ob + rows[i] * so.t);
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
      orow[(n * 8 + tq * 2) / 2] = pack_bf16(acc[n][2 * i] / den, acc[n][2 * i + 1] / den);
  }
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, Strides sq, Strides sk,
           Strides sv, Strides so, int B, int H, int rep, int T, int S, float sm_scale, int causal,
           cudaStream_t stream) {
  const int smem = kKeys * ((D + kPad) + (DV + kPad)) * (int)sizeof(bf16);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * H, (T + kRows - 1) / kRows);
  flash_kernel<D, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), sq, sk, sv, so, H, rep, T, S, sm_scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int qtt_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   long long sqb, long long sqh, long long sqt, long long skb,
                                   long long skh, long long skt, long long svb, long long svh,
                                   long long svt, long long sob, long long soh, long long sot,
                                   int B, int H, int KV, int T, int S, int d, int dv,
                                   float sm_scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || T <= 0 || S <= 0 || (T + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides sq{sqb, sqh, sqt}, sk{skb, skh, skt}, sv{svb, svh, svt}, so{sob, soh, sot};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (d == 128 && dv == 128)
    return launch<128, 128>(q, k, v, o, sq, sk, sv, so, B, H, H / KV, T, S, sm_scale, causal, s);
  if (d == 256 && dv == 128)
    return launch<256, 128>(q, k, v, o, sq, sk, sv, so, B, H, H / KV, T, S, sm_scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
