// FP8 E4M3 weight-only matmul with 128 x 128 block scales for Hopper
// (sm_90a): y = x @ W^T, bf16 out.
//
// Replaces quantizers_tpu/ops/kernels.py `_fp8_kernel` / `_fp8_matmul_2d`
// (reached through `fp8_matmul`).
//
// x bf16 (M, K); w float8_e4m3fn (K, N); s f32 (K/128, N/128), read as
// that grid (the TPU kernel expands it along N only for its tiling); out
// bf16 (M, N). 128 | K and 128 | N. Each weight is decoded to f32 (exact),
// multiplied by its block's scale in f32 and rounded to bf16, exactly where
// the TPU kernel and the reference dequantize round it; the products with x
// (bf16 x bf16, exact in f32) are summed in f32.
//
// What bounds it on the H100 SXM: bytes. On the FP8_BLOCK MLA serving path
// (M 8, DeepSeek-V2-Lite attention with the 8192-wide dense MLP) a decoder
// layer's four calls read 60.8 MB of fp8 weights, 18.2 us at 3.35 TB/s.
// The activations are bf16, so the FP8 tensor cores (which need both
// operands in E4M3) do not apply: that waits for dynamic FP8 activations.
//
// Design: the int8-doubled NVFP4 kernel's skeleton (nvfp4_matmul.cu, the
// same one-byte (K, N) layout) with an E4M3 decode, fed by TMA:
// * outT = WT . xT with mma.sync.m16n8k16 bf16 -> f32: the 16 rows of A are
//   16 output columns of a k16 slice of W, the 8 columns of B are 8 rows of
//   x, so a decode step at M = 8 fills the instruction with no padding.
// * A block owns 128 output columns (8 consumer warps, one m16 tile each):
//   one whole 128-byte line of each K row, and exactly one column of scale
//   blocks. A stage holds 128 K rows, so a block's stage lies in one
//   128 x 128 scale block: one f32 scale a stage, read with __ldg into
//   registers 4 stages ahead of its use (a read from device memory outlasts
//   a stage's products).
// * A ninth warp is the producer: one thread loads each stage by TMA (2-D
//   tensor maps, the 128-byte swizzle) into a ring of 2-3 stages, in two
//   halves of 64 K rows that complete on their own mbarriers, so the
//   products start when the first half of the first stage has landed. The
//   x rows of a half's K range ride with it. Copies by every thread
//   (cp.async) left the card further from the bytes bound.
// * To fill the card with so few column tiles (16 at N = 2048), the blocks
//   of a thread block cluster (up to 8, the fewest that put a block on
//   every SM, chosen at launch) split K: 192 blocks for q_proj, 128 for
//   o_proj and down, 256 for gate|up at M = 8. Each rank owns 1 / ranks of
//   the block's outputs; every rank sends its partial sums of them to that
//   rank (st.async into its shared memory, completing on its mbarrier),
//   and the owner adds them in rank order and writes them. No cluster-wide
//   barrier ends the kernel: a rank exits once its own outputs are out
//   (the reduction, the split rule and the cluster launch: splitk.cuh).
// * A warp's A fragments come from the staged tile with one
//   ldmatrix.x4.trans per 32 K rows (piece c of row r at c ^ (r % 8), the
//   TMA swizzle, common.cuh: w_off): lane (g, t) gets the bytes of K rows
//   2t, 2t+1 of columns 2g, 2g+1 of its tile, so A row g is column 2g and
//   A row g+8 column 2g+1 (the reduction undoes this).
// * The decode, two weights at a time: a byte permute gathers each
//   column's pair of codes, one cvt turns a pair of E4M3 codes into f16x2
//   (exact: every E4M3 value, subnormals too, is an f16), the pair widens
//   to f32, two f32 multiplies by the stage's scale and one bf16x2 rounding
//   give the reference's f32 product rounded to bf16.
// * Each weight fragment is decoded once for all of the block's rows of x,
//   up to 64 (one mma per 8 rows); M is tiled in 64s, so the row prefills
//   (M 128) read the weights twice and the no-cache window (M 512) 8 times.
// * One launch, no atomics and no workspace: two calls give the same bits.

#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "splitk.cuh"

namespace {
using namespace qtt;

constexpr int kTiles = 8;           // m16 column tiles per block
constexpr int kCols = 16 * kTiles;  // output columns per block
constexpr int kRows = 128;          // K rows per stage
constexpr int kBlock = 128;         // the side of a scale block
constexpr int kAhead = 4;           // stages a scale is read ahead of its use
static_assert(kCols == kBlock && kRows == kBlock, "a block's stage lies in one scale block");
static_assert(kCols == kLine, "a staged K row is one 128-byte line (common.cuh: w_off)");

// One stage of the ring, as TMA writes it in the 128-byte swizzle: the fp8
// tile [kRows][128 bytes] (piece c of row r at w_off(r, c)), then x in two
// boxes of 64 K columns, [8 MG rows][128 bytes] each, swizzled the same way.
// Half h of a stage is K rows 64h .. of the tile and x box h.
template <int MG>
struct Stage {
  static constexpr int kWarps = kTiles;       // consumer warps: one column tile each
  static constexpr int kThreads = 32 * kWarps + 32;  // and one producer warp
  static constexpr int kW = kRows * kCols;
  static constexpr int kXBox = 8 * MG * 128;
  static constexpr int kBytes = kW + 2 * kXBox;
  // the ring's depth: 2 blocks fit an SM at every MG (deeper rings were
  // slower on the H100)
  static constexpr int kStages = MG <= 4 ? 3 : 2;
  // the block's f32 outputs: each rank of the cluster receives every
  // rank's share of its 1 / ranks of them
  static constexpr int kOut = 8 * MG * kCols;
  // the ring, the reduction buffer, the mbarriers (full for each half
  // stage, empty a stage, one for the reduction), and room to align the
  // ring to 1024
  static constexpr int kSmem = kStages * kBytes + kOut * 4 + (3 * kStages + 1) * 8 + 1024;
  static_assert(kBytes % 1024 == 0 && kSmem <= 113 * 1024, "ring");
};

// The bytes of an ldmatrix.trans register, (k, c0), (k, c1), (k+1, c0),
// (k+1, c1), E4M3 codes, times the stage's scale s, as the bf16 pairs
// lo = (w(k, c0), w(k+1, c0)) and hi = (w(k, c1), w(k+1, c1)): each code
// exact in f16 and in f32, the product rounded to f32 and then to bf16.
__device__ __forceinline__ void dequant_pairs(uint32_t r, float s, uint32_t& lo, uint32_t& hi) {
  const uint32_t p = __byte_perm(r, 0u, 0x3120);  // column c0's pair low, c1's high
  const float2 a = __half22float2(
      __half2(__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(p & 0xFFFFu), __NV_E4M3)));
  const float2 b = __half22float2(
      __half2(__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(p >> 16), __NV_E4M3)));
  lo = as_u32(__float22bfloat162_rn(make_float2(a.x * s, a.y * s)));
  hi = as_u32(__float22bfloat162_rn(make_float2(b.x * s, b.y * s)));
}

// One block: 128 columns by 8 MG rows of x over its cluster rank's share
// of K (gridDim.z blocks a cluster split K). Warps 0-7 multiply (warp w:
// columns 16w ..); warp 8 is the producer, one of its threads keeps the
// ring full by TMA.
template <int MG>
__global__ void __launch_bounds__(Stage<MG>::kThreads, 2)
fp8_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tx,
           const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int M, int K,
           int N) {
  using St = Stage<MG>;
  constexpr int S = St::kStages, W = St::kWarps;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the swizzle atoms start on 1024-byte boundaries
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* red = reinterpret_cast<float*>(ring + S * St::kBytes);  // [ranks][kOut / ranks]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + St::kOut);  // [slot][half] has landed
  uint64_t* empty = full + 2 * S;  // every consumer warp is done with a stage
  uint64_t* reduced = empty + S;  // every rank's share of this block's outputs has landed
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * 8 * MG;
  // this block's stages: its share (rank of ranks) of K's
  const int ranks = gridDim.z, rank = blockIdx.z;
  const int all = K / kRows;
  const int s0 = all * rank / ranks;
  const int nk = all * (rank + 1) / ranks - s0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + 2 * i, 1);
      mbar_init(full + 2 * i + 1, 1);
      mbar_init(empty + i, W);
    }
  }
  if (warp == W && lane == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tw) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tx) : "memory");
  }
  push_init(reduced, St::kOut * 4);  // its fence and barrier publish these barriers too

  float acc[MG][4];
#pragma unroll
  for (int mg = 0; mg < MG; ++mg)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[mg][j] = 0.f;
  const int col = warp * 16 + 2 * gid;  // A rows gid, gid + 8: columns col, col + 1

  if (warp == W) {
    // the producer: stage s0 + s (K rows from (s0 + s) * kRows) into slot
    // s % S, a half at a time, once the consumers are done with its last
    // use; rows of x past M arrive as zeros, so they add 0
    if (lane == 0) {
      for (int s = 0; s < nk; ++s) {
        const int slot = s % S;
        if (s >= S) mbar_wait(empty + slot, (s / S - 1) & 1);
        uint8_t* base = ring + slot * St::kBytes;
        const int k0 = (s0 + s) * kRows;
        for (int h = 0; h < 2; ++h) {
          uint64_t* bar = full + 2 * slot + h;
          mbar_expect(bar, St::kBytes / 2);
          tma_load_2d(base + h * (St::kW / 2), &tw, n0, k0 + h * 64, bar);
          tma_load_2d(base + St::kW + h * St::kXBox, &tx, k0 + h * 64, m0, bar);
        }
      }
    }
  } else {
    // the scale of stage s: row s0 + s, column blockIdx.x of the grid,
    // read kAhead stages ahead of its use
    const int sblocks = N / kBlock;
    const float* sp = scale + (size_t)s0 * sblocks + blockIdx.x;
    auto scale_of = [&](int s) { return s < nk ? __ldg(sp + (size_t)s * sblocks) : 0.f; };
    float ahead[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) ahead[j] = scale_of(j);
    for (int s = 0; s < nk; ++s) {
      const int slot = s % S;
      const float sc = ahead[0];
#pragma unroll
      for (int j = 0; j + 1 < kAhead; ++j) ahead[j] = ahead[j + 1];
      ahead[kAhead - 1] = scale_of(s + kAhead);
      const uint8_t* base = ring + slot * St::kBytes;
#pragma unroll
      for (int kr = 0; kr < kRows; kr += 32) {
        if (kr % 64 == 0) mbar_wait(full + 2 * slot + kr / 64, (s / S) & 1);  // its half
        uint32_t wr[4];
        ldmatrix_x4_trans(wr, base + w_off(kr + lane, warp));
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          const int kk = kr + st * 16;  // the k16 step's first row in the stage
          uint32_t a[4];
          dequant_pairs(wr[2 * st], sc, a[0], a[1]);
          dequant_pairs(wr[2 * st + 1], sc, a[2], a[3]);
          // x row 8 mg + gid, K columns kk + 2t, + 1 and kk + 8 + 2t, + 1:
          // 16-byte pieces c and c + 1 of that row in its box, swizzled by
          // the row mod 8
          const uint8_t* xb = base + St::kW + (kk / 64) * St::kXBox + gid * 128 + 4 * t;
          const int c = (kk % 64) / 8;
#pragma unroll
          for (int mg = 0; mg < MG; ++mg) {
            const uint8_t* xr = xb + mg * 8 * 128;
            mma_bf16(acc[mg], a, *reinterpret_cast<const uint32_t*>(xr + ((c ^ gid) << 4)),
                     *reinterpret_cast<const uint32_t*>(xr + (((c + 1) ^ gid) << 4)));
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);  // this warp is done with the stage
    }
  }

  // the cluster's shares of K, added in a fixed order (splitk.cuh)
  push_store<MG, kCols, St::kThreads>(acc, red, reduced, out, M, N, m0, n0, col, t);
}

template <int MG>
int launch(const void* x, const void* w, const void* scale, void* out, int M, int K, int N,
           cudaStream_t stream) {
  CUtensorMap tw, tx;
  if (!make_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K, N, kCols, kRows / 2) ||
      !make_map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, 2LL * K, 64, 8 * MG))
    return (int)cudaErrorInvalidValue;
  // K's 128-row stages split over a cluster by splitk.cuh's rule, without
  // the second doubling
  static DeviceOnce once;
  return launch_split(once, fp8_kernel<MG>, N / kCols, (M + 8 * MG - 1) / (8 * MG),
                      Stage<MG>::kThreads, Stage<MG>::kSmem, K / kRows, false, stream, tw, tx,
                      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), M, K,
                      N);
}

}  // namespace

extern "C" int qtt_fp8_matmul(const void* x, const void* w, const void* scale, void* out,
                              int M, int K, int N, void* stream) {
  // TMA reads x and w from 16-byte aligned bases; f32 scales, bf16 pairs out
  if (M <= 0 || K <= 0 || N <= 0 || K % kBlock || N % kBlock) return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || (reinterpret_cast<uintptr_t>(scale) & 3u) ||
      (reinterpret_cast<uintptr_t>(out) & 3u))
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  // rows of x per block: the fewest 8-row groups that hold M, up to 64
  if (M <= 8) return launch<1>(x, w, scale, out, M, K, N, st);
  if (M <= 16) return launch<2>(x, w, scale, out, M, K, N, st);
  if (M <= 32) return launch<4>(x, w, scale, out, M, K, N, st);
  return launch<8>(x, w, scale, out, M, K, N, st);
}
