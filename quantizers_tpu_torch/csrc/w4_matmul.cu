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
// Arithmetic, as the JAX kernel's: the codes c - 8 (integers in -8..7,
// exact in bf16) are multiplied with the bf16 activations and summed in f32
// within a group, and each f32 partial sum is multiplied by its group's
// scale in f32 and added to the output's f32 sum. No weight is ever rounded
// to bf16 as (c - 8) * scale: a one-hot row of x reads out the f32 product
// rounded once, as the plain version gives it.
//
// What bounds it on the H100 SXM: bytes. At decode (M = 8) a Qwen3-4B
// decoder layer's four calls (qkv, o_proj, gate|up, down) read 56.8 MB of
// payload and scales, 17.2 us at 3.35 TB/s.
//
// Two bodies; the entry chooses by g % 16 alone:
//
// * 16 | g (every layout the serving paths build: g 32 on the main path):
//   the tensor-core skeleton of the packed NVFP4 kernel (nvfp4_matmul.cu),
//   which reads the same split-half (K/2, N) layout.
//   - outT = WT . xT with mma.sync.m16n8k16 bf16 -> f32: the 16 rows of A
//     are 16 output columns of a k16 slice of W, the 8 columns of B are 8
//     rows of x. A block owns 128 columns (8 warps, one m16 tile each), so
//     each staged row is one 128-byte line; M is tiled in 64s (1, 2, 4 or 8
//     mma per A fragment).
//   - A ninth warp is the producer: one thread loads each stage by TMA into
//     a ring of 3 stages (2-D tensor maps, the 128-byte swizzle: piece c of
//     staged row r at c ^ (r % 8), common.cuh: w_off), completing on the
//     stage's mbarrier; the consumer warps free a stage on another. A stage
//     is 64 packed rows, both planes of x (columns k0.. and K/2 + k0..) and,
//     when g | 64, the scale rows of both planes.
//   - One ldmatrix.x4.trans per 32 packed rows: lane (gid, t) holds bytes
//     (p, c0), (p, c1), (p + 1, c0), (p + 1, c1), columns c0 = 2 gid,
//     c1 = c0 + 1 of its warp's tile. A pair of nibbles becomes the bf16
//     pair 128 + c by one mask-or with 0x43004300 (after a shift by 4, 8 or
//     12), and one bf16x2 subtract of 136 gives c - 8, exactly.
//   - Each k16 step lies in one group of each plane (16 | g, and 2g | K puts
//     K/2 on a group boundary). Its products go into a fresh f32 fragment,
//     which is folded into the accumulator with one f32 multiply-add by its
//     column's scale: c0, c1 (A row gid) belong to column col, c2, c3 to
//     col + 1. When 32 | g (the main path's g 32), the two k16 steps of an
//     ldmatrix share one fragment and one fold. At g | 64 the scale pair of
//     a column comes from the staged rows; at other g (48, 128, ...) it is
//     read from device memory when a group starts.
//   - The blocks of a thread block cluster split K and push their partial
//     sums to the owning rank, and the split is doubled while SMs hold one
//     block (splitk.cuh). At m 8: 192 / 160 / 304 / 160 blocks for qkv /
//     o_proj / gate|up / down.
// * g not divisible by 16 (even g of 8, 24, ... that the wrapper admits): a
//   k16 step would span two groups. The CUDA-core body below takes these:
//   32-column blocks, one column per lane, products in f32 FMAs. No serving
//   path reaches it.
//
// One launch a call, no atomics and no workspace: two calls give the same
// bits.

#include "splitk.cuh"

namespace {
using namespace qtt;

// --- the tensor-core body (16 | g) ---------------------------------------------

constexpr int kWarps = 8;                   // consumer warps: one m16 column tile each
constexpr int kThreads = 32 * kWarps + 32;  // and one producer warp
constexpr int kCols = 16 * kWarps;          // output columns per block
constexpr int kRingBytes = 113 * 1024;      // a block's shared memory: 2 blocks fit an SM
constexpr int kRows = 64;                   // packed rows per stage: 128 K rows, 64 a plane
constexpr int kSlots = kRows / 16;          // most scale rows of a stage, each plane (g = 16)

static_assert(kCols == kLine, "a staged row is one 128-byte line (common.cuh: w_off)");

// One stage of the ring, as TMA writes it: the packed tile [kRows][128
// bytes] in the 128-byte swizzle (piece c of row r at w_off(r, c)); x's lo
// plane (columns k0 ..) and hi plane (K/2 + k0 ..) as boxes [8 MG rows][64
// bf16], swizzled the same way; then the scale rows of the lo plane
// [kSlots][128] bf16 and of the hi plane, as they are (g | 64: 64 / g rows
// of each are used). Beside the ring: the block's f32 outputs as the
// cluster's ranks send them, and the mbarriers (full and empty a stage, and
// splitk.cuh's `reduced`).
template <int MG>
struct Stage {
  static constexpr int kW = kRows * kCols;
  static constexpr int kXBox = 8 * MG * 128;
  static constexpr int kS = kSlots * kCols * 2;  // one plane's scale rows
  static constexpr int kBytes = kW + 2 * kXBox + 2 * kS;
  static constexpr int kOut = 8 * MG * kCols;  // f32
  // the deepest ring, up to 3, that leaves room for 2 blocks an SM (the
  // outputs, the mbarriers and room to align the ring to 1024 beside it)
  static constexpr int kFit = (kRingBytes - kOut * 4 - 1024 - 7 * 8) / kBytes;
  static constexpr int kStages = kFit < 3 ? kFit : 3;
  static constexpr int kSmem = kStages * kBytes + kOut * 4 + (2 * kStages + 1) * 8 + 1024;
  static_assert(kBytes % 1024 == 0 && kStages >= 2 && kSmem <= kRingBytes, "ring");
};

// One block: 128 columns (warp w < 8: columns 16w ..) by 8 MG rows of x
// over its cluster rank's share of K's stages (gridDim.z blocks a cluster
// split K); warp 8 is the producer, one of its threads keeps the ring full
// by TMA. kStaged: g | 64 (16, 32 or 64), the scale rows staged with the
// weights; otherwise each group's scale pair is read from device memory.
// kPair: 32 | g, one fold for each two k16 steps; otherwise one a step.
template <int MG, bool kStaged, bool kPair>
__global__ void __launch_bounds__(kThreads)
w4_mma_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap ts, const __nv_bfloat16* __restrict__ scale,
              __nv_bfloat16* __restrict__ out, int M, int K, int N, int g) {
  using St = Stage<MG>;
  constexpr int S = St::kStages;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the swizzle atoms start on 1024-byte boundaries
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* red = reinterpret_cast<float*>(ring + S * St::kBytes);  // [ranks][kOut / ranks]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + St::kOut);  // a stage has landed
  uint64_t* empty = full + S;     // every consumer warp is done with a stage
  uint64_t* reduced = empty + S;  // every rank's share of this block's outputs has landed
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * 8 * MG;
  const int half = K / 2;
  const int all = (half + kRows - 1) / kRows;
  const int s0 = all * blockIdx.z / gridDim.z;
  const int nk = all * (blockIdx.z + 1) / gridDim.z - s0;
  const int gs = __ffs(g) - 1;  // log2 g, where g | 64
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kWarps);
    }
  }
  push_init(reduced, St::kOut * 4);  // its fence and barrier publish these barriers too

  float acc[MG][4];
#pragma unroll
  for (int mg = 0; mg < MG; ++mg)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[mg][j] = 0.f;
  const int col = warp * 16 + 2 * gid;  // A rows gid, gid + 8: columns col, col + 1

  if (warp == kWarps) {
    // the producer: stage s0 + s (packed rows from (s0 + s) * kRows) into
    // slot s % S once the consumers are done with its last use. Packed rows
    // past K/2 and rows of x past M arrive as zeros, so they add 0.
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tw) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tx) : "memory");
      const uint32_t bytes = St::kW + 2 * St::kXBox + (kStaged ? 2 * (kRows >> gs) * kCols * 2 : 0);
      for (int s = 0; s < nk; ++s) {
        const int slot = s % S;
        if (s >= S) mbar_wait(empty + slot, (s / S - 1) & 1);
        uint8_t* base = ring + slot * St::kBytes;
        const int k0 = (s0 + s) * kRows;
        uint64_t* bar = full + slot;
        mbar_expect(bar, bytes);
        tma_load_2d(base, &tw, n0, k0, bar);
        tma_load_2d(base + St::kW, &tx, k0, m0, bar);
        tma_load_2d(base + St::kW + St::kXBox, &tx, half + k0, m0, bar);
        if (kStaged) {
          // 64 / g scale rows a plane: the lo plane's from group k0 / g, the
          // hi plane's K / 2g further on
          uint8_t* sb = base + St::kW + 2 * St::kXBox;
          tma_load_2d(sb, &ts, n0, k0 >> gs, bar);
          tma_load_2d(sb + St::kS, &ts, n0, (half + k0) >> gs, bar);
        }
      }
    }
    __syncwarp();  // the warp meets again before the reduction's aligned barriers
  } else {
    // unstaged scales: the pairs of the current group of each plane, the
    // group's index and the K row (of the lo plane) at which the next group
    // starts (a k16 step or a pair of them crosses one group boundary at
    // most); the hi plane's group is K / 2g further on (K/2 is a boundary)
    float2 slo = make_float2(0.f, 0.f), shi = slo;
    const int hg = kStaged ? 0 : half / g;
    int grp = kStaged ? 0 : s0 * kRows / g - 1;
    int next = (grp + 1) * g;
    for (int s = 0; s < nk; ++s) {
      const int slot = s % S;
      mbar_wait(full + slot, (s / S) & 1);
      const uint8_t* base = ring + slot * St::kBytes;
      const uint8_t* xl = base + St::kW + gid * 128 + 4 * t;  // x_frag's boxes
      const uint8_t* xh = xl + St::kXBox;
      const __nv_bfloat16* sl =
          reinterpret_cast<const __nv_bfloat16*>(base + St::kW + 2 * St::kXBox);
      const __nv_bfloat16* sh = sl + kSlots * kCols;
      const int k0 = (s0 + s) * kRows;
#pragma unroll
      for (int kr = 0; kr < kRows; kr += 32) {
        uint32_t wr[4];
        ldmatrix_x4_trans(wr, base + w_off(kr + lane, warp));
        // one fold for each k16 step, or (kPair: 32 | g, so both steps of
        // these 32 rows lie in one group) one for both, whose products
        // share one fresh fragment
#pragma unroll
        for (int st = 0; st < (kPair ? 1 : 2); ++st) {
          const int kk = kr + 16 * st;  // the fold's first packed row in the stage
          // the scale pairs (columns col, col + 1) of both planes' groups
          if (kStaged) {
            slo = scale_pair(sl + (kk >> gs) * kCols + col);
            shi = scale_pair(sh + (kk >> gs) * kCols + col);
          } else if (k0 + kk >= next && k0 + kk < half) {
            // a group starts: its scale pairs in both planes
            ++grp;
            next += g;
            slo = __bfloat1622float2(__ldg(
                reinterpret_cast<const __nv_bfloat162*>(scale + (size_t)grp * N + n0 + col)));
            shi = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(
                scale + (size_t)(grp + hg) * N + n0 + col)));
          }
          constexpr int kSteps = kPair ? 2 : 1;
          uint32_t alo[kSteps][4], ahi[kSteps][4];
#pragma unroll
          for (int j = 0; j < kSteps; ++j) {
            decode_w4(wr[2 * (st + j)], alo[j][0], alo[j][1], ahi[j][0], ahi[j][1]);
            decode_w4(wr[2 * (st + j) + 1], alo[j][2], alo[j][3], ahi[j][2], ahi[j][3]);
          }
          const int c = kk / 8;  // the 16-byte piece of x's K columns kk ..
#pragma unroll
          for (int mg = 0; mg < MG; ++mg) {
            float p[4];
            mma_bf16_fresh(p, alo[0], x_frag(xl, mg, c, gid), x_frag(xl, mg, c + 1, gid));
            if constexpr (kPair)
              mma_bf16(p, alo[1], x_frag(xl, mg, c + 2, gid), x_frag(xl, mg, c + 3, gid));
            fold(acc[mg], p, slo);
            mma_bf16_fresh(p, ahi[0], x_frag(xh, mg, c, gid), x_frag(xh, mg, c + 1, gid));
            if constexpr (kPair)
              mma_bf16(p, ahi[1], x_frag(xh, mg, c + 2, gid), x_frag(xh, mg, c + 3, gid));
            fold(acc[mg], p, shi);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);  // this warp is done with the stage
    }
  }
  push_store<MG, kCols, kThreads>(acc, red, reduced, out, M, N, m0, n0, col, t);
}

// Launch the tensor-core body over column tiles, 8 MG-row tiles of x and a
// cluster that splits K's stages (a stage holds 128 K rows), with the
// packed NVFP4 kernel's second doubling of the split.
template <int MG, bool kStaged, bool kPair>
int launch(const void* x, const void* w, const void* scale, void* out, int M, int K, int N, int g,
           cudaStream_t stream) {
  CUtensorMap tw, tx, ts;
  if (!make_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K / 2, N, kCols, kRows) ||
      !make_map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, 2LL * K, 64, 8 * MG))
    return (int)cudaErrorInvalidValue;
  // the staged scale rows: boxes of 64 / g rows of 128 columns, unswizzled
  if (!kStaged)
    ts = tw;
  else if (!make_map_2d(&ts, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, scale, N, K / g, 2LL * N, kCols,
                        kRows / g, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  static DeviceOnce once;
  return launch_split(once, w4_mma_kernel<MG, kStaged, kPair>, N / kCols,
                      (M + 8 * MG - 1) / (8 * MG), kThreads, Stage<MG>::kSmem, (K + 127) / 128,
                      true, stream, tw, tx, ts, static_cast<const __nv_bfloat16*>(scale),
                      static_cast<__nv_bfloat16*>(out), M, K, N, g);
}

template <bool kStaged, bool kPair>
int launch_rows(const void* x, const void* w, const void* scale, void* out, int M, int K, int N,
                int g, cudaStream_t stream) {
  // rows of x per block: the fewest 8-row groups that hold M, up to 64
  if (M <= 8) return launch<1, kStaged, kPair>(x, w, scale, out, M, K, N, g, stream);
  if (M <= 16) return launch<2, kStaged, kPair>(x, w, scale, out, M, K, N, g, stream);
  if (M <= 32) return launch<4, kStaged, kPair>(x, w, scale, out, M, K, N, g, stream);
  // at 64 rows the paired fold's registers would leave one block an SM
  return launch<8, kStaged, false>(x, w, scale, out, M, K, N, g, stream);
}

// --- the CUDA-core body (g not divisible by 16) -----------------------------------
//
// A block owns 32 output columns and 8 activation rows; each lane of a warp
// owns one column, so a warp reads 32 contiguous bytes (one sector) of a
// packed row. A pass covers 16 segments of K rows (the largest divisor of g
// up to 32 each), one per warp, so each column's K range is shared by the
// block's 16 warps without leaving the block. A warp requests all the bytes
// of its segment before the pass's barrier, so that their latency overlaps
// the staging of the pass's activations in shared memory as f32 (two
// planes: K rows p and K/2 + p). Each nibble becomes a signed value in
// registers; products are summed per segment in f32 and the group scale is
// applied to the segment's sum. At the end the 16 warps' sums meet in shared
// memory and are added in a fixed order.

namespace cuda_core {

constexpr int kBlockCols = 32;  // one column per lane
constexpr int kWarps = 16;      // each on its own K segment of a pass
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxChunk = kWarps * kMaxSeg;  // K rows (of each plane) per pass
static_assert(2 * kMaxChunk * kMTile >= kWarps * kMTile * kBlockCols, "shared buffer");

__global__ void __launch_bounds__(kThreads)
w4_cuda_core_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
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

int launch(const void* x, const void* packed, const void* scale, void* out, int M, int K, int N,
           int g, cudaStream_t stream) {
  const dim3 grid(N / kBlockCols, (M + kMTile - 1) / kMTile);
  w4_cuda_core_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const __nv_bfloat16*>(scale), static_cast<__nv_bfloat16*>(out), M, K, N, g,
      segment_rows(g));
  return (int)cudaGetLastError();
}

}  // namespace cuda_core

}  // namespace

extern "C" int qtt_w4_matmul(const void* x, const void* packed, const void* scale, void* out,
                             int M, int K, int N, int g, void* stream) {
  // 16-byte copies: 8 | K/2 for the rows of both planes of x, 128 | N and
  // 16-byte aligned bases
  if (M <= 0 || g <= 0 || K % (2 * g) || (K / 2) % 8 || N % kCols)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(packed) || !aligned16(scale))
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (g % 16) return cuda_core::launch(x, packed, scale, out, M, K, N, g, st);
  const auto rows = 64 % g == 0
                        ? (g % 32 ? &launch_rows<true, false> : &launch_rows<true, true>)
                        : (g % 32 ? &launch_rows<false, false> : &launch_rows<false, true>);
  return rows(x, packed, scale, out, M, K, N, g, st);
}

extern "C" const char* qtt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
