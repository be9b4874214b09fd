// NVFP4 weight-only matmul for Hopper (sm_90a): y = x @ W^T, bf16 out.
//
// Replaces quantizers_tpu/ops/kernels.py `_nvfp4_kernel` / `_nvfp4_matmul_2d`
// (packed E2M1 codes) and `_nvfp4_i8_kernel` / `_nvfp4_i8_matmul_2d` (the
// int8-doubled layout of the same weights). Two entry points:
//
// * qtt_nvfp4_matmul: packed uint8 (K/2, N), split-half: the low nibble of
//   row p is the E2M1 code of W[p, n], the high nibble that of W[K/2 + p, n].
//   Effective scales bf16 (K/g, N) (the global scale folded in), g = 16.
// * qtt_nvfp4_i8_matmul: int8 (K, N) holding 2x the E2M1 value, with the
//   scales halved, so value * scale is the same product.
//
// x bf16 (M, K). Both follow the JAX kernels' arithmetic: each weight is
// dequantized in f32 (value * scale, exact) and rounded to bf16 once, then
// multiplied with the bf16 activation and summed in f32.
//
// What bounds it on the H100 SXM: bytes at decode. The dense Qwen3-4B
// gate|up call (K 2560, N 19456) reads 24.9 MB packed plus 6.2 MB of scales
// (9.3 us at 3.35 TB/s); the int8 layout reads twice the payload.
//
// The packed kernel does its arithmetic on the CUDA cores: a decode, a
// scale, a bf16 rounding and 8 FMAs per weight at M = 8, so it is bound by
// those operations before it reaches the memory bound. Its design is the w4
// kernel's (w4_matmul.cu): 32 columns per block, one per lane, 16 warps on
// disjoint K segments of every pass, two activation planes. A segment lies
// in one scale group, so each lane loads one scale per segment. The E2M1
// decode is a shift and a mask of a constant in registers (common.cuh:
// fp4_value). Left for later in the packed kernel: tensor-core products
// (E2M1 -> bf16 in registers feeding mma), TMA / cp.async staging, and a
// Hopper relayout of the codes.
//
// The int8 kernel is built for the bytes bound, on the tensor cores:
// * outT = WT . xT with mma.sync.m16n8k16 bf16 -> f32: the 16 rows of A are
//   16 output columns of a k16 slice of W, the 8 columns of B are 8 rows of
//   x, so a decode step at M = 8 fills the instruction with no padding.
// * A block owns 128 output columns (8 warps, one m16 tile each), so each K
//   row of its tile is one whole 128-byte line. Narrower strips (16 or 32
//   bytes of a row a block, tried first) left the H100 at 1.0-1.4 TB/s.
// * To fill the card with so few column tiles (20 at N = 2560), the blocks
//   of a thread block cluster (up to 8, the fewest that put a block on
//   every SM, chosen at launch) split K, and add their sums through
//   distributed shared memory, in a fixed order, in the first block:
//   160 blocks at N = 2560, 192 at 6144, 152 at 19456.
// * The int8 (K, N) tile is staged with cp.async, 16 bytes a copy, 8
//   threads a 128-byte row, in a ring of 3-4 stages of 128 K rows (48 KB of
//   weights in flight a block at M <= 16 while one stage is multiplied).
//   The x rows and the scale rows of the same K range ride in the same
//   stage, as bf16. One __syncthreads a stage; two blocks fit an SM.
// * A warp's A fragments come from the staged tile with one
//   ldmatrix.x4.trans per 32 K rows: lane (g, t) gets the bytes of K rows
//   2t, 2t+1 of columns 2g, 2g+1 of its tile, so A row g is column 2g and
//   A row g+8 is column 2g+1 (the store undoes this). The 16-byte pieces
//   of each staged row are swizzled by the row's index mod 8 (w_off), so
//   the reads are free of bank conflicts, as are the B reads (x rows
//   padded by 16 bytes).
// * Dequantization in registers, two weights an instruction: a byte v
//   (|v| <= 12 in this layout) becomes v + 64 by (b & 0x7F) ^ 0x40, a byte
//   permute puts 0x43 above it (the bf16 192 + v), a bf16x2 subtract of 192
//   gives v exactly and a bf16x2 multiply by the scale pair rounds the exact
//   product once: the reference's f32 product rounded to bf16. With g = 16
//   (NVFP4's group, the only one the serving layouts build) a k16 step
//   needs one scale per column, two per lane, read as one bf16 pair; any
//   other g reads the scale of each K row from device memory (right, not
//   tuned).
// * Each weight fragment is dequantized once for all of the block's rows
//   of x, up to 64 (one mma per 8 rows); M is tiled in 64s, so the row
//   prefills' expert calls (M 128) read the weights twice, not 16 times.
// * One launch, no atomics and no workspace: two calls give the same bits.

#include <cooperative_groups.h>

#include <atomic>

#include "common.cuh"

namespace {
using namespace qtt;
namespace cg = cooperative_groups;

// --- packed E2M1 (K/2, N) ---------------------------------------------------

constexpr int kPCols = 32;  // one column per lane
constexpr int kPWarps = 16;
constexpr int kPThreads = 32 * kPWarps;
constexpr int kPChunk = kPWarps * kMaxSeg;  // K rows (of each plane) per pass
static_assert(2 * kPChunk * kMTile >= kPWarps * kMTile * kPCols, "shared buffer");

__global__ void __launch_bounds__(kPThreads)
nvfp4_packed_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
                    const __nv_bfloat16* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                    int M, int K, int N, int g, int seg) {
  __shared__ __align__(16) float smem[2 * kPChunk * kMTile];
  float* xs_lo = smem;
  float* xs_hi = smem + kPChunk * kMTile;
  const int half = K / 2;
  const int chunk = kPWarps * seg;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * kMTile;
  const int col0 = blockIdx.x * kPCols;
  const int col = col0 + lane;
  const int s0 = warp * seg;

  float acc[kMTile];
#pragma unroll
  for (int m = 0; m < kMTile; ++m) acc[m] = 0.f;

  for (int c0 = 0; c0 < half; c0 += chunk) {
    const int rows = min(chunk, half - c0);  // a multiple of seg
    const bool mine = s0 < rows;
    const uint8_t* wp = packed + (size_t)(c0 + s0) * N + col;
    uint32_t wb[kMaxSeg];
#pragma unroll
    for (int i = 0; i < kMaxSeg; ++i) wb[i] = (mine && i < seg) ? wp[(size_t)i * N] : 0u;
    float sl = 0.f, sh = 0.f;
    if (mine) {
      // a segment lies in one group of each plane (seg divides g and K/2)
      sl = __bfloat162float(scale[(size_t)((c0 + s0) / g) * N + col]);
      sh = __bfloat162float(scale[(size_t)((half + c0 + s0) / g) * N + col]);
    }
    __syncthreads();  // the previous pass is done with the staged x
    stage_x(xs_lo, x, M, K, m0, c0, rows);
    stage_x(xs_hi, x, M, K, m0, half + c0, rows);
    __syncthreads();
    if (!mine) continue;
#pragma unroll
    for (int i = 0; i < kMaxSeg; ++i) {
      if (i >= seg) break;
      const float wl = round_bf16(fp4_value(wb[i] & 0xFu) * sl);
      const float wh = round_bf16(fp4_value(wb[i] >> 4) * sh);
      float xl[kMTile], xh[kMTile];
      load_x8(xs_lo + (s0 + i) * kMTile, xl);
      load_x8(xs_hi + (s0 + i) * kMTile, xh);
#pragma unroll
      for (int m = 0; m < kMTile; ++m) acc[m] = fmaf(xh[m], wh, fmaf(xl[m], wl, acc[m]));
    }
  }
  __syncthreads();  // every warp is done with the staged x: reuse it
  float* red = smem;  // [warp][m][kPCols]
#pragma unroll
  for (int m = 0; m < kMTile; ++m) red[(warp * kMTile + m) * kPCols + lane] = acc[m];
  __syncthreads();
  reduce_store<kPWarps>(red, kPCols, out, M, N, m0, col0);
}

// --- int8-doubled (K, N), tensor cores -----------------------------------------

constexpr int kIWarps = 8;
constexpr int kIThreads = 32 * kIWarps;
constexpr int kICols = 16 * kIWarps;      // output columns per block: one m16 tile a warp
constexpr int kIRows = 128;               // K rows per stage
constexpr int kIMaxSplit = 8;             // most blocks of a cluster (the portable limit)
constexpr int kISlots = kIRows / 16;      // scale rows of a stage at g = 16
constexpr int kIXPitch = kIRows + 8;      // bf16 per staged x row (16 bytes of padding)

// One stage of the ring: the int8 tile [kIRows][128] (16-byte pieces
// swizzled, see w_off), the scale rows [kISlots][128] bf16, then x
// [8 MG][kIXPitch] bf16.
template <int MG>
struct IStage {
  static constexpr int kW = kIRows * kICols;
  static constexpr int kS = kISlots * kICols * 2;
  static constexpr int kX = 8 * MG * kIXPitch * 2;
  static constexpr int kBytes = kW + kS + kX;
  // the ring's depth: 2 blocks of 8 warps fit an SM at every MG
  static constexpr int kStages = MG <= 2 ? 4 : 3;
  static constexpr int kSmem = kStages * kBytes;
  static_assert(kBytes % 16 == 0 && kSmem <= 113 * 1024, "ring");
  static_assert(8 * MG * kICols * 4 <= kSmem, "reduction buffer");
};

static_assert(kICols == kLine, "a staged K row is one 128-byte line (common.cuh: w_off)");

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}


// The bytes of an ldmatrix.trans register, (k, c0), (k, c1), (k+1, c0),
// (k+1, c1), int8-doubled values |v| <= 12, as the bf16 pairs
// lo = (v(k, c0), v(k+1, c0)) * s0 and hi = (v(k, c1), v(k+1, c1)) * s1.
__device__ __forceinline__ void dequant_pairs(uint32_t r, __nv_bfloat162 s0, __nv_bfloat162 s1,
                                              uint32_t& lo, uint32_t& hi) {
  const uint32_t u = (r & 0x7F7F7F7Fu) ^ 0x40404040u;  // each byte v + 64, in 0..127
  const __nv_bfloat162 off = __floats2bfloat162_rn(192.f, 192.f);
  // 0x43 above a byte u is the bf16 128 + u = 192 + v
  const __nv_bfloat162 v0 = __hsub2(as_bf162(__byte_perm(u, 0x43434343u, 0x4240)), off);
  const __nv_bfloat162 v1 = __hsub2(as_bf162(__byte_perm(u, 0x43434343u, 0x4341)), off);
  lo = as_u32(__hmul2(v0, s0));
  hi = as_u32(__hmul2(v1, s1));
}

// One block: 128 columns (warp w: columns 16w ..) by 8 MG rows of x over
// its cluster rank's share of K (gridDim.z blocks a cluster split K).
// kG16: NVFP4's g = 16, the scales staged with the weights; otherwise (any
// g) the scale of each K row is read from device memory.
template <int MG, bool kG16>
__global__ void __launch_bounds__(kIThreads)
nvfp4_i8_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w8,
                const __nv_bfloat16* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                int M, int K, int N, int g) {
  using St = IStage<MG>;
  constexpr int S = St::kStages;
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kICols;
  const int m0 = blockIdx.y * 8 * MG;
  // this block's stages: its share (blockIdx.z of gridDim.z) of K's
  const int all = (K + kIRows - 1) / kIRows;
  const int s0 = all * blockIdx.z / gridDim.z;
  const int nk = all * (blockIdx.z + 1) / gridDim.z - s0;

  // Stage s0 + s (K rows from (s0 + s) * kIRows) into ring slot s % S. Rows
  // of W, x and the scales past K, and rows of x past M, are zero-filled, so
  // they add 0.
  auto load = [&](int s) {
    uint8_t* base = smem + (s % S) * St::kBytes;
    const int k0 = (s0 + s) * kIRows;
    for (int i = threadIdx.x; i < kIRows * kIWarps; i += kIThreads) {
      const int r = i / kIWarps, c = i % kIWarps;  // 8 threads read one 128-byte row
      const bool ok = k0 + r < K;
      cp_async16(base + w_off(r, c), w8 + (size_t)(ok ? k0 + r : 0) * N + n0 + c * 16, ok);
    }
    if (kG16) {
      const int first = k0 / 16, last = (min(k0 + kIRows, K) - 1) / 16;
      for (int i = threadIdx.x; i < kISlots * 16; i += kIThreads) {
        const int grp = first + i / 16;
        const bool ok = grp <= last;
        cp_async16(base + St::kW + i * 16, scale + (size_t)(ok ? grp : 0) * N + n0 + (i % 16) * 8,
                   ok);
      }
    }
    uint8_t* xs = base + St::kW + St::kS;
    constexpr int kChunks = kIRows / 8;  // 16-byte pieces of a staged x row
    for (int i = threadIdx.x; i < 8 * MG * kChunks; i += kIThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const bool ok = m0 + r < M && k0 + c * 8 < K;
      cp_async16(xs + (r * kIXPitch + c * 8) * 2,
                 x + (ok ? (size_t)(m0 + r) * K + k0 + c * 8 : 0), ok);
    }
  };

  float acc[MG][4];
#pragma unroll
  for (int mg = 0; mg < MG; ++mg)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[mg][j] = 0.f;

  const int col = warp * 16 + 2 * gid;  // A rows gid, gid + 8: columns col, col + 1
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < nk; ++s) {
    cp_async_wait<S - 2>();  // this thread's copies of stage s have landed
    __syncthreads();         // everyone's have, and stage s - 1's slot is free
    if (s + S - 1 < nk) load(s + S - 1);
    cp_async_commit();

    const uint8_t* base = smem + (s % S) * St::kBytes;
    const __nv_bfloat16* ss = reinterpret_cast<const __nv_bfloat16*>(base + St::kW);
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(base + St::kW + St::kS);
    const int k0 = (s0 + s) * kIRows;
#pragma unroll
    for (int kr = 0; kr < kIRows; kr += 32) {
      uint32_t wr[4];
      ldmatrix_x4_trans(wr, base + w_off(kr + lane, warp));
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        const int kk = kr + st * 16;  // the k16 step's first row in the stage
        __nv_bfloat162 s0a, s1a, s0b, s1b;  // scale pairs of a0, a1 and of a2, a3
        if (kG16) {
          const int slot = kk / 16;  // k0 is a multiple of 16
          const __nv_bfloat162 sp =
              *reinterpret_cast<const __nv_bfloat162*>(ss + slot * kICols + col);
          s0a = s0b = __low2bfloat162(sp);
          s1a = s1b = __high2bfloat162(sp);
        } else {
          // the scale rows of K rows k, k+1, k+8, k+9
          const int k = k0 + kk + 2 * t;
          const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
          __nv_bfloat162 row[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kj = k + (j & 1) + (j >> 1) * 8;
            row[j] = kj < K ? __ldg(reinterpret_cast<const __nv_bfloat162*>(
                                  scale + (size_t)(kj / g) * N + n0 + col))
                            : zero;
          }
          s0a = __lows2bfloat162(row[0], row[1]);
          s1a = __highs2bfloat162(row[0], row[1]);
          s0b = __lows2bfloat162(row[2], row[3]);
          s1b = __highs2bfloat162(row[2], row[3]);
        }
        uint32_t a[4];
        dequant_pairs(wr[2 * st], s0a, s1a, a[0], a[1]);
        dequant_pairs(wr[2 * st + 1], s0b, s1b, a[2], a[3]);
#pragma unroll
        for (int mg = 0; mg < MG; ++mg) {
          const __nv_bfloat16* xr = xs + (mg * 8 + gid) * kIXPitch + kk + 2 * t;
          mma_bf16(acc[mg], a, *reinterpret_cast<const uint32_t*>(xr),
                   *reinterpret_cast<const uint32_t*>(xr + 8));
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is idle: reuse it for the block's sums

  // c0, c2 are rows 2t of columns col, col + 1; c1, c3 rows 2t + 1
  float* fin = reinterpret_cast<float*>(smem);  // [8 MG rows][kICols]
#pragma unroll
  for (int mg = 0; mg < MG; ++mg) {
    float* rr = fin + (mg * 8 + 2 * t) * kICols + col;
    *reinterpret_cast<float2*>(rr) = make_float2(acc[mg][0], acc[mg][2]);
    *reinterpret_cast<float2*>(rr + kICols) = make_float2(acc[mg][1], acc[mg][3]);
  }
  // the cluster's shares of K meet in its first block's shared memory and
  // are added in a fixed order (rank 0 first)
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0) {
    const int ranks = (int)cluster.num_blocks();
    for (int i = threadIdx.x; i < 8 * MG * kICols / 2; i += kIThreads) {
      const int m = i / (kICols / 2), c = 2 * (i % (kICols / 2));
      if (m0 + m >= M) break;  // i grows with m
      float2 sum = make_float2(0.f, 0.f);
      for (int r = 0; r < ranks; ++r) {
        const float2 v =
            *reinterpret_cast<const float2*>(cluster.map_shared_rank(fin, r) + m * kICols + c);
        sum.x += v.x;
        sum.y += v.y;
      }
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(m0 + m) * N + n0 + c) =
          __floats2bfloat162_rn(sum.x, sum.y);
    }
  }
  cluster.sync();  // the other blocks' sums stay readable until they are read
}

template <int MG, bool kG16>
int launch_i8(const void* x, const void* w8, const void* scale, void* out, int M, int K, int N,
              int g, cudaStream_t stream) {
  constexpr int smem = IStage<MG>::kSmem;
  // the shared-memory limit is raised, and the SMs counted, once per device
  static std::atomic<uint64_t> raised{0};
  static std::atomic<int> sms[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const uint64_t bit = 1ull << (dev & 63);
  if (!(raised.load() & bit)) {
    e = cudaFuncSetAttribute(nvfp4_i8_kernel<MG, kG16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    int count = 0;
    e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    sms[dev & 63].store(count);
    raised.fetch_or(bit);
  }
  // split K over a cluster of the fewest blocks (a power of two, at most
  // 8) that puts a block on every SM, each block keeping 2 stages or more:
  // all blocks then run in one wave (2 fit an SM)
  const int tiles = (N / kICols) * ((M + 8 * MG - 1) / (8 * MG));
  const int stages = (K + kIRows - 1) / kIRows;
  int split = 1;
  while (split < kIMaxSplit && tiles * split < sms[dev & 63].load() && stages >= 4 * split)
    split *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / kICols, (M + 8 * MG - 1) / (8 * MG), split);
  cfg.blockDim = dim3(kIThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, nvfp4_i8_kernel<MG, kG16>,
                                 static_cast<const __nv_bfloat16*>(x),
                                 static_cast<const int8_t*>(w8),
                                 static_cast<const __nv_bfloat16*>(scale),
                                 static_cast<__nv_bfloat16*>(out), M, K, N, g);
}

template <bool kG16>
int launch_i8_rows(const void* x, const void* w8, const void* scale, void* out, int M, int K,
                   int N, int g, cudaStream_t stream) {
  // rows of x per block: the fewest 8-row groups that hold M, up to 64
  if (M <= 8) return launch_i8<1, kG16>(x, w8, scale, out, M, K, N, g, stream);
  if (M <= 16) return launch_i8<2, kG16>(x, w8, scale, out, M, K, N, g, stream);
  if (M <= 32) return launch_i8<4, kG16>(x, w8, scale, out, M, K, N, g, stream);
  return launch_i8<8, kG16>(x, w8, scale, out, M, K, N, g, stream);
}

}  // namespace

extern "C" int qtt_nvfp4_matmul(const void* x, const void* packed, const void* scale, void* out,
                                int M, int K, int N, int g, void* stream) {
  if (M <= 0 || g <= 0 || K % (2 * g) || N % kPCols) return (int)cudaErrorInvalidValue;
  const dim3 grid(N / kPCols, (M + kMTile - 1) / kMTile);
  nvfp4_packed_kernel<<<grid, kPThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const __nv_bfloat16*>(scale), static_cast<__nv_bfloat16*>(out),
      M, K, N, g, segment_rows(g));
  return (int)cudaGetLastError();
}

extern "C" int qtt_nvfp4_i8_matmul(const void* x, const void* w8, const void* scale, void* out,
                                   int M, int K, int N, int g, void* stream) {
  // 16-byte copies: 8 | K for the x rows, 128 | N and 16-byte aligned bases
  if (M <= 0 || g <= 0 || K % g || K % 8 || N % kICols) return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w8) || !aligned16(scale)) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return g == 16 ? launch_i8_rows<true>(x, w8, scale, out, M, K, N, g, st)
                 : launch_i8_rows<false>(x, w8, scale, out, M, K, N, g, st);
}
