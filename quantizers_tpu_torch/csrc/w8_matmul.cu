// INT8 weight-only matmul for Hopper (sm_90a): y = x @ W^T, bf16 out.
//
// Replaces quantizers_tpu/ops/kernels.py `_w8_kernel` / `_w8_matmul_2d`.
// Weights int8 (K, N); bf16 or f32 scales per channel (1, N) or per group
// (K/g, N). A per-channel scale is passed as one group of g = K rows. The
// kernel is templated on the scale type: f32 scales (the w8pc expert
// layout's) are read as they are, never rounded to bf16. x bf16 (M, K),
// M <= 512.
//
// Arithmetic, as the plain version states it: the codes are exact, the
// products and sums are f32, each group's f32 partial sum is multiplied by
// its f32 scale, bf16 out. With a per-channel scale that is one multiply of
// each column's finished sum: x . (c s) up to f32 rounding. (The JAX kernel
// rounds each c s to bf16 before its dot.) A one-hot row of x reads out
// bf16(f32(c s)) bit for bit.
//
// What bounds it on the H100 SXM: bytes. On the serving paths it is the
// int8 logits head at decode, M 8: K 2560, N 152064 (slice 1; the vocab
// padded to a multiple of 1536) reads 389 MB, 0.117 ms at 3.35 TB/s; path
// A's K 2048 0.094 ms, path E's K 2048, N 102912 0.063 ms. And the w8pc
// experts of path A's row prefills (f32 scales), (K, N) (2048, 1536) and
// (768, 2048) at M 32 or 128, two calls per expert and layer.
//
// Two bodies; the entry chooses by g alone:
//
// * 16 | g (the heads, the w8pc experts and the g 16 .. 128 layouts): the
//   skeleton of the FP8_BLOCK matmul (fp8_matmul.cu), which reads the same
//   one-byte (K, N) layout, over K5b's int8 (K, N) stages.
//   - outT = WT . xT with mma.sync.m16n8k16 bf16 -> f32: the 16 rows of A
//     are 16 output columns of a k16 slice of W, the 8 columns of B are 8
//     rows of x. A block owns 128 columns (8 warps, one m16 tile each), so
//     each staged K row is one 128-byte line; M is tiled in 64s (1, 2, 4 or
//     8 mma per A fragment), so each weight is decoded once for up to 64
//     rows of x.
//   - A ninth warp is the producer: one thread loads each 128-row stage by
//     TMA into a ring of 3 (2 at 64 rows of x), in two halves of 64 rows
//     that complete on their own mbarriers; the consumer warps free a stage
//     on another. The 128-byte swizzle puts piece c of staged row r at
//     c ^ (r % 8) (common.cuh: w_off); x rides in two 64-column boxes.
//   - One ldmatrix.x4.trans per 32 staged rows: lane (gid, t) gets the
//     bytes of rows 2t, 2t+1 of columns 2gid, 2gid+1 of its warp's tile, so
//     A row gid is column 2gid and A row gid + 8 column 2gid + 1.
//   - The decode is exact over the full code range (common.cuh:
//     decode_i8): each byte v ^ 0x80 under the f32 magic number 0x4B000000
//     is 2^23 + 128 + v, one f32 subtract gives v, and the high halves of
//     two such f32 are a bf16 pair. A bf16 magic number (K5b's) holds only 7
//     bits of a code; the route through two nibble planes joined by one bf16
//     add was 2-7% slower on the H100.
//   - g = K (per channel): the products go straight into the f32 sums, and
//     the epilogue multiplies each column's sum by its scale, before the
//     cluster push. 16 | g otherwise: a k16 step lies in one group; its
//     products go into a fresh fragment, folded into the sum with one f32
//     multiply-add by its column's scale. Scale rows ride in the stage when
//     g | 128, else each group's pair is read from device memory when the
//     group starts. The group modes tile M in 32s: at 64 rows their fresh
//     fragments spilled.
//   - The blocks of a thread block cluster split K when the column tiles
//     alone would leave SMs idle, and push their partial sums to the owning
//     rank (splitk.cuh). The heads (804-1188 tiles) run unsplit: splitting
//     them 2 or 4 ways to fill the last wave, or 3 or 4 blocks an SM, was
//     not faster on the H100.
// * 16 does not divide g (g 1 .. 8 and others the wrapper admits): a k16
//   step would span two groups. The CUDA-core body below takes these. No
//   serving path reaches it.
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
constexpr int kRows = 128;                  // K rows per stage, in two halves of 64
constexpr int kMaxStages = 3;
constexpr int kRingBytes = 113 * 1024;      // a block's shared memory: 2 blocks fit an SM

static_assert(kCols == kLine, "a staged row is one 128-byte line (common.cuh: w_off)");

// Where the scales meet the f32 sums: kChannel (g = K) multiplies each
// column's finished sum once; the group modes fold each k16 step's fresh
// products into the sum with one multiply-add, the scale rows staged with
// the weights (kStaged: g | 128) or read from device memory when a group
// starts (kRead).
enum Mode { kChannel, kStaged, kRead };

// One stage of the ring, as TMA writes it: the int8 tile [kRows][128 bytes]
// in the 128-byte swizzle (piece c of row r at w_off(r, c)), x in two boxes
// of 64 K columns [8 MG rows][128 bytes] swizzled the same way, then (the
// staged modes) the 128 / g scale rows of the stage's K range [128 /
// g][128] as they are. Half h of a stage is K rows 64h .. of the tile and
// x box h; the scale rows ride with half 0. Beside the ring: the block's
// f32 outputs as the cluster's ranks send them, and the mbarriers (full for
// each half stage, empty a stage, splitk.cuh's `reduced`).
template <int MG, typename ScaleT, int kMode>
struct Stage {
  static constexpr int kW = kRows * kCols;
  static constexpr int kXBox = 8 * MG * 128;
  static constexpr int kS = kMode == kStaged ? (kRows / 16) * kCols * (int)sizeof(ScaleT) : 0;
  static constexpr int kBytes = kW + 2 * kXBox + kS;
  static constexpr int kOut = 8 * MG * kCols;  // f32
  // the deepest ring, up to kMaxStages, that leaves room for 2 blocks an SM
  // (the outputs, the mbarriers and room to align the ring to 1024 beside it)
  static constexpr int kFit = (kRingBytes - kOut * 4 - (3 * kMaxStages + 1) * 8 - 1024) / kBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = kStages * kBytes + kOut * 4 + (3 * kStages + 1) * 8 + 1024;
  static_assert(kBytes % 1024 == 0 && kStages >= 2 && kSmem <= kRingBytes, "ring");
};

// The scales of columns col, col + 1 as f32, read from device memory.
__device__ __forceinline__ float2 ldg_scale_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

__device__ __forceinline__ float2 ldg_scale_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// One block: 128 columns (warp w < 8: columns 16w ..) by 8 MG rows of x
// over its cluster rank's share of K's stages (gridDim.z blocks a cluster
// split K); warp 8 is the producer, one of its threads keeps the ring full
// by TMA.
template <int MG, typename ScaleT, int kMode>
__global__ void __launch_bounds__(kThreads, 2)
w8_mma_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap ts, const ScaleT* __restrict__ scale,
              __nv_bfloat16* __restrict__ out, int M, int K, int N, int g) {
  using St = Stage<MG, ScaleT, kMode>;
  constexpr int S = St::kStages;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the swizzle atoms start on 1024-byte boundaries
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* red = reinterpret_cast<float*>(ring + S * St::kBytes);  // [ranks][kOut / ranks]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + St::kOut);  // [slot][half] has landed
  uint64_t* empty = full + 2 * S;  // every consumer warp is done with a stage
  uint64_t* reduced = empty + S;   // every rank's share of this block's outputs has landed
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * 8 * MG;
  // this block's stages: its share (blockIdx.z of gridDim.z) of K's
  const int all = K / kRows;
  const int s0 = all * blockIdx.z / gridDim.z;
  const int nk = all * (blockIdx.z + 1) / gridDim.z - s0;
  const int gs = __ffs(g) - 1;  // log2 g, where g | 128
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + 2 * i, 1);
      mbar_init(full + 2 * i + 1, 1);
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
    // the producer: stage s0 + s (K rows from (s0 + s) * kRows) into slot
    // s % S, a half at a time, once the consumers are done with its last
    // use; rows of x past M arrive as zeros, so they add 0
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tw) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tx) : "memory");
      const uint32_t sbytes = kMode == kStaged ? (kRows >> gs) * kCols * (int)sizeof(ScaleT) : 0;
      for (int s = 0; s < nk; ++s) {
        const int slot = s % S;
        if (s >= S) mbar_wait(empty + slot, (s / S - 1) & 1);
        uint8_t* base = ring + slot * St::kBytes;
        const int k0 = (s0 + s) * kRows;
        for (int h = 0; h < 2; ++h) {
          uint64_t* bar = full + 2 * slot + h;
          mbar_expect(bar, St::kW / 2 + St::kXBox + (h ? 0 : sbytes));
          tma_load_2d(base + h * (St::kW / 2), &tw, n0, k0 + h * 64, bar);
          tma_load_2d(base + St::kW + h * St::kXBox, &tx, k0 + h * 64, m0, bar);
          if (kMode == kStaged && h == 0)
            tma_load_2d(base + St::kW + 2 * St::kXBox, &ts, n0, k0 >> gs, bar);
        }
      }
    }
    __syncwarp();  // the warp meets again before the reduction's aligned barriers
  } else {
    // kRead: the scale pair of the current group, its index and the K row at
    // which the next group starts (16 | g: a k16 step lies in one group)
    float2 sc = make_float2(0.f, 0.f);
    int grp = kMode == kRead ? s0 * kRows / g - 1 : 0;
    int next = (grp + 1) * g;
    for (int s = 0; s < nk; ++s) {
      const int slot = s % S;
      const uint8_t* base = ring + slot * St::kBytes;
      const ScaleT* ss = reinterpret_cast<const ScaleT*>(base + St::kW + 2 * St::kXBox);
      const int k0 = (s0 + s) * kRows;
#pragma unroll
      for (int kr = 0; kr < kRows; kr += 32) {
        if (kr % 64 == 0) mbar_wait(full + 2 * slot + kr / 64, (s / S) & 1);  // its half
        uint32_t wr[4];
        ldmatrix_x4_trans(wr, base + w_off(kr + lane, warp));
        // x's box of these 32 K columns, and the 16-byte piece of column kr
        const uint8_t* xb = base + St::kW + (kr / 64) * St::kXBox + gid * 128 + 4 * t;
        const int c = (kr % 64) / 8;
#pragma unroll
        for (int st = 0; st < 2; ++st) {  // the two k16 steps
          uint32_t a[4];
          decode_i8(wr[2 * st], a[0], a[1]);
          decode_i8(wr[2 * st + 1], a[2], a[3]);
          if constexpr (kMode == kChannel) {
#pragma unroll
            for (int mg = 0; mg < MG; ++mg)
              mma_bf16(acc[mg], a, x_frag(xb, mg, c + 2 * st, gid),
                       x_frag(xb, mg, c + 2 * st + 1, gid));
          } else {
            // the step's fresh products, folded in with its group's scale
            const int kk = kr + 16 * st;
            if (kMode == kStaged) {
              sc = scale_pair(ss + (kk >> gs) * kCols + col);
            } else if (k0 + kk >= next) {
              ++grp;
              next += g;
              sc = ldg_scale_pair(scale + (size_t)grp * N + n0 + col);
            }
#pragma unroll
            for (int mg = 0; mg < MG; ++mg) {
              float p[4];
              mma_bf16_fresh(p, a, x_frag(xb, mg, c + 2 * st, gid),
                             x_frag(xb, mg, c + 2 * st + 1, gid));
              fold(acc[mg], p, sc);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);  // this warp is done with the stage
    }
    if constexpr (kMode == kChannel) {
      // the column's scale on its finished f32 sum
      const float2 s = ldg_scale_pair(scale + n0 + col);
#pragma unroll
      for (int mg = 0; mg < MG; ++mg) {
        acc[mg][0] *= s.x;
        acc[mg][1] *= s.x;
        acc[mg][2] *= s.y;
        acc[mg][3] *= s.y;
      }
    }
  }
  push_store<MG, kCols, kThreads>(acc, red, reduced, out, M, N, m0, n0, col, t);
}

// Launch the tensor-core body over column tiles, 8 MG-row tiles of x and a
// cluster that splits K's stages.
template <int MG, typename ScaleT, int kMode>
int launch(const void* x, const void* w8, const void* scale, void* out, int M, int K, int N,
           int g, cudaStream_t stream) {
  constexpr CUtensorMapDataType kScaleType =
      sizeof(ScaleT) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tw, tx, ts;
  if (!make_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w8, N, K, N, kCols, kRows / 2) ||
      !make_map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, 2LL * K, 64, 8 * MG))
    return (int)cudaErrorInvalidValue;
  // the staged scale rows: boxes of 128 / g rows of 128 columns, unswizzled
  if (kMode != kStaged)
    ts = tw;
  else if (!make_map_2d(&ts, kScaleType, scale, N, K / g, (long long)sizeof(ScaleT) * N, kCols,
                        kRows / g, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  static DeviceOnce once;
  return launch_split(once, w8_mma_kernel<MG, ScaleT, kMode>, N / kCols,
                      (M + 8 * MG - 1) / (8 * MG), kThreads, Stage<MG, ScaleT, kMode>::kSmem,
                      K / kRows, false, stream, tw, tx, ts, static_cast<const ScaleT*>(scale),
                      static_cast<__nv_bfloat16*>(out), M, K, N, g);
}

template <typename ScaleT, int kMode>
int launch_rows(const void* x, const void* w8, const void* scale, void* out, int M, int K, int N,
                int g, cudaStream_t stream) {
  // rows of x per block: the fewest 8-row groups that hold M, up to 64
  if (M <= 8) return launch<1, ScaleT, kMode>(x, w8, scale, out, M, K, N, g, stream);
  if (M <= 16) return launch<2, ScaleT, kMode>(x, w8, scale, out, M, K, N, g, stream);
  if (M <= 32) return launch<4, ScaleT, kMode>(x, w8, scale, out, M, K, N, g, stream);
  // the group modes' fresh fragments would spill at 64 rows: they stay at 32
  if constexpr (kMode != kChannel)
    return launch<4, ScaleT, kMode>(x, w8, scale, out, M, K, N, g, stream);
  else
    return launch<8, ScaleT, kMode>(x, w8, scale, out, M, K, N, g, stream);
}

// --- the CUDA-core body (g not divisible by 16) -----------------------------------
//
// A block owns 128 output columns and 8 activation rows; each lane of a
// warp owns four columns, so a warp reads 128 contiguous bytes of a weight
// row. A pass covers 8 segments of K rows (32 rows at most, inside one
// group), one per warp. A warp requests all the rows of its segment before
// the pass's barrier, so that their latency overlaps the staging of the
// pass's activations in shared memory as f32. Products are summed per
// segment in f32, then scaled. The 8 warps' sums meet in shared memory and
// are added in a fixed order.

namespace cuda_core {

constexpr int kWarps = 8;  // each on its own K segment of a pass
constexpr int kThreads = 32 * kWarps;
constexpr int kCols4 = 4;  // columns a lane
constexpr int kBlockCols = 32 * kCols4;
constexpr int kMaxChunk = kWarps * kMaxSeg;  // K rows per pass
// staged x, later the warps' partial sums: the larger of the two
constexpr int kSmem = kWarps * kMTile * kBlockCols;
static_assert(kSmem >= kMaxChunk * kMTile, "shared buffer");

__device__ __forceinline__ float s8(uint32_t w, int i) {
  return (float)(int8_t)((w >> (8 * i)) & 0xFF);
}

// the four scales of a lane's columns, widened to f32
__device__ __forceinline__ void load_scale4(const __nv_bfloat16* p, float (&sv)[kCols4]) {
  const float2 sa = scale_pair(p), sb = scale_pair(p + 2);
  sv[0] = sa.x; sv[1] = sa.y; sv[2] = sb.x; sv[3] = sb.y;
}

__device__ __forceinline__ void load_scale4(const float* p, float (&sv)[kCols4]) {
#pragma unroll
  for (int j = 0; j < kCols4; ++j) sv[j] = p[j];
}

template <typename ScaleT>
__global__ void __launch_bounds__(kThreads)
w8_cuda_core_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w8,
                    const ScaleT* __restrict__ scale, __nv_bfloat16* __restrict__ out, int M,
                    int K, int N, int g, int seg) {
  __shared__ __align__(16) float smem[kSmem];
  float* xs = smem;
  const int chunk = kWarps * seg;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * kMTile;
  const int col0 = blockIdx.x * kBlockCols;
  const int col = col0 + lane * kCols4;
  const int s0 = warp * seg;  // this warp's segment of every pass

  float acc[kMTile][kCols4];
#pragma unroll
  for (int m = 0; m < kMTile; ++m)
#pragma unroll
    for (int j = 0; j < kCols4; ++j) acc[m][j] = 0.f;

  for (int c0 = 0; c0 < K; c0 += chunk) {
    const int rows = min(chunk, K - c0);  // a multiple of seg
    const bool mine = s0 < rows;
    // the segment's words are requested first: their latency overlaps the
    // staging of x and the barriers
    const int8_t* wp = w8 + (size_t)(c0 + s0) * N + col;
    uint32_t wr[kMaxSeg];
#pragma unroll
    for (int i = 0; i < kMaxSeg; ++i)
      wr[i] = (mine && i < seg) ? *reinterpret_cast<const uint32_t*>(wp + (size_t)i * N) : 0u;
    __syncthreads();  // the previous pass is done with the staged x
    stage_x(xs, x, M, K, m0, c0, rows);
    __syncthreads();
    if (!mine) continue;
    float part[kMTile][kCols4];
#pragma unroll
    for (int m = 0; m < kMTile; ++m)
#pragma unroll
      for (int j = 0; j < kCols4; ++j) part[m][j] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxSeg; ++i) {
      if (i >= seg) break;
      const float wv[kCols4] = {s8(wr[i], 0), s8(wr[i], 1), s8(wr[i], 2), s8(wr[i], 3)};
      float xv[kMTile];
      load_x8(xs + (s0 + i) * kMTile, xv);
#pragma unroll
      for (int m = 0; m < kMTile; ++m)
#pragma unroll
        for (int j = 0; j < kCols4; ++j) part[m][j] = fmaf(xv[m], wv[j], part[m][j]);
    }
    float sv[kCols4];
    load_scale4(scale + (size_t)((c0 + s0) / g) * N + col, sv);
#pragma unroll
    for (int m = 0; m < kMTile; ++m)
#pragma unroll
      for (int j = 0; j < kCols4; ++j) acc[m][j] += part[m][j] * sv[j];
  }
  __syncthreads();  // every warp is done with the staged x: reuse it
  float* red = smem;  // [warp][m][kBlockCols]
#pragma unroll
  for (int m = 0; m < kMTile; ++m)
#pragma unroll
    for (int j = 0; j < kCols4; ++j)
      red[(warp * kMTile + m) * kBlockCols + lane * kCols4 + j] = acc[m][j];
  __syncthreads();
  reduce_store<kWarps>(red, kBlockCols, out, M, N, m0, col0);
}

template <typename ScaleT>
int launch(const void* x, const void* w8, const void* scale, void* out, int M, int K, int N,
           int g, cudaStream_t stream) {
  const dim3 grid(N / kBlockCols, (M + kMTile - 1) / kMTile);
  w8_cuda_core_kernel<ScaleT><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w8),
      static_cast<const ScaleT*>(scale), static_cast<__nv_bfloat16*>(out), M, K, N, g,
      segment_rows(g));
  return (int)cudaGetLastError();
}

}  // namespace cuda_core

// The body by g alone: the CUDA-core one for 16 ∤ g, else the tensor-core
// one with the scale mode of g.
template <typename ScaleT>
int launch_g(const void* x, const void* w8, const void* scale, void* out, int M, int K, int N,
             int g, void* stream) {
  // 16-byte copies: 128 | K (whole stages), 128 | N and 16-byte aligned bases
  if (M <= 0 || g <= 0 || K % g || N % kCols) return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w8) || !aligned16(scale)) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (g % 16) return cuda_core::launch<ScaleT>(x, w8, scale, out, M, K, N, g, st);
  if (K % kRows) return (int)cudaErrorInvalidValue;
  if (g == K) return launch_rows<ScaleT, kChannel>(x, w8, scale, out, M, K, N, g, st);
  return kRows % g ? launch_rows<ScaleT, kRead>(x, w8, scale, out, M, K, N, g, st)
                   : launch_rows<ScaleT, kStaged>(x, w8, scale, out, M, K, N, g, st);
}

}  // namespace

extern "C" int qtt_w8_matmul(const void* x, const void* w8, const void* scale, void* out,
                             int M, int K, int N, int g, void* stream) {
  return launch_g<__nv_bfloat16>(x, w8, scale, out, M, K, N, g, stream);
}

// the same with f32 scales
extern "C" int qtt_w8_matmul_f32s(const void* x, const void* w8, const void* scale, void* out,
                                  int M, int K, int N, int g, void* stream) {
  return launch_g<float>(x, w8, scale, out, M, K, N, g, stream);
}
