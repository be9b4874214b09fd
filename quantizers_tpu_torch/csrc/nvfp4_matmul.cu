// NVFP4 weight-only matmul for Hopper (sm_90a): y = x @ W^T, bf16 out.
//
// Replaces quantizers_tpu/ops/kernels.py `_nvfp4_kernel` / `_nvfp4_matmul_2d`
// (packed E2M1 codes) and `_nvfp4_i8_kernel` / `_nvfp4_i8_matmul_2d` (the
// int8-doubled layout of the same weights). Two entry points:
//
// * qtt_nvfp4_matmul: packed uint8 (K/2, N), split-half: the low nibble of
//   row p is the E2M1 code of W[p, n], the high nibble that of W[K/2 + p, n].
//   Effective scales bf16 (K/g, N) (the global scale folded in); NVFP4's
//   g is 16, and any g with 2g | K is taken.
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
// Both kernels share one design, built for the bytes bound on the tensor
// cores:
// * outT = WT . xT with mma.sync.m16n8k16 bf16 -> f32: the 16 rows of A are
//   16 output columns of a k16 slice of W, the 8 columns of B are 8 rows of
//   x, so a decode step at M = 8 fills the instruction with no padding.
// * A block owns 128 output columns (8 warps, one m16 tile each), so each
//   staged row of its tile is one whole 128-byte line. Narrower strips (16
//   or 32 bytes of a row a block, tried first) left the H100 at 1.0-1.4
//   TB/s.
// * To fill the card with so few column tiles (20 at N = 2560), the blocks
//   of a thread block cluster (up to 8, the fewest that put a block on
//   every SM, chosen at launch) split K: 160 blocks at N = 2560, 192 at
//   6144, 152 at 19456 (304 for the packed kernel, whose blocks then run 2
//   an SM). Each rank owns 1 / ranks of the block's outputs; every rank
//   pushes its partial sums of them to that rank (st.async into its shared
//   memory, completing on its mbarrier), and the owner adds them in rank
//   order and writes them. No closing cluster barrier: a rank exits once
//   its own outputs are out (the reduction of K9, fp8_matmul.cu). The
//   reduction, the split rule and the cluster launch live in splitk.cuh,
//   shared with the W4A16 kernel (w4_matmul.cu).
// * The weight tile is staged with cp.async, 16 bytes a copy, 8 threads a
//   128-byte row, in a ring of stages of 128 K rows; the x rows and the
//   scale rows of the same K range ride in the same stage, as bf16. One
//   __syncthreads a stage; two blocks fit an SM.
// * A warp's A fragments come from the staged tile with one
//   ldmatrix.x4.trans per 32 staged rows: lane (g, t) gets the bytes of rows
//   2t, 2t+1 of columns 2g, 2g+1 of its tile, so A row g is column 2g and
//   A row g+8 is column 2g+1 (the store undoes this). The 16-byte pieces
//   of each staged row are swizzled by the row's index mod 8 (w_off), so
//   the reads are free of bank conflicts, as are the B reads (x rows
//   padded by 16 bytes).
// * Each weight is dequantized in registers to the exact bf16 value, and a
//   bf16x2 multiply by the scale pair rounds the exact product once: the
//   reference's f32 product rounded to bf16. With g = 16 (NVFP4's group,
//   the only one the serving layouts build) a k16 step needs one scale per
//   column, two per lane, read as one bf16 pair from the staged rows; any
//   other g reads the scale of each K row from device memory (right, not
//   tuned).
// * Each weight fragment is dequantized once for all of the block's rows
//   of x, up to 64 (one mma per 8 rows); M is tiled in 64s, so the row
//   prefills' expert calls (M 128) read the weights twice, not 16 times.
// * One launch, no atomics and no workspace: two calls give the same bits.
//
// The int8 kernel's stage is 128 rows of the (K, N) tile. Its
// dequantization takes two weights an instruction: a byte v (|v| <= 12 in
// this layout) becomes v + 64 by (b & 0x7F) ^ 0x40, a byte permute puts
// 0x43 above it (the bf16 192 + v), and a bf16x2 subtract of 192 gives v.
//
// The packed kernel's stage is 64 rows of the (K/2, N) tile, which hold
// 128 K rows: a byte's low nibble is row p of the lo plane (K row p), its
// high nibble row p of the hi plane (K row K/2 + p). So a stage carries two
// planes of x (columns k0.. and K/2 + k0..) and, at g = 16, two planes of
// scale rows, and each ldmatrix register feeds two mma per 8 rows of x,
// one a plane. The E2M1 decode (sm_90a has no E2M1 conversion; cvt's
// e2m1x2 forms need sm_100a) builds each bf16x2 pair from the nibbles in
// three integer instructions: the sign to bit 15, the 3-bit magnitude code
// to bits 6-8. That bf16 is the E2M1 value times 2^-126 (0.5 becomes the
// subnormal 2^-127): a multiply by 2^126 makes it exact, and the multiply
// by the scale pair rounds once. The scales are not halved to reuse the
// int8 trick: halving a subnormal bf16 scale drops its low bit. What moved
// its time on the H100 (PERF.md, section 6): the pushed reduction (in place of
// one rank reading every rank's sums between two cluster barriers), a ring
// of 4 stages (8 was slower) and the second doubling of the split. Not the
// decode: with none at all the kernel was 13% faster, and a one-multiply
// path for scales below 4 and integer work moved to the multiply pipe were
// both slower.

#include <type_traits>

#include "splitk.cuh"

namespace {
using namespace qtt;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 16 * kWarps;  // output columns per block: one m16 tile a warp
constexpr int kRingBytes = 113 * 1024;  // a block's shared memory: 2 blocks fit an SM

static_assert(kCols == kLine, "a staged row is one 128-byte line (common.cuh: w_off)");

// --- int8-doubled (K, N) ------------------------------------------------------

constexpr int kIRows = 128;           // K rows per stage
constexpr int kISlots = kIRows / 16;  // scale rows of a stage at g = 16
constexpr int kIXPitch = kIRows + 8;  // bf16 per staged x row (16 bytes of padding)

// One stage of the ring: the int8 tile [kIRows][128] (16-byte pieces
// swizzled, see w_off), the scale rows [kISlots][128] bf16, then x
// [8 MG][kIXPitch] bf16. Beside the ring: the block's f32 outputs as the
// cluster's ranks send them, and an mbarrier (push_store).
template <int MG>
struct IStage {
  static constexpr int kW = kIRows * kCols;
  static constexpr int kS = kISlots * kCols * 2;
  static constexpr int kX = 8 * MG * kIXPitch * 2;
  static constexpr int kBytes = kW + kS + kX;
  static constexpr int kOut = 8 * MG * kCols;  // f32
  // the deepest ring that leaves room for 2 blocks an SM
  static constexpr int kStages = MG <= 2 ? 4 : MG == 4 ? 3 : 2;
  static constexpr int kRing = kStages * kBytes;
  static constexpr int kSmem = kRing + kOut * 4 + 16;
  static_assert(kBytes % 16 == 0 && kSmem <= kRingBytes, "ring");
};

// --- packed E2M1 (K/2, N) -----------------------------------------------------

constexpr int kPRows = 64;            // packed rows per stage: 128 K rows, 64 a plane
constexpr int kPSlots = kPRows / 16;  // scale rows of a stage, each plane, at g = 16
constexpr int kPXPitch = kPRows + 8;  // bf16 per staged x row (16 bytes of padding)

// One stage of the ring: the packed tile [kPRows][128] (swizzled), the
// scale rows of the lo plane [kPSlots][128] bf16 and of the hi plane, then
// x's lo plane [8 MG][kPXPitch] bf16 and its hi plane. Beside the ring: the
// block's f32 outputs as the cluster's ranks send them (each rank receives
// every rank's partials of its 1 / ranks of them) and an mbarrier. The ring
// holds 4 stages (2 at MG 8, where no more fit): 8 stages at m 8 ran slower
// on the H100 than 3 or 4, and 2 slower still.
template <int MG>
struct PStage {
  static constexpr int kW = kPRows * kCols;
  static constexpr int kS = 2 * kPSlots * kCols * 2;
  static constexpr int kXPlane = 8 * MG * kPXPitch;  // bf16
  static constexpr int kX = 2 * kXPlane * 2;
  static constexpr int kBytes = kW + kS + kX;
  static constexpr int kOut = 8 * MG * kCols;  // f32
  static constexpr int kFit = (kRingBytes - kOut * 4 - 16) / kBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kRing = kStages * kBytes;
  static constexpr int kSmem = kRing + kOut * 4 + 16;
  static_assert(kBytes % 16 == 0 && kStages >= 2 && kSmem <= kRingBytes, "ring");
};

// One block: 128 columns (warp w: columns 16w ..) by 8 MG rows of x over
// its cluster rank's share of K (gridDim.z blocks a cluster split K).
// kG16: NVFP4's g = 16, the scales staged with the weights; otherwise (any
// g) the scale of each K row is read from device memory.
template <int MG, bool kG16>
__global__ void __launch_bounds__(kThreads)
nvfp4_i8_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w8,
                const __nv_bfloat16* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                int M, int K, int N, int g) {
  using St = IStage<MG>;
  constexpr int S = St::kStages;
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * 8 * MG;
  // this block's stages: its share (blockIdx.z of gridDim.z) of K's
  const int all = (K + kIRows - 1) / kIRows;
  const int s0 = all * blockIdx.z / gridDim.z;
  const int nk = all * (blockIdx.z + 1) / gridDim.z - s0;
  float* red = reinterpret_cast<float*>(smem + St::kRing);
  uint64_t* reduced = reinterpret_cast<uint64_t*>(red + St::kOut);
  push_init(reduced, St::kOut * 4);

  // Stage s0 + s (K rows from (s0 + s) * kIRows) into ring slot s % S. Rows
  // of W, x and the scales past K, and rows of x past M, are zero-filled, so
  // they add 0.
  auto load = [&](int s) {
    uint8_t* base = smem + (s % S) * St::kBytes;
    const int k0 = (s0 + s) * kIRows;
    for (int i = threadIdx.x; i < kIRows * kWarps; i += kThreads) {
      const int r = i / kWarps, c = i % kWarps;  // 8 threads read one 128-byte row
      const bool ok = k0 + r < K;
      cp_async16(base + w_off(r, c), w8 + (size_t)(ok ? k0 + r : 0) * N + n0 + c * 16, ok);
    }
    if (kG16) {
      const int first = k0 / 16, last = (min(k0 + kIRows, K) - 1) / 16;
      for (int i = threadIdx.x; i < kISlots * 16; i += kThreads) {
        const int grp = first + i / 16;
        const bool ok = grp <= last;
        cp_async16(base + St::kW + i * 16, scale + (size_t)(ok ? grp : 0) * N + n0 + (i % 16) * 8,
                   ok);
      }
    }
    uint8_t* xs = base + St::kW + St::kS;
    constexpr int kChunks = kIRows / 8;  // 16-byte pieces of a staged x row
    for (int i = threadIdx.x; i < 8 * MG * kChunks; i += kThreads) {
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
          const __nv_bfloat162 sp =
              *reinterpret_cast<const __nv_bfloat162*>(ss + (kk / 16) * kCols + col);
          s0a = s0b = __low2bfloat162(sp);
          s1a = s1b = __high2bfloat162(sp);
        } else {
          row_scales(scale, k0 + kk + 2 * t, K, g, N, n0 + col, s0a, s1a, s0b, s1b);
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
  push_store<MG, kCols, kThreads>(acc, red, reduced, out, M, N, m0, n0, col, t);
}

// The packed kernel: the same block over stages of kPRows packed rows,
// each of which holds K rows k0 + p (lo plane) and K/2 + k0 + p (hi plane).
template <int MG, bool kG16>
__global__ void __launch_bounds__(kThreads)
nvfp4_packed_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
                    const __nv_bfloat16* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                    int M, int K, int N, int g) {
  using St = PStage<MG>;
  constexpr int S = St::kStages;
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * 8 * MG;
  const int half = K / 2;
  const int all = (half + kPRows - 1) / kPRows;
  const int s0 = all * blockIdx.z / gridDim.z;
  const int nk = all * (blockIdx.z + 1) / gridDim.z - s0;
  float* red = reinterpret_cast<float*>(smem + St::kRing);
  uint64_t* reduced = reinterpret_cast<uint64_t*>(red + St::kOut);
  push_init(reduced, St::kOut * 4);

  // Stage s0 + s (packed rows from (s0 + s) * kPRows) into ring slot s % S.
  // Packed rows past K/2 and their x columns and scale rows, and rows of x
  // past M, are zero-filled, so they add 0.
  auto load = [&](int s) {
    uint8_t* base = smem + (s % S) * St::kBytes;
    const int k0 = (s0 + s) * kPRows;
    for (int i = threadIdx.x; i < kPRows * kWarps; i += kThreads) {
      const int r = i / kWarps, c = i % kWarps;  // 8 threads read one 128-byte row
      const bool ok = k0 + r < half;
      cp_async16(base + w_off(r, c), packed + (size_t)(ok ? k0 + r : 0) * N + n0 + c * 16, ok);
    }
    if (kG16) {
      // lo-plane scale rows k0/16 .., then the hi plane's, K/32 further on
      for (int i = threadIdx.x; i < 2 * kPSlots * 16; i += kThreads) {
        const int plane = i / (kPSlots * 16), row = (i / 16) % kPSlots;
        const bool ok = k0 + row * 16 < half;
        const int grp = plane * (half / 16) + k0 / 16 + row;
        cp_async16(base + St::kW + i * 16, scale + (size_t)(ok ? grp : 0) * N + n0 + (i % 16) * 8,
                   ok);
      }
    }
    uint8_t* xs = base + St::kW + St::kS;
    constexpr int kChunks = kPRows / 8;  // 16-byte pieces of a staged x row
    for (int i = threadIdx.x; i < 2 * 8 * MG * kChunks; i += kThreads) {
      const int plane = i / (8 * MG * kChunks), r = (i / kChunks) % (8 * MG), c = i % kChunks;
      const bool ok = m0 + r < M && k0 + c * 8 < half;
      cp_async16(xs + (plane * St::kXPlane + r * kPXPitch + c * 8) * 2,
                 x + (ok ? (size_t)(m0 + r) * K + plane * half + k0 + c * 8 : 0), ok);
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
    const __nv_bfloat16* sl = reinterpret_cast<const __nv_bfloat16*>(base + St::kW);
    const __nv_bfloat16* sh = sl + kPSlots * kCols;
    const __nv_bfloat16* xl = reinterpret_cast<const __nv_bfloat16*>(base + St::kW + St::kS);
    const __nv_bfloat16* xh = xl + St::kXPlane;
    const int k0 = (s0 + s) * kPRows;
#pragma unroll
    for (int kr = 0; kr < kPRows; kr += 32) {
      uint32_t wr[4];
      ldmatrix_x4_trans(wr, base + w_off(kr + lane, warp));
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        const int kk = kr + st * 16;  // the k16 step's first packed row in the stage
        // scale pairs of a0, a1 (suffix a) and a2, a3 (b), lo and hi plane
        __nv_bfloat162 l0a, l1a, l0b, l1b, h0a, h1a, h0b, h1b;
        if (kG16) {
          const __nv_bfloat162 pl =
              *reinterpret_cast<const __nv_bfloat162*>(sl + (kk / 16) * kCols + col);
          const __nv_bfloat162 ph =
              *reinterpret_cast<const __nv_bfloat162*>(sh + (kk / 16) * kCols + col);
          l0a = l0b = __low2bfloat162(pl);
          l1a = l1b = __high2bfloat162(pl);
          h0a = h0b = __low2bfloat162(ph);
          h1a = h1b = __high2bfloat162(ph);
        } else {
          const int k = k0 + kk + 2 * t;
          row_scales(scale, k, half, g, N, n0 + col, l0a, l1a, l0b, l1b);
          // the hi plane's rows K/2 + k ..: rows at or past K read 0
          row_scales(scale, half + k, K, g, N, n0 + col, h0a, h1a, h0b, h1b);
        }
        uint32_t alo[4], ahi[4];
        dequant_packed(wr[2 * st], l0a, l1a, h0a, h1a, alo[0], alo[1], ahi[0], ahi[1]);
        dequant_packed(wr[2 * st + 1], l0b, l1b, h0b, h1b, alo[2], alo[3], ahi[2], ahi[3]);
#pragma unroll
        for (int mg = 0; mg < MG; ++mg) {
          const int xo = (mg * 8 + gid) * kPXPitch + kk + 2 * t;
          mma_bf16(acc[mg], alo, *reinterpret_cast<const uint32_t*>(xl + xo),
                   *reinterpret_cast<const uint32_t*>(xl + xo + 8));
          mma_bf16(acc[mg], ahi, *reinterpret_cast<const uint32_t*>(xh + xo),
                   *reinterpret_cast<const uint32_t*>(xh + xo + 8));
        }
      }
    }
  }
  push_store<MG, kCols, kThreads>(acc, red, reduced, out, M, N, m0, n0, col, t);
}

// Launch one of the kernels over column tiles, 8 MG-row tiles of x and a
// cluster that splits K's stages.
template <int MG, bool kPacked, bool kG16>
int launch(const void* x, const void* w, const void* scale, void* out, int M, int K, int N, int g,
           cudaStream_t stream) {
  using St = std::conditional_t<kPacked, PStage<MG>, IStage<MG>>;
  const auto kernel = kPacked ? nvfp4_packed_kernel<MG, kG16> : nvfp4_i8_kernel<MG, kG16>;
  // a stage holds 128 K rows in both layouts; the packed kernel's split
  // takes the second doubling (splitk.cuh: split_k)
  static DeviceOnce once;
  return launch_split(once, kernel, N / kCols, (M + 8 * MG - 1) / (8 * MG), kThreads, St::kSmem,
                      (K + 127) / 128, kPacked, stream, static_cast<const __nv_bfloat16*>(x),
                      static_cast<const uint8_t*>(w), static_cast<const __nv_bfloat16*>(scale),
                      static_cast<__nv_bfloat16*>(out), M, K, N, g);
}

template <bool kPacked, bool kG16>
int launch_rows(const void* x, const void* w, const void* scale, void* out, int M, int K, int N,
                int g, cudaStream_t stream) {
  // rows of x per block: the fewest 8-row groups that hold M, up to 64
  if (M <= 8) return launch<1, kPacked, kG16>(x, w, scale, out, M, K, N, g, stream);
  if (M <= 16) return launch<2, kPacked, kG16>(x, w, scale, out, M, K, N, g, stream);
  if (M <= 32) return launch<4, kPacked, kG16>(x, w, scale, out, M, K, N, g, stream);
  return launch<8, kPacked, kG16>(x, w, scale, out, M, K, N, g, stream);
}

template <bool kPacked>
int launch_g(const void* x, const void* w, const void* scale, void* out, int M, int K, int N,
             int g, void* stream) {
  if (!aligned16(x) || !aligned16(w) || !aligned16(scale)) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return g == 16 ? launch_rows<kPacked, true>(x, w, scale, out, M, K, N, g, st)
                 : launch_rows<kPacked, false>(x, w, scale, out, M, K, N, g, st);
}

}  // namespace

extern "C" int qtt_nvfp4_matmul(const void* x, const void* packed, const void* scale, void* out,
                                int M, int K, int N, int g, void* stream) {
  // 16-byte copies: 8 | K/2 for the rows of both planes of x, 128 | N and
  // 16-byte aligned bases
  if (M <= 0 || g <= 0 || K % (2 * g) || (K / 2) % 8 || N % kCols)
    return (int)cudaErrorInvalidValue;
  return launch_g<true>(x, packed, scale, out, M, K, N, g, stream);
}

extern "C" int qtt_nvfp4_i8_matmul(const void* x, const void* w8, const void* scale, void* out,
                                   int M, int K, int N, int g, void* stream) {
  // 16-byte copies: 8 | K for the x rows, 128 | N and 16-byte aligned bases
  if (M <= 0 || g <= 0 || K % g || K % 8 || N % kCols) return (int)cudaErrorInvalidValue;
  return launch_g<false>(x, w8, scale, out, M, K, N, g, stream);
}
