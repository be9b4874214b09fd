// The slot FFN skeleton of K6 (moe_slot_ffn.cu) and K7 (moe_slot_gu_ffn.cu):
// the slots grouped by expert inside the kernel, 128 output columns a block
// on mma.sync, a ring of cp.async stages.
//
// A slot is one (token, routed expert) pair: a row of x (S, D) bf16 and an
// expert id. Its gated FFN runs in two launches, gate|up then down, with a
// (S, F) bf16 workspace carrying a = bf16(silu(g) * u) between them.
// * Slots grouped by expert, so that each routed expert is read once
//   whatever its number of slots. A work item is a pass: up to 8 slots of
//   one expert (its slots in slot order, 8 at a time), the items ordered by
//   expert id. Block (j, c) owns item j and column tile c. Every block finds
//   its item from idx itself (the slots counted by id in shared memory, then
//   a walk of idx by one warp), so the grid, the most items S slots can make
//   by column tiles, depends on the shapes alone (no sort, no host sync,
//   ready for a CUDA graph); a block past the number of items returns. Ids
//   out of range form one key of their own, whose blocks write NaN rows and
//   read no weights.
// * outT = WT . xT with mma.sync.m16n8k16 bf16 -> f32, the form of the
//   NVFP4 matmul (nvfp4_matmul.cu): the 16 rows of A are 16 output columns
//   of a k16 slice of the expert's matrix, the 8 columns of B are the 8
//   slots of the item, so each weight fragment is decoded once for all of
//   them. Top-k routing puts at most one slot a token on an expert; a
//   hotter expert's items run side by side, each reading the expert's
//   columns (from L2 after the first).
// * A block owns 128 output columns (8 warps, one m16 tile each), so each
//   staged row is one 128-byte line; the gate|up block owns the same 128
//   columns of both matrices and writes a for its item's slots; the down
//   block owns 128 columns of y, f32.
// * Weight tiles are staged with 16-byte cp.async, 8 threads a 128-byte
//   row, in a ring of 3 stages of 64 stored rows (the 16-byte pieces
//   swizzled by row, common.cuh: w_off); the pass's x (or a) rows of the
//   stage ride in the same stage, and with the group-scaled payloads (16 |
//   g) one scale row a k16 step. The first stages' weights are issued as
//   soon as the block knows its expert, before warp 0 walks idx for the
//   pass's slots.
// * Three blocks an SM (at most 80 registers a thread).
// * Each output element is written by one block, its sums in a fixed
//   order: no atomics, and two calls give the same bits.
//
// The payloads (Payload): K6's packed w4, packed E2M1 and int8-doubled E2M1
// with bf16 group scales, each weight rounded to bf16 as value * scale
// before its product; K7's w8pc, int8 codes over their full range decoded
// exactly, the f32 per-channel scales multiplying the finished sums.

#pragma once

#include <type_traits>

#include "splitk.cuh"

namespace qtt {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 16 * kWarps;   // output columns a block: one m16 tile a warp
constexpr int kRows = 64;            // stored weight rows a stage (packed: 128 K rows)
constexpr int kPass = 8;             // slots a pass: the 8 columns of B
constexpr int kXPitch = kRows + 8;   // bf16 a staged x row (16 bytes of padding)
constexpr int kStages = 3;           // the ring (3 blocks an SM)
constexpr int kWindow = 512;         // keys a window of the item search
constexpr int kCounts = kWindow + kWindow / 32;  // its slot counts, padded (count_at)

static_assert(kCols == kLine, "a staged row is one 128-byte line (common.cuh: w_off)");

// kW4, kE2M1: split-half packed nibbles (K/2, N), two planes; kInt8: int8
// (K, N) holding 2x the E2M1 value with halved scales; kW8pc: int8 codes
// (K, N) with f32 per-channel scales (1, N).
enum Payload { kW4 = 0, kE2M1 = 1, kInt8 = 2, kW8pc = 3 };

__host__ __device__ constexpr bool packed_payload(int p) { return p == kW4 || p == kE2M1; }

// One operand: a stack of E matrices of N output columns, `ld` bytes a
// stored row apart, with bf16 group scales (K/g, N), or with f32
// per-channel scales (kW8pc).
struct Mat {
  const uint8_t* w;    // expert 0's payload at the operand's first column
  const void* s;       // expert 0's scales at the operand's first column
  long long w_stride;  // payload bytes an expert
  long long s_stride;  // scale elements an expert
  int ld;              // bytes a stored row (the fused gate|up stack: 2F)
};

// One stage of the ring: for each of the kMats matrices the weight tile
// [kRows][128] (swizzled) and its scale rows [kSRows][128] bf16 (one a k16
// step and plane: the lo plane's, then the hi plane's; kW8pc: none), then
// x's planes [kPass][kXPitch] bf16 (packed: columns k0.. and K/2 + k0..).
template <int P, int kMats>
struct Stage {
  static constexpr int kPlanes = packed_payload(P) ? 2 : 1;
  static constexpr int kSteps = kRows / 16;  // k16 steps a stage, each plane
  static constexpr int kW = kRows * kCols;
  static constexpr int kSRows = kPlanes * kSteps;
  static constexpr int kS = P == kW8pc ? 0 : kSRows * kCols * 2;
  static constexpr int kXPlane = kPass * kXPitch;  // bf16
  static constexpr int kBytes = kMats * (kW + kS) + kPlanes * kXPlane * 2;
  static constexpr int kSmem = kStages * kBytes;
  // with the static arrays of the item search and the 1 KB the SM keeps a block
  static constexpr int kStatic = (kCounts + kPass + 4) * 4;
  static_assert(kBytes % 16 == 0 && 3 * (kSmem + kStatic + 1024) <= 228 * 1024,
                "three blocks an SM");
};

// A slot's key: its expert id, or E for any id out of range.
__device__ __forceinline__ int slot_key(const int* __restrict__ idx, int s, int E) {
  const int e = __ldg(idx + s);
  return e < 0 || e >= E ? E : e;
}

// Where the slot count of key k of a window lies: one padding int every 32,
// so that warp 0's lanes, each reading 16 consecutive keys, hit distinct
// banks.
__device__ __forceinline__ int count_at(int k) { return k + k / 32; }

// This block's work item, the blockIdx.x-th (key, pass) in the order of
// the keys: a pass is 8 of the key's slots, in slot order (a key of n
// slots has ceil(n / 8) passes). Returns the key and sets `pass`, or
// returns -1 if there are fewer items. The slots of keys 0..E are counted
// in shared memory, a window of kWindow keys at a time (one window up to
// E 511); warp 0 adds up the windows' passes and finds the item. The
// result is the same for every thread.
__device__ int find_item(const int* __restrict__ idx, int S, int E, int* counts, int* info,
                         int& pass) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int rank = blockIdx.x;  // the item's rank among the items from this window on
  if (threadIdx.x == 0) info[0] = -1;
  for (int w0 = 0; w0 <= E; w0 += kWindow) {
    for (int i = threadIdx.x; i < kCounts; i += kThreads) counts[i] = 0;
    __syncthreads();
    for (int s = threadIdx.x; s < S; s += kThreads) {
      const int k = slot_key(idx, s, E) - w0;
      if (k >= 0 && k < kWindow) atomicAdd(counts + count_at(k), 1);
    }
    __syncthreads();
    if (warp == 0) {
      // lane l adds up the passes of keys w0 + kPer l .. in order
      constexpr int kPer = kWindow / 32;
      int mine = 0;
#pragma unroll
      for (int i = 0; i < kPer; ++i) mine += (counts[count_at(lane * kPer + i)] + 7) / 8;
      int incl = mine;  // passes of keys w0 .. w0 + kPer (lane + 1) - 1
#pragma unroll
      for (int o = 1; o < 32; o *= 2) {
        const int v = __shfl_up_sync(0xFFFFFFFFu, incl, o);
        if (lane >= o) incl += v;
      }
      if (rank >= incl - mine && rank < incl) {  // the item's key is one of this lane's
        int r = rank - (incl - mine);
        for (int i = 0; i < kPer; ++i) {
          const int c = (counts[count_at(lane * kPer + i)] + 7) / 8;
          if (r < c) {
            info[0] = w0 + lane * kPer + i;
            info[1] = r;
            break;
          }
          r -= c;
        }
      }
      if (lane == 31) info[2] = incl;
    }
    __syncthreads();
    if (info[0] >= 0) {
      pass = info[1];
      return info[0];
    }
    rank -= info[2];
  }
  return -1;
}

// The key's slots number p0 .. p0 + kPass - 1 (in slot order) into list;
// returns how many there are. Warp 0 walks idx 32 slots at a time.
__device__ int pass_slots(const int* __restrict__ idx, int S, int E, int key, int p0, int* list,
                          int* info) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int seen = 0;
    for (int c = 0; c < S && seen < p0 + kPass; c += 32) {
      const bool in = c + lane < S && slot_key(idx, c + lane, E) == key;
      const uint32_t ball = __ballot_sync(0xFFFFFFFFu, in);
      const int pos = seen + __popc(ball & ((1u << lane) - 1u));
      if (in && pos >= p0 && pos < p0 + kPass) list[pos - p0] = c + lane;
      seen += __popc(ball);
    }
    if (lane == 0) info[3] = min(seen - p0, kPass);
  }
  __syncthreads();
  return info[3];
}

// The scale pairs of a k16 step for a lane's columns col, col + 1: s0a, s1a
// for A registers a0, a1 (rows 2t, 2t + 1) and s0b, s1b for a2, a3 (rows
// 8 + 2t, 9 + 2t), each (column col pair, column col + 1 pair). Staged: one
// row of the stage (srow) holds the step's scales; otherwise each K row's
// scale is read from device memory (the step's first K row krow).
template <bool kStaged>
__device__ __forceinline__ void step_scales(const __nv_bfloat16* srow,
                                            const __nv_bfloat16* __restrict__ scale, int krow,
                                            int K, int g, int N, int col, int t,
                                            __nv_bfloat162& s0a, __nv_bfloat162& s1a,
                                            __nv_bfloat162& s0b, __nv_bfloat162& s1b) {
  if constexpr (kStaged) {
    const __nv_bfloat162 sp = *reinterpret_cast<const __nv_bfloat162*>(srow + col);
    s0a = s0b = __low2bfloat162(sp);
    s1a = s1b = __high2bfloat162(sp);
  } else {
    row_scales(scale, krow + 2 * t, K, g, N, col, s0a, s1a, s0b, s1b);
  }
}

// One block: work item blockIdx.x (up to 8 slots of one expert) by columns
// blockIdx.y * 128 .. of the kMats matrices (gate|up: 2, writing a =
// bf16(silu(g) * u) as bf16; down: 1, writing y as f32) over K. kStaged:
// 16 | g, the group scales staged with the weights (kW8pc: false).
template <int P, int kMats, bool kStaged>
__global__ void __launch_bounds__(kThreads, 3)
slot_group_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ idx, Mat m0,
                  Mat m1, int S, int K, int N, int E, int g, void* __restrict__ out) {
  using St = Stage<P, kMats>;
  using ScaleT = std::conditional_t<P == kW8pc, float, __nv_bfloat16>;
  constexpr bool kPacked = packed_payload(P);
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int counts[kCounts];
  __shared__ int list[kPass];
  __shared__ int info[4];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, t = lane % 4;
  const int n0 = blockIdx.y * kCols;
  int pass = 0;
  const int key = find_item(idx, S, E, counts, info, pass);
  if (key < 0) return;  // fewer items than blocks
  const bool bad = key == E;
  const int half = K / 2;
  const int nk = (kPacked ? half : K) / kRows;  // stages (128 | K)
  const int ld = m0.ld;                          // both matrices of a launch share it
  const uint8_t* w[kMats];
  const ScaleT* sc[kMats];
#pragma unroll
  for (int m = 0; m < kMats; ++m) {
    const Mat& mt = m == 0 ? m0 : m1;
    w[m] = mt.w + (bad ? 0 : (size_t)key * mt.w_stride) + n0;
    sc[m] = static_cast<const ScaleT*>(mt.s) + (bad ? 0 : (size_t)key * mt.s_stride) + n0;
  }
  const int col = warp * 16 + 2 * gid;  // A rows gid, gid + 8: columns col, col + 1

  // Stage s (stored rows s * kRows ..) goes to ring slot s % kStages: the
  // weight tiles and their staged scales, which need only the key (the
  // first kStages - 1 stages' are in flight while warp 0 walks idx), then the
  // pass's x rows (rows past its slots zero-filled, so they add 0).
  auto load_w = [&](int s) {
    uint8_t* base = smem + (s % kStages) * St::kBytes;
    const int r0 = s * kRows;
#pragma unroll
    for (int m = 0; m < kMats; ++m) {
      uint8_t* wt = base + m * (St::kW + St::kS);
      for (int i = threadIdx.x; i < kRows * 8; i += kThreads) {
        const int r = i / 8, c = i % 8;  // 8 threads read one 128-byte row
        cp_async16(wt + w_off(r, c), w[m] + (size_t)(r0 + r) * ld + c * 16, true);
      }
      if constexpr (kStaged) {
        for (int i = threadIdx.x; i < St::kSRows * 16; i += kThreads) {
          const int j = i / 16;  // plane j / kSteps, k16 step j % kSteps
          const int krow = (j / St::kSteps) * half + r0 + (j % St::kSteps) * 16;
          cp_async16(wt + St::kW + i * 16, sc[m] + (size_t)(krow / g) * N + (i % 16) * 8,
                     true);
        }
      }
    }
  };
  if (!bad)
    for (int s = 0; s < kStages - 1 && s < nk; ++s) load_w(s);

  const int n = pass_slots(idx, S, E, key, pass * kPass, list, info);  // 1..8
  if (bad) {
    // ids out of range: NaN rows, as the first port gave them
    for (int i = threadIdx.x; i < n * kCols / 2; i += kThreads) {
      const size_t o = (size_t)list[i / (kCols / 2)] * N + n0 + 2 * (i % (kCols / 2));
      if constexpr (kMats == 2)
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + o) = 0x7FC07FC0u;
      else
        *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
            make_float2(__int_as_float(0x7FC00000), __int_as_float(0x7FC00000));
    }
  } else {
    auto load_x = [&](int s) {
      uint8_t* xs = smem + (s % kStages) * St::kBytes + kMats * (St::kW + St::kS);
      const int r0 = s * kRows;
      constexpr int kChunks = kRows / 8;  // 16-byte pieces of a staged x row
      for (int i = threadIdx.x; i < St::kPlanes * kPass * kChunks; i += kThreads) {
        const int plane = i / (kPass * kChunks), r = (i / kChunks) % kPass, c = i % kChunks;
        const bool ok = r < n;
        cp_async16(xs + (plane * St::kXPlane + r * kXPitch + c * 8) * 2,
                   x + (ok ? (size_t)list[r] * K + plane * half + r0 + c * 8 : 0), ok);
      }
    };

    float acc[kMats][4];
#pragma unroll
    for (int m = 0; m < kMats; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

    // one copy group a stage (the first also holds the early weights)
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) load_x(s);
      cp_async_commit();
    }
    for (int s = 0; s < nk; ++s) {
      cp_async_wait<kStages - 2>();  // this thread's copies of stage s have landed
      __syncthreads();                 // everyone's have, and stage s - 1's slot is free
      if (s + kStages - 1 < nk) {
        load_w(s + kStages - 1);
        load_x(s + kStages - 1);
      }
      cp_async_commit();

      const uint8_t* base = smem + (s % kStages) * St::kBytes;
      const __nv_bfloat16* xl =
          reinterpret_cast<const __nv_bfloat16*>(base + kMats * (St::kW + St::kS));
      const __nv_bfloat16* xh = xl + St::kXPlane;  // packed: the hi plane
      const int r0 = s * kRows;
#pragma unroll
      for (int kr = 0; kr < kRows; kr += 32) {
        uint32_t wr[kMats][4];
#pragma unroll
        for (int m = 0; m < kMats; ++m)
          ldmatrix_x4_trans(wr[m], base + m * (St::kW + St::kS) + w_off(kr + lane, warp));
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          const int kk = kr + st * 16;  // the k16 step's first stored row in the stage
          uint32_t alo[kMats][4], ahi[kMats][4];  // int8, w8pc: alo only
#pragma unroll
          for (int m = 0; m < kMats; ++m) {
            if constexpr (P == kW8pc) {
              // the exact codes; the scales wait for the finished sums
              decode_i8(wr[m][2 * st], alo[m][0], alo[m][1]);
              decode_i8(wr[m][2 * st + 1], alo[m][2], alo[m][3]);
            } else {
              const __nv_bfloat16* ss = reinterpret_cast<const __nv_bfloat16*>(
                  base + m * (St::kW + St::kS) + St::kW);
              __nv_bfloat162 l0a, l1a, l0b, l1b;  // lo plane (int8: the only one)
              step_scales<kStaged>(ss + (kk / 16) * kCols, sc[m], r0 + kk, K, g, N, col, t,
                                   l0a, l1a, l0b, l1b);
              if constexpr (P == kInt8) {
                dequant_pairs(wr[m][2 * st], l0a, l1a, alo[m][0], alo[m][1]);
                dequant_pairs(wr[m][2 * st + 1], l0b, l1b, alo[m][2], alo[m][3]);
              } else {
                __nv_bfloat162 h0a, h1a, h0b, h1b;
                step_scales<kStaged>(ss + (St::kSteps + kk / 16) * kCols, sc[m],
                                     half + r0 + kk, K, g, N, col, t, h0a, h1a, h0b, h1b);
                if constexpr (P == kE2M1) {
                  dequant_packed(wr[m][2 * st], l0a, l1a, h0a, h1a, alo[m][0], alo[m][1],
                                 ahi[m][0], ahi[m][1]);
                  dequant_packed(wr[m][2 * st + 1], l0b, l1b, h0b, h1b, alo[m][2],
                                 alo[m][3], ahi[m][2], ahi[m][3]);
                } else {
                  uint32_t v[8];
                  decode_w4(wr[m][2 * st], v[0], v[1], v[2], v[3]);
                  decode_w4(wr[m][2 * st + 1], v[4], v[5], v[6], v[7]);
                  alo[m][0] = as_u32(__hmul2(as_bf162(v[0]), l0a));
                  alo[m][1] = as_u32(__hmul2(as_bf162(v[1]), l1a));
                  ahi[m][0] = as_u32(__hmul2(as_bf162(v[2]), h0a));
                  ahi[m][1] = as_u32(__hmul2(as_bf162(v[3]), h1a));
                  alo[m][2] = as_u32(__hmul2(as_bf162(v[4]), l0b));
                  alo[m][3] = as_u32(__hmul2(as_bf162(v[5]), l1b));
                  ahi[m][2] = as_u32(__hmul2(as_bf162(v[6]), h0b));
                  ahi[m][3] = as_u32(__hmul2(as_bf162(v[7]), h1b));
                }
              }
            }
          }
          const int xo = gid * kXPitch + kk + 2 * t;  // B column gid: slot gid
          const uint32_t bl0 = *reinterpret_cast<const uint32_t*>(xl + xo);
          const uint32_t bl1 = *reinterpret_cast<const uint32_t*>(xl + xo + 8);
#pragma unroll
          for (int m = 0; m < kMats; ++m) mma_bf16(acc[m], alo[m], bl0, bl1);
          if constexpr (kPacked) {
            const uint32_t bh0 = *reinterpret_cast<const uint32_t*>(xh + xo);
            const uint32_t bh1 = *reinterpret_cast<const uint32_t*>(xh + xo + 8);
#pragma unroll
            for (int m = 0; m < kMats; ++m) mma_bf16(acc[m], ahi[m], bh0, bh1);
          }
        }
      }
    }

    if constexpr (P == kW8pc) {
      // each column's finished f32 sum times its f32 scale
#pragma unroll
      for (int m = 0; m < kMats; ++m) {
        const float2 s2 = scale_pair(sc[m] + col);
        acc[m][0] *= s2.x;
        acc[m][1] *= s2.x;
        acc[m][2] *= s2.y;
        acc[m][3] *= s2.y;
      }
    }
    // c0, c2: slot 2t of the pass at columns col, col + 1; c1, c3: slot 2t + 1
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (2 * t + h >= n) continue;
      const size_t o = (size_t)list[2 * t + h] * N + n0 + col;
      if constexpr (kMats == 2) {
        const float g0 = acc[0][h], g1 = acc[0][2 + h];
        const float a0 = g0 * (1.f / (1.f + expf(-g0))) * acc[1][h];
        const float a1 = g1 * (1.f / (1.f + expf(-g1))) * acc[1][2 + h];
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o) =
            __floats2bfloat162_rn(a0, a1);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
            make_float2(acc[0][h], acc[0][2 + h]);
      }
    }
  }
}

// Launch one of the kernels over its most work items x N / 128 column
// tiles, raising its shared-memory limit once a device. A key of n slots
// has ceil(n / 8) <= 1 + (n - 1) / 8 items, so there are at most
// min(S, E + 1) + (S - 1) / 8 of them, and at most S.
template <int P, int kMats, bool kStaged>
int launch(const __nv_bfloat16* x, const int* idx, Mat m0, Mat m1, int S, int K, int N, int E,
           int g, void* out, cudaStream_t stream) {
  using St = Stage<P, kMats>;
  const auto kernel = slot_group_kernel<P, kMats, kStaged>;
  static DeviceOnce once;
  int dev = 0;
  const cudaError_t e = raise_once(once, kernel, St::kSmem, dev);
  if (e != cudaSuccess) return (int)e;
  const int keys = S < E + 1 ? S : E + 1;
  const int items = keys + (S - 1) / 8 < S ? keys + (S - 1) / 8 : S;
  kernel<<<dim3(items, N / kCols), kThreads, St::kSmem, stream>>>(x, idx, m0, m1, S, K, N, E, g,
                                                                   out);
  return (int)cudaGetLastError();
}

// gate|up (K D, N F) over x into the workspace a, then down (K F, N D) over
// a into out.
template <int P, bool kStaged>
int slot_ffn(const __nv_bfloat16* x, const int* idx, Mat G, Mat U, Mat Dn, __nv_bfloat16* a_ws,
             float* out, int S, int D, int F, int E, int g, cudaStream_t stream) {
  const int err = launch<P, 2, kStaged>(x, idx, G, U, S, D, F, E, g, a_ws, stream);
  if (err != 0) return err;
  return launch<P, 1, kStaged>(a_ws, idx, Dn, Dn, S, F, D, E, g, out, stream);
}

}  // namespace
}  // namespace qtt
