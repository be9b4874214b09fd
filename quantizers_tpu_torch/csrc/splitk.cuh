// The skeleton shared by the tensor-core weight-only matmuls over blocks of
// 128 output columns (nvfp4_matmul.cu: the packed and int8-doubled NVFP4
// kernels; w4_matmul.cu: the W4A16 kernel; w8_matmul.cu: the int8 kernel;
// fp8_matmul.cu: the FP8_BLOCK kernel): the blocks of a thread block
// cluster split K, each rank pushes its partial sums to the rank that owns
// them, and one launch helper picks the split and raises the kernel's
// shared-memory limit once per device. decode_attention.cu's cluster split
// of positions uses the push barrier and the launch; moe_slot_ffn.cu's
// launch the raise (raise_once).
//
// A kernel built on it holds, per thread of its first kCols / 16 warps, the
// mma.sync m16n8k16 output fragments acc[MG][4] of its warp's m16 tile (A
// rows gid, gid + 8: block columns col, col + 1) over 8 MG rows of x (8 a
// fragment), and keeps beside its ring the block's f32 outputs as the
// ranks send them (8 MG x kCols floats) and one mbarrier.
#pragma once

#include <atomic>

#include "common.cuh"

namespace qtt {

constexpr int kMaxSplit = 8;  // most blocks of a cluster (the portable limit)

// The cluster's shares of K added in a fixed order, pushed: output e of the
// block (row e / kCols, column e % kCols) belongs to rank e / share. Every
// rank stores its partial sum of e into slot `rank` of the owner's buffer
// `red`, completing on the owner's `reduced` barrier (armed by push_init);
// each rank then adds its outputs' partials rank by rank and writes them.
// No rank reads another's shared memory, so each exits once its own
// outputs are written.
__device__ __forceinline__ void push_init(uint64_t* reduced, int bytes) {
  if (threadIdx.x == 0) {
    mbar_init(reduced, 1);
    mbar_expect(reduced, bytes);  // every rank's partials of this rank's outputs
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the other ranks may send to `reduced` once every rank has passed here
  // (push_store waits before the first send)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

template <int MG, int kCols, int kThreads>
__device__ __forceinline__ void push_store(const float (&acc)[MG][4], float* red,
                                           uint64_t* reduced, __nv_bfloat16* __restrict__ out,
                                           int M, int N, int m0, int n0, int col, int t) {
  constexpr int kOut = 8 * MG * kCols;
  const int ranks = gridDim.z, rank = blockIdx.z;
  const int share = kOut / ranks;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  // the warps of the block's m16 column tiles send (a producer warp past
  // them holds no outputs); c0, c2 are rows 2t of columns col, col + 1; c1,
  // c3 rows 2t + 1
  if (kThreads == 2 * kCols || threadIdx.x < 2 * kCols) {
#pragma unroll
    for (int mg = 0; mg < MG; ++mg)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = (mg * 8 + 2 * t + h) * kCols + col;
        const int owner = e / share;
        st_async_f32x2(map_rank(red + rank * share + e - owner * share, owner), acc[mg][h],
                       acc[mg][2 + h], map_rank(reduced, owner));
      }
  }
  mbar_wait(reduced, 0);
  for (int j = 2 * threadIdx.x; j < share; j += 2 * kThreads) {
    const int e = rank * share + j;
    const int m = e / kCols, c = e % kCols;
    if (m0 + m >= M) break;  // j grows with m
    float2 sum = make_float2(0.f, 0.f);
    for (int r = 0; r < ranks; ++r) {
      const float2 v = *reinterpret_cast<const float2*>(red + r * share + j);
      sum.x += v.x;
      sum.y += v.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(m0 + m) * N + n0 + c) =
        __floats2bfloat162_rn(sum.x, sum.y);
  }
}

// The split of K: the fewest blocks a cluster (a power of two, at most 8)
// that put a block on every SM, each block keeping 2 stages or more; with
// `doubled`, the split is then doubled while that puts fewer than 2 blocks
// on every SM and each block keeps 4 stages or more (the packed NVFP4
// kernel's gate|up at m 8: 304 blocks, 0.025 -> 0.020 ms on the H100; the
// int8 one lost). All blocks run in one wave (2 fit an SM).
static inline int split_k(int tiles, int stages, int sms, bool doubled) {
  int split = 1;
  while (split < kMaxSplit && tiles * split < sms && stages >= 4 * split) split *= 2;
  while (doubled && split < kMaxSplit && tiles * split < 2 * sms && stages >= 8 * split)
    split *= 2;
  return split;
}

// One kernel's state across calls: the devices on which its shared-memory
// limit has been raised, and their SM counts. Each kernel keeps its own.
struct DeviceOnce {
  std::atomic<uint64_t> raised{0};
  std::atomic<int> sms[64];
};

// Raise `kernel`'s shared-memory limit to `smem` bytes and note the SM
// count, once on each device; `dev` is the current device.
template <typename... P>
cudaError_t raise_once(DeviceOnce& once, void (*kernel)(P...), int smem, int& dev) {
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = 1ull << (dev & 63);
  if (!(once.raised.load() & bit)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    int count = 0;
    e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    once.sms[dev & 63].store(count);
    once.raised.fetch_or(bit);
  }
  return cudaSuccess;
}

// Launch `kernel` over col_tiles x row_tiles blocks of `threads`, each
// with `smem` bytes of dynamic shared memory, K split by split_k over a
// cluster along z (`stages`: K's 128-row stages).
template <typename... P, typename... A>
int launch_split(DeviceOnce& once, void (*kernel)(P...), int col_tiles, int row_tiles,
                 int threads, int smem, int stages, bool doubled, cudaStream_t stream,
                 A... args) {
  int dev = 0;
  const cudaError_t e = raise_once(once, kernel, smem, dev);
  if (e != cudaSuccess) return (int)e;
  const int split =
      split_k(col_tiles * row_tiles, stages, once.sms[dev & 63].load(), doubled);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(col_tiles, row_tiles, split);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace qtt
