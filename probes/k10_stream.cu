// Streaming probes for K10's decode body (probes/k10_probe.py --stream):
// how fast blocks read an int8 (K, N) weight through a cp.async ring with
// no arithmetic, for the tile shapes a decode body could use.
//
// stream_strip<kCols, kRows, kStages, kThreads>: grid (N / kCols, split);
// block (x, z) reads columns x kCols .. + kCols of K rows [z K / split,
// (z + 1) K / split) in stages of kRows rows, kStages - 1 in flight, 16
// bytes a cp.async, then xors one word of each stage into out[block] (so
// that no load is dead).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(src) : "memory");
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int kCols, int kRows, int kStages, int kThreads>
__global__ void __launch_bounds__(kThreads)
stream_strip(const int8_t* __restrict__ w, int K, int N, uint32_t* out) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int kStage = kCols * kRows, kPieces = kStage / 16;
  const int n0 = blockIdx.x * kCols;
  const int steps = K / kRows, split = gridDim.y;
  const int s0 = steps * blockIdx.y / split, ns = steps * (blockIdx.y + 1) / split - s0;
  auto load = [&](int s) {
    uint8_t* dst = smem + (s % kStages) * kStage;
    const int8_t* src = w + (size_t)(s0 + s) * kRows * N + n0;
#pragma unroll
    for (int i = threadIdx.x; i < kPieces; i += kThreads) {
      const int r = i / (kCols / 16), c = i % (kCols / 16);
      cp16(dst + 16 * i, src + (size_t)r * N + 16 * c);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ns) load(s);
    commit();
  }
  uint32_t acc = 0;
  for (int s = 0; s < ns; ++s) {
    wait<kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < ns) load(s + kStages - 1);
    commit();
    acc ^= reinterpret_cast<const uint32_t*>(smem + (s % kStages) * kStage)[threadIdx.x];
  }
  if (acc == 0x12345678u) out[blockIdx.x] = acc;
}

template <int kCols, int kRows, int kStages, int kThreads>
int launch(const void* w, int K, int N, int split, void* out, cudaStream_t st) {
  auto k = stream_strip<kCols, kRows, kStages, kThreads>;
  const int smem = kCols * kRows * kStages;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  k<<<dim3(N / kCols, split), kThreads, smem, st>>>(static_cast<const int8_t*>(w), K, N,
                                                    static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// variant: 0 = 128 columns x 64 rows x 8 stages, 128 threads (the decode
// body's ring); 1 = 128 x 128 x 6, 256 threads; 2 = 256 x 64 x 8, 256
// threads; 3 = 512 x 32 x 8, 256 threads; 4 = 128 x 64 x 4, 128 threads;
// 5 = 128 x 64 x 12, 128 threads.
extern "C" int k10_stream(int variant, const void* w, int K, int N, int split, void* out,
                          void* stream) {
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch<128, 64, 8, 128>(w, K, N, split, out, st);
    case 1: return launch<128, 128, 6, 256>(w, K, N, split, out, st);
    case 2: return launch<256, 64, 8, 256>(w, K, N, split, out, st);
    case 3: return launch<512, 32, 8, 256>(w, K, N, split, out, st);
    case 4: return launch<128, 64, 4, 128>(w, K, N, split, out, st);
    case 5: return launch<128, 64, 12, 128>(w, K, N, split, out, st);
  }
  return -1;
}
