// K10's f16 instances (the kernels: w8a8_matmul.cuh), built apart from
// the others so that nvcc builds them in parallel.

#include "w8a8_matmul.cuh"

int qtt_w8a8_f16(int sw_f32, const void* x, const void* xq, const void* sx, const void* w,
                 const void* sw, void* out, int M, int K, int N, int split, cudaStream_t st) {
  return by_scale<__half>(sw_f32, x, xq, sx, w, sw, out, M, K, N, split, st);
}
