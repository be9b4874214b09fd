// K10's C entry and its bf16 instances (the kernels: w8a8_matmul.cuh).

#include "w8a8_matmul.cuh"

// The f16 and f32 instances (w8a8_matmul_f16.cu, w8a8_matmul_f32.cu).
int qtt_w8a8_f16(int sw_f32, const void* x, const void* xq, const void* sx, const void* w,
                 const void* sw, void* out, int M, int K, int N, int split, cudaStream_t st);
int qtt_w8a8_f32(int sw_f32, const void* x, const void* xq, const void* sx, const void* w,
                 const void* sw, void* out, int M, int K, int N, int split, cudaStream_t st);

// A W8A8 linear. w int8 (K, N); sw (N,) bf16 (sw_f32 0) or f32 (1); out
// (M, N) bf16 (out_type 0), f32 (1) or f16 (2). With x NULL: xq int8 (M,
// K) codes with their f32 scales sx (M,) (the GEMM alone). Else x (M, K)
// in out's type, quantized per row: in the same launch where the decode
// body takes it (M <= 64 and the block's share of x within kXShare; xq and
// sx unused), else into xq and sx, scratch that the quantizer pass fills
// before the GEMM (two launches). split: the blocks of a cluster that
// share one output tile's K (1 .. 8).
extern "C" int qtt_w8a8_matmul(const void* xq, const void* w, const void* sx, const void* sw,
                               void* out, const void* x, int M, int K, int N, int sw_f32,
                               int out_type, int split, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || split < 1 || split > kMaxSplit ||
      split > (K + kBK - 1) / kBK || out_type < 0 || out_type > 2)
    return (int)cudaErrorInvalidValue;
  const int elem = out_type == 1 ? 4 : 2;  // x's bytes an element (x has out's type)
  const bool fused = x != nullptr && decode_fits(M, K, split, elem);
  if (!fused && (xq == nullptr || sx == nullptr)) return (int)cudaErrorInvalidValue;
  if (!aligned16(w) || !aligned16(out) || (x && !aligned16(x)) || (!fused && !aligned16(xq)))
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (out_type == 0)
    return by_scale<__nv_bfloat16>(sw_f32, x, xq, sx, w, sw, out, M, K, N, split, st);
  if (out_type == 1) return qtt_w8a8_f32(sw_f32, x, xq, sx, w, sw, out, M, K, N, split, st);
  return qtt_w8a8_f16(sw_f32, x, xq, sx, w, sw, out, M, K, N, split, st);
}
