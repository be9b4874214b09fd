// W8A8 matmul for Hopper (sm_90a): int8 activations times int8 weights,
// summed exactly in int32, scaled per token and per channel.
//
// Replaces no Pallas kernel: the JAX package computes this with an XLA
// int8 dot_general into int32 (quantizers_tpu/ops/dispatch.py:
// w8a8_token_matmul, :46-54), which the TPU runs on its int8 matrix unit.
// Here the products run in the kernel's own body on the tensor cores'
// int8 path, mma.sync.m16n8k32 s8 x s8 -> s32.
//
// What it computes, bit for bit as that function:
//   out[m, n] = round_out((float(acc[m, n]) * sx[m]) * sw[n])
// with acc = sum_k xq[m, k] * w[k, n] exact in int32 (|acc| <= K * 2^14),
// float() rounding to nearest even, two f32 multiplies in that order, and
// one rounding to the output type (bf16, RNE, or f32 as it is). xq int8
// (M, K) row-major, the weight int8 (K, N) as it rests (N-contiguous), sx
// f32 (M,), sw bf16 or f32 (N,).
//
// The B operand. mma.sync s8 wants B "col": 4 consecutive K of one column
// in a register. The weight at rest is (K, N), N-contiguous, and neither
// ldmatrix.trans (16-bit elements only) nor s8 wgmma (K-major operands)
// transposes bytes. So the kernel transposes in registers: lane (gid, t)
// reads one 32-bit word (columns 4 gid .. 4 gid + 3) of each of 4
// consecutive staged K rows 4 t .. 4 t + 3 and turns the 4 x 4 bytes
// around with 8 __byte_perm, giving the B registers of 4 n8 tiles at once.
// The n8 tile j of a 32-column group therefore holds the columns 4 g + j
// (g = 0 .. 7), and the epilogue maps them back: lane (gid, t) ends with
// the 8 consecutive columns 8 t .. 8 t + 7 of each group, stored at once.
// The staged weight rows are 128 bytes; piece c (16 bytes) of row k sits
// at c ^ 2 ((k / 4) % 4), so the 32 lanes' words fall in 32 banks.
//
// A simple kernel that is right, as a first port: a 64 x 128 block tile of
// the output, K in steps of 64 through two cp.async stages, 4 warps of 32
// x 64, guards on the M, N and K tails (16-byte copies where a row's bytes
// allow them, byte loads elsewhere, zeros past the ends). Where the
// output tiles leave SMs idle (decode, the calibration's narrow
// projections) the blocks of a column tile split K and add their int32
// sums with atomics into a zeroed workspace, and a second kernel applies
// the scales: integer sums are exact in any order, so the result is the
// same bits as one block's.
//
// What bounds it on the H100 SXM: bytes at decode (the weight, K N bytes,
// at 3.35 TB/s: 7.4 us for Qwen3-4B's down_proj), operations at prefill
// (2 M K N at the 1,979 int8 TOPS: 51 us for gate at M 1024). mma.sync
// reaches part of that rate; wgmma with K-major staging and the
// quantizer fused into the prologue is later work.

#include "common.cuh"

namespace {
using namespace qtt;

constexpr int kBM = 64, kBN = 128, kBK = 64;
constexpr int kThreads = 128;       // 4 warps: 2 (M) x 2 (N), 32 x 64 each
constexpr int kAStride = kBK + 16;  // padded x rows (80 bytes): conflict-free words
constexpr int kABytes = kBM * kAStride;
constexpr int kBBytes = kBK * kBN;

// byte offset of piece c (16 bytes) of staged weight row k
__device__ __forceinline__ int b_off(int k, int c) { return k * kBN + ((c ^ (2 * ((k >> 2) & 3))) << 4); }

// 16 bytes of row r, columns c .. c + 15 of a row-major byte matrix (rows,
// cols, ld) into shared memory at dst; zeros past its ends. `fast`: every
// row starts 16-byte aligned (ld % 16 == 0), so a whole piece is one
// cp.async; else, and at a partial piece, byte loads.
__device__ __forceinline__ void load_piece(uint8_t* dst, const int8_t* __restrict__ src, int r,
                                           int c, int rows, int cols, int ld, bool fast) {
  if (r >= rows || c >= cols) {
    cp_async16(dst, src, false);
  } else if (fast && c + 16 <= cols) {
    cp_async16(dst, src + (size_t)r * ld + c, true);
  } else {
    uint32_t w[4];
    const int8_t* p = src + (size_t)r * ld;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t v = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int cc = c + 4 * i + b;
        v |= (cc < cols ? (uint32_t)(uint8_t)p[cc] : 0u) << (8 * b);
      }
      w[i] = v;
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// d += a . b: one warp-level m16n8k32 int8 product with int32 sums.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 4 x 4 bytes w[r] (K row r, columns 0..3) turned around: o[j] holds
// column j's bytes of rows 0..3, row 0 lowest.
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4], uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140), t3 = __byte_perm(w[2], w[3], 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

// (float(acc) * sx) * sw, each step rounded as written (no contraction)
__device__ __forceinline__ float scaled(int acc, float sx, float sw) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
}

// 8 consecutive outputs of one row at once (16-byte aligned: N % 8 == 0).
__device__ __forceinline__ void put8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  u.x = pack_bf16(v[0], v[1]);
  u.y = pack_bf16(v[2], v[3]);
  u.z = pack_bf16(v[4], v[5]);
  u.w = pack_bf16(v[6], v[7]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void put8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// One block: output rows m0 .. m0 + 63, columns n0 .. n0 + 127, over its
// share (blockIdx.z of gridDim.z) of K's 64-row steps. One share: the
// scaled outputs; several: int32 atomics into ws.
template <typename ScaleT, typename OutT>
__global__ void __launch_bounds__(kThreads)
w8a8_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
            const float* __restrict__ sx, const ScaleT* __restrict__ sw, OutT* __restrict__ out,
            int* __restrict__ ws, int M, int K, int N) {
  __shared__ __align__(16) uint8_t sa[2][kABytes];
  __shared__ __align__(16) uint8_t sb[2][kBBytes];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, t = lane % 4;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int steps = (K + kBK - 1) / kBK;
  const int s0 = steps * blockIdx.z / gridDim.z;
  const int ns = steps * (blockIdx.z + 1) / gridDim.z - s0;
  const bool fast_a = K % 16 == 0, fast_b = N % 16 == 0;

  auto load = [&](int buf, int step) {
    const int k0 = step * kBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // x: 64 rows x 4 pieces
      const int p = threadIdx.x + i * kThreads, r = p / 4, c = p % 4;
      load_piece(sa[buf] + r * kAStride + 16 * c, xq, m0 + r, k0 + 16 * c, M, K, K, fast_a);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // the weight: 64 K rows x 8 pieces
      const int p = threadIdx.x + i * kThreads, r = p / 8, c = p % 8;
      load_piece(sb[buf] + b_off(r, c), w, k0 + r, n0 + 16 * c, K, N, N, fast_b);
    }
    cp_async_commit();
  };

  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][nt][j] = 0;

  if (ns > 0) load(0, s0);
  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns) {
      load((s + 1) & 1, s0 + s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* a_s = sa[s & 1];
    const uint8_t* b_s = sb[s & 1];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const uint8_t* row = a_s + (32 * wm + 16 * mi + gid) * kAStride + ks + 4 * t;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(row);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(row + 8 * kAStride);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(row + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(row + 8 * kAStride + 16);
      }
#pragma unroll
      for (int ng = 0; ng < 2; ++ng) {
        // columns 64 wn + 32 ng + 4 gid .. + 3: piece c, word gid % 4
        const int c = (64 * wn + 32 * ng) / 16 + gid / 4;
        uint32_t b[2][4];  // [k half][n8 tile j]
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t wr[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int k = ks + 16 * h + 4 * t + r;
            wr[r] = *reinterpret_cast<const uint32_t*>(b_s + b_off(k, c) + 4 * (gid % 4));
          }
          transpose4(wr, b[h]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_s8(acc[mi][4 * ng + j], a[mi], b[0][j], b[1][j]);
      }
    }
    __syncthreads();  // the stage is refilled on the next step
  }

  // tile (ng, j), C column 2t (+1) is output column 32 ng + 8t + j (+4):
  // lane (gid, t) holds columns 8t .. 8t + 7 of each group
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + 32 * wm + 16 * mi + gid + 8 * half;
      if (m >= M) continue;
#pragma unroll
      for (int ng = 0; ng < 2; ++ng) {
        const int nb = n0 + 64 * wn + 32 * ng + 8 * t;
        int v[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = acc[mi][4 * ng + j][2 * half];
          v[4 + j] = acc[mi][4 * ng + j][2 * half + 1];
        }
        if (gridDim.z > 1) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (nb + e < N) atomicAdd(ws + (size_t)m * N + nb + e, v[e]);
          continue;
        }
        const float sxm = sx[m];
        if (N % 8 == 0 && nb + 8 <= N) {
          float f[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = scaled(v[e], sxm, to_f32(sw[nb + e]));
          put8(out + (size_t)m * N + nb, f);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (nb + e < N) put(out + (size_t)m * N + nb + e, scaled(v[e], sxm, to_f32(sw[nb + e])));
        }
      }
    }
}

// The split-K epilogue: the scales on the finished int32 sums.
template <typename ScaleT, typename OutT>
__global__ void w8a8_scale_kernel(const int* __restrict__ ws, const float* __restrict__ sx,
                                  const ScaleT* __restrict__ sw, OutT* __restrict__ out, int M,
                                  int N) {
  const size_t total = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int m = (int)(i / N), n = (int)(i % N);
    put(out + i, scaled(ws[i], sx[m], to_f32(sw[n])));
  }
}

template <typename ScaleT, typename OutT>
int launch(const void* xq, const void* w, const void* sx, const void* sw, void* out, void* ws,
           int M, int K, int N, int splits, cudaStream_t st) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  w8a8_kernel<ScaleT, OutT><<<grid, kThreads, 0, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w),
      static_cast<const float*>(sx), static_cast<const ScaleT*>(sw), static_cast<OutT*>(out),
      static_cast<int*>(ws), M, K, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t total = (size_t)M * N;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  w8a8_scale_kernel<ScaleT, OutT><<<blocks, 256, 0, st>>>(
      static_cast<const int*>(ws), static_cast<const float*>(sx), static_cast<const ScaleT*>(sw),
      static_cast<OutT*>(out), M, N);
  return (int)cudaGetLastError();
}

}  // namespace

// xq int8 (M, K), w int8 (K, N), sx f32 (M,), sw (N,) bf16 (sw_f32 0) or
// f32 (1), out (M, N) bf16 (out_f32 0) or f32 (1); splits > 1: blocks a
// column tile split K into, adding into ws, a zeroed int32 (M, N).
extern "C" int qtt_w8a8_matmul(const void* xq, const void* w, const void* sx, const void* sw,
                               void* out, void* ws, int M, int K, int N, int sw_f32,
                               int out_f32, int splits, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || splits < 1 || splits > (K + kBK - 1) / kBK ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(xq) || !aligned16(w) || !aligned16(out) || (ws && !aligned16(ws)))
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (sw_f32)
    return out_f32 ? launch<float, float>(xq, w, sx, sw, out, ws, M, K, N, splits, st)
                   : launch<float, __nv_bfloat16>(xq, w, sx, sw, out, ws, M, K, N, splits, st);
  return out_f32 ? launch<__nv_bfloat16, float>(xq, w, sx, sw, out, ws, M, K, N, splits, st)
                 : launch<__nv_bfloat16, __nv_bfloat16>(xq, w, sx, sw, out, ws, M, K, N, splits,
                                                        st);
}
