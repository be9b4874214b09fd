// Probes of one GPTQ column's dependent chain on the card (K11). Built and
// driven by probes/k11_probe.py; not part of the package. It includes the
// kernel's source, so that it measures and checks the kernel's own
// rcp_rn and div_fast.
//
// chain_kernel runs, on one thread, only the operations of a column that
// depend on the column before it, 128 columns a pass: the last update w_i
// -= e * U[i-1, i], x = w_i / s, q = clamp(rint(x)), dq = q * s, e = (w_i -
// dq) / U[i, i]. Its divisors and U's entries sit in registers, so no load
// and no shuffle is timed. Variants:
//   0  both divisions as __fdiv_rn (IEEE, as the plain version divides);
//   1  both divisions as the kernel's div_fast from staged reciprocals, no
//      NaN test in the clamp (the kernel's fast pass).
//
// div_check_kernel holds div_fast against __fdiv_rn bit for bit on seeded
// operands in its range; rcp_check_kernel holds rcp_rn against __frcp_rn
// on every float of its range.

#include "../quantizers_tpu_torch/csrc/gptq_block.cu"

namespace {

template <int V>
__device__ float chain(const float* p, int reps, long long* cyc) {
  float s[8], d[8], u[8], ys[8], yd[8], wv[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    s[t] = p[t];
    d[t] = p[8 + t];
    u[t] = p[16 + t];
    ys[t] = p[24 + t];
    yd[t] = p[32 + t];
    wv[t] = p[40 + t];
  }
  const float qmin = -8.f, qmax = 7.f;
  float e = 0.f;
  const long long t0 = clock64();
  for (int r = 0; r < reps; ++r) {
    for (int m = 0; m < 16; ++m) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float wi = __fsub_rn(wv[t], __fmul_rn(e, u[t]));
        if (V == 1) {
          const float q = fminf(fmaxf(rintf(div_fast(wi, s[t], ys[t])), qmin), qmax);
          e = div_fast(__fsub_rn(wi, __fmul_rn(q, s[t])), d[t], yd[t]);
        } else {
          float q = rintf(__fdiv_rn(wi, s[t]));
          if (!isnan(q)) q = fminf(fmaxf(q, qmin), qmax);
          e = __fdiv_rn(__fsub_rn(wi, __fmul_rn(q, s[t])), d[t]);
        }
      }
    }
  }
  *cyc = clock64() - t0;
  return e;
}

__global__ void chain_kernel(int variant, const float* __restrict__ p, float* out,
                             long long* cyc, int reps) {
  out[0] = variant == 1 ? chain<1>(p, reps, cyc) : chain<0>(p, reps, cyc);
}

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

// n seeded pairs: b with |b| in [2^-24, 2^25), a either random with |a| in
// [2^-96, 2^97) or (every other pair) the float nearest b (q + ulp(q) / 2)
// for a random q, whose quotient lies next to a rounding tie.
__global__ void div_check_kernel(unsigned long long n, uint32_t seed,
                                 unsigned long long* bad, float* first) {
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t h0 = mix((uint32_t)i * 4u + seed), h1 = mix(h0 ^ 0x9e3779b9u),
                   h2 = mix(h1 + 0x85ebca6bu), h3 = mix(h2 ^ 0xc2b2ae35u);
    const float b = __uint_as_float((h2 & 0x80000000u) | ((103u + h2 % 49u) << 23) |
                                    (h3 & 0x7fffffu));
    float a;
    if (i & 1) {
      const float q = __uint_as_float((h0 & 0x80000000u) | ((60u + h0 % 130u) << 23) |
                                      (h1 & 0x7fffffu));
      const double ulp = (double)__uint_as_float(((60u + h0 % 130u) - 23u) << 23);
      a = (float)((double)b * ((double)q + 0.5 * ulp));
    } else {
      a = __uint_as_float((h0 & 0x80000000u) | ((31u + h0 % 193u) << 23) | (h1 & 0x7fffffu));
    }
    const float ref = __fdiv_rn(a, b), got = div_fast(a, b, __frcp_rn(b));
    if (__float_as_uint(got) != __float_as_uint(ref) && atomicAdd(bad, 1ull) == 0) {
      first[0] = a;
      first[1] = b;
      first[2] = ref;
      first[3] = got;
    }
  }
}

__global__ void rcp_check_kernel(unsigned long long* bad) {
  const uint32_t lo = 103u << 23, n = (48u << 23) + 1;  // 2^-24 .. 2^24
  unsigned long long mine = 0;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < 2 * n;
       i += gridDim.x * blockDim.x) {
    const float b = __uint_as_float((i >= n ? 0x80000000u : 0u) | (lo + i % n));
    mine += __float_as_uint(rcp_rn(b)) != __float_as_uint(__frcp_rn(b));
  }
  if (mine) atomicAdd(bad, mine);
}

}  // namespace

extern "C" int probe_chain(int variant, const void* p, void* out, void* cyc, int reps,
                           void* stream) {
  chain_kernel<<<1, 1, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      variant, static_cast<const float*>(p), static_cast<float*>(out),
      static_cast<long long*>(cyc), reps);
  return (int)cudaGetLastError();
}

extern "C" int probe_div_check(unsigned long long n, unsigned seed, void* bad, void* first,
                               void* stream) {
  div_check_kernel<<<132 * 8, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      n, seed, static_cast<unsigned long long*>(bad), static_cast<float*>(first));
  return (int)cudaGetLastError();
}

extern "C" int probe_rcp_check(void* bad, void* stream) {
  rcp_check_kernel<<<132 * 8, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(bad));
  return (int)cudaGetLastError();
}
