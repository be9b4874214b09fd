// MoE slot FFN over quantized expert stacks, for Hopper (sm_90a).
//
// Replaces quantizers_tpu/ops/kernels.py `_moe_slot_ffn_call` (kernel
// `_moe_slot_ffn_kernel`, dequantization `_dequant_tile`): for S slots, each
// a row of x (S, D) bf16 and an expert id, y[s] = (silu(x_s G_e) *
// (x_s U_e)) Dn_e, (S, D) f32, where G and U are (E, D, F) and Dn (E, F, D)
// stacks in one of three payloads: packed w4 (uint8 (K/2, N) split-half,
// value = nibble - 8), packed E2M1 (the same layout of E2M1 codes), or int8
// (K, N) holding 2x the E2M1 value with halved scales; group scales bf16
// (K/g, N), g | D and g | F. As in `_dequant_tile`, each weight is value *
// scale rounded to bf16 once (for w4 too), a is rounded to bf16 before the
// down product, and products and sums are f32.
//
// What bounds it on the H100 SXM: bytes. Qwen3-30B-A3B decode at batch 8
// and top-8 (S 64, D 2048, F 768, E 128) routes its 64 slots to about 50
// distinct experts of 2.95 MB each (packed E2M1 with g 16 scales): 147 MB
// a call, 44 us at 3.35 TB/s, if each routed expert is read once.
//
// Design: the slot FFN skeleton of slot_group.cuh (the slots grouped by
// expert inside the kernel, 128 columns a block on mma.sync, a ring of 3
// cp.async stages, three blocks an SM), with these payloads:
// * Packed stages hold 128 K rows: both planes of x and, when 16 | g, of
//   one scale row a k16 step. Other g read each K row's scale from device
//   memory.
// * What moved it on the H100 (PERF.md, section 6): 3 blocks an SM
//   in place of 2, a ring of 3 in place of 4 (6 was slower), 8 slots an
//   item in place of 16; not the order of the grid. With no decode and no
//   products it still took 80% of its time: the copies bound it.
// * Decode in registers (common.cuh): E2M1 nibbles to bf16 in three integer
//   instructions and an exact multiply by 2^126; int8-doubled bytes by a
//   byte permute and a bf16x2 subtract; w4 nibbles to the exact c - 8. Then
//   one bf16x2 multiply by the scale pair rounds the exact product once.

#include <initializer_list>

#include "slot_group.cuh"

namespace {
using namespace qtt;

template <int P>
int slot_ffn_g(const __nv_bfloat16* x, const int* idx, Mat G, Mat U, Mat Dn,
               __nv_bfloat16* a_ws, float* out, int S, int D, int F, int E, int g,
               cudaStream_t stream) {
  return g % 16 == 0 ? slot_ffn<P, true>(x, idx, G, U, Dn, a_ws, out, S, D, F, E, g, stream)
                     : slot_ffn<P, false>(x, idx, G, U, Dn, a_ws, out, S, D, F, E, g, stream);
}

}  // namespace

// payload: 0 packed w4, 1 packed E2M1, 2 int8-doubled E2M1.
extern "C" int qtt_moe_slot_ffn(int payload, const void* x, const void* idx, const void* gw,
                                const void* gs, const void* uw, const void* us, const void* dw,
                                const void* ds, void* a_ws, void* out, int S, int D, int F,
                                int E, int g, void* stream) {
  // 128 | D, F: whole column tiles and whole stages of both planes
  if (S <= 0 || E <= 0 || g <= 0 || D % kCols || F % kCols || D % g || F % g || payload < 0 ||
      payload > 2)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {x, gw, gs, uw, us, dw, ds, (const void*)a_ws, (const void*)out})
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  const bool packed = payload != kInt8;
  const long long gu_bytes = (long long)(packed ? D / 2 : D) * F;
  const long long d_bytes = (long long)(packed ? F / 2 : F) * D;
  const auto bf = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
  const auto u8 = [](const void* p) { return static_cast<const uint8_t*>(p); };
  const Mat G{u8(gw), gs, gu_bytes, (long long)(D / g) * F, F};
  const Mat U{u8(uw), us, gu_bytes, (long long)(D / g) * F, F};
  const Mat Dn{u8(dw), ds, d_bytes, (long long)(F / g) * D, D};
  const auto* xb = bf(x);
  const auto* ib = static_cast<const int*>(idx);
  auto* ab = static_cast<__nv_bfloat16*>(a_ws);
  auto* ob = static_cast<float*>(out);
  auto st = reinterpret_cast<cudaStream_t>(stream);
  if (payload == kW4) return slot_ffn_g<kW4>(xb, ib, G, U, Dn, ab, ob, S, D, F, E, g, st);
  if (payload == kE2M1) return slot_ffn_g<kE2M1>(xb, ib, G, U, Dn, ab, ob, S, D, F, E, g, st);
  return slot_ffn_g<kInt8>(xb, ib, G, U, Dn, ab, ob, S, D, F, E, g, st);
}
