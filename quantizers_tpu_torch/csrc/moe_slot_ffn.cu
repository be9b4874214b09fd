// MoE slot FFN over quantized expert stacks, for Hopper (sm_90a).
//
// Replaces quantizers_tpu/ops/kernels.py `_moe_slot_ffn_kernel` /
// `_moe_slot_ffn_call` (with `_dequant_tile`): for S slots, each a row of x
// (S, D) bf16 and an expert id, y[s] = (silu(x_s G_e) * (x_s U_e)) Dn_e,
// (S, D) f32, where G and U are (E, D, F) and Dn (E, F, D) stacks in one of
// three payloads (slot_ffn.cuh): packed w4 (value = nibble - 8), packed
// E2M1 codes, or int8 holding 2x the E2M1 value with halved scales; group
// scales bf16, g | D and g | F. As in `_dequant_tile`, each weight is
// value * scale rounded to bf16 (exact in f32 before the rounding), and a
// is rounded to bf16 before the down product; products and sums are f32.
//
// What bounds it on the H100 SXM: bytes. Qwen3-30B-A3B decode at batch 8
// and top-8 (S 64, D 2048, F 768, E 128) reads about 50 distinct experts of
// 2.95 MB (packed E2M1 with g = 16 scales) per layer; the simple design
// reads each slot's expert once per slot (64 x 2.95 MB, 57 us at
// 3.35 TB/s) and does a decode, a scale, a rounding and an FMA per weight
// on the CUDA cores.
//
// Design (slot_ffn.cuh): two launches per call, gate|up then down, one
// block per (slot, 32 output columns), one column per lane, 8 warps on
// disjoint K segments; a (S, F) bf16 workspace carries a between them. The
// TPU kernel's F slicing and its 5.6 MB refusal for packed payloads are
// VMEM budgets with no counterpart here; its expert-sorted slot order only
// skips refetches and is left out.
//
// Left for later: group slots by expert so a repeated expert is read once,
// tensor-core products over the slots of one expert, and a Hopper layout of
// the E2M1 codes.

#include "slot_ffn.cuh"

using namespace qtt;

// payload: 0 packed w4, 1 packed E2M1, 2 int8-doubled E2M1.
extern "C" int qtt_moe_slot_ffn(int payload, const void* x, const void* idx, const void* gw,
                                const void* gs, const void* uw, const void* us, const void* dw,
                                const void* ds, void* a_ws, void* out, int S, int D, int F,
                                int E, int g, void* stream) {
  if (S <= 0 || E <= 0 || g <= 0 || D % kSlotCols || F % kSlotCols || D % g || F % g ||
      payload < 0 || payload > 2)
    return (int)cudaErrorInvalidValue;
  const bool packed = payload != 2;
  if (packed && (D % 2 || F % 2)) return (int)cudaErrorInvalidValue;
  const long long g_bytes = (long long)(packed ? D / 2 : D) * F;
  const long long d_bytes = (long long)(packed ? F / 2 : F) * D;
  const SlotMat G{static_cast<const uint8_t*>(gw), gs, g_bytes, (long long)(D / g) * F, F, 0};
  const SlotMat U{static_cast<const uint8_t*>(uw), us, g_bytes, (long long)(D / g) * F, F, 0};
  const SlotMat Dn{static_cast<const uint8_t*>(dw), ds, d_bytes, (long long)(F / g) * D, D, 0};
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* ib = static_cast<const int*>(idx);
  auto* ab = static_cast<__nv_bfloat16*>(a_ws);
  auto* ob = static_cast<float*>(out);
  auto st = reinterpret_cast<cudaStream_t>(stream);
  if (payload == 0) return slot_ffn_launch<kPackedW4>(xb, ib, S, D, F, E, g, G, U, Dn, ab, ob, st);
  if (payload == 1) return slot_ffn_launch<kPackedFp4>(xb, ib, S, D, F, E, g, G, U, Dn, ab, ob, st);
  return slot_ffn_launch<kInt8Scaled>(xb, ib, S, D, F, E, g, G, U, Dn, ab, ob, st);
}
