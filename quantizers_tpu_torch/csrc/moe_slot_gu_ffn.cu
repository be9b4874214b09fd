// MoE slot FFN over the fused int8 per-channel expert layout, for Hopper.
//
// Replaces quantizers_tpu/ops/kernels.py `_moe_slot_gu_kernel` /
// `_moe_slot_gu_call`: for S slots, each a row of x (S, D) bf16 and an
// expert id, with the fused gate|up stack int8 (E, D, 2F), its f32
// per-channel scales (E, 1, 2F), the down stack int8 (E, F, D) and its
// scales (E, 1, D): g|u = (x_s W_e) * s_e, a = bf16(silu(g) * u),
// y[s] = (a Dn_e) * ds_e, (S, D) f32. The int8 values are exact in bf16;
// the scales multiply the sums, not the weights (as in the TPU kernel).
//
// What bounds it on the H100 SXM: bytes. Qwen3-30B-A3B decode at batch 8
// and top-8 (S 64, D 2048, F 768, E 128): an expert is 4.72 MB (3.1 MB
// gate|up, 1.6 MB down, plus 12 KB of scales); reading each slot's expert
// once per slot is 302 MB, 90 us at 3.35 TB/s. One FMA per weight on the
// CUDA cores.
//
// Design (slot_ffn.cuh): two launches per call, gate|up then down, one
// block per (slot, 32 output columns); a lane owns column j of the gate
// half and column F + j of the up half of the fused stack, so one block
// reads both halves of its columns. The TPU kernel's VMEM limit has no
// counterpart here.
//
// Left for later: group slots by expert, int8 tensor-core products
// (x quantized per slot, or the weights converted to bf16 in registers).

#include "slot_ffn.cuh"

using namespace qtt;

extern "C" int qtt_moe_slot_gu_ffn(const void* x, const void* idx, const void* guw,
                                   const void* gus, const void* dw, const void* ds, void* a_ws,
                                   void* out, int S, int D, int F, int E, void* stream) {
  if (S <= 0 || E <= 0 || D % kSlotCols || F % kSlotCols) return (int)cudaErrorInvalidValue;
  const long long gu_bytes = (long long)D * 2 * F;
  const auto* w = static_cast<const uint8_t*>(guw);
  const SlotMat G{w, gus, gu_bytes, 2LL * F, 2 * F, 0};
  const SlotMat U{w, gus, gu_bytes, 2LL * F, 2 * F, F};
  const SlotMat Dn{static_cast<const uint8_t*>(dw), ds, (long long)F * D, (long long)D, D, 0};
  return slot_ffn_launch<kInt8PerChannel>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(idx), S, D, F, E, 1, G, U,
      Dn, static_cast<__nv_bfloat16*>(a_ws), static_cast<float*>(out),
      reinterpret_cast<cudaStream_t>(stream));
}
