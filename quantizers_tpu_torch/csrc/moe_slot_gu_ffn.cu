// MoE slot FFN over the fused int8 per-channel (w8pc) expert layout, for
// Hopper (sm_90a).
//
// Replaces quantizers_tpu/ops/kernels.py `_moe_slot_gu_call` (kernel
// `_moe_slot_gu_kernel`, wrapper `moe_slot_gu_ffn`): for S slots, each a
// row of x (S, D) bf16 and an expert id e, with the fused gate|up stack
// int8 (E, D, 2F), its f32 per-channel scales (E, 1, 2F), the down stack
// int8 (E, F, D) and its scales (E, 1, D): g|u = (x_s GU_e) * gus_e, a =
// bf16(silu(g) * u), y[s] = (a Dn_e) * ds_e, (S, D) f32. The int8 codes
// are exact in bf16 and each product with a bf16 is exact in f32; the
// scales multiply the finished f32 sums, never the weights (as in the TPU
// kernel).
//
// What bounds it on the H100 SXM: bytes. Qwen3-30B-A3B decode at batch 8
// and top-8 (S 64, D 2048, F 768, E 128): an expert is 4.72 MB (3.1 MB
// gate|up, 1.6 MB down, 12 KB of scales). The router's 64 slots fall on
// about 50 distinct experts, 236 MB a call if each routed expert is read
// once: 71 us at 3.35 TB/s (302 MB and 90 us when all 64 are distinct).
//
// Design: the slot FFN skeleton of slot_group.cuh, shared with K6: the
// slots grouped by expert inside the kernel (each routed expert read once a
// pass of 8 slots, the grid from the shapes alone: no sort and no host
// sync), 128 output columns a block, each stored row one 128-byte line
// copied by 16-byte cp.async into a ring of 3 stages, three blocks an SM.
// This payload (kW8pc):
// * The codes are decoded over their full range, -128..127, to exact bf16
//   pairs (common.cuh: decode_i8) and multiplied on mma.sync; no scale
//   enters a stage, which holds the two 128-column weight tiles and the
//   pass's 8 x rows (17.1 KB; 51.4 KB a ring).
// * The fused stack: a gate|up block owns gate columns n0.. and up columns
//   F + n0.. of the same 2F-byte rows (two operands `ld` = 2F apart from
//   their N = F), multiplies each column's finished f32 sum by its f32
//   scale and writes a = bf16(silu(g) * u) into the (S, F) workspace; the
//   down block (ld = N = D) writes y = sum * scale in f32.
// * Ids out of range write NaN rows, as the first port did.
//
// What moved it on the H100 (PERF.md, section 6): the grouping, the 128-byte
// lines and mma.sync (0.222 -> 0.111 ms a call at the router routing), then
// the first stages' weights issued before the walk of idx (0.108); a ring of
// 4, 2 blocks an SM with a ring of 5 or 6, and 4 down blocks an SM did not.
// With no decode and no products a call still takes 96% of its time: the
// copies bound it, at about 2.2 TB/s.
//
// Left for later: the gate|up launch's ~300 blocks fill one wave unevenly
// (two or three an SM), and a TMA producer warp (K3's gave 3-4%).

#include <initializer_list>

#include "slot_group.cuh"

using namespace qtt;

extern "C" int qtt_moe_slot_gu_ffn(const void* x, const void* idx, const void* guw,
                                   const void* gus, const void* dw, const void* ds, void* a_ws,
                                   void* out, int S, int D, int F, int E, void* stream) {
  // 128 | D, F: whole column tiles and whole stages
  if (S <= 0 || E <= 0 || D % kCols || F % kCols) return (int)cudaErrorInvalidValue;
  for (const void* p : {x, guw, gus, dw, ds, (const void*)a_ws, (const void*)out})
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  const auto* w = static_cast<const uint8_t*>(guw);
  const auto* gs = static_cast<const float*>(gus);
  const long long gu_bytes = (long long)D * 2 * F;
  const Mat G{w, gs, gu_bytes, 2LL * F, 2 * F};
  const Mat U{w + F, gs + F, gu_bytes, 2LL * F, 2 * F};
  const Mat Dn{static_cast<const uint8_t*>(dw), ds, (long long)F * D, (long long)D, D};
  return slot_ffn<kW8pc, false>(static_cast<const __nv_bfloat16*>(x),
                                static_cast<const int*>(idx), G, U, Dn,
                                static_cast<__nv_bfloat16*>(a_ws), static_cast<float*>(out), S,
                                D, F, E, 1, reinterpret_cast<cudaStream_t>(stream));
}
