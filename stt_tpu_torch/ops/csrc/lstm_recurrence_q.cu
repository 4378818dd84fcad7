// int8 LSTM inference recurrence for Hopper (sm_90a): K2.
//
// Replaces the TPU kernel stt_tpu/ops/lstm_kernel.py::_kernel_q (launched by
// lstm_fused_q_impl). Per step:
//
//     h_q = round_half_even(h * 127)          int8; |h| < 1, so no clip
//     acc = h_q . W_h_q                       int32, the exact sum
//     z   = x_proj[t] + float(acc) * step_scale
//
// then the gate math, the length mask and the f32 carry of K1. x_proj holds
// x . W_x + bias in f32 or bf16; step_scale [4H] is W_h's per-channel scale
// / 127. The kernel is K1's persistent recurrence (lstm_step.cuh) with int8
// weights: its layout and design are described there.
//
// What bounds it on this card: latency. The 2*B*H*4H int8 operations of a
// step are 0.54 G at B = 16, H = 2048 (0.3 us at the dense int8 rate), and
// W_h_q [H, 4H] at one byte (16 MiB at H = 2048) is 128 KB for each of 128
// blocks, which shared memory holds whole up to B = 32. So what a step must
// move is h_q (B x H bytes, through the L2) and x_proj[t]; the bound of the
// whole call is its bytes (W_h_q once, x_proj, out), and what a step really
// waits for is the grid-wide barrier and the round trip of h_q through the
// L2 that the recurrence needs between any two steps.
//
// What the design does about it: one cooperative launch for all T steps
// (no launch per step, no separate quantizing pass: the block that owns a
// unit writes its h_q for the next step), W_h_q resident in shared memory,
// the product on the int8 tensor cores from 8 rows up (mma.sync m16n8k32)
// and on __dp4a below.
//
// Not done yet: a step's h_q exchange and barrier are not overlapped with
// anything but the next step's first copies; wgmma instead of mma.sync.

#include "lstm_step.cuh"

extern "C" {

// K2 with x_proj in f32: see lstm::run_recurrence for the arguments (w_packed
// is `pack_w_h_q`'s layout, hm holds h_q).
int lstm_recurrence_q_f32(const void* x_proj, const void* w_packed,
                          const float* step_scale, const float* c0,
                          const float* h0, float* c, float* h, void* hm,
                          const int32_t* seq, float* out, unsigned int* counter,
                          int T, int B, int H, int bt, int blocks,
                          int tiles_per_block, int resident_chunks, int smem,
                          void* stream) {
  return lstm::run_recurrence<int8_t, float, false>(
      x_proj, w_packed, step_scale, c0, h0, c, h, hm, seq, out, nullptr, nullptr,
      counter, T, B, H, bt, blocks, tiles_per_block, resident_chunks, smem, stream);
}

// The same with x_proj in bf16; gates and state stay f32.
int lstm_recurrence_q_bf16(const void* x_proj, const void* w_packed,
                           const float* step_scale, const float* c0,
                           const float* h0, float* c, float* h, void* hm,
                           const int32_t* seq, float* out, unsigned int* counter,
                           int T, int B, int H, int bt, int blocks,
                           int tiles_per_block, int resident_chunks, int smem,
                           void* stream) {
  return lstm::run_recurrence<int8_t, __nv_bfloat16, false>(
      x_proj, w_packed, step_scale, c0, h0, c, h, hm, seq, out, nullptr, nullptr,
      counter, T, B, H, bt, blocks, tiles_per_block, resident_chunks, smem, stream);
}

}  // extern "C"
