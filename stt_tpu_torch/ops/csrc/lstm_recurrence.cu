// LSTM inference recurrence for Hopper (sm_90a): K1.
//
// Replaces the TPU kernel stt_tpu/ops/lstm_kernel.py::_kernel (launched by
// _lstm_fused_impl). The kernel, its layout and its semantics are in
// lstm_step.cuh, which the training forward (lstm_train.cu) shares. x_proj
// already holds x . W_x + bias (bias added in f32, then stored in the
// compute dtype).
//
// What bounds it on this card: bytes. Every step needs all of W_h [H, 4H]
// (64 MiB in f32, 32 MiB in bf16 at H = 2048) for 2*B*H*4H operations, far
// below the card's rate at serving batch sizes (B = 1 for a stream, 16 for
// a batch). All the blocks' shared memory together holds 132 x 227 KB, less
// than W_h, so a part of W_h has to come from device memory (or the L2) at
// every step, and the steps are a chain: each waits for the last one's h
// from every block.
//
// What the design does about it: one cooperative launch for all T steps,
// one block per SM, each owning 16 hidden units for all four gates. The
// chunks of a block's slice of W_h that fit stay in its shared memory for
// the whole call; the rest streams every step through a ring of bulk copies
// (TMA, counted by mbarriers) that runs several chunks ahead and across the
// grid-wide barrier between steps. h is staged in shared memory chunk by
// chunk and shared by all warps; W_h is read once per step for up to 32
// rows. The first step fills the resident part while it computes, so a
// chunk of 16 steps pays no separate pass over W_h.
//
// In bf16 from 8 rows up the product runs on the tensor cores (mma.sync
// m16n8k16, f32 accumulation); f32 stays on FFMA, since the port runs with
// TF32 off and TF32 could not hold the f32 tolerance.
//
// Not done yet: an uneven split of the units over all 132 SMs (128 blocks
// work at H = 2048); wgmma instead of mma.sync.

#include "lstm_step.cuh"

extern "C" {

// K1 in f32: see lstm::run_recurrence for the arguments.
int lstm_recurrence_f32(const void* x_proj, const void* w_packed,
                        const float* c0, const float* h0, float* c, float* h,
                        void* hm, const int32_t* seq, float* out,
                        unsigned int* counter, int T, int B, int H, int bt,
                        int blocks, int tiles_per_block, int resident_chunks,
                        int smem, void* stream) {
  return lstm::run_recurrence<float, float, false>(
      x_proj, w_packed, nullptr, c0, h0, c, h, hm, seq, out, nullptr, nullptr, counter,
      T, B, H, bt, blocks, tiles_per_block, resident_chunks, smem, stream);
}

// The same with x_proj and W_h in bf16; gates and state stay f32.
int lstm_recurrence_bf16(const void* x_proj, const void* w_packed,
                         const float* c0, const float* h0, float* c, float* h,
                         void* hm, const int32_t* seq, float* out,
                         unsigned int* counter, int T, int B, int H, int bt,
                         int blocks, int tiles_per_block, int resident_chunks,
                         int smem, void* stream) {
  return lstm::run_recurrence<__nv_bfloat16, __nv_bfloat16, false>(
      x_proj, w_packed, nullptr, c0, h0, c, h, hm, seq, out, nullptr, nullptr, counter,
      T, B, H, bt, blocks, tiles_per_block, resident_chunks, smem, stream);
}

}  // extern "C"
