// LSTM inference recurrence for Hopper (sm_90a): K1.
//
// Replaces the TPU kernel stt_tpu/ops/lstm_kernel.py::_kernel (launched by
// _lstm_fused_impl). The step itself, its layout and its semantics are in
// lstm_step.cuh, which the training forward (lstm_train.cu) shares. x_proj
// already holds x . W_x + bias (bias added in f32, then stored in the
// compute dtype).
//
// What bounds it on this card: every step reads all of W_h [H, 4H] (64 MiB
// in f32, 32 MiB in bf16 at H = 2048), which no SM's 227 KB of shared
// memory can hold, so a step costs at least H*4H*itemsize / 3.35 TB/s
// (about 20 us in f32 at H = 2048). The arithmetic, 2*B*H*4H per step, is
// far below that at serving batch sizes (B = 1 for a stream, 16 for a
// batch): the recurrence is bound by bytes.
//
// What the design does about it: one launch per step (the kernel boundary
// is the grid-wide barrier the recurrence needs); W_h is read once per step
// per 8-row batch tile.
//
// Not done yet: W_h slices resident in shared memory across a cluster or a
// persistent cooperative grid, wgmma at larger batch, one launch for all T.

#include "lstm_step.cuh"

namespace {

template <typename WT, typename XT>
__global__ void __launch_bounds__(lstm::THREADS)
lstm_step(const XT* __restrict__ x_proj_t, const WT* __restrict__ w_h,
          const float* __restrict__ h_prev, float* __restrict__ h_next,
          float* __restrict__ c, const int32_t* __restrict__ seq,
          float* __restrict__ out_t, int t, int B, int H) {
  lstm::step<WT, XT, false>(x_proj_t, w_h, h_prev, h_next, c, seq, out_t,
                            nullptr, nullptr, t, B, H);
}

template <typename WT, typename XT>
int run(const void* x_proj, const void* w_h, float* c, float* h,
        const int32_t* seq, float* out, int T, int B, int H, void* stream) {
  const dim3 grid((H + lstm::JT - 1) / lstm::JT, (B + lstm::BT - 1) / lstm::BT);
  const size_t bh = (size_t)B * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int t = 0; t < T; ++t) {
    // h holds two [B, H] buffers: step t reads h[t % 2], writes the other
    lstm_step<WT, XT><<<grid, lstm::THREADS, 0, s>>>(
        static_cast<const XT*>(x_proj) + (size_t)t * 4 * bh,
        static_cast<const WT*>(w_h), h + (t % 2) * bh, h + ((t + 1) % 2) * bh,
        c, seq, out + (size_t)t * bh, t, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x_proj [T, B, 4H] and w_h [H, 4H] in f32; c [B, H] in/out; h [2, B, H]
// with h0 in h[0] (the final h ends in h[T % 2]); seq [B]; out [T, B, H].
int lstm_recurrence_f32(const void* x_proj, const void* w_h, float* c,
                        float* h, const int32_t* seq, float* out, int T, int B,
                        int H, void* stream) {
  return run<float, float>(x_proj, w_h, c, h, seq, out, T, B, H, stream);
}

// The same with x_proj and w_h in bf16; gates and state stay f32.
int lstm_recurrence_bf16(const void* x_proj, const void* w_h, float* c,
                         float* h, const int32_t* seq, float* out, int T,
                         int B, int H, void* stream) {
  return run<__nv_bfloat16, __nv_bfloat16>(x_proj, w_h, c, h, seq, out, T, B,
                                           H, stream);
}

}  // extern "C"
