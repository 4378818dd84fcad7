// int8 LSTM inference recurrence for Hopper (sm_90a): K2.
//
// Replaces the TPU kernel stt_tpu/ops/lstm_kernel.py::_kernel_q (launched by
// lstm_fused_q_impl). Per step:
//
//     h_q = round_half_even(h * 127)          int8; |h| < 1, so no clip
//     acc = h_q . W_h_q                       int32, the exact sum
//     z   = x_proj[t] + float(acc) * step_scale
//
// then the gate math, the length mask and the f32 carry of lstm_step.cuh
// (lstm::finish), shared with K1 and K3. x_proj holds x . W_x + bias in f32
// or bf16; step_scale [4H] is W_h's per-channel scale / 127.
//
// What bounds it on this card: as K1, every step reads all of W_h_q, here
// [H, 4H] at one byte (16 MiB at H = 2048), which no SM's shared memory
// holds, so a step costs at least H*4H / 3.35 TB/s from device memory
// (about 5 us at H = 2048); the 2*B*H*4H int8 operations per step are far
// below the card's int8 rate at serving batch sizes. Bound by bytes. At
// 16 MiB the weights fit the 50 MB L2, so steps after the first can read
// them from there.
//
// What the design does about it: K1's tiling (a block owns 16 units x 4
// gates x 8 rows; its 8 warps split the k sum), with the weights re-laid
// once by the wrapper so that four consecutive k of one column share a
// 32-bit word: w4[k/4][n] holds W_h_q[k .. k+3][n] in its bytes, low byte
// first. A lane then loads one word per gate, 16 lanes a 64-byte run, and
// feeds it with four packed h_q bytes to __dp4a (four int8 products into an
// int32 sum). h_q is written by the step that produces h, next to it, so no
// step quantizes what it reads. One launch per step is the grid-wide
// barrier the recurrence needs.
//
// Not done yet: wider loads (16 k per lane), W_h_q slices resident in shared
// memory across a cluster, int8 tensor-core products at larger batch.

#include "lstm_step.cuh"

namespace {

__device__ __forceinline__ int8_t quantize_h(float h) {
  return static_cast<int8_t>(__float2int_rn(h * 127.0f));  // half to even
}

__global__ void quantize_state(const float* __restrict__ h,
                               int8_t* __restrict__ h_q, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) h_q[i] = quantize_h(h[i]);
}

template <typename XT>
__global__ void __launch_bounds__(lstm::THREADS)
lstm_step_q(const XT* __restrict__ x_proj_t,       // [B, 4H], step t
            const int32_t* __restrict__ w4,        // [H/4, 4H] packed int8x4
            const float* __restrict__ step_scale,  // [4H]
            const float* __restrict__ h_prev,      // [B, H]
            float* __restrict__ h_next,            // [B, H]
            const int32_t* __restrict__ hq_prev,   // [B, H/4] packed int8x4
            int8_t* __restrict__ hq_next,          // [B, H]
            float* __restrict__ c,                 // [B, H], in place
            const int32_t* __restrict__ seq,       // [B]
            float* __restrict__ out_t,             // [B, H], step t
            int t, int B, int H) {
  using namespace lstm;
  __shared__ int32_t part[KS][BT][4][JT];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int jj = lane % JT;
  const int kk = lane / JT;
  const int j = blockIdx.x * JT + jj;
  const int b0 = blockIdx.y * BT;
  const int nb = min(BT, B - b0);
  const size_t H4 = 4 * (size_t)H;
  const int K4 = H / 4;

  int32_t acc[BT][4];
#pragma unroll
  for (int bb = 0; bb < BT; ++bb) {
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[bb][g] = 0;
  }

  if (j < H) {
#pragma unroll 4
    for (int k4 = warp * KL + kk; k4 < K4; k4 += KS * KL) {
      const int32_t* row = w4 + (size_t)k4 * H4 + j;
      const int32_t w0 = row[0];
      const int32_t w1 = row[H];
      const int32_t w2 = row[2 * (size_t)H];
      const int32_t w3 = row[3 * (size_t)H];
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) {
        if (bb < nb) {
          const int32_t hv = hq_prev[(size_t)(b0 + bb) * K4 + k4];
          acc[bb][0] = __dp4a(hv, w0, acc[bb][0]);
          acc[bb][1] = __dp4a(hv, w1, acc[bb][1]);
          acc[bb][2] = __dp4a(hv, w2, acc[bb][2]);
          acc[bb][3] = __dp4a(hv, w3, acc[bb][3]);
        }
      }
    }
  }

  // lanes jj and jj + JT hold the same unit's sums over different k
#pragma unroll
  for (int off = JT; off < 32; off <<= 1) {
#pragma unroll
    for (int bb = 0; bb < BT; ++bb) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        acc[bb][g] += __shfl_xor_sync(0xffffffffu, acc[bb][g], off);
    }
  }
  if (kk == 0) {
#pragma unroll
    for (int bb = 0; bb < BT; ++bb) {
#pragma unroll
      for (int g = 0; g < 4; ++g) part[warp][bb][g][jj] = acc[bb][g];
    }
  }
  __syncthreads();

  const int tid = threadIdx.x;
  if (tid >= BT * JT) return;
  const int bb = tid / JT;
  const int ju = blockIdx.x * JT + tid % JT;
  if (bb >= nb || ju >= H) return;
  const int b = b0 + bb;

  float z[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    int32_t s = 0;
#pragma unroll
    for (int w = 0; w < KS; ++w) s += part[w][bb][g][tid % JT];
    const size_t n = (size_t)g * H + ju;
    // product and sum rounded separately, as the plain version rounds them
    z[g] = __fadd_rn(to_f32(x_proj_t[(size_t)b * H4 + n]),
                     __fmul_rn(__int2float_rn(s), step_scale[n]));
  }
  const size_t idx = (size_t)b * H + ju;
  finish(z, c, h_prev, h_next, out_t, idx, t < seq[b]);
  hq_next[idx] = quantize_h(h_next[idx]);
}

template <typename XT>
int run(const void* x_proj, const int32_t* w4, const float* step_scale,
        float* c, float* h, int8_t* h_q, const int32_t* seq, float* out, int T,
        int B, int H, void* stream) {
  const dim3 grid((H + lstm::JT - 1) / lstm::JT, (B + lstm::BT - 1) / lstm::BT);
  const size_t bh = (size_t)B * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  quantize_state<<<(unsigned)((bh + 255) / 256), 256, 0, s>>>(h, h_q, (int)bh);
  for (int t = 0; t < T; ++t) {
    // h and h_q hold two [B, H] buffers each: step t reads [t % 2] and
    // writes the other
    const size_t from = (t % 2) * bh, to = ((t + 1) % 2) * bh;
    lstm_step_q<XT><<<grid, lstm::THREADS, 0, s>>>(
        static_cast<const XT*>(x_proj) + (size_t)t * 4 * bh, w4, step_scale,
        h + from, h + to, reinterpret_cast<const int32_t*>(h_q + from),
        h_q + to, c, seq, out + (size_t)t * bh, t, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x_proj [T, B, 4H] f32; w4 [H/4, 4H] int32 (W_h_q packed four k to a word);
// step_scale [4H] f32; c [B, H] in/out; h [2, B, H] f32 with h0 in h[0] (the
// final h ends in h[T % 2]); h_q [2, B, H] int8 scratch; seq [B]; out
// [T, B, H]. H must be a multiple of 4.
int lstm_recurrence_q_f32(const void* x_proj, const int32_t* w4,
                          const float* step_scale, float* c, float* h,
                          int8_t* h_q, const int32_t* seq, float* out, int T,
                          int B, int H, void* stream) {
  return run<float>(x_proj, w4, step_scale, c, h, h_q, seq, out, T, B, H, stream);
}

// The same with x_proj in bf16; gates and state stay f32.
int lstm_recurrence_q_bf16(const void* x_proj, const int32_t* w4,
                           const float* step_scale, float* c, float* h,
                           int8_t* h_q, const int32_t* seq, float* out, int T,
                           int B, int H, void* stream) {
  return run<__nv_bfloat16>(x_proj, w4, step_scale, c, h, h_q, seq, out, T, B,
                            H, stream);
}

}  // extern "C"
