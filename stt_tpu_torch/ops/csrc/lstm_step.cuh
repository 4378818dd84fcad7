// One step of the LSTM recurrence, shared by the inference kernel (K1,
// lstm_recurrence.cu) and the training forward (K3, lstm_train.cu); the int8
// recurrence (K2, lstm_recurrence_q.cu) shares the tiling constants and the
// gate math.
//
//     z      = x_proj[t] + h_{t-1} . W_h          (f32 accumulate)
//     i,g,f,o = split(z, 4)                       (gate order i, g, f, o)
//     c_t    = sigmoid(f) c_{t-1} + sigmoid(i) tanh(g)
//     h_t    = sigmoid(o) tanh(c_t)
//
// Past seq[b] the state of row b freezes and out[t, b] = 0. h is rounded to
// W_h's dtype before each product, as on the TPU.
//
// Layout: a block owns JT = 16 hidden units for all four gates and BT = 8
// batch rows, so W_h is read once per step per batch tile, not once per
// row. Its 8 warps split the reduction over k; within a warp the 32 lanes
// cover 16 units x 2 rows of W_h, so each load instruction reads whole
// 32-byte sectors in bf16 and 64-byte runs in f32. Partial sums meet in
// shared memory, and one thread per (row, unit) applies the gate math and
// the length mask. c is updated in place, h goes to a ping-pong buffer, so
// no step reads what another block of the same step writes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lstm {

constexpr int JT = 16;            // hidden units per block
constexpr int KL = 32 / JT;       // rows of W_h a warp covers per load
constexpr int KS = 8;             // warps per block, splitting the k sum
constexpr int BT = 8;             // batch rows per block
constexpr int THREADS = 32 * KS;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// a value is rounded to W_h's dtype before it multiplies W_h
__device__ __forceinline__ float as_weight_type(float v, const float*) {
  return v;
}
__device__ __forceinline__ float as_weight_type(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The gate math and the length mask for one (row, unit) at flat index idx,
// from its four pre-activations z (i, g, f, o): updates c in place, writes
// the carried h to h_next and the emitted output to out_t. Returns the
// carried c. The int8 recurrence (lstm_recurrence_q.cu) shares it.
__device__ __forceinline__ float finish(
    const float (&z)[4], float* __restrict__ c,
    const float* __restrict__ h_prev, float* __restrict__ h_next,
    float* __restrict__ out_t, size_t idx, bool valid) {
  const float c_old = c[idx];
  const float c_new = sigmoid(z[2]) * c_old + sigmoid(z[0]) * tanhf(z[1]);
  const float h_new = sigmoid(z[3]) * tanhf(c_new);
  const float c_kept = valid ? c_new : c_old;
  c[idx] = c_kept;
  h_next[idx] = valid ? h_new : h_prev[idx];
  out_t[idx] = valid ? h_new : 0.0f;
  return c_kept;
}

// With STASH (the training forward) the step also writes the carried c
// after the length mask to cs_t and the pre-activations z, rounded to
// bf16, to zs_t; without it both pointers are unused.
template <typename WT, typename XT, bool STASH>
__device__ __forceinline__ void step(
    const XT* __restrict__ x_proj_t,   // [B, 4H], step t
    const WT* __restrict__ w_h,        // [H, 4H]
    const float* __restrict__ h_prev,  // [B, H]
    float* __restrict__ h_next,        // [B, H]
    float* __restrict__ c,             // [B, H], in place
    const int32_t* __restrict__ seq,   // [B]
    float* __restrict__ out_t,         // [B, H], step t
    float* __restrict__ cs_t,          // [B, H], step t (STASH)
    __nv_bfloat16* __restrict__ zs_t,  // [B, 4H], step t (STASH)
    int t, int B, int H) {
  __shared__ float part[KS][BT][4][JT];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int jj = lane % JT;
  const int kk = lane / JT;
  const int j = blockIdx.x * JT + jj;
  const int b0 = blockIdx.y * BT;
  const int nb = min(BT, B - b0);
  const size_t H4 = 4 * (size_t)H;

  float acc[BT][4];
#pragma unroll
  for (int bb = 0; bb < BT; ++bb) {
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[bb][g] = 0.0f;
  }

  if (j < H) {
#pragma unroll 4
    for (int k = warp * KL + kk; k < H; k += KS * KL) {
      const WT* row = w_h + (size_t)k * H4 + j;
      const float w0 = to_f32(row[0]);
      const float w1 = to_f32(row[H]);
      const float w2 = to_f32(row[2 * (size_t)H]);
      const float w3 = to_f32(row[3 * (size_t)H]);
#pragma unroll
      for (int bb = 0; bb < BT; ++bb) {
        if (bb < nb) {
          const float hv = as_weight_type(h_prev[(size_t)(b0 + bb) * H + k], w_h);
          acc[bb][0] = fmaf(hv, w0, acc[bb][0]);
          acc[bb][1] = fmaf(hv, w1, acc[bb][1]);
          acc[bb][2] = fmaf(hv, w2, acc[bb][2]);
          acc[bb][3] = fmaf(hv, w3, acc[bb][3]);
        }
      }
    }
  }

  // lanes jj and jj + JT hold the same unit's sums over different rows
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
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < KS; ++w) s += part[w][bb][g][tid % JT];
    z[g] = to_f32(x_proj_t[(size_t)b * H4 + (size_t)g * H + ju]) + s;
  }
  const size_t idx = (size_t)b * H + ju;
  const float c_kept = finish(z, c, h_prev, h_next, out_t, idx, t < seq[b]);
  if constexpr (STASH) {
    cs_t[idx] = c_kept;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      zs_t[(size_t)b * H4 + (size_t)g * H + ju] = __float2bfloat16(z[g]);
  }
}

}  // namespace lstm
