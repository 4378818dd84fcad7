// LSTM training recurrence for Hopper (sm_90a): K3 (forward with stashes)
// and K4 (reverse sweep).
//
// K3 replaces stt_tpu/ops/lstm_train.py::_fwd_kernel (launched by
// _lstm_train_fwd_impl). It is K1's step (lstm_step.cuh) that also writes,
// per step t,
//     hs[t] = valid ? h_t : 0          (the carried h freezes instead)
//     cs[t] = the carried c after the length mask
//     zs[t] = bf16(z_t)                (bf16 whatever the compute dtype)
//
// K4 replaces stt_tpu/ops/lstm_train.py::_bwd_kernel (launched by
// _lstm_train_bwd_impl). For t from T-1 down to 0, carrying (dc, dh):
//     dh_total = dout[t] + dh
//     dc_total = dc + dh_total * o * (1 - tanh(c_t)^2)
//     dz_t     = (dc_total g i (1-i), dc_total i (1-g^2),
//                 dc_total c_{t-1} f (1-f), dh_total tanh(c_t) o (1-o)),
//                zero past seq[b]; gates from zs[t] (bf16 -> f32)
//     dh       = valid ? round(dz_t) . W_h^T : dh    (f32 accumulate)
//     dc       = valid ? dc_total * f : dc
// round() is to W_h's dtype. dW_h = h_prev^T dz and dx_proj = dz are formed
// outside, in the wrapper's autograd function.
//
// What bounds them on this card: like K1, every step reads all of W_h
// (64 MiB in f32 at H = 2048), far more than shared memory holds, so a step
// costs at least H*4H*itemsize / 3.35 TB/s (about 20 us in f32). K3 also
// writes 4H bf16 + 2H f32 per row per step; K4 reads zs, cs, cs_prev and
// dout and writes dz (f32), per row per step. The arithmetic, 2*B*H*4H per
// step, is below the byte time at training batch sizes up to ~64 in f32.
//
// K4's design: dh_prev[b, j] = sum_k dz[b, k] W_h[j, k] reads row j of W_h,
// which is contiguous, so no transposed copy is needed. A block owns 16
// hidden units (2 per warp) and 8 batch rows; each lane walks k with
// stride 32, so a warp's loads of a W_h row and of a dz row are coalesced,
// and each dz value loaded serves both of the warp's units. Having formed
// dh_prev for its units, the block goes straight on, in the same launch, to
// the gate grads of step t-1 for the same units and rows: they need only
// the carried (dc, dh) of those units, which no other block touches, and
// the four gate columns of those units. So there is one launch per step
// plus one prologue launch for the gate grads of step T-1.
//
// Not done yet: W_h resident across steps, wgmma, one launch for all T.

#include "lstm_step.cuh"

namespace {

using lstm::as_weight_type;
using lstm::sigmoid;
using lstm::to_f32;

template <typename WT, typename XT>
__global__ void __launch_bounds__(lstm::THREADS)
lstm_train_fwd_step(const XT* __restrict__ x_proj_t, const WT* __restrict__ w_h,
                    const float* __restrict__ h_prev, float* __restrict__ h_next,
                    float* __restrict__ c, const int32_t* __restrict__ seq,
                    float* __restrict__ hs_t, float* __restrict__ cs_t,
                    __nv_bfloat16* __restrict__ zs_t, int t, int B, int H) {
  lstm::step<WT, XT, true>(x_proj_t, w_h, h_prev, h_next, c, seq, hs_t, cs_t,
                           zs_t, t, B, H);
}

template <typename WT, typename XT>
int run_fwd(const void* x_proj, const void* w_h, float* c, float* h,
            const int32_t* seq, float* hs, float* cs, __nv_bfloat16* zs,
            int T, int B, int H, void* stream) {
  const dim3 grid((H + lstm::JT - 1) / lstm::JT, (B + lstm::BT - 1) / lstm::BT);
  const size_t bh = (size_t)B * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int t = 0; t < T; ++t) {
    // h holds two [B, H] buffers: step t reads h[t % 2], writes the other
    lstm_train_fwd_step<WT, XT><<<grid, lstm::THREADS, 0, s>>>(
        static_cast<const XT*>(x_proj) + (size_t)t * 4 * bh,
        static_cast<const WT*>(w_h), h + (t % 2) * bh, h + ((t + 1) % 2) * bh,
        c, seq, hs + (size_t)t * bh, cs + (size_t)t * bh,
        zs + (size_t)t * 4 * bh, t, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

constexpr int UPW = 2;                 // hidden units per warp
constexpr int BW = 8;                  // warps per block
constexpr int BJT = UPW * BW;          // hidden units per block
constexpr int BBT = 8;                 // batch rows per block
constexpr int BTHREADS = 32 * BW;
constexpr int PROLOGUE_THREADS = 256;

// The gate grads of step s at (row b, unit j), given the carried dh after
// step s+1 (dh) and the carried dc (updated in place to the carry after
// step s). Writes the four gate columns of j in dz_s.
__device__ __forceinline__ void gate_grads(
    const __nv_bfloat16* __restrict__ zs_s, const float* __restrict__ cs_s,
    const float* __restrict__ csp_s, const float* __restrict__ dout_s,
    const int32_t* __restrict__ seq, float dh, float* __restrict__ dc,
    float* __restrict__ dz_s, int s, int b, int j, int H) {
  const size_t zb = (size_t)b * 4 * H + j;
  const float i = sigmoid(to_f32(zs_s[zb]));
  const float g = tanhf(to_f32(zs_s[zb + H]));
  const float f = sigmoid(to_f32(zs_s[zb + 2 * (size_t)H]));
  const float o = sigmoid(to_f32(zs_s[zb + 3 * (size_t)H]));
  const size_t idx = (size_t)b * H + j;
  const float tanh_c = tanhf(cs_s[idx]);
  const float dc_in = dc[idx];
  const float dh_total = dout_s[idx] + dh;
  const float dc_total = dc_in + dh_total * o * (1.0f - tanh_c * tanh_c);
  const bool valid = s < seq[b];
  dz_s[zb] = valid ? dc_total * g * i * (1.0f - i) : 0.0f;
  dz_s[zb + H] = valid ? dc_total * i * (1.0f - g * g) : 0.0f;
  dz_s[zb + 2 * (size_t)H] = valid ? dc_total * csp_s[idx] * f * (1.0f - f) : 0.0f;
  dz_s[zb + 3 * (size_t)H] = valid ? dh_total * tanh_c * o * (1.0f - o) : 0.0f;
  dc[idx] = valid ? dc_total * f : dc_in;
}

// gate grads of the last step, T-1, from (dc_T, dh_T): one thread per (b, j)
__global__ void __launch_bounds__(PROLOGUE_THREADS)
lstm_train_bwd_prologue(const __nv_bfloat16* __restrict__ zs_s,
                        const float* __restrict__ cs_s,
                        const float* __restrict__ csp_s,
                        const float* __restrict__ dout_s,
                        const int32_t* __restrict__ seq,
                        const float* __restrict__ dh, float* __restrict__ dc,
                        float* __restrict__ dz_s, int s, int B, int H) {
  const size_t idx = (size_t)blockIdx.x * PROLOGUE_THREADS + threadIdx.x;
  if (idx >= (size_t)B * H) return;
  const int b = static_cast<int>(idx / H);
  const int j = static_cast<int>(idx % H);
  gate_grads(zs_s, cs_s, csp_s, dout_s, seq, dh[idx], dc, dz_s, s, b, j, H);
}

// Step t of the reverse sweep: dh_prev = round(dz_t) . W_h^T for the
// block's units and rows, the dh carry, then (t > 0) the gate grads of step
// t-1 for the same units and rows. dz_prev == nullptr at t == 0.
template <typename WT>
__global__ void __launch_bounds__(BTHREADS)
lstm_train_bwd_step(const float* __restrict__ dz_t,     // [B, 4H]
                    const WT* __restrict__ w_h,         // [H, 4H]
                    float* __restrict__ dh,             // [B, H] carry
                    float* __restrict__ dc,             // [B, H] carry
                    const int32_t* __restrict__ seq,
                    float* __restrict__ dz_prev,        // [B, 4H], step t-1
                    const __nv_bfloat16* __restrict__ zs_prev,
                    const float* __restrict__ cs_prev_step,
                    const float* __restrict__ csp_prev_step,
                    const float* __restrict__ dout_prev,
                    int t, int B, int H) {
  __shared__ float dh_part[BBT][BJT];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x * BJT + warp * UPW;
  const int b0 = blockIdx.y * BBT;
  const int nb = min(BBT, B - b0);
  const size_t H4 = 4 * (size_t)H;

  float acc[UPW][BBT];
#pragma unroll
  for (int u = 0; u < UPW; ++u) {
#pragma unroll
    for (int bb = 0; bb < BBT; ++bb) acc[u][bb] = 0.0f;
  }

#pragma unroll 2
  for (size_t k = lane; k < H4; k += 32) {
    float d[BBT];
#pragma unroll
    for (int bb = 0; bb < BBT; ++bb)
      d[bb] = bb < nb ? as_weight_type(dz_t[(size_t)(b0 + bb) * H4 + k], w_h) : 0.0f;
#pragma unroll
    for (int u = 0; u < UPW; ++u) {
      if (j0 + u < H) {
        const float w = to_f32(w_h[(size_t)(j0 + u) * H4 + k]);
#pragma unroll
        for (int bb = 0; bb < BBT; ++bb) acc[u][bb] = fmaf(d[bb], w, acc[u][bb]);
      }
    }
  }

#pragma unroll
  for (int u = 0; u < UPW; ++u) {
#pragma unroll
    for (int bb = 0; bb < BBT; ++bb) {
      float v = acc[u][bb];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) dh_part[bb][warp * UPW + u] = v;
    }
  }
  __syncthreads();

  const int tid = threadIdx.x;
  if (tid >= BBT * BJT) return;
  const int bb = tid / BJT;
  const int jj = tid % BJT;
  const int j = blockIdx.x * BJT + jj;
  if (bb >= nb || j >= H) return;
  const int b = b0 + bb;
  const size_t idx = (size_t)b * H + j;
  const float dh_new = t < seq[b] ? dh_part[bb][jj] : dh[idx];
  dh[idx] = dh_new;
  if (dz_prev != nullptr)
    gate_grads(zs_prev, cs_prev_step, csp_prev_step, dout_prev, seq, dh_new,
               dc, dz_prev, t - 1, b, j, H);
}

template <typename WT>
int run_bwd(const __nv_bfloat16* zs, const float* cs, const float* cs_prev,
            const float* dout, const void* w_h, const int32_t* seq, float* dc,
            float* dh, float* dz, int T, int B, int H, void* stream) {
  if (T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bh = (size_t)B * H;
  const size_t bh4 = 4 * bh;
  const size_t last = (size_t)(T - 1);
  lstm_train_bwd_prologue<<<(unsigned)((bh + PROLOGUE_THREADS - 1) / PROLOGUE_THREADS),
                            PROLOGUE_THREADS, 0, s>>>(
      zs + last * bh4, cs + last * bh, cs_prev + last * bh, dout + last * bh,
      seq, dh, dc, dz + last * bh4, T - 1, B, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H + BJT - 1) / BJT, (B + BBT - 1) / BBT);
  for (int t = T - 1; t >= 0; --t) {
    const bool more = t > 0;
    const size_t p = more ? (size_t)(t - 1) : 0;
    lstm_train_bwd_step<WT><<<grid, BTHREADS, 0, s>>>(
        dz + (size_t)t * bh4, static_cast<const WT*>(w_h), dh, dc, seq,
        more ? dz + p * bh4 : nullptr, zs + p * bh4, cs + p * bh,
        cs_prev + p * bh, dout + p * bh, t, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K3. x_proj [T, B, 4H] and w_h [H, 4H] in f32; c [B, H] in/out (c0 in,
// c_T out); h [2, B, H] with h0 in h[0] (h_T ends in h[T % 2]); seq [B];
// hs, cs [T, B, H] f32; zs [T, B, 4H] bf16.
int lstm_train_fwd_f32(const void* x_proj, const void* w_h, float* c, float* h,
                       const int32_t* seq, float* hs, float* cs, void* zs,
                       int T, int B, int H, void* stream) {
  return run_fwd<float, float>(x_proj, w_h, c, h, seq, hs, cs,
                               static_cast<__nv_bfloat16*>(zs), T, B, H, stream);
}

// K3 with x_proj and w_h in bf16; gates, state and stashes as above.
int lstm_train_fwd_bf16(const void* x_proj, const void* w_h, float* c, float* h,
                        const int32_t* seq, float* hs, float* cs, void* zs,
                        int T, int B, int H, void* stream) {
  return run_fwd<__nv_bfloat16, __nv_bfloat16>(
      x_proj, w_h, c, h, seq, hs, cs, static_cast<__nv_bfloat16*>(zs), T, B, H,
      stream);
}

// K4. zs [T, B, 4H] bf16; cs, cs_prev, dout [T, B, H] f32; w_h [H, 4H] f32;
// seq [B]; dc, dh [B, H] in/out (dc_T, dh_T in; dc0, dh0 out); dz
// [T, B, 4H] f32 out.
int lstm_train_bwd_f32(const void* zs, const float* cs, const float* cs_prev,
                       const float* dout, const void* w_h, const int32_t* seq,
                       float* dc, float* dh, float* dz, int T, int B, int H,
                       void* stream) {
  return run_bwd<float>(static_cast<const __nv_bfloat16*>(zs), cs, cs_prev,
                        dout, w_h, seq, dc, dh, dz, T, B, H, stream);
}

// K4 with w_h in bf16 (dz is rounded to bf16 before the product).
int lstm_train_bwd_bf16(const void* zs, const float* cs, const float* cs_prev,
                        const float* dout, const void* w_h, const int32_t* seq,
                        float* dc, float* dh, float* dz, int T, int B, int H,
                        void* stream) {
  return run_bwd<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(zs), cs,
                                cs_prev, dout, w_h, seq, dc, dh, dz, T, B, H,
                                stream);
}

}  // extern "C"
