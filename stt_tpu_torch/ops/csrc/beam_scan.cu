// CTC prefix beam search over a chunk of frames for Hopper (sm_90a): K5.
//
// Replaces the TPU kernel stt_tpu/ops/beam_kernel.py::_make_kernel (body
// _frame_step, selection _select_top), whose grid is the T frames in order
// with the beam state in scratch memory. Here one block owns one utterance
// and loops over its frames; the beam state (p_b, p_nb, last label, string
// hashes and parent-string hashes of W slots, the started flag) stays in
// shared memory for the whole launch and is read from and written back to
// the state tensors, so chunks chain. The arithmetic is that of
// stt_tpu_torch/decode/device.py::_beam_step (the plain version), decision
// for decision: the same float32 operations in the same order, so that the
// backpointers come out equal.
//
// Per frame: log of the class probabilities and the emission cutoff (rank
// by counting, ties to the lower class; cumulative mass summed in rank
// order); per slot the parent lookup by hash (a scan of the W slots), the
// blank / repeat / merge-extend updates and the timestep-claim decision;
// then the candidate pool, W existing prefixes and W x C children, as
// 64-bit keys (order-preserving float bits above the complemented flat
// index, so that descending keys are value descending then flat index
// ascending, the order of a stable descending sort), children that already
// sit in the beam struck out by a scatter; the top W by a bitonic network:
// every aligned group of Wp = next_pow2(W) keys sorted, then pairs of
// groups merged keeping the better half until one group is left; and the
// new state and the packed backpointers (src << 8) | (char + 1) read off
// the winners.
//
// Capacity: the TPU kernel takes beams up to 128 slots; this one takes up
// to 512 as long as the pool W x (C + 1) fits 16,384 keys (128 KB of
// shared memory), which covers the serving default of beam 500 over a
// 29-class alphabet. The state tensors have S = 128 slots for beams up to
// 128 (the TPU kernel's layout) and S = 512 above; the packed backpointer
// is an int16 up to 128 slots (7 bits of source above 8 bits of character
// + 1) and an int32 above. All per-slot arrays live in dynamic shared
// memory behind the keys, since 512 slots pass the 48 KB of static space.
//
// What bounds it on this card: bytes in the table's sense are tiny (C
// floats in and W int16 out per frame), but the T frames form a dependency
// chain, each a few dozen block-wide barriers long, so the time is latency:
// barriers and shared-memory round trips per frame, times T. Utterances
// run in parallel on separate SMs, so a batch costs what its longest
// utterance costs as long as B <= 132.
//
// What the design does about it: no device memory traffic inside a frame
// but the C probabilities and the W backpointers; the selection sorts only
// what top-W needs (groups of Wp, then halving merges) in place of the
// whole pool; frames past the utterance's length or before the first
// non-blank frame cost one store per slot.
//
// Not done yet: warp-level sorting of small groups without barriers,
// skipping pool entries known to be -inf, several utterances per block at
// small W.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int LN = 128;  // class lanes of the masks
constexpr int MAX_SLOTS = 512;   // beam slots
constexpr int MAX_POOL = 16384;  // keys of the candidate pool
constexpr int SLOT_ARRAYS = 21;  // per-slot arrays of 4-byte values
constexpr float LOG_FLOOR = 1.1754944e-38f;
constexpr uint32_t H1 = 1000003u;
constexpr uint32_t H2 = 69069u;
#define NEG_INF (-CUDART_INF_F)

typedef unsigned long long u64;

// log(exp(a) + exp(b)), written as the plain version writes it
__device__ __forceinline__ float lse(float a, float b) {
  const float m = fmaxf(a, b);
  if (m == NEG_INF) return m;
  return m + log1pf(expf(-fabsf(a - b)));
}

// descending keys = value descending, then flat index ascending
__device__ __forceinline__ u64 make_key(float v, uint32_t flat) {
  const uint32_t b = __float_as_uint(v + 0.0f);  // -0 -> +0
  const uint32_t hi = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((u64)hi << 32) | (u64)(~flat);
}

__device__ __forceinline__ float key_value(u64 key) {
  const uint32_t hi = (uint32_t)(key >> 32);
  return __uint_as_float((hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi);
}

// Leaves the W largest keys of keys[0, P) in keys[0, W), descending. P and
// Wp are powers of two, W <= Wp <= P. Ends after a barrier.
__device__ void select_top(u64* keys, int P, int Wp, int log_wp) {
  const int tid = threadIdx.x, nt = blockDim.x;
  // every aligned group of Wp keys sorted: even groups descending, odd
  // groups ascending
  for (int k = 2; k <= Wp; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < P; i += nt) {
        const int l = i ^ j;
        if (l > i) {
          const bool desc = (i & k) == 0;
          const u64 x = keys[i], y = keys[l];
          if (desc ? x < y : x > y) {
            keys[i] = y;
            keys[l] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  // a descending and an ascending group: the element-wise larger keys are
  // the best Wp of both, as a bitonic sequence; merge it, descending where
  // the surviving group's number is even, and halve the groups again
  for (int s = Wp; s < P; s <<= 1) {
    const int count = (P / (2 * s)) * Wp;
    for (int e = tid; e < count; e += nt) {
      const int a = (e >> log_wp) * 2 * s + (e & (Wp - 1));
      const u64 y = keys[a + s];
      if (y > keys[a]) keys[a] = y;
    }
    __syncthreads();
    for (int j = Wp >> 1; j > 0; j >>= 1) {
      for (int e = tid; e < count; e += nt) {
        const int m = e >> log_wp, o = e & (Wp - 1);
        const int l = o ^ j;
        if (l > o) {
          const int a = m * 2 * s + o, c = m * 2 * s + l;
          const bool desc = (m & 1) == 0;
          const u64 x = keys[a], y = keys[c];
          if (desc ? x < y : x > y) {
            keys[a] = y;
            keys[c] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// mode: 0 = classes in static rank order, none cut; 1 = sorted by
// probability, none cut (cutoff_top_n < C alone); 2 = sorted and cut by
// cumulative mass cutoff_prob or at cutoff_top_n.
template <typename BP>
__global__ void __launch_bounds__(1024)
beam_scan_kernel(const float* __restrict__ probs,        // [B, T, C]
                 const int32_t* __restrict__ lens,       // [B]
                 const int32_t* __restrict__ nign,       // [LN]
                 const int32_t* __restrict__ rank_static,  // [LN]
                 const float* __restrict__ in_f,         // [2, B, S]
                 const int32_t* __restrict__ in_i,       // [5, B, S]
                 const int32_t* __restrict__ in_started, // [B]
                 float* __restrict__ out_f, int32_t* __restrict__ out_i,
                 int32_t* __restrict__ out_started,
                 BP* __restrict__ bp,                    // [B, T, W]
                 int B, int T, int W, int S, int C, int blank,
                 int cutoff_top_n, int mode, float cutoff_prob, int P, int Wp,
                 int log_wp) {
  extern __shared__ u64 keys[];  // [P], then SLOT_ARRAYS arrays of [S]
  float* const slot_f = reinterpret_cast<float*>(keys + P);
  float *const pb = slot_f, *const pnb = pb + S, *const score = pnb + S;
  float *const npb = score + S, *const npnb = npb + S, *const exist = npnb + S;
  float *const t_pb = exist + S, *const t_pnb = t_pb + S;
  int32_t* const slot_i = reinterpret_cast<int32_t*>(t_pnb + S);
  int32_t *const last = slot_i, *const ha = last + S, *const hb = ha + S;
  int32_t *const pha = hb + S, *const phb = pha + S;
  int32_t *const t_last = phb + S, *const t_ha = t_last + S;
  int32_t *const t_hb = t_ha + S, *const t_pha = t_hb + S;
  int32_t *const t_phb = t_pha + S, *const par_idx = t_phb + S;
  int32_t *const par_hits = par_idx + S, *const rewrite = par_hits + S;
  __shared__ float logp[LN], sprob[LN];
  __shared__ int32_t rank[LN], order[LN], included[LN];
  __shared__ int32_t started, cutlen;

  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.x;
  const int len = lens[b];
  const size_t plane = (size_t)B * S;

  for (int w = tid; w < W; w += nt) {
    const size_t at = (size_t)b * S + w;
    pb[w] = in_f[at];
    pnb[w] = in_f[plane + at];
    last[w] = in_i[at];
    ha[w] = in_i[plane + at];
    hb[w] = in_i[2 * plane + at];
    pha[w] = in_i[3 * plane + at];
    phb[w] = in_i[4 * plane + at];
  }
  if (tid == 0) started = in_started[b];
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    BP* bp_t = bp + ((size_t)b * T + t) * W;
    bool active = t < len;
    if (active) {
      const float* p_t = probs + ((size_t)b * T + t) * C;
      // delayed-expansion gate: the beam starts at the first frame whose
      // blank probability is below 0.999
      if (tid == 0 && p_t[blank] < 0.999f) started = 1;
      for (int c = tid; c < C; c += nt) {
        const float p = p_t[c];
        logp[c] = logf(p + LOG_FLOOR);
        sprob[c] = nign[c] ? p : 0.0f;
      }
      __syncthreads();
      active = started != 0;
    }
    if (!active) {  // the same for every thread of the block
      for (int w = tid; w < W; w += nt) bp_t[w] = (BP)(w << 8);
      __syncthreads();  // every thread has read `started` before it changes
      continue;
    }

    // ---- emission cutoff ----------------------------------------------
    if (mode == 0) {
      for (int c = tid; c < C; c += nt) {
        rank[c] = rank_static[c];
        included[c] = nign[c];
      }
    } else {
      for (int c = tid; c < C; c += nt) {
        const float mine = sprob[c];
        int r = 0;
        for (int o = 0; o < C; ++o) {
          const float other = sprob[o];
          r += (other > mine) || (other == mine && o < c);
        }
        rank[c] = r;
        order[r] = c;
      }
      __syncthreads();
      if (tid == 0) {
        int n = C;
        if (mode == 2) {
          float cum = 0.0f;
          for (int r = 0; r < C; ++r) {  // in rank order, as a cumsum runs
            cum = __fadd_rn(cum, sprob[order[r]]);
            if (cum >= cutoff_prob || r + 1 >= cutoff_top_n) {
              n = r + 1;
              break;
            }
          }
        }
        cutlen = n;
      }
      __syncthreads();
      for (int c = tid; c < C; c += nt)
        included[c] = (rank[c] < cutlen) && nign[c];
    }
    for (int w = tid; w < W; w += nt) score[w] = lse(pb[w], pnb[w]);
    __syncthreads();

    // ---- existing slots: parent by hash, blank / repeat / merge-extend,
    // and whether the extension rewrites the prefix's last timestep ------
    const bool blank_in = included[blank] != 0;
    for (int j = tid; j < W; j += nt) {
      const float sc = score[j];
      const bool alive = sc > NEG_INF;
      const int l = last[j];
      const bool has_last = l >= 0;
      int par = 0, hits = 0;
      if (has_last) {
        const int32_t a = pha[j], c2 = phb[j];
        for (int i = 0; i < W; ++i) {
          if (ha[i] == a && hb[i] == c2 && score[i] > NEG_INF) {
            if (hits == 0) par = i;
            ++hits;
          }
        }
      }
      const bool has_parent = hits > 0;
      const float lp = has_last ? logp[l] : 0.0f;
      const bool c_in = has_last && included[l] != 0;
      const float b_val = (blank_in && alive) ? logp[blank] + sc : NEG_INF;
      const float r_val = (c_in && alive) ? lp + pnb[j] : NEG_INF;
      const bool e_ok = has_parent && c_in;
      const float e_from = (last[par] == l) ? pb[par] : score[par];
      const float e_val = e_ok ? lp + e_from : NEG_INF;
      const float nb = lse(r_val, e_val);
      const bool blank_first = has_last ? rank[blank] < rank[l] : true;
      const bool r_first = j < par;
      const bool b_kills = !blank_first && blank_in && alive && (nb < b_val);
      const bool rw_a = (e_val > r_val) && !b_kills;
      const bool r_kills = c_in && alive && (e_val < r_val);
      const bool rw_b = (e_val > NEG_INF) && !r_kills && !b_kills;
      npb[j] = b_val;
      npnb[j] = nb;
      exist[j] = lse(b_val, nb);
      par_idx[j] = par;
      par_hits[j] = hits;
      rewrite[j] = (r_first ? rw_a : rw_b) && e_ok;
    }
    __syncthreads();

    // ---- the pool: W existing prefixes, then W x C children -------------
    const int n_pool = W + W * C;
    for (int f = tid; f < P; f += nt) {
      u64 key = 0;  // padding: below every real key
      if (f < W) {
        key = make_key(exist[f], f);
      } else if (f < n_pool) {
        const int w = (f - W) / C, c = (f - W) - w * C;
        float v = NEG_INF;
        if (score[w] > NEG_INF && included[c] && c != blank)
          v = ((c == last[w]) ? pb[w] : score[w]) + logp[c];
        key = make_key(v, f);
      }
      keys[f] = key;
    }
    __syncthreads();
    // a child that already sits in the beam (slot j is prefix_par + last[j])
    // is struck out: its mass went to slot j as the merge-extend
    for (int j = tid; j < W; j += nt) {
      const int hits = par_hits[j];
      if (hits == 1) {
        const int f = W + par_idx[j] * C + last[j];
        keys[f] = make_key(NEG_INF, f);
      } else if (hits > 1) {  // hash collision: every matching parent
        for (int i = 0; i < W; ++i) {
          if (ha[i] == pha[j] && hb[i] == phb[j] && score[i] > NEG_INF) {
            const int f = W + i * C + last[j];
            keys[f] = make_key(NEG_INF, f);
          }
        }
      }
    }
    __syncthreads();
    select_top(keys, P, Wp, log_wp);

    // ---- the winners become the new slots --------------------------------
    for (int k = tid; k < W; k += nt) {
      const u64 key = keys[k];
      const float val = key_value(key);
      const int flat = (int)(~(uint32_t)key);
      int s_last, s_ha, s_hb, s_pha, s_phb, src, ch;
      float s_pb, s_pnb;
      if (flat < W) {
        const int j = flat;
        s_last = last[j];
        s_pb = npb[j];
        s_pnb = npnb[j];
        s_ha = ha[j];
        s_hb = hb[j];
        s_pha = pha[j];
        s_phb = phb[j];
        src = rewrite[j] ? par_idx[j] : j;
        ch = rewrite[j] ? last[j] : -1;
      } else {
        const int i = (flat - W) / C, c = (flat - W) - i * C;
        s_last = c;
        s_pb = NEG_INF;
        s_pnb = val;
        // a child rolls its parent's hashes forward one character (the
        // products wrap in 32 bits)
        s_ha = (int32_t)((uint32_t)ha[i] * H1 + (uint32_t)(c + 1));
        s_hb = (int32_t)((uint32_t)hb[i] * H2 + (uint32_t)(c + 1));
        s_pha = ha[i];
        s_phb = hb[i];
        src = i;
        ch = c;
      }
      if (val == NEG_INF) {  // a dead slot: hash (0, 0), points at itself
        s_last = -1;
        s_pb = s_pnb = NEG_INF;
        s_ha = s_hb = s_pha = s_phb = 0;
        src = k;
        ch = -1;
      }
      t_last[k] = s_last;
      t_pb[k] = s_pb;
      t_pnb[k] = s_pnb;
      t_ha[k] = s_ha;
      t_hb[k] = s_hb;
      t_pha[k] = s_pha;
      t_phb[k] = s_phb;
      bp_t[k] = (BP)((src << 8) | (ch + 1));
    }
    __syncthreads();
    for (int w = tid; w < W; w += nt) {
      last[w] = t_last[w];
      pb[w] = t_pb[w];
      pnb[w] = t_pnb[w];
      ha[w] = t_ha[w];
      hb[w] = t_hb[w];
      pha[w] = t_pha[w];
      phb[w] = t_phb[w];
    }
    __syncthreads();
  }

  for (int w = tid; w < S; w += nt) {
    const size_t at = (size_t)b * S + w;
    const bool real = w < W;
    out_f[at] = real ? pb[w] : NEG_INF;
    out_f[plane + at] = real ? pnb[w] : NEG_INF;
    out_i[at] = real ? last[w] : -1;
    out_i[plane + at] = real ? ha[w] : 0;
    out_i[2 * plane + at] = real ? hb[w] : 0;
    out_i[3 * plane + at] = real ? pha[w] : 0;
    out_i[4 * plane + at] = real ? phb[w] : 0;
  }
  if (tid == 0) out_started[b] = started;
}

int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <typename BP>
int launch_scan(const float* probs, const int32_t* lens, const int32_t* nign,
                const int32_t* rank_static, const float* in_f,
                const int32_t* in_i, const int32_t* in_started, float* out_f,
                int32_t* out_i, int32_t* out_started, BP* bp, int B, int T,
                int W, int S, int C, int blank, int cutoff_top_n, int mode,
                float cutoff_prob, cudaStream_t stream) {
  const int P = next_pow2(W + W * C);
  const int Wp = next_pow2(W);
  int log_wp = 0;
  while ((1 << log_wp) < Wp) ++log_wp;
  const int threads = P <= 512 ? 128 : P <= 2048 ? 256 : P <= 8192 ? 512 : 1024;
  const size_t smem = (size_t)P * sizeof(u64) + (size_t)SLOT_ARRAYS * S * 4;
  cudaError_t err = cudaFuncSetAttribute(
      beam_scan_kernel<BP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  beam_scan_kernel<BP><<<B, threads, smem, stream>>>(
      probs, lens, nign, rank_static, in_f, in_i, in_started, out_f, out_i,
      out_started, bp, B, T, W, S, C, blank, cutoff_top_n, mode, cutoff_prob, P,
      Wp, log_wp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// probs [B, T, C] f32 softmax; lens [B]; nign, rank_static [128] int32;
// state in and out as f [2, B, 1, S] f32 (p_b, p_nb), i [5, B, 1, S] int32
// (last, ha, hb, par_ha, par_hb), started [B, 1, 1] int32; bp [B, T, W],
// int16 or with bp_wide int32 (which W > 128 needs). 1 <= W <= S <= 512,
// 1 <= C <= 127, W (C + 1) <= 16384.
int beam_scan(const float* probs, const int32_t* lens, const int32_t* nign,
              const int32_t* rank_static, const float* in_f,
              const int32_t* in_i, const int32_t* in_started, float* out_f,
              int32_t* out_i, int32_t* out_started, void* bp, int B, int T,
              int W, int S, int C, int blank, int cutoff_top_n, int mode,
              int bp_wide, float cutoff_prob, void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || W > S || S > MAX_SLOTS || C < 1 || C > LN - 1 ||
      W * (C + 1) > MAX_POOL || (W > 128 && !bp_wide))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t on = static_cast<cudaStream_t>(stream);
  if (bp_wide)
    return launch_scan(probs, lens, nign, rank_static, in_f, in_i, in_started,
                       out_f, out_i, out_started, static_cast<int32_t*>(bp), B,
                       T, W, S, C, blank, cutoff_top_n, mode, cutoff_prob, on);
  return launch_scan(probs, lens, nign, rank_static, in_f, in_i, in_started,
                     out_f, out_i, out_started, static_cast<int16_t*>(bp), B, T,
                     W, S, C, blank, cutoff_top_n, mode, cutoff_prob, on);
}

}  // extern "C"
