// LSTM training recurrence for Hopper (sm_90a): K3 (forward with stashes)
// and K4 (reverse sweep).
//
// K3 replaces stt_tpu/ops/lstm_train.py::_fwd_kernel (launched by
// _lstm_train_fwd_impl). It is K1's persistent kernel (lstm_step.cuh: one
// cooperative launch for all T, W_h chunks resident in shared memory, the
// rest streamed through a ring of bulk copies) whose epilogue also writes,
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
// What bounds them on this card: every step needs all of W_h (64 MiB in f32
// at H = 2048), more than all the blocks' shared memory holds. Both keep
// what fits on chip for the whole call and stream the rest each step. K3
// also writes 4H bf16 + 2H f32 per row per step; K4 reads zs, cs, cs_prev
// and dout and writes dz (f32), per row per step. At the training batch
// (B = 16) the 2*B*H*4H multiply-adds per step in f32 outside the tensor
// cores take about as long as the streamed bytes.
//
// K4's design: one persistent cooperative launch for all T, on the forward's
// layout (`pack_w_h`, the chunks, the ring of bulk copies and the resident
// chunks of lstm_step.cuh). A block owns the same tiles as in K3: 16 hidden
// units and their 64 gate columns. Per step t it
//   1. forms dz_t of its units for all B rows: they need only the (dc, dh)
//      carries of those units, which no other block touches, and the units'
//      columns of zs, cs, cs_prev and dout; writes them to dz[t] and keeps
//      them, rounded to W_h's dtype, in shared memory;
//   2. contracts each chunk of its slice along the columns instead of along
//      k: P_tile[b, j] = sum over the tile's 64 columns c of dz_t[b, c]
//      W_h[j, c], for the chunk's k rows j. A thread holds 8 columns of dz
//      for half the group's rows in registers for the whole step and reads
//      4 x 8 weights a pass; the 8 threads that share rows j then fold their
//      sums together through shuffles (each halving step keeps half the
//      values), and one of them stores them. In bf16 from 8
//      rows up the tensor cores take it (mma.sync m16n8k16): warp w forms
//      the chunk's k rows 16 w .. 16 w + 15 over all 64 columns, A read by
//      ldmatrix from the chunk as it lies (`pack_w_h`'s swizzle keeps its 8
//      rows in 8 bank groups), B = dz in registers; f32 stays on FFMA;
//   3. writes P_tile [HP, rows] to a global buffer, two planes by the parity
//      of the step, so that a fast block writing step t-1's partials never
//      meets a slow one still reading step t's;
//   4. meets the other blocks at the grid barrier;
//   5. sums, for its own units j, P over all tiles in a fixed order (tiles
//      split into a few fixed slices, the slices added in order): dh_prev,
//      bit-equal from call to call; freezes it past seq[b], and goes on to
//      step t-1's gate grads.
// The partials cost B x HP f32 written and read per block per step through
// the L2 (16 MB each way at B = 16, H = 2048). A design whose blocks own
// rows of W_h instead would have to gather all of dz_t [B, 4H] in every
// block every step (64 MB of L2 reads at B = 16) and a second packing.
// Rows past B and units past H have dz = 0 and zero weights, so their
// partials are 0; they are never written to dh. The next step's gate inputs
// are prefetched to the L2 while a step runs, and the reduction keeps 8
// loads in flight per thread (added in the same order).
//
// Not done yet: f32 takes its rows 16 at a time, so above 16 rows it streams
// the chunks and folds once per group; the partials could be summed by
// clusters of blocks through distributed shared memory instead of the L2.

#include "lstm_step.cuh"

namespace {

using lstm::as_weight_type;
using lstm::BAR_BYTES;
using lstm::CHUNK_BYTES;
using lstm::Chunk;
using lstm::KPASS;
using lstm::PTHREADS;
using lstm::sigmoid;
using lstm::STAGES;
using lstm::TC;
using lstm::to_f32;
using lstm::UT;
using lstm::Walk;

constexpr int RED_SLICES = 8;  // at most: the tiles are summed in this many slices
constexpr int RED_BATCH = 8;   // partials a thread of the reduction has in flight

// floats of the reduction's slices in shared memory (mirrored by the plan)
__host__ __device__ constexpr int red_floats(int tiles_per_block, int rows) {
  return PTHREADS * 4 > tiles_per_block * UT * rows ? PTHREADS * 4 : tiles_per_block * UT * rows;
}

struct BwdArgs {
  const __nv_bfloat16* zs;  // [T, B, 4H]
  const float* cs;          // [T, B, H]
  const float* cs_prev;     // [T, B, H]
  const float* dout;        // [T, B, H]
  const void* w_packed;     // [tiles, HP, TC] (`pack_w_h`), W_h's dtype
  const int32_t* seq;       // [B]
  float* dc;                // [B, H] carry: dc_T in, dc0 out
  float* dh;                // [B, H] carry: dh_T in, dh0 out
  float* dz;                // [T, B, 4H]
  float* part;              // [2, tiles, HP, rows] the partials of dh_prev
  unsigned int* counter;    // the barrier's arrivals, 0 at launch
  int T, B, H;
  int tiles_per_block;
  int resident_chunks;
};

// Folds the 8 threads (lanes l, l ^ 1, ..., l ^ 7) that hold sums of the
// same N = K values: each halving step gives a thread the sum of half the
// values it and its partner hold (the half named by its bit of MASK), so
// after log2 N steps (at most 3) a thread holds N / 8 of the totals; past
// that the last value is summed across the remaining lanes.
template <int K, int MASK, int N>
__device__ __forceinline__ void fold(float (&v)[N], int lane) {
  if constexpr (MASK > 0) {
    if constexpr (K > 1) {
      const bool up = (lane & MASK) != 0;
#pragma unroll
      for (int i = 0; i < K / 2; ++i) {
        const float send = up ? v[i] : v[i + K / 2];
        const float keep = up ? v[i + K / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, MASK);
      }
      fold<K / 2, MASK / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], MASK);
      fold<1, MASK / 2>(v, lane);
    }
  }
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// two f32 values, bf16-exact, as the packed pair an mma operand takes
__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

template <typename WT, int BT>
__global__ void __launch_bounds__(PTHREADS, 1)
bwd_kernel(const BwdArgs a) {
  // bf16 from 8 rows up on the tensor cores: warp w forms P for the chunk's
  // k rows 16 w .. 16 w + 15 (A: the chunk's rows through ldmatrix, whose
  // swizzled pieces meet no bank conflict) and the group's rows (B: dz,
  // held in registers for the step), over all 64 columns: no sums to fold
  constexpr bool MMA = sizeof(WT) == 2 && BT >= 8;
  constexpr int KC = Chunk<WT>::KC;
  constexpr int WCH = KC * TC;                  // weights per chunk
  constexpr int PIECE = 16 / (int)sizeof(WT);   // elements of a 16-byte piece
  // FFMA: a thread takes 8 columns of the tile (4 cg .. 4 cg + 3 and 32 +
  // 4 cg .. 32 + 4 cg + 3), HALVES-th of the group's rows and JJ k rows of
  // every pass of 64; 8 threads share each (k row, batch row) and fold
  constexpr int HALVES = BT >= 8 ? 2 : 1;
  constexpr int BB = BT / HALVES;               // batch rows a thread takes
  constexpr int JJ = BT >= 8 ? 4 : 2;           // k rows a thread takes per pass
  static_assert(8 * HALVES * (KPASS / JJ) == PTHREADS, "one pass covers the block");
  constexpr int N = JJ * BB;                    // sums a thread carries per pass
  constexpr int FOLDS = N >= 8 ? 3 : (N >= 4 ? 2 : 1);
  constexpr int M = N >> FOLDS;                 // totals a thread holds after folding
  constexpr int RV = BT % 4 == 0 ? 4 : 1;       // rows the reduction reads at once
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cg = tid & 7;                            // FFMA: the thread's columns,
  const int bh = HALVES == 2 ? (tid >> 3) & 1 : 0;   // its half of the rows
  const int kg = tid >> (HALVES == 2 ? 4 : 3);       // and its k rows JJ kg ..
  const int T = a.T, B = a.B, H = a.H;
  const size_t H4 = 4 * (size_t)H;
  const int nch = (H + KC - 1) / KC;
  const int HP = nch * KC;
  const int groups = (B + BT - 1) / BT;
  const int rows = groups * BT;
  const int tiles = (H + UT - 1) / UT;
  const int rc = a.resident_chunks;
  int my_tiles = 0;
  for (int i = 0; i < a.tiles_per_block; ++i)
    my_tiles += (blockIdx.x + i * gridDim.x) < tiles;
  const int V = my_tiles * groups * nch;  // chunk visits of one step
  const long long NV = (long long)T * V;
  const size_t plane = (size_t)tiles * HP * rows;
  const WT* const w_packed = static_cast<const WT*>(a.w_packed);

  WT* const ring_w = reinterpret_cast<WT*>(smem);
  // dz_t of the block's units, rounded: [tiles_per_block, rows, TC]
  float* const dzs = reinterpret_cast<float*>(smem + (size_t)STAGES * CHUNK_BYTES);
  float* const red = dzs + (size_t)a.tiles_per_block * rows * TC;
  unsigned long long* const full =
      reinterpret_cast<unsigned long long*>(red + red_floats(a.tiles_per_block, rows));
  WT* const resident = reinterpret_cast<WT*>(reinterpret_cast<unsigned char*>(full) + BAR_BYTES);

  // the reduction: items of RV rows of one unit, tiles cut into S slices
  const int n_items = my_tiles * UT * rows / RV;
  const int S = n_items >= PTHREADS ? 1 : min(RED_SLICES, PTHREADS / n_items);
  const int n_gate = my_tiles * UT * rows;  // (tile, unit, row), row fastest

  // Thread 0 requests copies; visit m over the whole call has slot
  // m % STAGES and parity (m / STAGES) & 1. Resident chunks are copied at
  // their first visit; later visits of them only arrive.
  auto request = [&](const Walk& at, long long m) {
    unsigned long long* bar = full + m % STAGES;
    const bool res = at.resident(rc, nch);
    if (res && !(m < V && at.g == 0)) {
      lstm::mbar_arrive(bar);
      return;
    }
    WT* dst = res ? resident + ((size_t)at.tl * rc + at.slot) * WCH
                  : ring_w + (size_t)(m % STAGES) * WCH;
    const int tile = blockIdx.x + at.tl * gridDim.x;
    lstm::mbar_arrive_expect(bar, CHUNK_BYTES);
    lstm::bulk_copy(dst, w_packed + ((size_t)tile * nch + at.c) * WCH, CHUNK_BYTES, bar);
  };
  auto advance = [&](Walk& at) {
    at.next(rc, nch, groups);
    if (at.tl == my_tiles) at.tl = 0;  // on to the next step's first visit
  };
  // dh after step t + 1: the slices of the reduction summed in order,
  // frozen past the row's length
  auto reduced_dh = [&](int t1, int tl, int u, int b, size_t idx) {
    const int k = (tl * UT + u) * rows + b;
    float sum = 0.0f;
    for (int sl = 0; sl < S; ++sl) sum += red[((size_t)sl * n_items + k / RV) * RV + k % RV];
    const float dh = t1 < a.seq[b] ? sum : a.dh[idx];
    a.dh[idx] = dh;
    return dh;
  };

  Walk ahead;  // thread 0: the next visit to request
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) lstm::mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (long long m = 0; m < STAGES - 1 && m < NV; ++m, advance(ahead)) request(ahead, m);
  }
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    // ---- 1. the gate grads of step t for the block's units ------------
    for (int i = tid; i < n_gate; i += PTHREADS) {
      const int b = i % rows, u = (i / rows) % UT, tl = i / (rows * UT);
      const int j = (blockIdx.x + tl * gridDim.x) * UT + u;
      float* dzrow = dzs + ((size_t)tl * rows + b) * TC + u;
      if (b >= B || j >= H) {
#pragma unroll
        for (int q = 0; q < 4; ++q) dzrow[q * UT] = 0.0f;
        continue;
      }
      const size_t idx = (size_t)b * H + j;
      const float dh = s == 0 ? a.dh[idx] : reduced_dh(t + 1, tl, u, b, idx);
      const size_t zb = ((size_t)t * B + b) * H4 + j;
      const size_t at = (size_t)t * B * H + idx;
      const float ig = sigmoid(to_f32(a.zs[zb]));
      const float gg = tanhf(to_f32(a.zs[zb + H]));
      const float fg = sigmoid(to_f32(a.zs[zb + 2 * (size_t)H]));
      const float og = sigmoid(to_f32(a.zs[zb + 3 * (size_t)H]));
      const float tanh_c = tanhf(a.cs[at]);
      const float dc_in = a.dc[idx];
      const float dh_total = a.dout[at] + dh;
      const float dc_total = dc_in + dh_total * og * (1.0f - tanh_c * tanh_c);
      const bool valid = t < a.seq[b];
      float d[4];
      d[0] = valid ? dc_total * gg * ig * (1.0f - ig) : 0.0f;
      d[1] = valid ? dc_total * ig * (1.0f - gg * gg) : 0.0f;
      d[2] = valid ? dc_total * a.cs_prev[at] * fg * (1.0f - fg) : 0.0f;
      d[3] = valid ? dh_total * tanh_c * og * (1.0f - og) : 0.0f;
      a.dc[idx] = valid ? dc_total * fg : dc_in;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a.dz[zb + q * (size_t)H] = d[q];
        dzrow[q * UT] = as_weight_type(d[q], w_packed);
      }
      if (t > 0) {  // step t - 1's inputs travel to the L2 while this step runs
#pragma unroll
        for (int q = 0; q < 4; ++q) prefetch_l2(a.zs + zb - B * H4 + q * (size_t)H);
        prefetch_l2(a.cs + at - (size_t)B * H);
        prefetch_l2(a.cs_prev + at - (size_t)B * H);
        prefetch_l2(a.dout + at - (size_t)B * H);
      }
    }
    __syncthreads();

    // ---- 2, 3. the partial products, chunk by chunk ---------------------
    float* const part = a.part + (size_t)(s & 1) * plane;
    float dzr[BB][8];  // FFMA: the thread's 8 columns of dz_t for its rows
    unsigned dzf[TC / 16][MMA ? BT / 8 : 1][2];  // MMA: dz_t as B fragments
    Walk at;
    for (int v = 0; v < V; ++v, advance(at)) {
      const long long n = (long long)s * V + v;
      const int tile = blockIdx.x + at.tl * gridDim.x;
      if (at.c == 0 && MMA) {
        const float* rows0 = dzs + ((size_t)at.tl * rows + at.g * BT + (lane >> 2)) * TC + 2 * (lane & 3);
#pragma unroll
        for (int ks = 0; ks < TC / 16; ++ks) {
#pragma unroll
          for (int nt = 0; nt < (MMA ? BT / 8 : 1); ++nt) {
            const float* x = rows0 + nt * 8 * TC + ks * 16;
            dzf[ks][nt][0] = bf16_pair(x[0], x[1]);
            dzf[ks][nt][1] = bf16_pair(x[8], x[9]);
          }
        }
      } else if (at.c == 0) {
#pragma unroll
        for (int bb = 0; bb < BB; ++bb) {
          const float* row = dzs + ((size_t)at.tl * rows + at.g * BT + bh * BB + bb) * TC + 4 * cg;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float4 x = *reinterpret_cast<const float4*>(row + 32 * half);
            dzr[bb][4 * half] = x.x;
            dzr[bb][4 * half + 1] = x.y;
            dzr[bb][4 * half + 2] = x.z;
            dzr[bb][4 * half + 3] = x.w;
          }
        }
      }
      lstm::mbar_wait(full + n % STAGES, (unsigned)(n / STAGES) & 1u);
      __syncthreads();  // the slot of the visit before is free again
      if (tid == 0 && n + STAGES - 1 < NV) {
        request(ahead, n + STAGES - 1);
        advance(ahead);
      }
      const WT* ws = at.resident(rc, nch) ? resident + ((size_t)at.tl * rc + at.slot) * WCH
                                          : ring_w + (size_t)(n % STAGES) * WCH;
      if constexpr (MMA) {
        const int warp = tid >> 5;
        const int k = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix: the row
        float d[BT / 8][4];
#pragma unroll
        for (int nt = 0; nt < BT / 8; ++nt) {
#pragma unroll
          for (int q = 0; q < 4; ++q) d[nt][q] = 0.0f;
        }
#pragma unroll
        for (int ks = 0; ks < TC / 16; ++ks) {
          unsigned af[4];
          lstm::ldmatrix_x4(ws + k * TC + lstm::swizzled<WT>(k, 2 * ks + (lane >> 4)) * 8, af);
#pragma unroll
          for (int nt = 0; nt < BT / 8; ++nt) lstm::mma_bf16(d[nt], af, dzf[ks][nt][0], dzf[ks][nt][1]);
        }
        // a thread holds k rows lane / 4 and + 8, batch rows 2 (lane % 4) and + 1
        float* dst = part + ((size_t)tile * HP + at.c * KC + warp * 16 + (lane >> 2)) * rows +
                     at.g * BT + 2 * (lane & 3);
#pragma unroll
        for (int nt = 0; nt < BT / 8; ++nt) {
          __stcg(reinterpret_cast<float2*>(dst + nt * 8), make_float2(d[nt][0], d[nt][1]));
          __stcg(reinterpret_cast<float2*>(dst + 8 * rows + nt * 8), make_float2(d[nt][2], d[nt][3]));
        }
        continue;
      }
#pragma unroll
      for (int p = 0; p < KC / KPASS; ++p) {
        const int k0 = p * KPASS + kg * JJ;
        float w[JJ][8];  // 8 lanes read a row's 32 consecutive columns at once
#pragma unroll
        for (int r = 0; r < JJ; ++r) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int col = 32 * half + 4 * cg;
            float v[4];
            lstm::load_w4(ws + (k0 + r) * TC + lstm::swizzled<WT>(k0 + r, col / PIECE) * PIECE +
                              col % PIECE, v);
#pragma unroll
            for (int q = 0; q < 4; ++q) w[r][4 * half + q] = v[q];
          }
        }
        float acc[N];  // acc[r * BB + bb]: the thread's row bb, k row k0 + r
#pragma unroll
        for (int r = 0; r < JJ; ++r) {
#pragma unroll
          for (int bb = 0; bb < BB; ++bb) {
            float x = 0.0f;
#pragma unroll
            for (int q = 0; q < 8; ++q) x = fmaf(dzr[bb][q], w[r][q], x);
            acc[r * BB + bb] = x;
          }
        }
        fold<N, 4>(acc, lane);
        // this thread now holds totals sel * M .. sel * M + M - 1
        if ((cg & ((1 << (3 - FOLDS)) - 1)) == 0) {
          const int first = (cg >> (3 - FOLDS)) * M;
          const int r = first / BB, bb = bh * BB + first % BB;
          float* dst = part + ((size_t)tile * HP + at.c * KC + k0 + r) * rows + at.g * BT + bb;
          if constexpr (M == 4) {
            __stcg(reinterpret_cast<float4*>(dst), make_float4(acc[0], acc[1], acc[2], acc[3]));
          } else if constexpr (M == 2) {
            __stcg(reinterpret_cast<float2*>(dst), make_float2(acc[0], acc[1]));
          } else {
            __stcg(dst, acc[0]);
          }
        }
      }
    }

    // ---- 4. every block's partials of step t are written ----------------
    lstm::grid_barrier(a.counter, (unsigned)(s + 1) * gridDim.x);

    // ---- 5. the sums over all tiles, for the block's units --------------
    for (int i = tid; i < n_items * S; i += PTHREADS) {
      const int item = i % n_items, sl = i / n_items;
      const int k = item * RV;
      const int b = k % rows, u = (k / rows) % UT, tl = k / (rows * UT);
      const int j = (blockIdx.x + tl * gridDim.x) * UT + u;
      float sum[RV];
#pragma unroll
      for (int e = 0; e < RV; ++e) sum[e] = 0.0f;
      if (j < H) {
        // RED_BATCH loads in flight at once, added in the slice's order
        const float* src = part + (size_t)j * rows + b;
        for (int tp0 = sl; tp0 < tiles; tp0 += RED_BATCH * S) {
          float y[RED_BATCH][RV];
#pragma unroll
          for (int u = 0; u < RED_BATCH; ++u) {
            const int tp = tp0 + u * S;
            const float* x = src + (size_t)tp * HP * rows;
            if constexpr (RV == 4) {
              const float4 v = tp < tiles ? __ldcg(reinterpret_cast<const float4*>(x))
                                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              y[u][0] = v.x; y[u][1] = v.y; y[u][2] = v.z; y[u][3] = v.w;
            } else {
              y[u][0] = tp < tiles ? __ldcg(x) : 0.0f;
            }
          }
#pragma unroll
          for (int u = 0; u < RED_BATCH; ++u) {
#pragma unroll
            for (int e = 0; e < RV; ++e) sum[e] += y[u][e];
          }
        }
      }
#pragma unroll
      for (int e = 0; e < RV; ++e) red[((size_t)sl * n_items + item) * RV + e] = sum[e];
    }
    __syncthreads();
  }

  // dh0: the sums of step 0, frozen past the row's length
  for (int i = tid; i < n_gate; i += PTHREADS) {
    const int b = i % rows, u = (i / rows) % UT, tl = i / (rows * UT);
    const int j = (blockIdx.x + tl * gridDim.x) * UT + u;
    if (b < B && j < H) reduced_dh(0, tl, u, b, (size_t)b * H + j);
  }
}

// Launches K4 for the plan the wrapper made (`bwd_launch_plan`): `blocks`
// blocks of PTHREADS threads, `smem` bytes of dynamic shared memory, `bt`
// batch rows per group (1, 8 or 16). Cooperative, as K3.
template <typename WT>
int run_bwd(const BwdArgs& a, int bt, int blocks, int smem, cudaStream_t s) {
  switch (bt) {
    case 1: return lstm::launch_cooperative(bwd_kernel<WT, 1>, a, blocks, smem, s);
    case 8: return lstm::launch_cooperative(bwd_kernel<WT, 8>, a, blocks, smem, s);
    case 16: return lstm::launch_cooperative(bwd_kernel<WT, 16>, a, blocks, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename WT>
int bwd_entry(const void* zs, const float* cs, const float* cs_prev, const float* dout,
              const void* w_packed, const int32_t* seq, float* dc, float* dh, float* dz,
              float* part, unsigned int* counter, int T, int B, int H, int bt, int blocks,
              int tiles_per_block, int resident_chunks, int smem, void* stream) {
  if (T == 0) return 0;
  BwdArgs a;
  a.zs = static_cast<const __nv_bfloat16*>(zs);
  a.cs = cs;
  a.cs_prev = cs_prev;
  a.dout = dout;
  a.w_packed = w_packed;
  a.seq = seq;
  a.dc = dc;
  a.dh = dh;
  a.dz = dz;
  a.part = part;
  a.counter = counter;
  a.T = T;
  a.B = B;
  a.H = H;
  a.tiles_per_block = tiles_per_block;
  a.resident_chunks = resident_chunks;
  return run_bwd<WT>(a, bt, blocks, smem, static_cast<cudaStream_t>(stream));
}
}  // namespace

extern "C" {

// K3 in f32: see lstm::run_recurrence for the arguments (hs is its `out`).
int lstm_train_fwd_f32(const void* x_proj, const void* w_packed,
                       const float* c0, const float* h0, float* c, float* h,
                       void* hm, const int32_t* seq, float* hs, float* cs,
                       void* zs, unsigned int* counter, int T, int B, int H,
                       int bt, int blocks, int tiles_per_block,
                       int resident_chunks, int smem, void* stream) {
  return lstm::run_recurrence<float, float, true>(
      x_proj, w_packed, nullptr, c0, h0, c, h, hm, seq, hs, cs, zs, counter, T, B, H, bt,
      blocks, tiles_per_block, resident_chunks, smem, stream);
}

// K3 with x_proj and W_h in bf16; gates, state and stashes as above.
int lstm_train_fwd_bf16(const void* x_proj, const void* w_packed,
                        const float* c0, const float* h0, float* c, float* h,
                        void* hm, const int32_t* seq, float* hs, float* cs,
                        void* zs, unsigned int* counter, int T, int B, int H,
                        int bt, int blocks, int tiles_per_block,
                        int resident_chunks, int smem, void* stream) {
  return lstm::run_recurrence<__nv_bfloat16, __nv_bfloat16, true>(
      x_proj, w_packed, nullptr, c0, h0, c, h, hm, seq, hs, cs, zs, counter, T, B, H, bt,
      blocks, tiles_per_block, resident_chunks, smem, stream);
}

// K4. zs [T, B, 4H] bf16; cs, cs_prev, dout [T, B, H] f32; w_packed
// (`pack_w_h` of W_h, f32); seq [B]; dc, dh [B, H] in/out (dc_T, dh_T in;
// dc0, dh0 out); dz [T, B, 4H] f32 out; part [2, tiles, HP, rows] f32
// scratch; counter: one zeroed uint32. bt, blocks, tiles_per_block,
// resident_chunks and smem are the wrapper's launch plan (`bwd_launch_plan`).
// Returns the CUDA error, 0 when the kernel was launched.
int lstm_train_bwd_f32(const void* zs, const float* cs, const float* cs_prev,
                       const float* dout, const void* w_packed, const int32_t* seq,
                       float* dc, float* dh, float* dz, float* part,
                       unsigned int* counter, int T, int B, int H, int bt,
                       int blocks, int tiles_per_block, int resident_chunks,
                       int smem, void* stream) {
  return bwd_entry<float>(zs, cs, cs_prev, dout, w_packed, seq, dc, dh, dz, part,
                          counter, T, B, H, bt, blocks, tiles_per_block,
                          resident_chunks, smem, stream);
}

// K4 with W_h in bf16 (dz is rounded to bf16 before the product).
int lstm_train_bwd_bf16(const void* zs, const float* cs, const float* cs_prev,
                        const float* dout, const void* w_packed, const int32_t* seq,
                        float* dc, float* dh, float* dz, float* part,
                        unsigned int* counter, int T, int B, int H, int bt,
                        int blocks, int tiles_per_block, int resident_chunks,
                        int smem, void* stream) {
  return bwd_entry<__nv_bfloat16>(zs, cs, cs_prev, dout, w_packed, seq, dc, dh, dz,
                                  part, counter, T, B, H, bt, blocks,
                                  tiles_per_block, resident_chunks, smem, stream);
}

}  // extern "C"
