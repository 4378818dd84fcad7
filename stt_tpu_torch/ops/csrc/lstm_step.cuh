// The LSTM forward recurrence as one persistent kernel, shared by the
// inference kernel (K1, lstm_recurrence.cu) and the training forward (K3,
// lstm_train.cu); the int8 recurrence (K2, lstm_recurrence_q.cu) shares the
// gate math.
//
//     z      = x_proj[t] + round(h_{t-1}) . W_h   (f32 accumulate)
//     i,g,f,o = split(z, 4)                       (gate order i, g, f, o)
//     c_t    = sigmoid(f) c_{t-1} + sigmoid(i) tanh(g)
//     h_t    = sigmoid(o) tanh(c_t)
//
// Past seq[b] the state of row b freezes and out[t, b] = 0. h is rounded to
// W_h's dtype before each product, as on the TPU.
//
// One launch runs all T steps. The hidden units are cut into tiles of UT =
// 16 units (64 columns of W_h: the tile's units for the four gates); a block
// owns one tile (several when there are more tiles than SMs) for the whole
// call, and the blocks meet at a grid-wide barrier after every step. The
// wrapper repacks W_h once so that a tile's columns are one contiguous
// [k, 64] slab, cut along k into chunks of 16 KB.
//
// Per step a block walks its tile's chunks. As many chunks as fit stay in
// shared memory for the whole call (filled while the first step computes);
// the others stream through a ring of STAGES slots filled by bulk copies
// (one thread asks the TMA unit for a whole chunk, an mbarrier counts the
// bytes that land), several chunks ahead, and the ring goes on filling
// across the barrier: the weights of a step's first chunks are requested
// before the step's h exists. The rounded h of the previous step lies in a
// small global scratch (it lives in the L2), is written by the blocks that
// own its units and read by everyone after the barrier through the same
// ring, chunk by chunk, so a block holds only STAGES chunks of h whatever B
// is.
//
// Within a chunk a thread owns 4 columns and 4 consecutive k of every pass
// of 64 k: it reads 4 weight vectors and, per batch row, one 16-byte vector
// of h from shared memory for 16 multiply-adds, and carries BT x 4 sums in
// registers, so W_h is read once per step for up to 32 rows (more rows are
// taken in groups of 32). The 16 k-slices of a tile meet through a shuffle
// and a small buffer in shared memory, 8 rows at a time, always in the same
// order: results do not change from run to run. One thread per (row, unit)
// then applies the gate math and the length mask; c and the carried h stay
// in global memory but are touched only by that thread. In bf16 from 8 rows
// up the multiply-adds run on the tensor cores instead (see Product).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lstm {

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
// carried c. The int8 recurrence (lstm_recurrence_q.cu) uses it.
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

// ---- the persistent recurrence (K1, K3) --------------------------------
//
// The constants below are mirrored by the launch plan in
// stt_tpu_torch/ops/lstm_kernel.py, which sizes the grid and the shared
// memory.

constexpr int UT = 16;             // hidden units per tile
constexpr int TC = 4 * UT;         // columns of W_h per tile
constexpr int CHUNK_BYTES = 16384; // one chunk of a tile's weights
constexpr int STAGES = 4;          // slots of the ring
constexpr int PTHREADS = 256;      // threads per block
constexpr int KPASS = 64;          // k covered by the block in one pass
constexpr int KSLICES = PTHREADS / 32;  // warps, each summing its own k
constexpr int ER = 8;              // rows per round of the epilogue
constexpr int PSTRIDE = TC + 16;   // padded row of partial sums (banks)
constexpr int BAR_BYTES = 64;      // room for the ring's STAGES mbarriers

template <typename WT>
struct Chunk {
  static constexpr int KC = CHUNK_BYTES / (TC * (int)sizeof(WT));  // k rows
};

template <typename WT>
struct Args {
  const WT* x_proj;        // [T, B, 4H], W_h's dtype
  const void* w_packed;    // [tiles, nch * KC, TC], W_h's dtype
  const float* c0;         // [B, H], the state the first step starts from
  const float* h0;         // [B, H]
  float* c;                // [B, H], the carried c: written by every step
  float* h;                // [B, H], the carried h, unrounded
  void* hm;                // [2, groups, nch, BT, HROW] h rounded to and
                           // stored in W_h's dtype, zero padded; hm[0] = h0
  const int32_t* seq;      // [B]
  float* out;              // [T, B, H] (K3: hs)
  float* cs;               // [T, B, H] (STASH)
  __nv_bfloat16* zs;       // [T, B, 4H] (STASH)
  unsigned int* counter;   // the barrier's arrivals, 0 at launch
  int T, B, H;
  int tiles_per_block;     // tiles a block owns (blockIdx.x + i * gridDim.x)
  int resident_chunks;     // chunks per tile kept in shared memory
};

// ---- bulk copies (the TMA unit) and the barriers that count their bytes --
//
// One thread asks for a whole chunk with one instruction; the copy engine
// makes the addresses and reports the bytes that landed to an mbarrier in
// shared memory. (16-byte cp.async copies by all threads went through the
// load/store unit, 40 warp instructions a chunk, and the product's own
// shared-memory loads queued behind them: a third of a step at B = 16.)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(arrivals)
               : "memory");
}
// more bytes to wait for in the barrier's current phase, without arriving
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// the phase's one arrival, with more bytes to wait for
__device__ __forceinline__ void mbar_arrive_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the phase of this parity is complete: its arrival was made and
// all its bytes have landed, and are visible. Traps like grid_barrier.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done, spins = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (++spins == (1u << 25)) __trap();
  } while (!done);
}
// `bytes` (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory, counted on `bar` as they land
__device__ __forceinline__ void bulk_copy(void* smem_dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(smem_dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// orders this thread's earlier accesses (and what it has acquired) before
// its later bulk copies, which read through another path than loads do
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// Every block arrives and waits until `target` arrivals were counted. The
// counter only grows, so a step's target is (t + 1) * gridDim.x. Writes made
// before the barrier by any thread of any block are visible after it to
// loads that go to the L2 (bulk copies after fence_proxy_async, __ldcg). A barrier that is not met
// within some seconds (a block that never came: a fault, not a wait) traps,
// so that the launch fails instead of holding the card.
__device__ __forceinline__ void grid_barrier(unsigned int* counter,
                                             unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    unsigned int seen, spins = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(counter)
                   : "memory");
      if (++spins == (1u << 25)) __trap();
    } while (seen < target);
  }
  __syncthreads();
}

// four consecutive columns of one k row of a chunk in shared memory
__device__ __forceinline__ void load_w4(const float* p, float (&w)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void load_w4(const __nv_bfloat16* p, float (&w)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  w[0] = __uint_as_float(v.x << 16);
  w[1] = __uint_as_float(v.x & 0xffff0000u);
  w[2] = __uint_as_float(v.y << 16);
  w[3] = __uint_as_float(v.y & 0xffff0000u);
}

// Where a walk over a block's chunk visits stands: the tile (by its place
// in the block's list), the group of rows, the chunk, and whether that chunk
// is resident and in which slot. Chunk c is resident when
// floor((c + 1) rc / nch) > floor(c rc / nch): the resident chunks are spread
// evenly over k, so the ring streams all through a step. The walk keeps the
// quotient and remainder of c rc / nch as it goes, with no division.
struct Walk {
  int tl = 0, g = 0, c = 0;
  int slot = 0, rem = 0;  // c * rc = slot * nch + rem
  __device__ __forceinline__ bool resident(int rc, int nch) const {
    return rem + rc >= nch;
  }
  __device__ __forceinline__ void next(int rc, int nch, int groups) {
    rem += rc;
    if (rem >= nch) {
      rem -= nch;
      ++slot;
    }
    if (++c == nch) {
      c = slot = rem = 0;
      if (++g == groups) {
        g = 0;
        ++tl;
      }
    }
  }
};

// what the epilogue's thread needs for its (row, unit) besides the sums
struct Cell {
  float x[4];
  float c_old, h_old;
  bool valid;
};

// The tensor cores take the bf16 product from 8 rows up: per chunk a block
// forms z^T[64 columns, BT rows] += W^T[64, KC] . h^T[KC, BT] with
// mma.sync m16n8k16. Warp w owns the 16 columns of gate w % 4 and half w / 4
// of the chunk's k; A comes from the [k, column] chunk through
// ldmatrix.trans, B from the staged h rows. f32 stays on FFMA: TF32 could
// not hold its tolerance.
template <typename WT, int BT>
struct Product {
  static constexpr bool MMA = sizeof(WT) == 2 && BT >= 8;
  static constexpr int KC = Chunk<WT>::KC;
  // bf16 rows of staged h are padded by 16 bytes: the mma's loads of one k
  // from 8 rows then fall into 8 different banks
  static constexpr int HROW = KC + (sizeof(WT) == 2 ? 8 : 0);
  static constexpr int SLICES = MMA ? 2 : KSLICES;  // partial sums per column
  static constexpr int ACC = MMA ? BT / 8 : BT;     // accumulator rows a thread
  // rows whose sums meet per round, and that the epilogue finishes per round
  static constexpr int PR = MMA ? BT : (BT < ER ? BT : ER);
  static constexpr int EPR = MMA ? (BT < 16 ? BT : 16) : PR;
  static constexpr int PART = SLICES * PR * PSTRIDE;  // floats of partial sums
};

// bf16 chunks are packed with the 16-byte pieces of row k exchanged by
// piece ^ (k & 7) (`pack_w_h` does it), so that ldmatrix's 8 rows of one
// column block fall into different banks; f32 chunks are not
template <typename WT>
__device__ __forceinline__ int swizzled(int k, int piece) {
  return sizeof(WT) == 2 ? (piece ^ (k & 7)) : piece;
}

__device__ __forceinline__ void store_rounded(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_rounded(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ void ldmatrix_x4_trans(const void* smem_src, unsigned (&r)[4]) {
  const unsigned src = static_cast<unsigned>(__cvta_generic_to_shared(smem_src));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(src));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename WT, bool STASH, int BT>
__global__ void __launch_bounds__(PTHREADS, 1)
recurrence_kernel(const Args<WT> a) {
  using P = Product<WT, BT>;
  constexpr bool MMA = P::MMA;
  constexpr int KC = P::KC;
  constexpr int HROW = P::HROW;
  constexpr int WCH = KC * TC;             // weights per chunk
  constexpr int HCH = BT * HROW;           // staged h per chunk
  constexpr int PR = P::PR;
  constexpr int EPR = P::EPR;
  constexpr int ROUNDS = BT / EPR;
  constexpr int PIECE = 16 / (int)sizeof(WT);  // elements of a 16-byte piece
  extern __shared__ __align__(16) unsigned char smem[];
  WT* const ring_w = reinterpret_cast<WT*>(smem);
  WT* const ring_h = reinterpret_cast<WT*>(smem + (size_t)STAGES * CHUNK_BYTES);
  float* const part = reinterpret_cast<float*>(ring_h + STAGES * HCH);
  // one barrier per slot of the ring, in BAR_BYTES
  unsigned long long* const full = reinterpret_cast<unsigned long long*>(part + P::PART);
  WT* const resident = reinterpret_cast<WT*>(part + P::PART + BAR_BYTES / 4);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cg = tid & 15;   // FFMA: the thread's 4 columns, 4 cg .. 4 cg + 3
  const int kg = tid >> 4;   // and its 4 k of every pass, 4 kg .. 4 kg + 3
  const int T = a.T, B = a.B, H = a.H;
  const size_t H4 = 4 * (size_t)H;
  const int nch = (H + KC - 1) / KC;
  const int groups = (B + BT - 1) / BT;
  const size_t hm_plane = (size_t)groups * nch * HCH;
  const int tiles = (H + UT - 1) / UT;
  const int rc = a.resident_chunks;
  int my_tiles = 0;
  for (int i = 0; i < a.tiles_per_block; ++i)
    my_tiles += (blockIdx.x + i * gridDim.x) < tiles;
  const int V = my_tiles * groups * nch;  // chunk visits of one step
  const WT* const w_packed = static_cast<const WT*>(a.w_packed);
  WT* const hm = static_cast<WT*>(a.hm);

  // Thread 0 requests copies; `n` counts visits over the whole call, so
  // slot n % STAGES and the parity (n / STAGES) & 1 of its barrier follow.
  // The weights of the visit at `at` in step t, unless they are resident and
  // already there (a tile's resident chunks are loaded at its first visit):
  auto request_w = [&](const Walk& at, long long n, int t) {
    const bool res = at.resident(rc, nch);
    if (res && !(t == 0 && at.g == 0)) return;
    WT* dst = res ? resident + ((size_t)at.tl * rc + at.slot) * WCH
                  : ring_w + (size_t)(n % STAGES) * WCH;
    const int tile = blockIdx.x + at.tl * gridDim.x;
    mbar_expect(full + n % STAGES, CHUNK_BYTES);
    bulk_copy(dst, w_packed + ((size_t)tile * nch + at.c) * WCH, CHUNK_BYTES,
              full + n % STAGES);
  };
  // the rounded h of that visit, BT rows of HROW values that lie together,
  // and the arrival that lets the slot's phase complete
  auto request_h = [&](const Walk& at, long long n, const WT* hm_cur) {
    constexpr unsigned HBYTES = HCH * sizeof(WT);
    mbar_arrive_expect(full + n % STAGES, HBYTES);
    bulk_copy(ring_h + (size_t)(n % STAGES) * HCH,
              hm_cur + ((size_t)at.g * nch + at.c) * HCH, HBYTES, full + n % STAGES);
  };

  const int e_bb = tid / UT;  // the epilogue's (row of the round, unit)
  const int e_u = tid % UT;
  auto load_cell = [&](int t, int b, int j) {
    Cell cell;
    const WT* x = a.x_proj + ((size_t)t * B + b) * H4 + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) cell.x[g] = to_f32(x[(size_t)g * H]);
    const size_t idx = (size_t)b * H + j;
    cell.c_old = t == 0 ? a.c0[idx] : a.c[idx];
    cell.h_old = t == 0 ? a.h0[idx] : a.h[idx];
    cell.valid = t < a.seq[b];
    return cell;
  };

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
    // the weights of the first step's first visits
    Walk at;
    for (int n = 0; n < STAGES - 1 && n < V; ++n, at.next(rc, nch, groups))
      request_w(at, n, 0);
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const WT* hm_cur = hm + (size_t)(t & 1) * hm_plane;
    WT* hm_next = hm + (size_t)((t + 1) & 1) * hm_plane;
    // the visit whose copies are requested: STAGES - 1 ahead of the one
    // that computes. The weights of the step's first visits were requested
    // before the barrier; their h follows now, after what the barrier made
    // visible is ordered before the bulk copies.
    const long long n0 = (long long)t * V;  // visits before this step
    Walk ahead;
    if (tid == 0) fence_proxy_async();
    for (int n = 0; n < STAGES - 1; ++n, ahead.next(rc, nch, groups))
      if (n < V && tid == 0) request_h(ahead, n0 + n, hm_cur);

    float acc[P::ACC][4];
    Cell first;  // round 0 of the group, loaded before its chunks
    first.valid = false;
    Walk at;  // the visit that computes
    for (int v = 0; v < V; ++v, at.next(rc, nch, groups), ahead.next(rc, nch, groups)) {
      const int g = at.g, c = at.c;
      const int tile = blockIdx.x + at.tl * gridDim.x;
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < P::ACC; ++i) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
        }
        const int b = g * BT + e_bb, j = tile * UT + e_u;
        if (tid < EPR * UT && b < B && j < H) first = load_cell(t, b, j);
      }

      mbar_wait(full + (n0 + v) % STAGES, (unsigned)((n0 + v) / STAGES) & 1u);
      __syncthreads();  // the slot of the visit before is free again
      if (v + STAGES - 1 < V && tid == 0) {
        request_w(ahead, n0 + v + STAGES - 1, t);
        request_h(ahead, n0 + v + STAGES - 1, hm_cur);
      }

      // the visit's weights, as an offset from the ring: its slot there, or
      // the resident chunk (the resident chunks lie behind `part`)
      const int ring_slot = (int)((n0 + v) % STAGES);
      const WT* ws = ring_w + (at.resident(rc, nch)
                                   ? (resident - ring_w) + (at.tl * rc + at.slot) * WCH
                                   : ring_slot * WCH);
      const WT* hs = ring_h + (size_t)ring_slot * HCH;
      if constexpr (MMA) {
        const int m0 = (warp & 3) * 16 + (lane & 8);       // ldmatrix: column block
        const int kq = (warp >> 2) * (KC / 2) + ((lane >> 4) << 3) + (lane & 7);
        const WT* hq = hs + (lane >> 2) * HROW + (warp >> 2) * (KC / 2) + 2 * (lane & 3);
#pragma unroll
        for (int ks = 0; ks < KC / 32; ++ks) {
          const int k = kq + ks * 16;
          unsigned af[4];
          ldmatrix_x4_trans(ws + k * TC + swizzled<WT>(k, m0 >> 3) * 8, af);
#pragma unroll
          for (int nt = 0; nt < BT / 8; ++nt) {
            const WT* hb = hq + nt * 8 * HROW + ks * 16;
            mma_bf16(acc[nt], af, *reinterpret_cast<const unsigned*>(hb),
                     *reinterpret_cast<const unsigned*>(hb + 8));
          }
        }
      } else {
#pragma unroll
        for (int p = 0; p < KC / KPASS; ++p) {
          const int k0 = p * KPASS + kg * 4;
          float w[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            load_w4(ws + (k0 + r) * TC + swizzled<WT>(k0 + r, cg * 4 / PIECE) * PIECE +
                        cg * 4 % PIECE, w[r]);
#pragma unroll
          for (int bb = 0; bb < BT; ++bb) {
            float hv[4];
            load_w4(hs + bb * HROW + k0, hv);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              acc[bb][q] = fmaf(hv[0], w[0][q], acc[bb][q]);
              acc[bb][q] = fmaf(hv[1], w[1][q], acc[bb][q]);
              acc[bb][q] = fmaf(hv[2], w[2][q], acc[bb][q]);
              acc[bb][q] = fmaf(hv[3], w[3][q], acc[bb][q]);
            }
          }
        }
      }
      if (c != nch - 1) continue;

      // ---- the group's epilogue: sums meet, gate math, length mask ----
      if constexpr (MMA) {
        // a thread holds rows 2 (lane % 4) and + 1 of each 8-row tile, for
        // columns lane / 4 and + 8 of its gate
        float* mine_part = part + ((warp >> 2) * BT + 2 * (lane & 3)) * PSTRIDE +
                           (warp & 3) * 16 + (lane >> 2);
#pragma unroll
        for (int nt = 0; nt < BT / 8; ++nt) {
          float* row = mine_part + nt * 8 * PSTRIDE;
          row[0] = acc[nt][0];
          row[PSTRIDE] = acc[nt][1];
          row[8] = acc[nt][2];
          row[PSTRIDE + 8] = acc[nt][3];
        }
      } else {
#pragma unroll
        for (int bb = 0; bb < BT; ++bb) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[bb][q] += __shfl_xor_sync(0xffffffffu, acc[bb][q], 16);
        }
      }
#pragma unroll
      for (int r = 0; r < ROUNDS; ++r) {
        const int b = g * BT + r * EPR + e_bb, j = tile * UT + e_u;
        const bool mine = tid < EPR * UT && b < B && j < H;
        Cell cell = first;
        if (r > 0) {
          if (mine) cell = load_cell(t, b, j);
          if constexpr (!MMA) __syncthreads();  // the last round's sums were read
        }
        if constexpr (!MMA) {
          if (lane < 16) {
#pragma unroll
            for (int bb = 0; bb < PR; ++bb)
              *reinterpret_cast<float4*>(part + (warp * PR + bb) * PSTRIDE + cg * 4) =
                  make_float4(acc[r * PR + bb][0], acc[r * PR + bb][1],
                              acc[r * PR + bb][2], acc[r * PR + bb][3]);
          }
        }
        if (!MMA || r == 0) __syncthreads();
        if (r == 0 && v == V - 1 && t + 1 < T && tid == 0) {
          // every slot of the ring is free: the next step's first weights
          // travel while this step's epilogue and the barrier run
          Walk to;
          for (int m = 0; m < STAGES - 1 && m < V; ++m, to.next(rc, nch, groups))
            request_w(to, n0 + V + m, t + 1);
        }
        if (!mine) continue;
        const int prow = MMA ? r * EPR + e_bb : e_bb;  // row within the sums
        float z[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float s = 0.0f;
#pragma unroll
          for (int w = 0; w < P::SLICES; ++w)
            s += part[(w * PR + prow) * PSTRIDE + q * UT + e_u];
          z[q] = cell.x[q] + s;
        }
        const float c_new = sigmoid(z[2]) * cell.c_old + sigmoid(z[0]) * tanhf(z[1]);
        const float h_new = sigmoid(z[3]) * tanhf(c_new);
        const float c_kept = cell.valid ? c_new : cell.c_old;
        const float h_kept = cell.valid ? h_new : cell.h_old;
        const size_t idx = (size_t)b * H + j;
        a.c[idx] = c_kept;
        a.h[idx] = h_kept;
        // h's scratch is laid out as it is staged: [group, chunk, row, HROW]
        store_rounded(hm_next + ((size_t)g * nch + j / KC) * HCH +
                          (r * EPR + e_bb) * HROW + j % KC,
                      h_kept);
        a.out[(size_t)t * B * H + idx] = cell.valid ? h_new : 0.0f;
        if constexpr (STASH) {
          a.cs[(size_t)t * B * H + idx] = c_kept;
          __nv_bfloat16* zs_t = a.zs + ((size_t)t * B + b) * H4 + j;
#pragma unroll
          for (int q = 0; q < 4; ++q) zs_t[(size_t)q * H] = __float2bfloat16(z[q]);
        }
      }
    }
    if (t + 1 < T) grid_barrier(a.counter, (unsigned)(t + 1) * gridDim.x);
  }
}

// Launches the recurrence for the plan the wrapper made: `blocks` blocks of
// PTHREADS threads with `smem` bytes of dynamic shared memory, `bt` batch
// rows per group (1, 8, 16 or 32). The launch is cooperative, so a grid
// that cannot be resident at once is refused and the error returned.
template <typename WT, bool STASH, int BT>
int launch_rows(const Args<WT>& a, int blocks, int smem, cudaStream_t s) {
  auto kernel = recurrence_kernel<WT, STASH, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* params[] = {const_cast<Args<WT>*>(&a)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(blocks),
                                    dim3(PTHREADS), params, (size_t)smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The host side of K1 (STASH false: cs and zs unused) and K3: x_proj
// [T, B, 4H] and w_packed (`pack_w_h`'s layout) in WT; c0, h0 [B, H] f32 in;
// c, h [B, H] f32 out; hm [2, groups, chunks, bt, HROW] scratch in WT with
// the rounded h0 in hm[0] and zeros elsewhere; seq [B]; out [T, B, H] (K3: hs); cs [T, B, H];
// zs [T, B, 4H] bf16; counter: one zeroed uint32. bt, blocks,
// tiles_per_block, resident_chunks and smem are the wrapper's launch plan.
// Returns the CUDA error, 0 when the kernel was launched.
template <typename WT, bool STASH>
int run_recurrence(const void* x_proj, const void* w_packed, const float* c0,
                   const float* h0, float* c, float* h, void* hm,
                   const int32_t* seq, float* out, float* cs, void* zs,
                   unsigned int* counter, int T, int B, int H, int bt,
                   int blocks, int tiles_per_block, int resident_chunks,
                   int smem, void* stream) {
  Args<WT> a;
  a.x_proj = static_cast<const WT*>(x_proj);
  a.w_packed = w_packed;
  a.c0 = c0;
  a.h0 = h0;
  a.c = c;
  a.h = h;
  a.hm = hm;
  a.seq = seq;
  a.out = out;
  a.cs = cs;
  a.zs = static_cast<__nv_bfloat16*>(zs);
  a.counter = counter;
  a.T = T;
  a.B = B;
  a.H = H;
  a.tiles_per_block = tiles_per_block;
  a.resident_chunks = resident_chunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bt) {
    case 1: return launch_rows<WT, STASH, 1>(a, blocks, smem, s);
    case 8: return launch_rows<WT, STASH, 8>(a, blocks, smem, s);
    case 16: return launch_rows<WT, STASH, 16>(a, blocks, smem, s);
    case 32: return launch_rows<WT, STASH, 32>(a, blocks, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace lstm
