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
// order); per slot the parent lookup by hash (a table in shared memory of
// the live slots' hash pairs, each with its first slot and its count: what
// a scan of the W slots finds, at one probe or two instead of W), the
// blank / repeat / merge-extend updates and the timestep-claim decision;
// then the candidate pool, W existing prefixes and W x C children, as
// 64-bit keys (order-preserving float bits above the complemented flat
// index, so that descending keys are value descending then flat index
// ascending, the order of a stable descending sort; keys are unique), and
// the top W of it; and the new state and the packed backpointers
// (src << 8) | (char + 1) read off the winners.
//
// The top W: children that already sit in the beam are struck out (a bit
// each), and only the live keys (finite values) are written, compacted by
// warp ballots: a -inf winner becomes a dead slot whose fields do not
// depend on which -inf key won. When no more than W are live they are all
// winners; else a radix select, most significant byte first from the
// highest byte in which the keys differ, finds the W-th largest key with
// one 256-bin histogram per byte; the W keys at or above it are gathered.
// The winners are then sorted descending by a bitonic network whose stages
// of pairs less than 32 apart run inside a warp by shuffles: at W = 512,
// 10 block-wide barriers. (The selection this replaces sorted all of a
// padded pool of up to 16,384 keys by groups of W and merged them: about
// 95 barriers a frame at W = 500.)
//
// Capacity: the TPU kernel takes beams up to 128 slots and 127 classes;
// this one takes every beam and every alphabet, in three instances of one
// template. The narrow instance (classes <= 127 and a pool W x (C + 1) of
// at most 16,384 keys, 128 KB) keeps the pool in shared memory: it covers
// the serving default of beam 500 over a 29-class alphabet. The wide
// instance takes beams up to 512 over up to 256 classes (the blank last at
// 256), byte alphabets at beam 500 among them, whose pool of up to 512 x
// 257 keys (1.05 MB) no shared memory holds: its live keys are compacted
// into a scratch of [B, W (C + 1)] keys in device memory that the caller
// allocates, which the 50 MB L2 holds at the batches the main path uses;
// the radix select's histograms stay in shared memory, and only the W
// winners come back into shared memory for the sort. Its class masks have
// 256 lanes, its strike-out bits cover the whole pool (16 KB). The huge
// instance takes every other shape: beams above 512 (the state then has
// W rounded up to a multiple of 128 slots), more than 256 classes (a
// character alphabet of thousands of symbols), 256 classes with another
// blank. Everything of it that scales with W or C lies in a layout that
// the host computes (`huge_layout`): the per-slot arrays, the per-class
// arrays, the parent table (at least 2 W places), one sort buffer of
// next_pow2(max(W, C)) keys and the strike-out bits over the pool, each in
// dynamic shared memory while HUGE_SMEM lasts and else in a workspace in
// device memory that the caller allocates per utterance (at beam 500 over
// 4,096 classes the strike-out bits, 256 KB, go there). Its classes are
// ranked by sorting C keys (a block-wide bitonic sort in memory) where the
// other instances count, and its winners are sorted by the same in-memory
// network, since W may pass the block's 1,024 threads. Its backpointers
// are two int32 planes, source slot and character, since a character may
// pass 254 and a slot 2^15. Its flat indices are ints, so W (C + 1) is at
// most MAX_FLAT = 2^30 (8 GiB of keys an utterance): the key's low 32 bits
// would hold up to 2^32.
// The arithmetic is the same code in all three. The state tensors have S =
// 128 slots for beams up to 128 (the TPU kernel's layout) and S = 512 up
// to 512; the packed backpointer of the narrow and wide instances is an
// int16 up to 128 slots (7 bits of source above 8 bits of character + 1)
// and an int32 above, so a character must be at most 254 there (with 256
// classes the blank is then the last). All per-slot arrays live in dynamic
// shared memory (behind the keys in the narrow instance), since 512 slots
// pass the 48 KB of static space.

// What bounds it on this card: bytes in the table's sense are tiny (C
// floats in and W int16 out per frame), but the T frames form a dependency
// chain, each a few dozen block-wide barriers long, so the time is latency:
// barriers and shared-memory round trips per frame, times T. Utterances
// run in parallel on separate SMs, so a batch costs what its longest
// utterance costs as long as B <= 132.
//
// What the design does about it: no device memory traffic inside a frame
// but the C probabilities and the W backpointers (and, in the wide
// instance, the pool's live keys through the L2); the selection ranks only
// the live keys and sorts only the W winners; frames past the utterance's
// length or before the first non-blank frame cost one store per slot.
//
// Not done yet: several utterances per block at small W.
//
// The backtrace, launched after the scan on the same stream
// (beam_backtrack_kernel; it replaces no TPU kernel: stt_tpu walks the
// backpointers on the host, as stt_tpu_torch/decode/device.py's
// rebuild_results does, after copying all of them there). For each row b
// and result r one warp picks the r-th beam in the order of
// np.argsort(-scores[b], kind="stable") (descending, ties to the lower
// slot, NaN last) by r + 1 warp-wide arg-max rounds over the beams after
// the previous pick, then one lane walks that beam from frame T - 1 down to
// 0 as rebuild_results does, padding frames included: char = the frame's
// character at slot w, a token where it is not -1, w = the frame's source
// slot. The path is B x R x (3 + 2 T) int32: the score's bits, the slot
// (-1 where the pick is no result: a non-finite score, or no r-th beam),
// the token count, then the tokens and their frames, each in time order
// from index 0 and zero past the count. It reads the scan's backpointers in
// the form the scan wrote them (the int16 or int32 packed plane, or the
// huge instance's two int32 planes), only the T entries of each walk.
// What bounds it: the walk is T dependent loads of a plane that the L2
// does not hold (0.19 GB at B 128, T 750, W 500), ~T x the device memory's
// latency; the bytes (B R T entries, the scores, the paths) take
// microseconds. The warps of a batch walk side by side.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int LN = 128;  // class lanes of the narrow instance's masks
constexpr int WIDE_LN = 256;     // and of the wide instance's: the most classes
constexpr int MAX_SLOTS = 512;   // beam slots
constexpr int MAX_POOL = 16384;  // keys of the narrow instance's pool, in shared memory
constexpr int WIDE_POOL = MAX_SLOTS * (WIDE_LN + 1);  // of the wide one's, in device memory
constexpr int SLOT_ARRAYS = 20;  // per-slot arrays of 4-byte values
constexpr int MAX_SORT = 512;    // keys the final sort takes: the beam, padded
constexpr int TABLE = 1024;      // open-addressing places of the parent table (2 x MAX_SLOTS)
constexpr int TABLE_BITS = 10;   // log2(TABLE)
constexpr int HUGE_SMEM = 200 * 1024;  // dynamic shared memory the huge instance's layout may take
constexpr long long MAX_FLAT = 1LL << 30;  // W (C + 1) of the huge instance: int flat indices
constexpr int NO_SLOT = 0x7fffffff;  // a table place's first slot before any slot has it
constexpr float LOG_FLOOR = 1.1754944e-38f;
constexpr uint32_t H1 = 1000003u;
constexpr uint32_t H2 = 69069u;
#define NEG_INF (-CUDART_INF_F)

typedef unsigned long long u64;

enum Kind { NARROW = 0, WIDE = 1, HUGE = 2 };

// Where the huge instance's arrays lie: region r (0 the per-slot arrays,
// 1 the per-class arrays, 2 the parent table, 3 the sort buffer, 4 the
// strike-out bits) in dynamic shared memory when bit r of in_smem is set,
// else in the block's part of the workspace, at byte offset off[r].
struct Layout {
  unsigned in_smem;
  u64 off[5];
  u64 smem_bytes, ws_bytes;  // dynamic shared memory; workspace per block
  int tbits;                 // the parent table has 1 << tbits places
  int lsort;                 // keys of the sort buffer (a power of two)
};

#ifdef K5_PHASE_CLOCKS
// A variant for measurement only (chip_smoke.py builds it beside the
// kernel): the SM clock cycles of block 0's frames summed by phase [0, 6),
// each phase ended by a barrier (the parent lookup gets a barrier of its
// own); [6] the most live keys a frame had, [7] the frames counted.
__device__ u64 k5_phase_clocks[8];
#define PHASE(i)                                                   \
  do {                                                             \
    __syncthreads();                                               \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                     \
      const u64 now = clock64();                                   \
      k5_phase_clocks[i] += now - stamp;                           \
      stamp = now;                                                 \
    }                                                              \
  } while (0)
#else
#define PHASE(i) \
  do {           \
  } while (0)
#endif

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

// a slot's string hashes as one key of the parent table; (0, 0) is its
// empty place, so live slots with those hashes are counted beside it
__device__ __forceinline__ u64 hash_pair(int32_t a, int32_t b) {
  return ((u64)(uint32_t)a << 32) | (u64)(uint32_t)b;
}
__device__ __forceinline__ unsigned table_place(u64 key, int bits) {
  return (unsigned)(((key ^ (key >> 29)) * 0x9E3779B97F4A7C15ull) >> (64 - bits));
}

__device__ __forceinline__ u64 umax64(u64 a, u64 b) { return a > b ? a : b; }
__device__ __forceinline__ u64 umin64(u64 a, u64 b) { return a < b ? a : b; }

// Sorts the L keys of buf[0][0, L) descending (L a power of two, at most
// MAX_SORT and at most the block's threads) by a bitonic network in which
// thread i holds key i: stages that pair keys less than 32 apart run inside
// a warp by shuffles, the others meet in shared memory, one barrier each
// (the two buffers take turns). Ends with the keys in buf[0][0, L) and a
// barrier.
__device__ void sort_desc(u64 (*buf)[MAX_SORT], int L) {
  const int tid = threadIdx.x;
  u64 x = tid < L ? buf[0][tid] : 0;
  int turn = 1;
  for (int k = 2; k <= L; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      u64 y;
      if (j >= 32) {
        if (tid < L) buf[turn][tid] = x;
        __syncthreads();
        y = tid < L ? buf[turn][tid ^ j] : 0;
        turn ^= 1;
      } else {
        y = __shfl_xor_sync(0xffffffffu, x, j);
      }
      const bool desc = (tid & k) == 0, lower = (tid & j) == 0;
      x = lower == desc ? umax64(x, y) : umin64(x, y);
    }
  }
  __syncthreads();  // the last stage's reads are done
  if (tid < L) buf[0][tid] = x;
  __syncthreads();
}

// Sorts the L keys of a[0, L) descending (L a power of two, any size) by
// the bitonic network in memory, shared or device: every thread takes the
// pairs (i, i ^ j) with i < i ^ j of its indices, one barrier a stage.
// The caller has written a[] before a barrier; ends with a barrier.
__device__ void sort_desc_mem(u64* a, int L) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int k = 2; k <= L; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < L; i += nt) {
        const int p = i ^ j;
        if (p > i) {
          const u64 x = a[i], y = a[p];
          if ((i & k) == 0 ? x < y : x > y) {
            a[i] = y;
            a[p] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// The position of this lane's item among the warp's items that are `on`,
// and (in *count) how many of the warp's items are on.
__device__ __forceinline__ int warp_rank(bool on, int* count) {
  const unsigned ballot = __ballot_sync(0xffffffffu, on);
  *count = __popc(ballot);
  return __popc(ballot & ((1u << (threadIdx.x & 31)) - 1u));
}

// Called by every thread: of the per-warp values vals[0, nwarps), the sum
// of those before warp w (returned) and of all (*total), by one warp scan
// of values every thread reads.
__device__ __forceinline__ int warps_before(const int* vals, int nwarps, int w, int* total) {
  const int lane = threadIdx.x & 31;
  const int mine = lane < nwarps ? vals[lane] : 0;
  int incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  *total = __shfl_sync(0xffffffffu, incl, 31);
  return __shfl_sync(0xffffffffu, incl - mine, w);
}

// Radix select, most significant byte first: among the n unique keys of
// keys[0, n) (n > W), the W largest are those whose bits above `*shift`
// are at least those of the returned prefix. Starts at the highest byte in
// which the keys differ (from their OR-ed differences, `spread`, and one
// key, `any`). Per byte: a 256-bin histogram of the keys that share the
// prefix so far, counted with one shared atomic per run of equal digits in
// a warp (__match_any_sync: at flat emissions most live keys share their
// top bytes), then one warp walks the bins from the top to the bin that
// holds the W-th key. Stops when every key of that bin is taken. hist[2][256]
// must be zero at the start and is left zero after the next barrier.
__device__ u64 radix_select(const u64* keys, int n, int W, u64 spread, u64 any,
                            int (*hist)[256], int* shift_out, int* decision) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  int shift = ((63 - __clzll((long long)spread)) >> 3) << 3;
  u64 prefix = shift == 56 ? 0 : (any >> (shift + 8)) << (shift + 8);
  int need = W;
  for (int pass = 0;; ++pass, shift -= 8) {
    int* h = hist[pass & 1];
    const int above = shift + 8;  // bits decided so far: those at and above `above`
    for (int base = tid & ~31; base < n; base += nt) {
      const int i = base + lane;
      int digit = -1;
      if (i < n) {
        const u64 key = keys[i];
        if (above == 64 || (key >> above) == (prefix >> above)) digit = (int)((key >> shift) & 255);
      }
      const unsigned peers = __match_any_sync(0xffffffffu, digit);
      if (digit >= 0 && lane == __ffs(peers) - 1) atomicAdd(h + digit, __popc(peers));
    }
    __syncthreads();
    if (tid < 32) {
      // lane l holds bins 255 - 8 l down to 248 - 8 l
      int c[8], sum = 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        c[e] = h[255 - 8 * lane - e];
        sum += c[e];
      }
      int incl = sum;
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      int before = incl - sum;  // keys in the bins above this lane's
      if (before < need && need <= incl) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (before < need && need <= before + c[e]) {
            decision[0] = 255 - 8 * lane - e;
            decision[1] = need - before;
            decision[2] = c[e] == need - before;
          }
          before += c[e];
        }
      }
    }
    __syncthreads();
    prefix |= (u64)decision[0] << shift;
    need = decision[1];
    const bool done = decision[2] != 0;
    // this histogram was read above; the next pass counts in the other one,
    // and warp 0 writes the decision again only after that pass's barrier
    for (int i = tid; i < 256; i += nt) h[i] = 0;
    if (done || shift == 0) break;
  }
  *shift_out = shift;
  return prefix;
}

// mode: 0 = classes in static rank order, none cut; 1 = sorted by
// probability, none cut (cutoff_top_n < C alone); 2 = sorted and cut by
// cumulative mass cutoff_prob or at cutoff_top_n. KIND: NARROW keeps the
// pool's keys in shared memory; WIDE puts them in pool [B, W (C + 1)] in
// device memory and has masks of WIDE_LN lanes; HUGE also has its pool
// there and every array that scales with W or C where `lay` says (ws:
// [B, lay.ws_bytes]), and writes bp as two int32 planes [2, B, T, W].
template <typename BP, int KIND>
__global__ void __launch_bounds__(1024)
beam_scan_kernel(const float* __restrict__ probs,        // [B, T, C]
                 const int32_t* __restrict__ lens,       // [B]
                 const int32_t* __restrict__ nign,       // [lanes]
                 const int32_t* __restrict__ rank_static,  // [lanes]
                 const float* __restrict__ in_f,         // [2, B, S]
                 const int32_t* __restrict__ in_i,       // [5, B, S]
                 const int32_t* __restrict__ in_started, // [B]
                 float* __restrict__ out_f, int32_t* __restrict__ out_i,
                 int32_t* __restrict__ out_started,
                 BP* __restrict__ bp,                    // [B, T, W]; HUGE [2, B, T, W]
                 u64* pool,                              // WIDE, HUGE: [B, W (C + 1)]
                 int B, int T, int W, int S, int C, int blank,
                 int cutoff_top_n, int mode, float cutoff_prob,
                 const Layout lay, unsigned char* ws) {
  constexpr bool BIG = KIND == HUGE;
  constexpr int lanes = BIG ? 1 : KIND == WIDE ? WIDE_LN : LN;
  constexpr int pool_bits = BIG ? 32 : KIND == WIDE ? WIDE_POOL : MAX_POOL;
  constexpr int places = BIG ? 1 : TABLE;
  // NARROW, WIDE: two sort buffers of MAX_SORT keys, the pool's live keys
  // [W (C + 1)] (narrow instance only), then SLOT_ARRAYS arrays of [S];
  // HUGE: the regions of `lay` that lie in shared memory
  extern __shared__ u64 dyn[];
  const int n_pool = W + W * C;
  __shared__ float logp_s[lanes], sprob_s[lanes];
  __shared__ int32_t rank_s[lanes], order_s[lanes], included_s[lanes];
  __shared__ unsigned struck_s[(pool_bits + 31) / 32];  // children already in the beam
  __shared__ int hist[2][256];               // the radix select's
  __shared__ int wcount[32], decision[3], n_sel;
  __shared__ u64 wmin[32], wmax[32];
  // the parent table: per distinct hash pair of the live slots, the first
  // slot that has it and how many do
  __shared__ u64 tab_key_s[places];
  __shared__ int tab_first_s[places], tab_hits_s[places];
  __shared__ int zero_first, zero_hits;  // the live slots with hashes (0, 0)
  __shared__ int32_t started, cutlen;

  u64 *keys, *top0;
  float *slot_f, *logp, *sprob;
  int32_t *rank, *order, *included;
  unsigned* struck;
  u64* tab_key;
  int *tab_first, *tab_hits;
  int tbits;
  if constexpr (BIG) {
    unsigned char* const mine = ws + (size_t)blockIdx.x * lay.ws_bytes;
    auto region = [&](int r) -> unsigned char* {
      return ((lay.in_smem >> r) & 1u ? reinterpret_cast<unsigned char*>(dyn) : mine) + lay.off[r];
    };
    slot_f = reinterpret_cast<float*>(region(0));
    logp = reinterpret_cast<float*>(region(1));
    sprob = logp + C;
    rank = reinterpret_cast<int32_t*>(sprob + C);
    order = rank + C;
    included = order + C;
    tab_key = reinterpret_cast<u64*>(region(2));
    tab_first = reinterpret_cast<int*>(tab_key + (1 << lay.tbits));
    tab_hits = tab_first + (1 << lay.tbits);
    top0 = reinterpret_cast<u64*>(region(3));
    struck = reinterpret_cast<unsigned*>(region(4));
    keys = pool + (size_t)blockIdx.x * n_pool;
    tbits = lay.tbits;
  } else {
    top0 = dyn;
    keys = KIND == WIDE ? pool + (size_t)blockIdx.x * n_pool : dyn + 2 * MAX_SORT;
    slot_f = reinterpret_cast<float*>(KIND == WIDE ? dyn + 2 * MAX_SORT : keys + n_pool);
    logp = logp_s;
    sprob = sprob_s;
    rank = rank_s;
    order = order_s;
    included = included_s;
    struck = struck_s;
    tab_key = tab_key_s;
    tab_first = tab_first_s;
    tab_hits = tab_hits_s;
    tbits = TABLE_BITS;
  }
  const int n_places = 1 << tbits;
  float *const pb = slot_f, *const pnb = pb + S, *const score = pnb + S;
  float *const npb = score + S, *const npnb = npb + S, *const exist = npnb + S;
  float *const t_pb = exist + S, *const t_pnb = t_pb + S;
  int32_t* const slot_i = reinterpret_cast<int32_t*>(t_pnb + S);
  int32_t *const last = slot_i, *const ha = last + S, *const hb = ha + S;
  int32_t *const pha = hb + S, *const phb = pha + S;
  int32_t *const t_last = phb + S, *const t_ha = t_last + S;
  int32_t *const t_hb = t_ha + S, *const t_pha = t_hb + S;
  int32_t *const t_phb = t_pha + S, *const par_idx = t_phb + S;
  int32_t* const rewrite = par_idx + S;

  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int b = blockIdx.x;
  const int len = lens[b];
  const size_t plane = (size_t)B * S;
  const size_t bp_plane = (size_t)B * T * W;  // HUGE: the character plane's offset

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
  for (int i = tid; i < 2 * 256; i += nt) hist[i >> 8][i & 255] = 0;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
#ifdef K5_PHASE_CLOCKS
    u64 stamp = clock64();
#endif
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
      for (int w = tid; w < W; w += nt) {
        if constexpr (BIG) {
          bp_t[w] = w;
          bp_t[bp_plane + w] = -1;
        } else {
          bp_t[w] = (BP)(w << 8);
        }
      }
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
      if constexpr (BIG) {
        // the rank of a class, by sorting the classes' keys: probability
        // descending, then class ascending (the counting below, in
        // O(C log^2 C) instead of O(C^2))
        const int lc = C <= 1 ? 1 : 1 << (32 - __clz(C - 1));
        for (int c = tid; c < lc; c += nt) top0[c] = c < C ? make_key(sprob[c], c) : 0;
        __syncthreads();
        sort_desc_mem(top0, lc);
        for (int r = tid; r < C; r += nt) {
          const int c = (int)(~(uint32_t)top0[r]);
          rank[c] = r;
          order[r] = c;
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
    for (int i = tid; i < (n_pool + 31) / 32; i += nt) struck[i] = 0;
    for (int i = tid; i < n_places; i += nt) {
      tab_key[i] = 0;
      tab_first[i] = NO_SLOT;
      tab_hits[i] = 0;
    }
    if (tid == 0) {
      n_sel = zero_hits = 0;
      zero_first = NO_SLOT;
    }
    __syncthreads();
    PHASE(0);  // class logs, cutoff, scores

    // ---- the parent table: every live slot under its string hashes -------
    for (int i = tid; i < W; i += nt) {
      if (!(score[i] > NEG_INF)) continue;
      const u64 key = hash_pair(ha[i], hb[i]);
      int *first = &zero_first, *hits = &zero_hits;
      if (key != 0) {
        unsigned at = table_place(key, tbits);
        for (u64 seen; (seen = atomicCAS(&tab_key[at], 0ull, key)) != 0 && seen != key;)
          at = (at + 1) & (n_places - 1);
        first = tab_first + at;
        hits = tab_hits + at;
      }
      atomicMin(first, i);
      atomicAdd(hits, 1);
    }
    __syncthreads();

    // the parent of slot j: the first live slot whose string hashes are
    // j's parent-string hashes, and how many match (what a scan of the W
    // slots in order finds)
    auto parent_of = [&](int j, int& par, int& hits) {
      par = hits = 0;
      if (last[j] < 0) return;
      const u64 key = hash_pair(pha[j], phb[j]);
      const int *first = &zero_first, *count = &zero_hits;
      if (key != 0) {
        unsigned at = table_place(key, tbits);
        while (tab_key[at] != key && tab_key[at] != 0) at = (at + 1) & (n_places - 1);
        if (tab_key[at] != key) return;
        first = tab_first + at;
        count = tab_hits + at;
      }
      hits = *count;
      if (hits) par = *first;
    };
#ifdef K5_PHASE_CLOCKS
    for (int j = tid; j < W; j += nt) parent_of(j, par_idx[j], rewrite[j]);
    PHASE(1);
#endif

    // ---- existing slots: parent by hash, blank / repeat / merge-extend,
    // and whether the extension rewrites the prefix's last timestep ------
    const bool blank_in = included[blank] != 0;
    for (int j = tid; j < W; j += nt) {
      const float sc = score[j];
      const bool alive = sc > NEG_INF;
      const int l = last[j];
      const bool has_last = l >= 0;
      int par, hits;
#ifdef K5_PHASE_CLOCKS
      par = par_idx[j];
      hits = rewrite[j];
#else
      parent_of(j, par, hits);
#endif
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
      rewrite[j] = (r_first ? rw_a : rw_b) && e_ok;
      // the child prefix_par + last[j] already sits in the beam as slot j:
      // its mass went to slot j as the merge-extend, so it is struck out of
      // the pool (under a hash collision, that of every matching parent)
      if (hits == 1) {
        const int f = W + par * C + l;
        atomicOr(&struck[f >> 5], 1u << (f & 31));
      } else if (hits > 1) {
        for (int i = 0; i < W; ++i) {
          if (ha[i] == pha[j] && hb[i] == phb[j] && score[i] > NEG_INF) {
            const int f = W + i * C + l;
            atomicOr(&struck[f >> 5], 1u << (f & 31));
          }
        }
      }
    }
    __syncthreads();
    PHASE(2);  // updates of the existing slots

    // ---- the pool: the live keys of the W existing prefixes and the
    // W x C children, compacted. A key is live when its value is finite: a
    // -inf winner becomes a dead slot whose fields do not depend on which
    // -inf key won, so only the finite keys need ranking. Warp w takes a
    // run of seg flat indices; it counts its live keys, the warps' counts
    // are scanned, and it writes them at its offset.
    const int seg = (n_pool + nt - 1) / nt * 32;
    const int f_begin = warp * seg, f_end = min(f_begin + seg, n_pool);
    auto pool_key = [&](int f, u64* key) {
      float v;
      if (f < W) {
        v = exist[f];
      } else {
        const int w = (f - W) / C, c = (f - W) - w * C;
        v = NEG_INF;
        if (score[w] > NEG_INF && included[c] && c != blank && !((struck[f >> 5] >> (f & 31)) & 1u))
          v = ((c == last[w]) ? pb[w] : score[w]) + logp[c];
      }
      *key = make_key(v, f);
      return v > NEG_INF;
    };
    {
      int count = 0;
      for (int f0 = f_begin; f0 < f_end; f0 += 32) {
        u64 key;
        const bool on = f0 + lane < f_end && pool_key(f0 + lane, &key);
        count += __popc(__ballot_sync(0xffffffffu, on));
      }
      if (lane == 0) wcount[warp] = count;
    }
    __syncthreads();
    int n_live;
    {
      int pos = warps_before(wcount, nwarps, warp, &n_live);
      u64 lo = ~0ull, hi = 0;
      for (int f0 = f_begin; f0 < f_end; f0 += 32) {
        u64 key;
        const bool on = f0 + lane < f_end && pool_key(f0 + lane, &key);
        int count;
        const int r = warp_rank(on, &count);
        if (on) {
          keys[pos + r] = key;
          lo = umin64(lo, key);
          hi = umax64(hi, key);
        }
        pos += count;
      }
      for (int o = 16; o > 0; o >>= 1) {
        lo = umin64(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = umax64(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      }
      if (lane == 0) {
        wmin[warp] = lo;
        wmax[warp] = hi;
      }
    }
    __syncthreads();
    PHASE(3);  // the pool's live keys, compacted
#ifdef K5_PHASE_CLOCKS
    if (blockIdx.x == 0 && tid == 0) {  // the most live keys a frame had, and the frames
      if ((u64)n_live > k5_phase_clocks[6]) k5_phase_clocks[6] = n_live;
      k5_phase_clocks[7] += 1;
    }
#endif

    // ---- the top W: all live keys when they are no more than W, else the
    // W at or above the W-th largest (radix select); then sorted ----------
    const int n_top = min(n_live, W);
    if (n_live > W) {
      u64 lo = lane < nwarps ? wmin[lane] : ~0ull, hi = lane < nwarps ? wmax[lane] : 0;
      for (int o = 16; o > 0; o >>= 1) {
        lo = umin64(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = umax64(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      }
      int shift;
      const u64 prefix = radix_select(keys, n_live, W, hi ^ lo, hi, hist, &shift, decision);
      for (int base = tid & ~31; base < n_live; base += nt) {
        const int i = base + lane;
        const bool on = i < n_live && (keys[i] >> shift) >= (prefix >> shift);
        int count;
        const int r = warp_rank(on, &count);
        int at = 0;
        if (lane == 0 && count) at = atomicAdd(&n_sel, count);
        at = __shfl_sync(0xffffffffu, at, 0);
        if (on) top0[at + r] = keys[i];
      }
    } else {
      for (int i = tid; i < n_live; i += nt) top0[i] = keys[i];
    }
    const int L = n_top <= 1 ? 1 : 1 << (32 - __clz(n_top - 1));
    for (int i = n_top + tid; i < L; i += nt) top0[i] = 0;  // below every key
    __syncthreads();
    if constexpr (BIG) {
      sort_desc_mem(top0, L);
    } else {
      sort_desc(reinterpret_cast<u64 (*)[MAX_SORT]>(dyn), L);
    }
    PHASE(4);  // radix select, gather, sort

    // ---- the winners become the new slots --------------------------------
    for (int k = tid; k < W; k += nt) {
      int s_last, s_ha, s_hb, s_pha, s_phb, src, ch;
      float s_pb, s_pnb;
      const u64 key = top0[k];
      const int flat = (int)(~(uint32_t)key);
      if (k >= n_top) {  // a dead slot: hash (0, 0), points at itself
        s_last = -1;
        s_pb = s_pnb = NEG_INF;
        s_ha = s_hb = s_pha = s_phb = 0;
        src = k;
        ch = -1;
      } else if (flat < W) {
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
        s_pnb = key_value(key);
        // a child rolls its parent's hashes forward one character (the
        // products wrap in 32 bits)
        s_ha = (int32_t)((uint32_t)ha[i] * H1 + (uint32_t)(c + 1));
        s_hb = (int32_t)((uint32_t)hb[i] * H2 + (uint32_t)(c + 1));
        s_pha = ha[i];
        s_phb = hb[i];
        src = i;
        ch = c;
      }
      t_last[k] = s_last;
      t_pb[k] = s_pb;
      t_pnb[k] = s_pnb;
      t_ha[k] = s_ha;
      t_hb[k] = s_hb;
      t_pha[k] = s_pha;
      t_phb[k] = s_phb;
      if constexpr (BIG) {
        bp_t[k] = src;
        bp_t[bp_plane + k] = ch;
      } else {
        bp_t[k] = (BP)((src << 8) | (ch + 1));
      }
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
    PHASE(5);  // the winners become the new slots
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

// The huge instance's layout at (W, S, C): each region, in the order of
// Layout, goes to dynamic shared memory while HUGE_SMEM lasts, else to the
// block's workspace; every region starts 16-byte aligned.
Layout huge_layout(int W, int S, int C) {
  Layout lay{};
  lay.tbits = TABLE_BITS;
  while ((1 << lay.tbits) < 2 * W) ++lay.tbits;
  lay.lsort = next_pow2(W > C ? W : C);
  const u64 n_pool = (u64)W * (u64)(C + 1);
  const u64 bytes[5] = {
      (u64)SLOT_ARRAYS * S * 4,  // the per-slot arrays
      5ull * C * 4,              // logp, sprob, rank, order, included
      (1ull << lay.tbits) * 16,  // key, first slot, count
      (u64)lay.lsort * 8,        // the sort buffer
      (n_pool + 31) / 32 * 4,    // the strike-out bits
  };
  for (int r = 0; r < 5; ++r) {
    const u64 size = (bytes[r] + 15) & ~15ull;
    if (lay.smem_bytes + size <= (u64)HUGE_SMEM) {
      lay.in_smem |= 1u << r;
      lay.off[r] = lay.smem_bytes;
      lay.smem_bytes += size;
    } else {
      lay.off[r] = lay.ws_bytes;
      lay.ws_bytes += size;
    }
  }
  return lay;
}

template <typename BP, int KIND>
int launch_scan(const float* probs, const int32_t* lens, const int32_t* nign,
                const int32_t* rank_static, const float* in_f,
                const int32_t* in_i, const int32_t* in_started, float* out_f,
                int32_t* out_i, int32_t* out_started, BP* bp, u64* pool,
                unsigned char* ws, int B, int T, int W, int S, int C, int blank,
                int cutoff_top_n, int mode, float cutoff_prob, cudaStream_t stream) {
  const int n_pool = W + W * C;
  Layout lay{};
  int threads;
  size_t smem;
  if (KIND == HUGE) {
    lay = huge_layout(W, S, C);
    threads = 1024;
    smem = lay.smem_bytes;
  } else {
    // at least one thread per key of the final sort
    threads = n_pool <= 512 ? 128 : n_pool <= 2048 ? 256 : n_pool <= 8192 ? 512 : 1024;
    if (threads < next_pow2(W)) threads = next_pow2(W);
    smem = (size_t)(2 * MAX_SORT + (KIND == WIDE ? 0 : n_pool)) * sizeof(u64) +
           (size_t)SLOT_ARRAYS * S * 4;
  }
  cudaError_t err = cudaFuncSetAttribute(
      beam_scan_kernel<BP, KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  beam_scan_kernel<BP, KIND><<<B, threads, smem, stream>>>(
      probs, lens, nign, rank_static, in_f, in_i, in_started, out_f, out_i,
      out_started, bp, pool, B, T, W, S, C, blank, cutoff_top_n, mode, cutoff_prob, lay, ws);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND>
int scan(const float* probs, const int32_t* lens, const int32_t* nign,
         const int32_t* rank_static, const float* in_f, const int32_t* in_i,
         const int32_t* in_started, float* out_f, int32_t* out_i,
         int32_t* out_started, void* bp, u64* pool, int B, int T, int W, int S,
         int C, int blank, int cutoff_top_n, int mode, int bp_wide,
         float cutoff_prob, void* stream) {
  cudaStream_t on = static_cast<cudaStream_t>(stream);
  if (bp_wide)
    return launch_scan<int32_t, KIND>(probs, lens, nign, rank_static, in_f, in_i, in_started,
                                      out_f, out_i, out_started, static_cast<int32_t*>(bp),
                                      pool, nullptr, B, T, W, S, C, blank, cutoff_top_n, mode,
                                      cutoff_prob, on);
  return launch_scan<int16_t, KIND>(probs, lens, nign, rank_static, in_f, in_i, in_started,
                                    out_f, out_i, out_started, static_cast<int16_t*>(bp), pool,
                                    nullptr, B, T, W, S, C, blank, cutoff_top_n, mode,
                                    cutoff_prob, on);
}

constexpr int PATH_HEAD = 3;  // a path's score bits, slot and token count before its tokens

// whether beam (a, ia) comes before beam (b, ib) in the order of
// np.argsort(-scores, kind="stable"): descending, NaN last, ties to the lower slot
__device__ __forceinline__ bool ranks_before(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return nb;
  if (!na && a != b) return a > b;
  return ia < ib;
}

// Frame t's (source slot, character) at slot w of row b: the packed plane
// (src << 8) | (char + 1) of int16 or int32, or the pair of int32 planes.
template <typename BP, bool PAIR>
__device__ __forceinline__ void backpointer(const BP* bp, const int32_t* bp_char, size_t at,
                                            int* src, int* ch) {
  if (PAIR) {
    *src = bp[at];
    *ch = bp_char[at];
  } else {
    const int32_t v = bp[at];
    *src = v >> 8;
    *ch = (v & 0xFF) - 1;
  }
}

// grid B x R blocks of one warp: block (b, r) writes out[b, r] (see the
// header of this file). bp [B, T, W]; bp_char [B, T, W] with PAIR.
template <typename BP, bool PAIR>
__global__ void __launch_bounds__(32)
beam_backtrack_kernel(const float* __restrict__ scores,  // [B, W]
                      const BP* __restrict__ bp, const int32_t* __restrict__ bp_char,
                      int32_t* __restrict__ out,          // [B, R, PATH_HEAD + 2 T]
                      int T, int W, int R) {
  constexpr unsigned FULL = 0xffffffffu;
  const int b = blockIdx.x / R, r = blockIdx.x % R, lane = threadIdx.x;
  const float* s = scores + (size_t)b * W;

  // the r-th beam: r + 1 arg-max rounds, each over the beams after the last pick
  int pick = -1;
  float value = 0.0f;
  for (int k = 0; k <= r; ++k) {
    int best = -1;
    float best_v = 0.0f;
    for (int w = lane; w < W; w += 32) {
      const float v = s[w];
      if (k > 0 && !ranks_before(value, pick, v, w)) continue;
      if (best < 0 || ranks_before(v, w, best_v, best)) best = w, best_v = v;
    }
    for (int off = 16; off > 0; off >>= 1) {
      const int o = __shfl_down_sync(FULL, best, off);
      const float ov = __shfl_down_sync(FULL, best_v, off);
      if (o >= 0 && (best < 0 || ranks_before(ov, o, best_v, best))) best = o, best_v = ov;
    }
    pick = __shfl_sync(FULL, best, 0);
    value = __shfl_sync(FULL, best_v, 0);
    if (pick < 0) break;  // fewer than r + 1 beams
  }
  const bool found = pick >= 0 && isfinite(value);

  int32_t* path = out + ((size_t)b * R + r) * (PATH_HEAD + 2 * (size_t)T);
  int32_t* tokens = path + PATH_HEAD;
  int32_t* frames = tokens + T;
  int n = 0;
  if (found) {
    // one lane chases the pointers, writing the tokens from the end of the row
    if (lane == 0) {
      const size_t row = (size_t)b * T;
      int w = pick;
      for (int t = T - 1; t >= 0; --t) {
        int src, ch;
        backpointer<BP, PAIR>(bp, bp_char, (row + t) * W + w, &src, &ch);
        if (ch != -1) {
          ++n;
          tokens[T - n] = ch;
          frames[T - n] = t;
        }
        w = src;
      }
    }
    n = __shfl_sync(FULL, n, 0);
    __syncwarp();
    // the warp moves them to the front: a round reads its 32 before it writes,
    // and writes below where any later round reads
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      int tok = 0, frame = 0;
      if (i < n) tok = tokens[T - n + i], frame = frames[T - n + i];
      __syncwarp();
      if (i < n) tokens[i] = tok, frames[i] = frame;
      __syncwarp();
    }
  }
  for (int i = n + lane; i < T; i += 32) tokens[i] = 0, frames[i] = 0;
  if (lane == 0) {
    path[0] = found ? __float_as_int(value) : 0;
    path[1] = found ? pick : -1;
    path[2] = n;
  }
}

template <typename BP, bool PAIR>
int launch_backtrack(const float* scores, const void* bp, const int32_t* bp_char, int32_t* out,
                     int B, int T, int W, int R, cudaStream_t stream) {
  beam_backtrack_kernel<BP, PAIR><<<B * R, 32, 0, stream>>>(
      scores, static_cast<const BP*>(bp), bp_char, out, T, W, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The narrow instance. probs [B, T, C] f32 softmax; lens [B]; nign,
// rank_static [128] int32; state in and out as f [2, B, 1, S] f32 (p_b,
// p_nb), i [5, B, 1, S] int32 (last, ha, hb, par_ha, par_hb), started
// [B, 1, 1] int32; bp [B, T, W], int16 or with bp_wide int32 (which W >
// 128 needs). 1 <= W <= S <= 512, 1 <= C <= 127, W (C + 1) <= 16384.
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
  return scan<NARROW>(probs, lens, nign, rank_static, in_f, in_i, in_started, out_f, out_i,
                      out_started, bp, nullptr, B, T, W, S, C, blank, cutoff_top_n, mode,
                      bp_wide, cutoff_prob, stream);
}

// The wide instance: the same arguments, with nign and rank_static of 256
// lanes, 1 <= C <= 256 (a character of at most 254: with 256 classes the
// blank is the last), and pool a scratch of B x W (C + 1) 64-bit keys in
// device memory.
int beam_scan_wide(const float* probs, const int32_t* lens, const int32_t* nign,
                   const int32_t* rank_static, const float* in_f,
                   const int32_t* in_i, const int32_t* in_started, float* out_f,
                   int32_t* out_i, int32_t* out_started, void* bp, int B, int T,
                   int W, int S, int C, int blank, int cutoff_top_n, int mode,
                   int bp_wide, float cutoff_prob, void* pool, void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || W > S || S > MAX_SLOTS || C < 1 || C > WIDE_LN || pool == nullptr ||
      (C == WIDE_LN && blank != C - 1) || (W > 128 && !bp_wide))
    return static_cast<int>(cudaErrorInvalidValue);
  return scan<WIDE>(probs, lens, nign, rank_static, in_f, in_i, in_started, out_f, out_i,
                    out_started, bp, static_cast<u64*>(pool), B, T, W, S, C, blank,
                    cutoff_top_n, mode, bp_wide, cutoff_prob, stream);
}

// Bytes of device memory the huge instance's workspace needs per utterance
// at (W, S, C): what of its layout HUGE_SMEM does not hold.
long long beam_scan_huge_workspace(int W, int S, int C) {
  return (long long)huge_layout(W, S, C).ws_bytes;
}

// The huge instance, for any shape: the narrow instance's arguments with
// nign and rank_static of at least C lanes, 1 <= W <= S, 1 <= C, W (C + 1)
// <= MAX_FLAT; bp two int32 planes [2, B, T, W] (source slot, character;
// -1 for the same prefix one frame back); pool a scratch of B x W (C + 1)
// keys and ws one of B x beam_scan_huge_workspace(W, S, C) bytes, both in
// device memory.
int beam_scan_huge(const float* probs, const int32_t* lens, const int32_t* nign,
                   const int32_t* rank_static, const float* in_f,
                   const int32_t* in_i, const int32_t* in_started, float* out_f,
                   int32_t* out_i, int32_t* out_started, void* bp, int B, int T,
                   int W, int S, int C, int blank, int cutoff_top_n, int mode,
                   float cutoff_prob, void* pool, void* ws, void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || W > S || C < 1 || (long long)W * (C + 1) > MAX_FLAT || pool == nullptr ||
      (ws == nullptr && huge_layout(W, S, C).ws_bytes > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_scan<int32_t, HUGE>(probs, lens, nign, rank_static, in_f, in_i, in_started,
                                    out_f, out_i, out_started, static_cast<int32_t*>(bp),
                                    static_cast<u64*>(pool), static_cast<unsigned char*>(ws),
                                    B, T, W, S, C, blank, cutoff_top_n, mode, cutoff_prob,
                                    static_cast<cudaStream_t>(stream));
}

// The backtrace: scores [B, W] f32 (the scan's final scores); bp [B, T, W]
// as the scan wrote it, the packed plane (int16 with bp_bytes 2, int32 with
// 4) or, with bp_char [B, T, W] int32 given, the source plane of the huge
// instance's pair; out [B, R, 3 + 2 T] int32, the paths of each row's R
// best beams (see the header of this file). 1 <= W, 0 <= T.
int beam_backtrack(const float* scores, const void* bp, const int32_t* bp_char, int bp_bytes,
                   int32_t* out, int B, int T, int W, int R, void* stream) {
  if (B <= 0 || R <= 0) return 0;
  if (W < 1 || T < 0 || (long long)B * R > 0x7fffffffLL ||
      (bp_char == nullptr && bp_bytes != 2 && bp_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t on = static_cast<cudaStream_t>(stream);
  if (bp_char != nullptr)
    return launch_backtrack<int32_t, true>(scores, bp, bp_char, out, B, T, W, R, on);
  if (bp_bytes == 2)
    return launch_backtrack<int16_t, false>(scores, bp, nullptr, out, B, T, W, R, on);
  return launch_backtrack<int32_t, false>(scores, bp, nullptr, out, B, T, W, R, on);
}

#ifdef K5_PHASE_CLOCKS
// Copies the phase clocks to clocks[8] and sets them to zero.
int beam_scan_phase_clocks(u64* clocks) {
  cudaError_t err = cudaMemcpyFromSymbol(clocks, k5_phase_clocks, sizeof(k5_phase_clocks));
  if (err != cudaSuccess) return static_cast<int>(err);
  const u64 zeros[8] = {};
  return static_cast<int>(cudaMemcpyToSymbol(k5_phase_clocks, zeros, sizeof(zeros)));
}
#endif

}  // extern "C"
