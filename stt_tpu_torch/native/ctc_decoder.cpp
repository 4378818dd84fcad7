// Native CTC prefix beam-search decoder library for stt_tpu.
//
// The host-side hot path of decoding (the per-frame beam expansion, the
// KenLM query and the vocabulary-trie walk) is native here for the same
// reason it is native in the reference (ctcdecode/*.cpp): Python-object
// beam bookkeeping is ~100x too slow at production beam widths. The
// semantics mirror stt_tpu_torch/decode/beam.py exactly — that module is the
// property-tested oracle and the equivalence test decodes identical
// inputs through both.
//
// Contents: murmur hash, KenLM binary trie reader (plain/quantized,
// bhiksha array pointers), ConstFst dictionary reader, .scorer package
// parse, prefix trie + timestep tree, DecoderState, C ABI (ctypes).
//
// Build: g++ -O3 -std=c++17 -fPIC -shared ctc_decoder.cpp -o libstt_decoder.so
// (stt_tpu_torch/decode/native.py does this at first use, into build/native/).

#include <algorithm>
#include <cassert>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fstream>
#include <limits>
#include <memory>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kNegInf = -std::numeric_limits<double>::infinity();
constexpr double kFltMin = 1.1754944e-38;
constexpr double kOovScore = -1000.0;
const double kLog10E = std::log10(std::exp(1.0));

inline double log_sum_exp(double a, double b) {
  if (a == kNegInf) return b;
  if (b == kNegInf) return a;
  double hi = std::max(a, b), lo = std::min(a, b);
  // exact early-out: when exp(lo-hi) < ulp(hi)/2 the addition cannot
  // change hi's double value, so skip the exp. exp(-42) ~ 5.7e-19 and
  // ulp(0.01) ~ 1.7e-18, so gap <= -42 with |hi| >= 0.01 is bit-exact.
  if (lo - hi < -42.0 && std::fabs(hi) >= 0.01) return hi;
  return hi + std::log1p(std::exp(lo - hi));
}

// ---------------------------------------------------------------- murmur
uint64_t murmur_hash64a(const void* key, size_t len, uint64_t seed = 0) {
  const uint64_t m = 0xc6a4a7935bd1e995ULL;
  const int r = 47;
  uint64_t h = seed ^ (len * m);
  const uint8_t* data = static_cast<const uint8_t*>(key);
  const uint8_t* end = data + (len & ~size_t(7));
  for (const uint8_t* p = data; p != end; p += 8) {
    uint64_t k;
    std::memcpy(&k, p, 8);
    k *= m;
    k ^= k >> r;
    k *= m;
    h ^= k;
    h *= m;
  }
  size_t tail_len = len & 7;
  if (tail_len) {
    uint64_t tail = 0;
    std::memcpy(&tail, end, tail_len);
    h ^= tail;
    h *= m;
  }
  h ^= h >> r;
  h *= m;
  h ^= h >> r;
  return h;
}

// ------------------------------------------------------------- bit utils
inline uint64_t read_bits(const uint8_t* base, uint64_t bit_off, int bits) {
  uint64_t word;
  std::memcpy(&word, base + (bit_off >> 3), 8);
  return (word >> (bit_off & 7)) & ((bits >= 64) ? ~0ULL : ((1ULL << bits) - 1));
}

inline float read_float32(const uint8_t* base, uint64_t bit_off) {
  uint32_t i = static_cast<uint32_t>(read_bits(base, bit_off, 32));
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}

inline float read_nonpositive_float31(const uint8_t* base, uint64_t bit_off) {
  uint32_t i = static_cast<uint32_t>(read_bits(base, bit_off, 31)) | 0x80000000u;
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}

inline int required_bits(uint64_t max_value) {
  int bits = 0;
  while (max_value) {
    ++bits;
    max_value >>= 1;
  }
  return bits;
}

inline uint64_t align8(uint64_t x) { return ((x - 1) / 8 + 1) * 8; }

// ------------------------------------------------------------ kenlm read
struct KenLM {
  std::vector<uint8_t> data;
  int order = 0;
  std::vector<uint64_t> counts;
  bool quantized = false, array_mode = false;
  int prob_bits = 0, backoff_bits = 0;

  const uint64_t* vocab_hashes = nullptr;
  uint64_t n_hashes = 0;

  struct UnigramValue {
    float prob, backoff;
    uint64_t next;
  };
  const UnigramValue* unigram = nullptr;

  struct Middle {
    const uint64_t* bhiksha_offsets = nullptr;
    uint64_t bhiksha_count = 0;
    int inline_bits = 0;
    const uint8_t* bits = nullptr;
    int word_bits = 0, quant_bits = 0, total_bits = 0;
    uint64_t entries = 0;
  };
  std::vector<Middle> middles;
  struct Longest {
    const uint8_t* bits = nullptr;
    int word_bits = 0, quant_bits = 0, total_bits = 0;
  } longest;
  std::vector<const float*> quant_prob_tables, quant_backoff_tables;
  const float* longest_table = nullptr;
  uint64_t end_of_search = 0;
  uint64_t end_of_lm = 0;  // past optional vocabulary strings section
  uint32_t bos_id = 0, eos_id = 0;

  bool parse(std::vector<uint8_t>&& bytes, std::string* err) {
    data = std::move(bytes);
    static const char kMagic[] =
        "mmap lm http://kheafield.com/code format version 5\n";
    const size_t magic_len = sizeof(kMagic);  // includes trailing NUL
    if (data.size() < 128 ||
        std::memcmp(data.data(), kMagic, magic_len - 1) != 0) {
      *err = "not a KenLM binary file";
      return false;
    }
    uint64_t sanity = align8(magic_len) + 12 + 12 + 8;
    uint64_t off = sanity;
    order = data[off];
    int32_t model_type;
    std::memcpy(&model_type, data.data() + off + 8, 4);
    off += 20;
    counts.resize(order);
    std::memcpy(counts.data(), data.data() + off, 8 * order);
    uint64_t header_size = align8(sanity + 20 + 8 * order);
    if (model_type < 2 || model_type > 5) {
      *err = "unsupported KenLM model type " + std::to_string(model_type);
      return false;
    }
    quantized = (model_type == 3 || model_type == 5);
    array_mode = (model_type == 4 || model_type == 5);

    uint64_t pos = header_size;
    std::memcpy(&n_hashes, data.data() + pos, 8);
    vocab_hashes = reinterpret_cast<const uint64_t*>(data.data() + pos + 8);
    pos += 8 + 8 * counts[0];

    if (quantized) {
      if (data[pos] != 2) {
        *err = "bad quantization version";
        return false;
      }
      prob_bits = data[pos + 1];
      backoff_bits = data[pos + 2];
      uint64_t tp = pos + 8;
      for (int o = 0; o < order - 2; ++o) {
        quant_prob_tables.push_back(
            reinterpret_cast<const float*>(data.data() + tp));
        tp += 4ULL << prob_bits;
        quant_backoff_tables.push_back(
            reinterpret_cast<const float*>(data.data() + tp));
        tp += 4ULL << backoff_bits;
      }
      longest_table = reinterpret_cast<const float*>(data.data() + tp);
      tp += 4ULL << prob_bits;
      pos = tp;
    }
    int middle_quant_bits = quantized ? prob_bits + backoff_bits : 31 + 32;
    int longest_quant_bits = quantized ? prob_bits : 31;

    unigram = reinterpret_cast<const UnigramValue*>(data.data() + pos);
    pos += (counts[0] + 2) * 16;

    int pointer_bhiksha_bits = 64;
    if (array_mode && order > 2) pointer_bhiksha_bits = data[align8(pos) + 1];

    int word_bits = required_bits(counts[0]);
    for (int o = 2; o < order; ++o) {
      Middle mid;
      uint64_t entries = counts[o - 1];
      uint64_t max_next = counts[o];
      int req = required_bits(max_next);
      uint64_t bhiksha_size = 0;
      if (array_mode) {
        uint64_t max_offset = entries + 1;
        int best_chop = 0;
        int64_t lowest = std::numeric_limits<int64_t>::max();
        for (int chop = 0; chop <= std::min(req, pointer_bhiksha_bits);
             ++chop) {
          int64_t change =
              static_cast<int64_t>(max_next >> (req - chop)) * 64 -
              static_cast<int64_t>(max_offset) * chop;
          if (change < lowest) {
            lowest = change;
            best_chop = chop;
          }
        }
        mid.inline_bits = req - best_chop;
        mid.bhiksha_count = (max_next >> (req - best_chop)) + 1;
        bhiksha_size = 8 * (1 + mid.bhiksha_count) + 7;
        mid.bhiksha_offsets =
            reinterpret_cast<const uint64_t*>(data.data() + align8(pos) + 8);
      } else {
        mid.inline_bits = req;
      }
      mid.word_bits = word_bits;
      mid.quant_bits = middle_quant_bits;
      mid.total_bits = word_bits + middle_quant_bits + mid.inline_bits;
      mid.entries = entries;
      mid.bits = data.data() + pos + bhiksha_size;
      uint64_t bits_size = ((1 + entries) * mid.total_bits + 7) / 8 + 8;
      pos += bhiksha_size + bits_size;
      middles.push_back(mid);
    }
    longest.word_bits = word_bits;
    longest.quant_bits = longest_quant_bits;
    longest.total_bits = word_bits + longest_quant_bits;
    longest.bits = data.data() + pos;
    pos += ((1 + counts[order - 1]) * longest.total_bits + 7) / 8 + 8;
    end_of_search = pos;

    // binaries built without kenlm's -v append counts[0] null-terminated
    // vocabulary strings after the search section; a .scorer trailer (if
    // any) starts past them
    end_of_lm = pos;
    bool has_vocabulary = data[sanity + 12] != 0;
    if (has_vocabulary) {
      uint64_t p = pos;
      for (uint64_t i = 0; i < counts[0] && p < data.size(); ++i) {
        while (p < data.size() && data[p] != 0) ++p;
        ++p;  // skip the NUL
      }
      end_of_lm = p;
    }

    bos_id = vocab_index("<s>");
    eos_id = vocab_index("</s>");
    return true;
  }

  uint32_t vocab_index(const std::string& word) const {
    uint64_t h = murmur_hash64a(word.data(), word.size());
    const uint64_t* it = std::lower_bound(vocab_hashes, vocab_hashes + n_hashes, h);
    if (it != vocab_hashes + n_hashes && *it == h)
      return static_cast<uint32_t>(it - vocab_hashes) + 1;
    return 0;
  }

  struct Range {
    uint64_t begin, end;
  };

  void bhiksha_next(const Middle& mid, uint64_t entry_bit_off, uint64_t index,
                    Range* out) const {
    uint64_t lo_begin = read_bits(mid.bits, entry_bit_off, mid.inline_bits);
    uint64_t lo_end =
        read_bits(mid.bits, entry_bit_off + mid.total_bits, mid.inline_bits);
    if (!mid.bhiksha_offsets) {
      out->begin = lo_begin;
      out->end = lo_end;
      return;
    }
    const uint64_t* ob = mid.bhiksha_offsets;
    const uint64_t* oe = ob + mid.bhiksha_count;
    uint64_t bb = (std::upper_bound(ob, oe, index) - 1) - ob;
    uint64_t eb = (std::upper_bound(ob, oe, index + 1) - 1) - ob;
    out->begin = (bb << mid.inline_bits) | lo_begin;
    out->end = (eb << mid.inline_bits) | lo_end;
  }

  // returns true + fills prob/backoff/range when found
  bool middle_find(int order_m2, uint32_t word, Range* range, float* prob,
                   float* backoff) const {
    const Middle& mid = middles[order_m2];
    uint64_t lo = range->begin, hi = range->end;
    while (lo < hi) {
      uint64_t m = (lo + hi) / 2;
      uint64_t w = read_bits(mid.bits, m * mid.total_bits, mid.word_bits);
      if (w < word)
        lo = m + 1;
      else if (w > word)
        hi = m;
      else {
        uint64_t at = m * mid.total_bits + mid.word_bits;
        if (quantized) {
          uint64_t b_idx = read_bits(mid.bits, at, backoff_bits);
          uint64_t p_idx = read_bits(mid.bits, at + backoff_bits, prob_bits);
          *prob = quant_prob_tables[order_m2][p_idx];
          *backoff = quant_backoff_tables[order_m2][b_idx];
        } else {
          *prob = read_nonpositive_float31(mid.bits, at);
          *backoff = read_float32(mid.bits, at + 31);
        }
        bhiksha_next(mid, at + mid.quant_bits, m, range);
        return true;
      }
    }
    return false;
  }

  bool longest_find(uint32_t word, const Range& range, float* prob) const {
    uint64_t lo = range.begin, hi = range.end;
    while (lo < hi) {
      uint64_t m = (lo + hi) / 2;
      uint64_t w = read_bits(longest.bits, m * longest.total_bits,
                             longest.word_bits);
      if (w < word)
        lo = m + 1;
      else if (w > word)
        hi = m;
      else {
        uint64_t at = m * longest.total_bits + longest.word_bits;
        if (quantized) {
          uint64_t idx = read_bits(longest.bits, at, prob_bits);
          *prob = longest_table[idx];
        } else {
          *prob = read_nonpositive_float31(longest.bits, at);
        }
        return true;
      }
    }
    return false;
  }

  // log10 P(word | context), context left-to-right (kenlm.py score())
  double score(const std::vector<uint32_t>& context_full, uint32_t word) const {
    size_t ctx_start = context_full.size() > size_t(order - 1)
                           ? context_full.size() - (order - 1)
                           : 0;
    const uint32_t* context = context_full.data() + ctx_start;
    int ctx_len = static_cast<int>(context_full.size() - ctx_start);

    double prob = unigram[word].prob;
    Range node{unigram[word].next, unigram[word + 1].next};
    int matched = 1;
    for (int k = 0; k < ctx_len; ++k) {
      if (node.begin == node.end) break;
      uint32_t w = context[ctx_len - 1 - k];
      if (k == order - 2) {
        float p;
        if (longest_find(w, node, &p)) {
          prob = p;
          matched = order;
        }
        break;
      }
      float p, b;
      if (!middle_find(k, w, &node, &p, &b)) break;
      prob = p;
      matched = k + 2;
    }
    if (ctx_len >= matched) {
      int start = matched;
      Range bnode;
      if (start <= 1) {
        uint32_t w = context[ctx_len - 1];
        prob += unigram[w].backoff;
        bnode = {unigram[w].next, unigram[w + 1].next};
        start = 2;
      } else {
        uint32_t w = context[ctx_len - 1];
        bnode = {unigram[w].next, unigram[w + 1].next};
        bool ok = true;
        for (int k = 1; k < start - 1; ++k) {
          float p, b;
          if (!middle_find(k - 1, context[ctx_len - 1 - k], &bnode, &p, &b)) {
            ok = false;
            break;
          }
        }
        if (!ok) return prob;
      }
      for (int length = start; length <= ctx_len; ++length) {
        if (bnode.begin == bnode.end) break;
        float p, b;
        if (!middle_find(length - 2, context[ctx_len - length], &bnode, &p, &b))
          break;
        prob += b;
      }
    }
    return prob;
  }
};

// ----------------------------------------------------------- ConstFst
struct FstDict {
  struct State {
    float final_w;
    uint32_t pos, narcs, nieps, noeps;
  };
  struct Arc {
    int32_t ilabel, olabel;
    float weight;
    int32_t nextstate;
  };
  std::vector<State> states;
  std::vector<Arc> arcs;
  int32_t start = 0;

  bool parse(const uint8_t* data, uint64_t size, uint64_t base, std::string* err) {
    uint64_t off = base;
    int32_t magic;
    std::memcpy(&magic, data + off, 4);
    off += 4;
    if (magic != 2125659606) {
      *err = "bad FST magic";
      return false;
    }
    auto read_string = [&](std::string* s) {
      int32_t n;
      std::memcpy(&n, data + off, 4);
      off += 4;
      s->assign(reinterpret_cast<const char*>(data + off), n);
      off += n;
    };
    std::string fsttype, arctype;
    read_string(&fsttype);
    read_string(&arctype);
    if (fsttype != "const" || arctype != "standard") {
      *err = "unsupported FST type";
      return false;
    }
    int32_t version, flags;
    std::memcpy(&version, data + off, 4);
    std::memcpy(&flags, data + off + 4, 4);
    off += 8;
    uint64_t properties;
    int64_t st, nstates, narcs;
    std::memcpy(&properties, data + off, 8);
    std::memcpy(&st, data + off + 8, 8);
    std::memcpy(&nstates, data + off + 16, 8);
    std::memcpy(&narcs, data + off + 24, 8);
    off += 32;
    bool aligned = (version == 1) || (flags & 4);
    auto align16 = [&]() {
      if (aligned) off = (off + 15) & ~15ULL;
    };
    align16();
    states.resize(nstates);
    std::memcpy(states.data(), data + off, nstates * sizeof(State));
    off += nstates * sizeof(State);
    align16();
    arcs.resize(narcs);
    std::memcpy(arcs.data(), data + off, narcs * sizeof(Arc));
    start = static_cast<int32_t>(st);
    return true;
  }

  bool is_final(int32_t s) const { return std::isfinite(states[s].final_w); }

  // label = alphabet index; arcs store index+1. -1 = not found.
  int32_t step(int32_t s, int label, bool reset = true) const {
    const State& st = states[s];
    const Arc* b = arcs.data() + st.pos;
    const Arc* e = b + st.narcs;
    int32_t want = label + 1;
    const Arc* it = std::lower_bound(
        b, e, want, [](const Arc& a, int32_t v) { return a.ilabel < v; });
    if (it == e || it->ilabel != want) return -1;
    int32_t nxt = it->nextstate;
    if (reset && is_final(nxt)) return start;
    return nxt;
  }
};

// ------------------------------------------------------------- scorer
struct Scorer {
  KenLM lm;
  std::unique_ptr<FstDict> dictionary;
  bool utf8_mode = false;
  double alpha = 0, beta = 0;

  bool load(const std::string& path, std::string* err) {
    std::ifstream in(path, std::ios::binary);
    if (!in) {
      *err = "cannot open scorer file";
      return false;
    }
    std::vector<uint8_t> bytes((std::istreambuf_iterator<char>(in)),
                               std::istreambuf_iterator<char>());
    if (!lm.parse(std::move(bytes), err)) return false;
    uint64_t off = lm.end_of_lm;
    const uint8_t* d = lm.data.data();
    if (lm.data.size() < off + 25 || std::memcmp(d + off, "EIRT", 4) != 0) {
      *err = "scorer has no TRIE trailer";
      return false;
    }
    int32_t version;
    std::memcpy(&version, d + off + 4, 4);
    if (version != 6) {
      *err = "scorer version mismatch";
      return false;
    }
    utf8_mode = d[off + 8] != 0;
    std::memcpy(&alpha, d + off + 9, 8);
    std::memcpy(&beta, d + off + 17, 8);
    dictionary.reset(new FstDict());
    if (!dictionary->parse(d, lm.data.size(), off + 25, err)) return false;
    return true;
  }

  // ngram of word strings -> ln P(last | preceding); OOV anywhere = OOV
  double cond_prob(const std::vector<std::string>& ngram, bool bos) const {
    std::vector<uint32_t> context;
    if (bos) context.push_back(lm.bos_id);
    double cond = 0.0;
    for (const auto& w : ngram) {
      uint32_t wid = lm.vocab_index(w);
      if (wid == 0) return kOovScore;
      cond = lm.score(context, wid);
      context.push_back(wid);
    }
    return cond / kLog10E;
  }
};

// ------------------------------------------------- prefix + timesteps
//
// Both trees are arena-allocated (std::deque pools owned by the
// Decoder): nodes churn at ~beam x candidates per frame and the
// reference's per-node heap allocation (PathTrie news/deletes) was the
// top allocator load in profiles. TimestepNodes are never freed until
// reset; Prefix nodes recycle through a free list.
struct TimestepNode {
  TimestepNode* parent = nullptr;
  int data = -1;
  std::vector<TimestepNode*> children;
};

struct TimestepArena {
  std::deque<TimestepNode> pool;

  TimestepNode* fresh() {
    pool.emplace_back();
    return &pool.back();
  }

  TimestepNode* child(TimestepNode* node, int value) {
    for (TimestepNode* c : node->children)
      if (c->data == value) return c;
    TimestepNode* c = fresh();
    c->parent = node;
    c->data = value;
    node->children.push_back(c);
    return c;
  }

  void clear() { pool.clear(); }
};

struct Prefix {
  // hot fields first: the expansion loop reads score/character/the four
  // probability registers on every visit — keep them inside one cache
  // line (64B) with the timestep-claim pointer
  double score = kNegInf;
  double log_prob_b_prev = kNegInf, log_prob_nb_prev = kNegInf;
  double log_prob_b_cur = kNegInf, log_prob_nb_cur = kNegInf;
  int character = -1;
  bool exists = true;
  TimestepNode* previous_timesteps = nullptr;
  TimestepNode* timesteps = nullptr;
  Prefix* parent = nullptr;
  // sorted by label ascending — iteration order must match the
  // std::map-keyed DFS the Python oracle (beam.py PrefixNode) produces
  std::vector<std::pair<int, Prefix*>> children;
  int new_timestep = -1;
  int32_t dict_state = -1;
  // memoized raw LM contribution (cond_prob + hot boost, before
  // alpha/beta): the n-gram ending at this node never changes, so the
  // KenLM walk runs once per node instead of once per (node, frame).
  // lm_gen guards hot-word mutations between runs.
  double lm_raw = 0.0;
  uint32_t lm_gen = 0;
  bool lm_valid = false;

  void reset_node(int label, Prefix* par, int32_t dict) {
    character = label;
    parent = par;
    children.clear();
    exists = true;
    log_prob_b_prev = log_prob_nb_prev = kNegInf;
    log_prob_b_cur = log_prob_nb_cur = kNegInf;
    score = kNegInf;
    timesteps = nullptr;
    previous_timesteps = nullptr;
    new_timestep = -1;
    dict_state = dict;
    lm_valid = false;
  }

  std::pair<int, Prefix*>* find_child(int label) {
    auto it = std::lower_bound(
        children.begin(), children.end(), label,
        [](const std::pair<int, Prefix*>& a, int v) { return a.first < v; });
    if (it != children.end() && it->first == label) return &*it;
    return nullptr;
  }
};

struct PrefixArena {
  std::deque<Prefix> pool;
  std::vector<Prefix*> free_list;

  Prefix* alloc(int label, Prefix* parent, int32_t dict) {
    Prefix* node;
    if (!free_list.empty()) {
      node = free_list.back();
      free_list.pop_back();
    } else {
      pool.emplace_back();
      node = &pool.back();
    }
    node->reset_node(label, parent, dict);
    return node;
  }

  void clear() {
    pool.clear();
    free_list.clear();
  }
};

// added: when non-null, nodes that newly became exists (created or
// revived) are appended — the per-frame alive set is then exactly
// beam ∪ added, which replaces the full-trie DFS rollover on the
// scorer path (see Decoder::step).
Prefix* prefix_get_child(Prefix* self, int label, const FstDict* trie,
                         PrefixArena* arena, std::vector<Prefix*>* added) {
  if (auto* slot = self->find_child(label)) {
    Prefix* node = slot->second;
    if (!node->exists) {
      node->exists = true;
      node->log_prob_b_prev = node->log_prob_nb_prev = kNegInf;
      node->log_prob_b_cur = node->log_prob_nb_cur = kNegInf;
      if (added) added->push_back(node);
    }
    return node;
  }
  int32_t next_state = -1;
  if (trie) {
    next_state = trie->step(self->dict_state, label, true);
    if (next_state < 0) return nullptr;
  }
  Prefix* node = arena->alloc(label, self, next_state);
  auto it = std::lower_bound(
      self->children.begin(), self->children.end(), label,
      [](const std::pair<int, Prefix*>& a, int v) { return a.first < v; });
  self->children.insert(it, {label, node});
  if (added) added->push_back(node);
  return node;
}

void prefix_iterate_to_vec(Prefix* self, std::vector<Prefix*>* out,
                           TimestepArena* ts) {
  for (auto& kv : self->children) prefix_iterate_to_vec(kv.second, out, ts);
  if (self->exists) {
    self->log_prob_b_prev = self->log_prob_b_cur;
    self->log_prob_nb_prev = self->log_prob_nb_cur;
    self->log_prob_b_cur = kNegInf;
    self->log_prob_nb_cur = kNegInf;
    self->score = log_sum_exp(self->log_prob_b_prev, self->log_prob_nb_prev);
    if (self->previous_timesteps)
      self->timesteps = ts->child(self->previous_timesteps, self->new_timestep);
    self->previous_timesteps = nullptr;
    out->push_back(self);
  }
}

void prefix_remove(Prefix* self, PrefixArena* arena) {
  self->exists = false;
  while (self->children.empty() && self->parent) {
    Prefix* p = self->parent;
    auto* slot = p->find_child(self->character);
    p->children.erase(p->children.begin() + (slot - p->children.data()));
    arena->free_list.push_back(self);
    if (p->exists || !p->children.empty()) break;
    self = p;
    self->exists = false;  // cascade: p was already !exists to get here
  }
}

// ------------------------------------------------------------- decoder
struct Decoder {
  std::vector<std::string> labels;  // index -> utf8 label
  int space_id = -2, blank_id = 0;
  size_t beam_size = 0;
  double cutoff_prob = 1.0;
  size_t cutoff_top_n = 40;
  std::shared_ptr<Scorer> scorer;
  // per-decoder LM weights: scorers are shared read-only across decoder
  // instances (scorer_create / decoder_attach_scorer), so the tunable
  // alpha/beta live here, seeded from the package defaults
  double alpha = 0, beta = 0;
  std::unordered_map<std::string, float> hot_words;
  uint32_t lm_gen = 1;  // bumped on hot-word changes; guards Prefix::lm_raw

  PrefixArena arena;
  TimestepArena ts_arena;
  Prefix* root = nullptr;
  TimestepNode* timestep_root = nullptr;
  std::vector<Prefix*> prefixes;
  int abs_time_step = 0;
  bool start_expanding = false;
  // true when `prefixes` is already in (-score, character) order — the
  // post-prune order carries into the next frame unchanged, so the
  // per-frame sort only runs when the beam wasn't overfull last frame
  bool beam_sorted = false;

  void init() {
    abs_time_step = 0;
    start_expanding = false;
    beam_sorted = false;
    ts_arena.clear();
    arena.clear();
    timestep_root = ts_arena.fresh();
    root = arena.alloc(-1, nullptr, -1);
    root->score = 0.0;
    root->log_prob_b_prev = 0.0;
    root->timesteps = timestep_root;
    if (scorer && scorer->dictionary) root->dict_state = scorer->dictionary->start;
    prefixes.assign(1, root);
  }

  void attach_scorer(std::shared_ptr<Scorer> s) {
    scorer = std::move(s);
    if (scorer) {
      alpha = scorer->alpha;
      beta = scorer->beta;
    }
    init();  // dictionary state must thread from the root
  }

  static bool prefix_compare(const Prefix* a, const Prefix* b) {
    if (a->score == b->score) return a->character < b->character;
    return a->score > b->score;
  }

  // Flat sort key: sorting Prefix pointers chases cold heap lines on
  // every comparison (41% of decode time in profiles); extracting
  // (score, character) once and sorting the 16-byte keys is ~5x faster
  // with the identical comparator semantics.
  struct SortKey {
    double score;
    int character;
    int idx;
  };
  std::vector<SortKey> sort_keys;
  std::vector<Prefix*> sort_tmp;

  static bool key_compare(const SortKey& a, const SortKey& b) {
    if (a.score == b.score) return a.character < b.character;
    return a.score > b.score;
  }

  std::vector<Prefix*> frame_added;   // nodes that became alive this frame
  std::vector<Prefix*> rolled;        // rollover scratch
  std::vector<double> flat_scores;    // prefixes[i]->score, contiguous

  // sort prefixes[0..n) fully (n <= size); when top_only is set, order
  // only the best beam_size entries (nth_element + sort of the head —
  // the tail is pruned right after, its order never observed)
  void sort_prefixes(bool top_only) {
    size_t n = prefixes.size();
    sort_keys.resize(n);
    for (size_t i = 0; i < n; ++i)
      sort_keys[i] = {prefixes[i]->score, prefixes[i]->character,
                      static_cast<int>(i)};
    if (top_only && n > beam_size) {
      std::nth_element(sort_keys.begin(), sort_keys.begin() + beam_size,
                       sort_keys.end(), key_compare);
      std::sort(sort_keys.begin(), sort_keys.begin() + beam_size, key_compare);
    } else {
      std::sort(sort_keys.begin(), sort_keys.end(), key_compare);
    }
    sort_tmp.resize(n);
    for (size_t i = 0; i < n; ++i) sort_tmp[i] = prefixes[sort_keys[i].idx];
    prefixes.swap(sort_tmp);
  }

  std::vector<std::string> make_ngram(Prefix* prefix) const {
    std::vector<std::string> ngram;
    Prefix* node = prefix;
    int max_order = scorer->lm.order;
    for (int i = 0; i < max_order; ++i) {
      if (!node || node->character == -1) break;
      std::string unit;
      Prefix* stop = node;
      if (scorer->utf8_mode) {
        // walk back to the codepoint's first byte
        std::vector<int> bytes;
        Prefix* cur = node;
        while (true) {
          bytes.push_back(cur->character);
          uint8_t b = static_cast<uint8_t>(cur->character + 1);
          if ((b & 0xC0) != 0x80 || !cur->parent) {
            stop = cur;
            break;
          }
          cur = cur->parent;
        }
        for (auto it = bytes.rbegin(); it != bytes.rend(); ++it)
          unit += static_cast<char>(*it + 1);
      } else {
        if (node->character == space_id) {
          stop = node;  // empty word
        } else {
          std::vector<int> chars;
          Prefix* cur = node;
          while (true) {
            chars.push_back(cur->character);
            Prefix* p = cur->parent;
            if (!p || p->character == space_id || p->character == -1) {
              stop = p ? p : cur;
              break;
            }
            cur = p;
          }
          for (auto it = chars.rbegin(); it != chars.rend(); ++it)
            unit += labels[*it];
        }
      }
      node = stop->parent;
      ngram.push_back(unit);
    }
    std::reverse(ngram.begin(), ngram.end());
    return ngram;
  }

  bool codepoint_complete(Prefix* prefix) const {
    if (prefix->character == -1) return false;
    int distance = 0;
    Prefix* node = prefix;
    int first_byte = -1;
    while (node && node->character != -1) {
      ++distance;
      uint8_t b = static_cast<uint8_t>(node->character + 1);
      if ((b & 0xC0) != 0x80) {
        first_byte = b;
        break;
      }
      node = node->parent;
    }
    if (first_byte < 0) return false;
    int needed;
    if ((first_byte >> 3) == 0x1E)
      needed = 4;
    else if ((first_byte >> 4) == 0x0E)
      needed = 3;
    else if ((first_byte >> 5) == 0x06)
      needed = 2;
    else if ((first_byte >> 7) == 0x00)
      needed = 1;
    else
      return false;
    return distance == needed;
  }

  bool is_scoring_boundary(Prefix* prefix, int new_label) const {
    if (scorer->utf8_mode) return codepoint_complete(prefix);
    return new_label == space_id;
  }

  double lm_score(Prefix* to_score) {
    // The n-gram ending at a prefix node is a pure function of the node's
    // string, which never changes — memoize the raw (pre-alpha/beta)
    // contribution on the node. The reference re-walks the string and
    // re-queries KenLM on every frame a boundary candidate appears
    // (ctc_beam_search_decoder.cpp:181-196); with production-size LMs the
    // query dominates, so this is a large exact-result speedup.
    if (to_score->lm_valid && to_score->lm_gen == lm_gen)
      return to_score->lm_raw * alpha + beta;
    auto ngram = make_ngram(to_score);
    double hot_boost = 0.0;
    if (!hot_words.empty()) {
      for (const auto& word : ngram) {
        auto it = hot_words.find(word);
        if (it != hot_words.end()) hot_boost += it->second;
      }
    }
    bool bos = ngram.size() < static_cast<size_t>(scorer->lm.order);
    double raw = scorer->cond_prob(ngram, bos) + hot_boost;
    to_score->lm_raw = raw;
    to_score->lm_gen = lm_gen;
    to_score->lm_valid = true;
    return raw * alpha + beta;
  }

  void next(const double* probs, int time_dim, int class_dim) {
    for (int rel_t = 0; rel_t < time_dim; ++rel_t) {
      const double* prob = probs + static_cast<size_t>(rel_t) * class_dim;
      // pruned emissions
      std::vector<std::pair<int, double>> emissions;
      {
        size_t n = class_dim;
        std::vector<std::pair<int, double>> pairs(n);
        for (size_t i = 0; i < n; ++i) pairs[i] = {static_cast<int>(i), prob[i]};
        size_t cutoff_len = n;
        if (cutoff_prob < 1.0 || cutoff_top_n < n) {
          std::sort(pairs.begin(), pairs.end(),
                    [](auto& a, auto& b) { return a.second > b.second; });
          if (cutoff_prob < 1.0) {
            double cum = 0.0;
            cutoff_len = 0;
            for (auto& pr : pairs) {
              cum += pr.second;
              ++cutoff_len;
              if (cum >= cutoff_prob || cutoff_len >= cutoff_top_n) break;
            }
          }
          pairs.resize(cutoff_len);
        }
        emissions.reserve(pairs.size());
        for (auto& pr : pairs)
          emissions.emplace_back(pr.first, std::log(pr.second + kFltMin));
      }
      step(emissions, prob[blank_id]);
    }
  }

  // One frame given already-pruned (class, logp) candidates — the entry
  // point for device-side emission pruning (stt_tpu/decode/device.py),
  // where only [T, K] (indices, logp) + the blank probability cross
  // from the TPU. blank_prob drives the expansion gate and min_cutoff.
  // per-node end-of-frame rollover — the body of prefix_iterate_to_vec,
  // applied to an explicitly tracked alive set instead of a trie DFS
  void roll_node(Prefix* node, std::vector<Prefix*>* out) {
    node->log_prob_b_prev = node->log_prob_b_cur;
    node->log_prob_nb_prev = node->log_prob_nb_cur;
    node->log_prob_b_cur = kNegInf;
    node->log_prob_nb_cur = kNegInf;
    node->score = log_sum_exp(node->log_prob_b_prev, node->log_prob_nb_prev);
    if (node->previous_timesteps)
      node->timesteps =
          ts_arena.child(node->previous_timesteps, node->new_timestep);
    node->previous_timesteps = nullptr;
    out->push_back(node);
  }

  void step(const std::vector<std::pair<int, double>>& emissions,
            double blank_prob) {
    {
      if (blank_prob < 0.999) start_expanding = true;
      if (!start_expanding) {
        ++abs_time_step;
        return;
      }

      double min_cutoff = kNegInf;
      bool full_beam = false;
      const FstDict* trie =
          (scorer && scorer->dictionary) ? scorer->dictionary.get() : nullptr;
      if (scorer) {
        if (!beam_sorted) sort_prefixes(false);
        size_t num_prefixes = std::min(prefixes.size(), beam_size);
        min_cutoff = prefixes[num_prefixes - 1]->score +
                     std::log(blank_prob + kFltMin) -
                     std::max(0.0, beta);
        full_beam = num_prefixes == beam_size;
      }

      size_t n_pref = std::min(prefixes.size(), beam_size);
      // contiguous score mirror: the full_beam break scans hundreds of
      // beam slots per candidate; reading a flat double array instead of
      // chasing Prefix pointers keeps the scan in one or two cache lines
      flat_scores.resize(n_pref);
      for (size_t i = 0; i < n_pref; ++i) flat_scores[i] = prefixes[i]->score;
      // scorer path: collect this frame's newly-alive nodes so the
      // rollover below touches exactly beam ∪ added instead of walking
      // the whole prefix trie (the DFS was ~20% of decode time); the
      // no-scorer path must keep the DFS — its per-frame iteration
      // order (string order) is observable through lsexp rounding and
      // the oracle iterates unsorted
      std::vector<Prefix*>* added = scorer ? &frame_added : nullptr;
      if (added) added->clear();
      for (auto& em : emissions) {
        int c = em.first;
        double log_prob_c = em.second;
        for (size_t pi = 0; pi < n_pref; ++pi) {
          double pscore = flat_scores[pi];
          if (full_beam && log_prob_c + pscore < min_cutoff) break;
          if (pscore == kNegInf) continue;
          if (pi + 4 < n_pref) __builtin_prefetch(prefixes[pi + 4]);
          Prefix* prefix = prefixes[pi];

          if (c == blank_id) {
            double log_p = log_prob_c + pscore;
            if (prefix->log_prob_nb_cur < log_p)
              prefix->previous_timesteps = nullptr;
            prefix->log_prob_b_cur = log_sum_exp(prefix->log_prob_b_cur, log_p);
            continue;
          }
          if (c == prefix->character) {
            double log_p = log_prob_c + prefix->log_prob_nb_prev;
            if (prefix->log_prob_nb_cur < log_p)
              prefix->previous_timesteps = nullptr;
            prefix->log_prob_nb_cur =
                log_sum_exp(prefix->log_prob_nb_cur, log_p);
          }
          Prefix* new_prefix = prefix_get_child(prefix, c, trie, &arena, added);
          if (!new_prefix) continue;

          double log_p = kNegInf;
          if (c == prefix->character && prefix->log_prob_b_prev != kNegInf) {
            log_p = log_prob_c + prefix->log_prob_b_prev;
          } else if (c != prefix->character) {
            log_p = log_prob_c + pscore;
          }
          if (scorer) {
            Prefix* to_score = scorer->utf8_mode ? new_prefix : prefix;
            if (is_scoring_boundary(to_score, c)) log_p += lm_score(to_score);
          }
          if (new_prefix->log_prob_nb_cur < log_p) {
            new_prefix->previous_timesteps = prefix->timesteps;
            new_prefix->new_timestep = abs_time_step;
          }
          new_prefix->log_prob_nb_cur =
              log_sum_exp(new_prefix->log_prob_nb_cur, log_p);
        }
      }

      if (added) {
        // beam ∪ added IS the alive set: the previous prune removed
        // every other node (prefix_remove), and only get_child revives
        // or creates. Rollover order is irrelevant here — the sort
        // before the next frame's expansion fixes the observable order.
        size_t n_beam = prefixes.size();
        rolled.clear();
        for (Prefix* node : prefixes) roll_node(node, &rolled);
        for (Prefix* node : frame_added) roll_node(node, &rolled);
        prefixes.swap(rolled);
        // Sort now (the next frame needs sorted order anyway) and
        // exploit stability: on blank-dominated frames every beam score
        // shifts by ~log p_blank, so the beam part usually keeps its
        // exact order — then only the ~10% new children need sorting
        // before a linear merge, instead of re-sorting the whole list.
        size_t n = prefixes.size();
        sort_keys.resize(n);
        for (size_t i = 0; i < n; ++i)
          sort_keys[i] = {prefixes[i]->score, prefixes[i]->character,
                          static_cast<int>(i)};
        bool head_sorted = std::is_sorted(
            sort_keys.begin(), sort_keys.begin() + n_beam, key_compare);
        if (head_sorted) {
          std::sort(sort_keys.begin() + n_beam, sort_keys.end(), key_compare);
          std::inplace_merge(sort_keys.begin(), sort_keys.begin() + n_beam,
                             sort_keys.end(), key_compare);
        } else {
          std::sort(sort_keys.begin(), sort_keys.end(), key_compare);
        }
        sort_tmp.resize(n);
        for (size_t i = 0; i < n; ++i) sort_tmp[i] = prefixes[sort_keys[i].idx];
        prefixes.swap(sort_tmp);
        if (n > beam_size) {
          for (size_t i = beam_size; i < n; ++i)
            prefix_remove(prefixes[i], &arena);
          prefixes.resize(beam_size);
        }
        beam_sorted = true;
      } else {
        prefixes.clear();
        prefix_iterate_to_vec(root, &prefixes, &ts_arena);
        if (prefixes.size() > beam_size) {
          sort_prefixes(true);
          for (size_t i = beam_size; i < prefixes.size(); ++i)
            prefix_remove(prefixes[i], &arena);
          prefixes.resize(beam_size);
          beam_sorted = true;
        } else {
          beam_sorted = false;
        }
      }
      ++abs_time_step;
    }
  }

  void next_pruned(const int* indices, const float* logps, const int* counts,
                   const float* blank_probs, int time_dim, int k) {
    std::vector<std::pair<int, double>> emissions;
    for (int t = 0; t < time_dim; ++t) {
      int n = counts[t];
      if (n > k) n = k;
      emissions.clear();
      emissions.reserve(n);
      for (int i = 0; i < n; ++i) {
        emissions.emplace_back(indices[t * k + i],
                               static_cast<double>(logps[t * k + i]));
      }
      step(emissions, static_cast<double>(blank_probs[t]));
    }
  }

  struct Output {
    std::vector<int> tokens;
    std::vector<int> timesteps;
    double confidence;
  };

  std::vector<Output> decode(size_t num_results) {
    std::vector<Prefix*> candidates = prefixes;
    std::unordered_map<const Prefix*, double> scores;
    for (Prefix* p : candidates) scores[p] = p->score;
    if (scorer) {
      for (size_t i = 0; i < beam_size && i < candidates.size(); ++i) {
        Prefix* prefix = candidates[i];
        Prefix* boundary = scorer->utf8_mode ? prefix : prefix->parent;
        if (boundary && !is_scoring_boundary(boundary, prefix->character)) {
          auto ngram = make_ngram(prefix);
          bool bos = ngram.size() < static_cast<size_t>(scorer->lm.order);
          scores[prefix] += scorer->cond_prob(ngram, bos) * alpha + beta;
        }
      }
    }
    std::sort(candidates.begin(), candidates.end(),
              [&](const Prefix* a, const Prefix* b) {
                if (scores[a] == scores[b]) return a->character < b->character;
                return scores[a] > scores[b];
              });
    std::vector<Output> outputs;
    size_t n = std::min(candidates.size(), num_results);
    for (size_t i = 0; i < n; ++i) {
      Prefix* p = candidates[i];
      Output out;
      out.confidence = scores[p];
      for (Prefix* node = p; node->parent; node = node->parent)
        out.tokens.push_back(node->character);
      std::reverse(out.tokens.begin(), out.tokens.end());
      for (TimestepNode* t = p->timesteps; t && t->parent; t = t->parent)
        out.timesteps.push_back(t->data);
      std::reverse(out.timesteps.begin(), out.timesteps.end());
      outputs.push_back(std::move(out));
    }
    return outputs;
  }
};

}  // namespace

// ------------------------------------------------------------------ C ABI
extern "C" {

void* decoder_create(const char* labels_blob, int n_labels, int space_index,
                     int beam_size, double cutoff_prob, int cutoff_top_n) {
  Decoder* d = new Decoder();
  // labels_blob: n_labels entries of (uint16 len, bytes)
  const uint8_t* p = reinterpret_cast<const uint8_t*>(labels_blob);
  for (int i = 0; i < n_labels; ++i) {
    uint16_t len;
    std::memcpy(&len, p, 2);
    p += 2;
    d->labels.emplace_back(reinterpret_cast<const char*>(p), len);
    p += len;
    if (d->labels.back() == " ") d->space_id = i;
  }
  d->blank_id = n_labels;
  d->beam_size = beam_size;
  d->cutoff_prob = cutoff_prob;
  d->cutoff_top_n = cutoff_top_n;
  d->init();
  return d;
}

int decoder_enable_scorer(void* handle, const char* scorer_path, double alpha,
                          double beta) {
  Decoder* d = static_cast<Decoder*>(handle);
  auto scorer = std::make_shared<Scorer>();
  std::string err;
  if (!scorer->load(scorer_path, &err)) return 1;
  d->attach_scorer(std::move(scorer));
  if (!std::isnan(alpha)) d->alpha = alpha;
  if (!std::isnan(beta)) d->beta = beta;
  return 0;
}

// Load a scorer package once and share it (read-only) across decoder
// instances — the reference reloads the package per Scorer object; a
// batch fan-out here attaches one parsed copy N times instead of
// re-reading the file per utterance. Returns NULL on failure.
void* scorer_create(const char* scorer_path) {
  auto scorer = std::make_shared<Scorer>();
  std::string err;
  if (!scorer->load(scorer_path, &err)) return nullptr;
  return new std::shared_ptr<Scorer>(std::move(scorer));
}

void scorer_free(void* scorer_handle) {
  delete static_cast<std::shared_ptr<Scorer>*>(scorer_handle);
}

void decoder_attach_scorer(void* handle, void* scorer_handle, double alpha,
                           double beta) {
  Decoder* d = static_cast<Decoder*>(handle);
  d->attach_scorer(*static_cast<std::shared_ptr<Scorer>*>(scorer_handle));
  if (!std::isnan(alpha)) d->alpha = alpha;
  if (!std::isnan(beta)) d->beta = beta;
}

void decoder_set_alpha_beta(void* handle, double alpha, double beta) {
  Decoder* d = static_cast<Decoder*>(handle);
  d->alpha = alpha;
  d->beta = beta;
}

void decoder_add_hot_word(void* handle, const char* word, float boost) {
  Decoder* d = static_cast<Decoder*>(handle);
  d->hot_words[word] = boost;
  ++d->lm_gen;
}

void decoder_clear_hot_words(void* handle) {
  Decoder* d = static_cast<Decoder*>(handle);
  d->hot_words.clear();
  ++d->lm_gen;
}

void decoder_next(void* handle, const double* probs, int time_dim,
                  int class_dim) {
  static_cast<Decoder*>(handle)->next(probs, time_dim, class_dim);
}

// Device-pruned emissions: indices/logps are [time_dim, k] row-major,
// counts/blank_probs are [time_dim].
void decoder_next_pruned(void* handle, const int* indices, const float* logps,
                         const int* counts, const float* blank_probs,
                         int time_dim, int k) {
  static_cast<Decoder*>(handle)->next_pruned(indices, logps, counts,
                                             blank_probs, time_dim, k);
}

// Flattens up to num_results outputs. Returns number of results.
// out_lengths[i] = token count of result i; tokens/timesteps packed
// consecutively into out_tokens/out_timesteps (caller sizes max_tokens).
int decoder_decode(void* handle, int num_results, int* out_tokens,
                   int* out_timesteps, int* out_lengths,
                   double* out_confidences, int max_tokens) {
  Decoder* d = static_cast<Decoder*>(handle);
  auto outputs = d->decode(num_results);
  int pos = 0;
  int n = 0;
  for (auto& out : outputs) {
    if (pos + static_cast<int>(out.tokens.size()) > max_tokens) break;
    out_lengths[n] = static_cast<int>(out.tokens.size());
    out_confidences[n] = out.confidence;
    for (size_t i = 0; i < out.tokens.size(); ++i) {
      out_tokens[pos] = out.tokens[i];
      out_timesteps[pos] =
          i < out.timesteps.size() ? out.timesteps[i] : -1;
      ++pos;
    }
    ++n;
  }
  return n;
}

void decoder_reset(void* handle) { static_cast<Decoder*>(handle)->init(); }

void decoder_free(void* handle) { delete static_cast<Decoder*>(handle); }

// standalone scorer sanity check (early_training_checks surface)
int scorer_validate(const char* path) {
  Scorer s;
  std::string err;
  return s.load(path, &err) ? 0 : 1;
}
}
