// Profiling driver for the native decoder hot loop (gprof; not part of
// the library build). Synthesizes speechlike blank-dominated emissions
// (the same distribution bench.py uses) and decodes them repeatedly.
//
// stt_tpu_torch.native_build.build_prof_decoder() builds it with
// `g++ -O2 -pg -std=c++17` into build/native/prof_decoder. It writes
// gmon.out into its working directory, so run it from a scratch one:
//   cd scratch && prof_decoder [scorer] && gprof prof_decoder gmon.out
#include "ctc_decoder.cpp"

#include <cstdio>
#include <random>

int main(int argc, char** argv) {
  const char* scorer_path = argc > 1 ? argv[1] : nullptr;
  int n_labels = 28;  // english alphabet.txt
  int frames = 500, reps = 10;
  int C = n_labels + 1;

  // labels blob: a..z, ', space  (space at index 0 in the reference
  // alphabet.txt ordering: " abcdefghijklmnopqrstuvwxyz'")
  std::string blob;
  const char* labels = " abcdefghijklmnopqrstuvwxyz'";
  for (int i = 0; i < n_labels; ++i) {
    uint16_t len = 1;
    blob.append(reinterpret_cast<const char*>(&len), 2);
    blob.push_back(labels[i]);
  }

  std::mt19937 rng(0);
  std::uniform_int_distribution<int> step_d(2, 5), char_d(0, n_labels - 1);
  std::uniform_real_distribution<double> dom_d(0.5, 0.95);
  std::vector<float> logp(frames * C);
  std::vector<int> idx(frames * C);
  std::vector<int> cnt(frames, C);
  std::vector<float> blank(frames);
  {
    std::vector<double> probs(frames * C);
    for (int t = 0; t < frames; ++t) {
      for (int c = 0; c < C; ++c) probs[t * C + c] = 1e-4;
      probs[t * C + C - 1] = 1.0;
    }
    int t = 0;
    while (t < frames) {
      t += step_d(rng);
      if (t >= frames) break;
      int c = char_d(rng);
      double dom = dom_d(rng);
      probs[t * C + C - 1] = 1.0 - dom;
      probs[t * C + c] = dom;
      int c2 = char_d(rng);
      probs[t * C + c2] += (1.0 - dom) * 0.5;
    }
    for (int tt = 0; tt < frames; ++tt) {
      double s = 0;
      for (int c = 0; c < C; ++c) s += probs[tt * C + c];
      for (int c = 0; c < C; ++c) {
        double p = probs[tt * C + c] / s;
        idx[tt * C + c] = c;
        logp[tt * C + c] = std::log(p + kFltMin);
      }
      blank[tt] = probs[tt * C + C - 1] / s;
    }
  }

  void* d = decoder_create(blob.data(), n_labels, 0, 500, 1.0, 40);
  if (scorer_path) {
    double nan = std::nan("");
    if (decoder_enable_scorer(d, scorer_path, nan, nan)) {
      std::fprintf(stderr, "scorer load failed\n");
      return 1;
    }
  }
  for (int r = 0; r < reps; ++r) {
    decoder_reset(d);
    decoder_next_pruned(d, idx.data(), logp.data(), cnt.data(), blank.data(),
                        frames, C);
    std::vector<int> toks(65536), steps(65536), lens(1);
    std::vector<double> conf(1);
    decoder_decode(d, 1, toks.data(), steps.data(), lens.data(), conf.data(),
                   65536);
    if (r == 0) {
      std::string s;
      for (int i = 0; i < lens[0]; ++i) s += labels[toks[i]];
      std::fprintf(stderr, "transcript[%d]: %s\n", lens[0], s.c_str());
    }
  }
  decoder_free(d);
  return 0;
}
