// Sanitizer smoke harness for the native decoder library (the
// counterpart of the reference's valgrind memcheck workflow, ds_*.supp
// + parse_valgrind_suppressions.sh): exercises the full C ABI — decoder
// lifecycle, scorer load, hot words, streamed next/decode/reset — under
// ASan/UBSan. stt_tpu_torch.native_build.build_decoder_smoke() builds it
// with ctc_decoder.cpp into build/native/decoder_smoke_asan; run it with no
// argument, then with a .scorer path. Exit 0 + no sanitizer report = pass.

#include <cmath>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
void* decoder_create(const char* labels_blob, int n_labels, int space_index,
                     int beam_size, double cutoff_prob, int cutoff_top_n);
int decoder_enable_scorer(void* handle, const char* scorer_path, double alpha,
                          double beta);
void decoder_set_alpha_beta(void* handle, double alpha, double beta);
void decoder_add_hot_word(void* handle, const char* word, float boost);
void decoder_clear_hot_words(void* handle);
void decoder_next(void* handle, const double* probs, int time_dim,
                  int class_dim);
int decoder_decode(void* handle, int num_results, int* out_tokens,
                   int* out_timesteps, int* out_lengths,
                   double* out_confidences, int max_tokens);
void decoder_reset(void* handle);
void decoder_free(void* handle);
int scorer_validate(const char* path);
}

int main(int argc, char** argv) {
  const char* scorer_path = argc > 1 ? argv[1] : nullptr;

  // alphabet: space + a-z + apostrophe, packed as (uint16 len, bytes)
  // entries — the decoder_create blob contract
  std::string labels;
  auto add_label = [&labels](const char* s) {
    uint16_t len = (uint16_t)std::strlen(s);
    labels.append(reinterpret_cast<const char*>(&len), 2);
    labels.append(s, len);
  };
  add_label(" ");
  for (char c = 'a'; c <= 'z'; ++c) {
    char s[2] = {c, 0};
    add_label(s);
  }
  add_label("'");
  const int n_labels = 28;
  const int class_dim = n_labels + 1;  // + blank

  for (int round = 0; round < 3; ++round) {
    void* d = decoder_create(labels.c_str(), n_labels, 0, 64, 1.0, 40);
    if (!d) return 1;
    if (scorer_path) {
      if (scorer_validate(scorer_path) != 0) return 2;
      if (decoder_enable_scorer(d, scorer_path, 0.93, 1.18) != 0) return 3;
      decoder_set_alpha_beta(d, 0.5, 0.5);
    }
    decoder_add_hot_word(d, "dark", 2.5f);
    decoder_add_hot_word(d, "suit", -1.0f);

    // synthetic emissions spelling "hi you" with blanks between letters
    const char* text = "hi you";
    std::vector<double> probs;
    int t_total = 0;
    for (const char* p = text; *p; ++p) {
      int idx = *p == ' ' ? 0 : (*p - 'a' + 1);
      for (int step = 0; step < 2; ++step) {  // letter frame + blank frame
        std::vector<double> frame(class_dim, 1e-6);
        frame[step == 0 ? idx : n_labels] = 1.0;
        double sum = 0;
        for (double v : frame) sum += v;
        for (double& v : frame) v /= sum;
        probs.insert(probs.end(), frame.begin(), frame.end());
        ++t_total;
      }
      // feed in small chunks to exercise streamed state
      decoder_next(d, probs.data(), t_total, class_dim);
      probs.clear();
      t_total = 0;
    }

    int tokens[256], timesteps[256], lengths[8];
    double confidences[8];
    int n = decoder_decode(d, 4, tokens, timesteps, lengths, confidences, 256);
    if (n < 1) return 4;
    std::string best;
    for (int i = 0; i < lengths[0]; ++i) {
      int tok = tokens[i];
      best.push_back(tok == 0 ? ' ' : (tok <= 26 ? 'a' + tok - 1 : '\''));
    }
    std::printf("round %d: %d results, best \"%s\"\n", round, n, best.c_str());
    if (!scorer_path && best != "hi you") return 5;

    decoder_clear_hot_words(d);
    decoder_reset(d);
    decoder_free(d);
  }
  std::puts("decoder_smoke OK");
  return 0;
}
