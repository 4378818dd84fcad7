// Driver for the REFERENCE ctcdecode decoder library, used purely as an
// external test/bench oracle (the port's copy of tools/oracle_main.cpp).
// This file is original driver code; it links against the reference's own
// sources compiled out-of-tree into build/ctcdecode_oracle/ (see
// stt_tpu_torch/tools/reference_decoder_oracle.py) — nothing from the reference is
// copied into this repository. The API exercised is
// /root/reference/native_client/ctcdecode/ctc_beam_search_decoder.h:54-84
// (DecoderState init/next/decode) and scorer.h:40-67.
//
// Protocol:
//   oracle --alphabet PATH [--utf8] [--scorer PATH --alpha A --beta B]
//          [--beam N] [--cutoff_prob P] [--cutoff_top_n N]
//          [--num_results N] [--hot word=boost]... [--reps N] [--chunk N]
//          --classes C  probs1.f64:T1 [probs2.f64:T2 ...]
// Each probs file is raw little-endian float64, row-major [T, C]
// (post-softmax probabilities, blank last). Output: one JSON object with
// per-utterance results (confidence/tokens/timesteps) and the wall time
// of the decode loop (file IO and scorer load excluded).

#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <memory>
#include <stdexcept>
#include <string>
#include <unordered_map>
#include <vector>

#include "ctc_beam_search_decoder.h"
#include "alphabet.h"
#include "scorer.h"
#include "flashlight/lib/text/dictionary/Dictionary.h"

namespace {

struct Utt {
  std::vector<double> probs;
  int t;
};

std::vector<double> read_f64(const std::string &path, size_t n) {
  std::ifstream in(path, std::ios::binary);
  if (!in) {
    fprintf(stderr, "cannot open %s\n", path.c_str());
    exit(2);
  }
  std::vector<double> out(n);
  in.read(reinterpret_cast<char *>(out.data()), n * sizeof(double));
  if (static_cast<size_t>(in.gcount()) != n * sizeof(double)) {
    fprintf(stderr, "short read on %s\n", path.c_str());
    exit(2);
  }
  return out;
}

void print_output_json(const Output &o, std::string *buf) {
  char tmp[64];
  snprintf(tmp, sizeof(tmp), "{\"confidence\":%.17g,\"tokens\":[", o.confidence);
  *buf += tmp;
  for (size_t i = 0; i < o.tokens.size(); ++i) {
    snprintf(tmp, sizeof(tmp), i ? ",%u" : "%u", o.tokens[i]);
    *buf += tmp;
  }
  *buf += "],\"timesteps\":[";
  for (size_t i = 0; i < o.timesteps.size(); ++i) {
    snprintf(tmp, sizeof(tmp), i ? ",%u" : "%u", o.timesteps[i]);
    *buf += tmp;
  }
  *buf += "]}";
}

}  // namespace

int main(int argc, char **argv) {
  std::string alphabet_path, scorer_path;
  bool utf8 = false;
  double alpha = 0.0, beta = 0.0, cutoff_prob = 1.0;
  size_t beam = 500, cutoff_top_n = 40, num_results = 1;
  int reps = 1, chunk = 0, classes = 0;
  bool flashlight = false, fl_log_add = false;
  double fl_beam_threshold = 25.0, fl_sil_score = 0.0;
  std::unordered_map<std::string, float> hot_words;
  std::vector<std::pair<std::string, int>> utt_specs;

  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&]() -> std::string {
      if (i + 1 >= argc) {
        fprintf(stderr, "missing value for %s\n", a.c_str());
        exit(2);
      }
      return argv[++i];
    };
    if (a == "--alphabet") alphabet_path = next();
    else if (a == "--utf8") utf8 = true;
    else if (a == "--scorer") scorer_path = next();
    else if (a == "--alpha") alpha = atof(next().c_str());
    else if (a == "--beta") beta = atof(next().c_str());
    else if (a == "--beam") beam = atoi(next().c_str());
    else if (a == "--cutoff_prob") cutoff_prob = atof(next().c_str());
    else if (a == "--cutoff_top_n") cutoff_top_n = atoi(next().c_str());
    else if (a == "--num_results") num_results = atoi(next().c_str());
    else if (a == "--reps") reps = atoi(next().c_str());
    else if (a == "--chunk") chunk = atoi(next().c_str());
    else if (a == "--classes") classes = atoi(next().c_str());
    else if (a == "--flashlight") flashlight = true;
    else if (a == "--fl_beam_threshold")
      fl_beam_threshold = atof(next().c_str());
    else if (a == "--fl_sil_score") fl_sil_score = atof(next().c_str());
    else if (a == "--fl_log_add") fl_log_add = true;
    else if (a == "--hot") {
      std::string kv = next();
      size_t eq = kv.rfind('=');
      hot_words[kv.substr(0, eq)] = atof(kv.substr(eq + 1).c_str());
    } else {
      size_t colon = a.rfind(':');
      utt_specs.emplace_back(a.substr(0, colon),
                             atoi(a.substr(colon + 1).c_str()));
    }
  }
  if (classes <= 0 || utt_specs.empty()) {
    fprintf(stderr, "usage: oracle --alphabet A --classes C probs.f64:T...\n");
    return 2;
  }

  UTF8Alphabet utf8_alphabet;
  Alphabet text_alphabet;
  Alphabet *alphabet = nullptr;
  if (utf8) {
    alphabet = &utf8_alphabet;
  } else {
    if (text_alphabet.init(alphabet_path.c_str()) != 0) {
      fprintf(stderr, "alphabet init failed\n");
      return 2;
    }
    alphabet = &text_alphabet;
  }

  std::shared_ptr<Scorer> scorer;
  if (!scorer_path.empty()) {
    scorer = std::make_shared<Scorer>();
    if (scorer->init_from_filepath(scorer_path, *alphabet) != 0) {
      fprintf(stderr, "scorer init failed\n");
      return 2;
    }
    scorer->reset_params(alpha, beta);
  }

  std::vector<Utt> utts;
  double total_t = 0;
  for (auto &spec : utt_specs) {
    Utt u;
    u.t = spec.second;
    u.probs = read_f64(spec.first, static_cast<size_t>(u.t) * classes);
    total_t += u.t;
    utts.push_back(std::move(u));
  }

  if (flashlight) {
    // reference FlashlightDecoderState, lexicon-free + Single-token
    // (ctc_beam_search_decoder.cpp:395-505): lm_tokens = the AM units
    fl::lib::text::Dictionary lm_tokens;
    for (size_t i = 0; i < alphabet->GetSize(); ++i)
      lm_tokens.addEntry(alphabet->DecodeSingle(i));
    std::string out = "{\"utterances\":[";
    for (size_t ui = 0; ui < utts.size(); ++ui) {
      FlashlightDecoderState fstate;
      fstate.init(*alphabet, beam, fl_beam_threshold, cutoff_top_n,
                  scorer, FlashlightDecoderState::Single, lm_tokens,
                  FlashlightDecoderState::LexiconFree, fl_sil_score,
                  fl_log_add, FlashlightDecoderState::CTC, {});
      const Utt &u = utts[ui];
      int step = chunk > 0 ? chunk : u.t;
      for (int t0 = 0; t0 < u.t; t0 += step) {
        int n = std::min(step, u.t - t0);
        fstate.next(u.probs.data() + static_cast<size_t>(t0) * classes,
                    n, classes);
      }
      auto outs = fstate.decode(num_results);
      if (ui) out += ",";
      out += "{\"results\":[";
      char tmp2[256];
      auto fin = [](double v) {  // JSON has no inf/nan
        return std::isfinite(v) ? v : (v > 0 ? 1e308 : -1e308);
      };
      for (size_t ri = 0; ri < outs.size(); ++ri) {
        if (ri) out += ",";
        snprintf(tmp2, sizeof(tmp2),
                 "{\"score\":%.17g,\"am_score\":%.17g,\"lm_score\":%.17g,"
                 "\"tokens\":[",
                 fin(outs[ri].aggregate_score),
                 fin(outs[ri].acoustic_model_score),
                 fin(outs[ri].language_model_score));
        out += tmp2;
        for (size_t i = 0; i < outs[ri].tokens.size(); ++i) {
          snprintf(tmp2, sizeof(tmp2), i ? ",%d" : "%d",
                   outs[ri].tokens[i]);
          out += tmp2;
        }
        out += "],\"words\":[";
        for (size_t i = 0; i < outs[ri].words.size(); ++i) {
          if (i) out += ",";
          out += "\"";
          for (unsigned char c : outs[ri].words[i]) {
            if (c == '"' || c == '\\') {
              out += '\\';
              out += static_cast<char>(c);
            } else if (c < 0x20 || c >= 0x7f) {
              snprintf(tmp2, sizeof(tmp2), "\\u%04x", c);
              out += tmp2;
            } else {
              out += static_cast<char>(c);
            }
          }
          out += "\"";
        }
        out += "]}";
      }
      out += "]}";
    }
    out += "]}\n";
    fwrite(out.data(), 1, out.size(), stdout);
    return 0;
  }

  std::vector<std::vector<Output>> results(utts.size());
  auto start = std::chrono::steady_clock::now();
  for (int r = 0; r < reps; ++r) {
    for (size_t ui = 0; ui < utts.size(); ++ui) {
      DecoderState state;
      state.init(*alphabet, beam, cutoff_prob, cutoff_top_n, scorer,
                 hot_words);
      const Utt &u = utts[ui];
      int step = chunk > 0 ? chunk : u.t;
      for (int t0 = 0; t0 < u.t; t0 += step) {
        int n = std::min(step, u.t - t0);
        state.next(u.probs.data() + static_cast<size_t>(t0) * classes, n,
                   classes);
      }
      results[ui] = state.decode(num_results);
    }
  }
  auto end = std::chrono::steady_clock::now();
  double elapsed = std::chrono::duration<double>(end - start).count();

  std::string out = "{\"elapsed\":";
  char tmp[64];
  snprintf(tmp, sizeof(tmp), "%.6f", elapsed);
  out += tmp;
  snprintf(tmp, sizeof(tmp), ",\"reps\":%d,\"total_timesteps\":%.0f", reps,
           total_t);
  out += tmp;
  out += ",\"utterances\":[";
  for (size_t ui = 0; ui < results.size(); ++ui) {
    if (ui) out += ",";
    out += "{\"results\":[";
    for (size_t ri = 0; ri < results[ui].size(); ++ri) {
      if (ri) out += ",";
      print_output_json(results[ui][ri], &out);
    }
    out += "],\"transcripts\":[";
    for (size_t ri = 0; ri < results[ui].size(); ++ri) {
      if (ri) out += ",";
      out += "\"";
      std::string text = alphabet->Decode(results[ui][ri].tokens);
      for (unsigned char c : text) {
        if (c == '"' || c == '\\') {
          out += '\\';
          out += static_cast<char>(c);
        } else if (c < 0x20 || c >= 0x7f) {
          // bytes-mode output need not be valid UTF-8; keep JSON clean
          snprintf(tmp, sizeof(tmp), "\\u%04x", c);
          out += tmp;
        } else {
          out += static_cast<char>(c);
        }
      }
      out += "\"";
    }
    out += "]}";
  }
  out += "]}\n";
  fwrite(out.data(), 1, out.size(), stdout);
  return 0;
}
