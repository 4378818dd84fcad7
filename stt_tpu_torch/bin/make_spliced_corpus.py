"""Synthesize a multi-utterance training corpus from the smoke data (the
port of bin/make_spliced_corpus.py).

The smoke data hold exactly one labeled English utterance (LDC93S1). To
get a corpus with real transcript diversity for the flagship-geometry
endurance run (stt_tpu_torch/bin/run-flagship-endurance.sh), this script:

1. decodes LDC93S1 with a trained smoke checkpoint and uses the beam
   decoder's per-token TIMESTEPS as a forced alignment (CTC peaks);
2. cuts the audio into per-word clips at the aligned boundaries;
3. splices random word sequences into new utterances whose transcripts
   are exact by construction, writes wavs + train/dev CSVs.

Offline augmentation (volume/reverb/resample/overlay with the russian
smoke clip as interference) is applied afterwards by
stt_tpu_torch.tools.data_set_tool.

The one difference from stt_tpu's script: the smoke utterance's path
defaults to the reference's (SMOKE_WAV) and can be given with
--smoke_wav, so the script runs where the reference is not mounted. The
model runs on --device (default cuda).

Run: python stt_tpu_torch/bin/make_spliced_corpus.py --checkpoint_dir ckpt \
       --out_dir corpus [--n_train 288] [--n_dev 32] [--smoke_wav LDC93S1.wav]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from stt_tpu_torch.config import initialize_globals_from_cli  # noqa: E402
from stt_tpu_torch.data.audio import read_wav, resample, write_wav  # noqa: E402
from stt_tpu_torch.decode import ctc_beam_search_decoder  # noqa: E402
from stt_tpu_torch.device import resolve_device  # noqa: E402
from stt_tpu_torch.frontend import audio_to_mfcc_numpy  # noqa: E402
from stt_tpu_torch.train.checkpoints import (  # noqa: E402
    CheckpointManager,
    load_graph_for_evaluation,
)
from stt_tpu_torch.train.step import create_train_state  # noqa: E402

SMOKE_WAV = "/root/reference/data/smoke_test/LDC93S1.wav"
TRANSCRIPT = "she had your dark suit in greasy wash water all year"


def align_words(config, audio, device="cuda"):
    """Per-word (start_sample, end_sample) from beam-decode timesteps."""
    device = resolve_device(device)
    alphabet = config.resolve_alphabet()
    model_config = config.model_config(training=False)
    template = create_train_state(
        model_config, device=device, learning_rate=config.learning_rate,
        beta1=config.beta1, beta2=config.beta2, epsilon=config.epsilon,
    )
    manager = CheckpointManager(config.load_checkpoint_dir)
    state, _ = load_graph_for_evaluation(manager, template, "best")
    feats = audio_to_mfcc_numpy(audio, config.feature_config)[None]
    lengths = np.asarray([feats.shape[1]], np.int32)
    with torch.no_grad():
        logits, _ = state.model(
            torch.from_numpy(feats).to(device), seq_len=torch.from_numpy(lengths).to(device)
        )
        probs = torch.softmax(logits[0], dim=-1).cpu().numpy()
    [res] = ctc_beam_search_decoder(probs, alphabet, beam_size=64)
    assert res.transcript == TRANSCRIPT, res.transcript
    step = config.feature_config.step_samples
    win = config.feature_config.window_samples
    words, spans = [], []
    word, start_t, last_t = "", None, None
    for tok, t in zip(res.tokens, res.timesteps):
        ch = alphabet.labels[tok]
        if ch == " ":
            words.append(word)
            spans.append((start_t, last_t))
            word, start_t = "", None
            continue
        if start_t is None:
            start_t = t
        last_t = t
        word += ch
    words.append(word)
    spans.append((start_t, last_t))
    assert " ".join(words) == TRANSCRIPT
    clips = {}
    for i, (w, (a, b)) in enumerate(zip(words, spans)):
        # CTC emission peaks lag acoustics slightly; pad one frame left
        # and two right, clamp to neighbors' starts to avoid overlap
        lo = max(0, (a - 1) * step)
        hi = min(len(audio), (b + 2) * step + win)
        if i + 1 < len(spans):
            hi = min(hi, max(lo + step, (spans[i + 1][0] - 1) * step))
        clips.setdefault(w, audio[lo:hi])
    return words, clips


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--n_train", type=int, default=288)
    ap.add_argument("--n_dev", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--train_speakers", default="1.0",
        help="comma-separated speed-perturbation factors for train "
             "utterances ('synthetic speakers': vocal-tract + rate "
             "scaling via resampling, the classic speed-perturb recipe)",
    )
    ap.add_argument(
        "--dev_speakers", default="1.0",
        help="factors for dev — DISJOINT from --train_speakers makes "
             "the dev set acoustically unseen voices",
    )
    ap.add_argument("--smoke_wav", default=SMOKE_WAV,
                    help="the labeled smoke utterance (default: the reference's)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the alignment model (default cuda)")
    args, rest = ap.parse_known_args(argv)
    config = initialize_globals_from_cli(rest, device=args.device)
    smoke_wav = args.smoke_wav

    audio, rate = read_wav(smoke_wav)
    words, clips = align_words(config, audio, args.device)
    print("aligned words:", {w: len(c) / rate for w, c in clips.items()})

    rng = np.random.RandomState(args.seed)
    os.makedirs(os.path.join(args.out_dir, "wav"), exist_ok=True)
    gap = np.zeros(int(0.06 * rate), np.float32)
    lead = np.zeros(int(0.15 * rate), np.float32)

    def synth(name, n, speakers, include_original=False):
        factors = [float(x) for x in speakers.split(",") if x]
        path = os.path.join(args.out_dir, f"{name}.csv")
        with open(path, "w", encoding="utf-8") as f:
            f.write("wav_filename,wav_filesize,transcript\n")
            if include_original:
                f.write(f"{smoke_wav},93638,{TRANSCRIPT}\n")
            for i in range(n):
                k = rng.randint(4, 10)
                seq = [words[j] for j in rng.randint(0, len(words), k)]
                pieces = [lead]
                for w in seq:
                    pieces.append(clips[w])
                    pieces.append(gap)
                wav = np.concatenate(pieces)
                factor = factors[int(rng.randint(len(factors)))]
                if factor != 1.0:
                    # "synthetic speaker": resampling by `factor` scales
                    # pitch AND rate together (Kaldi-style speed perturb)
                    wav = resample(wav, int(rate * factor), rate)
                out = os.path.join(
                    args.out_dir, "wav", f"{name}_{i:04d}.wav"
                )
                write_wav(out, wav, rate)
                size = os.path.getsize(out)
                f.write(f"{out},{size},{' '.join(seq)}\n")
        return path

    train_csv = synth(
        "train", args.n_train, args.train_speakers, include_original=True
    )
    dev_csv = synth("dev", args.n_dev, args.dev_speakers)
    print("wrote", train_csv, "and", dev_csv)


if __name__ == "__main__":
    main()
