"""`stt` command-line client: one-shot, streaming, and JSON word-timing modes.

The counterpart of `stt_tpu.client` (native_client/client.cc:483-635 and
native_client/python/client.py): load an exported artifact and transcribe
a WAV (or every WAV in a directory) on the card, in one of four output
modes:

  default      plain transcript on stdout
  --extended   top candidate with per-token timings
  --json       JSON document: word timings + confidence, alternatives
               (word grouping mirrors client.cc CandidateTranscriptToWords
               :64-106 — duration = last_token.start - first_token.start)
  --stream N   feed N-millisecond chunks, print intermediate decodes

Usage:
  python -m stt_tpu_torch.client --model export/ --audio a.wav

--scorer decodes with a .scorer package (--lm_alpha and --lm_beta, both
given, replace its alpha and beta); --hot_words takes word:boost,... .
--device cpu runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List


def words_from_candidate_transcript(transcript) -> List[dict]:
    """Group token metadata into word dicts with start/duration.

    Mirrors the reference word-boundary rules (client.cc:64-106): a word
    ends at a space token or the final token; duration is the start-time
    span between the word's first and last token, floored at zero.
    """
    words = []
    word = ""
    word_start = 0.0
    for i, token in enumerate(transcript.tokens):
        if token.text != " ":
            if not word:
                word_start = token.start_time
            word += token.text
        if token.text == " " or i == len(transcript.tokens) - 1:
            duration = max(token.start_time - word_start, 0.0)
            words.append(
                {
                    "word": word,
                    "start_time": round(word_start, 4),
                    "duration": round(duration, 4),
                }
            )
            word = ""
            word_start = 0.0
    return words


def metadata_to_json(metadata) -> str:
    res = {
        "transcripts": [
            {
                "confidence": t.confidence,
                "words": words_from_candidate_transcript(t),
            }
            for t in metadata.transcripts
        ]
    }
    return json.dumps(res, indent=2)


def metadata_to_extended(transcript) -> str:
    lines = [f"confidence {transcript.confidence:.4f}"]
    for token in transcript.tokens:
        lines.append(
            f"  {token.start_time:7.3f}s  step {token.timestep:5d}  "
            f"{token.text!r}"
        )
    return "\n".join(lines)


def parse_hot_words(spec: str):
    """Parse the reference's ``word:boost,word:boost`` syntax."""
    pairs = []
    for item in spec.split(","):
        if not item:
            continue
        word, _, boost = item.rpartition(":")
        if not word:
            raise ValueError(f"bad hot-word entry {item!r}, want word:boost")
        pairs.append((word, float(boost)))
    return pairs


AUDIO_EXTENSIONS = (".wav", ".flac")


def resolve_audio_paths(audio: str) -> List[str]:
    if os.path.isdir(audio):
        found = sorted(
            os.path.join(audio, name)
            for name in os.listdir(audio)
            if name.lower().endswith(AUDIO_EXTENSIONS)
        )
        if not found:
            raise FileNotFoundError(f"no audio files under {audio}")
        return found
    return [audio]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Run stt_tpu_torch inference on audio files"
    )
    parser.add_argument("--model", required=True, help="exported artifact path")
    parser.add_argument("--scorer", help="external scorer package (.scorer)")
    parser.add_argument(
        "--audio", required=True, help="audio file (or directory of files)"
    )
    parser.add_argument("--beam_width", type=int, help="CTC decoder beam width")
    parser.add_argument("--lm_alpha", type=float, help="LM weight (needs --scorer)")
    parser.add_argument("--lm_beta", type=float, help="word bonus (needs --scorer)")
    parser.add_argument(
        "--hot_words", help="comma-separated word:boost hot-word list"
    )
    parser.add_argument(
        "--candidate_transcripts", type=int, default=3,
        help="number of alternatives in --json output",
    )
    parser.add_argument(
        "--json", action="store_true", help="emit JSON with word timings"
    )
    parser.add_argument(
        "--extended", action="store_true", help="per-token timing output"
    )
    parser.add_argument(
        "--stream", type=int, metavar="MS", default=0,
        help="streaming mode: feed MS-millisecond chunks, print intermediates",
    )
    parser.add_argument(
        "-t", "--time", action="store_true", dest="show_time",
        help="print inference wall time and real-time factor",
    )
    parser.add_argument(
        "--device", default="cuda", help="torch device to run on (default cuda)"
    )
    parser.add_argument("--version", action="store_true", help="print version")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.version:
        from stt_tpu_torch import __version__

        print(f"stt_tpu_torch {__version__}")
        return 0
    from stt_tpu_torch.data.audio import read_audio
    from stt_tpu_torch.serve import Model

    model = Model(args.model, device=args.device)
    if args.beam_width:
        model.set_model_beam_width(args.beam_width)
    if args.scorer:
        model.enable_external_scorer(args.scorer)
        if args.lm_alpha is not None and args.lm_beta is not None:
            model.set_scorer_alpha_beta(args.lm_alpha, args.lm_beta)
    elif args.lm_alpha is not None or args.lm_beta is not None:
        print("--lm_alpha/--lm_beta require --scorer", file=sys.stderr)
        return 2
    if args.hot_words:
        for word, boost in parse_hot_words(args.hot_words):
            model.add_hot_word(word, boost)

    rate = model.sample_rate()
    for path in resolve_audio_paths(args.audio):
        audio, _ = read_audio(path, desired_rate=rate)
        t0 = time.time()
        if args.stream:
            chunk = max(int(args.stream * rate / 1000), 1)
            stream = model.create_stream()
            last = ""
            for off in range(0, len(audio), chunk):
                stream.feed_audio_content(audio[off : off + chunk])
                text = stream.intermediate_decode()
                if text != last:
                    print(text, flush=True)
                    last = text
            final = stream.finish_stream()
            print(final)
        elif args.json:
            metadata = model.stt_with_metadata(
                audio, args.candidate_transcripts
            )
            print(metadata_to_json(metadata))
        elif args.extended:
            metadata = model.stt_with_metadata(audio, 1)
            print(metadata.transcripts[0].transcript)
            print(metadata_to_extended(metadata.transcripts[0]), file=sys.stderr)
        else:
            print(model.stt(audio))
        if args.show_time:
            wall = time.time() - t0
            audio_s = len(audio) / rate
            print(
                f"took {wall:.3f}s for {audio_s:.3f}s audio "
                f"(RTF {wall / max(audio_s, 1e-9):.3f})",
                file=sys.stderr,
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
