"""Multilingual LibriSpeech (MLS) importer (counterpart of
bin/import_mls.py).

Layout: mls_<language>[_opus]/{train,dev,test}/ each with
audio/<speaker>/<book>/<id>.{flac,opus} and transcripts.txt
("<id>\\t<transcript>"). Both releases convert to 16 kHz wav: FLAC via
the in-tree decoder, Opus via the system libopus (falling back to
container-probed rows with a warning when libopus is absent).

Writes mls_<language>_{train,dev,test}.csv beside the corpus.
"""

from __future__ import annotations

import argparse
import os

SAMPLE_RATE = 16000
LANGUAGES = (
    "english", "german", "french", "dutch", "spanish", "italian",
    "portuguese", "polish",
)


def import_split(split_dir: str, wav_dir: str):
    from stt_tpu_torch.data.audio import read_audio, write_wav
    from stt_tpu_torch.data.ogg import probe_ogg_file

    rows = []
    opus_count = 0
    trans = os.path.join(split_dir, "transcripts.txt")
    with open(trans, encoding="utf-8") as f:
        for line in f:
            seqid, _, transcript = line.strip().partition("\t")
            spk, book, _ = seqid.split("_", 2)
            base = os.path.join(split_dir, "audio", spk, book, seqid)
            transcript = transcript.strip()
            if os.path.isfile(base + ".flac"):
                out = os.path.join(wav_dir, spk, book)
                os.makedirs(out, exist_ok=True)
                wav = os.path.join(out, seqid + ".wav")
                if not os.path.isfile(wav):
                    audio, _ = read_audio(
                        base + ".flac", desired_rate=SAMPLE_RATE
                    )
                    write_wav(wav, audio, SAMPLE_RATE)
                rows.append((wav, os.path.getsize(wav), transcript))
            elif os.path.isfile(base + ".opus"):
                from stt_tpu_torch.data.opus import opus_available

                if opus_available():
                    out = os.path.join(wav_dir, spk, book)
                    os.makedirs(out, exist_ok=True)
                    wav = os.path.join(out, seqid + ".wav")
                    if not os.path.isfile(wav):
                        audio, _ = read_audio(
                            base + ".opus", desired_rate=SAMPLE_RATE
                        )
                        write_wav(wav, audio, SAMPLE_RATE)
                    rows.append((wav, os.path.getsize(wav), transcript))
                else:
                    opus_count += 1
                    probe_ogg_file(base + ".opus")  # validates the container
                    rows.append(
                        (base + ".opus", os.path.getsize(base + ".opus"),
                         transcript)
                    )
            else:
                print(f"Warning: missing audio for {seqid}")
    if opus_count:
        print(
            f"Warning: {opus_count} rows reference .opus files — libopus "
            "is unavailable, so they were probed but not converted; "
            "training needs wavs."
        )
    return rows


def import_language(corpus_dir: str, language: str):
    from stt_tpu_torch.tools.importers import write_samples_csv

    csvs = []
    for split in ("train", "dev", "test"):
        split_dir = os.path.join(corpus_dir, split)
        if not os.path.isdir(split_dir):
            print(f"Skipping {split}: {split_dir} not found")
            continue
        rows = import_split(split_dir, os.path.join(split_dir, "audio-wav"))
        csv_path = os.path.join(corpus_dir, f"mls_{language}_{split}.csv")
        write_samples_csv(csv_path, rows)
        csvs.append(csv_path)
    return csvs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "corpus_dir", help="extracted mls_<language> directory"
    )
    parser.add_argument("--language", choices=LANGUAGES, default="english")
    args = parser.parse_args(argv)
    import_language(args.corpus_dir, args.language)


if __name__ == "__main__":
    main()
