"""African Accented French (OpenSLR SLR57) importer (counterpart of
bin/import_slr57.py).

Layout: African_Accented_French/ with speech/**/*.wav recordings and the
scattered transcript files the reference enumerates (yaounde fn_text,
ca16 conv/read, niger TSV, devtest conditioned, test prompts). Builds a
basename->transcript map, matches every wav under speech/, validates
labels, and writes slr57_{train,dev,test}.csv with a deterministic
90/5/5 split (the reference splits 80/10/10 in-line; counts are
parameterized here).
"""

from __future__ import annotations

import argparse
import glob
import os

from stt_tpu_torch.tools.importers import (
    deterministic_split,
    filter_sample,
    get_counter,
    get_validate_label,
    print_import_report,
    write_samples_csv,
)

SAMPLE_RATE = 16000
MAX_SECS = 15
ARCHIVE_DIR_NAME = "African_Accented_French"
TRANSCRIPT_FILES = (
    "transcripts/train/yaounde/fn_text.txt",
    "transcripts/train/ca16_conv/transcripts.txt",
    "transcripts/train/ca16_read/conditioned.txt",
    "transcripts/dev/niger_west_african_fr/transcripts.txt",
    "speech/dev/niger_west_african_fr/niger_wav_file_name_transcript.tsv",
    "transcripts/devtest/ca16_read/conditioned.txt",
    "transcripts/test/ca16/prompts.txt",
)


def load_transcripts(corpus_dir: str) -> dict:
    transcripts = {}
    for rel in TRANSCRIPT_FILES:
        path = os.path.join(corpus_dir, rel)
        if not os.path.isfile(path):
            continue
        sep = "\t" if rel.endswith(".tsv") else " "
        with open(path, encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                audio = os.path.basename(line.split(sep)[0])
                if ".wav" not in audio:
                    audio = audio.replace(".tdf", ".wav") if ".tdf" in audio \
                        else audio + ".wav"
                transcripts[audio] = " ".join(line.split(sep)[1:])
    return transcripts


def preprocess_data(target_dir: str, validate_label, dev_frac: float = 0.05,
                    test_frac: float = 0.05):
    corpus_dir = os.path.join(target_dir, ARCHIVE_DIR_NAME)
    transcripts = load_transcripts(corpus_dir)
    counter = get_counter()
    rows = []
    for wav in sorted(
        glob.glob(os.path.join(corpus_dir, "speech", "**", "*.wav"),
                  recursive=True)
    ):
        name = os.path.basename(wav)
        if name not in transcripts:
            continue
        label = validate_label(transcripts[name])
        row = filter_sample(wav, label, counter, MAX_SECS,
                            min_ms_per_char=15.0 / 2)
        if row:
            rows.append(row)
    print_import_report(counter, SAMPLE_RATE, MAX_SECS)

    n_dev = max(int(len(rows) * dev_frac), 1)
    n_test = max(int(len(rows) * test_frac), 1)
    train, dev, test = deterministic_split(rows, n_dev, n_test)
    csvs = []
    for subset, subset_rows in (("train", train), ("dev", dev), ("test", test)):
        csv_path = os.path.join(corpus_dir, f"slr57_{subset}.csv")
        write_samples_csv(csv_path, subset_rows)
        csvs.append(csv_path)
    return csvs


def main(argv=None):
    from stt_tpu_torch.tools.importers import get_importers_parser

    parser = get_importers_parser(description=__doc__)
    parser.add_argument("target_dir",
                        help=f"dir containing {ARCHIVE_DIR_NAME}/")
    args = parser.parse_args(argv)
    validate_label = get_validate_label(args)
    preprocess_data(args.target_dir, validate_label)


if __name__ == "__main__":
    main()
