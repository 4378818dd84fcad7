"""Primewords Chinese corpus set 1 importer (counterpart of
bin/import_primewords.py).

Layout: primewords_md_2018_set1/ with audio_files/*/*/*.wav and
set1_transcript.json ([{"file": ..., "text": ...}, ...]). Deterministic
5000/5000 dev/test split (seed 12345); train trimmed at 15 s.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from stt_tpu_torch.tools.importers import (
    deterministic_split,
    extract_archive,
    trim_longer_than,
    write_samples_csv,
)


def preprocess_data(tgz_file: str, target_dir: str,
                    n_dev: int = 5000, n_test: int = 5000):
    main_folder = os.path.join(target_dir, "primewords_md_2018_set1")
    extract_archive(tgz_file, target_dir, expected_dir=main_folder)

    with open(
        os.path.join(main_folder, "set1_transcript.json"), encoding="utf-8"
    ) as f:
        transcripts = {e["file"]: e["text"] for e in json.load(f)}

    rows = []
    pattern = os.path.join(main_folder, "audio_files", "*", "*", "*.wav")
    for wav in sorted(glob.glob(pattern)):
        key = os.path.basename(wav)
        if key not in transcripts:
            print(f"Warning: Missing transcript for WAV file {wav}.")
            continue
        rows.append((wav, os.path.getsize(wav), transcripts[key].strip()))

    train, dev, test = deterministic_split(rows, n_dev, n_test)
    train = trim_longer_than(train, 15.0)
    csvs = []
    for subset, subset_rows in (("train", train), ("dev", dev), ("test", test)):
        csv_path = os.path.join(target_dir, f"primewords_{subset}.csv")
        write_samples_csv(csv_path, subset_rows)
        csvs.append(csv_path)
    return csvs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("tgz_file", help="Path to primewords_md_2018_set1.tar.gz")
    parser.add_argument("--target_dir", default="")
    args = parser.parse_args(argv)
    target = args.target_dir or os.path.dirname(args.tgz_file)
    preprocess_data(args.tgz_file, target)


if __name__ == "__main__":
    main()
