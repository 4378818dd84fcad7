"""AISHELL-1 Mandarin corpus importer (counterpart of bin/import_aishell.py).

Layout: data_aishell.tgz containing wav/*.tar.gz per-speaker archives and
transcript/aishell_transcript_v0.8.txt ("<utt_id> <transcript>" lines).
Writes aishell_{train,dev,test}.csv; train rows longer than 10 s (by wav
filesize) are trimmed, matching the reference.
"""

from __future__ import annotations

import argparse
import glob
import os

from stt_tpu_torch.tools.importers import (
    extract_archive,
    trim_longer_than,
    write_samples_csv,
)


def preprocess_data(tgz_file: str, target_dir: str):
    main_folder = os.path.join(target_dir, "data_aishell")
    extract_archive(tgz_file, target_dir, expected_dir=main_folder)
    for targz in sorted(glob.glob(os.path.join(main_folder, "wav", "*.tar.gz"))):
        extract_archive(targz, main_folder)

    transcripts_path = os.path.join(
        main_folder, "transcript", "aishell_transcript_v0.8.txt"
    )
    with open(transcripts_path, encoding="utf-8") as f:
        transcripts = dict(line.split(" ", maxsplit=1) for line in f)

    csvs = []
    for subset in ("train", "dev", "test"):
        rows = []
        pattern = os.path.join(main_folder, subset, "S*", "*.wav")
        for wav in sorted(glob.glob(pattern)):
            key = os.path.splitext(os.path.basename(wav))[0]
            if key not in transcripts:
                print(f"Warning: Missing transcript for WAV file {wav}.")
                continue
            rows.append(
                (wav, os.path.getsize(wav), transcripts[key].strip("\n").strip())
            )
        if subset == "train":
            rows = trim_longer_than(rows, 10.0)
        csv_path = os.path.join(target_dir, f"aishell_{subset}.csv")
        write_samples_csv(csv_path, rows)
        csvs.append(csv_path)
    return csvs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("aishell_tgz_file", help="Path to data_aishell.tgz")
    parser.add_argument("--target_dir", default="")
    args = parser.parse_args(argv)
    target = args.target_dir or os.path.dirname(args.aishell_tgz_file)
    preprocess_data(args.aishell_tgz_file, target)


if __name__ == "__main__":
    main()
