"""aidatatang_200zh Mandarin corpus importer (counterpart of
bin/import_aidatatang.py).

Layout: aidatatang_200zh.tgz with corpus/{train,dev,test}/*.tar.gz
nested archives and transcript/aidatatang_200_zh_transcript.txt
("<utt_id> <transcript>"). Writes aidatatang_{train,dev,test}.csv with
the reference's 10 s train trim.
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
    main_folder = os.path.join(target_dir, "aidatatang_200zh")
    extract_archive(tgz_file, target_dir, expected_dir=main_folder)
    for targz in sorted(
        glob.glob(os.path.join(main_folder, "corpus", "*", "*.tar.gz"))
    ):
        extract_archive(targz, os.path.dirname(targz))

    transcripts_path = os.path.join(
        main_folder, "transcript", "aidatatang_200_zh_transcript.txt"
    )
    with open(transcripts_path, encoding="utf-8") as f:
        transcripts = dict(line.split(" ", maxsplit=1) for line in f)

    csvs = []
    for subset in ("train", "dev", "test"):
        rows = []
        pattern = os.path.join(main_folder, "corpus", subset, "*", "*.wav")
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
        csv_path = os.path.join(target_dir, f"aidatatang_{subset}.csv")
        write_samples_csv(csv_path, rows)
        csvs.append(csv_path)
    return csvs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("tgz_file", help="Path to aidatatang_200zh.tgz")
    parser.add_argument("--target_dir", default="")
    args = parser.parse_args(argv)
    target = args.target_dir or os.path.dirname(args.tgz_file)
    preprocess_data(args.tgz_file, target)


if __name__ == "__main__":
    main()
