"""Free ST Chinese Mandarin (ST-CMDS) importer (counterpart of
bin/import_freestmandarin.py).

Layout: ST-CMDS-20170001_1-OS/*.wav with a same-stem .txt transcript per
file. Splits deterministically (seed 12345): last 5000 shuffled as test,
previous 5000 as dev; train trimmed at 10 s.
"""

from __future__ import annotations

import argparse
import glob
import os

from stt_tpu_torch.tools.importers import (
    deterministic_split,
    extract_archive,
    trim_longer_than,
    write_samples_csv,
)


def preprocess_data(tgz_file: str, target_dir: str,
                    n_dev: int = 5000, n_test: int = 5000):
    main_folder = os.path.join(target_dir, "ST-CMDS-20170001_1-OS")
    extract_archive(tgz_file, target_dir, expected_dir=main_folder)

    rows = []
    for wav in sorted(glob.glob(os.path.join(main_folder, "*.wav"))):
        txt = os.path.splitext(wav)[0] + ".txt"
        with open(txt, encoding="utf-8") as f:
            transcript = f.read().strip()
        rows.append((wav, os.path.getsize(wav), transcript))

    train, dev, test = deterministic_split(rows, n_dev, n_test)
    train = trim_longer_than(train, 10.0)
    csvs = []
    for subset, subset_rows in (("train", train), ("dev", dev), ("test", test)):
        csv_path = os.path.join(target_dir, f"freestmandarin_{subset}.csv")
        write_samples_csv(csv_path, subset_rows)
        csvs.append(csv_path)
    return csvs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("tgz_file", help="Path to ST-CMDS-20170001_1-OS.tar.gz")
    parser.add_argument("--target_dir", default="")
    args = parser.parse_args(argv)
    target = args.target_dir or os.path.dirname(args.tgz_file)
    preprocess_data(args.tgz_file, target)


if __name__ == "__main__":
    main()
