"""Fisher English importer (counterpart of bin/import_fisher.py).

Layout: fisher_audio/**/*.sph (2-channel 8 kHz calls, LDC2004S13 /
LDC2005S13) + transcript dirs with fe_03_*.txt files whose lines are
"<start> <stop> <A:|B:> <words...>" (speaker A = channel 1). Calls are
decoded/split with the in-tree SPHERE tools, segments cut per line, and
CSVs written as fisher-{train,dev,test}.csv (dev/test carved from the
shuffled tail like the reference's per-release split).
"""

from __future__ import annotations

import argparse
import fnmatch
import os

from stt_tpu_torch.tools.importers import deterministic_split, write_samples_csv
from stt_tpu_torch.tools.ldc_conversational import (
    clean_conversational,
    convert_call_channels,
    slice_segments,
)


def parse_transcriptions(trans_file: str):
    """-> per-channel [(start, stop, transcript)]
    (bin/import_fisher.py:82-106)."""
    per_channel = {0: [], 1: []}
    with open(trans_file, encoding="utf-8", errors="replace") as f:
        for line in f:
            if line.startswith("#") or len(line) <= 1:
                continue
            tokens = line.split()
            start, stop = float(tokens[0]), float(tokens[1])
            channel = 0 if tokens[2].upper().startswith("A") else 1
            transcript = clean_conversational(" ".join(tokens[3:]))
            if transcript:
                per_channel[channel].append((start, stop, transcript))
    return per_channel


def preprocess_data(data_dir: str, n_dev: int = 1000, n_test: int = 1000):
    audio_dir = os.path.join(data_dir, "fisher_audio")
    wav_dir = os.path.join(data_dir, "fisher-wav")
    split_dir = os.path.join(data_dir, "fisher-split-wav")

    sph_by_call = {}
    for root, _, files in os.walk(audio_dir):
        for name in fnmatch.filter(files, "*.sph"):
            sph_by_call[os.path.splitext(name)[0]] = os.path.join(root, name)

    rows = []
    for root, _, files in os.walk(data_dir):
        if "fisher-split-wav" in root or "fisher-wav" in root:
            continue
        for name in sorted(fnmatch.filter(files, "fe_03_*.txt")):
            call = os.path.splitext(name)[0]
            if call not in sph_by_call:
                print(f"Warning: no audio for transcript {name}")
                continue
            channels = convert_call_channels(
                sph_by_call[call], wav_dir, suffix=("_c1", "_c2")
            )
            per_channel = parse_transcriptions(os.path.join(root, name))
            for c, wav in enumerate(channels):
                rows.extend(
                    slice_segments(
                        wav, per_channel[c], split_dir, f"{call}_c{c + 1}"
                    )
                )

    n_dev = min(n_dev, max(len(rows) // 10, 1))
    n_test = min(n_test, max(len(rows) // 10, 1))
    train, dev, test = deterministic_split(rows, n_dev, n_test)
    csvs = []
    for subset, subset_rows in (("train", train), ("dev", dev), ("test", test)):
        csv_path = os.path.join(data_dir, f"fisher-{subset}.csv")
        write_samples_csv(csv_path, subset_rows)
        csvs.append(csv_path)
    return csvs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "data_dir",
        help="dir with fisher_audio/ (sph calls) and transcript dirs",
    )
    args = parser.parse_args(argv)
    preprocess_data(args.data_dir)


if __name__ == "__main__":
    main()
