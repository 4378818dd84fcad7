"""Switchboard-1 importer (counterpart of bin/import_swb.py).

Layout: swb1_d{1..4}/**/*.sph (2-channel 8 kHz ulaw calls, LDC97S62) +
swb_ms98_transcriptions/<dd>/<dddd>/sw<call><A|B>-ms98-a-trans.text with
lines "<uttid> <start> <stop> <words...>" (channel from the A/B in the
uttid). Calls are decoded/split in-tree (no sph2pipe/librosa), segments
cut per utterance, annotation tokens dropped, and CSVs written as
swb-{train,dev,test}.csv with a deterministic tail split.
"""

from __future__ import annotations

import argparse
import fnmatch
import os
import re

from stt_tpu_torch.tools.importers import deterministic_split, write_samples_csv
from stt_tpu_torch.tools.ldc_conversational import (
    clean_conversational,
    convert_call_channels,
    slice_segments,
)

TRANS_NAME = re.compile(r"sw(\d{4})([AB])-ms98-a-trans\.text$")


def parse_ms98_trans(trans_file: str):
    segments = []
    with open(trans_file, encoding="utf-8", errors="replace") as f:
        for line in f:
            tokens = line.split()
            if len(tokens) < 4:
                continue
            start, stop = float(tokens[1]), float(tokens[2])
            transcript = clean_conversational(" ".join(tokens[3:]))
            if transcript:
                segments.append((start, stop, transcript))
    return segments


def preprocess_data(data_dir: str, n_dev: int = 1000, n_test: int = 1000):
    wav_dir = os.path.join(data_dir, "swb-wav")
    split_dir = os.path.join(data_dir, "swb-split-wav")

    sph_by_call = {}
    for disc in ("swb1_d1", "swb1_d2", "swb1_d3", "swb1_d4", "swb1"):
        disc_dir = os.path.join(data_dir, disc)
        for root, _, files in os.walk(disc_dir):
            for name in fnmatch.filter(files, "*.sph"):
                digits = re.search(r"(\d+)", name)  # sw02001.sph -> 2001
                if digits:
                    sph_by_call[digits.group(1)[-4:]] = os.path.join(root, name)

    rows = []
    trans_root = os.path.join(data_dir, "swb_ms98_transcriptions")
    for root, _, files in os.walk(trans_root):
        for name in sorted(files):
            m = TRANS_NAME.search(name)
            if not m:
                continue
            call, side = m.group(1), m.group(2)
            if call not in sph_by_call:
                print(f"Warning: no audio for call sw{call}")
                continue
            channels = convert_call_channels(
                sph_by_call[call], wav_dir, suffix=("-1", "-2")
            )
            wav = channels[0 if side == "A" else 1]
            segments = parse_ms98_trans(os.path.join(root, name))
            rows.extend(
                slice_segments(wav, segments, split_dir, f"sw{call}{side}")
            )

    n_dev = min(n_dev, max(len(rows) // 10, 1))
    n_test = min(n_test, max(len(rows) // 10, 1))
    train, dev, test = deterministic_split(rows, n_dev, n_test)
    csvs = []
    for subset, subset_rows in (("train", train), ("dev", dev), ("test", test)):
        csv_path = os.path.join(data_dir, f"swb-{subset}.csv")
        write_samples_csv(csv_path, subset_rows)
        csvs.append(csv_path)
    return csvs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "data_dir",
        help="dir with swb1_d*/ sph discs and swb_ms98_transcriptions/",
    )
    args = parser.parse_args(argv)
    preprocess_data(args.data_dir)


if __name__ == "__main__":
    main()
