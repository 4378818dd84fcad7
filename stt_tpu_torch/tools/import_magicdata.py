"""MAGICDATA Mandarin read-speech importer (counterpart of
bin/import_magicdata.py).

Layout: magicdata_{train,dev,test}_set.tar.gz each extracting a
{train,dev,test}/ dir with speaker subdirs of wavs and a TRANS.txt TSV
(UtteranceID / SpeakerID / Transcription). Truncated wavs (header frame
count disagreeing with filesize) are dropped, train is trimmed at 10 s
and [FIL]/[SPK] noise-tagged transcripts removed, like the reference.
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
import re
import wave

from stt_tpu_torch.tools.importers import (
    extract_archive,
    trim_longer_than,
    write_samples_csv,
)

NOISE_TAG = re.compile(r"\[(FIL|SPK)\]")


def is_file_truncated(wav_filename: str, wav_filesize: int) -> bool:
    with wave.open(wav_filename, mode="rb") as f:
        header_duration = f.getnframes() / f.getframerate()
        filesize_duration = (wav_filesize - 44) / 16000 / 2
    return header_duration != filesize_duration


def load_transcripts(trans_path: str) -> dict:
    out = {}
    with open(trans_path, newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            out[row["UtteranceID"].split("/")[-1]] = row["Transcription"]
    return out


def preprocess_data(folder_with_archives: str, target_dir: str):
    csvs = []
    for subset in ("train", "dev", "test"):
        set_dir = os.path.join(target_dir, subset)
        archive = os.path.join(
            folder_with_archives, f"magicdata_{subset}_set.tar.gz"
        )
        if os.path.isfile(archive) or not os.path.isdir(set_dir):
            extract_archive(archive, target_dir, expected_dir=set_dir)
        transcripts = load_transcripts(os.path.join(set_dir, "TRANS.txt"))
        rows = []
        for wav in sorted(glob.glob(os.path.join(set_dir, "*", "*.wav"))):
            key = os.path.basename(wav)
            if key not in transcripts:
                print(f"Warning: Missing transcript for WAV file {wav}.")
                continue
            size = os.path.getsize(wav)
            if is_file_truncated(wav, size):
                print(f"Warning: File {wav} is corrupted, ignoring.")
                continue
            rows.append((wav, size, transcripts[key].strip()))
        if subset == "train":
            rows = trim_longer_than(rows, 10.0)
            n = len(rows)
            rows = [r for r in rows if not NOISE_TAG.search(r[2])]
            if len(rows) < n:
                print(f"Trimming {n - len(rows)} samples with noise tags")
        csv_path = os.path.join(target_dir, f"magicdata_{subset}.csv")
        write_samples_csv(csv_path, rows)
        csvs.append(csv_path)
    return csvs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "folder_with_archives",
        help="folder containing magicdata_{train,dev,test}_set.tar.gz",
    )
    parser.add_argument("--target_dir", default="")
    args = parser.parse_args(argv)
    target = args.target_dir or os.path.join(
        args.folder_with_archives, "magicdata"
    )
    os.makedirs(target, exist_ok=True)
    preprocess_data(args.folder_with_archives, target)


if __name__ == "__main__":
    main()
