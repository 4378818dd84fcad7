"""VoxForge importer (counterpart of bin/import_voxforge.py).

Layout: per-session archives extracted under
<data_dir>/{train,dev,test}/<session>/ with etc/prompts-original (or
etc/PROMPTS) mapping utterance ids to transcripts and wav/<id>.wav
recordings. Sessions are assigned to test/dev/train by sorted index
(first N test, next M dev, rest train — the reference's extracter
order). Writes voxforge-{train,dev,test}.csv.
"""

from __future__ import annotations

import argparse
import glob
import os

from stt_tpu_torch.tools.importers import (
    get_counter,
    print_import_report,
    validate_label_eng,
    write_samples_csv,
)

SAMPLE_RATE = 16000
MAX_SECS = 15


def read_prompts(session_dir: str) -> dict:
    for cand in ("prompts-original", "PROMPTS", "prompts.txt", "prompt.txt",
                 "cc.prompts", "Transcriptions.txt"):
        path = os.path.join(session_dir, "etc", cand)
        if os.path.isfile(path):
            prompts = {}
            with open(path, encoding="utf-8", errors="replace") as f:
                for line in f:
                    key, _, text = line.strip().partition(" ")
                    if key and text:
                        prompts[os.path.basename(key)] = text
            return prompts
    return {}


def import_session(session_dir: str, counter) -> list:
    rows = []
    prompts = read_prompts(session_dir)
    for wav in sorted(glob.glob(os.path.join(session_dir, "wav", "*.wav"))):
        key = os.path.splitext(os.path.basename(wav))[0]
        counter["all"] += 1
        if key not in prompts:
            counter["failed"] += 1
            continue
        label = validate_label_eng(prompts[key])
        if label is None:
            counter["invalid_label"] += 1
            continue
        size = os.path.getsize(wav)
        frames = (size - 44) // 2
        counter["total_time"] += frames
        if frames / SAMPLE_RATE > MAX_SECS:
            counter["too_long"] += 1
            continue
        counter["imported_time"] += frames
        rows.append((wav, size, label))
    return rows


def assign_splits(data_dir: str, number_of_test: int, number_of_dev: int):
    """If sessions live directly under data_dir (not pre-assigned into
    train/dev/test), assign them by sorted index like the reference's
    extracter (bin/import_voxforge.py:75-95)."""
    sessions = sorted(
        d for d in glob.glob(os.path.join(data_dir, "*"))
        if os.path.isdir(d) and os.path.basename(d) not in
        ("train", "dev", "test")
    )
    assigned = {"train": [], "dev": [], "test": []}
    for i, session in enumerate(sessions):
        if i < number_of_test:
            assigned["test"].append(session)
        elif i < number_of_test + number_of_dev:
            assigned["dev"].append(session)
        else:
            assigned["train"].append(session)
    for subset in ("train", "dev", "test"):
        pre = os.path.join(data_dir, subset)
        if os.path.isdir(pre):
            assigned[subset].extend(
                d for d in sorted(glob.glob(os.path.join(pre, "*")))
                if os.path.isdir(d)
            )
    return assigned


def preprocess_data(data_dir: str, number_of_test: int = 0,
                    number_of_dev: int = 0):
    assigned = assign_splits(data_dir, number_of_test, number_of_dev)
    csvs = []
    for subset in ("train", "dev", "test"):
        counter = get_counter()
        rows = []
        for session in assigned[subset]:
            rows.extend(import_session(session, counter))
        print(f"--- {subset} ---")
        print_import_report(counter, SAMPLE_RATE, MAX_SECS)
        csv_path = os.path.join(data_dir, f"voxforge-{subset}.csv")
        write_samples_csv(csv_path, rows)
        csvs.append(csv_path)
    return csvs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("data_dir", help="dir of extracted voxforge sessions")
    parser.add_argument("--number_of_test", type=int, default=0)
    parser.add_argument("--number_of_dev", type=int, default=0)
    args = parser.parse_args(argv)
    preprocess_data(args.data_dir, args.number_of_test, args.number_of_dev)


if __name__ == "__main__":
    main()
