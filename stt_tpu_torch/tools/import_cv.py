"""Common Voice v1 importer (counterpart of bin/import_cv.py).

Layout: cv_corpus_v1/ with cv-{valid,other,invalid}-{train,dev,test}.csv
catalogs ("filename,text,...") pointing at mp3 clips; mp3s decode
in-process through libmpg123 (wavs are cached next to the mp3s, same
stem), which is also what the reference produces on disk after its sox
pass. Rows are validated/filtered like the reference (<= 10 s,
>= 10 ms per 2 chars) and written as one output CSV per input catalog.
"""

from __future__ import annotations

import argparse
import csv
import glob
import os

from stt_tpu_torch.tools.importers import (
    LabelFilter,
    add_filter_args,
    ensure_wav,
    filter_sample,
    format_transcript,
    get_counter,
    label_filter_from_args,
    print_import_report,
    validate_label_eng,
    write_samples_csv,
)

SAMPLE_RATE = 16000
MAX_SECS = 10
ARCHIVE_DIR_NAME = "cv_corpus_v1"


def convert_catalog(extracted_dir: str, source_csv: str, target_csv: str,
                    validate_label=validate_label_eng, filter_obj=None,
                    space_after_every_character=False):
    if filter_obj is None:
        filter_obj = LabelFilter(validate_fun=validate_label)
    counter = get_counter()
    rows = []
    missing_mp3 = 0
    with open(source_csv, newline="", encoding="utf-8") as f:
        for entry in csv.DictReader(f):
            clip = os.path.join(extracted_dir, entry["filename"])
            wav = os.path.splitext(clip)[0] + ".wav"
            if not ensure_wav(clip, wav, SAMPLE_RATE):
                missing_mp3 += 1
                counter["all"] += 1
                counter["failed"] += 1
                continue
            label = filter_obj.filter(entry["text"])
            row = filter_sample(wav, label, counter, MAX_SECS,
                                min_ms_per_char=10.0 / 2)
            if row:
                wav_f, size, text = row
                rows.append(
                    (wav_f, size,
                     format_transcript(text, space_after_every_character))
                )
    if missing_mp3:
        print(
            f"Warning: {missing_mp3} clips could not be decoded "
            "(missing file, or libmpg123 unavailable for mp3)."
        )
    print_import_report(counter, SAMPLE_RATE, MAX_SECS)
    write_samples_csv(target_csv, rows)
    return target_csv


def preprocess_data(target_dir: str, filter_obj=None,
                    space_after_every_character=False):
    extracted_dir = os.path.join(target_dir, ARCHIVE_DIR_NAME)
    csvs = []
    for source_csv in sorted(glob.glob(os.path.join(extracted_dir, "*.csv"))):
        out = os.path.join(target_dir, os.path.basename(source_csv))
        csvs.append(convert_catalog(
            extracted_dir, source_csv, out, filter_obj=filter_obj,
            space_after_every_character=space_after_every_character,
        ))
    return csvs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("target_dir", help=f"dir containing {ARCHIVE_DIR_NAME}/")
    parser.add_argument("--validate_label_locale")
    add_filter_args(parser)
    args = parser.parse_args(argv)
    preprocess_data(
        args.target_dir,
        filter_obj=label_filter_from_args(args),
        space_after_every_character=args.space_after_every_character,
    )


if __name__ == "__main__":
    main()
