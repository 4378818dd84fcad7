"""Common Voice personal-data export importer (counterpart of
bin/import_cv_personal.py).

Layout: the per-user takeout: a TSV with original_sentence_id /
sentence / locale columns and <id>.mp3 clips in --audio_dir. mp3s
decode in-process via libmpg123 (wavs cached beside the mp3s).
Writes data.csv in the audio dir; --space_after_every_character supports
CJK-style character targets like the reference.
"""

from __future__ import annotations

import csv
import os

from stt_tpu_torch.tools.importers import (
    ensure_wav,
    filter_sample,
    get_counter,
    get_importers_parser,
    get_validate_label,
    print_import_report,
    write_samples_csv,
)

SAMPLE_RATE = 16000
MAX_SECS = 10


def convert_set(tsv_file: str, audio_dir: str, validate_label,
                space_after_every_character: bool = False) -> str:
    counter = get_counter()
    rows = []
    missing = 0
    with open(tsv_file, newline="", encoding="utf-8") as f:
        for entry in csv.DictReader(f, delimiter="\t"):
            stem = os.path.join(audio_dir, entry["original_sentence_id"])
            wav = stem + ".wav"
            if not ensure_wav(stem + ".mp3", wav, SAMPLE_RATE):
                missing += 1
                counter["all"] += 1
                counter["failed"] += 1
                continue
            label = validate_label(entry["sentence"])
            row = filter_sample(wav, label, counter, MAX_SECS,
                                min_ms_per_char=10.0 / 2)
            if row:
                if space_after_every_character:
                    row = (row[0], row[1], " ".join(row[2]))
                rows.append(row)
    if missing:
        print(
            f"Warning: {missing} clips could not be decoded "
            "(missing mp3, or libmpg123 unavailable)."
        )
    print_import_report(counter, SAMPLE_RATE, MAX_SECS)
    output_csv = os.path.join(os.path.abspath(audio_dir), "data.csv")
    write_samples_csv(output_csv, rows)
    return output_csv


def main(argv=None):
    parser = get_importers_parser(description=__doc__)
    parser.add_argument("tsv_file", help="personal-export sentences TSV")
    parser.add_argument("--audio_dir", required=True)
    parser.add_argument("--space_after_every_character", action="store_true")
    args = parser.parse_args(argv)
    convert_set(args.tsv_file, args.audio_dir, get_validate_label(args),
                args.space_after_every_character)


if __name__ == "__main__":
    main()
