"""Lingua Libre importer (counterpart of bin/import_lingua_libre.py).

Layout: Q<qId>-<iso>-<Language>/ speaker dirs of per-word/phrase .ogg
recordings whose file stem IS the transcript. This build has no Vorbis
codec, so each .ogg must have a pre-converted .wav beside it (the
reference creates exactly that with sox); records whose stem fails the
label validator (e.g. wiki Q-ids) are skipped via --bogus-records
regexes like the reference. Output: lingua_libre_{train,dev,test}.csv
(80/10/10 contiguous).
"""

from __future__ import annotations

import glob
import os
import re

from stt_tpu_torch.tools.importers import (
    filter_sample,
    get_counter,
    get_importers_parser,
    get_validate_label,
    print_import_report,
    write_samples_csv,
)

SAMPLE_RATE = 16000
MAX_SECS = 15


def preprocess_data(ogg_root_dir: str, validate_label, bogus_regex=None):
    bogus = re.compile(bogus_regex) if bogus_regex else None
    counter = get_counter()
    rows = []
    missing_wav = 0
    pattern = os.path.join(ogg_root_dir, "**", "*.ogg")
    for record in sorted(glob.glob(pattern, recursive=True)):
        stem = os.path.splitext(os.path.basename(record))[0]
        if bogus and bogus.match(stem):
            counter["all"] += 1
            counter["invalid_label"] += 1
            continue
        wav = os.path.splitext(record)[0] + ".wav"
        if not os.path.isfile(wav):
            missing_wav += 1
            counter["all"] += 1
            counter["failed"] += 1
            continue
        label = validate_label(stem)
        row = filter_sample(wav, label, counter, MAX_SECS,
                            min_ms_per_char=15.0 / 2)
        if row:
            rows.append(row)
    if missing_wav:
        print(
            f"Warning: {missing_wav} .ogg records had no .wav beside them — "
            "no Vorbis codec in this build; pre-convert to wav first."
        )
    print_import_report(counter, SAMPLE_RATE, MAX_SECS)

    i80, i90 = int(len(rows) * 0.8), int(len(rows) * 0.9)
    csvs = []
    for subset, subset_rows in (
        ("train", rows[:i80]), ("dev", rows[i80:i90]), ("test", rows[i90:]),
    ):
        csv_path = os.path.join(ogg_root_dir, f"lingua_libre_{subset}.csv")
        write_samples_csv(csv_path, subset_rows)
        csvs.append(csv_path)
    return csvs


def main(argv=None):
    parser = get_importers_parser(description=__doc__)
    parser.add_argument("ogg_root_dir", help="extracted Q<id>-<iso>-<lang> dir")
    parser.add_argument(
        "--bogus-records", dest="bogus_regex",
        help="regex of record stems to skip (e.g. '^Q[0-9]+')",
    )
    args = parser.parse_args(argv)
    preprocess_data(args.ogg_root_dir, get_validate_label(args),
                    args.bogus_regex)


if __name__ == "__main__":
    main()
