"""M-AILABS speech dataset importer (counterpart of bin/import_m-ailabs.py).

Layout: <lang>_<country>/by_book/<gender>/<speaker>/<book>/ with
wavs/*.wav and metadata.csv pipe-separated lines
"<id>|<original>|<normalized>". Uses the normalized transcript (field 3),
validates labels, filters by duration (<= 15 s, >= 15 ms per 2 chars),
optionally skips books via --skiplist, and writes an 80/10/10 split
(<prefix>_{train,dev,test}.csv) like the reference.
"""

from __future__ import annotations

import argparse
import glob
import os

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


def collect_samples(corpus_dir: str, skiplist=()):
    samples = []
    for record in sorted(
        glob.glob(os.path.join(corpus_dir, "**", "metadata.csv"),
                  recursive=True)
    ):
        if any(skip in record for skip in skiplist):
            continue
        with open(record, encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split("|")
                if len(parts) < 3:
                    continue
                wav = os.path.join(
                    os.path.dirname(record), "wavs", parts[0] + ".wav"
                )
                samples.append((wav, parts[2]))
    return samples


def preprocess_data(corpus_dir: str, validate_label, skiplist=()):
    counter = get_counter()
    rows = []
    for wav, transcript in collect_samples(corpus_dir, skiplist):
        label = validate_label(transcript)
        row = filter_sample(wav, label, counter, MAX_SECS,
                            min_ms_per_char=15.0 / 2)
        if row:
            rows.append(row)
    print_import_report(counter, SAMPLE_RATE, MAX_SECS)

    # 80/10/10 contiguous split over the collected order (the reference
    # writes the three CSVs by running row index, bin/import_m-ailabs.py)
    i80 = int(len(rows) * 0.8)
    i90 = int(len(rows) * 0.9)
    splits = (
        ("train", rows[:i80]), ("dev", rows[i80:i90]), ("test", rows[i90:]),
    )
    csvs = []
    for subset, subset_rows in splits:
        csv_path = os.path.join(corpus_dir, f"m-ailabs_{subset}.csv")
        write_samples_csv(csv_path, subset_rows)
        csvs.append(csv_path)
    return csvs


def main(argv=None):
    parser = get_importers_parser(description=__doc__)
    parser.add_argument("corpus_dir", help="extracted M-AILABS language dir")
    parser.add_argument("--skiplist", default="",
                        help="comma-separated book names to skip")
    args = parser.parse_args(argv)
    validate_label = get_validate_label(args)
    skiplist = tuple(s for s in args.skiplist.split(",") if s)
    preprocess_data(args.corpus_dir, validate_label, skiplist)


if __name__ == "__main__":
    main()
