"""Att-HACK French expressive-speech importer (counterpart of
bin/import_atthack.py).

Layout: an extracted archive with wav/*.wav recordings and txt/*.txt
transcripts (same stem). Labels are validated (French locale plug-in
supported), duration-filtered at 15 s, and written as
atthack_{train,dev,test}.csv with an 80/10/10 contiguous split.
"""

from __future__ import annotations

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


def preprocess_data(extracted_dir: str, validate_label):
    transcripts = {}
    for tr in sorted(glob.glob(os.path.join(extracted_dir, "txt", "*.txt"))):
        with open(tr, encoding="utf-8") as f:
            transcripts[os.path.basename(tr)[:-4] + ".wav"] = f.read()

    counter = get_counter()
    rows = []
    for wav in sorted(glob.glob(os.path.join(extracted_dir, "wav", "*.wav"))):
        name = os.path.basename(wav)
        if name not in transcripts:
            continue
        label = validate_label(transcripts[name])
        row = filter_sample(wav, label, counter, MAX_SECS,
                            min_ms_per_char=15.0 / 2)
        if row:
            rows.append(row)
    print_import_report(counter, SAMPLE_RATE, MAX_SECS)

    i80, i90 = int(len(rows) * 0.8), int(len(rows) * 0.9)
    csvs = []
    for subset, subset_rows in (
        ("train", rows[:i80]), ("dev", rows[i80:i90]), ("test", rows[i90:]),
    ):
        csv_path = os.path.join(extracted_dir, f"atthack_{subset}.csv")
        write_samples_csv(csv_path, subset_rows)
        csvs.append(csv_path)
    return csvs


def main(argv=None):
    parser = get_importers_parser(description=__doc__)
    parser.add_argument("extracted_dir", help="extracted Att-HACK dir (wav/ + txt/)")
    args = parser.parse_args(argv)
    preprocess_data(args.extracted_dir, get_validate_label(args))


if __name__ == "__main__":
    main()
