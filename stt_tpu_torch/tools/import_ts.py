"""TrainingSpeech (French) importer (counterpart of bin/import_ts.py).

Layout: an extracted release dir with data.csv ("path,text,..." rows)
and the referenced audio files (wav; the reference converts other
formats with sox). Transcripts are cleaned (typographic apostrophes,
punctuation, lowercasing; optional ASCII folding for English-compatible
alphabets), filtered at 15 s, and split 80/10/10 deterministically into
ts_{train,dev,test}.csv.
"""

from __future__ import annotations

import argparse
import csv
import os
import re

from stt_tpu_torch.tools.importers import (
    deterministic_split,
    filter_sample,
    get_counter,
    print_import_report,
    write_samples_csv,
)

SAMPLE_RATE = 16000
MAX_SECS = 15
PUNCTUATIONS_REG = re.compile(r"[°.,;?!:\"“”«»…()\[\]{}\-—_]")
MULTIPLE_SPACES_REG = re.compile(r"\s{2,}")


def cleanup_transcript(text: str, english_compatible: bool = False):
    text = text.replace("’", "'").replace(" ", " ")
    text = PUNCTUATIONS_REG.sub(" ", text)
    text = MULTIPLE_SPACES_REG.sub(" ", text)
    if english_compatible:
        import unicodedata

        text = (
            unicodedata.normalize("NFKD", text)
            .encode("ascii", "ignore")
            .decode("ascii")
        )
    text = text.strip().lower()
    return text or None


def preprocess_data(extracted_dir: str, english_compatible: bool = False):
    counter = get_counter()
    rows = []
    with open(
        os.path.join(extracted_dir, "data.csv"), newline="", encoding="utf-8"
    ) as f:
        for entry in csv.DictReader(f):
            wav = os.path.join(extracted_dir, entry["path"])
            label = cleanup_transcript(entry["text"], english_compatible)
            row = filter_sample(wav, label, counter, MAX_SECS,
                                min_ms_per_char=15.0 / 2)
            if row:
                rows.append(row)
    print_import_report(counter, SAMPLE_RATE, MAX_SECS)

    n_dev = max(len(rows) // 10, 1)
    n_test = max(len(rows) // 10, 1)
    train, dev, test = deterministic_split(rows, n_dev, n_test)
    csvs = []
    for subset, subset_rows in (("train", train), ("dev", dev), ("test", test)):
        csv_path = os.path.join(extracted_dir, f"ts_{subset}.csv")
        write_samples_csv(csv_path, subset_rows)
        csvs.append(csv_path)
    return csvs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("extracted_dir", help="extracted TrainingSpeech release")
    parser.add_argument("--english_compatible", action="store_true")
    args = parser.parse_args(argv)
    preprocess_data(args.extracted_dir, args.english_compatible)


if __name__ == "__main__":
    main()
