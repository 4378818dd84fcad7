"""Scan transcripts in CSV files and report the unique character set —
used to build alphabet files for new corpora (parity:
util/check_characters.py).

Run: python -m stt_tpu_torch.tools.check_characters -csv train.csv [-alpha] [-unicode]
"""

from __future__ import annotations

import argparse
import csv
import sys
from typing import List, Set


def collect_characters(csv_files: List[str]) -> Set[str]:
    chars: Set[str] = set()
    for path in csv_files:
        with open(path, newline="", encoding="utf-8") as f:
            for row in csv.DictReader(f):
                chars.update(row.get("transcript", ""))
    return chars


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "-csv", "--csv-files", required=True,
        help="Comma-separated list of CSV files",
    )
    parser.add_argument(
        "-alpha", "--alphabet-format", action="store_true",
        help="Print as alphabet.txt content (one char per line)",
    )
    parser.add_argument(
        "-unicode", "--disable-unicode-variants", action="store_true",
        help="Warn on unicode normalization variants",
    )
    args = parser.parse_args(argv)
    chars = collect_characters(args.csv_files.split(","))
    if args.disable_unicode_variants:
        import unicodedata

        for ch in sorted(chars):
            norm = unicodedata.normalize("NFKC", ch)
            if norm != ch:
                print(
                    f"WARNING: {ch!r} has a unicode variant {norm!r}",
                    file=sys.stderr,
                )
    if args.alphabet_format:
        print("# Each line in this file represents a character")
        for ch in sorted(chars):
            print("\\#" if ch == "#" else ch)
    else:
        print(f"### The following unique characters were found in your "
              f"transcripts: ###")
        print(sorted(chars))
    return sorted(chars)


if __name__ == "__main__":
    main()
