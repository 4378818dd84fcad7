"""GramVaani Hindi corpus importer (counterpart of bin/import_gram_vaani.py).

Input: the GramVaani catalog CSV with (piece_id, audio_url,
transcript_labelled, transcript, labels, content_filename, audio_length,
user_id) columns. Audio files are downloaded per audio_url into
--target_dir (skipped when already present — the zero-egress path is to
pre-populate them); mp3s decode in-process via libmpg123 to 16 kHz wavs
with the same stem. Writes
gram_vaani_{train,dev,test}.csv (80/10/10 contiguous).
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
MAX_SECS = 30


def parse_catalog(csv_filename: str):
    entries = []
    with open(csv_filename, newline="", encoding="utf-8") as f:
        reader = csv.reader(f, quoting=csv.QUOTE_ALL)
        next(reader, None)  # header
        for row in reader:
            if len(row) < 7:
                continue
            audio_url, transcript = row[1], row[3]
            if audio_url and transcript:
                entries.append((audio_url, transcript))
    return entries


def preprocess_data(csv_filename: str, target_dir: str, validate_label,
                    download: bool = False):
    from stt_tpu_torch.tools.downloader import maybe_download

    counter = get_counter()
    rows = []
    missing = 0
    for audio_url, transcript in parse_catalog(csv_filename):
        name = os.path.basename(audio_url.split("?")[0])
        mp3 = os.path.join(target_dir, name)
        if download and not os.path.isfile(mp3):
            try:
                maybe_download(name, target_dir, audio_url)
            except Exception as e:
                print(f"Warning: download failed for {name}: {e}")
        wav = os.path.splitext(mp3)[0] + ".wav"
        if not ensure_wav(mp3, wav, SAMPLE_RATE):
            missing += 1
            counter["all"] += 1
            counter["failed"] += 1
            continue
        label = validate_label(transcript)
        row = filter_sample(wav, label, counter, MAX_SECS,
                            min_ms_per_char=10.0 / 2)
        if row:
            rows.append(row)
    if missing:
        print(
            f"Warning: {missing} clips could not be decoded "
            "(missing mp3, or libmpg123 unavailable)."
        )
    print_import_report(counter, SAMPLE_RATE, MAX_SECS)

    i80, i90 = int(len(rows) * 0.8), int(len(rows) * 0.9)
    csvs = []
    for subset, subset_rows in (
        ("train", rows[:i80]), ("dev", rows[i80:i90]), ("test", rows[i90:]),
    ):
        csv_path = os.path.join(target_dir, f"gram_vaani_{subset}.csv")
        write_samples_csv(csv_path, subset_rows)
        csvs.append(csv_path)
    return csvs


def main(argv=None):
    parser = get_importers_parser(description=__doc__)
    parser.add_argument("--csv_filename", required=True)
    parser.add_argument("--target_dir", required=True)
    parser.add_argument("--download", action="store_true")
    args = parser.parse_args(argv)
    os.makedirs(args.target_dir, exist_ok=True)
    preprocess_data(args.csv_filename, args.target_dir,
                    get_validate_label(args), args.download)


if __name__ == "__main__":
    main()
