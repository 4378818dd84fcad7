"""LibriSpeech (LibriVox) importer: FLAC releases -> 16 kHz wav + CSVs.

Counterpart of bin/import_librivox.py: for each set archive
(train-clean-100, dev-clean, test-clean, ...) extract under
<data_dir>/LibriSpeech, convert every FLAC referenced from a
*.trans.txt to wav (the reference shells out to sox; this build uses
the in-tree pure-Python FLAC decoder), ASCII-fold the transcripts, and
write one CSV per set (librivox-<set>.csv).

Run offline: drop the .tar.gz archives (or pre-extracted LibriSpeech/
tree) under --data_dir first; downloads only happen for missing sets
when --base_url is given.
"""

from __future__ import annotations

import argparse
import os
import unicodedata

SAMPLE_RATE = 16000
OPENSLR_URL = "http://www.openslr.org/resources/12"
ALL_SETS = (
    "train-clean-100", "train-clean-360", "train-other-500",
    "dev-clean", "dev-other", "test-clean", "test-other",
)


def fold_transcript(text: str) -> str:
    """NFKD-fold diacritics, drop non-ASCII, lowercase
    (bin/import_librivox.py:100-108)."""
    return (
        unicodedata.normalize("NFKD", text)
        .encode("ascii", "ignore")
        .decode("ascii")
        .lower()
        .strip()
    )


def convert_set(set_dir: str, wav_dir: str, relative_to: str | None = None):
    """Walk *.trans.txt under set_dir, convert FLACs, yield CSV rows."""
    from stt_tpu_torch.data.audio import read_audio, write_wav

    rows = []
    for root, _, files in os.walk(set_dir):
        for name in sorted(files):
            if not name.endswith(".trans.txt"):
                continue
            with open(os.path.join(root, name), encoding="utf-8") as f:
                for line in f:
                    seqid, _, transcript = line.strip().partition(" ")
                    flac = os.path.join(root, seqid + ".flac")
                    if not os.path.isfile(flac):
                        print(f"Warning: missing {flac}")
                        continue
                    out = os.path.join(wav_dir, *seqid.split("-")[:2])
                    os.makedirs(out, exist_ok=True)
                    wav = os.path.join(out, seqid + ".wav")
                    if not os.path.isfile(wav):
                        audio, _ = read_audio(flac, desired_rate=SAMPLE_RATE)
                        write_wav(wav, audio, SAMPLE_RATE)
                    path = (
                        os.path.relpath(wav, relative_to)
                        if relative_to else os.path.abspath(wav)
                    )
                    rows.append(
                        (path, os.path.getsize(wav), fold_transcript(transcript))
                    )
    return rows


def import_sets(data_dir: str, sets, base_url: str | None = None,
                relative: bool = False):
    from stt_tpu_torch.tools.downloader import maybe_download
    from stt_tpu_torch.tools.importers import extract_archive, write_samples_csv

    root = os.path.join(data_dir, "LibriSpeech")
    csvs = []
    for name in sets:
        set_dir = os.path.join(root, name)
        if not os.path.isdir(set_dir):
            archive = os.path.join(data_dir, name + ".tar.gz")
            if not os.path.isfile(archive) and base_url:
                archive = maybe_download(
                    name + ".tar.gz", data_dir, f"{base_url}/{name}.tar.gz"
                )
            if not os.path.isfile(archive):
                print(f"Skipping {name}: no archive or extracted dir")
                continue
            extract_archive(archive, data_dir, expected_dir=set_dir)
        rows = convert_set(
            set_dir,
            os.path.join(root, name + "-wav"),
            relative_to=root if relative else None,
        )
        csv_path = os.path.join(root, f"librivox-{name}.csv")
        write_samples_csv(csv_path, rows)
        csvs.append(csv_path)
    return csvs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("data_dir", help="where archives live / are extracted")
    parser.add_argument(
        "--sets", default=",".join(ALL_SETS),
        help="comma-separated subset of sets to import",
    )
    parser.add_argument(
        "--base_url", default=OPENSLR_URL,
        help="download base URL ('' disables downloading)",
    )
    parser.add_argument(
        "--relative", action="store_true",
        help="write wav paths relative to the LibriSpeech root",
    )
    args = parser.parse_args(argv)
    import_sets(
        args.data_dir, args.sets.split(","),
        base_url=args.base_url or None, relative=args.relative,
    )


if __name__ == "__main__":
    main()
