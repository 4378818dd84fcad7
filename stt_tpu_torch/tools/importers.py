"""Shared importer machinery: per-locale label validation plug-in and
import statistics (parity: util/importers.py)."""

from __future__ import annotations

import argparse
import importlib
import os
import re
import sys
from collections import Counter
from typing import Optional


def get_counter() -> Counter:
    return Counter(
        {
            "all": 0,
            "failed": 0,
            "invalid_label": 0,
            "too_short": 0,
            "too_long": 0,
            "imported_time": 0,
            "total_time": 0,
        }
    )


def print_import_report(counter: Counter, sample_rate: int, max_secs: float) -> None:
    print(f"Imported {counter['all']} samples.")
    if counter["failed"] > 0:
        print(f"Skipped {counter['failed']} samples that failed upon conversion.")
    if counter["invalid_label"] > 0:
        print(
            f"Skipped {counter['invalid_label']} samples that failed on "
            "transcript validation."
        )
    if counter["too_short"] > 0:
        print(
            f"Skipped {counter['too_short']} samples that were too short to "
            "match the transcript."
        )
    if counter["too_long"] > 0:
        print(
            f"Skipped {counter['too_long']} samples that were longer than "
            f"{max_secs} seconds."
        )
    print(
        "Final amount of imported audio: "
        f"{counter['imported_time'] / sample_rate / 3600:.2f} h of "
        f"{counter['total_time'] / sample_rate / 3600:.2f} h."
    )


def get_importers_parser(description: str, **kwargs) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=description,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        **kwargs,
    )
    parser.add_argument(
        "--validate_label_locale",
        help="Path to a Python file defining a |validate_label| function "
        "for your locale.",
    )
    return parser


def get_validate_label(args):
    """Resolve the label-validation function: a user-supplied module with
    `validate_label`, defaulting to the English normalizer."""
    locale_path = getattr(args, "validate_label_locale", None)
    if locale_path is None:
        print(
            "WARNING: No --validate_label_locale specified, you might end "
            "with inconsistent dataset."
        )
        return validate_label_eng
    locale_path = str(locale_path)
    if not os.path.exists(os.path.abspath(locale_path)):
        print("ERROR: Path specified in --validate_label_locale is not a file.")
        return None
    sys.path.insert(1, os.path.abspath(os.path.dirname(locale_path)))
    module_name = os.path.basename(locale_path).replace(".py", "")
    return importlib.import_module(module_name).validate_label


class LabelFilter:
    """Transcript filter chain (bin/import_cv2.py:35-51 parity):
    optional NFKD-normalize to base ascii characters, the per-locale
    validate function, then an optional alphabet membership filter.
    Returns None to drop the sample."""

    def __init__(self, normalize=False, alphabet=None, validate_fun=None):
        self.normalize = bool(normalize)
        self.alphabet = alphabet
        self.validate_fun = validate_fun or validate_label_eng

    def filter(self, label):
        import unicodedata

        if label is None:
            return None
        if self.normalize:
            label = (
                unicodedata.normalize("NFKD", label.strip())
                .encode("ascii", "ignore")
                .decode("ascii", "ignore")
            )
        label = self.validate_fun(label)
        if self.alphabet and label and not self.alphabet.can_encode(label):
            label = None
        return label


def add_filter_args(parser: argparse.ArgumentParser) -> None:
    """The reference's shared transcript-filter flags
    (bin/import_cv2.py:217-239)."""
    parser.add_argument(
        "--filter_alphabet",
        help="Exclude samples with characters not in provided alphabet",
    )
    parser.add_argument(
        "--normalize",
        action="store_true",
        help="Converts diacritic characters to their base ones",
    )
    parser.add_argument(
        "--space_after_every_character",
        action="store_true",
        help="To help transcript join by white space",
    )


def label_filter_from_args(args) -> LabelFilter:
    alphabet = None
    if getattr(args, "filter_alphabet", None):
        from stt_tpu_torch.alphabet import Alphabet

        alphabet = Alphabet(args.filter_alphabet)
    return LabelFilter(
        normalize=getattr(args, "normalize", False),
        alphabet=alphabet,
        validate_fun=get_validate_label(args),
    )


def format_transcript(label: str, space_after_every_character: bool) -> str:
    """CSV transcript formatting: optionally join every character by a
    space (bin/import_cv2.py _maybe_convert_set)."""
    if space_after_every_character:
        return " ".join(label)
    return label


CSV_COLUMNS = ("wav_filename", "wav_filesize", "transcript")


def extract_archive(archive_path: str, target_dir: str,
                    expected_dir: Optional[str] = None) -> None:
    """Extract a tar/zip archive unless `expected_dir` already exists
    (the reference importers' _maybe_extract idiom)."""
    if expected_dir and os.path.isdir(expected_dir):
        print(f'Found directory "{expected_dir}" - not extracting.')
        return
    print(f"Extracting {archive_path} into {target_dir}...")
    if archive_path.endswith(".zip"):
        import zipfile

        with zipfile.ZipFile(archive_path) as z:
            z.extractall(target_dir)
    else:
        import tarfile

        with tarfile.open(archive_path) as tar:
            tar.extractall(target_dir)


def write_samples_csv(csv_path: str, rows) -> None:
    """Write the standard (wav_filename, wav_filesize, transcript) CSV."""
    import csv as _csv

    with open(csv_path, "w", newline="", encoding="utf-8") as f:
        writer = _csv.writer(f)
        writer.writerow(CSV_COLUMNS)
        writer.writerows(rows)
    print(f"Wrote {csv_path} ({len(rows)} samples)")


def deterministic_split(rows, n_dev: int, n_test: int, seed: int = 12345):
    """Seeded shuffle split -> (train, dev, test); test takes the last
    n_test shuffled indices, dev the n_dev before them (the reference's
    Chinese-corpora recipe, e.g. bin/import_freestmandarin.py:36-44)."""
    import numpy as np

    rows = sorted(rows, key=lambda r: r[0])
    indices = np.arange(len(rows))
    np.random.RandomState(seed).shuffle(indices)
    test_idx = indices[len(rows) - n_test :]
    dev_idx = indices[len(rows) - n_test - n_dev : len(rows) - n_test]
    train_idx = indices[: len(rows) - n_test - n_dev]
    pick = lambda idx: [rows[i] for i in idx]  # noqa: E731
    return pick(train_idx), pick(dev_idx), pick(test_idx)


def wav_duration_from_size(filesize: int, rate: int = 16000) -> float:
    """Duration of a 16-bit mono wav from its byte size (44-byte header)."""
    return (filesize - 44) / rate / 2


def trim_longer_than(rows, max_secs: float, rate: int = 16000):
    """Drop rows whose wav (by filesize) exceeds max_secs — the train-set
    trim every Chinese-corpus importer applies."""
    kept = [
        r for r in rows if wav_duration_from_size(int(r[1]), rate) <= max_secs
    ]
    if len(kept) < len(rows):
        print(f"Trimming {len(rows) - len(kept)} samples > {max_secs} seconds")
    return kept


def filter_sample(wav_filename: str, label: Optional[str], counter: Counter,
                  max_secs: float, min_ms_per_char: float = 30.0,
                  rate: int = 16000) -> Optional[tuple]:
    """The per-sample acceptance rule every reference importer applies
    (e.g. bin/import_slr57.py one_sample): file must exist, label must
    validate, audio must be long enough for the transcript
    (>= min_ms_per_char per character) and no longer than max_secs.
    Returns a CSV row or None; updates counter either way."""
    counter["all"] += 1
    if not os.path.isfile(wav_filename):
        counter["failed"] += 1
        return None
    file_size = os.path.getsize(wav_filename)
    frames = (file_size - 44) // 2
    counter["total_time"] += frames
    if label is None:
        counter["invalid_label"] += 1
        return None
    if frames / rate * 1000 / min_ms_per_char < len(label):
        counter["too_short"] += 1
        return None
    if frames / rate > max_secs:
        counter["too_long"] += 1
        return None
    counter["imported_time"] += frames
    return (wav_filename, file_size, label)


def validate_label_eng(label: str) -> Optional[str]:
    """Normalize an English transcript to [a-z '] or reject it."""
    if re.search(r"[0-9]|[(<\[\]&*{]", label) is not None:
        return None
    label = label.replace("-", " ").replace("_", " ")
    label = re.sub("[ ]{2,}", " ", label)
    for ch in ".,;?!:\"":
        label = label.replace(ch, "")
    label = label.strip().lower()
    return label if label else None


def ensure_wav(src_path: str, wav_path: str, rate: int = 16000) -> bool:
    """Make sure a 16 kHz mono wav exists at wav_path, decoding src_path
    (mp3/opus/flac/ogg/sph — whatever stt_tpu_torch.data.audio handles) when
    it does not. Returns True when the wav is present afterwards. The
    reference importers shell out to sox/ffmpeg for this; here the
    decode is in-process (libmpg123/libopus/in-tree decoders)."""
    import os

    if os.path.isfile(wav_path):
        return True
    if not os.path.isfile(src_path):
        return False
    from stt_tpu_torch.data.audio import read_audio, write_wav

    try:
        audio, _ = read_audio(src_path, desired_rate=rate)
    except (ValueError, RuntimeError):
        return False
    os.makedirs(os.path.dirname(wav_path) or ".", exist_ok=True)
    write_wav(wav_path, audio, rate)
    return True
