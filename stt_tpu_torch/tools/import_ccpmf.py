"""CCPMF (Centre de Conférences Pierre Mendès-France, French ministry
of finance) importer — counterpart of bin/import_ccpmf.py.

Input: pairs of <session>.xml transcriptions (rows of
``<row timestamp="s" timedur="s">text</row>``) and session audio. The
reference merges contiguous rows (close timestamps, total under
MAX_SECS), decodes the session mp3, slices per merged sample, and
normalizes French text (special chars, anglicisms, digits to words via
num2words). Each <session>.mp3 decodes in-process via libmpg123 (a
16 kHz <session>.wav beside the xml also works). Digit normalization uses
the built-in French number speller below. Output:
ccpmf_{train,dev,test}.csv with a 99%-confidence dev/test sample size.
"""

from __future__ import annotations

import argparse
import glob
import math
import os
import re
import xml.etree.ElementTree as ET

from stt_tpu_torch.tools.import_swc import get_sample_size
from stt_tpu_torch.tools.importers import get_counter, write_samples_csv
from stt_tpu_torch.tools.ldc_conversational import slice_segments

SAMPLE_RATE = 16000
MAX_SECS = 10
MIN_SECS = 0.85

_UNITS = ["zéro", "un", "deux", "trois", "quatre", "cinq", "six", "sept",
          "huit", "neuf", "dix", "onze", "douze", "treize", "quatorze",
          "quinze", "seize", "dix-sept", "dix-huit", "dix-neuf"]
_TENS = [None, None, "vingt", "trente", "quarante", "cinquante", "soixante"]


def french_number_words(n: int) -> str:
    """Spell an integer in French (0 .. 999 999 999)."""
    if n < 0:
        return "moins " + french_number_words(-n)
    if n < 20:
        return _UNITS[n]
    if n < 70:
        tens, unit = divmod(n, 10)
        if unit == 0:
            return _TENS[tens]
        if unit == 1:
            return f"{_TENS[tens]} et un"
        return f"{_TENS[tens]}-{_UNITS[unit]}"
    if n < 80:
        rest = n - 60
        return "soixante et onze" if n == 71 else f"soixante-{_UNITS[rest]}"
    if n < 100:
        rest = n - 80
        return "quatre-vingts" if rest == 0 else f"quatre-vingt-{_UNITS[rest] if rest < 20 else french_number_words(rest)}"
    if n < 1000:
        hundreds, rest = divmod(n, 100)
        head = "cent" if hundreds == 1 else f"{_UNITS[hundreds]} cent"
        if rest == 0:
            return head + ("s" if hundreds > 1 else "")
        return f"{head} {french_number_words(rest)}"
    if n < 1_000_000:
        thousands, rest = divmod(n, 1000)
        head = "mille" if thousands == 1 else \
            f"{french_number_words(thousands)} mille"
        return head if rest == 0 else f"{head} {french_number_words(rest)}"
    millions, rest = divmod(n, 1_000_000)
    head = f"{french_number_words(millions)} million" + \
        ("s" if millions > 1 else "")
    return head if rest == 0 else f"{head} {french_number_words(rest)}"


SPECIALS = [
    (re.compile(r"\.{2,}"), " "), (re.compile(r" {2,}"), " "),
    (re.compile(r"[«»“”]"), ""), (re.compile(r"’"), "'"),
    (re.compile(r"€"), "euros"), (re.compile(r"%"), "pour cent"),
    (re.compile(r"°"), " "), (re.compile(r"[()\[\]{}]"), " "),
]
ANGLICISMS = [
    (re.compile(r"\bfintech\b", re.I), "finetech"),
    (re.compile(r"\bstartup(s)?\b", re.I), "startup"),
]
THOUSAND_GROUPS = re.compile(r"(\d)\s(\d{3})")
TIME_EXPR = re.compile(r"(\d{1,2})h(\d{2})?")


def maybe_normalize(label: str) -> str:
    for reg, sub in SPECIALS + ANGLICISMS:
        label = reg.sub(sub, label)
    # merge digit groups "50 000" -> "50000"
    while True:
        label, r = THOUSAND_GROUPS.subn(r"\1\2", label)
        if r == 0:
            break
    label = TIME_EXPR.sub(
        lambda m: f"{m.group(1)} heures {m.group(2) or ''}".strip(), label
    )
    out = []
    for token in label.split(" "):
        if token and any(c.isdigit() for c in token):
            stripped = token.strip(".,;?!:\"'")
            if stripped.isdigit():
                out.append(french_number_words(int(stripped)))
                continue
            if re.fullmatch(r"\d+[.,]\d+", stripped):
                whole, frac = re.split(r"[.,]", stripped)
                out.append(
                    f"{french_number_words(int(whole))} virgule "
                    f"{french_number_words(int(frac))}"
                )
                continue
        out.append(token)
    label = " ".join(out)
    label = re.sub(r"[.,;?!:\"]", "", label)
    return re.sub(r" {2,}", " ", label).strip().lower()


def parse_session_xml(xml_file: str, rel_tol: float = 1e-1):
    """Merge contiguous rows into samples (bin/import_ccpmf.py:589-636).
    -> [(start_s, duration_s, text)]"""
    samples = []
    this_time = this_duration = prev_time = prev_duration = 0.0
    this_text = ""
    for child in ET.parse(xml_file).getroot():
        if child.tag != "row":
            continue
        cur_time = float(child.attrib["timestamp"])
        cur_duration = float(child.attrib["timedur"])
        cur_text = child.text or ""
        if this_time == 0.0:
            this_time = cur_time
        delta = cur_time - (prev_time + prev_duration)
        is_close = math.isclose(cur_time, this_time + this_duration,
                                rel_tol=rel_tol)
        is_short = (this_duration + cur_duration + delta) < MAX_SECS
        if is_close and is_short:
            this_duration += cur_duration + delta
            this_text += cur_text
        else:
            if this_text:
                samples.append((this_time, this_duration, this_text))
            this_time, this_duration, this_text = cur_time, cur_duration, cur_text
        prev_time, prev_duration = cur_time, cur_duration
    if this_text:
        samples.append((this_time, this_duration, this_text))
    return samples


def preprocess_data(data_dir: str, target_dir: str | None = None):
    target_dir = target_dir or data_dir
    counter = get_counter()
    rows = []
    missing = 0
    for xml_file in sorted(
        glob.glob(os.path.join(data_dir, "**", "*.xml"), recursive=True)
    ):
        stem = os.path.splitext(xml_file)[0]
        wav = stem + ".wav"
        from stt_tpu_torch.tools.importers import ensure_wav

        if not ensure_wav(stem + ".mp3", wav, SAMPLE_RATE):
            missing += 1
            continue
        base = os.path.splitext(os.path.basename(xml_file))[0]
        segments = []
        for start, duration, text in parse_session_xml(xml_file):
            if duration < MIN_SECS:
                counter["too_short"] += 1
                continue
            label = maybe_normalize(text)
            if not label:
                counter["invalid_label"] += 1
                continue
            counter["all"] += 1
            segments.append((start, start + duration, label))
        rows.extend(
            slice_segments(
                wav, segments, os.path.join(target_dir, base + "-split"), base
            )
        )
    if missing:
        print(
            f"Warning: {missing} sessions could not be decoded "
            "(missing mp3/wav beside the xml, or libmpg123 unavailable)."
        )

    sample_size = get_sample_size(len(rows))
    dev, test, train = (
        rows[:sample_size],
        rows[sample_size : 2 * sample_size],
        rows[2 * sample_size :],
    )
    csvs = []
    for subset, subset_rows in (("train", train), ("dev", dev), ("test", test)):
        csv_path = os.path.join(target_dir, f"ccpmf_{subset}.csv")
        write_samples_csv(csv_path, subset_rows)
        csvs.append(csv_path)
    return csvs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("data_dir", help="dir of <session>.xml + <session>.wav")
    parser.add_argument("--target_dir", default="")
    args = parser.parse_args(argv)
    preprocess_data(args.data_dir, args.target_dir or None)


if __name__ == "__main__":
    main()
