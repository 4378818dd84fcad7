"""TUDA German Distant Speech corpus importer (counterpart of
bin/import_tuda.py).

Layout: german-speechdata-package-v2/{train,dev,test}/ with one XML
metadata file per recording (<cleaned_sentence> holds the transcript)
and one wav per microphone named <recording>_<mic>.wav. Sentences are
lowercased, "co2" expanded, optionally NFKD-folded to the alphabet
(keeping a-umlauts), and each mic wav is kept if it is 16 kHz/mono/16-bit
and long enough for the sentence (>= 30 ms per character).
Writes tuda-v2-{train,dev,test}.csv.
"""

from __future__ import annotations

import argparse
import os
import unicodedata
import wave
import xml.etree.ElementTree as ET
from collections import Counter

from stt_tpu_torch.tools.importers import validate_label_eng, write_samples_csv

TUDA_VERSION = "v2"
TUDA_PACKAGE = "german-speechdata-package-v2"
SAMPLE_RATE = 16000
GERMAN_CHARS = set("abcdefghijklmnopqrstuvwxyzäöüß '")


def check_and_prepare_sentence(sentence: str, normalize: bool = True):
    sentence = sentence.lower().replace("co2", "c o zwei")
    chars = []
    for c in sentence:
        if normalize and c not in "äöüß" and c not in GERMAN_CHARS:
            c = (
                unicodedata.normalize("NFKD", c)
                .encode("ascii", "ignore")
                .decode("ascii")
            )
        for sc in c:
            if sc not in GERMAN_CHARS:
                return None
            chars.append(sc)
    label = "".join(chars)
    # reuse the shared whitespace/punctuation normalization minus the
    # ASCII-only constraint (German umlauts survive)
    return validate_label_eng(label) if label.isascii() else label.strip() or None


def check_wav_file(wav_path: str, sentence: str, max_duration: float):
    try:
        with wave.open(wav_path, "r") as f:
            rate = f.getframerate()
            channels = f.getnchannels()
            width = f.getsampwidth()
            ms = int(f.getnframes() * 1000 / rate)
    except (wave.Error, EOFError):
        return False, "invalid wav file"
    if rate != SAMPLE_RATE:
        return False, "wrong sample rate"
    if channels != 1:
        return False, "wrong number of channels"
    if width != 2:
        return False, "wrong sample width"
    if ms / max(len(sentence), 1) < 30:
        return False, "too short"
    if 0 < max_duration < ms / 1000:
        return False, "too long"
    return True, "OK"


def write_csvs(extracted: str, base_dir: str, max_duration: float = 0,
               normalize: bool = True):
    csvs = []
    reasons = Counter()
    total = 0
    for subset in ("train", "dev", "test"):
        set_path = os.path.join(extracted, subset)
        names = sorted(os.listdir(set_path)) if os.path.isdir(set_path) else []
        recordings = {n[:-4]: [] for n in names if n.endswith(".xml")}
        for n in names:
            if n.endswith(".wav") and "_" in n:
                prefix = n.split("_")[0]
                if prefix in recordings:
                    recordings[prefix].append(n)
        rows = []
        for prefix, wav_names in sorted(recordings.items()):
            meta = ET.parse(os.path.join(set_path, prefix + ".xml")).getroot()
            nodes = list(meta.iter("cleaned_sentence"))
            sentence = nodes[0].text if nodes and nodes[0].text else ""
            sentence = check_and_prepare_sentence(sentence, normalize)
            if sentence is None:
                reasons["alphabet filter"] += 1
                continue
            for wav_name in wav_names:
                total += 1
                wav_path = os.path.join(set_path, wav_name)
                keep, reason = check_wav_file(wav_path, sentence, max_duration)
                if keep:
                    rows.append(
                        (os.path.relpath(wav_path, base_dir),
                         os.path.getsize(wav_path), sentence.lower())
                    )
                else:
                    reasons[reason] += 1
        csv_path = os.path.join(base_dir, f"tuda-{TUDA_VERSION}-{subset}.csv")
        write_samples_csv(csv_path, rows)
        csvs.append(csv_path)
    if reasons:
        print("Excluded samples:")
        for reason, n in reasons.most_common():
            print(f' - "{reason}": {n}')
    return csvs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--base_dir", required=True,
                        help=f"dir containing {TUDA_PACKAGE}[.tar.gz]")
    parser.add_argument("--max_duration", type=float, default=0,
                        help="maximum sample length in seconds (0 = off)")
    parser.add_argument("--no-normalize", dest="normalize",
                        action="store_false")
    args = parser.parse_args(argv)
    extracted = os.path.join(args.base_dir, TUDA_PACKAGE)
    if not os.path.isdir(extracted):
        from stt_tpu_torch.tools.importers import extract_archive

        extract_archive(
            os.path.join(args.base_dir, TUDA_PACKAGE + ".tar.gz"),
            args.base_dir, expected_dir=extracted,
        )
    write_csvs(extracted, args.base_dir, args.max_duration, args.normalize)


if __name__ == "__main__":
    main()
