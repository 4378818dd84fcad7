"""Spoken Wikipedia Corpora (SWC) importer (counterpart of
bin/import_swc.py).

Layout: <language>/<article>/ dirs each holding aligned.swc (XML word
alignment: <prop> metadata, <s> sentences of <t> tokens whose <n> notes
carry start/end milliseconds and pronunciations) and audio.wav (the
reference converts audio*.ogg with sox first; this build has no Vorbis
codec, so audio.wav must be pre-converted — dirs without it are
reported and skipped). Sentences are accumulated into samples, filtered
(duration/transcript-length ratios, per-language alphabet), sliced into
per-sample wavs, and split speaker-disjoint with a 99%-confidence
dev/test sample size. Output: <language>/{train,dev,test}.csv.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from collections import Counter, defaultdict

UNKNOWN = "<unknown>"
ALIGNED_NAME = "aligned.swc"
WAV_NAME = "audio.wav"
ALPHABETS = {
    "english": set("abcdefghijklmnopqrstuvwxyz '"),
    "german": set("abcdefghijklmnopqrstuvwxyzäöüß '"),
    "dutch": set("abcdefghijklmnopqrstuvwxyz '"),
}


def get_sample_size(population_size: int) -> int:
    """99%-confidence / 1%-margin sample size (bin/import_swc.py:102-118)."""
    margin_of_error = 0.01
    fraction_picking = 0.50
    z_score = 2.58
    numerator = (z_score**2 * fraction_picking * (1 - fraction_picking)) / (
        margin_of_error**2
    )
    sample_size = 0
    for train_size in range(population_size, 0, -1):
        denominator = 1 + (z_score**2 * fraction_picking *
                           (1 - fraction_picking)) / (
            margin_of_error**2 * train_size
        )
        sample_size = int(numerator / denominator)
        if 2 * sample_size + train_size <= population_size:
            break
    return sample_size


def label_filter(label: str, language: str):
    label = label.lower().strip()
    alphabet = ALPHABETS.get(language)
    if alphabet is None:
        return label, None
    for c in label:
        if c not in alphabet:
            return None, "alphabet filter"
    return label, None


def read_token(token):
    """-> (start_ms, end_ms, text) (bin/import_swc.py:151-169)."""
    texts, start, end = [], None, None
    notes = token.findall("n")
    if notes:
        for note in notes:
            attributes = note.attrib
            if start is None and "start" in attributes:
                start = int(attributes["start"])
            if "end" in attributes:
                token_end = int(attributes["end"])
                if end is None or token_end > end:
                    end = token_end
            if "pronunciation" in attributes:
                texts.append(attributes["pronunciation"])
    elif "text" in token.attrib:
        texts.append(token.attrib["text"])
    return start, end, " ".join(texts)


def collect_samples(base_dir: str, language: str, max_duration_ms: int = 0):
    """-> [(wav_path, start_ms, end_ms, text, speaker)], skip reasons."""
    roots = []
    missing_wav = 0
    for root, _, files in os.walk(base_dir):
        if ALIGNED_NAME in files:
            if WAV_NAME in files:
                roots.append(root)
            else:
                missing_wav += 1
    if missing_wav:
        print(
            f"Warning: {missing_wav} aligned articles had no {WAV_NAME} — "
            "pre-convert audio*.ogg (no Vorbis codec in this build)."
        )

    samples = []
    reasons = Counter()

    def add_sample(wav_path, speaker, start, end, text):
        if start is None or end is None:
            reasons["missing timestamps"] += 1
            return
        if not text:
            reasons["missing text"] += 1
            return
        duration = end - start
        text, filter_reason = label_filter(text, language)
        if filter_reason:
            reasons[filter_reason] += 1
        elif 0 < max_duration_ms < duration:
            reasons["exceeded duration"] += 1
        elif int(duration / 30) < len(text):
            reasons["too short to decode"] += 1
        elif duration / len(text) < 10:
            reasons["length duration ratio"] += 1
        else:
            samples.append((wav_path, start, end, text, speaker))

    for root in sorted(roots):
        wav_path = os.path.join(root, WAV_NAME)
        aligned = ET.parse(os.path.join(root, ALIGNED_NAME))
        speaker = UNKNOWN
        for prop in aligned.iter("prop"):
            attributes = prop.attrib
            if attributes.get("key") == "reader.name":
                speaker = attributes.get("value", UNKNOWN)
        for sentence in aligned.iter("s"):
            start, end, texts = None, None, []
            for token in sentence.findall("t"):
                t_start, t_end, t_text = read_token(token)
                if start is None:
                    start = t_start
                if t_end is not None:
                    end = t_end
                if t_text:
                    texts.append(t_text)
            add_sample(wav_path, speaker, start, end, " ".join(texts))
    if reasons:
        print("Skipped samples:")
        for reason, n in reasons.most_common():
            print(f" - {reason}: {n}")
    return samples


def assign_sub_sets(samples):
    """Speaker-disjoint dev/test assignment (bin/import_swc.py:380-419)."""
    sample_size = get_sample_size(len(samples))
    by_speaker = defaultdict(list)
    for s in samples:
        by_speaker[s[4]].append(s)
    speakers = sorted(by_speaker.values(), key=len)
    sets = {"dev": [], "test": []}
    while (
        any(len(v) < sample_size for v in sets.values()) and speakers
    ):
        for name in ("dev", "test"):
            if len(sets[name]) < sample_size and speakers:
                sets[name].extend(speakers.pop(0))
    sets["train"] = [s for group in speakers for s in group]
    if not sets["train"]:
        print("WARNING: no speaker metadata; falling back to a seeded shuffle")
        import random

        random.seed(42)
        shuffled = list(samples)
        random.shuffle(shuffled)
        sets = {
            "dev": shuffled[:sample_size],
            "test": shuffled[sample_size : 2 * sample_size],
            "train": shuffled[2 * sample_size :],
        }
    return sets


def slice_and_write(base_dir: str, language: str, sets):
    from stt_tpu_torch.tools.importers import write_samples_csv
    from stt_tpu_torch.tools.ldc_conversational import slice_segments

    sample_dir = os.path.join(base_dir, "samples")
    csvs = []
    for subset in ("train", "dev", "test"):
        rows = []
        by_wav = defaultdict(list)
        for wav_path, start, end, text, _ in sets.get(subset, []):
            by_wav[wav_path].append((start / 1000.0, end / 1000.0, text))
        for wav_path, segments in sorted(by_wav.items()):
            prefix = os.path.basename(os.path.dirname(wav_path))
            rows.extend(
                slice_segments(
                    wav_path, segments,
                    os.path.join(sample_dir, subset), prefix,
                )
            )
        csv_path = os.path.join(base_dir, f"{language}_{subset}.csv")
        write_samples_csv(csv_path, rows)
        csvs.append(csv_path)
    return csvs


def prepare_language(base_dir: str, language: str, max_duration_ms: int = 0):
    samples = collect_samples(base_dir, language, max_duration_ms)
    sets = assign_sub_sets(samples)
    return slice_and_write(base_dir, language, sets)


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("base_dir", help="extracted <language> SWC dir")
    parser.add_argument("--language", default="english",
                        choices=sorted(ALPHABETS))
    parser.add_argument("--max_duration", type=int, default=0,
                        help="max sample duration in ms (0 = off)")
    args = parser.parse_args(argv)
    prepare_language(args.base_dir, args.language, args.max_duration)


if __name__ == "__main__":
    main()
