"""VCTK importer (counterpart of bin/import_vctk.py).

Layout: VCTK-Corpus/wav48/<speaker>/<utt>.wav (48 kHz) and
txt/<speaker>/<utt>.txt transcripts. Each wav is silence-trimmed
(energy-based, replacing the reference's librosa.effects.trim),
resampled to 16 kHz mono, filtered to 1..10 s, and written beside the
source as <utt>_16k.wav. Output: vctk_{train,dev,test}.csv with a
deterministic 90/5/5 split by utterance.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from stt_tpu_torch.tools.importers import (
    deterministic_split,
    extract_archive,
    get_counter,
    print_import_report,
    validate_label_eng,
    write_samples_csv,
)

SAMPLE_RATE = 16000
MAX_SECS = 10
MIN_SECS = 1


def trim_silence(audio: np.ndarray, rate: int, top_db: float = 60.0,
                 frame: int = 2048, hop: int = 512) -> np.ndarray:
    """Energy trim equivalent to librosa.effects.trim: drop leading and
    trailing frames more than top_db below the peak RMS."""
    if not len(audio):
        return audio
    n_frames = max((len(audio) - frame) // hop + 1, 1)
    rms = np.array([
        np.sqrt(np.mean(audio[i * hop : i * hop + frame] ** 2) + 1e-12)
        for i in range(n_frames)
    ])
    db = 20.0 * np.log10(rms / (rms.max() + 1e-12) + 1e-12)
    keep = np.where(db > -top_db)[0]
    if not len(keep):
        return audio[:0]
    start = keep[0] * hop
    stop = min(keep[-1] * hop + frame, len(audio))
    return audio[start:stop]


def preprocess_data(target_dir: str):
    from stt_tpu_torch.data.audio import read_wav, resample, write_wav

    corpus = os.path.join(target_dir, "VCTK-Corpus")
    archive = glob.glob(os.path.join(target_dir, "VCTK-Corpus.zip*"))
    if not os.path.isdir(corpus) and archive:
        extract_archive(archive[0], target_dir, expected_dir=corpus)

    counter = get_counter()
    rows = []
    for wav in sorted(glob.glob(os.path.join(corpus, "wav48", "*", "*.wav"))):
        if wav.endswith("_16k.wav"):
            continue
        counter["all"] += 1
        utt = os.path.splitext(os.path.basename(wav))[0]
        speaker = os.path.basename(os.path.dirname(wav))
        txt = os.path.join(corpus, "txt", speaker, utt + ".txt")
        if not os.path.isfile(txt):
            counter["failed"] += 1
            continue
        with open(txt, encoding="utf-8") as f:
            label = validate_label_eng(f.read().strip())
        if label is None:
            counter["invalid_label"] += 1
            continue
        out = os.path.splitext(wav)[0] + "_16k.wav"
        if not os.path.isfile(out):
            audio, rate = read_wav(wav)
            audio = trim_silence(audio, rate)
            if rate != SAMPLE_RATE:
                audio = resample(audio, rate, SAMPLE_RATE)
            write_wav(out, audio, SAMPLE_RATE)
        size = os.path.getsize(out)
        secs = (size - 44) / 2 / SAMPLE_RATE
        counter["total_time"] += int(secs * SAMPLE_RATE)
        if secs > MAX_SECS:
            counter["too_long"] += 1
            continue
        if secs < MIN_SECS:
            counter["too_short"] += 1
            continue
        counter["imported_time"] += int(secs * SAMPLE_RATE)
        rows.append((out, size, label))
    print_import_report(counter, SAMPLE_RATE, MAX_SECS)

    n_dev = max(len(rows) // 20, 1)
    train, dev, test = deterministic_split(rows, n_dev, n_dev)
    csvs = []
    for subset, subset_rows in (("train", train), ("dev", dev), ("test", test)):
        csv_path = os.path.join(target_dir, f"vctk_{subset}.csv")
        write_samples_csv(csv_path, subset_rows)
        csvs.append(csv_path)
    return csvs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("target_dir", help="dir containing VCTK-Corpus[.zip]")
    args = parser.parse_args(argv)
    preprocess_data(args.target_dir)


if __name__ == "__main__":
    main()
