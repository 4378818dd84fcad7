"""Shared machinery for LDC conversational-telephone corpora
(Switchboard, Fisher): 2-channel 8 kHz SPHERE calls + time-stamped
per-channel transcripts -> per-segment 16 kHz wavs + CSV rows.

Replaces the reference importers' sph2pipe/librosa/soundfile toolchain
(bin/import_swb.py:87-121, bin/import_fisher.py:60-81) with the in-tree
SPHERE decoder and resampler.
"""

from __future__ import annotations

import os
import re
import unicodedata

import numpy as np

SAMPLE_RATE = 16000
BRACKETED = re.compile(r"\[[^\]]*\]|<[^>]*>|{[^}]*}")


def fold_ascii(text: str) -> str:
    return (
        unicodedata.normalize("NFKD", text)
        .encode("ascii", "ignore")
        .decode("ascii")
    )


def clean_conversational(text: str):
    """Drop annotation tokens ([silence], [noise], <b_aside>, {laugh}),
    partial-word markers, then normalize like the English validator."""
    from stt_tpu_torch.tools.importers import validate_label_eng

    text = BRACKETED.sub(" ", fold_ascii(text))
    text = text.replace("/", " ")
    return validate_label_eng(text)


def convert_call_channels(sph_file: str, target_dir: str,
                          suffix=("-1", "-2")):
    """Decode a 2-channel SPHERE call to two 16 kHz mono wavs
    (<call><suffix[c]>.wav). Returns the per-channel wav paths."""
    from stt_tpu_torch.data.audio import resample, write_wav
    from stt_tpu_torch.data.sph import read_sph

    base = os.path.splitext(os.path.basename(sph_file))[0]
    outs = [os.path.join(target_dir, base + s + ".wav") for s in suffix]
    if all(os.path.isfile(o) for o in outs):
        return outs
    audio, rate = read_sph(sph_file)
    if audio.ndim == 1:
        audio = audio[:, None]
    os.makedirs(target_dir, exist_ok=True)
    for c, out in enumerate(outs):
        chan = audio[:, min(c, audio.shape[1] - 1)]
        if rate != SAMPLE_RATE:
            chan = resample(chan, rate, SAMPLE_RATE)
        write_wav(out, np.asarray(chan), SAMPLE_RATE)
    return outs


def slice_segments(wav_path: str, segments, split_dir: str, prefix: str):
    """Cut (start, stop, transcript) segments out of one channel wav.
    Yields CSV rows; skips empty transcripts and zero-length slices."""
    from stt_tpu_torch.data.audio import read_wav, write_wav

    audio, rate = read_wav(wav_path)
    os.makedirs(split_dir, exist_ok=True)
    rows = []
    for start, stop, transcript in segments:
        if not transcript:
            continue
        chunk = audio[int(start * rate) : int(stop * rate)]
        if len(chunk) < rate // 20:  # < 50 ms is unusable
            continue
        name = f"{prefix}-{start:.2f}-{stop:.2f}.wav"
        out = os.path.join(split_dir, name)
        if not os.path.isfile(out):
            write_wav(out, chunk, rate)
        rows.append((os.path.abspath(out), os.path.getsize(out), transcript))
    return rows
