"""Host-side audio IO and PCM utilities.

Covers the reference's util/audio.py surface that the training/serving
paths need: WAV read/write, int16<->float conversion (the i16/32768 scale
the streaming engine uses, stt.cc:113), resampling, loudness (dBFS)
measures, and normalization. Compressed formats decode through in-tree
pure-Python decoders (FLAC, Ogg Vorbis, SPHERE) or thin ctypes bindings
over system libraries (Opus via libopus, MP3 via libmpg123), each gated
with a clear error when the library is absent.
"""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np

DEFAULT_RATE = 16000


def pcm16_to_float(pcm: np.ndarray) -> np.ndarray:
    return (pcm.astype(np.float32)) / 32768.0


def float_to_pcm16(audio: np.ndarray) -> np.ndarray:
    return np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)


def read_wav(path: str, desired_rate: int | None = None) -> Tuple[np.ndarray, int]:
    """Read a PCM WAV file -> (float32 mono audio in [-1,1), sample rate).

    Multi-channel audio is averaged to mono; optionally resampled.
    """
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        n_channels = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        pcm = np.frombuffer(raw, np.int16)
        audio = pcm16_to_float(pcm)
    elif width == 1:
        audio = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 4:
        audio = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if n_channels > 1:
        audio = audio.reshape(-1, n_channels).mean(axis=1)
    if desired_rate is not None and rate != desired_rate:
        audio = resample(audio, rate, desired_rate)
        rate = desired_rate
    return audio, rate


def read_audio(path: str, desired_rate: int | None = None) -> Tuple[np.ndarray, int]:
    """Read an audio file by extension: .wav (PCM), .flac (pure-Python
    decoder, bit-exact), .ogg Vorbis (pure-Python decoder), or .sph
    (NIST SPHERE: pcm/ulaw/alaw), .opus (Ogg Opus via the system
    libopus), or .mp3 (via the system libmpg123)."""
    ext = path.lower().rsplit(".", 1)[-1]
    if ext == "wav":
        return read_wav(path, desired_rate)
    if ext == "flac":
        from stt_tpu_torch.data.flac import read_flac

        audio, rate = read_flac(path)
    elif ext in ("ogg", "oga"):
        from stt_tpu_torch.data.vorbis import read_vorbis

        audio, rate = read_vorbis(path)
        if audio.ndim == 2:
            audio = audio.mean(axis=1)
    elif ext == "sph":
        from stt_tpu_torch.data.sph import read_sph

        audio, rate = read_sph(path)
        if audio.ndim == 2:
            audio = audio.mean(axis=1)
    elif ext == "opus":
        from stt_tpu_torch.data.opus import opus_available, read_ogg_opus_file

        if not opus_available():
            raise ValueError(
                f"{path}: Ogg Opus needs libopus, which is not available "
                "on this system; convert to wav/flac/ogg-vorbis first"
            )
        audio, rate = read_ogg_opus_file(path)
        if audio.ndim == 2:
            audio = audio.mean(axis=1)
    elif ext == "mp3":
        from stt_tpu_torch.data.mp3 import mp3_available, read_mp3

        if not mp3_available():
            raise ValueError(
                f"{path}: MP3 needs libmpg123, which is not available on "
                "this system; convert to wav/flac first"
            )
        audio, rate = read_mp3(path)
        if audio.ndim == 2:
            audio = audio.mean(axis=1)
    else:
        raise ValueError(
            f"unsupported audio format '.{ext}' ({path}): this build "
            "decodes wav, flac, ogg (Vorbis), sph, opus, and mp3"
        )
    if desired_rate is not None and rate != desired_rate:
        audio = resample(audio, rate, desired_rate)
        rate = desired_rate
    return audio, rate


def write_wav(path: str, audio: np.ndarray, rate: int = DEFAULT_RATE) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(float_to_pcm16(audio).tobytes())


def resample(audio: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Polyphase resampling via scipy (fallback: linear interpolation)."""
    if src_rate == dst_rate:
        return audio
    try:
        from scipy.signal import resample_poly
        from math import gcd

        g = gcd(src_rate, dst_rate)
        return resample_poly(audio, dst_rate // g, src_rate // g).astype(
            np.float32
        )
    except ImportError:  # pragma: no cover
        n_out = int(round(len(audio) * dst_rate / src_rate))
        x_out = np.linspace(0, len(audio) - 1, n_out)
        return np.interp(x_out, np.arange(len(audio)), audio).astype(np.float32)


def duration_seconds(n_samples: int, rate: int = DEFAULT_RATE) -> float:
    return n_samples / rate


# -- loudness (parity: util/audio.py:880-929) -------------------------------


def rms_dbfs(audio: np.ndarray) -> float:
    rms = float(np.sqrt(np.mean(np.square(audio)))) if audio.size else 0.0
    if rms <= 0:
        return -float("inf")
    return 20.0 * np.log10(rms)


def max_dbfs(audio: np.ndarray) -> float:
    peak = float(np.max(np.abs(audio))) if audio.size else 0.0
    if peak <= 0:
        return -float("inf")
    return 20.0 * np.log10(peak)


def gain_db_to_ratio(gain_db: float) -> float:
    return 10.0 ** (gain_db / 20.0)


def normalize_audio(audio: np.ndarray, target_dbfs: float = 0.0) -> np.ndarray:
    return np.clip(
        audio * gain_db_to_ratio(target_dbfs - max_dbfs(audio)), -1.0, 1.0
    ).astype(np.float32)
