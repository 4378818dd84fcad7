"""NIST SPHERE (.sph / TIMIT .WAV) audio reader.

The reference converts SPHERE corpora (TED-LIUM, TIMIT, Switchboard,
Fisher) by shelling out to sox (bin/import_timit.py:65,
bin/import_ted.py via sox Transformer); this build decodes the format
directly: a 1024-byte ASCII header of "name -type value" lines, then raw
samples. Supported codings: pcm (8/16-bit, either byte order), ulaw,
alaw. Embedded-shorten compression (some LDC distributions) is not
supported — those corpora ship a `w` decompression tool; run it first.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SphInfo:
    sample_rate: int
    channels: int
    sample_count: int  # per channel
    coding: str
    sample_bytes: int
    big_endian: bool
    header_bytes: int


def _ulaw_table() -> np.ndarray:
    u = np.arange(256, dtype=np.int32) ^ 0xFF
    sign = u & 0x80
    exponent = (u >> 4) & 0x07
    mantissa = u & 0x0F
    magnitude = ((mantissa << 3) + 0x84) << exponent
    magnitude -= 0x84
    return np.where(sign, -magnitude, magnitude).astype(np.int16)


def _alaw_table() -> np.ndarray:
    a = np.arange(256, dtype=np.int32) ^ 0x55
    sign = a & 0x80
    exponent = (a >> 4) & 0x07
    mantissa = a & 0x0F
    magnitude = np.where(
        exponent == 0,
        (mantissa << 4) + 8,
        ((mantissa << 4) + 0x108) << (exponent - 1),
    )
    return np.where(sign, -magnitude, magnitude).astype(np.int16)


_ULAW = _ulaw_table()
_ALAW = _alaw_table()


def read_sph_header(data: bytes) -> SphInfo:
    if data[:8].rstrip() != b"NIST_1A":
        raise ValueError("not a NIST SPHERE file (missing NIST_1A magic)")
    header_bytes = int(data[8:16].split()[0])
    fields = {}
    for line in data[16:header_bytes].decode("ascii", "replace").splitlines():
        line = line.strip()
        if not line or line.startswith(";"):
            continue
        if line == "end_head":
            break
        parts = line.split(None, 2)
        if len(parts) == 3 and parts[1].startswith("-"):
            fields[parts[0]] = parts[2]
    coding = fields.get("sample_coding", "pcm").lower()
    byte_format = fields.get("sample_byte_format", "01")
    return SphInfo(
        sample_rate=int(fields.get("sample_rate", 16000)),
        channels=int(fields.get("channel_count", 1)),
        sample_count=int(fields.get("sample_count", 0)),
        coding=coding,
        sample_bytes=int(fields.get("sample_n_bytes", 2)),
        big_endian=byte_format == "10",
        header_bytes=header_bytes,
    )


def read_sph(path: str):
    """Decode a SPHERE file -> (float32 array [n] or [n, channels] in
    [-1, 1], sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    info = read_sph_header(data)
    if "shorten" in info.coding:
        raise ValueError(
            f"{path}: embedded-shorten SPHERE compression is not supported; "
            "decompress with the LDC `w` tool first"
        )
    body = data[info.header_bytes :]
    if info.coding.startswith("pcm"):
        if info.sample_bytes == 2:
            dtype = ">i2" if info.big_endian else "<i2"
            pcm = np.frombuffer(body, dtype=dtype,
                                count=info.sample_count * info.channels)
            audio = pcm.astype(np.float32) / 32768.0
        elif info.sample_bytes == 1:
            pcm = np.frombuffer(body, dtype=np.int8,
                                count=info.sample_count * info.channels)
            audio = pcm.astype(np.float32) / 128.0
        else:
            raise ValueError(f"unsupported pcm width {info.sample_bytes}")
    elif info.coding.startswith("ulaw") or info.coding.startswith("mu-law"):
        raw = np.frombuffer(body, dtype=np.uint8,
                            count=info.sample_count * info.channels)
        audio = _ULAW[raw].astype(np.float32) / 32768.0
    elif info.coding.startswith("alaw"):
        raw = np.frombuffer(body, dtype=np.uint8,
                            count=info.sample_count * info.channels)
        audio = _ALAW[raw].astype(np.float32) / 32768.0
    else:
        raise ValueError(f"unsupported SPHERE coding {info.coding!r}")
    if info.channels > 1:
        audio = audio.reshape(-1, info.channels)
    return audio, info.sample_rate


def write_sph(path: str, audio: np.ndarray, rate: int,
              coding: str = "pcm", big_endian: bool = False) -> None:
    """Encode float audio as a SPHERE file (test fixtures / tooling)."""
    audio = np.asarray(audio)
    channels = 1 if audio.ndim == 1 else audio.shape[-1]
    n = audio.shape[0]
    if coding == "pcm":
        body = (
            np.clip(audio * 32768.0, -32768, 32767)
            .astype(">i2" if big_endian else "<i2")
            .tobytes()
        )
        sample_bytes = 2
    elif coding == "ulaw":
        pcm = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
        body = _encode_ulaw(pcm).tobytes()
        sample_bytes = 1
    else:
        raise ValueError(coding)
    header = [
        "NIST_1A", "   1024",
        f"sample_rate -i {rate}",
        f"channel_count -i {channels}",
        f"sample_count -i {n}",
        f"sample_n_bytes -i {sample_bytes}",
        f"sample_byte_format -s2 {'10' if big_endian else '01'}",
        f"sample_coding -s{len(coding)} {coding}",
        "end_head",
    ]
    head = ("\n".join(header) + "\n").encode("ascii")
    with open(path, "wb") as f:
        f.write(head + b" " * (1024 - len(head)) + body)


def _encode_ulaw(pcm: np.ndarray) -> np.ndarray:
    x = pcm.astype(np.int32)
    sign = np.where(x < 0, 0x80, 0)
    mag = np.minimum(np.abs(x) + 0x84, 0x7FFF)
    exponent = (np.floor(np.log2(mag)) - 7).astype(np.int32)
    mantissa = (mag >> (exponent + 3)) & 0x0F
    return (~(sign | (exponent << 4) | mantissa) & 0xFF).astype(np.uint8)


def sph_to_wav(sph_path: str, wav_path: str, desired_rate: int | None = None,
               channel: int | None = None) -> None:
    """Convert SPHERE -> 16-bit mono wav (the importers' sox replacement).
    For multi-channel files, `channel` selects one (None averages)."""
    from stt_tpu_torch.data.audio import resample, write_wav

    audio, rate = read_sph(sph_path)
    if audio.ndim == 2:
        audio = audio[:, channel] if channel is not None else audio.mean(axis=1)
    if desired_rate and rate != desired_rate:
        audio = resample(audio, rate, desired_rate)
        rate = desired_rate
    write_wav(wav_path, audio, rate)
