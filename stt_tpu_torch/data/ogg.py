"""Ogg container prober: codec, channels, rate, and exact duration
without decoding.

The reference probes Ogg/Opus duration through pyogg's op_pcm_total
(bin/import_mls.py read_ogg_opus_duration) and reads audio format info
via pyogg/miniaudio (util/audio.py). Neither codec library exists in
this build, but duration/format probing needs only the container: the
identification header (OpusHead / \\x01vorbis) gives channels+rate, and
the final page's granule position gives total samples (Opus granules
are always 48 kHz; subtract the OpusHead pre-skip).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional


@dataclasses.dataclass
class OggInfo:
    codec: str  # "opus" | "vorbis" | "unknown"
    channels: int
    sample_rate: int  # of the original input (decode rate for vorbis)
    duration_seconds: float
    pre_skip: int = 0


def _iter_pages(data: bytes):
    """Yield (granule, serial, body) per Ogg page."""
    pos = 0
    n = len(data)
    while pos + 27 <= n:
        idx = data.find(b"OggS", pos)
        if idx < 0:
            return
        if idx + 27 > n:
            return
        granule, serial = struct.unpack_from("<qI", data, idx + 6)
        nsegs = data[idx + 26]
        seg_table = data[idx + 27 : idx + 27 + nsegs]
        body_len = sum(seg_table)
        body_start = idx + 27 + nsegs
        yield granule, serial, data[body_start : body_start + body_len]
        pos = body_start + body_len


def ogg_packets(data: bytes):
    """Reassemble the logical packets of the FIRST stream in an Ogg
    container (lacing values; 255 means continued, <255 ends a packet;
    packets may span pages via the continuation flag). Yields
    (packet_bytes, granule_of_its_page)."""
    target_serial = None
    partial = b""
    pos = 0
    n = len(data)
    while pos + 27 <= n:
        idx = data.find(b"OggS", pos)
        if idx < 0 or idx + 27 > n:
            break
        granule, serial = struct.unpack_from("<qI", data, idx + 6)
        nsegs = data[idx + 26]
        seg_table = data[idx + 27 : idx + 27 + nsegs]
        body = idx + 27 + nsegs
        if target_serial is None:
            target_serial = serial
        if serial == target_serial:
            off = body
            for seg in seg_table:
                partial += data[off : off + seg]
                off += seg
                if seg < 255:
                    yield partial, granule
                    partial = b""
        pos = body + sum(seg_table)
    if partial:
        yield partial, -1


def probe_ogg(data: bytes) -> OggInfo:
    codec = "unknown"
    channels = 0
    rate = 48000
    pre_skip = 0
    audio_serial: Optional[int] = None
    last_granule = 0
    first_granule: Optional[int] = None

    for granule, serial, body in _iter_pages(data):
        if codec == "unknown" or audio_serial is None:
            if body.startswith(b"OpusHead"):
                codec = "opus"
                audio_serial = serial
                channels = body[9]
                pre_skip, input_rate = struct.unpack_from("<HI", body, 10)
                rate = input_rate or 48000
                continue
            if body.startswith(b"\x01vorbis"):
                codec = "vorbis"
                audio_serial = serial
                channels = body[11]
                rate, = struct.unpack_from("<I", body, 12)
                continue
        if serial == audio_serial and granule >= 0:
            if granule > 0 and first_granule is None:
                first_granule = granule
            last_granule = max(last_granule, granule)

    if codec == "opus":
        # granules are 48 kHz regardless of input rate; pre-skip samples
        # are decoder warm-up, not audio (RFC 7845 §4.1)
        duration = max(last_granule - pre_skip, 0) / 48000.0
    elif codec == "vorbis":
        duration = last_granule / float(rate or 1)
    else:
        raise ValueError("no Opus/Vorbis stream found in Ogg container")
    return OggInfo(
        codec=codec,
        channels=channels,
        sample_rate=rate,
        duration_seconds=duration,
        pre_skip=pre_skip,
    )


def probe_ogg_file(path: str) -> OggInfo:
    with open(path, "rb") as f:
        return probe_ogg(f.read())


def read_ogg_opus_duration(path: str) -> float:
    """Drop-in for the reference's pyogg-based prober
    (bin/import_mls.py:75-95)."""
    info = probe_ogg_file(path)
    return info.duration_seconds
