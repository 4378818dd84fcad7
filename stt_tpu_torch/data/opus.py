"""Opus codec via a ctypes binding over the system libopus.

Counterpart of the reference's opuslib/pyogg usage
(training/coqui_stt_training/util/audio.py:375-460): raw packet
encode/decode for the Opus-in-SDB container and the Codec augmentation,
plus an Ogg Opus file decoder (RFC 7845 demux over stt_tpu_torch.data.ogg's
packet reassembly + libopus packet decode).

libopus accepts Fs in {8000, 12000, 16000, 24000, 48000}; Ogg Opus is
always decoded at 48 kHz (granule rate) and the pre-skip/gain rules of
RFC 7845 §4.1 are applied here.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional, Tuple

import numpy as np

_OPUS_APPLICATION_AUDIO = 2049
_OPUS_SET_BITRATE_REQUEST = 4002
_MAX_FRAME_48K = 5760  # 120 ms at 48 kHz, the largest legal Opus frame

_lib: Optional[ctypes.CDLL] = None
_lib_checked = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_checked
    if _lib_checked:
        return _lib
    _lib_checked = True
    for name in ("libopus.so.0", "libopus.so", ctypes.util.find_library("opus")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.opus_decoder_create.restype = ctypes.c_void_p
        lib.opus_decoder_create.argtypes = [
            ctypes.c_int32,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.opus_decode.restype = ctypes.c_int
        lib.opus_decode.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int16),
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.opus_decoder_destroy.restype = None
        lib.opus_decoder_destroy.argtypes = [ctypes.c_void_p]
        lib.opus_encoder_create.restype = ctypes.c_void_p
        lib.opus_encoder_create.argtypes = [
            ctypes.c_int32,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.opus_encode.restype = ctypes.c_int32
        lib.opus_encode.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int16),
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.c_int32,
        ]
        lib.opus_encoder_destroy.restype = None
        lib.opus_encoder_destroy.argtypes = [ctypes.c_void_p]
        lib.opus_encoder_ctl.restype = ctypes.c_int
        _lib = lib
        return _lib
    return None


def opus_available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "libopus is not available on this system; Opus decode/encode "
            "is disabled (convert audio to wav/flac/ogg-vorbis)"
        )
    return lib


class OpusDecoder:
    def __init__(self, rate: int, channels: int):
        self._lib = _require()
        err = ctypes.c_int()
        self._dec = self._lib.opus_decoder_create(
            rate, channels, ctypes.byref(err)
        )
        if not self._dec or err.value != 0:
            raise RuntimeError(f"opus_decoder_create failed: {err.value}")
        self.rate = rate
        self.channels = channels

    def decode(self, packet: bytes, max_frame: int = _MAX_FRAME_48K) -> np.ndarray:
        """Decode one Opus packet -> int16 array [n_samples, channels]."""
        out = np.empty(max_frame * self.channels, np.int16)
        n = self._lib.opus_decode(
            self._dec,
            packet,
            len(packet),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            max_frame,
            0,
        )
        if n < 0:
            raise RuntimeError(f"opus_decode failed: {n}")
        return out[: n * self.channels].reshape(-1, self.channels)

    def __del__(self):
        dec = getattr(self, "_dec", None)
        if dec:
            self._lib.opus_decoder_destroy(dec)
            self._dec = None


class OpusEncoder:
    def __init__(self, rate: int, channels: int, bitrate: Optional[int] = None):
        self._lib = _require()
        err = ctypes.c_int()
        self._enc = self._lib.opus_encoder_create(
            rate, channels, _OPUS_APPLICATION_AUDIO, ctypes.byref(err)
        )
        if not self._enc or err.value != 0:
            raise RuntimeError(f"opus_encoder_create failed: {err.value}")
        self.rate = rate
        self.channels = channels
        if bitrate is not None:
            # variadic call: without argtypes ctypes would truncate the
            # raw int handle to 32 bits — wrap it explicitly
            self._lib.opus_encoder_ctl(
                ctypes.c_void_p(self._enc),
                ctypes.c_int(_OPUS_SET_BITRATE_REQUEST),
                ctypes.c_int32(int(bitrate)),
            )

    def encode(self, pcm: np.ndarray, frame_size: int) -> bytes:
        """Encode exactly frame_size samples/channel of int16 PCM."""
        pcm = np.ascontiguousarray(pcm, np.int16)
        if pcm.size != frame_size * self.channels:
            raise ValueError(
                f"encode needs {frame_size * self.channels} samples, "
                f"got {pcm.size}"
            )
        out = ctypes.create_string_buffer(4000)
        n = self._lib.opus_encode(
            self._enc,
            pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            frame_size,
            out,
            len(out),
        )
        if n < 0:
            raise RuntimeError(f"opus_encode failed: {n}")
        return out.raw[:n]

    def __del__(self):
        enc = getattr(self, "_enc", None)
        if enc:
            self._lib.opus_encoder_destroy(enc)
            self._enc = None


def read_ogg_opus(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode an Ogg Opus container -> (float32 [n, channels] in [-1,1), 48000).

    Applies RFC 7845 pre-skip trimming, end-granule truncation, and the
    OpusHead output gain (Q7.8 dB).
    """
    from stt_tpu_torch.data.ogg import ogg_packets

    channels = None
    pre_skip = 0
    gain_q78 = 0
    decoder = None
    chunks = []
    last_granule = 0
    n_header_packets = 0
    import struct

    for packet, granule in ogg_packets(data):
        if n_header_packets == 0:
            if not packet.startswith(b"OpusHead"):
                raise ValueError("not an Ogg Opus stream (no OpusHead)")
            channels = packet[9]
            pre_skip = struct.unpack_from("<H", packet, 10)[0]
            gain_q78 = struct.unpack_from("<h", packet, 16)[0]
            decoder = OpusDecoder(48000, channels)
            n_header_packets = 1
            continue
        if n_header_packets == 1:
            # RFC 7845 §5: the comment header is identified by its
            # 'OpusTags' magic, not by position — a zero-length packet or
            # a tags header spanning several ogg packets must not shift
            # audio packets into the header slot (or vice versa).
            if packet.startswith(b"OpusTags") or not packet:
                continue
            n_header_packets = 2
        if not packet:
            continue
        chunks.append(decoder.decode(packet))
        if granule >= 0:
            last_granule = max(last_granule, granule)

    if decoder is None:
        raise ValueError("not an Ogg Opus stream (no OpusHead)")
    if not chunks:
        return np.zeros((0, channels), np.float32), 48000
    pcm = np.concatenate(chunks, axis=0)
    total = last_granule if last_granule > 0 else len(pcm)
    pcm = pcm[pre_skip : min(total, len(pcm))]
    audio = pcm.astype(np.float32) / 32768.0
    if gain_q78:
        audio *= 10.0 ** (gain_q78 / (20.0 * 256.0))
    return audio, 48000


def read_ogg_opus_file(path: str) -> Tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        return read_ogg_opus(f.read())


# --- Opus-in-SDB container (reference util/audio.py:379-423 format:
# big-endian pcm_len(4) rate(4) channels(1) width(1), then
# [chunk_len(2), opus packet] repeated; 60 ms frames) -----------------

OPUS_PCM_LEN_SIZE = 4
OPUS_RATE_SIZE = 4
OPUS_CHANNELS_SIZE = 1
OPUS_WIDTH_SIZE = 1
OPUS_CHUNK_LEN_SIZE = 2


def get_opus_frame_size(rate: int) -> int:
    return 60 * rate // 1000


def write_opus(opus_file, pcm_bytes: bytes, rate: int = 16000,
               channels: int = 1, width: int = 2,
               bitrate: Optional[int] = None) -> None:
    """Write raw int16 PCM bytes as the reference's Opus-in-SDB blob."""
    frame_size = get_opus_frame_size(rate)
    encoder = OpusEncoder(rate, channels, bitrate=bitrate)
    chunk_size = frame_size * channels * width
    opus_file.write(len(pcm_bytes).to_bytes(OPUS_PCM_LEN_SIZE, "big"))
    opus_file.write(rate.to_bytes(OPUS_RATE_SIZE, "big"))
    opus_file.write(channels.to_bytes(OPUS_CHANNELS_SIZE, "big"))
    opus_file.write(width.to_bytes(OPUS_WIDTH_SIZE, "big"))
    for i in range(0, len(pcm_bytes), chunk_size):
        chunk = pcm_bytes[i : i + chunk_size]
        if len(chunk) < chunk_size:
            chunk = chunk + b"\0" * (chunk_size - len(chunk))
        pcm = np.frombuffer(chunk, np.int16)
        encoded = encoder.encode(pcm, frame_size)
        opus_file.write(len(encoded).to_bytes(OPUS_CHUNK_LEN_SIZE, "big"))
        opus_file.write(encoded)


def read_opus(opus_file) -> Tuple[bytes, int, int, int]:
    """Read the reference's Opus-in-SDB blob -> (pcm_bytes, rate,
    channels, width)."""
    opus_file.seek(0)
    pcm_len = int.from_bytes(opus_file.read(OPUS_PCM_LEN_SIZE), "big")
    rate = int.from_bytes(opus_file.read(OPUS_RATE_SIZE), "big")
    channels = int.from_bytes(opus_file.read(OPUS_CHANNELS_SIZE), "big")
    width = int.from_bytes(opus_file.read(OPUS_WIDTH_SIZE), "big")
    frame_size = get_opus_frame_size(rate)
    decoder = OpusDecoder(rate, channels)
    out = bytearray()
    while len(out) < pcm_len:
        chunk_len = int.from_bytes(opus_file.read(OPUS_CHUNK_LEN_SIZE), "big")
        packet = opus_file.read(chunk_len)
        if not packet:
            break
        out.extend(decoder.decode(packet, max_frame=frame_size).tobytes())
    return bytes(out[:pcm_len]), rate, channels, width


def codec_round_trip(audio: np.ndarray, rate: int, bitrate: int) -> np.ndarray:
    """Encode float32 mono audio through Opus at `bitrate` and decode it
    back — the Codec augmentation's lossy round trip
    (reference augmentations.py:366-383)."""
    pcm = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
    from stt_tpu_torch.data.opus import write_opus, read_opus  # self, for clarity
    import io

    buf = io.BytesIO()
    write_opus(buf, pcm.tobytes(), rate=rate, channels=1, width=2,
               bitrate=bitrate)
    buf.seek(0)
    out_bytes, out_rate, _, _ = read_opus(buf)
    out = np.frombuffer(out_bytes, np.int16).astype(np.float32) / 32768.0
    return out[: len(audio)]
