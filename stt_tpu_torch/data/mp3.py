"""MP3 decode via a ctypes binding over the system libmpg123.

The reference delegates mp3 to `sox`/pydub in its importers (e.g.
bin/import_swc.py, bin/import_ccpmf.py convert mp3 corpora); here the
decode happens in-process so mp3 corpora import without external
binaries. Output is forced to signed-16 PCM and converted to the
framework's float32 [-1,1) convention.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional, Tuple

import numpy as np

_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_ENC_SIGNED_16 = 0xD0

_lib: Optional[ctypes.CDLL] = None
_lib_checked = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_checked
    if _lib_checked:
        return _lib
    _lib_checked = True
    for name in (
        "libmpg123.so.0",
        "libmpg123.so",
        ctypes.util.find_library("mpg123"),
    ):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.mpg123_init.restype = ctypes.c_int
        lib.mpg123_new.restype = ctypes.c_void_p
        lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_open.restype = ctypes.c_int
        lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.mpg123_getformat.restype = ctypes.c_int
        lib.mpg123_getformat.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.mpg123_format_none.restype = ctypes.c_int
        lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
        lib.mpg123_format.restype = ctypes.c_int
        lib.mpg123_format.argtypes = [
            ctypes.c_void_p,
            ctypes.c_long,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.mpg123_read.restype = ctypes.c_int
        lib.mpg123_read.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.mpg123_close.restype = ctypes.c_int
        lib.mpg123_close.argtypes = [ctypes.c_void_p]
        lib.mpg123_delete.restype = None
        lib.mpg123_delete.argtypes = [ctypes.c_void_p]
        lib.mpg123_init()
        _lib = lib
        return _lib
    return None


def mp3_available() -> bool:
    return _load() is not None


def read_mp3(path: str) -> Tuple[np.ndarray, int]:
    """Decode an MP3 file -> (float32 [n] or [n, channels] in [-1,1), rate)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "libmpg123 is not available on this system; MP3 decode is "
            "disabled (convert to wav/flac first)"
        )
    err = ctypes.c_int()
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed: {err.value}")
    try:
        if lib.mpg123_open(h, path.encode()) != _MPG123_OK:
            raise RuntimeError(f"cannot open mp3 file: {path}")
        rate = ctypes.c_long()
        channels = ctypes.c_int()
        encoding = ctypes.c_int()
        if (
            lib.mpg123_getformat(
                h, ctypes.byref(rate), ctypes.byref(channels),
                ctypes.byref(encoding)
            )
            != _MPG123_OK
        ):
            raise RuntimeError(f"cannot probe mp3 format: {path}")
        # lock the output to this rate/channels in signed-16
        lib.mpg123_format_none(h)
        lib.mpg123_format(h, rate.value, channels.value, _MPG123_ENC_SIGNED_16)

        buf = ctypes.create_string_buffer(65536)
        done = ctypes.c_size_t()
        chunks = []
        while True:
            rc = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(buf.raw[: done.value])
            if rc == _MPG123_DONE:
                break
            if rc not in (_MPG123_OK, _MPG123_NEW_FORMAT):
                lib.mpg123_close(h)
                raise RuntimeError(
                    f"mp3 decode error (mpg123 rc={rc}): {path}"
                )
        lib.mpg123_close(h)
    finally:
        lib.mpg123_delete(h)

    pcm = np.frombuffer(b"".join(chunks), np.int16)
    audio = pcm.astype(np.float32) / 32768.0
    if channels.value > 1:
        audio = audio.reshape(-1, channels.value)
    return audio, int(rate.value)
