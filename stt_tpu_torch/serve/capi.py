"""Build of the port's C API: `libstt_tpu_torch.so` (`native/stt_c_api.cpp`,
the `STT_*` functions of `native/stt_tpu.h` over `serve.cbridge`) and the
`stt_client` program linked against it (`native/stt_client.c`).

Both are built at first use into `build/native/` at the root of the
checkout, as the native decoder is (`native_build.build_if_stale`), and
again when a source is newer or the Python that runs the build is another:
the library embeds that Python (its headers and `libpython` from
`sysconfig`, and its executable, so an interpreter that the library boots
in a C program finds the same `sys.path`, a virtual environment's
included). The client finds the library beside itself (rpath $ORIGIN).
No fallback: a failed build raises RuntimeError with the compiler's message.

From C: `#include "stt_tpu.h"`, link `-lstt_tpu_torch`, and set PYTHONPATH
to the root of the checkout. From Python, `load()` gives the library bound
with ctypes in the running interpreter (`cbridge.set_device("cpu")` then
serves on the CPU), and `take_string` / `take_metadata` read and free what
it returns.
"""

from __future__ import annotations

import ctypes
import sys
import sysconfig
import threading
from pathlib import Path
from typing import List

from stt_tpu_torch.native_build import BUILD, NATIVE, build_if_stale

SOURCE = NATIVE / "stt_c_api.cpp"
HEADER = NATIVE / "stt_tpu.h"
CLIENT_SOURCE = NATIVE / "stt_client.c"
LIBRARY = BUILD / "libstt_tpu_torch.so"
CLIENT = BUILD / "stt_client"

_lock = threading.Lock()


def library_command() -> List[str]:
    """g++'s command for the library, against the Python running it."""
    include = sysconfig.get_config_var("INCLUDEPY")
    libdir = sysconfig.get_config_var("LIBDIR")
    python = f"python{sysconfig.get_config_var('LDVERSION')}"
    return ["g++", "-O3", "-std=c++17", "-fPIC", "-Wall", "-shared", f"-I{include}",
            f'-DSTT_PYTHON_EXECUTABLE="{sys.executable}"', str(SOURCE), f"-L{libdir}",
            f"-l{python}", f"-Wl,-rpath,{libdir}"]


def client_command() -> List[str]:
    return ["gcc", "-O2", "-Wall", f"-I{NATIVE}", str(CLIENT_SOURCE), f"-L{BUILD}",
            "-lstt_tpu_torch", "-Wl,-rpath,$ORIGIN"]


def library() -> Path:
    """The path of libstt_tpu_torch.so, built if needed."""
    with _lock:
        build_if_stale(library_command(), [SOURCE, HEADER], LIBRARY, "the C API library")
    return LIBRARY


def client() -> Path:
    """The path of stt_client, built (and the library first) if needed."""
    library()
    with _lock:
        build_if_stale(client_command(), [CLIENT_SOURCE, HEADER, LIBRARY], CLIENT,
                       "the C API client")
    return CLIENT


class TokenMetadata(ctypes.Structure):
    _fields_ = [("text", ctypes.c_char_p), ("timestep", ctypes.c_uint),
                ("start_time", ctypes.c_float)]


class CandidateTranscript(ctypes.Structure):
    _fields_ = [("tokens", ctypes.POINTER(TokenMetadata)), ("num_tokens", ctypes.c_uint),
                ("confidence", ctypes.c_double)]


class Metadata(ctypes.Structure):
    _fields_ = [("transcripts", ctypes.POINTER(CandidateTranscript)),
                ("num_transcripts", ctypes.c_uint)]


def load() -> ctypes.CDLL:
    """libstt_tpu_torch.so (built if needed) loaded into this interpreter,
    with each STT_* function's argument and result types declared."""
    lib = ctypes.CDLL(str(library()))
    p_void, p_short, p_meta = ctypes.c_void_p, ctypes.POINTER(ctypes.c_short), ctypes.POINTER(Metadata)
    c_int, c_uint, c_float, c_char_p = ctypes.c_int, ctypes.c_uint, ctypes.c_float, ctypes.c_char_p
    signatures = {
        "STT_CreateModel": (c_int, [c_char_p, ctypes.POINTER(p_void)]),
        "STT_FreeModel": (None, [p_void]),
        "STT_GetModelBeamWidth": (c_uint, [p_void]),
        "STT_SetModelBeamWidth": (c_int, [p_void, c_uint]),
        "STT_GetModelSampleRate": (c_int, [p_void]),
        "STT_EnableExternalScorer": (c_int, [p_void, c_char_p]),
        "STT_DisableExternalScorer": (c_int, [p_void]),
        "STT_SetScorerAlphaBeta": (c_int, [p_void, c_float, c_float]),
        "STT_AddHotWord": (c_int, [p_void, c_char_p, c_float]),
        "STT_EraseHotWord": (c_int, [p_void, c_char_p]),
        "STT_ClearHotWords": (c_int, [p_void]),
        "STT_SpeechToText": (p_void, [p_void, p_short, c_uint]),
        "STT_SpeechToTextWithMetadata": (p_meta, [p_void, p_short, c_uint, c_uint]),
        "STT_CreateStream": (c_int, [p_void, ctypes.POINTER(p_void)]),
        "STT_FeedAudioContent": (None, [p_void, p_short, c_uint]),
        "STT_IntermediateDecode": (p_void, [p_void]),
        "STT_IntermediateDecodeWithMetadata": (p_meta, [p_void, c_uint]),
        "STT_FinishStream": (p_void, [p_void]),
        "STT_FinishStreamWithMetadata": (p_meta, [p_void, c_uint]),
        "STT_FreeStream": (None, [p_void]),
        "STT_FreeMetadata": (None, [p_meta]),
        "STT_FreeString": (None, [p_void]),
        "STT_Version": (p_void, []),
        "STT_ErrorCodeToErrorMessage": (p_void, [c_int]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def take_string(lib: ctypes.CDLL, ptr) -> str:
    """A char* the C API returned, as str; frees it. Raises on NULL."""
    if not ptr:
        raise RuntimeError("the C API returned no string")
    text = ctypes.string_at(ptr).decode("utf-8")
    lib.STT_FreeString(ptr)
    return text


def take_metadata(lib: ctypes.CDLL, ptr) -> list:
    """A Metadata* the C API returned, as cbridge's tuples
    [(confidence, [(text, timestep, start_time), ...]), ...]; frees it.
    Raises on NULL."""
    if not ptr:
        raise RuntimeError("the C API returned no metadata")
    out = []
    for i in range(ptr.contents.num_transcripts):
        cand = ptr.contents.transcripts[i]
        tokens = [(cand.tokens[j].text.decode("utf-8"), cand.tokens[j].timestep,
                   cand.tokens[j].start_time) for j in range(cand.num_tokens)]
        out.append((cand.confidence, tokens))
    lib.STT_FreeMetadata(ptr)
    return out


def pcm_pointer(pcm) -> "ctypes._Pointer":
    """A C-contiguous int16 numpy array as the short* the C API takes; the
    caller keeps the array alive over the call."""
    if pcm.dtype.str != "<i2" or not pcm.flags.c_contiguous:
        raise ValueError("the C API takes C-contiguous 16-bit little-endian PCM")
    return pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_short))
