"""ctypes binding of the native CTC beam decoder
(`stt_tpu_torch/native/ctc_decoder.cpp`), the counterpart of
`stt_tpu.decode.native`.

The C++ decoder has the semantics of the Python `DecoderState` in
beam.py (C++ beam bookkeeping, and its own KenLM and ConstFst readers for
.scorer packages), ~100x faster. It is host code: g++ builds it at first
use into `build/native/libstt_decoder.so` at the root of the checkout,
and again whenever the source is newer than the library or the command
differs from the one that built it (`native_build.build_if_stale`).
ctypes releases the GIL around each call, so threads decode utterances
concurrently.

There is no fallback: when the library cannot be built or loaded, every
call that needs it raises RuntimeError with the compiler's message.
`implementation="python"` (beam.make_decoder_state) is the explicit way
to the Python decoder.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from stt_tpu_torch.decode.beam import DecodeResult
from stt_tpu_torch.native_build import BUILD, DECODER_SOURCE, build_if_stale

SOURCE = DECODER_SOURCE
LIBRARY = BUILD / "libstt_decoder.so"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
MAX_TOKENS = 65536  # decode()'s output buffer, tokens over all results

_lock = threading.Lock()
# (source, library) -> the loaded library, or why it could not be built
_loaded: Dict[Tuple[str, str], Union[ctypes.CDLL, str]] = {}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int, c_double, c_float, c_void_p, c_char_p = (
        ctypes.c_int, ctypes.c_double, ctypes.c_float, ctypes.c_void_p, ctypes.c_char_p)
    p_int, p_float = ctypes.POINTER(c_int), ctypes.POINTER(c_float)
    signatures = {
        "decoder_create": (c_void_p, [c_char_p, c_int, c_int, c_int, c_double, c_int]),
        "decoder_add_hot_word": (None, [c_void_p, c_char_p, c_float]),
        "decoder_next": (None, [c_void_p, ctypes.POINTER(c_double), c_int, c_int]),
        "decoder_next_pruned": (None, [c_void_p, p_int, p_float, p_int, p_float, c_int, c_int]),
        "decoder_decode": (c_int, [c_void_p, c_int, p_int, p_int, p_int,
                                   ctypes.POINTER(c_double), c_int]),
        "decoder_reset": (None, [c_void_p]),
        "decoder_free": (None, [c_void_p]),
        "scorer_validate": (c_int, [c_char_p]),
        "scorer_create": (c_void_p, [c_char_p]),
        "decoder_attach_scorer": (None, [c_void_p, c_void_p, c_double, c_double]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def library() -> ctypes.CDLL:
    """The native decoder library, built if needed; raises RuntimeError
    (with the compiler's message) when it cannot be built or loaded."""
    key = (str(SOURCE), str(LIBRARY))
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            try:
                build_if_stale(["g++", *CXX_FLAGS, str(SOURCE)], [SOURCE], LIBRARY,
                               "the native decoder")
                lib = _bind(ctypes.CDLL(str(LIBRARY)))
            except (RuntimeError, OSError) as e:
                lib = str(e)
            _loaded[key] = lib
    if isinstance(lib, str):
        raise RuntimeError(lib)
    return lib


def native_available() -> bool:
    return native_build_error() is None


def native_build_error() -> Optional[str]:
    """None when the library loads, else why it does not."""
    try:
        library()
    except RuntimeError as e:
        return str(e)
    return None


# scorer packages parsed once and shared read-only across decoder
# instances (path -> native handle). The per-decoder alpha/beta live in
# the decoder, so sharing is safe; a batch fan-out attaches one parsed
# copy per utterance instead of re-reading the file each time.
_scorer_cache: Dict[str, int] = {}


def _shared_scorer(lib, path: str) -> int:
    with _lock:
        handle = _scorer_cache.get(path)
        if handle is None:
            handle = lib.scorer_create(path.encode())
            if not handle:
                raise ValueError(f"native scorer load failed: {path}")
            _scorer_cache[path] = handle
        return handle


def labels_blob(alphabet) -> bytes:
    """The labels as the C ABI takes them: per label a little-endian
    uint16 byte length, then its UTF-8 bytes."""
    return b"".join(
        struct.pack("<H", len(lab.encode("utf-8"))) + lab.encode("utf-8")
        for lab in alphabet.labels
    )


class NativeDecoderState:
    """Same interface as beam.DecoderState, natively backed.

    The scorer is given by path (the native library reads the .scorer
    package itself) rather than as a Python object; alpha or beta None
    keeps the package's own value."""

    def __init__(
        self,
        alphabet,
        beam_size: int,
        cutoff_prob: float = 1.0,
        cutoff_top_n: int = 40,
        scorer_path: Optional[str] = None,
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        hot_words: Optional[Dict[str, float]] = None,
    ):
        lib = library()
        self._lib = lib
        self.alphabet = alphabet
        self._handle = lib.decoder_create(
            labels_blob(alphabet), alphabet.size, alphabet.space_index, beam_size,
            cutoff_prob, cutoff_top_n,
        )
        if scorer_path:
            nan = float("nan")  # the C side keeps the package's value
            lib.decoder_attach_scorer(
                self._handle, _shared_scorer(lib, scorer_path),
                nan if alpha is None else alpha,
                nan if beta is None else beta,
            )
        for word, boost in (hot_words or {}).items():
            lib.decoder_add_hot_word(self._handle, word.encode(), boost)

    def next(self, probs: np.ndarray) -> None:
        probs = np.ascontiguousarray(probs, np.float64)
        if probs.ndim != 2 or probs.shape[1] <= self.alphabet.size:
            raise ValueError(
                f"probs must be [T, C] with a blank column at {self.alphabet.size}, "
                f"got {probs.shape}"
            )
        t, c = probs.shape
        self._lib.decoder_next(
            self._handle,
            probs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            t, c,
        )

    def next_pruned(self, indices, logps, counts, blank_probs) -> None:
        """Advance over device-pruned emissions (decode/device.py
        prune_emissions): indices/logps [T, K], counts/blank_probs [T]."""
        indices = np.ascontiguousarray(indices, np.int32)
        logps = np.ascontiguousarray(logps, np.float32)
        counts = np.ascontiguousarray(counts, np.int32)
        blank_probs = np.ascontiguousarray(blank_probs, np.float32)
        if (indices.ndim != 2 or logps.shape != indices.shape
                or counts.shape != indices.shape[:1] or blank_probs.shape != counts.shape):
            raise ValueError(
                f"pruned emissions must be [T, K] indices and logps and [T] counts "
                f"and blank probabilities, got {indices.shape}, {logps.shape}, "
                f"{counts.shape}, {blank_probs.shape}"
            )
        t, k = indices.shape
        if t and not (0 <= counts.min() and counts.max() <= k):
            raise ValueError(f"counts must lie in [0, {k}]")
        self._lib.decoder_next_pruned(
            self._handle,
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            logps.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            blank_probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            t, k,
        )

    def decode(self, num_results: int = 1) -> List[DecodeResult]:
        tokens = np.zeros(MAX_TOKENS, np.int32)
        timesteps = np.zeros(MAX_TOKENS, np.int32)
        lengths = np.zeros(num_results, np.int32)
        confidences = np.zeros(num_results, np.float64)
        n = self._lib.decoder_decode(
            self._handle, num_results,
            tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            timesteps.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            confidences.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            MAX_TOKENS,
        )
        results = []
        pos = 0
        for i in range(n):
            length = int(lengths[i])
            toks = tokens[pos : pos + length].tolist()
            steps = timesteps[pos : pos + length].tolist()
            pos += length
            results.append(
                DecodeResult(
                    confidence=float(confidences[i]),
                    transcript=self.alphabet.decode(toks),
                    tokens=toks,
                    timesteps=steps,
                )
            )
        return results

    def reset(self) -> None:
        self._lib.decoder_reset(self._handle)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.decoder_free(self._handle)
            self._handle = None


def validate_scorer(path: str) -> bool:
    """Whether the native library parses the .scorer package at `path`."""
    return library().scorer_validate(path.encode()) == 0
