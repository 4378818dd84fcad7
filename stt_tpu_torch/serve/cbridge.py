"""Python side of the C API (libstt_tpu_torch, `stt_tpu_torch/native/`):
plain functions over `stt_tpu_torch.serve` that take and return only
C-friendly values (str, bytes, int, float, tuples), so the embedding layer
never touches numpy or rich objects. The port's copy of the JAX
package's bridge, with the same functions.

PCM convention matches the reference C API: 16-bit signed little-endian
mono at the model sample rate (stt.cc:113 scales by 1/32768).

Models are created on the card. A Python caller that shares the
interpreter (the library loaded with ctypes) may ask for the CPU with
`set_device("cpu")`; the C surface has no such call, so a C program
(`stt_client`) always serves on the card, and without CUDA
`STT_CreateModel` fails with the reason printed.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from stt_tpu_torch.serve.model import Metadata, Model

_MODELS = {}
_STREAMS = {}
_NEXT = [1]
_DEVICE = ["cuda"]  # where create_model puts the models it makes


def set_device(device: str) -> None:
    """The device of the models `create_model` makes from now on: "cuda"
    (the default) or "cpu"."""
    _DEVICE[0] = device


def _register(table, obj) -> int:
    handle = _NEXT[0]
    _NEXT[0] += 1
    table[handle] = obj
    return handle


def _pcm_to_float(pcm_bytes: bytes) -> np.ndarray:
    return np.frombuffer(pcm_bytes, dtype="<i2").astype(np.float32) / 32768.0


def _metadata_tuples(metadata: Metadata) -> List[Tuple]:
    """[(confidence, [(text, timestep, start_time), ...]), ...]"""
    return [
        (
            t.confidence,
            [(tok.text, int(tok.timestep), float(tok.start_time))
             for tok in t.tokens],
        )
        for t in metadata.transcripts
    ]


# -- model ------------------------------------------------------------------


def create_model(model_path: str) -> int:
    return _register(_MODELS, Model(model_path, device=_DEVICE[0]))


def free_model(handle: int) -> None:
    _MODELS.pop(handle, None)


def get_beam_width(handle: int) -> int:
    return _MODELS[handle].beam_width


def set_beam_width(handle: int, width: int) -> None:
    _MODELS[handle].set_model_beam_width(width)


def get_sample_rate(handle: int) -> int:
    return _MODELS[handle].sample_rate()


def enable_external_scorer(handle: int, path: str) -> None:
    _MODELS[handle].enable_external_scorer(path)


def disable_external_scorer(handle: int) -> None:
    _MODELS[handle].disable_external_scorer()


def set_scorer_alpha_beta(handle: int, alpha: float, beta: float) -> None:
    _MODELS[handle].set_scorer_alpha_beta(alpha, beta)


def add_hot_word(handle: int, word: str, boost: float) -> None:
    _MODELS[handle].add_hot_word(word, boost)


def erase_hot_word(handle: int, word: str) -> None:
    _MODELS[handle].erase_hot_word(word)


def clear_hot_words(handle: int) -> None:
    _MODELS[handle].clear_hot_words()


def speech_to_text(handle: int, pcm_bytes: bytes) -> str:
    return _MODELS[handle].stt(_pcm_to_float(pcm_bytes))


def speech_to_text_with_metadata(handle: int, pcm_bytes: bytes,
                                 num_results: int) -> List[Tuple]:
    metadata = _MODELS[handle].stt_with_metadata(
        _pcm_to_float(pcm_bytes), num_results
    )
    return _metadata_tuples(metadata)


# -- stream -------------------------------------------------------------------


def create_stream(model_handle: int) -> int:
    return _register(_STREAMS, _MODELS[model_handle].create_stream())


def feed_audio_content(handle: int, pcm_bytes: bytes) -> None:
    _STREAMS[handle].feed_audio_content(_pcm_to_float(pcm_bytes))


def intermediate_decode(handle: int) -> str:
    return _STREAMS[handle].intermediate_decode()


def intermediate_decode_with_metadata(handle: int,
                                      num_results: int) -> List[Tuple]:
    return _metadata_tuples(
        _STREAMS[handle].intermediate_decode_with_metadata(num_results)
    )


def finish_stream(handle: int) -> str:
    stream = _STREAMS.pop(handle)
    return stream.finish_stream()


def finish_stream_with_metadata(handle: int, num_results: int) -> List[Tuple]:
    stream = _STREAMS.pop(handle)
    return _metadata_tuples(stream.finish_stream_with_metadata(num_results))


def free_stream(handle: int) -> None:
    _STREAMS.pop(handle, None)


def version() -> str:
    import stt_tpu_torch

    return stt_tpu_torch.__version__
