"""Sample stream -> padded Batch stream (the counterpart of
`stt_tpu.data.feeding`).

Per-sample MFCC features on the host CPU (the port's own frontend), label
encoding with an error that names the sample, duration-sorted batches,
the epoch-seeded batch shuffle `random.Random(563 + epoch)`, time padded
to a multiple of `pad_time_to` (16) and labels to `pad_labels_to` (8).
Batches hold CPU tensors; the trainer moves them to the card.

`device_featurize` batches carry raw audio instead, padded so that the
frontend gives exactly the padded frame count, and the MFCC runs on the
card inside the train step (`train.step.make_train_step_audio`).

Not ported yet (ROADMAP.md, P6): augmentations, the feature cache, and the
threaded pipeline; batches are featurized serially, which gives the same
batches as the JAX package's threads.
"""

from __future__ import annotations

import random
from typing import Iterable, Iterator, List, Tuple, Union

import numpy as np
import torch

from stt_tpu_torch.alphabet import Alphabet
from stt_tpu_torch.data.sources import Sample, samples_from_sources
from stt_tpu_torch.frontend import FeatureConfig, audio_to_mfcc
from stt_tpu_torch.train.step import Batch


def text_to_char_array(transcript: str, alphabet: Alphabet, context: str = "") -> np.ndarray:
    """Encode, with an error naming the offending sample."""
    if not alphabet.can_encode(transcript):
        missing = [ch for ch in transcript if not alphabet.can_encode_single(ch)]
        raise ValueError(
            f'Alphabet cannot encode transcript "{transcript}" while '
            f'processing sample "{context}", check that your alphabet '
            f"contains all characters in the training corpus. "
            f"Missing characters are: {missing}."
        )
    encoded = alphabet.encode(transcript)
    if len(encoded) == 0:
        raise ValueError(
            f"While processing {context}: Found an empty transcript! "
            f"You must include a transcript for all training data."
        )
    return np.asarray(encoded, np.int32)


def _checked_audio(sample: Sample, feature_config: FeatureConfig) -> np.ndarray:
    if sample.rate != feature_config.sample_rate:
        raise NotImplementedError(
            f"{sample.sample_id} is sampled at {sample.rate} Hz, the features want "
            f"{feature_config.sample_rate} Hz; resampling is not ported to "
            "stt_tpu_torch yet (ROADMAP.md, P6)"
        )
    return np.asarray(sample.audio, np.float32)


def featurize_sample(sample: Sample, feature_config: FeatureConfig) -> np.ndarray:
    """One utterance -> [T, n_mfcc] float32 features, on the CPU."""
    audio = torch.from_numpy(_checked_audio(sample, feature_config))
    return audio_to_mfcc(audio, feature_config).numpy()


def _round_up(x: int, m: int) -> int:
    return max(m, ((x + m - 1) // m) * m)


def create_batches(
    sources: Union[Iterable[str], List[Sample]],
    alphabet: Alphabet,
    feature_config: FeatureConfig = FeatureConfig(),
    batch_size: int = 1,
    augmentations=(),
    train_phase: bool = False,
    epoch: int = 0,
    reverse: bool = False,
    limit: int = 0,
    drop_remainder: bool = False,
    pad_time_to: int = 16,
    pad_labels_to: int = 8,
    shuffle_batches: bool = True,
    device_featurize: bool = False,
) -> Iterator[Tuple[Batch, List[str]]]:
    """Yield (padded Batch, sample ids).

    reverse/limit give the longest-first dummy run that finds an
    out-of-memory batch before training starts."""
    if augmentations:
        raise NotImplementedError(
            "augmentations are not ported to stt_tpu_torch yet (ROADMAP.md, P6)"
        )
    if isinstance(sources, (list, tuple)) and sources and isinstance(sources[0], Sample):
        samples = list(sources)
    else:
        samples = list(samples_from_sources(list(sources), labeled=True))

    # global duration-proxy sort (ascending); the hint falls back to audio
    samples.sort(key=lambda s: s.duration_hint or s.duration)
    if reverse:
        samples.reverse()
    if limit:
        samples = samples[:limit]

    n_batches = len(samples) // batch_size if drop_remainder else -(-len(samples) // batch_size)
    order = list(range(n_batches))
    if train_phase and shuffle_batches and not reverse:
        random.Random(563 + epoch).shuffle(order)

    for batch_index in order:
        chunk = samples[batch_index * batch_size : (batch_index + 1) * batch_size]
        ids = [s.sample_id for s in chunk]
        labels_list = [text_to_char_array(s.transcript, alphabet, s.sample_id) for s in chunk]
        if device_featurize:
            batch = _audio_batch(
                [_checked_audio(s, feature_config) for s in chunk], labels_list,
                feature_config, pad_time_to, pad_labels_to,
            )
        else:
            batch = _feature_batch(
                [featurize_sample(s, feature_config) for s in chunk], labels_list,
                feature_config.n_mfcc, pad_time_to, pad_labels_to,
            )
        yield batch, ids


def _labels(labels_list, pad_labels_to: int):
    l_max = _round_up(max(len(l) for l in labels_list), pad_labels_to)
    labels = np.zeros((len(labels_list), l_max), np.int32)
    for i, l in enumerate(labels_list):
        labels[i, : len(l)] = l
    lengths = np.array([len(l) for l in labels_list], np.int32)
    return torch.from_numpy(labels), torch.from_numpy(lengths)


def _feature_batch(feats_list, labels_list, width, pad_time_to, pad_labels_to) -> Batch:
    t_max = _round_up(max(f.shape[0] for f in feats_list), pad_time_to)
    features = np.zeros((len(feats_list), t_max, width), np.float32)
    for i, f in enumerate(feats_list):
        features[i, : f.shape[0]] = f
    lengths = np.array([f.shape[0] for f in feats_list], np.int32)
    return Batch(torch.from_numpy(features), torch.from_numpy(lengths),
                 *_labels(labels_list, pad_labels_to))


def _audio_batch(audio_list, labels_list, fc: FeatureConfig, pad_time_to, pad_labels_to) -> Batch:
    """Raw audio padded so that the frontend makes exactly
    round_up(frames, pad_time_to) frames; feature_lengths count the true
    frames (CTC masks the padding)."""
    win, step = fc.window_samples, fc.step_samples
    t_true = [max(0, (len(a) - win) // step + 1) for a in audio_list]
    t_pad = _round_up(max(max(t_true), 1), pad_time_to)
    s_pad = (t_pad - 1) * step + win
    audio = np.zeros((len(audio_list), s_pad), np.float32)
    for i, a in enumerate(audio_list):
        audio[i, : len(a)] = a[:s_pad]
    return Batch(torch.from_numpy(audio), torch.tensor(t_true, dtype=torch.int32),
                 *_labels(labels_list, pad_labels_to))
