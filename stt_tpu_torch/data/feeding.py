"""Sample stream -> padded Batch stream (the counterpart of
`stt_tpu.data.feeding`).

Per-sample MFCC features on the host CPU (the port's own frontend), with
the reference's augmentations when training (`data.augmentations`: sample
domain on the audio, then signal, spectrogram and features domains around
the frontend's two halves), audio at another rate resampled first, label
encoding with an error that names the sample, duration-sorted batches, the
epoch-seeded batch shuffle `random.Random(563 + epoch)`, time padded to a
multiple of `pad_time_to` (16) and labels to `pad_labels_to` (8). Batches
hold CPU tensors; the trainer moves them to the card.

`device_featurize` batches carry raw audio instead, padded so that the
frontend gives exactly the padded frame count, and the MFCC runs on the
card inside the train step (`train.step.make_train_step_audio`).

`num_workers` > 1 featurizes a batch's rows on a thread pool and
`prefetch` > 0 assembles batches ahead on a producer thread; every
sample's augmentation RNG is seeded by (sample id, clock), so the batches
are those of the serial path. `feature_cache` (a
`data.feature_cache.FeatureCache`) serves rows it holds and fills the rest.

`row_range` featurizes only those rows of every global batch (one
process's share in data-parallel training); `device_augment` (a
`data.device_augment.DeviceAugmentPipeline`) stops the host's work at the
spectrogram and yields the drawn augmentation parameters beside each batch,
for the chain to run on the card.
"""

from __future__ import annotations

import random
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from stt_tpu_torch.alphabet import Alphabet
from stt_tpu_torch.data.audio import resample
from stt_tpu_torch.data.augmentations import (
    Augmentation,
    apply_graph_augmentations,
    apply_sample_augmentations,
)
from stt_tpu_torch.data.sources import Sample, samples_from_sources
from stt_tpu_torch.frontend import FeatureConfig, audio_to_mfcc, mfcc_from_spectrogram, spectrogram
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


def _at_rate(sample: Sample, feature_config: FeatureConfig) -> Sample:
    """The sample at the frontend's rate (a new Sample when resampled)."""
    if sample.rate == feature_config.sample_rate:
        return sample
    return Sample(
        sample_id=sample.sample_id,
        transcript=sample.transcript,
        duration_hint=sample.duration_hint,
        _audio=resample(np.asarray(sample.audio, np.float32), sample.rate,
                        feature_config.sample_rate),
        _rate=feature_config.sample_rate,
    )


def featurize_sample(
    sample: Sample,
    feature_config: FeatureConfig,
    augmentations: Sequence[Augmentation] = (),
    train_phase: bool = False,
    clock: float = 0.0,
) -> np.ndarray:
    """One utterance -> [T, n_mfcc] float32 features, on the CPU (with
    augmentation when training)."""
    sample = _at_rate(sample, feature_config)
    if train_phase and augmentations:
        sample = apply_sample_augmentations(sample, augmentations, clock=clock)
        audio = np.asarray(sample.audio, np.float32)
        audio = apply_graph_augmentations("signal", audio, augmentations, clock=clock)
        spec = spectrogram(torch.from_numpy(np.asarray(audio, np.float32)), feature_config).numpy()
        spec = apply_graph_augmentations("spectrogram", spec, augmentations, clock=clock)
        feats = mfcc_from_spectrogram(
            torch.from_numpy(np.maximum(spec, 0.0).astype(np.float32)), feature_config).numpy()
        feats = apply_graph_augmentations("features", feats, augmentations, clock=clock)
        return np.asarray(feats, np.float32)
    audio = torch.from_numpy(np.asarray(sample.audio, np.float32))
    return audio_to_mfcc(audio, feature_config).numpy()


def prepare_sample_audio(
    sample: Sample,
    feature_config: FeatureConfig,
    augmentations: Sequence[Augmentation] = (),
    train_phase: bool = False,
    clock: float = 0.0,
) -> np.ndarray:
    """Host half of the device-featurize path: the rate, then the sample-
    and signal-domain augmentations; the MFCC runs on the card inside the
    train step."""
    sample = _at_rate(sample, feature_config)
    if train_phase and augmentations:
        sample = apply_sample_augmentations(sample, augmentations, clock=clock)
        audio = np.asarray(sample.audio, np.float32)
        return apply_graph_augmentations("signal", audio, augmentations, clock=clock)
    return np.asarray(sample.audio, np.float32)


def featurize_sample_spectrogram(
    sample: Sample,
    feature_config: FeatureConfig,
    augmentations: Sequence[Augmentation] = (),
    clock: float = 0.0,
) -> np.ndarray:
    """Host half of the on-device augmentation path: the rate, the sample-
    and signal-domain augmentations and the power spectrogram [T, n_bins];
    the spectrogram- and features-domain transforms and the MFCC run on the
    card (`data.device_augment`)."""
    sample = apply_sample_augmentations(_at_rate(sample, feature_config), augmentations,
                                        clock=clock)
    audio = apply_graph_augmentations("signal", np.asarray(sample.audio, np.float32),
                                      augmentations, clock=clock)
    return spectrogram(torch.from_numpy(np.asarray(audio, np.float32)), feature_config).numpy()


def _round_up(x: int, m: int) -> int:
    return max(m, ((x + m - 1) // m) * m)


def create_batches(
    sources: Union[Iterable[str], List[Sample]],
    alphabet: Alphabet,
    feature_config: FeatureConfig = FeatureConfig(),
    batch_size: int = 1,
    augmentations: Sequence[Augmentation] = (),
    train_phase: bool = False,
    epoch: int = 0,
    total_epochs: int = 1,
    reverse: bool = False,
    limit: int = 0,
    drop_remainder: bool = False,
    pad_time_to: int = 16,
    pad_labels_to: int = 8,
    shuffle_batches: bool = True,
    row_range: Optional[Tuple[int, int]] = None,
    num_workers: int = 0,
    prefetch: int = 0,
    device_augment=None,
    device_featurize: bool = False,
    feature_cache=None,
    feature_dtype=None,
) -> Iterator[tuple]:
    """Yield (padded Batch, sample ids), or with device_augment in the
    training phase (Batch of spectrograms, sample ids, drawn parameters).

    reverse/limit give the longest-first dummy run that finds an
    out-of-memory batch before training starts. A sample's augmentation
    clock is (epoch + row / rows) / total_epochs.

    device_featurize: spectrogram- and features-domain augmentations are
    refused (the features never exist on the host).

    feature_cache: rows found in it skip decode and featurize; rows made
    this epoch fill it, and a completed epoch finalizes (persists) it. It
    is ignored for device_featurize and for the reversed or limited dummy
    run, since rows are keyed by their position in the ascending sort.

    feature_dtype: a torch dtype for the feature batch (torch.bfloat16
    halves the bytes uploaded to a bf16 train step, which casts its
    features at its first op anyway); None keeps float32.

    row_range=(start, end): only rows [start, end) of every global batch
    (the composition, sort and shuffle of the batches are the same in
    every process); empty shares are skipped, and the feature cache is not
    finalized, since it holds only these rows.

    device_augment: the training batches carry power spectrograms [B, T,
    n_bins] after the sample- and signal-domain augmentations, and each
    yield adds the batch's drawn parameters (`DeviceAugmentPipeline.stack`)
    for the spectrogram and features chains on the card; the feature cache
    is not used."""
    if isinstance(sources, (list, tuple)) and sources and isinstance(sources[0], Sample):
        samples = list(sources)
    else:
        samples = list(samples_from_sources(list(sources), labeled=True))
    for aug in augmentations:
        aug.start()

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

    clock_base = epoch / max(total_epochs, 1)
    clock_span = 1.0 / max(total_epochs, 1)
    total = max(len(samples), 1)

    if device_featurize:
        bad = [a for a in augmentations
               if getattr(a, "domain", None) in ("spectrogram", "features")]
        if bad:
            raise ValueError(
                "device_featurize cannot apply host graph augmentations "
                f"in the spectrogram/features domains: {bad}; use "
                "--graph_augs_on_device for those"
            )
    spectrograms = device_augment is not None and train_phase
    cache = feature_cache
    if cache is not None and (device_featurize or device_augment is not None or reverse
                              or limit):
        cache = None

    def featurize_row(args):
        row, sample = args
        clock = clock_base + clock_span * (row / total)
        if cache is not None:
            hit = cache.get(row)
            if hit is not None:
                return hit[0], hit[1], None
        labels = text_to_char_array(sample.transcript, alphabet, context=sample.sample_id)
        if spectrograms:
            spec = featurize_sample_spectrogram(sample, feature_config, augmentations, clock)
            return spec, labels, device_augment.draw_sample(sample.sample_id, spec.shape[0],
                                                            clock)
        if device_featurize:
            return prepare_sample_audio(
                sample, feature_config, augmentations, train_phase, clock), labels, None
        feats = featurize_sample(sample, feature_config, augmentations, train_phase, clock)
        if cache is not None:
            cache.put(row, feats, labels)
        return feats, labels, None

    def batch_tasks():
        for batch_index in order:
            start = batch_index * batch_size
            rows = list(enumerate(samples[start:start + batch_size], start))
            if row_range is not None:
                rows = rows[row_range[0]:row_range[1]]
                if not rows:
                    continue
            yield rows

    def assemble(rows, results):
        ids = [sample.sample_id for _, sample in rows]
        feats_list = [feats for feats, _, _ in results]
        labels_list = [labels for _, labels, _ in results]
        if device_featurize and not spectrograms:
            return _audio_batch(feats_list, labels_list, feature_config, pad_time_to,
                                pad_labels_to), ids
        width = feature_config.n_bins if spectrograms else feature_config.n_mfcc
        batch = _feature_batch(feats_list, labels_list, width, pad_time_to, pad_labels_to)
        if spectrograms:
            return batch, ids, device_augment.stack([drawn for _, _, drawn in results])
        if feature_dtype is not None:
            batch = batch._replace(features=batch.features.to(feature_dtype))
        return batch, ids

    try:
        if num_workers > 1 or prefetch > 0:
            yield from _pipelined_batches(batch_tasks(), featurize_row, assemble,
                                          max(1, num_workers), max(1, prefetch))
        else:
            for rows in batch_tasks():
                yield assemble(rows, [featurize_row(r) for r in rows])
        if cache is not None and row_range is None:
            cache.finalize(len(samples))  # a full epoch: freeze and persist
    finally:
        for aug in augmentations:
            aug.stop()


def _pipelined_batches(tasks, featurize_row, assemble, num_workers: int, prefetch: int):
    """A producer thread featurizes each batch's rows on a pool of
    `num_workers` threads and queues up to `prefetch` assembled batches; an
    error in it is raised in the consumer, and a consumer that stops early
    stops it."""
    import queue
    import threading
    from concurrent.futures import ThreadPoolExecutor

    ready: "queue.Queue" = queue.Queue(maxsize=prefetch)
    done = object()
    stop = threading.Event()  # the consumer abandoned the generator

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                ready.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            with ThreadPoolExecutor(max_workers=num_workers) as pool:
                for rows in tasks:
                    if stop.is_set():
                        return
                    results = list(pool.map(featurize_row, rows))
                    if not offer(assemble(rows, results)):
                        return
            offer(done)
        except BaseException as exc:  # surfaces in the consumer
            offer(exc)

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    try:
        while True:
            item = ready.get()
            if item is done:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        thread.join(timeout=5.0)


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
