"""Data augmentation: parsing, scheduling, and the two augmentation
families (a copy of `stt_tpu.data.augmentations`).

Parity surface: util/augmentations.py —
- spec strings like "reverb[p=0.5,delay=20.0~5]" with ValueRange params
  swept by the training "clock" (epoch progress 0->1) for curriculum;
- SampleAugmentations mutate raw audio on the host (overlay, reverb,
  resample, normalize_sample_rate, volume, codec — a lossy Opus round
  trip through the system libopus);
- GraphAugmentations transform per-utterance spectrograms/features
  (pitch, tempo, warp, frequency_mask, time_mask, dropout, add,
  multiply). The reference runs these inside the TF graph; here they are
  numpy host transforms applied before batching — feature tensors are
  ~100x smaller than audio so this costs little, and stays deterministic
  per (sample, clock).

All randomness is drawn from a per-sample numpy Generator so parallel
workers reproduce identically.
"""

from __future__ import annotations

import math
import re
from typing import List, Optional, Sequence

import numpy as np

from stt_tpu_torch.data.audio import (
    gain_db_to_ratio,
    max_dbfs,
    normalize_audio,
    resample,
)
from stt_tpu_torch.data.helpers import (
    float_range,
    int_range,
    pick_value_from_range,
)

SPEC_PARSER = re.compile(r"^(?P<cls>[a-z_]+)(\[(?P<params>.*)\])?$")


class Augmentation:
    def __init__(self, p=1.0):
        self.probability = float(p)

    def start(self):  # multiprocess hook (Overlay spins a feeder)
        pass

    def stop(self):
        pass


class SampleAugmentation(Augmentation):
    def apply(self, sample, clock=0.0, rng=None):
        raise NotImplementedError


class GraphAugmentation(Augmentation):
    """In-graph transforms. Each subclass separates parameter DRAWING
    (host, cheap python rng — `draw_params`) from the tensor TRANSFORM
    (`transform`, numpy), so that an on-device twin can apply the exact
    same drawn parameters."""

    def __init__(self, p=1.0, domain="spectrogram"):
        super().__init__(p)
        if domain not in ("signal", "spectrogram", "features"):
            raise ValueError(f"unsupported augmentation domain: {domain}")
        self.domain = domain

    def units_per_ms(self, feature_step_ms: float = 20.0) -> float:
        """Time units per millisecond in this domain (augmentations.py:60)."""
        return 16 if self.domain == "signal" else 1.0 / feature_step_ms

    def draw_params(self, shape, clock=0.0, rng=None) -> dict:
        raise NotImplementedError

    def transform(self, tensor, params: dict):
        raise NotImplementedError

    def apply(self, tensor, clock=0.0, rng=None):
        return self.transform(
            tensor, self.draw_params(tensor.shape, clock=clock, rng=rng)
        )


# -- sample (host audio) augmentations --------------------------------------


class Overlay(SampleAugmentation):
    """Mix noise/speech from another source at a target SNR."""

    def __init__(self, source, p=1.0, snr=3.0, layers=1):
        super().__init__(p)
        self.source = source
        self.snr = float_range(snr)
        self.layers = int_range(layers)
        self._samples: Optional[List[np.ndarray]] = None
        self._next = 0
        self._current: Optional[np.ndarray] = None

    def start(self):
        from stt_tpu_torch.data.sources import samples_from_source

        self._samples = [
            np.asarray(s.audio, np.float32)
            for s in samples_from_source(self.source, labeled=None)
        ]
        self._next = 0

    def _next_overlay(self) -> np.ndarray:
        if self._samples is None:
            self.start()
        audio = self._samples[self._next % len(self._samples)]
        self._next += 1
        return audio

    def apply(self, sample, clock=0.0, rng=None):
        audio = np.array(sample.audio, np.float32)
        n_layers = pick_value_from_range(self.layers, clock=clock, rng=rng)
        overlay = np.zeros_like(audio)
        for _ in range(n_layers):
            offset = 0
            while offset < len(audio):
                if self._current is None:
                    self._current = self._next_overlay()
                take = min(len(audio) - offset, len(self._current))
                overlay[offset : offset + take] += self._current[:take]
                self._current = (
                    None if take == len(self._current) else self._current[take:]
                )
                offset += take
        snr_db = pick_value_from_range(self.snr, clock=clock, rng=rng)
        orig_dbfs = max_dbfs(audio)
        gain = orig_dbfs - max_dbfs(overlay) - snr_db
        audio = audio + overlay * gain_db_to_ratio(gain)
        sample.audio = normalize_audio(audio, target_dbfs=orig_dbfs)


class Codec(SampleAugmentation):
    """Lossy Opus encode->decode round trip at a (possibly scheduled)
    bitrate — reference augmentations.py:366-383 (PCM -> AUDIO_TYPE_OPUS
    -> decoded again downstream). Requires the system libopus."""

    def __init__(self, p=1.0, bitrate=3200):
        super().__init__(p)
        self.bitrate = int_range(bitrate)

    def apply(self, sample, clock=0.0, rng=None):
        from stt_tpu_torch.data.opus import codec_round_trip, opus_available

        if not opus_available():
            raise NotImplementedError(
                "codec augmentation requires libopus, which is not "
                "available on this system"
            )
        bitrate = pick_value_from_range(self.bitrate, clock=clock, rng=rng)
        # libopus accepts Fs in {8000,12000,16000,24000,48000}; resample
        # other rates to 16 kHz (the pipeline's target rate) first
        rate = sample.rate
        audio = np.asarray(sample.audio, np.float32)
        if rate not in (8000, 12000, 16000, 24000, 48000):
            from stt_tpu_torch.data.audio import resample

            audio = resample(audio, rate, 16000)
            rate = 16000
            sample.rate = rate
        sample.audio = codec_round_trip(audio, rate, int(bitrate))


class Reverb(SampleAugmentation):
    """Comb-filter reverb with prime-spaced delay lines
    (augmentations.py:386-423 math)."""

    def __init__(self, p=1.0, delay=20.0, decay=10.0):
        super().__init__(p)
        self.delay = float_range(delay)
        self.decay = float_range(decay)

    def apply(self, sample, clock=0.0, rng=None):
        audio = np.asarray(sample.audio, np.float64)
        orig_dbfs = max_dbfs(audio)
        delay = pick_value_from_range(self.delay, clock=clock, rng=rng)
        decay = gain_db_to_ratio(
            -pick_value_from_range(self.decay, clock=clock, rng=rng)
        )
        result = np.copy(audio)
        primes = [17, 19, 23, 29, 31]
        for prime in primes:
            layer = np.copy(audio)
            n_delay = max(
                16, math.floor(delay * (prime / primes[0]) * sample.rate / 1000.0)
            )
            for w in range(0, math.floor(len(audio) / n_delay)):
                w1, w2 = w * n_delay, (w + 1) * n_delay
                width = min(len(audio) - w2, n_delay)
                layer[w2 : w2 + width] += decay * layer[w1 : w1 + width]
            result += layer
        sample.audio = normalize_audio(result, target_dbfs=orig_dbfs)


class Resample(SampleAugmentation):
    """Down-up resample to simulate low-bandwidth audio."""

    def __init__(self, p=1.0, rate=8000):
        super().__init__(p)
        self.rate = int_range(rate)

    def apply(self, sample, clock=0.0, rng=None):
        rate = pick_value_from_range(self.rate, clock=clock, rng=rng)
        orig_len = len(sample.audio)
        down = resample(sample.audio, sample.rate, int(rate))
        sample.audio = resample(down, int(rate), sample.rate)[:orig_len]


class NormalizeSampleRate(SampleAugmentation):
    def __init__(self, rate):
        super().__init__(p=1.0)
        self.rate = int(rate) if not isinstance(rate, tuple) else int(rate[0])

    def apply(self, sample, clock=0.0, rng=None):
        if sample.rate != self.rate:
            sample.audio = resample(sample.audio, sample.rate, self.rate)
            sample._rate = self.rate


class Volume(SampleAugmentation):
    def __init__(self, p=1.0, dbfs=3.0103):
        super().__init__(p)
        self.target_dbfs = float_range(dbfs)

    def apply(self, sample, clock=0.0, rng=None):
        target = pick_value_from_range(self.target_dbfs, clock=clock, rng=rng)
        sample.audio = normalize_audio(sample.audio, target_dbfs=target)


# -- graph (feature-domain) augmentations -----------------------------------


def _bilinear_resize(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """Bilinear resize of a [H, W] array (align_corners=False TF default)."""
    h, w = img.shape
    ys = (np.arange(new_h) + 0.0) * h / new_h
    xs = (np.arange(new_w) + 0.0) * w / new_w
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


class Pitch(GraphAugmentation):
    """Stretch/squeeze the frequency axis of the spectrogram."""

    def __init__(self, p=1.0, pitch=(1.075, 1.075, 0.125)):
        super().__init__(p, domain="spectrogram")
        self.pitch = float_range(pitch)

    def draw_params(self, shape, clock=0.0, rng=None):
        return {
            "pitch": pick_value_from_range(self.pitch, clock=clock, rng=rng)
        }

    def transform(self, tensor, params):
        t, f = tensor.shape
        new_f = max(1, int(f * params["pitch"]))
        resized = _bilinear_resize(tensor, t, new_f)
        if new_f >= f:
            return resized[:, :f]
        out = np.zeros_like(tensor)
        out[:, :new_f] = resized
        return out


class Tempo(GraphAugmentation):
    """Stretch/squeeze the time axis of the spectrogram."""

    def __init__(self, p=1.0, factor=1.1, max_time=-1):
        super().__init__(p, domain="spectrogram")
        self.factor = float_range(factor)
        self.max_time = float(max_time)

    def draw_params(self, shape, clock=0.0, rng=None):
        return {
            "factor": pick_value_from_range(self.factor, clock=clock, rng=rng)
        }

    def new_time(self, t: int, factor: float, transcript_len: int = 0) -> int:
        new_t = max(1, int(t / factor))
        if transcript_len:
            new_t = max(new_t, transcript_len)
        if self.max_time > 0:
            new_t = min(new_t, int(self.max_time * self.units_per_ms()))
        return new_t

    def transform(self, tensor, params, transcript_len: int = 0):
        t, f = tensor.shape
        new_t = self.new_time(t, params["factor"], transcript_len)
        return _bilinear_resize(tensor, new_t, f)

    def apply(self, tensor, clock=0.0, rng=None, transcript_len: int = 0):
        return self.transform(
            tensor,
            self.draw_params(tensor.shape, clock=clock, rng=rng),
            transcript_len,
        )


class Warp(GraphAugmentation):
    """SpecAugment-style sparse warping of the spectrogram grid."""

    def __init__(self, p=1.0, num_t=1, num_f=1, warp_t=0.1, warp_f=0.0):
        super().__init__(p, domain="spectrogram")
        self.num_t = int_range(num_t)
        self.num_f = int_range(num_f)
        self.warp_t = float_range(warp_t)
        self.warp_f = float_range(warp_f)

    def draw_params(self, shape, clock=0.0, rng=None):
        t, f = shape
        np_rng = np.random.default_rng(
            abs(hash((round(clock, 6), tuple(shape)))) % (2**32)
        )
        num_t = pick_value_from_range(self.num_t, clock=clock, rng=rng)
        num_f = pick_value_from_range(self.num_f, clock=clock, rng=rng)

        def flow_grid(n, size, warp_range):
            warp = pick_value_from_range(warp_range, clock=clock, rng=rng)
            std = warp * size / (2 * (n + 1))
            inner = np_rng.normal(0.0, max(std, 0.0), (num_t, num_f))
            return np.pad(inner, 1).astype(np.float32)

        return {
            "grid_t": flow_grid(num_t, t, self.warp_t),
            "grid_f": flow_grid(num_f, f, self.warp_f),
        }

    def transform(self, tensor, params):
        t, f = tensor.shape
        flow_t = _bilinear_resize(params["grid_t"], t, f)
        flow_f = _bilinear_resize(params["grid_f"], t, f)
        # dense_image_warp: output(x) = input(x - flow) with bilinear sampling
        ys = np.clip(np.arange(t)[:, None] - flow_t, 0, t - 1)
        xs = np.clip(np.arange(f)[None, :] - flow_f, 0, f - 1)
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        y1 = np.clip(y0 + 1, 0, t - 1)
        x1 = np.clip(x0 + 1, 0, f - 1)
        wy, wx = ys - y0, xs - x0
        return (
            tensor[y0, x0] * (1 - wy) * (1 - wx)
            + tensor[y0, x1] * (1 - wy) * wx
            + tensor[y1, x0] * wy * (1 - wx)
            + tensor[y1, x1] * wy * wx
        )


class FrequencyMask(GraphAugmentation):
    def __init__(self, p=1.0, n=3, size=2):
        super().__init__(p, domain="spectrogram")
        self.n = int_range(n)
        self.size = int_range(size)

    def draw_params(self, shape, clock=0.0, rng=None):
        t, f = shape
        n = pick_value_from_range(self.n, clock=clock, rng=rng)
        starts, sizes = [], []
        for _ in range(n):
            size = max(1, min(f - 1, pick_value_from_range(self.size, clock=clock, rng=rng)))
            f0 = int((rng.random() if rng else np.random.random()) * (f - size))
            starts.append(f0)
            sizes.append(size)
        return {
            "starts": np.asarray(starts, np.int32),
            "sizes": np.asarray(sizes, np.int32),
        }

    def transform(self, tensor, params):
        out = np.array(tensor)
        for f0, size in zip(params["starts"], params["sizes"]):
            out[:, f0 : f0 + size] = 0.0
        return out


class TimeMask(GraphAugmentation):
    def __init__(self, p=1.0, domain="spectrogram", n=3, size=10.0):
        super().__init__(p, domain=domain)
        self.n = int_range(n)
        self.size = float_range(size)

    def draw_params(self, shape, clock=0.0, rng=None):
        time_max = shape[0]
        n = pick_value_from_range(self.n, clock=clock, rng=rng)
        starts, sizes = [], []
        for _ in range(n):
            size = int(
                pick_value_from_range(self.size, clock=clock, rng=rng)
                * self.units_per_ms()
            )
            size = max(1, min(time_max - 1, size))
            t0 = int((rng.random() if rng else np.random.random()) * (time_max - size))
            starts.append(t0)
            sizes.append(size)
        return {
            "starts": np.asarray(starts, np.int32),
            "sizes": np.asarray(sizes, np.int32),
        }

    def transform(self, tensor, params):
        out = np.array(tensor)
        for t0, size in zip(params["starts"], params["sizes"]):
            out[t0 : t0 + size] = 0.0
        return out


class Dropout(GraphAugmentation):
    def __init__(self, p=1.0, domain="spectrogram", rate=0.05):
        super().__init__(p, domain=domain)
        self.rate = float_range(rate)

    def draw_params(self, shape, clock=0.0, rng=None):
        return {
            "rate": max(
                0.0, pick_value_from_range(self.rate, clock=clock, rng=rng)
            ),
            "seed": int((rng.random() if rng else np.random.random()) * 2**31),
        }

    def transform(self, tensor, params):
        np_rng = np.random.default_rng(params["seed"])
        keep = np_rng.random(tensor.shape) >= params["rate"]
        return tensor * keep


class Add(GraphAugmentation):
    def __init__(self, p=1.0, domain="features", stddev=5):
        super().__init__(p, domain=domain)
        self.stddev = float_range(stddev)

    def draw_params(self, shape, clock=0.0, rng=None):
        return {
            "stddev": pick_value_from_range(self.stddev, clock=clock, rng=rng),
            "seed": int((rng.random() if rng else np.random.random()) * 2**31),
        }

    def transform(self, tensor, params):
        np_rng = np.random.default_rng(params["seed"])
        return tensor + np_rng.normal(
            0.0, abs(params["stddev"]), tensor.shape
        )


class Multiply(GraphAugmentation):
    def __init__(self, p=1.0, domain="features", stddev=5):
        super().__init__(p, domain=domain)
        self.stddev = float_range(stddev)

    def draw_params(self, shape, clock=0.0, rng=None):
        return {
            "stddev": pick_value_from_range(self.stddev, clock=clock, rng=rng),
            "seed": int((rng.random() if rng else np.random.random()) * 2**31),
        }

    def transform(self, tensor, params):
        np_rng = np.random.default_rng(params["seed"])
        return tensor * np_rng.normal(
            1.0, abs(params["stddev"]), tensor.shape
        )


# -- parsing + application --------------------------------------------------

_CLASSES = {
    "overlay": Overlay,
    "codec": Codec,
    "reverb": Reverb,
    "resample": Resample,
    "normalize_sample_rate": NormalizeSampleRate,
    "volume": Volume,
    "pitch": Pitch,
    "tempo": Tempo,
    "warp": Warp,
    "frequency_mask": FrequencyMask,
    "time_mask": TimeMask,
    "dropout": Dropout,
    "add": Add,
    "multiply": Multiply,
}


def parse_augmentation(spec: str) -> Augmentation:
    match = SPEC_PARSER.match(spec.strip())
    if not match:
        raise ValueError(f"augmentation spec has wrong format: {spec!r}")
    name = match.group("cls")
    cls = _CLASSES.get(name)
    if cls is None:
        raise ValueError(f"unknown augmentation: {name!r}")
    params = match.group("params")
    kwargs = {}
    args = []
    if params:
        for part in params.split(","):
            key, eq, val = part.partition("=")
            if eq:
                kwargs[key.strip()] = val.strip()
            else:
                args.append(part.strip())
    return cls(*args, **kwargs)


def parse_augmentations(specs: Optional[Sequence[str]]) -> List[Augmentation]:
    return [parse_augmentation(s) for s in (specs or [])]


def apply_sample_augmentations(
    sample, augmentations: Sequence[Augmentation], clock: float = 0.0, rng=None
):
    import random as _random

    rng = rng or _random.Random(hash((sample.sample_id, round(clock, 6))))
    for aug in augmentations:
        if isinstance(aug, SampleAugmentation) and rng.random() < aug.probability:
            aug.apply(sample, clock=clock, rng=rng)
    return sample


def apply_graph_augmentations(
    domain: str,
    tensor: np.ndarray,
    augmentations: Sequence[Augmentation],
    clock: float = 0.0,
    rng=None,
):
    import random as _random

    rng = rng or _random.Random(int(clock * 1e9) + tensor.size)
    for aug in augmentations:
        if (
            isinstance(aug, GraphAugmentation)
            and aug.domain == domain
            and rng.random() < aug.probability
        ):
            tensor = aug.apply(tensor, clock=clock, rng=rng)
    return tensor
