"""Voice activity detection and long-audio segmentation (numpy only): the
port's copy of `stt_tpu/data/vad.py`, so both packages split a recording
alike.

Parity surface: util/audio.py:296-364 (vad_split with a webrtcvad
frame classifier and a ring-buffer trigger) and util/feeding.py:240-280
(split_audio_file: VAD segments -> duration-sorted batches with outliers
isolated into batch-size-1 batches).

webrtcvad is not available in this image, so the frame classifier is an
adaptive log-energy detector; the segmentation state machine (ring
buffer, 90% trigger/detrigger ratio) mirrors the reference exactly, and
the classifier is pluggable for environments that have webrtcvad.

Aggressiveness mapping (webrtcvad's 0-3 scale direction, quantified in
tests/test_vad_quantified.py): the voicing threshold sits at
(15 + 10*aggressiveness)% of the per-utterance noise-floor->peak energy
range, so 0 is the most permissive and 3 the strictest. Measured drift
vs constructed ground truth: boundaries within 0.35 s on synthetic
speech/silence and within a true span +-0.5 s on real (LDC93S1)
speech; >=90-95% of true speech covered; silence leak bounded by the
state machine's 300 ms padding prepend (the reference leaks the same
way).
"""

from __future__ import annotations

import collections
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

DEFAULT_RATE = 16000


def energy_vad_classifier(
    audio: np.ndarray, frame_len: int, aggressiveness: int = 3
) -> List[bool]:
    """Frame-wise voiced/unvoiced via adaptive log-energy thresholding.
    Higher aggressiveness -> stricter (more frames called unvoiced)."""
    n_frames = len(audio) // frame_len
    if n_frames == 0:
        return []
    frames = audio[: n_frames * frame_len].reshape(n_frames, frame_len)
    energy = 10.0 * np.log10(np.mean(np.square(frames), axis=1) + 1e-10)
    floor = np.percentile(energy, 10)
    peak = np.percentile(energy, 95)
    # threshold sweeps from 15% to 45% of the floor->peak range
    frac = 0.15 + 0.1 * aggressiveness
    threshold = floor + frac * max(peak - floor, 6.0)
    return (energy > threshold).tolist()


# -- WebRTC-class GMM classifier --------------------------------------------
#
# The reference classifies frames with webrtcvad (util/audio.py:308-364),
# whose core is an adaptive per-sub-band Gaussian-mixture speech/noise
# model. Neither the webrtcvad package nor its source exists in this
# image (verified), so exact bit-parity is unattainable here; this is
# the same CLASS of detector — six sub-band log energies, two-component
# adaptive noise/speech GMMs per band, likelihood-ratio decision with
# hangover — with the same 0-3 aggressiveness API. Unlike the
# stationary-threshold energy classifier above it tracks non-stationary
# noise floors, quantified in tests/test_vad_quantified.py.

_VAD_BANDS = (
    (80, 250), (250, 500), (500, 1000),
    (1000, 2000), (2000, 3000), (3000, 4000),
)


def gmm_vad_classifier(
    audio: np.ndarray,
    frame_len: int,
    aggressiveness: int = 3,
    rate: int = DEFAULT_RATE,
) -> List[bool]:
    """Adaptive sub-band GMM voiced/unvoiced classification."""
    n_frames = len(audio) // frame_len
    if n_frames == 0:
        return []
    frames = np.asarray(
        audio[: n_frames * frame_len], np.float32
    ).reshape(n_frames, frame_len)
    window = np.hanning(frame_len).astype(np.float32)
    spec = np.fft.rfft(frames * window, axis=-1)
    power = (spec.real ** 2 + spec.imag ** 2) / frame_len
    freqs = np.fft.rfftfreq(frame_len, 1.0 / rate)
    n_bands = len(_VAD_BANDS)
    band_p = np.empty((n_frames, n_bands), np.float32)
    for b, (lo, hi) in enumerate(_VAD_BANDS):
        sel = (freqs >= lo) & (freqs < hi)
        band_p[:, b] = power[:, sel].sum(axis=1)
    band_e = 10.0 * np.log10(band_p + 1e-10)
    # MCRA-style: smooth POWER over ~0.2 s before taking the floor
    # statistic — power averaging is dominated by the loud neighbors, so
    # single-frame speech closures (-80 dB stops) vanish from the floor
    # track while genuine noise periods keep their level
    k = min(7, n_frames)
    kern = np.ones(k, np.float32) / k
    smooth_p = np.apply_along_axis(
        lambda v: np.convolve(v, kern, mode="same"), 0, band_p
    )
    smooth_e = 10.0 * np.log10(smooth_p + 1e-10)

    # minima-controlled noise floor: rolling per-band minimum over ~1.5 s
    # (50 frames at 30 ms). This is what lets the model TRACK a
    # non-stationary floor — after a step up, the rolling min rises
    # within the window and the noise model follows, where a global
    # percentile threshold stays stuck at the old floor.
    win = min(45, n_frames)
    floors = np.empty_like(band_e)
    for t in range(n_frames):
        floors[t] = smooth_e[max(0, t - win + 1) : t + 1].min(axis=0)

    noise_mu = band_e[: max(1, win // 2)].min(axis=0).astype(np.float32)
    noise_var = np.full(n_bands, 16.0, np.float32)
    # speech model: offset above the CURRENT noise floor (speech energy
    # rides on top of whatever the floor is)
    speech_offset = np.full(n_bands, 18.0, np.float32)
    speech_var = np.full(n_bands, 60.0, np.float32)

    # decision threshold per aggressiveness mode (sum of CLAMPED
    # per-band LLRs), hangover keeps short gaps. The clamp is
    # load-bearing: a few strongly-voiced bands must win even when
    # other bands sit below the floor (speech has spectral tilt;
    # broadband floors do not), and silence — mildly negative in every
    # band — must not be dragged positive by wide speech-gaussian tails.
    llr_thresholds = (-3.0, 0.0, 3.0, 6.0)
    thr = llr_thresholds[max(0, min(3, aggressiveness))]
    hangover_max = 4 if aggressiveness < 2 else 2

    flags: List[bool] = []
    hangover = 0
    alpha_fast, alpha_slow = 0.3, 0.03
    for t in range(n_frames):
        x = band_e[t]
        # minima pull runs in EVERY state (gating it on the speech flag
        # deadlocks: a noise step that false-triggers would freeze the
        # very adaptation that clears it). During real speech the
        # SMOOTHED rolling min stays near the true floor — power
        # smoothing keeps closures out, inter-word gaps keep it low —
        # so the pull is ~neutral there; a sustained broadband rise
        # adapts within win + ~12 frames (the bounded adaptation window
        # quantified in tests/test_vad_quantified.py).
        noise_mu += alpha_fast * np.clip(floors[t] - noise_mu, -6.0, 6.0)
        speech_mu = noise_mu + speech_offset
        ll_s = -0.5 * ((x - speech_mu) ** 2 / speech_var
                       + np.log(2 * np.pi * speech_var))
        ll_n = -0.5 * ((x - noise_mu) ** 2 / noise_var
                       + np.log(2 * np.pi * noise_var))
        total_llr = float(np.sum(np.clip(ll_s - ll_n, -0.5, 8.0)))
        raw_speech = total_llr > thr
        if raw_speech:
            hangover = hangover_max
            speech = True
        elif hangover > 0:
            hangover -= 1
            speech = True
        else:
            speech = False
        if raw_speech:
            # adapt the speech offset toward observed speech energy,
            # bounded away from the floor so the models never collapse
            speech_offset += alpha_slow * np.clip(
                (x - noise_mu) - speech_offset, -3.0, 3.0
            )
            speech_offset = np.clip(speech_offset, 9.0, 45.0)
        else:
            # near-floor frames refine the noise model
            noise_mu += alpha_slow * (x - noise_mu)
            noise_var = np.clip(
                noise_var + alpha_slow * ((x - noise_mu) ** 2 - noise_var),
                4.0, 150.0,
            )
        flags.append(bool(speech))
    return flags


_CLASSIFIERS = {
    "energy": energy_vad_classifier,
    "gmm": gmm_vad_classifier,
}


def vad_split(
    audio: np.ndarray,
    rate: int = DEFAULT_RATE,
    num_padding_frames: int = 10,
    threshold: float = 0.5,
    aggressiveness: int = 3,
    frame_duration_ms: int = 30,
    classifier: Optional[Callable] = None,
) -> Iterator[Tuple[np.ndarray, float, float]]:
    """Yield (segment_audio, time_start_s, time_end_s) voiced segments.

    Ring-buffer trigger semantics of util/audio.py:308-364: collecting
    starts when > threshold of the buffered frames are voiced and stops
    when > threshold are unvoiced (the padding frames are prepended)."""
    if frame_duration_ms not in (10, 20, 30):
        raise ValueError("VAD-splitting only supported for frame durations 10, 20, or 30 ms")
    frame_len = rate * frame_duration_ms // 1000
    if classifier is None:
        classifier = "energy"
    if isinstance(classifier, str):
        fn = _CLASSIFIERS[classifier]
        classifier = lambda a, fl: fn(a, fl, aggressiveness)
    voiced_flags = classifier(audio, frame_len)

    ring_buffer: collections.deque = collections.deque(maxlen=num_padding_frames)
    triggered = False
    segment: List[int] = []
    start_frame = 0
    for i, is_speech in enumerate(voiced_flags):
        if not triggered:
            ring_buffer.append((i, is_speech))
            num_voiced = sum(1 for _, speech in ring_buffer if speech)
            if num_voiced > threshold * ring_buffer.maxlen:
                triggered = True
                start_frame = ring_buffer[0][0]
                segment = [idx for idx, _ in ring_buffer]
                ring_buffer.clear()
        else:
            segment.append(i)
            ring_buffer.append((i, is_speech))
            num_unvoiced = sum(1 for _, speech in ring_buffer if not speech)
            if num_unvoiced > threshold * ring_buffer.maxlen:
                triggered = False
                end_frame = segment[-1] + 1
                yield (
                    audio[start_frame * frame_len : end_frame * frame_len],
                    start_frame * frame_duration_ms / 1000.0,
                    end_frame * frame_duration_ms / 1000.0,
                )
                ring_buffer.clear()
                segment = []
    if triggered and segment:
        end_frame = segment[-1] + 1
        yield (
            audio[start_frame * frame_len : end_frame * frame_len],
            start_frame * frame_duration_ms / 1000.0,
            end_frame * frame_duration_ms / 1000.0,
        )


def split_audio_file(
    audio: np.ndarray,
    rate: int = DEFAULT_RATE,
    batch_size: int = 8,
    aggressiveness: int = 3,
    outlier_duration_ms: float = 10000,
    outlier_batch_size: int = 1,
    classifier: Optional[Callable] = None,
) -> Iterator[List[Tuple[float, float, np.ndarray]]]:
    """VAD-segment audio into padded decode batches; duration outliers go
    into their own small batches (feeding.py:240-280)."""
    segments = list(
        vad_split(
            audio, rate, aggressiveness=aggressiveness,
            classifier=classifier,
        )
    )
    if not segments:
        return
    normal = [
        (s, ts, te) for s, ts, te in segments if (te - ts) * 1000 <= outlier_duration_ms
    ]
    outliers = [
        (s, ts, te) for s, ts, te in segments if (te - ts) * 1000 > outlier_duration_ms
    ]
    normal.sort(key=lambda x: len(x[0]))
    outliers.sort(key=lambda x: len(x[0]))
    for group, bsize in ((normal, batch_size), (outliers, outlier_batch_size)):
        for i in range(0, len(group), bsize):
            yield [
                (ts, te, seg) for seg, ts, te in group[i : i + bsize]
            ]
