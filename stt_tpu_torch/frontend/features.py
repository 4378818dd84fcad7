"""MFCC feature frontend: framing -> |FFT|^2 -> mel filterbank -> log -> DCT.

The semantics of `stt_tpu.frontend.features` (TF AudioSpectrogram and Mfcc
ops): frames start at multiples of `step` and only full windows are
emitted; periodic Hann window; fft length = next power of two >= window;
mel filterbank on |FFT| with TF's band edges; log floor 1e-12; DCT-II
scaled by sqrt(2/n_mels).

Plain PyTorch, no kernel (the JAX package has no Pallas kernel here
either): framing is `Tensor.unfold`, the real DFT is two float32 matmuls
with the window folded into the matrices. On CUDA, `resolve_device` turns
TF32 off, so these are true float32 products as JAX's precision="highest".
The constants are computed in float64 numpy and kept as float32.

`spectrogram_numpy`, `mfcc_from_spectrogram_numpy` and
`audio_to_mfcc_numpy` are copies of stt_tpu's host (numpy) frontend:
float32 frames through scipy's real FFT, as the one-shot inference entry
points feature a file.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

_FILTERBANK_FLOOR = 1e-12
_MEL_BREAK_HZ = 700.0
_MEL_HIGH_Q = 1127.0


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    sample_rate: int = 16000
    window_samples: int = 512  # 32 ms at 16 kHz
    step_samples: int = 320  # 20 ms at 16 kHz
    n_mfcc: int = 26
    n_mels: int = 40
    lower_frequency_hz: float = 20.0
    upper_frequency_hz: float | None = None  # default: sample_rate / 2

    @classmethod
    def from_ms(
        cls,
        sample_rate: int = 16000,
        window_ms: float = 32.0,
        step_ms: float = 20.0,
        **kw,
    ) -> "FeatureConfig":
        return cls(
            sample_rate=sample_rate,
            window_samples=int(sample_rate * window_ms / 1000),
            step_samples=int(sample_rate * step_ms / 1000),
            **kw,
        )

    @property
    def upper_hz(self) -> float:
        return (
            self.upper_frequency_hz
            if self.upper_frequency_hz is not None
            else self.sample_rate / 2
        )

    @property
    def fft_length(self) -> int:
        return 1 << (self.window_samples - 1).bit_length()

    @property
    def n_bins(self) -> int:
        return self.fft_length // 2 + 1


def num_frames(n_samples: int, window_samples: int, step_samples: int) -> int:
    """Frames with a full window of samples."""
    return max(0, (n_samples - window_samples) // step_samples + 1)


def _freq_to_mel(freq):
    return _MEL_HIGH_Q * np.log1p(np.asarray(freq, np.float64) / _MEL_BREAK_HZ)


@functools.lru_cache(maxsize=16)
def _constants(config: FeatureConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(mel_matrix [n_bins, n_mels], dct [n_mels, n_mfcc])."""
    n_bins = config.n_bins
    n_mels = config.n_mels
    mel_low = _freq_to_mel(config.lower_frequency_hz)
    mel_hi = _freq_to_mel(config.upper_hz)
    # n_mels + 1 center frequencies; centers[k] is the upper band edge of
    # channel k-1 and the peak of channel k.
    spacing = (mel_hi - mel_low) / (n_mels + 1)
    centers = mel_low + spacing * (np.arange(n_mels + 1, dtype=np.float64) + 1)

    hz_per_bin = 0.5 * config.sample_rate / (n_bins - 1)
    start_index = int(1.5 + config.lower_frequency_hz / hz_per_bin)
    end_index = int(config.upper_hz / hz_per_bin)

    mel_matrix = np.zeros((n_bins, n_mels), dtype=np.float64)
    for i in range(start_index, min(end_index, n_bins - 1) + 1):
        melf = _freq_to_mel(i * hz_per_bin)
        # channel whose upper edge is the first center above this bin
        channel = int(np.searchsorted(centers[:n_mels], melf, side="left")) - 1
        if channel >= 0:
            weight = (centers[channel + 1] - melf) / (
                centers[channel + 1] - centers[channel]
            )
        else:
            weight = (centers[0] - melf) / (centers[0] - mel_low)
        if channel >= 0:
            mel_matrix[i, channel] += weight  # falling edge of triangle
        if channel + 1 < n_mels:
            mel_matrix[i, channel + 1] += 1.0 - weight  # rising edge

    # DCT-II, globally scaled by sqrt(2/n_mels).
    j = np.arange(n_mels, dtype=np.float64)
    k = np.arange(config.n_mfcc, dtype=np.float64)
    dct = np.sqrt(2.0 / n_mels) * np.cos(np.pi / n_mels * np.outer(k, (j + 0.5)))
    return mel_matrix.astype(np.float32), dct.T.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _dft_matrices(config: FeatureConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Real DFT with the Hann window folded in, as two [window, n_bins]
    matrices (zero padding to fft_length is implicit)."""
    n = config.fft_length
    w = config.window_samples
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(w, dtype=np.float64) / w)
    k = np.arange(config.n_bins, dtype=np.float64)
    t = np.arange(w, dtype=np.float64)
    angle = -2.0 * np.pi * np.outer(t, k) / n
    cos_mat = (np.cos(angle) * window[:, None]).astype(np.float32)
    sin_mat = (np.sin(angle) * window[:, None]).astype(np.float32)
    return cos_mat, sin_mat


@functools.lru_cache(maxsize=16)
def _on_device(config: FeatureConfig, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """(cos, sin, mel_matrix, dct_t) as float32 tensors on `device`, made
    once per (config, device) so a stream's chunks upload nothing."""
    cos_mat, sin_mat = _dft_matrices(config)
    mel_matrix, dct_t = _constants(config)
    return tuple(
        torch.from_numpy(a).to(device) for a in (cos_mat, sin_mat, mel_matrix, dct_t)
    )


def spectrogram(
    audio: torch.Tensor, config: FeatureConfig = FeatureConfig()
) -> torch.Tensor:
    """[..., n_samples] float audio in [-1, 1] -> [..., n_frames, n_bins]
    magnitude-squared."""
    cos_mat, sin_mat, _, _ = _on_device(config, audio.device)
    n_samples = audio.shape[-1]
    if n_samples < config.window_samples:  # unfold refuses a short input
        frames = audio.new_zeros(audio.shape[:-1] + (0, config.window_samples))
    else:
        frames = audio.float().unfold(-1, config.window_samples, config.step_samples)
    real = torch.matmul(frames, cos_mat)
    imag = torch.matmul(frames, sin_mat)
    return real.square() + imag.square()


def mfcc_from_spectrogram(
    power_spec: torch.Tensor, config: FeatureConfig = FeatureConfig()
) -> torch.Tensor:
    """[..., n_frames, n_bins] magnitude-squared -> [..., n_frames, n_mfcc]."""
    _, _, mel_matrix, dct_t = _on_device(config, power_spec.device)
    mel = torch.matmul(torch.sqrt(power_spec), mel_matrix)
    log_mel = torch.log(torch.clamp(mel, min=_FILTERBANK_FLOOR))
    return torch.matmul(log_mel, dct_t)


def audio_to_mfcc(
    audio: torch.Tensor, config: FeatureConfig = FeatureConfig()
) -> torch.Tensor:
    """Full frontend. [..., n_samples] -> [..., n_frames, n_mfcc].

    Batched inputs should be zero-padded on the right; `num_frames` of each
    utterance's sample count gives its valid feature length."""
    return mfcc_from_spectrogram(spectrogram(audio, config), config)


@functools.lru_cache(maxsize=8)
def _frame_index(n_frames: int, window_samples: int, step_samples: int) -> np.ndarray:
    return (
        np.arange(n_frames)[:, None] * step_samples
        + np.arange(window_samples)[None, :]
    )


@functools.lru_cache(maxsize=16)
def _hann(window_samples: int) -> np.ndarray:
    n = window_samples
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n, dtype=np.float64) / n)).astype(
        np.float32)


def spectrogram_numpy(
    audio: np.ndarray, config: FeatureConfig = FeatureConfig()
) -> np.ndarray:
    """[n_samples] audio -> [n_frames, n_bins] magnitude-squared, float32,
    on the host."""
    from scipy import fft

    n_frames = num_frames(len(audio), config.window_samples, config.step_samples)
    idx = _frame_index(n_frames, config.window_samples, config.step_samples)
    frames = np.asarray(audio, np.float32)[idx] * _hann(config.window_samples)
    spec = fft.rfft(frames, n=config.fft_length, axis=-1)
    power = spec.real.astype(np.float32) ** 2
    power += spec.imag.astype(np.float32) ** 2
    return power


def mfcc_from_spectrogram_numpy(
    power_spec: np.ndarray, config: FeatureConfig = FeatureConfig()
) -> np.ndarray:
    """[n_frames, n_bins] magnitude-squared -> [n_frames, n_mfcc], float32."""
    mel_matrix, dct_t = _constants(config)
    magnitude = np.sqrt(power_spec.astype(np.float32))
    mel = magnitude @ mel_matrix
    log_mel = np.log(np.maximum(mel, _FILTERBANK_FLOOR, dtype=np.float32))
    return log_mel @ dct_t


def audio_to_mfcc_numpy(
    audio: np.ndarray, config: FeatureConfig = FeatureConfig()
) -> np.ndarray:
    return mfcc_from_spectrogram_numpy(spectrogram_numpy(audio, config), config)
