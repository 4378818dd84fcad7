"""The one generator of every traffic mix: it reads a mix's parameters
(`traffic/<name>.json`) and makes, from the run's seed, the utterances,
their transcripts and the weights that both the program and the reference
are handed.

Every seed gets the same set of sizes, in another order: durations are
the quantiles of the mix's range, shuffled by the seed, so the work of a
run depends on its seed only through the order and the content. The
speech-like audio is chip_smoke.py's `utterance` (a few gliding partials
under noise), computed in bulk on the card; its random draws come from the
seed alone, so the reference can make the same audio again.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PARTIALS = 4


def load_json(kind: str, name: str) -> dict:
    """`<kind>/<name>.json` under the benchmark's folder."""
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def rng(seed: int, purpose: str) -> np.random.Generator:
    """An independent stream of draws for each purpose of one seed."""
    return np.random.default_rng([seed, *purpose.encode()])


def durations(seed: int, n: int, low: float, high: float, purpose: str) -> np.ndarray:
    """n durations in seconds: the quantiles (i + 0.5) / n of [low, high],
    in an order drawn from the seed."""
    q = low + (high - low) * (np.arange(n) + 0.5) / n
    return q[rng(seed, purpose).permutation(n)]


def samples(seconds: np.ndarray, rate: int) -> np.ndarray:
    return (np.asarray(seconds) * rate).astype(np.int64)


def synth(seed: int, lengths: np.ndarray, rate: int, device, purpose: str,
          block: int = 32) -> torch.Tensor:
    """Audio [n, max(lengths)] float32 on `device`, zero past each length:
    PARTIALS gliding sines (f0 90-400 Hz, glide -40-40 Hz/s, amplitude
    0.05-0.2) under noise of deviation 0.02, clipped to [-1, 1]."""
    n = len(lengths)
    r = rng(seed, purpose)
    f0 = r.uniform(90, 400, (n, PARTIALS))
    glide = r.uniform(-40, 40, (n, PARTIALS))
    amp = r.uniform(0.05, 0.2, (n, PARTIALS))
    noise_gen = torch.Generator(device=device).manual_seed(int(r.integers(1 << 62)))
    width = int(max(lengths)) if n else 0
    out = torch.zeros((n, width), dtype=torch.float32, device=device)
    t = torch.arange(width, dtype=torch.float64, device=device) / rate
    for s in range(0, n, block):
        e = min(n, s + block)
        f = torch.as_tensor(f0[s:e], device=device)[:, :, None]
        g = torch.as_tensor(glide[s:e], device=device)[:, :, None]
        a = torch.as_tensor(amp[s:e], device=device)[:, :, None]
        wave = (a * torch.sin(2 * np.pi * (f + g * t) * t)).sum(dim=1)
        noise = torch.randn((e - s, width), generator=noise_gen, dtype=torch.float32,
                            device=device)
        x = torch.clamp(wave.float() + 0.02 * noise, -1.0, 1.0)
        mask = t[None, :] < torch.as_tensor(lengths[s:e] / rate, device=device)[:, None]
        out[s:e] = torch.where(mask, x, torch.zeros_like(x))
    return out


def transcripts(seed: int, seconds: np.ndarray, per_second: float, n_labels: int,
                purpose: str) -> List[np.ndarray]:
    """Label sequences of round(per_second * duration) labels each, drawn
    uniformly over the alphabet's n_labels labels (the blank excluded)."""
    r = rng(seed, purpose)
    return [r.integers(0, n_labels, int(round(per_second * s))) for s in seconds]


def frames(n_samples, feat: dict) -> np.ndarray:
    """Full windows of each utterance."""
    n = np.asarray(n_samples)
    return np.maximum(0, (n - feat["window_samples"]) // feat["step_samples"] + 1)


def weights(cfg: dict, seed: int, device, logit_scale: float) -> Dict[str, torch.Tensor]:
    """The model's parameters, named as its artifacts name them, drawn on
    `device` from the seed in one call: Glorot-uniform matrices (the LSTM's
    fan counts its four gates once each, as TF's LSTMBlockFusedCell
    initializer) and zero biases, in float32; the output layer's matrix
    times `logit_scale`.

    At the initializer's scale the emissions are near uniform (a frame's
    largest probability is ~0.04 over 29 classes), on which a beam of 500
    keeps one of many near-equal prefixes by the last bit of its rounding.
    A served model is a trained one, whose emissions are peaky: the
    serving mixes scale the logits by 1000, at which the best prefix's
    score no longer moves with the prefixes at the beam's edge."""
    n_in = (2 * cfg["n_context"] + 1) * cfg["n_input"]
    h, cell, out = cfg["n_hidden"], cfg["n_cell_dim"], cfg["n_out"]
    mats = {"layer_1/w": (n_in, h), "layer_2/w": (h, h), "layer_3/w": (h, cell),
            "lstm/kernel": (cell + cell, 4 * cell), "layer_5/w": (cell, h),
            "layer_6/w": (h, out)}
    biases = {"layer_1/b": h, "layer_2/b": h, "layer_3/b": cell, "lstm/bias": 4 * cell,
              "layer_5/b": h, "layer_6/b": out}
    gen = torch.Generator(device=device).manual_seed(int(rng(seed, "weights").integers(1 << 62)))
    total = sum(a * b for a, b in mats.values())
    flat = torch.rand(total, generator=gen, device=device)
    params, at = {}, 0
    for name, (a, b) in mats.items():
        fan = (a // 2 + a // 2 + b) if name == "lstm/kernel" else (a + b)
        limit = (6.0 / fan) ** 0.5
        params[name] = (flat[at:at + a * b].view(a, b) * (2 * limit) - limit)
        if name == "layer_6/w":
            params[name] *= logit_scale
        at += a * b
    for name, size in biases.items():
        params[name] = torch.zeros(size, device=device)
    return params
