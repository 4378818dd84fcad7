"""Plain MFCC, DeepSpeech forward, CTC loss and Adam.

- MFCC: TensorFlow's AudioSpectrogram (periodic Hann window, |rfft|^2 of
  the next power of two, full windows only) and Mfcc ops (mfcc_mel_filterbank.cc:
  triangular bands between mel-spaced centres on the magnitude, log floored
  at 1e-12, DCT-II scaled by sqrt(2 / channels)), in float64 NumPy.
- The model: DeepSpeech 0.9's graph. 2 n_context + 1 frames of context
  (zero frames past either end), three dense layers and one after the
  LSTM with min(relu(x), relu_clip), TF's LSTMBlockFusedCell (gates i, g,
  f, o; forget bias 0; state frozen and output 0 past a row's length),
  linear logits with the blank last. float32 with TF32 off, in blocks of
  rows.
- The loss: torch.nn.functional.ctc_loss in float64 (blank last), the mean
  over the feasible rows; the gradients by autograd, summed over blocks.
- Adam: Kingma and Ba's update with bias correction, eps outside the root.

`tf32=True` rounds every matmul operand (forward and backward) to TF32's
10-bit mantissa: the control, the same arithmetic one precision below.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence

import numpy as np
import torch


# --- MFCC -------------------------------------------------------------------


def _mel(freq):
    return 1127.0 * np.log1p(np.asarray(freq, np.float64) / 700.0)


def mel_bank(feat: dict) -> np.ndarray:
    """[n_bins, channels]: TF's MfccMelFilterbank as a matrix."""
    return _mel_bank(feat["window_samples"], feat["n_mels"], feat["lower_hz"], feat["sample_rate"])


@functools.lru_cache(maxsize=8)
def _mel_bank(window_samples: int, channels: int, low: float, rate: int) -> np.ndarray:
    fft = 1 << (window_samples - 1).bit_length()
    n_bins = fft // 2 + 1
    high = rate / 2
    mel_low, mel_hi = _mel(low), _mel(high)
    spacing = (mel_hi - mel_low) / (channels + 1)
    centres = mel_low + spacing * (np.arange(channels + 1) + 1)
    hz_per_bin = 0.5 * rate / (n_bins - 1)
    start, end = int(1.5 + low / hz_per_bin), int(high / hz_per_bin)
    bank = np.zeros((n_bins, channels))
    channel = 0
    for i in range(start, min(end, n_bins - 1) + 1):
        melf = _mel(i * hz_per_bin)
        while channel < channels and centres[channel] < melf:
            channel += 1
        band = channel - 1
        if band >= 0:
            weight = (centres[band + 1] - melf) / (centres[band + 1] - centres[band])
            bank[i, band] += weight
        else:
            weight = (centres[0] - melf) / (centres[0] - mel_low)
        if band + 1 < channels:
            bank[i, band + 1] += 1.0 - weight
    return bank


def mfcc(audio: np.ndarray, feat: dict) -> np.ndarray:
    """One utterance's samples -> [frames, n_mfcc] float64."""
    win, step = feat["window_samples"], feat["step_samples"]
    audio = np.asarray(audio, np.float64)
    n = 0 if len(audio) < win else (len(audio) - win) // step + 1
    fft = 1 << (win - 1).bit_length()
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(win) / win)
    frames = audio[np.arange(n)[:, None] * step + np.arange(win)] * hann
    power = np.abs(np.fft.rfft(frames, n=fft, axis=1)) ** 2
    mel = np.sqrt(power) @ mel_bank(feat)
    log_mel = np.log(np.maximum(mel, 1e-12))
    channels = feat["n_mels"]
    k = np.arange(feat["n_mfcc"])[:, None]
    dct = np.sqrt(2.0 / channels) * np.cos(np.pi / channels * k * (np.arange(channels) + 0.5))
    return log_mel @ dct.T


def features(audios: Sequence[np.ndarray], feat: dict, frames: int, device) -> tuple:
    """Utterances -> (features [B, frames, n_mfcc] float32, zero past each
    length, on `device`; lengths [B] int64)."""
    out = np.zeros((len(audios), frames, feat["n_mfcc"]), np.float32)
    lengths = []
    for i, a in enumerate(audios):
        f = mfcc(a, feat)[:frames]
        out[i, :len(f)] = f
        lengths.append(len(f))
    return torch.from_numpy(out).to(device), torch.tensor(lengths, dtype=torch.int64)


# --- the model ----------------------------------------------------------------


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value (10 mantissa bits, ties to even)."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _Tf32Mm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _tf32(a) @ _tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _tf32(g)
        return g @ _tf32(b).T, _tf32(a).T @ g


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    return _Tf32Mm.apply(a, b) if tf32 else a @ b


def windows(feats: torch.Tensor, n_context: int) -> torch.Tensor:
    """[B, T, n] -> [B, T, (2 n_context + 1) n], taps outer, zero frames
    past either end."""
    B, T, n = feats.shape
    padded = torch.cat([feats.new_zeros(B, n_context, n), feats,
                        feats.new_zeros(B, n_context, n)], dim=1)
    taps = [padded[:, k:k + T] for k in range(2 * n_context + 1)]
    return torch.cat(taps, dim=2)


def forward(params: Dict[str, torch.Tensor], feats: torch.Tensor, lengths: torch.Tensor,
            cfg: dict, tf32: bool = False) -> torch.Tensor:
    """feats [B, T, n_input] f32 -> logits [B, T, n_out] f32."""
    B, T, _ = feats.shape
    clip = cfg["relu_clip"]
    x = windows(feats, cfg["n_context"]).reshape(B * T, -1)
    for name in ("layer_1", "layer_2", "layer_3"):
        x = torch.clamp(matmul(x, params[f"{name}/w"], tf32) + params[f"{name}/b"], 0.0, clip)
    H = cfg["n_cell_dim"]
    kernel = params["lstm/kernel"]
    n_in = kernel.shape[0] - H
    x_proj = (matmul(x, kernel[:n_in], tf32) + params["lstm/bias"]).reshape(B, T, 4 * H)
    w_h = kernel[n_in:]
    c = feats.new_zeros(B, H)
    h = feats.new_zeros(B, H)
    valid = (torch.arange(T, device=feats.device)[None, :] < lengths.to(feats.device)[:, None])
    outs = []
    for t in range(T):
        z = x_proj[:, t] + matmul(h, w_h, tf32)
        i, g, f, o = z.split(H, dim=1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        keep = valid[:, t:t + 1]
        c = torch.where(keep, c_new, c)
        h = torch.where(keep, h_new, h)
        outs.append(torch.where(keep, h_new, torch.zeros_like(h_new)))
    x = torch.stack(outs, dim=1).reshape(B * T, H)
    x = torch.clamp(matmul(x, params["layer_5/w"], tf32) + params["layer_5/b"], 0.0, clip)
    logits = matmul(x, params["layer_6/w"], tf32) + params["layer_6/b"]
    return logits.reshape(B, T, -1)


@torch.no_grad()
def probabilities(params, feats, lengths, cfg, tf32=False, block=16) -> torch.Tensor:
    """Softmax probabilities [B, T, C], float64, computed in blocks of rows."""
    parts = []
    for s in range(0, feats.shape[0], block):
        logits = forward(params, feats[s:s + block], lengths[s:s + block], cfg, tf32)
        parts.append(torch.softmax(logits.double(), dim=-1))
    return torch.cat(parts)


# --- the loss, its gradients and Adam ----------------------------------------


def feasible(labels: Sequence[np.ndarray], frames: Sequence[int]) -> np.ndarray:
    """Rows whose labels fit their frames: |l| plus the repeats that need a
    blank between them."""
    return np.array([len(l) + int(np.sum(l[1:] == l[:-1])) <= t
                     for l, t in zip(labels, frames)])


def loss_and_grads(params, feats, lengths, labels, cfg, tf32=False, block=64) -> tuple:
    """(mean CTC loss over the feasible rows, {leaf: its gradient}), in
    blocks of rows."""
    lens = lengths.cpu().numpy()
    ok = feasible(labels, lens)
    count = max(int(ok.sum()), 1)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    total = 0.0
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    blank = cfg["n_out"] - 1
    for s in range(0, feats.shape[0], block):
        rows = list(range(s, min(s + block, feats.shape[0])))
        logits = forward(leaves, feats[s:s + block], lengths[s:s + block], cfg, tf32)
        logp = torch.log_softmax(logits.double(), dim=-1).transpose(0, 1)
        targets = [torch.as_tensor(labels[r], dtype=torch.long) for r in rows]
        flat = torch.cat(targets).to(feats.device)
        losses = torch.nn.functional.ctc_loss(
            logp, flat, lengths[s:s + block].to(feats.device),
            torch.tensor([len(t) for t in targets], device=feats.device),
            blank=blank, reduction="none", zero_infinity=False)
        keep = torch.as_tensor(ok[rows], device=feats.device)
        block_loss = torch.where(keep, losses, torch.zeros_like(losses)).sum() / count
        block_grads = torch.autograd.grad(block_loss, list(leaves.values()))
        for k, g in zip(leaves, block_grads):
            grads[k] += g.float()
        total += float(block_loss.detach())
    return total, grads


def adam_(params, grads, m, v, step: int, lr: float, b1=0.9, b2=0.999, eps=1e-8) -> None:
    """One Adam step in place, in float64 per leaf."""
    for k, p in params.items():
        g = grads[k].double()
        m[k] = b1 * m[k] + (1 - b1) * g
        v[k] = b2 * v[k] + (1 - b2) * g * g
        m_hat = m[k] / (1 - b1 ** step)
        v_hat = v[k] / (1 - b2 ** step)
        p.copy_((p.double() - lr * m_hat / (v_hat.sqrt() + eps)).float())


def train(params0, batches: List[tuple], cfg: dict, lr: float, tf32=False, block=64) -> dict:
    """Follow len(batches) training steps from params0, one batch (feats,
    lengths, labels) a step. Returns each step's loss, the first gradient
    and the parameters' change after the last step, by leaf."""
    params = {k: v.detach().clone() for k, v in params0.items()}
    m = {k: torch.zeros_like(v, dtype=torch.float64) for k, v in params.items()}
    v = {k: torch.zeros_like(x, dtype=torch.float64) for k, x in params.items()}
    losses, first = [], None
    for step, (feats, lengths, labels) in enumerate(batches, start=1):
        loss, grads = loss_and_grads(params, feats, lengths, labels, cfg, tf32, block)
        losses.append(loss)
        if first is None:
            first = grads
        with torch.no_grad():
            adam_(params, grads, m, v, step, lr)
        del grads
    change = {k: params[k] - params0[k] for k in params}
    return {"losses": losses, "grad": first, "change": change}
