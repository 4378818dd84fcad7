"""Graph augmentations on the batch's device: the spectrogram- and
features-domain transforms of `data.augmentations`, applied to a padded
[B, T, F] batch in one pass (the counterpart of
`stt_tpu.data.device_augment`).

The split of the work is stt_tpu's:

- on the host, each sample draws its activation gates and its parameters
  with the augmentation classes' own `draw_params` (`draw_sample`, `draw`,
  `stack`), in the featurize workers, so the device's results are the host
  transforms' on the same parameters;
- on the device, `apply` runs the spectrogram chain, then
  `mfcc_from_spectrogram`, then the features chain over the whole padded
  batch. Every size-changing transform (pitch, tempo, the warp's flow
  grids) is an interpolation whose sizes are values over the fixed [B, T,
  F] buffer, with stt_tpu's arithmetic (`_interp_time`, `_pitch`,
  `_tempo`, `_warp`), so lengths come out exactly as stt_tpu's.

Where stt_tpu vmaps a per-sample function, this writes the batch dimension
out. The random family (dropout, add, multiply) draws its noise from a
`torch.Generator` on the batch's device seeded by each sample's drawn seed:
deterministic per seed, with the moments of stt_tpu's `jax.random` streams,
which torch cannot reproduce bit for bit (nor does the CPU generator give
the CUDA one's numbers).

As in stt_tpu, a tempo stretch (factor < 1) that would lengthen a sample
past the padded T is clipped to T, where the host path grows the tensor.
"""

from __future__ import annotations

import random as _random
from typing import List, Sequence, Tuple

import numpy as np
import torch

from stt_tpu_torch.data.augmentations import (
    Add,
    Dropout,
    FrequencyMask,
    GraphAugmentation,
    Multiply,
    Pitch,
    Tempo,
    TimeMask,
    Warp,
)
from stt_tpu_torch.frontend import FeatureConfig, mfcc_from_spectrogram

MAX_MASKS = 16  # masks per mask augmentation a sample may draw
MAX_GRID = 12  # the side of a warp's padded flow grid


# --------------------------------------------------------------------------
# batched transforms: x [B, T, F], lens [B] int32, parameters [B, ...]
# --------------------------------------------------------------------------


def _rows(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """[B, T, 1] bool: the rows below each sample's length."""
    return (torch.arange(x.shape[1], device=x.device)[None, :] < lens[:, None])[..., None]


def _interp_time(x: torch.Tensor, src_len: torch.Tensor, dst_len: torch.Tensor) -> torch.Tensor:
    """Resize rows [0, src_len) onto rows [0, dst_len) of the same buffer:
    row i samples y = i * src_len / dst_len (the host's bilinear resize);
    rows from dst_len on are 0."""
    B, T, F = x.shape
    i = torch.arange(T, device=x.device, dtype=torch.int32)
    ys = i[None, :] * (src_len.float() / dst_len.float())[:, None]  # [B, T] f32
    hi = (src_len - 1)[:, None]
    y0 = torch.minimum(torch.clamp(torch.floor(ys).to(torch.int32), min=0), hi)
    y1 = torch.minimum(torch.clamp(y0 + 1, min=0), hi)
    wy = (ys - y0)[..., None]
    x0 = x.gather(1, y0.long()[..., None].expand(B, T, F))
    x1 = x.gather(1, y1.long()[..., None].expand(B, T, F))
    out = x0 * (1 - wy) + x1 * wy
    return torch.where(_rows(x, dst_len), out, torch.zeros_like(out))


def _pitch(x, lens, pitch):
    """Squeeze or stretch the frequency axis by `pitch` [B]."""
    F = x.shape[2]
    new_f = torch.clamp(torch.floor(F * pitch), min=1).to(torch.int32)  # [B]
    j = torch.arange(F, device=x.device, dtype=torch.int32)
    xs = j[None, :] * (F / new_f.float())[:, None]  # [B, F]
    x0 = torch.clamp(torch.floor(xs).to(torch.int32), 0, F - 1)
    x1 = torch.clamp(x0 + 1, 0, F - 1)
    wx = (xs - x0)[:, None, :]
    B, T, _ = x.shape
    lo = x.gather(2, x0.long()[:, None, :].expand(B, T, F))
    up = x.gather(2, x1.long()[:, None, :].expand(B, T, F))
    out = lo * (1 - wx) + up * wx
    out = torch.where((j[None, :] < new_f[:, None])[:, None, :], out, torch.zeros_like(out))
    return torch.where(_rows(x, lens), out, torch.zeros_like(out)), lens


def _tempo(x, lens, factor):
    """Stretch the time axis by 1 / `factor` [B], within the buffer."""
    new_len = torch.clamp(torch.floor(lens.float() / factor), min=1).to(torch.int32)
    new_len = torch.clamp(new_len, max=x.shape[1])
    return _interp_time(x, lens, new_len), new_len


def _flow_field(grid, gh, gw, lens, T: int, F: int):
    """The padded flow grids [B, G, G] (their valid gh x gw corner) resized
    bilinearly to [B, T, F] over each sample's length."""
    dev = grid.device
    B = grid.shape[0]
    ys = torch.arange(T, device=dev, dtype=torch.int32)[None, :] * (
        gh.float() / torch.clamp(lens, min=1).float())[:, None]
    y0 = torch.minimum(torch.clamp(torch.floor(ys).to(torch.int32), min=0), (gh - 1)[:, None])
    y1 = torch.minimum(torch.clamp(y0 + 1, min=0), (gh - 1)[:, None])
    wy = (ys - y0)[..., None]
    xs = torch.arange(F, device=dev, dtype=torch.int32)[None, :] * (gw.float() / F)[:, None]
    x0 = torch.minimum(torch.clamp(torch.floor(xs).to(torch.int32), min=0), (gw - 1)[:, None])
    x1 = torch.minimum(torch.clamp(x0 + 1, min=0), (gw - 1)[:, None])
    wx = (xs - x0)[:, None, :]
    b = torch.arange(B, device=dev)[:, None, None]

    def at(y, xcol):
        return grid[b, y.long()[:, :, None], xcol.long()[:, None, :]]

    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def _warp(x, lens, grid_t, grid_f, dims_t, dims_f):
    """Sparse warp: out(y, x) = x(y - flow_t, x - flow_f), bilinear."""
    B, T, F = x.shape
    dev = x.device
    flow_t = _flow_field(grid_t, dims_t[:, 0], dims_t[:, 1], lens, T, F)
    flow_f = _flow_field(grid_f, dims_f[:, 0], dims_f[:, 1], lens, T, F)
    top_row = torch.clamp(lens - 1, min=0).float()[:, None, None]
    ys = torch.arange(T, device=dev, dtype=torch.int32)[None, :, None] - flow_t
    ys = torch.minimum(torch.clamp(ys, min=0), top_row)
    xs = torch.clamp(torch.arange(F, device=dev, dtype=torch.int32)[None, None, :] - flow_f,
                     0, F - 1)
    y0 = torch.floor(ys).to(torch.int32)
    x0 = torch.floor(xs).to(torch.int32)
    y1 = torch.minimum(torch.clamp(y0 + 1, min=0), torch.clamp(lens - 1, min=0)[:, None, None])
    x1 = torch.clamp(x0 + 1, 0, F - 1)
    wy, wx = ys - y0, xs - x0
    b = torch.arange(B, device=dev)[:, None, None]

    def at(y, xcol):
        return x[b, y.long(), xcol.long()]

    out = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1) * (1 - wy) * wx
           + at(y1, x0) * wy * (1 - wx) + at(y1, x1) * wy * wx)
    return torch.where(_rows(x, lens), out, torch.zeros_like(out)), lens


def _masked(size: int, starts, sizes, device) -> torch.Tensor:
    """[B, size] bool: positions inside any of the drawn masks [B, MAX_MASKS]
    (padding masks have size 0)."""
    j = torch.arange(size, device=device)[None, None, :]
    return ((j >= starts[..., None]) & (j < (starts + sizes)[..., None])).any(dim=1)


def _freq_mask(x, lens, starts, sizes):
    masked = _masked(x.shape[2], starts, sizes, x.device)[:, None, :]
    return torch.where(masked, torch.zeros_like(x), x), lens


def _time_mask(x, lens, starts, sizes):
    masked = _masked(x.shape[1], starts, sizes, x.device)[:, :, None]
    return torch.where(masked, torch.zeros_like(x), x), lens


def _noise(x: torch.Tensor, seeds, normal: bool) -> torch.Tensor:
    """Per sample, noise of one row's shape from a generator on x's device
    seeded by that sample's drawn seed: standard normal or uniform [0, 1)."""
    rows = []
    for seed in seeds.tolist():
        gen = torch.Generator(device=x.device).manual_seed(int(seed))
        draw = torch.randn if normal else torch.rand
        rows.append(draw(x.shape[1:], generator=gen, device=x.device))
    return torch.stack(rows)


def _dropout(x, lens, rate, seed):
    keep = _noise(x, seed, normal=False) >= rate[:, None, None]
    return x * keep, lens


def _add(x, lens, stddev, seed):
    out = x + stddev.abs()[:, None, None] * _noise(x, seed, normal=True)
    return torch.where(_rows(x, lens), out, torch.zeros_like(out)), lens


def _multiply(x, lens, stddev, seed):
    return x * (1.0 + stddev.abs()[:, None, None] * _noise(x, seed, normal=True)), lens


# --------------------------------------------------------------------------
# host-side parameter drawing and the batched application
# --------------------------------------------------------------------------


def _pad_masks(starts: np.ndarray, sizes: np.ndarray):
    s = np.zeros((MAX_MASKS,), np.int32)
    z = np.zeros((MAX_MASKS,), np.int32)
    n = min(len(starts), MAX_MASKS)
    s[:n] = starts[:n]
    z[:n] = sizes[:n]
    return s, z


def _pad_grid(grid: np.ndarray):
    g = np.zeros((MAX_GRID, MAX_GRID), np.float32)
    h, w = min(grid.shape[0], MAX_GRID), min(grid.shape[1], MAX_GRID)
    g[:h, :w] = grid[:h, :w]
    return g, np.asarray([h, w], np.int32)


_TRANSFORMS = {Pitch: (_pitch, ("pitch",)), Tempo: (_tempo, ("factor",)),
               Warp: (_warp, ("grid_t", "grid_f", "dims_t", "dims_f")),
               FrequencyMask: (_freq_mask, ("starts", "sizes")),
               TimeMask: (_time_mask, ("starts", "sizes")),
               Dropout: (_dropout, ("rate", "seed")), Add: (_add, ("stddev", "seed")),
               Multiply: (_multiply, ("stddev", "seed"))}


class DeviceAugmentPipeline:
    """The spectrogram -> features augmentation chain on the batch's device.

    On the host, per sample: the activation gate (p) and each
    augmentation's parameters, drawn with the class's own draw_params. On
    the device: one pass of the whole chain and the MFCC projection over the
    padded batch."""

    def __init__(self, augmentations: Sequence[GraphAugmentation],
                 feature_config: FeatureConfig = FeatureConfig()):
        self.feature_config = feature_config
        self.spec_augs: List[GraphAugmentation] = []
        self.feat_augs: List[GraphAugmentation] = []
        for aug in augmentations:
            if not isinstance(aug, GraphAugmentation):
                continue
            if aug.domain == "spectrogram":
                self.spec_augs.append(aug)
            elif aug.domain == "features":
                self.feat_augs.append(aug)

    def has_work(self) -> bool:
        return bool(self.spec_augs or self.feat_augs)

    # -- drawing ---------------------------------------------------------

    def _draw_one(self, aug, shape, clock, rng) -> Tuple[bool, dict]:
        active = rng.random() < aug.probability
        params = aug.draw_params(shape, clock=clock, rng=rng)
        if isinstance(aug, (FrequencyMask, TimeMask)):
            starts, sizes = _pad_masks(params["starts"], params["sizes"])
            return active, {"starts": starts, "sizes": sizes}
        if isinstance(aug, Warp):
            gt, dt = _pad_grid(params["grid_t"])
            gf, df = _pad_grid(params["grid_f"])
            return active, {"grid_t": gt, "dims_t": dt, "grid_f": gf, "dims_f": df}
        if isinstance(aug, Pitch):
            return active, {"pitch": np.float32(params["pitch"])}
        if isinstance(aug, Tempo):
            return active, {"factor": np.float32(params["factor"])}
        if isinstance(aug, Dropout):
            return active, {"rate": np.float32(params["rate"]),
                            "seed": np.int32(params["seed"] & 0x7FFFFFFF)}
        if isinstance(aug, (Add, Multiply)):
            return active, {"stddev": np.float32(params["stddev"]),
                            "seed": np.int32(params["seed"] & 0x7FFFFFFF)}
        raise NotImplementedError(type(aug).__name__)

    @property
    def chain(self):
        fc = self.feature_config
        return ([(aug, fc.n_bins) for aug in self.spec_augs]
                + [(aug, fc.n_mfcc) for aug in self.feat_augs])

    def draw_sample(self, sample_id, length, clock) -> List[Tuple[bool, dict]]:
        """The whole chain's parameters for one sample, deterministic per
        (sample_id, clock); called from the featurize workers."""
        rng = _random.Random(hash((sample_id, round(float(clock), 6), "device_aug")))
        cur = int(length)
        out: List[Tuple[bool, dict]] = []
        for aug, width in self.chain:
            active, params = self._draw_one(aug, (cur, width), clock, rng)
            if active and isinstance(aug, Tempo):
                cur = min(aug.new_time(cur, float(params["factor"])), 1 << 30)
            out.append((active, params))
        return out

    def stack(self, per_sample: List[List[Tuple[bool, dict]]]) -> List[dict]:
        """[B] lists of per-augmentation (active, params) -> one dict per
        augmentation, each value stacked over the batch, with 'active' [B]."""
        out: List[dict] = []
        for j in range(len(self.chain)):
            rows = [s[j][1] for s in per_sample]
            stacked = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
            stacked["active"] = np.asarray([s[j][0] for s in per_sample], bool)
            out.append(stacked)
        return out

    def draw(self, sample_ids, lengths, clocks) -> List[dict]:
        """A batch's parameters: one dict per augmentation in chain order
        (spectrogram, then features), as `stack` gives them."""
        return self.stack([self.draw_sample(sid, n, c)
                           for sid, n, c in zip(sample_ids, lengths, clocks)])

    # -- the device pass ---------------------------------------------------

    @staticmethod
    def _apply_aug(aug, x, lens, params: dict):
        fn, names = _TRANSFORMS[type(aug)]
        args = [torch.as_tensor(np.asarray(params[k]), device=x.device) for k in names]
        y, new_lens = fn(x, lens, *args)
        active = torch.as_tensor(np.asarray(params["active"]), device=x.device)
        return (torch.where(active[:, None, None], y, x),
                torch.where(active, new_lens, lens))

    @torch.no_grad()
    def apply(self, spec_batch: torch.Tensor, lengths: torch.Tensor, params: List[dict]):
        """[B, T, n_bins] power spectrograms and their lengths [B] on one
        device -> the augmented [B, T, n_mfcc] features and their new
        lengths (int32), on that device."""
        x = spec_batch.float()
        lens = lengths.to(device=x.device, dtype=torch.int32)
        i = 0
        for aug in self.spec_augs:
            x, lens = self._apply_aug(aug, x, lens, params[i])
            i += 1
        # the host path clamps augmented spectrograms at 0 before the MFCC
        feats = mfcc_from_spectrogram(torch.clamp(x, min=0.0), self.feature_config)
        # rows past the length stay zero features, not the MFCC of silence
        feats = torch.where(_rows(feats, lens), feats, torch.zeros_like(feats))
        for aug in self.feat_augs:
            feats, lens = self._apply_aug(aug, feats, lens, params[i])
            i += 1
        return feats, lens
