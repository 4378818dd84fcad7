"""The train and eval steps (the counterpart of `stt_tpu.train.step`,
single device).

A step is: the DeepSpeech forward with dropout, whose LSTM runs the
training kernels K3/K4 on the card (`stt_tpu_torch.ops.lstm_train`), the
CTC loss per example, the mean over the finite ones, autograd, the global
gradient norm, and one Adam update. Non-finite per-example losses (an
infeasible alignment, a bad sample) are masked out of the mean and
reported in the step metrics so the caller can name the files; the CTC
loss keeps their gradients 0.

Differences from the JAX package, by necessity:
- the state is mutable: `TrainState` holds the model and a
  `torch.optim.Adam`, and a step updates them in place (JAX donates the
  old state);
- dropout masks come from a `torch.Generator` seeded by (seed, step,
  rank), the counterpart of `jax.random.fold_in(rng, step)`; the two give
  different masks.

With several processes (`parallel.distributed`) each rank steps on its
rows of the global batch, and the step is the one-process step on the
whole batch, as stt_tpu's multi-process trainer runs `make_train_step` over
global arrays: the count of finite losses is all-reduced before the mean,
so each rank's loss is its finite losses' sum over the global count, and
the gradients are all-reduced (summed) before the gradient norm, which is
still summed in float64, and before Adam. Every rank then holds the same
parameters. The tensor-parallel step is not ported yet (ROADMAP.md, M13).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from stt_tpu_torch.ctc import ctc_loss
from stt_tpu_torch.device import resolve_device
from stt_tpu_torch.parallel import distributed
from stt_tpu_torch.frontend import FeatureConfig, audio_to_mfcc
from stt_tpu_torch.models import DeepSpeech, ModelConfig


class Batch(NamedTuple):
    """One padded utterance batch."""

    features: torch.Tensor  # [B, T, n_input] float32 (raw audio [B, samples] for the audio step)
    feature_lengths: torch.Tensor  # [B] int32
    labels: torch.Tensor  # [B, L] int32
    label_lengths: torch.Tensor  # [B] int32

    def to(self, device) -> "Batch":
        return Batch(*(t.to(device, non_blocking=True) for t in self))


@dataclasses.dataclass
class TrainState:
    step: int
    model: DeepSpeech
    optimizer: torch.optim.Optimizer

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The flat JAX-named parameters ("layer_1/w", "lstm/kernel", ...)."""
        return dict(self.model.named_parameters())


class StepMetrics(NamedTuple):
    loss: torch.Tensor  # mean finite loss
    per_example_loss: torch.Tensor  # [B]
    non_finite: torch.Tensor  # [B] bool: inf/nan loss (bad sample or length)
    grad_norm: torch.Tensor  # global L2 norm of the gradients before the update


def create_optimizer(
    params, learning_rate: float = 0.001, beta1: float = 0.9, beta2: float = 0.999,
    epsilon: float = 1e-8,
) -> torch.optim.Adam:
    """Adam with the reference's defaults. torch's Adam adds eps outside
    the square root of the bias-corrected second moment, as optax's adam
    does: update = lr * m_hat / (sqrt(v_hat) + eps)."""
    return torch.optim.Adam(
        params, lr=learning_rate, betas=(beta1, beta2), eps=epsilon, foreach=False
    )


def create_train_state(
    config: ModelConfig,
    seed: int = 0,
    device="cuda",
    model: Optional[DeepSpeech] = None,
    **optimizer_args,
) -> TrainState:
    """A fresh model drawn from `seed` (or `model`, moved to `device`) and a
    fresh Adam over its parameters, at step 0."""
    device = resolve_device(device)
    if model is None:
        gen = torch.Generator().manual_seed(seed)
        model = DeepSpeech(config, generator=gen)
    model = model.to(device)
    return TrainState(0, model, create_optimizer(model.parameters(), **optimizer_args))


def dropout_generator(seed: int, step: int, device: torch.device,
                      rank: int = 0) -> torch.Generator:
    """The dropout masks' generator for one step: a function of (seed,
    step, rank) alone, so a resumed run draws the masks it would have drawn
    and each rank draws its own."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step + (rank << 40))


def _loss_fn(
    model: DeepSpeech, batch: Batch, generator: Optional[torch.Generator]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(the sum of this rank's finite losses over the global batch's count
    of finite losses, per-example losses, finite mask)."""
    logits, _ = model(
        batch.features, seq_len=batch.feature_lengths, dropout_generator=generator
    )
    losses = ctc_loss(logits, batch.feature_lengths, batch.labels, batch.label_lengths)
    finite = torch.isfinite(losses)
    n_finite = torch.clamp(distributed.allreduce_(finite.sum()), min=1)
    mean_loss = torch.where(finite, losses, torch.zeros_like(losses)).sum() / n_finite
    return mean_loss, losses, finite


def _update(state: TrainState, batch: Batch, seed: int) -> StepMetrics:
    model, optimizer = state.model, state.optimizer
    device = batch.features.device
    optimizer.zero_grad(set_to_none=True)
    loss, losses, finite = _loss_fn(
        model, batch, dropout_generator(seed, state.step, device, distributed.process_index()))
    loss.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if distributed.active():
        # one all-reduce of every gradient, flattened, and of the loss
        flat = distributed.allreduce_(torch.cat([g.reshape(-1) for g in grads]))
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))
        loss = distributed.allreduce_(loss.detach().clone())
    # float64 sums: torch's float32 norm on the CPU is ~0.2% off for a
    # tensor of 10^7 elements such as the LSTM kernel's gradient
    norms = [torch.linalg.vector_norm(g, dtype=torch.float64) for g in grads]
    grad_norm = torch.linalg.vector_norm(torch.stack(norms)).float()
    optimizer.step()
    state.step += 1
    return StepMetrics(loss.detach(), losses.detach(), ~finite, grad_norm)


TrainStep = Callable[[TrainState, Batch, int], Tuple[TrainState, StepMetrics]]


def make_train_step() -> TrainStep:
    """train_step(state, batch, seed=0) -> (state, StepMetrics). The state
    is updated in place and returned. Dropout runs at the rates of the
    model's config (`SttConfig.model_config(training=True)` sets them)."""

    def train_step(state: TrainState, batch: Batch, seed: int = 0):
        return state, _update(state, batch, seed)

    return train_step


def make_train_step_audio(feature_config: FeatureConfig) -> TrainStep:
    """The train step over raw-audio batches (the feeding's
    `device_featurize` mode): `batch.features` is [B, samples] and the MFCC
    frontend runs on the batch's device inside the step;
    `batch.feature_lengths` counts true frames."""

    def train_step(state: TrainState, batch: Batch, seed: int = 0):
        feats = audio_to_mfcc(batch.features, feature_config)
        return state, _update(state, batch._replace(features=feats), seed)

    return train_step


def make_eval_step():
    """eval_step(model, batch) -> (per-example loss [B], logits [B, T, C]),
    without dropout and without autograd: the LSTM takes the inference
    kernel (K1)."""

    @torch.no_grad()
    def eval_step(model: DeepSpeech, batch: Batch):
        logits, _ = model(batch.features, seq_len=batch.feature_lengths)
        losses = ctc_loss(logits, batch.feature_lengths, batch.labels, batch.label_lengths)
        return losses, logits

    return eval_step
