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
parameters.

The tensor-parallel step (`make_train_step_tp`, the counterpart of
stt_tpu's) runs on a ('data', 'model') mesh (`parallel.mesh`): the state
holds this rank's shards (`shard_train_state`; a `ShardedDeepSpeech` and
an Adam over its shards), the forward is `parallel.tp.apply_model_tp`, the
sharded leaves' gradients are divided by n_model, and the finite count,
the loss and the gradients are all-reduced over the rank's data group.
Dropout masks come from (seed, step, data index), so the model ranks of
one data index draw the same ones. `gather_train_state` puts the full
parameters and Adam state back together: checkpoints hold them, so one
file loads at any n_model.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from stt_tpu_torch import trace
from stt_tpu_torch.ctc import ctc_loss
from stt_tpu_torch.device import resolve_device
from stt_tpu_torch.parallel import distributed
from stt_tpu_torch.frontend import FeatureConfig, audio_to_mfcc
from stt_tpu_torch.models import DeepSpeech, ModelConfig
from stt_tpu_torch.models.deepspeech import param_shapes
from stt_tpu_torch.parallel.mesh import Mesh, gather_params, shard, shard_dim, shard_params
from stt_tpu_torch.parallel.tp import ShardedDeepSpeech


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
    and each rank draws its own (with a model axis, `rank` is the data
    index, which the model ranks of one data index share)."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step + (rank << 40))


def _loss_fn(
    model, batch: Batch, generator: Optional[torch.Generator], group=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(the sum of this rank's finite losses over the global batch's count
    of finite losses, the count summed over `group`, else over every rank;
    per-example losses; finite mask)."""
    with trace.span("train.forward"):
        logits, _ = model(
            batch.features, seq_len=batch.feature_lengths, dropout_generator=generator
        )
    losses = ctc_loss(logits, batch.feature_lengths, batch.labels, batch.label_lengths)
    finite = torch.isfinite(losses)
    n_finite = torch.clamp(distributed.allreduce_(finite.sum(), group), min=1)
    mean_loss = torch.where(finite, losses, torch.zeros_like(losses)).sum() / n_finite
    return mean_loss, losses, finite


def _update(state: TrainState, batch: Batch, seed: int) -> StepMetrics:
    model, optimizer = state.model, state.optimizer
    device = batch.features.device
    with trace.span("train.step", device=True):
        optimizer.zero_grad(set_to_none=True)
        loss, losses, finite = _loss_fn(
            model, batch, dropout_generator(seed, state.step, device, distributed.process_index()))
        with trace.span("train.backward"):
            loss.backward()
        with trace.span("train.optim"):
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            if distributed.active():
                # one all-reduce of every gradient, flattened, and of the loss
                _allreduce_flat_(grads)
                loss = distributed.allreduce_(loss.detach().clone())
            grad_norm = torch.sqrt(_square_sum(grads)).float()
            optimizer.step()
    state.step += 1
    return StepMetrics(loss.detach(), losses.detach(), ~finite, grad_norm)


def _square_sum(grads) -> torch.Tensor:
    """The gradients' summed squares, in float64: torch's float32 norm on
    the CPU is ~0.2% off for a tensor of 10^7 elements such as the LSTM
    kernel's gradient."""
    if not grads:
        return torch.zeros((), dtype=torch.float64)
    return torch.stack([torch.linalg.vector_norm(g, dtype=torch.float64) ** 2
                        for g in grads]).sum()


def _allreduce_flat_(grads, group=None) -> None:
    """Sum the gradients over the ranks of `group` in one all-reduce of them
    all, flattened."""
    flat = distributed.allreduce_(torch.cat([g.reshape(-1) for g in grads]), group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


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


def make_train_step_tp(config: ModelConfig, mesh: Mesh,
                       feature_config: Optional[FeatureConfig] = None,
                       replicate_uneven: bool = False) -> TrainStep:
    """train_step(state, batch, seed=0) -> (state, StepMetrics) on the
    ('data', 'model') mesh: `state` holds this rank's shards
    (`shard_train_state`), `batch` this rank's data index's rows (the same
    on its model ranks). With `feature_config`, the batch is raw audio and
    the MFCC runs in the step, as in `make_train_step_audio`.

    Refuses, as stt_tpu's make_train_step_tp does, a hidden matrix whose
    width does not divide over the model axis: it stays whole between
    sharded layers, and each model rank's gradient of it is a partial sum.
    With `replicate_uneven` (the trainer's choice: stt_tpu's trainer runs
    GSPMD over `param_sharding`, which takes every layout) such a matrix,
    the LSTM's included, stays replicated: the mean over the model ranks
    that every replicated leaf's gradient takes (`_update_tp`) is then
    their partial sums' total, the whole gradient."""
    n_model = mesh.n_model
    shapes = param_shapes(config)
    for name, shape in shapes.items():
        if (not replicate_uneven and len(shape) == 2 and shape[1] != config.n_out
                and shape[1] % n_model):
            raise ValueError(
                f"make_train_step_tp: hidden matrix {name} with "
                f"output dim {shape[1]} is not divisible by "
                f"n_model={n_model}; it would replicate between "
                f"sharded layers and its gradient would be a "
                f"partial sum. Use a divisible width or fewer "
                f"model shards."
            )
    sharded = [shard_dim(shape, n_model) is not None for shape in shapes.values()]

    def train_step(state: TrainState, batch: Batch, seed: int = 0):
        if feature_config is not None:
            batch = batch._replace(features=audio_to_mfcc(batch.features, feature_config))
        return state, _update_tp(state, batch, seed, mesh, sharded)

    return train_step


def _update_tp(state: TrainState, batch: Batch, seed: int, mesh: Mesh, sharded) -> StepMetrics:
    model, optimizer = state.model, state.optimizer
    optimizer.zero_grad(set_to_none=True)
    loss, losses, finite = _loss_fn(
        model, batch, dropout_generator(seed, state.step, batch.features.device,
                                        mesh.data_index), mesh.data_group)
    loss.backward()
    grads = [p.grad for p in model.parameters()]
    split = [g for g, s in zip(grads, sharded) if s]
    whole = [g for g, s in zip(grads, sharded) if not s]
    # every model rank computed the same loss, so the gathers' backward
    # summed K equal cotangents into each sharded leaf
    for g in split:
        g.div_(mesh.n_model)
    if whole:
        # a replicated leaf's gradient, over the model ranks: equal copies of
        # it (layer_6, whose logits feed the loss on every rank), or, for a
        # hidden matrix between sharded layers, parts that sum to K times it
        # (the sharded layer after it hands each rank the cotangent of its
        # own columns, K times over). The mean is the gradient in both cases,
        # and keeps the copies equal bit for bit where the card's backward
        # sums by atomics.
        _allreduce_flat_(whole, mesh.model_group)
        for g in whole:
            g.div_(mesh.n_model)
    if mesh.n_data > 1:
        _allreduce_flat_(grads, mesh.data_group)
        loss = distributed.allreduce_(loss.detach().clone(), mesh.data_group)
    # the sharded leaves' squares summed over the model ranks, the
    # replicated ones' counted once
    squares = distributed.allreduce_(_square_sum(split), mesh.model_group) + _square_sum(whole)
    grad_norm = torch.sqrt(squares).float()
    optimizer.step()
    state.step += 1
    return StepMetrics(loss.detach(), losses.detach(), ~finite, grad_norm)


def _map_adam_state(adam: dict, names, fn) -> dict:
    """Adam's state dict with fn(name, moment) applied to every moment."""
    state = {}
    for index, entry in adam["state"].items():
        name = names[index]
        state[index] = {key: value.clone() if key == "step" else fn(name, value)
                        for key, value in entry.items()}
    return {"state": state, "param_groups": adam["param_groups"]}


def shard_train_state(full: TrainState, mesh: Mesh) -> TrainState:
    """The full state's shards for this rank: a `ShardedDeepSpeech` on the
    full model's device and an Adam over it whose moments are the full
    moments' shards, at the same step and learning rate."""
    config = full.model.config
    names = list(param_shapes(config))
    shards = shard_params({k: v.detach() for k, v in full.params.items()}, mesh)
    model = ShardedDeepSpeech(config, shards, mesh)
    optimizer = create_optimizer(model.parameters())
    optimizer.load_state_dict(_map_adam_state(
        full.optimizer.state_dict(), names,
        lambda name, value: shard(value, mesh.n_model, mesh.model_index).clone()))
    return TrainState(full.step, model, optimizer)


def gather_model(state: TrainState, mesh: Mesh) -> DeepSpeech:
    """The full model from the model ranks' shards (an all-gather over the
    model group), on the shards' device."""
    config = state.model.config
    params = gather_params({k: v.detach() for k, v in state.params.items()}, mesh,
                           param_shapes(config))
    device = next(state.model.parameters()).device
    model = DeepSpeech(config, device=device)
    model.load_state_dict(params)
    return model


def gather_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """The full parameters and Adam state from the model ranks' shards, as a
    one-process state (a collective over the model group)."""
    config = state.model.config
    shapes = param_shapes(config)
    names = list(shapes)
    model = gather_model(state, mesh)
    optimizer = create_optimizer(model.parameters())
    optimizer.load_state_dict(_map_adam_state(
        state.optimizer.state_dict(), names,
        lambda name, value: gather_params({name: value}, mesh, shapes)[name].clone()))
    return TrainState(state.step, model, optimizer)


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
