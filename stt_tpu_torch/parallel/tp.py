"""Tensor-parallel forward over the model axis (the counterpart of
`stt_tpu.parallel.tp`).

Each model rank holds its shards of the parameters (`mesh.shard_params`:
matrices split their output dimension, so a dense layer's weight is
[n_in, D/K] and the LSTM kernel [n_in + H, 4H/K]).

1. Column-parallel projections. Every dense layer and the LSTM's input
   projection x . W_x run on the rank's weight shard; the activations are
   all-gathered to full width at each layer's end, where the clipped ReLU,
   the layer norm (its scale and bias gathered) and dropout run on full
   rows.
2. A batch-resharded recurrence with no per-step collective. The gate
   projection [T, B, 4H/K] goes through one all_to_all to [T, B/K, 4H]:
   rank m then holds all 4H gate columns, in icfo order, of batch rows
   [m B/K, (m+1) B/K). W_h is all-gathered once, and each rank runs the
   whole recurrence at full width on its rows: on CUDA tensors the training
   kernels K3 and K4 (`ops.lstm_train._Recurrence`, which packs the
   gathered W_h anew at every forward), on CPU tensors their plain
   versions. The outputs and the final (c, h) are all-gathered back over
   the batch. When B does not divide by K, the projection is all-gathered
   instead and every rank runs the recurrence on the whole batch.

A layer whose width does not divide by K (the LSTM when 4H does not) stays
replicated: every rank runs it whole on the full-width input, the LSTM as
the one-process `lstm_train`. `train.step.make_train_step_tp` takes such
layouts only when asked (`replicate_uneven`, as the trainer asks).

Autograd runs through the collectives (`parallel.distributed.all_gather`,
whose backward sums over the group, and `all_to_all`, whose backward is
the inverse all_to_all). Every model rank computes the same loss, so each
sharded leaf's gradient arrives K times over; the train step
(`train.step.make_train_step_tp`) divides it by K.

Dropout draws from the caller's generator on full-width activations, in
the order of `DeepSpeech.forward` (layers 1, 2, 3, 5): the model ranks of
one data index share the generator's seed and so draw the same masks.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from stt_tpu_torch.models.deepspeech import (
    NORMED_LAYERS,
    ModelConfig,
    _layer_norm,
    create_overlapping_windows,
    param_shapes,
)
from stt_tpu_torch.models.lstm import State, input_projection
from stt_tpu_torch.ops.lstm_train import _Recurrence, lstm_train
from stt_tpu_torch.parallel.distributed import all_gather, all_to_all
from stt_tpu_torch.parallel.mesh import Mesh


def _gather_cols(x: torch.Tensor, full_dim: int, mesh: Mesh) -> torch.Tensor:
    """A [..., D/K] activation all-gathered to full width (as it is when the
    weight that made it is replicated)."""
    if x.shape[-1] == full_dim:
        return x
    return all_gather(x, x.ndim - 1, mesh.model_group)


def _dense_tp(params: Dict[str, torch.Tensor], name: str, x: torch.Tensor, config: ModelConfig,
              mesh: Mesh, full_dim: int, relu: bool = True, dropout_rate: float = 0.0,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Column-parallel twin of `DeepSpeech._dense`: the local matmul on the
    [n_in, D/K] shard, the bias, the gather, then the clipped ReLU, the
    layer norm and dropout at full width."""
    dtype = config.dtype
    out = torch.matmul(x.to(dtype).float(), params[f"{name}/w"].to(dtype).float())
    out = _gather_cols(out + params[f"{name}/b"], full_dim, mesh)
    if relu:
        out = torch.clamp(out, min=0.0, max=config.relu_clip)
    if config.layer_norm and name in NORMED_LAYERS:
        out = _layer_norm(out, _gather_cols(params[f"{name}/ln_scale"], full_dim, mesh),
                          _gather_cols(params[f"{name}/ln_bias"], full_dim, mesh))
    if generator is not None and dropout_rate > 0.0:
        keep = 1.0 - dropout_rate
        mask = torch.bernoulli(torch.full_like(out, keep), generator=generator)
        out = torch.where(mask.bool(), out / keep, torch.zeros_like(out))
    return out


def _lstm_tp(params: Dict[str, torch.Tensor], x: torch.Tensor, seq_len: Optional[torch.Tensor],
             config: ModelConfig, mesh: Mesh) -> Tuple[torch.Tensor, State]:
    """The gate-sharded projection and the batch-resharded full-width
    recurrence. x [T, B, n_cell] full width (the same on every model rank)
    -> (outputs [T, B, n_cell], (c, h) [B, n_cell]), full."""
    T, B, n_in = x.shape
    H = config.n_cell_dim
    K = mesh.n_model
    dtype = config.dtype
    kernel = params["lstm/kernel"]  # [n_in + H, 4H/K]
    x_proj = input_projection({"kernel": kernel, "bias": params["lstm/bias"]}, x, dtype)
    w_h = all_gather(kernel[n_in:], 1, mesh.model_group)  # [H, 4H] f32
    seq = (torch.full((B,), T, dtype=torch.int32, device=x.device) if seq_len is None
           else seq_len.to(device=x.device, dtype=torch.int32))
    reshard_batch = B % K == 0
    if reshard_batch:
        x_proj = all_to_all(x_proj, 1, 2, mesh.model_group)  # [T, B/K, 4H]
        rows = B // K
        seq = seq[mesh.model_index * rows:(mesh.model_index + 1) * rows]
    else:
        # fewer rows than ranks to share them: every rank runs the whole batch
        x_proj = all_gather(x_proj, 2, mesh.model_group)  # [T, B, 4H]
        rows = B
    c0 = torch.zeros((rows, H), dtype=torch.float32, device=x.device)
    hs, c, h = _Recurrence.apply(
        x_proj.contiguous(), w_h, c0, c0.clone(), seq.contiguous(), dtype)
    if not reshard_batch:
        return hs, (c, h)
    group = mesh.model_group
    return all_gather(hs, 1, group), (all_gather(c, 0, group), all_gather(h, 0, group))


def apply_model_tp(
    params: Dict[str, torch.Tensor],
    features: torch.Tensor,
    seq_len: Optional[torch.Tensor],
    config: ModelConfig,
    mesh: Mesh,
    dropout_generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, State]:
    """The forward over this rank's shards: the same outputs as
    `DeepSpeech.forward` on the full parameters (logits [B, T, n_out] f32,
    the final LSTM state), on every model rank."""
    rates = config.dropout_rates
    gen = dropout_generator
    b, t = features.shape[:2]
    x = create_overlapping_windows(features, config.n_context).reshape(b * t, -1)
    for i, (name, width) in enumerate((("layer_1", config.n_hidden), ("layer_2", config.n_hidden),
                                       ("layer_3", config.n_cell_dim))):
        x = _dense_tp(params, name, x, config, mesh, width, dropout_rate=rates[i], generator=gen)
    x = x.reshape(b, t, -1).transpose(0, 1)  # [T, B, n_cell]
    if params["lstm/kernel"].shape[1] == 4 * config.n_cell_dim:
        # 4H does not divide by K, so the kernel stays whole: the one-process
        # LSTM on every rank
        outputs, state = lstm_train(
            {"kernel": params["lstm/kernel"], "bias": params["lstm/bias"]}, x, seq_len=seq_len,
            compute_dtype=config.dtype)
    else:
        outputs, state = _lstm_tp(params, x, seq_len, config, mesh)
    x = outputs.transpose(0, 1).reshape(b * t, -1)
    x = _dense_tp(params, "layer_5", x, config, mesh, config.n_hidden, dropout_rate=rates[5],
                  generator=gen)
    logits = _dense_tp(params, "layer_6", x, config, mesh, config.n_out, relu=False)
    return logits.reshape(b, t, config.n_out).float(), state


class ShardedDeepSpeech(nn.Module):
    """This rank's shards of a DeepSpeech's parameters, under the same flat
    names and in the same order; calling it runs `apply_model_tp`."""

    def __init__(self, config: ModelConfig, shards: Dict[str, torch.Tensor], mesh: Mesh):
        super().__init__()
        self.config = config
        self.mesh = mesh
        for name in param_shapes(config):
            self.register_parameter(name, nn.Parameter(shards[name].detach().clone()))

    def forward(self, features: torch.Tensor, seq_len: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, State]:
        return apply_model_tp(dict(self.named_parameters()), features, seq_len, self.config,
                              self.mesh, dropout_generator)
