"""DeepSpeech-style LSTM acoustic model as an nn.Module.

The architecture of `stt_tpu.models.deepspeech`:
  context window (2*n_context+1 frames of n_input MFCCs)
  -> dense x3 with clipped ReLU (min(relu(x), relu_clip)) + dropout
  -> unidirectional LSTM (n_cell_dim), stateful for streaming
  -> dense with clipped ReLU + dropout
  -> linear dense to n_alphabet+1 logits (blank = last index)

Parameters keep the JAX package's flat names ("layer_1/w", "lstm/kernel"
[n_in + H, 4H], "lstm/bias", ...) and its i, g, f, o gate order, so
`state_dict()` is the artifact's weights.npz. Parameters are trainable;
serving runs the model under `torch.no_grad()`.

The LSTM takes one of two routes, decided by the grad mode and the
tensor's device alone: when autograd records, `lstm_train` (the training
kernels K3/K4, with their backward); otherwise `lstm_fused` (the inference
kernel K1). On CPU tensors both run their plain PyTorch versions.

Dropout is that of the JAX package's `_dense`: a keep-mask drawn as
bernoulli(1 - rate), kept values scaled by 1 / (1 - rate), on layers 1-3
(`dropout_rates[0:3]`) and layer 5 (`dropout_rates[5]`), only when the
caller passes a `torch.Generator` (the JAX package's `dropout_rng`). The
masks cannot reproduce JAX's random streams.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from stt_tpu_torch.models.lstm import State
from stt_tpu_torch import ops  # its attributes are read at call time: ops imports models.lstm

NORMED_LAYERS = ("layer_1", "layer_2", "layer_3", "layer_5")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The fields of `stt_tpu.models.ModelConfig` without `fused_lstm` and
    `force_fused`: those gate the TPU kernel on VMEM capacity, (8, 128)
    tiling and device count, none of which limits the card, so here every
    LSTM forward on a CUDA tensor takes the kernel."""

    n_input: int = 26  # MFCC coefficients per frame
    n_context: int = 9  # frames of context on each side
    n_hidden: int = 2048  # width of dense layers 1-3 and 5
    n_cell_dim: int = 2048  # LSTM cell width
    n_out: int = 29  # alphabet size + 1 (CTC blank, last index)
    relu_clip: float = 20.0
    layer_norm: bool = False
    # dropout rates for layers [1, 2, 3, lstm(unused), unused, 5]; used only
    # when forward is given a dropout generator
    dropout_rates: Tuple[float, ...] = (0.05, 0.05, 0.05, 0.0, 0.0, 0.05)
    compute_dtype: str = "float32"  # or "bfloat16"

    @property
    def window_width(self) -> int:
        return 2 * self.n_context + 1

    @property
    def window_input(self) -> int:
        return self.window_width * self.n_input

    @property
    def dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[
            self.compute_dtype
        ]


def param_shapes(config: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    dims = {
        "layer_1": (config.window_input, config.n_hidden),
        "layer_2": (config.n_hidden, config.n_hidden),
        "layer_3": (config.n_hidden, config.n_cell_dim),
        "layer_5": (config.n_cell_dim, config.n_hidden),
        "layer_6": (config.n_hidden, config.n_out),
    }
    shapes = {}
    for name, (n_in, n_out) in dims.items():
        shapes[f"{name}/w"] = (n_in, n_out)
        shapes[f"{name}/b"] = (n_out,)
        if config.layer_norm and name in NORMED_LAYERS:
            shapes[f"{name}/ln_scale"] = (n_out,)
            shapes[f"{name}/ln_bias"] = (n_out,)
    h = config.n_cell_dim
    shapes["lstm/kernel"] = (h + h, 4 * h)
    shapes["lstm/bias"] = (4 * h,)
    return shapes


def create_overlapping_windows(features: torch.Tensor, n_context: int) -> torch.Tensor:
    """[B, T, n_input] -> [B, T, (2*n_context+1)*n_input].

    Frame t sees frames [t-n_context, t+n_context], zero-padded at the
    edges; the window flattens as (tap, channel), the layout layer_1's
    weights expect."""
    b, t, n_input = features.shape
    width = 2 * n_context + 1
    padded = nn.functional.pad(features, (0, 0, n_context, n_context))
    windows = padded.unfold(1, width, 1)  # [B, T, n_input, width]
    return windows.transpose(2, 3).reshape(b, t, width * n_input)


def _layer_norm(x, scale, bias, eps=1e-6):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


class DeepSpeech(nn.Module):
    def __init__(
        self,
        config: ModelConfig,
        device="cpu",
        generator: Optional[torch.Generator] = None,
    ):
        """Parameters on `device`. With a generator, they are drawn the way
        `stt_tpu.models.init_params` draws them (Glorot-uniform kernels,
        zero biases, unit layer-norm scales), from that generator; without
        one they are left uninitialised for a load."""
        super().__init__()
        self.config = config
        for name, shape in param_shapes(config).items():
            value = torch.empty(shape, dtype=torch.float32, device=device)
            if generator is not None:
                _init_(name, value, generator)
            self.register_parameter(name, nn.Parameter(value))

    def param(self, name: str) -> torch.Tensor:
        return getattr(self, name)

    def _dense(
        self,
        name: str,
        x: torch.Tensor,
        relu: bool = True,
        dropout_rate: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        dtype = self.config.dtype
        out = torch.matmul(
            x.to(dtype).float(), self.param(f"{name}/w").to(dtype).float()
        ) + self.param(f"{name}/b")
        if relu:
            out = torch.clamp(out, min=0.0, max=self.config.relu_clip)
        if self.config.layer_norm and name in NORMED_LAYERS:
            out = _layer_norm(
                out, self.param(f"{name}/ln_scale"), self.param(f"{name}/ln_bias")
            )
        if generator is not None and dropout_rate > 0.0:
            keep = 1.0 - dropout_rate
            mask = torch.bernoulli(torch.full_like(out, keep), generator=generator)
            out = torch.where(mask.bool(), out / keep, torch.zeros_like(out))
        return out

    def forward(
        self,
        features: torch.Tensor,
        seq_len: Optional[torch.Tensor] = None,
        previous_state: Optional[State] = None,
        overlap: bool = True,
        dropout_generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, State]:
        """features [B, T, n_input] MFCCs (or [B, T, window_input] with
        overlap=False); seq_len [B] valid frames (None = all); previous_state
        (c, h) each [B, n_cell_dim] (None = zeros); dropout_generator, on the
        features' device, turns dropout on.

        Returns (logits [B, T, n_out] f32, final LSTM state)."""
        config = self.config
        rates = config.dropout_rates
        gen = dropout_generator
        b, t = features.shape[:2]
        x = create_overlapping_windows(features, config.n_context) if overlap else features
        x = x.reshape(b * t, -1)
        for i, name in enumerate(("layer_1", "layer_2", "layer_3")):
            x = self._dense(name, x, dropout_rate=rates[i], generator=gen)
        x = x.reshape(b, t, -1).transpose(0, 1)  # time-major for the LSTM
        lstm = {"kernel": self.param("lstm/kernel"), "bias": self.param("lstm/bias")}
        records = torch.is_grad_enabled() and (x.requires_grad or lstm["kernel"].requires_grad)
        recurrence = ops.lstm_train if records else ops.lstm_fused
        outputs, state = recurrence(
            lstm, x, seq_len=seq_len, initial_state=previous_state,
            compute_dtype=config.dtype,
        )
        x = outputs.transpose(0, 1).reshape(b * t, -1)
        x = self._dense("layer_5", x, dropout_rate=rates[5], generator=gen)
        logits = self._dense("layer_6", x, relu=False)
        return logits.reshape(b, t, config.n_out).float(), state


def _init_(name: str, value: torch.Tensor, generator: torch.Generator) -> None:
    kind = name.split("/")[1]
    if kind in ("w", "kernel"):
        n_in, n_out = value.shape
        if kind == "kernel":  # lstm_init: fan counts the four gates once each
            n_in, n_out = n_in // 2, n_out
            limit = (6.0 / (n_in + n_in + n_out)) ** 0.5
        else:
            limit = (6.0 / (n_in + n_out)) ** 0.5
        sample = torch.rand(value.shape, generator=generator, device=generator.device)
        value.copy_(sample * (2 * limit) - limit)
    elif kind == "ln_scale":
        value.fill_(1.0)
    else:
        value.zero_()

