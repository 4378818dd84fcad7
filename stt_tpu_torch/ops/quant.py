"""Post-training int8 quantization for the inference path: the counterpart
of `stt_tpu.ops.quant`.

Scheme: symmetric int8, per-output-channel weight scales, per-tensor
activation scales. Every hidden activation is bounded by construction
(clipped ReLU outputs in [0, relu_clip], LSTM outputs in (-1, 1)), so the
activation scales are static; only the windowed-MFCC input scale can be
calibrated. A dense layer is y = (x_q @ W_q) * (s_x * s_w) + b with the
product summed in int32 and dequantized and biased in f32. The LSTM
recurrence quantizes too: h_q = round(h * 127) each step, h_q @ W_h_q in
int32, gates and carry in f32 (`lstm_recurrence_q`, the Hopper kernel on
CUDA tensors; `recurrence_q` below is its plain version).

Parameters are the flat names of `DeepSpeech.state_dict()` ("layer_1/w",
"lstm/kernel", ...).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from stt_tpu_torch.artifact import DENSE
from stt_tpu_torch.models.deepspeech import ModelConfig, create_overlapping_windows
from stt_tpu_torch.models.lstm import State, lengths, stack, start_state


@dataclasses.dataclass
class QuantizedDense:
    w_q: torch.Tensor  # [n_in, n_out] int8
    w_scale: torch.Tensor  # [n_out] f32, per output channel
    b: torch.Tensor  # [n_out] f32
    x_scale: float  # static activation scale of this layer's input

    def __post_init__(self):
        # w_q widened once for `int8_matmul`, not per call (128 MB per call
        # for the LSTM's input projection at the 2048 geometry)
        self.w_wide = self.w_q.double()

    def to(self, device) -> "QuantizedDense":
        return QuantizedDense(
            self.w_q.to(device), self.w_scale.to(device), self.b.to(device), self.x_scale
        )


QuantizedParams = Dict[str, object]


def _quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8: scale[j] = max_i |W[i, j]| / 127."""
    w = w.detach().float()
    scale = torch.clamp(w.abs().amax(dim=0), min=1e-8) / 127.0
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w_q, scale


def quantize_params(
    params: Mapping[str, torch.Tensor],
    config: ModelConfig,
    calibration_features: Optional[torch.Tensor] = None,
) -> QuantizedParams:
    """Quantize trained f32 parameters for int8 inference, on the
    parameters' device.

    calibration_features: [B, T, n_input] MFCCs used only to pick the input
    scale of layer_1 (the one unbounded activation); without them a
    conservative |x| <= 64 bound on MFCC magnitudes."""
    from stt_tpu_torch.ops.lstm_kernel import pack_w_h_q

    ln_layers = [name for name in DENSE if f"{name}/ln_scale" in params]
    if ln_layers:
        # _qdense_apply has no layer-norm step, and the static activation
        # scales assume no renormalization after the matmul
        raise ValueError(
            "int8 activation quantization does not support layer_norm "
            f"models (ln params on {ln_layers}); use the weight-only "
            "artifact (flatten_weight_only) instead"
        )
    if calibration_features is not None:
        x = create_overlapping_windows(calibration_features.float(), config.n_context)
        in_scale = float(x.abs().max()) / 127.0
    else:
        # MFCC c0 (log frame energy) dominates and tops out near 60 for
        # full-scale 16-bit audio, so 64 bounds any real input
        in_scale = 64.0 / 127.0
    in_scale = max(in_scale, 1e-6)
    clip_scale = float(config.relu_clip) / 127.0
    h_scale = 1.0 / 127.0  # LSTM h = sigmoid * tanh in (-1, 1)

    def qdense(name: str, x_scale: float) -> QuantizedDense:
        w_q, w_scale = _quantize_weight(params[f"{name}/w"])
        return QuantizedDense(w_q, w_scale, params[f"{name}/b"].detach().float(), x_scale)

    kernel = params["lstm/kernel"].detach()
    n_cell = kernel.shape[1] // 4
    n_in = kernel.shape[0] - n_cell
    wx_q, wx_scale = _quantize_weight(kernel[:n_in])
    wh_q, wh_scale = _quantize_weight(kernel[n_in:])
    return {
        "layer_1": qdense("layer_1", in_scale),
        "layer_2": qdense("layer_2", clip_scale),
        "layer_3": qdense("layer_3", clip_scale),
        "lstm_in": QuantizedDense(
            wx_q, wx_scale, params["lstm/bias"].detach().float(), clip_scale
        ),
        "lstm_rec": {
            "w_h_q": wh_q.contiguous(),
            # folds w_h's per-channel scale with the 1/127 scale of h
            "step_scale": (wh_scale / 127.0).reshape(1, -1),
            # W_h_q in the kernel's layout, made once here and not per call
            "w_h_q_packed": pack_w_h_q(wh_q),
        },
        "layer_5": qdense("layer_5", h_scale),
        "layer_6": qdense("layer_6", clip_scale),
    }


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor,
                w_wide: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_q [M, K] int8 @ w_q [K, N] int8 -> [M, N] int32, the exact sum.
    `w_wide` is w_q as float64, where the caller keeps it.

    The product is taken in float64 on both devices: every partial sum is an
    integer below 2^53 (for any K under 5 * 10^11), so it is exact in any
    order of summation, at every shape, through a BLAS product. The
    alternatives are not: an int8 matmul wraps on the CPU, a float32 one is
    inexact from K * 127 * 127 > 2^24 (which K = 2048 passes), torch.matmul
    has no integer kernel on CUDA, and `torch._int_mm` (1.1 ms against this
    product's 2.3 ms at [4000, 2048] x [2048, 8192] on an NVIDIA H100 80GB
    HBM3 at 700 W) had narrow and ragged shapes refused by its library (60
    rows, K = 104)."""
    if w_wide is None:
        w_wide = w_q.double()
    return torch.matmul(x_q.double(), w_wide).to(torch.int32)


def _qdense_apply(
    q: QuantizedDense, x: torch.Tensor, relu_clip: Optional[float]
) -> torch.Tensor:
    """x f32 [M, n_in] -> f32 [M, n_out] through the int8 product."""
    x_q = torch.clamp(torch.round(x / q.x_scale), -127, 127).to(torch.int8)
    acc = int8_matmul(x_q, q.w_q, q.w_wide)
    out = acc.float() * (q.x_scale * q.w_scale) + q.b
    if relu_clip is not None:
        out = torch.clamp(out, min=0.0, max=relu_clip)
    return out


def recurrence_q(
    x_proj: torch.Tensor,
    w_h_q: torch.Tensor,
    step_scale: torch.Tensor,
    c0: torch.Tensor,
    h0: torch.Tensor,
    seq: torch.Tensor,
) -> Tuple[torch.Tensor, State]:
    """The int8 recurrence over a precomputed (biased) input projection, in
    plain PyTorch: the plain version of the kernel behind
    `lstm_recurrence_q`, and the counterpart of
    `stt_tpu.ops.quant._lstm_recurrence_scan`.

    x_proj [T, B, 4H] f32 or bf16; w_h_q [H, 4H] int8; step_scale [1, 4H]
    f32; c0, h0 [B, H] f32; seq [B] int32 -> (out [T, B, H] f32, (c, h))."""
    T, B, four_h = x_proj.shape
    n_cell = four_h // 4
    c, h, outs = c0, h0, []
    w = w_h_q.double()  # widened once: see int8_matmul
    for t in range(T):
        h_q = torch.round(h * 127.0).to(torch.int8)  # half to even; |h| < 1
        acc = torch.matmul(h_q.double(), w).to(torch.int32)
        z = x_proj[t].float() + acc.float() * step_scale
        i, g, f, o = z.split(n_cell, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        valid = (t < seq)[:, None]
        c = torch.where(valid, c_new, c)
        h = torch.where(valid, h_new, h)
        outs.append(torch.where(valid, h_new, torch.zeros_like(h_new)))
    return stack(outs, (0, B, n_cell), device=x_proj.device), (c, h)


@torch.no_grad()
def input_projection_q(
    qparams: QuantizedParams,
    features: torch.Tensor,
    config: ModelConfig = ModelConfig(),
    overlap: bool = True,
) -> torch.Tensor:
    """The int8 dense layers before the recurrence: features [B, T, n_input]
    -> the LSTM's biased input projection [T, B, 4H] in `config.dtype`, what
    `apply_model_quantized` hands to the recurrence."""
    b, t = features.shape[:2]
    x = create_overlapping_windows(features, config.n_context) if overlap else features
    x = x.reshape(b * t, -1).float()
    for name in ("layer_1", "layer_2", "layer_3"):
        x = _qdense_apply(qparams[name], x, config.relu_clip)
    x_proj = _qdense_apply(qparams["lstm_in"], x, None)  # bias added here, f32
    return x_proj.reshape(b, t, -1).transpose(0, 1).to(config.dtype).contiguous()


@torch.no_grad()
def apply_model_quantized(
    qparams: QuantizedParams,
    features: torch.Tensor,
    seq_len: Optional[torch.Tensor] = None,
    config: ModelConfig = ModelConfig(),
    previous_state: Optional[State] = None,
    overlap: bool = True,
) -> Tuple[torch.Tensor, State]:
    """int8 forward pass, inference only; the arguments and results of
    `DeepSpeech.forward` without dropout. The LSTM's input projection is
    stored in `config.dtype` before the recurrence, which takes the int8
    kernel on CUDA tensors and its plain version on CPU tensors."""
    from stt_tpu_torch.ops.lstm_kernel import lstm_recurrence_q

    b, t = features.shape[:2]
    x_proj = input_projection_q(qparams, features, config, overlap)
    c0, h0 = start_state(previous_state, b, config.n_cell_dim, features.device)
    rec = qparams["lstm_rec"]
    outputs, state = lstm_recurrence_q(
        x_proj, rec["w_h_q"], rec["step_scale"], c0, h0,
        lengths(seq_len, t, b, features.device), packed=rec["w_h_q_packed"],
    )
    x = outputs.transpose(0, 1).reshape(b * t, -1)
    x = _qdense_apply(qparams["layer_5"], x, config.relu_clip)
    logits = _qdense_apply(qparams["layer_6"], x, None)
    return logits.reshape(b, t, config.n_out).float(), state


def qparams_to(qparams: QuantizedParams, device) -> QuantizedParams:
    """The quantized parameters moved to `device`."""
    return {
        name: ({k: v.to(device) for k, v in leaf.items()} if isinstance(leaf, dict)
               else leaf.to(device))
        for name, leaf in qparams.items()
    }


# --- weight-only quantized artifact (dynamic-range semantics) ----------
#
# int8 weights and scales in the artifact, dequantized at load
# (`stt_tpu_torch.artifact.dequantize_flat`): a 4x smaller file, float compute.


def flatten_weight_only(params: Mapping[str, torch.Tensor], n_cell: int) -> Dict[str, np.ndarray]:
    """Flat parameters -> the npz-ready entries of the int8 weight-only
    artifact, as `stt_tpu.ops.quant.flatten_weight_only` writes them."""
    flat: Dict[str, np.ndarray] = {}

    def f32(name: str) -> np.ndarray:
        return params[name].detach().float().cpu().numpy()

    for name in DENSE:
        w_q, w_scale = _quantize_weight(params[f"{name}/w"])
        flat[f"{name}/w_q"] = w_q.cpu().numpy()
        flat[f"{name}/w_scale"] = w_scale.cpu().numpy()
        flat[f"{name}/b"] = f32(f"{name}/b")
        if f"{name}/ln_scale" in params:
            flat[f"{name}/ln_scale"] = f32(f"{name}/ln_scale")
            flat[f"{name}/ln_bias"] = f32(f"{name}/ln_bias")
    kernel = params["lstm/kernel"].detach()
    n_in = kernel.shape[0] - n_cell
    wx_q, wx_scale = _quantize_weight(kernel[:n_in])
    flat["lstm/w_x_q"] = wx_q.cpu().numpy()
    flat["lstm/w_x_scale"] = wx_scale.cpu().numpy()
    # the recurrent half feeds the carry chain: it keeps a float16 mantissa
    flat["lstm/w_h_f16"] = kernel[n_in:].float().cpu().numpy().astype(np.float16)
    flat["lstm/bias"] = f32("lstm/bias")
    return flat
