"""Unidirectional LSTM, time-major, in plain PyTorch.

Cell semantics are those of `stt_tpu.models.lstm` (TF LSTMBlockFusedCell,
forget_bias 0, no peepholes):

    z = [x_t, h_{t-1}] @ W + b          W: [n_in + n_cell, 4*n_cell]
    i, g, f, o = split(z, 4)            gate order i, g(cell), f, o - NOT
                                        torch.nn.LSTM's i, f, g, o
    c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)
    h_t = sigmoid(o) * tanh(c_t)

Past seq_len the emitted output is 0 and (c, h) freeze, so the final state
is each row's state at its last valid frame.

`recurrence` is the plain version of the CUDA kernel behind
`stt_tpu_torch.ops.lstm_fused`: the wrapper runs it for CPU tensors, and
the tests and chip_smoke.py hold the kernel against it. `steps` is the one
step both it and the training forward's plain version
(`stt_tpu_torch.ops.lstm_train.train_forward`) iterate.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import torch

State = Tuple[torch.Tensor, torch.Tensor]


def input_projection(
    params: Dict[str, torch.Tensor], x: torch.Tensor, compute_dtype: torch.dtype
) -> torch.Tensor:
    """x [T, B, n_in] -> x_proj [T, B, 4H] in compute_dtype.

    x @ W_x is one matmul over all steps with f32 accumulation: the
    operands are rounded to compute_dtype and multiplied in f32, the bias
    is added in f32, and the sum is then stored in compute_dtype."""
    T, B, n_in = x.shape
    kernel = params["kernel"]
    w_x = kernel[:n_in].to(compute_dtype)
    x_proj = torch.matmul(
        x.reshape(T * B, n_in).to(compute_dtype).float(), w_x.float()
    ) + params["bias"].float()
    return x_proj.to(compute_dtype).reshape(T, B, kernel.shape[1])


def recurrent_weights(
    params: Dict[str, torch.Tensor], n_in: int, compute_dtype: torch.dtype
) -> torch.Tensor:
    """W_h [H, 4H] in compute_dtype: the rows of the kernel below W_x."""
    return params["kernel"][n_in:].to(compute_dtype).contiguous()


def project_inputs(
    params: Dict[str, torch.Tensor], x: torch.Tensor, compute_dtype: torch.dtype
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, B, n_in] -> (x_proj [T, B, 4H] in compute_dtype, W_h [H, 4H])."""
    return (input_projection(params, x, compute_dtype),
            recurrent_weights(params, x.shape[2], compute_dtype))


def start_state(
    initial: Optional[State], batch: int, n_cell: int, device
) -> State:
    if initial is None:
        zeros = torch.zeros((batch, n_cell), dtype=torch.float32, device=device)
        return zeros, zeros.clone()
    return initial[0].float().contiguous(), initial[1].float().contiguous()


def lengths(seq_len: Optional[torch.Tensor], T: int, batch: int, device) -> torch.Tensor:
    """[B] int32 valid lengths; None means every step is valid."""
    if seq_len is None:
        return torch.full((batch,), T, dtype=torch.int32, device=device)
    return seq_len.to(device=device, dtype=torch.int32).reshape(batch)


def steps(
    x_proj: torch.Tensor,
    w_h: torch.Tensor,
    c0: torch.Tensor,
    h0: torch.Tensor,
    seq: torch.Tensor,
) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The recurrence step by step: yields (z f32 pre-activations, carried c,
    carried h, emitted out) for each t. h is rounded to w_h's dtype before
    each product, which accumulates in f32."""
    n_cell = x_proj.shape[2] // 4
    w = w_h.float()
    c, h = c0, h0
    for t in range(x_proj.shape[0]):
        z = x_proj[t].float() + torch.matmul(h.to(w_h.dtype).float(), w)
        i, g, f, o = z.split(n_cell, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        valid = (t < seq)[:, None]
        c = torch.where(valid, c_new, c)
        h = torch.where(valid, h_new, h)
        yield z, c, h, torch.where(valid, h_new, torch.zeros_like(h_new))


def stack(values, empty_shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """torch.stack that gives an empty [0, ...] tensor for no steps."""
    if not values:
        return torch.zeros(empty_shape, dtype=dtype, device=device)
    return torch.stack(values)


def recurrence(
    x_proj: torch.Tensor,
    w_h: torch.Tensor,
    c0: torch.Tensor,
    h0: torch.Tensor,
    seq: torch.Tensor,
) -> Tuple[torch.Tensor, State]:
    """The recurrence over precomputed input projections.

    x_proj [T, B, 4H] and w_h [H, 4H] in the compute dtype; c0, h0 [B, H]
    f32; seq [B] int32 -> (out [T, B, H] f32, (c, h) f32)."""
    _, B, four_h = x_proj.shape
    c, h, outs = c0, h0, []
    for _, c, h, out in steps(x_proj, w_h, c0, h0, seq):
        outs.append(out)
    return stack(outs, (0, B, four_h // 4), device=x_proj.device), (c, h)


def lstm_scan(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    seq_len: Optional[torch.Tensor] = None,
    initial_state: Optional[State] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, State]:
    """x [T, B, n_in] -> (outputs [T, B, n_cell] f32, (c, h)), all in plain
    PyTorch. The counterpart of `stt_tpu.models.lstm.lstm_scan`."""
    T, B, _ = x.shape
    x_proj, w_h = project_inputs(params, x, compute_dtype)
    c0, h0 = start_state(initial_state, B, w_h.shape[0], x.device)
    return recurrence(x_proj, w_h, c0, h0, lengths(seq_len, T, B, x.device))
