"""LSTM inference recurrences: the wrappers of the Hopper kernels in
`csrc/lstm_recurrence.cu` and `csrc/lstm_recurrence_q.cu`, which replace the
TPU kernels `stt_tpu/ops/lstm_kernel.py::_kernel` and `::_kernel_q`.

`lstm_recurrence` launches the float kernel for CUDA tensors and runs the
plain version (`stt_tpu_torch.models.lstm.recurrence`) for CPU tensors;
`lstm_recurrence_q` does the same for the int8 recurrence, whose plain
version is `stt_tpu_torch.ops.quant.recurrence_q`. There is no shape gate:
batch 1 and ragged batches take the kernels too.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from stt_tpu_torch.models.lstm import (
    State,
    lengths,
    project_inputs,
    recurrence,
    start_state,
)
from stt_tpu_torch.ops._build import check_tensors, launch, load

_ENTRY = {torch.float32: "lstm_recurrence_f32", torch.bfloat16: "lstm_recurrence_bf16"}


@functools.lru_cache(maxsize=None)
def _library_function(dtype: torch.dtype):
    fn = getattr(load("lstm_recurrence"), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x_proj, w_h, c0, h0, seq) -> None:
    if x_proj.dim() != 3 or x_proj.shape[2] % 4:
        raise ValueError(f"x_proj must be [T, B, 4H], got {tuple(x_proj.shape)}")
    T, B, four_h = x_proj.shape
    H = four_h // 4
    if x_proj.dtype not in _ENTRY or w_h.dtype != x_proj.dtype:
        raise ValueError(
            f"x_proj and w_h must both be float32 or bfloat16, got "
            f"{x_proj.dtype} and {w_h.dtype}"
        )
    check_tensors({
        "x_proj": (x_proj, (T, B, four_h), x_proj.dtype),
        "w_h": (w_h, (H, four_h), w_h.dtype),
        "c0": (c0, (B, H), torch.float32),
        "h0": (h0, (B, H), torch.float32),
        "seq": (seq, (B,), torch.int32),
    }, x_proj.device)


def lstm_recurrence(
    x_proj: torch.Tensor,
    w_h: torch.Tensor,
    c0: torch.Tensor,
    h0: torch.Tensor,
    seq: torch.Tensor,
) -> Tuple[torch.Tensor, State]:
    """x_proj [T, B, 4H] and w_h [H, 4H] (both f32 or both bf16); c0, h0
    [B, H] f32; seq [B] int32 -> (out [T, B, H] f32, (c, h) f32)."""
    _check(x_proj, w_h, c0, h0, seq)
    if x_proj.device.type == "cpu":
        return recurrence(x_proj, w_h, c0, h0, seq)
    T, B, four_h = x_proj.shape
    H = four_h // 4
    device = x_proj.device
    c = c0.clone()
    h = torch.empty((2, B, H), dtype=torch.float32, device=device)
    h[0].copy_(h0)
    out = torch.empty((T, B, H), dtype=torch.float32, device=device)
    if T == 0:
        return out, (c, h[0])
    lstm_recurrence.launches += 1
    launch(
        _library_function(x_proj.dtype), "lstm_recurrence", device,
        x_proj.data_ptr(), w_h.data_ptr(), c.data_ptr(), h.data_ptr(),
        seq.data_ptr(), out.data_ptr(), T, B, H,
    )
    return out, (c, h[T % 2])


lstm_recurrence.launches = 0


def lstm_fused(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    seq_len: Optional[torch.Tensor] = None,
    initial_state: Optional[State] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, State]:
    """Counterpart of `stt_tpu.ops.lstm_fused` (inference).

    x [T, B, n_in] -> (outputs [T, B, n_cell] f32, (c, h)). The input
    projection is one matmul outside the kernel; the recurrence runs in
    the kernel on CUDA tensors."""
    T, B, _ = x.shape
    x_proj, w_h = project_inputs(params, x, compute_dtype)
    c0, h0 = start_state(initial_state, B, w_h.shape[0], x.device)
    return lstm_recurrence(x_proj, w_h, c0, h0, lengths(seq_len, T, B, x.device))


_ENTRY_Q = {torch.float32: "lstm_recurrence_q_f32", torch.bfloat16: "lstm_recurrence_q_bf16"}


@functools.lru_cache(maxsize=None)
def _library_function_q(dtype: torch.dtype):
    fn = getattr(load("lstm_recurrence_q"), _ENTRY_Q[dtype])
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pack_w_h_q(w_h_q: torch.Tensor) -> torch.Tensor:
    """W_h_q [H, 4H] int8 -> the int8 kernel's layout [H/4, 4H, 4] int8: the
    four consecutive k of one column lie in one 32-bit word, low byte
    first, as `__dp4a` takes them. H must be a multiple of 4."""
    H, four_h = w_h_q.shape
    if w_h_q.dtype != torch.int8 or H % 4 or four_h != 4 * H:
        raise ValueError(
            f"w_h_q must be [H, 4H] int8 with H a multiple of 4, got "
            f"{tuple(w_h_q.shape)} {w_h_q.dtype}"
        )
    return w_h_q.reshape(H // 4, 4, four_h).permute(0, 2, 1).contiguous()


def lstm_recurrence_q(
    x_proj: torch.Tensor,
    w_h_q: torch.Tensor,
    step_scale: torch.Tensor,
    c0: torch.Tensor,
    h0: torch.Tensor,
    seq: torch.Tensor,
    packed: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, State]:
    """The int8 recurrence. x_proj [T, B, 4H] f32 or bf16 (bias included);
    w_h_q [H, 4H] int8; step_scale [1, 4H] f32 (W_h's per-channel scale /
    127); c0, h0 [B, H] f32; seq [B] int32 -> (out [T, B, H] f32, (c, h)
    f32). `packed` is `pack_w_h_q(w_h_q)` where the caller keeps it (the
    quantized parameters do); without it the weights are packed per call."""
    from stt_tpu_torch.ops.quant import recurrence_q

    if x_proj.dim() != 3 or x_proj.shape[2] % 16:
        raise ValueError(
            f"x_proj must be [T, B, 4H] with H a multiple of 4, got {tuple(x_proj.shape)}"
        )
    T, B, four_h = x_proj.shape
    H = four_h // 4
    if x_proj.dtype not in _ENTRY_Q:
        raise ValueError(f"x_proj must be float32 or bfloat16, got {x_proj.dtype}")
    device = x_proj.device
    expected = {
        "x_proj": (x_proj, (T, B, four_h), x_proj.dtype),
        "w_h_q": (w_h_q, (H, four_h), torch.int8),
        "step_scale": (step_scale, (1, four_h), torch.float32),
        "c0": (c0, (B, H), torch.float32),
        "h0": (h0, (B, H), torch.float32),
        "seq": (seq, (B,), torch.int32),
    }
    if packed is not None:
        expected["packed"] = (packed, (H // 4, four_h, 4), torch.int8)
    check_tensors(expected, device)
    if device.type == "cpu":
        return recurrence_q(x_proj, w_h_q, step_scale, c0, h0, seq)
    if packed is None:
        packed = pack_w_h_q(w_h_q)
    c = c0.clone()
    h = torch.empty((2, B, H), dtype=torch.float32, device=device)
    h[0].copy_(h0)
    h_q = torch.empty((2, B, H), dtype=torch.int8, device=device)
    out = torch.empty((T, B, H), dtype=torch.float32, device=device)
    if T == 0:
        return out, (c, h[0])
    lstm_recurrence_q.launches += 1
    launch(
        _library_function_q(x_proj.dtype), "lstm_recurrence_q", device,
        x_proj.data_ptr(), packed.data_ptr(), step_scale.data_ptr(), c.data_ptr(),
        h.data_ptr(), h_q.data_ptr(), seq.data_ptr(), out.data_ptr(), T, B, H,
    )
    return out, (c, h[T % 2])


lstm_recurrence_q.launches = 0
