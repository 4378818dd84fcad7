"""LSTM training recurrence: the wrappers of the Hopper kernels in
`csrc/lstm_train.cu` (K3, the forward with stashes, replacing
`stt_tpu/ops/lstm_train.py::_fwd_kernel`; K4, the reverse sweep, replacing
`::_bwd_kernel`), their plain versions, and the autograd function that
joins them, the counterpart of `_make_recurrence`'s custom_vjp.

The decomposition is the JAX package's: the forward runs the recurrence
once and stashes per step the pre-activations z (bf16, whatever the
compute dtype) and the cell states c; the backward sweeps in reverse
carrying only (dc, dh), forms the gate grads dz from the stashes and
dh_{t-1} = dz . W_h^T; outside the kernels, dW_h = h_prev^T . dz is one
matmul and dx_proj = dz. Because the backward's gates come from bf16 z,
gradients differ from autodiff of `lstm_scan` by ~1e-3 even in f32.

CUDA tensors launch the kernels (or raise); CPU tensors run the plain
versions. Each wrapper counts its kernel launches in `.launches`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from stt_tpu_torch import trace
from stt_tpu_torch.models.lstm import (
    State,
    lengths,
    project_inputs,
    stack,
    start_state,
    steps,
)
from stt_tpu_torch.ops._build import check_tensors, launch, load
from stt_tpu_torch.ops.lstm_kernel import TILE_COLUMNS, pack_w_h, plan_for, run_persistent

_DTYPES = (torch.float32, torch.bfloat16)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.lru_cache(maxsize=None)
def _library_function(kind: str, dtype: torch.dtype):
    fn = getattr(load("lstm_train"), f"lstm_train_{kind}_{_SUFFIX[dtype]}")
    # twelve pointers (fwd) or eleven (bwd), then T, B, H and the five ints
    # of the launch plan
    n_pointers, n_ints = {"fwd": (12, 8), "bwd": (11, 8)}[kind]
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# --- K3: forward with stashes --------------------------------------------


def train_forward(x_proj, w_h, c0, h0, seq):
    """K3's plain version. x_proj [T, B, 4H] and w_h [H, 4H] in the compute
    dtype; c0, h0 [B, H] f32; seq [B] int32 -> (hs [T, B, H] f32, zero past
    the length; cs [T, B, H] f32, the carried c; zs [T, B, 4H] bf16; c_T,
    h_T [B, H] f32)."""
    T, B, four_h = x_proj.shape
    H = four_h // 4
    c, h, hs, cs, zs = c0, h0, [], [], []
    for z, c, h, out in steps(x_proj, w_h, c0, h0, seq):
        hs.append(out)
        cs.append(c)
        zs.append(z.to(torch.bfloat16))
    dev = x_proj.device
    return (
        stack(hs, (0, B, H), device=dev),
        stack(cs, (0, B, H), device=dev),
        stack(zs, (0, B, four_h), torch.bfloat16, dev),
        c,
        h,
    )


def lstm_train_fwd(x_proj, w_h, c0, h0, seq, packed=None):
    """K3: `train_forward`'s function, in the kernel on CUDA tensors: one
    persistent launch for all T steps (`csrc/lstm_step.cuh`). `packed` is
    `pack_w_h(w_h)` where the caller has it; without it W_h is packed per
    call (training changes it every step: one pass over W_h, small beside
    the recurrence)."""
    T, B, four_h = x_proj.shape
    H = four_h // 4
    if x_proj.dtype not in _DTYPES:
        raise ValueError(f"x_proj must be float32 or bfloat16, got {x_proj.dtype}")
    check_tensors({
        "x_proj": (x_proj, (T, B, four_h), x_proj.dtype),
        "w_h": (w_h, (H, four_h), x_proj.dtype),
        "c0": (c0, (B, H), torch.float32),
        "h0": (h0, (B, H), torch.float32),
        "seq": (seq, (B,), torch.int32),
    }, x_proj.device)
    if x_proj.device.type == "cpu":
        return train_forward(x_proj, w_h, c0, h0, seq)
    device = x_proj.device
    hs = torch.empty((T, B, H), dtype=torch.float32, device=device)
    cs = torch.empty((T, B, H), dtype=torch.float32, device=device)
    zs = torch.empty((T, B, four_h), dtype=torch.bfloat16, device=device)
    if T == 0 or B == 0 or H == 0:
        return hs, cs, zs, c0.clone(), h0.clone()
    lstm_train_fwd.launches += 1
    c, h = run_persistent(_library_function("fwd", x_proj.dtype), "lstm_train_fwd",
                          x_proj, pack_w_h(w_h) if packed is None else packed, c0, h0, seq,
                          (hs, cs, zs))
    return hs, cs, zs, c, h


lstm_train_fwd.launches = 0


# --- K4: reverse sweep ------------------------------------------------------


def train_backward(zs, cs, cs_prev, dout, w_h, seq, dc_T, dh_T):
    """K4's plain version. zs [T, B, 4H] bf16; cs, cs_prev, dout [T, B, H]
    f32; w_h [H, 4H] in the compute dtype; seq [B] int32; dc_T, dh_T [B, H]
    f32 -> (dz [T, B, 4H] f32, dc0, dh0 [B, H] f32). dz is rounded to w_h's
    dtype before dz . W_h^T, which accumulates in f32; past a row's length
    dz is 0 and the carries pass through."""
    T, B, four_h = zs.shape
    H = four_h // 4
    w_t = w_h.float().T
    dc, dh = dc_T, dh_T
    dzs = [None] * T
    for t in reversed(range(T)):
        i, g, f, o = zs[t].float().split(H, dim=-1)
        i, g, f, o = torch.sigmoid(i), torch.tanh(g), torch.sigmoid(f), torch.sigmoid(o)
        tanh_c = torch.tanh(cs[t])
        dh_total = dout[t] + dh
        dc_total = dc + dh_total * o * (1.0 - tanh_c * tanh_c)
        dz = torch.cat([
            dc_total * g * i * (1.0 - i),
            dc_total * i * (1.0 - g * g),
            dc_total * cs_prev[t] * f * (1.0 - f),
            dh_total * tanh_c * o * (1.0 - o),
        ], dim=-1)
        valid = (t < seq)[:, None]
        dz = torch.where(valid, dz, torch.zeros_like(dz))
        dh_prev = torch.matmul(dz.to(w_h.dtype).float(), w_t)
        dc = torch.where(valid, dc_total * f, dc)
        dh = torch.where(valid, dh_prev, dh)
        dzs[t] = dz
    return stack(dzs, (0, B, four_h), device=zs.device), dc, dh


def lstm_train_bwd(zs, cs, cs_prev, dout, w_h, seq, dc_T, dh_T, packed=None):
    """K4: `train_backward`'s function, in the kernel on CUDA tensors: one
    persistent launch for all T steps on the forward's layout of W_h.
    `packed` is `pack_w_h(w_h)` where the caller has it (the autograd
    function keeps the forward's); without it W_h is packed per call."""
    T, B, four_h = zs.shape
    H = four_h // 4
    if w_h.dtype not in _DTYPES:
        raise ValueError(f"w_h must be float32 or bfloat16, got {w_h.dtype}")
    check_tensors({
        "zs": (zs, (T, B, four_h), torch.bfloat16),
        "cs": (cs, (T, B, H), torch.float32),
        "cs_prev": (cs_prev, (T, B, H), torch.float32),
        "dout": (dout, (T, B, H), torch.float32),
        "w_h": (w_h, (H, four_h), w_h.dtype),
        "seq": (seq, (B,), torch.int32),
        "dc_T": (dc_T, (B, H), torch.float32),
        "dh_T": (dh_T, (B, H), torch.float32),
    }, zs.device)
    if zs.device.type == "cpu":
        return train_backward(zs, cs, cs_prev, dout, w_h, seq, dc_T, dh_T)
    device = zs.device
    dc = dc_T.clone()
    dh = dh_T.clone()
    dz = torch.empty((T, B, four_h), dtype=torch.float32, device=device)
    if T == 0 or B == 0 or H == 0:
        return dz, dc, dh
    plan = plan_for(B, H, w_h.dtype, device, backward=True)
    if packed is None:
        packed = pack_w_h(w_h)
    check_tensors({"packed": (packed, (plan.tiles, plan.padded_h, TILE_COLUMNS), w_h.dtype)},
                  device)
    # two planes of partials, then the barrier's counter (zeroed alone:
    # every partial is written before it is read)
    plane = plan.tiles * plan.padded_h * plan.padded_rows
    part = torch.empty(2 * plane + 1, dtype=torch.float32, device=device)
    part[-1:].zero_()
    lstm_train_bwd.launches += 1
    launch(
        _library_function("bwd", w_h.dtype), "lstm_train_bwd", device,
        zs.data_ptr(), cs.data_ptr(), cs_prev.data_ptr(), dout.data_ptr(),
        packed.data_ptr(), seq.data_ptr(), dc.data_ptr(), dh.data_ptr(),
        dz.data_ptr(), part.data_ptr(), part[-1:].data_ptr(), T, B, H, plan.rows,
        plan.blocks, plan.tiles_per_block, plan.resident_chunks, plan.smem_bytes,
    )
    return dz, dc, dh


lstm_train_bwd.launches = 0


# --- the differentiable recurrence ------------------------------------------


class _Recurrence(torch.autograd.Function):
    """(x_proj, w_h f32, c0, h0, seq) -> (hs, c_T, h_T), with K3 as the
    forward and K4 plus two matmuls as the backward (`rec_fwd`/`rec_bwd`
    of `_make_recurrence`). On the card W_h is packed once a step: K4
    reads the forward's packed copy."""

    @staticmethod
    def forward(ctx, x_proj, w_h, c0, h0, seq, compute_dtype):
        w = w_h.to(compute_dtype).contiguous()
        packed = pack_w_h(w) if x_proj.device.type == "cuda" else None
        hs, cs, zs, c_T, h_T = lstm_train_fwd(x_proj, w, c0, h0, seq, packed=packed)
        ctx.save_for_backward(w, c0, h0, seq, hs, cs, zs)
        ctx.packed = packed
        ctx.dtypes = (x_proj.dtype, w_h.dtype)
        return hs, c_T, h_T

    @staticmethod
    def backward(ctx, d_hs, d_cT, d_hT):
        w, c0, h0, seq, hs, cs, zs = ctx.saved_tensors
        x_dtype, w_dtype = ctx.dtypes
        with trace.span("lstm.bwd"):
            cs_prev = torch.cat([c0[None], cs])[:hs.shape[0]]
            dz, dc0, dh0 = lstm_train_bwd(
                zs, cs, cs_prev.contiguous(), _cotangent(d_hs, hs), w, seq,
                _cotangent(d_cT, c0), _cotangent(d_hT, h0), packed=ctx.packed,
            )
            ctx.packed = None
            dw_h = weight_grad(h0, hs, dz, w.dtype)
        # x_proj is stored in the compute dtype, so its gradient is too
        return dz.to(x_dtype), dw_h.to(w_dtype), dc0, dh0, None, None


def weight_grad(h0, hs, dz, dtype: torch.dtype) -> torch.Tensor:
    """dW_h = h_prev^T . dz as one matmul over all T steps, the operands
    rounded to the compute dtype, accumulated in f32: h0 [B, H], hs
    [T, B, H], dz [T, B, 4H] -> [H, 4H] f32."""
    T, B, H = hs.shape
    h_prev = torch.cat([h0[None], hs])[:T].reshape(T * B, H)
    return torch.matmul(h_prev.to(dtype).float().T, dz.reshape(T * B, 4 * H).to(dtype).float())


def _cotangent(grad: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    if grad is None:
        return torch.zeros_like(like, dtype=torch.float32)
    return grad.float().contiguous()


def lstm_train(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    seq_len: Optional[torch.Tensor] = None,
    initial_state: Optional[State] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, State]:
    """Counterpart of `stt_tpu.ops.lstm_train.lstm_train`: the training
    path's drop-in for `lstm_scan`.

    x [T, B, n_in] -> (outputs [T, B, n_cell] f32, (c, h)), differentiable
    with respect to params, x and initial_state."""
    T, B, n_in = x.shape
    x_proj, _ = project_inputs(params, x, compute_dtype)
    w_h = params["kernel"][n_in:]
    c0, h0 = start_state(initial_state, B, w_h.shape[0], x.device)
    seq = lengths(seq_len, T, B, x.device)
    hs, c, h = _Recurrence.apply(x_proj, w_h, c0, h0, seq, compute_dtype)
    return hs, (c, h)
