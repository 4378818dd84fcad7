#!/usr/bin/env python3
"""Chip smoke run of stt_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--seed N] [--out REPORT.json] [--phases k1,k3k4]

1. Setup: prints the card's name and power limit, turns TF32 off, builds
   every CUDA kernel of the package from its sources (build/kernels/), one
   nvcc per source, all at once.
2. Kernel phase: holds each kernel against its plain PyTorch version on the
   card at the shapes of the main path and beyond, and times the kernel,
   the plain version, the bound and, where one exists, the one PyTorch
   call that computes the same function:
   - K1, the inference recurrence, at H = 2048, B in {1, 8, 16, 32}, T in
     {16, 200} and the batch request's (B, T) = (16, 240), f32 and bf16,
     ragged lengths, non-zero initial state, with the launch plan, the time
     per step, the ratio to cuDNN and, at a stream's chunk (B = 1, T = 16),
     the time with the L2 overwritten between calls;
   - K3 and K4, the training forward with stashes and the reverse sweep,
     at H = 2048, B in {8, 32}, T in {50, 200} and at the training phase's
     shape (B = 16, T = 256), f32 and bf16, ragged lengths, non-zero
     initial state and final-state gradients; the library time is cuDNN's
     training forward and its backward.
   - K2, the int8 inference recurrence, at H = 2048, B in {1, 8, 16, 32}, T
     in {16, 200}, x_proj in f32 and bf16, ragged lengths, non-zero initial
     state: one step from a common state (the int32 sums are exact), then
     the sequence, with the count of h_q values that differ;
   - K5, the beam scan, at (W, C) in {(8, 8), (32, 29), (128, 29),
     (128, 127), (500, 29), (512, 31)}, B in {1, 16}, T in {16, 200}, peaky
     and flat emissions, one utterance shorter than T; the cutoff branches,
     an external class layout, chunks of 16 against one launch, and a state
     handed from the plain version to the kernel mid-stream, at beam 32 and
     at the serving default of 500. Backpointers must be equal.
3. Serving phase: a full-width DeepSpeech (the 2048 geometry, 29 outputs)
   with random weights from a seeded generator, saved as an artifact and
   opened with `Model(dir)` on the card; answers `stt` on three utterances,
   `stt_with_metadata`, one `Stream` fed in 320 ms pieces with intermediate
   decodes, and `infer_logits` at B = 16. Each of these must launch K1 and
   no other kernel, and the probabilities must match the same model run
   by the port on the CPU. Then the two opt-in paths: a stream with
   device_decode, at the artifact's beam of 32 and at `Model`'s default of
   500, which must launch K5 once per chunk (and K1) and whose transcript,
   tokens and timesteps must be those of the plain beam scan on the same
   emissions, and a batch device decode of the B = 16 logits from a host
   array; and `Model(dir, quantized_inference=True)`, whose `infer_logits`
   must launch K2 and not K1 and is held against the port's int8 path on
   the CPU and against the float logits, with K2 held against its plain
   version and timed on that request's own input projection.
4. Training phase: 32 seeded synthetic utterances of 2-5 s with random
   transcripts, a train and a dev CSV, and `train(SttConfig(...))` of the
   full-width model at B = 16 for one epoch with dropout; every step must
   launch K3 and K4, losses must be finite, the parameters must move, the
   checkpoints must exist, and the trained weights, exported as an
   artifact, must answer `Model(dir).stt`. Then one full-width step on the
   card against the same step on the CPU (B = 2, dropout 0), the train
   step's time at B = 16, and where one profiled step's device time goes.
5. Prints one JSON line listing every kernel, the card's name and power
   limit, and as the last line {"ok": true, "device": {...}}.

Any failure raises and the script exits non-zero. Without CUDA it exits 1
and prints no result. --out writes the full record as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}  # dense, H100 SXM
# kernel vs plain version: float32 sums in another order; in bf16 those
# ~1e-7 differences tip a few h values across a bf16 rounding boundary
K1_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-4}
# K3 and K4 vs their plain versions: hs, cs, the state, dz, dc0 and dh0 by
# max abs diff, for K1's reasons; K4 also rounds dz to bf16 before the
# product with a bf16 W_h, and h's bf16 roundings tip over up to 256
# steps, so bf16 allows 5e-4 (measured up to 2.4e-7 in f32 and 1.7e-4 in
# bf16 on an H100). zs is bf16 in both dtypes: within one bf16 ulp (2^-7
# of the value) plus the tolerance.
TRAIN_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-4}
# card vs CPU, one full-width train step in f32: the loss, the gradient
# norm, and the LSTM kernel's gradient (relative to its largest value);
# 47M-parameter products summed in another order (measured on an H100:
# equal loss and norm, 5e-6 on the LSTM kernel's gradient)
STEP_LOSS_RTOL, STEP_GRAD_NORM_RTOL, STEP_LSTM_GRAD_TOL = 1e-4, 1e-3, 1e-3
# K2 vs its plain version. One step from a common state: the int32 sums are
# equal, so z differs only by float32 rounding. Over a sequence a last-bit
# difference in expf/tanhf moves some h * 127 across a rounding boundary;
# that h_q then differs by one step, which moves z of the next step by up to
# one weight scale (0.022 at H = 2048), and the difference spreads (measured
# on an H100: at most 0.5% of the h_q values and 1.5e-3 over 200 steps). The
# count of h_q values that differ is printed.
K2_STEP_TOL, K2_SEQ_TOL = 1e-5, 1e-2
K5_SCORE_TOL = 1e-4  # K5's beam scores vs the plain version's (f32 log sums)
K5_TIE_ULPS = 4  # see compare_beam
# int8 logits of the full-width model, card vs the port's int8 path on the
# CPU from the same quantized weights: the h_q flips above move h by ~1e-3,
# and with random weights the hidden activations are ~0.1 against a
# quantization step of relu_clip / 127 = 0.157, so that moves about 1% of
# layer_6's inputs across a rounding boundary, each worth up to 0.157 x a
# weight (~0.05): the largest difference is a sum of such flips (measured
# 7.7e-2 on an H100 beside a largest logit of 0.41), the mean stays small.
# int8 vs float logits on the card is the quantization error itself at that
# coarse step (measured 0.22).
INT8_CARD_CPU_TOL, INT8_CARD_CPU_MEAN_TOL, INT8_FLOAT_TOL = 0.2, 2e-2, 0.5
INT8_OPS_PER_S = 1979e12  # dense int8, H100 SXM
PROBS_TOL = 1e-4  # card vs CPU probabilities of the full-width model, f32
LOGITS_TOL = 2e-3  # card vs CPU logits of the full-width model, f32
LABELS = list(" abcdefghijklmnopqrstuvwxyz'")  # English, 28 labels + blank
BEAM_WIDTH = 32
TRAIN_SHAPE = (16, 256)  # (B, T) of the training phase's longest batch


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs, by CUDA events, after one
    warm-up run."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(moved_bytes: int, ops: int, dtype: torch.dtype) -> tuple:
    """Least time for a function's work on the card: the bytes it must move
    (each input read once, each output written once) at the memory rate
    against its matmul operations at the peak rate of the input type.
    Returns (bound_ms, bound_by)."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def recurrence_bounds(kind: str, T: int, B: int, H: int, valid_steps: int,
                      dtype: torch.dtype) -> tuple:
    """(bound_ms, bound_by, w_h_per_step_ms) of K1 ("k1"), K3 ("fwd") or K4
    ("bwd") over T steps of B rows, of which valid_steps (the sum of the
    lengths) need the product h . W_h (or dz . W_h^T), 2 H 4H operations
    each. The last is W_h read once per step, the floor of any design that
    cannot keep W_h on chip."""
    item = torch.finfo(dtype).bits // 8
    state = 2 * B * H * 4  # (c, h) or (dc, dh), f32
    w_h = H * 4 * H * item
    if kind == "k1":  # x_proj, W_h, state, seq -> out, state
        moved = T * B * 4 * H * item + w_h + state + B * 4 + T * B * H * 4 + state
    elif kind == "fwd":  # ... -> hs, cs (f32), zs (bf16), state
        moved = T * B * 4 * H * item + w_h + state + B * 4 + 2 * T * B * H * 4 + T * B * 4 * H * 2 + state
    else:  # zs (bf16), cs, cs_prev, dout, W_h, seq, state -> dz (f32), state
        moved = T * B * 4 * H * 2 + 3 * T * B * H * 4 + w_h + B * 4 + state + T * B * 4 * H * 4 + state
    ms, by = bound_ms(moved, 2 * valid_steps * H * 4 * H, dtype)
    return ms, by, T * w_h / HBM_BYTES_PER_S * 1e3


def streaming_floors(plan, T: int, H: int, dtype: torch.dtype, device) -> dict:
    """Floors of a recurrence that keeps part of W_h in shared memory for the
    whole call and streams the rest from device memory at every step, over T
    steps: for this launch plan's resident share, and for a design that
    filled every SM's shared memory with weights. (The first step also
    reads the resident part once: one more step's worth at most.)"""
    props = torch.cuda.get_device_properties(device)
    w_h = H * 4 * H * (torch.finfo(dtype).bits // 8)
    streamed = plan.tiles * plan.groups * (plan.chunks - plan.resident_chunks) * 16384
    on_chip = props.multi_processor_count * getattr(props, "shared_memory_per_block_optin", 232448)
    return {
        "streamed_bytes_per_step": streamed,
        "plan_floor_ms": (T * streamed + min(w_h, plan.tiles * plan.resident_chunks * 16384))
                         / HBM_BYTES_PER_S * 1e3,
        "all_smem_floor_ms": (T * max(w_h - on_chip, 0) + min(w_h, on_chip)) / HBM_BYTES_PER_S * 1e3,
    }


def cudnn_lstm(w_h: torch.Tensor, H: int, device) -> torch.nn.LSTM:
    """torch.nn.LSTM (cuDNN) computing K1's function over x_proj at full
    lengths: the input weights are the permutation that takes x_proj's
    i, g, f, o gate blocks to cuDNN's i, f, g, o, the recurrent weights are
    W_h's blocks in that order, and the biases are zero."""
    order = [0, 2, 1, 3]
    lstm = torch.nn.LSTM(4 * H, H).to(device)
    eye = torch.eye(4 * H, device=device)
    blocks = [slice(g * H, (g + 1) * H) for g in order]
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.cat([eye[b] for b in blocks]))
        lstm.weight_hh_l0.copy_(torch.cat([w_h.float()[:, b].T for b in blocks]))
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()
    return lstm


def flush_l2(device) -> torch.Tensor:
    """A buffer larger than the 50 MB L2: writing it evicts what lay there."""
    return torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32, device=device)


def alone_ms(fn, spoil, reps: int) -> float:
    """Mean milliseconds of fn() run alone: events around each run, a
    synchronise after it, so the host's launches are not hidden behind the
    run before. With `spoil` (see flush_l2) each run also finds the L2
    overwritten, as a stream's chunk finds it after the dense layers."""
    fn()
    total = 0.0
    for _ in range(reps):
        if spoil is not None:
            spoil.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def k1_phase(device, seed: int) -> list:
    from stt_tpu_torch.models.lstm import recurrence
    from stt_tpu_torch.ops.lstm_kernel import lstm_recurrence, pack_w_h, plan_for

    H = 2048
    gen = torch.Generator().manual_seed(seed)
    limit = (6.0 / (6 * H)) ** 0.5  # lstm_init's Glorot limit at this width
    w32 = ((torch.rand(H, 4 * H, generator=gen) * 2 - 1) * limit).to(device)
    spoil = flush_l2(device)
    records = []
    # a stream's chunk (B = 1, T = 16), the batch request (B = 16, T = 240)
    # and the shapes around them
    shapes = [(B, T) for B in (1, 8, 16, 32) for T in (16, 200)] + [(16, 240)]
    for dtype in (torch.float32, torch.bfloat16):
        w_h = w32.to(dtype).contiguous()
        packed = pack_w_h(w_h)  # kept across calls, as the serving model keeps it
        pack_ms = cuda_ms(lambda: pack_w_h(w_h), 5)
        lstm = cudnn_lstm(w_h, H, device) if dtype == torch.float32 else None
        for B, T in shapes:
            x_proj = (torch.randn(T, B, 4 * H, generator=gen) * 0.5).to(device).to(dtype)
            c0 = (torch.randn(B, H, generator=gen) * 0.1).to(device)
            h0 = ((torch.rand(B, H, generator=gen) * 2 - 1) * 0.1).to(device)
            seq = torch.randint(1, T + 1, (B,), generator=gen, dtype=torch.int32)
            seq[0] = T
            seq = seq.to(device)
            got, (c, h) = lstm_recurrence(x_proj, w_h, c0, h0, seq)  # packs per call
            kept, (c_kept, h_kept) = lstm_recurrence(x_proj, None, c0, h0, seq, packed=packed)
            want, (c_ref, h_ref) = recurrence(x_proj, w_h, c0, h0, seq)
            torch.cuda.synchronize()
            if not (torch.equal(got, kept) and torch.equal(c, c_kept) and torch.equal(h, h_kept)):
                raise AssertionError(f"K1 {dtype} B={B} T={T}: kept packed weights give another result")
            err = max(
                (got - want).abs().max().item(),
                (c - c_ref).abs().max().item(),
                (h - h_ref).abs().max().item(),
            )
            if not err <= K1_TOL[dtype]:
                raise AssertionError(
                    f"K1 {dtype} B={B} T={T}: max abs diff {err} > {K1_TOL[dtype]}"
                )
            reps = 20 if T <= 16 else 5
            run = lambda: lstm_recurrence(x_proj, None, c0, h0, seq, packed=packed)
            ms = cuda_ms(run, reps)
            # the plain version is a host-bound loop: one timed run of the long ones
            plain_ms = cuda_ms(lambda: recurrence(x_proj, w_h, c0, h0, seq), reps if T <= 16 else 1)
            library_ms = library_err = None
            if lstm is not None:
                full = torch.full((B,), T, dtype=torch.int32, device=device)
                k_out, (k_c, k_h) = lstm_recurrence(x_proj, w_h, c0, h0, full)
                with torch.no_grad():
                    l_out, (l_h, l_c) = lstm(x_proj, (h0[None], c0[None]))
                library_err = max(
                    (k_out - l_out).abs().max().item(),
                    (k_c - l_c[0]).abs().max().item(),
                    (k_h - l_h[0]).abs().max().item(),
                )
                if library_err <= 1e-4:
                    with torch.no_grad():
                        library_ms = cuda_ms(lambda: lstm(x_proj, (h0[None], c0[None])), reps)
            bound, bound_by, w_step_ms = recurrence_bounds(
                "k1", T, B, H, int(seq.sum()), dtype)
            rec = {
                "dtype": str(dtype).replace("torch.", ""), "B": B, "T": T, "H": H,
                "kernel": "persistent", "plan": plan_for(B, H, dtype, device).describe(),
                **streaming_floors(plan_for(B, H, dtype, device), T, H, dtype, device),
                "max_abs_err": err, "tol": K1_TOL[dtype], "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "library_max_abs_err": library_err, "bound_ms": bound,
                "bound_by": bound_by, "w_h_per_step_bound_ms": w_step_ms,
                "us_per_step": ms / T * 1e3,
                "vs_library": (ms / library_ms) if library_ms else None,
                "pack_w_h_ms": pack_ms,
            }
            if (B, T) == (1, 16):  # a stream finds W_h cold after the dense layers
                rec["alone_ms"] = alone_ms(run, None, 10)
                rec["l2_flushed_ms"] = alone_ms(run, spoil, 10)
                if lstm is not None and library_ms is not None:
                    with torch.no_grad():
                        call = lambda: lstm(x_proj, (h0[None], c0[None]))
                        rec["alone_library_ms"] = alone_ms(call, None, 10)
                        rec["l2_flushed_library_ms"] = alone_ms(call, spoil, 10)
            print("k1", json.dumps(rec), flush=True)
            records.append(rec)
        del lstm
    return records


def assert_zs_close(got: torch.Tensor, want: torch.Tensor, tol: float, what: str) -> None:
    """bf16 stashes: within one bf16 ulp (2^-7 of the value) plus tol."""
    got, want = got.float(), want.float()
    excess = ((got - want).abs() - (2.0 ** -7 * want.abs() + tol)).max().item()
    if excess > 0:
        raise AssertionError(f"{what}: zs off by more than one bf16 ulp + {tol} (by {excess})")


def train_kernel_phase(device, seed: int) -> list:
    """K3 and K4 against their plain versions, timed beside their bound,
    the plain versions and cuDNN's training forward and backward."""
    from stt_tpu_torch.ops.lstm_kernel import plan_for
    from stt_tpu_torch.ops.lstm_train import (
        lstm_train_bwd, lstm_train_fwd, train_backward, train_forward,
    )

    H = 2048
    gen = torch.Generator().manual_seed(seed + 7)
    limit = (6.0 / (6 * H)) ** 0.5
    w32 = ((torch.rand(H, 4 * H, generator=gen) * 2 - 1) * limit).to(device)
    records = []
    shapes = [(8, 50), (8, 200), (32, 50), (32, 200), TRAIN_SHAPE]
    for dtype in (torch.float32, torch.bfloat16):
        w_h = w32.to(dtype).contiguous()
        lstm = cudnn_lstm(w_h, H, device) if dtype == torch.float32 else None
        tol = TRAIN_TOL[dtype]
        for B, T in shapes:
            name = f"{str(dtype).replace('torch.', '')} B={B} T={T}"
            x_proj = (torch.randn(T, B, 4 * H, generator=gen) * 0.5).to(device).to(dtype)
            c0 = (torch.randn(B, H, generator=gen) * 0.1).to(device)
            h0 = ((torch.rand(B, H, generator=gen) * 2 - 1) * 0.1).to(device)
            seq = torch.randint(1, T + 1, (B,), generator=gen, dtype=torch.int32)
            seq[0] = T
            seq = seq.to(device)
            dout = (torch.randn(T, B, H, generator=gen) * 0.1).to(device)
            dc_T = (torch.randn(B, H, generator=gen) * 0.1).to(device)
            dh_T = (torch.randn(B, H, generator=gen) * 0.1).to(device)

            fwd_args = (x_proj, w_h, c0, h0, seq)
            got = lstm_train_fwd(*fwd_args)
            want = train_forward(*fwd_args)
            torch.cuda.synchronize()
            fwd_err = max((g - w).abs().max().item()
                          for i, (g, w) in enumerate(zip(got, want)) if i != 2)
            if not fwd_err <= tol:
                raise AssertionError(f"K3 {name}: max abs diff {fwd_err} > {tol}")
            assert_zs_close(got[2], want[2], tol, f"K3 {name}")
            zs, cs = want[2], want[1]
            cs_prev = torch.cat([c0[None], cs[:-1]]).contiguous()
            bwd_args = (zs, cs, cs_prev, dout, w_h, seq, dc_T, dh_T)
            got_b = lstm_train_bwd(*bwd_args)
            want_b = train_backward(*bwd_args)
            torch.cuda.synchronize()
            bwd_err = max((g - w).abs().max().item() for g, w in zip(got_b, want_b))
            if not bwd_err <= tol:
                raise AssertionError(f"K4 {name}: max abs diff {bwd_err} > {tol}")

            reps = 3 if T >= 200 else 10
            rec = {"dtype": str(dtype).replace("torch.", ""), "B": B, "T": T, "H": H,
                   "tol": tol, "valid_steps": int(seq.sum()), "fwd_kernel": "persistent",
                   "fwd_plan": plan_for(B, H, dtype, device).describe(),
                   "fwd_floors": streaming_floors(plan_for(B, H, dtype, device), T, H, dtype, device)}
            for kind, err, fn, plain, args in (
                ("fwd", fwd_err, lstm_train_fwd, train_forward, fwd_args),
                ("bwd", bwd_err, lstm_train_bwd, train_backward, bwd_args),
            ):
                ms = cuda_ms(lambda: fn(*args), reps)
                bound, bound_by, w_step_ms = recurrence_bounds(
                    kind, T, B, H, int(seq.sum()), dtype)
                rec[kind] = {
                    "max_abs_err": err, "ms": ms, "us_per_step": ms / T * 1e3,
                    "plain_ms": cuda_ms(lambda: plain(*args), 1 if T >= 200 else 3),
                    "bound_ms": bound, "bound_by": bound_by, "w_h_per_step_bound_ms": w_step_ms,
                    "library_ms": None, "library_rel_err": None, "vs_library": None,
                }
            if lstm is not None:
                cudnn_times(rec, lstm, x_proj, w_h, c0, h0, dout, dc_T, dh_T, reps)
                for kind in ("fwd", "bwd"):
                    if rec[kind]["library_ms"]:
                        rec[kind]["vs_library"] = rec[kind]["ms"] / rec[kind]["library_ms"]
            print("k3k4", json.dumps(rec), flush=True)
            records.append(rec)
        del lstm
    return records


def cudnn_times(rec: dict, lstm, x_proj, w_h, c0, h0, dout, dc_T, dh_T, reps: int) -> None:
    """cuDNN's training forward and backward on K3's and K4's function at
    full lengths, timed where it agrees with the kernels. Its backward also
    forms the weight gradients and the input GEMM's gradient, which K4
    leaves outside."""
    from stt_tpu_torch.ops.lstm_train import lstm_train_bwd, lstm_train_fwd

    T, B, _ = x_proj.shape
    full = torch.full((B,), T, dtype=torch.int32, device=x_proj.device)
    hs, cs, zs, c_T, h_T = lstm_train_fwd(x_proj, w_h, c0, h0, full)
    cs_prev = torch.cat([c0[None], cs[:-1]]).contiguous()
    dz, dc0, dh0 = lstm_train_bwd(zs, cs, cs_prev, dout, w_h, full, dc_T, dh_T)
    xr = x_proj.detach().clone().requires_grad_()
    h0r = h0[None].detach().clone().requires_grad_()
    c0r = c0[None].detach().clone().requires_grad_()
    with torch.enable_grad():
        out, (hn, cn) = lstm(xr, (h0r, c0r))
        torch.autograd.backward([out, hn, cn], [dout, dh_T[None], dc_T[None]], retain_graph=True)
    fwd_err = max((out - hs).abs().max().item(), (cn[0] - c_T).abs().max().item(),
                  (hn[0] - h_T).abs().max().item())
    # K4's gates come from bf16 z, cuDNN's from f32 z: ~1e-3 apart
    bwd_err = max(((xr.grad - dz).abs().max() / dz.abs().max()).item(),
                  ((c0r.grad[0] - dc0).abs().max() / dc0.abs().max()).item(),
                  ((h0r.grad[0] - dh0).abs().max() / dh0.abs().max()).item())
    rec["fwd"]["library_rel_err"] = fwd_err
    rec["bwd"]["library_rel_err"] = bwd_err
    if fwd_err <= 1e-4:
        with torch.enable_grad():
            rec["fwd"]["library_ms"] = cuda_ms(lambda: lstm(xr, (h0r, c0r)), reps)
    if bwd_err <= 2e-2:
        rec["bwd"]["library_ms"] = cuda_ms(
            lambda: torch.autograd.backward([out, hn, cn], [dout, dh_T[None], dc_T[None]],
                                            retain_graph=True), reps)


def k2_record(name: str, args: tuple, packed: torch.Tensor) -> dict:
    """Holds K2 against its plain version on args = (x_proj, w_h_q,
    step_scale, c0, h0, seq): one step from the common start state, then
    the sequence, with the count of h_q values that differ; and times it
    beside its bound and the plain version."""
    from stt_tpu_torch.ops.lstm_kernel import lstm_recurrence_q
    from stt_tpu_torch.ops.quant import recurrence_q

    x_proj, w_h_q, step_scale, c0, h0, seq = args
    T, B, four_h = x_proj.shape
    H = four_h // 4

    def diff(got, want):  # over (out, (c, h))
        return max((g - w).abs().max().item() for g, w in
                   zip((got[0], *got[1]), (want[0], *want[1])))

    one = (x_proj[:1].contiguous(), w_h_q, step_scale, c0, h0, seq.clamp(max=1))
    step_err = diff(lstm_recurrence_q(*one, packed=packed), recurrence_q(*one))
    if not step_err <= K2_STEP_TOL:
        raise AssertionError(f"{name}: one step off by {step_err} > {K2_STEP_TOL}")
    got = lstm_recurrence_q(*args, packed=packed)
    want = recurrence_q(*args)
    torch.cuda.synchronize()
    err = diff(got, want)
    valid = torch.arange(T, device=x_proj.device)[:, None] < seq[None, :]
    differ = (torch.round(got[0] * 127) != torch.round(want[0] * 127))[valid]
    if not err <= K2_SEQ_TOL:
        raise AssertionError(f"{name}: max abs diff {err} > {K2_SEQ_TOL}, "
                             f"{int(differ.sum())} of {differ.numel()} h_q differ")
    reps = 20 if T <= 16 else 5
    ms = cuda_ms(lambda: lstm_recurrence_q(*args, packed=packed), reps)
    plain_ms = cuda_ms(lambda: recurrence_q(*args), 2 if T > 16 else 5)
    item = torch.finfo(x_proj.dtype).bits // 8
    state = 2 * B * H * 4
    moved = (T * B * 4 * H * item + H * 4 * H + 4 * H * 4 + state + B * 4
             + T * B * H * 4 + state)
    ops = 2 * int(seq.sum()) * H * 4 * H
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return {
        "dtype": str(x_proj.dtype).replace("torch.", ""), "B": B, "T": T, "H": H,
        "valid_steps": int(seq.sum()),
        "one_step_max_abs_err": step_err, "one_step_tol": K2_STEP_TOL,
        "max_abs_err": err, "tol": K2_SEQ_TOL,
        "h_q_differ": int(differ.sum()), "h_q_valid": differ.numel(),
        "ms": ms, "us_per_step": ms / T * 1e3, "plain_ms": plain_ms,
        "library_ms": None, "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "w_h_per_step_bound_ms": T * H * 4 * H / HBM_BYTES_PER_S * 1e3,
    }


def k2_phase(device, seed: int) -> list:
    """K2 against its plain version: one step from a common state, then the
    sequence; timed beside its bound and the plain version. No PyTorch call
    computes this quantized recurrence, so there is no library time."""
    from stt_tpu_torch.ops.lstm_kernel import pack_w_h_q
    from stt_tpu_torch.ops.quant import _quantize_weight

    H = 2048
    gen = torch.Generator().manual_seed(seed + 11)
    limit = (6.0 / (6 * H)) ** 0.5
    w_h_q, w_scale = _quantize_weight(((torch.rand(H, 4 * H, generator=gen) * 2 - 1) * limit).to(device))
    w_h_q = w_h_q.contiguous()
    step_scale = (w_scale / 127.0).reshape(1, -1)
    packed = pack_w_h_q(w_h_q)
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        for B in (1, 8, 16, 32):
            for T in (16, 200):
                x_proj = (torch.randn(T, B, 4 * H, generator=gen) * 0.5).to(device).to(dtype)
                c0 = (torch.randn(B, H, generator=gen) * 0.1).to(device)
                h0 = ((torch.rand(B, H, generator=gen) * 2 - 1) * 0.9).to(device)
                seq = torch.randint(1, T + 1, (B,), generator=gen, dtype=torch.int32)
                seq[0] = T
                rec = k2_record(f"K2 {dtype} B={B} T={T}",
                                (x_proj, w_h_q, step_scale, c0, h0, seq.to(device)), packed)
                print("k2", json.dumps(rec), flush=True)
                records.append(rec)
    return records


def beam_inputs(B: int, T: int, C: int, peaky: bool, seed: int, device) -> tuple:
    """Seeded softmax emissions, flat or peaky with frequent strong blanks,
    and lengths with one utterance shorter than T."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, T, C)).astype(np.float32)
    if peaky:
        logits = logits * 4.0
        logits[:, ::3, -1] += 6.0
    lens = np.full((B,), T, np.int32)
    lens[-1] = max(1, T - 3)
    return (torch.softmax(torch.from_numpy(logits).to(device), dim=-1).contiguous(),
            torch.from_numpy(lens).to(device))


def ulps_apart(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in float32 representation steps; equal infinities
    are 0 apart."""
    def ordered(x):
        bits = x.contiguous().view(torch.int32).long()
        return torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits)
    return int((ordered(a) - ordered(b)).abs().max().item())


def compare_beam(name: str, probs, lens, W: int, kernel_out, plain_out, params: tuple,
                 state=None) -> float:
    """Holds one beam_scan result (state, scores, packed backpointers)
    against the plain version's (state, bp_src, bp_char): backpointers
    equal, scores within K5_SCORE_TOL. Backpointer decisions compare
    float32 values made with logf, expf and log1pf, which the kernel and
    ATen may round differently in the last bit; if a fixture differs, the
    first differing frame and slot are printed with both candidates and
    their values after that frame, and the fixture passes only if those
    values lie within K5_TIE_ULPS of each other and every rebuilt candidate
    (tokens and timesteps) is equal. `state` is the state both started from
    (None: root-only beams). Returns the largest score difference."""
    from stt_tpu_torch.decode.device import beam_scan_plain, logaddexp
    from stt_tpu_torch.ops import beam_kernel

    _, scores, packed = kernel_out
    plain_state, src, char = plain_out
    want = logaddexp(plain_state[0], plain_state[1])
    finite = torch.isfinite(want)
    if not torch.equal(torch.isfinite(scores), finite):
        raise AssertionError(f"{name}: dead slots differ")
    score_err = (scores[finite] - want[finite]).abs().max().item() if finite.any() else 0.0
    if not score_err <= K5_SCORE_TOL:
        raise AssertionError(f"{name}: scores differ by {score_err} > {K5_SCORE_TOL}")
    want_packed = beam_kernel.pack_bp(src, char)
    if torch.equal(packed, want_packed):
        return score_err
    b, t, k = (int(v) for v in (packed != want_packed).nonzero()[0])
    upto = (probs[:, :t + 1].contiguous(), lens.clamp(max=t + 1), W, *params)
    if state is None:
        state = beam_kernel.init_state(probs.shape[0], probs.device, beam_kernel.state_slots(W))
    _, s_kernel, _ = beam_kernel.beam_scan(*upto, state=state)
    st, _, _ = beam_scan_plain(beam_kernel.state_to_plain(state, W), *upto)
    s_plain = logaddexp(st[0], st[1])
    got_sc = beam_kernel.unpack_bp(packed[b, t, k].cpu().numpy())
    print(f"{name}: first difference at utterance {b} frame {t} slot {k}: kernel (src, char) "
          f"{got_sc} value {s_kernel[b, k].item()!r}, plain ({int(src[b, t, k])}, "
          f"{int(char[b, t, k])}) value {s_plain[b, k].item()!r}", flush=True)
    apart = ulps_apart(s_kernel[b, k], s_plain[b, k])
    walked = [beam_results(scores[i], *beam_kernel.unpack_bp(packed[i].cpu().numpy()), W)
              == beam_results(want[i], src[i].cpu().numpy(), char[i].cpu().numpy(), W)
              for i in range(probs.shape[0])]
    if apart > K5_TIE_ULPS or not all(walked):
        raise AssertionError(f"{name}: backpointers differ ({apart} ulp apart, rebuilt equal: {walked})")
    return score_err


def beam_results(scores, src, char, W: int) -> list:
    """(tokens, timesteps) of every live candidate, best first."""
    from stt_tpu_torch.alphabet import Alphabet
    from stt_tpu_torch.decode.device import rebuild_results

    alphabet = Alphabet().init_from_labels([chr(33 + i) for i in range(127)])
    found = rebuild_results(scores.cpu().numpy(), src, char, alphabet, W)
    return [(r.tokens, r.timesteps) for r in found]


def k5_phase(device, seed: int) -> list:
    """K5 against its plain version running on the card, and its times. The
    bound is bytes (emissions and state in, packed backpointers and state
    out), but the T frames form a dependency chain, so the time per frame is
    printed beside it. No PyTorch call computes a beam scan: no library time."""
    from stt_tpu_torch.decode.device import beam_scan_plain
    from stt_tpu_torch.ops import beam_kernel

    def plain(probs, lens, W, *params, state=None):
        if state is None:
            state = beam_kernel.init_state(probs.shape[0], device, beam_kernel.state_slots(W))
        return beam_scan_plain(beam_kernel.state_to_plain(state, W), probs, lens, W, *params)

    records = []
    for W, C in ((8, 8), (32, 29), (128, 29), (128, 127), (500, 29), (512, 31)):
        for B in (1, 16):
            for T in (16, 200):
                for peaky in (True, False):
                    probs, lens = beam_inputs(B, T, C, peaky, seed + W + C + B + T, device)
                    name = f"K5 W={W} C={C} B={B} T={T} {'peaky' if peaky else 'flat'}"
                    params = (40, 1.0, None, ())
                    out = beam_kernel.beam_scan(probs, lens, W, *params)
                    torch.cuda.synchronize()
                    err = compare_beam(name, probs, lens, W, out, plain(probs, lens, W, *params), params)
                    reps = 20 if T <= 16 else 3
                    ms = cuda_ms(lambda: beam_kernel.beam_scan(probs, lens, W, *params), reps)
                    plain_ms = cuda_ms(lambda: plain(probs, lens, W, *params), 1)
                    state_bytes = (2 + 5) * B * beam_kernel.state_slots(W) * 4 + B * 4
                    bp_bytes = B * T * W * (2 if W <= beam_kernel.WSLOTS else 4)
                    moved = B * T * C * 4 + B * 4 + 2 * beam_kernel.LANES * 4 + 2 * state_bytes + bp_bytes
                    bound, bound_by = bound_ms(moved, 0, torch.float32)
                    rec = {"W": W, "C": C, "B": B, "T": T, "emissions": "peaky" if peaky else "flat",
                           "max_abs_err": err, "tol": K5_SCORE_TOL, "backpointers": "equal",
                           "ms": ms, "us_per_frame": ms / T * 1e3, "plain_ms": plain_ms,
                           "library_ms": None, "bound_ms": bound, "bound_by": bound_by}
                    print("k5", json.dumps(rec), flush=True)
                    records.append(rec)

    # the branches of the emission cutoff, and an external class layout
    for label, C, W, params in (
        ("cutoff_top_n=10 cutoff_prob=0.9", 29, 32, (10, 0.9, None, ())),
        ("cutoff_top_n=20", 29, 32, (20, 1.0, None, ())),
        ("blank_id=0 ignored=(1, 2)", 32, 32, (40, 1.0, 0, (1, 2))),
    ):
        for peaky in (True, False):
            probs, lens = beam_inputs(4, 48, C, peaky, seed + 100 + C + len(label), device)
            out = beam_kernel.beam_scan(probs, lens, W, *params)
            compare_beam(f"K5 {label} {'peaky' if peaky else 'flat'}", probs, lens, W, out,
                         plain(probs, lens, W, *params), params)
    print("k5 branches: backpointers equal (cutoff_prob, cutoff_top_n alone, external layout)", flush=True)

    # chunks of 16 with the state carried against one launch over all T,
    # and a state handed from the plain version to the kernel mid-stream
    for W in (32, 500):
        B, T, C = 4, 64, 29
        probs, lens = beam_inputs(B, T, C, True, seed + 200 + W, device)
        _, scores, packed = beam_kernel.beam_scan(probs, lens, W)
        state, parts = None, []
        for t0 in range(0, T, 16):
            state, chunk_scores, bp = beam_kernel.beam_scan(
                probs[:, t0:t0 + 16].contiguous(), (lens - t0).clamp(0, 16), W, state=state)
            parts.append(bp)
        if not (torch.equal(torch.cat(parts, dim=1), packed) and torch.equal(chunk_scores, scores)):
            raise AssertionError(f"K5 W={W}: chunks of 16 differ from one launch over all frames")
        half = plain(probs[:, :32].contiguous(), lens.clamp(max=32), W)
        rest = (probs[:, 32:].contiguous(), (lens - 32).clamp(min=0), W)
        handed = beam_kernel.beam_scan(*rest, state=beam_kernel.state_from_plain(half[0]))
        carried = plain(*rest, state=beam_kernel.state_from_plain(half[0]))
        compare_beam(f"K5 W={W} state handed from the plain version", *rest, handed, carried,
                     (40, 1.0, None, ()), state=beam_kernel.state_from_plain(half[0]))
        if not torch.equal(torch.cat([beam_kernel.pack_bp(half[1], half[2]), handed[2]], dim=1), packed):
            raise AssertionError(f"K5 W={W}: plain first half + kernel second half differs from one launch")
    print("k5 chunked == one launch; plain -> kernel hand-over mid-stream equal (beam 32 and 500)",
          flush=True)
    return records


def utterance(seconds: float, rate: int, rng: np.random.RandomState) -> np.ndarray:
    """Seeded speech-like audio: a few gliding harmonics under noise."""
    n = int(seconds * rate)
    t = np.arange(n) / rate
    audio = np.zeros(n)
    for _ in range(4):
        f0 = rng.uniform(90, 400)
        glide = rng.uniform(-40, 40)
        audio += rng.uniform(0.05, 0.2) * np.sin(2 * np.pi * (f0 + glide * t) * t)
    audio += 0.02 * rng.randn(n)
    return np.clip(audio, -1, 1).astype(np.float32)


def device_events(prof) -> list:
    """The profiler's kernels and copies on the card, by name. (A CPU-side
    op such as aten::mm also reports its kernels' time as its own device
    time; summing every entry would count those twice.)"""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


RECURRENCE_KERNEL = "recurrence_kernel"  # K1's and K3's persistent kernel, by name


def profiled(name: str, audio_s: float, fn, kernel_names: dict) -> tuple:
    """One request under torch.profiler: its wall time, the device time of
    all kernels and copies in it and of each named kernel (by a substring
    of the kernel's name), and the device's idle share. Where K1 is named,
    its device events are counted too: the recurrence must show one kernel
    per wrapper call, not one per step. Returns (record, the request's
    result)."""
    from torch.profiler import ProfilerActivity, profile

    from stt_tpu_torch.ops.lstm_kernel import lstm_recurrence

    torch.cuda.synchronize()
    calls = lstm_recurrence.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    calls = lstm_recurrence.launches - calls
    events = device_events(prof)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    rec = {"request": f"{name} (profiled)", "audio_s": audio_s, "wall_ms": wall_ms,
           "device_busy_ms": device_ms or None,
           "device_idle_share": (1 - device_ms / wall_ms) if device_ms else None}
    for key, part in kernel_names.items():
        rec[key] = sum(e.self_device_time_total for e in events if part in e.key) / 1e3 or None
    if "k1_device_ms" in kernel_names and device_ms:
        rec["k1_wrapper_calls"] = calls
        rec["k1_device_events"] = sum(e.count for e in events if RECURRENCE_KERNEL in e.key)
        if rec["k1_device_events"] != calls:
            raise AssertionError(f"{name}: {rec['k1_device_events']} recurrence kernels on the "
                                 f"card for {calls} wrapper calls")
    return rec, result


def profile_request(gpu, audio: np.ndarray, alphabet) -> dict:
    """Where one stt request's time goes, with the host beam decoder re-run
    alone on its emissions."""
    from stt_tpu_torch.decode import ctc_beam_search_decoder

    rec, (_, probs) = profiled("stt_with_emissions", len(audio) / gpu.sample_rate(),
                               lambda: gpu.stt_with_emissions(audio), {"k1_device_ms": RECURRENCE_KERNEL})
    start = time.perf_counter()
    ctc_beam_search_decoder(probs, alphabet, BEAM_WIDTH)
    rec["host_decode_ms"] = (time.perf_counter() - start) * 1e3
    print("profile", json.dumps(rec), flush=True)
    return rec


def serving_phase(device, seed: int, work_dir: str) -> dict:
    from stt_tpu_torch.alphabet import Alphabet
    from stt_tpu_torch.artifact import build_metadata, save_artifact
    from stt_tpu_torch.decode import ctc_beam_search_decoder
    from stt_tpu_torch.decode import device as decode_device
    from stt_tpu_torch.frontend import FeatureConfig, audio_to_mfcc
    from stt_tpu_torch.models import DeepSpeech, ModelConfig
    from stt_tpu_torch.ops import beam_kernel
    from stt_tpu_torch.ops.lstm_kernel import lstm_recurrence, lstm_recurrence_q
    from stt_tpu_torch.ops.lstm_train import lstm_train_bwd, lstm_train_fwd
    from stt_tpu_torch.ops.quant import apply_model_quantized, input_projection_q, qparams_to
    from stt_tpu_torch.serve import Model

    alphabet = Alphabet().init_from_labels(LABELS)
    config = ModelConfig(n_out=len(LABELS) + 1)  # the 2048 geometry
    fc = FeatureConfig()
    t0 = time.time()
    model = DeepSpeech(config, generator=torch.Generator().manual_seed(seed))
    n_params = sum(p.numel() for p in model.parameters())
    save_artifact(work_dir, model, build_metadata(config, fc, alphabet, beam_width=BEAM_WIDTH), alphabet)
    del model
    gpu = Model(work_dir)  # the card is the default device
    cpu = Model(work_dir, device="cpu")
    print(f"serving: {n_params} params, artifact saved and opened in {time.time() - t0:.1f} s", flush=True)
    assert gpu.device.type == "cuda" and gpu.beam_width == BEAM_WIDTH

    rng = np.random.RandomState(seed)
    rate = fc.sample_rate
    audios = [utterance(s, rate, rng) for s in (2.0, 3.3, 4.7)]
    requests = []

    counted = {"k1": lstm_recurrence, "k2": lstm_recurrence_q, "k3": lstm_train_fwd,
               "k4": lstm_train_bwd, "k5": beam_kernel.beam_scan}

    def request(name: str, audio_s: float, fn, must=("k1",)):
        """Run one request with every launch count set to 0 just before it:
        it must launch each kernel in `must` and none of the others."""
        for wrapper in counted.values():
            wrapper.launches = 0
        decode_device.scan.plain_scans = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - start) * 1e3
        launches = {key: wrapper.launches for key, wrapper in counted.items()}
        for key, n in launches.items():
            if (n > 0) != (key in must):
                raise AssertionError(f"request {name}: {key} launched {n} times, must launch: {must}")
        if decode_device.scan.plain_scans:
            raise AssertionError(f"request {name} ran the plain beam scan")
        rec = {"request": name, "audio_s": audio_s, "ms": ms, "rtf": ms / 1e3 / audio_s,
               "k1_launches": launches["k1"], "launches": launches}
        print("request", json.dumps(rec), flush=True)
        requests.append(rec)
        return result

    gpu.stt(audios[0][:rate // 2])  # warm-up: cuBLAS handles, caches
    texts = [
        request(f"stt[{i}]", len(a) / rate, lambda a=a: gpu.stt(a))
        for i, a in enumerate(audios)
    ]
    meta = request("stt_with_metadata", len(audios[1]) / rate,
                   lambda: gpu.stt_with_metadata(audios[1], 3))
    assert meta.transcripts[0].transcript == texts[1]
    steps = [t.timestep for t in meta.transcripts[0].tokens]
    assert steps == sorted(steps), "token timesteps must not decrease"

    piece = int(0.32 * rate)

    def stream_request():
        stream = gpu.create_stream()
        partial = []
        for off in range(0, len(audios[2]), piece):
            stream.feed_audio_content(audios[2][off:off + piece])
            partial.append(stream.intermediate_decode())
        return partial, stream.finish_stream()

    partial, streamed = request("stream[320ms]", len(audios[2]) / rate, stream_request)
    assert streamed == texts[2], "streamed transcript differs from one-shot"

    batch = [utterance(s, rate, rng) for s in rng.uniform(2.0, 5.0, size=16)]
    feats = [audio_to_mfcc(torch.from_numpy(a), fc).numpy() for a in batch]
    lengths = np.array([f.shape[0] for f in feats], np.int32)
    padded = np.zeros((16, lengths.max(), config.n_input), np.float32)
    for i, f in enumerate(feats):
        padded[i, : len(f)] = f
    logits = request("infer_logits[B=16]", sum(len(a) for a in batch) / rate,
                     lambda: gpu.infer_logits(padded, lengths))

    # ---- opt-in path B: decoding on the card ---------------------------
    def device_stream_request():
        stream = gpu.create_stream(device_decode=True)
        partial = []
        for off in range(0, len(audios[2]), piece):
            stream.feed_audio_content(audios[2][off:off + piece])
            partial.append(stream.intermediate_decode())
        return partial, stream.finish_stream_with_metadata(3)

    gpu.create_stream(device_decode=True).feed_audio_content(audios[0])  # warm-up
    _, emissions = gpu.stt_with_emissions(audios[2])
    em = torch.from_numpy(emissions).to(device)[None].contiguous()
    em_len = torch.tensor([em.shape[1]], dtype=torch.int32, device=device)
    device_equals_host = {}
    # the artifact's beam, then the beam `Model` takes when the metadata
    # names none
    for beam in (BEAM_WIDTH, 500):
        gpu.set_model_beam_width(beam)
        name = f"stream[320ms, device_decode, beam {beam}]"
        dd_partial, dd_meta = request(name, len(audios[2]) / rate, device_stream_request,
                                      must=("k1", "k5"))
        if requests[-1]["launches"]["k5"] != requests[-1]["launches"]["k1"]:
            raise AssertionError(f"device decode must launch K5 once per chunk: {requests[-1]}")
        # the same emissions through the plain beam scan on the card
        plain_state, src, char = decode_device.beam_scan_plain(
            decode_device.init_beam_state(1, beam, device), em, em_len, beam, 40, 1.0)
        want = decode_device.rebuild_results(
            decode_device.logaddexp(plain_state[0], plain_state[1])[0].cpu().numpy(),
            src[0].cpu().numpy(), char[0].cpu().numpy(), alphabet, 3)
        for cand, ref in zip(dd_meta.transcripts, want):
            if (cand.transcript, [alphabet.encode_single(t.text) for t in cand.tokens],
                    [t.timestep for t in cand.tokens]) != (ref.transcript, ref.tokens, ref.timesteps):
                raise AssertionError(f"{name}: {cand} differs from the plain scan's {ref}")
            if not abs(cand.confidence - ref.confidence) <= K5_SCORE_TOL:
                raise AssertionError(f"{name}: confidence {cand.confidence} vs {ref.confidence}")
        device_equals_host[beam] = dd_meta.transcripts[0].transcript == texts[2]
        print(f"serving: {name} == plain scan on its emissions (3 candidates); transcript "
              f"equals the host decoder's at beam {BEAM_WIDTH}: {device_equals_host[beam]}",
              flush=True)
    gpu.set_model_beam_width(BEAM_WIDTH)

    probs16 = torch.softmax(logits, dim=-1)
    batch_results = request(
        "ctc_beam_search_decoder_device[B=16]", sum(len(a) for a in batch) / rate,
        lambda: decode_device.ctc_beam_search_decoder_device(
            probs16, lengths, alphabet, beam_size=BEAM_WIDTH, num_results=2),
        must=("k5",))
    # the same from a host array: the entry point moves it to the card
    from_host = request(
        "ctc_beam_search_decoder_device[B=16, host array]", sum(len(a) for a in batch) / rate,
        lambda: decode_device.ctc_beam_search_decoder_device(
            probs16.cpu().numpy(), lengths, alphabet, beam_size=BEAM_WIDTH, num_results=2),
        must=("k5",))
    if from_host != batch_results:
        raise AssertionError("batch device decode of a host array differs from the tensor's")
    lens16 = torch.from_numpy(lengths).to(device)
    st16, src16, char16 = decode_device.beam_scan_plain(
        decode_device.init_beam_state(16, BEAM_WIDTH, device), probs16.contiguous(), lens16,
        BEAM_WIDTH, 40, 1.0)
    sc16 = decode_device.logaddexp(st16[0], st16[1]).cpu().numpy()
    for i, got in enumerate(batch_results):
        ref = decode_device.rebuild_results(sc16[i], src16[i].cpu().numpy(),
                                            char16[i].cpu().numpy(), alphabet, 2)
        if [(r.tokens, r.timesteps) for r in got] != [(r.tokens, r.timesteps) for r in ref]:
            raise AssertionError(f"batch device decode, utterance {i}: {got} differs from {ref}")

    # ---- opt-in path A: int8 inference ---------------------------------
    qgpu = Model(work_dir, quantized_inference=True)
    qgpu.infer_logits(padded[:2, :32], np.minimum(lengths[:2], 32))  # warm-up
    q_logits = request("infer_logits[B=16, int8]", sum(len(a) for a in batch) / rate,
                       lambda: qgpu.infer_logits(padded, lengths), must=("k2",))
    # K2 against its plain version on what that request gave it: the
    # request's own input projection, lengths and zero start state
    x_proj_q = input_projection_q(qgpu._qparams, torch.from_numpy(padded).to(device),
                                  gpu.model_config)
    rec_q = qgpu._qparams["lstm_rec"]
    zeros = torch.zeros((16, config.n_cell_dim), device=device)
    k2_request = k2_record(
        "K2 at the int8 request's shape",
        (x_proj_q, rec_q["w_h_q"], rec_q["step_scale"], zeros, zeros.clone(),
         torch.from_numpy(lengths).to(device)), rec_q["w_h_q_packed"])
    print("k2 at infer_logits[B=16, int8]", json.dumps(k2_request), flush=True)

    # correctness: the card against the port's CPU path on the same model
    text_gpu, probs_gpu = gpu.stt_with_emissions(audios[0])
    text_cpu, probs_cpu = cpu.stt_with_emissions(audios[0])
    assert probs_gpu.shape == probs_cpu.shape == (
        (len(audios[0]) - fc.window_samples) // fc.step_samples + 1, config.n_out
    ), (probs_gpu.shape, probs_cpu.shape)
    assert np.isfinite(probs_gpu).all()
    assert np.allclose(probs_gpu.sum(-1), 1.0, atol=1e-5)
    probs_err = float(np.abs(probs_gpu - probs_cpu).max())
    if not probs_err <= PROBS_TOL:
        raise AssertionError(f"card vs CPU probs: max abs diff {probs_err} > {PROBS_TOL}")
    redecoded = ctc_beam_search_decoder(probs_gpu, alphabet, BEAM_WIDTH)[0].transcript
    assert redecoded == text_gpu == texts[0]
    logits_cpu = cpu.infer_logits(padded, lengths).numpy()
    logits_gpu = logits.cpu().numpy()
    mask = np.arange(padded.shape[1])[None, :] < lengths[:, None]
    assert np.isfinite(logits_gpu).all()
    logits_err = float(np.abs(logits_gpu - logits_cpu)[mask].max())
    if not logits_err <= LOGITS_TOL:
        raise AssertionError(f"card vs CPU logits: max abs diff {logits_err} > {LOGITS_TOL}")
    q_gpu = q_logits.cpu().numpy()
    # the same quantized weights on the CPU (quantizing there anew can move
    # a scale by its last bit: the card divides by 127 as a product)
    q_cpu, _ = apply_model_quantized(
        qparams_to(qgpu._qparams, "cpu"), torch.from_numpy(padded),
        seq_len=torch.from_numpy(lengths), config=gpu.model_config)
    q_cpu = q_cpu.numpy()
    assert np.isfinite(q_gpu).all() and q_gpu.shape == logits_gpu.shape
    int8_err = float(np.abs(q_gpu - q_cpu)[mask].max())
    int8_mean_err = float(np.abs(q_gpu - q_cpu)[mask].mean())
    int8_float_err = float(np.abs(q_gpu - logits_gpu)[mask].max())
    print(f"serving: int8 logits card vs CPU max {int8_err:.3e} (tol {INT8_CARD_CPU_TOL}) mean "
          f"{int8_mean_err:.3e} (tol {INT8_CARD_CPU_MEAN_TOL}), int8 vs float on the card "
          f"{int8_float_err:.3e} (bound {INT8_FLOAT_TOL}), largest float logit "
          f"{np.abs(logits_gpu)[mask].max():.3f}", flush=True)
    if not (int8_err <= INT8_CARD_CPU_TOL and int8_mean_err <= INT8_CARD_CPU_MEAN_TOL
            and int8_float_err <= INT8_FLOAT_TOL):
        raise AssertionError("int8 logits out of tolerance")
    gpu.set_model_beam_width(500)
    wide_profile = profiled("stream[320ms, device_decode, beam 500]", len(audios[2]) / rate,
                            device_stream_request,
                            {"k1_device_ms": RECURRENCE_KERNEL, "k5_device_ms": "beam_scan_kernel"})[0]
    gpu.set_model_beam_width(BEAM_WIDTH)
    profiles = [
        profiled(f"stream[320ms, device_decode, beam {BEAM_WIDTH}]", len(audios[2]) / rate,
                 device_stream_request,
                 {"k1_device_ms": RECURRENCE_KERNEL, "k5_device_ms": "beam_scan_kernel"})[0],
        wide_profile,
        profiled("infer_logits[B=16, int8]", sum(len(a) for a in batch) / rate,
                 lambda: qgpu.infer_logits(padded, lengths), {"k2_device_ms": "lstm_step_q"})[0],
        profiled("infer_logits[B=16]", sum(len(a) for a in batch) / rate,
                 lambda: gpu.infer_logits(padded, lengths), {"k1_device_ms": RECURRENCE_KERNEL})[0],
    ]
    for rec in profiles:
        print("profile", json.dumps(rec), flush=True)
    print(f"serving: probs err {probs_err:.3e} (tol {PROBS_TOL}), logits err "
          f"{logits_err:.3e} (tol {LOGITS_TOL}), transcripts card == cpu: "
          f"{text_gpu == text_cpu}", flush=True)
    return {
        "profile": profile_request(gpu, audios[2], alphabet), "opt_in_profiles": profiles,
        "k2_at_int8_request": k2_request,
        "int8_card_vs_cpu_max_abs_err": int8_err, "int8_card_vs_cpu_mean_abs_err": int8_mean_err,
        "int8_vs_float_max_abs_err": int8_float_err,
        "device_decode_equals_host_decoder": device_equals_host,
        "device_decode_intermediate_decodes": len(dd_partial),
        "params": n_params, "beam_width": BEAM_WIDTH, "requests": requests,
        "probs_max_abs_err": probs_err, "logits_max_abs_err": logits_err,
        "card_transcript_equals_cpu": text_gpu == text_cpu,
        "intermediate_decodes": len(partial),
    }


def write_dataset(data_dir: str, rng: np.random.RandomState, rate: int) -> dict:
    """Seeded utterances of 2-5 s with random transcripts over the 28
    labels: 32 for training, 8 for dev, as CSVs of WAV files."""
    from stt_tpu_torch.data.sources import CSVWriter, Sample

    shutil.rmtree(data_dir, ignore_errors=True)
    os.makedirs(data_dir)
    paths = {"alphabet": os.path.join(data_dir, "alphabet.txt")}
    with open(paths["alphabet"], "w") as f:
        f.write("".join(label + "\n" for label in LABELS))
    for split, n in (("train", 32), ("dev", 8)):
        paths[split] = os.path.join(data_dir, f"{split}.csv")
        with CSVWriter(paths[split]) as writer:
            for i in range(n):
                seconds = rng.uniform(2.0, 5.0)
                words = rng.randint(3, 9)
                text = " ".join("".join(rng.choice(LABELS[1:], rng.randint(2, 7)))
                                for _ in range(words))[: int(seconds * 8)]
                writer.add(Sample(f"{split}{i}", text.strip() or "a",
                                  _audio=utterance(seconds, rate, rng), _rate=rate))
    return paths


def card_vs_cpu_step(device, seed: int, batch) -> dict:
    """One full-width train step (dropout 0) on the card and on the CPU
    from the same weights: loss, gradient norm, and the LSTM kernel's
    gradient."""
    from stt_tpu_torch.models import DeepSpeech, ModelConfig
    from stt_tpu_torch.train import create_train_state, make_train_step

    config = ModelConfig(n_out=len(LABELS) + 1, dropout_rates=(0.0,) * 6)
    weights = DeepSpeech(config, generator=torch.Generator().manual_seed(seed)).state_dict()
    out = {}
    for dev in (device, torch.device("cpu")):
        model = DeepSpeech(config, device=dev)
        model.load_state_dict(weights)
        state = create_train_state(config, device=dev, model=model)
        start = time.perf_counter()
        _, metrics = make_train_step()(state, batch.to(dev), seed)
        loss, norm = metrics.loss.item(), metrics.grad_norm.item()
        grads = {k: p.grad.cpu() for k, p in state.model.named_parameters()}
        out[dev.type] = (loss, norm, grads, (time.perf_counter() - start) * 1e3)
    (loss_g, norm_g, grads_g, ms_g), (loss_c, norm_c, grads_c, ms_c) = out["cuda"], out["cpu"]
    grad_g, grad_c = grads_g["lstm/kernel"], grads_c["lstm/kernel"]
    rec = {
        "B": int(batch.features.shape[0]), "T": int(batch.features.shape[1]),
        "loss_card": loss_g, "loss_cpu": loss_c, "grad_norm_card": norm_g, "grad_norm_cpu": norm_c,
        "loss_rel_err": abs(loss_g - loss_c) / abs(loss_c),
        "grad_norm_rel_err": abs(norm_g - norm_c) / abs(norm_c),
        "lstm_grad_max_abs_err": (grad_g - grad_c).abs().max().item(),
        "lstm_grad_max_abs": grad_c.abs().max().item(),
        "card_step_ms": ms_g, "cpu_step_ms": ms_c,
        "grad_rel_err": {k: ((grads_g[k] - g).norm() / g.norm()).item() for k, g in grads_c.items()},
    }
    print("card_vs_cpu_step", json.dumps(rec), flush=True)
    if not (np.isfinite(loss_g) and rec["loss_rel_err"] <= STEP_LOSS_RTOL
            and rec["grad_norm_rel_err"] <= STEP_GRAD_NORM_RTOL
            and rec["lstm_grad_max_abs_err"] <= STEP_LSTM_GRAD_TOL * rec["lstm_grad_max_abs"]):
        raise AssertionError(f"card vs CPU train step out of tolerance: {rec}")
    return rec


def step_profile(state, batch, seed: int) -> dict:
    """Where one train step's time goes: the step's phases timed on the
    host around synchronisations, then one step under torch.profiler with
    its device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from stt_tpu_torch.ctc import ctc_loss
    from stt_tpu_torch.train.step import dropout_generator

    model, optimizer = state.model, state.optimizer
    marks = [time.perf_counter()]

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    optimizer.zero_grad(set_to_none=True)
    logits, _ = model(batch.features, seq_len=batch.feature_lengths,
                      dropout_generator=dropout_generator(seed, state.step, batch.features.device))
    mark()
    losses = ctc_loss(logits, batch.feature_lengths, batch.labels, batch.label_lengths)
    loss = losses[torch.isfinite(losses)].sum() / max(int(torch.isfinite(losses).sum()), 1)
    mark()
    loss.backward()
    mark()
    optimizer.step()
    mark()
    phases = dict(zip(("forward_ms", "ctc_loss_ms", "backward_ms", "adam_ms"),
                      (np.diff(marks) * 1e3).tolist()))

    from stt_tpu_torch.train import make_train_step

    step = make_train_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        step(state, batch, seed)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    events = device_events(prof)

    def device_ms(match) -> float:
        return sum(e.self_device_time_total for e in events if match(e.key)) / 1e3

    busy = device_ms(lambda k: True)
    k3 = device_ms(lambda k: RECURRENCE_KERNEL in k)
    k3_events = sum(e.count for e in events if RECURRENCE_KERNEL in e.key)
    if busy and k3_events != 1:
        raise AssertionError(f"one train step showed {k3_events} K3 kernels on the card, not 1")
    k4 = device_ms(lambda k: "lstm_train_bwd" in k)
    gemm = device_ms(lambda k: any(s in k.lower() for s in ("gemm", "cutlass", "sm90_xmma")))
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    rec = {
        **phases, "profiled_wall_ms": wall_ms, "device_busy_ms": busy or None,
        "k3_device_ms": k3 or None, "k3_device_events": k3_events,
        "k4_device_ms": k4 or None, "gemm_device_ms": gemm or None,
        "other_device_ms": (busy - k3 - k4 - gemm) if busy else None,
        "device_idle_share": (1 - busy / wall_ms) if busy else None,
        "top_kernels": [(e.key[:80], e.self_device_time_total / 1e3, e.count) for e in top],
    }
    print("step_profile", json.dumps(rec), flush=True)
    return rec


def training_phase(device, seed: int, work_dir: str) -> dict:
    from stt_tpu_torch.alphabet import Alphabet
    from stt_tpu_torch.artifact import build_metadata, save_artifact
    from stt_tpu_torch.config import SttConfig
    from stt_tpu_torch.data.feeding import create_batches
    from stt_tpu_torch.frontend import FeatureConfig
    from stt_tpu_torch.models import DeepSpeech
    from stt_tpu_torch.ops.lstm_kernel import lstm_recurrence
    from stt_tpu_torch.ops.lstm_train import lstm_train_bwd, lstm_train_fwd
    from stt_tpu_torch.serve import Model
    from stt_tpu_torch.train import make_train_step
    from stt_tpu_torch.train.trainer import train

    fc = FeatureConfig()
    rng = np.random.RandomState(seed + 1)
    paths = write_dataset(os.path.join(work_dir, "data"), rng, fc.sample_rate)
    ckpt = os.path.join(work_dir, "checkpoints")
    summary = os.path.join(work_dir, "summary")
    shutil.rmtree(ckpt, ignore_errors=True)
    shutil.rmtree(summary, ignore_errors=True)
    config = SttConfig(
        train_files=[paths["train"]], dev_files=[paths["dev"]],
        alphabet_config_path=paths["alphabet"], n_hidden=2048, train_batch_size=16,
        dev_batch_size=8, epochs=1, dropout_rate=0.05, checkpoint_dir=ckpt,
        summary_dir=summary, seed=seed,
    )
    model_config = config.model_config(training=True)
    initial = DeepSpeech(model_config, generator=torch.Generator().manual_seed(seed)).state_dict()

    lstm_recurrence.launches = lstm_train_fwd.launches = lstm_train_bwd.launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    state = train(config, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - start
    launches = {"k1": lstm_recurrence.launches, "k3": lstm_train_fwd.launches,
                "k4": lstm_train_bwd.launches}
    print(f"training: {state.step} steps in {train_s:.1f} s, launches {launches}", flush=True)
    if not launches["k3"] == launches["k4"] == state.step >= 3:
        raise AssertionError(f"every train step must launch K3 and K4: {launches}, {state.step} steps")
    with open(os.path.join(summary, "scalars.jsonl")) as f:
        step_losses = [r["train/step_loss"] for r in map(json.loads, f) if "train/step_loss" in r]
    if len(step_losses) != state.step - 1 or not np.isfinite(step_losses).all():
        raise AssertionError(f"train step losses: {step_losses}")
    unchanged = [k for k, v in state.params.items()
                 if torch.equal(v.detach().cpu(), initial[k])]
    if unchanged:
        raise AssertionError(f"parameters did not move: {unchanged}")
    with open(os.path.join(ckpt, "meta.json")) as f:
        meta = json.load(f)
    last = os.path.join(ckpt, "last", f"step_{state.step}", "state.pt")
    if meta.get("last") != state.step or not os.path.isfile(last):
        raise AssertionError(f"no last checkpoint: meta {meta}")

    # the trained weights, exported, answer a request on the card
    alphabet = Alphabet(paths["alphabet"])
    art = os.path.join(work_dir, "artifact")
    save_artifact(art, state.model, build_metadata(config.model_config(training=False), fc,
                                                   alphabet, beam_width=BEAM_WIDTH), alphabet)
    lstm_recurrence.launches = lstm_train_fwd.launches = lstm_train_bwd.launches = 0
    text = Model(art).stt(utterance(2.5, fc.sample_rate, rng))
    if not lstm_recurrence.launches or lstm_train_fwd.launches or lstm_train_bwd.launches:
        raise AssertionError("serving the trained model must launch K1 and no training kernel")
    print(f"training: trained model transcribes {text!r}", flush=True)

    # the step at B = 16 on the longest batch, and where its time goes
    batch, _ = next(create_batches([paths["train"]], alphabet, fc, batch_size=16, reverse=True,
                                   limit=16))
    start = time.perf_counter()
    next(create_batches([paths["train"]], alphabet, fc, batch_size=16, reverse=True, limit=16))
    feed_ms = (time.perf_counter() - start) * 1e3
    batch = batch.to(device)
    step = make_train_step()
    audio_s = float(batch.feature_lengths.sum()) * fc.step_samples / fc.sample_rate
    step(state, batch, seed)
    torch.cuda.synchronize()
    start = time.perf_counter()
    reps = 3
    for _ in range(reps):
        step(state, batch, seed)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - start) * 1e3 / reps
    rec = {
        "steps": state.step, "train_s": train_s, "launches": launches,
        "step_losses": step_losses, "transcript": text,
        "batch": {"B": int(batch.features.shape[0]), "T": int(batch.features.shape[1]),
                  "audio_s": audio_s},
        "train_step_ms": step_ms, "audio_s_per_s": audio_s / (step_ms / 1e3),
        "host_featurize_batch_ms": feed_ms,
    }
    print("train_step", json.dumps(rec), flush=True)
    rec["profile"] = step_profile(state, batch, seed)

    small, _ = next(create_batches([paths["train"]], alphabet, fc, batch_size=2, limit=2))
    rec["card_vs_cpu"] = card_vs_cpu_step(device, seed, small)
    return rec


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", help="write the full record here as JSON")
    parser.add_argument("--phases", default="",
                        help="comma-separated kernel phases (k1, k2, k3k4, k5) to run alone, "
                             "for work on a kernel: prints their records and no result line")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from stt_tpu_torch.device import resolve_device
    from stt_tpu_torch.ops import _build

    card = gpu_line()
    print(f"gpu: {card}", flush=True)
    print(sys.version.split()[0], "torch", torch.__version__, "cuda", torch.version.cuda, flush=True)
    device = resolve_device("cuda")
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}", flush=True)
    t0 = time.time()
    for name, report in _build.build().items():
        print(f"built {name}:\n{report}", flush=True)
    print(f"build: {time.time() - t0:.1f} s", flush=True)

    if args.phases:
        alone = {"k1": k1_phase, "k2": k2_phase, "k3k4": train_kernel_phase, "k5": k5_phase}
        for name in args.phases.split(","):
            alone[name](device, args.seed)
        print(f"gpu: {card}")
        print("chip_smoke: ran only", args.phases, "- no result line")
        return 0
    k1 = k1_phase(device, args.seed)
    k2 = k2_phase(device, args.seed)
    k3k4 = train_kernel_phase(device, args.seed)
    k5 = k5_phase(device, args.seed)
    work_dir = os.path.join(ROOT, "build", "chip_smoke")
    serving = serving_phase(device, args.seed, os.path.join(work_dir, "model"))
    training = training_phase(device, args.seed, os.path.join(work_dir, "train"))

    # K1 at the serving path's stream shape: batch 1, 16 steps, f32
    main_shape = next(r for r in k1 if (r["dtype"], r["B"], r["T"]) == ("float32", 1, 16))
    kernels = [{
        "name": "lstm_recurrence",
        "route": "cuda",
        "source": "stt_tpu_torch/ops/csrc/lstm_recurrence.cu",
        "replaces": "stt_tpu/ops/lstm_kernel.py:44",
        "launches": sum(r["k1_launches"] for r in serving["requests"]),
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
    }]
    # K3 and K4 at the training phase's shape: B = 16, T = 256, f32
    train_shape = next(r for r in k3k4 if (r["dtype"], r["B"], r["T"]) == ("float32", *TRAIN_SHAPE))
    for kind, name, key, line in (("fwd", "lstm_train_fwd", "k3", 54),
                                  ("bwd", "lstm_train_bwd", "k4", 175)):
        row = train_shape[kind]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "stt_tpu_torch/ops/csrc/lstm_train.cu",
            "replaces": f"stt_tpu/ops/lstm_train.py:{line}",
            "launches": training["launches"][key],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    # K2 on the int8 request's own input projection, lengths and state, and
    # K5 at the stream's chunk (one stream, 16 frames, the artifact's beam
    # of 32, 29 classes)
    q_shape = serving["k2_at_int8_request"]
    beam_shape = next(r for r in k5 if (r["W"], r["C"], r["B"], r["T"], r["emissions"])
                      == (BEAM_WIDTH, 29, 1, 16, "flat"))
    for name, source, replaces, key, row in (
        ("lstm_recurrence_q", "lstm_recurrence_q.cu", "stt_tpu/ops/lstm_kernel.py:196", "k2", q_shape),
        ("beam_scan", "beam_scan.cu", "stt_tpu/ops/beam_kernel.py:506", "k5", beam_shape),
    ):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"stt_tpu_torch/ops/csrc/{source}",
            "replaces": replaces,
            "launches": sum(r["launches"][key] for r in serving["requests"]),
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
        })
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"gpu": card, "torch": torch.__version__, "k1": k1, "k2": k2, "k3k4": k3k4, "k5": k5,
                       "serving": serving, "training": training, "kernels": kernels},
                      f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(f"gpu: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
