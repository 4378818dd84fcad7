#!/usr/bin/env python3
"""Chip smoke run of stt_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--seed N] [--out REPORT.json]

1. Setup: prints the card's name and power limit, turns TF32 off, builds
   every CUDA kernel of the package from its sources (build/kernels/), one
   nvcc per source, all at once.
2. Kernel phase: holds each kernel against its plain PyTorch version on the
   card at the shapes of the main path and beyond, and times the kernel,
   the plain version, the bound and, where one exists, the one PyTorch
   call that computes the same function:
   - K1, the inference recurrence, at H = 2048, B in {1, 8, 32}, T in
     {16, 200}, f32 and bf16, ragged lengths, non-zero initial state;
   - K3 and K4, the training forward with stashes and the reverse sweep,
     at H = 2048, B in {8, 32}, T in {50, 200} and at the training phase's
     shape (B = 16, T = 256), f32 and bf16, ragged lengths, non-zero
     initial state and final-state gradients; the library time is cuDNN's
     training forward and its backward.
3. Serving phase: a full-width DeepSpeech (the 2048 geometry, 29 outputs)
   with random weights from a seeded generator, saved as an artifact and
   opened with `Model(dir)` on the card; answers `stt` on three utterances,
   `stt_with_metadata`, one `Stream` fed in 320 ms pieces with intermediate
   decodes, and `infer_logits` at B = 16. Each request must launch K1 and
   neither K3 nor K4, and the probabilities must match the same model run
   by the port on the CPU.
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


def k1_phase(device, seed: int) -> list:
    from stt_tpu_torch.models.lstm import recurrence
    from stt_tpu_torch.ops.lstm_kernel import lstm_recurrence

    H = 2048
    gen = torch.Generator().manual_seed(seed)
    limit = (6.0 / (6 * H)) ** 0.5  # lstm_init's Glorot limit at this width
    w32 = ((torch.rand(H, 4 * H, generator=gen) * 2 - 1) * limit).to(device)
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        w_h = w32.to(dtype).contiguous()
        lstm = cudnn_lstm(w_h, H, device) if dtype == torch.float32 else None
        for B in (1, 8, 32):
            for T in (16, 200):
                x_proj = (torch.randn(T, B, 4 * H, generator=gen) * 0.5).to(device).to(dtype)
                c0 = (torch.randn(B, H, generator=gen) * 0.1).to(device)
                h0 = ((torch.rand(B, H, generator=gen) * 2 - 1) * 0.1).to(device)
                seq = torch.randint(1, T + 1, (B,), generator=gen, dtype=torch.int32)
                seq[0] = T
                seq = seq.to(device)
                got, (c, h) = lstm_recurrence(x_proj, w_h, c0, h0, seq)
                want, (c_ref, h_ref) = recurrence(x_proj, w_h, c0, h0, seq)
                torch.cuda.synchronize()
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
                ms = cuda_ms(lambda: lstm_recurrence(x_proj, w_h, c0, h0, seq), reps)
                plain_ms = cuda_ms(lambda: recurrence(x_proj, w_h, c0, h0, seq), reps)
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
                    "max_abs_err": err, "tol": K1_TOL[dtype], "ms": ms,
                    "plain_ms": plain_ms, "library_ms": library_ms,
                    "library_max_abs_err": library_err, "bound_ms": bound,
                    "bound_by": bound_by, "w_h_per_step_bound_ms": w_step_ms,
                    "us_per_step": ms / T * 1e3,
                }
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
                   "tol": tol, "valid_steps": int(seq.sum())}
            for kind, err, fn, plain, args in (
                ("fwd", fwd_err, lstm_train_fwd, train_forward, fwd_args),
                ("bwd", bwd_err, lstm_train_bwd, train_backward, bwd_args),
            ):
                ms = cuda_ms(lambda: fn(*args), reps)
                bound, bound_by, w_step_ms = recurrence_bounds(
                    kind, T, B, H, int(seq.sum()), dtype)
                rec[kind] = {
                    "max_abs_err": err, "ms": ms, "us_per_step": ms / T * 1e3,
                    "plain_ms": cuda_ms(lambda: plain(*args), reps),
                    "bound_ms": bound, "bound_by": bound_by, "w_h_per_step_bound_ms": w_step_ms,
                    "library_ms": None, "library_rel_err": None,
                }
            if lstm is not None:
                cudnn_times(rec, lstm, x_proj, w_h, c0, h0, dout, dc_T, dh_T, reps)
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


def profile_request(gpu, audio: np.ndarray, alphabet) -> dict:
    """Where one stt request's time goes: its wall time under
    torch.profiler, the device time of all kernels and copies in it and of
    K1 alone, and the host beam decoder re-run alone on its emissions."""
    from torch.profiler import ProfilerActivity, profile

    from stt_tpu_torch.decode import ctc_beam_search_decoder

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        _, probs = gpu.stt_with_emissions(audio)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    events = device_events(prof)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    k1_ms = sum(e.self_device_time_total for e in events if "lstm_step" in e.key) / 1e3
    start = time.perf_counter()
    ctc_beam_search_decoder(probs, alphabet, BEAM_WIDTH)
    decode_ms = (time.perf_counter() - start) * 1e3
    rec = {
        "request": "stt_with_emissions (profiled)",
        "audio_s": len(audio) / gpu.sample_rate(),
        "wall_ms": wall_ms, "device_busy_ms": device_ms or None,
        "k1_device_ms": k1_ms or None, "host_decode_ms": decode_ms,
        "device_idle_share": (1 - device_ms / wall_ms) if device_ms else None,
    }
    print("profile", json.dumps(rec), flush=True)
    return rec


def serving_phase(device, seed: int, work_dir: str) -> dict:
    from stt_tpu_torch.alphabet import Alphabet
    from stt_tpu_torch.artifact import build_metadata, save_artifact
    from stt_tpu_torch.decode import ctc_beam_search_decoder
    from stt_tpu_torch.frontend import FeatureConfig, audio_to_mfcc
    from stt_tpu_torch.models import DeepSpeech, ModelConfig
    from stt_tpu_torch.ops.lstm_kernel import lstm_recurrence
    from stt_tpu_torch.ops.lstm_train import lstm_train_bwd, lstm_train_fwd
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

    def request(name: str, audio_s: float, fn):
        lstm_recurrence.launches = lstm_train_fwd.launches = lstm_train_bwd.launches = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - start) * 1e3
        launches = lstm_recurrence.launches
        if launches == 0:
            raise AssertionError(f"request {name} did not launch the LSTM kernel")
        if lstm_train_fwd.launches or lstm_train_bwd.launches:
            raise AssertionError(f"request {name} launched a training kernel")
        rec = {"request": name, "audio_s": audio_s, "ms": ms,
               "rtf": ms / 1e3 / audio_s, "k1_launches": launches}
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
    print(f"serving: probs err {probs_err:.3e} (tol {PROBS_TOL}), logits err "
          f"{logits_err:.3e} (tol {LOGITS_TOL}), transcripts card == cpu: "
          f"{text_gpu == text_cpu}", flush=True)
    return {
        "profile": profile_request(gpu, audios[2], alphabet),
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
    k3 = device_ms(lambda k: "lstm_train_fwd" in k)
    k4 = device_ms(lambda k: "lstm_train_bwd" in k)
    gemm = device_ms(lambda k: any(s in k.lower() for s in ("gemm", "cutlass", "sm90_xmma")))
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    rec = {
        **phases, "profiled_wall_ms": wall_ms, "device_busy_ms": busy or None,
        "k3_device_ms": k3 or None, "k4_device_ms": k4 or None, "gemm_device_ms": gemm or None,
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

    k1 = k1_phase(device, args.seed)
    k3k4 = train_kernel_phase(device, args.seed)
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
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"gpu": card, "torch": torch.__version__, "k1": k1, "k3k4": k3k4,
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
