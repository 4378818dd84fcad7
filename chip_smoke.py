#!/usr/bin/env python3
"""Chip smoke run of stt_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--seed N] [--out REPORT.json] [--phases tp,entry]

1. Setup: prints the card's name and power limit, turns TF32 off, builds
   every CUDA kernel of the package from its sources (build/kernels/), one
   nvcc per source, all at once, and beside them the native CTC decoder,
   the C API's libstt_tpu_torch.so and stt_client with g++ and gcc
   (build/native/).
2. Kernel phase: holds each kernel against its plain PyTorch version on the
   card at the shapes of the main path and beyond, and times the kernel,
   the plain version, the bound and, where one exists, the one PyTorch
   call that computes the same function:
   - K1, the inference recurrence, at H = 2048, B in {1, 8, 16, 32}, T in
     {16, 200} and the batch request's (B, T) = (16, 240), f32 and bf16,
     and in bf16 the benchmark tool's batch (128, 500) with cuDNN in bf16,
     ragged lengths, non-zero initial state, with the launch plan, the time
     per step, the ratio to cuDNN and, at a stream's chunk (B = 1, T = 16),
     the time with the L2 overwritten between calls;
   - K3 and K4, the training forward with stashes and the reverse sweep,
     at H = 2048, B in {8, 32}, T in {50, 200} and at the training phase's
     shape (B = 16, T = 256), f32 and bf16 (and in bf16 the benchmark
     tool's train step, (64, 500), with cuDNN in bf16), ragged lengths, non-zero
     initial state and final-state gradients, with both launch plans and
     their streaming floors; K4 twice on the same inputs must give the same
     bits; K4 is also timed with the weight gradient's GEMM beside it, the
     fair counterpart of cuDNN's backward; the library time is cuDNN's
     training forward and its backward.
   - K2, the int8 inference recurrence, at H = 2048, B in {1, 8, 16, 32}, T
     in {16, 200}, x_proj in f32 and bf16, ragged lengths, non-zero initial
     state: one step from a common state (the int32 sums are exact), then
     the sequence, with the count of h_q values that differ, the launch
     plan, its streaming floor and the time per step beside K1's in bf16;
   - K5, the beam scan, in its narrow instance (pool in shared memory) at
     (W, C) in {(8, 8), (32, 29), (128, 29), (128, 127), (500, 29), (512,
     31)}, B in {1, 16}, T in {16, 200}, in its wide instance (pool in
     device memory, byte alphabets) at (W, C) in {(32, 256), (128, 200),
     (500, 256), (512, 256)}, and in its huge instance (every other shape:
     its arrays in shared memory or a workspace in device memory) at (W, C)
     in {(1024, 29), (500, 1000), (500, 4096), (64, 300)}, both at B in
     {1, 8}, T in {16, 240}; peaky and flat emissions, one utterance shorter
     than T; the cutoff branches (cutoff_top_n below and above C), external
     class layouts, 256 classes with the blank first, chunks of 16 against
     one launch, and a state handed from the plain version to the kernel
     mid-stream, at beams 32 to 1,024 over 29 to 4,096 classes.
     Backpointers must be equal. Probabilities over 4,096 classes through
     the batch and the streaming device decoders at beam 500 must give the
     plain scan's transcripts. Then where a frame's time goes at beam 32
     and 500 (a variant built with K5_PHASE_CLOCKS: SM cycles by phase) and
     the most live keys a frame had;
   - the backtrace (also `--phases backtrack`), on K5's backpointers at
     B 128, T 750 in each of their three forms ((W, C) in {(500, 29),
     (500, 256), (600, 5)}): paths equal to its plain version's, and its
     time repeated and with the L2 overwritten before each run.
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
   must launch K2 and not K1, in one kernel on the card, and is held
   against the port's int8 path on the CPU and against the float logits,
   with K2 held against its plain version and timed on that request's own
   input projection; its time is printed beside the float request's.
   Before these, the host decoder's requests, decoded by the native
   decoder: the 4.7 s stream at beam 32 and at 500, the stream with a
   scorer and hot words at beam 500, and `stt_with_metadata` with them,
   each with its wall time, RTF, host decode time, device busy time and
   idle share, and the native and the Python decoder re-run alone on the
   same emissions, whose results each must equal. The scorers are .scorer
   packages built first by the port's own tools from a seeded corpus
   (3-gram; words, and characters in bytes mode).
3b. Decoder phase: the native decoder against the port's Python one on
   the model's emissions and seeded peaky ones (beam 32, with and without
   the scorer and hot words, through next_pruned with emissions pruned on
   the card, and a bytes-mode package), tokens and timesteps equal and
   confidences within 1e-6; beam 500 natively against the Python decoder
   at 128; the batch fan-out on infer_logits[B=16]'s softmax at 1 and 16
   threads; the gprof driver prof_decoder (500 frames x 10 decodes at beam
   500 with the word scorer, in a scratch directory), its wall seconds.
4. Training phase: 32 seeded synthetic utterances of 2-5 s with random
   transcripts, a train and a dev CSV, and `train(SttConfig(...))` of the
   full-width model at B = 16 for one epoch with dropout; every step must
   launch K3 and K4, losses must be finite, the parameters must move, the
   checkpoints must exist, and the trained weights, exported as an
   artifact, must answer `Model(dir).stt`. Then one full-width step on the
   card against the same step on the CPU (B = 2, dropout 0), the train
   step's time at B = 16, and where one profiled step's device time goes
   (it must show one K3 and one K4 kernel on the card).
4b. Evaluation phase, on the training phase's checkpoint and dev CSV (8
   utterances) through the port's entry points: `evaluate(config)` at
   test_batch_size 8 and export_beam_width 500 with the decode modes off,
   prune and full, prune with the word scorer, and prune with
   cutoff_top_n 10 (the chunked prune, copied into pinned memory): off,
   prune and full must agree (exact ties between classes counted beside
   the hold), K1 must launch at least once a batch, K5 in full and only
   there, the cutoff run must equal a host-pruned decode of the same
   probabilities; then where evaluate's time goes (forward, CTC loss,
   softmax, each decode mode's audio-s/s, the chunked prune against one
   bulk fetch). `export(config)` float, --export_zip and --export_quantize,
   the .sttpkg answering as the directory; `transcribe_file` on a 30 s
   seeded recording with the float export (K1) and the int8 one under
   quantized_inference=True (K2); `evaluate_export` on the dev CSV. No
   training kernel may launch. Then `evaluate` with --device_decode full
   --bytes_output_mode at beam 500 on a full-width bytes-mode checkpoint
   (n_out 256, seeded random weights): K5 in its wide instance, transcripts
   equal to the plain scan's on the same probabilities. `--phases
   evaluation` runs the training phase first, for its checkpoint.
4c. Input phase (also `--phases input`): `train(config)` of the
   full-width model from a CSV of FLAC (16 kHz, by `write_flac` here) and
   mu-law SPHERE (8 kHz), an SDB and a tar of 8 kHz WAV (32 utterances,
   B = 16, three epochs) with --augment covering every augmentation (codec
   where libopus loads), --feature_cache and --cache_for_epochs 2, 8 input
   workers and --profile_dir: K3 and K4 every step, the cache written in
   epoch 0, serving epoch 1 with no featurize, dropped at epoch 2; the
   trace names K3's and K4's kernels; 8 workers' batches equal the serial
   ones; the host featurize rate, serial and on 8 threads, beside the
   train step's.
4d. Pool phase (also `--phases pool`): `StreamPool` of the full-width
   model at 8 slots, nine utterances fed in 320 ms pieces with staggered
   lifetimes and a freed slot reused, with host slots (beam 32) and
   device-decode slots (beam 32, 500): pooled transcripts equal to single
   streams', one K1 launch a round, K5 in the device-decode runs; rounds,
   K5 calls a round, wall ms a cycle against the 320 ms cadence, and one
   profiled round's idle share.
4e. Augment phase (also `--phases augment`): `train(config)` of the
   full-width model with --graph_augs_on_device on the input phase's
   sources and augmentations (B = 16, one epoch; K3 and K4 every step);
   one batch's device pass on the card against the CPU (lengths equal,
   features within AUGMENT_TOL, the random family's gates closed; with them
   open the card's pass repeats); the pass's time, the augmented step's
   audio-s/s, and the host featurize rate of the spectrogram path beside
   the host path's.
4f. Parallel phase (also `--phases parallel`): two ranks of this script on
   the one card over gloo (NCCL refuses two ranks on one card) train the
   full-width model for one epoch, B = 16 (8 rows a rank), dropout 0: their
   losses equal each other and, within PARALLEL_LOSS_RTOL, one rank's on the
   global batch, as the merged dev loss; step ms of both; then a group of
   one rank on NCCL steps as a step without a group.
4g. TP phase (also `--phases tp`): tensor parallelism, --n_model_parallel
   2, on the parallel phase's data and config (full width, B = 16, one
   epoch, dropout 0): one rank, then ranks of this script on the one card
   over gloo on a (1 x 2) and a (2 x 2) mesh. Every rank must launch K3
   and K4 once a step at its B / K rows (8, then 4) with the gathered
   [2048, 8192] W_h, and K3 and K4 must agree with their plain versions
   on each of those recurrences' own inputs and cotangents; the ranks'
   losses and gathered parameters equal each other and one rank's within
   the stated tolerances, as the dev loss and the first step's gradients
   leaf by leaf; each rank's step ms and the bytes a step stages through
   the host beside one rank's step; which gloo collectives take CUDA
   tensors; the first forward's clipped-ReLU mask flips against one rank's.
4h. Entry phase (also `--phases entry`, after the training phase): on the
   training phase's checkpoint, `training_graph_inference` on a seeded 5 s
   WAV (K1; the transcript equals the served export's), `lm_optimizer`
   with four trials and the word scorer, `evaluate_flashlight` on the dev
   CSV, and `evaluate_wav2vec2am` on emissions that the port's model writes
   as .npy (K5); each one's wall ms, and no training kernel.
4i. C API phase (also `--phases capi`): the full-width artifact served
   through libstt_tpu_torch.so by ctypes in this process (STT_SpeechToText,
   STT_SpeechToTextWithMetadata, and a 320 ms-chunk stream with the word
   scorer and HOT_WORDS), each equal to the same request of an in-process
   `Model` on the card and launching K1, with both wall times; then the
   stt_client program in a subprocess, one-shot and --stream --scorer, whose
   transcripts must be the in-process ones, with its wall seconds.
4j. Compat phase (also `--phases compat`): the committed reference-format
   .tflite fixtures (f32 and int8, tests/fixtures/) imported by the port's
   reader and served by `Model(dir)` on the card: logits within
   COMPAT_LOGITS_TOL of the CPU's, equal transcripts, K1.
4k. Import phase (also `--phases import`): LDC93S1, LibriSpeech (FLAC),
   TIMIT (SPHERE), Common Voice (WAV clips and TSVs) and Switchboard (a
   two-channel 8 kHz mu-law call with MS98 transcripts) written from the
   seed in their published layouts and imported by the port's importers'
   main(argv) (Common Voice through a pool of 2 spawned workers): rows,
   folded transcripts and 16 kHz mono WAVs as built; then `train(config)`
   of the full-width model on the four train CSVs (B = 8, one epoch, the
   LDC93S1 CSV as dev; K3 and K4 every step) and `evaluate.main` on the
   test CSVs with --device_decode full at beam 32 (K1 and K5).
4l. Scripts phase (also `--phases scripts`): the port's scripts as a user
   runs them, on a `write_smoke_set` tree (the reference's smoke data with
   learnable stand-ins for its recordings): the benchmark tool at its
   defaults (K1 in bf16 at B 128, T 500; the 2048 stream; a bf16 train
   step at B 64, T 500 through K3/K4), the stream latency probe (K5
   against the host decoder: equal transcripts), and every
   stt_tpu_torch/bin/ script through `sh` with device=cuda, in two lanes
   side by side: each must exit 0 with its gates as written and launch its
   kernels (counted in its child processes through STT_TORCH_LAUNCH_LOG).
5. Prints one JSON line listing every kernel (launches counted over the
   serving, training, evaluation, input, pool, augment, parallel, tp,
   entry, capi, compat, import and scripts phases' runs), the card's name and power limit,
   and as the last line {"ok": true, "device": {...}}.

Any failure raises and the script exits non-zero. Without CUDA it exits 1
and prints no result. --out writes the full record as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
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
# the benchmark tool's shapes (stt_tpu_torch/tools/benchmark.py at its
# defaults, --batch 128 --seconds 10): K1 in its batch inference, K3 and K4
# in its train step at B = batch // 2, both in bf16
BENCH_K1_SHAPE, BENCH_TRAIN_SHAPE = (128, 500), (64, 500)
# cuDNN (torch.nn.LSTM) against the kernels on their function, before its
# time is taken: the forward by max abs diff, the backward by the largest
# relative one (see cudnn_times). In f32 both keep f32 state; in bf16
# cuDNN also rounds its output and state to bf16, so it is held only to
# computing the same function (measured on an H100 at the benchmark shapes:
# 3.7e-3 forward, 5.2e-3 relative backward).
CUDNN_AGREE = {torch.float32: (1e-4, 2e-2), torch.bfloat16: (5e-2, 1e-1)}
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
# card vs CPU logits of the 64-wide imported .tflite fixtures, f32 sums in
# another order (measured 1.6e-7 on an H100 80GB HBM3 at 700 W)
COMPAT_LOGITS_TOL = 1e-4
LABELS = list(" abcdefghijklmnopqrstuvwxyz'")  # English, 28 labels + blank
BEAM_WIDTH = 32
# the native (C++) decoder against the port's Python one on the same inputs:
# the same float64 terms, in places summed in another order (the tolerance
# of tests/test_native_decoder.py); tokens and timesteps must be equal
DECODER_CONF_TOL = 1e-6
# the scorer's corpus: sentences drawn from these words with Zipf-like
# weights, a 3-gram Kneser-Ney model, and the package's default alpha/beta
LM_WORDS = (
    "the of and to a in is you that it he was for on are as with his they i at be this "
    "have from or one had by word but not what all were we when your can said there use "
    "an each which she do how their if will up other about out many then them these so "
    "some her would make like him into time has look two more write go see number no way "
    "could people my than first water been call who oil its now find long down day did get "
    "come made may part over new sound take only little work know place year live me back "
    "give most very after thing our just name good dark suit greasy wash year don't can't"
).split()
LM_SENTENCES, LM_ORDER, LM_ALPHA, LM_BETA = 3000, 3, 0.93, 1.18
HOT_WORDS = {"water": 2.0, "the": -0.5, "year": 1.0}
TRAIN_SHAPE = (16, 256)  # (B, T) of the training phase's longest batch
# the input phase's --augment: every augmentation of the reference (codec
# only where libopus loads), the overlay's source filled in at run time
INPUT_AUGMENT = (
    "overlay[p=0.5,source={noise},snr=8:20,layers=1:2]", "reverb[p=0.3,delay=10:30,decay=5:15]",
    "resample[p=0.3,rate=8000:12000]", "volume[p=0.5,dbfs=-20:-3]",
    "pitch[p=0.3,pitch=0.9:1.1~0.05]", "tempo[p=0.3,factor=0.9:1.1]", "warp[p=0.3]",
    "frequency_mask[p=0.5,n=1:3,size=1:5]", "time_mask[p=0.5,n=1:3,size=10:50]",
    "dropout[p=0.3,rate=0.02:0.05]", "add[p=0.3,stddev=0.1]", "multiply[p=0.3,stddev=0.05]",
)
INPUT_CODEC = "codec[p=0.3,bitrate=8000:16000]"
# threaded against serial featurization of one epoch, the same package:
# numpy's and torch's CPU kernels may sum in another order under threads
# (stt_tpu's tests/test_data.py)
THREADED_RTOL, THREADED_ATOL = 1e-4, 1e-5


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
    w_h = H * 4 * H * dtype.itemsize
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
        # and in bf16 the benchmark tool's batch, with cuDNN in bf16 beside it
        for B, T in shapes + ([BENCH_K1_SHAPE] if dtype == torch.bfloat16 else []):
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
            library = lstm
            if library is None and (B, T) == BENCH_K1_SHAPE:
                library = cudnn_lstm(w_h, H, device).to(dtype)
            if library is not None:
                full = torch.full((B,), T, dtype=torch.int32, device=device)
                k_out, (k_c, k_h) = lstm_recurrence(x_proj, w_h, c0, h0, full)
                state0 = (h0[None].to(dtype), c0[None].to(dtype))
                with torch.no_grad():
                    l_out, (l_h, l_c) = library(x_proj, state0)
                library_err = max(
                    (k_out - l_out.float()).abs().max().item(),
                    (k_c - l_c[0].float()).abs().max().item(),
                    (k_h - l_h[0].float()).abs().max().item(),
                )
                if library_err <= CUDNN_AGREE[dtype][0]:
                    with torch.no_grad():
                        library_ms = cuda_ms(lambda: library(x_proj, state0), reps)
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
    from stt_tpu_torch.ops.lstm_kernel import pack_w_h, plan_for
    from stt_tpu_torch.ops.lstm_train import (
        lstm_train_bwd, lstm_train_fwd, train_backward, train_forward, weight_grad,
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
        # the tp phase's model ranks: B / K = 8 and 4 rows of the training shape
        tp_shapes = [(TRAIN_SHAPE[0] // k, TRAIN_SHAPE[1]) for k in (2, 4)]
        # and in bf16 the benchmark tool's train step, with cuDNN in bf16 beside it
        extra = tp_shapes if dtype == torch.float32 else [BENCH_TRAIN_SHAPE]
        for B, T in shapes + extra:
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
            again = lstm_train_bwd(*bwd_args, packed=pack_w_h(w_h))  # the forward's copy
            torch.cuda.synchronize()
            bwd_err = max((g - w).abs().max().item() for g, w in zip(got_b, want_b))
            if not bwd_err <= tol:
                raise AssertionError(f"K4 {name}: max abs diff {bwd_err} > {tol}")
            if not all(torch.equal(a, b) for a, b in zip(got_b, again)):
                raise AssertionError(f"K4 {name}: two calls on the same inputs differ")

            reps = 3 if T >= 200 else 10
            rec = {"dtype": str(dtype).replace("torch.", ""), "B": B, "T": T, "H": H,
                   "tol": tol, "valid_steps": int(seq.sum()), "fwd_kernel": "persistent",
                   "fwd_plan": plan_for(B, H, dtype, device).describe(),
                   "fwd_floors": streaming_floors(plan_for(B, H, dtype, device), T, H, dtype, device),
                   "bwd_kernel": "persistent",
                   "bwd_plan": plan_for(B, H, dtype, device, backward=True).describe(),
                   "bwd_floors": streaming_floors(plan_for(B, H, dtype, device, backward=True),
                                                  T, H, dtype, device)}
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
            # K4 with the weight gradient the autograd function forms beside
            # it: the counterpart of cuDNN's backward, which forms it too
            packed, hs = pack_w_h(w_h), got[0]

            def k4_and_dw():
                dz = lstm_train_bwd(*bwd_args, packed=packed)[0]
                return weight_grad(h0, hs, dz, w_h.dtype)

            rec["bwd"]["with_dw_ms"] = cuda_ms(k4_and_dw, reps)
            rec["bwd"]["with_dw_vs_library"] = None
            library = lstm
            if library is None and (B, T) == BENCH_TRAIN_SHAPE:
                library = cudnn_lstm(w_h, H, device).to(dtype)
            if library is not None:
                cudnn_times(rec, library, x_proj, w_h, c0, h0, dout, dc_T, dh_T, reps)
                for kind in ("fwd", "bwd"):
                    if rec[kind]["library_ms"]:
                        rec[kind]["vs_library"] = rec[kind]["ms"] / rec[kind]["library_ms"]
                if rec["bwd"]["library_ms"]:
                    rec["bwd"]["with_dw_vs_library"] = rec["bwd"]["with_dw_ms"] / rec["bwd"]["library_ms"]
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
    dtype = x_proj.dtype  # the LSTM's too
    full = torch.full((B,), T, dtype=torch.int32, device=x_proj.device)
    hs, cs, zs, c_T, h_T = lstm_train_fwd(x_proj, w_h, c0, h0, full)
    cs_prev = torch.cat([c0[None], cs[:-1]]).contiguous()
    dz, dc0, dh0 = lstm_train_bwd(zs, cs, cs_prev, dout, w_h, full, dc_T, dh_T)
    xr = x_proj.detach().clone().requires_grad_()
    h0r = h0[None].to(dtype).detach().clone().requires_grad_()
    c0r = c0[None].to(dtype).detach().clone().requires_grad_()
    grads = [dout.to(dtype), dh_T[None].to(dtype), dc_T[None].to(dtype)]
    with torch.enable_grad():
        out, (hn, cn) = lstm(xr, (h0r, c0r))
        torch.autograd.backward([out, hn, cn], grads, retain_graph=True)
    fwd_err = max((out.float() - hs).abs().max().item(), (cn[0].float() - c_T).abs().max().item(),
                  (hn[0].float() - h_T).abs().max().item())
    # K4's gates come from bf16 z, cuDNN's from f32 z: ~1e-3 apart
    bwd_err = max(((xr.grad.float() - dz).abs().max() / dz.abs().max()).item(),
                  ((c0r.grad[0].float() - dc0).abs().max() / dc0.abs().max()).item(),
                  ((h0r.grad[0].float() - dh0).abs().max() / dh0.abs().max()).item())
    rec["fwd"]["library_rel_err"] = fwd_err
    rec["bwd"]["library_rel_err"] = bwd_err
    fwd_agree, bwd_agree = CUDNN_AGREE[dtype]
    if fwd_err <= fwd_agree:
        with torch.enable_grad():
            rec["fwd"]["library_ms"] = cuda_ms(lambda: lstm(xr, (h0r, c0r)), reps)
    if bwd_err <= bwd_agree:
        rec["bwd"]["library_ms"] = cuda_ms(
            lambda: torch.autograd.backward([out, hn, cn], grads, retain_graph=True), reps)


def k2_record(name: str, args: tuple, packed: torch.Tensor) -> dict:
    """Holds K2 against its plain version on args = (x_proj, w_h_q,
    step_scale, c0, h0, seq): one step from the common start state, then
    the sequence, with the count of h_q values that differ; and times it
    beside its bound, its launch plan's streaming floor, the plain version
    and K1 in bf16 on the same x_proj and lengths with W_h = W_h_q's
    dequantized image (the float path's fastest recurrence, same shapes)."""
    from stt_tpu_torch.ops.lstm_kernel import lstm_recurrence, lstm_recurrence_q, pack_w_h, plan_for
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
    run = lambda: lstm_recurrence_q(*args, packed=packed)
    ms = cuda_ms(run, reps)
    plain_ms = cuda_ms(lambda: recurrence_q(*args), 2 if T > 16 else 5)
    w_bf16 = (w_h_q.float() * step_scale * 127.0).to(torch.bfloat16)
    x_bf16 = x_proj.to(torch.bfloat16)
    k1_packed = pack_w_h(w_bf16)
    k1_run = lambda: lstm_recurrence(x_bf16, None, c0, h0, seq, packed=k1_packed)
    k1_ms = cuda_ms(k1_run, reps)
    # the kernels alone: at T = 16 a call's time is mostly the wrapper's host work
    device_ms = kernel_device_ms(run, K2_KERNEL, reps)
    k1_device_ms = kernel_device_ms(k1_run, K1_BF16_KERNEL, reps)
    plan = plan_for(B, H, torch.int8, x_proj.device)
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
        "kernel": "persistent", "plan": plan.describe(),
        **streaming_floors(plan, T, H, torch.int8, x_proj.device),
        "ms": ms, "us_per_step": ms / T * 1e3, "plain_ms": plain_ms,
        "k1_bf16_ms": k1_ms, "k1_bf16_us_per_step": k1_ms / T * 1e3,
        "device_ms": device_ms, "device_us_per_step": device_ms / T * 1e3,
        "k1_bf16_device_ms": k1_device_ms, "k1_bf16_device_us_per_step": k1_device_ms / T * 1e3,
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
    got_src, got_char = bp_pair(packed)
    if torch.equal(got_src, src) and torch.equal(got_char, char):
        return score_err
    b, t, k = (int(v) for v in ((got_src != src) | (got_char != char)).nonzero()[0])
    upto = (probs[:, :t + 1].contiguous(), lens.clamp(max=t + 1), W, *params)
    if state is None:
        state = beam_kernel.init_state(probs.shape[0], probs.device, beam_kernel.state_slots(W))
    _, s_kernel, _ = beam_kernel.beam_scan(*upto, state=state)
    st, _, _ = beam_scan_plain(beam_kernel.state_to_plain(state, W), *upto)
    s_plain = logaddexp(st[0], st[1])
    got_sc = (int(got_src[b, t, k]), int(got_char[b, t, k]))
    print(f"{name}: first difference at utterance {b} frame {t} slot {k}: kernel (src, char) "
          f"{got_sc} value {s_kernel[b, k].item()!r}, plain ({int(src[b, t, k])}, "
          f"{int(char[b, t, k])}) value {s_plain[b, k].item()!r}", flush=True)
    apart = ulps_apart(s_kernel[b, k], s_plain[b, k])
    walked = [beam_results(scores[i], got_src[i].cpu().numpy(), got_char[i].cpu().numpy(), W)
              == beam_results(want[i], src[i].cpu().numpy(), char[i].cpu().numpy(), W)
              for i in range(probs.shape[0])]
    if apart > K5_TIE_ULPS or not all(walked):
        raise AssertionError(f"{name}: backpointers differ ({apart} ulp apart, rebuilt equal: {walked})")
    return score_err


def bp_pair(bp) -> tuple:
    """K5's backpointers as the (bp_src, bp_char) int32 pair on the card:
    the huge instance's pair as it is, the packed plane unpacked."""
    if isinstance(bp, tuple):
        return bp
    packed = bp.to(torch.int32)
    return packed >> 8, (packed & 0xFF) - 1


def cat_bp(parts: list):
    """Chunks' backpointers joined along time, in their own form."""
    if isinstance(parts[0], tuple):
        return tuple(torch.cat([p[i] for p in parts], dim=1) for i in range(2))
    return torch.cat(parts, dim=1)


def same_bp(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(bp_pair(a), bp_pair(b)))


def beam_results(scores, src, char, W: int) -> list:
    """(tokens, timesteps) of every live candidate, best first."""
    from stt_tpu_torch.alphabet import Alphabet
    from stt_tpu_torch.decode.device import rebuild_results

    alphabet = Alphabet().init_from_labels([chr(0x4E00 + i) for i in range(8192)])
    found = rebuild_results(scores.cpu().numpy(), src, char, alphabet, W)
    return [(r.tokens, r.timesteps) for r in found]


K5_NARROW = ((8, 8), (32, 29), (128, 29), (128, 127), (500, 29), (512, 31))  # pool in shared memory
K5_WIDE = ((32, 256), (128, 200), (500, 256), (512, 256))  # pool in device memory
# the huge instance: a beam past 512, character alphabets past 256 classes
# (cutoff_top_n 40 above C at 29 classes, below it at 300 and more)
K5_HUGE = ((1024, 29), (500, 1000), (500, 4096), (64, 300))


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
    narrow = [((W, C), B, T) for W, C in K5_NARROW for B in (1, 16) for T in (16, 200)]
    wide = [((W, C), B, T) for W, C in K5_WIDE for B in (1, 8) for T in (16, 240)]
    huge = [((W, C), B, T) for W, C in K5_HUGE for B in (1, 8) for T in (16, 240)]
    for (W, C), B, T in narrow + wide + huge:
        for peaky in (True, False):
            probs, lens = beam_inputs(B, T, C, peaky, seed + W + C + B + T, device)
            name = f"K5 W={W} C={C} B={B} T={T} {'peaky' if peaky else 'flat'}"
            params = (40, 1.0, None, ())
            out = beam_kernel.beam_scan(probs, lens, W, *params)
            # the plain version's one run, timed: the fixtures before it warmed its ops
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            want = plain(probs, lens, W, *params)
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
            err = compare_beam(name, probs, lens, W, out, want, params)
            reps = 20 if T <= 16 else 3
            ms = cuda_ms(lambda: beam_kernel.beam_scan(probs, lens, W, *params), reps)
            # the kernel alone: at T = 16 the call's host work can outlast it
            device_ms = kernel_device_ms(
                lambda: beam_kernel.beam_scan(probs, lens, W, *params), "beam_scan_kernel", reps)
            state_bytes = (2 + 5) * B * beam_kernel.state_slots(W) * 4 + B * 4
            kind = beam_kernel.instance(W, C)
            bp_bytes = B * T * W * (8 if kind == "huge" else 2 if W <= beam_kernel.WSLOTS else 4)
            lanes = beam_kernel._masks(C, C - 1, (), True)[0].size
            moved = B * T * C * 4 + B * 4 + 2 * lanes * 4 + 2 * state_bytes + bp_bytes
            bound, bound_by = bound_ms(moved, 0, torch.float32)
            rec = {"W": W, "C": C, "B": B, "T": T, "emissions": "peaky" if peaky else "flat",
                   "instance": kind,
                   "max_abs_err": err, "tol": K5_SCORE_TOL, "backpointers": "equal",
                   "ms": ms, "us_per_frame": ms / T * 1e3, "device_ms": device_ms,
                   "device_us_per_frame": device_ms / T * 1e3, "plain_ms": plain_ms,
                   "library_ms": None, "bound_ms": bound, "bound_by": bound_by}
            print("k5", json.dumps(rec), flush=True)
            records.append(rec)

    # the branches of the emission cutoff, and an external class layout
    for label, C, W, params in (
        ("cutoff_top_n=10 cutoff_prob=0.9", 29, 32, (10, 0.9, None, ())),
        ("cutoff_top_n=20", 29, 32, (20, 1.0, None, ())),
        ("blank_id=0 ignored=(1, 2)", 32, 32, (40, 1.0, 0, (1, 2))),
        ("wide cutoff_top_n=10 cutoff_prob=0.9", 256, 64, (10, 0.9, None, ())),
        ("wide blank_id=0 ignored=(1, 2)", 200, 130, (40, 1.0, 0, (1, 2))),
        ("huge 256 classes blank_id=0", 256, 128, (40, 1.0, 0, ())),
        ("huge 256 classes blank_id=0 at beam 500", 256, 500, (40, 1.0, 0, ())),
        ("huge 256 classes blank_id=0 cutoff_top_n above C", 256, 128, (300, 1.0, 0, ())),
        ("huge cutoff_top_n above C", 300, 64, (400, 1.0, None, ())),
        ("huge cutoff_top_n above C at 1,000 classes", 1000, 500, (1200, 1.0, None, ())),
        ("huge cutoff_top_n above C at 4,096 classes", 4096, 500, (5000, 1.0, None, ())),
        ("huge cutoff_top_n=10 cutoff_prob=0.9", 4096, 500, (10, 0.9, None, ())),
        ("huge blank_id=0 ignored=(1, 2)", 1000, 130, (40, 1.0, 0, (1, 2))),
        ("huge beam 1024 cutoff_top_n=10 cutoff_prob=0.9", 29, 1024, (10, 0.9, None, ())),
        ("huge beam 1024 cutoff_top_n below C", 29, 1024, (20, 1.0, None, ())),
    ):
        for peaky in (True, False):
            probs, lens = beam_inputs(4, 48, C, peaky, seed + 100 + C + len(label), device)
            out = beam_kernel.beam_scan(probs, lens, W, *params)
            compare_beam(f"K5 {label} {'peaky' if peaky else 'flat'}", probs, lens, W, out,
                         plain(probs, lens, W, *params), params)
    print("k5 branches: backpointers equal (cutoff_prob, cutoff_top_n alone and above C, "
          "external layouts, 256 classes with blank 0; narrow, wide and huge)", flush=True)

    # chunks of 16 with the state carried against one launch over all T,
    # and a state handed from the plain version to the kernel mid-stream,
    # in both instances
    for W, C, blank_id in ((32, 29, None), (500, 29, None), (32, 256, None), (500, 256, None),
                           (1024, 29, None), (500, 1000, None), (500, 4096, None), (64, 300, None),
                           (128, 256, 0)):
        B, T = 4, 64
        params = (40, 1.0, blank_id, ())
        probs, lens = beam_inputs(B, T, C, True, seed + 200 + W, device)
        _, scores, packed = beam_kernel.beam_scan(probs, lens, W, *params)
        state, parts = None, []
        for t0 in range(0, T, 16):
            state, chunk_scores, bp = beam_kernel.beam_scan(
                probs[:, t0:t0 + 16].contiguous(), (lens - t0).clamp(0, 16), W, *params,
                state=state)
            parts.append(bp)
        if not (same_bp(cat_bp(parts), packed) and torch.equal(chunk_scores, scores)):
            raise AssertionError(f"K5 W={W} C={C}: chunks of 16 differ from one launch over all frames")
        half = plain(probs[:, :32].contiguous(), lens.clamp(max=32), W, *params)
        rest = (probs[:, 32:].contiguous(), (lens - 32).clamp(min=0), W)
        handed = beam_kernel.beam_scan(*rest, *params, state=beam_kernel.state_from_plain(half[0]))
        carried = plain(*rest, *params, state=beam_kernel.state_from_plain(half[0]))
        compare_beam(f"K5 W={W} C={C} state handed from the plain version", *rest, handed, carried,
                     params, state=beam_kernel.state_from_plain(half[0]))
        if not same_bp(cat_bp([(half[1], half[2]), bp_pair(handed[2])]), packed):
            raise AssertionError(f"K5 W={W} C={C}: plain first half + kernel second half differs from one launch")
    print("k5 chunked == one launch; plain -> kernel hand-over mid-stream equal (beam 32, 64, "
          "128, 500 and 1024; 29, 256 (blank last and first), 300, 1,000 and 4,096 classes)",
          flush=True)
    large_alphabet_decodes(device, seed)
    return records


BACKTRACK_SHAPES = ((500, 29), (500, 256), (600, 5))  # (W, C) at B 128, T 750: the three planes


def backtrack_phase(device, seed: int) -> list:
    """The backtrace kernel on K5's backpointers at the batch cells' shape
    (B 128, T 750, one result): against its plain version on the card, and
    its times, repeated (the walks' lines stay in the L2) and alone with the
    L2 overwritten before each run. Its bound is bytes (each walk's T
    entries, the scores, the paths), but each walk is T dependent loads, so
    its time is T times the memory's latency. No PyTorch call walks
    backpointers: no library time."""
    from stt_tpu_torch.decode.device import PATH_HEAD, backtrack_plain
    from stt_tpu_torch.ops import beam_kernel

    B, T, R = 128, 750, 1
    spoil = flush_l2(device)
    records = []
    for W, C in BACKTRACK_SHAPES:
        probs, lens = beam_inputs(B, T, C, True, seed + W + C, device)
        _, scores, bp = beam_kernel.beam_scan(probs, lens, W)
        run = lambda: beam_kernel.beam_backtrack(scores, bp, R)
        got = run()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = backtrack_plain(scores, bp, R)
        end.record()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"backtrace W={W} C={C}: the kernel's paths differ from the plain version's")
        entry = 8 if isinstance(bp, tuple) else bp.element_size()
        moved = B * R * T * entry + B * W * 4 + B * R * (PATH_HEAD + 2 * T) * 4
        bound, bound_by = bound_ms(moved, 0, torch.float32)
        rec = {"W": W, "C": C, "B": B, "T": T, "R": R,
               "plane": "pair" if isinstance(bp, tuple) else str(bp.dtype),
               "paths": "equal", "ms": cuda_ms(run, 20),
               "device_ms": kernel_device_ms(run, "beam_backtrack_kernel", 20),
               "cold_ms": alone_ms(run, spoil, 10), "plain_ms": start.elapsed_time(end),
               "library_ms": None, "bound_ms": bound, "bound_by": bound_by,
               "dependent_loads_per_walk": T}
        print("backtrack", json.dumps(rec), flush=True)
        records.append(rec)
    return records


def large_alphabet_decodes(device, seed: int) -> None:
    """Probabilities over a 4,096-class alphabet (4,095 characters and the
    blank) through `ctc_beam_search_decoder_device` and a
    `DeviceStreamingDecoder` fed in chunks of 16, at beam 500, on the card
    (K5's huge instance): their transcripts, tokens and timesteps must be
    those of the plain scan on the same probabilities."""
    from stt_tpu_torch.alphabet import Alphabet
    from stt_tpu_torch.decode import device as decode_device
    from stt_tpu_torch.ops import beam_kernel

    C, W, B, T = 4096, 500, 2, 64
    alphabet = Alphabet().init_from_labels([chr(0x4E00 + i) for i in range(C - 1)])
    probs, lens = beam_inputs(B, T, C, True, seed + 300, device)
    before = beam_kernel.beam_scan.launches
    got = decode_device.ctc_beam_search_decoder_device(probs, lens.tolist(), alphabet,
                                                       beam_size=W, num_results=3)
    streams = []
    for i in range(B):
        dec = decode_device.DeviceStreamingDecoder(alphabet, W)
        n = int(lens[i])
        for t0 in range(0, T, 16):
            dec.next(probs[i, t0:t0 + 16], n_valid=max(0, min(16, n - t0)))
        streams.append(dec.decode(3))
    launches = beam_kernel.beam_scan.launches - before
    st, src, char = decode_device.beam_scan_plain(
        decode_device.init_beam_state(B, W, device), probs, lens, W, 40, 1.0)
    scores = decode_device.logaddexp(st[0], st[1]).cpu().numpy()
    for i in range(B):
        want = decode_device.rebuild_results(scores[i], src[i].cpu().numpy(),
                                             char[i].cpu().numpy(), alphabet, 3)
        for results in (got[i], streams[i]):
            if [(r.transcript, r.tokens, r.timesteps) for r in results] != \
                    [(r.transcript, r.tokens, r.timesteps) for r in want]:
                raise AssertionError(f"4,096 classes, utterance {i}: {results} differ from the "
                                     f"plain scan's {want}")
    if launches != 1 + B * T // 16:
        raise AssertionError(f"4,096 classes: {launches} K5 launches, {1 + B * T // 16} expected")
    print(f"k5 4,096 classes at beam 500: batch and streaming device decodes equal the plain "
          f"scan's transcripts ({launches} K5 launches)", flush=True)


def kernel_device_ms(fn, name: str, reps: int) -> float:
    """Device milliseconds per call of the kernels named `name` (a
    substring) in fn(), from torch.profiler: the kernel alone, without the
    host's work around it. Fails if fn() launches no such kernel."""
    from torch.profiler import ProfilerActivity

    fn()
    _, _, events = device_profile(lambda: [fn() for _ in range(reps)], [ProfilerActivity.CUDA], [name])
    return sum(e.self_device_time_total for e in events if name in e.key) / 1e3 / reps


def k5_against(device, seed: int, other_source: str) -> list:
    """K5 against another version of its source (`beam_scan.cu` of another
    commit, with the same entry point), built beside it and timed in turns
    (other, this, this, other) on the same inputs, with equal backpointers
    required: a comparison that the spread between runs on different
    machines cannot blur."""
    import ctypes

    from stt_tpu_torch.ops import _build, beam_kernel

    lib = _build.BUILD_DIR / "libbeam_scan_other.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), other_source],
                   check=True, capture_output=True)
    other = ctypes.CDLL(str(lib)).beam_scan
    this = beam_kernel._library_function()
    other.argtypes, other.restype = this.argtypes, this.restype
    kept = beam_kernel._library_function
    out = []
    try:
        for W, C in ((8, 8), (32, 29), (128, 29), (128, 127), (500, 29)):
            for B, T in ((1, 16), (1, 200), (16, 200)):
                for peaky in (True, False):
                    probs, lens = beam_inputs(B, T, C, peaky, seed + W + C + B + T, device)
                    run = lambda: beam_kernel.beam_scan(probs, lens, W)
                    times, results = {"other": [], "this": []}, {}
                    for turn in ("other", "this", "this", "other"):
                        fn = other if turn == "other" else this
                        beam_kernel._library_function = lambda define="", kind="narrow", fn=fn: fn
                        results[turn] = run()[2]
                        times[turn].append(kernel_device_ms(run, "beam_scan_kernel", 10 if T <= 16 else 3))
                    if not torch.equal(results["other"], results["this"]):
                        raise AssertionError(f"K5 W={W} C={C}: the other source's backpointers differ")
                    rec = {"W": W, "C": C, "B": B, "T": T, "emissions": "peaky" if peaky else "flat",
                           "other_device_ms": times["other"], "this_device_ms": times["this"],
                           "this_vs_other": sum(times["this"]) / sum(times["other"])}
                    print("k5_against", json.dumps(rec), flush=True)
                    out.append(rec)
    finally:
        beam_kernel._library_function = kept
    return out


K5_PHASES = ("cutoff", "parent_lookup", "updates", "pool", "selection", "winners")


def k5_split(device, seed: int, records: list) -> list:
    """Where a frame of K5 goes, at the stream's chunk (B = 1, T = 16, C =
    29) for beam 32 and 500, flat and peaky emissions: the variant built
    with K5_PHASE_CLOCKS (the same kernel with a barrier and an SM clock
    stamp after each phase, block 0 only) on k5_phase's inputs, SM cycles
    per frame by phase, their shares, and the most live keys a frame had.
    The frame's time is k5_phase's, from the uninstrumented kernel."""
    import ctypes

    from stt_tpu_torch.ops import _build, beam_kernel

    read = _build.load("beam_scan", "K5_PHASE_CLOCKS").beam_scan_phase_clocks
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    clocks = (ctypes.c_ulonglong * 8)()
    kept = beam_kernel._library_function
    instrumented = kept("K5_PHASE_CLOCKS")
    split = []
    beam_kernel._library_function = lambda define="", kind="narrow": instrumented
    try:
        for W, C in ((BEAM_WIDTH, 29), (500, 29)):
            for peaky in (True, False):
                emissions = "peaky" if peaky else "flat"
                probs, lens = beam_inputs(1, 16, C, peaky, seed + W + C + 1 + 16, device)
                beam_kernel.beam_scan(probs, lens, W)
                torch.cuda.synchronize()
                if read(clocks) != 0:  # (sets them to zero)
                    raise RuntimeError("reading K5's phase clocks failed")
                for _ in range(10):
                    beam_kernel.beam_scan(probs, lens, W)
                torch.cuda.synchronize()
                if read(clocks) != 0:
                    raise RuntimeError("reading K5's phase clocks failed")
                per_frame = [clocks[i] / clocks[7] for i in range(len(K5_PHASES))]
                row = next(r for r in records if (r["W"], r["C"], r["B"], r["T"], r["emissions"])
                           == (W, C, 1, 16, emissions))
                rec = {"W": W, "C": C, "B": 1, "T": 16, "emissions": emissions,
                       "us_per_frame": row["us_per_frame"], "pool_keys": W * (C + 1),
                       "most_live_keys": int(clocks[6]),
                       "cycles_per_frame": dict(zip(K5_PHASES, per_frame)),
                       "share": {k: v / sum(per_frame) for k, v in zip(K5_PHASES, per_frame)}}
                print("k5_split", json.dumps(rec), flush=True)
                split.append(rec)
    finally:
        beam_kernel._library_function = kept
    return split


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


def transcript(seconds: float, rng: np.random.RandomState) -> str:
    """Random words over LABELS, at most 8 characters a second of audio."""
    words = rng.randint(3, 9)
    text = " ".join("".join(rng.choice(LABELS[1:], rng.randint(2, 7)))
                    for _ in range(words))[: int(seconds * 8)]
    return text.strip() or "a"


def device_events(prof) -> list:
    """The profiler's kernels and copies on the card, by name. (A CPU-side
    op such as aten::mm also reports its kernels' time as its own device
    time; summing every entry would count those twice.)"""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


PROFILE_TRIES = 3  # sessions of torch.profiler taken before a run without device events fails


def device_profile(fn, activities, names=()) -> tuple:
    """fn() under torch.profiler: (its result, its wall milliseconds, the
    session's device events). Now and then, in a run of many sessions, one
    comes back without the kernels that fn launched, their records lost; a
    session with no device event, or with none named by one of `names` (a
    substring of a kernel's name that fn must launch), is taken again, up
    to PROFILE_TRIES times."""
    from torch.profiler import profile

    for attempt in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            start = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - start) * 1e3
        events = device_events(prof)
        missing = [n for n in names if not any(n in e.key for e in events)]
        if events and not missing:
            return result, wall_ms, events
        print(f"profiler: session {attempt} of {PROFILE_TRIES} recorded "
              f"{len(events)} device events, none of {missing}", file=sys.stderr, flush=True)
    raise AssertionError(f"torch.profiler recorded no device event, or none of {missing}, "
                         f"in {PROFILE_TRIES} sessions")


RECURRENCE_KERNEL = "recurrence_kernel"  # K1's, K2's and K3's persistent kernel, by name
K2_KERNEL = "recurrence_kernel<signed char"  # its int8 instances (K2), by name
K1_BF16_KERNEL = "recurrence_kernel<__nv_bfloat16, __nv_bfloat16"  # K1 (or K3) in bf16
BWD_KERNEL = "bwd_kernel"  # K4's persistent kernel, by name


def profiled(name: str, audio_s: float, fn, kernel_names: dict) -> tuple:
    """One request under torch.profiler: its wall time, the device time of
    all kernels and copies in it and of each named kernel (by a substring
    of the kernel's name), and the device's idle share. Where K1 is named,
    its device events are counted too: the recurrence must show one kernel
    per wrapper call, not one per step. Returns (record, the request's
    result)."""
    from torch.profiler import ProfilerActivity

    from stt_tpu_torch.ops.lstm_kernel import lstm_recurrence, lstm_recurrence_q

    counted = {}

    def request():  # the wrapper calls of the session that is kept
        before = lstm_recurrence.launches, lstm_recurrence_q.launches
        out = fn()
        counted["calls"] = lstm_recurrence.launches - before[0]
        counted["q_calls"] = lstm_recurrence_q.launches - before[1]
        return out

    result, wall_ms, events = device_profile(request, [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                             list(kernel_names.values()))
    calls, q_calls = counted["calls"], counted["q_calls"]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    rec = {"request": f"{name} (profiled)", "audio_s": audio_s, "wall_ms": wall_ms,
           "device_busy_ms": device_ms, "device_idle_share": 1 - device_ms / wall_ms}
    for key, part in kernel_names.items():
        rec[key] = sum(e.self_device_time_total for e in events if part in e.key) / 1e3
    if "k1_device_ms" in kernel_names:
        rec["k1_wrapper_calls"] = calls
        rec["k1_device_events"] = sum(e.count for e in events if RECURRENCE_KERNEL in e.key)
        if rec["k1_device_events"] != calls:
            raise AssertionError(f"{name}: {rec['k1_device_events']} recurrence kernels on the "
                                 f"card for {calls} wrapper calls")
    if "k2_device_ms" in kernel_names:
        rec["k2_wrapper_calls"] = q_calls
        rec["k2_device_events"] = sum(e.count for e in events if K2_KERNEL in e.key)
        if not rec["k2_device_events"] == q_calls == 1:
            raise AssertionError(
                f"{name}: {rec['k2_device_events']} K2 kernels on the card for {q_calls} wrapper "
                f"calls, one of each expected; kernels: {[e.key for e in events]}")
    return rec, result


def profile_request(gpu, audio: np.ndarray, alphabet) -> dict:
    """Where one stt request's time goes, with the host beam decoder (the
    native one, and the Python one beside it) re-run alone on its
    emissions."""
    rec, (_, probs) = profiled("stt_with_emissions", len(audio) / gpu.sample_rate(),
                               lambda: gpu.stt_with_emissions(audio), {"k1_device_ms": RECURRENCE_KERNEL})
    rec["host_decode_ms"] = decode_timed(probs, alphabet, BEAM_WIDTH, "native")[1]
    rec["python_decode_ms"] = decode_timed(probs, alphabet, BEAM_WIDTH, "python")[1]
    print("profile", json.dumps(rec), flush=True)
    return rec


def build_scorers(work_dir: str, seed: int) -> dict:
    """Two .scorer packages made by the port's own tools from a seeded
    corpus: a 3-gram of words over LABELS, and a bytes-mode one, a 3-gram
    of characters (the words' letters run together, as for a language
    written without spaces). The estimator is lmplz's modified Kneser-Ney
    with its discount fallback (the small vocabulary leaves some counts of
    counts empty). Prints each one's build time and size."""
    from stt_tpu_torch.lm.arpa import estimate_kneser_ney_lmplz, write_arpa
    from stt_tpu_torch.tools.generate_scorer_package import create_package

    os.makedirs(work_dir, exist_ok=True)
    rs = np.random.RandomState(seed)
    weights = 1.0 / np.arange(1, len(LM_WORDS) + 1)
    words = [list(rs.choice(LM_WORDS, size=rs.randint(3, 13), p=weights / weights.sum()))
             for _ in range(LM_SENTENCES)]
    alphabet_path = os.path.join(work_dir, "alphabet.txt")
    with open(alphabet_path, "w") as f:
        f.write("".join(f"{c}\n" for c in LABELS))
    record = {}
    for mode, sentences in (("alphabet", words), ("bytes", [list("".join(s)) for s in words])):
        start = time.perf_counter()
        vocab, arpa = (os.path.join(work_dir, f"{mode}.{ext}") for ext in ("vocab", "arpa"))
        with open(vocab, "w") as f:
            f.write("\n".join(sorted({w for s in sentences for w in s})) + "\n")
        write_arpa(estimate_kneser_ney_lmplz(sentences, order=LM_ORDER, discount_fallback=True), arpa)
        path = create_package(alphabet_path if mode == "alphabet" else None, arpa, vocab,
                              os.path.join(work_dir, f"{mode}.scorer"), LM_ALPHA, LM_BETA,
                              force_bytes_output_mode=True if mode == "bytes" else None)
        record[mode] = {"path": path, "build_s": time.perf_counter() - start,
                        "package_bytes": os.path.getsize(path), "sentences": LM_SENTENCES,
                        "order": LM_ORDER}
        print("scorer", mode, json.dumps(record[mode]), flush=True)
    return record


def smoke_artifact(work_dir: str, seed: int) -> tuple:
    """The full-width DeepSpeech with random weights from `seed`, saved as
    an artifact in `work_dir`: (its config, feature config, alphabet,
    parameter count)."""
    from stt_tpu_torch.alphabet import Alphabet
    from stt_tpu_torch.artifact import build_metadata, save_artifact
    from stt_tpu_torch.frontend import FeatureConfig
    from stt_tpu_torch.models import DeepSpeech, ModelConfig

    alphabet = Alphabet().init_from_labels(LABELS)
    config = ModelConfig(n_out=len(LABELS) + 1)  # the 2048 geometry
    fc = FeatureConfig()
    model = DeepSpeech(config, generator=torch.Generator().manual_seed(seed))
    n_params = sum(p.numel() for p in model.parameters())
    save_artifact(work_dir, model, build_metadata(config, fc, alphabet, beam_width=BEAM_WIDTH), alphabet)
    return config, fc, alphabet, n_params


def serving_inputs(seed: int, fc, n_input: int) -> tuple:
    """The serving phase's seeded audio: three utterances (2.0, 3.3 and
    4.7 s) and a batch of 16 of 2-5 s as padded MFCC features. Returns
    (utterances, batch audio, padded features, lengths)."""
    from stt_tpu_torch.frontend import audio_to_mfcc

    rng = np.random.RandomState(seed)
    rate = fc.sample_rate
    audios = [utterance(s, rate, rng) for s in (2.0, 3.3, 4.7)]
    batch = [utterance(s, rate, rng) for s in rng.uniform(2.0, 5.0, size=16)]
    feats = [audio_to_mfcc(torch.from_numpy(a), fc).numpy() for a in batch]
    lengths = np.array([f.shape[0] for f in feats], np.int32)
    padded = np.zeros((16, lengths.max(), n_input), np.float32)
    for i, f in enumerate(feats):
        padded[i, : len(f)] = f
    return audios, batch, padded, lengths


HOST_DECODE = {"ms": 0.0}  # host decoder time of the streams made since it was last set to 0


def time_host_decoders() -> None:
    """Make every host decoder a stream makes add the time of its calls
    (next, next_pruned, decode) to HOST_DECODE["ms"]."""
    from stt_tpu_torch.stream import streaming

    make = streaming.make_decoder_state

    class Timed:
        def __init__(self, inner):
            self._inner = inner

        def __getattr__(self, name):
            fn = getattr(self._inner, name)
            if name not in ("next", "next_pruned", "decode"):
                return fn

            def call(*args, **kwargs):
                start = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    HOST_DECODE["ms"] += (time.perf_counter() - start) * 1e3
            return call

    streaming.make_decoder_state = lambda *args, **kwargs: Timed(make(*args, **kwargs))


def decoder_inputs(device, seed: int, work_dir: str) -> dict:
    """For the decoder phase run alone: what the serving phase hands it,
    the full-width model's emissions of the 4.7 s utterance and the
    softmax of infer_logits[B=16]."""
    from stt_tpu_torch.serve import Model

    config, fc, _, _ = smoke_artifact(work_dir, seed)
    audios, batch, padded, lengths = serving_inputs(seed, fc, config.n_input)
    gpu = Model(work_dir)
    probs16 = torch.softmax(gpu.infer_logits(padded, lengths), dim=-1).cpu().numpy()
    return {"emissions": gpu.stt_with_emissions(audios[2])[1], "probs16": probs16,
            "lengths16": lengths, "audio_s16": sum(len(a) for a in batch) / fc.sample_rate}


def peaky_probs(T: int, C: int, seed: int) -> np.ndarray:
    """Seeded emissions with one strong class a frame (blank in about half
    of them) and a rival beside it, float32 like the model's."""
    rs = np.random.RandomState(seed)
    logits = rs.randn(T, C)
    winners = np.where(rs.rand(T) < 0.5, C - 1, rs.randint(C - 1, size=T))
    logits[np.arange(T), winners] += 6.0
    logits[np.arange(T), rs.randint(C, size=T)] += rs.uniform(2.0, 5.0, size=T)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def decode_timed(probs, alphabet, beam: int, implementation: str, scorer=None, hot_words=None,
                 pruned=None, num_results: int = 1) -> tuple:
    """One decode of `probs` (or of the pruned arrays) from a fresh state:
    (its results, its milliseconds)."""
    from stt_tpu_torch.decode import make_decoder_state

    start = time.perf_counter()
    state = make_decoder_state(alphabet, beam, 1.0, 40, scorer, hot_words, implementation)
    if pruned is not None:
        state.next_pruned(*pruned)
    else:
        state.next(probs)
    results = state.decode(num_results)
    return results, (time.perf_counter() - start) * 1e3


def live(results: list) -> list:
    """The candidates whose score is finite. Under pruning a dictionary
    can leave every prefix at -inf; the order of those is no decoder's to
    keep."""
    return [r for r in results if np.isfinite(r.confidence)]


def same_results(got: list, want: list) -> bool:
    got, want = live(got), live(want)
    return len(got) == len(want) and all(
        g.tokens == w.tokens and g.timesteps == w.timesteps
        and abs(g.confidence - w.confidence) <= DECODER_CONF_TOL for g, w in zip(got, want))


def decoder_phase(device, seed: int, scorers: dict, inputs: dict) -> dict:
    """The native decoder against the port's Python DecoderState on the same
    inputs (tokens and timesteps equal, confidences within
    DECODER_CONF_TOL), each timed: the full-width model's emissions of the
    4.7 s utterance and seeded peaky ones, at beam 32 with and without the
    scorer and hot words and through next_pruned (pruned on the card), a
    bytes-mode package; then beam 500 natively against the Python decoder at
    beam 128, to say how far they grow apart; then the batch fan-out on
    infer_logits[B=16]'s softmax, native at beam 500 with the scorer, at 1
    and 16 threads."""
    from stt_tpu_torch.alphabet import Alphabet, UTF8Alphabet
    from stt_tpu_torch.decode import ctc_beam_search_decoder_batch
    from stt_tpu_torch.decode.device import prune_emissions
    from stt_tpu_torch.decode.scorer_package import KenLMScorer

    alphabet = Alphabet().init_from_labels(LABELS)
    scorer = KenLMScorer(scorers["alphabet"]["path"])
    emissions = np.asarray(inputs["emissions"], np.float32)
    sources = {"model emissions": emissions,
               "peaky random": peaky_probs(len(emissions), len(LABELS) + 1, seed)}
    holds, apart = [], []
    for source, probs in sources.items():
        # exact ties between classes in one frame (there the two decoders
        # may order candidates differently): printed, to explain a mismatch
        ties = int(sum(len(np.unique(row)) < len(row) for row in probs))
        for case, lm, cutoff in (("beam 32", False, None),
                                 ("beam 32, scorer + hot words", True, None),
                                 ("beam 32, next_pruned (top 10, 0.99)", False, (10, 0.99)),
                                 ("beam 32, next_pruned (top 20, 0.999), scorer + hot words", True,
                                  (20, 0.999))):
            pruned = None if cutoff is None else [a.cpu().numpy() for a in prune_emissions(
                torch.from_numpy(probs).to(device), cutoff_top_n=cutoff[0], cutoff_prob=cutoff[1])]
            args = dict(scorer=scorer if lm else None, hot_words=HOT_WORDS if lm else None,
                        pruned=pruned, num_results=3)
            native, native_ms = decode_timed(probs, alphabet, 32, "native", **args)
            python, python_ms = decode_timed(probs, alphabet, 32, "python", **args)
            rec = {"input": source, "case": case, "frames": len(probs), "tied_frames": ties,
                   "native_ms": native_ms, "python_ms": python_ms, "equal": same_results(native, python),
                   "live_candidates": len(live(python)), "transcript": native[0].transcript,
                   "max_conf_diff": max([abs(a.confidence - b.confidence)
                                         for a, b in zip(live(native), live(python))] or [0.0])}
            print("decoder", json.dumps(rec), flush=True)
            holds.append(rec)
        wide, wide_ms = decode_timed(probs, alphabet, 500, "native", scorer, HOT_WORDS)
        narrow, narrow_ms = decode_timed(probs, alphabet, 128, "python", scorer, HOT_WORDS)
        rec = {"input": source, "native_beam_500_ms": wide_ms, "python_beam_128_ms": narrow_ms,
               "same_transcript": wide[0].transcript == narrow[0].transcript,
               "confidence_500": wide[0].confidence, "confidence_128": narrow[0].confidence,
               "transcript_500": wide[0].transcript, "transcript_128": narrow[0].transcript}
        print("decoder beam 500 vs 128", json.dumps(rec), flush=True)
        apart.append(rec)
    # bytes mode: a character LM over UTF-8 bytes (255 labels and blank)
    utf8 = UTF8Alphabet()
    probs = peaky_probs(120, 256, seed + 1)
    bytes_scorer = KenLMScorer(scorers["bytes"]["path"])
    native, native_ms = decode_timed(probs, utf8, 16, "native", bytes_scorer, num_results=3)
    python, python_ms = decode_timed(probs, utf8, 16, "python", bytes_scorer, num_results=3)
    rec = {"input": "peaky random, 256 classes", "case": "beam 16, bytes-mode scorer",
           "frames": len(probs), "native_ms": native_ms, "python_ms": python_ms,
           "equal": same_results(native, python), "live_candidates": len(live(python)),
           "max_conf_diff": max([abs(a.confidence - b.confidence)
                                 for a, b in zip(live(native), live(python))] or [0.0])}
    print("decoder", json.dumps(rec), flush=True)
    holds.append(rec)
    failed = [r for r in holds if not r["equal"]]
    if failed:
        raise AssertionError(f"native decoder differs from the Python one: {failed}")
    if not all(r["live_candidates"] for r in holds if "next_pruned" not in r["case"]):
        raise AssertionError(f"a decode without pruning ended with no live candidate: {holds}")

    # the batch fan-out: ctypes releases the GIL around each native call
    batch = []
    audio_s = inputs["audio_s16"]
    results = {}
    for threads in (1, 16):
        start = time.perf_counter()
        results[threads] = ctc_beam_search_decoder_batch(
            inputs["probs16"], inputs["lengths16"], alphabet, 500, threads, scorer=scorer,
            hot_words=HOT_WORDS)
        ms = (time.perf_counter() - start) * 1e3
        rec = {"request": f"ctc_beam_search_decoder_batch[B=16, native, beam 500, scorer, "
                          f"num_processes {threads}]",
               "ms": ms, "audio_s": audio_s, "audio_s_per_s": audio_s / (ms / 1e3)}
        print("request", json.dumps(rec), flush=True)
        batch.append(rec)
    flat = {k: [(r[0].tokens, r[0].timesteps, r[0].confidence) for r in v] for k, v in results.items()}
    if flat[1] != flat[16]:
        raise AssertionError("batch decode at 16 threads differs from one thread")
    print(f"decoder: native == Python in {len(holds)} cases; batch 16 threads "
          f"{batch[0]['ms'] / batch[1]['ms']:.2f}x faster than 1", flush=True)
    return {"holds": holds, "beam_500_vs_128": apart, "batch": batch,
            "scorers": scorers, "conf_tol": DECODER_CONF_TOL,
            "prof_decoder": run_prof_decoder(scorers["alphabet"]["path"])}


def host_cpu() -> str:
    """The host's CPU model (or, where /proc/cpuinfo names none, its
    architecture) and its core count."""
    import platform

    with open("/proc/cpuinfo") as f:
        names = [line.split(":", 1)[1].strip() for line in f if line.startswith("model name")]
    names = [name for name in names if name != "unknown"]
    return f"{names[0] if names else platform.machine()}, {os.cpu_count()} cores"


def run_prof_decoder(scorer_path: str) -> dict:
    """The decoder's gprof driver (native/prof_decoder.cc, built at setup
    with -pg) at its own 500 frames x 10 decodes at beam 500, with the word
    scorer, in a scratch working directory (it writes gmon.out there): its
    wall seconds and the transcript line it prints on stderr."""
    from stt_tpu_torch import native_build

    scratch = os.path.join(ROOT, "build", "chip_smoke", "prof_decoder")
    shutil.rmtree(scratch, ignore_errors=True)
    os.makedirs(scratch)
    start = time.perf_counter()
    proc = subprocess.run([str(native_build.PROF_DECODER), scorer_path], cwd=scratch,
                          capture_output=True, text=True, timeout=600)
    wall_s = time.perf_counter() - start
    line = [x for x in proc.stderr.splitlines() if x.startswith("transcript[")]
    if proc.returncode != 0 or not line:
        raise AssertionError(f"prof_decoder exited {proc.returncode}: {proc.stderr[-2000:]}")
    rec = {"wall_s": wall_s, "frames": 500, "decodes": 10, "beam": 500, "scorer": "words",
           "transcript": line[0], "host": host_cpu(), "gpu": gpu_line()}
    print("prof_decoder", json.dumps(rec), flush=True)
    return rec


def host_decoder_row(gpu, name: str, fn, beam: int, scorers, emissions, audio_s: float,
                     request, requests: list, reruns: dict) -> dict:
    """One request decoded on the host by the native decoder, at `beam`,
    with the scorer and hot words when `scorers` is given: its wall time,
    RTF and host decode time (`request`), its device busy time and idle
    share (a profiled run of it), and the native and the Python decoder
    re-run alone on the same emissions, whose results it must equal.
    `reruns` keeps those re-runs by (beam, scorer) for the next request
    with the same decoder."""
    gpu.set_model_beam_width(beam)
    if scorers is not None:
        gpu.enable_external_scorer(scorers["alphabet"]["path"])
        for word, boost in HOT_WORDS.items():
            gpu.add_hot_word(word, boost)
    try:
        meta = request(name, audio_s, fn)
        timed = requests[-1]
        prof = profiled(name, audio_s, fn, {"k1_device_ms": RECURRENCE_KERNEL})[0]
        key = (beam, scorers is not None)
        if key not in reruns:
            reruns[key] = {impl: decode_timed(emissions, gpu.alphabet, beam, impl, gpu.scorer,
                                              gpu.hot_words or None)
                           for impl in ("native", "python")}
        rerun = reruns[key]
    finally:
        gpu.disable_external_scorer()
        gpu.clear_hot_words()
        gpu.set_model_beam_width(BEAM_WIDTH)
    cand = meta.transcripts[0]
    got = (cand.transcript, [gpu.alphabet.encode_single(t.text) for t in cand.tokens],
           [t.timestep for t in cand.tokens])
    for impl, (results, _) in rerun.items():
        want = results[0]
        if got != (want.transcript, want.tokens, want.timesteps) or not (
                abs(cand.confidence - want.confidence) <= DECODER_CONF_TOL):
            raise AssertionError(f"{name}: {cand} differs from the {impl} decoder's {want} "
                                 "on the same emissions")
    row = {"request": name, "beam": beam, "scorer": scorers is not None, "audio_s": audio_s,
           "ms": timed["ms"], "rtf": timed["rtf"], "host_decode_ms": timed["host_decode_ms"],
           "device_busy_ms": prof["device_busy_ms"], "device_idle_share": prof["device_idle_share"],
           "profiled_wall_ms": prof["wall_ms"], "k1_device_ms": prof["k1_device_ms"],
           "native_rerun_ms": rerun["native"][1], "python_rerun_ms": rerun["python"][1],
           "transcript": cand.transcript}
    print("host decoder", json.dumps(row), flush=True)
    return row


def counted_wrappers() -> dict:
    """Each kernel's wrapper, whose `launches` counts the kernel's launches."""
    from stt_tpu_torch.ops import beam_kernel
    from stt_tpu_torch.ops.lstm_kernel import lstm_recurrence, lstm_recurrence_q
    from stt_tpu_torch.ops.lstm_train import lstm_train_bwd, lstm_train_fwd

    return {"k1": lstm_recurrence, "k2": lstm_recurrence_q, "k3": lstm_train_fwd,
            "k4": lstm_train_bwd, "k5": beam_kernel.beam_scan}


def run_counted(name: str, fn, must: tuple) -> tuple:
    """fn() with every launch count set to 0 just before it and read just
    after, timed on the host between synchronizes: it must launch each
    kernel in `must` and none of the others. Returns (fn's result, its wall
    ms, its launches by kernel)."""
    wrappers = counted_wrappers()
    for wrapper in wrappers.values():
        wrapper.launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - start) * 1e3
    launches = {key: wrapper.launches for key, wrapper in wrappers.items()}
    for key, n in launches.items():
        if (n > 0) != (key in must):
            raise AssertionError(f"{name}: {key} launched {n} times, must launch: {must}")
    return result, ms, launches


def serving_phase(device, seed: int, work_dir: str, scorers: dict) -> dict:
    from stt_tpu_torch.decode import ctc_beam_search_decoder
    from stt_tpu_torch.decode import device as decode_device
    from stt_tpu_torch.ops.quant import apply_model_quantized, input_projection_q, qparams_to
    from stt_tpu_torch.serve import Model

    t0 = time.time()
    config, fc, alphabet, n_params = smoke_artifact(work_dir, seed)
    gpu = Model(work_dir)  # the card is the default device
    cpu = Model(work_dir, device="cpu")
    print(f"serving: {n_params} params, artifact saved and opened in {time.time() - t0:.1f} s", flush=True)
    assert gpu.device.type == "cuda" and gpu.beam_width == BEAM_WIDTH

    rate = fc.sample_rate
    audios, batch, padded, lengths = serving_inputs(seed, fc, config.n_input)
    requests = []
    time_host_decoders()

    def request(name: str, audio_s: float, fn, must=("k1",)):
        """Run one request with every launch count set to 0 just before it:
        it must launch each kernel in `must` and none of the others."""
        HOST_DECODE["ms"] = 0.0
        result, ms, launches = run_counted(f"request {name}", fn, must)
        rec = {"request": name, "audio_s": audio_s, "ms": ms, "rtf": ms / 1e3 / audio_s,
               "k1_launches": launches["k1"], "launches": launches,
               "host_decode_ms": HOST_DECODE["ms"]}
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

    logits = request("infer_logits[B=16]", sum(len(a) for a in batch) / rate,
                     lambda: gpu.infer_logits(padded, lengths))

    # ---- the host decoder: native, without and with a scorer -----------
    _, emissions = gpu.stt_with_emissions(audios[2])

    def host_stream_request():
        stream = gpu.create_stream()
        for off in range(0, len(audios[2]), piece):
            stream.feed_audio_content(audios[2][off:off + piece])
            stream.intermediate_decode()
        return stream.finish_stream_with_metadata(1)

    host_rows, reruns = [], {}
    for name, fn, beam, lm in (
        (f"stream[320ms, beam {BEAM_WIDTH}]", host_stream_request, BEAM_WIDTH, False),
        ("stream[320ms, beam 500]", host_stream_request, 500, False),
        ("stream[320ms, scorer + hot words, beam 500]", host_stream_request, 500, True),
        ("stt_with_metadata[scorer + hot words, beam 500]",
         lambda: gpu.stt_with_metadata(audios[2], 1), 500, True),
    ):
        host_rows.append(host_decoder_row(gpu, name, fn, beam, scorers if lm else None,
                                          emissions, len(audios[2]) / rate, request, requests,
                                          reruns))

    # ---- opt-in path B: decoding on the card ---------------------------
    def device_stream_request():
        stream = gpu.create_stream(device_decode=True)
        partial = []
        for off in range(0, len(audios[2]), piece):
            stream.feed_audio_content(audios[2][off:off + piece])
            partial.append(stream.intermediate_decode())
        return partial, stream.finish_stream_with_metadata(3)

    gpu.create_stream(device_decode=True).feed_audio_content(audios[0])  # warm-up
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
                 lambda: qgpu.infer_logits(padded, lengths), {"k2_device_ms": K2_KERNEL})[0],
        profiled("infer_logits[B=16]", sum(len(a) for a in batch) / rate,
                 lambda: gpu.infer_logits(padded, lengths), {"k1_device_ms": RECURRENCE_KERNEL})[0],
    ]
    for rec in profiles:
        print("profile", json.dumps(rec), flush=True)
    timed = {r["request"]: r for r in requests + profiles}
    print(f"serving: infer_logits[B=16] int8 {timed['infer_logits[B=16, int8]']['ms']:.2f} ms "
          f"(profiled: device busy {timed['infer_logits[B=16, int8] (profiled)']['device_busy_ms']} "
          f"ms, K2 {timed['infer_logits[B=16, int8] (profiled)']['k2_device_ms']} ms) against "
          f"float {timed['infer_logits[B=16]']['ms']:.2f} ms (device busy "
          f"{timed['infer_logits[B=16] (profiled)']['device_busy_ms']} ms, K1 "
          f"{timed['infer_logits[B=16] (profiled)']['k1_device_ms']} ms)", flush=True)
    print(f"serving: probs err {probs_err:.3e} (tol {PROBS_TOL}), logits err "
          f"{logits_err:.3e} (tol {LOGITS_TOL}), transcripts card == cpu: "
          f"{text_gpu == text_cpu}", flush=True)
    return {
        "profile": profile_request(gpu, audios[2], alphabet), "opt_in_profiles": profiles,
        "host_decoder": host_rows,
        "decoder_inputs": {"emissions": emissions, "probs16": probs16.cpu().numpy(),
                           "lengths16": lengths, "audio_s16": sum(len(a) for a in batch) / rate},
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


POOL_SLOTS = 8
POOL_PIECE_S = 0.32  # audio fed to each live slot per cycle: the stream cadence
POOL_RUNS = (("host slots, beam 32", False, BEAM_WIDTH), ("device-decode slots, beam 32", True,
             BEAM_WIDTH), ("device-decode slots, beam 500", True, 500))


def drive_pool(pool, audios: list, piece: int) -> tuple:
    """Staggered lifetimes: stream i (of the first POOL_SLOTS) joins at cycle
    i // 2; each cycle feeds every live stream its next `piece` samples and
    finishes the streams whose audio ran out; when the first finishes, one
    more stream takes its slot. Returns (transcripts by utterance, each
    cycle's wall ms, the slot the last stream got)."""
    streams, fed, texts, cycle_ms = {}, {}, {}, []
    waiting = list(range(len(audios)))
    reused_slot = None
    cycle = 0
    while waiting or streams:
        while waiting and waiting[0] < POOL_SLOTS and waiting[0] // 2 <= cycle:
            i = waiting.pop(0)
            streams[i], fed[i] = pool.create_stream(), 0
        start = time.perf_counter()
        for i, stream in list(streams.items()):
            stream.feed_audio_content(audios[i][fed[i]:fed[i] + piece])
            fed[i] += piece
        for i, stream in list(streams.items()):
            if fed[i] >= len(audios[i]):
                texts[i] = stream.finish_stream()
                del streams[i]
                if waiting and waiting[0] >= POOL_SLOTS:  # the extra stream reuses the slot
                    j = waiting.pop(0)
                    streams[j], fed[j] = pool.create_stream(), 0
                    reused_slot = (stream._slot, streams[j]._slot)
        torch.cuda.synchronize()
        cycle_ms.append((time.perf_counter() - start) * 1e3)
        cycle += 1
    return [texts[i] for i in range(len(audios))], cycle_ms, reused_slot


def k1_idle_rows(device, seed: int, H: int) -> dict:
    """K1 as a pool round calls it, at B = 8 slots and the full width, with
    half the rows at seq_len 0 throughout: those rows' output must be 0 and
    their state the initial one, bit for bit, and the others within K1_TOL of
    the plain version."""
    from stt_tpu_torch.models.lstm import recurrence
    from stt_tpu_torch.ops.lstm_kernel import lstm_recurrence

    gen = torch.Generator().manual_seed(seed + 9)
    w_h = ((torch.rand(H, 4 * H, generator=gen) * 2 - 1) * (6.0 / (6 * H)) ** 0.5).to(device)
    x_proj = (torch.randn(16, POOL_SLOTS, 4 * H, generator=gen) * 0.5).to(device)
    c0 = (torch.randn(POOL_SLOTS, H, generator=gen) * 0.1).to(device)
    h0 = ((torch.rand(POOL_SLOTS, H, generator=gen) * 2 - 1) * 0.1).to(device)
    seq = torch.tensor([16, 0] * (POOL_SLOTS // 2), dtype=torch.int32, device=device)
    out, (c, h) = lstm_recurrence(x_proj, w_h, c0, h0, seq)
    want, (c_ref, h_ref) = recurrence(x_proj, w_h, c0, h0, seq)
    idle = seq == 0
    if not (torch.equal(out[:, idle], torch.zeros_like(out[:, idle]))
            and torch.equal(c[idle], c0[idle]) and torch.equal(h[idle], h0[idle])):
        raise AssertionError("K1: rows at seq_len 0 moved their state or emitted")
    err = max((out - want).abs().max().item(), (c - c_ref).abs().max().item(),
              (h - h_ref).abs().max().item())
    if not err <= K1_TOL[torch.float32]:
        raise AssertionError(f"K1 with idle rows: max abs diff {err}")
    rec = {"B": POOL_SLOTS, "T": 16, "H": H, "idle_rows": int(idle.sum()),
           "idle_rows_frozen": True, "max_abs_err": err}
    print("pool k1_idle_rows", json.dumps(rec), flush=True)
    return rec


def pool_phase(device, seed: int, work_dir: str, card: str) -> dict:
    """`StreamPool` of the full-width model (random weights from `seed`) at
    S = 8 slots on the card: nine seeded utterances of 2-5 s fed in 320 ms
    pieces with staggered lifetimes (two streams join a cycle; the first to
    finish frees its slot for the ninth), with host-decoder slots at beam
    32, then device-decode slots at beam 32 and 500. Holds: every pooled
    transcript equals that audio's single-stream `Model` transcript in the
    same mode; each round (and each flush step) launches K1 once, at B = 8;
    device-decode runs launch K5 and host runs do not; K1 at B = 8 with
    slots at seq_len 0 keeps their state and emits 0 (`k1_idle_rows`).
    Records rounds, K1 launches a round, K5 calls a round, wall ms a cycle
    against the 320 ms cadence, and one profiled round's device busy time
    and idle share."""
    from torch.profiler import ProfilerActivity

    from stt_tpu_torch.serve import Model, StreamPool

    config, fc, alphabet, n_params = smoke_artifact(work_dir, seed)
    frozen = k1_idle_rows(device, seed, config.n_cell_dim)
    gpu = Model(work_dir)
    rate = fc.sample_rate
    piece = int(POOL_PIECE_S * rate)
    rng = np.random.RandomState(seed + 5)
    audios = [utterance(sec, rate, rng) for sec in rng.uniform(2.0, 5.0, size=POOL_SLOTS + 1)]
    audio_s = sum(len(a) for a in audios) / rate
    gpu.stt(audios[0][: rate // 2])  # warm-up
    runs, launches_total = [], {"k1": 0, "k5": 0}
    for name, device_decode, beam in POOL_RUNS:
        gpu.set_model_beam_width(beam)
        pool = StreamPool(gpu, max_streams=POOL_SLOTS, device_decode=device_decode)
        calls = {"rounds": 0, "flush_steps": 0}
        fused, run_infer = pool.fused_round, pool._run_infer

        def counted_round(*args, fused=fused, calls=calls):
            calls["rounds"] += 1
            return fused(*args)

        def counted_flush(*args, run_infer=run_infer, calls=calls):
            calls["flush_steps"] += 1
            return run_infer(*args)

        pool.fused_round, pool._run_infer = counted_round, counted_flush
        (texts, cycle_ms, reused), wall_ms, launches = run_counted(
            f"pool {name}", lambda: drive_pool(pool, audios, piece),
            ("k1", "k5") if device_decode else ("k1",))
        steps = calls["rounds"] + calls["flush_steps"]
        if launches["k1"] != steps:
            raise AssertionError(f"pool {name}: {launches['k1']} K1 launches for {steps} rounds "
                                 "and flush steps, one each expected")
        if reused is None or reused[0] != reused[1]:
            raise AssertionError(f"pool {name}: the ninth stream did not reuse a freed slot: {reused}")
        singles = []
        for audio in audios:
            stream = gpu.create_stream(device_decode=device_decode)
            for off in range(0, len(audio), piece):
                stream.feed_audio_content(audio[off:off + piece])
            singles.append(stream.finish_stream())
        if texts != singles:
            raise AssertionError(f"pool {name}: pooled transcripts {texts} differ from single "
                                 f"streams' {singles}")
        rec = {"run": name, "slots": POOL_SLOTS, "beam": beam, "streams": len(audios),
               "audio_s": audio_s, "wall_ms": wall_ms, "rtf": wall_ms / 1e3 / audio_s,
               "rounds": calls["rounds"], "flush_steps": calls["flush_steps"],
               "launches": launches, "k1_launches_per_round": launches["k1"] / steps,
               "k5_calls_per_round": launches["k5"] / steps, "cycles": len(cycle_ms),
               "cycle_ms_mean": float(np.mean(cycle_ms)), "cycle_ms_median": float(np.median(cycle_ms)),
               "cycle_ms_max": float(np.max(cycle_ms)), "cadence_ms": POOL_PIECE_S * 1e3,
               "transcripts_equal_single_streams": True, "reused_slot": reused[0]}
        print("pool", json.dumps(rec), flush=True)
        runs.append(rec)
        for key in launches_total:
            launches_total[key] += launches[key]

    # one steady round of 8 primed host slots under the profiler
    gpu.set_model_beam_width(BEAM_WIDTH)
    pool = StreamPool(gpu, max_streams=POOL_SLOTS)
    streams = [pool.create_stream() for _ in range(POOL_SLOTS)]
    chunk = pool._chunk_samples
    for i, stream in enumerate(streams):
        stream.feed_audio_content(audios[i][:chunk])
    offsets = [chunk] * POOL_SLOTS

    def one_round():
        for i, stream in enumerate(streams):
            stream.feed_audio_content(audios[i][offsets[i]:offsets[i] + 16 * fc.step_samples])
            offsets[i] += 16 * fc.step_samples

    one_round()  # warm: the round after the priming one emits
    _, round_ms, events = device_profile(one_round, [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                         [RECURRENCE_KERNEL])
    busy = sum(e.self_device_time_total for e in events) / 1e3
    k1 = sum(e.self_device_time_total for e in events if RECURRENCE_KERNEL in e.key) / 1e3
    k1_events = sum(e.count for e in events if RECURRENCE_KERNEL in e.key)
    if k1_events != 1:
        raise AssertionError(f"a profiled round showed {k1_events} K1 kernels, 1 expected")
    profile = {"round_wall_ms": round_ms, "device_busy_ms": busy, "k1_device_ms": k1,
               "device_idle_share": 1 - busy / round_ms, "k1_events": k1_events,
               "top_kernels": [(e.key[:80], e.self_device_time_total / 1e3, e.count) for e in
                               sorted(events, key=lambda e: -e.self_device_time_total)[:6]]}
    print("pool_profile", json.dumps(profile), flush=True)
    return {"runs": runs, "profile": profile, "launches": launches_total, "params": n_params,
            "k1_idle_rows": frozen, "gpu": card}


AUGMENT_TOL = 2e-3  # on-card features vs the CPU pass, absolute and relative (see augment_phase)


def augment_phase(device, seed: int, work_dir: str, card: str) -> dict:
    """`train(config)` of the full-width model on the card with
    --graph_augs_on_device: the input phase's sources and augmentations
    (FLAC, 8 kHz SPHERE, SDB, tar; every augmentation, codec where libopus
    loads), B = 16, one epoch, 8 input workers. Every step launches K3 and
    K4. Then one batch's drawn parameters through the device pass on the
    card and on the CPU: lengths equal, features within AUGMENT_TOL (float32
    products of the MFCC summed in another order on the card; the chain's
    interpolations are the same operations), with the random family's
    gates (dropout, add, multiply) closed, since the CPU and CUDA generators
    give different noise; with them open the card's pass must repeat bit
    for bit. Records the steps, the device pass's time, the train step's
    audio-s/s with it, and the host featurize rate of the spectrogram path
    beside the host path's (all augmentations on the host, as in the input
    phase), serial and on 8 threads."""
    from stt_tpu_torch.alphabet import Alphabet
    from stt_tpu_torch.config import SttConfig
    from stt_tpu_torch.data.augmentations import Add, Dropout, Multiply, parse_augmentations
    from stt_tpu_torch.data.device_augment import DeviceAugmentPipeline
    from stt_tpu_torch.data.feeding import create_batches
    from stt_tpu_torch.data.opus import opus_available
    from stt_tpu_torch.frontend import FeatureConfig
    from stt_tpu_torch.train import Batch, make_train_step
    from stt_tpu_torch.train.trainer import train

    rng = np.random.RandomState(seed + 7)
    paths = write_input_dataset(os.path.join(work_dir, "data"), rng)
    codec = opus_available()
    augment = [a.format(noise=paths["noise"]) for a in INPUT_AUGMENT] + ([INPUT_CODEC] if codec else [])
    sources = [paths["csv"], paths["sdb"], paths["tar"]]
    summary = os.path.join(work_dir, "summary")
    shutil.rmtree(summary, ignore_errors=True)
    config = SttConfig(
        train_files=sources, alphabet_config_path=paths["alphabet"], n_hidden=2048,
        train_batch_size=16, epochs=1, dropout_rate=0.05, augment=augment,
        graph_augs_on_device=True, input_workers=8, prefetch_batches=2, summary_dir=summary,
        seed=seed,
    )
    state, train_ms, launches = run_counted("augment: train with --graph_augs_on_device",
                                            lambda: train(config, device="cuda"), ("k3", "k4"))
    steps = state.step
    if not launches["k3"] == launches["k4"] == steps == 3:
        raise AssertionError(f"every step must launch K3 and K4 (a dummy step and 2): "
                             f"{launches}, {steps} steps")
    with open(os.path.join(summary, "scalars.jsonl")) as f:
        losses = [r["train/step_loss"] for r in map(json.loads, f) if "train/step_loss" in r]
    if len(losses) != 2 or not np.isfinite(losses).all():
        raise AssertionError(f"train step losses: {losses}")

    alphabet, fc = Alphabet(paths["alphabet"]), FeatureConfig()
    augs = parse_augmentations(augment)
    pipeline = DeviceAugmentPipeline(augs, fc)
    batch, ids, params = next(create_batches(sources, alphabet, fc, batch_size=16,
                                             augmentations=augs, train_phase=True,
                                             device_augment=pipeline))
    closed = [dict(p, active=np.zeros_like(p["active"]))
              if isinstance(aug, (Dropout, Add, Multiply)) else p
              for (aug, _), p in zip(pipeline.chain, params)]
    on_card = pipeline.apply(batch.features.to(device), batch.feature_lengths.to(device), closed)
    on_cpu = pipeline.apply(batch.features, batch.feature_lengths, closed)
    if not torch.equal(on_card[1].cpu(), on_cpu[1]):
        raise AssertionError(f"augment: lengths on the card {on_card[1].tolist()} differ from the "
                             f"CPU's {on_cpu[1].tolist()}")
    err = (on_card[0].cpu() - on_cpu[0]).abs()
    worst = float((err - AUGMENT_TOL * on_cpu[0].abs()).max())
    max_abs = float(err.max())
    if not worst <= AUGMENT_TOL:
        raise AssertionError(f"augment: on-card features differ from the CPU pass by {max_abs}")
    full = [pipeline.apply(batch.features.to(device), batch.feature_lengths.to(device), params)
            for _ in range(2)]
    if not (torch.equal(full[0][0], full[1][0]) and torch.equal(full[0][1], full[1][1])):
        raise AssertionError("augment: the card's pass with the random family does not repeat")
    active = {type(aug).__name__: int(p["active"].sum()) for (aug, _), p in zip(pipeline.chain, params)}
    spec = batch.features.to(device)
    lens = batch.feature_lengths.to(device)
    pass_ms = cuda_ms(lambda: pipeline.apply(spec, lens, params), 10)
    step = make_train_step()
    labels = batch.to(device)

    def augmented_step():
        feats, new_lens = pipeline.apply(spec, lens, params)
        step(state, Batch(feats, new_lens, labels.labels, labels.label_lengths), seed)

    augmented_step()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(3):
        augmented_step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - start) * 1e3 / 3
    batch_audio_s = float(batch.feature_lengths.sum()) * fc.step_samples / fc.sample_rate

    def spectrogram_epoch(workers: int) -> tuple:
        start, audio_s = time.perf_counter(), 0.0
        for b, _, _ in create_batches(sources, alphabet, fc, batch_size=16, augmentations=augs,
                                      train_phase=True, epoch=1, total_epochs=3,
                                      num_workers=workers, prefetch=2 if workers else 0,
                                      device_augment=pipeline):
            audio_s += float(b.feature_lengths.sum()) * fc.step_samples / fc.sample_rate
        return time.perf_counter() - start, audio_s

    no_overlay = [a for a in augment if not a.startswith("overlay")]
    rates = {}
    for workers in (0, 8):
        seconds, audio_s = spectrogram_epoch(workers)
        rates[f"spectrogram_path_{workers}_workers_audio_s_per_s"] = audio_s / seconds
        _, host_s, host_audio_s = featurize_epoch(sources, alphabet, fc, no_overlay, workers)
        rates[f"host_path_{workers}_workers_audio_s_per_s"] = host_audio_s / host_s
    rec = {"steps": steps, "train_ms": train_ms, "launches": launches, "losses": losses,
           "batch": {"B": int(spec.shape[0]), "T": int(spec.shape[1]), "audio_s": batch_audio_s},
           "active_rows": active, "card_vs_cpu_max_abs": max_abs, "tol": AUGMENT_TOL,
           "device_pass_ms": pass_ms, "augmented_step_ms": step_ms,
           "augmented_step_audio_s_per_s": batch_audio_s / (step_ms / 1e3), **rates,
           "codec": codec, "host_cpus": os.cpu_count(), "gpu": card}
    print("augment", json.dumps(rec), flush=True)
    return rec


PARALLEL_RANKS = 2
PARALLEL_TIMEOUT_S = 400  # each rank's own limit; the phase kills the ranks past it
# the two ranks' losses against one rank on the global batch: the same
# float32 terms, but each rank's products run at 8 rows where one rank runs
# 16 (other GEMM tilings), and Adam moves every parameter by about lr
# whatever its gradient's size, so the rounding drifts the next steps apart
PARALLEL_LOSS_RTOL = 1e-3


def parallel_config(paths: dict, seed: int, work_dir: str, **kw):
    from stt_tpu_torch.config import SttConfig

    return SttConfig(
        train_files=[paths["train"]], dev_files=[paths["dev"]],
        alphabet_config_path=paths["alphabet"], n_hidden=2048, train_batch_size=16,
        dev_batch_size=4, epochs=1, dropout_rate=0.0, seed=seed, input_workers=0,
        prefetch_batches=0, summary_dir=os.path.join(work_dir, "summary"), **kw)


def timed_training(config, name: str = "parallel: train", factory: str = "make_train_step",
                   must: tuple = ("k1", "k3", "k4"), first_grads: dict = None) -> tuple:
    """train(config) on the card with every step's loss, wall ms (the step
    ends in a synchronize) and bytes staged through the host for gloo's
    collectives recorded, and the launch counts set to 0 just before and
    read just after. `factory` names the trainer's step maker to time
    (make_train_step_tp under --n_model_parallel); `must`, the kernels it
    must launch. With `first_grads`, the gradients of the first step (the
    ones Adam took; under tensor parallelism gathered over the model ranks)
    are put into it. Returns (record, the state train returns)."""
    from stt_tpu_torch.parallel import distributed
    from stt_tpu_torch.train import trainer

    made = getattr(trainer, factory)
    losses, grad_norms, step_ms, staged = [], [], [], []

    def timed(*args, **kw):
        inner = made(*args, **kw)
        mesh = args[1] if factory == "make_train_step_tp" else None

        def train_step(state, batch, seed=0):
            torch.cuda.synchronize()
            start = time.perf_counter()
            before = distributed.staged_bytes[0]
            state, metrics = inner(state, batch, seed)
            losses.append(metrics.loss.item())
            grad_norms.append(metrics.grad_norm.item())
            step_ms.append((time.perf_counter() - start) * 1e3)
            staged.append(distributed.staged_bytes[0] - before)
            if first_grads is not None and len(losses) == 1:
                first_grads.update(step_gradients(state, mesh))
            return state, metrics
        return train_step

    setattr(trainer, factory, timed)
    try:
        state, ms, launches = run_counted(name, lambda: trainer.train(config, "cuda"), must)
    finally:
        setattr(trainer, factory, made)
    dev = None  # rank 0 alone writes the scalars
    if os.path.exists(os.path.join(config.summary_dir, "scalars.jsonl")):
        with open(os.path.join(config.summary_dir, "scalars.jsonl")) as f:
            dev = [r["dev/loss"] for r in map(json.loads, f) if "dev/loss" in r]
    return {"losses": losses, "grad_norms": grad_norms, "step_ms": step_ms,
            "staged_bytes": staged, "train_ms": ms,
            "launches": launches, "dev_loss": dev, "steps": state.step}, state


def step_gradients(state, mesh) -> dict:
    """The gradients the last step left on the state's parameters (cloned);
    with a mesh, gathered over its model ranks (a collective)."""
    from stt_tpu_torch.models.deepspeech import param_shapes
    from stt_tpu_torch.parallel import gather_params

    grads = {k: p.grad.detach().clone() for k, p in state.model.named_parameters()}
    if mesh is None:
        return grads
    return gather_params(grads, mesh, param_shapes(state.model.config))


def parallel_rank(rank: int, port: int, work_dir: str, seed: int) -> int:
    """One rank of the parallel phase, in a process of its own: joins the
    group of PARALLEL_RANKS over gloo (NCCL refuses two ranks on one card)
    with its tensors on the one card, trains, and writes its record."""
    sys.path.insert(0, ROOT)
    from stt_tpu_torch.parallel import distributed

    with open(os.path.join(work_dir, "paths.json")) as f:
        paths = json.load(f)
    distributed.initialize(f"localhost:{port}", PARALLEL_RANKS, rank, backend="gloo",
                           device="cuda")
    rec, _ = timed_training(parallel_config(paths, seed, os.path.join(work_dir, f"rank{rank}")))
    rec["rank"] = rank
    with open(os.path.join(work_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def parallel_phase(device, seed: int, work_dir: str, card: str) -> dict:
    """Data parallelism on the one card: two ranks (processes of this
    script, gloo passed to `initialize`, their tensors on the card) train
    the full-width model for one epoch of 32 seeded utterances at B = 16,
    8 rows a rank, dropout 0, with dev losses merged; then one rank trains
    the same on the global batch. Holds: the ranks' losses are equal to
    each other and, within PARALLEL_LOSS_RTOL, to the one rank's, and so is
    the merged dev loss that rank 0 writes (dev batches of 4: one for each
    rank); only rank 0 writes scalars; every rank's
    step launches K3 and K4. Records the step ms of both. Then a group of
    one rank on NCCL: two steps, whose first loss must equal the same step's
    without a group (a sum over one rank changes nothing)."""
    from stt_tpu_torch.alphabet import Alphabet
    from stt_tpu_torch.data.feeding import create_batches
    from stt_tpu_torch.frontend import FeatureConfig
    from stt_tpu_torch.parallel import distributed
    from stt_tpu_torch.train import create_train_state, make_train_step

    shutil.rmtree(work_dir, ignore_errors=True)
    os.makedirs(work_dir)
    fc = FeatureConfig()
    paths = write_dataset(os.path.join(work_dir, "data"), np.random.RandomState(seed + 1),
                          fc.sample_rate)
    with open(os.path.join(work_dir, "paths.json"), "w") as f:
        json.dump(paths, f)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--seed", str(seed),
                               "--parallel-rank", str(r), "--parallel-port", str(port),
                               "--parallel-dir", work_dir], cwd=ROOT)
             for r in range(PARALLEL_RANKS)]
    try:
        for proc in procs:
            proc.wait(timeout=PARALLEL_TIMEOUT_S)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if any(proc.returncode != 0 for proc in procs):
        raise AssertionError(f"parallel: ranks exited {[p.returncode for p in procs]}")
    ranks = []
    for r in range(PARALLEL_RANKS):
        with open(os.path.join(work_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    one, _ = timed_training(parallel_config(paths, seed, os.path.join(work_dir, "one")))
    failures = []
    if ranks[0]["losses"] != ranks[1]["losses"] or ranks[1]["dev_loss"] is not None:
        failures.append(f"the ranks' losses differ: {[r['losses'] for r in ranks]}")
    if not (len(ranks[0]["losses"]) == len(one["losses"]) == 3 and np.allclose(
            ranks[0]["losses"], one["losses"], rtol=PARALLEL_LOSS_RTOL, atol=0)):
        failures.append(f"two ranks' losses {ranks[0]['losses']} vs one rank's {one['losses']}")
    if not (len(one["dev_loss"]) == 1 and np.allclose(ranks[0]["dev_loss"], one["dev_loss"],
                                                       rtol=PARALLEL_LOSS_RTOL, atol=0)):
        failures.append(f"dev losses {ranks[0]['dev_loss']} vs {one['dev_loss']}")
    for rec in ranks:
        if not rec["launches"]["k3"] == rec["launches"]["k4"] == rec["steps"] == 3:
            failures.append(f"rank {rec['rank']}: every step must launch K3 and K4: {rec['launches']}")
    loss_rel = float(np.max(np.abs(np.array(ranks[0]["losses"]) / np.array(one["losses"]) - 1)))

    # a group of one rank on NCCL: the collectives run, and change nothing
    alphabet = Alphabet(paths["alphabet"])
    batch, _ = next(create_batches([paths["train"]], alphabet, fc, batch_size=16, reverse=True,
                                   limit=16))
    batch = batch.to(device)
    model_config = parallel_config(paths, seed, work_dir).model_config(training=True)
    nccl = {}
    for grouped in (False, True):
        if grouped:
            distributed.initialize(f"localhost:{free_port()}", 1, 0, backend="nccl", device="cuda")
        try:
            state = create_train_state(model_config, seed=seed, device=device)
            step = make_train_step()
            losses, ms = [], []
            for _ in range(2):
                torch.cuda.synchronize()
                start = time.perf_counter()
                _, metrics = step(state, batch, seed)
                losses.append(metrics.loss.item())
                ms.append((time.perf_counter() - start) * 1e3)
            nccl["nccl" if grouped else "no_group"] = {"losses": losses, "step_ms": ms,
                                                      "backend": torch.distributed.get_backend()
                                                      if grouped else None}
        finally:
            if grouped:
                torch.distributed.destroy_process_group()
    # the first step from the same weights is equal bit for bit; the CTC
    # loss's backward sums by atomics, so the second may differ in its last bits
    got, want = nccl["nccl"]["losses"], nccl["no_group"]["losses"]
    if got[0] != want[0] or not np.isclose(got[1], want[1], rtol=1e-5, atol=0):
        failures.append(f"one-rank NCCL steps {nccl}")
    rec = {"ranks": PARALLEL_RANKS, "backend": "gloo, two ranks on one card", "rank_records": ranks,
           "one_rank": one, "loss_rel_err_vs_one_rank": loss_rel, "tol": PARALLEL_LOSS_RTOL,
           "nccl_one_rank": nccl, "gpu": card,
           "launches": {k: sum(r["launches"][k] for r in ranks) for k in ("k1", "k3", "k4")}}
    shown = {k: v for k, v in rec.items() if k != "rank_records"}
    shown["rank_step_ms"] = [r["step_ms"] for r in ranks]
    shown["rank_launches"] = [r["launches"] for r in ranks]
    print("parallel", json.dumps(shown), flush=True)
    if failures:
        raise AssertionError("parallel phase: " + "; ".join(failures))
    return rec


class BitWriter:
    """MSB-first bits, as FLAC writes them."""

    def __init__(self):
        self.parts = []

    def put(self, value: int, bits: int) -> None:
        if bits:
            self.parts.append(format(value & ((1 << bits) - 1), f"0{bits}b"))

    def put_rice(self, value: int, k: int) -> None:
        u = 2 * value if value >= 0 else -2 * value - 1  # zigzag
        self.parts.append("0" * (u >> k) + "1" + (format(u & ((1 << k) - 1), f"0{k}b") if k else ""))

    def bytes(self) -> bytes:
        bits = "".join(self.parts)
        bits += "0" * (-len(bits) % 8)  # zero-padded to a byte
        return int(bits, 2).to_bytes(len(bits) // 8, "big") if bits else b""


def _crc(data: bytes, bits: int, poly: int) -> int:
    crc, top, mask = 0, 1 << (bits - 1), (1 << bits) - 1
    for byte in data:
        crc ^= byte << (bits - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly if crc & top else crc << 1) & mask
    return crc


FLAC_RATE_CODES = {8000: 4, 16000: 5, 22050: 6, 24000: 7, 32000: 8, 44100: 9, 48000: 10}
FLAC_FIXED = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def write_flac(path: str, audio: np.ndarray, rate: int, order=2, block: int = 4096) -> None:
    """16-bit mono FLAC: per frame a FIXED subframe of `order` (0-4) whose
    residuals are Rice-coded in one partition, or a VERBATIM subframe when
    order is None; frame headers with CRC-8, frames with CRC-16, STREAMINFO
    without MD5. A small encoder for seeded fixtures."""
    pcm = np.clip(np.asarray(audio) * 32768.0, -32768, 32767).astype(np.int64)
    info = BitWriter()
    for value, bits in ((block, 16), (block, 16), (0, 24), (0, 24), (rate, 20), (0, 3),
                        (15, 5), (len(pcm), 36)):
        info.put(value, bits)
    out = [b"fLaC", bytes([0x80, 0, 0, 34]), info.bytes() + bytes(16)]
    for index, start in enumerate(range(0, len(pcm), block)):
        x = pcm[start:start + block]
        head = BitWriter()
        head.put(0xFFF8, 16)  # sync, reserved, fixed block size
        head.put(12 if len(x) == block else 7, 4)  # 4096, or 16 bits of size - 1 below
        head.put(FLAC_RATE_CODES.get(rate, 0), 4)
        head.put(0, 4)  # mono
        head.put(4, 3)  # 16 bits a sample
        head.put(0, 1)
        if index < 0x80:
            head.put(index, 8)
        else:  # two-byte UTF-8 frame number
            head.put(0xC0 | (index >> 6), 8)
            head.put(0x80 | (index & 0x3F), 8)
        if len(x) != block:
            head.put(len(x) - 1, 16)
        header = head.bytes()
        body = BitWriter()
        body.put(0, 1)
        if order is None or len(x) <= order:
            body.put(1, 6)  # VERBATIM
            body.put(0, 1)
            for v in x.tolist():
                body.put(v, 16)
        else:
            body.put(8 + order, 6)  # FIXED
            body.put(0, 1)
            for v in x[:order].tolist():
                body.put(v, 16)
            pred = np.zeros(len(x) - order, np.int64)
            for i, c in enumerate(FLAC_FIXED[order]):
                pred += c * x[order - 1 - i:len(x) - 1 - i]
            residual = (x[order:] - pred).tolist()
            mean = float(np.mean(np.abs(residual))) if residual else 0.0
            k = min(14, max(0, int(np.log2(mean + 1))))
            body.put(0, 2)  # 4-bit Rice parameters
            body.put(0, 4)  # one partition
            body.put(k, 4)
            for r in residual:
                body.put_rice(r, k)
        frame = header + bytes([_crc(header, 8, 0x07)]) + body.bytes()
        out.append(frame + _crc(frame, 16, 0x8005).to_bytes(2, "big"))
    with open(path, "wb") as f:
        f.write(b"".join(out))


SMOKE_TRANSCRIPT = "she had your dark suit in greasy wash water all year"
SMOKE_SAMPLES = 46797  # LDC93S1's length: a 93,638-byte WAV, as the scripts' CSVs say
RU_TRANSCRIPT = "бедняга ребят на его месте должен был быть я"
RU_SECONDS = 4.0
SMOKE_OGG = os.path.join(ROOT, "tests", "fixtures", "LDC93S1.ogg")  # spoken(SMOKE_TRANSCRIPT, ...)
SMOKE_LM_SENTENCES = 1000


def spoken(text: str, rate: int, samples: int) -> np.ndarray:
    """A learnable stand-in for a recording of `text`: after 0.1 s of
    quiet, one 85%-voiced segment per character, all of equal length, a
    tone with two harmonics whose pitch is set by the character's class
    (its rank among the text's distinct characters); a space is a pause.
    Faint noise throughout, from a fixed seed, so the same text gives the
    same samples."""
    classes = {c: i for i, c in enumerate(sorted(set(text) - {" "}))}
    lead = int(0.1 * rate)
    per = (samples - 2 * lead) // len(text)
    voiced = int(per * 0.85)
    audio = 0.003 * np.random.RandomState(0).randn(samples)
    t = np.arange(voiced) / rate
    ramp = np.arange(voiced)
    fade = np.minimum(1.0, np.minimum(ramp, ramp[::-1]) / (0.005 * rate))
    for i, c in enumerate(text):
        if c == " ":
            continue
        f0 = 140.0 * 2 ** (classes[c] / 8)
        tone = sum(a * np.sin(2 * np.pi * f0 * m * t) for m, a in ((1, 0.5), (2, 0.25), (3, 0.12)))
        start = lead + i * per
        audio[start:start + voiced] += tone * fade
    return np.clip(audio, -1, 1).astype(np.float32)


def write_smoke_set(root: str, seed: int) -> dict:
    """The reference's data/ layout for the port's bin/ scripts, with
    learnable stand-ins for its recordings: root/alphabet.txt (LABELS) and
    root/smoke_test/ with LDC93S1.wav/.txt and ldc93s1.csv (the sentence
    spoken by `spoken`, 46,797 samples as the original), ldc93s1_flac.csv
    (a FLAC by write_flac), ldc93s1_vorbis.csv (the committed
    tests/fixtures/LDC93S1.ogg, the same utterance: the card's host may
    lack libvorbisenc), pruned_lm.scorer (a 3-gram of seeded sentences over
    LM_WORDS and the smoke sentence, built by the port's LM tools as
    build_scorers builds one) and russian_sample_data/ru.csv (its Cyrillic
    sentence spoken the same way, 4 s). Returns {"smoke": dir, "alphabet":
    path}."""
    from stt_tpu_torch.data.audio import write_wav
    from stt_tpu_torch.lm.arpa import estimate_kneser_ney_lmplz, write_arpa
    from stt_tpu_torch.tools.generate_scorer_package import create_package

    rate = 16000
    smoke = os.path.join(root, "smoke_test")
    ru_dir = os.path.join(smoke, "russian_sample_data")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(ru_dir)
    alphabet = os.path.join(root, "alphabet.txt")
    with open(alphabet, "w") as f:
        f.write("".join(f"{c}\n" for c in LABELS))
    audio = spoken(SMOKE_TRANSCRIPT, rate, SMOKE_SAMPLES)
    write_wav(os.path.join(smoke, "LDC93S1.wav"), audio, rate)
    write_flac(os.path.join(smoke, "LDC93S1.flac"), audio, rate)
    shutil.copy(SMOKE_OGG, os.path.join(smoke, "LDC93S1.ogg"))
    with open(os.path.join(smoke, "LDC93S1.txt"), "w") as f:
        f.write(f"0 {SMOKE_SAMPLES} {SMOKE_TRANSCRIPT.capitalize()}.\n")
    for csv, name in (("ldc93s1.csv", "LDC93S1.wav"), ("ldc93s1_flac.csv", "LDC93S1.flac"),
                      ("ldc93s1_vorbis.csv", "LDC93S1.ogg")):
        size = os.path.getsize(os.path.join(smoke, name))
        with open(os.path.join(smoke, csv), "w") as f:
            f.write(f"wav_filename,wav_filesize,transcript\n{name},{size},{SMOKE_TRANSCRIPT}\n")
    write_wav(os.path.join(ru_dir, "ru.wav"), spoken(RU_TRANSCRIPT, rate, int(RU_SECONDS * rate)),
              rate)
    with open(os.path.join(ru_dir, "ru.csv"), "w", encoding="utf-8") as f:
        size = os.path.getsize(os.path.join(ru_dir, "ru.wav"))
        f.write(f"wav_filename,wav_filesize,transcript\nru.wav,{size},{RU_TRANSCRIPT}\n")
    rs = np.random.RandomState(seed)
    weights = 1.0 / np.arange(1, len(LM_WORDS) + 1)
    sentences = [list(rs.choice(LM_WORDS, size=rs.randint(3, 13), p=weights / weights.sum()))
                 for _ in range(SMOKE_LM_SENTENCES)] + [SMOKE_TRANSCRIPT.split()] * 10
    vocab, arpa = (os.path.join(root, f"lm.{ext}") for ext in ("vocab", "arpa"))
    with open(vocab, "w") as f:
        f.write("\n".join(sorted({w for s in sentences for w in s})) + "\n")
    write_arpa(estimate_kneser_ney_lmplz(sentences, order=LM_ORDER, discount_fallback=True), arpa)
    create_package(alphabet, arpa, vocab, os.path.join(smoke, "pruned_lm.scorer"), LM_ALPHA,
                   LM_BETA)
    return {"smoke": smoke, "alphabet": alphabet}


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
                writer.add(Sample(f"{split}{i}", transcript(seconds, rng),
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
    k4 = device_ms(lambda k: BWD_KERNEL in k)
    k4_events = sum(e.count for e in events if BWD_KERNEL in e.key)
    if busy and k4_events != 1:
        raise AssertionError(f"one train step showed {k4_events} K4 kernels on the card, not 1")
    gemm = device_ms(lambda k: any(s in k.lower() for s in ("gemm", "cutlass", "sm90_xmma")))
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    rec = {
        **phases, "profiled_wall_ms": wall_ms, "device_busy_ms": busy or None,
        "k3_device_ms": k3 or None, "k3_device_events": k3_events,
        "k4_device_ms": k4 or None, "k4_device_events": k4_events, "gemm_device_ms": gemm or None,
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
    rec["paths"] = {**paths, "checkpoints": ckpt}
    return rec


def write_input_dataset(data_dir: str, rng: np.random.RandomState) -> dict:
    """32 seeded utterances of 2-5 s over the 28 labels: 8 FLAC at 16 kHz
    (write_flac, FIXED subframes of order 0-4 and one VERBATIM) and 8 mu-law
    SPHERE at 8 kHz (the port's write_sph) in a CSV; 8 WAV at 8 kHz in an SDB
    (the port's SDBWriter); 8 WAV at 8 kHz in a webdataset tar (.wav and .txt
    members: the tar source reads WAV members, in stt_tpu as in the port);
    and the overlay's noise, a second seeded SDB."""
    import io
    import tarfile
    import wave

    from stt_tpu_torch.data.sources import Sample, SDBWriter
    from stt_tpu_torch.data.sph import write_sph

    shutil.rmtree(data_dir, ignore_errors=True)
    os.makedirs(data_dir)
    paths = {"alphabet": os.path.join(data_dir, "alphabet.txt"),
             "csv": os.path.join(data_dir, "mixed.csv"), "sdb": os.path.join(data_dir, "wav8k.sdb"),
             "tar": os.path.join(data_dir, "wav8k.tar"), "noise": os.path.join(data_dir, "noise.sdb")}
    with open(paths["alphabet"], "w") as f:
        f.write("".join(label + "\n" for label in LABELS))

    def utterances(n: int, rate: int):
        for _ in range(n):
            seconds = rng.uniform(2.0, 5.0)
            words = " ".join("".join(rng.choice(LABELS[1:], rng.randint(2, 7)))
                             for _ in range(rng.randint(3, 9)))[: int(seconds * 8)]
            yield words.strip() or "a", utterance(seconds, rate, rng)

    rows = []
    for i, (text, audio) in enumerate(utterances(8, 16000)):
        name = f"flac{i}.flac"
        write_flac(os.path.join(data_dir, name), audio, 16000, order=None if i == 7 else i % 5)
        rows.append((name, text))
    for i, (text, audio) in enumerate(utterances(8, 8000)):
        name = f"sph{i}.sph"
        write_sph(os.path.join(data_dir, name), audio, 8000, coding="ulaw")
        rows.append((name, text))
    with open(paths["csv"], "w") as f:
        f.write("wav_filename,wav_filesize,transcript\n")
        for name, text in rows:
            f.write(f"{name},{os.path.getsize(os.path.join(data_dir, name))},{text}\n")
    with SDBWriter(paths["sdb"]) as writer:
        for i, (text, audio) in enumerate(utterances(8, 8000)):
            writer.add(Sample(f"sdb{i}", text, _audio=audio, _rate=8000))
    with tarfile.open(paths["tar"], "w") as tar:
        for i, (text, audio) in enumerate(utterances(8, 8000)):
            wav = io.BytesIO()
            with wave.open(wav, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(8000)
                w.writeframes(np.clip(audio * 32768.0, -32768, 32767).astype(np.int16).tobytes())
            for member, data in ((f"tar{i}.wav", wav.getvalue()), (f"tar{i}.txt", text.encode())):
                info = tarfile.TarInfo(member)
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
    with SDBWriter(paths["noise"]) as writer:
        for i in range(4):
            noise = (0.1 * rng.randn(int(rng.uniform(1.0, 3.0) * 16000))).astype(np.float32)
            writer.add(Sample(f"noise{i}", "noise", _audio=noise, _rate=16000))
    return paths


def featurize_epoch(sources: list, alphabet, fc, augment: list, workers: int) -> tuple:
    """One training epoch's batches (B = 16, epoch 1 of 3) featurized on the
    host with `workers` threads (0: serially), from freshly read sources:
    (batches as numpy arrays with their ids, seconds, audio-seconds)."""
    from stt_tpu_torch.data.augmentations import parse_augmentations
    from stt_tpu_torch.data.feeding import create_batches

    out, audio_s = [], 0.0
    start = time.perf_counter()
    for batch, ids in create_batches(sources, alphabet, fc, batch_size=16,
                                     augmentations=parse_augmentations(augment), train_phase=True,
                                     epoch=1, total_epochs=3, num_workers=workers,
                                     prefetch=2 if workers else 0):
        out.append((ids, [t.numpy() for t in batch]))
        audio_s += float(batch.feature_lengths.sum()) * fc.step_samples / fc.sample_rate
    return out, time.perf_counter() - start, audio_s


def input_phase(device, seed: int, work_dir: str, card: str) -> dict:
    """`train(config)` of the full-width model on the card from CSV (FLAC and
    8 kHz SPHERE), SDB and tar (8 kHz WAV) sources, 32 utterances, B = 16,
    three epochs, with --augment covering every augmentation (codec where
    libopus loads), --feature_cache with --cache_for_epochs 2, 8 input
    workers, 2 batches of prefetch and --profile_dir. Holds: every step
    launches K3 and K4; losses finite, parameters moved; the cache file is
    written at the end of epoch 0, epoch 1 featurizes nothing, epoch 2 drops
    the file and writes it again; the trace exists and names K3's and K4's
    kernels; one epoch's batches on 8 threads equal the serial ones (every
    augmentation but the overlay, whose noise cursor follows the order rows
    are featurized). Prints the host featurize rate, serial and on 8
    threads, beside the train step's."""
    import stt_tpu_torch.data.feeding as feeding
    from stt_tpu_torch.alphabet import Alphabet
    from stt_tpu_torch.config import SttConfig
    from stt_tpu_torch.data.feature_cache import FeatureCache
    from stt_tpu_torch.data.feeding import create_batches
    from stt_tpu_torch.data.opus import opus_available
    from stt_tpu_torch.frontend import FeatureConfig
    from stt_tpu_torch.models import DeepSpeech
    from stt_tpu_torch.ops.lstm_train import lstm_train_bwd, lstm_train_fwd
    from stt_tpu_torch.train import make_train_step
    from stt_tpu_torch.train.trainer import train

    rng = np.random.RandomState(seed + 3)
    start = time.perf_counter()
    paths = write_input_dataset(os.path.join(work_dir, "data"), rng)
    write_s = time.perf_counter() - start
    codec = opus_available()
    augment = [a.format(noise=paths["noise"]) for a in INPUT_AUGMENT] + ([INPUT_CODEC] if codec else [])
    print(f"input: codec augmentation {'included' if codec else 'left out: libopus not found'}",
          flush=True)
    cache = os.path.join(work_dir, "features.cache")
    profile_dir = os.path.join(work_dir, "profile")
    summary = os.path.join(work_dir, "summary")
    shutil.rmtree(profile_dir, ignore_errors=True)
    shutil.rmtree(summary, ignore_errors=True)
    if os.path.exists(cache):
        os.remove(cache)
    sources = [paths["csv"], paths["sdb"], paths["tar"]]
    config = SttConfig(
        train_files=sources, alphabet_config_path=paths["alphabet"], n_hidden=2048,
        train_batch_size=16, epochs=3, dropout_rate=0.05, augment=augment,
        feature_cache=cache, cache_for_epochs=2, input_workers=8, prefetch_batches=2,
        profile_dir=profile_dir, profile_steps=2, summary_dir=summary, seed=seed,
    )
    initial = DeepSpeech(config.model_config(training=True),
                         generator=torch.Generator().manual_seed(seed)).state_dict()

    # the cache's life, as train() drives it: featurize calls, and the file
    # after each finalize and invalidation
    events = []
    real = (feeding.featurize_sample, FeatureCache.finalize, FeatureCache.maybe_invalidate)

    def featurize(*args, **kw):
        events.append("featurize")
        return real[0](*args, **kw)

    def finalize(self, n_rows):
        real[1](self, n_rows)
        events.append(("finalize", os.path.isfile(cache)))

    def maybe_invalidate(self, epoch):
        dropped = real[2](self, epoch)
        events.append(("epoch", epoch, dropped, os.path.isfile(cache)))
        return dropped

    feeding.featurize_sample, FeatureCache.finalize, FeatureCache.maybe_invalidate = (
        featurize, finalize, maybe_invalidate)
    lstm_train_fwd.launches = lstm_train_bwd.launches = 0
    try:
        torch.cuda.synchronize()
        start = time.perf_counter()
        state = train(config, device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - start
    finally:
        feeding.featurize_sample, FeatureCache.finalize, FeatureCache.maybe_invalidate = real
    launches = {"k3": lstm_train_fwd.launches, "k4": lstm_train_bwd.launches}
    steps = state.step
    failures = []
    if not launches["k3"] == launches["k4"] == steps == 7:
        failures.append(f"every train step must launch K3 and K4 (a dummy step and 2 an "
                        f"epoch): {launches}, {steps} steps")
    with open(os.path.join(summary, "scalars.jsonl")) as f:
        losses = [r["train/step_loss"] for r in map(json.loads, f) if "train/step_loss" in r]
    if len(losses) != steps - 1 or not np.isfinite(losses).all():
        failures.append(f"train step losses: {losses}")
    if [k for k, v in state.params.items() if torch.equal(v.detach().cpu(), initial[k])]:
        failures.append("parameters did not move")

    # per epoch: (featurize calls, the file after its finalize), and the
    # invalidation at its start
    epochs, current = [], None
    for e in events:
        if isinstance(e, tuple) and e[0] == "epoch":
            current = {"epoch": e[1], "dropped": e[2], "file_at_start": e[3], "featurized": 0}
            epochs.append(current)
        elif e == "featurize" and current is not None:
            current["featurized"] += 1
        elif isinstance(e, tuple) and e[0] == "finalize" and current is not None:
            current["file_after"] = e[1]
    want = [{"epoch": 0, "dropped": False, "file_at_start": False, "featurized": 32, "file_after": True},
            {"epoch": 1, "dropped": False, "file_at_start": True, "featurized": 0, "file_after": True},
            {"epoch": 2, "dropped": True, "file_at_start": False, "featurized": 32, "file_after": True}]
    if epochs != want:
        failures.append(f"feature cache: {epochs}, want {want}")
    trace = os.path.join(profile_dir, "trace.json")
    names = {}
    if os.path.isfile(trace):
        with open(trace) as f:
            text = f.read()
        names = {n: text.count(n) for n in (RECURRENCE_KERNEL, BWD_KERNEL)}
    if not names or not all(names.values()):
        failures.append(f"the profiler trace {trace} names K3's and K4's kernels: {names}")

    # threaded against serial featurization of one epoch, and their rates
    alphabet = Alphabet(paths["alphabet"])
    fc = FeatureConfig()
    no_overlay = [a for a in augment if not a.startswith("overlay")]
    serial, serial_s, audio_s = featurize_epoch(sources, alphabet, fc, no_overlay, 0)
    threaded, threaded_s, _ = featurize_epoch(sources, alphabet, fc, no_overlay, 8)
    same = [ids for ids, _ in serial] == [ids for ids, _ in threaded] and len(serial) == 2
    worst = 0.0
    for (_, (f, fl, l, ll)), (_, (tf, tfl, tl, tll)) in zip(serial, threaded):
        same &= (np.array_equal(fl, tfl) and np.array_equal(l, tl) and np.array_equal(ll, tll)
                 and f.shape == tf.shape)
        if f.shape == tf.shape:
            same &= bool(np.allclose(tf, f, rtol=THREADED_RTOL, atol=THREADED_ATOL))
            worst = max(worst, float(np.abs(tf - f).max()))
    if not same:
        failures.append(f"8 input workers' batches differ from the serial ones (worst {worst})")

    # the train step at B = 16 on this data's first batch, for the rates
    batch, _ = next(create_batches(sources, alphabet, fc, batch_size=16, reverse=True, limit=16))
    batch = batch.to(device)
    step = make_train_step()
    step(state, batch, seed)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(3):
        step(state, batch, seed)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - start) * 1e3 / 3
    batch_audio_s = float(batch.feature_lengths.sum()) * fc.step_samples / fc.sample_rate
    rec = {
        "steps": steps, "train_s": train_s, "dataset_write_s": write_s, "launches": launches,
        "losses": losses, "cache": epochs, "trace_kernel_mentions": names,
        "codec": codec, "augment": augment, "utterances": 32, "audio_s": audio_s,
        "featurize_serial_s": serial_s, "featurize_8_workers_s": threaded_s,
        "featurize_serial_audio_s_per_s": audio_s / serial_s,
        "featurize_8_workers_audio_s_per_s": audio_s / threaded_s,
        "featurize_serial_ms_per_batch": serial_s * 1e3 / len(serial),
        "featurize_8_workers_ms_per_batch": threaded_s * 1e3 / len(threaded),
        "threaded_vs_serial_max_abs": worst, "train_step_ms": step_ms,
        "train_step_audio_s_per_s": batch_audio_s / (step_ms / 1e3),
        "host_cpus": os.cpu_count(), "gpu": card,
    }
    print("input", json.dumps(rec), flush=True)
    if failures:
        raise AssertionError("input phase: " + "; ".join(failures))
    return rec


EVAL_CASES = (  # (name, SttConfig fields) of the evaluation phase's evaluate runs
    ("off", {"device_decode": "off"}),
    ("prune", {"device_decode": "prune"}),
    ("full", {"device_decode": "full"}),
    ("prune, scorer", {"device_decode": "prune", "scorer_path": True}),
    ("prune, cutoff_top_n 10", {"device_decode": "prune", "cutoff_top_n": 10}),
)
EVAL_REPS = 3  # timed repetitions of each decode in the evaluation phase's split


def long_recording(seconds: float, rate: int, rng: np.random.RandomState) -> tuple:
    """Seeded utterance() pieces of 1.5-4 s with 0.5-1.5 s of quiet between
    them, to `seconds`: (audio, the pieces' (start, end) in seconds)."""
    audio, spans, t = [], [], 0.0
    while t < seconds - 2.0:
        gap = rng.uniform(0.5, 1.5)
        piece = utterance(min(rng.uniform(1.5, 4.0), seconds - t - gap), rate, rng)
        audio += [1e-3 * rng.randn(int(gap * rate)).astype(np.float32), piece]
        spans.append((t + gap, t + gap + len(piece) / rate))
        t = sum(len(a) for a in audio) / rate
    audio.append(1e-3 * rng.randn(int((seconds - t) * rate)).astype(np.float32))
    return np.concatenate(audio), spans


def evaluation_split(device, model, config, batches, alphabet, scorer, card: str) -> tuple:
    """Where evaluate's time goes, on the same batches: the forward (K1), the
    CTC loss and the softmax, each timed after a synchronize, then each decode mode's decode (`decode_batch`, as evaluate
    calls it) from probabilities on the card, EVAL_REPS times; and the
    chunked prune with pinned copies (cutoff_top_n 10) against one bulk fetch
    of the same probabilities pruned on the host. Returns (the record, each
    batch's (probabilities on the card, lengths))."""
    import dataclasses

    from stt_tpu_torch.ctc import ctc_loss
    from stt_tpu_torch.decode.device import ctc_beam_search_decoder_batch_pruned
    from stt_tpu_torch.evaluate import decode_batch

    fc = config.feature_config
    marks = {"forward_ms": 0.0, "ctc_loss_ms": 0.0, "softmax_ms": 0.0}
    probs_list = []
    with torch.no_grad():
        for batch, _ in batches:
            batch = batch.to(device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = model(batch.features, seq_len=batch.feature_lengths)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ctc_loss(logits, batch.feature_lengths, batch.labels, batch.label_lengths)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            probs = torch.softmax(logits, dim=-1)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            marks["forward_ms"] += (t1 - t0) * 1e3
            marks["ctc_loss_ms"] += (t2 - t1) * 1e3
            marks["softmax_ms"] += (t3 - t2) * 1e3
            probs_list.append((probs, batch.feature_lengths.tolist()))
    audio_s = sum(sum(n) for _, n in probs_list) * fc.step_samples / fc.sample_rate
    decode = {}
    for name, fields in EVAL_CASES:
        fields = dict(fields, scorer_path="")
        cfg = dataclasses.replace(config, **fields)
        times = []
        for _ in range(EVAL_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for probs, lengths in probs_list:
                decode_batch(cfg, probs, lengths, alphabet,
                             scorer if name == "prune, scorer" else None)
            times.append(time.perf_counter() - t0)
        decode[name] = {"ms": min(times) * 1e3, "reps_ms": [t * 1e3 for t in times],
                        "audio_s_per_s": audio_s / min(times)}
    pulls = {"chunked_pinned_ms": [], "bulk_fetch_ms": []}
    for _ in range(EVAL_REPS):
        for key in pulls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for probs, lengths in probs_list:
                src = probs if key == "chunked_pinned_ms" else probs.cpu().numpy()
                ctc_beam_search_decoder_batch_pruned(
                    src, lengths, alphabet, config.export_beam_width,
                    num_processes=max(1, min(config.test_batch_size, os.cpu_count() or 1)),
                    cutoff_top_n=10)
            pulls[key].append((time.perf_counter() - t0) * 1e3)
    rec = {**marks, "audio_s": audio_s, "frames": [int(p.shape[1]) for p, _ in probs_list],
           "decode": decode, "chunked_vs_bulk": {k: min(v) for k, v in pulls.items()},
           "chunked_vs_bulk_reps": pulls, "gpu": card}
    print("evaluate_split", json.dumps(rec), flush=True)
    return rec, probs_list


def evaluate_in_bytes_mode(device, seed: int, out_dir: str, paths: dict, counted) -> tuple:
    """`evaluate(config)` with --device_decode full --bytes_output_mode at
    beam 500 on the dev CSV: a full-width bytes-mode model (n_out 256,
    seeded random weights) saved as a checkpoint and evaluated on the card,
    which must launch K5 (its wide instance, by shape) and K1; its
    transcripts must equal those of the port's plain scan on the same
    probabilities, on the card. Returns (failures, the run's record)."""
    from stt_tpu_torch.config import SttConfig
    from stt_tpu_torch.data.feeding import create_batches
    from stt_tpu_torch.decode.device import _device_beam_scan, rebuild_results
    from stt_tpu_torch.evaluate import evaluate, load_model
    from stt_tpu_torch.ops import beam_kernel
    from stt_tpu_torch.train import create_train_state
    from stt_tpu_torch.train.checkpoints import CheckpointManager

    ckpt = os.path.join(out_dir, "bytes_checkpoint")
    config = SttConfig(
        test_files=[paths["dev"]], bytes_output_mode=True, n_hidden=2048, test_batch_size=8,
        export_beam_width=500, device_decode="full", checkpoint_dir=ckpt, seed=seed,
    )
    model_config = config.model_config(training=False)
    if model_config.n_out != 256 or beam_kernel.is_narrow(500, model_config.n_out):
        raise AssertionError(f"bytes mode must run K5's wide instance: n_out {model_config.n_out}")
    CheckpointManager(ckpt).save(create_train_state(model_config, seed=seed, device=device), "last")
    model = load_model(config, device)
    alphabet = config.resolve_alphabet()
    [res], rec = counted("evaluate[full, bytes]", lambda: evaluate(config, model=model),
                         ("k1", "k5"))
    rec.update(transcripts=[r.res for r in res], n_out=model_config.n_out, beam=500,
               instance="wide")
    failures = []
    plain = {}
    with torch.no_grad():
        for batch, ids in create_batches([paths["dev"]], alphabet, config.feature_config,
                                         batch_size=config.test_batch_size):
            batch = batch.to(device)
            logits, _ = model(batch.features, seq_len=batch.feature_lengths)
            probs = torch.softmax(logits, dim=-1)
            scores, src, char = _device_beam_scan(probs, batch.feature_lengths, 500,
                                                  config.cutoff_top_n, config.cutoff_prob)
            for i, sample_id in enumerate(ids):
                plain[sample_id] = rebuild_results(
                    scores[i].cpu().numpy(), src[i].cpu().numpy(), char[i].cpu().numpy(),
                    alphabet)[0].transcript
    equal = [plain[r.sample_id] == r.res for r in res]
    rec.update(equal_to_plain_scan=equal, transcript_bytes=[len(r.res.encode()) for r in res])
    print("evaluate", json.dumps(rec), flush=True)
    if not all(equal) or len(equal) != 8:
        failures.append(f"evaluate[full, bytes] differs from the plain scan on the same "
                        f"probabilities: {equal}")
    return failures, rec


def evaluation_phase(device, seed: int, work_dir: str, paths: dict, scorers: dict,
                     card: str) -> dict:
    """Evaluate, export and transcribe the training phase's full-width
    checkpoint through the port's entry points, on the card:
    - `evaluate(config)` on the dev CSV (8 utterances, test_batch_size 8,
      export_beam_width 500) with the decode modes off, prune and full, prune
      with the word scorer, and prune with cutoff_top_n 10 (the chunked prune
      with pinned copies): off, prune and full must give one transcript and
      WER, K1 must launch in every run (at least once a batch), K5 in full
      and only there, no training kernel; the cutoff_top_n 10 run must equal
      a host-pruned decode of the same probabilities; then `evaluation_split`;
    - `export(config)` float, --export_zip and --export_quantize: the
      .sttpkg's Model answers as the directory's;
    - `transcribe_file` on a 30 s seeded recording, VAD-split, with the float
      export (K1) and the int8 one under quantized_inference=True (K2, not
      K1), no training kernel;
    - `evaluate_export` on the dev CSV (K1)."""
    import dataclasses

    from stt_tpu_torch.alphabet import Alphabet
    from stt_tpu_torch.config import SttConfig
    from stt_tpu_torch.data import write_wav
    from stt_tpu_torch.data.feeding import create_batches
    from stt_tpu_torch.decode.device import ctc_beam_search_decoder_batch_pruned
    from stt_tpu_torch.decode.scorer_package import KenLMScorer
    from stt_tpu_torch.evaluate import decode_batch, evaluate, load_model
    from stt_tpu_torch.evaluate_export import evaluate_export
    from stt_tpu_torch.export import export
    from stt_tpu_torch.serve import Model
    from stt_tpu_torch.transcribe import transcribe_file

    out_dir = os.path.join(work_dir, "evaluation")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    config = SttConfig(
        test_files=[paths["dev"]], alphabet_config_path=paths["alphabet"], n_hidden=2048,
        test_batch_size=8, export_beam_width=500, checkpoint_dir=paths["checkpoints"],
        seed=seed,
    )
    alphabet = Alphabet(paths["alphabet"])
    totals, runs = {}, []

    def counted(name: str, fn, must: tuple) -> tuple:
        result, ms, launches = run_counted(name, fn, must)
        for key, n in launches.items():
            totals[key] = totals.get(key, 0) + n
        return result, {"run": name, "wall_ms": ms, "launches": launches, "gpu": card}

    start = time.perf_counter()
    model = load_model(config, device)
    load_ms = (time.perf_counter() - start) * 1e3
    batches = list(create_batches([paths["dev"]], alphabet, config.feature_config,
                                  batch_size=config.test_batch_size))
    n_batches = len(batches)
    evaluate(dataclasses.replace(config, device_decode="off"), model=model)  # warm-up
    results = {}
    for name, fields in EVAL_CASES:
        if fields.get("scorer_path"):
            fields = dict(fields, scorer_path=scorers["alphabet"]["path"])
        cfg = dataclasses.replace(config, test_output_file=os.path.join(
            out_dir, name.replace(" ", "").replace(",", "_") + ".json"), **fields)
        must = ("k1", "k5") if name == "full" else ("k1",)
        [res], rec = counted(f"evaluate[{name}]", lambda: evaluate(cfg, model=model), must)
        if rec["launches"]["k1"] < n_batches:
            raise AssertionError(f"evaluate[{name}]: K1 launched {rec['launches']['k1']} times "
                                 f"for {n_batches} batches")
        rec.update(transcripts=[r.res for r in res], wer=[r.wer for r in res],
                   mean_loss=float(np.mean([r.loss for r in res])))
        print("evaluate", json.dumps(rec), flush=True)
        results[name] = res
        runs.append(rec)
    scorer = KenLMScorer(scorers["alphabet"]["path"], alpha=config.lm_alpha, beta=config.lm_beta)
    split, probs = evaluation_split(device, model, config, batches, alphabet, scorer, card)
    del model
    # the three decodes agree; exact ties between two classes in a frame of
    # the probabilities (where decoders may order candidates differently)
    # are counted beside the hold
    ties = 0
    for p, lengths in probs:
        rows = p.cpu().numpy()
        ties += sum(int(len(np.unique(row)) < len(row))
                    for i, n in enumerate(lengths) for row in rows[i, :n])
    # checks that fail are raised at the end of the phase, so that one run
    # shows every one of them
    failures = []
    agree = {name: [(r.res, r.wer) for r in results[name]] for name in ("off", "prune", "full")}
    print(f"evaluation: off == prune == full: {agree['off'] == agree['prune'] == agree['full']} "
          f"({ties} tied frames)", flush=True)
    if not agree["off"] == agree["prune"] == agree["full"]:
        differ = [i for i, (a, b, c) in enumerate(zip(*agree.values())) if not a == b == c]
        scores = {}
        for name, fields in EVAL_CASES[:3]:
            cfg = dataclasses.replace(config, **fields)
            decoded = [r for p, lengths in probs for r in decode_batch(cfg, p, lengths, alphabet)]
            scores[name] = [decoded[i][0].confidence for i in differ]
        failures.append(f"evaluate's decode modes disagree on utterances {differ} ({ties} tied "
                        f"frames; best scores by mode {scores}): {agree}")
    host = [r[0].transcript for p, lengths in probs for r in ctc_beam_search_decoder_batch_pruned(
        p.cpu().numpy(), lengths, alphabet, config.export_beam_width, num_processes=8,
        cutoff_top_n=10)]
    if host != [r.res for r in results["prune, cutoff_top_n 10"]]:
        failures.append("evaluate with cutoff_top_n 10 (chunked, pruned on the card) differs "
                        "from the host-pruned decode of the same probabilities")

    # ---- evaluate[full, bytes]: K5's wide instance (256 classes, beam 500) --
    res, rec = evaluate_in_bytes_mode(device, seed, out_dir, paths, counted)
    runs.append(rec)
    failures += res

    # ---- export: float, --export_zip, --export_quantize --------------------
    exports = {}
    for name, fields in (("float", {}), ("zip", {"export_zip": True}),
                         ("int8", {"export_quantize": True})):
        cfg = dataclasses.replace(config, export_dir=os.path.join(out_dir, f"export_{name}"),
                                  **fields)
        exports[name], rec = counted(f"export[{name}]", lambda: export(cfg), ())
        rec["bytes"] = (os.path.getsize(exports[name]) if os.path.isfile(exports[name]) else
                        sum(os.path.getsize(os.path.join(exports[name], f))
                            for f in os.listdir(exports[name])))
        print("export", json.dumps(rec), flush=True)
        runs.append(rec)
    if not exports["zip"].endswith(".sttpkg"):
        raise AssertionError(f"--export_zip wrote {exports['zip']}")
    rng = np.random.RandomState(seed + 2)
    fc = config.feature_config
    probe = utterance(2.5, fc.sample_rate, rng)
    float_model, zip_model = Model(exports["float"]), Model(exports["zip"])
    feats = batches[0][0].features[:2]
    lengths = batches[0][0].feature_lengths[:2]
    if not (float_model.stt(probe) == zip_model.stt(probe) and torch.equal(
            float_model.infer_logits(feats, lengths), zip_model.infer_logits(feats, lengths))):
        failures.append("Model(.sttpkg) answers otherwise than Model(dir)")
    del zip_model

    # ---- transcribe: a 30 s recording, float (K1) and int8 (K2) -------------
    audio, spans = long_recording(30.0, fc.sample_rate, rng)
    wav = os.path.join(out_dir, "long.wav")
    write_wav(wav, audio, fc.sample_rate)
    int8_model = Model(exports["int8"], quantized_inference=True)
    transcribe_file(float_model, wav)  # warm-up
    for name, gpu_model, must in (("float", float_model, ("k1",)), ("int8", int8_model, ("k2",))):
        segments, rec = counted(f"transcribe_file[{name}]",
                                lambda: transcribe_file(gpu_model, wav), must)
        rec.update(audio_s=len(audio) / fc.sample_rate, pieces=len(spans),
                   segments=len(segments),
                   audio_s_per_s=len(audio) / fc.sample_rate / (rec["wall_ms"] / 1e3),
                   transcripts=[s["transcript"] for s in segments])
        print("transcribe", json.dumps(rec), flush=True)
        if len(segments) < 2:
            failures.append(f"VAD cut the {len(spans)}-piece recording into {segments}")
        runs.append(rec)
    del int8_model, float_model

    # ---- evaluate_export on the dev CSV (K1) ---------------------------------
    report, rec = counted("evaluate_export",
                          lambda: evaluate_export(exports["float"], paths["dev"]), ("k1",))
    rec.update(wer=float(np.mean([r.wer for r in report])), samples=len(report))
    print("evaluate_export", json.dumps(rec), flush=True)
    runs.append(rec)
    if len(report) != 8:
        failures.append(f"evaluate_export scored {len(report)} of 8 samples")
    if failures:
        raise AssertionError("evaluation phase: " + "; ".join(failures))
    return {"load_ms": load_ms, "runs": runs, "split": split, "tied_frames": ties,
            "launches": totals, "gpu": card}


TP_MESHES = ((1, 2), (2, 2))  # (n_data, n_model) of the tp phase's runs
TP_TIMEOUT_S = 500  # each rank's own limit; the phase kills the ranks past it
# Where a mesh's column-split GEMMs round otherwise than one rank's whole
# ones, as (2 x 2)'s do and (1 x 2)'s do not (`relu_mask_flips`: the first
# forward's pre-activations against one rank's), a pre-activation within
# about 1e-7 of the clipped ReLU's kink lands on its other side, the
# sharded leaves' first gradients move (TP_GRAD_RTOL's readings) and two
# Adam steps carry that into the losses. The limits below were set from
# the readings of an NVIDIA H100 80GB HBM3 at 700 W. The losses against
# one rank's: (1 x 2) 3.3e-6, (2 x 2) 2.7e-4.
TP_LOSS_RTOL = 1e-3
# the ranks' parameters after the epoch against one rank's: the norm of the
# difference of the two runs' updates over the norm of one rank's update,
# held; (1 x 2) read 3.1e-4 to 3.8e-4, (2 x 2) 6.7e-3, and the CPU tests'
# TP runs against stt_tpu 5.3e-3 under the same limit
# (tests/test_torch_tp.py). Three Adam steps move a parameter whose
# gradient is near 0 by about 3 lr whatever its gradient, so the largest
# single difference is recorded, not held.
TP_UPDATE_RTOL = 2e-2
# the first step's gradient norm against one rank's, from the same
# parameters: the sums run in other orders (column-split GEMMs, the data
# all-reduce, the CTC backward's atomics). The CPU tests read 1.1e-7 at
# most against the one-process step.
TP_GRAD_NORM_RTOL = 1e-4
# the first step's gradients against one rank's, leaf by leaf: the norm of
# the difference over the norm of one rank's gradient; (1 x 2) read 4.4e-7,
# (2 x 2) 7.2e-5 (its mask flips). A wrong factor of K or a piece out of
# order moves a leaf by 0.5 or more.
TP_GRAD_RTOL = 1e-3


def gloo_cuda_probe() -> dict:
    """Which of gloo's tensor collectives take CUDA tensors in this torch:
    each tried once on a small tensor on the card, over the whole group."""
    import torch.distributed as dist

    world = dist.get_world_size()
    x = torch.arange(4 * world, dtype=torch.float32, device="cuda").reshape(2 * world, 2)
    calls = {
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            x.new_empty((2 * world * world, 2)), x),
        "all_to_all_single": lambda: dist.all_to_all_single(torch.empty_like(x), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(x.new_empty((2, 2)), x),
        "all_reduce": lambda: dist.all_reduce(x.clone()),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize()
            out[name] = "takes CUDA tensors"
        except Exception as e:  # a refusal is the finding: recorded, not hidden
            out[name] = f"refuses CUDA tensors: {type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return out


def params_fingerprint(params: dict) -> dict:
    """Per leaf: the float64 sum and sum of squares (equal bits give equal
    fingerprints)."""
    return {k: [float(v.double().sum()), float(v.double().square().sum())]
            for k, v in params.items()}


class FirstPreactivations:
    """Records the full-width pre-activations (before the clipped ReLU) of
    the five dense layers in the first forward that runs after it is made:
    of `parallel.tp`'s column-parallel layers (at their gather) in a TP
    rank, of `DeepSpeech._dense` in one rank. For the tp phase's
    configuration, which has no dropout and no layer norm: there the
    pre-activation is the dense layer's output before the clamp."""

    LAYERS = ("layer_1", "layer_2", "layer_3", "layer_5", "layer_6")

    def __init__(self, one_rank: bool = False):
        import importlib

        from stt_tpu_torch.models.deepspeech import DeepSpeech

        self.values = []
        if one_rank:
            self.owner, self.name = DeepSpeech, "_dense"
            made = DeepSpeech._dense

            def dense(model, name, x, relu=True, **kw):
                out = made(model, name, x, relu=False, **kw)
                self.keep(out)
                return torch.clamp(out, min=0.0, max=model.config.relu_clip) if relu else out
            setattr(DeepSpeech, "_dense", dense)
        else:
            self.owner, self.name = importlib.import_module("stt_tpu_torch.parallel.tp"), "_gather_cols"
            made = self.owner._gather_cols

            def gather(x, full_dim, mesh):
                out = made(x, full_dim, mesh)
                self.keep(out)
                return out
            self.owner._gather_cols = gather
        self.made = made

    def keep(self, out: torch.Tensor) -> None:
        if len(self.values) < len(self.LAYERS):
            self.values.append(out.detach().clone())

    def stop(self) -> None:
        setattr(self.owner, self.name, self.made)


def relu_mask_flips(got: list, want: list, relu_clip: float) -> dict:
    """Per ReLU layer, the count of pre-activations in `got` (a mesh's, its
    data indices' rows in order) on the other side of the clipped ReLU's
    kinks (0 and relu_clip) than in one rank's `want`, the largest distance
    of one rank's value from the kink among them, the largest difference
    and the share of values equal bit for bit."""
    out = {}
    for name, a, b in zip(FirstPreactivations.LAYERS[:4], got, want):  # layer_6 has no ReLU
        b = b.to(a.device)
        flip = ((a > 0) != (b > 0)) | ((a > relu_clip) != (b > relu_clip))
        near = torch.minimum(b.abs(), (b - relu_clip).abs())[flip]
        out[name] = {"flips": int(flip.sum()),
                     "largest_distance_to_kink": float(near.max()) if near.numel() else None,
                     "max_abs_diff": float((a - b).abs().max()),
                     "bit_equal_share": float((a == b).float().mean())}
    return out


def recurrence_check(call: dict) -> dict:
    """K3 and K4 against their plain versions on one recurrence's inputs as
    the TP step gave them (the rank's rows of the gate projection, the
    gathered W_h) and on the cotangents its backward received. Each is held
    at TRAIN_TOL times the largest magnitude among the plain version's
    outputs where that passes 1: after an Adam step the cell state grows
    far past unit scale over 256 steps, and the cotangents are the loss's."""
    from stt_tpu_torch.ops.lstm_train import (
        _cotangent, lstm_train_bwd, lstm_train_fwd, train_backward, train_forward,
    )

    x_proj, w_h, c0, h0, seq = call["inputs"]
    w = w_h.to(call["dtype"]).contiguous()
    tol = TRAIN_TOL[call["dtype"]]
    got = lstm_train_fwd(x_proj, w, c0, h0, seq)
    want = train_forward(x_proj, w, c0, h0, seq)
    fwd_err = max((g - v).abs().max().item() for i, (g, v) in enumerate(zip(got, want)) if i != 2)
    fwd_largest = max(v.abs().max().item() for i, v in enumerate(want) if i != 2)
    assert_zs_close(got[2], want[2], tol * max(1.0, fwd_largest), f"tp K3 at {list(x_proj.shape)}")
    hs, cs, zs = want[0], want[1], want[2]
    d_hs, d_cT, d_hT = call["cotangents"]
    cs_prev = torch.cat([c0[None], cs])[:hs.shape[0]].contiguous()
    bwd_args = (zs, cs, cs_prev, _cotangent(d_hs, hs), w, seq, _cotangent(d_cT, c0),
                _cotangent(d_hT, h0))
    got_b = lstm_train_bwd(*bwd_args)
    want_b = train_backward(*bwd_args)
    torch.cuda.synchronize()
    bwd_err = max((g - v).abs().max().item() for g, v in zip(got_b, want_b))
    bwd_largest = max(v.abs().max().item() for v in want_b)
    return {"x_proj": list(x_proj.shape), "w_h": list(w_h.shape), "fwd_max_abs_err": fwd_err,
            "fwd_largest": fwd_largest, "bwd_max_abs_err": bwd_err, "bwd_largest": bwd_largest,
            "tol": tol, "ok": (fwd_err <= tol * max(1.0, fwd_largest)
                               and bwd_err <= tol * max(1.0, bwd_largest))}


def tp_rank(rank: int, world: int, n_model: int, port: int, work_dir: str, seed: int) -> int:
    """One rank of the tp phase, in a process of its own: joins a group of
    `world` ranks over gloo with its tensors on the one card, trains with
    --n_model_parallel n_model, records the shapes each recurrence got, and
    writes its record (rank 0 also the gathered parameters)."""
    sys.path.insert(0, ROOT)
    from stt_tpu_torch.ops.lstm_train import _Recurrence
    from stt_tpu_torch.parallel import distributed

    with open(os.path.join(work_dir, "paths.json")) as f:
        paths = json.load(f)
    distributed.initialize(f"localhost:{port}", world, rank, backend="gloo", device="cuda")
    probe = gloo_cuda_probe()
    shapes, calls = [], []
    forward, backward = _Recurrence.forward, _Recurrence.backward

    def recording(ctx, x_proj, w_h, c0, h0, seq, compute_dtype):
        shapes.append([list(x_proj.shape), list(w_h.shape)])
        ctx.call = len(calls)
        calls.append({"inputs": [t.detach().clone() for t in (x_proj, w_h, c0, h0, seq)],
                      "dtype": compute_dtype})
        return forward(ctx, x_proj, w_h, c0, h0, seq, compute_dtype)

    def recording_backward(ctx, *cotangents):
        calls[ctx.call]["cotangents"] = [None if d is None else d.detach().clone()
                                         for d in cotangents]
        return backward(ctx, *cotangents)

    _Recurrence.forward = staticmethod(recording)
    _Recurrence.backward = staticmethod(recording_backward)
    pre = FirstPreactivations()
    config = parallel_config(paths, seed, os.path.join(work_dir, f"rank{rank}"),
                             n_model_parallel=n_model)
    # the dev batches go round-robin over the ranks; a rank with one runs K1
    with open(paths["dev"]) as f:
        dev_batches = -(-(sum(1 for _ in f) - 1) // config.dev_batch_size)
    grads = {}
    rec, state = timed_training(config, "tp: train", "make_train_step_tp",
                                ("k1", "k3", "k4") if rank < dev_batches else ("k3", "k4"),
                                first_grads=grads)
    _Recurrence.forward, _Recurrence.backward = staticmethod(forward), staticmethod(backward)
    pre.stop()
    params = {k: v.detach() for k, v in state.params.items()}
    rec.update(rank=rank, recurrence_shapes=shapes, fingerprint=params_fingerprint(params),
               gloo_cuda=probe, recurrence_checks=[recurrence_check(c) for c in calls])
    if rank == 0:
        torch.save({k: v.cpu() for k, v in params.items()}, os.path.join(work_dir, "params.pt"))
        torch.save({k: v.cpu() for k, v in grads.items()}, os.path.join(work_dir, "grads.pt"))
    if rank % n_model == 0:  # each data index's rows, from its first model rank
        torch.save([v.cpu() for v in pre.values],
                   os.path.join(work_dir, f"pre{rank // n_model}.pt"))
    with open(os.path.join(work_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()
    return 0


def tp_phase(device, seed: int, work_dir: str, card: str) -> dict:
    """Tensor parallelism on the one card: the full-width model, the
    training phase's data, dropout 0, one epoch at B = 16, trained by one
    rank, then by ranks (processes of this script, gloo passed to
    `initialize`, their tensors on the card) on a (1 x 2) and a (2 x 2) mesh
    with --n_model_parallel 2. Holds: every rank launches K3 and K4 once a
    step, at its B / K rows (8, then 4) of the gate projection with the
    gathered [2048, 8192] W_h; the ranks' losses are equal to each other
    and, within TP_LOSS_RTOL, to one rank's, as is the merged dev
    loss; the first step's gradient norm is one rank's within
    TP_GRAD_NORM_RTOL; the ranks' gathered parameters are equal bit for bit
    (by fingerprint) and rank 0's updates are one rank's within
    TP_UPDATE_RTOL; the first step's gradients, gathered, are one rank's
    leaf by leaf within TP_GRAD_RTOL; K3 and K4 agree with their plain
    versions on each of the ranks' recurrences' own inputs and cotangents
    (`recurrence_check`). Records each rank's step ms and the bytes a step
    stages through the host beside one rank's step, what gloo takes on CUDA
    tensors, and the first forward's clipped-ReLU mask flips against one
    rank's (`relu_mask_flips`)."""
    from stt_tpu_torch.frontend import FeatureConfig
    from stt_tpu_torch.train import create_train_state

    shutil.rmtree(work_dir, ignore_errors=True)
    os.makedirs(work_dir)
    paths = write_dataset(os.path.join(work_dir, "data"), np.random.RandomState(seed + 1),
                          FeatureConfig().sample_rate)
    one_grads, one_pre = {}, FirstPreactivations(one_rank=True)
    one, one_state = timed_training(parallel_config(paths, seed, os.path.join(work_dir, "one")),
                                    "tp: one rank", first_grads=one_grads)
    one_pre.stop()
    model_config = parallel_config(paths, seed, work_dir).model_config(training=True)
    init = create_train_state(model_config, seed=seed, device=device).params
    one_update = {k: (v.detach() - init[k].detach()) for k, v in one_state.params.items()}
    del one_state
    failures, meshes = [], []
    for n_data, n_model in TP_MESHES:
        world = n_data * n_model
        mesh_dir = os.path.join(work_dir, f"{n_data}x{n_model}")
        os.makedirs(mesh_dir)
        with open(os.path.join(mesh_dir, "paths.json"), "w") as f:
            json.dump(paths, f)
        port = free_port()
        start = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--seed", str(seed),
                                   "--tp-rank", str(r), "--tp-world", str(world),
                                   "--tp-model", str(n_model), "--parallel-port", str(port),
                                   "--parallel-dir", mesh_dir], cwd=ROOT)
                 for r in range(world)]
        try:
            for proc in procs:
                proc.wait(timeout=TP_TIMEOUT_S)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if any(proc.returncode != 0 for proc in procs):
            raise AssertionError(f"tp {n_data}x{n_model}: ranks exited "
                                 f"{[p.returncode for p in procs]}")
        wall_s = time.perf_counter() - start
        ranks = []
        for r in range(world):
            with open(os.path.join(mesh_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        tag = f"tp {n_data}x{n_model}"
        rows = TRAIN_SHAPE[0] // world
        H = model_config.n_cell_dim
        for rec in ranks:
            if rec["losses"] != ranks[0]["losses"] or rec["fingerprint"] != ranks[0]["fingerprint"]:
                failures.append(f"{tag}: rank {rec['rank']}'s losses or parameters differ from "
                                f"rank 0's")
            if not rec["launches"]["k3"] == rec["launches"]["k4"] == rec["steps"] == 3:
                failures.append(f"{tag}: rank {rec['rank']}: every step must launch K3 and K4: "
                                f"{rec['launches']}")
            if any(x[1] != rows or x[2] != 4 * H or w != [H, 4 * H]
                   for x, w in rec["recurrence_shapes"]) or len(rec["recurrence_shapes"]) != 3:
                failures.append(f"{tag}: rank {rec['rank']}'s recurrences ran at "
                                f"{rec['recurrence_shapes']}, not {rows} rows with the gathered "
                                f"[{H}, {4 * H}] W_h")
            checks = rec["recurrence_checks"]
            if len(checks) != 3 or not all(c["ok"] for c in checks):
                failures.append(f"{tag}: rank {rec['rank']}'s K3/K4 on its recurrences' own "
                                f"inputs against the plain versions: {checks}")
        if not np.allclose(ranks[0]["losses"], one["losses"], rtol=TP_LOSS_RTOL, atol=0):
            failures.append(f"{tag}: losses {ranks[0]['losses']} vs one rank's {one['losses']}")
        grad_norm_rel = abs(ranks[0]["grad_norms"][0] / one["grad_norms"][0] - 1)
        if not grad_norm_rel <= TP_GRAD_NORM_RTOL:
            failures.append(f"{tag}: the first step's gradient norm {ranks[0]['grad_norms'][0]} "
                            f"vs one rank's {one['grad_norms'][0]}")
        if not (ranks[0]["dev_loss"] and np.allclose(ranks[0]["dev_loss"], one["dev_loss"],
                                                      rtol=TP_LOSS_RTOL, atol=0)):
            failures.append(f"{tag}: dev losses {ranks[0]['dev_loss']} vs {one['dev_loss']}")
        rows_pre = [torch.load(os.path.join(mesh_dir, f"pre{d}.pt"), weights_only=True)
                    for d in range(n_data)]
        flips = relu_mask_flips([torch.cat(layer).to(device) for layer in zip(*rows_pre)],
                                one_pre.values, model_config.relu_clip)
        grads = torch.load(os.path.join(mesh_dir, "grads.pt"), weights_only=True)
        grad_rel = {name: float((grads[name].to(device) - want).double().norm()
                                / max(float(want.double().norm()), 1e-30))
                    for name, want in one_grads.items()}
        if sorted(grads) != sorted(one_grads) or not max(grad_rel.values()) <= TP_GRAD_RTOL:
            failures.append(f"{tag}: the first step's gradients against one rank's, leaf by "
                            f"leaf: {grad_rel}")
        params = torch.load(os.path.join(mesh_dir, "params.pt"), weights_only=True)
        diff_sq = ref_sq = max_abs = 0.0
        for name, update in one_update.items():
            delta = params[name].to(device) - init[name].detach() - update
            diff_sq += float(delta.double().square().sum())
            ref_sq += float(update.double().square().sum())
            max_abs = max(max_abs, float(delta.abs().max()))
        update_rel = (diff_sq / ref_sq) ** 0.5
        if not update_rel <= TP_UPDATE_RTOL:
            failures.append(f"{tag}: parameters after the epoch differ from one rank's: update "
                            f"{update_rel:.3g} relative, {max_abs:.3g} at most")
        loss_rel = float(np.max(np.abs(np.array(ranks[0]["losses"]) / np.array(one["losses"]) - 1)))
        meshes.append({
            "mesh": [n_data, n_model], "ranks": world, "rows_per_recurrence": rows,
            "wall_s": wall_s, "rank_step_ms": [r["step_ms"] for r in ranks],
            "rank_staged_bytes_per_step": [r["staged_bytes"] for r in ranks],
            "rank_train_ms": [r["train_ms"] for r in ranks],
            "losses": ranks[0]["losses"], "dev_loss": ranks[0]["dev_loss"],
            "loss_rel_err_vs_one_rank": loss_rel, "update_rel_err_vs_one_rank": update_rel,
            "first_grad_norm_rel_err_vs_one_rank": grad_norm_rel,
            "first_grads_rel_err_vs_one_rank": grad_rel, "relu_mask_flips": flips,
            "recurrence_checks": [c for r in ranks for c in r["recurrence_checks"]],
            "grad_norms": ranks[0]["grad_norms"],
            "param_max_abs_err_vs_one_rank": max_abs,
            "launches": {k: sum(r["launches"][k] for r in ranks) for k in ("k1", "k3", "k4")},
            "rank_launches": [r["launches"] for r in ranks],
            "recurrence_shapes": ranks[0]["recurrence_shapes"]})
    rec = {"meshes": meshes, "one_rank": one, "gloo_cuda": ranks[0]["gloo_cuda"],
           "backend": "gloo, the ranks on one card", "loss_tol": TP_LOSS_RTOL,
           "update_tol": TP_UPDATE_RTOL, "grad_norm_tol": TP_GRAD_NORM_RTOL,
           "grad_tol": TP_GRAD_RTOL, "gpu": card,
           "launches": {k: one["launches"][k] + sum(m["launches"][k] for m in meshes)
                        for k in ("k1", "k3", "k4")}}
    print("tp", json.dumps(rec), flush=True)
    if failures:
        raise AssertionError("tp phase: " + "; ".join(failures))
    return rec


ENTRY_FLASHLIGHT_BEAM = 16  # evaluate_flashlight's beam (its host decoder is pure Python)
ENTRY_LM_TRIALS = 4


def entry_phase(device, seed: int, work_dir: str, paths: dict, scorers: dict, card: str) -> dict:
    """The other entry points on the training phase's full-width checkpoint
    and dev CSV (8 utterances), on the card; none may launch a training
    kernel:
    - `training_graph_inference` on a seeded 5 s WAV at beam 500: K1, and the
      transcript of the checkpoint's export served by `Model(dir).stt` on
      the same file;
    - `lm_optimizer`, ENTRY_LM_TRIALS trials with the word scorer: K1 once a
      batch of the one acoustic pass;
    - `evaluate_flashlight` (lexicon, from the scorer's vocabulary, beam
      ENTRY_FLASHLIGHT_BEAM): K1;
    - `evaluate_wav2vec2am` without a scorer on emissions that the port's
      model computes and writes as .npy (the model's 29 classes as a
      wav2vec2 AM with the blank last): K5 (the batch device decode at
      beam 500), and the transcripts of the batch device decoder on the same
      probabilities in the framework's own class layout.
    Records each one's wall ms."""
    import dataclasses

    from stt_tpu_torch.config import SttConfig
    from stt_tpu_torch.data import write_wav
    from stt_tpu_torch.data.feeding import create_batches
    from stt_tpu_torch.decode.device import ctc_beam_search_decoder_device
    from stt_tpu_torch.evaluate import load_model
    from stt_tpu_torch.evaluate_flashlight import evaluate_flashlight
    from stt_tpu_torch.evaluate_wav2vec2am import evaluate_wav2vec2am, read_csv_entries
    from stt_tpu_torch.export import export
    from stt_tpu_torch.lm_optimizer import compute_lm_optimization
    from stt_tpu_torch.serve import Model
    from stt_tpu_torch.train.step import make_eval_step
    from stt_tpu_torch.training_graph_inference import do_single_file_inference

    out_dir = os.path.join(work_dir, "entry")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    config = SttConfig(
        test_files=[paths["dev"]], alphabet_config_path=paths["alphabet"], n_hidden=2048,
        test_batch_size=8, beam_width=500, export_beam_width=500,
        checkpoint_dir=paths["checkpoints"], export_dir=os.path.join(out_dir, "export"), seed=seed)
    fc = config.feature_config
    runs, totals, failures = [], {}, []

    def counted(name: str, fn, must: tuple):
        result, ms, launches = run_counted(name, fn, must)
        for key, n in launches.items():
            totals[key] = totals.get(key, 0) + n
        rec = {"run": name, "wall_ms": ms, "launches": launches, "gpu": card}
        runs.append(rec)
        return result, rec

    # ---- training_graph_inference on 5 s, against the export's Model.stt ----
    audio = utterance(5.0, fc.sample_rate, np.random.RandomState(seed + 3))
    wav = os.path.join(out_dir, "five_seconds.wav")
    write_wav(wav, audio, fc.sample_rate)
    do_single_file_inference(config, wav)  # warm-up
    text, rec = counted("training_graph_inference", lambda: do_single_file_inference(config, wav),
                        ("k1",))
    export(config)
    served, _ = counted("Model.stt of the export", lambda: Model(config.export_dir).stt(audio),
                        ("k1",))
    rec.update(transcript=text, served=served)
    print("entry", json.dumps(rec), flush=True)
    if text != served:
        failures.append(f"training_graph_inference gave {text!r}, the served export {served!r}")

    # ---- lm_optimizer with the word scorer ---------------------------------
    scored = dataclasses.replace(config, scorer_path=scorers["alphabet"]["path"])
    best, rec = counted("lm_optimizer", lambda: compute_lm_optimization(
        scored, n_trials=ENTRY_LM_TRIALS), ("k1",))
    rec.update(trials=ENTRY_LM_TRIALS, best=list(best))
    print("entry", json.dumps(rec), flush=True)

    # ---- evaluate_flashlight (lexicon from the scorer's vocabulary) ---------
    [res], rec = counted("evaluate_flashlight", lambda: evaluate_flashlight(
        scored, decoder_type="lexicon", beam_size=ENTRY_FLASHLIGHT_BEAM), ("k1",))
    rec.update(beam=ENTRY_FLASHLIGHT_BEAM, samples=len(res),
               wer=float(np.mean([r.wer for r in res])), transcripts=[r.res for r in res])
    print("entry", json.dumps(rec), flush=True)
    if len(res) != 8:
        failures.append(f"evaluate_flashlight scored {len(res)} of 8 samples")

    # ---- evaluate_wav2vec2am on the model's own emissions -------------------
    am_dir = os.path.join(out_dir, "am")
    os.makedirs(os.path.join(am_dir, "emissions"))
    with open(os.path.join(am_dir, "config.json"), "w") as f:
        json.dump({"alphabet_labels": LABELS + ["<blank>"], "blank_id": len(LABELS)}, f)
    alphabet = config.resolve_alphabet()
    model = load_model(config, device)
    eval_step = make_eval_step()
    by_stem = {}
    for batch, ids in create_batches([paths["dev"]], alphabet, fc, batch_size=1):
        _, logits = eval_step(model, batch.to(device))
        stem = os.path.splitext(os.path.basename(ids[0]))[0]
        by_stem[stem] = torch.log_softmax(logits[0], dim=-1).cpu().numpy()
        np.save(os.path.join(am_dir, "emissions", stem + ".npy"), by_stem[stem])
    # in the CSV's order, as evaluate_wav2vec2am reads them
    emitted = [by_stem[os.path.splitext(os.path.basename(wav_path))[0]]
               for wav_path, _ in read_csv_entries([paths["dev"]])]
    del model
    res, rec = counted("evaluate_wav2vec2am", lambda: evaluate_wav2vec2am(
        [paths["dev"]], am_dir, emissions_dir=os.path.join(am_dir, "emissions"),
        beam_width=500), ("k5",))
    # the same probabilities through the batch device decoder in the
    # framework's own class layout (blank last, implied)
    probs = [np.exp(e) for e in emitted]
    want = ctc_beam_search_decoder_device(probs, [len(p) for p in probs], alphabet,
                                          beam_size=500)
    rec.update(samples=len(res), transcripts=[r.res for r in res])
    print("entry", json.dumps(rec), flush=True)
    if [r.res for r in res] != [w[0].transcript for w in want]:
        failures.append(f"evaluate_wav2vec2am gave {[r.res for r in res]}, the device decoder "
                        f"{[w[0].transcript for w in want]}")
    if failures:
        raise AssertionError("entry phase: " + "; ".join(failures))
    return {"runs": runs, "launches": totals, "gpu": card}


CAPI_PIECE_S = 0.32  # the C API stream's chunk, as the serving phase's streams


def write_pcm_wav(path: str, pcm: np.ndarray, rate: int) -> None:
    """16-bit mono WAV of `pcm` as it is, so stt_client reads these samples."""
    import wave

    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(rate)
        f.writeframes(pcm.astype("<i2").tobytes())


def same_c_metadata(name: str, got: list, want: list) -> None:
    """Transcripts, tokens and timesteps equal; confidences within
    DECODER_CONF_TOL (the C side passes them as doubles, unchanged)."""
    if [[(t, s) for t, s, _ in c[1]] for c in got] != [[(t, s) for t, s, _ in c[1]] for c in want]:
        raise AssertionError(f"{name}: C API tokens {got} differ from the in-process {want}")
    for (conf, _), (want_conf, _) in zip(got, want):
        if not abs(conf - want_conf) <= DECODER_CONF_TOL:
            raise AssertionError(f"{name}: confidence {conf} vs the in-process {want_conf}")


def capi_phase(device, seed: int, work_dir: str, scorers: dict, card: str) -> dict:
    """The C API (libstt_tpu_torch.so over serve.cbridge) on the full-width
    artifact of the serving phase, on the card:
    - through ctypes in this process: STT_SpeechToText and
      STT_SpeechToTextWithMetadata of a 3.3 s utterance as 16-bit PCM, and a
      stream fed 320 ms chunks with an intermediate decode after each and a
      final decode with metadata, with the word scorer and HOT_WORDS; each
      against the same request of an in-process `Model` on the card
      (transcripts, tokens and timesteps equal, confidences within
      DECODER_CONF_TOL), each run twice on each side in turns (C, in
      process, in process, C) and counted: K1 and no other kernel, the
      stream at least one K1 launch a model chunk (16 frames), and as many
      as the in-process stream;
    - the stt_client program in a subprocess (PYTHONPATH = the root), one-shot
      and --stream with --scorer: stdout's transcript equals the in-process
      one (the client streams 0.5 s chunks, without hot words).
    Records each request's wall ms beside the in-process one, and the
    client's wall seconds with its interpreter's boot."""
    from stt_tpu_torch.serve import Model, capi, cbridge

    t0 = time.time()
    config, fc, alphabet, n_params = smoke_artifact(work_dir, seed)
    rate = fc.sample_rate
    audios = serving_inputs(seed, fc, config.n_input)[0]
    pcms = [np.clip(a * 32768, -32768, 32767).astype(np.int16) for a in audios[1:]]
    floats = [p.astype(np.float32) / 32768.0 for p in pcms]  # what cbridge hands Model
    lib = capi.load()
    cbridge.set_device("cuda")
    handle = ctypes.c_void_p()
    if lib.STT_CreateModel(work_dir.encode(), ctypes.byref(handle)) != 0:
        raise AssertionError("STT_CreateModel failed on the full-width artifact")
    model = Model(work_dir)
    print(f"capi: {n_params} params; library built and loaded, model created by the C API and "
          f"in process in {time.time() - t0:.1f} s", flush=True)
    if [m.device.type for m in cbridge._MODELS.values()] != ["cuda"]:
        raise AssertionError("the C API's model is not on the card")
    requests, totals = [], {}

    def in_turns(name: str, c_fn, in_fn, audio_s: float) -> tuple:
        """The C API's request and the in-process one in turns (C, in
        process, in process, C), each counted; each side must give the same
        result and K1 launches both times. Returns (C result, in-process
        result, C record, in-process record)."""
        results, recs = {"capi": [], "in": []}, {"capi": [], "in": []}
        for side in ("capi", "in", "in", "capi"):
            result, ms, launches = run_counted(f"capi: {name} ({side})",
                                               c_fn if side == "capi" else in_fn, ("k1",))
            for key, n in launches.items():
                totals[key] = totals.get(key, 0) + n
            results[side].append(result)
            recs[side].append((ms, launches["k1"]))
        for side in recs:
            if results[side][0] != results[side][1] or recs[side][0][1] != recs[side][1][1]:
                raise AssertionError(f"{name}: two {side} runs differ: {results[side]}, {recs[side]}")
        rec = {side: {"ms": [ms for ms, _ in recs[side]], "rtf": min(ms for ms, _ in recs[side])
                      / 1e3 / audio_s, "k1_launches": recs[side][0][1]} for side in recs}
        return results["capi"][0], results["in"][0], rec["capi"], rec["in"]

    def record(name: str, audio_s: float, c_side: dict, in_process: dict, **extra) -> None:
        rec = {"request": name, "audio_s": audio_s, "capi": c_side, "in_process": in_process,
               "gpu": card, **extra}
        print("capi", json.dumps(rec), flush=True)
        requests.append(rec)

    lib.STT_SpeechToText(handle, capi.pcm_pointer(pcms[0][:rate // 2]), rate // 2)  # warm-up
    model.stt(floats[0][:rate // 2])
    # ---- one-shot and metadata, no scorer ------------------------------------
    pcm, audio_s = pcms[0], len(pcms[0]) / rate
    text, want, c_rec, in_rec = in_turns("STT_SpeechToText", lambda: capi.take_string(
        lib, lib.STT_SpeechToText(handle, capi.pcm_pointer(pcm), len(pcm))),
        lambda: model.stt(floats[0]), audio_s)
    if text != want:
        raise AssertionError(f"STT_SpeechToText gave {text!r}, Model.stt {want!r}")
    record("STT_SpeechToText", audio_s, c_rec, in_rec, transcript=text)
    got, want, c_rec, in_rec = in_turns("STT_SpeechToTextWithMetadata", lambda: capi.take_metadata(
        lib, lib.STT_SpeechToTextWithMetadata(handle, capi.pcm_pointer(pcm), len(pcm), 3)),
        lambda: cbridge._metadata_tuples(model.stt_with_metadata(floats[0], 3)), audio_s)
    same_c_metadata("STT_SpeechToTextWithMetadata", got, want)
    if "".join(t for t, _, _ in got[0][1]) != text:
        raise AssertionError("the best candidate's tokens do not spell STT_SpeechToText's text")
    record("STT_SpeechToTextWithMetadata[3]", audio_s, c_rec, in_rec, candidates=len(got))

    # ---- a stream with the scorer and hot words ------------------------------
    scorer = scorers["alphabet"]["path"]
    if lib.STT_EnableExternalScorer(handle, scorer.encode()) != 0:
        raise AssertionError("STT_EnableExternalScorer failed")
    model.enable_external_scorer(scorer)
    for word, boost in HOT_WORDS.items():
        if lib.STT_AddHotWord(handle, word.encode(), boost) != 0:
            raise AssertionError(f"STT_AddHotWord({word}) failed")
        model.add_hot_word(word, boost)
    piece = int(CAPI_PIECE_S * rate)
    pcm, audio_s = pcms[1], len(pcms[1]) / rate

    def c_stream():
        stream = ctypes.c_void_p()
        if lib.STT_CreateStream(handle, ctypes.byref(stream)) != 0:
            raise AssertionError("STT_CreateStream failed")
        partial = []
        for off in range(0, len(pcm), piece):
            chunk = np.ascontiguousarray(pcm[off:off + piece])
            lib.STT_FeedAudioContent(stream, capi.pcm_pointer(chunk), len(chunk))
            partial.append(capi.take_string(lib, lib.STT_IntermediateDecode(stream)))
        return partial, capi.take_metadata(lib, lib.STT_FinishStreamWithMetadata(stream, 3))

    def in_process_stream():
        stream = model.create_stream()
        partial = []
        for off in range(0, len(pcm), piece):
            stream.feed_audio_content(floats[1][off:off + piece])
            partial.append(stream.intermediate_decode())
        return partial, cbridge._metadata_tuples(stream.finish_stream_with_metadata(3))

    (partial, final), (want_partial, want_final), c_rec, in_rec = in_turns(
        "stream", c_stream, in_process_stream, audio_s)
    if partial != want_partial:
        raise AssertionError(f"C API intermediate decodes {partial} differ from {want_partial}")
    same_c_metadata("C API stream", final, want_final)
    frames = (len(pcm) - fc.window_samples) // fc.step_samples + 1
    if c_rec["k1_launches"] != in_rec["k1_launches"] or c_rec["k1_launches"] < frames // 16:
        raise AssertionError(f"C API stream launched K1 {c_rec['k1_launches']} times, the "
                             f"in-process one {in_rec['k1_launches']}, over {frames} frames")
    if cbridge._STREAMS:
        raise AssertionError(f"finished streams left in the bridge's table: {cbridge._STREAMS}")
    final_text = "".join(t for t, _, _ in final[0][1])
    record(f"stream[{int(CAPI_PIECE_S * 1e3)}ms, scorer + hot words]", audio_s, c_rec, in_rec,
           chunks=len(partial), frames=frames, transcript=final_text)
    lib.STT_FreeModel(handle)
    if cbridge._MODELS:
        raise AssertionError("STT_FreeModel left the model in the bridge's table")

    # ---- stt_client in a subprocess: one-shot, and --stream with the scorer -
    client = capi.client()
    wav = os.path.join(work_dir, "capi.wav")
    write_pcm_wav(wav, pcms[1], rate)
    plain = Model(work_dir)
    client_piece = rate // 2  # stt_client's stream chunk
    scored = Model(work_dir)
    scored.enable_external_scorer(scorer)
    stream = scored.create_stream()
    for off in range(0, len(pcms[1]), client_piece):
        stream.feed_audio_content(floats[1][off:off + client_piece])
        stream.intermediate_decode()
    expected = {"one-shot": plain.stt(floats[1]), "--stream --scorer": stream.finish_stream()}
    clients = []
    for mode, flags in (("one-shot", []), ("--stream --scorer", ["--stream", "--scorer", scorer])):
        start = time.perf_counter()
        proc = subprocess.run([str(client), "--model", work_dir, "--audio", wav, *flags],
                              capture_output=True, text=True, timeout=300,
                              env={**os.environ, "PYTHONPATH": ROOT})
        wall_s = time.perf_counter() - start
        if proc.returncode != 0:
            raise AssertionError(f"stt_client {mode} exited {proc.returncode}: {proc.stderr[-2000:]}")
        rec = {"client": mode, "wall_s": wall_s, "transcript": proc.stdout.strip(),
               "expected": expected[mode], "gpu": card}
        print("capi", json.dumps(rec), flush=True)
        if rec["transcript"] != expected[mode]:
            raise AssertionError(f"stt_client {mode} printed {rec['transcript']!r}, "
                                 f"in process {expected[mode]!r}")
        clients.append(rec)
    return {"requests": requests, "clients": clients, "launches": totals, "gpu": card}


TFLITE_FIXTURES = {kind: os.path.join(ROOT, "tests", "fixtures", f"reference_{kind}.tflite")
                   for kind in ("f32", "int8")}  # written by tests/torch_tflite_fixture.py


def compat_phase(device, seed: int, work_dir: str, card: str) -> dict:
    """The committed reference-format .tflite fixtures (f32 and int8
    dynamic-range, 64 wide; written by the port's exporter, so that a
    machine without TensorFlow serves them) imported by the port's reader, saved as
    artifacts and served by `Model(dir)` on the card: logits of a seeded
    batch within COMPAT_LOGITS_TOL of `Model(dir, device="cpu")`'s, and the
    transcripts of three utterances equal; each request launches K1 and no
    other kernel."""
    from stt_tpu_torch.artifact import save_tflite_as_artifact
    from stt_tpu_torch.frontend import audio_to_mfcc
    from stt_tpu_torch.serve import Model

    rng = np.random.RandomState(seed + 7)
    runs, totals = [], {}
    for kind, fixture in TFLITE_FIXTURES.items():
        start = time.perf_counter()
        path, geometry = save_tflite_as_artifact(fixture, os.path.join(work_dir, kind))
        import_ms = (time.perf_counter() - start) * 1e3
        gpu, cpu = Model(path), Model(path, device="cpu")
        assert gpu.device.type == "cuda"
        fc = gpu.feature_config
        audios = [utterance(s, fc.sample_rate, rng) for s in (1.5, 2.5, 3.5)]
        feats = [audio_to_mfcc(torch.from_numpy(a), fc).numpy() for a in audios]
        lengths = np.array([len(f) for f in feats], np.int32)
        padded = np.zeros((len(feats), lengths.max(), geometry["n_input"]), np.float32)
        for i, f in enumerate(feats):
            padded[i, :len(f)] = f
        gpu.stt(audios[0])  # warm-up
        texts, ms, launches = run_counted(f"compat {kind}: stt", lambda: [gpu.stt(a) for a in audios],
                                          ("k1",))
        logits, logits_ms, logits_launches = run_counted(
            f"compat {kind}: infer_logits", lambda: gpu.infer_logits(padded, lengths), ("k1",))
        want = cpu.infer_logits(padded, lengths)
        err = 0.0
        for i, n in enumerate(lengths):
            err = max(err, float((logits[i, :n].cpu() - want[i, :n]).abs().max()))
        want_texts = [cpu.stt(a) for a in audios]
        for key in launches:
            totals[key] = totals.get(key, 0) + launches[key] + logits_launches[key]
        rec = {"fixture": os.path.relpath(fixture, ROOT), "bytes": os.path.getsize(fixture),
               "geometry": geometry, "import_ms": import_ms, "stt_ms": ms, "infer_logits_ms": logits_ms,
               "k1_launches": launches["k1"] + logits_launches["k1"], "logits_max_abs_err": err,
               "transcripts": texts, "gpu": card}
        print("compat", json.dumps(rec), flush=True)
        if not err <= COMPAT_LOGITS_TOL:
            raise AssertionError(f"compat {kind}: card logits {err} from the CPU's "
                                 f"(tol {COMPAT_LOGITS_TOL})")
        if texts != want_texts:
            raise AssertionError(f"compat {kind}: card transcripts {texts}, CPU {want_texts}")
        runs.append(rec)
    return {"runs": runs, "launches": totals, "gpu": card}


IMPORT_SPLITS = {  # (corpus, CSV): rows the import must write
    ("ldc93s1", "ldc93s1.csv"): 1,
    ("librispeech", "LibriSpeech/librivox-dev-clean.csv"): 8,
    ("timit", "timit_train.csv"): 3, ("timit", "timit_test.csv"): 2,
    ("timit", "timit_all.csv"): 5,
    ("common_voice", "out/train.csv"): 4, ("common_voice", "out/dev.csv"): 2,
    ("switchboard", "swb-train.csv"): 3, ("switchboard", "swb-dev.csv"): 1,
    ("switchboard", "swb-test.csv"): 1,
}
IMPORT_TRAIN = ("LibriSpeech/librivox-dev-clean.csv", "timit_train.csv", "out/train.csv",
                "swb-train.csv")
IMPORT_TEST = ("timit_test.csv", "out/dev.csv", "swb-test.csv")
SWB_SEGMENTS = (("A", 0.5, 3.0), ("A", 3.5, 6.5), ("A", 10.5, 13.5), ("B", 1.0, 4.0),
                ("B", 14.0, 17.5))  # (channel, start s, stop s) with words; A 7-10 s is noise


def write_import_corpora(root: str, rng: np.random.RandomState) -> dict:
    """Five corpora under `root` in their published layouts, from `rng`:
    LDC93S1 (a 3 s WAV and its .txt with the sample indices), LibriSpeech
    dev-clean (FLAC and .trans.txt in capitals), TIMIT (NIST SPHERE .WAV
    and .TXT prompts, one SA prompt), Common Voice (clips/*.wav with
    train.tsv and dev.tsv) and Switchboard (a two-channel 8 kHz mu-law
    SPHERE call of 20 s with MS98 transcripts, one segment noise only).
    Returns each corpus's transcripts, folded as its importer folds them,
    and the argv of its importer's main."""
    from stt_tpu_torch.data import write_wav
    from stt_tpu_torch.data.sph import write_sph

    rate = 16000
    shutil.rmtree(root, ignore_errors=True)
    want = {}

    def folder(*parts) -> str:
        path = os.path.join(root, *parts)
        os.makedirs(path, exist_ok=True)
        return path

    source = folder("ldc93s1_source")
    text = transcript(3.0, rng)
    write_wav(os.path.join(source, "LDC93S1.wav"), utterance(3.0, rate, rng), rate)
    with open(os.path.join(source, "LDC93S1.txt"), "w") as f:
        f.write(f"0 {3 * rate} {text.capitalize()}.\n")
    want["ldc93s1"] = ([text], [folder("ldc93s1"), "--source_dir", source])

    chapter = folder("librispeech", "LibriSpeech", "dev-clean", "1272", "128104")
    lines, texts = [], []
    for i in range(8):
        seconds = rng.uniform(2.0, 5.0)
        texts.append(transcript(seconds, rng))
        write_flac(os.path.join(chapter, f"1272-128104-{i:04d}.flac"),
                   utterance(seconds, rate, rng), rate)
        lines.append(f"1272-128104-{i:04d} {texts[-1].upper()}\n")
    with open(os.path.join(chapter, "1272-128104.trans.txt"), "w") as f:
        f.write("".join(lines))
    want["librispeech"] = (texts, [os.path.join(root, "librispeech"), "--sets", "dev-clean",
                                   "--base_url", ""])

    texts = []
    for subset, speaker, utt in (("TRAIN", "DR1/FCJF0", "SA1"), ("TRAIN", "DR1/FCJF0", "SI1027"),
                                 ("TRAIN", "DR1/FCJF0", "SX127"), ("TRAIN", "DR2/MABC0", "SX64"),
                                 ("TEST", "DR1/FAKS0", "SI943"), ("TEST", "DR1/FAKS0", "SX133")):
        path = folder("timit", "TIMIT", subset, *speaker.split("/"))
        seconds = rng.uniform(2.0, 4.0)
        text = transcript(seconds, rng)
        write_sph(os.path.join(path, f"{utt}.WAV"), utterance(seconds, rate, rng), rate)
        with open(os.path.join(path, f"{utt}.TXT"), "w") as f:
            f.write(f"0 {int(seconds * rate)} {text.capitalize()}.\n")
        if not utt.startswith("SA"):  # the calibration prompts are not imported
            texts.append(text)
    want["timit"] = (texts, [os.path.join(root, "timit")])

    clips, texts = folder("common_voice", "clips"), []
    for split, n in (("train", 4), ("dev", 2)):
        lines = ["client_id\tpath\tsentence\tup_votes\tdown_votes"]
        for i in range(n):
            seconds = rng.uniform(2.0, 4.0)
            texts.append(transcript(seconds, rng))
            name = f"common_voice_en_{split}_{i}.wav"
            write_wav(os.path.join(clips, name), utterance(seconds, rate, rng), rate)
            lines.append(f"speaker{i}\t{name}\t{texts[-1].capitalize()}!\t2\t0")
        with open(os.path.join(root, "common_voice", f"{split}.tsv"), "w") as f:
            f.write("\n".join(lines) + "\n")
    want["common_voice"] = (texts, [
        "--audio_dir", clips, "--tsv_dir", os.path.join(root, "common_voice"),
        "--target_dir", os.path.join(root, "common_voice", "out"), "--workers", "2"])

    call = folder("switchboard", "swb1_d1", "data")
    channels = np.stack([utterance(20.0, 8000, rng), utterance(20.0, 8000, rng)], axis=-1)
    write_sph(os.path.join(call, "sw02001.sph"), channels, 8000, coding="ulaw")
    trans = folder("switchboard", "swb_ms98_transcriptions", "20", "2001")
    lines, texts = {"A": [], "B": []}, []
    for side, start, stop in SWB_SEGMENTS:
        texts.append(transcript(stop - start, rng))
        words = texts[-1].split(" ")
        words.insert(len(words) // 2, "[laughter]")  # an annotation the importer drops
        lines[side].append((start, stop, " ".join(words)))
    lines["A"].insert(2, (7.0, 10.0, "[noise]"))
    for side, segments in lines.items():
        with open(os.path.join(trans, f"sw2001{side}-ms98-a-trans.text"), "w") as f:
            f.write("".join(f"sw2001{side}-ms98-a-{i + 1:04d} {start:.2f} {stop:.2f} {words}\n"
                            for i, (start, stop, words) in enumerate(segments)))
    want["switchboard"] = (texts, [os.path.join(root, "switchboard")])
    return want


def read_rows(path: str) -> list:
    import csv

    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.DictReader(f))


def import_phase(device, seed: int, work_dir: str, card: str) -> dict:
    """The port's counterpart of bin/run-ldc93s1.sh with a multi-corpus
    import, at full width on the card:
    - five corpora written from the seed in their published layouts
      (`write_import_corpora`), each imported by its importer's main(argv)
      in this process (Common Voice through import_cv2's pool of 2 spawned
      workers): each CSV has the rows that were built (TIMIT's SA prompt
      and Switchboard's noise-only segment dropped), its transcripts are
      the written ones after the importer's folding, and every WAV reads
      back as 16 kHz mono;
    - `train(config, device="cuda")` of the full-width model (n_hidden
      2048) on the LibriSpeech, TIMIT, Common Voice and Switchboard train
      CSVs with LDC93S1 as dev, B = 8, one epoch, dropout 0.05: at least 3
      steps, K3 and K4 once a step, finite losses, parameters that move;
    - `stt_tpu_torch.evaluate.main` on the TIMIT, Common Voice and
      Switchboard test CSVs with --device_decode full at beam 32: K1 and
      K5, no training kernel (its WER is that of random weights: a cost,
      not a score).
    Prints each importer's wall ms and audio-s, the rows per CSV, the train
    steps, wall s and audio-s/s, evaluate's wall ms and the phase's
    launches, each beside the card's name and power limit."""
    import importlib

    from stt_tpu_torch import evaluate as evaluate_module
    from stt_tpu_torch.config import SttConfig
    from stt_tpu_torch.data.audio import read_audio
    from stt_tpu_torch.models import DeepSpeech
    from stt_tpu_torch.train.trainer import train

    corpora = os.path.join(work_dir, "corpora")
    want = write_import_corpora(corpora, np.random.RandomState(seed + 13))
    modules = {"ldc93s1": "import_ldc93s1", "librispeech": "import_librivox",
               "timit": "import_timit", "common_voice": "import_cv2", "switchboard": "import_swb"}
    imports, rows, failures = [], {}, []
    for corpus, (texts, argv) in want.items():
        main = importlib.import_module(f"stt_tpu_torch.tools.{modules[corpus]}").main
        start = time.perf_counter()
        main(argv)
        ms = (time.perf_counter() - start) * 1e3
        base = os.path.join(corpora, corpus)
        got, audio_s = [], 0.0
        for (name, rel), n in IMPORT_SPLITS.items():
            if name != corpus:
                continue
            rows[rel] = read_rows(os.path.join(base, rel))
            if len(rows[rel]) != n:
                failures.append(f"{rel}: {len(rows[rel])} rows, built {n}")
            if rel != "timit_all.csv":
                got += [r["transcript"] for r in rows[rel]]
            for r in rows[rel]:
                audio, rate = read_audio(r["wav_filename"])
                if rate != 16000 or audio.ndim != 1 or os.path.getsize(r["wav_filename"]) != int(
                        r["wav_filesize"]):
                    failures.append(f"{r['wav_filename']}: {rate} Hz, shape {audio.shape}")
                if rel != "timit_all.csv":
                    audio_s += len(audio) / rate
        if sorted(got) != sorted(texts):
            failures.append(f"{corpus}: imported {sorted(got)}, written {sorted(texts)}")
        rec = {"importer": modules[corpus], "wall_ms": ms, "audio_s": audio_s, "rows": len(got),
               "gpu": card}
        print("import", json.dumps(rec), flush=True)
        imports.append(rec)
    print("import rows", json.dumps({rel: len(r) for rel, r in rows.items()}), flush=True)
    if failures:
        raise AssertionError("import phase: " + "; ".join(failures))
    csv_of = {rel: os.path.join(corpora, corpus, rel) for corpus, rel in IMPORT_SPLITS}

    alphabet = os.path.join(work_dir, "alphabet.txt")
    with open(alphabet, "w") as f:
        f.write("".join(label + "\n" for label in LABELS))
    ckpt, summary = os.path.join(work_dir, "checkpoints"), os.path.join(work_dir, "summary")
    shutil.rmtree(ckpt, ignore_errors=True)
    shutil.rmtree(summary, ignore_errors=True)
    config = SttConfig(
        train_files=[csv_of[rel] for rel in IMPORT_TRAIN], dev_files=[csv_of["ldc93s1.csv"]],
        alphabet_config_path=alphabet, n_hidden=2048, train_batch_size=8, dev_batch_size=8,
        epochs=1, dropout_rate=0.05, checkpoint_dir=ckpt, summary_dir=summary, seed=seed)
    initial = DeepSpeech(config.model_config(training=True),
                         generator=torch.Generator().manual_seed(seed)).state_dict()
    state, train_ms, launches = run_counted("import: train", lambda: train(config, device="cuda"),
                                            ("k1", "k3", "k4"))
    train_audio_s = sum(float(r["wav_filesize"]) - 44 for rel in IMPORT_TRAIN
                        for r in rows[rel]) / 2 / 16000
    with open(os.path.join(summary, "scalars.jsonl")) as f:
        step_losses = [r["train/step_loss"] for r in map(json.loads, f) if "train/step_loss" in r]
    moved = sum(not torch.equal(v.detach().cpu(), initial[k]) for k, v in state.params.items())
    rec = {"steps": state.step, "train_s": train_ms / 1e3, "samples": sum(
        len(rows[rel]) for rel in IMPORT_TRAIN), "audio_s": train_audio_s,
        "audio_s_per_s": train_audio_s / (train_ms / 1e3), "launches": launches,
        "step_losses": step_losses, "params_moved": f"{moved} of {len(initial)}", "gpu": card}
    print("import train", json.dumps(rec), flush=True)
    if not launches["k3"] == launches["k4"] == state.step >= 3:
        failures.append(f"every train step must launch K3 and K4: {launches}, {state.step} steps")
    if len(step_losses) != state.step - 1 or not np.isfinite(step_losses).all():
        failures.append(f"train step losses: {step_losses}")
    if moved != len(initial):
        failures.append(f"parameters moved: {moved} of {len(initial)}")

    argv = ["--test_files", ",".join(csv_of[rel] for rel in IMPORT_TEST),
            "--checkpoint_dir", ckpt, "--alphabet_config_path", alphabet, "--n_hidden", "2048",
            "--test_batch_size", "8", "--device_decode", "full", "--export_beam_width", "32"]
    _, eval_ms, eval_launches = run_counted("import: evaluate",
                                            lambda: evaluate_module.main(argv), ("k1", "k5"))
    evaluated = {"wall_ms": eval_ms, "launches": eval_launches, "test_files": list(IMPORT_TEST),
                 "samples": sum(len(rows[rel]) for rel in IMPORT_TEST), "gpu": card}
    print("import evaluate", json.dumps(evaluated), flush=True)
    totals = {key: launches[key] + eval_launches[key] for key in launches}
    print(f"import: launches {json.dumps(totals)}; gpu: {card}", flush=True)
    if failures:
        raise AssertionError("import phase: " + "; ".join(failures))
    return {"imports": imports, "rows": {rel: len(r) for rel, r in rows.items()}, "train": rec,
            "evaluate": evaluated, "launches": totals, "gpu": card}


SCRIPTS_DIR = os.path.join(ROOT, "stt_tpu_torch", "bin")
# the scripts run in two lanes side by side, each lane's in order: the fused
# script trains the endurance script's alignment checkpoint, and that lane
# is the phase's length (on an H100, run alone, 154 + 175 s; the other
# lane's five 296 s; beside two other lanes it took 370-441 s)
SCRIPT_LANES = (
    ("run-ci-ldc93s1_fused.sh", "run-flagship-endurance.sh"),
    ("run-ci-ldc93s1_new.sh", "run-ldc93s1.sh", "run-ci-ldc93s1_checkpoint.sh",
     "run-ci-ldc93s1_audio_formats.sh", "run-ci-multihost.sh"),
)
SCRIPT_KERNELS = {  # the kernels each script's commands must launch on the card
    "run-ci-ldc93s1_fused.sh": ("k1", "k3", "k4"),  # training (dev passes K1), evaluate
    "run-flagship-endurance.sh": ("k1", "k3", "k4"),
    "run-ci-ldc93s1_new.sh": ("k1", "k3", "k4"),
    "run-ldc93s1.sh": ("k1", "k3", "k4"),
    "run-ci-ldc93s1_checkpoint.sh": ("k1", "k3", "k4"),
    "run-ci-ldc93s1_audio_formats.sh": ("k3", "k4"),
    "run-ci-multihost.sh": ("k3", "k4"),
}
# the endurance script at its own epochs=1 and a short Russian leg
ENDURANCE_EPOCHS, ENDURANCE_RU_EPOCHS = 1, 5
SCRIPT_TIMEOUT_S = 480  # each script's own limit; its process group is killed past it
SCRIPT_THREADS = 2  # each script process's CPU threads (OMP_NUM_THREADS)
SCRIPT_GATES = (  # lines of a script's log that show its gates and results
    "decoded: ", " OK", "WER: ", "transcript", "aligned words:", "Wrote ", "wrote ")


def run_script(name: str, env: dict, work_dir: str, card: str) -> dict:
    """`sh stt_tpu_torch/bin/<name>` from the root of the checkout with
    `env` added, its output in work_dir/<name>.log, its processes' kernel
    launches counted through launch_log's file. Kills the script's process
    group when it ends or passes SCRIPT_TIMEOUT_S."""
    from stt_tpu_torch.ops import launch_log

    log, counts = (os.path.join(work_dir, name + ext) for ext in (".log", ".launches"))
    if os.path.exists(counts):
        os.remove(counts)
    start = time.perf_counter()
    with open(log, "w") as out:
        proc = subprocess.Popen(["sh", os.path.join(SCRIPTS_DIR, name)], cwd=ROOT, stdout=out,
                                stderr=subprocess.STDOUT, start_new_session=True,
                                env={**os.environ, **env, launch_log.ENV: counts})
        try:
            rc = proc.wait(timeout=SCRIPT_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            rc = "timeout"
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    wall_s = time.perf_counter() - start
    with open(log, errors="replace") as f:
        lines = f.read().splitlines()
    shown = [line for line in lines if not line.startswith("+") and any(g in line for g in SCRIPT_GATES)]
    epochs = [line for line in lines if "| train loss " in line]
    return {"script": name, "rc": rc, "wall_s": wall_s, "launches": launch_log.read(counts),
            "lines": shown[:6] + (["..."] + shown[-6:] if len(shown) > 12 else shown[6:]),
            "epoch_lines": len(epochs), "last_epoch": epochs[-1] if epochs else None,
            "log": os.path.relpath(log, ROOT), "tail": lines[-15:], "gpu": card}


def scripts_phase(device, seed: int, work_dir: str, card: str) -> dict:
    """The port's scripts, as a user runs them, on the card:
    - the benchmark tool at its defaults (`tools.benchmark.main([])`: K1 in
      bf16 at B 128, T 500; the 2048 stream at beam 64 through K1; a bf16
      train step at B 64, T 500 through K3 and K4), in this process: its
      three records;
    - the stream latency probe (`tools.probe_stream_latency`: K5 over 500
      frames in chunks of 16 against the host decoder): both times, and the
      transcripts must be equal;
    - every stt_tpu_torch/bin/ script through `sh`, two lanes side by side
      (SCRIPT_LANES), with smoke=, alphabet= and work= (or run-ldc93s1.sh's
      own variables) on a `write_smoke_set` tree, device=cuda, and the
      endurance script at epochs=1, ru_epochs=5 with the fused script's
      checkpoint for its alignment. Each must exit 0 with its gates as
      written (the exact transcript of run-ci-ldc93s1_new.sh and _fused.sh,
      make_spliced_corpus's alignment assert, the checkpoint files, the
      multihost losses' cmp), and its processes must launch the kernels of
      SCRIPT_KERNELS (counted by STT_TORCH_LAUNCH_LOG, since the wrappers'
      counts live in the child processes).
    `python` on the scripts' PATH is this interpreter. Prints each script's
    wall, exit code, launches and result lines, the records and the probe's
    lines, beside the card's name and power limit."""
    from stt_tpu_torch.tools import benchmark, probe_stream_latency

    shutil.rmtree(work_dir, ignore_errors=True)
    os.makedirs(work_dir)
    start = time.perf_counter()
    data = write_smoke_set(os.path.join(work_dir, "data"), seed)
    bin_dir = os.path.join(work_dir, "bin")
    os.makedirs(bin_dir)
    with open(os.path.join(bin_dir, "python"), "w") as f:
        f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    os.chmod(os.path.join(bin_dir, "python"), 0o755)
    print(f"scripts: smoke set written in {time.perf_counter() - start:.1f} s; gpu: {card}",
          flush=True)

    records, bench_ms, bench_launches = run_counted(
        "scripts: benchmark", lambda: benchmark.main([]), ("k1", "k3", "k4"))
    bench = {"records": records, "wall_ms": bench_ms, "launches": bench_launches, "gpu": card}
    print("scripts benchmark", json.dumps(bench), flush=True)
    probe, probe_ms, probe_launches = run_counted(
        "scripts: probe", lambda: probe_stream_latency.main(["--alphabet", data["alphabet"]]),
        ("k5",))
    probe = {**probe, "wall_ms": probe_ms, "launches": probe_launches, "gpu": card}
    print("scripts probe", json.dumps(probe), flush=True)
    failures = [] if probe["transcripts_equal"] else ["probe: the transcripts differ"]

    w = lambda name: os.path.join(work_dir, name)  # noqa: E731
    # the lanes (three processes with the multihost ranks) share the host's
    # cores: two CPU threads each rather than one per core each
    common = {"PATH": bin_dir + os.pathsep + os.environ.get("PATH", ""), "device": "cuda",
              "smoke": data["smoke"], "alphabet": data["alphabet"],
              "OMP_NUM_THREADS": str(SCRIPT_THREADS)}
    envs = {
        "run-ci-ldc93s1_fused.sh": {"work": w("fused")},
        "run-flagship-endurance.sh": {"work": w("flagship"), "align_ckpt": w("fused/ckpt"),
                                      "epochs": str(ENDURANCE_EPOCHS),
                                      "ru_epochs": str(ENDURANCE_RU_EPOCHS)},
        "run-ci-ldc93s1_new.sh": {"work": w("new")},
        "run-ldc93s1.sh": {"ldc93s1_dir": w("ldc93s1/data"), "ckpt_dir": w("ldc93s1/ckpt"),
                           "export_dir": w("ldc93s1/model"), "smoke_src": data["smoke"]},
        "run-ci-ldc93s1_checkpoint.sh": {"work": w("checkpoint")},
        "run-ci-ldc93s1_audio_formats.sh": {"work": w("formats")},
        "run-ci-multihost.sh": {"work": w("multihost"), "port": str(free_port())},
    }
    results = {}

    def lane(names):
        for name in names:
            results[name] = run_script(name, {**common, **envs[name]}, work_dir, card)
            if results[name]["rc"] != 0:
                return  # the phase fails; the endurance script needs the fused one's checkpoint

    torch.cuda.empty_cache()  # the benchmark's cached blocks, for the scripts' processes
    lanes_start = time.perf_counter()
    threads = [threading.Thread(target=lane, args=(names,)) for names in SCRIPT_LANES]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    lanes_s = time.perf_counter() - lanes_start
    for names in SCRIPT_LANES:
        for name in names:
            if name not in results:
                failures.append(f"{name}: not run, an earlier script of its lane failed")
                continue
            rec = results[name]
            print("scripts run", json.dumps({k: v for k, v in rec.items() if k != "tail"}),
                  flush=True)
            missing = [k for k in SCRIPT_KERNELS[name] if not rec["launches"][k]]
            if rec["rc"] != 0:
                failures.append(f"{name}: exit {rec['rc']}, log {rec['log']}:\n"
                                + "\n".join(rec["tail"]))
            elif missing:
                failures.append(f"{name}: launched no {missing}: {rec['launches']}")
    totals = {k: bench_launches[k] + probe_launches[k]
              + sum(r["launches"][k] for r in results.values()) for k in bench_launches}
    wall_s = time.perf_counter() - start
    print(f"scripts: launches {json.dumps(totals)}; the scripts' lanes {lanes_s:.1f} s; "
          f"the phase {wall_s:.1f} s; gpu: {card}", flush=True)
    if failures:
        raise AssertionError("scripts phase: " + "\n".join(failures))
    return {"benchmark": bench, "probe": probe, "scripts": results, "launches": totals,
            "lanes_s": lanes_s, "wall_s": wall_s, "gpu": card}


def build_native_decoder(out: dict) -> None:
    """Build (g++) and load the port's native CTC decoder, then build (g++,
    gcc) the C API's library and stt_client, and (g++ -pg) the decoder's
    profiling driver; records the seconds each took and their paths in
    `out`, or the error."""
    from stt_tpu_torch import native_build
    from stt_tpu_torch.decode import native
    from stt_tpu_torch.serve import capi

    start = time.time()
    try:
        native.library()
        out.update(s=time.time() - start, library=os.path.relpath(native.LIBRARY, ROOT))
        start = time.time()
        capi.client()
        out.update(capi_s=time.time() - start, capi=[os.path.relpath(p, ROOT)
                                                      for p in (capi.LIBRARY, capi.CLIENT)])
        start = time.time()
        prof = native_build.build_prof_decoder()
    except RuntimeError as e:
        out["error"] = str(e)
        return
    out.update(prof_s=time.time() - start, prof=os.path.relpath(prof, ROOT))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", help="write the full record here as JSON")
    parser.add_argument("--k5-against", metavar="BEAM_SCAN_CU",
                        help="with --phases k5: also time K5 in turns against this version of "
                             "its source")
    parser.add_argument("--phases", default="",
                        help="comma-separated phases (k1, k2, k3k4, k5, backtrack, decoder, "
                             "evaluation, "
                             "input, pool, augment, parallel, tp, entry, capi, compat, import, "
                             "scripts) to "
                             "run alone "
                             "(evaluation and entry train their checkpoint first), for work on "
                             "a kernel, the host decoder or a module: prints their records and "
                             "no result line")
    # one rank of the parallel or the tp phase, in a process that phase starts
    parser.add_argument("--parallel-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--parallel-port", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--parallel-dir", help=argparse.SUPPRESS)
    parser.add_argument("--tp-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--tp-world", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--tp-model", type=int, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    if args.parallel_rank is not None:
        return parallel_rank(args.parallel_rank, args.parallel_port, args.parallel_dir, args.seed)
    if args.tp_rank is not None:
        return tp_rank(args.tp_rank, args.tp_world, args.tp_model, args.parallel_port,
                       args.parallel_dir, args.seed)
    from stt_tpu_torch.device import resolve_device
    from stt_tpu_torch.ops import _build

    card = gpu_line()
    print(f"gpu: {card}", flush=True)
    print(sys.version.split()[0], "torch", torch.__version__, "cuda", torch.version.cuda, flush=True)
    device = resolve_device("cuda")
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}", flush=True)
    t0 = time.time()
    # the host decoder's g++ build runs beside the kernels' nvcc builds
    native_build = {}
    host = threading.Thread(target=build_native_decoder, args=(native_build,))
    host.start()
    for name, report in _build.build().items():
        print(f"built {name}:\n{report}", flush=True)
    host.join()
    if "error" in native_build:
        raise RuntimeError(native_build["error"])
    print(f"build: {time.time() - t0:.1f} s (native decoder {native_build['s']:.1f} s, "
          f"{native_build['library']}; C API {native_build['capi_s']:.1f} s, "
          f"{', '.join(native_build['capi'])}; profiling driver {native_build['prof_s']:.1f} s, "
          f"{native_build['prof']})", flush=True)
    work_dir = os.path.join(ROOT, "build", "chip_smoke")

    if args.phases:
        alone = {"k1": k1_phase, "k2": k2_phase, "k3k4": train_kernel_phase, "k5": k5_phase,
                 "backtrack": backtrack_phase}
        for name in args.phases.split(","):
            if name in ("input", "import", "scripts"):
                phase = {"input": input_phase, "import": import_phase,
                         "scripts": scripts_phase}[name]
                phase(device, args.seed, os.path.join(work_dir, name), card)
                continue
            if name == "decoder":
                decoder_phase(device, args.seed, build_scorers(os.path.join(work_dir, "lm"), args.seed),
                              decoder_inputs(device, args.seed, os.path.join(work_dir, "model")))
                continue
            if name in ("evaluation", "entry"):  # on the checkpoint the training phase makes
                scorers = build_scorers(os.path.join(work_dir, "lm"), args.seed)
                training = training_phase(device, args.seed, os.path.join(work_dir, "train"))
                phase = evaluation_phase if name == "evaluation" else entry_phase
                phase(device, args.seed, os.path.join(work_dir, "train"), training["paths"],
                      scorers, card)
                continue
            if name == "capi":
                capi_phase(device, args.seed, os.path.join(work_dir, "capi"),
                           build_scorers(os.path.join(work_dir, "lm"), args.seed), card)
                continue
            modules = {"pool": pool_phase, "augment": augment_phase, "parallel": parallel_phase,
                       "tp": tp_phase, "compat": compat_phase}
            if name in modules:
                modules[name](device, args.seed, os.path.join(work_dir, name), card)
                continue
            records = alone[name](device, args.seed)
            if name == "k5":
                k5_split(device, args.seed, records)
                if args.k5_against:
                    k5_against(device, args.seed, args.k5_against)
        print(f"gpu: {card}")
        print("chip_smoke: ran only", args.phases, "- no result line")
        return 0
    k1 = k1_phase(device, args.seed)
    k2 = k2_phase(device, args.seed)
    k3k4 = train_kernel_phase(device, args.seed)
    k5 = k5_phase(device, args.seed)
    k5_phases = k5_split(device, args.seed, k5)
    backtrack = backtrack_phase(device, args.seed)
    scorers = build_scorers(os.path.join(work_dir, "lm"), args.seed)
    serving = serving_phase(device, args.seed, os.path.join(work_dir, "model"), scorers)
    decoder = decoder_phase(device, args.seed, scorers, serving.pop("decoder_inputs"))
    training = training_phase(device, args.seed, os.path.join(work_dir, "train"))
    evaluation = evaluation_phase(device, args.seed, os.path.join(work_dir, "train"),
                                  training["paths"], scorers, card)
    inputs = input_phase(device, args.seed, os.path.join(work_dir, "input"), card)
    pool = pool_phase(device, args.seed, os.path.join(work_dir, "pool"), card)
    augment = augment_phase(device, args.seed, os.path.join(work_dir, "augment"), card)
    parallel = parallel_phase(device, args.seed, os.path.join(work_dir, "parallel"), card)
    one_rank = parallel["one_rank"]["launches"]
    tp = tp_phase(device, args.seed, os.path.join(work_dir, "tp"), card)
    entry = entry_phase(device, args.seed, os.path.join(work_dir, "train"), training["paths"],
                        scorers, card)
    capi = capi_phase(device, args.seed, os.path.join(work_dir, "capi"), scorers, card)
    compat = compat_phase(device, args.seed, os.path.join(work_dir, "compat"), card)
    imported = import_phase(device, args.seed, os.path.join(work_dir, "import"), card)
    scripts = scripts_phase(device, args.seed, os.path.join(work_dir, "scripts"), card)

    # K1 at the serving path's stream shape: batch 1, 16 steps, f32
    main_shape = next(r for r in k1 if (r["dtype"], r["B"], r["T"]) == ("float32", 1, 16))
    kernels = [{
        "name": "lstm_recurrence",
        "route": "cuda",
        "source": "stt_tpu_torch/ops/csrc/lstm_recurrence.cu",
        "replaces": "stt_tpu/ops/lstm_kernel.py:44",
        "launches": (sum(r["k1_launches"] for r in serving["requests"])
                     + training["launches"]["k1"] + evaluation["launches"]["k1"]
                     + pool["launches"]["k1"] + parallel["launches"]["k1"] + one_rank["k1"]
                     + tp["launches"]["k1"] + entry["launches"]["k1"] + capi["launches"]["k1"]
                     + compat["launches"]["k1"] + imported["launches"]["k1"]
                     + scripts["launches"]["k1"]),
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
            "launches": (training["launches"][key] + inputs["launches"][key]
                         + augment["launches"][key] + parallel["launches"][key] + one_rank[key]
                         + tp["launches"][key] + imported["launches"][key]
                         + scripts["launches"][key]),
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
            "launches": (sum(r["launches"][key] for r in serving["requests"])
                         + evaluation["launches"][key] + pool["launches"].get(key, 0)
                         + entry["launches"][key] + imported["launches"][key]
                         + scripts["launches"][key]),
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
            json.dump({"gpu": card, "torch": torch.__version__, "k1": k1, "k2": k2, "k3k4": k3k4,
                       "k5": k5, "k5_phases": k5_phases, "backtrack": backtrack,
                       "native_build": native_build,
                       "serving": serving, "decoder": decoder, "training": training,
                       "evaluation": evaluation, "input": inputs, "pool": pool,
                       "augment": augment, "parallel": parallel, "tp": tp, "entry": entry,
                       "capi": capi, "compat": compat, "import": imported, "scripts": scripts,
                       "kernels": kernels},
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
