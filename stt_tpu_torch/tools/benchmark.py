"""Multi-metric benchmark: batch inference throughput, streaming RTF and
per-chunk latency, and training-step throughput, on the card (the port of
stt_tpu/tools/benchmark.py; the same flags, records and metric names).

- batch: MFCC -> DeepSpeech in bf16 -> greedy best path over `--batch`
  utterances of `--seconds` (K1 at B 128, T 500 by default);
- streaming: the full 2048 geometry in f32, one `StreamState` at beam 64
  fed 10 s of audio in 320 ms pieces, decoded by the native host decoder
  (K1 at B 1, T 16);
- train: one train step in bf16 at B = batch // 2, T = seconds x 50 frames,
  labels 80 long (K3 and K4 at B 64, T 500 by default).

The weights come from the port's seeded initialisation (seed 0) and the
audio from np.random.RandomState(0), as in stt_tpu. Without JAX the port
cannot draw the weights of PRNGKey(0), so the streaming record's host
decode time, which depends on the emissions, is not the same function of
the weights as stt_tpu's. Every clock read follows torch.cuda.synchronize()
where stt_tpu read a result to the host; the warm-ups and the minimum over
repetitions are stt_tpu's.

Run: python -m stt_tpu_torch.tools.benchmark [--batch 128] [--seconds 10]
       [--skip batch,stream,train] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from stt_tpu_torch.alphabet import Alphabet
from stt_tpu_torch.ctc.greedy import best_path
from stt_tpu_torch.device import resolve_device
from stt_tpu_torch.frontend import FeatureConfig, audio_to_mfcc
from stt_tpu_torch.models import DeepSpeech, ModelConfig
from stt_tpu_torch.stream.streaming import StreamingRuntime, StreamState
from stt_tpu_torch.train import Batch, create_train_state, make_train_step

SEED = 0
STREAM_SECONDS = 10
STREAM_BEAM = 64
LABEL_LENGTH = 80


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def seeded_model(config: ModelConfig, device: torch.device) -> DeepSpeech:
    """DeepSpeech drawn from SEED, on `device`, for inference."""
    model = DeepSpeech(config, generator=torch.Generator().manual_seed(SEED)).to(device)
    return model.requires_grad_(False)


def batch_audio(batch: int, seconds: float, fc: FeatureConfig) -> np.ndarray:
    """stt_tpu's batch input: [batch, seconds x rate] noise at 0.1."""
    rng = np.random.RandomState(0)
    return (rng.randn(batch, int(seconds * fc.sample_rate)) * 0.1).astype(np.float32)


@torch.no_grad()
def transcribe_batch(model: DeepSpeech, audio: torch.Tensor, fc: FeatureConfig) -> torch.Tensor:
    """MFCC -> model -> best path: [B, samples] -> [B, T] classes."""
    feats = audio_to_mfcc(audio, fc)
    seq = torch.full((audio.shape[0],), feats.shape[1], dtype=torch.int32, device=audio.device)
    logits, _ = model(feats, seq_len=seq)
    return best_path(logits)


def bench_batch_inference(batch: int, seconds: float, device="cuda") -> dict:
    device = resolve_device(device)
    fc = FeatureConfig()
    model = seeded_model(ModelConfig(compute_dtype="bfloat16"), device)
    audio = torch.from_numpy(batch_audio(batch, seconds, fc)).to(device)
    transcribe_batch(model, audio, fc).cpu()
    # enqueue all, synchronise once (stt_tpu's pipelined dispatch)
    inputs = [audio + i * 1e-6 for i in range(5)]
    sync(device)
    wall = None
    for _ in range(2):
        t0 = time.time()
        outs = [transcribe_batch(model, a, fc) for a in inputs]
        outs[-1][:1].cpu()
        sync(device)
        w = (time.time() - t0) / len(inputs)
        wall = w if wall is None else min(wall, w)
    return {
        "metric": "batch_inference",
        "audio_seconds_per_second": round(batch * seconds / wall, 1),
        "batch": batch,
        "wall_ms": round(wall * 1e3, 2),
    }


def english_alphabet() -> Alphabet:
    return Alphabet().init_from_labels(
        [" "] + [chr(c) for c in range(ord("a"), ord("z") + 1)] + ["'"]
    )


def stream_audio() -> np.ndarray:
    rng = np.random.RandomState(0)
    return (rng.randn(16000 * STREAM_SECONDS) * 0.1).astype(np.float32)


def stream_feed(stream: StreamState, audio: np.ndarray, chunk: int, device) -> list:
    """Feed `audio` in pieces of `chunk` samples; each piece's seconds."""
    times = []
    for start in range(0, len(audio), chunk):
        sync(device)
        c0 = time.time()
        stream.feed_audio_content(audio[start : start + chunk])
        sync(device)
        times.append(time.time() - c0)
    return times


def bench_streaming_rtf(device="cuda") -> dict:
    device = resolve_device(device)
    config = ModelConfig(dropout_rates=(0.0,) * 6)  # full 2048 geometry
    runtime = StreamingRuntime(seeded_model(config, device), FeatureConfig(), english_alphabet(),
                               device)
    audio = stream_audio()
    # warm the kernels and the decoder
    warm = StreamState(runtime, beam_width=STREAM_BEAM)
    warm.feed_audio_content(audio[: 16000 * 2])
    warm.finish(1)

    stream = StreamState(runtime, beam_width=STREAM_BEAM)
    chunk = 320 * 16  # 320 ms feed granularity
    sync(device)
    t0 = time.time()
    chunk_times = stream_feed(stream, audio, chunk, device)
    stream.finish(1)
    sync(device)
    wall = time.time() - t0
    rtf = wall / float(STREAM_SECONDS)
    return {
        "metric": "streaming",
        "rtf": round(rtf, 4),
        "x_realtime": round(1.0 / rtf, 1),
        "p50_chunk_latency_ms": round(float(np.median(chunk_times)) * 1e3, 1),
        "max_chunk_latency_ms": round(float(np.max(chunk_times)) * 1e3, 1),
    }


def train_batch(batch: int, seconds: float) -> Batch:
    """stt_tpu's train input: seeded features and labels, full lengths."""
    t_frames = int(seconds * 50)
    rng = np.random.RandomState(0)
    features = rng.randn(batch, t_frames, 26).astype(np.float32)
    labels = rng.randint(0, 28, (batch, LABEL_LENGTH)).astype(np.int32)
    return Batch(
        features=torch.from_numpy(features),
        feature_lengths=torch.full((batch,), t_frames, dtype=torch.int32),
        labels=torch.from_numpy(labels),
        label_lengths=torch.full((batch,), LABEL_LENGTH, dtype=torch.int32),
    )


def bench_train_step(batch: int, seconds: float, device="cuda") -> dict:
    device = resolve_device(device)
    # every LSTM of a training step on the card runs K3 forward, K4 backward
    config = ModelConfig(compute_dtype="bfloat16")
    state = create_train_state(config, seed=SEED, device=device)
    train_step = make_train_step()
    b = train_batch(batch, seconds).to(device)
    state, metrics = train_step(state, b, SEED)
    float(metrics.loss)
    times = []
    for _ in range(4):
        sync(device)
        t0 = time.time()
        state, metrics = train_step(state, b, SEED)
        float(metrics.loss)
        sync(device)
        times.append(time.time() - t0)
    wall = min(times)
    return {
        "metric": "train_step",
        "audio_seconds_per_second": round(batch * seconds / wall, 1),
        "step_ms": round(wall * 1e3, 1),
        "batch": batch,
    }


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--skip", default="", help="comma list: batch,stream,train")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; cpu asks for the CPU)")
    args = parser.parse_args(argv)
    skip = set(args.skip.split(","))
    results = []
    if "batch" not in skip:
        results.append(bench_batch_inference(args.batch, args.seconds, args.device))
    if "stream" not in skip:
        results.append(bench_streaming_rtf(args.device))
    if "train" not in skip:
        results.append(bench_train_step(args.batch // 2, args.seconds, args.device))
    for r in results:
        print(json.dumps(r), flush=True)
    return results


if __name__ == "__main__":
    main()
