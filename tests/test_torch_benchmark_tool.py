"""The port's benchmark tool (stt_tpu_torch/tools/benchmark.py) against
stt_tpu.tools.benchmark on the CPU, at a small geometry, with the JAX
parameters carried across by params_from_numpy:

- each bench's inputs are stt_tpu's, drawn the same way from
  RandomState(0);
- batch inference: MFCC -> model (bf16) -> best path, equal classes;
- train: one bf16 step's loss from the same parameters, dropout off,
  within 1e-3 relative (the train-step parity test's bf16 tolerance,
  tests/test_torch_train_step.py);
- streaming: the 2048 stream's code path (f32, beam 64, 320 ms feeds,
  native host decoder) gives the same transcript, tokens and timesteps.
  layer_6's weights are scaled up on both sides so that the emissions are
  peaky: on near-flat emissions a last-bit difference may reorder the
  beam (ROADMAP: "Flat emissions");
- main(["--device", "cpu", ...]) prints records whose keys and metric names
  are those of stt_tpu's functions run at the same arguments (both at the
  small geometry, their ModelConfig narrowed in place).
"""

import functools
import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import stt_tpu.models
from stt_tpu.alphabet import Alphabet as JaxAlphabet
from stt_tpu.ctc.greedy import best_path as jax_best_path
from stt_tpu.frontend import FeatureConfig as JaxFeatureConfig
from stt_tpu.frontend import audio_to_mfcc as jax_audio_to_mfcc
from stt_tpu.models import ModelConfig as JaxModelConfig
from stt_tpu.models import apply_model, init_params
from stt_tpu.stream.streaming import StreamingRuntime as JaxRuntime
from stt_tpu.stream.streaming import StreamState as JaxStreamState
from stt_tpu.train import Batch as JaxBatch
from stt_tpu.train import create_train_state as jax_create_train_state
from stt_tpu.train import make_train_step as jax_make_train_step
from stt_tpu.train.step import create_optimizer as jax_create_optimizer
from stt_tpu_torch.artifact import params_from_numpy
from stt_tpu_torch.frontend import FeatureConfig
from stt_tpu_torch.models import ModelConfig
from stt_tpu_torch.stream.streaming import StreamingRuntime, StreamState
from stt_tpu_torch.tools import benchmark
from stt_tpu_torch.train import create_train_state, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_hidden=48, n_cell_dim=64)
TRAIN_LOSS_RTOL = 1e-3
CPU = torch.device("cpu")


def jax_params(config, scale_out=1.0):
    params = jax.device_get(init_params(jax.random.PRNGKey(0), config))
    params["layer_6"]["w"] = np.asarray(params["layer_6"]["w"]) * scale_out
    return params


def test_batch_inference_matches_stt_tpu():
    jax_cfg = JaxModelConfig(compute_dtype="bfloat16", fused_lstm=True, **SMALL)
    cfg = ModelConfig(compute_dtype="bfloat16", **SMALL)
    params = jax_params(jax_cfg)
    fc, jax_fc = FeatureConfig(), JaxFeatureConfig()
    audio = benchmark.batch_audio(3, 0.6, fc)
    rng = np.random.RandomState(0)  # stt_tpu's draw
    np.testing.assert_array_equal(
        audio, np.asarray(jnp.asarray(rng.randn(3, int(0.6 * 16000)) * 0.1, jnp.float32)))
    feats = jax_audio_to_mfcc(jnp.asarray(audio), jax_fc)
    seq = jnp.full((3,), feats.shape[1], jnp.int32)
    logits, _ = apply_model(params, feats, seq_len=seq, config=jax_cfg)
    want = np.asarray(jax_best_path(logits))
    model = params_from_numpy(params, cfg)
    got = benchmark.transcribe_batch(model, torch.from_numpy(audio), fc).numpy()
    assert got.shape == want.shape == (3, feats.shape[1])
    np.testing.assert_array_equal(got, want)


def test_train_step_loss_matches_stt_tpu():
    kw = dict(SMALL, compute_dtype="bfloat16", dropout_rates=(0.0,) * 6)
    jax_cfg, cfg = JaxModelConfig(fused_lstm=True, **kw), ModelConfig(**kw)
    batch = benchmark.train_batch(2, 2.0)  # T 100 frames: room for 80 labels
    rng = np.random.RandomState(0)  # stt_tpu's draws
    np.testing.assert_array_equal(batch.features.numpy(),
                                  np.asarray(jnp.asarray(rng.randn(2, 100, 26), jnp.float32)))
    np.testing.assert_array_equal(batch.labels.numpy(), rng.randint(0, 28, (2, 80)))
    assert batch.feature_lengths.tolist() == [100, 100]
    assert batch.label_lengths.tolist() == [80, 80]
    params = jax_params(jax_cfg)
    optimizer = jax_create_optimizer()
    jax_state = jax_create_train_state(jax.random.PRNGKey(0), jax_cfg, optimizer, params=params)
    jax_batch = JaxBatch(*(jnp.asarray(t.numpy()) for t in batch))
    _, jax_metrics = jax_make_train_step(jax_cfg, optimizer)(jax_state, jax_batch,
                                                            jax.random.PRNGKey(0))
    state = create_train_state(cfg, device="cpu", model=params_from_numpy(params, cfg))
    _, metrics = make_train_step()(state, batch, benchmark.SEED)
    want = float(jax_metrics.loss)
    assert np.isfinite(want) and want > 0
    assert float(metrics.loss) == pytest.approx(want, rel=TRAIN_LOSS_RTOL)


def test_streaming_transcript_matches_stt_tpu():
    kw = dict(SMALL, dropout_rates=(0.0,) * 6)
    jax_cfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    params = jax_params(jax_cfg, scale_out=40.0)
    labels = benchmark.english_alphabet().labels
    audio = benchmark.stream_audio()
    np.testing.assert_array_equal(
        audio, (np.random.RandomState(0).randn(16000 * 10) * 0.1).astype(np.float32))
    chunk = 320 * 16

    jax_stream = JaxStreamState(
        JaxRuntime(params, jax_cfg, JaxFeatureConfig(), JaxAlphabet().init_from_labels(labels)),
        beam_width=benchmark.STREAM_BEAM)
    for start in range(0, len(audio), chunk):
        jax_stream.feed_audio_content(audio[start:start + chunk])
    [want] = jax_stream.finish(1)

    runtime = StreamingRuntime(params_from_numpy(params, cfg), FeatureConfig(),
                               benchmark.english_alphabet(), CPU)
    stream = StreamState(runtime, beam_width=benchmark.STREAM_BEAM)
    times = benchmark.stream_feed(stream, audio, chunk, CPU)
    [got] = stream.finish(1)
    assert len(times) == -(-len(audio) // chunk)
    assert len(want.transcript) > 10
    assert got.transcript == want.transcript
    assert list(got.tokens) == list(want.tokens)
    assert list(got.timesteps) == list(want.timesteps)


@pytest.fixture
def stt_tpu_benchmark(monkeypatch):
    """stt_tpu.tools.benchmark, imported with its XLA cache under the
    checkout's build/ (its import points JAX's persistent cache there), the
    JAX settings it changes restored after the test."""
    saved = {name: getattr(jax.config, name) for name in (
        "jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
    monkeypatch.setenv("STT_TPU_COMPILE_CACHE", os.path.join(ROOT, "build", "test_xla_cache"))
    from stt_tpu.tools import benchmark as module

    yield module
    for name, value in saved.items():
        jax.config.update(name, value)


def test_main_prints_stt_tpus_records(monkeypatch, stt_tpu_benchmark):
    monkeypatch.setattr(stt_tpu.models, "ModelConfig", functools.partial(JaxModelConfig, **SMALL))
    monkeypatch.setattr(benchmark, "ModelConfig", functools.partial(ModelConfig, **SMALL))
    out = io.StringIO()
    with redirect_stdout(out):
        got = benchmark.main(["--device", "cpu", "--batch", "2", "--seconds", "0.5"])
    printed = [json.loads(line) for line in out.getvalue().splitlines()]
    assert printed == got
    want = [stt_tpu_benchmark.bench_batch_inference(2, 0.5), stt_tpu_benchmark.bench_streaming_rtf(),
            stt_tpu_benchmark.bench_train_step(1, 0.5)]
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [r["metric"] for r in got] == [r["metric"] for r in want] == [
        "batch_inference", "streaming", "train_step"]
    assert got[0]["batch"] == want[0]["batch"] == 2 and got[2]["batch"] == want[2]["batch"] == 1
    assert all(v > 0 for r in got for k, v in r.items() if k != "metric")


def test_main_skips_and_refuses_cuda_without_it(capsys):
    assert benchmark.main(["--device", "cpu", "--skip", "batch,stream,train"]) == []
    assert capsys.readouterr().out == ""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        benchmark.main(["--skip", "stream,train"])
