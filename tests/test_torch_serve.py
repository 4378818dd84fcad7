"""The port's serving slice as a whole against stt_tpu on one artifact: an
artifact written by stt_tpu.artifact.save_artifact (plain, int8 and
.sttpkg) loads to the same parameters, and the port's Model on the CPU
gives stt_tpu's Model's emissions, logits and transcripts.

Tolerances: emissions (softmax probabilities) 1e-5 and logits 1e-4 - float32
products summed in another order. Transcripts are compared exactly where
both sides decode the same probabilities.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stt_tpu.alphabet import Alphabet as JaxAlphabet
from stt_tpu.artifact import build_metadata, load_artifact as jax_load_artifact
from stt_tpu.artifact import package_zip, save_artifact
from stt_tpu.decode import ctc_beam_search_decoder
from stt_tpu.frontend import FeatureConfig as JaxFeatureConfig
from stt_tpu.frontend import audio_to_mfcc as jax_audio_to_mfcc
from stt_tpu.models import ModelConfig as JaxModelConfig
from stt_tpu.models import init_params
from stt_tpu.serve import Model as JaxModel
from stt_tpu_torch import client
from stt_tpu_torch.artifact import load_artifact
from stt_tpu_torch.data import write_wav
from stt_tpu_torch.serve import Model

LABELS = list(" abcdefghijklmnopqrstuvwxyz'")
BEAM = 16
PROBS_TOL = 1e-5
LOGITS_TOL = 1e-4


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    alphabet = JaxAlphabet().init_from_labels(LABELS)
    config = JaxModelConfig(n_hidden=64, n_cell_dim=64, n_out=len(LABELS) + 1,
                            dropout_rates=(0.0,) * 6)
    params = jax.device_get(init_params(jax.random.PRNGKey(7), config))
    meta = build_metadata(config, JaxFeatureConfig(), alphabet, beam_width=BEAM)
    root = tmp_path_factory.mktemp("artifacts")
    plain = save_artifact(str(root / "plain"), params, meta, alphabet)
    quant = save_artifact(str(root / "int8"), params, meta, alphabet, quantize=True)
    return {"plain": plain, "int8": quant, "zip": package_zip(plain)}


@pytest.fixture(scope="module")
def models(artifacts):
    return JaxModel(artifacts["plain"]), Model(artifacts["plain"], device="cpu")


def speech_like(seed, seconds):
    rs = np.random.RandomState(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000.0
    audio = sum(0.15 * np.sin(2 * np.pi * rs.uniform(100, 2000) * t) for _ in range(3))
    return (audio + 0.03 * rs.randn(n)).astype(np.float32)


@pytest.mark.parametrize("form", ["plain", "int8", "zip"])
def test_load_artifact_gives_jax_params(artifacts, form):
    want, want_meta, want_alphabet = jax_load_artifact(artifacts[form])
    got, meta, alphabet = load_artifact(artifacts[form])
    assert meta == want_meta and alphabet.labels == want_alphabet.labels
    assert got.keys() == want.keys()
    for layer in want:
        assert got[layer].keys() == want[layer].keys()
        for leaf in want[layer]:
            np.testing.assert_array_equal(got[layer][leaf], want[layer][leaf])


def test_emissions_and_transcript(models):
    jax_model, model = models
    audio = speech_like(0, 2.3)
    want_text, want_probs = jax_model.stt_with_emissions(audio)
    text, probs = model.stt_with_emissions(audio)
    assert probs.shape == want_probs.shape
    np.testing.assert_allclose(probs, want_probs, rtol=0, atol=PROBS_TOL)
    # stt_tpu's decoder on the port's probabilities gives the port's transcript
    ref = ctc_beam_search_decoder(probs, jax_model.alphabet, BEAM, implementation="python")
    assert text == ref[0].transcript
    assert text == model.stt(audio)


def test_metadata_tokens_and_timesteps(models):
    jax_model, model = models
    audio = speech_like(1, 1.7)
    meta = model.stt_with_metadata(audio, 3)
    _, probs = model.stt_with_emissions(audio)
    ref = ctc_beam_search_decoder(probs, jax_model.alphabet, BEAM, num_results=3,
                                  implementation="python")
    assert len(meta.transcripts) == 3
    for cand, want in zip(meta.transcripts, ref):
        assert cand.transcript == want.transcript
        assert [t.timestep for t in cand.tokens] == list(want.timesteps)
        assert [t.text for t in cand.tokens] == [LABELS[i] for i in want.tokens]
        assert [t.start_time for t in cand.tokens] == [s * 0.02 for s in want.timesteps]
        assert cand.confidence == want.confidence


def test_streamed_chunks_equal_one_shot_and_int16(models):
    _, model = models
    audio = speech_like(2, 3.1)
    text, probs = model.stt_with_emissions(audio)
    stream = model.create_stream()
    for start in range(0, len(audio), 1111):  # awkward sizes stress the buffers
        stream.feed_audio_content(audio[start:start + 1111])
        stream.intermediate_decode()
    assert stream.finish_stream() == text
    np.testing.assert_array_equal(stream._state.probs_history, probs)
    pcm = np.clip(audio * 32768, -32768, 32767).astype(np.int16)
    _, probs16 = model.stt_with_emissions(pcm)
    _, probs_f = model.stt_with_emissions(pcm.astype(np.float32) / 32768.0)
    np.testing.assert_array_equal(probs16, probs_f)


def test_device_prune_stream_matches(models):
    _, model = models
    audio = speech_like(3, 2.0)
    plain = model.create_stream(device_prune=False)
    pruned = model.create_stream(device_prune=True)
    for s in (plain, pruned):
        s.feed_audio_content(audio)
    assert pruned.finish_stream() == plain.finish_stream()


def test_pruned_stream_feeds_the_native_decoder_through_next_pruned(models, monkeypatch):
    """With device pruning a stream hands the native decoder the pruned
    emissions (int32 indices and counts, float32 logps and blank
    probabilities, [T, K] and [T]) through next_pruned, and decodes what
    the Python decoder decodes from the same arrays."""
    from stt_tpu_torch.decode import make_decoder_state
    from stt_tpu_torch.decode.device import prune_emissions
    from stt_tpu_torch.decode.native import NativeDecoderState

    _, model = models
    audio = speech_like(5, 1.9)
    seen = []
    original = NativeDecoderState.next_pruned

    def spy(self, indices, logps, counts, blank_probs):
        seen.append((indices.dtype, logps.dtype, counts.dtype, blank_probs.dtype,
                     indices.shape[1:], logps.shape == indices.shape,
                     counts.shape == blank_probs.shape == indices.shape[:1]))
        return original(self, indices, logps, counts, blank_probs)

    monkeypatch.setattr(NativeDecoderState, "next_pruned", spy)
    model._cutoff_prob, model._cutoff_top_n = 0.95, 8  # auto pruning turns on
    try:
        stream = model.create_stream()
        assert stream._state.device_prune
        assert isinstance(stream._state.decoder, NativeDecoderState)
        stream.feed_audio_content(audio)
        got = stream.finish_stream_with_metadata(2)
    finally:
        model._cutoff_prob, model._cutoff_top_n = 1.0, 40
    i32, f32 = np.dtype(np.int32), np.dtype(np.float32)
    assert seen and set(seen) == {(i32, f32, i32, f32, (8,), True, True)}
    _, probs = model.stt_with_emissions(audio)
    python = make_decoder_state(model.alphabet, BEAM, 0.95, 8, implementation="python")
    python.next_pruned(*(a.numpy() for a in prune_emissions(torch.from_numpy(probs), 8, 0.95)))
    for cand, want in zip(got.transcripts, python.decode(2)):
        assert cand.transcript == want.transcript
        assert [t.timestep for t in cand.tokens] == want.timesteps
        assert cand.confidence == pytest.approx(want.confidence, abs=1e-6)


def test_infer_logits_batch(models):
    jax_model, model = models
    feats = [np.asarray(jax_audio_to_mfcc(jnp.asarray(speech_like(10 + i, s))))
             for i, s in enumerate((1.1, 0.7, 1.6))]
    lengths = np.array([len(f) for f in feats], np.int32)
    batch = np.zeros((3, lengths.max(), 26), np.float32)
    for i, f in enumerate(feats):
        batch[i, : len(f)] = f
    want = np.asarray(jax_model.infer_logits(batch, lengths))
    got = model.infer_logits(batch, lengths).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGITS_TOL)


def test_unported_surfaces_raise(artifacts, models, tmp_path):
    """The external scorer is ported: what raises now is what raises in
    stt_tpu, a missing or invalid package and alpha/beta without a scorer."""
    jax_model, model = models
    bad = tmp_path / "bad.scorer"
    bad.write_bytes(b"not a scorer package" * 8)
    for m in (model, jax_model):
        with pytest.raises(FileNotFoundError):
            m.enable_external_scorer(str(tmp_path / "missing.scorer"))
        with pytest.raises(ValueError, match="KenLM"):
            m.enable_external_scorer(str(bad))
        with pytest.raises(ValueError, match="KenLM"):
            m.enable_external_scorer_from_buffer(bad.read_bytes())
        assert m.scorer is None
        with pytest.raises(RuntimeError, match="no scorer"):
            m.set_scorer_alpha_beta(1.0, 2.0)


def test_quantized_inference_model_routes_logits_through_int8(artifacts, models):
    """Model(quantized_inference=True) quantizes once and `infer_logits`
    takes the int8 path: close to the float logits, not equal to them, and
    stt_tpu's int8 logits to the float tolerance (no rounding-boundary flip
    on these seeded inputs, see tests/test_torch_quant.py)."""
    jax_model, model = models
    q_model = Model(artifacts["plain"], quantized_inference=True, device="cpu")
    assert q_model._qparams is not None and model._qparams is None
    rs = np.random.RandomState(5)
    batch = (rs.randn(2, 21, 26) * 5).astype(np.float32)
    lengths = np.array([21, 13], np.int32)
    got = q_model.infer_logits(batch, lengths).numpy()
    ref = model.infer_logits(batch, lengths).numpy()
    assert got.shape == ref.shape == (2, 21, len(LABELS) + 1)
    assert 0 < np.abs(got - ref).max() < 0.5
    want = np.asarray(JaxModel(artifacts["plain"], quantized_inference=True)
                      .infer_logits(batch, lengths))
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGITS_TOL)


def test_device_decode_stream_matches_the_batch_device_decoder(models):
    """create_stream(device_decode=True) decodes on the model's device:
    chunk by chunk it gives what the batch device decoder gives on the
    emissions of the same audio, and the host sees no probabilities."""
    from stt_tpu_torch.decode.device import (
        DeviceStreamingDecoder,
        ctc_beam_search_decoder_device,
    )

    _, model = models
    audio = speech_like(6, 2.4)
    stream = model.create_stream(device_decode=True)
    assert isinstance(stream._state.decoder, DeviceStreamingDecoder)
    for start in range(0, len(audio), 5000):
        stream.feed_audio_content(audio[start:start + 5000])
        stream.intermediate_decode()
    meta = stream.finish_stream_with_metadata(2)
    assert stream._state.probs_history.shape[0] == 0
    _, probs = model.stt_with_emissions(audio)
    want = ctc_beam_search_decoder_device([probs], [len(probs)], model.alphabet,
                                          beam_size=BEAM, num_results=2, device="cpu")[0]
    for cand, ref in zip(meta.transcripts, want):
        assert cand.transcript == ref.transcript
        assert [t.timestep for t in cand.tokens] == ref.timesteps
        assert cand.confidence == pytest.approx(ref.confidence, abs=1e-5)


def test_client_json_and_unported_flags(artifacts, tmp_path, capsys):
    wav = str(tmp_path / "a.wav")
    write_wav(wav, speech_like(4, 1.2))
    assert client.main(["--model", artifacts["plain"], "--audio", wav, "--json",
                        "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert len(out["transcripts"]) == 3
    # the scorer flags are ported; alpha and beta without a scorer are
    # refused as by stt_tpu's client
    assert client.main(["--model", artifacts["plain"], "--audio", wav,
                        "--lm_alpha", "1.0", "--lm_beta", "2.0", "--device", "cpu"]) == 2
    assert "--lm_alpha/--lm_beta require --scorer" in capsys.readouterr().err
    assert os.path.exists(wav)


def test_serving_takes_the_inference_route(models, monkeypatch):
    """Serving runs under no_grad, so its LSTM is lstm_fused (K1 on the
    card) and never lstm_train (K3/K4), although the parameters are
    trainable."""
    from stt_tpu_torch import ops

    _, port = models
    assert all(p.requires_grad for p in port._runtime.model.parameters())
    calls = []
    fused = ops.lstm_fused

    def counting(*args, **kwargs):
        calls.append(1)
        return fused(*args, **kwargs)

    def refuse(*args, **kwargs):
        raise AssertionError("serving reached the training recurrence")

    monkeypatch.setattr(ops, "lstm_fused", counting)
    monkeypatch.setattr(ops, "lstm_train", refuse)
    port.stt(speech_like(3, 1.2))
    logits = port.infer_logits(np.zeros((2, 20, 26), np.float32), [20, 11])
    assert not logits.requires_grad
    assert len(calls) >= 2


HOT_WORDS = {"water": 3.0, "the": -1.0}
CONF_TOL = 1e-4  # scores summed over emissions that differ by up to PROBS_TOL


@pytest.fixture(scope="module")
def lm_setup(tmp_path_factory):
    """A model whose emissions are peaky (the two packages' probabilities
    then cannot order near-equal beams differently) and a scorer package
    built in the test."""
    from test_torch_scorer import build_package

    alphabet = JaxAlphabet().init_from_labels(LABELS)
    config = JaxModelConfig(n_hidden=64, n_cell_dim=64, n_out=len(LABELS) + 1,
                            dropout_rates=(0.0,) * 6)
    params = jax.device_get(init_params(jax.random.PRNGKey(3), config))
    params["layer_6"]["b"] = (np.random.RandomState(1).randn(len(LABELS) + 1) * 3).astype(np.float32)
    params["layer_6"]["w"] = params["layer_6"]["w"] * 20.0
    root = tmp_path_factory.mktemp("lm_serve")
    meta = build_metadata(config, JaxFeatureConfig(), alphabet, beam_width=BEAM)
    path = save_artifact(str(root / "m"), params, meta, alphabet)
    return path, build_package(root, "lm.scorer")


def candidates(meta) -> list:
    return [(c.transcript, [t.timestep for t in c.tokens], [t.text for t in c.tokens],
             c.confidence) for c in meta.transcripts]


def assert_same(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:3] == w[:3]
        assert g[3] == pytest.approx(w[3], abs=CONF_TOL)


def test_scorer_and_hot_words_match_stt_tpu(lm_setup):
    """enable_external_scorer, hot words, set_scorer_alpha_beta and
    enable_external_scorer_from_buffer, then stt, stt_with_metadata and a
    stream fed in pieces: the port's Model gives stt_tpu's."""
    from stt_tpu_torch.decode.native import NativeDecoderState
    from stt_tpu_torch.decode.scorer_package import KenLMScorer

    artifact, scorer_path = lm_setup
    jax_model, model = JaxModel(artifact), Model(artifact, device="cpu")
    audio = [speech_like(20 + i, s) for i, s in enumerate((1.3, 2.1))]
    plain = [model.stt(a) for a in audio]
    for m in (jax_model, model):
        m.enable_external_scorer(scorer_path)
        for word, boost in HOT_WORDS.items():
            m.add_hot_word(word, boost)
    assert isinstance(model.scorer, KenLMScorer) and model.scorer.path == scorer_path
    assert (model.scorer.alpha, model.scorer.beta) == (0.93, 1.18)  # the package's own
    assert isinstance(model.create_stream()._state.decoder, NativeDecoderState)

    def answers(m):
        texts = [m.stt(a) for a in audio]
        metas = [candidates(m.stt_with_metadata(a, 3)) for a in audio]
        stream, partial = m.create_stream(), []
        for start in range(0, len(audio[1]), 2777):
            stream.feed_audio_content(audio[1][start:start + 2777])
            partial.append(stream.intermediate_decode())
        return texts, metas, partial, candidates(stream.finish_stream_with_metadata(2))

    for step in ("package values", "alpha/beta set", "from a buffer"):
        if step == "alpha/beta set":
            for m in (jax_model, model):
                m.set_scorer_alpha_beta(2.5, -0.5)
        elif step == "from a buffer":
            with open(scorer_path, "rb") as f:
                data = f.read()
            for m in (jax_model, model):
                m.enable_external_scorer_from_buffer(data)
            assert model.scorer.path is None
        texts, metas, partial, streamed = answers(model)
        want_texts, want_metas, want_partial, want_streamed = answers(jax_model)
        assert texts == want_texts and partial == want_partial, step
        for got, want in zip(metas, want_metas):
            assert_same(got, want)
        assert_same(streamed, want_streamed)
        assert texts[1] == streamed[0][0]
    assert texts != plain and all(texts)  # the language model reached the transcripts


def test_client_with_scorer_matches_stt_tpu(lm_setup, tmp_path, capsys):
    """python -m stt_tpu_torch.client --scorer ... --hot_words ... --json
    against stt_tpu's client on the same WAV."""
    import subprocess
    import sys

    from stt_tpu import client as jax_client

    artifact, scorer_path = lm_setup
    wav = str(tmp_path / "a.wav")
    write_wav(wav, speech_like(30, 1.8))
    args = ["--model", artifact, "--audio", wav, "--scorer", scorer_path, "--hot_words",
            "water:3.0,the:-1.0", "--lm_alpha", "1.5", "--lm_beta", "0.5", "--json",
            "--candidate_transcripts", "2"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-m", "stt_tpu_torch.client", *args, "--device", "cpu"],
                          cwd=root, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": root})
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout)
    capsys.readouterr()
    assert jax_client.main(args) == 0
    want = json.loads(capsys.readouterr().out)
    assert len(got["transcripts"]) == len(want["transcripts"]) == 2
    for g, w in zip(got["transcripts"], want["transcripts"]):
        assert g["words"] == w["words"]
        assert g["confidence"] == pytest.approx(w["confidence"], abs=CONF_TOL)
    assert client.parse_hot_words("a:1,b:c:-2.5,") == [("a", 1.0), ("b:c", -2.5)]
