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


def test_unported_surfaces_raise(artifacts, models):
    _, model = models
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.enable_external_scorer("lm.scorer")


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
    assert client.main(["--model", artifacts["plain"], "--audio", wav,
                        "--scorer", "lm.scorer", "--device", "cpu"]) == 2
    assert "not ported" in capsys.readouterr().err
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
