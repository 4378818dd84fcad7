"""The port's stream pool (`stt_tpu_torch.serve.pool`) against the port's
single `Stream` and against `stt_tpu.serve.pool.StreamPool`, on one artifact
written by stt_tpu and the same audio, on the CPU.

Tolerances: probabilities 1e-5 (float32 products at B = S against B = 1,
and against XLA, summed in another order); transcripts, tokens and
timesteps exactly; confidences to 1e-4 (sums over the probabilities).
"""

import numpy as np
import pytest

import jax
import torch

from stt_tpu.alphabet import Alphabet as JaxAlphabet
from stt_tpu.artifact import build_metadata, save_artifact
from stt_tpu.frontend import FeatureConfig as JaxFeatureConfig
from stt_tpu.models import ModelConfig as JaxModelConfig
from stt_tpu.models import init_params
from stt_tpu.serve import Model as JaxModel
from stt_tpu.serve.pool import StreamPool as JaxStreamPool
from stt_tpu_torch import ops
from stt_tpu_torch.serve import Model, StreamPool

LABELS = list(" abcdefghijklmnopqrstuvwxyz'")
BEAM = 16
PROBS_TOL = 1e-5
CONF_TOL = 1e-4
MODES = {"host": {"device_prune": False, "device_decode": False},
         "device_prune": {"device_prune": True, "device_decode": False},
         "device_decode": {"device_decode": True}}


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    alphabet = JaxAlphabet().init_from_labels(LABELS)
    config = JaxModelConfig(n_hidden=48, n_cell_dim=48, n_out=len(LABELS) + 1,
                            dropout_rates=(0.0,) * 6)
    params = jax.device_get(init_params(jax.random.PRNGKey(3), config))
    # a spread of output biases and larger output weights make the emissions
    # peaky, so the decoders of the two packages see no near-ties
    params["layer_6"]["b"] = (np.random.RandomState(1).randn(len(LABELS) + 1) * 3).astype(np.float32)
    params["layer_6"]["w"] = params["layer_6"]["w"] * 20.0
    meta = build_metadata(config, JaxFeatureConfig(), alphabet, beam_width=BEAM)
    return save_artifact(str(tmp_path_factory.mktemp("pool") / "m"), params, meta, alphabet)


@pytest.fixture(scope="module")
def models(artifact):
    return Model(artifact, device="cpu"), JaxModel(artifact)


def speech_like(seed, seconds):
    rs = np.random.RandomState(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000.0
    audio = sum(0.15 * np.sin(2 * np.pi * rs.uniform(100, 2000) * t) for _ in range(3))
    return (audio + 0.03 * rs.randn(n)).astype(np.float32)


class Recording:
    """A decoder that keeps every probability chunk its stream is fed."""

    def __init__(self, decoder):
        self.decoder = decoder
        self.chunks = []

    def next(self, probs, n_valid=None):
        rows = probs if n_valid is None else probs[:n_valid]
        self.chunks.append(np.asarray(rows.cpu() if isinstance(rows, torch.Tensor) else rows))
        return self.decoder.next(probs) if n_valid is None else self.decoder.next(probs, n_valid)

    def __getattr__(self, name):
        return getattr(self.decoder, name)

    def probs(self):
        return np.concatenate(self.chunks) if self.chunks else np.zeros((0, len(LABELS) + 1))


def record(pool, stream):
    pool._decoders[stream._slot] = Recording(pool._decoders[stream._slot])
    return pool._decoders[stream._slot]


def single(model, audio, num_results=3, **kwargs):
    stream = model.create_stream(**kwargs)
    stream.feed_audio_content(audio)
    return stream.finish_stream_with_metadata(num_results)


def assert_same_metadata(got, want, tol=CONF_TOL):
    assert len(got.transcripts) == len(want.transcripts)
    for a, b in zip(got.transcripts, want.transcripts):
        assert a.transcript == b.transcript
        assert [t.text for t in a.tokens] == [t.text for t in b.tokens]
        assert [t.timestep for t in a.tokens] == [t.timestep for t in b.tokens]
        assert a.confidence == pytest.approx(b.confidence, abs=tol)


def run_interleaved(pool_class, model, audios, kwargs, recording=False):
    """Two streams fed in awkward sizes, the second one stopping half way;
    returns their metadata (3 candidates) and, with `recording`, the
    probabilities each was fed."""
    pool = pool_class(model, max_streams=4, **kwargs)
    s1, s2 = pool.create_stream(), pool.create_stream()
    recs = [record(pool, s) for s in (s1, s2)] if recording else []
    a1, a2 = audios
    for start in range(0, len(a1), 3001):
        s1.feed_audio_content(a1[start:start + 3001])
        if start < len(a2):
            s2.feed_audio_content(a2[start:start + 3001])
        s1.intermediate_decode()
    metas = [s.finish_stream_with_metadata(3) for s in (s1, s2)]
    return metas, [r.probs() for r in recs]


@pytest.mark.parametrize("mode", list(MODES))
def test_pooled_streams_equal_single_streams_and_stt_tpu(models, mode):
    model, jax_model = models
    kwargs = MODES[mode]
    audios = (speech_like(0, 2.9), speech_like(1, 1.4))
    metas, probs = run_interleaved(StreamPool, model, audios, kwargs, recording=mode == "host")
    jax_metas, jax_probs = run_interleaved(JaxStreamPool, jax_model, audios, kwargs,
                                           recording=mode == "host")
    for audio, meta, jax_meta in zip(audios, metas, jax_metas):
        assert meta.transcripts[0].transcript != ""
        assert_same_metadata(meta, single(model, audio, **kwargs))
        assert_same_metadata(meta, jax_meta)
    if mode == "host":
        for audio, got, want in zip(audios, probs, jax_probs):
            _, one = model.stt_with_emissions(audio)
            assert got.shape == one.shape == want.shape
            np.testing.assert_allclose(got, one, rtol=0, atol=PROBS_TOL)
            np.testing.assert_allclose(got, want, rtol=0, atol=PROBS_TOL)


def test_pool_slot_reuse_and_exhaustion(models):
    model, _ = models
    audio = speech_like(2, 1.8)
    pool = StreamPool(model, max_streams=2)
    a, b = pool.create_stream(), pool.create_stream()
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.create_stream()
    a.feed_audio_content(audio[:8000])
    a.finish_stream()  # releases the slot
    c = pool.create_stream()  # and it is reused, from a fresh state
    assert c._slot == a._slot
    c.feed_audio_content(audio)
    assert c.finish_stream() == model.stt(audio)
    b.feed_audio_content(audio[:4000])
    assert b.finish_stream() == model.stt(audio[:4000])


@pytest.mark.parametrize("mode", list(MODES))
def test_pool_staggered_lifetimes(models, mode):
    """Streams created mid-flight of others, int16 audio among them, stay
    equal to their single streams and to stt_tpu's pool."""
    model, jax_model = models
    kwargs = MODES[mode]
    audio, other = speech_like(3, 2.6), speech_like(4, 2.0)
    pcm = np.clip(other * 32768, -32768, 32767).astype(np.int16)

    def run(pool_class, m):
        pool = pool_class(m, max_streams=3, **kwargs)
        s1 = pool.create_stream()
        s1.feed_audio_content(audio[: len(audio) // 2])
        s2 = pool.create_stream()  # created later, fresh state
        for start in range(0, len(pcm), 5000):
            s2.feed_audio_content(pcm[start:start + 5000])
        s1.feed_audio_content(audio[len(audio) // 2:])
        return s1.finish_stream_with_metadata(2), s2.finish_stream_with_metadata(2)

    got, want = run(StreamPool, model), run(JaxStreamPool, jax_model)
    assert_same_metadata(got[0], single(model, audio, 2, **kwargs))
    assert_same_metadata(got[1], single(model, pcm, 2, **kwargs))
    for a, b in zip(got, want):
        assert_same_metadata(a, b)


def test_a_round_runs_the_recurrence_once_for_every_slot(models, monkeypatch):
    """Four streams fed one chunk each in step: one round, one LSTM call at
    B = 4 (K1 once on the card), not one a stream."""
    model, _ = models
    calls = []
    fused = ops.lstm_fused

    def counting(params, x, **kwargs):
        calls.append(x.shape[1])
        return fused(params, x, **kwargs)

    monkeypatch.setattr(ops, "lstm_fused", counting)
    pool = StreamPool(model, max_streams=4)
    streams = [pool.create_stream() for _ in range(4)]
    chunk = pool._chunk_samples
    audios = [speech_like(10 + i, 1.0) for i in range(4)]
    for s, a in zip(streams, audios):
        s.feed_audio_content(a[:chunk])  # primes the slot
    for s, a in zip(streams, audios):
        s.feed_audio_content(a[chunk:chunk + 320 * 16])  # the next chunk: an emitting round
    assert calls == [4, 4]  # the priming round and the emitting one, each at B = 4
    assert pool._primed.all()


def test_rows_at_seq_len_zero_keep_their_state(models):
    """A round with idle slots (mode 0) leaves their LSTM state and frame
    carries as they were, and primes or emits the others."""
    model, _ = models
    pool = StreamPool(model, max_streams=3)
    rng = np.random.RandomState(0)
    pool._c = torch.from_numpy(rng.randn(3, 48).astype(np.float32))
    pool._h = torch.from_numpy(rng.randn(3, 48).astype(np.float32))
    pool._pend_dev = torch.from_numpy(rng.randn(*pool._pend_dev.shape).astype(np.float32))
    before = [t.clone() for t in (pool._c, pool._h, pool._left_dev, pool._pend_dev)]
    chunks = torch.from_numpy(np.stack([speech_like(20 + i, 0.4)[: pool._chunk_samples]
                                        for i in range(3)]))
    pool.fused_round(chunks, torch.tensor([0, 2, 1]))
    after = (pool._c, pool._h, pool._left_dev, pool._pend_dev)
    for got, want in zip(after, before):
        assert torch.equal(got[0], want[0])  # idle
    assert not torch.equal(pool._c[1], before[0][1])  # emitted
    assert torch.equal(pool._c[2], before[0][2])  # primed: frames only
    assert not torch.equal(pool._pend_dev[2], before[3][2])
    assert torch.equal(pool._left_dev[2], before[2][2])


def test_device_decode_slots_use_the_device_decoder(models):
    from stt_tpu_torch.decode.device import DeviceStreamingDecoder

    model, _ = models
    pool = StreamPool(model, max_streams=2, device_decode=True)
    stream = pool.create_stream()
    assert isinstance(pool._decoders[stream._slot], DeviceStreamingDecoder)
    assert pool.device_decode and not pool.device_prune
    auto = StreamPool(model, max_streams=2)
    assert not auto.device_decode and not auto.device_prune  # 29 classes: no pruning


PIECE = 2777  # samples a feed: no multiple of the chunk, the step or the window
SCORED_CONF_TOL = 1e-3  # with the scorer's and int8's terms (ROADMAP §3's probe)


def pooled_pieces(model, audios, kwargs):
    """A 3-slot pool, three streams fed in PIECE-sample pieces in turn with
    an intermediate decode of each after every piece; returns the
    intermediate transcripts and each stream's final metadata (3
    candidates)."""
    pool = (StreamPool if isinstance(model, Model) else JaxStreamPool)(model, max_streams=3,
                                                                       **kwargs)
    streams = [pool.create_stream() for _ in audios]
    seen = []
    for start in range(0, max(len(a) for a in audios), PIECE):
        for stream, audio in zip(streams, audios):
            if start < len(audio):
                stream.feed_audio_content(audio[start:start + PIECE])
                seen.append(stream.intermediate_decode())
    return seen, [s.finish_stream_with_metadata(3) for s in streams]


@pytest.fixture(scope="module")
def scorer_path(tmp_path_factory):
    """A 3-gram .scorer package of seeded sentences over chip_smoke's words,
    built by the port's LM tools."""
    import os
    import sys

    from stt_tpu_torch.lm.arpa import estimate_kneser_ney_lmplz, write_arpa
    from stt_tpu_torch.tools.generate_scorer_package import create_package

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import LM_WORDS

    root = tmp_path_factory.mktemp("pool_scorer")
    rs = np.random.RandomState(5)
    sentences = [list(rs.choice(LM_WORDS, size=rs.randint(3, 10))) for _ in range(300)]
    alphabet, vocab, arpa = (str(root / name) for name in ("alphabet.txt", "vocab.txt", "lm.arpa"))
    with open(alphabet, "w") as f:
        f.write("".join(f"{c}\n" for c in LABELS))
    with open(vocab, "w") as f:
        f.write("\n".join(sorted({w for s in sentences for w in s})) + "\n")
    write_arpa(estimate_kneser_ney_lmplz(sentences, order=3, discount_fallback=True), arpa)
    return create_package(alphabet, arpa, vocab, str(root / "lm.scorer"), 0.93, 1.18)


@pytest.mark.parametrize("mode", ["host", "device_prune"])
@pytest.mark.parametrize("kind", ["scorer_hot_words", "int8"])
def test_pool_with_scorer_or_int8_equals_stt_tpu(artifact, scorer_path, kind, mode):
    """The re-anchor's probe as a test: three streams through a 3-slot pool
    with a scorer and hot words, or with quantized_inference=True, against
    stt_tpu's pool on the same artifact: intermediate and final transcripts
    and timesteps equal, confidences within 1e-3."""
    quantized = kind == "int8"
    model = Model(artifact, quantized_inference=quantized, device="cpu")
    jax_model = JaxModel(artifact, quantized_inference=quantized)
    if not quantized:
        for m in (model, jax_model):
            m.enable_external_scorer(scorer_path)
            for word, boost in (("water", 2.0), ("the", -0.5), ("year", 1.0)):
                m.add_hot_word(word, boost)
    audios = [speech_like(30 + i, s) for i, s in enumerate((2.4, 1.7, 3.1))]
    seen, metas = pooled_pieces(model, audios, MODES[mode])
    jax_seen, jax_metas = pooled_pieces(jax_model, audios, MODES[mode])
    assert len(seen) == len(jax_seen) >= 3 * 6
    assert seen == jax_seen
    assert any(meta.transcripts[0].transcript for meta in metas)
    for got, want in zip(metas, jax_metas):
        assert_same_metadata(got, want, tol=SCORED_CONF_TOL)
