"""The port's other entry points (M14) against stt_tpu's on the CPU, on
the same weights (carried across by `params_from_numpy`), inputs and
scorer (a package built by the port's tools from the in-repo corpus of
tests/test_torch_scorer.py; both packages' tools write it byte-equal):

- `audio_to_mfcc_numpy`: within 1e-6 (measured 0: the same float32 numpy
  and scipy operations);
- `training_graph_inference.do_single_file_inference` from a stt_tpu
  checkpoint and from a port checkpoint of the same parameters, over a
  seeded WAV, with and without a scorer: the same transcript;
- `lm_optimizer.compute_lm_optimization` with the model given: the same
  trial lines (alpha, beta, metric) in the same order and the same best
  (alpha, beta, metric);
- the flashlight decoders (`decode.flashlight`) on seeded emissions with
  a lexicon built here, lexicon and lexicon-free: the same words and
  tokens, scores within 1e-5 (measured 0: the same float64 arithmetic);
- `evaluate_flashlight` on a test CSV: the same transcripts, WER and CER,
  losses within 1e-5 absolute plus 1e-5 relative (float32 sums in another
  order, as in tests/test_torch_evaluate.py);
- the wav2vec2 decoder (blank 0, ignored symbols, AM tokens remapped onto
  the scorer's alphabet), with and without the scorer: the same
  transcripts, tokens and timesteps, confidences within 1e-9 relative
  (measured 0);
- `evaluate_wav2vec2am` on .npy emissions written here, with the scorer
  (host decoder) and without (the beam kernel's plain version on the
  port's side, stt_tpu's XLA scan on its side), and
  `compute_lm_optimization_wav2vec2am`: the same transcripts, WER and CER,
  and the same best (alpha, beta, WER);
- `collect_emissions_torch` (the --model_dir path with a scorer) with a
  stand-in for the model that `load_wav2vec2` loads (and, on stt_tpu's
  side, for `transformers`' Wav2Vec2ForCTC): the model and its input on
  the device asked for (the card by default, refused here), emissions
  equal to stt_tpu's bit for bit;
- `evaluate_wav2vec2am` with --model_dir and no scorer on a tiny seeded
  checkpoint: batches of 2 (`transcribe_batch`) give the transcripts of
  one utterance at a time.
"""

import contextlib
import io
import json
import os
import re
import sys
import types

import jax
import numpy as np
import pytest
import torch

from stt_tpu import evaluate_flashlight as jax_flashlight_eval
from stt_tpu import evaluate_wav2vec2am as jax_w2v
from stt_tpu import lm_optimizer as jax_lm_optimizer
from stt_tpu import training_graph_inference as jax_tgi
from stt_tpu.alphabet import Alphabet as JaxAlphabet
from stt_tpu.config import SttConfig as JaxSttConfig
from stt_tpu.decode import ctc_beam_search_decoder_for_wav2vec2am as jax_w2v_decoder
from stt_tpu.decode.flashlight import flashlight_beam_search_decoder as jax_flashlight
from stt_tpu.decode.scorer_package import KenLMScorer as JaxKenLMScorer
from stt_tpu.frontend import FeatureConfig as JaxFeatureConfig
from stt_tpu.frontend import audio_to_mfcc_numpy as jax_audio_to_mfcc_numpy
from stt_tpu.models import init_params
from stt_tpu.train.checkpoints import CheckpointManager as JaxCheckpointManager
from stt_tpu.train.step import create_train_state as jax_create_train_state
from stt_tpu.train.trainer import create_optimizer_with_hyperparams as jax_optimizer
from stt_tpu_torch import evaluate_flashlight, evaluate_wav2vec2am, lm_optimizer
from stt_tpu_torch import training_graph_inference
from stt_tpu_torch.alphabet import Alphabet
from stt_tpu_torch.artifact import params_from_numpy
from stt_tpu_torch.config import SttConfig
from stt_tpu_torch.data.audio import write_wav
from stt_tpu_torch.decode import ctc_beam_search_decoder_for_wav2vec2am
from stt_tpu_torch.decode.flashlight import flashlight_beam_search_decoder
from stt_tpu_torch.decode.scorer_package import KenLMScorer
from stt_tpu_torch.frontend import FeatureConfig, audio_to_mfcc_numpy
from stt_tpu_torch.train.checkpoints import CheckpointManager
from stt_tpu_torch.train.step import create_train_state
from stt_tpu_torch.train.trainer import create_optimizer_with_hyperparams
from test_torch_evaluate import assert_same_results, utterance, write_test_csv
from test_torch_scorer import LABELS, WORDS, build_package, write_inputs

BEAM = 16
VOCABULARY = WORDS[:40]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The alphabet, the scorer, a test CSV, a seeded WAV, and one set of
    weights saved as a stt_tpu checkpoint and as a port checkpoint."""
    root = tmp_path_factory.mktemp("entry")
    paths = write_inputs(root)
    rs = np.random.RandomState(0)
    wav = str(root / "one.wav")
    write_wav(wav, utterance(rs, 1.7), 16000)
    args = dict(alphabet_config_path=paths["alphabet"], n_hidden=32, beam_width=BEAM,
                export_beam_width=BEAM, test_batch_size=2)
    jax_config = JaxSttConfig(checkpoint_dir=str(root / "jax_ckpt"), **args)
    config = SttConfig(checkpoint_dir=str(root / "port_ckpt"), **args)
    params = jax.device_get(init_params(jax.random.PRNGKey(3),
                                        jax_config.model_config(training=False)))
    optimizer = jax_optimizer(jax_config)
    JaxCheckpointManager(jax_config.save_checkpoint_dir).save(
        jax_create_train_state(None, jax_config.model_config(training=False), optimizer,
                               params=params), "best_dev", dev_loss=1.0)
    model = params_from_numpy(params, config.model_config(training=False))
    state = create_train_state(config.model_config(training=False), device="cpu", model=model)
    state.optimizer = create_optimizer_with_hyperparams(config, state.model.parameters())
    CheckpointManager(config.save_checkpoint_dir).save(state, "best_dev", dev_loss=1.0)
    return {"root": root, "alphabet": paths["alphabet"], "scorer": build_package(root, "lm.scorer"),
            "csv": write_test_csv(root / "test.csv", rs), "wav": wav, "params": params,
            "model": model, "jax_config": jax_config, "config": config, "args": args}


def quiet(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kw)
    return result, out.getvalue()


@pytest.mark.parametrize("rate", [16000, 8000])
def test_audio_to_mfcc_numpy_equals_stt_tpus(rate):
    audio = np.random.RandomState(rate).randn(rate * 2 + 77).astype(np.float32) * 0.2
    got = audio_to_mfcc_numpy(audio, FeatureConfig.from_ms(rate))
    want = jax_audio_to_mfcc_numpy(audio, JaxFeatureConfig.from_ms(rate))
    assert got.shape == want.shape == (99, 26) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert audio_to_mfcc_numpy(audio[:100]).shape == (0, 26)


@pytest.mark.parametrize("with_scorer", [False, True])
def test_training_graph_inference_equals_stt_tpus(data, with_scorer):
    scorer = dict(scorer_path=data["scorer"]) if with_scorer else {}
    jax_config = JaxSttConfig(checkpoint_dir=data["jax_config"].checkpoint_dir, **data["args"],
                              **scorer)
    config = SttConfig(checkpoint_dir=data["config"].checkpoint_dir, **data["args"], **scorer)
    want, _ = quiet(jax_tgi.do_single_file_inference, jax_config, data["wav"])
    got, printed = quiet(training_graph_inference.do_single_file_inference, config, data["wav"],
                         device="cpu")
    assert got == want and printed.endswith(got + "\n")
    assert "Loaded 'best_dev' checkpoint" in printed


def trial_lines(printed: str) -> list:
    return re.findall(r"(baseline|trial \d+):? alpha=(\S+) beta=(\S+) -> (\S+)", printed)


def test_lm_optimizer_equals_stt_tpus(data):
    args = dict(data["args"], test_files=[data["csv"]], scorer_path=data["scorer"])
    want, jax_printed = quiet(jax_lm_optimizer.compute_lm_optimization, JaxSttConfig(**args),
                              n_trials=7, params=data["params"])
    got, printed = quiet(lm_optimizer.compute_lm_optimization, SttConfig(**args), n_trials=7,
                         model=data["model"], device="cpu")
    assert got == want
    assert len(trial_lines(printed)) == 8
    assert trial_lines(printed) == trial_lines(jax_printed)


def peaky_log_probs(seed: int, words, alphabet, T_per_char=3, C=29):
    """[T, C] log probabilities that spell `words` with blanks and repeats,
    under noise."""
    rs = np.random.RandomState(seed)
    path = []
    for word in words:
        for c in alphabet.encode(word + " "):
            path += [c] * rs.randint(1, T_per_char) + [C - 1] * rs.randint(0, 2)
    logits = rs.randn(len(path), C)
    logits[np.arange(len(path)), path] += 8.0
    return (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)


@pytest.mark.parametrize("decoder_type", ["lexicon", "lexicon_free"])
def test_flashlight_decoder_equals_stt_tpus(data, decoder_type):
    alphabet, jax_alphabet = Alphabet(data["alphabet"]), JaxAlphabet(data["alphabet"])
    scorer, jax_scorer = KenLMScorer(data["scorer"]), JaxKenLMScorer(data["scorer"])
    for seed, words in enumerate((["she", "was", "with", "her"], ["the", "water", "was", "dark"])):
        log_probs = peaky_log_probs(seed, words, alphabet)
        kw = dict(vocabulary=VOCABULARY if seed == 0 else None, decoder_type=decoder_type,
                  beam_size=24, lm_weight=0.8, word_score=0.5, num_results=3)
        got = flashlight_beam_search_decoder(log_probs, alphabet, scorer, **kw)
        want = jax_flashlight(log_probs, jax_alphabet, jax_scorer, **kw)
        assert len(got) == len(want) >= 1
        assert [(r.words, r.tokens) for r in got] == [(r.words, r.tokens) for r in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose([g.score, g.am_score, g.lm_score],
                                       [w.score, w.am_score, w.lm_score], rtol=1e-5, atol=1e-5)
        if decoder_type == "lexicon" and seed == 0:  # the lexicon given here
            assert got[0].words == words


@pytest.mark.parametrize("decoder_type", ["lexicon", "lexicon_free"])
def test_evaluate_flashlight_equals_stt_tpus(data, decoder_type, tmp_path):
    args = dict(data["args"], test_files=[data["csv"]], scorer_path=data["scorer"])
    kw = dict(decoder_type=decoder_type, beam_size=BEAM, lm_weight=0.7, word_score=0.2)
    want, jax_printed = quiet(jax_flashlight_eval.evaluate_flashlight,
                              JaxSttConfig(test_output_file=str(tmp_path / "jax.json"), **args),
                              params=data["params"], **kw)
    got, printed = quiet(evaluate_flashlight.evaluate_flashlight,
                         SttConfig(test_output_file=str(tmp_path / "port.json"), **args),
                         model=data["model"], device="cpu", **kw)
    assert len(got) == len(want) == 1 and len(got[0]) == 5
    assert_same_results(got[0], want[0])
    report = re.compile(r"Test on .* - WER: \S+, CER: \S+")
    assert report.findall(printed) == report.findall(jax_printed)
    assert f"[flashlight/{decoder_type}]" in printed
    with open(tmp_path / "port.json") as f, open(tmp_path / "jax.json") as g:
        assert [r["res"] for r in json.load(f)] == [r["res"] for r in json.load(g)]


AM_LABELS = ["<pad>", "<s>", "</s>", "<unk>", " "] + LABELS[1:] + ["X"]
AM_IGNORED = [1, 2, 3]


def am_emissions(seed: int, words, log: bool = True):
    """[T, C] emissions of a wav2vec2-style AM (blank 0 first) spelling
    `words`, with some weight on the control tokens and on "X" (absent from
    the scorer's alphabet)."""
    rs = np.random.RandomState(seed)
    index = {label: i for i, label in enumerate(AM_LABELS)}
    path = []
    for word in words:
        for c in word + " ":
            path += [index[c]] * rs.randint(1, 3) + [0] * rs.randint(0, 2)
    logits = rs.randn(len(path), len(AM_LABELS))
    logits[np.arange(len(path)), path] += 5.0
    logits[:, -1] += 1.0
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return np.log(probs).astype(np.float32) if log else probs.astype(np.float32)


@pytest.mark.parametrize("with_scorer", [False, True])
def test_wav2vec2_decoder_equals_stt_tpus(data, with_scorer):
    am, jax_am = Alphabet().init_from_labels(AM_LABELS), JaxAlphabet().init_from_labels(AM_LABELS)
    alphabet, jax_alphabet = Alphabet(data["alphabet"]), JaxAlphabet(data["alphabet"])
    scorer = KenLMScorer(data["scorer"]) if with_scorer else None
    jax_scorer = JaxKenLMScorer(data["scorer"]) if with_scorer else None
    ignored = AM_IGNORED + [len(AM_LABELS) - 1]
    for seed, words in enumerate((["water", "was", "dark"], ["the", "year"])):
        probs = am_emissions(seed, words, log=False)
        kw = dict(blank_id=0, ignored_symbols=ignored, num_results=3)
        got = ctc_beam_search_decoder_for_wav2vec2am(probs, alphabet, BEAM, am_alphabet=am,
                                                     scorer=scorer, **kw)
        want = jax_w2v_decoder(probs, jax_alphabet, BEAM, am_alphabet=jax_am, scorer=jax_scorer,
                               **kw)
        assert [(r.transcript, list(r.tokens), list(r.timesteps)) for r in got] == \
            [(r.transcript, list(r.tokens), list(r.timesteps)) for r in want]
        np.testing.assert_allclose([r.confidence for r in got], [r.confidence for r in want],
                                   rtol=1e-9)
        assert got[0].transcript.split() == words


@pytest.fixture(scope="module")
def am_dir(data):
    """A wav2vec2 AM directory (config.json: labels, blank 0, ignored
    controls) and .npy emissions for each WAV of the test CSV."""
    root = data["root"] / "w2v"
    (root / "emissions").mkdir(parents=True)
    (root / "config.json").write_text(json.dumps(
        {"alphabet_labels": AM_LABELS, "blank_id": 0, "ignored_symbols": AM_IGNORED}))
    entries = jax_w2v.read_csv_entries([data["csv"]])
    for seed, (wav, transcript) in enumerate(entries):
        stem = os.path.splitext(os.path.basename(wav))[0]
        np.save(root / "emissions" / f"{stem}.npy", am_emissions(seed, transcript.split()))
    return root


@pytest.mark.parametrize("with_scorer", [False, True])
def test_evaluate_wav2vec2am_equals_stt_tpus(data, am_dir, with_scorer):
    kw = dict(emissions_dir=str(am_dir / "emissions"), beam_width=BEAM)
    if with_scorer:
        kw.update(scorer_path=data["scorer"], scorer_alphabet_path=data["alphabet"],
                  lm_alpha=0.5, lm_beta=1.0)
    want, _ = quiet(jax_w2v.evaluate_wav2vec2am, [data["csv"]], str(am_dir), **kw)
    got, _ = quiet(evaluate_wav2vec2am.evaluate_wav2vec2am, [data["csv"]], str(am_dir),
                   device="cpu", **kw)
    assert [(r.sample_id, r.src, r.res, r.wer, r.cer) for r in got] == \
        [(r.sample_id, r.src, r.res, r.wer, r.cer) for r in want]
    assert len(got) == 5 and sum(r.wer for r in got) < 5


def test_wav2vec2am_lm_optimization_equals_stt_tpus(data, am_dir):
    args = ([data["csv"]], str(am_dir), data["scorer"], data["alphabet"])
    kw = dict(emissions_dir=str(am_dir / "emissions"), beam_width=BEAM, n_trials=5)
    want, jax_printed = quiet(jax_w2v.compute_lm_optimization_wav2vec2am, *args, **kw)
    got, printed = quiet(evaluate_wav2vec2am.compute_lm_optimization_wav2vec2am, *args, **kw)
    assert got == want
    assert trial_lines(printed) == trial_lines(jax_printed) and len(trial_lines(printed)) == 5


class StandInWav2Vec2(torch.nn.Module):
    """A wav2vec2-shaped stand-in: raw audio [1, S] -> logits [1, S / 320,
    C] from a strided convolution, seeded, recording its input's device."""

    seen = []

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(5)
        self.conv = torch.nn.Conv1d(1, len(AM_LABELS), 320, stride=320)
        with torch.no_grad():
            for p in self.conv.parameters():
                p.copy_(torch.randn(p.shape, generator=gen))

    @classmethod
    def from_pretrained(cls, model_dir):
        assert os.path.isfile(os.path.join(model_dir, "config.json"))
        return cls()

    def forward(self, audio):
        StandInWav2Vec2.seen.append(audio.device)
        return types.SimpleNamespace(logits=self.conv(audio[:, None]).transpose(1, 2))


class PortStandIn(StandInWav2Vec2):
    """The stand-in with the port's model's call: (audio [B, S], lengths)
    -> (logits [B, T, C], frames [B])."""

    def forward(self, audio, lengths):
        logits = super().forward(audio).logits
        return logits, torch.full((audio.shape[0],), logits.shape[1])


def stand_in_loader(model_dir, device):
    assert os.path.isfile(os.path.join(model_dir, "config.json"))
    return PortStandIn().to(device)


def test_collect_emissions_torch_runs_on_the_device_asked_for(data, am_dir, monkeypatch):
    monkeypatch.setattr(evaluate_wav2vec2am, "load_wav2vec2", stand_in_loader)
    wavs = [wav for wav, _ in jax_w2v.read_csv_entries([data["csv"]])]
    StandInWav2Vec2.seen.clear()
    got = evaluate_wav2vec2am.collect_emissions_torch(str(am_dir), wavs, device="cpu")
    assert StandInWav2Vec2.seen == [torch.device("cpu")] * len(wavs)
    with monkeypatch.context() as m:  # stt_tpu's side loads transformers' class
        m.setitem(sys.modules, "transformers",
                  types.SimpleNamespace(Wav2Vec2ForCTC=StandInWav2Vec2))
        want = jax_w2v.collect_emissions_torch(str(am_dir), wavs)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.shape == w.shape and g.shape[1] == len(AM_LABELS)
        np.testing.assert_array_equal(g, w)
    if not torch.cuda.is_available():  # the default is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            evaluate_wav2vec2am.collect_emissions_torch(str(am_dir), wavs)


@pytest.fixture(scope="module")
def w2v2_dir(data):
    """A tiny wav2vec2 checkpoint in HuggingFace's layout (config.json,
    vocab.json, pytorch_model.bin), seeded, its CTC head scaled so that the
    emissions are peaky."""
    from stt_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2CTC

    root = data["root"] / "w2v2"
    root.mkdir()
    config = dict(conv_dim=[16] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2],
                  conv_stride=[5, 2, 2, 2, 2, 2, 2], hidden_size=32, num_hidden_layers=2,
                  num_attention_heads=2, intermediate_size=64, num_conv_pos_embeddings=16,
                  num_conv_pos_embedding_groups=2, vocab_size=len(AM_LABELS), pad_token_id=0,
                  do_stable_layer_norm=True, feat_extract_norm="layer")
    (root / "config.json").write_text(json.dumps(config))
    (root / "vocab.json").write_text(json.dumps(
        {("|" if label == " " else label): i for i, label in enumerate(AM_LABELS)}))
    torch.manual_seed(21)
    model = Wav2Vec2CTC(Wav2Vec2Config.from_dict(config))
    with torch.no_grad():
        model.lm_head.weight.mul_(30.0)
    torch.save(model.state_dict(), root / "pytorch_model.bin")
    return root


def test_evaluate_wav2vec2am_batches_give_the_transcripts_of_one_at_a_time(data, w2v2_dir):
    kw = dict(beam_width=16, device="cpu")
    one, _ = quiet(evaluate_wav2vec2am.evaluate_wav2vec2am, [data["csv"]], str(w2v2_dir),
                   test_batch_size=1, **kw)
    two, _ = quiet(evaluate_wav2vec2am.evaluate_wav2vec2am, [data["csv"]], str(w2v2_dir),
                   test_batch_size=2, **kw)
    assert len(one) == len(two) == 5
    assert [(r.sample_id, r.src, r.res) for r in two] == \
        [(r.sample_id, r.src, r.res) for r in one]
    assert all(r.res for r in one)
