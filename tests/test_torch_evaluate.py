"""The port's evaluation slice against stt_tpu's on the CPU, at a tiny width:

- `text` and `evaluate_tools`: the same numbers, the report's captured
  stdout and the samples JSON byte-equal;
- `evaluate(config, model=...)` against `stt_tpu.evaluate.evaluate(config,
  params=...)` on the same weights (carried across by `params_from_numpy`)
  and one CSV of seeded synthetic WAVs, in every --device_decode mode,
  with a scorer built in the test and with a cutoff_top_n that takes the
  chunked prune: transcripts, WER and CER equal, losses within 1e-5
  absolute plus 1e-5 relative (float32 sums in another order), and the
  --test_output_file JSON equal up to that loss tolerance. stt_tpu's
  `full` mode takes its own route on the CPU (the XLA scan); the port's,
  the beam kernel's plain version;
- `ctc_beam_search_decoder_batch_pruned` against stt_tpu's on host arrays
  and on 3-D tensors (jax.Array on stt_tpu's side), with T > 128 so that
  the chunked path packs three chunks, in identity mode and with
  cutoff_top_n < C - 2: equal candidates (transcripts, tokens, timesteps),
  confidences equal from host arrays and within 1e-6 relative from
  tensors, whose planes hold torch's float32 log against XLA's (they may
  differ in the last bit); `_prune_pack` and `unpack_pruned` give stt_tpu's
  planes to 2e-7 relative (that last bit), and the unpacked planes are the
  port's `prune_emissions` exactly;
- `evaluate_from_csv`: equal reports;
- the command line with --device cpu, and the --device_decode values.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stt_tpu import evaluate_tools as jax_tools
from stt_tpu import text as jax_text
from stt_tpu.config import SttConfig as JaxSttConfig
from stt_tpu.decode import device as jax_device
from stt_tpu.evaluate import evaluate as jax_evaluate
from stt_tpu.evaluate_from_csv import evaluate_from_csv as jax_evaluate_from_csv
from stt_tpu.models import init_params
from stt_tpu_torch import evaluate_tools, text
from stt_tpu_torch.alphabet import Alphabet
from stt_tpu_torch.artifact import params_from_numpy
from stt_tpu_torch.config import SttConfig, parse_flags
from stt_tpu_torch.data.sources import CSVWriter, Sample
from stt_tpu_torch.decode import ctc_beam_search_decoder_batch
from stt_tpu_torch.decode import device as port_device
from stt_tpu_torch.evaluate import evaluate
from stt_tpu_torch.evaluate_from_csv import evaluate_from_csv
from stt_tpu_torch.train.checkpoints import CheckpointManager
from stt_tpu_torch.train.step import create_train_state
from test_torch_scorer import WORDS, build_package, write_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_ATOL = LOSS_RTOL = 1e-5
BEAM = 16


def utterance(rs, seconds):
    n = int(seconds * 16000)
    t = np.arange(n) / 16000
    audio = sum(rs.uniform(0.05, 0.2) * np.sin(2 * np.pi * rs.uniform(90, 400) * t)
                for _ in range(3)) + 0.02 * rs.randn(n)
    return np.clip(audio, -1, 1).astype(np.float32)


def write_test_csv(path, rs, n=5):
    with CSVWriter(str(path)) as writer:
        for i in range(n):
            writer.add(Sample(f"t{i}", " ".join(rs.choice(WORDS, rs.randint(2, 4))),
                              _audio=utterance(rs, rs.uniform(0.8, 1.6)), _rate=16000))
    return str(path)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("evaluate")
    paths = write_inputs(root)
    return {
        "alphabet": paths["alphabet"],
        "scorer": build_package(root, "lm.scorer"),
        "csv": write_test_csv(root / "test.csv", np.random.RandomState(0)),
        "root": root,
    }


def configs(data, out_dir, **kw):
    """(stt_tpu's config, the port's) with the same flags; each writes its
    own --test_output_file."""
    args = dict(test_files=[data["csv"]], alphabet_config_path=data["alphabet"], n_hidden=32,
                test_batch_size=2, export_beam_width=BEAM, **kw)
    return (JaxSttConfig(test_output_file=str(out_dir / "jax.json"), **args),
            SttConfig(test_output_file=str(out_dir / "port.json"), **args))


def weights(jax_config, config, seed=3):
    params = jax.device_get(init_params(jax.random.PRNGKey(seed),
                                        jax_config.model_config(training=False)))
    return params, params_from_numpy(params, config.model_config(training=False))


def run_quiet(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kw)
    return result, out.getvalue()


def assert_same_results(got, want):
    assert [(r.sample_id, r.src, r.res, r.wer, r.cer) for r in got] == \
        [(r.sample_id, r.src, r.res, r.wer, r.cer) for r in want]
    np.testing.assert_allclose([r.loss for r in got], [r.loss for r in want],
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)


def assert_same_json(path, want_path):
    with open(path) as f, open(want_path) as g:
        got, want = json.load(f), json.load(g)
    assert [{k: v for k, v in r.items() if k != "loss"} for r in got] == \
        [{k: v for k, v in r.items() if k != "loss"} for r in want]
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in want],
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)


# -- text and evaluate_tools -------------------------------------------------

TEXT_CASES = [
    ("levenshtein", ("", "")), ("levenshtein", ("abc", "abc")), ("levenshtein", ("abc", "")),
    ("levenshtein", ("kitten", "sitting")), ("levenshtein", (["a", "b"], ["b"])),
    ("wer", ("she had your dark suit", "she had your dark suit")),
    ("cer", ("she had your dark suit", "she had your dark suit")),
    ("wer", ("she had your dark suit", "she had your dark suits")),
    ("wer", ("a b c d", "a b")), ("wer", ("", "something")),
    ("cer", ("kitten", "sitting")), ("word_distance", ("a b c", "a x c d")),
    ("char_distance", ("abc", "")),
    ("wer_cer_batch", (["a b", "c d e f"], ["a b", "c d e x"])),
]


@pytest.mark.parametrize("name,args", TEXT_CASES)
def test_text_equals_stt_tpu(name, args):
    assert getattr(text, name)(*args) == getattr(jax_text, name)(*args)


def sample_results(module):
    rs = np.random.RandomState(5)
    out = []
    for i in range(7):
        src = " ".join(rs.choice(WORDS, rs.randint(1, 5)))
        res = " ".join(rs.choice(WORDS, rs.randint(0, 5)))
        out.append(module.process_decode_result(f"wav{i}.wav", src, res, float(rs.rand() * 50)))
    return out


@pytest.mark.parametrize("report_count", [1, 3, 10])
def test_report_and_samples_json_are_byte_equal(tmp_path, report_count):
    got, got_out = run_quiet(evaluate_tools.calculate_and_print_report,
                             sample_results(evaluate_tools), "test.csv", report_count)
    want, want_out = run_quiet(jax_tools.calculate_and_print_report,
                               sample_results(jax_tools), "test.csv", report_count)
    assert got == want
    assert got_out == want_out and "Median WER:" in got_out
    evaluate_tools.save_samples_json(sample_results(evaluate_tools), str(tmp_path / "port.json"))
    jax_tools.save_samples_json(sample_results(jax_tools), str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


def test_evaluate_from_csv_equals_stt_tpu(tmp_path):
    rows = [("a.wav", "she had your", "she has your"), ("b.wav", "dark suit", "dark suit"),
            ("c.wav", "in greasy wash", "in grease watch")]
    for name, col in (("ref.csv", 1), ("hyp.csv", 2)):
        with open(tmp_path / name, "w") as f:
            f.write("wav_filename,wav_filesize,transcript\n")
            f.write("".join(f"{r[0]},0,{r[col]}\n" for r in rows))
    ref, hyp = str(tmp_path / "ref.csv"), str(tmp_path / "hyp.csv")
    got, got_out = run_quiet(evaluate_from_csv, ref, hyp)
    want, want_out = run_quiet(jax_evaluate_from_csv, ref, hyp)
    assert got_out == want_out
    assert [r.to_dict() for r in got] == [r.to_dict() for r in want]


# -- evaluate ------------------------------------------------------------------

MODES = [
    dict(device_decode="off"),
    dict(device_decode="prune"),
    dict(device_decode="full"),
    dict(device_decode="auto"),
    dict(device_decode="prune", scorer_path="lm"),
    dict(device_decode="full", scorer_path="lm"),
    dict(device_decode="off", scorer_path="lm"),
    dict(device_decode="prune", cutoff_top_n=10),
    dict(device_decode="full", cutoff_top_n=10, cutoff_prob=0.99),
]


@pytest.mark.parametrize("kw", MODES, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_evaluate_equals_stt_tpu(data, tmp_path, kw):
    if kw.get("scorer_path"):
        kw = dict(kw, scorer_path=data["scorer"])
    jax_config, config = configs(data, tmp_path, **kw)
    params, model = weights(jax_config, config)
    [want], want_out = run_quiet(jax_evaluate, jax_config, params=params)
    [got], got_out = run_quiet(evaluate, config, model=model, device="cpu")
    assert len(got) == 5
    assert_same_results(got, want)
    assert_same_json(config.test_output_file, jax_config.test_output_file)
    # the report's lines up to the loss, which is compared by tolerance
    head = lambda out: [l.split(", loss")[0] for l in out.splitlines() if "Test on" in l]
    assert head(got_out) == head(want_out)


def test_off_prune_and_full_give_one_transcript(data, tmp_path):
    """As tests/test_cli_e2e.py requires of stt_tpu: the three decodes agree."""
    outputs = {}
    for mode in ("off", "prune", "full"):
        _, config = configs(data, tmp_path, device_decode=mode)
        _, model = weights(*configs(data, tmp_path), seed=4)
        [results], _ = run_quiet(evaluate, config, model=model, device="cpu")
        outputs[mode] = [(r.res, r.wer) for r in results]
    assert outputs["off"] == outputs["prune"] == outputs["full"]


def test_evaluate_loads_the_checkpoint(data, tmp_path):
    """Without a model, evaluate restores best_dev, then last, as
    load_graph_for_evaluation orders them."""
    jax_config, config = configs(data, tmp_path, checkpoint_dir=str(tmp_path / "ckpt"))
    params, model = weights(jax_config, config)
    state = create_train_state(config.model_config(training=False), device="cpu", model=model)
    state.step = 7
    CheckpointManager(config.checkpoint_dir).save(state, "last")
    [got], out = run_quiet(evaluate, config, device="cpu")
    assert "Loaded 'last' checkpoint for evaluation" in out
    [want], _ = run_quiet(jax_evaluate, jax_config, params=params)
    assert_same_results(got, want)


def test_evaluate_module_runs_on_the_cpu_when_asked(data, tmp_path):
    jax_config, config = configs(data, tmp_path, checkpoint_dir=str(tmp_path / "ckpt"))
    params, model = weights(jax_config, config)
    CheckpointManager(config.checkpoint_dir).save(
        create_train_state(config.model_config(training=False), device="cpu", model=model), "last")
    args = ["--device", "cpu", "--test_files", data["csv"], "--alphabet_config_path",
            data["alphabet"], "--n_hidden", "32", "--test_batch_size", "2",
            "--export_beam_width", str(BEAM), "--checkpoint_dir", config.checkpoint_dir,
            "--test_output_file", config.test_output_file]
    env = {**os.environ, "PYTHONPATH": ROOT, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "stt_tpu_torch.evaluate", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "Decode throughput on" in proc.stdout and "WER:" in proc.stdout
    run_quiet(jax_evaluate, jax_config, params=params)
    assert_same_json(config.test_output_file, jax_config.test_output_file)


def test_device_decode_takes_stt_tpu_values():
    for mode in ("auto", "full", "prune", "off"):
        argv = ["--device_decode", mode]
        assert parse_flags(argv).device_decode == mode
        assert JaxSttConfig(device_decode=mode).device_decode == mode
    with pytest.raises(ValueError, match="device_decode"):
        SttConfig(device_decode="gpu")


# -- the pruned batch decoder --------------------------------------------------

def peaky(B, T, C, seed):
    rs = np.random.RandomState(seed)
    logits = rs.randn(B, T, C).astype(np.float32) * 3.0
    logits[..., -1] += 1.5  # blank-heavy, as a CTC model's output is
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


ALPHABET_LABELS = list(" abcdefghijklmnopqrstuvwxyz'")
PRUNE_CASES = [  # (cutoff_top_n, cutoff_prob)
    (40, 1.0),  # identity: top_n >= C, nothing sorts
    (10, 1.0),  # sorted, every class kept
    (10, 0.99),  # sorted and truncated
    (5, 0.9),
]


def assert_same_decodes(got, want, rtol):
    """Equal candidates (transcripts, tokens, timesteps); confidences within
    rtol: the float32 logs of torch and of XLA may differ in the last bit,
    and the unpruned decoder takes them in float64."""
    key = lambda results: [[(r.transcript, list(r.tokens), list(r.timesteps)) for r in rs]
                           for rs in results]
    assert key(got) == key(want)
    np.testing.assert_allclose([[r.confidence for r in rs] for rs in got],
                               [[r.confidence for r in rs] for rs in want], rtol=rtol)


@pytest.mark.parametrize("cutoff_top_n,cutoff_prob", PRUNE_CASES)
@pytest.mark.parametrize("form", ["tensor", "array", "list"])
def test_batch_pruned_decoder_equals_stt_tpu(form, cutoff_top_n, cutoff_prob):
    """T = 300: the chunked path packs chunks of 128, 128 and 44 frames."""
    alphabet = Alphabet().init_from_labels(ALPHABET_LABELS)
    from stt_tpu.alphabet import Alphabet as JaxAlphabet

    jax_alphabet = JaxAlphabet().init_from_labels(ALPHABET_LABELS)
    probs = peaky(3, 300, len(ALPHABET_LABELS) + 1, seed=cutoff_top_n)
    lengths = [300, 131, 17]
    if form == "tensor":
        ours, theirs = torch.from_numpy(probs), jnp.asarray(probs)
    elif form == "array":
        ours = theirs = probs
    else:
        ours = theirs = [probs[i, :n] for i, n in enumerate(lengths)]
    args = dict(beam_size=8, cutoff_top_n=cutoff_top_n, cutoff_prob=cutoff_prob, num_results=2)
    got = port_device.ctc_beam_search_decoder_batch_pruned(ours, lengths, alphabet, **args)
    want = jax_device.ctc_beam_search_decoder_batch_pruned(theirs, lengths, jax_alphabet, **args)
    assert_same_decodes(got, want, rtol=1e-6 if form == "tensor" else 0)
    plain = ctc_beam_search_decoder_batch(list(probs), lengths, alphabet, 8,
                                          cutoff_prob=cutoff_prob, cutoff_top_n=cutoff_top_n,
                                          num_results=2)
    assert_same_decodes(got, plain, rtol=1e-5)


def test_batch_pruned_decoder_with_scorer_and_threads(data):
    from stt_tpu.alphabet import Alphabet as JaxAlphabet
    from stt_tpu.decode.scorer_package import KenLMScorer as JaxKenLMScorer
    from stt_tpu_torch.decode.scorer_package import KenLMScorer

    probs = peaky(4, 200, len(ALPHABET_LABELS) + 1, seed=11)
    lengths = [200, 160, 140, 90]
    args = dict(beam_size=16, num_processes=4, cutoff_top_n=12, cutoff_prob=0.999)
    got = port_device.ctc_beam_search_decoder_batch_pruned(
        torch.from_numpy(probs), lengths, Alphabet(data["alphabet"]),
        scorer=KenLMScorer(data["scorer"]), **args)
    want = jax_device.ctc_beam_search_decoder_batch_pruned(
        jnp.asarray(probs), lengths, JaxAlphabet(data["alphabet"]),
        scorer=JaxKenLMScorer(data["scorer"]), **args)
    assert_same_decodes(got, want, rtol=1e-6)
    assert any(r[0].transcript.strip() for r in got)


@pytest.mark.parametrize("cutoff_top_n,cutoff_prob", PRUNE_CASES)
def test_prune_pack_and_unpack_equal_stt_tpu(cutoff_top_n, cutoff_prob):
    probs = peaky(2, 40, 30, seed=3)
    identity = cutoff_prob >= 1.0 and cutoff_top_n >= 30
    packed = port_device._prune_pack(torch.from_numpy(probs), cutoff_top_n, cutoff_prob).numpy()
    want = np.asarray(jax_device._prune_pack(jnp.asarray(probs), cutoff_top_n, cutoff_prob))
    assert packed.shape == want.shape and packed.dtype == want.dtype == np.float32
    # idx, count and blank exactly; logp within a float32 ulp of log
    np.testing.assert_allclose(packed, want, rtol=2e-7, atol=0)
    got = port_device.unpack_pruned(packed, identity=identity)
    ref = jax_device.unpack_pruned(want, identity=identity)
    pruned = [a.numpy() for a in port_device.prune_emissions(
        torch.from_numpy(probs), cutoff_top_n, cutoff_prob)]
    for a, b, c in zip(got, ref, pruned):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=2e-7, atol=0)
        # the unpacked plane is the pruning itself
        np.testing.assert_array_equal(a, c)
