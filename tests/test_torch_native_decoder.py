"""The port's native (C++) and Python beam decoders against stt_tpu's native
and Python decoders on the same seeded emissions: tokens and timesteps
equal, confidences within 1e-6 (the tolerance of
tests/test_native_decoder.py: C++ and Python sum the same float64 terms,
in places in another order). The scorer packages are built here
(tests/test_torch_scorer.py); the emissions have no exact ties between
classes (on a tie the native and the Python decoder may keep different
prefixes, in both packages alike).

Also: the batch fan-out at 1 and 4 threads, `validate_scorer`, the
library's build (concurrent first builds, and no fallback to the Python
decoder when it fails).
"""

import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from stt_tpu.alphabet import Alphabet as JaxAlphabet
from stt_tpu.alphabet import UTF8Alphabet as JaxUTF8Alphabet
from stt_tpu.decode import ctc_beam_search_decoder_batch as jax_decoder_batch
from stt_tpu.decode import make_decoder_state as jax_make_decoder_state
from stt_tpu.decode import native as jax_native
from stt_tpu.decode.scorer import StaticScorer as JaxStaticScorer
from stt_tpu.decode.scorer_package import KenLMScorer as JaxKenLMScorer
from stt_tpu_torch.alphabet import Alphabet, UTF8Alphabet
from stt_tpu_torch.decode import ctc_beam_search_decoder_batch, make_decoder_state
from stt_tpu_torch.decode import native
from stt_tpu_torch.decode.beam import DecoderState
from stt_tpu_torch.decode.device import prune_emissions_host
from stt_tpu_torch.decode.native import NativeDecoderState
from stt_tpu_torch.decode.scorer import StaticScorer
from stt_tpu_torch.decode.scorer_package import KenLMScorer
from test_torch_scorer import LABELS, build_package, corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF_TOL = 1e-6
HOT_WORDS = {"water": 2.5, "the": -1.0, "don't": 1.5}


@pytest.fixture(scope="module")
def packages(tmp_path_factory):
    root = tmp_path_factory.mktemp("packages")
    return {"alphabet": build_package(root, "lm.scorer"),
            "bytes": build_package(root, "bytes.scorer", bytes_mode=True)}


def alphabets(utf8: bool = False):
    if utf8:
        return UTF8Alphabet(), JaxUTF8Alphabet()
    return Alphabet().init_from_labels(LABELS), JaxAlphabet().init_from_labels(LABELS)


def random_probs(seed: int, t: int = 60, c: int = len(LABELS) + 1) -> np.ndarray:
    rs = np.random.RandomState(seed)
    p = np.exp(rs.randn(t, c) * 3)
    return p / p.sum(-1, keepdims=True)


def spelled_probs(text: str, alphabet, seed: int, c: int) -> np.ndarray:
    """Emissions that spell `text` with noise: each label over 2-3 frames,
    blanks between, a rival label beside each one, silence at the start."""
    rs = np.random.RandomState(seed)
    frames = [c - 1] * 4
    for label in alphabet.encode(text):
        frames += [label] * rs.randint(2, 4) + [c - 1] * rs.randint(0, 3)
    logits = rs.randn(len(frames), c)
    for t, label in enumerate(frames):
        logits[t, label] += 6.0
        logits[t, rs.randint(c - 1)] += rs.uniform(2.0, 5.5)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return p / p.sum(-1, keepdims=True)


def sentence(seed: int) -> str:
    return " ".join(corpus(1, seed=100 + seed)[0])


def outputs(results) -> list:
    return [(r.tokens, r.timesteps, r.transcript, r.confidence) for r in results]


def assert_same(got: list, want: list, what: str) -> None:
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert g[:3] == w[:3], what
        assert g[3] == pytest.approx(w[3], abs=CONF_TOL), what


def feed(state, probs, chunk=None, pruned=None):
    if pruned is not None:
        state.next_pruned(*prune_emissions_host(probs.astype(np.float32), *pruned))
        return
    step = chunk or len(probs)
    for start in range(0, len(probs), step):
        state.next(probs[start:start + step])


# case -> (emissions, decoder arguments, how to feed them)
def case(name: str, packages):
    beam, cutoff, scorer, hot, utf8, chunk, pruned, n = 32, (1.0, 40), None, None, False, None, None, 1
    if name.startswith("no_lm"):
        probs = random_probs(int(name[-1]))
        n = 3
    elif name == "lm_hot_words":
        probs, scorer, hot, n = spelled_probs(sentence(0), alphabets()[0], 0, 29), "alphabet", HOT_WORDS, 3
    elif name == "lm_random":
        probs, scorer = random_probs(7), "alphabet"
    elif name == "cutoff":
        probs, cutoff, scorer = spelled_probs(sentence(1), alphabets()[0], 1, 29), (0.99, 10), "alphabet"
    elif name == "chunked":
        probs, scorer, hot, chunk = spelled_probs(sentence(2), alphabets()[0], 2, 29), "alphabet", HOT_WORDS, 7
    elif name == "next_pruned":
        probs, pruned, scorer = spelled_probs(sentence(3), alphabets()[0], 3, 29), (10, 0.99), "alphabet"
        cutoff = (0.99, 10)
    elif name == "utf8":
        # a bytes-mode package holds a language model of characters, for a
        # language written without spaces
        utf8, scorer, beam = True, "bytes", 16
        probs = spelled_probs(sentence(4).replace(" ", ""), alphabets(True)[0], 4, 256)
    elif name == "num_results_5":
        probs, scorer, n = spelled_probs(sentence(5), alphabets()[0], 5, 29), "alphabet", 5
    else:
        raise KeyError(name)
    path = packages[scorer] if scorer else None
    return probs, dict(beam=beam, cutoff=cutoff, path=path, hot=hot, utf8=utf8), dict(
        chunk=chunk, pruned=pruned), n


CASES = ["no_lm_0", "no_lm_1", "no_lm_2", "lm_hot_words", "lm_random", "cutoff", "chunked",
         "next_pruned", "utf8", "num_results_5"]


@pytest.mark.parametrize("name", CASES)
def test_four_decoders_agree(packages, name):
    """port native = port Python = stt_tpu native = stt_tpu Python."""
    probs, args, how, n = case(name, packages)
    ours, theirs = alphabets(args["utf8"])
    path = args["path"]
    scorer = KenLMScorer(path) if path else None
    jax_scorer = JaxKenLMScorer(path) if path else None
    cutoff_prob, top_n = args["cutoff"]
    states = {
        "port native": make_decoder_state(ours, args["beam"], cutoff_prob, top_n, scorer,
                                          args["hot"]),
        "port python": make_decoder_state(ours, args["beam"], cutoff_prob, top_n, scorer,
                                          args["hot"], implementation="python"),
        "stt_tpu native": jax_make_decoder_state(theirs, args["beam"], cutoff_prob, top_n,
                                                 jax_scorer, args["hot"], implementation="native"),
        "stt_tpu python": jax_make_decoder_state(theirs, args["beam"], cutoff_prob, top_n,
                                                 jax_scorer, args["hot"], implementation="python"),
    }
    assert isinstance(states["port native"], NativeDecoderState)
    assert type(states["port python"]) is DecoderState
    got = {}
    for key, state in states.items():
        feed(state, probs, **how)
        got[key] = outputs(state.decode(n))
    want = got["stt_tpu python"]
    assert len(want) == n and want[0][0]
    for key in ("port native", "port python", "stt_tpu native"):
        assert_same(got[key], want, f"{name}: {key}")
    if path and not args["utf8"]:
        # the language model reaches the transcript: it differs from the
        # decode without a scorer, and is made of dictionary words
        plain = make_decoder_state(ours, args["beam"], cutoff_prob, top_n)
        feed(plain, probs, **how)
        words = set(scorer.dictionary.words(ours))
        assert set(want[0][2].split()) <= words
        assert outputs(plain.decode(1))[0][3] != want[0][3]


def test_alpha_beta_and_buffer_scorer(packages):
    """NaN alpha/beta keep the package's values; set ones replace them; a
    package loaded from a buffer (no path) takes the Python decoder."""
    ours, _ = alphabets()
    probs = spelled_probs(sentence(6), ours, 6, 29)
    path = packages["alphabet"]

    def run(state):
        state.next(probs)
        return outputs(state.decode(2))

    default = run(NativeDecoderState(ours, 32, scorer_path=path))
    assert_same(default, run(NativeDecoderState(ours, 32, scorer_path=path, alpha=0.93,
                                                beta=1.18)), "package values")
    moved = run(make_decoder_state(ours, 32, scorer=KenLMScorer(path, alpha=2.0, beta=-1.0)))
    assert moved[0][3] != default[0][3]
    with open(path, "rb") as f:
        buffered = KenLMScorer(data=f.read(), alpha=2.0, beta=-1.0)
    state = make_decoder_state(ours, 32, scorer=buffered)
    assert type(state) is DecoderState
    assert_same(run(state), moved, "buffer scorer through the Python decoder")


def test_static_scorer_takes_the_python_route():
    ours, theirs = alphabets()
    table = {("the",): -1.0, ("water",): -2.5, ("the", "water"): -0.5, ("oil",): -3.0}
    vocab = ["the", "water", "oil"]
    scorer = StaticScorer(table, 2, 0.8, 0.3, vocab, ours)
    jax_scorer = JaxStaticScorer(table, 2, 0.8, 0.3, vocab, theirs)
    probs = spelled_probs("the water oil", ours, 8, 29)
    state = make_decoder_state(ours, 16, scorer=scorer, hot_words={"oil": 1.0})
    assert type(state) is DecoderState
    state.next(probs)
    ref = jax_make_decoder_state(theirs, 16, scorer=jax_scorer, hot_words={"oil": 1.0})
    assert type(ref).__name__ == "DecoderState"
    ref.next(probs)
    assert_same(outputs(state.decode(3)), outputs(ref.decode(3)), "static scorer")


@pytest.mark.parametrize("num_processes", [1, 4])
def test_batch_decoder_matches_stt_tpu(packages, num_processes):
    ours, theirs = alphabets()
    path = packages["alphabet"]
    batch = [spelled_probs(sentence(i), ours, 10 + i, 29) for i in range(6)]
    width = max(len(p) for p in batch)
    padded = np.stack([np.pad(p, ((0, width - len(p)), (0, 0))) for p in batch])
    lengths = [len(p) for p in batch]
    got = ctc_beam_search_decoder_batch(padded, lengths, ours, 32, num_processes,
                                        scorer=KenLMScorer(path), hot_words=HOT_WORDS,
                                        num_results=2)
    want = jax_decoder_batch(padded, lengths, theirs, 32, num_processes,
                             scorer=JaxKenLMScorer(path), hot_words=HOT_WORDS, num_results=2)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert_same(outputs(g), outputs(w), "batch")


def test_validate_scorer(packages):
    assert native.validate_scorer(packages["alphabet"]) and native.validate_scorer(packages["bytes"])
    assert not native.validate_scorer("/dev/null")
    assert jax_native.validate_scorer(packages["alphabet"]) and not jax_native.validate_scorer("/dev/null")
    with pytest.raises(ValueError, match="load failed"):
        NativeDecoderState(alphabets()[0], 8, scorer_path="/dev/null")


def test_auto_raises_with_the_compilers_message(tmp_path, monkeypatch):
    """No fallback: a source that does not compile makes 'auto' raise, with
    g++'s message, where stt_tpu would quietly take the Python decoder."""
    with open(native.SOURCE) as f:
        source = f.read()
    broken = tmp_path / "ctc_decoder.cpp"
    broken.write_text(source.replace("namespace {", "namespace { this_is_not_cpp;", 1))
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "build" / "libstt_decoder.so")
    alphabet = alphabets()[0]
    with pytest.raises(RuntimeError, match="this_is_not_cpp") as raised:
        make_decoder_state(alphabet, 8)
    assert "g++ failed" in str(raised.value)
    assert not native.native_available()
    assert "this_is_not_cpp" in native.native_build_error()
    assert not (tmp_path / "build" / "libstt_decoder.so").exists()
    assert type(make_decoder_state(alphabet, 8, implementation="python")) is DecoderState
    monkeypatch.undo()
    assert native.native_available() and native.native_build_error() is None


def test_concurrent_first_builds_load_a_whole_library(tmp_path):
    """Two processes that build the library into the same empty place at
    once both load a whole one and decode, and leave the library and its
    build stamp and no temporary file."""
    shutil.copy(native.SOURCE, tmp_path / "ctc_decoder.cpp")
    code = textwrap.dedent(f"""
        from pathlib import Path
        import numpy as np
        from stt_tpu_torch.alphabet import Alphabet
        from stt_tpu_torch.decode import native
        native.SOURCE = Path({str(tmp_path / 'ctc_decoder.cpp')!r})
        native.LIBRARY = Path({str(tmp_path / 'build' / 'libstt_decoder.so')!r})
        state = native.NativeDecoderState(Alphabet().init_from_labels(list(" ab")), 4)
        state.next(np.full((5, 4), 0.25))
        print(len(state.decode(1)))
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env={**os.environ, "PYTHONPATH": ROOT}) for _ in range(2)]
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        assert out.strip() == "1"
    assert sorted(os.listdir(tmp_path / "build")) == ["libstt_decoder.so",
                                                      "libstt_decoder.so.cmd"]


def test_shared_scorer_under_many_threads(packages, tmp_path):
    """More threads than cores attach one scorer package at once: it is
    parsed once (one cached handle for its path), and every decode gives
    the one-thread result."""
    from concurrent.futures import ThreadPoolExecutor

    path = str(tmp_path / "copy.scorer")
    shutil.copy(packages["alphabet"], path)
    ours = alphabets()[0]
    probs = spelled_probs(sentence(9), ours, 9, 29)

    def one(_):
        state = NativeDecoderState(ours, 16, scorer_path=path, hot_words=HOT_WORDS)
        state.next(probs)
        return outputs(state.decode(2))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=4 * (os.cpu_count() or 1)) as pool:
            futures = [pool.submit(one, i) for i in range(64)]
            got = [f.result(timeout=120) for f in futures]
    finally:
        sys.setswitchinterval(interval)
    assert list(native._scorer_cache).count(path) == 1
    want = one(0)
    assert all(g == want for g in got)


def test_malformed_inputs_raise_before_the_native_call():
    state = NativeDecoderState(alphabets()[0], 8)
    with pytest.raises(ValueError, match="blank column"):
        state.next(np.full((4, 28), 1 / 28))  # no blank column
    with pytest.raises(ValueError, match="blank column"):
        state.next(np.full(29, 1 / 29))
    idx, logp, count, blank = prune_emissions_host(random_probs(0, t=5).astype(np.float32), 4, 0.9)
    with pytest.raises(ValueError, match=r"\[T, K\]"):
        state.next_pruned(idx, logp[:, :2], count, blank)
    with pytest.raises(ValueError, match=r"\[T, K\]"):
        state.next_pruned(idx, logp, count[:3], blank)
    with pytest.raises(ValueError, match="counts"):
        state.next_pruned(idx, logp, count + 5, blank)
    state.next_pruned(idx, logp, count, blank)
    assert state.decode(1)
