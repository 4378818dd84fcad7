"""The port's language-model tools and scorer package against stt_tpu's,
on fixtures built here (an alphabet of space, a-z and ', and a seeded
corpus of a few hundred sentences):

- ARPA text (`estimate_kneser_ney`, `estimate_kneser_ney_lmplz`,
  `write_arpa`), KenLM trie binaries (`write_trie_binary`) and .scorer
  packages (`create_package`, in alphabet and in bytes output mode, and
  its command line) are byte-equal;
- the readers give the same answers: `KenLMModel` (counts, vocabulary
  ids, scores), `KenLMScorer.get_log_cond_prob` on a grid of n-grams with
  and without BOS and with OOV words, `FstDictionary.words` and its walk,
  `DictionaryTrie` and `StaticScorer`;
- the copied modules hold the same code as stt_tpu's, apart from their
  docstrings and the package their imports name (so the reader's branches
  that no writer here reaches, quantized and Bhiksha tries, are stt_tpu's).

Scores are compared exactly: both sides run the same float arithmetic.
The corpus and the functions that build packages are shared with the
other port tests that need a scorer.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

from stt_tpu.alphabet import Alphabet as JaxAlphabet
from stt_tpu.alphabet import UTF8Alphabet as JaxUTF8Alphabet
from stt_tpu.decode.scorer import StaticScorer as JaxStaticScorer
from stt_tpu.decode.scorer_package import KenLMScorer as JaxKenLMScorer
from stt_tpu.decode.trie import DictionaryTrie as JaxDictionaryTrie
from stt_tpu.lm import arpa as jax_arpa
from stt_tpu.lm.kenlm import KenLMModel as JaxKenLMModel
from stt_tpu.lm.murmur import murmur_hash64a as jax_murmur
from stt_tpu.lm.trie_writer import write_trie_binary as jax_write_trie_binary
from stt_tpu.tools.generate_scorer_package import create_package as jax_create_package
from stt_tpu_torch.alphabet import Alphabet, UTF8Alphabet
from stt_tpu_torch.decode.scorer import OOV_SCORE, StaticScorer
from stt_tpu_torch.decode.scorer_package import FILE_VERSION, MAGIC, KenLMScorer, ScorerLoadError
from stt_tpu_torch.decode.trie import DictionaryTrie
from stt_tpu_torch.lm import arpa
from stt_tpu_torch.lm.kenlm import KenLMModel
from stt_tpu_torch.lm.murmur import murmur_hash64a
from stt_tpu_torch.lm.trie_writer import write_trie_binary
from stt_tpu_torch.tools.generate_scorer_package import create_package

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABELS = list(" abcdefghijklmnopqrstuvwxyz'")
WORDS = (
    "the of and to in is was he for it with as his on be at by had are but from or "
    "she have an they which one you were her all their there been if more when will "
    "would who so no out up into do any could my than first water been call who oil "
    "now find long down day did get come made may part over new sound take only little "
    "work know place years live me back give most very after things our just name good "
    "dark suit greasy wash year don't can't it's"
).split()
ALPHA, BETA = 0.93, 1.18


def corpus(n: int = 400, seed: int = 0) -> list:
    """Seeded sentences of 3-10 words, drawn with Zipf-like weights."""
    rs = np.random.RandomState(seed)
    weights = 1.0 / np.arange(1, len(WORDS) + 1)
    weights /= weights.sum()
    return [list(rs.choice(WORDS, size=rs.randint(3, 11), p=weights)) for _ in range(n)]


def write_inputs(root, bytes_mode: bool = False) -> dict:
    """The alphabet file, the corpus and its vocabulary, under `root`. In
    bytes mode the language model is one of characters, as for a language
    written without spaces: a sentence is its words' letters run together."""
    tag = "_bytes" if bytes_mode else ""
    paths = {k: os.path.join(str(root), f"{k}{tag}.txt") for k in ("alphabet", "corpus", "vocab")}
    with open(paths["alphabet"], "w") as f:
        f.write("# space, a-z and '\n" + "".join(f"{c}\n" for c in LABELS))
    sentences = corpus()
    if bytes_mode:
        sentences = [list("".join(s)) for s in sentences]
    with open(paths["corpus"], "w") as f:
        f.write("".join(" ".join(s) + "\n" for s in sentences))
    with open(paths["vocab"], "w") as f:
        f.write("\n".join(sorted({w for s in sentences for w in s})) + "\n")
    return paths


def build_package(root, package: str, port: bool = True, bytes_mode: bool = False,
                  order: int = 3) -> str:
    """corpus -> estimate_kneser_ney -> write_arpa -> create_package, by
    the port's tools (port=True) or stt_tpu's; returns the package path."""
    paths = write_inputs(root, bytes_mode)
    tools = (arpa, create_package) if port else (jax_arpa, jax_create_package)
    with open(paths["corpus"]) as f:
        sentences = [line.split() for line in f]
    arpa_path = os.path.join(str(root), package + ".arpa")
    tools[0].write_arpa(tools[0].estimate_kneser_ney(sentences, order=order), arpa_path)
    out = os.path.join(str(root), package)
    tools[1](None if bytes_mode else paths["alphabet"], arpa_path, paths["vocab"], out,
             ALPHA, BETA, force_bytes_output_mode=True if bytes_mode else None)
    return out


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The same packages built by each package's tools, in both modes."""
    root = tmp_path_factory.mktemp("scorer")
    out = {}
    for port in (True, False):
        for bytes_mode in (False, True):
            name = f"{'port' if port else 'jax'}{'_bytes' if bytes_mode else ''}.scorer"
            out[port, bytes_mode] = build_package(root, name, port, bytes_mode)
    out["inputs"] = write_inputs(root)
    out["inputs_bytes"] = write_inputs(root, bytes_mode=True)
    return out


def read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("order", [2, 3, 4])
def test_arpa_text_is_byte_equal(tmp_path, order):
    sentences = corpus(300, seed=order)
    arpa.write_arpa(arpa.estimate_kneser_ney(sentences, order=order), str(tmp_path / "port.arpa"))
    jax_arpa.write_arpa(jax_arpa.estimate_kneser_ney(sentences, order=order),
                        str(tmp_path / "jax.arpa"))
    text = read(tmp_path / "port.arpa")
    assert text == read(tmp_path / "jax.arpa") and text.count(b"-grams:") == order
    # read_arpa gives back the same model in both packages
    got, want = arpa.read_arpa(str(tmp_path / "port.arpa")), jax_arpa.read_arpa(str(tmp_path / "jax.arpa"))
    assert got.order == want.order and got.ngrams == want.ngrams


def test_lmplz_estimator_is_equal(tmp_path):
    # a long Zipf tail, so every order has n-grams seen once to four times
    rs = np.random.RandomState(5)
    weights = 1.0 / np.arange(1, 401)
    sentences = [[f"w{k}" for k in rs.choice(400, size=rs.randint(3, 11), p=weights / weights.sum())]
                 for _ in range(500)]
    got = arpa.estimate_kneser_ney_lmplz(sentences, order=3)
    want = jax_arpa.estimate_kneser_ney_lmplz(sentences, order=3)
    assert got.ngrams == want.ngrams
    with pytest.raises(arpa.DiscountEstimationError):
        arpa.estimate_kneser_ney_lmplz([["a", "b"]], order=3)
    with pytest.raises(jax_arpa.DiscountEstimationError):
        jax_arpa.estimate_kneser_ney_lmplz([["a", "b"]], order=3)


@pytest.mark.parametrize("include_vocab", [False, True])
def test_trie_binary_is_byte_equal(include_vocab):
    sentences = corpus(200, seed=2)
    got = write_trie_binary(arpa.estimate_kneser_ney(sentences), include_vocab=include_vocab)
    want = jax_write_trie_binary(jax_arpa.estimate_kneser_ney(sentences),
                                 include_vocab=include_vocab)
    assert got == want
    model, ref = KenLMModel(got), JaxKenLMModel(want)
    assert (model.order, model.counts, model.end_of_search_offset, model.end_of_lm_offset) == (
        ref.order, ref.counts, ref.end_of_search_offset, ref.end_of_lm_offset)
    if include_vocab:
        assert model.vocab_strings() == ref.vocab_strings()


@pytest.mark.parametrize("bytes_mode", [False, True], ids=["alphabet", "bytes"])
def test_scorer_package_is_byte_equal(built, bytes_mode):
    data = read(built[True, bytes_mode])
    assert data == read(built[False, bytes_mode])
    scorer = KenLMScorer(built[True, bytes_mode])
    off = scorer.lm.end_of_lm_offset
    assert data[off:off + 4] == MAGIC and FILE_VERSION == 6
    assert scorer.is_utf8_mode() == bytes_mode and scorer.get_max_order() == 3
    assert (scorer.alpha, scorer.beta) == (ALPHA, BETA)


def test_generate_scorer_package_command_line(built, tmp_path):
    inputs = built["inputs"]
    with open(inputs["corpus"]) as f:
        sentences = [line.split() for line in f]
    arpa_path = str(tmp_path / "lm.arpa")
    arpa.write_arpa(arpa.estimate_kneser_ney(sentences), arpa_path)
    out = str(tmp_path / "cli.scorer")
    proc = subprocess.run(
        [sys.executable, "-m", "stt_tpu_torch.tools.generate_scorer_package",
         "--alphabet", inputs["alphabet"], "--lm", arpa_path, "--vocab", inputs["vocab"],
         "--package", out, "--default_alpha", str(ALPHA), "--default_beta", str(BETA)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert proc.returncode == 0, proc.stderr
    assert "alphabet output mode" in proc.stdout
    assert read(out) == read(built[False, False])


def test_package_from_a_kenlm_binary_is_equal(built, tmp_path):
    """create_package takes a KenLM binary too (validated and trimmed)."""
    inputs = built["inputs"]
    with open(inputs["corpus"]) as f:
        sentences = [line.split() for line in f]
    binary = str(tmp_path / "lm.binary")
    with open(binary, "wb") as f:
        f.write(write_trie_binary(arpa.estimate_kneser_ney(sentences), include_vocab=True))
    create_package(inputs["alphabet"], binary, inputs["vocab"], str(tmp_path / "a.scorer"), 0.5, 1.0)
    jax_create_package(inputs["alphabet"], binary, inputs["vocab"], str(tmp_path / "b.scorer"),
                       0.5, 1.0)
    assert read(tmp_path / "a.scorer") == read(tmp_path / "b.scorer")


def ngram_grid(bytes_mode: bool) -> list:
    """Unigrams to trigrams of seen words (letters in bytes mode), unseen
    orders of them, and OOV words at every position."""
    seen = list("thewaro'") if bytes_mode else WORDS[:6] + ["water", "don't"]
    oov = "\u00e9" if bytes_mode else "zyzzyva"
    grid = [[w] for w in seen] + [[oov], ["<s>"], ["</s>"]]
    for a, b in zip(seen, seen[1:] + seen[:1]):
        grid += [[a, b], [b, a], [a, oov], [oov, b]]
    for a, b, c in zip(seen, seen[2:], seen[5:]):
        grid += [[a, b, c], [c, b, a], [a, oov, c]]
    return grid


@pytest.mark.parametrize("bytes_mode", [False, True], ids=["alphabet", "bytes"])
def test_log_cond_prob_is_equal(built, bytes_mode):
    path = built[True, bytes_mode]
    ours, theirs = KenLMScorer(path), JaxKenLMScorer(path)
    from_buffer = KenLMScorer(data=read(path))
    assert from_buffer.path is None and ours.path == path
    oov = 0
    grid = ngram_grid(bytes_mode)
    for ngram in grid:
        for bos in (False, True):
            want = theirs.get_log_cond_prob(ngram, bos)
            assert ours.get_log_cond_prob(ngram, bos) == want, (ngram, bos)
            assert from_buffer.get_log_cond_prob(ngram, bos) == want
            oov += want == OOV_SCORE
    assert 0 < oov < len(grid)
    for word in WORDS + list("abc'") + ["zyzzyva", "<s>", "</s>", "<unk>"]:
        assert ours.lm.vocab_index(word) == theirs.lm.vocab_index(word)
        assert murmur_hash64a(word.encode()) == jax_murmur(word.encode())
    assert (ours.lm.bos_id, ours.lm.eos_id, ours.lm.unk_id) == (
        theirs.lm.bos_id, theirs.lm.eos_id, theirs.lm.unk_id)


def walk(dictionary, labels):
    """The walk's state after each label: an int state, 'start' when a
    completed word restarted it, or None once the dictionary refused."""
    out, state = [], dictionary.start
    for label in labels:
        state = dictionary.step(state, label)
        if state is None:
            out.append(None)
            break
        out.append("start" if state == dictionary.start else "inner")
    return out


@pytest.mark.parametrize("bytes_mode", [False, True], ids=["alphabet", "bytes"])
def test_fst_dictionary_and_trie_walks_are_equal(built, bytes_mode):
    path = built[True, bytes_mode]
    ours, theirs = KenLMScorer(path).dictionary, JaxKenLMScorer(path).dictionary
    if bytes_mode:
        alphabet, jax_alphabet = UTF8Alphabet(), JaxUTF8Alphabet()
    else:
        alphabet = Alphabet(built["inputs"]["alphabet"])
        jax_alphabet = JaxAlphabet(built["inputs"]["alphabet"])
    words = ours.words(alphabet)
    assert words == theirs.words(jax_alphabet)
    with open(built["inputs_bytes" if bytes_mode else "inputs"]["vocab"]) as f:
        assert sorted(words) == sorted(f.read().split())
    assert (ours.num_states, ours.num_arcs) == (theirs.num_states, theirs.num_arcs)
    trie = DictionaryTrie.from_words(words, alphabet, bytes_mode)
    jax_trie = JaxDictionaryTrie.from_words(words, jax_alphabet, bytes_mode)
    assert len(trie) == len(jax_trie) == len(words)
    end = [] if bytes_mode else [alphabet.space_index]
    probes = words + ["zyzzyva", "wate", "waterx", "the the"] + ["\u00e9t\u00e9"] * bytes_mode
    for word in probes:
        labels = alphabet.encode(word) + end
        want = walk(theirs, labels)
        assert walk(ours, labels) == want, word
        assert walk(trie, labels) == walk(jax_trie, labels) == want, word


def test_static_scorer_is_equal():
    alphabet, jax_alphabet = Alphabet().init_from_labels(LABELS), JaxAlphabet().init_from_labels(LABELS)
    table = {("the",): -1.0, ("water",): -2.5, ("the", "water"): -0.5, ("dark", "suit"): -0.7}
    vocab = ["the", "water", "dark", "suit"]
    ours = StaticScorer(table, 2, 0.8, 0.3, vocab, alphabet)
    theirs = JaxStaticScorer(table, 2, 0.8, 0.3, vocab, jax_alphabet)
    for ngram in (["the"], ["the", "water"], ["suit"], ["dark", "suit"], ["oil"], ["the", "oil"]):
        for bos in (False, True):
            assert ours.get_log_cond_prob(ngram, bos) == theirs.get_log_cond_prob(ngram, bos)
    assert (ours.get_max_order(), ours.alpha, ours.beta) == (2, 0.8, 0.3)
    for word in vocab + ["oil"]:
        labels = alphabet.encode(word) + [alphabet.space_index]
        assert walk(ours.dictionary, labels) == walk(theirs.dictionary, labels)


def test_invalid_packages_raise_alike(built, tmp_path):
    good = read(built[True, False])
    off = KenLMScorer(built[True, False]).lm.end_of_lm_offset
    no_trailer = good[:off] + b"XXXX" + good[off + 4:]
    old = good[:off + 4] + (5).to_bytes(4, "little") + good[off + 8:]
    for data, error in ((no_trailer, "TRIE trailer"), (old, "version 5")):
        with pytest.raises(ScorerLoadError, match=error):
            KenLMScorer(data=data)
        with pytest.raises(ValueError, match=error):
            JaxKenLMScorer(data=data)
    for data in (b"", b"not a kenlm file at all" * 4):
        with pytest.raises(ValueError):
            KenLMScorer(data=data)
        with pytest.raises(ValueError):
            JaxKenLMScorer(data=data)
    with pytest.raises(ValueError, match="need scorer_path or data"):
        KenLMScorer()


COPIES = [
    "lm/murmur.py", "lm/kenlm.py", "lm/arpa.py", "lm/trie_writer.py", "decode/fst_dict.py",
    "decode/fst_writer.py", "decode/trie.py", "decode/scorer_package.py",
    "tools/generate_scorer_package.py",
]


def code_of(path: str, package: str) -> str:
    """The module's AST without docstrings, with `package` renamed."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith(package + "."):
            node.module = "PKG" + node.module[len(package):]
    return ast.dump(tree)


@pytest.mark.parametrize("module", COPIES)
def test_copied_module_holds_the_same_code(module):
    ours = code_of(os.path.join(ROOT, "stt_tpu_torch", module), "stt_tpu_torch")
    theirs = code_of(os.path.join(ROOT, "stt_tpu", module), "stt_tpu")
    if module == "lm/kenlm.py":  # one error message names the port's tool
        ours = ours.replace("with build_binary first, or packaged from the ARPA with "
                            "stt_tpu_torch.tools.generate_scorer_package)",
                            "with build_binary / stt_tpu.tools.build_lm first)")
    assert ours == theirs
