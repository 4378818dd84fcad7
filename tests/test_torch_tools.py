"""The port's remote I/O (stt_tpu_torch.io), downloader, LM tools and data
tools against stt_tpu's on the CPU, on inputs made here:

- io: local, mem:// (round trip, copy, glob, remove) and the WebHDFS
  handler under monkeypatch (stt_tpu's fake namenode) give stt_tpu.io's
  answers; `maybe_download` of an archive that exists downloads nothing;
- generate_lm (ARPA and trie bytes, from a corpus and from an ARPA),
  enumerate_kenlm_vocabulary and trie_load give stt_tpu's output;
- check_characters, data_set_tool (CSV -> SDB -> CSV, bytes equal; the
  CSV up to the port's relative WAV paths),
  compare_samples and stats give stt_tpu's output, and play's augmented
  WAVs are bit-equal at one seed (both packages in one process: the
  sample augmentations seed by Python's string hash);
- every copied module holds stt_tpu's code apart from docstrings and the
  package its imports name.
"""

import os

import numpy as np
import pytest

import stt_tpu.io as jax_io
from stt_tpu.tools import check_characters as jax_check_characters
from stt_tpu.tools import compare_samples as jax_compare_samples
from stt_tpu.tools import data_set_tool as jax_data_set_tool
from stt_tpu.tools import downloader as jax_downloader
from stt_tpu.tools import enumerate_kenlm_vocabulary as jax_enumerate
from stt_tpu.tools import generate_lm as jax_generate_lm
from stt_tpu.tools import play as jax_play
from stt_tpu.tools import stats as jax_stats
from stt_tpu.tools import trie_load as jax_trie_load
import stt_tpu_torch.io as port_io
from stt_tpu_torch.data.audio import write_wav
from stt_tpu_torch.data.sources import CSVWriter, Sample
from stt_tpu_torch.tools import (
    check_characters,
    compare_samples,
    data_set_tool,
    downloader,
    enumerate_kenlm_vocabulary,
    generate_lm,
    play,
    stats,
    trie_load,
)
from test_io_tools import _FakeWebHDFS
from test_torch_scorer import ROOT, build_package, code_of, corpus, write_inputs

PAIRS = {  # the port's module, stt_tpu's
    "check_characters": (check_characters, jax_check_characters),
    "compare_samples": (compare_samples, jax_compare_samples),
    "data_set_tool": (data_set_tool, jax_data_set_tool),
    "enumerate_kenlm_vocabulary": (enumerate_kenlm_vocabulary, jax_enumerate),
    "generate_lm": (generate_lm, jax_generate_lm),
    "play": (play, jax_play),
    "stats": (stats, jax_stats),
    "trie_load": (trie_load, jax_trie_load),
}
COPIES = ["io.py", "compat/tflite.py", "compat/tf_checkpoint.py", "compat/tflite_export.py",
          "tools/downloader.py", *[f"tools/{name}.py" for name in PAIRS]]
WORDS = ["she", "had", "your", "dark", "suit", "in", "greasy", "wash", "water", "Ünïcode"]


@pytest.mark.parametrize("module", COPIES)
def test_copied_module_holds_the_same_code(module, tmp_path):
    with open(os.path.join(ROOT, "stt_tpu", module)) as f:
        source = f.read()
    if module == "io.py":  # one error message names the port's module
        source = source.replace("stt_tpu.io.register_scheme", "stt_tpu_torch.io.register_scheme")
    theirs = tmp_path / "theirs.py"
    theirs.write_text(source)
    assert code_of(os.path.join(ROOT, "stt_tpu_torch", module), "stt_tpu_torch") == \
        code_of(str(theirs), "stt_tpu")


# ---- io ---------------------------------------------------------------------


def exercise_io(io, root: str, hdfs=None) -> list:
    """One script of calls through `io` (a package's module) on local,
    mem:// and, with a fake namenode, hdfs:// paths; returns what each
    answered."""
    out = []
    io.register_scheme("mem", io.MemoryHandler())
    out.append([io.is_remote_path(p) for p in ("gs://b/k", "hdfs://nn/p", "/l/p", "rel.csv",
                                                "file:///l/p", "mem://b/x")])
    local = os.path.join(root, "x.txt")
    with io.open_remote(local, "w") as f:
        f.write("hello")
    out.append([io.path_exists_remote(local), io.isdir_remote(root),
                sorted(io.listdir_remote(root)), io.glob_remote(os.path.join(root, "*.txt"))])
    with io.open_remote("mem://b/dir/a.txt", "w") as f:
        f.write("alpha")
    with io.open_remote("mem://b/dir/b.bin", "wb") as f:
        f.write(b"\x00\x01")
    with io.open_remote("mem://b/dir/a.txt") as f, io.open_remote("mem://b/dir/b.bin", "rb") as g:
        out.append([f.read(), g.read(), io.listdir_remote("mem://b/dir"),
                    io.glob_remote("mem://b/dir/*.txt"), io.isdir_remote("mem://b/dir")])
    io.copy_remote(local, "mem://b/in.txt")
    try:
        io.copy_remote(local, "mem://b/in.txt")
    except FileExistsError as e:
        out.append(type(e).__name__)
    io.copy_remote(local, "mem://b/in.txt", overwrite=True)
    back = os.path.join(root, "back.txt")
    io.copy_remote("mem://b/in.txt", back)
    with open(back) as f:
        out.append(f.read())
    io.remove_remote("mem://b/dir/b.bin")
    io.remove_remote(local)
    out.append([io.path_exists_remote("mem://b/dir/b.bin"), io.path_exists_remote(local)])
    io.rmtree_remote("mem://b/dir")
    out.append(io.isdir_remote("mem://b/dir"))
    try:
        io.open_remote("s4://bucket/key")
    except ValueError as e:
        out.append(str(e).split(";")[0])
    if hdfs is not None:
        base = "hdfs://nn:8020/data"
        with io.open_remote(f"{base}/x.csv", "w") as f:
            f.write("a,b\n1,2\n")
        with io.open_remote(f"{base}/y.bin", "wb") as f:
            f.write(b"\x00\x01")
        with io.open_remote(f"{base}/x.csv") as f:
            out.append([f.read(), io.path_exists_remote(f"{base}/x.csv"),
                        io.path_exists_remote(f"{base}/missing"), io.isdir_remote(base),
                        io.isdir_remote(f"{base}/x.csv"), io.listdir_remote(base),
                        io.glob_remote(f"{base}/*.csv")])
        io.remove_remote(f"{base}/y.bin")
        out.append(io.path_exists_remote(f"{base}/y.bin"))
        io.rmtree_remote(base)
        out.append([io.isdir_remote(base), dict(hdfs.files)])
    return out


@pytest.mark.parametrize("redirect_mode", ["json", "307"])
def test_io_answers_as_stt_tpu_io(tmp_path, monkeypatch, redirect_mode):
    answers = []
    for name, io in (("port", port_io), ("jax", jax_io)):
        root = tmp_path / name
        root.mkdir()
        fake = _FakeWebHDFS(redirect_mode)
        handler = io.HDFSHandler()
        monkeypatch.setattr(handler, "_request", fake)
        io.register_scheme("hdfs", handler)
        answers.append([str(a).replace(str(root), "ROOT") for a in exercise_io(io, str(root), fake)])
    assert answers[0] == answers[1]
    assert "['a,b\\n1,2\\n', True, False, True, False, ['x.csv', 'y.bin']" in answers[0][-3]


def test_maybe_download_existing_is_noop(tmp_path, capsys):
    archive = tmp_path / "corpus.tgz"
    archive.write_bytes(b"cached")
    outputs = []
    for module in (downloader, jax_downloader):
        out = module.maybe_download("corpus.tgz", str(tmp_path), "http://example.invalid/x")
        assert out == str(archive) and archive.read_bytes() == b"cached"
        outputs.append(capsys.readouterr().out)
    assert outputs[0] == outputs[1] and "not downloading" in outputs[0]


# ---- LM tools -----------------------------------------------------------------


def tree_bytes(root) -> dict:
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("flags", [[], ["--discount", "0.7"], ["--arpa_prune", "0|1"]],
                         ids=["lmplz", "fixed_discount", "pruned"])
def test_generate_lm_writes_stt_tpus_files(tmp_path, capsys, flags):
    text = tmp_path / "corpus.txt"
    text.write_text("".join(" ".join(s) + "\n" for s in corpus(200, seed=5)))
    trees = []
    for name, module in (("port", generate_lm), ("jax", jax_generate_lm)):
        module.main(["--input_txt", str(text), "--output_dir", str(tmp_path / name), "--top_k",
                     "40", "--arpa_order", "3", "--discount_fallback", *flags])
        trees.append(tree_bytes(tmp_path / name))
        # and from the ARPA it wrote
        module.main(["--input_arpa", str(tmp_path / name / "lm.arpa"), "--output_dir",
                     str(tmp_path / f"{name}_from_arpa")])
        trees.append(tree_bytes(tmp_path / f"{name}_from_arpa"))
        capsys.readouterr()
    assert trees[0] == trees[2] and trees[1] == trees[3]
    assert sorted(trees[0]) == ["lm.arpa", "lm.binary", "lower.txt", "vocab-40.txt"]
    assert sorted(trees[1]) == ["lm.binary", "vocab.txt"]


def test_enumerate_kenlm_vocabulary_equals_stt_tpus(tmp_path, capsys):
    from stt_tpu_torch.lm.arpa import estimate_kneser_ney
    from stt_tpu_torch.lm.trie_writer import write_trie_binary

    model = estimate_kneser_ney(corpus(100, seed=6), order=3)
    path = tmp_path / "vocab.klm"
    path.write_bytes(write_trie_binary(model, include_vocab=True))
    outputs = []
    for name, module in (("port", enumerate_kenlm_vocabulary), ("jax", jax_enumerate)):
        out = tmp_path / f"{name}.txt"
        assert module.main([str(path), str(out)]) == 0
        outputs.append((out.read_text(), capsys.readouterr().out.replace(name, "")))
    assert outputs[0] == outputs[1] and outputs[0][0].startswith("<unk>\n")
    stripped = tmp_path / "stripped.klm"
    stripped.write_bytes(write_trie_binary(model))
    messages = []
    for module in (enumerate_kenlm_vocabulary, jax_enumerate):
        with pytest.raises(ValueError, match="without vocabulary strings") as raised:
            module.main([str(stripped), str(tmp_path / "x.txt")])
        messages.append(str(raised.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("command", [[], ["arcs"], ["dump-vocab"]], ids=["load", "arcs", "vocab"])
def test_trie_load_prints_stt_tpus_output(tmp_path, capsys, command):
    package = build_package(tmp_path, "lm.scorer")
    alphabet = write_inputs(tmp_path)["alphabet"]
    capsys.readouterr()
    outputs = []
    for module in (trie_load, jax_trie_load):
        assert module.main([package, alphabet, *command]) == 0
        captured = capsys.readouterr()
        outputs.append((captured.out, captured.err))
    assert outputs[0] == outputs[1]
    if command == ["dump-vocab"]:
        assert {"water", "dark", "suit"} <= set(outputs[0][0].split())
    garbage = tmp_path / "garbage.scorer"
    garbage.write_bytes(b"x" * 100)
    for module in (trie_load, jax_trie_load):
        assert module.main([str(garbage), alphabet]) == 1
    captured = capsys.readouterr()
    assert captured.err.count("scorer load failed") == 2


# ---- data tools ---------------------------------------------------------------


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A CSV of six seeded WAVs (16 kHz) whose transcripts use a non-ASCII
    word, and a second CSV of two 8 kHz WAVs."""
    root = tmp_path_factory.mktemp("data_tools")
    rs = np.random.RandomState(8)
    paths = {}
    for name, n, rate in (("a", 6, 16000), ("b", 2, 8000)):
        paths[name] = str(root / f"{name}.csv")
        with CSVWriter(paths[name]) as writer:
            for i in range(n):
                t = np.arange(int(rs.uniform(0.4, 1.2) * rate)) / rate
                audio = (0.3 * np.sin(2 * np.pi * rs.uniform(100, 800) * t)
                         + 0.02 * rs.randn(len(t))).astype(np.float32)
                text = " ".join(rs.choice(WORDS, rs.randint(1, 5)))
                writer.add(Sample(f"s{i}", text, _audio=audio, _rate=rate))
    paths["root"] = root
    return paths


@pytest.mark.parametrize("flags", [[], ["-alpha"], ["-unicode"]], ids=["list", "alpha", "unicode"])
def test_check_characters_prints_stt_tpus_output(dataset, capsys, flags):
    outputs = []
    for module in (check_characters, jax_check_characters):
        chars = module.main(["-csv", f"{dataset['a']},{dataset['b']}", *flags])
        captured = capsys.readouterr()
        outputs.append((chars, captured.out, captured.err))
    assert outputs[0] == outputs[1]
    assert "Ü" in outputs[0][0] and " " in outputs[0][0]


def test_stats_prints_stt_tpus_output(dataset, capsys):
    outputs = []
    for module in (stats, jax_stats):
        result = module.main(["-csv", f"{dataset['a']},{dataset['b']}"])
        outputs.append((result.n_samples, result.total_bytes, result.total_seconds,
                        capsys.readouterr().out))
    assert outputs[0] == outputs[1] and outputs[0][0] == 8


@pytest.mark.parametrize("augment", [[], ["volume[dbfs=-6]", "reverb[delay=10,decay=10]"]],
                         ids=["plain", "augmented"])
def test_data_set_tool_round_trip_is_stt_tpus(dataset, tmp_path, augment):
    """CSV -> SDB -> CSV through each package's tool: the SDBs byte-equal,
    the CSVs and every WAV they name byte-equal."""
    trees = []
    for name, module in (("port", data_set_tool), ("jax", jax_data_set_tool)):
        out = tmp_path / name
        out.mkdir()
        sdb = str(out / "mid.sdb")
        args = ["--sources", f"{dataset['a']},{dataset['b']}", "--target", sdb]
        for spec in augment:
            args += ["--augment", spec]
        module.main(args)
        module.main(["--sources", sdb, "--target", str(out / "back.csv")])
        trees.append(tree_bytes(out))
    # the port's CSVWriter names each WAV relative to the CSV's directory,
    # stt_tpu's by its absolute path: the same files either way
    trees[1]["back.csv"] = trees[1]["back.csv"].replace(f"{tmp_path / 'jax'}/".encode(), b"")
    assert trees[0] == trees[1]
    assert len([k for k in trees[0] if k.endswith(".wav")]) == 8


def test_compare_samples_decides_as_stt_tpu(dataset, tmp_path, capsys):
    root = tmp_path
    rs = np.random.RandomState(9)
    base = (0.3 * rs.randn(16000)).astype(np.float32)
    for name, audio in (("a", base), ("near", base + 1e-5 * rs.randn(16000).astype(np.float32)),
                        ("far", base + 0.1 * rs.randn(16000).astype(np.float32)),
                        ("short", base[:8000])):
        write_wav(str(root / f"{name}.wav"), audio, 16000)
    for other in ("a", "near", "far", "short"):
        for flags in ([], ["--if-differ"], ["--threshold", "-20"]):
            outcomes = []
            for module in (compare_samples, jax_compare_samples):
                with pytest.raises(SystemExit) as done:
                    module.main([str(root / "a.wav"), str(root / f"{other}.wav"), *flags])
                outcomes.append((done.value.code, capsys.readouterr().out))
            assert outcomes[0] == outcomes[1], (other, flags)
    assert compare_samples.audio_diff_dbfs(base, base + 0.01) == pytest.approx(-40.0, abs=1e-3)


def test_play_writes_stt_tpus_wavs(dataset, tmp_path, capsys):
    specs = ["volume[p=1,dbfs=-20:-3]", "tempo[p=1,factor=0.9:1.1]",
             "pitch[p=1,pitch=0.9:1.1]", "add[p=1,stddev=0.1]"]
    trees = []
    for name, module in (("port", play), ("jax", jax_play)):
        args = ["--source", dataset["a"], "--start", "1", "--number", "4", "--pipe",
                str(tmp_path / name)]
        for spec in specs:
            args += ["--augment", spec]
        written = module.main(args)
        assert [os.path.basename(p) for p in written] == [f"augmented_{i:06d}.wav"
                                                         for i in range(1, 5)]
        trees.append(tree_bytes(tmp_path / name))
    assert trees[0] == trees[1] and len(trees[0]) == 4
    out = capsys.readouterr().out.replace(str(tmp_path / "jax"), "X")
    out = out.replace(str(tmp_path / "port"), "X").splitlines()
    assert out[:4] == out[4:]
