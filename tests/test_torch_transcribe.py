"""The port's transcription slice against stt_tpu's on the CPU, at a tiny
width, on one artifact written by stt_tpu:

- `data.vad` splits equal to stt_tpu's (segment audio and times), with
  both classifiers and the aggressiveness scale's ends;
- `transcribe_file` gives stt_tpu's segments (start, end, transcript) on
  the same artifact and WAV: float, int8 (quantized_inference=True) and
  with a scorer;
- `evaluate_export` gives stt_tpu's report and results;
- `resolve_sources`, the command lines with --device cpu, and the refusal
  of several processes (M13).
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from stt_tpu.alphabet import Alphabet as JaxAlphabet
from stt_tpu.artifact import build_metadata, save_artifact
from stt_tpu.data import vad as jax_vad
from stt_tpu.decode.scorer_package import KenLMScorer as JaxKenLMScorer
from stt_tpu.evaluate_export import evaluate_export as jax_evaluate_export
from stt_tpu.frontend import FeatureConfig as JaxFeatureConfig
from stt_tpu.models import ModelConfig as JaxModelConfig
from stt_tpu.models import init_params
from stt_tpu.serve import Model as JaxModel
from stt_tpu.transcribe import resolve_sources as jax_resolve_sources
from stt_tpu.transcribe import transcribe_file as jax_transcribe_file
from stt_tpu_torch.data import vad, write_wav
from stt_tpu_torch.data.sources import CSVWriter, Sample
from stt_tpu_torch.decode.scorer_package import KenLMScorer
from stt_tpu_torch.evaluate_export import evaluate_export
from stt_tpu_torch.serve import Model
from stt_tpu_torch.transcribe import main as transcribe_main
from stt_tpu_torch.transcribe import resolve_sources, transcribe_file
from test_torch_scorer import LABELS, WORDS, build_package, write_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATE = 16000
BEAM = 16


def recording(seed, spans, total_s):
    """Speech-like islands (gliding harmonics) at `spans` over a quiet
    noise floor, so that VAD cuts it into segments."""
    rs = np.random.RandomState(seed)
    audio = rs.randn(int(total_s * RATE)).astype(np.float32) * 10 ** (-55 / 20)
    for t0, t1 in spans:
        t = np.arange(int((t1 - t0) * RATE)) / RATE
        island = sum(rs.uniform(0.05, 0.2) * np.sin(2 * np.pi * (rs.uniform(90, 400)
                                                               + rs.uniform(-40, 40) * t) * t)
                     for _ in range(4))
        audio[int(t0 * RATE): int(t0 * RATE) + len(t)] += island + 0.02 * rs.randn(len(t))
    return np.clip(audio, -1, 1).astype(np.float32)


SPANS = [(0.4, 1.5), (2.3, 3.1), (3.9, 5.6), (6.5, 7.0), (7.8, 9.4)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("transcribe")
    alphabet = JaxAlphabet().init_from_labels(LABELS)
    config = JaxModelConfig(n_hidden=32, n_cell_dim=32, n_out=len(LABELS) + 1,
                            dropout_rates=(0.0,) * 6)
    params = jax.device_get(init_params(jax.random.PRNGKey(5), config))
    meta = build_metadata(config, JaxFeatureConfig(), alphabet, beam_width=BEAM)
    wav = str(root / "long.wav")
    write_wav(wav, recording(0, SPANS, 10.0), RATE)
    rs = np.random.RandomState(1)
    csv = str(root / "test.csv")
    with CSVWriter(csv) as writer:
        for i in range(4):
            writer.add(Sample(f"e{i}", " ".join(rs.choice(WORDS, 2)),
                              _audio=recording(10 + i, [(0.1, 0.9)], 1.0), _rate=RATE))
    write_inputs(root)
    return {
        "root": root,
        "artifact": save_artifact(str(root / "model"), params, meta, alphabet),
        "wav": wav,
        "csv": csv,
        "scorer": build_package(root, "lm.scorer"),
    }


def same_split(got, want):
    """Equal nests of lists and tuples, with equal arrays at the leaves."""
    if isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for x, y in zip(got, want):
            same_split(x, y)
    else:
        assert got == want


@pytest.mark.parametrize("aggressiveness", [0, 3])
@pytest.mark.parametrize("classifier", ["energy", "gmm"])
def test_vad_splits_equal_stt_tpu(classifier, aggressiveness):
    audio = recording(0, SPANS, 10.0)
    fn = {"energy": "energy_vad_classifier", "gmm": "gmm_vad_classifier"}[classifier]
    assert getattr(vad, fn)(audio, 480, aggressiveness) == \
        getattr(jax_vad, fn)(audio, 480, aggressiveness)
    segments = list(vad.vad_split(audio, RATE, aggressiveness=aggressiveness,
                                  classifier=classifier))
    same_split(segments, list(jax_vad.vad_split(audio, RATE, aggressiveness=aggressiveness,
                                                classifier=classifier)))
    assert len(segments) >= 3
    got = list(vad.split_audio_file(audio, RATE, batch_size=2, aggressiveness=aggressiveness,
                                    classifier=classifier, outlier_duration_ms=1500))
    same_split(got, list(jax_vad.split_audio_file(
        audio, RATE, batch_size=2, aggressiveness=aggressiveness, classifier=classifier,
        outlier_duration_ms=1500)))
    assert len(got) >= 2


@pytest.mark.parametrize("case", ["float", "int8", "scorer"])
def test_transcribe_file_equals_stt_tpu(setup, case):
    quantized = case == "int8"
    model = Model(setup["artifact"], quantized_inference=quantized, device="cpu")
    jax_model = JaxModel(setup["artifact"], quantized_inference=quantized)
    scorers = (None, None)
    if case == "scorer":
        scorers = (KenLMScorer(setup["scorer"]), JaxKenLMScorer(setup["scorer"]))
    kw = dict(batch_size=2, beam_width=BEAM, aggressiveness=1)
    got = transcribe_file(model, setup["wav"], scorer=scorers[0], **kw)
    want = jax_transcribe_file(jax_model, setup["wav"], scorer=scorers[1], **kw)
    assert len(got) >= 3
    assert got == want
    assert [s["start"] for s in got] == sorted(s["start"] for s in got)


def test_evaluate_export_equals_stt_tpu(setup, tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = evaluate_export(setup["artifact"], setup["csv"], beam_width=8,
                              output_file=str(tmp_path / "port.json"), device="cpu")
    got_out, out = out.getvalue(), io.StringIO()
    with contextlib.redirect_stdout(out):
        want = jax_evaluate_export(setup["artifact"], setup["csv"], beam_width=8,
                                   output_file=str(tmp_path / "jax.json"))
    assert got_out == out.getvalue() and "WER:" in got_out
    assert [r.to_dict() for r in got] == [r.to_dict() for r in want]
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


def test_resolve_sources_equals_stt_tpu(tmp_path):
    (tmp_path / "d" / "sub").mkdir(parents=True)
    for name in ("d/b.wav", "d/sub/a.wav", "d/c.txt"):
        (tmp_path / name).write_bytes(b"")
    catalog = tmp_path / "x.catalog"
    catalog.write_text(json.dumps(["d/b.wav", {"audio": str(tmp_path / "d/sub/a.wav")}]))
    for src in (str(tmp_path / "d"), str(catalog), str(tmp_path / "d/b.wav")):
        assert resolve_sources(src) == jax_resolve_sources(src)
    assert len(resolve_sources(str(tmp_path / "d"))) == 2


@pytest.mark.parametrize("count,rank", [(2, 0), (2, 1), (3, 2)])
def test_sources_shard_round_robin_like_stt_tpu(setup, tmp_path, count, rank):
    """Each process transcribes every count-th source from its rank, as
    stt_tpu.transcribe slices them ([proc_id::proc_count])."""
    from stt_tpu_torch.transcribe import shard_sources

    for i in range(5):
        (tmp_path / f"r{i}.wav").write_bytes(b"")
    sources = resolve_sources(str(tmp_path))
    assert sources == jax_resolve_sources(str(tmp_path))
    assert shard_sources(sources, rank, count) == sources[rank::count]
    shares = [shard_sources(sources, r, count) for r in range(count)]
    assert sorted(sum(shares, [])) == sorted(sources)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_ranks(argvs, timeout=120):
    """Start one `python -m ...` process a rank, all at once, each killed if
    it outlasts `timeout` seconds; returns their (returncode, stdout, stderr)."""
    env = {**os.environ, "PYTHONPATH": ROOT, "CUDA_VISIBLE_DEVICES": ""}
    procs = [subprocess.Popen([sys.executable, "-m", *argv], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for argv in argvs]
    out = []
    for proc in procs:
        try:
            stdout, stderr = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
        out.append((proc.returncode, stdout, stderr))
    return out


def test_two_processes_transcribe_their_shares(setup, tmp_path):
    """--num_processes 2 on the CPU (gloo): the ranks join one group over
    --coordinator_address, each writes the .tlog of its share, and every
    .tlog equals stt_tpu's transcribe_file of that recording."""
    for i in range(3):
        write_wav(str(tmp_path / f"r{i}.wav"), recording(30 + i, [(0.3, 1.4)], 2.0), RATE)
    address = f"localhost:{free_port()}"
    results = run_ranks([["stt_tpu_torch.transcribe", "--src", str(tmp_path), "--model_dir",
                          setup["artifact"], "--beam_width", str(BEAM), "--device", "cpu",
                          "--num_processes", "2", "--process_id", str(rank),
                          "--coordinator_address", address] for rank in range(2)])
    for code, stdout, stderr in results:
        assert code == 0, stderr
    assert "r0.wav" in results[0][1] and "r2.wav" in results[0][1]
    assert "r1.wav" in results[1][1] and "r1.wav" not in results[0][1]
    jax_model = JaxModel(setup["artifact"])
    for i in range(3):
        with open(tmp_path / f"r{i}.tlog") as f:
            segments = json.load(f)
        want = jax_transcribe_file(jax_model, str(tmp_path / f"r{i}.wav"), beam_width=BEAM)
        assert segments == json.loads(json.dumps(want))


def test_command_lines_run_on_the_cpu_when_asked(setup, tmp_path):
    env = {**os.environ, "PYTHONPATH": ROOT, "CUDA_VISIBLE_DEVICES": ""}
    tlog = str(tmp_path / "out.tlog")
    args = ["--src", setup["wav"], "--dst", tlog, "--model_dir", setup["artifact"],
            "--beam_width", str(BEAM), "--batch_size", "2", "--vad_aggressiveness", "1",
            "--device", "cpu"]
    proc = subprocess.run([sys.executable, "-m", "stt_tpu_torch.transcribe", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    with open(tlog) as f:
        segments = json.load(f)
    want = jax_transcribe_file(JaxModel(setup["artifact"]), setup["wav"], batch_size=2,
                               beam_width=BEAM, aggressiveness=1)
    assert segments == json.loads(json.dumps(want))
    proc = subprocess.run([sys.executable, "-m", "stt_tpu_torch.evaluate_export", "--model_dir",
                           setup["artifact"], "--csv", setup["csv"], "--device", "cpu"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "Test on" in proc.stdout
