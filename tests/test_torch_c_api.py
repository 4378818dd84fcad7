"""The port's C API (libstt_tpu_torch.so over stt_tpu_torch.serve.cbridge,
and the stt_client program) against stt_tpu's bridge on the CPU, on one
artifact and one scorer package made here:

- the library and the client build at first use into build/native/, and
  again when the Python that builds them is another; the header is
  stt_tpu's ABI;
- STT_CreateModel on a missing path gives STT_ERR_NO_MODEL, a scorer
  package of another version STT_ERR_SCORER_VERSION_MISMATCH (the port's
  ScorerLoadError, mapped by its name), STT_Version the port's version;
- with the bridge on the CPU (`cbridge.set_device("cpu")`, the one way a
  caller in this interpreter asks for it), one-shot, metadata and
  streaming with a scorer and hot words through ctypes give stt_tpu's
  cbridge's transcripts, tokens and timesteps; confidences to 1e-5
  (float32 forwards summed in another order move the beam scores by that
  much, not the beams);
- stt_client boots its own interpreter, and without CUDA it exits non-zero
  and says why: the C surface serves on the card only.
"""

import ctypes
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

from stt_tpu.alphabet import Alphabet as JaxAlphabet
from stt_tpu.artifact import build_metadata, save_artifact
from stt_tpu.frontend import FeatureConfig as JaxFeatureConfig
from stt_tpu.models import ModelConfig as JaxModelConfig
from stt_tpu.models import init_params
from stt_tpu.serve import cbridge as jax_cbridge
import stt_tpu_torch
from stt_tpu_torch import native_build
from stt_tpu_torch.data import write_wav
from stt_tpu_torch.decode.scorer_package import MAGIC
from stt_tpu_torch.serve import capi, cbridge
from test_torch_scorer import build_package

ROOT = Path(__file__).resolve().parents[1]
LABELS = list(" abcdefghijklmnopqrstuvwxyz'")
BEAM = 16
CONF_TOL = 1e-5
HOT_WORDS = {"water": 2.0, "the": -0.5, "year": 1.0}
STT_ERR_NO_MODEL, STT_ERR_SCORER_NOT_ENABLED, STT_ERR_SCORER_VERSION_MISMATCH = (
    0x1000, 0x2004, 0x2009)


@pytest.fixture(scope="module")
def lib():
    cbridge.set_device("cpu")
    yield capi.load()
    cbridge.set_device("cuda")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One artifact (stt_tpu's writer, 64 wide), a scorer package and the
    PCM of a speech-like utterance."""
    root = tmp_path_factory.mktemp("capi")
    alphabet = JaxAlphabet().init_from_labels(LABELS)
    config = JaxModelConfig(n_hidden=64, n_cell_dim=64, n_out=len(LABELS) + 1,
                            dropout_rates=(0.0,) * 6)
    params = jax.device_get(init_params(jax.random.PRNGKey(3), config))
    model = save_artifact(str(root / "model"), params,
                          build_metadata(config, JaxFeatureConfig(), alphabet, beam_width=BEAM),
                          alphabet)
    rs = np.random.RandomState(4)
    t = np.arange(int(2.7 * 16000)) / 16000.0
    audio = sum(0.15 * np.sin(2 * np.pi * rs.uniform(100, 2000) * t) for _ in range(3))
    audio = (audio + 0.03 * rs.randn(len(t))).astype(np.float32)
    pcm = np.clip(audio * 32768, -32768, 32767).astype(np.int16)
    wav = str(root / "a.wav")
    write_wav(wav, pcm.astype(np.float32) / 32768.0, 16000)
    return {"model": model, "scorer": build_package(root, "lm.scorer"), "pcm": pcm, "wav": wav,
            "root": root}


def same_metadata(got: list, want: list) -> None:
    assert len(got) == len(want)
    for (conf, tokens), (want_conf, want_tokens) in zip(got, want):
        assert [(t, s) for t, s, _ in tokens] == [(t, s) for t, s, _ in want_tokens]
        np.testing.assert_allclose([s for *_, s in tokens], [s for *_, s in want_tokens],
                                   rtol=1e-6)
        assert abs(conf - want_conf) <= CONF_TOL, (conf, want_conf)


def port_model(lib, served, scorer=True) -> ctypes.c_void_p:
    handle = ctypes.c_void_p()
    assert lib.STT_CreateModel(served["model"].encode(), ctypes.byref(handle)) == 0
    if scorer:
        assert lib.STT_EnableExternalScorer(handle, served["scorer"].encode()) == 0
        for word, boost in HOT_WORDS.items():
            assert lib.STT_AddHotWord(handle, word.encode(), boost) == 0
    return handle


def jax_model(served, scorer=True) -> int:
    handle = jax_cbridge.create_model(served["model"])
    if scorer:
        jax_cbridge.enable_external_scorer(handle, served["scorer"])
        for word, boost in HOT_WORDS.items():
            jax_cbridge.add_hot_word(handle, word, boost)
    return handle


def test_library_and_client_build_into_build_native():
    assert capi.LIBRARY == ROOT / "build" / "native" / "libstt_tpu_torch.so"
    assert capi.CLIENT == ROOT / "build" / "native" / "stt_client"
    assert capi.client() == capi.CLIENT and capi.CLIENT.is_file() and capi.LIBRARY.is_file()
    command = capi.library_command()
    assert f'-DSTT_PYTHON_EXECUTABLE="{sys.executable}"' in command
    assert any(arg.startswith("-lpython") for arg in command)
    assert (ROOT / "build" / "native" / "libstt_tpu_torch.so.cmd").read_text() == " ".join(command)


def test_header_is_stt_tpus_abi():
    """stt_tpu.h is stt_tpu's header apart from its opening comment, so a C
    program links either library."""
    def declarations(path: Path) -> str:
        text = path.read_text()
        return text[text.index("#ifndef STT_TPU_H"):]

    assert declarations(capi.HEADER) == declarations(ROOT / "stt_tpu" / "native" / "stt_tpu.h")


def test_a_build_for_another_python_is_built_again(tmp_path, monkeypatch):
    """The stamp beside the output names the command that built it: the same
    sources built for another interpreter are built again; a failed build
    raises with the compiler's message and leaves nothing in place."""
    out = tmp_path / "libx.so"
    source = tmp_path / "x.cpp"
    source.write_text("int f() { return 1; }\n")
    command = ["g++", "-shared", "-fPIC", str(source)]
    native_build.build_if_stale(command, [source], out, "x")
    built = out.stat().st_mtime_ns
    native_build.build_if_stale(command, [source], out, "x")
    assert out.stat().st_mtime_ns == built
    os.utime(out, ns=(built, built))
    native_build.build_if_stale(command + ["-DOTHER_PYTHON"], [source], out, "x")
    assert (tmp_path / "libx.so.cmd").read_text().endswith("-DOTHER_PYTHON")
    source.write_text("int f() { return not_declared; }\n")
    with pytest.raises(RuntimeError, match="not_declared"):
        native_build.build_if_stale(command, [source], out, "x")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["libx.so", "libx.so.cmd", "x.cpp"]


def test_error_codes_and_version(lib, served, tmp_path):
    handle = ctypes.c_void_p()
    assert lib.STT_CreateModel(b"/nonexistent/model", ctypes.byref(handle)) == STT_ERR_NO_MODEL
    assert capi.take_string(lib, lib.STT_ErrorCodeToErrorMessage(STT_ERR_NO_MODEL)) == \
        "Missing model information."
    assert capi.take_string(lib, lib.STT_Version()) == stt_tpu_torch.__version__
    # map_exception maps by the exception's name and message, as stt_tpu's
    # does: a package of another version raises ScorerLoadError in both
    # bridges, a file that is no KenLM model a ValueError naming the scorer
    data = Path(served["scorer"]).read_bytes()
    at = data.index(MAGIC) + len(MAGIC)
    other_version = tmp_path / "v99.scorer"
    other_version.write_bytes(data[:at] + struct.pack("<i", 99) + data[at + 4:])
    garbage = tmp_path / "garbage.scorer"
    garbage.write_bytes(b"not a scorer package" * 10)
    handle, want = port_model(lib, served, scorer=False), jax_model(served, scorer=False)
    for path, code in ((other_version, STT_ERR_SCORER_VERSION_MISMATCH),
                       (garbage, STT_ERR_SCORER_NOT_ENABLED)):
        assert lib.STT_EnableExternalScorer(handle, str(path).encode()) == code
        with pytest.raises(ValueError) as raised:
            jax_cbridge.enable_external_scorer(want, str(path))
        assert type(raised.value).__name__ == ("ScorerLoadError" if path == other_version
                                               else "ValueError")
    jax_cbridge.free_model(want)
    assert lib.STT_GetModelSampleRate(handle) == 16000
    assert lib.STT_GetModelBeamWidth(handle) == BEAM
    assert lib.STT_SetModelBeamWidth(handle, 24) == 0 and lib.STT_GetModelBeamWidth(handle) == 24
    lib.STT_FreeModel(handle)


@pytest.mark.parametrize("scorer", [False, True], ids=["plain", "scorer+hot_words"])
def test_one_shot_and_metadata_equal_stt_tpus_bridge(lib, served, scorer):
    pcm = served["pcm"]
    handle, want = port_model(lib, served, scorer), jax_model(served, scorer)
    text = capi.take_string(lib, lib.STT_SpeechToText(handle, capi.pcm_pointer(pcm), len(pcm)))
    assert text and text == jax_cbridge.speech_to_text(want, pcm.tobytes())
    got = capi.take_metadata(lib, lib.STT_SpeechToTextWithMetadata(handle, capi.pcm_pointer(pcm),
                                                              len(pcm), 3))
    same_metadata(got, jax_cbridge.speech_to_text_with_metadata(want, pcm.tobytes(), 3))
    assert "".join(t for t, _, _ in got[0][1]) == text
    lib.STT_FreeModel(handle)
    jax_cbridge.free_model(want)


def test_stream_with_scorer_and_hot_words_equals_stt_tpus_bridge(lib, served):
    """320 ms chunks with an intermediate decode after each, then the final
    decode with metadata; the handle tables hold no finished stream."""
    pcm = served["pcm"]
    handle, want = port_model(lib, served), jax_model(served)
    stream = ctypes.c_void_p()
    assert lib.STT_CreateStream(handle, ctypes.byref(stream)) == 0
    want_stream = jax_cbridge.create_stream(want)
    piece = int(0.32 * 16000)
    partial, want_partial = [], []
    for off in range(0, len(pcm), piece):
        chunk = np.ascontiguousarray(pcm[off:off + piece])
        lib.STT_FeedAudioContent(stream, capi.pcm_pointer(chunk), len(chunk))
        partial.append(capi.take_string(lib, lib.STT_IntermediateDecode(stream)))
        jax_cbridge.feed_audio_content(want_stream, chunk.tobytes())
        want_partial.append(jax_cbridge.intermediate_decode(want_stream))
    assert any(partial) and partial == want_partial
    assert len(cbridge._STREAMS) == 1
    final = capi.take_metadata(lib, lib.STT_FinishStreamWithMetadata(stream, 2))
    same_metadata(final, jax_cbridge.finish_stream_with_metadata(want_stream, 2))
    assert final[0][1], "the final decode is empty"
    assert not cbridge._STREAMS
    # a stream freed unfinished leaves the table too
    assert lib.STT_CreateStream(handle, ctypes.byref(stream)) == 0
    assert len(cbridge._STREAMS) == 1
    lib.STT_FreeStream(stream)
    assert not cbridge._STREAMS
    lib.STT_FreeModel(handle)
    jax_cbridge.free_model(want)


def run_client(*args, **env) -> subprocess.CompletedProcess:
    return subprocess.run([str(capi.client()), *args], capture_output=True, text=True,
                          timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT), **env})


def test_stt_client_boots_its_interpreter():
    """The program starts Python as the interpreter that built it would
    start, so the same site-packages (torch) are found."""
    proc = run_client("--version")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f"stt_tpu_torch {stt_tpu_torch.__version__}"
    assert run_client().returncode == 2


@pytest.mark.parametrize("mode", [[], ["--stream"]], ids=["one_shot", "stream"])
def test_stt_client_without_cuda_fails_and_says_why(served, mode):
    proc = run_client("--model", served["model"], "--audio", served["wav"], *mode,
                      CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr, proc.stderr
    assert "CreateModel failed" in proc.stderr and not proc.stdout
