"""The port's two harnesses of the native decoder (`stt_tpu_torch/native/`),
built by `native_build` into build/native/:

- decoder_smoke under ASan and UBSan: its C ABI rounds pass without a
  scorer and with a scorer package built here by the port's tools, and no
  sanitizer reports anything;
- prof_decoder (the gprof driver, built with -pg): its transcript line on
  stderr equals that of stt_tpu's prof_decoder.cc, built into the test's
  directory, with the same scorer and without one (the scorer's
  transcript is a few words, the unscored one every frame's character);
  each writes gmon.out into its own scratch working directory.

Skips only where g++ is absent.
"""

import os
import re
import shutil
import subprocess

import pytest

from stt_tpu_torch import native_build
from test_torch_scorer import ROOT, build_package

TRANSCRIPT = re.compile(r"^transcript\[\d+\]: .*$", re.M)


@pytest.fixture(scope="module")
def scorer(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("native toolchain unavailable")
    return build_package(tmp_path_factory.mktemp("lm"), "lm.scorer")


@pytest.mark.parametrize("with_scorer", [False, True])
def test_decoder_smoke_passes_under_sanitizers(scorer, with_scorer, tmp_path):
    harness = native_build.build_decoder_smoke()
    proc = subprocess.run([str(harness), *([scorer] if with_scorer else [])], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-3000:]
    assert "decoder_smoke OK" in proc.stdout
    assert proc.stdout.count("round ") == 3
    assert "AddressSanitizer" not in out
    assert "runtime error" not in out  # UBSan


def prof_transcript(binary, scorer, cwd) -> str:
    os.makedirs(cwd, exist_ok=True)
    proc = subprocess.run([str(binary), *([scorer] if scorer else [])], cwd=cwd,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert os.path.isfile(os.path.join(cwd, "gmon.out"))
    [line] = TRANSCRIPT.findall(proc.stderr)
    return line


@pytest.mark.parametrize("with_scorer", [True, False])
def test_prof_decoder_prints_stt_tpus_transcript(scorer, with_scorer, tmp_path):
    ours = native_build.build_prof_decoder()
    theirs = tmp_path / "prof_decoder"
    proc = subprocess.run(["g++", "-O2", "-pg", "-std=c++17",
                           os.path.join(ROOT, "stt_tpu", "native", "prof_decoder.cc"),
                           "-o", str(theirs)], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    scorer = scorer if with_scorer else None
    got = prof_transcript(ours, scorer, tmp_path / "ours")
    assert got == prof_transcript(theirs, scorer, tmp_path / "theirs")
    assert len(got) > len("transcript[0]: ")
