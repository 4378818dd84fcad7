"""The port's scripts (stt_tpu_torch/bin/) against the repository's bin/:

(a) every `python -m stt_tpu.X` command line of each bin/ script has its
    twin in the port's script, with the same flags and values, once
    stt_tpu is read as stt_tpu_torch and `--device "$device"` is removed;
    the variables keep their defaults, the gates (expected transcript,
    checkpoint-file checks, cmp, asserts) are the same lines, and every
    command that computes takes `--device "$device"` (default cuda);
(b) the scripts without a transcript gate run through `sh` with
    device=cpu on a `chip_smoke.write_smoke_set` tree: checkpoint, audio
    formats (FLAC and the committed Vorbis fixture) and multihost (two gloo
    processes whose losses `cmp` equal), each process counting its kernel
    launches through STT_TORCH_LAUNCH_LOG (none on the CPU);
(c) make_spliced_corpus is held to bin/make_spliced_corpus.py in
    tests/test_torch_spliced_corpus.py (a file of its own, so that the two
    run side by side).

The committed Vorbis fixture (tests/fixtures/LDC93S1.ogg) is
`chip_smoke.spoken` of the smoke sentence through libvorbisenc; `python
tests/test_torch_scripts.py` writes it again.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from stt_tpu_torch.ops import launch_log  # noqa: E402

PORT_BIN = os.path.join(ROOT, "stt_tpu_torch", "bin")
TWINS = {  # bin/ script -> the port's
    "run-ldc93s1.sh": "run-ldc93s1.sh",
    "run-ci-ldc93s1_new.sh": "run-ci-ldc93s1_new.sh",
    "run-ci-ldc93s1_checkpoint.sh": "run-ci-ldc93s1_checkpoint.sh",
    "run-ci-ldc93s1_audio_formats.sh": "run-ci-ldc93s1_audio_formats.sh",
    "run-ci-ldc93s1_tpu_fused.sh": "run-ci-ldc93s1_fused.sh",
    "run-ci-multihost.sh": "run-ci-multihost.sh",
    "run-flagship-endurance.sh": "run-flagship-endurance.sh",
}
COMPUTING = ("train", "evaluate", "export", "client", "training_graph_inference")
DEVICE = ' --device "$device"'
SCRIPT_TIMEOUT_S = 300


def read(path: str) -> str:
    with open(path, encoding="utf-8") as f:
        return f.read()


def logical_lines(text: str) -> list:
    """The script's lines but its comments, with backslash continuations
    joined and whitespace runs collapsed."""
    lines = [" ".join(line.split()) for line in text.replace("\\\n", " ").splitlines()]
    return [line for line in lines if not line.startswith("#")]


def commands(text: str, package: str) -> list:
    """Every `python -m <package>.X ...` of the script, from `python` on."""
    pattern = re.compile(r"python -m " + re.escape(package) + r"\.\S+.*")
    return [m.group(0) for line in logical_lines(text) for m in [pattern.search(line)] if m]


def defaults(text: str) -> dict:
    return dict(re.findall(r'^(\w+)="\$\{\w+:-(.*)\}"$', text, re.M))


def gates(text: str) -> list:
    keys = ("expected=", "MISMATCH", "[ -f", "cmp ", "assert ", "test -")
    return [line for line in logical_lines(text) if any(k in line for k in keys)]


@pytest.mark.parametrize("original", sorted(TWINS))
def test_command_lines_are_stt_tpus(original):
    theirs = read(os.path.join(ROOT, "bin", original))
    ours = read(os.path.join(PORT_BIN, TWINS[original]))
    want = [c.replace("python -m stt_tpu.", "python -m stt_tpu_torch.")
            for c in commands(theirs, "stt_tpu")]
    got = commands(ours, "stt_tpu_torch")
    assert want and [c.replace(DEVICE, "") for c in got] == want
    for command in got:
        module = command.split()[2].split(".")[1]
        assert (DEVICE in command) == (module in COMPUTING), command
    assert not commands(ours, "stt_tpu")
    ours_defaults = defaults(ours)
    assert ours_defaults.pop("device") == "cuda"
    assert ours_defaults == defaults(theirs)
    assert gates(ours) == gates(theirs)
    assert "JAX_PLATFORMS" not in ours and "XLA_FLAGS" not in ours


def test_endurance_runs_the_ports_splice_and_fused_script():
    theirs = logical_lines(read(os.path.join(ROOT, "bin", "run-flagship-endurance.sh")))
    ours = logical_lines(read(os.path.join(PORT_BIN, "run-flagship-endurance.sh")))
    [want] = [line for line in theirs if "make_spliced_corpus.py" in line]
    [got] = [line for line in ours if "make_spliced_corpus.py" in line]
    assert got.replace(" stt_tpu_torch/bin/", " bin/").replace(DEVICE, "").replace(
        ' --smoke_wav "$smoke/LDC93S1.wav"', "") == want
    [fallback] = [line for line in ours if "run-ci-ldc93s1_fused.sh" in line]
    assert fallback == 'work="$(dirname "$align_ckpt")" sh stt_tpu_torch/bin/run-ci-ldc93s1_fused.sh 200'
    assert defaults(read(os.path.join(PORT_BIN, "run-flagship-endurance.sh")))["align_ckpt"] == (
        "/tmp/ci_ldc93s1_tpu_fused/ckpt")


@pytest.fixture(scope="module")
def smoke_set(tmp_path_factory):
    return chip_smoke.write_smoke_set(str(tmp_path_factory.mktemp("data")), 0)


def run_script(name: str, tmp_path, env: dict) -> tuple:
    counts = str(tmp_path / "launches.jsonl")
    proc = subprocess.run(["sh", os.path.join(PORT_BIN, name)], cwd=ROOT, capture_output=True,
                          text=True, timeout=SCRIPT_TIMEOUT_S,
                          env={**os.environ, "device": "cpu", launch_log.ENV: counts, **env})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout + proc.stderr, launch_log.read(counts)


def test_checkpoint_script_runs_on_the_cpu(smoke_set, tmp_path):
    out, launches = run_script("run-ci-ldc93s1_checkpoint.sh", tmp_path,
                               {"work": str(tmp_path / "w"), **smoke_set})
    assert "run-ci-ldc93s1_checkpoint OK" in out
    assert launches == {**dict.fromkeys(launch_log.WRAPPERS, 0), "processes": 2}
    resumed = read(str(tmp_path / "w" / "resume.log"))
    assert "Initialized model from '" in resumed and "from 'init'" not in resumed
    assert resumed.count("| train loss ") == 5


def test_audio_formats_script_runs_on_the_cpu(smoke_set, tmp_path):
    out, launches = run_script("run-ci-ldc93s1_audio_formats.sh", tmp_path,
                               {"work": str(tmp_path / "w"), **smoke_set})
    assert "run-ci-ldc93s1_audio_formats OK" in out
    assert out.count("| train loss ") == 20
    assert launches["processes"] == 2 and launches["k3"] == launches["k4"] == 0


def test_multihost_script_runs_on_the_cpu(smoke_set, tmp_path):
    out, launches = run_script("run-ci-multihost.sh", tmp_path,
                               {"work": str(tmp_path / "w"), "port": str(chip_smoke.free_port()),
                                **smoke_set})
    assert "multi-host CI gate OK" in out
    assert launches["processes"] == 2 and launches["k3"] == 0
    losses = read(str(tmp_path / "w" / "l0")).split()
    assert len(losses) == 2 and all(np.isfinite(float(x)) for x in losses)


def test_vorbis_fixture_is_the_smoke_utterance(smoke_set):
    """The committed .ogg decodes (the port's decoder) to the utterance's
    length at 16 kHz, and its MFCCs lie nearer the utterance's than those of
    the same sentence shifted by one character."""
    from stt_tpu_torch.data.audio import read_audio
    from stt_tpu_torch.frontend import FeatureConfig, audio_to_mfcc_numpy

    audio, rate = read_audio(os.path.join(smoke_set["smoke"], "LDC93S1.ogg"))
    assert rate == 16000 and len(audio) == chip_smoke.SMOKE_SAMPLES
    want = chip_smoke.spoken(chip_smoke.SMOKE_TRANSCRIPT, rate, chip_smoke.SMOKE_SAMPLES)
    other = chip_smoke.spoken(chip_smoke.SMOKE_TRANSCRIPT[1:] + "s", rate, chip_smoke.SMOKE_SAMPLES)
    fc = FeatureConfig()
    got = audio_to_mfcc_numpy(audio, fc)
    assert (np.abs(got - audio_to_mfcc_numpy(want, fc)).mean()
            < 0.5 * np.abs(got - audio_to_mfcc_numpy(other, fc)).mean())


def write_vorbis_fixture() -> None:
    """Write tests/fixtures/LDC93S1.ogg again (needs libvorbisenc)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_audio_formats import write_vorbis

    audio = chip_smoke.spoken(chip_smoke.SMOKE_TRANSCRIPT, 16000, chip_smoke.SMOKE_SAMPLES)
    write_vorbis(chip_smoke.SMOKE_OGG, audio, 16000)


if __name__ == "__main__":
    write_vorbis_fixture()
