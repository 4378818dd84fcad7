"""The port's export against stt_tpu's on the CPU, from the same weights: a
port checkpoint and a stt_tpu checkpoint of one parameter tree, each
package's `export(config)` with the same flags, then

- metadata.json, alphabet.txt and MODEL_CARD.md byte-equal;
- the weights.npz arrays equal, float and int8 (--export_quantize);
- the .sttpkg of --export_zip with the same members, and equal
  metadata.json and alphabet.txt inside;
- the port's export loads in stt_tpu.serve.Model and gives the transcript
  of stt_tpu's own export;
- --export_tflite writes output_graph.tflite beside the artifact, equal to
  stt_tpu's when read back, holding the checkpoint's weights; the command
  line with --device cpu.
"""

import io
import os
import subprocess
import sys
import zipfile

import jax
import numpy as np
import pytest

from stt_tpu.config import SttConfig as JaxSttConfig
from stt_tpu.export import export as jax_export
from stt_tpu.models import init_params
from stt_tpu.serve import Model as JaxModel
from stt_tpu.train.checkpoints import CheckpointManager as JaxCheckpointManager
from stt_tpu.train.step import create_train_state as jax_create_train_state
from stt_tpu.train.trainer import create_optimizer_with_hyperparams
from stt_tpu_torch.artifact import PACKAGE_EXT, package_zip, params_from_numpy
from stt_tpu_torch.config import SttConfig, parse_flags
from stt_tpu_torch.export import export
from stt_tpu_torch.serve import Model
from stt_tpu_torch.train.checkpoints import CheckpointManager, load_graph_for_evaluation
from stt_tpu_torch.train.step import create_train_state
from test_torch_scorer import write_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = dict(export_model_name="tiny-en", export_author_id="someone", export_model_version="1.2.3",
            export_license="MPL-2.0", export_language="en-US", export_beam_width=64,
            lm_alpha=0.5, lm_beta=1.5)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One parameter tree saved as a checkpoint of each package."""
    root = tmp_path_factory.mktemp("export")
    alphabet = write_inputs(root)["alphabet"]
    flags = dict(alphabet_config_path=alphabet, n_hidden=32)
    jax_config = JaxSttConfig(**flags)
    model_config = jax_config.model_config(training=False)
    params = jax.device_get(init_params(jax.random.PRNGKey(11), model_config))
    jax_state = jax_create_train_state(jax.random.PRNGKey(0), model_config,
                                       create_optimizer_with_hyperparams(jax_config),
                                       params=params)
    JaxCheckpointManager(str(root / "jax_ckpt")).save(jax_state, "last")
    config = SttConfig(**flags)
    model = params_from_numpy(params, config.model_config(training=False))
    state = create_train_state(config.model_config(training=False), device="cpu", model=model)
    CheckpointManager(str(root / "port_ckpt")).save(state, "last")
    return {"root": root, "flags": flags}


def exported(checkpoints, name, **kw):
    """(the port's export, stt_tpu's) with the same flags."""
    root = checkpoints["root"]
    common = dict(checkpoints["flags"], **CARD, **kw)
    got = export(SttConfig(checkpoint_dir=str(root / "port_ckpt"),
                           export_dir=str(root / f"{name}_port"), **common), device="cpu")
    want = jax_export(JaxSttConfig(checkpoint_dir=str(root / "jax_ckpt"),
                                   export_dir=str(root / f"{name}_jax"), **common))
    return got, want


def read(path, name) -> bytes:
    if os.path.isdir(path):
        with open(os.path.join(path, name), "rb") as f:
            return f.read()
    with zipfile.ZipFile(path) as zf:
        return zf.read(name)


def npz(data: bytes) -> dict:
    with np.load(io.BytesIO(data)) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("quantize", [False, True])
def test_artifact_files_equal_stt_tpu(checkpoints, quantize):
    got, want = exported(checkpoints, f"q{int(quantize)}", export_quantize=quantize)
    for name in ("metadata.json", "alphabet.txt", "MODEL_CARD.md"):
        assert read(got, name) == read(want, name), name
    assert b"- Framework: stt_tpu 0.1.0 (graph v6)" in read(got, "MODEL_CARD.md")
    assert (b'"quantized": true' in read(got, "metadata.json")) == quantize
    weights, want_weights = npz(read(got, "weights.npz")), npz(read(want, "weights.npz"))
    assert weights.keys() == want_weights.keys()
    for key, value in want_weights.items():
        assert weights[key].dtype == value.dtype, key
        np.testing.assert_array_equal(weights[key], value, err_msg=key)


@pytest.mark.parametrize("quantize", [False, True])
def test_export_zip_equals_stt_tpu(checkpoints, quantize):
    got, want = exported(checkpoints, f"zip{int(quantize)}", export_zip=True,
                         export_quantize=quantize)
    assert got.endswith(PACKAGE_EXT) and want.endswith(PACKAGE_EXT)
    with zipfile.ZipFile(got) as a, zipfile.ZipFile(want) as b:
        assert a.namelist() == b.namelist() == ["weights.npz", "metadata.json", "alphabet.txt"]
    for name in ("metadata.json", "alphabet.txt"):
        assert read(got, name) == read(want, name)
    for key, value in npz(read(want, "weights.npz")).items():
        np.testing.assert_array_equal(npz(read(got, "weights.npz"))[key], value)
    # package_zip alone makes the same members from the directory
    again = package_zip(got[: -len(PACKAGE_EXT)], got + ".again")
    with zipfile.ZipFile(again) as a:
        assert a.namelist() == ["weights.npz", "metadata.json", "alphabet.txt"]


@pytest.mark.parametrize("form", ["dir", "zip", "int8"])
def test_port_export_serves_in_stt_tpu(checkpoints, form):
    kw = {"dir": {}, "zip": {"export_zip": True}, "int8": {"export_quantize": True}}[form]
    got, want = exported(checkpoints, f"serve_{form}", **kw)
    rs = np.random.RandomState(2)
    t = np.arange(int(1.3 * 16000)) / 16000
    audio = (sum(0.15 * np.sin(2 * np.pi * rs.uniform(100, 2000) * t) for _ in range(3))
             + 0.03 * rs.randn(len(t))).astype(np.float32)
    text = JaxModel(got).stt(audio)
    assert text == JaxModel(want).stt(audio)
    # and the port opens it too, with stt_tpu's metadata
    model = Model(got, device="cpu")
    assert model.metadata == JaxModel(want).metadata
    assert model.beam_width == CARD["export_beam_width"]


@pytest.mark.parametrize("quantize", [False, True])
def test_export_tflite_writes_the_reference_graph(checkpoints, quantize):
    """--export_tflite (once refused by the port's config) writes
    output_graph.tflite beside the artifact: read back by either package's
    reader it equals stt_tpu's export, and in f32 it holds the checkpoint's
    weights exactly."""
    pytest.importorskip("tensorflow")
    from stt_tpu.compat.tflite import read_reference_tflite as jax_read
    from stt_tpu_torch.compat.tflite import read_reference_tflite
    from stt_tpu_torch.config import NOT_PORTED

    assert NOT_PORTED == {}
    assert parse_flags(["--export_tflite", "true"]).export_tflite is True
    for flag, value in (("export_dir", "/tmp/e"), ("export_zip", True),
                        ("export_quantize", True), ("export_beam_width", 32),
                        ("export_tflite", True), ("n_steps", 8)):
        assert getattr(SttConfig(**{flag: value}), flag) == value
    got, want = exported(checkpoints, f"tflite_{quantize}", export_tflite=True,
                         export_quantize=quantize)
    path = os.path.join(got, "output_graph.tflite")
    params, meta, geometry = read_reference_tflite(path)
    for reader in (read_reference_tflite, jax_read):
        other = reader(os.path.join(want, "output_graph.tflite"))
        assert other[1:] == (meta, geometry)
        for layer in params:
            for leaf in params[layer]:
                np.testing.assert_array_equal(other[0][layer][leaf], params[layer][leaf])
    assert geometry["n_hidden"] == 32 and meta["beam_width"] == CARD["export_beam_width"]
    assert meta["language"] == CARD["export_language"]
    if not quantize:
        state = create_train_state(SttConfig(**checkpoints["flags"]).model_config(training=False),
                                   device="cpu")
        state, _ = load_graph_for_evaluation(
            CheckpointManager(str(checkpoints["root"] / "port_ckpt")), state, "auto")
        for name, value in state.model.state_dict().items():
            layer, leaf = name.split("/")
            np.testing.assert_array_equal(params[layer][leaf], value.numpy())


def test_export_module_runs_on_the_cpu_when_asked(checkpoints, tmp_path):
    root = checkpoints["root"]
    args = ["--device", "cpu", "--alphabet_config_path", checkpoints["flags"]["alphabet_config_path"],
            "--n_hidden", "32", "--checkpoint_dir", str(root / "port_ckpt"), "--export_dir",
            str(tmp_path / "cli"), "--export_zip", "true"]
    env = {**os.environ, "PYTHONPATH": ROOT, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "stt_tpu_torch.export", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "Exporting 'last' checkpoint (step 0)" in proc.stdout
    assert os.path.isfile(str(tmp_path / "cli") + PACKAGE_EXT)
    proc = subprocess.run([sys.executable, "-m", "stt_tpu_torch.export", *args[:-4]], cwd=ROOT,
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 1 and "--export_dir is required" in proc.stderr
