"""The port's reference-format interop (stt_tpu_torch.compat) against
stt_tpu's on the CPU, on the same seeded parameters:

- a .tflite written by each package's exporter, f32 and int8
  (dynamic-range), read back by each package's reader: equal weights bit
  for bit, equal metadata and geometry;
- the TFLite interpreter running the port's .tflite against the port's
  forward on the imported weights (stt_tpu's tolerance, rtol 1e-4 and
  atol 1e-5), over two chunks with the LSTM state carried;
- a TF1 checkpoint (built in the test, as tests/test_tf_checkpoint_import.py
  builds one) read by both packages: equal weights and geometry, and the
  port's forward on them against stt_tpu.models.apply_model;
- the geometry guess kept from stt_tpu, right and wrong, in both;
- the committed fixtures that chip_smoke.py serves on the card
  (tests/torch_tflite_fixture.py) are what the port's exporter writes, and
  saved as the port's artifact (`artifact.save_tflite_as_artifact`) they
  serve stt_tpu's forward on the imported weights.
"""

import os

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import jax.numpy as jnp
import torch

import torch_tflite_fixture as fixture
from stt_tpu.alphabet import Alphabet as JaxAlphabet
from stt_tpu.compat import tf_checkpoint as jax_tf_checkpoint
from stt_tpu.compat.tflite import read_reference_tflite as jax_read_tflite
from stt_tpu.compat.tflite_export import export_reference_tflite as jax_export_tflite
from stt_tpu.models import ModelConfig as JaxModelConfig
from stt_tpu.models import apply_model
from stt_tpu_torch.alphabet import Alphabet
from stt_tpu_torch.artifact import params_from_numpy, save_tflite_as_artifact
from stt_tpu_torch.compat import tf_checkpoint
from stt_tpu_torch.compat.tflite import read_reference_tflite
from stt_tpu_torch.compat.tflite_export import export_reference_tflite
from stt_tpu_torch.models import ModelConfig
from stt_tpu_torch.models.deepspeech import create_overlapping_windows
from stt_tpu_torch.serve import Model
from test_tf_checkpoint_import import make_reference_checkpoint

RTOL, ATOL = 1e-4, 1e-5  # stt_tpu's tests/test_tflite_interop.py
N_STEPS = fixture.N_STEPS
WIDTH = 2 * fixture.N_CONTEXT + 1


def port_config(geometry: dict) -> ModelConfig:
    return ModelConfig(n_input=geometry["n_input"], n_context=geometry["n_context"],
                       n_hidden=geometry["n_hidden"], n_cell_dim=geometry["n_cell_dim"],
                       n_out=geometry["n_out"], dropout_rates=(0.0,) * 6)


def assert_trees_equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for layer in want:
        assert got[layer].keys() == want[layer].keys(), layer
        for leaf in want[layer]:
            g, w = np.asarray(got[layer][leaf]), np.asarray(want[layer][leaf])
            assert g.dtype == w.dtype and g.shape == w.shape, (layer, leaf)
            np.testing.assert_array_equal(g, w, err_msg=f"{layer}/{leaf}")


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """{kind: (the port's .tflite, stt_tpu's)} from fixture_params()."""
    root = tmp_path_factory.mktemp("compat")
    labels = fixture.LABELS
    out = {}
    for kind in ("f32", "int8"):
        port = export_reference_tflite(fixture.fixture_params(), Alphabet().init_from_labels(labels),
                                       str(root / f"port_{kind}.tflite"), n_steps=N_STEPS,
                                       quantize=kind == "int8")
        jax = jax_export_tflite(fixture.fixture_params(), JaxAlphabet().init_from_labels(labels),
                                str(root / f"jax_{kind}.tflite"), n_steps=N_STEPS,
                                quantize=kind == "int8")
        out[kind] = (port, jax)
    return out


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_both_exports_read_back_equal_through_both_readers(exports, kind):
    port_path, jax_path = exports[kind]
    reads = [reader(path) for path in (port_path, jax_path)
             for reader in (read_reference_tflite, jax_read_tflite)]
    params, meta, geometry = reads[0]
    for other in reads[1:]:
        assert_trees_equal(other[0], params)
        assert other[1] == meta and other[2] == geometry
    assert geometry == {"n_input": 26, "n_context": 9, "n_hidden": 64, "n_cell_dim": 64,
                        "n_out": 29, "n_steps": N_STEPS, "layer_norm": False}
    assert meta["version"] == 6 and meta["sample_rate"] == 16000
    assert meta["beam_width"] == 500
    assert Alphabet.deserialize(meta["alphabet_serialized"]).labels == fixture.LABELS
    if kind == "f32":
        assert_trees_equal(params, fixture.fixture_params())
    else:  # dequantized int8: close to the weights, not equal
        want = fixture.fixture_params()
        err = max(np.abs(params[k]["w" if k != "lstm" else "kernel"]
                         - want[k]["w" if k != "lstm" else "kernel"]).max() for k in want)
        assert 0 < err < 0.05


def interpreter_forward(path: str, windowed: np.ndarray, c: np.ndarray, h: np.ndarray):
    interp = tf.lite.Interpreter(model_path=path)
    interp.allocate_tensors()
    inputs = {d["name"]: d["index"] for d in interp.get_input_details()}
    outputs = {d["name"]: d["index"] for d in interp.get_output_details()}
    interp.set_tensor(inputs["input_node"], windowed.astype(np.float32))
    interp.set_tensor(inputs["previous_state_c"], c)
    interp.set_tensor(inputs["previous_state_h"], h)
    interp.set_tensor(inputs["input_samples"], np.zeros(512, np.float32))
    interp.invoke()
    return tuple(interp.get_tensor(outputs[k]) for k in ("logits", "new_state_c", "new_state_h"))


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_interpreter_matches_the_port_forward_on_the_imported_weights(exports, kind):
    """The .tflite the port wrote, run by TensorFlow Lite, against the port's
    DeepSpeech on the CPU with the weights its reader imported (for int8,
    the dequantized ones: the interpreter's hybrid kernels quantize the
    activations too, so int8 is held to the int8 drift stt_tpu allows)."""
    path = exports[kind][0]
    params, _, geometry = read_reference_tflite(path)
    model = params_from_numpy(params, port_config(geometry))
    feats = np.random.RandomState(0).randn(1, 2 * N_STEPS, fixture.N_INPUT).astype(np.float32) * 0.5
    with torch.no_grad():
        logits, (c_port, h_port) = model(torch.from_numpy(feats))
        ours = torch.softmax(logits, -1)[0].numpy()
        windowed = create_overlapping_windows(torch.from_numpy(feats), fixture.N_CONTEXT).numpy()
    windowed = windowed.reshape(1, 2 * N_STEPS, WIDTH, fixture.N_INPUT)
    c = h = np.zeros((1, fixture.N_HIDDEN), np.float32)
    probs1, c, h = interpreter_forward(path, windowed[:, :N_STEPS], c, h)
    probs2, c, h = interpreter_forward(path, windowed[:, N_STEPS:], c, h)
    theirs = np.concatenate([probs1, probs2])
    if kind == "f32":
        np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(c_port[0].numpy(), c[0], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(h_port[0].numpy(), h[0], rtol=RTOL, atol=ATOL)
    else:  # stt_tpu's test_quantized_artifact_import bound
        assert np.abs(ours - theirs).max() < 0.05


def test_tf_checkpoint_import_equals_stt_tpu(tmp_path):
    path = make_reference_checkpoint(tmp_path)
    params = tf_checkpoint.load_reference_checkpoint(path)
    want = jax_tf_checkpoint.load_reference_checkpoint(path)
    assert_trees_equal(params, want)
    geometry = tf_checkpoint.infer_geometry(params)
    assert geometry == jax_tf_checkpoint.infer_geometry(want)
    assert geometry == {"n_input": 26, "n_context": 9, "n_hidden": 64, "n_cell_dim": 64,
                        "n_out": 29, "layer_norm": False}
    feats = np.random.RandomState(1).randn(2, 12, 26).astype(np.float32)
    jax_logits, _ = apply_model(params, jnp.asarray(feats), config=JaxModelConfig(
        **{k: v for k, v in geometry.items() if k != "layer_norm"}, dropout_rates=(0.0,) * 6))
    with torch.no_grad():
        logits, _ = params_from_numpy(params, port_config(geometry))(torch.from_numpy(feats))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jax_logits), rtol=RTOL, atol=ATOL)


def test_params_from_reader_with_layer_norm_equals_stt_tpu():
    rng = np.random.RandomState(3)
    tensors = {}
    for layer, shape in (("layer_1", (494, 8)), ("layer_2", (8, 8)), ("layer_3", (8, 8)),
                         ("layer_5", (8, 8)), ("layer_6", (8, 5))):
        tensors[f"{layer}/weights"] = rng.randn(*shape)
        tensors[f"{layer}/bias"] = rng.randn(shape[1])
        tensors[f"{layer}/LayerNorm/gamma"] = rng.randn(shape[1])
        tensors[f"{layer}/LayerNorm/beta"] = rng.randn(shape[1])
    scope = "cudnn_lstm/rnn/multi_rnn_cell/cell_0/cudnn_compatible_lstm_cell"
    tensors[f"{scope}/kernel"] = rng.randn(16, 32)
    tensors[f"{scope}/bias"] = rng.randn(32)
    args = (tensors.__getitem__, tensors.__contains__)
    params = tf_checkpoint.params_from_reader(*args)
    assert_trees_equal(params, jax_tf_checkpoint.params_from_reader(*args))
    assert tf_checkpoint.infer_geometry(params)["layer_norm"] is True


# (n_input, n_context) -> the n_input the guess gives back: right at 26, and
# stt_tpu's wrong answer for 40 features with 5 frames of context, kept
@pytest.mark.parametrize("n_input,n_context,guess", [(26, 9, 26), (40, 5, 23)])
@pytest.mark.parametrize("package", ["stt_tpu_torch", "stt_tpu"])
def test_geometry_guess_is_stt_tpus(package, n_input, n_context, guess):
    module = tf_checkpoint if package == "stt_tpu_torch" else jax_tf_checkpoint
    window_input = (2 * n_context + 1) * n_input
    params = {"layer_1": {"w": np.zeros((window_input, 8), np.float32)},
              "lstm": {"kernel": np.zeros((16, 32), np.float32)},
              "layer_6": {"w": np.zeros((8, 5), np.float32)}}
    geometry = module.infer_geometry(params)
    assert geometry["n_input"] == guess
    assert geometry["n_context"] == (window_input // guess - 1) // 2


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_committed_fixture_is_what_the_exporter_writes(exports, kind):
    """chip_smoke.py serves tests/fixtures/reference_{kind}.tflite on the
    card, where no TensorFlow exists to write one: it must import to what
    the port's exporter writes from fixture_params() here."""
    committed = read_reference_tflite(fixture.PATHS[kind])
    fresh = read_reference_tflite(exports[kind][0])
    assert_trees_equal(committed[0], fresh[0])
    assert committed[1:] == fresh[1:]
    assert os.path.getsize(fixture.PATHS["f32"]) + os.path.getsize(fixture.PATHS["int8"]) < 1 << 20


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_committed_fixture_saved_as_artifact_serves_stt_tpus_forward(tmp_path, kind):
    """What chip_smoke.py serves on the card, here on the CPU: the fixture
    saved as the port's artifact opens in `Model` with the fixture's
    geometry, alphabet and feature settings, and its logits are
    stt_tpu.models.apply_model's on the imported weights."""
    params, meta, geometry = read_reference_tflite(fixture.PATHS[kind])
    path, saved_geometry = save_tflite_as_artifact(fixture.PATHS[kind], str(tmp_path / kind))
    assert saved_geometry == geometry
    model = Model(path, device="cpu")
    assert model.beam_width == meta["beam_width"]
    assert model.sample_rate() == meta["sample_rate"]
    assert model.alphabet.serialize() == meta["alphabet_serialized"]
    feats = np.random.RandomState(2).randn(2, 40, fixture.N_INPUT).astype(np.float32) * 0.5
    lengths = np.array([40, 27], np.int32)
    got = model.infer_logits(feats, lengths).numpy()
    config = JaxModelConfig(**{k: geometry[k] for k in ("n_input", "n_context", "n_hidden",
                                                         "n_cell_dim", "n_out")},
                            dropout_rates=(0.0,) * 6)
    want, _ = apply_model(params, jnp.asarray(feats), config=config,
                          seq_len=jnp.asarray(lengths))
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(got[i, :n], np.asarray(want)[i, :n], rtol=RTOL, atol=ATOL)
