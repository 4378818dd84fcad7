"""The committed reference-format .tflite fixtures (tests/fixtures/), f32
and int8 (dynamic-range), written by stt_tpu_torch's own exporter from
seeded parameters at tests/test_tflite_interop.py's geometry. The card's
machine has no TensorFlow: `python3 chip_smoke.py` imports these files with
the port's reader and serves them. tests/test_torch_compat.py holds them
to what the exporter writes from `fixture_params()` now.

Regenerate (needs TensorFlow): python tests/torch_tflite_fixture.py
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
PATHS = {"f32": os.path.join(FIXTURES, "reference_f32.tflite"),
         "int8": os.path.join(FIXTURES, "reference_int8.tflite")}
N_INPUT, N_CONTEXT, N_HIDDEN, N_OUT, N_STEPS = 26, 9, 64, 29, 16
LABELS = list(" abcdefghijklmnopqrstuvwxyz'")
SEED = 12


def fixture_params() -> dict:
    """The fixtures' parameters, {layer: {leaf: float32 array}}."""
    rng = np.random.RandomState(SEED)
    window_input = (2 * N_CONTEXT + 1) * N_INPUT
    dims = {"layer_1": (window_input, N_HIDDEN), "layer_2": (N_HIDDEN, N_HIDDEN),
            "layer_3": (N_HIDDEN, N_HIDDEN), "layer_5": (N_HIDDEN, N_HIDDEN),
            "layer_6": (N_HIDDEN, N_OUT)}
    params = {}
    for layer, (n_in, n_out) in dims.items():
        params[layer] = {"w": (rng.randn(n_in, n_out) / np.sqrt(n_in)).astype(np.float32),
                         "b": (rng.randn(n_out) * 0.05).astype(np.float32)}
    params["lstm"] = {
        "kernel": (rng.randn(2 * N_HIDDEN, 4 * N_HIDDEN) / np.sqrt(2 * N_HIDDEN)).astype(np.float32),
        "bias": (rng.randn(4 * N_HIDDEN) * 0.05).astype(np.float32),
    }
    return params


def write(path: str, quantize: bool) -> str:
    sys.path.insert(0, ROOT)
    from stt_tpu_torch.alphabet import Alphabet
    from stt_tpu_torch.compat.tflite_export import export_reference_tflite

    alphabet = Alphabet().init_from_labels(LABELS)
    return export_reference_tflite(fixture_params(), alphabet, path, n_steps=N_STEPS,
                                   quantize=quantize)


if __name__ == "__main__":
    os.makedirs(FIXTURES, exist_ok=True)
    for kind, path in PATHS.items():
        write(path, quantize=kind == "int8")
        print(path, os.path.getsize(path))
