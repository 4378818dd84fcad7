"""Import reference (Coqui STT / TF1) training checkpoints into a parameter
tree of numpy arrays (the port's copy of `stt_tpu.compat.tf_checkpoint`):
models trained by the reference can be evaluated, served and fine-tuned by
the port (`stt_tpu_torch.artifact.params_from_numpy` makes the module).

Variable mapping (deepspeech_model.py:66-98 scopes; gate order is TF
LSTMCell "i, j(g), f, o", which is exactly this framework's layout so
the LSTM kernel/bias transfer untouched):

  layer_1/weights, layer_1/bias             -> layer_1/w, layer_1/b
  layer_2/*, layer_3/*, layer_5/*, layer_6/* likewise
  cudnn_lstm/rnn/multi_rnn_cell/cell_0/cudnn_compatible_lstm_cell/kernel
                                             -> lstm/kernel
  .../bias                                   -> lstm/bias
  (optional layer norm: layer_N/LayerNorm/{gamma,beta} -> ln_scale/ln_bias)
"""

from __future__ import annotations

from typing import Dict

import numpy as np

_LSTM_SCOPE = "cudnn_lstm/rnn/multi_rnn_cell/cell_0/cudnn_compatible_lstm_cell"

_DENSE_LAYERS = ("layer_1", "layer_2", "layer_3", "layer_5", "layer_6")


def params_from_reader(get_tensor, has_tensor) -> Dict:
    """Build a params pytree from accessor callables (decoupled from TF)."""
    params: Dict = {}
    for layer in _DENSE_LAYERS:
        entry = {
            "w": np.asarray(get_tensor(f"{layer}/weights"), np.float32),
            "b": np.asarray(get_tensor(f"{layer}/bias"), np.float32),
        }
        gamma = f"{layer}/LayerNorm/gamma"
        if has_tensor(gamma):
            entry["ln_scale"] = np.asarray(get_tensor(gamma), np.float32)
            entry["ln_bias"] = np.asarray(
                get_tensor(f"{layer}/LayerNorm/beta"), np.float32
            )
        params[layer] = entry
    params["lstm"] = {
        "kernel": np.asarray(get_tensor(f"{_LSTM_SCOPE}/kernel"), np.float32),
        "bias": np.asarray(get_tensor(f"{_LSTM_SCOPE}/bias"), np.float32),
    }
    return params


def load_reference_checkpoint(checkpoint_path: str) -> Dict:
    """Read a TF checkpoint (index/data files) via the TF checkpoint
    reader. checkpoint_path is the prefix (e.g. .../best_dev-12345)."""
    import tensorflow as tf  # heavyweight; only needed for this bridge

    reader = tf.train.load_checkpoint(checkpoint_path)
    shapes = reader.get_variable_to_shape_map()
    return params_from_reader(
        reader.get_tensor, lambda name: name in shapes
    )


def infer_geometry(params: Dict) -> Dict:
    """Derive the ModelConfig geometry from imported shapes (mirrors the
    reference reading n_hidden back from checkpoints, config.py:239-260)."""
    window_input, n_hidden = params["layer_1"]["w"].shape
    n_cell = params["lstm"]["kernel"].shape[1] // 4
    n_out = params["layer_6"]["w"].shape[1]
    # stt_tpu's guess, kept as it is: right at n_input 26, wrong for other
    # geometries (n_input 40 with n_context 5 gives 23; ROADMAP.md)
    n_input = 26 if window_input % 26 == 0 else window_input // 19
    n_context = (window_input // n_input - 1) // 2
    return {
        "n_input": n_input,
        "n_context": n_context,
        "n_hidden": n_hidden,
        "n_cell_dim": n_cell,
        "n_out": n_out,
        "layer_norm": "ln_scale" in params["layer_1"],
    }
