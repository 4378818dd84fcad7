"""Reference `.tflite` model-artifact interop (export side).

Builds a REFERENCE-FORMAT TFLite model from a parameter tree of numpy
arrays (the port's copy of `stt_tpu.compat.tflite_export`; the port's
module gives its tree as `{layer: {leaf: array}}` from its state_dict,
see `stt_tpu_torch.artifact.params_to_numpy`): the exact
named-tensor API boundary the reference's C++ runtime loads by name
(native_client/tflitemodelstate.cc:211-303) — `input_node
[1, n_steps, 2*n_context+1, n_input]`, `previous_state_c/h [1, n_cell]`,
`input_samples [audio_window]` -> `logits [n_steps, n_out] (softmax)`,
`new_state_c/h`, `mfccs`, plus the `metadata_*` constant outputs
(export.py:57-77: graph version 6, sample rate, feature win len/step ms,
export beam width, binary-serialized alphabet). A model trained in this
framework therefore runs unmodified on the reference's deployment stack
(and anything else that speaks its artifact format).

TensorFlow (in-image, CPU) is used as the flatbuffer builder — the same
role the reference uses it for at export time (export.py:126-150); it is
imported lazily and only here, so on a machine without TensorFlow a call
raises its ImportError. The graph mirrors
deepspeech_model.create_inference_graph(tflite=True): static_rnn
unrolled over n_steps with the [n_in+H, 4H] icfo kernel, clipped-relu
denses, softmax output, AudioSpectrogram/Mfcc custom-op feature
subgraph. `quantize=True` applies Optimize.DEFAULT dynamic-range
quantization, the reference's default export flavor.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def export_reference_tflite(
    params: Dict,
    alphabet,
    path: str,
    n_steps: int = 16,
    sample_rate: int = 16000,
    feature_win_len_ms: int = 32,
    feature_win_step_ms: int = 20,
    export_beam_width: int = 500,
    graph_version: int = 6,
    language: str = "",
    quantize: bool = False,
) -> str:
    """Write a reference-format .tflite; returns `path`."""
    import tensorflow as tf

    v1 = tf.compat.v1

    p = {
        k: {kk: np.asarray(vv, np.float32) for kk, vv in v.items()}
        for k, v in params.items()
    }
    window_input, n_hidden = p["layer_1"]["w"].shape
    n_cell = p["lstm"]["kernel"].shape[1] // 4
    n_out = p["layer_6"]["w"].shape[1]
    # stt_tpu's guess, kept as it is: right at n_input 26, wrong for other
    # geometries (n_input 40 with n_context 5 gives 23; ROADMAP.md)
    n_input = 26 if window_input % 26 == 0 else window_input // 19
    window = window_input // n_input
    win_samples = sample_rate * feature_win_len_ms // 1000
    step_samples = sample_rate * feature_win_step_ms // 1000

    g = tf.Graph()
    with g.as_default():
        # feature subgraph (deepspeech_model.py:274-282): custom ops with
        # built-in TFLite kernels, exactly what the reference exports
        input_samples = v1.placeholder(
            tf.float32, [win_samples], "input_samples"
        )
        samples = tf.expand_dims(input_samples, -1)
        spec = tf.raw_ops.AudioSpectrogram(
            input=samples, window_size=win_samples, stride=step_samples,
            magnitude_squared=True,
        )
        mfccs_t = tf.raw_ops.Mfcc(
            spectrogram=spec, sample_rate=sample_rate,
            upper_frequency_limit=sample_rate / 2,
            lower_frequency_limit=20, filterbank_channel_count=40,
            dct_coefficient_count=n_input,
        )
        mfccs = tf.identity(
            tf.reshape(mfccs_t, [-1, n_input]), name="mfccs"
        )

        input_node = v1.placeholder(
            tf.float32, [1, n_steps, window, n_input], name="input_node"
        )
        prev_c = v1.placeholder(tf.float32, [1, n_cell],
                                name="previous_state_c")
        prev_h = v1.placeholder(tf.float32, [1, n_cell],
                                name="previous_state_h")

        def dense(name, x, relu=True):
            w = tf.constant(p[name]["w"])
            b = tf.constant(p[name]["b"])
            y = tf.nn.bias_add(tf.matmul(x, w), b)
            return tf.minimum(tf.nn.relu(y), 20.0) if relu else y

        x = tf.reshape(input_node, [n_steps, window * n_input])
        x = dense("layer_1", x)
        x = dense("layer_2", x)
        x = dense("layer_3", x)
        # static_rnn twin (deepspeech_model.py:144-170): unrolled
        # LSTMCell, [n_in+H, 4H] kernel, gate order i, j(g), f, o
        kernel = tf.constant(p["lstm"]["kernel"])
        bias = tf.constant(p["lstm"]["bias"])
        c_t, h_t = prev_c, prev_h
        outs = []
        for t in range(n_steps):
            gates = tf.matmul(tf.concat([x[t : t + 1], h_t], 1), kernel)
            gates = tf.nn.bias_add(gates, bias)
            gi, gj, gf, go = tf.split(gates, 4, axis=1)
            c_t = tf.sigmoid(gf) * c_t + tf.sigmoid(gi) * tf.tanh(gj)
            h_t = tf.sigmoid(go) * tf.tanh(c_t)
            outs.append(h_t)
        h = tf.concat(outs, 0)
        new_c = tf.identity(c_t, name="new_state_c")
        new_h = tf.identity(h_t, name="new_state_h")
        x = dense("layer_5", h)
        x = dense("layer_6", x, relu=False)
        probs = tf.nn.softmax(x, name="logits")

        meta = [
            tf.constant([graph_version], name="metadata_version"),
            tf.constant([sample_rate], name="metadata_sample_rate"),
            tf.constant([feature_win_len_ms],
                        name="metadata_feature_win_len"),
            tf.constant([feature_win_step_ms],
                        name="metadata_feature_win_step"),
            tf.constant([export_beam_width], name="metadata_beam_width"),
            tf.constant([alphabet.serialize()], name="metadata_alphabet"),
        ]
        if language:
            meta.append(tf.constant([language.encode("utf-8")],
                                    name="metadata_language"))

        outputs = [probs, new_c, new_h, mfccs] + meta
        inputs = [input_node, prev_c, prev_h, input_samples]
        with v1.Session(graph=g) as sess:
            frozen = v1.graph_util.convert_variables_to_constants(
                sess, g.as_graph_def(), [t.op.name for t in outputs]
            )
    converter = v1.lite.TFLiteConverter(
        frozen, input_tensors=inputs, output_tensors=outputs
    )
    converter.allow_custom_ops = True  # AudioSpectrogram / Mfcc
    if quantize:
        converter.optimizations = [tf.lite.Optimize.DEFAULT]
    flatbuffer = converter.convert()
    with open(path, "wb") as f:
        f.write(flatbuffer)
    return path
