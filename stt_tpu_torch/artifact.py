"""Exported model artifact, in the format of `stt_tpu.artifact`, so one
artifact loads in both packages.

A directory (or a single .sttpkg zip of the same entries):
  weights.npz     flat params, keys "layer_1/w", "lstm/kernel", ...
                  (or, when metadata says "quantized", the int8
                  weight-only form of stt_tpu.ops.quant.flatten_weight_only)
  metadata.json   graph/geometry/feature/decoder metadata
  alphabet.txt    alphabet config (bytes mode: marker comment only)
"""

from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from stt_tpu_torch import GRAPH_VERSION, __version__
from stt_tpu_torch.alphabet import Alphabet, UTF8Alphabet
from stt_tpu_torch.compat.tflite import read_reference_tflite
from stt_tpu_torch.frontend import FeatureConfig
from stt_tpu_torch.models import DeepSpeech, ModelConfig

DENSE = ("layer_1", "layer_2", "layer_3", "layer_5", "layer_6")
PACKAGE_EXT = ".sttpkg"


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    out: Dict = {}
    for name, value in flat.items():
        node = out
        parts = name.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return out


def dequantize_flat(flat: Dict[str, np.ndarray]) -> Dict:
    """int8 weight-only artifact entries -> f32 parameter tree (a copy of
    stt_tpu.ops.quant.dequantize_flat): per-channel int8 dense and W_x
    weights times their scales; W_h kept in float16."""
    params: Dict = {}
    for name in DENSE:
        layer = {
            "w": flat[f"{name}/w_q"].astype(np.float32) * flat[f"{name}/w_scale"],
            "b": flat[f"{name}/b"],
        }
        if f"{name}/ln_scale" in flat:
            layer["ln_scale"] = flat[f"{name}/ln_scale"]
            layer["ln_bias"] = flat[f"{name}/ln_bias"]
        params[name] = layer
    w_x = flat["lstm/w_x_q"].astype(np.float32) * flat["lstm/w_x_scale"]
    w_h = flat["lstm/w_h_f16"].astype(np.float32)
    params["lstm"] = {
        "kernel": np.concatenate([w_x, w_h], axis=0),
        "bias": flat["lstm/bias"],
    }
    return params


def params_from_numpy(
    params: Dict, config: ModelConfig, device="cpu"
) -> DeepSpeech:
    """The JAX package's parameter tree (nested dicts of numpy arrays, as
    `jax.device_get(init_params(...))` or `load_artifact` give them) -> a
    DeepSpeech on `device` computing the same function."""
    model = DeepSpeech(config, device=device)
    flat = {}
    for layer, leaves in params.items():
        for leaf, value in leaves.items():
            flat[f"{layer}/{leaf}"] = torch.tensor(np.asarray(value, np.float32))
    model.load_state_dict(flat)
    return model


def params_to_numpy(model: DeepSpeech) -> Dict:
    """The inverse of `params_from_numpy`: `model`'s parameters as the JAX
    package's tree, {"layer_1": {"w": array, "b": array}, ..., "lstm":
    {"kernel": array, "bias": array}}, float32 numpy arrays on the host."""
    return _unflatten({k: v.detach().cpu().numpy() for k, v in model.state_dict().items()})


def qparams_from_numpy(qparams: Dict, device="cpu") -> Dict:
    """The JAX package's `quantize_params` output (its QuantizedDense leaves
    and arrays, read as numpy; the `x_scale` floats as they are) -> the
    port's quantized parameters on `device`. The full-precision "lstm"
    entry, which only the JAX package's scan fallback reads, is dropped."""
    from stt_tpu_torch.ops.lstm_kernel import pack_w_h_q
    from stt_tpu_torch.ops.quant import QuantizedDense

    def tensor(value, dtype) -> torch.Tensor:
        return torch.tensor(np.asarray(value, dtype), device=device)

    out: Dict = {}
    for name in (*DENSE, "lstm_in"):
        q = qparams[name]
        out[name] = QuantizedDense(
            tensor(q.w_q, np.int8), tensor(q.w_scale, np.float32),
            tensor(q.b, np.float32), float(q.x_scale),
        )
    w_h_q = tensor(qparams["lstm_rec"]["w_h_q"], np.int8)
    out["lstm_rec"] = {
        "w_h_q": w_h_q,
        "step_scale": tensor(qparams["lstm_rec"]["step_scale"], np.float32),
        "w_h_q_packed": pack_w_h_q(w_h_q),
    }
    return out


def build_metadata(
    model_config: ModelConfig,
    feature_config: FeatureConfig,
    alphabet: Alphabet,
    beam_width: int = 500,
    lm_alpha: float = 0.931289039105002,
    lm_beta: float = 1.1834137581510284,
    model_name: str = "stt-tpu-model",
    author: str = "",
    license_str: str = "",
    language: str = "",
) -> dict:
    return {
        "format": "stt_tpu",
        "framework_version": __version__,
        "graph_version": GRAPH_VERSION,
        "model_name": model_name,
        "author": author,
        "license": license_str,
        "language": language,
        "sample_rate": feature_config.sample_rate,
        "feature_win_len_ms": feature_config.window_samples
        * 1000
        // feature_config.sample_rate,
        "feature_win_step_ms": feature_config.step_samples
        * 1000
        // feature_config.sample_rate,
        "n_input": model_config.n_input,
        "n_context": model_config.n_context,
        "n_hidden": model_config.n_hidden,
        "n_cell_dim": model_config.n_cell_dim,
        "n_out": model_config.n_out,
        "relu_clip": model_config.relu_clip,
        "layer_norm": model_config.layer_norm,
        "beam_width": beam_width,
        "lm_alpha": lm_alpha,
        "lm_beta": lm_beta,
        "bytes_output_mode": isinstance(alphabet, UTF8Alphabet),
        "n_mels": feature_config.n_mels,
        "n_mfcc": feature_config.n_mfcc,
    }


def save_artifact(
    out_dir: str,
    model: DeepSpeech,
    metadata: dict,
    alphabet: Alphabet,
    quantize: bool = False,
) -> str:
    """Write `model`'s weights, the metadata and the alphabet into
    `out_dir`. quantize=True stores int8 weights and per-channel scales (a
    4x smaller file, marked "quantized" in the metadata); `load_artifact`
    dequantizes them."""
    os.makedirs(out_dir, exist_ok=True)
    if quantize:
        from stt_tpu_torch.ops.quant import flatten_weight_only

        metadata = dict(metadata, quantized=True)
        flat = flatten_weight_only(model.state_dict(), n_cell=metadata["n_cell_dim"])
    else:
        flat = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    np.savez(os.path.join(out_dir, "weights.npz"), **flat)
    with open(os.path.join(out_dir, "metadata.json"), "w") as f:
        json.dump(metadata, f, indent=2)
    with open(os.path.join(out_dir, "alphabet.txt"), "w") as f:
        if isinstance(alphabet, UTF8Alphabet):
            f.write("# bytes output mode\n")
        else:
            f.write(alphabet.serialize_text())
    return out_dir


def save_tflite_as_artifact(tflite_path: str, out_dir: str) -> Tuple[str, Dict]:
    """A reference `.tflite`, imported by `compat.tflite.read_reference_tflite`
    (int8 weights dequantized), saved as an artifact in `out_dir` that
    `serve.Model` loads: (the artifact's path, the import's geometry)."""
    params, meta, geometry = read_reference_tflite(tflite_path)
    config = ModelConfig(n_input=geometry["n_input"], n_context=geometry["n_context"],
                         n_hidden=geometry["n_hidden"], n_cell_dim=geometry["n_cell_dim"],
                         n_out=geometry["n_out"], dropout_rates=(0.0,) * 6)
    fc = FeatureConfig.from_ms(meta["sample_rate"], meta["feature_win_len"],
                               meta["feature_win_step"], n_mfcc=geometry["n_input"])
    alphabet = Alphabet.deserialize(meta["alphabet_serialized"])
    path = save_artifact(out_dir, params_from_numpy(params, config),
                         build_metadata(config, fc, alphabet, beam_width=meta["beam_width"]),
                         alphabet)
    return path, geometry


def package_zip(artifact_dir: str, zip_path: Optional[str] = None) -> str:
    """Bundle an artifact directory into one .sttpkg file, with the members
    stt_tpu.artifact.package_zip writes."""
    if zip_path is None:
        zip_path = artifact_dir.rstrip("/") + PACKAGE_EXT
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as zf:
        for name in ("weights.npz", "metadata.json", "alphabet.txt"):
            zf.write(os.path.join(artifact_dir, name), name)
    return zip_path


def load_artifact(path: str) -> Tuple[Dict, dict, Alphabet]:
    """Load a directory or .sttpkg -> (params tree of numpy arrays,
    metadata, alphabet); `params_from_numpy` turns the tree into a model."""
    if os.path.isdir(path):
        def read(name, mode="rb"):
            with open(os.path.join(path, name), mode) as f:
                return f.read()
    else:
        with zipfile.ZipFile(path, "r") as zf:
            entries = {name: zf.read(name) for name in zf.namelist()}

        def read(name, mode="rb"):
            data = entries[name]
            return data if mode == "rb" else data.decode("utf-8")

    metadata = json.loads(read("metadata.json", "r"))
    if metadata.get("format") != "stt_tpu":
        raise ValueError(f"{path} is not an stt_tpu model artifact")
    with np.load(io.BytesIO(read("weights.npz"))) as npz:
        flat = {k: npz[k] for k in npz.files}
    params = dequantize_flat(flat) if metadata.get("quantized") else _unflatten(flat)
    if metadata.get("bytes_output_mode"):
        alphabet: Alphabet = UTF8Alphabet()
    else:
        alphabet = Alphabet().init_from_text(read("alphabet.txt", "r"))
    return params, metadata, alphabet


def model_config_from_metadata(metadata: dict) -> ModelConfig:
    return ModelConfig(
        n_input=metadata["n_input"],
        n_context=metadata["n_context"],
        n_hidden=metadata["n_hidden"],
        n_cell_dim=metadata["n_cell_dim"],
        n_out=metadata["n_out"],
        relu_clip=metadata["relu_clip"],
        layer_norm=metadata["layer_norm"],
        dropout_rates=(0.0,) * 6,
    )


def feature_config_from_metadata(metadata: dict) -> FeatureConfig:
    rate = metadata["sample_rate"]
    return FeatureConfig(
        sample_rate=rate,
        window_samples=rate * metadata["feature_win_len_ms"] // 1000,
        step_samples=rate * metadata["feature_win_step_ms"] // 1000,
        n_mfcc=metadata.get("n_mfcc", 26),
        n_mels=metadata.get("n_mels", 40),
    )
