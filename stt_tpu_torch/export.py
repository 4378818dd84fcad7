"""Export a trained checkpoint as a deployable model artifact (the
counterpart of `stt_tpu.export`).

The artifact is stt_tpu's: weights.npz + metadata.json + alphabet.txt
(`stt_tpu_torch.artifact`), with MODEL_CARD.md beside them, byte-equal to
what stt_tpu writes for the same weights; `--export_zip` packs it into one
.sttpkg file and `--export_quantize` stores int8 weights. Either package's
`Model` loads it. `--export_tflite` also writes the reference-format
output_graph.tflite beside it (`stt_tpu_torch.compat.tflite_export`; int8
dynamic-range with `--export_quantize`), which needs TensorFlow: without
it the export raises TensorFlow's ImportError.

Run: python -m stt_tpu_torch.export --checkpoint_dir ... --export_dir ...
     [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

from stt_tpu_torch.artifact import build_metadata, package_zip, params_to_numpy, save_artifact
from stt_tpu_torch.config import SttConfig, initialize_globals_from_cli, log_info
from stt_tpu_torch.device import resolve_device
from stt_tpu_torch.train.checkpoints import CheckpointManager, load_graph_for_evaluation
from stt_tpu_torch.train.step import create_train_state


def export(config: SttConfig, device="cuda") -> str:
    """Load the checkpoint `--load_evaluate` names onto `device` (the card
    unless the caller passes "cpu") and write the artifact; returns its
    directory, or the .sttpkg path with `--export_zip`."""
    device = resolve_device(device)
    alphabet = config.resolve_alphabet()
    model_config = config.model_config(training=False)
    state = create_train_state(model_config, device=device)
    manager = CheckpointManager(config.load_checkpoint_dir)
    state, method = load_graph_for_evaluation(manager, state, config.load_evaluate)
    log_info(f"Exporting '{method}' checkpoint (step {state.step})")
    metadata = build_metadata(
        model_config,
        config.feature_config,
        alphabet,
        beam_width=config.export_beam_width,
        lm_alpha=config.lm_alpha,
        lm_beta=config.lm_beta,
        model_name=config.export_model_name,
        author=config.export_author_id,
        license_str=config.export_license,
        language=config.export_language,
    )
    out = save_artifact(
        config.export_dir, state.model, metadata, alphabet, quantize=config.export_quantize
    )
    write_model_card(config, metadata, out)
    log_info(f"Exported model artifact to {out}")
    if config.export_tflite:
        from stt_tpu_torch.compat.tflite_export import export_reference_tflite

        tflite_path = os.path.join(
            out, (config.export_file_name or "output_graph") + ".tflite"
        )
        export_reference_tflite(
            params_to_numpy(state.model), alphabet, tflite_path,
            n_steps=config.n_steps,
            sample_rate=config.feature_config.sample_rate,
            feature_win_len_ms=config.feature_win_len,
            feature_win_step_ms=config.feature_win_step,
            export_beam_width=config.export_beam_width,
            language=config.export_language,
            quantize=config.export_quantize,
        )
        log_info(
            f"Exported reference-format TFLite artifact to {tflite_path} "
            "(loadable by the reference C++ runtime)"
        )
    if config.export_zip:
        zip_path = package_zip(out)
        log_info(f"Packaged {zip_path}")
        return zip_path
    return out


def write_model_card(config: SttConfig, metadata: dict, out_dir: str) -> str:
    """Model-card markdown beside the artifact, as stt_tpu writes it (its
    "Framework: stt_tpu" line included: the artifact format is stt_tpu's,
    whichever package exported it)."""
    path = os.path.join(out_dir, "MODEL_CARD.md")
    with open(path, "w") as f:
        f.write(
            f"# Model card for {config.export_model_name}\n\n"
            f"- Author: {config.export_author_id or 'unknown'}\n"
            f"- Model version: {config.export_model_version}\n"
            f"- Language: {config.export_language or 'unspecified'}\n"
            f"- License: {config.export_license or 'unspecified'}\n"
            f"- Framework: stt_tpu {metadata['framework_version']} "
            f"(graph v{metadata['graph_version']})\n\n"
            f"## Geometry\n\n"
            f"- n_hidden: {metadata['n_hidden']}\n"
            f"- alphabet size + blank: {metadata['n_out']}\n"
            f"- sample rate: {metadata['sample_rate']} Hz, "
            f"{metadata['feature_win_len_ms']} ms window / "
            f"{metadata['feature_win_step_ms']} ms step, "
            f"{metadata['n_mfcc']} MFCCs\n\n"
            f"## Decoder defaults\n\n"
            f"- beam width: {metadata['beam_width']}\n"
            f"- lm_alpha: {metadata['lm_alpha']}\n"
            f"- lm_beta: {metadata['lm_beta']}\n"
        )
    return path


def main(argv=None):
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default="cuda")
    args, rest = parser.parse_known_args(argv)
    config = initialize_globals_from_cli(rest)
    if not config.export_dir:
        print("--export_dir is required", file=sys.stderr)
        sys.exit(1)
    export(config, device=args.device)


if __name__ == "__main__":
    main()
