"""Evaluate an EXPORTED model artifact through the serving stack on a test
CSV (the counterpart of `stt_tpu.evaluate_export`, itself the counterpart
of the reference's evaluate_export.py / evaluate_tflite.py): each sample
goes through `Model.stt` (a stream: the inference kernel K1 on the card,
the native decoder on the host), then the WER/CER report.

Run: python -m stt_tpu_torch.evaluate_export --model_dir exported \\
       --csv test.csv [--scorer_path x.scorer] [--beam_width N] [--device cpu]
"""

from __future__ import annotations

import argparse

from stt_tpu_torch.data.sources import CSVSource
from stt_tpu_torch.evaluate_tools import (
    calculate_and_print_report,
    process_decode_result,
    save_samples_json,
)


def evaluate_export(
    model_dir: str,
    csv_path: str,
    scorer_path: str = "",
    lm_alpha=None,
    lm_beta=None,
    beam_width: int = 0,
    output_file: str = "",
    device="cuda",
):
    """Runs on the card unless the caller passes device="cpu"."""
    from stt_tpu_torch.serve import Model

    model = Model(model_dir, device=device)
    if beam_width:
        model.set_model_beam_width(beam_width)
    if scorer_path:
        model.enable_external_scorer(scorer_path)
        if lm_alpha is not None and lm_beta is not None:
            model.set_scorer_alpha_beta(lm_alpha, lm_beta)
    results = []
    for sample in CSVSource(csv_path):
        hyp = model.stt(sample.audio)
        results.append(
            process_decode_result(sample.sample_id, sample.transcript, hyp, 0.0)
        )
    calculate_and_print_report(results, dataset_name=csv_path)
    if output_file:
        save_samples_json(results, output_file)
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model_dir", required=True)
    parser.add_argument("--csv", required=True)
    parser.add_argument("--scorer_path", default="")
    parser.add_argument("--lm_alpha", type=float, default=None)
    parser.add_argument("--lm_beta", type=float, default=None)
    parser.add_argument("--beam_width", type=int, default=0)
    parser.add_argument("--test_output_file", default="")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda)")
    args = parser.parse_args(argv)
    evaluate_export(
        args.model_dir, args.csv, args.scorer_path, args.lm_alpha,
        args.lm_beta, args.beam_width, args.test_output_file, args.device,
    )


if __name__ == "__main__":
    main()
