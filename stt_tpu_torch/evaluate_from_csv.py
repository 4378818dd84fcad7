"""Compute WER/CER between two transcript CSV files — e.g. a ground-truth
CSV and a CSV of transcriptions produced elsewhere (parity:
evaluate_from_csv.py). The port's copy of `stt_tpu/evaluate_from_csv.py`;
it runs on the host alone.

Run: python -m stt_tpu_torch.evaluate_from_csv --ref ref.csv --hyp hyp.csv \
       [--ref-field transcript] [--hyp-field transcript]
"""

from __future__ import annotations

import argparse
import csv

from stt_tpu_torch.evaluate_tools import calculate_and_print_report, process_decode_result


def evaluate_from_csv(
    ref_csv: str,
    hyp_csv: str,
    ref_field: str = "transcript",
    hyp_field: str = "transcript",
    join_field: str = "wav_filename",
):
    def load(path, field):
        out = {}
        with open(path, newline="", encoding="utf-8") as f:
            for row in csv.DictReader(f):
                out[row[join_field]] = row[field]
        return out

    refs = load(ref_csv, ref_field)
    hyps = load(hyp_csv, hyp_field)
    results = []
    for key, ref in refs.items():
        if key not in hyps:
            continue
        results.append(process_decode_result(key, ref, hyps[key], 0.0))
    calculate_and_print_report(results, dataset_name=f"{ref_csv} vs {hyp_csv}")
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ref", required=True)
    parser.add_argument("--hyp", required=True)
    parser.add_argument("--ref-field", default="transcript")
    parser.add_argument("--hyp-field", default="transcript")
    parser.add_argument("--join-field", default="wav_filename")
    # taken for a command line like the other entry points'; nothing here
    # runs on a device
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    evaluate_from_csv(
        args.ref, args.hyp, args.ref_field, args.hyp_field, args.join_field
    )


if __name__ == "__main__":
    main()
