"""WER/CER reporting: sample-level metrics, best/median/worst report,
JSON dump. The port's copy of `stt_tpu/evaluate_tools.py`: the report text
and the samples JSON are byte-equal to stt_tpu's (parity:
util/evaluate_tools.py)."""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Optional

from stt_tpu_torch.config import log_info
from stt_tpu_torch.text import char_distance, wer_cer_batch, word_distance


@dataclass
class SampleResult:
    sample_id: str
    src: str  # reference transcript
    res: str  # hypothesis
    loss: float
    wer: float
    cer: float

    def to_dict(self):
        return {
            "wav_filename": self.sample_id,
            "src": self.src,
            "res": self.res,
            "loss": self.loss,
            "wer": self.wer,
            "cer": self.cer,
        }


def process_decode_result(sample_id: str, src: str, res: str, loss: float) -> SampleResult:
    wd, wn = word_distance(src, res)
    cd, cn = char_distance(src, res)
    return SampleResult(
        sample_id=sample_id,
        src=src,
        res=res,
        loss=loss,
        wer=wd / max(wn, 1),
        cer=cd / max(cn, 1),
    )


def calculate_and_print_report(
    results: List[SampleResult],
    dataset_name: str = "test",
    report_count: int = 5,
) -> tuple:
    """Corpus WER/CER + best/median/worst sample listing
    (evaluate_tools.py:77-151)."""
    wer, cer = wer_cer_batch(
        [r.src for r in results], [r.res for r in results]
    )
    mean_loss = (
        sum(r.loss for r in results) / len(results) if results else float("nan")
    )
    log_info("-" * 80)
    log_info(
        f"Test on {dataset_name} - WER: {wer:.6f}, CER: {cer:.6f}, "
        f"loss: {mean_loss:.6f}"
    )
    ordered = sorted(results, key=lambda r: (r.wer, r.cer))
    n = min(report_count, len(ordered))
    sections = [
        ("Best", ordered[:n]),
        ("Median", ordered[(len(ordered) - n) // 2 : (len(ordered) + n) // 2]),
        ("Worst", ordered[-n:]),
    ]
    for title, subset in sections:
        log_info("-" * 80)
        log_info(f"{title} WER:")
        for r in subset:
            log_info(
                f"WER: {r.wer:.6f}, CER: {r.cer:.6f}, loss: {r.loss:.6f}"
            )
            log_info(f" - wav: {r.sample_id}")
            log_info(f" - src: {r.src!r}")
            log_info(f" - res: {r.res!r}")
    log_info("-" * 80)
    return wer, cer, mean_loss


def save_samples_json(results: List[SampleResult], output_path: str) -> None:
    with open(output_path, "w") as f:
        json.dump([r.to_dict() for r in results], f, indent=2)
