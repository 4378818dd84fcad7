"""Corpus duration statistics from CSV files (parity: stats.py).

Run: python -m stt_tpu_torch.tools.stats -csv train.csv,dev.csv
"""

from __future__ import annotations

import argparse
import csv
from dataclasses import dataclass


@dataclass
class CorpusStats:
    n_samples: int
    total_bytes: int
    total_seconds: float

    @property
    def total_hours(self) -> float:
        return self.total_seconds / 3600


def compute_stats(
    csv_files, sample_rate=16000, channels=1, bits_per_sample=16
) -> CorpusStats:
    n, total_bytes = 0, 0
    for path in csv_files:
        with open(path, newline="", encoding="utf-8") as f:
            for row in csv.DictReader(f):
                n += 1
                total_bytes += int(row.get("wav_filesize", 0) or 0)
    bytes_per_second = sample_rate * channels * bits_per_sample // 8
    # subtract the 44-byte wav header per file
    audio_bytes = max(0, total_bytes - 44 * n)
    return CorpusStats(n, total_bytes, audio_bytes / bytes_per_second)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-csv", "--csv-files", required=True)
    parser.add_argument("--sample-rate", type=int, default=16000)
    parser.add_argument("--channels", type=int, default=1)
    parser.add_argument("--bits-per-sample", type=int, default=16)
    args = parser.parse_args(argv)
    stats = compute_stats(
        args.csv_files.split(","),
        args.sample_rate,
        args.channels,
        args.bits_per_sample,
    )
    print(f"Total samples: {stats.n_samples}")
    print(f"Total time: {stats.total_hours:.2f} h "
          f"({stats.total_seconds:.0f} s)")
    return stats


if __name__ == "__main__":
    main()
