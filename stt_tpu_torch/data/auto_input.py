"""Automatic dataset preparation from a single CSV: train/dev/test split
with a statistically meaningful dev/test size, plus alphabet generation
(parity: util/auto_input.py — 99% confidence sample sizing :30)."""

from __future__ import annotations

import csv
import math
import os
from typing import List, Tuple


def _required_sample_size(population: int, confidence_z: float = 2.58,
                          margin: float = 0.05, p: float = 0.5) -> int:
    """Sample size for a proportion estimate at the given confidence
    (default 99% / 5% margin), finite-population corrected."""
    if population <= 0:
        return 0
    n0 = (confidence_z**2) * p * (1 - p) / (margin**2)
    n = n0 / (1 + (n0 - 1) / population)
    return max(1, min(population, math.ceil(n)))


def create_datasets_from_auto_input(
    csv_path: str, output_dir: str | None = None, seed: int = 563
) -> Tuple[str, str, str]:
    """Split one CSV into {base}-train.csv, {base}-dev.csv, {base}-test.csv."""
    import random

    with open(csv_path, newline="", encoding="utf-8") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = list(reader)
    random.Random(seed).shuffle(rows)
    n = len(rows)
    holdout = _required_sample_size(n)
    holdout = min(holdout, n // 3 or 1)
    dev, test = rows[:holdout], rows[holdout : 2 * holdout]
    train = rows[2 * holdout :]
    base = os.path.splitext(csv_path)[0]
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        base = os.path.join(output_dir, os.path.basename(base))
    paths = []
    for name, subset in (("train", train), ("dev", dev), ("test", test)):
        path = f"{base}-{name}.csv"
        with open(path, "w", newline="", encoding="utf-8") as f:
            writer = csv.writer(f)
            writer.writerow(header)
            writer.writerows(subset)
        paths.append(path)
    return tuple(paths)


def create_alphabet_from_sources(csv_paths: List[str], output_path: str) -> str:
    chars = set()
    for path in csv_paths:
        with open(path, newline="", encoding="utf-8") as f:
            for row in csv.DictReader(f):
                chars.update(row.get("transcript", ""))
    from stt_tpu_torch.alphabet import Alphabet

    alphabet = Alphabet().init_from_labels(sorted(chars))
    with open(output_path, "w", encoding="utf-8") as f:
        f.write(alphabet.serialize_text())
    return output_path
