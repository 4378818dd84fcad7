"""Re-package datasets between formats (CSV <-> SDB) with optional
offline augmentation (parity: bin/data_set_tool.py).

Run: python -m stt_tpu_torch.tools.data_set_tool --sources in.csv --target out.sdb \
       [--augment volume[dbfs=-3]] [--unlabeled]
"""

from __future__ import annotations

import argparse
import os

from stt_tpu_torch.data.augmentations import (
    apply_sample_augmentations,
    parse_augmentations,
)
from stt_tpu_torch.data.sources import CSVWriter, SDBWriter, samples_from_sources


def convert(
    sources,
    target: str,
    augment_specs=None,
    labeled: bool = True,
) -> int:
    augmentations = parse_augmentations(augment_specs)
    for aug in augmentations:
        aug.start()
    ext = os.path.splitext(target)[1].lower()
    if ext == ".sdb":
        writer = SDBWriter(target, labeled=labeled)
    elif ext == ".csv":
        writer = CSVWriter(target, labeled=labeled)
    else:
        raise ValueError(f"unsupported target type: {target}")
    count = 0
    with writer:
        for i, sample in enumerate(
            samples_from_sources(list(sources), labeled=labeled)
        ):
            if augmentations:
                sample = apply_sample_augmentations(
                    sample, augmentations, clock=0.5
                )
            writer.add(sample)
            count += 1
    for aug in augmentations:
        aug.stop()
    return count


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--sources", required=True,
                        help="Comma-separated source files (csv/sdb/tar)")
    parser.add_argument("--target", required=True, help="Output .csv or .sdb")
    parser.add_argument("--augment", action="append", default=[])
    parser.add_argument("--unlabeled", action="store_true")
    args = parser.parse_args(argv)
    n = convert(
        args.sources.split(","),
        args.target,
        augment_specs=args.augment,
        labeled=not args.unlabeled,
    )
    print(f"Wrote {n} samples to {args.target}")


if __name__ == "__main__":
    main()
