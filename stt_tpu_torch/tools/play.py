"""Audition augmentation pipelines: apply --augment specs to samples from
a source and write the results as wav files (parity: bin/play.py, which
plays through a sound device — headless environments write files).

Run: python -m stt_tpu_torch.tools.play --source in.csv --augment volume[dbfs=-6] \
       --pipe out_dir
"""

from __future__ import annotations

import argparse
import itertools
import os

from stt_tpu_torch.data.audio import write_wav
from stt_tpu_torch.data.augmentations import (
    apply_sample_augmentations,
    parse_augmentations,
)
from stt_tpu_torch.data.sources import samples_from_source


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--source", required=True)
    parser.add_argument("--augment", action="append", default=[])
    parser.add_argument("--start", type=int, default=0)
    parser.add_argument("--number", type=int, default=1)
    parser.add_argument("--clock", type=float, default=0.5)
    parser.add_argument("--pipe", required=True,
                        help="output directory for augmented wavs")
    args = parser.parse_args(argv)
    augmentations = parse_augmentations(args.augment)
    for aug in augmentations:
        aug.start()
    os.makedirs(args.pipe, exist_ok=True)
    source = samples_from_source(args.source, labeled=None)
    written = []
    for i, sample in enumerate(
        itertools.islice(iter(source), args.start, args.start + args.number)
    ):
        sample = apply_sample_augmentations(
            sample, augmentations, clock=args.clock
        )
        out = os.path.join(args.pipe, f"augmented_{args.start + i:06d}.wav")
        write_wav(out, sample.audio, sample.rate)
        print(f"{sample.sample_id} -> {out}")
        written.append(out)
    for aug in augmentations:
        aug.stop()
    return written


if __name__ == "__main__":
    main()
