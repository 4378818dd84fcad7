"""Compare two audio files by maximum per-window dBFS difference
(parity: bin/compare_samples.py:18-55).

Run: python -m stt_tpu_torch.tools.compare_samples a.wav b.wav [--if-differ]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from stt_tpu_torch.data.audio import read_wav


def audio_diff_dbfs(a: np.ndarray, b: np.ndarray, window: int = 1024) -> float:
    """Max windowed RMS-dBFS of the difference signal."""
    n = min(len(a), len(b))
    if n == 0:
        return 0.0
    diff = a[:n] - b[:n]
    n_win = max(1, n // window)
    diff = diff[: n_win * window].reshape(n_win, window)
    rms = np.sqrt(np.mean(np.square(diff), axis=1)) + 1e-10
    return float(20 * np.log10(rms).max())


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("file1")
    parser.add_argument("file2")
    parser.add_argument("--threshold", type=float, default=-60.0,
                        help="dBFS difference above which samples differ")
    parser.add_argument("--if-differ", action="store_true",
                        help="exit 0 only if samples differ")
    args = parser.parse_args(argv)
    a, ra = read_wav(args.file1)
    b, rb = read_wav(args.file2)
    if ra != rb or abs(len(a) - len(b)) > ra * 0.1:
        differ = True
        diff = float("inf")
    else:
        diff = audio_diff_dbfs(a, b)
        differ = diff > args.threshold
    print(f"Difference: {diff:.2f} dBFS -> samples {'differ' if differ else 'match'}")
    ok = differ if args.if_differ else not differ
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
