"""Text metrics: levenshtein distance, WER, CER.

The port's copy of `stt_tpu/text.py`, so both packages score a transcript
alike (parity surface: training/coqui_stt_training/util/text.py:46 and
util/evaluate_tools.py:37).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Edit distance between two sequences (words or characters)."""
    if len(a) < len(b):
        a, b = b, a
    # len(a) >= len(b); DP over the shorter sequence for O(min) space.
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, start=1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, start=1):
            cur[j] = min(
                prev[j] + 1,          # deletion
                cur[j - 1] + 1,       # insertion
                prev[j - 1] + (ca != cb),  # substitution
            )
        prev = cur
    return prev[len(b)]


def word_distance(ref: str, hyp: str) -> Tuple[int, int]:
    """(edit distance over words, #ref words)."""
    ref_words = ref.split()
    return levenshtein(ref_words, hyp.split()), len(ref_words)


def char_distance(ref: str, hyp: str) -> Tuple[int, int]:
    return levenshtein(ref, hyp), len(ref)


def wer(ref: str, hyp: str) -> float:
    dist, n = word_distance(ref, hyp)
    return dist / max(n, 1)


def cer(ref: str, hyp: str) -> float:
    dist, n = char_distance(ref, hyp)
    return dist / max(n, 1)


def wer_cer_batch(refs: List[str], hyps: List[str]) -> Tuple[float, float]:
    """Corpus-level WER/CER: sum of distances over sum of lengths
    (matches evaluate_tools.py:37-57 aggregation)."""
    assert len(refs) == len(hyps)
    wd = wn = cd = cn = 0
    for ref, hyp in zip(refs, hyps):
        d, n = word_distance(ref, hyp)
        wd += d
        wn += n
        d, n = char_distance(ref, hyp)
        cd += d
        cn += n
    return wd / max(wn, 1), cd / max(cn, 1)
