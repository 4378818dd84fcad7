"""Scorer load-test harness: validate a .scorer package against an alphabet.

Counterpart of the reference's native_client/trie_load.cc:35-92: load the
scorer, report success/failure via the exit code, and (like its DEBUG
mode) optionally inspect the vocabulary FST with `arcs` or `dump-vocab`.

Usage:
  python -m stt_tpu_torch.tools.trie_load <scorer> <alphabet> [arcs|dump-vocab]
"""

from __future__ import annotations

import argparse
import sys

from stt_tpu_torch.alphabet import Alphabet
from stt_tpu_torch.decode.scorer_package import KenLMScorer


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("scorer_path")
    parser.add_argument("alphabet_path")
    parser.add_argument("command", nargs="?", choices=["arcs", "dump-vocab"])
    args = parser.parse_args(argv)

    print(
        f"Loading scorer({args.scorer_path}) and alphabet({args.alphabet_path})",
        file=sys.stderr,
    )
    alphabet = Alphabet(args.alphabet_path)
    try:
        scorer = KenLMScorer(args.scorer_path)
    except Exception as e:
        print(f"scorer load failed: {e}", file=sys.stderr)
        return 1
    print(
        f"order {scorer.get_max_order()}, utf8 {scorer.is_utf8_mode()}, "
        f"alpha {scorer.alpha:.6f}, beta {scorer.beta:.6f}",
        file=sys.stderr,
    )

    fst = scorer.dictionary
    if args.command == "arcs":
        # per-arc label ranges out of the start state (trie_load.cc:66-82)
        start = fst.start
        for ilabel, nextstate in sorted(fst.arcs(start)):
            ch = ilabel - 1
            printable = chr(ch) if 32 <= ch < 127 else "?"
            print(f"{start} -> state {nextstate} (char 0x{ch:X}, {printable!r})")
    elif args.command == "dump-vocab":
        for word in fst.words(alphabet):
            print(word)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
