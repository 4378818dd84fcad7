"""Dump the vocabulary of a KenLM binary model to a text file.

Counterpart of the reference's enumerate_kenlm_vocabulary.cpp:28-50
(lm::EnumerateVocab callback over LoadVirtual); here the from-scratch
KenLM reader exposes the trailing string table directly.

Usage: python -m stt_tpu_torch.tools.enumerate_kenlm_vocabulary <kenlm.binary> <out.txt>
"""

from __future__ import annotations

import argparse

from stt_tpu_torch.lm.kenlm import KenLMModel


def enumerate_vocabulary(kenlm_path: str) -> list:
    model = KenLMModel.from_file(kenlm_path)
    words = model.vocab_strings()
    if not words:
        raise ValueError(
            f"{kenlm_path}: model was built without vocabulary strings "
            "(kenlm build_binary -v); rebuild with include_vocab to "
            "enumerate, or walk the scorer FST with tools.trie_load "
            "dump-vocab instead"
        )
    return words


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("kenlm_model")
    parser.add_argument("output_path")
    args = parser.parse_args(argv)
    words = enumerate_vocabulary(args.kenlm_model)
    with open(args.output_path, "w", encoding="utf-8") as f:
        for word in words:
            f.write(word + "\n")
    print(f"wrote {len(words)} words to {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
