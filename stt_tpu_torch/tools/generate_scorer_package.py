"""Create a .scorer package: KenLM LM + metadata trailer + vocabulary FST.

Parity surface: native_client/generate_scorer_package.cpp (create_package
:19-104): reads the vocabulary, auto-detects bytes-output mode, builds
the FST dictionary, copies the LM and appends trailer + FST. Accepts a
KenLM binary (built by anything) or an ARPA file (converted natively via
stt_tpu_torch.lm.trie_writer — the reference needs KenLM's build_binary here).

Run: python -m stt_tpu_torch.tools.generate_scorer_package --alphabet alphabet.txt \
       --lm lm.binary|lm.arpa --vocab vocab.txt --package out.scorer \
       --default_alpha 0.93 --default_beta 1.18 [--force_bytes_output_mode]

The port's copy of `stt_tpu/tools/generate_scorer_package.py`, so the
two packages read and write the same files.
"""

from __future__ import annotations

import argparse
import struct
import sys
from typing import List, Optional

from stt_tpu_torch.alphabet import Alphabet, UTF8Alphabet
from stt_tpu_torch.decode.fst_writer import build_dictionary_fst, write_const_fst
from stt_tpu_torch.decode.scorer_package import FILE_VERSION, MAGIC


def words_look_like_bytes_mode(words: List[str]) -> bool:
    """Heuristic from generate_scorer_package.cpp:30-50: bytes-output
    vocabularies contain multi-byte/non-ascii sequences."""
    return any(not w.isascii() for w in words)


def create_package(
    alphabet_path: Optional[str],
    lm_path: str,
    vocab_path: str,
    package_path: str,
    default_alpha: float,
    default_beta: float,
    force_bytes_output_mode: Optional[bool] = None,
) -> str:
    with open(vocab_path, "r", encoding="utf-8") as f:
        words = [w for line in f for w in line.split()]

    bytes_mode = (
        force_bytes_output_mode
        if force_bytes_output_mode is not None
        else words_look_like_bytes_mode(words)
    )
    if bytes_mode:
        alphabet: Alphabet = UTF8Alphabet()
    else:
        if not alphabet_path:
            raise ValueError("--alphabet is required unless in bytes output mode")
        alphabet = Alphabet(alphabet_path)

    if lm_path.endswith(".arpa") or lm_path.endswith(".arpa.txt"):
        from stt_tpu_torch.lm.arpa import read_arpa
        from stt_tpu_torch.lm.trie_writer import write_trie_binary

        lm_bytes = write_trie_binary(read_arpa(lm_path))
    else:
        with open(lm_path, "rb") as f:
            lm_bytes = f.read()
        # validate + trim anything after the search structure
        from stt_tpu_torch.lm.kenlm import KenLMModel

        model = KenLMModel(lm_bytes)
        lm_bytes = lm_bytes[: model.end_of_search_offset]

    trailer = (
        MAGIC
        + struct.pack("<i", FILE_VERSION)
        + struct.pack("<b", 1 if bytes_mode else 0)
        + struct.pack("<dd", default_alpha, default_beta)
    )
    states, arcs = build_dictionary_fst(words, alphabet, utf8_mode=bytes_mode)
    fst_bytes = write_const_fst(
        states, arcs, base_offset=len(lm_bytes) + len(trailer)
    )
    with open(package_path, "wb") as f:
        f.write(lm_bytes)
        f.write(trailer)
        f.write(fst_bytes)
    print(
        f"Package created in {package_path} "
        f"({'bytes' if bytes_mode else 'alphabet'} output mode, "
        f"{len(states)} FST states)"
    )
    return package_path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--alphabet", default="")
    parser.add_argument("--lm", required=True)
    parser.add_argument("--vocab", required=True)
    parser.add_argument("--package", required=True)
    parser.add_argument("--default_alpha", type=float, required=True)
    parser.add_argument("--default_beta", type=float, required=True)
    parser.add_argument("--force_bytes_output_mode", action="store_true",
                        default=None)
    args = parser.parse_args(argv)
    create_package(
        args.alphabet or None,
        args.lm,
        args.vocab,
        args.package,
        args.default_alpha,
        args.default_beta,
        args.force_bytes_output_mode,
    )


if __name__ == "__main__":
    main()
