"""Build a language model from a text corpus: top-k vocabulary filtering
+ native Kneser-Ney ARPA estimation + KenLM trie binary conversion.

Parity surface: data/lm/generate_lm.py (convert/top-k :12-75 and the
lmplz/filter/build_binary subprocess calls :79-129 — replaced by the
native estimator and trie writer; an externally built ARPA can also be
converted with --input_arpa).

Run: python -m stt_tpu_torch.tools.generate_lm --input_txt corpus.txt \
       --output_dir lm_out --top_k 500000 --arpa_order 5
"""

from __future__ import annotations

import argparse
import gzip
import os
from collections import Counter


def load_lines(path: str):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        for line in f:
            line = line.strip().lower()
            if line:
                yield line


def convert_and_filter_topk(input_txt: str, output_dir: str, top_k: int):
    """Count words, keep the top_k, write filtered corpus + vocab file
    (generate_lm.py:12-75)."""
    os.makedirs(output_dir, exist_ok=True)
    counter = Counter()
    for line in load_lines(input_txt):
        counter.update(line.split())
    vocab = [w for w, _ in counter.most_common(top_k)]
    vocab_set = set(vocab)
    vocab_path = os.path.join(output_dir, f"vocab-{top_k}.txt")
    with open(vocab_path, "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    filtered_path = os.path.join(output_dir, "lower.txt")
    kept = total = 0
    with open(filtered_path, "w", encoding="utf-8") as f:
        for line in load_lines(input_txt):
            words = line.split()
            total += 1
            if all(w in vocab_set for w in words):
                f.write(line + "\n")
                kept += 1
    print(f"Kept {kept}/{total} sentences fully covered by top-{top_k} vocab")
    return filtered_path, vocab_path, vocab_set


def build_lm(
    filtered_path: str,
    output_dir: str,
    arpa_order: int,
    vocab_set=None,
    discount: float = None,
    arpa_prune: str = "0",
    discount_fallback: bool = False,
):
    """Estimate + package the LM. Default estimator is the lmplz
    algorithm (modified KN, per-order count-of-counts discounts —
    reference data/lm/generate_lm.py:79-97 shells to lmplz with --order/
    --prune/--discount_fallback); pass a fixed `discount` to use the
    simple absolute-discount estimator instead."""
    from stt_tpu_torch.lm.arpa import (
        estimate_kneser_ney,
        estimate_kneser_ney_lmplz,
        write_arpa,
    )
    from stt_tpu_torch.lm.trie_writer import write_trie_binary

    sentences = [line.split() for line in load_lines(filtered_path)]
    if discount is None:
        from stt_tpu_torch.lm.arpa import DiscountEstimationError

        prune = [int(x) for x in str(arpa_prune).split("|")]
        try:
            model = estimate_kneser_ney_lmplz(
                sentences, order=arpa_order, vocabulary=vocab_set,
                discount_fallback=discount_fallback, prune=prune,
            )
        except DiscountEstimationError as exc:
            # lmplz aborts here and tells the user to rerun with
            # --discount_fallback; tiny corpora are common for domain
            # scorers, so retry with the fallback discounts and say so
            print(
                f"Could not estimate Kneser-Ney discounts ({exc}); "
                "using --discount_fallback defaults 0.5/1.0/1.5"
            )
            model = estimate_kneser_ney_lmplz(
                sentences, order=arpa_order, vocabulary=vocab_set,
                discount_fallback=True, prune=prune,
            )
    else:
        model = estimate_kneser_ney(
            sentences, order=arpa_order, discount=discount,
            vocabulary=vocab_set,
        )
    arpa_path = os.path.join(output_dir, "lm.arpa")
    write_arpa(model, arpa_path)
    binary_path = os.path.join(output_dir, "lm.binary")
    with open(binary_path, "wb") as f:
        f.write(write_trie_binary(model))
    print(f"Wrote {arpa_path} (counts {model.counts()}) and {binary_path}")
    return arpa_path, binary_path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input_txt", help="corpus text (.txt or .txt.gz)")
    parser.add_argument("--input_arpa", help="pre-built ARPA to convert")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--top_k", type=int, default=500000)
    parser.add_argument("--arpa_order", type=int, default=4)
    parser.add_argument(
        "--discount", type=float, default=None,
        help="fixed discount for the simple estimator; default uses "
             "lmplz-style count-of-counts estimation",
    )
    parser.add_argument(
        "--arpa_prune", default="0",
        help="'|'-separated per-order prune thresholds (lmplz --prune "
             "semantics: n-grams with adjusted count <= threshold are "
             "dropped; 0 disables)",
    )
    parser.add_argument(
        "--discount_fallback", action="store_true",
        help="fall back to 0.5/1.0/1.5 discounts on tiny corpora "
             "(lmplz --discount_fallback)",
    )
    args = parser.parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    if args.input_arpa:
        from stt_tpu_torch.lm.arpa import read_arpa
        from stt_tpu_torch.lm.trie_writer import write_trie_binary

        model = read_arpa(args.input_arpa)
        binary_path = os.path.join(args.output_dir, "lm.binary")
        with open(binary_path, "wb") as f:
            f.write(write_trie_binary(model))
        vocab_path = os.path.join(args.output_dir, "vocab.txt")
        with open(vocab_path, "w", encoding="utf-8") as f:
            f.write(
                "\n".join(
                    w for w in model.vocabulary
                    if w not in ("<s>", "</s>", "<unk>")
                )
                + "\n"
            )
        print(f"Converted {args.input_arpa} -> {binary_path}")
        return
    if not args.input_txt:
        parser.error("need --input_txt or --input_arpa")
    filtered, vocab_path, vocab_set = convert_and_filter_topk(
        args.input_txt, args.output_dir, args.top_k
    )
    build_lm(filtered, args.output_dir, args.arpa_order, vocab_set,
             args.discount, args.arpa_prune, args.discount_fallback)


if __name__ == "__main__":
    main()
