"""Writer for KenLM binary trie models (plain TRIE, model_type 2).

The inverse of stt_tpu_torch.lm.kenlm: takes an ArpaModel and emits a binary
the reference's `lm::ngram::LoadVirtual` (and our reader) loads — this
is what lets `generate_scorer_package` work entirely offline from an
ARPA file, where the reference shells out to KenLM's `build_binary`.

Reverse-trie layout (see stt_tpu_torch/lm/kenlm.py for the read-side spec):
n-gram (w1..wn) lives at depth n under the path wn -> w(n-1) -> ... ;
contexts that appear only inside longer n-grams get "blank" entries
whose stored probability equals the backed-off estimate, so scoring
walks return exact ARPA semantics through them.

The port's copy of `stt_tpu/lm/trie_writer.py`, so the two packages read
and write the same files.
"""

from __future__ import annotations

import math
import struct
from typing import Dict, List, Tuple

import numpy as np

from stt_tpu_torch.lm.arpa import ArpaModel
from stt_tpu_torch.lm.kenlm import MAGIC_SENTENCE, TRIE, _align8, _required_bits
from stt_tpu_torch.lm.murmur import murmur_hash64a

_TRIE_SEARCH_VERSION = 1  # lm/search_trie.hh:39


class _BitWriter:
    def __init__(self, total_bits_capacity: int):
        self.buf = bytearray((total_bits_capacity + 7) // 8 + 8)

    def write(self, bit_off: int, bits: int, value: int) -> None:
        byte = bit_off >> 3
        shift = bit_off & 7
        word = int.from_bytes(self.buf[byte : byte + 8], "little")
        word |= (value & ((1 << bits) - 1)) << shift
        self.buf[byte : byte + 8] = word.to_bytes(8, "little")


def _float_bits(value: float) -> int:
    return struct.unpack("<I", struct.pack("<f", value))[0]


def _nonpositive_float31(value: float) -> int:
    return _float_bits(value) & 0x7FFFFFFF


def write_trie_binary(model: ArpaModel, include_vocab: bool = False) -> bytes:
    """include_vocab appends the vocabulary-strings section (kenlm
    build_binary's default; the reference LM pipeline passes -v to strip
    it, data/lm/generate_lm.py:119-124, so scorer packages default off)."""
    order = model.order
    ln10 = math.log(10.0)

    # -- vocabulary ids: <unk>=0, others by ascending MurmurHash ----------
    words = model.vocabulary
    hashed = []
    saw_unk = False
    for w in words:
        if w in ("<unk>", "<UNK>"):
            saw_unk = True
            continue
        hashed.append((murmur_hash64a(w.encode("utf-8")), w))
    hashed.sort()
    word_id: Dict[str, int] = {"<unk>": 0, "<UNK>": 0}
    for i, (_, w) in enumerate(hashed):
        word_id[w] = i + 1
    n_unigrams = len(hashed) + 1  # ids 0..len(hashed)

    # -- build the reverse trie -------------------------------------------
    # node key: tuple of word ids along the path (last word first)
    # value: [prob_log10, backoff_log10, is_blank]
    tries: List[Dict[Tuple[int, ...], List]] = [dict() for _ in range(order)]
    for n in range(1, order + 1):
        for ngram, (prob, backoff) in model.ngrams[n - 1].items():
            ids = tuple(word_id.get(w, 0) for w in ngram)
            path = tuple(reversed(ids))  # (wn, wn-1, ..., w1)
            tries[n - 1][path] = [prob, backoff, False]

    # ensure every path prefix exists (blanks)
    for n in range(order, 1, -1):
        for path in list(tries[n - 1].keys()):
            for k in range(n - 1, 0, -1):
                prefix = path[:k]
                if prefix not in tries[k - 1]:
                    tries[k - 1][prefix] = [None, 0.0, True]

    # compute blank probs = backed-off estimate (exact-scoring invariant)
    def backed_off_prob(path: Tuple[int, ...]) -> float:
        """path = (wn, c1, c2, ...): log10 P(wn | ...c2 c1)."""
        word = path[0]
        context = path[1:]
        for i in range(len(context), -1, -1):
            sub = (word,) + context[:i]
            entry = tries[len(sub) - 1].get(sub)
            if entry is not None and entry[0] is not None:
                prob = entry[0]
                for j in range(i, len(context)):
                    ctx_path = context[: j + 1]
                    ctx_entry = tries[len(ctx_path) - 1].get(ctx_path)
                    if ctx_entry is not None and not ctx_entry[2]:
                        prob += ctx_entry[1]
                return prob
        return -99.0

    for n in range(2, order + 1):
        for path, entry in tries[n - 1].items():
            if entry[2]:
                entry[0] = backed_off_prob(path)

    counts = [n_unigrams] + [len(tries[n - 1]) for n in range(2, order + 1)]

    # -- assign entry indices: children blocks grouped under parents ------
    # order 1: index = word id. order n: sort paths by (parent index, word)
    index_of: List[Dict[Tuple[int, ...], int]] = [dict() for _ in range(order)]
    for path in tries[0]:
        index_of[0][path] = path[0]
    for n in range(2, order + 1):
        paths = sorted(
            tries[n - 1].keys(),
            key=lambda p: (index_of[n - 2][p[:-1]], p[-1]),
        )
        for i, p in enumerate(paths):
            index_of[n - 1][p] = i

    # -- header -----------------------------------------------------------
    out = bytearray()
    sanity = bytearray(_align8(len(MAGIC_SENTENCE)))
    sanity[: len(MAGIC_SENTENCE)] = MAGIC_SENTENCE
    sanity += struct.pack("<fff", 0.0, 1.0, -0.5)
    sanity += struct.pack("<III", 1, 0xFFFFFFFF, 0)
    sanity += struct.pack("<Q", 1)
    out += sanity
    out += struct.pack(
        "<B3xfi?3xI", order, 1.5, TRIE, include_vocab, _TRIE_SEARCH_VERSION
    )
    out += struct.pack(f"<{order}Q", *counts)
    header_size = _align8(len(out))
    out += b"\x00" * (header_size - len(out))

    # -- vocab ------------------------------------------------------------
    out += struct.pack("<Q", len(hashed))
    out += np.asarray([h for h, _ in hashed], "<u8").tobytes()
    # allocated block is 8 + 8*counts[0]; we have 8 + 8*(counts[0]-1)
    out += b"\x00" * 8

    # -- unigram array ----------------------------------------------------
    # next pointers: children (order-2 entries) of unigram w occupy a
    # contiguous block; iterate ids in order accumulating block sizes
    if order >= 2:
        children_count = [0] * (n_unigrams + 1)
        for path in tries[1]:
            children_count[path[0]] += 1
    uni = np.zeros(
        counts[0] + 2,
        dtype=np.dtype([("prob", "<f4"), ("backoff", "<f4"), ("next", "<u8")]),
    )
    running = 0
    for wid in range(n_unigrams):
        entry = tries[0].get((wid,))
        if entry is not None and entry[0] is not None:
            uni[wid]["prob"] = entry[0]
            uni[wid]["backoff"] = entry[1]
        else:
            uni[wid]["prob"] = -100.0
            uni[wid]["backoff"] = 0.0
        uni[wid]["next"] = running
        if order >= 2:
            running += children_count[wid]
    for tail in range(n_unigrams, counts[0] + 2):
        uni[tail]["next"] = running
    out += uni.tobytes()

    # -- middle orders ----------------------------------------------------
    word_bits = _required_bits(counts[0])
    for n in range(2, order):
        entries = counts[n - 1]
        max_next = counts[n]
        next_bits = _required_bits(max_next)
        quant_bits = 31 + 32
        total_bits = word_bits + quant_bits + next_bits
        writer = _BitWriter((entries + 1) * total_bits)
        paths = sorted(
            tries[n - 1].keys(), key=lambda p: index_of[n - 1][p]
        )
        # children counts at order n+1 grouped by parent index
        child_count = [0] * (entries + 1)
        for p in tries[n]:
            child_count[index_of[n - 1][p[:-1]]] += 1
        running = 0
        for i, path in enumerate(paths):
            prob, backoff, _ = tries[n - 1][path]
            at = i * total_bits
            writer.write(at, word_bits, path[-1])
            at += word_bits
            writer.write(at, 31, _nonpositive_float31(prob))
            writer.write(at + 31, 32, _float_bits(backoff))
            writer.write(at + quant_bits, next_bits, running)
            running += child_count[i]
        # final next pointer closes the last block
        writer.write(
            entries * total_bits + word_bits + quant_bits, next_bits, running
        )
        out += bytes(writer.buf)

    # -- longest order ----------------------------------------------------
    entries = counts[-1]
    total_bits = word_bits + 31
    writer = _BitWriter((entries + 1) * total_bits)
    paths = sorted(
        tries[order - 1].keys(), key=lambda p: index_of[order - 1][p]
    )
    for i, path in enumerate(paths):
        prob, _, _ = tries[order - 1][path]
        at = i * total_bits
        writer.write(at, word_bits, path[-1])
        writer.write(at + word_bits, 31, _nonpositive_float31(prob))
    out += bytes(writer.buf)

    if include_vocab:
        # null-terminated strings in vocab-id order: <unk>, then hash order
        out += b"<unk>\x00"
        for _, w in hashed:
            out += w.encode("utf-8") + b"\x00"

    return bytes(out)
