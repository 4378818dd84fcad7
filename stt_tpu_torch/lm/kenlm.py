"""From-scratch reader for KenLM binary n-gram models (trie family).

Implements the on-disk format the reference consumes through
`lm::ngram::LoadVirtual` (scorer.cpp:109-146) so `.scorer` packages and
`lm.binary` artifacts load without the KenLM C++ library:

  [header]   magic sentence, sanity floats, fixed params (order, type,
             search version), per-order n-gram counts.
  [vocab]    uint64 entry count + sorted MurmurHash64A word hashes;
             word id = position + 1 (<unk> = 0).
  [search]   trie family:
               quant tables (QUANT_*): 8-byte header (version, prob_bits,
                 backoff_bits) + per-order bin-center float tables
               unigram array: (count+2) x {f32 prob, f32 backoff, u64 next}
               per middle order: optional bhiksha offset array + bit-packed
                 entries [word | quant/backoff+prob | next]
               longest order: bit-packed [word | prob]
  [strings]  optional vocabulary strings ("<unk>\\0word\\0...").

Scoring follows the stateless walk of FullScoreForgotState
(lm/model.cc:178-203): longest-suffix-match probability plus the backoffs
of every existing context suffix at least as long as the match.

Supported model types: TRIE, QUANT_TRIE, ARRAY_TRIE, QUANT_ARRAY_TRIE
(PROBING variants raise with a clear message; `build_binary trie` is the
format every published scorer uses).

The port's copy of `stt_tpu/lm/kenlm.py`, so the two packages read and
write the same files.
"""

from __future__ import annotations

import bisect
import math
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from stt_tpu_torch.lm.murmur import murmur_hash64a

MAGIC_SENTENCE = b"mmap lm http://kheafield.com/code format version 5\n\x00"

# model types (lm/model_type.hh)
PROBING = 0
REST_PROBING = 1
TRIE = 2
QUANT_TRIE = 3
ARRAY_TRIE = 4
QUANT_ARRAY_TRIE = 5

LOG10_E = math.log10(math.e)


def _align8(x: int) -> int:
    return ((x - 1) // 8 + 1) * 8


def _required_bits(max_value: int) -> int:
    return max_value.bit_length()


def _read_int(buf, bit_off: int, bits: int) -> int:
    """ReadInt57/ReadInt25 semantics: little-endian word at the byte
    containing bit_off, shifted by the bit remainder."""
    byte = bit_off >> 3
    word = int.from_bytes(buf[byte : byte + 8], "little")
    return (word >> (bit_off & 7)) & ((1 << bits) - 1)


def _read_float32(buf, bit_off: int) -> float:
    return struct.unpack("<f", _read_int(buf, bit_off, 32).to_bytes(4, "little"))[0]


def _read_nonpositive_float31(buf, bit_off: int) -> float:
    i = _read_int(buf, bit_off, 31) | 0x80000000
    return struct.unpack("<f", i.to_bytes(4, "little"))[0]


class _Bhiksha:
    """Next-pointer codec: either plain inline bits (DontBhiksha) or
    array-compressed high bits (ArrayBhiksha, lm/bhiksha.hh)."""

    def __init__(self, data, start: int, max_offset: int, max_next: int,
                 array_mode: bool, pointer_bhiksha_bits: int):
        required = _required_bits(max_next)
        if not array_mode:
            self.inline_bits = required
            self.offsets = None
            self.size = 0
            return
        best_chop, lowest = 0, None
        for chop in range(0, min(required, pointer_bhiksha_bits) + 1):
            change = (max_next >> (required - chop)) * 64 - max_offset * chop
            if lowest is None or change < lowest:
                lowest, best_chop = change, chop
        self.inline_bits = required - best_chop
        array_count = (max_next >> (required - best_chop)) + 1
        self.size = 8 * (1 + array_count) + 7
        table_start = _align8(start) + 8  # 8-byte [version, bits] header
        self.offsets = np.frombuffer(
            data, dtype="<u8", count=array_count, offset=table_start
        )

    def read_next(self, bits, entry_bit_off: int, index: int, total_bits: int):
        lo_begin = _read_int(bits, entry_bit_off, self.inline_bits)
        lo_end = _read_int(bits, entry_bit_off + total_bits, self.inline_bits)
        if self.offsets is None:
            return lo_begin, lo_end
        offs = self.offsets
        begin_block = int(np.searchsorted(offs, index, side="right")) - 1
        end_block = int(np.searchsorted(offs, index + 1, side="right")) - 1
        return (
            (begin_block << self.inline_bits) | lo_begin,
            (end_block << self.inline_bits) | lo_end,
        )


class _Middle:
    def __init__(self, data, start: int, entries: int, max_vocab: int,
                 max_next: int, quant_bits: int, array_mode: bool,
                 pointer_bhiksha_bits: int):
        self.bhiksha = _Bhiksha(
            data, start, entries + 1, max_next, array_mode, pointer_bhiksha_bits
        )
        self.word_bits = _required_bits(max_vocab)
        self.word_mask = (1 << self.word_bits) - 1
        self.quant_bits = quant_bits
        self.total_bits = self.word_bits + quant_bits + self.bhiksha.inline_bits
        bits_start = start + self.bhiksha.size
        bits_size = ((1 + entries) * self.total_bits + 7) // 8 + 8
        self.bits = data[bits_start : bits_start + bits_size]
        self.size = self.bhiksha.size + bits_size
        self.entries = entries

    def _word_at(self, index: int) -> int:
        return _read_int(self.bits, index * self.total_bits, self.word_bits)

    def find(self, word: int, begin: int, end: int):
        """Binary search for word in entry range [begin, end).
        Returns (entry_index, quant_bit_offset, (next_begin, next_end))
        or None."""
        lo, hi = begin, end
        while lo < hi:
            mid = (lo + hi) // 2
            w = self._word_at(mid)
            if w < word:
                lo = mid + 1
            elif w > word:
                hi = mid
            else:
                lo = mid
                break
        else:
            return None
        if self._word_at(lo) != word:
            return None
        at = lo * self.total_bits + self.word_bits
        nxt = self.bhiksha.read_next(
            self.bits, at + self.quant_bits, lo, self.total_bits
        )
        return lo, at, nxt


class _Longest:
    def __init__(self, data, start: int, entries: int, max_vocab: int,
                 quant_bits: int):
        self.word_bits = _required_bits(max_vocab)
        self.quant_bits = quant_bits
        self.total_bits = self.word_bits + quant_bits
        bits_size = ((1 + entries) * self.total_bits + 7) // 8 + 8
        self.bits = data[start : start + bits_size]
        self.size = bits_size

    def find(self, word: int, begin: int, end: int) -> Optional[int]:
        lo, hi = begin, end
        while lo < hi:
            mid = (lo + hi) // 2
            w = _read_int(self.bits, mid * self.total_bits, self.word_bits)
            if w < word:
                lo = mid + 1
            elif w > word:
                hi = mid
            else:
                return mid * self.total_bits + self.word_bits
        return None


class KenLMModel:
    def __init__(self, data: bytes):
        self._data = memoryview(data)
        self._parse(self._data)

    @classmethod
    def from_file(cls, path: str) -> "KenLMModel":
        with open(path, "rb") as f:
            return cls(f.read())

    # -- parsing -----------------------------------------------------------

    def _parse(self, data) -> None:
        if bytes(data[: len(MAGIC_SENTENCE)]) != MAGIC_SENTENCE:
            raise ValueError(
                "not a KenLM binary file (ARPA text models must be converted "
                "with build_binary first, or packaged from the ARPA with "
                "stt_tpu_torch.tools.generate_scorer_package)"
            )
        sanity_size = _align8(len(MAGIC_SENTENCE)) + 12 + 12 + 8
        off = sanity_size
        order, = struct.unpack_from("<B", data, off)
        probing_multiplier, = struct.unpack_from("<f", data, off + 4)
        model_type, = struct.unpack_from("<i", data, off + 8)
        has_vocabulary, = struct.unpack_from("<?", data, off + 12)
        search_version, = struct.unpack_from("<I", data, off + 16)
        off += 20
        counts = list(struct.unpack_from(f"<{order}Q", data, off))
        header_size = _align8(sanity_size + 20 + 8 * order)

        if model_type in (PROBING, REST_PROBING):
            raise NotImplementedError(
                "KenLM probing-format models are not supported yet; rebuild "
                "with 'build_binary trie' (the format all published scorers use)"
            )
        if model_type not in (TRIE, QUANT_TRIE, ARRAY_TRIE, QUANT_ARRAY_TRIE):
            raise ValueError(f"unknown KenLM model type {model_type}")
        quantized = model_type in (QUANT_TRIE, QUANT_ARRAY_TRIE)
        array_mode = model_type in (ARRAY_TRIE, QUANT_ARRAY_TRIE)

        self.order = order
        self.counts = counts
        self.model_type = model_type
        self.has_vocabulary = has_vocabulary
        self.quantized = quantized

        # vocabulary: leading uint64 entry count, then sorted hashes
        vocab_off = header_size
        n_hashes, = struct.unpack_from("<Q", data, vocab_off)
        self._vocab_hashes = np.frombuffer(
            data, dtype="<u8", count=n_hashes, offset=vocab_off + 8
        )
        vocab_size = 8 + 8 * counts[0]
        pos = vocab_off + vocab_size

        # quantization tables
        if quantized:
            version, prob_bits, backoff_bits = struct.unpack_from("<BBB", data, pos)
            if version != 2:
                raise ValueError(f"quantization version {version} unsupported")
            self.prob_bits, self.backoff_bits = prob_bits, backoff_bits
            table_pos = pos + 8
            self._quant_tables = []
            for _ in range(order - 2):
                probs = np.frombuffer(data, "<f4", 1 << prob_bits, table_pos)
                table_pos += 4 << prob_bits
                backoffs = np.frombuffer(data, "<f4", 1 << backoff_bits, table_pos)
                table_pos += 4 << backoff_bits
                self._quant_tables.append((probs, backoffs))
            self._longest_table = np.frombuffer(
                data, "<f4", 1 << prob_bits, table_pos
            )
            table_pos += 4 << prob_bits
            pos = table_pos
            middle_quant_bits = prob_bits + backoff_bits
            longest_quant_bits = prob_bits
        else:
            self.prob_bits = self.backoff_bits = 0
            middle_quant_bits = 31 + 32
            longest_quant_bits = 31

        # unigrams
        self._unigram = np.frombuffer(
            data,
            dtype=np.dtype([("prob", "<f4"), ("backoff", "<f4"), ("next", "<u8")]),
            count=counts[0] + 2,
            offset=pos,
        )
        pos += (counts[0] + 2) * 16

        # bhiksha bits config: first middle's section header byte 1
        pointer_bhiksha_bits = 64
        if array_mode and order > 2:
            pointer_bhiksha_bits = data[_align8(pos) + 1]

        self._middles: List[_Middle] = []
        for o in range(2, order):
            mid = _Middle(
                data, pos, counts[o - 1], counts[0], counts[o],
                middle_quant_bits, array_mode, pointer_bhiksha_bits,
            )
            self._middles.append(mid)
            pos += mid.size
        self._longest = _Longest(
            data, pos, counts[-1], counts[0], longest_quant_bits
        )
        pos += self._longest.size
        self.end_of_search_offset = pos

        self._unk_id = 0
        self._bos_id = self.vocab_index("<s>")
        self._eos_id = self.vocab_index("</s>")

    # -- vocabulary --------------------------------------------------------

    def vocab_index(self, word: str) -> int:
        h = murmur_hash64a(word.encode("utf-8"))
        pos = bisect.bisect_left(self._vocab_hashes, h)
        if pos < len(self._vocab_hashes) and self._vocab_hashes[pos] == h:
            return pos + 1  # 0 is <unk>
        return 0

    def vocab_strings(self, data: Optional[bytes] = None) -> List[str]:
        """The trailing vocabulary strings section: counts[0]
        null-terminated words in vocab-id order, present iff the binary
        was built without kenlm's `-v` (has_vocabulary header flag).
        Layout verified against build_binary output."""
        if not self.has_vocabulary:
            return []
        tail = bytes(
            (self._data if data is None else data)[self.end_of_search_offset :]
        )
        words: List[str] = []
        pos = 0
        for _ in range(self.counts[0]):
            end = tail.index(b"\x00", pos)
            words.append(tail[pos:end].decode("utf-8"))
            pos = end + 1
        return words

    @property
    def end_of_lm_offset(self) -> int:
        """First byte past the whole LM (search data + optional vocabulary
        strings) — where a .scorer package's TRIE trailer begins."""
        if not self.has_vocabulary:
            return self.end_of_search_offset
        tail = bytes(self._data[self.end_of_search_offset :])
        pos = 0
        for _ in range(self.counts[0]):
            pos = tail.index(b"\x00", pos) + 1
        return self.end_of_search_offset + pos

    @property
    def bos_id(self) -> int:
        return self._bos_id

    @property
    def eos_id(self) -> int:
        return self._eos_id

    @property
    def unk_id(self) -> int:
        return self._unk_id

    # -- lookups -----------------------------------------------------------

    def _middle_values(self, order_m2: int, quant_off: int) -> Tuple[float, float]:
        mid = self._middles[order_m2]
        if self.quantized:
            probs, backoffs = self._quant_tables[order_m2]
            b_idx = _read_int(mid.bits, quant_off, self.backoff_bits)
            p_idx = _read_int(mid.bits, quant_off + self.backoff_bits, self.prob_bits)
            return float(probs[p_idx]), float(backoffs[b_idx])
        prob = _read_nonpositive_float31(mid.bits, quant_off)
        backoff = _read_float32(mid.bits, quant_off + 31)
        return prob, backoff

    def _longest_value(self, quant_off: int) -> float:
        if self.quantized:
            idx = _read_int(self._longest.bits, quant_off, self.prob_bits)
            return float(self._longest_table[idx])
        return _read_nonpositive_float31(self._longest.bits, quant_off)

    # -- scoring -----------------------------------------------------------

    def score(self, context: Sequence[int], word: int) -> float:
        """log10 P(word | context) — context ordered left to right, ids from
        vocab_index. Mirrors FullScoreForgotState."""
        context = list(context)[-(self.order - 1) :]
        uni = self._unigram[word]
        prob = float(uni["prob"])
        node = (int(uni["next"]), int(self._unigram[word + 1]["next"]))
        matched = 1
        # extend match leftward through the context
        for k in range(len(context)):
            if node[0] == node[1]:
                break
            w = context[-(k + 1)]
            order_m2 = k
            if order_m2 == self.order - 2:
                found = self._longest.find(w, node[0], node[1])
                if found is not None:
                    prob = self._longest_value(found)
                    matched = self.order
                break
            res = self._middles[order_m2].find(w, node[0], node[1])
            if res is None:
                break
            _, quant_off, node = res
            p, _ = self._middle_values(order_m2, quant_off)
            prob = p
            matched = k + 2

        # charge backoffs of context suffixes with length >= matched
        if len(context) >= matched:
            start = matched
            if start <= 1:
                w = context[-1]
                prob += float(self._unigram[w]["backoff"])
                bnode = (
                    int(self._unigram[w]["next"]),
                    int(self._unigram[w + 1]["next"]),
                )
                start = 2
            else:
                # rebuild the node for the context suffix of length start-1
                w = context[-1]
                bnode = (
                    int(self._unigram[w]["next"]),
                    int(self._unigram[w + 1]["next"]),
                )
                ok = True
                for k in range(1, start - 1):
                    res = self._middles[k - 1].find(
                        context[-(k + 1)], bnode[0], bnode[1]
                    )
                    if res is None:
                        ok = False
                        break
                    _, _, bnode = res
                if not ok:
                    return prob
            for length in range(start, len(context) + 1):
                if bnode[0] == bnode[1]:
                    break
                res = self._middles[length - 2].find(
                    context[-length], bnode[0], bnode[1]
                )
                if res is None:
                    break
                _, quant_off, bnode = res
                _, backoff = self._middle_values(length - 2, quant_off)
                prob += backoff
        return prob

    def score_sentence(self, words: List[str], bos: bool = True,
                       eos: bool = True) -> Tuple[float, List[float]]:
        """Total log10 prob and per-word scores (query-tool semantics)."""
        context = [self._bos_id] if bos else []
        scores = []
        for w in words:
            wid = self.vocab_index(w)
            scores.append(self.score(context, wid))
            if wid == 0:
                context = []  # unk resets nothing in kenlm state; see note
            context.append(wid)
        if eos:
            scores.append(self.score(context, self._eos_id))
        return sum(scores), scores
