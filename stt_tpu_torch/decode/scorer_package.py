"""The .scorer package: KenLM binary LM + metadata trailer + ConstFst
vocabulary trie, and the KenLMScorer that drives beam search with it.

Package layout (generate_scorer_package.cpp:90-104, scorer.cpp:177-222):
  [KenLM binary model]
  int32 MAGIC 'TRIE' (bytes "EIRT" little-endian)
  int32 FILE_VERSION (6)
  int8  is_utf8_mode
  f64   alpha
  f64   beta
  [ConstFst<StdArc> dictionary]

The port's copy of `stt_tpu/decode/scorer_package.py`, so the two
packages read and write the same files.
"""

from __future__ import annotations

import math
import struct
from typing import Optional, Sequence

from stt_tpu_torch.decode.fst_dict import FstDictionary
from stt_tpu_torch.decode.scorer import OOV_SCORE, ScorerBase
from stt_tpu_torch.lm.kenlm import KenLMModel

MAGIC = b"EIRT"  # int 'TRIE' little-endian
FILE_VERSION = 6
LOG10_E = math.log10(math.e)


class ScorerLoadError(ValueError):
    pass


class KenLMScorer(ScorerBase):
    """External scorer backed by a real KenLM model + FST vocabulary."""

    def __init__(
        self,
        scorer_path: Optional[str] = None,
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        data: Optional[bytes] = None,
    ):
        super().__init__(0.0, 0.0)
        self.path = scorer_path  # lets the native decoder re-open the package
        if data is None:
            if scorer_path is None:
                raise ValueError("need scorer_path or data")
            with open(scorer_path, "rb") as f:
                data = f.read()
        self.lm = KenLMModel(data)
        off = self.lm.end_of_lm_offset
        if bytes(data[off : off + 4]) != MAGIC:
            raise ScorerLoadError(
                "scorer file has no TRIE trailer at the end of the LM "
                "(invalid or pre-v6 scorer package)"
            )
        version, = struct.unpack_from("<i", data, off + 4)
        if version != FILE_VERSION:
            raise ScorerLoadError(
                f"scorer file version {version}, expected {FILE_VERSION}"
            )
        self._utf8, = struct.unpack_from("<b", data, off + 8)
        file_alpha, file_beta = struct.unpack_from("<dd", data, off + 9)
        self.alpha = file_alpha if alpha is None else alpha
        self.beta = file_beta if beta is None else beta
        self.dictionary = FstDictionary(data, off + 25)

    def is_utf8_mode(self) -> bool:
        return bool(self._utf8)

    def get_max_order(self) -> int:
        return self.lm.order

    def get_log_cond_prob(self, ngram: Sequence[str], bos: bool) -> float:
        """ln P(last word | preceding) — walks the words like the
        reference (scorer.cpp:303-344): any OOV anywhere returns
        OOV_SCORE; the returned value is the last word's conditional."""
        context = [self.lm.bos_id] if bos else []
        cond = 0.0
        for word in ngram:
            wid = self.lm.vocab_index(word)
            if wid == self.lm.unk_id:
                return OOV_SCORE
            cond = self.lm.score(context, wid)
            context.append(wid)
        return cond / LOG10_E
