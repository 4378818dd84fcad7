"""External scorer interface for beam-search LM fusion (ScorerBase and
StaticScorer, as in stt_tpu/decode/scorer.py).

The reference scorer (ctcdecode/scorer.{h,cpp}) couples a KenLM n-gram
model with a vocabulary trie and two fused hyperparameters (alpha = LM
weight, beta = word-insertion bonus). This module defines the interface
the decoder consumes; the concrete backend is
stt_tpu_torch.decode.scorer_package (the .scorer package: a KenLM binary
read by stt_tpu_torch.lm.kenlm, and its vocabulary FST).

Scores are natural-log conditional probabilities (the reference divides
KenLM's log10 by log10(e), scorer.cpp:343).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

OOV_SCORE = -1000.0  # scorer.h OOV_SCORE


class ScorerBase:
    """Interface the beam search drives. alpha/beta are mutable
    (STT_SetScorerAlphaBeta surface)."""

    def __init__(self, alpha: float = 0.0, beta: float = 0.0):
        self.alpha = alpha
        self.beta = beta
        self.dictionary = None  # Optional[DictionaryTrie]

    def reset_params(self, alpha: float, beta: float) -> None:
        self.alpha = alpha
        self.beta = beta

    def is_utf8_mode(self) -> bool:
        return False

    def get_max_order(self) -> int:
        raise NotImplementedError

    def get_log_cond_prob(self, ngram: Sequence[str], bos: bool) -> float:
        """ln P(last word | preceding words); OOV_SCORE if any word is
        out of vocabulary."""
        raise NotImplementedError


class StaticScorer(ScorerBase):
    """Table-backed n-gram scorer (tests and tiny domain LMs): maps word
    tuples to ln-probabilities with backoff to OOV_SCORE."""

    def __init__(
        self,
        ngram_scores: dict,
        max_order: int = 2,
        alpha: float = 1.0,
        beta: float = 0.0,
        vocabulary: Optional[List[str]] = None,
        alphabet=None,
        utf8_mode: bool = False,
    ):
        super().__init__(alpha, beta)
        self._scores = {tuple(k): v for k, v in ngram_scores.items()}
        self._max_order = max_order
        self._utf8 = utf8_mode
        self._vocab = set(vocabulary) if vocabulary is not None else None
        if vocabulary is not None and alphabet is not None:
            from stt_tpu_torch.decode.trie import DictionaryTrie

            self.dictionary = DictionaryTrie.from_words(
                vocabulary, alphabet, utf8_mode
            )

    def is_utf8_mode(self) -> bool:
        return self._utf8

    def get_max_order(self) -> int:
        return self._max_order

    def get_log_cond_prob(self, ngram: Sequence[str], bos: bool) -> float:
        if self._vocab is not None and ngram and ngram[-1] not in self._vocab:
            return OOV_SCORE
        for start in range(len(ngram)):
            key = tuple(ngram[start:])
            if key in self._scores:
                return self._scores[key]
        return OOV_SCORE
