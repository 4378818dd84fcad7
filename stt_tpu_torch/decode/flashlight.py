"""Flashlight-style lexicon / lexicon-free beam decoders (a copy of
`stt_tpu.decode.flashlight`: numpy on the host, over the port's KenLM
reader).

The reference exposes these as the alternative decoder family
(FlashlightDecoderState glue, ctc_beam_search_decoder.cpp:395-567, over
the vendored flashlight LexiconDecoder/LexiconFreeDecoder). Unlike the
CTC prefix beam search (which merges alignments into prefix
probabilities), these are Viterbi-style beams over (LM state, lexicon
node) hypotheses:

- LexiconDecoder: tokens walk a trie of word spellings; the word-level
  LM scores at word ends, with MAX-smeared per-node lookahead so partial
  words carry admissible LM estimates (Trie::smear);
- LexiconFreeDecoder: token-level hypotheses, LM over tokens;
- CTC criterion: blank transitions and the repeated-token rule.

Scores are Viterbi (max) by default with optional log-add hypothesis
merging, matching flashlight's candidatesStore.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from stt_tpu_torch.alphabet import Alphabet

NEG_INF = -math.inf
LOG10_E = math.log10(math.e)


# ---------------------------------------------------------------- LM bridge


class WordLM:
    """Stateful word-level LM over a KenLMModel (flashlight KenLM adapter:
    state = context word ids). Scores are RAW log10, exactly what the
    reference's Scorer::score hands flashlight (scorer.cpp:452-464
    returns BaseScore untransformed) — lmWeight/alpha values are tuned
    for that unit, and the lexicon-free parity gate vs the compiled
    FlashlightDecoderState depends on it."""

    def __init__(self, kenlm_model):
        self.lm = kenlm_model

    def start(self) -> Tuple[int, ...]:
        return (self.lm.bos_id,)

    def score(self, state: Tuple[int, ...], word_id: int):
        new_state = (state + (word_id,))[-(self.lm.order - 1) :]
        return new_state, self.lm.score(list(state), word_id)

    def finish(self, state: Tuple[int, ...]):
        return state, self.lm.score(list(state), self.lm.eos_id)


# ------------------------------------------------------------------- trie


class TrieNode:
    __slots__ = ("children", "labels", "scores", "max_score")

    def __init__(self):
        self.children: Dict[int, "TrieNode"] = {}
        self.labels: List[int] = []  # word ids ending here
        self.scores: List[float] = []
        self.max_score = NEG_INF


class Trie:
    """Lexicon trie over token spellings with MAX smearing
    (flashlight Trie.cpp)."""

    def __init__(self):
        self.root = TrieNode()

    def insert(self, token_ids: Sequence[int], word_id: int, score: float):
        node = self.root
        for tok in token_ids:
            node = node.children.setdefault(tok, TrieNode())
        node.labels.append(word_id)
        node.scores.append(score)

    def smear(self):
        def visit(node: TrieNode) -> float:
            best = max(node.scores, default=NEG_INF)
            for child in node.children.values():
                best = max(best, visit(child))
            node.max_score = best
            return best

        visit(self.root)


def build_lexicon_trie(
    words: Sequence[str], alphabet: Alphabet, lm: WordLM
) -> Tuple[Trie, List[str]]:
    """Words -> (smeared trie keyed by char-token spellings, word list).
    Word unigram LM scores seed the smearing (flashlight builds tries the
    same way)."""
    trie = Trie()
    word_list = []
    start = lm.start()
    for word in words:
        if not alphabet.can_encode(word) or not word:
            continue
        word_id = len(word_list)
        word_list.append(word)
        lm_id = lm.lm.vocab_index(word)
        _, score = lm.score(start, lm_id)
        trie.insert(alphabet.encode(word), word_id, score)
    trie.smear()
    return trie, word_list


# -------------------------------------------------------------- hypotheses


@dataclass
class _Hyp:
    score: float
    lm_state: Tuple[int, ...]
    lex: Optional[TrieNode]
    parent: Optional["_Hyp"]
    token: int
    word: int  # emitted word id (-1 = none)
    prev_blank: bool
    am_score: float
    lm_score: float


@dataclass
class FlashlightResult:
    score: float
    am_score: float
    lm_score: float
    words: List[str]
    tokens: List[int]


def _store_candidates(
    candidates: List[_Hyp],
    beam_size: int,
    threshold_floor: float,
    log_add: bool,
) -> List[_Hyp]:
    """Dedup by (lm_state, lex, prev_blank), keep best (or log-add), then
    beam prune (flashlight candidatesStore)."""
    merged: Dict[tuple, _Hyp] = {}
    for hyp in candidates:
        if hyp.score < threshold_floor:
            continue
        key = (hyp.lm_state, id(hyp.lex), hyp.prev_blank, hyp.token)
        best = merged.get(key)
        if best is None:
            merged[key] = hyp
        elif log_add:
            hi, lo = (best.score, hyp.score) if best.score > hyp.score else (
                hyp.score, best.score,
            )
            if hyp.score > best.score:
                merged[key] = hyp
                best = hyp
            best.score = hi + math.log1p(math.exp(lo - hi))
        elif hyp.score > best.score:
            merged[key] = hyp
    out = sorted(merged.values(), key=lambda h: -h.score)
    return out[:beam_size]


def _backtrack(hyp: _Hyp, word_list: List[str], blank_id: int,
               sil_id: int) -> FlashlightResult:
    words: List[str] = []
    tokens: List[int] = []
    node = hyp
    while node is not None:
        if node.word >= 0:
            words.append(word_list[node.word] if word_list else str(node.word))
        if node.token >= 0 and node.token != blank_id:
            tokens.append(node.token)
        node = node.parent
    words.reverse()
    tokens.reverse()
    return FlashlightResult(
        score=hyp.score, am_score=hyp.am_score, lm_score=hyp.lm_score,
        words=words, tokens=tokens,
    )


# ------------------------------------------------------------ lexicon beam


class LexiconDecoder:
    def __init__(
        self,
        trie: Trie,
        word_list: List[str],
        lm: WordLM,
        alphabet: Alphabet,
        beam_size: int = 64,
        beam_size_token: int = 40,
        beam_threshold: float = 25.0,
        lm_weight: float = 1.0,
        word_score: float = 0.0,
        unk_score: float = NEG_INF,
        sil_score: float = 0.0,
        log_add: bool = False,
    ):
        self.trie = trie
        self.word_list = word_list
        self.lm = lm
        self.alphabet = alphabet
        self.blank_id = alphabet.size
        self.sil_id = alphabet.space_index
        self.beam_size = beam_size
        self.beam_size_token = beam_size_token
        self.beam_threshold = beam_threshold
        self.lm_weight = lm_weight
        self.word_score = word_score
        self.unk_score = unk_score
        self.sil_score = sil_score
        self.log_add = log_add
        self.reset()

    def reset(self):
        self.hyps: List[_Hyp] = [
            _Hyp(0.0, self.lm.start(), self.trie.root, None, self.sil_id,
                 -1, False, 0.0, 0.0)
        ]

    def decode_step(self, emissions: np.ndarray) -> None:
        """emissions: [T, C] log-probabilities."""
        for t in range(emissions.shape[0]):
            em = emissions[t]
            top = np.argsort(-em)[: self.beam_size_token]
            candidates: List[_Hyp] = []
            best = NEG_INF
            root = self.trie.root

            def add(hyp: _Hyp):
                nonlocal best
                best = max(best, hyp.score)
                candidates.append(hyp)

            for prev in self.hyps:
                lex = prev.lex
                lex_max = 0.0 if lex is root else lex.max_score
                # (1) trie children
                for n in top:
                    n = int(n)
                    child = lex.children.get(n)
                    if child is None:
                        continue
                    am = float(em[n])
                    score = prev.score + am
                    if n == self.sil_id:
                        score += self.sil_score
                    # continue inside a word
                    if prev.prev_blank or n != prev.token:
                        if child.children:
                            lm_score = child.max_score - lex_max
                            add(_Hyp(
                                score + self.lm_weight * lm_score,
                                prev.lm_state, child, prev, n, -1, False,
                                prev.am_score + am, prev.lm_score + lm_score,
                            ))
                    # complete words at this node
                    for word_id in child.labels:
                        if lex is root and prev.token == n:
                            continue  # CTC: identical tokens need a blank
                        lm_id = self.lm.lm.vocab_index(
                            self.word_list[word_id]
                        )
                        lm_state, raw = self.lm.score(prev.lm_state, lm_id)
                        lm_score = raw - lex_max
                        add(_Hyp(
                            score + self.lm_weight * lm_score + self.word_score,
                            lm_state, root, prev, n, word_id, False,
                            prev.am_score + am, prev.lm_score + lm_score,
                        ))
                    if not child.labels and self.unk_score > NEG_INF:
                        lm_state, raw = self.lm.score(
                            prev.lm_state, self.lm.lm.unk_id
                        )
                        lm_score = raw - lex_max
                        add(_Hyp(
                            score + self.lm_weight * lm_score + self.unk_score,
                            lm_state, root, prev, n, -1, False,
                            prev.am_score + am, prev.lm_score + lm_score,
                        ))
                # (2) stay on the same lexicon node
                if not prev.prev_blank or lex is root:
                    n = self.sil_id if lex is root else prev.token
                    if n >= 0:
                        am = float(em[n])
                        score = prev.score + am
                        if n == self.sil_id:
                            score += self.sil_score
                        add(_Hyp(
                            score, prev.lm_state, lex, prev, n, -1, False,
                            prev.am_score + am, prev.lm_score,
                        ))
                # (3) blank
                am = float(em[self.blank_id])
                add(_Hyp(
                    prev.score + am, prev.lm_state, lex, prev,
                    self.blank_id, -1, True, prev.am_score + am, prev.lm_score,
                ))

            self.hyps = _store_candidates(
                candidates, self.beam_size, best - self.beam_threshold,
                self.log_add,
            )

    def decode_end(self) -> None:
        candidates = []
        nice = any(h.lex is self.trie.root for h in self.hyps)
        for prev in self.hyps:
            if not nice or prev.lex is self.trie.root:
                lm_state, lm_score = self.lm.finish(prev.lm_state)
                candidates.append(_Hyp(
                    prev.score + self.lm_weight * lm_score, lm_state,
                    prev.lex, prev, self.sil_id, -1, False,
                    prev.am_score, prev.lm_score + lm_score,
                ))
            else:
                candidates.append(prev)
        best = max((h.score for h in candidates), default=0.0)
        self.hyps = _store_candidates(
            candidates, self.beam_size, best - self.beam_threshold,
            self.log_add,
        )

    def results(self, num_results: int = 1) -> List[FlashlightResult]:
        return [
            _backtrack(h, self.word_list, self.blank_id, self.sil_id)
            for h in self.hyps[:num_results]
        ]


class LexiconFreeDecoder:
    """Token-level beam with a token/character LM (or no LM).
    The LM here scores TOKENS — pass a WordLM over a character-unit
    KenLM (bytes-mode scorers) or lm=None for pure Viterbi."""

    def __init__(
        self,
        alphabet: Alphabet,
        lm: Optional[WordLM] = None,
        beam_size: int = 64,
        beam_size_token: int = 40,
        beam_threshold: float = 25.0,
        lm_weight: float = 1.0,
        sil_score: float = 0.0,
        log_add: bool = False,
    ):
        self.alphabet = alphabet
        self.lm = lm
        self.blank_id = alphabet.size
        self.sil_id = alphabet.space_index
        self.beam_size = beam_size
        self.beam_size_token = beam_size_token
        self.beam_threshold = beam_threshold
        self.lm_weight = lm_weight
        self.sil_score = sil_score
        self.log_add = log_add
        self.reset()

    def reset(self):
        state = self.lm.start() if self.lm else ()
        self.hyps = [_Hyp(0.0, state, None, None, self.sil_id, -1, False,
                          0.0, 0.0)]

    def _lm_token_id(self, token: int) -> int:
        label = self.alphabet.decode_single(token)
        return self.lm.lm.vocab_index(label)

    def decode_step(self, emissions: np.ndarray) -> None:
        for t in range(emissions.shape[0]):
            em = emissions[t]
            top = np.argsort(-em)[: self.beam_size_token]
            candidates: List[_Hyp] = []
            best = NEG_INF

            def add(h):
                nonlocal best
                best = max(best, h.score)
                candidates.append(h)

            for prev in self.hyps:
                for n in top:
                    n = int(n)
                    am = float(em[n])
                    if n == self.blank_id:
                        add(_Hyp(prev.score + am, prev.lm_state, None, prev,
                                 self.blank_id, -1, True,
                                 prev.am_score + am, prev.lm_score))
                        continue
                    if n == prev.token and not prev.prev_blank:
                        add(_Hyp(prev.score + am, prev.lm_state, None, prev,
                                 n, -1, False, prev.am_score + am,
                                 prev.lm_score))
                        continue
                    score = prev.score + am
                    if n == self.sil_id:
                        score += self.sil_score
                    lm_state, lm_score = prev.lm_state, 0.0
                    if self.lm is not None:
                        lm_state, lm_score = self.lm.score(
                            prev.lm_state, self._lm_token_id(n)
                        )
                        score += self.lm_weight * lm_score
                    add(_Hyp(score, lm_state, None, prev, n, -1, False,
                             prev.am_score + am, prev.lm_score + lm_score))

            self.hyps = _store_candidates(
                candidates, self.beam_size, best - self.beam_threshold,
                self.log_add,
            )

    def decode_end(self) -> None:
        if self.lm is None:
            return
        candidates = []
        for prev in self.hyps:
            lm_state, lm_score = self.lm.finish(prev.lm_state)
            candidates.append(_Hyp(
                prev.score + self.lm_weight * lm_score, lm_state, None,
                prev, prev.token, -1, prev.prev_blank, prev.am_score,
                prev.lm_score + lm_score,
            ))
        best = max((h.score for h in candidates), default=0.0)
        self.hyps = _store_candidates(
            candidates, self.beam_size, best - self.beam_threshold,
            self.log_add,
        )

    def results(self, num_results: int = 1) -> List[FlashlightResult]:
        out = []
        for h in self.hyps[:num_results]:
            res = _backtrack(h, [], self.blank_id, self.sil_id)
            # collapse CTC repeats for the token view
            collapsed: List[int] = []
            node, prev_tok, prev_blank = h, None, True
            chain = []
            while node is not None:
                chain.append(node)
                node = node.parent
            chain.reverse()
            last = None
            for n in chain:
                if n.token == self.blank_id or n.token < 0:
                    last = None
                    continue
                if n.token != last or n.prev_blank:
                    collapsed.append(n.token)
                last = n.token
            res.tokens = collapsed[1:] if collapsed[:1] == [self.sil_id] else collapsed
            res.words = (
                "".join(self.alphabet.decode_single(t) for t in res.tokens)
                .split()
            )
            out.append(res)
        return out


def flashlight_beam_search_decoder(
    log_probs: np.ndarray,
    alphabet: Alphabet,
    scorer,
    vocabulary: Optional[Sequence[str]] = None,
    decoder_type: str = "lexicon",
    beam_size: int = 64,
    beam_size_token: int = 40,
    beam_threshold: float = 25.0,
    lm_weight: float = 1.0,
    word_score: float = 0.0,
    num_results: int = 1,
) -> List[FlashlightResult]:
    """One-shot decode of [T, C] LOG probabilities (reference glue surface
    flashlight_beam_search_decoder, __init__.py:386-572)."""
    lm = WordLM(scorer.lm) if scorer is not None else None
    if decoder_type == "lexicon":
        if vocabulary is None:
            vocabulary = scorer.dictionary.words(alphabet)
        trie, word_list = build_lexicon_trie(vocabulary, alphabet, lm)
        decoder = LexiconDecoder(
            trie, word_list, lm, alphabet, beam_size, beam_size_token,
            beam_threshold, lm_weight, word_score,
        )
    else:
        decoder = LexiconFreeDecoder(
            alphabet, lm, beam_size, beam_size_token, beam_threshold,
            lm_weight,
        )
    decoder.decode_step(np.asarray(log_probs))
    decoder.decode_end()
    return decoder.results(num_results)
