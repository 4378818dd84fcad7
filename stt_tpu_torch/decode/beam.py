"""CTC prefix beam search with LM fusion, hot words and token timings.

Host reference implementation whose observable behavior matches the
reference decoder library (ctcdecode/ctc_beam_search_decoder.cpp,
path_trie.cpp) — the WER gates depend on its subtle semantics:

- streaming: DecoderState.next() consumes [T, C] softmax probabilities in
  chunks; decode() is non-destructive (intermediate transcripts).
- blank = alphabet_size (last class), cpp:33.
- delayed expansion until the first frame with p(blank) < 0.999 so leading
  silence doesn't skew token timings (cpp:120-131).
- with a scorer: beam pre-sorted each frame; min_cutoff early break
  `score + log p(blank) - max(0, beta)` once the beam is full (cpp:134-146).
- emission pruning: classes sorted by prob and truncated by cumulative
  cutoff_prob / cutoff_top_n — top_n only binds when cutoff_prob < 1,
  faithfully mirroring the reference's condition structure (cpp:328-358).
- per-(char, prefix) expansion with the blank / repeat / extend cases and
  log-sum-exp merging (cpp:150-255); LM scored at word boundaries (space
  in word mode, codepoint completion in bytes mode) with alpha/beta and
  additive hot-word boosts over every word of the n-gram (cpp:219-242).
- prefixes live in a trie; timesteps live in a shared tree updated only
  when a higher-probability path claims the prefix (path_trie.cpp:159-190).
- decode() rescoring of the trailing partial word (cpp:288-301).

A copy of the Python decoder of stt_tpu/decode/beam.py, its wav2vec2
variant (`Wav2vec2DecoderState`: any blank index, ignored symbols, AM
tokens remapped onto the scorer's alphabet), and its factory:
`make_decoder_state` takes the native C++ decoder (decode/native.py) by
default, as stt_tpu does, but never falls back to this module's.
"""

from __future__ import annotations

import math
from collections import namedtuple
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from stt_tpu_torch.alphabet import Alphabet
from stt_tpu_torch.decode.scorer import ScorerBase

NEG_INF = -float("inf")
_FLT_MIN = 1.1754944e-38  # matches the reference's NUM_FLT_MIN log floor

DecodeResult = namedtuple(
    "DecodeResult", ["confidence", "transcript", "tokens", "timesteps"]
)


def _lse(x: float, y: float) -> float:
    if x == NEG_INF:
        return y
    if y == NEG_INF:
        return x
    hi, lo = (x, y) if x > y else (y, x)
    return hi + math.log1p(math.exp(lo - hi))


class _TimestepNode:
    __slots__ = ("parent", "data", "children")

    def __init__(self, parent=None, data: int = -1):
        self.parent = parent
        self.data = data
        self.children: List["_TimestepNode"] = []

    def child(self, data: int) -> "_TimestepNode":
        for c in self.children:
            if c.data == data:
                return c
        node = _TimestepNode(self, data)
        self.children.append(node)
        return node

    def history(self) -> List[int]:
        out: List[int] = []
        node = self
        while node.parent is not None:
            out.append(node.data)
            node = node.parent
        out.reverse()
        return out


class _Prefix:
    ROOT = -1
    __slots__ = (
        "character",
        "parent",
        "children",
        "exists",
        "log_prob_b_prev",
        "log_prob_nb_prev",
        "log_prob_b_cur",
        "log_prob_nb_cur",
        "score",
        "timesteps",
        "previous_timesteps",
        "new_timestep",
        "dict_state",
    )

    def __init__(self, character: int = ROOT, parent: Optional["_Prefix"] = None):
        self.character = character
        self.parent = parent
        self.children: Dict[int, "_Prefix"] = {}
        self.exists = True
        self.log_prob_b_prev = NEG_INF
        self.log_prob_nb_prev = NEG_INF
        self.log_prob_b_cur = NEG_INF
        self.log_prob_nb_cur = NEG_INF
        self.score = NEG_INF
        self.timesteps: Optional[_TimestepNode] = None
        self.previous_timesteps: Optional[_TimestepNode] = None
        self.new_timestep = -1
        self.dict_state = None

    def get_child(self, label: int, trie) -> Optional["_Prefix"]:
        """Child prefix for `label`, reviving pruned nodes; None when a
        dictionary trie rejects the expansion (path_trie.cpp:37-101)."""
        node = self.children.get(label)
        if node is not None:
            if not node.exists:
                node.exists = True
                node.log_prob_b_prev = NEG_INF
                node.log_prob_nb_prev = NEG_INF
                node.log_prob_b_cur = NEG_INF
                node.log_prob_nb_cur = NEG_INF
            return node
        if trie is not None:
            next_state = trie.step(self.dict_state, label, reset=True)
            if next_state is None:
                return None
        else:
            next_state = None
        node = _Prefix(label, self)
        node.dict_state = next_state
        self.children[label] = node
        return node

    def path_tokens(self) -> List[int]:
        out: List[int] = []
        node = self
        while node.parent is not None:
            out.append(node.character)
            node = node.parent
        out.reverse()
        return out

    def iterate_to_vec(self, out: List["_Prefix"]) -> None:
        """Roll cur->prev, refresh score + timesteps, collect live nodes.
        Children first: their previous_timesteps may point at ancestors."""
        for child in self.children.values():
            child.iterate_to_vec(out)
        if self.exists:
            self.log_prob_b_prev = self.log_prob_b_cur
            self.log_prob_nb_prev = self.log_prob_nb_cur
            self.log_prob_b_cur = NEG_INF
            self.log_prob_nb_cur = NEG_INF
            self.score = _lse(self.log_prob_b_prev, self.log_prob_nb_prev)
            if self.previous_timesteps is not None:
                self.timesteps = self.previous_timesteps.child(self.new_timestep)
            self.previous_timesteps = None
            out.append(self)

    def remove(self) -> None:
        self.exists = False
        if not self.children and self.parent is not None:
            del self.parent.children[self.character]
            if not self.parent.children and not self.parent.exists:
                self.parent.remove()

    # words/graphemes for LM n-grams ---------------------------------------
    # Both return (labels, stop) with the same contract as the reference's
    # get_prev_word / get_prev_grapheme (path_trie.cpp:113-157): labels are
    # the unit ending at this node; the n-gram walk continues from
    # stop.parent.

    def prev_word(self, space_index: int) -> Tuple[List[int], "_Prefix"]:
        """Word ending at this node; stop = its space/root ancestor (or
        this node itself if it is already a boundary)."""
        if self.character == space_index or self.character == _Prefix.ROOT:
            return [], self
        labels: List[int] = []
        node = self
        while True:
            labels.append(node.character)
            parent = node.parent
            if (
                parent is None
                or parent.character == space_index
                or parent.character == _Prefix.ROOT
            ):
                stop = parent if parent is not None else node
                break
            node = parent
        labels.reverse()
        return labels, stop

    def prev_grapheme(self) -> Tuple[List[int], "_Prefix"]:
        """UTF-8 codepoint (byte labels) ending at this node; stop = the
        codepoint's first-byte node. Bytes-mode label n -> byte n+1."""
        if self.character == _Prefix.ROOT:
            return [], self
        labels: List[int] = []
        node = self
        while True:
            labels.append(node.character)
            byte = (node.character + 1) & 0xFF
            if (byte & 0xC0) != 0x80 or node.parent is None:
                stop = node
                break
            node = node.parent
        labels.reverse()
        return labels, stop


def _codepoint_complete(prefix: "_Prefix", alphabet: Alphabet) -> bool:
    """Bytes mode boundary: prefix's trailing bytes form a whole codepoint
    (scorer.cpp:271-299)."""
    if prefix.character == _Prefix.ROOT:
        return False
    # walk back to the codepoint's first byte
    distance = 0
    node = prefix
    first_byte = None
    while node is not None and node.character != _Prefix.ROOT:
        distance += 1
        b = (node.character + 1) & 0xFF  # UTF8Alphabet: index n -> byte n+1
        if (b & 0xC0) != 0x80:
            first_byte = b
            break
        node = node.parent
    if first_byte is None:
        return False
    if (first_byte >> 3) == 0x1E:
        needed = 4
    elif (first_byte >> 4) == 0x0E:
        needed = 3
    elif (first_byte >> 5) == 0x06:
        needed = 2
    elif (first_byte >> 7) == 0x00:
        needed = 1
    else:
        return False
    return distance == needed


class DecoderState:
    """Stateful streaming CTC beam search."""

    def __init__(
        self,
        alphabet: Alphabet,
        beam_size: int,
        cutoff_prob: float = 1.0,
        cutoff_top_n: int = 40,
        scorer: Optional[ScorerBase] = None,
        hot_words: Optional[Dict[str, float]] = None,
    ):
        self.alphabet = alphabet
        self.beam_size = int(beam_size)
        self.cutoff_prob = float(cutoff_prob)
        self.cutoff_top_n = int(cutoff_top_n)
        self.scorer = scorer
        self.hot_words = dict(hot_words or {})
        self.blank_id = alphabet.size
        self.space_id = alphabet.space_index
        self.abs_time_step = 0
        self.start_expanding = False

        self.timestep_root = _TimestepNode()
        root = _Prefix()
        root.score = 0.0
        root.log_prob_b_prev = 0.0
        root.timesteps = self.timestep_root
        if scorer is not None and scorer.dictionary is not None:
            root.dict_state = scorer.dictionary.start
        self.root = root
        self.prefixes: List[_Prefix] = [root]

    def _to_scorer_token(self, am_token: int) -> int:
        """AM token -> prefix label (identity; wav2vec2 variant remaps)."""
        return am_token

    # -- scoring helpers ---------------------------------------------------

    def _make_ngram(self, prefix: _Prefix) -> List[str]:
        scorer = self.scorer
        ngram: List[str] = []
        node = prefix
        for _ in range(scorer.get_max_order()):
            if node is None or node.character == _Prefix.ROOT:
                break
            if scorer.is_utf8_mode():
                labels, stop = node.prev_grapheme()
            else:
                labels, stop = node.prev_word(self.space_id)
            node = stop.parent
            ngram.append(self.alphabet.decode(labels))
        ngram.reverse()
        return ngram

    def _is_scoring_boundary(self, prefix: _Prefix, new_label: int) -> bool:
        if self.scorer.is_utf8_mode():
            return _codepoint_complete(prefix, self.alphabet)
        return new_label == self.space_id

    def _lm_score(self, prefix_to_score: _Prefix) -> float:
        scorer = self.scorer
        ngram = self._make_ngram(prefix_to_score)
        hot_boost = 0.0
        if self.hot_words:
            for word in ngram:
                boost = self.hot_words.get(word)
                if boost is not None:
                    hot_boost += boost
        bos = len(ngram) < scorer.get_max_order()
        return (
            scorer.get_log_cond_prob(ngram, bos) + hot_boost
        ) * scorer.alpha + scorer.beta

    def _pruned_emissions(self, prob: np.ndarray) -> List[Tuple[int, float]]:
        n = prob.shape[0]
        pairs = [(i, float(prob[i])) for i in range(n)]
        cutoff_len = n
        if self.cutoff_prob < 1.0 or self.cutoff_top_n < n:
            pairs.sort(key=lambda p: -p[1])
            if self.cutoff_prob < 1.0:
                cum, cutoff_len = 0.0, 0
                for _, p in pairs:
                    cum += p
                    cutoff_len += 1
                    if cum >= self.cutoff_prob or cutoff_len >= self.cutoff_top_n:
                        break
            pairs = pairs[:cutoff_len]
        return [(i, math.log(p + _FLT_MIN)) for i, p in pairs]

    # -- core --------------------------------------------------------------

    def next(self, probs: np.ndarray) -> None:
        """Advance over a [T, C] chunk of softmax probabilities."""
        probs = np.asarray(probs)
        for rel_t in range(probs.shape[0]):
            prob = probs[rel_t]
            self._step(
                self._pruned_emissions(prob), float(prob[self.blank_id])
            )

    def next_pruned(
        self,
        indices: np.ndarray,
        logps: np.ndarray,
        counts: np.ndarray,
        blank_probs: np.ndarray,
    ) -> None:
        """Advance over device-pruned emissions (decode/device.py
        prune_emissions): per frame the top-k candidate (class, logp)
        pairs sorted by descending probability, the number of valid
        candidates, and the raw blank probability (for the expansion
        gate and the scorer min_cutoff). Host work per frame is
        O(count x beam), independent of the alphabet size."""
        indices = np.asarray(indices)
        logps = np.asarray(logps)
        counts = np.asarray(counts)
        blank_probs = np.asarray(blank_probs)
        for rel_t in range(indices.shape[0]):
            n = int(counts[rel_t])
            pruned = [
                (int(indices[rel_t, k]), float(logps[rel_t, k]))
                for k in range(n)
            ]
            self._step(pruned, float(blank_probs[rel_t]))

    def _step(
        self, pruned: List[Tuple[int, float]], blank_prob: float
    ) -> None:
        """One frame of expansion given pruned (class, logp) candidates."""
        scorer = self.scorer
        beam_size = self.beam_size
        if blank_prob < 0.999:
            self.start_expanding = True
        if not self.start_expanding:
            self.abs_time_step += 1
            return

        min_cutoff = NEG_INF
        full_beam = False
        if scorer is not None:
            self.prefixes.sort(key=lambda p: (-p.score, p.character))
            num_prefixes = min(len(self.prefixes), beam_size)
            min_cutoff = (
                self.prefixes[num_prefixes - 1].score
                + math.log(blank_prob + _FLT_MIN)
                - max(0.0, scorer.beta)
            )
            full_beam = num_prefixes == beam_size
        trie = scorer.dictionary if scorer is not None else None

        for c, log_prob_c in pruned:
            # `c` is the AM token (blank test); `scorer_c` is the prefix
            # label (identity except in the wav2vec2 variant, cpp:150)
            scorer_c = self._to_scorer_token(c)
            for prefix in self.prefixes[:beam_size]:
                if full_beam and log_prob_c + prefix.score < min_cutoff:
                    break
                if prefix.score == NEG_INF:
                    continue

                if c == self.blank_id:
                    log_p = log_prob_c + prefix.score
                    if prefix.log_prob_nb_cur < log_p:
                        prefix.previous_timesteps = None
                    prefix.log_prob_b_cur = _lse(prefix.log_prob_b_cur, log_p)
                    continue

                if scorer_c == prefix.character:
                    log_p = log_prob_c + prefix.log_prob_nb_prev
                    if prefix.log_prob_nb_cur < log_p:
                        prefix.previous_timesteps = None
                    prefix.log_prob_nb_cur = _lse(
                        prefix.log_prob_nb_cur, log_p
                    )

                new_prefix = prefix.get_child(scorer_c, trie)
                if new_prefix is None:
                    continue

                log_p = NEG_INF
                if (
                    scorer_c == prefix.character
                    and prefix.log_prob_b_prev != NEG_INF
                ):
                    log_p = log_prob_c + prefix.log_prob_b_prev
                elif scorer_c != prefix.character:
                    log_p = log_prob_c + prefix.score

                if scorer is not None:
                    to_score = (
                        new_prefix if scorer.is_utf8_mode() else prefix
                    )
                    if self._is_scoring_boundary(to_score, scorer_c):
                        log_p += self._lm_score(to_score)

                if new_prefix.log_prob_nb_cur < log_p:
                    new_prefix.previous_timesteps = prefix.timesteps
                    new_prefix.new_timestep = self.abs_time_step
                new_prefix.log_prob_nb_cur = _lse(
                    new_prefix.log_prob_nb_cur, log_p
                )

        self.prefixes = []
        self.root.iterate_to_vec(self.prefixes)
        if len(self.prefixes) > beam_size:
            self.prefixes.sort(key=lambda p: (-p.score, p.character))
            for p in self.prefixes[beam_size:]:
                p.remove()
            self.prefixes = self.prefixes[:beam_size]

        self.abs_time_step += 1

    def decode(self, num_results: int = 1) -> List[DecodeResult]:
        """Non-destructive best-hypotheses extraction with trailing partial
        word rescoring."""
        candidates = list(self.prefixes)
        scores = {id(p): p.score for p in candidates}
        if self.scorer is not None:
            for prefix in candidates[: self.beam_size]:
                boundary_node = (
                    prefix if self.scorer.is_utf8_mode() else prefix.parent
                )
                if boundary_node is not None and not self._is_scoring_boundary(
                    boundary_node, prefix.character
                ):
                    ngram = self._make_ngram(prefix)
                    bos = len(ngram) < self.scorer.get_max_order()
                    scores[id(prefix)] += (
                        self.scorer.get_log_cond_prob(ngram, bos)
                        * self.scorer.alpha
                        + self.scorer.beta
                    )
        candidates.sort(key=lambda p: (-scores[id(p)], p.character))
        results = []
        for prefix in candidates[:num_results]:
            tokens = prefix.path_tokens()
            timesteps = (
                prefix.timesteps.history() if prefix.timesteps is not None else []
            )
            results.append(
                DecodeResult(
                    confidence=scores[id(prefix)],
                    transcript=self.alphabet.decode(tokens),
                    tokens=tokens,
                    timesteps=timesteps,
                )
            )
        return results


def make_decoder_state(
    alphabet: Alphabet,
    beam_size: int,
    cutoff_prob: float = 1.0,
    cutoff_top_n: int = 40,
    scorer: Optional[ScorerBase] = None,
    hot_words: Optional[Dict[str, float]] = None,
    implementation: str = "auto",
):
    """DecoderState factory. implementation: 'auto' | 'python' | 'native'.

    'auto' takes the native (C++) decoder unless the scorer has no file
    path (a StaticScorer, a package loaded from a buffer), which only the
    Python decoder takes. Unlike stt_tpu, 'auto' never falls back to the
    Python decoder when the native library cannot be built: that raises
    RuntimeError with the compiler's message."""
    if implementation not in ("auto", "python", "native"):
        raise ValueError(f"unknown decoder implementation {implementation!r}")
    if implementation != "python":
        scorer_path = getattr(scorer, "path", None)
        if scorer is None or scorer_path is not None:
            from stt_tpu_torch.decode import native

            return native.NativeDecoderState(
                alphabet,
                beam_size,
                cutoff_prob,
                cutoff_top_n,
                scorer_path=scorer_path,
                alpha=scorer.alpha if scorer is not None else None,
                beta=scorer.beta if scorer is not None else None,
                hot_words=hot_words,
            )
        if implementation == "native":
            raise RuntimeError(
                "the native decoder reads its scorer from a file, and this "
                "scorer has no path"
            )
    return DecoderState(
        alphabet, beam_size, cutoff_prob, cutoff_top_n, scorer, hot_words
    )


def ctc_beam_search_decoder(
    probs: np.ndarray,
    alphabet: Alphabet,
    beam_size: int,
    cutoff_prob: float = 1.0,
    cutoff_top_n: int = 40,
    scorer: Optional[ScorerBase] = None,
    hot_words: Optional[Dict[str, float]] = None,
    num_results: int = 1,
    implementation: str = "auto",
) -> List[DecodeResult]:
    """One-shot decode of [T, C] softmax probabilities."""
    state = make_decoder_state(
        alphabet, beam_size, cutoff_prob, cutoff_top_n, scorer, hot_words,
        implementation,
    )
    state.next(probs)
    return state.decode(num_results)


def ctc_beam_search_decoder_batch(
    probs_batch: Sequence[np.ndarray],
    seq_lengths: Sequence[int],
    alphabet: Alphabet,
    beam_size: int,
    num_processes: int = 1,
    cutoff_prob: float = 1.0,
    cutoff_top_n: int = 40,
    scorer: Optional[ScorerBase] = None,
    hot_words: Optional[Dict[str, float]] = None,
    num_results: int = 1,
    implementation: str = "auto",
) -> List[List[DecodeResult]]:
    """Decode a batch of utterances (parallel fan-out like the reference's
    ThreadPool wrapper, cpp:608-702). With the native decoder, worker
    threads run truly concurrently: ctypes releases the GIL around each
    call into the library."""
    items = [
        np.asarray(p)[: int(n)] for p, n in zip(probs_batch, seq_lengths)
    ]

    def one(p):
        return ctc_beam_search_decoder(
            p, alphabet, beam_size, cutoff_prob, cutoff_top_n, scorer,
            hot_words, num_results, implementation,
        )

    if num_processes <= 1 or len(items) <= 1:
        return [one(p) for p in items]
    with ThreadPoolExecutor(max_workers=num_processes) as pool:
        return list(pool.map(one, items))


class Wav2vec2DecoderState(DecoderState):
    """Beam search for external (wav2vec2-style) acoustic models whose
    class layout differs from this framework's convention
    (ctc_beam_search_decoder.cpp:73-110 CTCDecoderForWav2vec2AM):

    - blank may be any index (wav2vec2 uses 0), not alphabet_size;
    - some AM symbols (e.g. <pad>/<s>/</s> controls) are ignored
      entirely during expansion;
    - AM token ids are remapped onto scorer-alphabet ids so the
      vocabulary trie and LM n-grams line up.

    `am_alphabet` decodes AM ids to strings; the scorer alphabet (from
    the DecoderState's `alphabet` argument) defines prefix labels.
    """

    def __init__(
        self,
        alphabet: Alphabet,
        beam_size: int,
        blank_id: int,
        am_alphabet: Optional[Alphabet] = None,
        ignored_symbols: Sequence[int] = (),
        cutoff_prob: float = 1.0,
        cutoff_top_n: int = 40,
        scorer: Optional[ScorerBase] = None,
        hot_words: Optional[Dict[str, float]] = None,
    ):
        super().__init__(
            alphabet, beam_size, cutoff_prob, cutoff_top_n, scorer, hot_words
        )
        self.blank_id = blank_id
        self.ignored = set(int(i) for i in ignored_symbols)
        self._am_to_scorer: Dict[int, int] = {}
        if am_alphabet is not None:
            for am_token in range(am_alphabet.size):
                if am_token == blank_id or am_token in self.ignored:
                    continue
                label = am_alphabet.decode_single(am_token)
                if alphabet.can_encode_single(label):
                    self._am_to_scorer[am_token] = alphabet.encode_single(label)

    def _remap(self, am_token: int) -> int:
        return self._am_to_scorer.get(am_token, am_token)

    def _pruned_emissions(self, prob: np.ndarray) -> List[Tuple[int, float]]:
        """Ignored symbols are dropped; blank goes last so the timestep
        merge assumption holds (cpp: 'Blank must go last')."""
        pairs = [
            (i, float(prob[i]))
            for i in range(prob.shape[0])
            if i != self.blank_id and i not in self.ignored
        ]
        pairs.append((self.blank_id, float(prob[self.blank_id])))
        n = prob.shape[0]
        cutoff_len = n
        if self.cutoff_prob < 1.0 or self.cutoff_top_n < n:
            pairs.sort(key=lambda p: -p[1])
            if self.cutoff_prob < 1.0:
                cum, cutoff_len = 0.0, 0
                for _, p in pairs:
                    cum += p
                    cutoff_len += 1
                    if cum >= self.cutoff_prob or cutoff_len >= self.cutoff_top_n:
                        break
            pairs = pairs[:cutoff_len]
        return [(i, math.log(p + _FLT_MIN)) for i, p in pairs]

    def _to_scorer_token(self, am_token: int) -> int:
        return self._am_to_scorer.get(am_token, am_token)


def ctc_beam_search_decoder_for_wav2vec2am(
    probs: np.ndarray,
    alphabet: Alphabet,
    beam_size: int,
    blank_id: int,
    am_alphabet: Optional[Alphabet] = None,
    ignored_symbols: Sequence[int] = (),
    cutoff_prob: float = 1.0,
    cutoff_top_n: int = 40,
    scorer: Optional[ScorerBase] = None,
    hot_words: Optional[Dict[str, float]] = None,
    num_results: int = 1,
) -> List[DecodeResult]:
    state = Wav2vec2DecoderState(
        alphabet, beam_size, blank_id, am_alphabet, ignored_symbols,
        cutoff_prob, cutoff_top_n, scorer, hot_words,
    )
    state.next(probs)
    return state.decode(num_results)
