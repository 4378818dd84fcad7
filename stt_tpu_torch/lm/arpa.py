"""ARPA n-gram models: read/write, and interpolated modified-Kneser-Ney
estimation from text.

This replaces the reference's dependency on external KenLM binaries
(`lmplz` subprocess calls in data/lm/generate_lm.py:79-129) with a
native estimator usable for domain scorers; large-corpus estimation can
still ingest an externally-built ARPA through `read_arpa`.

Probabilities are log10 (ARPA convention). Backoff entries are omitted
for highest order; missing backoff means 0.0.

The port's copy of `stt_tpu/lm/arpa.py`, so the two packages read and
write the same files.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

NGram = Tuple[str, ...]

BOS = "<s>"
EOS = "</s>"
UNK = "<unk>"


class ArpaModel:
    def __init__(self, order: int):
        self.order = order
        # per order (1-based): {ngram tuple: (log10 prob, log10 backoff)}
        self.ngrams: List[Dict[NGram, Tuple[float, float]]] = [
            {} for _ in range(order)
        ]

    def add(self, ngram: NGram, prob: float, backoff: float = 0.0) -> None:
        self.ngrams[len(ngram) - 1][ngram] = (prob, backoff)

    def counts(self) -> List[int]:
        return [len(d) for d in self.ngrams]

    @property
    def vocabulary(self) -> List[str]:
        return [w for (w,) in self.ngrams[0]]

    # -- scoring (reference semantics, used for oracle tests) --------------

    def score(self, context: NGram, word: str) -> float:
        """log10 P(word | context) with standard Katz backoff walk."""
        context = tuple(context)[-(self.order - 1) :]
        for i in range(len(context) + 1):
            ngram = context[i:] + (word,)
            entry = self.ngrams[len(ngram) - 1].get(ngram)
            if entry is not None:
                prob = entry[0]
                # charge backoffs of longer context suffixes
                for j in range(i):
                    ctx = context[j:]
                    ctx_entry = self.ngrams[len(ctx) - 1].get(ctx)
                    if ctx_entry is not None:
                        prob += ctx_entry[1]
                return prob
        unk = self.ngrams[0].get((UNK,))
        prob = unk[0] if unk else -99.0
        for j in range(len(context)):
            ctx = context[j:]
            ctx_entry = self.ngrams[len(ctx) - 1].get(ctx)
            if ctx_entry is not None:
                prob += ctx_entry[1]
        return prob


def read_arpa(path_or_lines) -> ArpaModel:
    if isinstance(path_or_lines, str):
        with open(path_or_lines, "r", encoding="utf-8") as f:
            lines = f.read().splitlines()
    else:
        lines = list(path_or_lines)
    it = iter(lines)
    counts = []
    for line in it:
        line = line.strip()
        if line == "\\data\\":
            break
    for line in it:
        line = line.strip()
        if not line:
            break
        if line.startswith("ngram"):
            counts.append(int(line.split("=")[1]))
    model = ArpaModel(len(counts))
    current = 0
    for line in it:
        line = line.strip()
        if not line:
            continue
        if line == "\\end\\":
            break
        if line.startswith("\\") and line.endswith("-grams:"):
            current = int(line[1:].split("-")[0])
            continue
        parts = line.split("\t")
        if len(parts) < 2:
            parts = line.split()
            parts = [parts[0], " ".join(parts[1:current + 1])] + parts[current + 1:]
        prob = float(parts[0])
        ngram = tuple(parts[1].split())
        backoff = float(parts[2]) if len(parts) > 2 else 0.0
        model.add(ngram, prob, backoff)
    return model


def write_arpa(model: ArpaModel, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write("\\data\\\n")
        for i, count in enumerate(model.counts(), start=1):
            f.write(f"ngram {i}={count}\n")
        for i, table in enumerate(model.ngrams, start=1):
            f.write(f"\n\\{i}-grams:\n")
            for ngram, (prob, backoff) in table.items():
                text = " ".join(ngram)
                if i < model.order and backoff != 0.0:
                    f.write(f"{prob:.7f}\t{text}\t{backoff:.7f}\n")
                else:
                    f.write(f"{prob:.7f}\t{text}\n")
        f.write("\n\\end\\\n")


class DiscountEstimationError(ValueError):
    """Count-of-count discount estimation failed (same condition that
    makes lmplz say 'Could not calculate Kneser-Ney discounts ... rerun
    with --discount_fallback')."""


def estimate_discounts(
    adjusted_counts: List[Counter], fallback: bool = False
) -> List[Tuple[float, float, float]]:
    """Per-order modified Kneser-Ney discounts (D1, D2, D3+) from
    counts-of-adjusted-counts — lmplz's estimation (Heafield et al.
    2013, 'Scalable Modified Kneser-Ney Language Model Estimation' §3.2;
    reference pipeline shells to it, data/lm/generate_lm.py:79-97):

        Y   = n1 / (n1 + 2 n2)
        D_k = k - (k + 1) Y n_{k+1} / n_k          for k = 1, 2, 3

    with n_k the number of n-grams of that order whose adjusted count is
    exactly k. fallback=True mirrors lmplz --discount_fallback
    (0.5/1.0/1.5 defaults when estimation is impossible on tiny counts).
    """
    out = []
    for n, table in enumerate(adjusted_counts, start=1):
        cc = Counter()
        for c in table.values():
            if 1 <= c <= 4:
                cc[c] += 1
        try:
            if any(cc[k] == 0 for k in (1, 2, 3, 4)):
                raise DiscountEstimationError(
                    f"order {n}: zero count-of-counts {dict(cc)}"
                )
            y = cc[1] / (cc[1] + 2.0 * cc[2])
            ds = tuple(
                k - (k + 1.0) * y * cc[k + 1] / cc[k] for k in (1, 2, 3)
            )
            if any(not (0.0 <= d <= k) for d, k in zip(ds, (1, 2, 3))):
                raise DiscountEstimationError(
                    f"order {n}: discounts out of range {ds}"
                )
            out.append(ds)
        except DiscountEstimationError:
            if not fallback:
                raise
            out.append((0.5, 1.0, 1.5))
    return out


def estimate_kneser_ney_lmplz(
    sentences: Iterable[List[str]],
    order: int = 3,
    vocabulary: Optional[set] = None,
    discount_fallback: bool = False,
    prune: Optional[List[int]] = None,
) -> ArpaModel:
    """Interpolated MODIFIED Kneser-Ney with per-order count-of-counts
    discount estimation — the algorithm lmplz implements (the reference
    pipeline's estimator; the reference vendors KenLM's query code only,
    not its estimator, so this follows the published algorithm):

    - adjusted counts: raw at the highest order and for n-grams starting
      with <s>; left-extension type counts (continuation) below;
    - three discounts per order from counts-of-adjusted-counts
      (estimate_discounts above);
    - pseudo-probability u(w|c) = (a(cw) - D(a(cw))) / sum_w a(cw) and
      interpolation weight gamma(c) = (D1 N1(c) + D2 N2(c) + D3 N3+(c))
      / sum_w a(cw), interpolated down to unigrams and finally the
      uniform distribution over the vocabulary (lmplz
      --interpolate_unigrams default);
    - <s> carries -99 unigram log-prob with a real backoff weight;
      <unk> gets the uniform-interpolation share.

    prune: per-order minimum adjusted-count thresholds like lmplz
    --prune (0 = keep all; applied to orders 2..N, never unigrams).
    Correctness gate (tests/test_lm_pipeline.py): for every context the
    backoff-walk distribution sums to 1 — the invariant lmplz output
    satisfies — plus hand-computed discounts on a toy corpus.
    """
    counts: List[Counter] = [Counter() for _ in range(order)]
    for words in sentences:
        if vocabulary is not None:
            words = [w if w in vocabulary else UNK for w in words]
        toks = [BOS] + list(words) + [EOS]
        for n in range(1, order + 1):
            for i in range(len(toks) - n + 1):
                counts[n - 1][tuple(toks[i : i + n])] += 1

    # adjusted counts: highest order raw; below, the number of distinct
    # left extensions — except <s>-initial n-grams (nothing can precede
    # <s>), which keep raw counts
    adjusted: List[Counter] = [Counter() for _ in range(order)]
    adjusted[order - 1] = Counter(counts[order - 1])
    for n in range(order - 1, 0, -1):
        higher = counts[n] if n < order else counts[order - 1]
        seen = set()
        for g in higher:
            suffix = g[1:]
            key = (g[0], suffix)
            if key not in seen:
                seen.add(key)
                adjusted[n - 1][suffix] += 1
        for g, c in counts[n - 1].items():
            if g[0] == BOS:
                adjusted[n - 1][g] = c

    discounts = estimate_discounts(adjusted, fallback=discount_fallback)

    def D(n: int, count: int) -> float:
        if count <= 0:
            return 0.0
        d1, d2, d3 = discounts[n - 1]
        return d1 if count == 1 else d2 if count == 2 else d3

    if prune:
        thresholds = list(prune) + [0] * (order - len(prune))
        full_adjusted = [Counter(t) for t in adjusted]
        for n in range(2, order + 1):
            t = thresholds[n - 1] if n - 1 < len(thresholds) else 0
            if t:
                # lmplz --prune drops n-grams with adjusted count <= t
                # (keeps strictly greater), see kenlm lm/builder docs
                adjusted[n - 1] = Counter(
                    {g: c for g, c in adjusted[n - 1].items() if c > t}
                )
        # context protection (lmplz keeps every kept n-gram's prefix so
        # the ARPA stays reachable): re-add missing prefixes top-down
        for n in range(order, 2, -1):
            for g in adjusted[n - 1]:
                prefix = g[:-1]
                if prefix not in adjusted[n - 2]:
                    adjusted[n - 2][prefix] = full_adjusted[n - 2][prefix]

    # <s> is never predictable: it leaves the unigram distribution
    # entirely (no count in the denominator, no probability row beyond
    # the conventional -99 entry), like lmplz
    adjusted[0].pop((BOS,), None)

    # group each order by context
    by_context: List[Dict[NGram, List[Tuple[str, int]]]] = []
    for n in range(1, order + 1):
        ctxs: Dict[NGram, List[Tuple[str, int]]] = defaultdict(list)
        for g, c in adjusted[n - 1].items():
            ctxs[g[:-1]].append((g[-1], c))
        by_context.append(ctxs)

    # predictable vocabulary: every word that can follow a context
    # (includes <unk> and </s>, excludes <s>) — the uniform base
    # distribution ranges over exactly this set so that every context's
    # distribution sums to 1
    vocab = sorted({w for (w,) in adjusted[0]} | {UNK, EOS})
    n_vocab = len(vocab)

    # interpolated probabilities, bottom-up
    probs: List[Dict[NGram, float]] = [dict() for _ in range(order)]
    gammas: List[Dict[NGram, float]] = [dict() for _ in range(order)]

    def lower_prob(g: NGram) -> float:
        """Interpolated p(last word | shorter context) for the suffix
        g; when pruning removed the suffix row, walk further down
        through the backoff weights."""
        if len(g) == 0:
            return 1.0 / n_vocab
        p = probs[len(g) - 1].get(g)
        if p is not None:
            return p
        return gammas[len(g) - 1].get(g[:-1], 1.0) * lower_prob(g[1:])

    for n in range(1, order + 1):
        for ctx, items in by_context[n - 1].items():
            denom = float(sum(c for _, c in items))
            if denom <= 0:
                continue
            dmass = sum(D(n, c) for _, c in items)
            gamma = dmass / denom
            gammas[n - 1][ctx] = gamma
            for w, c in items:
                u = (c - D(n, c)) / denom
                suffix = (ctx + (w,))[1:]
                probs[n - 1][ctx + (w,)] = u + gamma * lower_prob(suffix)
        if n == 1:
            # <unk> (adjusted count 0) takes the uniform share
            gamma = gammas[0].get((), 0.0)
            probs[0].setdefault((UNK,), gamma / n_vocab)

    model = ArpaModel(order)
    for w in vocab:
        p = probs[0].get((w,))
        if p is None or p <= 0:
            p = 1e-99
        backoff = gammas[1].get((w,), 0.0) if order > 1 else 0.0
        model.add(
            (w,), math.log10(p),
            math.log10(backoff) if backoff > 0 else 0.0,
        )
    bos_backoff = gammas[1].get((BOS,), 0.0) if order > 1 else 0.0
    model.add(
        (BOS,), -99.0,
        math.log10(bos_backoff) if bos_backoff > 0 else 0.0,
    )
    for n in range(2, order + 1):
        for g, p in probs[n - 1].items():
            if p <= 0:
                continue
            backoff = gammas[n].get(g, 0.0) if n < order else 0.0
            model.add(
                g, math.log10(p),
                math.log10(backoff) if backoff > 0 else 0.0,
            )
    return model


def estimate_kneser_ney(
    sentences: Iterable[List[str]],
    order: int = 3,
    discount: float = 0.75,
    vocabulary: Optional[set] = None,
) -> ArpaModel:
    """Interpolated Kneser-Ney with a FIXED discount — kept as the
    simple estimator; `estimate_kneser_ney_lmplz` implements the
    reference pipeline's (lmplz) count-of-counts estimation and is what
    tools/generate_lm.py uses. Sentences are word lists; BOS/EOS are
    added here."""
    counts: List[Counter] = [Counter() for _ in range(order)]
    for words in sentences:
        if vocabulary is not None:
            words = [w if w in vocabulary else UNK for w in words]
        toks = [BOS] + list(words) + [EOS]
        for n in range(1, order + 1):
            for i in range(len(toks) - n + 1):
                ngram = tuple(toks[i : i + n])
                if n == 1 and ngram == (BOS,):
                    continue  # <s> gets no unigram probability
                counts[n - 1][ngram] += 1

    # continuation counts for lower orders (KN): N1+(• w)
    continuation: List[Counter] = [Counter() for _ in range(order)]
    for n in range(2, order + 1):
        seen = set()
        for ngram in counts[n - 1]:
            suffix = ngram[1:]
            key = (ngram[0], suffix)
            if key not in seen:
                seen.add(key)
                continuation[n - 2][suffix] += 1

    model = ArpaModel(order)
    vocab = set(w for (w,) in counts[0]) | {UNK}
    total_continuation_bigrams = sum(continuation[0].values())

    def interp_prob(ngram: NGram) -> float:
        """Interpolated KN probability (linear domain)."""
        n = len(ngram)
        if n == 1:
            # continuation probability at the bottom, uniform floor for unk
            cont = continuation[0].get(ngram, 0)
            p = cont / max(total_continuation_bigrams, 1)
            return p if p > 0 else 1.0 / (10 * max(len(vocab), 1))
        prefix = ngram[:-1]
        if n == order:
            num = counts[n - 1].get(ngram, 0)
            den = counts[n - 2].get(prefix, 0)
        else:
            num = continuation[n - 1].get(ngram, 0)
            den = sum(
                c for g, c in continuation[n - 1].items() if g[:-1] == prefix
            )
            if den == 0:  # fall back to raw counts (e.g. <s> contexts)
                num = counts[n - 1].get(ngram, 0)
                den = counts[n - 2].get(prefix, 0)
        if den == 0:
            return interp_prob(ngram[1:])
        types = len([g for g in counts[n - 1] if g[:-1] == prefix])
        lam = discount * types / den
        return max(num - discount, 0) / den + lam * interp_prob(ngram[1:])

    # precompute prefix type counts to avoid O(n^2) scans
    prefix_types: List[Counter] = [Counter() for _ in range(order)]
    for n in range(2, order + 1):
        for g in counts[n - 1]:
            prefix_types[n - 1][g[:-1]] += 1

    # unigrams (plus <s> entry with prob "-99" like lmplz)
    norm = 0.0
    uni_probs = {}
    for (w,) in list(counts[0].keys()) + ([(UNK,)] if (UNK,) not in counts[0] else []):
        p = interp_prob((w,))
        uni_probs[w] = p
        norm += p
    for w, p in uni_probs.items():
        model.add((w,), math.log10(p / norm))
    model.add((BOS,), -99.0)

    # higher orders
    for n in range(2, order + 1):
        for ngram in counts[n - 1]:
            p = interp_prob(ngram)
            if p > 0:
                model.add(ngram, math.log10(p))

    # backoffs: weight mass reserved by discounting at each context
    for n in range(1, order):
        table = model.ngrams[n - 1]
        for ngram in list(table.keys()):
            types = prefix_types[n][ngram] if n >= 1 else 0
            den = counts[n - 1].get(ngram, 0)
            if types > 0 and den > 0:
                backoff = math.log10(max(discount * types / den, 1e-10))
                prob = table[ngram][0]
                table[ngram] = (prob, backoff)
    return model
