"""CTC decoding where the probabilities live: the counterpart of
`stt_tpu.decode.device`.

1. `prune_emissions`: per frame the reference decoder's
   get_pruned_emissions (ctc_beam_search_decoder.cpp:328-358) - classes
   sorted by probability and cut by cumulative cutoff_prob / cutoff_top_n -
   computed on the probabilities' device, so only [T, K] (class, logp)
   pairs, the counts and the blank probability cross to the host.
   `DecoderState.next_pruned` consumes them.
   `ctc_beam_search_decoder_batch_pruned` decodes a batch that way,
   pruned in chunks packed into one plane each (`_prune_pack`), with or
   without a scorer.

2. `device_beam_search` / `DeviceStreamingDecoder`: the whole per-frame
   beam expansion and prune for the no-LM path on the probabilities'
   device. Beam prefixes live as fixed-width slot arrays (log p_blank,
   log p_nonblank, last label, string hashes); each frame expands every
   (slot, label) pair, merges the repeat / blank / extend cases as the
   host decoder (decode/beam.py) does, and keeps the top `beam`
   candidates. The scan leaves backpointer tables on the device; strings and
   timesteps come from walking them back, in O(T + tokens) whatever the
   alphabet's size: for a batch (`ctc_beam_search_decoder_device`) on the
   device by the backtrace (`stt_tpu_torch.ops.beam_kernel.beam_backtrack`,
   plain version `backtrack_plain`), which sends only the chosen paths to
   the host; for a stream (`DeviceStreamingDecoder`) and
   `device_beam_search` on the host (`rebuild_results`), after the tables
   are copied there. Every shape goes through the beam
   kernel's wrapper (`stt_tpu_torch.ops.beam_kernel.beam_scan`, which takes
   every beam and every alphabet), which launches the Hopper kernel on
   CUDA tensors and runs `beam_scan_plain`, the kernel's plain version, on
   CPU tensors. Host arrays go to the card (`device="cuda"`) unless the
   caller passes device="cpu"; tensors stay where they lie.

   Known, deliberate divergences from the host decoder: arithmetic is f32
   against the host's f64 (transcripts, tokens and timesteps match on the
   test fixtures, confidences to ~1e-3), and score ties go to the lower
   slot (the previous frame's rank), not to the host's (-score, character)
   order. Prefix identity is a pair of rolling 32-bit string hashes per
   slot, matched each frame against the parent-string hashes as the host
   trie's get_child does; a 64-bit collision could merge two prefixes.

Candidate ORDER is part of the contract: the decoder visits candidates in
this order and its timestep claims depend on it. Classes are sorted only
when the reference sorts (cutoff_prob < 1 or cutoff_top_n < C), by a
stable descending sort, so ties go to the lower class index (torch.topk
promises no tie order).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from stt_tpu_torch import trace
from stt_tpu_torch.alphabet import Alphabet
from stt_tpu_torch.decode.beam import DecodeResult, make_decoder_state
from stt_tpu_torch.device import resolve_device

_FLT_MIN = 1.1754944e-38  # NUM_FLT_MIN log floor, decoder_utils.h


def _prune_frame_sorted(
    probs: torch.Tensor, cutoff_top_n: int, cutoff_prob: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """probs [..., C] -> (idx [..., K] int32, logp [..., K], count [...] int32)."""
    c = probs.shape[-1]
    lead = probs.shape[:-1]
    if cutoff_prob < 1.0:
        k = min(cutoff_top_n, c)
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        vals, idx = vals[..., :k], idx[..., :k]
        cum = torch.cumsum(vals, dim=-1)
        pos = torch.arange(1, k + 1, device=probs.device)
        trigger = (cum >= cutoff_prob) | (pos >= cutoff_top_n)
        count = torch.where(
            trigger.any(dim=-1),
            trigger.int().argmax(dim=-1) + 1,
            torch.full(lead, k, device=probs.device, dtype=torch.int64),
        )
    elif cutoff_top_n < c:
        # the reference sorts but keeps every class
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        count = torch.full(lead, c, device=probs.device)
    else:
        # index order, untouched
        vals = probs
        idx = torch.arange(c, device=probs.device).expand(probs.shape)
        count = torch.full(lead, c, device=probs.device)
    logp = torch.log(vals + _FLT_MIN)
    return idx.to(torch.int32), logp, count.to(torch.int32)


def prune_emissions(
    probs: torch.Tensor, cutoff_top_n: int = 40, cutoff_prob: float = 1.0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Emission pruning over [..., T, C] on the tensor's device.

    Returns (indices [..., T, K], logp [..., T, K], counts [..., T],
    blank_prob [..., T]) with K = min(cutoff_top_n, C) when cutoff_prob < 1
    (the only case the reference truncates) and K = C otherwise."""
    idx, logp, count = _prune_frame_sorted(probs, int(cutoff_top_n), float(cutoff_prob))
    return idx, logp, count, probs[..., -1]


def prune_emissions_host(
    probs: np.ndarray, cutoff_top_n: int = 40, cutoff_prob: float = 1.0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """numpy twin of `prune_emissions` for probabilities already on the
    host (a copy of stt_tpu.decode.device.prune_emissions_host)."""
    probs = np.asarray(probs, np.float32)
    c = probs.shape[-1]
    lead = probs.shape[:-1]
    if cutoff_prob < 1.0:
        k = min(cutoff_top_n, c)
        order = np.argsort(-probs, axis=-1, kind="stable")[..., :k]
        vals = np.take_along_axis(probs, order, axis=-1)
        cum = np.cumsum(vals, axis=-1, dtype=np.float32)
        pos = np.arange(1, k + 1)
        trigger = (cum >= cutoff_prob) | (pos >= cutoff_top_n)
        count = np.where(
            trigger.any(axis=-1), trigger.argmax(axis=-1) + 1, k
        )
        idx = order
    elif cutoff_top_n < c:
        idx = np.argsort(-probs, axis=-1, kind="stable")
        vals = np.take_along_axis(probs, idx, axis=-1)
        count = np.full(lead, c, np.int32)
    else:
        vals = probs
        idx = np.broadcast_to(np.arange(c, dtype=np.int32), probs.shape)
        count = np.full(lead, c, np.int32)
    logp = np.log(vals + _FLT_MIN, dtype=np.float32)
    return (
        np.ascontiguousarray(idx, np.int32),
        logp,
        count.astype(np.int32),
        np.ascontiguousarray(probs[..., -1]),
    )


def _prune_pack(probs: torch.Tensor, cutoff_top_n: int, cutoff_prob: float) -> torch.Tensor:
    """Emission pruning packed into one float32 plane [..., T, 2K+2] (idx,
    logp, count, blank), so that a chunk crosses to the host in one copy.
    Class indices and counts are below 2^24: float32 holds them exactly.
    In identity mode (cutoff_prob 1, cutoff_top_n >= C: index order, every
    class) only logp and blank cross, [..., T, C+1]."""
    c = probs.shape[-1]
    blank = probs[..., -1:]
    if cutoff_prob >= 1.0 and cutoff_top_n >= c:
        return torch.cat([torch.log(probs + _FLT_MIN), blank], dim=-1)
    idx, logp, count = _prune_frame_sorted(probs, int(cutoff_top_n), float(cutoff_prob))
    return torch.cat([idx.float(), logp, count.float()[..., None], blank], dim=-1)


def unpack_pruned(packed: np.ndarray, identity: bool = False):
    """Host unpack of a `_prune_pack` plane -> (idx, logp, count, blank)
    (a copy of stt_tpu.decode.device.unpack_pruned).

    identity: the pack was the logp+blank-only fast mode (no truncation);
    candidate indices are index order and counts are the class count."""
    if identity:
        c = packed.shape[-1] - 1
        logp = packed[..., :c]
        blank = packed[..., c]
        idx = np.broadcast_to(
            np.arange(c, dtype=np.int32), logp.shape
        )
        count = np.full(logp.shape[:-1], c, np.int32)
        return idx, logp, count, blank
    k = (packed.shape[-1] - 2) // 2
    idx = packed[..., :k].astype(np.int32)
    logp = packed[..., k : 2 * k]
    count = packed[..., 2 * k].astype(np.int32)
    blank = packed[..., 2 * k + 1]
    return idx, logp, count, blank


PRUNE_CHUNK_FRAMES = 128  # frames per packed plane of the chunked path


def _packed_chunks(probs: torch.Tensor, cutoff_top_n: int, cutoff_prob: float):
    """Yield the host numpy plane of each PRUNE_CHUNK_FRAMES-frame chunk of
    probs [B, T, C], pruned where the tensor lies. On CUDA each chunk's
    prune and its copy into pinned memory (non_blocking, an event after
    it) are all queued before the first plane is yielded, so chunk j + 1
    is pruned and copied while the caller decodes chunk j."""
    starts = range(0, probs.shape[1], PRUNE_CHUNK_FRAMES)
    if not probs.is_cuda:
        for t0 in starts:
            yield _prune_pack(probs[:, t0 : t0 + PRUNE_CHUNK_FRAMES], cutoff_top_n,
                              cutoff_prob).numpy()
        return
    pending = []
    for t0 in starts:
        chunk = _prune_pack(probs[:, t0 : t0 + PRUNE_CHUNK_FRAMES], cutoff_top_n, cutoff_prob)
        host = torch.empty(chunk.shape, dtype=chunk.dtype, pin_memory=True)
        host.copy_(chunk, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        pending.append((host, done))
    for host, done in pending:
        done.synchronize()
        yield host.numpy()


def ctc_beam_search_decoder_batch_pruned(
    probs_batch,
    seq_lengths: Sequence[int],
    alphabet: Alphabet,
    beam_size: int,
    num_processes: int = 1,
    cutoff_prob: float = 1.0,
    cutoff_top_n: int = 40,
    scorer=None,
    hot_words=None,
    num_results: int = 1,
    implementation: str = "auto",
) -> List[List[DecodeResult]]:
    """Scorer-capable batch decode with emission pruning where the
    probabilities lie (the counterpart of
    stt_tpu.decode.device.ctc_beam_search_decoder_batch_pruned).

    A 3-D tensor (the acoustic model's softmax, on its device) is pruned
    there in PRUNE_CHUNK_FRAMES-frame chunks, each packed into one float32
    plane (`_prune_pack`); on CUDA the planes are copied into pinned host
    memory without blocking, so the host decodes chunk j while chunk j + 1
    is copied. Where the packed plane would be no smaller than the
    probabilities (cutoff_top_n + 2 >= C, as at the English alphabet's 29
    classes with the default cutoff_top_n), the tensor is fetched in one
    copy and pruned on the host instead, as stt_tpu does. Host arrays and
    lists take `prune_emissions_host`.

    The results equal ctc_beam_search_decoder_batch's; host work no longer
    scales with the alphabet's size."""
    lengths = [int(n) for n in seq_lengths]

    def make_states(batch_size: int):
        return [
            make_decoder_state(
                alphabet, beam_size, cutoff_prob, cutoff_top_n, scorer,
                hot_words, implementation,
            )
            for _ in range(batch_size)
        ]

    on_device = isinstance(probs_batch, torch.Tensor) and probs_batch.dim() == 3
    if on_device and cutoff_top_n + 2 >= probs_batch.shape[2]:
        probs_batch = probs_batch.float().cpu().numpy()
        on_device = False
    if not on_device:
        if getattr(probs_batch, "ndim", 0) == 3:
            batch = np.asarray(probs_batch, np.float32)
        else:
            items = [np.asarray(p, np.float32) for p in probs_batch]
            if not items:
                return []
            T = max(p.shape[0] for p in items)
            C = items[0].shape[1]
            batch = np.zeros((len(items), T, C), np.float32)
            batch[..., -1] = 1.0
            for i, p in enumerate(items):
                batch[i, : p.shape[0]] = p
        idx, logp, cnt, blank = prune_emissions_host(
            batch, cutoff_top_n=cutoff_top_n, cutoff_prob=cutoff_prob
        )
        B = idx.shape[0]
        states = make_states(B)

        def one(i: int) -> List[DecodeResult]:
            n = lengths[i]
            states[i].next_pruned(
                idx[i, :n], logp[i, :n], cnt[i, :n], blank[i, :n]
            )
            return states[i].decode(num_results)

        if num_processes <= 1 or B <= 1:
            return [one(i) for i in range(B)]
        with ThreadPoolExecutor(max_workers=num_processes) as pool:
            return list(pool.map(one, range(B)))

    # ---- chunked prune where the tensor lies, copies beside the decode ----
    B, _, C = probs_batch.shape
    identity = cutoff_prob >= 1.0 and cutoff_top_n >= C
    states = make_states(B)
    pool = (
        ThreadPoolExecutor(max_workers=num_processes)
        if num_processes > 1 and B > 1
        else None
    )
    try:
        chunks = _packed_chunks(probs_batch.float(), int(cutoff_top_n), float(cutoff_prob))
        for j, packed in enumerate(chunks):
            idx, logp, cnt, blank = unpack_pruned(packed, identity=identity)
            t0 = j * PRUNE_CHUNK_FRAMES

            def feed(i: int, t0=t0):
                n = min(lengths[i] - t0, idx.shape[1])
                if n > 0:
                    states[i].next_pruned(
                        idx[i, :n], logp[i, :n], cnt[i, :n], blank[i, :n]
                    )

            if pool is not None:
                list(pool.map(feed, range(B)))
            else:
                for i in range(B):
                    feed(i)
        if pool is not None:
            return list(
                pool.map(lambda s: s.decode(num_results), states)
            )
        return [s.decode(num_results) for s in states]
    finally:
        if pool is not None:
            pool.shutdown()


# --------------------------------------------------------------------------
# Full beam search on the device (no-LM path)
# --------------------------------------------------------------------------

_KEEP = -1  # bp_char value meaning "same prefix as bp_src one frame back"
NEG_INF = float("-inf")

# rolling string-hash multipliers (two independent 32-bit streams); the
# beam kernel uses the same, so its state and the plain state interchange
H1 = 1000003
H2 = 69069

# (p_b, p_nb [B, W] f32; last, ha, hb, par_ha, par_hb [B, W] int32;
#  started [B] bool)
BeamState = Tuple[torch.Tensor, ...]


def logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(exp(a) + exp(b)) as max + log1p(exp(-|a - b|)), -inf for two
    -inf: written out so that the beam kernel computes it the same way."""
    m = torch.maximum(a, b)
    r = m + torch.log1p(torch.exp(-(a - b).abs()))
    return torch.where(torch.isneginf(m), m, r)


def _roll_hash(h: torch.Tensor, mult: int, char: torch.Tensor) -> torch.Tensor:
    """h * mult + char + 1 wrapped to int32 (computed in int64: signed
    overflow is not defined for int32 tensors)."""
    x = (h.long() * mult + char.long() + 1) & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def class_masks(n_class: int, blank: int, ignored_symbols: Sequence[int],
                default_blank: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(not_ignored [C] bool, static rank [C] int32): the candidate order
    when nothing sorts - index order, or for external (wav2vec2-style)
    layouts the non-ignored, non-blank tokens in index order, blank last."""
    not_ignored = np.ones((n_class,), bool)
    for sym in ignored_symbols:
        not_ignored[int(sym)] = False
    not_ignored[blank] = True
    rank = np.arange(n_class, dtype=np.int32)
    if not (default_blank and not ignored_symbols):
        order = [i for i in range(n_class) if not_ignored[i] and i != blank]
        order.append(blank)
        rank = np.full((n_class,), n_class - 1, np.int32)
        for pos, tok in enumerate(order):
            rank[tok] = pos
    return not_ignored, rank


def init_beam_state(batch: int, beam: int, device) -> BeamState:
    """Root-only beams: slot 0 holds the empty string (hash (1, 1), log
    probability 0); dead slots sit at -inf with hash (0, 0)."""
    p_b = torch.full((batch, beam), NEG_INF, device=device)
    p_b[:, 0] = 0.0
    ha = torch.zeros((batch, beam), dtype=torch.int32, device=device)
    ha[:, 0] = 1
    return (
        p_b, torch.full((batch, beam), NEG_INF, device=device),
        torch.full((batch, beam), -1, dtype=torch.int32, device=device),
        ha, ha.clone(), torch.zeros_like(ha), torch.zeros_like(ha),
        torch.zeros((batch,), dtype=torch.bool, device=device),
    )


def _beam_step(state: BeamState, prob: torch.Tensor, valid: torch.Tensor, *,
               beam: int, n_class: int, cutoff_top_n: int, cutoff_prob: float,
               blank_id: Optional[int] = None,
               ignored_symbols: Tuple[int, ...] = ()):
    """One frame of CTC prefix beam search over slot arrays, for a batch:
    `stt_tpu.decode.device._beam_step` op for op with the batch dimension
    written out. prob [B, C] softmax probabilities of this frame; valid [B]
    bool. Returns the new state and (bp_src [B, W], bp_char [B, W]) int32."""
    p_b, p_nb, last, ha, hb, par_ha, par_hb, started = state
    W, C = beam, n_class
    dev = prob.device
    B = prob.shape[0]
    default_blank = blank_id is None
    blank = C - 1 if default_blank else int(blank_id)
    ni_np, rank_np = class_masks(C, blank, ignored_symbols, default_blank)
    not_ignored = torch.from_numpy(ni_np).to(dev)
    classes = torch.arange(C, device=dev)
    slots = torch.arange(W, device=dev)

    # delayed-expansion gate (cpp:120-131); padding frames cannot trip it
    started = started | ((prob[:, blank] < 0.999) & valid)
    active = (started & valid)[:, None]

    # ---- emission pruning ------------------------------------------------
    cand_logp = torch.log(prob + _FLT_MIN)  # [B, C]
    if cutoff_prob < 1.0 or cutoff_top_n < C:
        # ignored symbols sort at probability 0: after every real candidate
        sort_probs = torch.where(not_ignored, prob, torch.zeros_like(prob))
        svals, sidx = torch.sort(sort_probs, dim=-1, descending=True, stable=True)
        rank = torch.empty_like(sidx).scatter_(1, sidx, classes.expand(B, C))
        if cutoff_prob < 1.0:
            cum = torch.cumsum(svals, dim=-1)
            trigger = (cum >= cutoff_prob) | (classes + 1 >= cutoff_top_n)
            cutoff_len = torch.where(
                trigger.any(dim=-1), trigger.int().argmax(dim=-1) + 1,
                torch.full((B,), C, device=dev),
            )
        else:
            cutoff_len = torch.full((B,), C, device=dev)  # top_n alone: sort only
        included = (rank < cutoff_len[:, None]) & not_ignored
    else:
        rank = torch.from_numpy(rank_np).to(dev).long().expand(B, C)
        included = not_ignored.expand(B, C)

    score = logaddexp(p_b, p_nb)  # [B, W]
    alive = score > NEG_INF
    last_safe = last.clamp(0, C - 1).long()
    has_last = last >= 0

    # ---- parent lookup by string hash (the trie's get_child merge) --------
    # eq_par[b, i, j]: alive slot i holds slot j's parent string. Alive slots
    # hold distinct strings, so each column has at most one hit.
    eq_par = (
        (ha[:, :, None] == par_ha[:, None, :])
        & (hb[:, :, None] == par_hb[:, None, :])
        & alive[:, :, None]
        & has_last[:, None, :]
    )
    has_parent = eq_par.any(dim=1)
    par_idx = eq_par.int().argmax(dim=1)  # the first hit; 0 without one

    # ---- existing-slot updates (blank / repeat / merge-extend) ------------
    neg = torch.full_like(score, NEG_INF)
    blank_in = included[:, blank][:, None]
    b_val = torch.where(blank_in & alive, cand_logp[:, blank][:, None] + score, neg)
    logp_last = cand_logp.gather(1, last_safe)
    c_in = has_last & included.gather(1, last_safe)
    r_val = torch.where(c_in & alive, logp_last + p_nb, neg)
    par_score = score.gather(1, par_idx)
    par_last = last.gather(1, par_idx)
    par_pb = p_b.gather(1, par_idx)
    e_from = torch.where(par_last == last, par_pb, par_score)
    e_ok = has_parent & c_in
    e_val = torch.where(e_ok, logp_last + e_from, neg)
    new_pb_exist = b_val
    new_pnb_exist = logaddexp(r_val, e_val)

    # ---- timestep-claim state machine --------------------------------------
    # The host decoder walks candidates in rank order and beam slots in list
    # order; each improving contribution to a prefix's nb either cancels
    # (blank / repeat) or installs (extend) a pending history rewrite.
    rank_blank = rank[:, blank][:, None]
    blank_first = torch.where(has_last, rank_blank < rank.gather(1, last_safe),
                              torch.ones_like(has_last))
    r_first = slots[None, :] < par_idx  # slot j processed before its parent?
    nb_final = new_pnb_exist
    b_kills = (~blank_first) & blank_in & alive & (nb_final < b_val)
    rw_a = (e_val > r_val) & ~b_kills  # R before E
    r_kills = c_in & alive & (e_val < r_val)
    rw_b = (e_val > NEG_INF) & ~r_kills & ~b_kills  # E before R
    rewrite = torch.where(r_first, rw_a, rw_b) & e_ok

    # ---- extension children pool [B, W, C] ---------------------------------
    # merged[b, i, c]: an alive slot already holds prefix_i + c
    onehot_last = (last[:, :, None] == classes) & has_last[:, :, None]
    merged = torch.bmm(eq_par.float(), onehot_last.float()) > 0.5
    is_rep = last[:, :, None] == classes
    child_val = torch.where(is_rep, p_b[:, :, None], score[:, :, None]) + cand_logp[:, None, :]
    child_ok = alive[:, :, None] & included[:, None, :] & (classes != blank) & ~merged
    child_val = torch.where(child_ok, child_val, torch.full_like(child_val, NEG_INF))

    # ---- top-W over (existing ++ children): value descending, then flat
    # index ascending (a stable sort; torch.topk promises no tie order) ----
    exist_score = logaddexp(new_pb_exist, new_pnb_exist)
    pool = torch.cat([exist_score, child_val.reshape(B, W * C)], dim=1)
    top_val, top_idx = torch.sort(pool, dim=-1, descending=True, stable=True)
    top_val, top_idx = top_val[:, :W], top_idx[:, :W]
    is_exist = top_idx < W
    j_old = torch.where(is_exist, top_idx, torch.zeros_like(top_idx))
    flat = torch.where(is_exist, torch.zeros_like(top_idx), top_idx - W)
    i_old = flat // C
    c_new = (flat % C).to(torch.int32)
    dead = top_val == NEG_INF

    sel_last = torch.where(is_exist, last.gather(1, j_old), c_new)
    sel_pb = torch.where(is_exist, new_pb_exist.gather(1, j_old), neg)
    sel_pnb = torch.where(is_exist, new_pnb_exist.gather(1, j_old), top_val)
    ha_i, hb_i = ha.gather(1, i_old), hb.gather(1, i_old)
    sel_ha = torch.where(is_exist, ha.gather(1, j_old), _roll_hash(ha_i, H1, c_new))
    sel_hb = torch.where(is_exist, hb.gather(1, j_old), _roll_hash(hb_i, H2, c_new))
    sel_par_ha = torch.where(is_exist, par_ha.gather(1, j_old), ha_i)
    sel_par_hb = torch.where(is_exist, par_hb.gather(1, j_old), hb_i)

    rw_sel = rewrite.gather(1, j_old)
    keep = torch.full_like(c_new, _KEEP)
    src_exist = torch.where(rw_sel, par_idx.gather(1, j_old), j_old)
    char_exist = torch.where(rw_sel, last.gather(1, j_old), keep)
    bp_src = torch.where(is_exist, src_exist, i_old).to(torch.int32)
    bp_char = torch.where(is_exist, char_exist, c_new)

    zero = torch.zeros_like(c_new)
    idw = slots.to(torch.int32).expand(B, W)
    sel_last = torch.where(dead, keep, sel_last)
    sel_pb = torch.where(dead, neg, sel_pb)
    sel_pnb = torch.where(dead, neg, sel_pnb)
    # dead slots get the (0, 0) hash pair, unreachable for real strings
    sel_ha, sel_hb = torch.where(dead, zero, sel_ha), torch.where(dead, zero, sel_hb)
    sel_par_ha = torch.where(dead, zero, sel_par_ha)
    sel_par_hb = torch.where(dead, zero, sel_par_hb)
    bp_src = torch.where(dead, idw, bp_src)
    bp_char = torch.where(dead, keep, bp_char)

    # ---- inactive frames: identity -----------------------------------------
    new_state = (
        torch.where(active, sel_pb, p_b), torch.where(active, sel_pnb, p_nb),
        torch.where(active, sel_last, last),
        torch.where(active, sel_ha, ha), torch.where(active, sel_hb, hb),
        torch.where(active, sel_par_ha, par_ha), torch.where(active, sel_par_hb, par_hb),
        started,
    )
    return new_state, (torch.where(active, bp_src, idw), torch.where(active, bp_char, keep))


@torch.no_grad()
def beam_scan_plain(
    state: BeamState,
    probs: torch.Tensor,
    lens: torch.Tensor,
    beam_width: int,
    cutoff_top_n: int = 40,
    cutoff_prob: float = 1.0,
    blank_id: Optional[int] = None,
    ignored_symbols: Tuple[int, ...] = (),
):
    """Advance B beams over probs [B, T, C]; frames at or past lens [B] are
    no-ops. A Python loop over the frames: the plain version of the beam
    kernel (`stt_tpu_torch.ops.beam_kernel.beam_scan`). Returns (state',
    bp_src [B, T, W] int32, bp_char [B, T, W] int32)."""
    B, T, C = probs.shape
    srcs, chars = [], []
    for t in range(T):
        state, (src, char) = _beam_step(
            state, probs[:, t], t < lens, beam=beam_width, n_class=C,
            cutoff_top_n=cutoff_top_n, cutoff_prob=cutoff_prob,
            blank_id=blank_id, ignored_symbols=ignored_symbols,
        )
        srcs.append(src)
        chars.append(char)
    if not srcs:
        empty = torch.zeros((B, 0, beam_width), dtype=torch.int32, device=probs.device)
        return state, empty, empty.clone()
    return state, torch.stack(srcs, dim=1), torch.stack(chars, dim=1)


PATH_HEAD = 3  # a path's score (float32 bits), beam slot and token count, before its tokens


@torch.no_grad()
def backtrack_plain(scores: torch.Tensor, bp, num_results: int) -> torch.Tensor:
    """The paths of each row's `num_results` best beams, walked back through
    the scan's backpointers where they lie: the plain version of the
    backtrace kernel (`stt_tpu_torch.ops.beam_kernel.beam_backtrack`), a
    loop over the frames of gathers across B x R.

    scores [B, W]; bp the packed [B, T, W] plane or the (bp_src, bp_char)
    pair, as `scan` returns them. Returns [B, R, PATH_HEAD + 2 T] int32: per
    row the beams in the order of `rebuild_results` (descending score, ties
    to the lower slot), each as its score's float32 bits, its slot (-1 where
    it is no result: a non-finite score, or fewer than R beams), its token
    count n, then T tokens and T frames, the first n of each in time order
    and the rest 0."""
    pair = isinstance(bp, tuple)
    B, T, W = (bp[0] if pair else bp).shape
    R = int(num_results)
    K = min(R, W)
    dev = scores.device
    picked = torch.sort(-scores, dim=1, stable=True).indices[:, :K]
    value = scores.gather(1, picked)
    found = torch.isfinite(value)
    w = picked
    chars = torch.empty((B, K, T), dtype=torch.int32, device=dev)
    for t in range(T - 1, -1, -1):
        if pair:
            src, ch = bp[0][:, t].gather(1, w), bp[1][:, t].gather(1, w)
        else:
            v = bp[:, t].gather(1, w).to(torch.int32)
            src, ch = v >> 8, (v & 0xFF) - 1
        chars[:, :, t] = ch
        w = src.long()
    kept = (chars != _KEEP) & found[..., None]
    count = kept.sum(-1)
    # a stable sort puts each path's token frames first, in time order
    frames = torch.sort((~kept).to(torch.int8), dim=-1, stable=True).indices
    live = torch.arange(T, device=dev) < count[..., None]
    out = torch.zeros((B, R, PATH_HEAD + 2 * T), dtype=torch.int32, device=dev)
    out[:, :, 1] = -1
    out[:, :K, 0] = torch.where(found, value, torch.zeros_like(value)).view(torch.int32)
    out[:, :K, 1] = torch.where(found, picked, torch.full_like(picked, -1)).to(torch.int32)
    out[:, :K, 2] = count.to(torch.int32)
    out[:, :K, PATH_HEAD:PATH_HEAD + T] = torch.where(live, chars.gather(-1, frames), 0)
    out[:, :K, PATH_HEAD + T:] = torch.where(live, frames, 0).to(torch.int32)
    return out


def paths_to_results(paths: np.ndarray, alphabet: Alphabet) -> List[List[DecodeResult]]:
    """The backtrace's paths [B, R, PATH_HEAD + 2 T] on the host -> per row
    the DecodeResults that `rebuild_results` builds from the same beams."""
    T = (paths.shape[-1] - PATH_HEAD) // 2
    confidence = paths[..., 0].view(np.float32)
    batch = []
    for row, row_conf in zip(paths, confidence):
        results = []
        for path, conf in zip(row, row_conf):
            if path[1] < 0:
                continue
            n = int(path[2])
            tokens = path[PATH_HEAD:PATH_HEAD + n].tolist()
            results.append(DecodeResult(
                confidence=float(conf),
                transcript=alphabet.decode(tokens),
                tokens=tokens,
                timesteps=path[PATH_HEAD + T:PATH_HEAD + T + n].tolist(),
            ))
        batch.append(results or [DecodeResult(0.0, "", [], [])])
    return batch


def _device_beam_scan(probs, seq_len, beam_width, cutoff_top_n, cutoff_prob,
                      blank_id=None, ignored_symbols=()):
    """[B, T, C] probs -> (scores [B, W], bp_src, bp_char [B, T, W]) from
    root-only beams, all on the probabilities' device, by the plain scan."""
    state = init_beam_state(probs.shape[0], beam_width, probs.device)
    state, src, char = beam_scan_plain(
        state, probs, seq_len.to(torch.int32), beam_width, cutoff_top_n,
        cutoff_prob, blank_id, tuple(ignored_symbols),
    )
    return logaddexp(state[0], state[1]), src, char


def scan(probs, lens, beam_width, cutoff_top_n, cutoff_prob, blank_id=None,
         ignored_symbols=(), state=None):
    """The beam scan of every shape, through the beam kernel's wrapper: the
    kernel on CUDA tensors, its plain version on CPU tensors. `state` is
    what the previous call returned (None to start). Returns (state',
    scores [B, W], backpointers), the last either the wrapper's packed
    [B, T, W] plane or a (bp_src, bp_char) pair."""
    from stt_tpu_torch.ops import beam_kernel

    return beam_kernel.beam_scan(
        probs, lens, beam_width, cutoff_top_n, cutoff_prob, blank_id,
        tuple(int(i) for i in ignored_symbols), state=state,
    )


def _on_device(probs, device) -> torch.Tensor:
    """A tensor stays on its device; a host array goes to `device`."""
    if isinstance(probs, torch.Tensor):
        return probs.float()
    return torch.as_tensor(np.asarray(probs, np.float32)).to(resolve_device(device))


def _host_backpointers(bp) -> Tuple[np.ndarray, np.ndarray]:
    from stt_tpu_torch.ops import beam_kernel

    return beam_kernel.unpack_bp(bp if isinstance(bp, tuple) else bp.cpu().numpy())


class DeviceStreamingDecoder:
    """Stateful no-LM beam decoder whose per-frame expansion and prune run
    on the probabilities' device: the streaming counterpart of
    `device_beam_search`, with the DecoderState surface the stream runtime
    consumes (next / decode). Per chunk one scan advances the beam; the
    backpointer tables stay on the device until decode() pulls them, so
    feeding audio moves nothing decode-related to the host. Chunks given as
    tensors are consumed where they lie; host arrays go to `device`."""

    def __init__(
        self,
        alphabet: Alphabet,
        beam_size: int,
        cutoff_prob: float = 1.0,
        cutoff_top_n: int = 40,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.alphabet = alphabet
        self.beam_size = int(beam_size)
        self.cutoff_prob = float(cutoff_prob)
        self.cutoff_top_n = int(cutoff_top_n)
        self._state = None  # as `scan` returns it
        self._scores: Optional[torch.Tensor] = None
        self._chunks: List[tuple] = []  # (backpointers on the device, n_valid)

    def next(self, probs: torch.Tensor, n_valid: Optional[int] = None) -> None:
        """[n, C] softmax chunk. Pass n_valid < n for a padded flush chunk,
        so the chunk shape stays fixed."""
        probs = _on_device(probs, self.device)
        n = int(probs.shape[0])
        if n_valid is None:
            n_valid = n
        if n_valid <= 0:
            return
        lens = torch.tensor([n_valid], dtype=torch.int32, device=probs.device)
        self._state, self._scores, bp = scan(
            probs[None].contiguous(), lens, self.beam_size, self.cutoff_top_n,
            self.cutoff_prob, state=self._state,
        )
        self._chunks.append((bp, n_valid))

    def next_pruned(self, *_args, **_kw):
        raise NotImplementedError(
            "DeviceStreamingDecoder consumes full probabilities on the device; "
            "pruned emissions are a host-decoder transport"
        )

    def decode(self, num_results: int = 1) -> List[DecodeResult]:
        if not self._chunks:
            return [DecodeResult(0.0, "", [], [])]
        pairs = [_host_backpointers(bp) for bp, _ in self._chunks]
        src = np.concatenate([s[0, :n] for (s, _), (_, n) in zip(pairs, self._chunks)])
        char = np.concatenate([c[0, :n] for (_, c), (_, n) in zip(pairs, self._chunks)])
        scores = self._scores[0].cpu().numpy()
        return rebuild_results(scores, src, char, self.alphabet, num_results)


def _batch_scan(probs, seq_lengths, beam_width, cutoff_top_n, cutoff_prob, blank_id,
                ignored_symbols, device):
    """The scan of a [B, T, C] batch from root-only beams, where the
    probabilities lie (a host array goes to `device`): (scores [B, W],
    backpointers as `scan` returns them), both on that device."""
    probs = _on_device(probs, device)
    if probs.dim() == 2:
        probs = probs[None]
    lens = torch.as_tensor(np.atleast_1d(np.asarray(seq_lengths)), dtype=torch.int32)
    _, scores, bp = scan(
        probs.contiguous(), lens.to(probs.device), int(beam_width), int(cutoff_top_n),
        float(cutoff_prob), None if blank_id is None else int(blank_id), ignored_symbols,
    )
    return scores, bp


def device_beam_search(
    probs,
    seq_lengths,
    beam_width: int = 128,
    cutoff_top_n: int = 40,
    cutoff_prob: float = 1.0,
    blank_id: Optional[int] = None,
    ignored_symbols: Sequence[int] = (),
    device="cuda",
):
    """The no-LM beam search over a [B, T, C] batch: a tensor is searched on
    the device it lies on, a host array is moved to `device` (the card
    unless the caller passes "cpu").

    Returns (scores [B, W], bp_src [B, T, W], bp_char [B, T, W]) as numpy
    arrays, for the host's `rebuild_results`.
    blank_id / ignored_symbols cover external (wav2vec2-style) layouts."""
    scores, bp = _batch_scan(probs, seq_lengths, beam_width, cutoff_top_n, cutoff_prob,
                             blank_id, ignored_symbols, device)
    src, char = _host_backpointers(bp)
    return scores.cpu().numpy(), src, char


def rebuild_results(
    scores: np.ndarray,
    bp_src: np.ndarray,
    bp_char: np.ndarray,
    alphabet: Alphabet,
    num_results: int = 1,
) -> List[DecodeResult]:
    """Host-side walk of one utterance's backpointer table: scores [W];
    bp_src, bp_char [T, W]. O(num_results * T) host work, whatever the
    alphabet's size."""
    T, _ = bp_src.shape
    order = np.argsort(-scores, kind="stable")
    results: List[DecodeResult] = []
    for w0 in order[:num_results]:
        if not np.isfinite(scores[w0]):
            continue
        tokens_rev: List[int] = []
        steps_rev: List[int] = []
        w = int(w0)
        for t in range(T - 1, -1, -1):
            ch = int(bp_char[t, w])
            if ch != _KEEP:
                tokens_rev.append(ch)
                steps_rev.append(t)
            w = int(bp_src[t, w])
        tokens = tokens_rev[::-1]
        results.append(
            DecodeResult(
                confidence=float(scores[w0]),
                transcript=alphabet.decode(tokens),
                tokens=tokens,
                timesteps=steps_rev[::-1],
            )
        )
    if not results:
        results.append(DecodeResult(0.0, "", [], []))
    return results


def ctc_beam_search_decoder_device(
    probs_batch,
    seq_lengths: Sequence[int],
    alphabet: Alphabet,
    beam_size: int = 128,
    cutoff_prob: float = 1.0,
    cutoff_top_n: int = 40,
    num_results: int = 1,
    blank_id: Optional[int] = None,
    ignored_symbols: Sequence[int] = (),
    device="cuda",
) -> List[List[DecodeResult]]:
    """Batch no-LM decode with the expansion and prune on the device.

    A [B, T, C] tensor (as it comes out of the acoustic model, on its
    device) is consumed as it is, so the probabilities never visit the host
    at full width; a host array, or a list of [T_i, C] arrays padded to a
    rectangle, is moved to `device` (the card unless the caller passes
    "cpu").

    The backpointers stay where the scan wrote them: the backtrace
    (`stt_tpu_torch.ops.beam_kernel.beam_backtrack`) walks each row's
    num_results best beams there, and only those paths, [B, num_results,
    PATH_HEAD + 2 T] int32, cross to the host. The results equal
    `rebuild_results`' on the same backpointers."""
    from stt_tpu_torch.ops import beam_kernel

    if getattr(probs_batch, "ndim", 0) == 3:
        batch = probs_batch
        B = batch.shape[0]
    else:
        items = [np.asarray(p, np.float32) for p in probs_batch]
        if not items:
            return []
        B = len(items)
        T = max(p.shape[0] for p in items)
        C = items[0].shape[1]
        batch = np.zeros((B, T, C), np.float32)
        # padding frames lie past seq_len and are masked inside the scan;
        # blank = 1 keeps their sums sane if the lengths disagree
        batch[..., C - 1 if blank_id is None else int(blank_id)] = 1.0
        for i, p in enumerate(items):
            batch[i, : p.shape[0]] = p
    scores, bp = _batch_scan(batch, np.asarray(seq_lengths, np.int32), beam_size, cutoff_top_n,
                             cutoff_prob, blank_id, ignored_symbols, device)
    paths = beam_kernel.beam_backtrack(scores, bp, num_results).cpu()
    trace.count("decode.d2h_bytes", paths.numel() * paths.element_size())
    with trace.span("decode.rebuild"):
        return paths_to_results(paths.numpy(), alphabet)
