"""Plain CTC prefix beam search without a language model: the decoder of
DeepSpeech 0.9 (ctc_beam_search_decoder.cpp, DecoderState::next), in
float64, over a batch of utterances at once.

Per frame, once a frame's blank probability has dropped below 0.999 (the
decoder delays expansion until then): every prefix in the beam takes the
blank (p_b += score * p(blank)) and its own last label again (p_nb += p_nb
* p(last)); each label c extends it to prefix + c (p_nb += p_b * p(c) where
c repeats the last label, else score * p(c)), merged into that prefix
where it is already in the beam; then the beam keeps its `beam` best
prefixes by score = logaddexp(p_b, p_nb). Log probabilities are log(p +
FLT_MIN). Prefixes are identified exactly, by (parent, label).

This is the semantics only for cutoff_prob = 1 and cutoff_top_n >= the
class count (no emission pruning), which is what every cell runs.
"""

from __future__ import annotations

import numpy as np
import torch

FLT_MIN = 1.1754943508222875e-38
NEG = float("-inf")


def _logaddexp(a, b):
    return torch.logaddexp(a, b)


@torch.no_grad()
def search(probs: torch.Tensor, lengths, beam: int) -> list:
    """probs [n, T, C] (blank last), lengths [n] -> per utterance a dict:
    `best` (labels tuple, score) and `beam` {labels tuple: score} of the
    final beam."""
    probs = probs.double()
    n, T, C = probs.shape
    dev = probs.device
    blank = C - 1
    lengths = torch.as_tensor(np.asarray(lengths), device=dev)
    W = beam
    p_b = torch.full((n, W), NEG, dtype=torch.float64, device=dev)
    p_b[:, 0] = 0.0
    p_nb = torch.full_like(p_b, NEG)
    last = torch.full((n, W), -1, dtype=torch.long, device=dev)
    pid = torch.full((n, W), -1, dtype=torch.long, device=dev)
    pid[:, 0] = 0  # the root
    parent = torch.full_like(pid, -1)
    started = torch.zeros(n, dtype=torch.bool, device=dev)
    tree = []  # node k + 1 is tree[k] = (its parent node, its label); the root is 0
    children = {}  # (parent node, label) -> node
    labels = torch.arange(C, device=dev)
    rows = torch.arange(n, device=dev)[:, None]
    for t in range(T):
        in_len = t < lengths
        started = started | (in_len & (probs[:, t, blank] < 0.999))
        active = in_len & started
        if not bool(active.any()):
            continue
        logp = torch.log(probs[:, t] + FLT_MIN)
        score = _logaddexp(p_b, p_nb)
        alive = pid >= 0
        b_new = torch.where(alive, score + logp[:, blank:blank + 1], NEG)
        repeat = logp.gather(1, last.clamp(min=0))
        nb_new = torch.where(alive & (last >= 0), p_nb + repeat, NEG)
        same = labels[None, None, :] == last[:, :, None]
        ext = torch.where(same, p_b[:, :, None], score[:, :, None]) + logp[:, None, :]
        ext[:, :, blank] = NEG
        ext = torch.where(alive[:, :, None], ext, NEG)
        # a prefix in the beam whose parent is in the beam is that parent's
        # extension by its last label: merge the two
        match = (parent[:, :, None] == pid[:, None, :]) & alive[:, :, None] & (pid >= 0)[:, None, :]
        has = match.any(dim=2)
        src = match.float().argmax(dim=2)
        via = ext[rows, src, last.clamp(min=0)]
        nb_new = torch.where(has, _logaddexp(nb_new, via), nb_new)
        ext[rows.expand(n, W)[has], src[has], last[has]] = NEG
        old_score = torch.where(alive, _logaddexp(b_new, nb_new), NEG)
        cand = torch.cat([old_score, ext.reshape(n, W * C)], dim=1)
        top_score, top = cand.topk(W, dim=1)
        is_old = top < W
        slot = torch.where(is_old, top, (top - W) // C)
        lab = torch.where(is_old, last.gather(1, top.clamp(max=W - 1)), (top - W) % C)
        src_pid = pid.gather(1, slot)
        dead = torch.isneginf(top_score)
        made = ~is_old & ~dead
        # a new prefix is (parent, label): the node of that string if the
        # trie still holds it, else a node of its own
        ids = torch.where(is_old, src_pid, -1)
        if bool(made.any()):
            keys = zip(src_pid[made].cpu().tolist(), lab[made].cpu().tolist())
            fresh = []
            for key in keys:
                node = children.get(key)
                if node is None:
                    node = children[key] = len(tree) + 1
                    tree.append(key)
                fresh.append(node)
            ids[made] = torch.tensor(fresh, device=dev)
        n_pid = torch.where(dead, -1, ids)
        n_parent = torch.where(is_old, parent.gather(1, slot), src_pid)
        n_pb = torch.where(is_old, b_new.gather(1, slot), NEG)
        n_nb = torch.where(is_old, nb_new.gather(1, slot), top_score)
        act = active[:, None]
        p_b = torch.where(act, torch.where(dead, NEG, n_pb), p_b)
        p_nb = torch.where(act, torch.where(dead, NEG, n_nb), p_nb)
        last = torch.where(act, torch.where(dead, -1, lab), last)
        parent = torch.where(act, torch.where(dead, -1, n_parent), parent)
        pid = torch.where(act, n_pid, pid)
    final = _logaddexp(p_b, p_nb).cpu().numpy()
    pid = pid.cpu().numpy()
    out = []
    for b in range(n):
        beams = {}
        for w in range(W):
            if pid[b, w] < 0 or not np.isfinite(final[b, w]):
                continue
            beams[_labels(tree, int(pid[b, w]))] = float(final[b, w])
        best = max(beams.items(), key=lambda kv: kv[1]) if beams else ((), 0.0)
        out.append({"best": best, "beam": beams})
    return out


def _labels(tree: list, node: int) -> tuple:
    out = []
    while node != 0:
        node, label = tree[node - 1]
        out.append(label)
    return tuple(reversed(out))
