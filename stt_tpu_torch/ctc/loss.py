"""CTC loss: the log-semiring forward algorithm over time, in plain
PyTorch, differentiated by autograd (the counterpart of
`stt_tpu.ctc.loss.ctc_loss`; no TPU kernel there, so none here).

Semantics:
- blank index = num_classes - 1 (alphabet labels 0..A-1, blank = A);
- per-example loss = -log P(labels | logits), summed over time; repeated
  labels must be separated by a blank;
- impossible alignments (T < |l| + #repeats) give +inf.

log 0 is the finite sentinel -1e30, and `_logaddexp` stays NaN-free where
both arguments are the sentinel, so the gradient of every sample,
infeasible ones included, is finite: the trainer masks non-finite losses
out of the mean and needs their gradients to be 0, not NaN. Frames past a
row's `logit_lengths` leave its alphas untouched.

`torch.nn.functional.ctc_loss` is not this function: its blank defaults to
0, and its inf and `zero_infinity` handling differ.
"""

from __future__ import annotations

import torch

from stt_tpu_torch import trace

_NEG_INF = -1e30  # finite stand-in for log(0): keeps gradients NaN-free


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """logaddexp that stays NaN-free at (-inf, -inf) corners."""
    mx = torch.clamp(torch.maximum(a, b), min=_NEG_INF)  # both "-inf": no inf - inf
    return mx + torch.log1p(torch.exp(torch.minimum(a, b) - mx))


def _shift(alpha: torch.Tensor, by: int) -> torch.Tensor:
    """alpha[:, s - by], with log 0 shifted in at the left."""
    return torch.nn.functional.pad(alpha, (by, 0), value=_NEG_INF)[:, : alpha.shape[1]]


def ctc_loss(
    logits: torch.Tensor,
    logit_lengths: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
) -> torch.Tensor:
    """Per-example negative log likelihood.

    logits [B, T, C] raw (pre-softmax), blank = C - 1; logit_lengths [B]
    valid frames; labels [B, L] integer, padded past label_lengths (the
    padding value is masked out); label_lengths [B]. Returns [B] float32."""
    with trace.span("ctc.loss", device=True):
        losses = _ctc_loss(logits, logit_lengths, labels, label_lengths)
    if trace.enabled() and losses.requires_grad and logits.requires_grad:
        _trace_backward(logits, losses)
    return losses


def _trace_backward(logits: torch.Tensor, losses: torch.Tensor) -> None:
    """The span `ctc.loss.bwd` over the loss's backward: it opens at the
    gradient of `losses` and closes at that of `logits`, once every node of
    the loss has run."""
    opened = []
    losses.register_hook(lambda grad: opened.append(trace.begin("ctc.loss.bwd", device=True)))
    logits.register_hook(lambda grad: opened.pop().close() if opened else None)


def _ctc_loss(logits, logit_lengths, labels, label_lengths) -> torch.Tensor:
    batch, t_max, n_class = logits.shape
    device = logits.device
    blank = n_class - 1
    s_max = 2 * labels.shape[1] + 1
    labels = labels.long()
    label_lengths = label_lengths.to(device=device, dtype=torch.long)
    logit_lengths = logit_lengths.to(device=device, dtype=torch.long)

    log_probs = torch.log_softmax(logits.float(), dim=-1)

    # extended sequence: blank, l1, blank, l2, ..., blank -> [B, 2L+1]
    ext = torch.full((batch, s_max), blank, dtype=torch.long, device=device)
    ext[:, 1::2] = labels
    valid_s = torch.arange(s_max, device=device)[None, :] < (2 * label_lengths[:, None] + 1)

    # every step's emissions in one gather: [T, B, S]
    emit_all = torch.gather(log_probs, 2, ext[:, None, :].expand(batch, t_max, s_max))
    emit_all = emit_all.transpose(0, 1)

    # alpha[s] takes alpha[s-2] only where ext[s] is a label other than ext[s-2]
    ext_shift2 = torch.nn.functional.pad(ext, (2, 0), value=-1)[:, :s_max]
    can_skip = (ext != blank) & (ext != ext_shift2)

    neg = torch.full((batch, s_max), _NEG_INF, dtype=torch.float32, device=device)
    # t = 0 starts at s = 0 (blank) or s = 1 (first label)
    alpha = torch.cat([
        emit_all[0, :, :1],
        torch.where(label_lengths[:, None] > 0, emit_all[0, :, 1:2], neg[:, :1]),
        neg[:, 2:],
    ], dim=1)
    alpha = torch.where(valid_s, alpha, neg)

    for t in range(1, t_max):
        acc = _logaddexp(alpha, _shift(alpha, 1))
        acc = torch.where(can_skip, _logaddexp(acc, _shift(alpha, 2)), acc)
        new_alpha = torch.where(valid_s, acc + emit_all[t], neg)
        # frames past an utterance's end leave alpha untouched
        alpha = torch.where((t < logit_lengths)[:, None], new_alpha, alpha)

    # terminal states: last blank (2L) and last label (2L - 1)
    end_blank = torch.gather(alpha, 1, (2 * label_lengths)[:, None])[:, 0]
    end_label_pos = torch.clamp(2 * label_lengths - 1, min=0)
    end_label = torch.gather(alpha, 1, end_label_pos[:, None])[:, 0]
    end_label = torch.where(label_lengths > 0, end_label, neg[:, 0])
    loss = -_logaddexp(end_blank, end_label)
    # the sentinel back to a true inf for impossible alignments
    return torch.where(loss > -0.5 * _NEG_INF, torch.full_like(loss, float("inf")), loss)
