"""The port's CTC loss against stt_tpu.ctc.ctc_loss: values and gradients
(autograd against jax.grad) on the same seeded inputs, with ragged logit
and label lengths, repeated labels, zero-length labels and an infeasible
sample; torch.nn.functional.ctc_loss (blank rotated to 0) is a third
opinion on the feasible rows.

Tolerance: 1e-5 on losses and gradients (the same recursion in float32,
logsumexp terms summed in another order; losses here are 10-60).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stt_tpu.ctc import ctc_loss as jax_ctc_loss
from stt_tpu_torch.ctc import ctc_loss

TOL = 1e-5


def case(seed, b=5, t=24, c=7, l=6):
    rs = np.random.RandomState(seed)
    logits = (rs.randn(b, t, c) * 2).astype(np.float32)
    logit_lens = rs.randint(l * 2 + 2, t + 1, size=b).astype(np.int32)
    logit_lens[0] = t
    labels = rs.randint(0, c - 1, size=(b, l)).astype(np.int32)
    labels[1, 1] = labels[1, 0]  # a repeat: needs a blank between
    label_lens = rs.randint(1, l + 1, size=b).astype(np.int32)
    label_lens[1] = max(label_lens[1], 2)
    label_lens[2] = 0  # an empty transcript: all blanks
    # an infeasible row: 6 labels with repeats need more than 4 frames
    labels[3] = [1, 1, 1, 2, 2, 2]
    label_lens[3] = l
    logit_lens[3] = 4
    return logits, logit_lens, labels, label_lens


def both(logits, logit_lens, labels, label_lens):
    x = torch.from_numpy(logits).requires_grad_()
    loss = ctc_loss(x, torch.from_numpy(logit_lens), torch.from_numpy(labels),
                    torch.from_numpy(label_lens))
    finite = torch.isfinite(loss)
    torch.where(finite, loss, torch.zeros_like(loss)).sum().backward()

    def jax_fn(lg):
        out = jax_ctc_loss(lg, jnp.asarray(logit_lens), jnp.asarray(labels), jnp.asarray(label_lens))
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0)), out

    (_, want), grad = jax.value_and_grad(jax_fn, has_aux=True)(jnp.asarray(logits))
    return loss.detach().numpy(), x.grad.numpy(), np.asarray(want), np.asarray(grad)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loss_and_grad_match_jax(seed):
    got, grad, want, want_grad = both(*case(seed))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    assert np.isinf(got[3]) and np.isfinite(np.delete(got, 3)).all()
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=0, atol=TOL)
    assert np.isfinite(grad).all()
    np.testing.assert_allclose(grad, want_grad, rtol=0, atol=TOL)
    assert np.all(grad[3] == 0)  # the infeasible row takes no gradient


def test_infeasible_row_alone_has_zero_nan_free_gradient():
    """Even differentiated through its own inf (masked as the trainer does),
    an infeasible row gives a zero gradient and no NaN."""
    logits, logit_lens, labels, label_lens = case(3)
    x = torch.from_numpy(logits[3:4]).requires_grad_()
    loss = ctc_loss(x, torch.from_numpy(logit_lens[3:4]), torch.from_numpy(labels[3:4]),
                    torch.from_numpy(label_lens[3:4]))
    assert torch.isinf(loss).all()
    torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss)).sum().backward()
    assert torch.all(x.grad == 0)


def test_feasible_rows_agree_with_torch_ctc():
    logits, logit_lens, labels, label_lens = case(4)
    keep = [0, 1, 4]  # torch's loss wants label_lens >= 1 for a useful check
    got = ctc_loss(*(torch.from_numpy(a[keep]) for a in (logits, logit_lens, labels, label_lens)))
    rotated = np.concatenate([logits[..., -1:], logits[..., :-1]], axis=-1)[keep]
    ref = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.from_numpy(rotated).transpose(0, 1), dim=-1),
        torch.from_numpy(labels[keep].astype(np.int64) + 1),
        torch.from_numpy(logit_lens[keep].astype(np.int64)),
        torch.from_numpy(label_lens[keep].astype(np.int64)),
        blank=0, reduction="none",
    )
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


def test_labels_padded_to_a_longer_width_give_the_same_loss():
    logits, logit_lens, labels, label_lens = case(5)
    wide = np.concatenate([labels, np.full((labels.shape[0], 10), 3, np.int32)], axis=1)
    args = [torch.from_numpy(a) for a in (logits, logit_lens)]
    a = ctc_loss(*args, torch.from_numpy(labels), torch.from_numpy(label_lens))
    b = ctc_loss(*args, torch.from_numpy(wide), torch.from_numpy(label_lens))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
