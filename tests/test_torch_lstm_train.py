"""The port's training recurrence against the JAX package's: K3's and K4's
plain versions (stt_tpu_torch.ops.lstm_train.train_forward /
train_backward) against the Pallas kernels `_lstm_train_fwd_impl` /
`_lstm_train_bwd_impl` run in interpret mode, and `lstm_train`'s values and
gradients against `jax.grad` of `stt_tpu.ops.lstm_train.lstm_train`
(interpret mode) and of `lstm_scan`. (The Hopper kernels against the plain
versions are tests/test_torch_cuda.py.)

Tolerances:
- forward stashes hs, cs and the state: 1e-5 (float32 sums in another
  order). zs is stored in bf16: equal except where those ~1e-7 differences
  tip z across a bf16 rounding boundary, which moves it by one bf16 ulp
  (at most 2^-7 of the value); the test allows that for at most 0.1% of
  the values.
- backward dz, dc0, dh0 from the same stashes: 1e-5 in f32, 1e-4 in bf16
  (dz is rounded to bf16 before dz . W_h^T, and a 1e-7 difference can tip
  that rounding, moving dh by about 2^-8 of one term).
- `lstm_train` against JAX's `lstm_train`, values and gradients: 1e-5 in
  f32, the same computation. In bf16 the gradients of x and of W_x pass
  through a bf16 cast (autograd rounds a cotangent to the dtype of the
  value it belongs to, as JAX's VJP does), and x_proj itself is a bf16
  rounding of float32 sums taken in another order; a value on a rounding
  boundary then lands one bf16 ulp away on one side, and that ulp travels
  back through the gradients. So bf16 gradients are held by their
  relative norm, 2e-3, and their largest difference, two bf16 ulps of the
  largest value (2^-7 of it); measured on these inputs: 7.2e-4 and 3.8e-3
  (x), 2.2e-4 and 2.1e-3 (kernel).
- against autodiff of `lstm_scan`: 2e-3, as tests/test_lstm_train_kernel.py
  holds the JAX pair; the backward's gates come from bf16 z.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stt_tpu.models.lstm import lstm_scan as jax_lstm_scan
from stt_tpu.ops.lstm_train import (
    _lstm_train_bwd_impl,
    _lstm_train_fwd_impl,
    lstm_train as jax_lstm_train,
)
from stt_tpu_torch.models.lstm import project_inputs
from stt_tpu_torch.ops import lstm_train, lstm_train_bwd, lstm_train_fwd
from stt_tpu_torch.ops.lstm_train import train_backward, train_forward

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BWD_TOL = {"float32": 1e-5, "bfloat16": 1e-4}
BF16_REL_NORM = 2e-3
BF16_MAX_SHARE = 2.0 ** -7


def make_case(seed, T, B, H, n_in=None):
    rs = np.random.RandomState(seed)
    n_in = n_in or H
    limit = (6.0 / (n_in + 5 * H)) ** 0.5
    params = {
        "kernel": rs.uniform(-limit, limit, (n_in + H, 4 * H)).astype(np.float32),
        "bias": (rs.randn(4 * H) * 0.1).astype(np.float32),
    }
    x = (rs.randn(T, B, n_in) * 0.5).astype(np.float32)
    seq = rs.randint(1, T + 1, size=B).astype(np.int32)
    seq[0] = T
    c0 = (rs.randn(B, H) * 0.1).astype(np.float32)
    h0 = rs.uniform(-0.1, 0.1, (B, H)).astype(np.float32)
    return params, x, seq, c0, h0


def bf16_mismatch(got: np.ndarray, want: np.ndarray):
    """(share of values that differ, whether every difference is within one
    bf16 ulp, i.e. 2^-7 of the value)."""
    diff = np.abs(got - want)
    return float(np.mean(diff > 0)), bool(np.all(diff <= 2.0 ** -7 * np.abs(want)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_and_backward_match_the_pallas_kernels(dtype):
    jdt, tdt = DTYPES[dtype]
    T, B, H = 7, 8, 128
    params, x, seq, c0, h0 = make_case(0, T, B, H)
    x_proj, w_h = project_inputs({k: torch.from_numpy(v) for k, v in params.items()},
                                 torch.from_numpy(x), tdt)
    seq_t = torch.from_numpy(seq)
    hs, cs, zs, c_T, h_T = lstm_train_fwd(x_proj, w_h, torch.from_numpy(c0),
                                          torch.from_numpy(h0), seq_t)
    jx = jnp.asarray(x_proj.float().numpy()).astype(jdt)
    jw = jnp.asarray(w_h.float().numpy()).astype(jdt)
    want = _lstm_train_fwd_impl(jx, jw, jnp.asarray(c0), jnp.asarray(h0),
                                jnp.asarray(seq)[:, None], interpret=True)
    for got, ref in zip((hs, cs, c_T, h_T), (want[0], want[1], want[3], want[4])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    assert zs.dtype == torch.bfloat16
    share, one_ulp = bf16_mismatch(zs.float().numpy(), np.asarray(want[2].astype(jnp.float32)))
    assert share <= 1e-3 and one_ulp, share
    for b, n in enumerate(seq.tolist()):
        assert torch.all(hs[n:, b] == 0)

    # K4 from the JAX stashes, so both sides see the same inputs
    rs = np.random.RandomState(1)
    dout = (rs.randn(T, B, H) * 0.1).astype(np.float32)
    dc_T = (rs.randn(B, H) * 0.1).astype(np.float32)
    dh_T = (rs.randn(B, H) * 0.1).astype(np.float32)
    j_zs, j_cs = want[2], want[1]
    cs_prev = np.concatenate([c0[None], np.asarray(j_cs)[:-1]])
    dz_want, dc_want, dh_want = _lstm_train_bwd_impl(
        j_zs, j_cs, jnp.asarray(cs_prev), jnp.asarray(dout), jw.T,
        jnp.asarray(seq)[:, None], jnp.asarray(dc_T), jnp.asarray(dh_T), interpret=True,
    )
    t_zs = torch.from_numpy(np.array(j_zs.astype(jnp.float32))).to(torch.bfloat16)
    dz, dc0, dh0 = lstm_train_bwd(
        t_zs, torch.from_numpy(np.asarray(j_cs)), torch.from_numpy(cs_prev),
        torch.from_numpy(dout), w_h, seq_t, torch.from_numpy(dc_T), torch.from_numpy(dh_T),
    )
    for got, ref in ((dz, dz_want), (dc0, dc_want), (dh0, dh_want)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=BWD_TOL[dtype])
    for b, n in enumerate(seq.tolist()):
        assert torch.all(dz[n:, b] == 0)


def test_backward_carries_pass_through_past_the_length():
    """A row with no valid step returns its dc_T, dh_T untouched."""
    T, B, H = 4, 2, 16
    rs = np.random.RandomState(2)
    zs = torch.from_numpy(rs.randn(T, B, 4 * H).astype(np.float32)).to(torch.bfloat16)
    cs, cs_prev, dout = (torch.from_numpy(rs.randn(T, B, H).astype(np.float32)) for _ in range(3))
    w_h = torch.from_numpy(rs.randn(H, 4 * H).astype(np.float32))
    dc_T, dh_T = (torch.from_numpy(rs.randn(B, H).astype(np.float32)) for _ in range(2))
    seq = torch.tensor([T, 0], dtype=torch.int32)
    dz, dc0, dh0 = train_backward(zs, cs, cs_prev, dout, w_h, seq, dc_T, dh_T)
    assert torch.all(dz[:, 1] == 0)
    assert torch.equal(dc0[1], dc_T[1]) and torch.equal(dh0[1], dh_T[1])


def weighted_sum(out, c, h, xp):
    """The loss of tests/test_lstm_train_kernel.py, in numpy-free terms."""
    weights = xp.cos(xp.arange(out.size if xp is jnp else out.numel()).reshape(out.shape))
    return (out * weights).sum() + (c * 0.3).sum() + (h * 0.7).sum()


def jax_grads(fn, params, x, seq, c0, h0, jdt):
    def loss(p, x, c0h0):
        out, (c, h) = fn(p, x, seq_len=jnp.asarray(seq), initial_state=c0h0, compute_dtype=jdt)
        return weighted_sum(out, c, h, jnp)

    args = ({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
            (jnp.asarray(c0), jnp.asarray(h0)))
    value = loss(*args)
    gp, gx, (gc, gh) = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return float(value), {"kernel": gp["kernel"], "bias": gp["bias"], "x": gx, "c0": gc, "h0": gh}


def port_grads(params, x, seq, c0, h0, tdt):
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    c0t = torch.from_numpy(c0).requires_grad_()
    h0t = torch.from_numpy(h0).requires_grad_()
    out, (c, h) = lstm_train(leaves, xt, seq_len=torch.from_numpy(seq),
                             initial_state=(c0t, h0t), compute_dtype=tdt)
    loss = weighted_sum(out, c, h, torch)
    loss.backward()
    grads = {"kernel": leaves["kernel"].grad, "bias": leaves["bias"].grad,
             "x": xt.grad, "c0": c0t.grad, "h0": h0t.grad}
    return float(loss.detach()), {k: v.numpy() for k, v in grads.items()}, (out, c, h)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,B,H", [(7, 8, 128), (5, 3, 100)])
def test_lstm_train_values_and_grads_match_jax(dtype, T, B, H):
    jdt, tdt = DTYPES[dtype]
    params, x, seq, c0, h0 = make_case(T + B + H, T, B, H, n_in=48)
    value, grads, (out, c, h) = port_grads(params, x, seq, c0, h0, tdt)
    want_value, want = jax_grads(
        lambda *a, **k: jax_lstm_train(*a, interpret=True, **k), params, x, seq, c0, h0, jdt)
    assert out.dtype == torch.float32 and out.shape == (T, B, H)
    assert abs(value - want_value) <= 1e-4 * max(1.0, abs(want_value))
    for name, ref in want.items():
        ref = np.asarray(ref)
        assert grads[name].dtype == np.float32, name
        if dtype == "float32":
            np.testing.assert_allclose(grads[name], ref, rtol=0, atol=1e-5, err_msg=name)
        else:
            diff = grads[name] - ref
            assert np.linalg.norm(diff) <= BF16_REL_NORM * np.linalg.norm(ref), name
            assert np.abs(diff).max() <= BF16_MAX_SHARE * np.abs(ref).max(), name
    if dtype == "float32":
        # against autodiff of the scan: the backward's gates come from bf16 z
        scan_value, scan = jax_grads(jax_lstm_scan, params, x, seq, c0, h0, jdt)
        assert abs(value - scan_value) <= 1e-4 * max(1.0, abs(scan_value))
        for name, ref in scan.items():
            np.testing.assert_allclose(grads[name], np.asarray(ref), rtol=2e-3,
                                       atol=2e-3, err_msg=name)


def test_lstm_train_without_state_or_lengths_matches_jax():
    T, B, H = 5, 8, 128
    params, x, _, _, _ = make_case(1, T, B, H)
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, _ = lstm_train(leaves, xt, compute_dtype=torch.float32)
    out.square().sum().backward()

    def loss(p, x):
        out, _ = jax_lstm_train(p, x, compute_dtype=jnp.float32, interpret=True)
        return jnp.sum(out ** 2)

    gp, gx = jax.grad(loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    for got, ref in ((leaves["kernel"].grad, gp["kernel"]), (leaves["bias"].grad, gp["bias"]),
                     (xt.grad, gx)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_forward_stashes_and_zero_steps():
    H = 16
    rs = np.random.RandomState(3)
    w_h = torch.from_numpy(rs.randn(H, 4 * H).astype(np.float32))
    c0, h0 = (torch.from_numpy(rs.randn(2, H).astype(np.float32)) for _ in range(2))
    seq = torch.zeros(2, dtype=torch.int32)
    hs, cs, zs, c, h = train_forward(torch.zeros(0, 2, 4 * H), w_h, c0, h0, seq)
    assert hs.shape == cs.shape == (0, 2, H) and zs.shape == (0, 2, 4 * H)
    assert zs.dtype == torch.bfloat16
    assert torch.equal(c, c0) and torch.equal(h, h0)
