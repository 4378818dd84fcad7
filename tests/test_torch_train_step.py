"""The port's train and eval steps against stt_tpu.train on the CPU, with
the JAX parameters carried across by params_from_numpy, dropout off, and a
batch with one infeasible sample (its loss is inf, it is masked out of the
mean and flagged in `non_finite`).

On the CPU the JAX step differentiates `lstm_scan` (its Pallas training
kernels are for the TPU), while the port's CPU step runs the plain
versions of K3/K4, whose backward takes its gates from z stashed in bf16.
So the losses agree as tightly as the forward does, and the gradients of
the LSTM and the layers below it by what that rounding moves:

- loss, per-example loss: on the first step, from the same parameters,
  1e-5 relative in f32 (float32 sums in another order; measured 1.7e-7);
  on the next two, 1e-4 (the parameters have drifted apart, see below;
  measured 3.3e-5). non_finite equal.
- gradients of the first step, per parameter, by relative norm: 2e-3 in
  f32 (the bf16 z stash; tests/test_lstm_train_kernel.py holds the JAX
  pair to 2e-3; measured up to 9.4e-4, layer_1/w).
- grad_norm: 1e-3 relative in f32 (measured up to 2.9e-4).
- parameters after 3 Adam steps: Adam moves each parameter by about +-lr a
  step whatever the size of its gradient, so a gradient near 0 whose sign
  differs between the two packages moves that parameter up to 2 lr apart
  a step. So each parameter is held by the norm of its difference, at most
  10% of the norm of JAX's movement (measured up to 6.9%, layer_2/b), and
  by its largest difference, at most 6 lr (measured 2.3 lr); the
  gradients above hold the rest.
- bf16 compute: both round every product's operands to bf16 but at
  different points in the scan's autodiff and in the port's backward, so
  loss 1e-3 relative (measured 1.6e-4), gradients 2e-2 by relative norm
  (measured up to 4.8e-3), grad_norm 2e-2 (measured 3.2e-4); parameters as
  in f32 (measured 5.4% and 3.9 lr).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from stt_tpu.frontend import FeatureConfig as JaxFeatureConfig
from stt_tpu.models import ModelConfig as JaxModelConfig
from stt_tpu.models import init_params
from stt_tpu.train import Batch as JaxBatch
from stt_tpu.train import create_train_state as jax_create_train_state
from stt_tpu.train import make_eval_step as jax_make_eval_step
from stt_tpu.train import make_train_step as jax_make_train_step
from stt_tpu.train.step import _loss_fn as jax_loss_fn
from stt_tpu.train.step import create_optimizer as jax_create_optimizer
from stt_tpu.train.step import make_train_step_audio as jax_make_train_step_audio
from stt_tpu_torch.artifact import params_from_numpy
from stt_tpu_torch.frontend import FeatureConfig
from stt_tpu_torch.models import ModelConfig
from stt_tpu_torch.train import (
    Batch,
    create_optimizer,
    create_train_state,
    make_eval_step,
    make_train_step,
    make_train_step_audio,
)

GEOMETRY = dict(n_input=26, n_context=9, n_hidden=64, n_cell_dim=128, n_out=29)
LR = 1e-3
TOL = {
    "float32": dict(loss=(1e-5, 1e-4), grad=2e-3, norm=1e-3),
    "bfloat16": dict(loss=(1e-3, 1e-3), grad=2e-2, norm=2e-2),
}
PARAM_MOVE_SHARE = 0.1
PARAM_MAX_LR = 6


def configs(dtype):
    kw = dict(GEOMETRY, compute_dtype=dtype, dropout_rates=(0.0,) * 6)
    return JaxModelConfig(**kw), ModelConfig(**kw)


def make_batch(seed, B=4, T=40, L=8):
    rs = np.random.RandomState(seed)
    feats = (rs.randn(B, T, GEOMETRY["n_input"]) * 3).astype(np.float32)
    feat_lens = np.array([T, 33, 27, 5][:B], np.int32)
    labels = rs.randint(0, GEOMETRY["n_out"] - 1, size=(B, L)).astype(np.int32)
    label_lens = np.array([8, 6, 4, 8][:B], np.int32)  # row 3: 8 labels in 5 frames
    return feats, feat_lens, labels, label_lens


def jax_batch(arrays):
    return JaxBatch(*map(jnp.asarray, arrays))


def port_batch(arrays):
    return Batch(*map(torch.from_numpy, arrays))


def flat(tree):
    return {f"{layer}/{leaf}": np.asarray(v) for layer, d in tree.items() for leaf, v in d.items()}


def rel_norm(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_steps_match_jax(dtype):
    tol = TOL[dtype]
    jax_cfg, cfg = configs(dtype)
    params = jax.device_get(init_params(jax.random.PRNGKey(0), jax_cfg))
    arrays = make_batch(1)
    optimizer = jax_create_optimizer(learning_rate=LR)
    jstate = jax_create_train_state(None, jax_cfg, optimizer, params=params)
    jstep = jax_make_train_step(jax_cfg, optimizer)
    (_, _), jgrads = jax.value_and_grad(jax_loss_fn, has_aux=True)(
        params, jax_batch(arrays), None, jax_cfg)
    jgrads = flat(jgrads)

    state = create_train_state(cfg, device="cpu", model=params_from_numpy(params, cfg),
                               learning_rate=LR)
    step = make_train_step()
    for i in range(3):
        jstate, jm = jstep(jstate, jax_batch(arrays), jax.random.PRNGKey(9))
        state, m = step(state, port_batch(arrays), 9)
        assert state.step == int(jstate.step) == i + 1
        np.testing.assert_array_equal(m.non_finite.numpy(), np.asarray(jm.non_finite))
        assert m.non_finite.tolist() == [False, False, False, True]
        finite = ~m.non_finite.numpy()
        loss_tol = tol["loss"][min(i, 1)]
        np.testing.assert_allclose(m.per_example_loss.numpy()[finite],
                                   np.asarray(jm.per_example_loss)[finite], rtol=loss_tol)
        np.testing.assert_allclose(m.loss.item(), float(jm.loss), rtol=loss_tol)
        np.testing.assert_allclose(m.grad_norm.item(), float(jm.grad_norm), rtol=tol["norm"])
        if i == 0:
            grads = {k: p.grad.numpy().copy() for k, p in state.model.named_parameters()}
            assert set(grads) == set(jgrads)
            for name, want in jgrads.items():
                assert np.isfinite(grads[name]).all(), name
                assert rel_norm(grads[name], want) <= tol["grad"], (name, rel_norm(grads[name], want))

    start = flat(params)
    for name, want in flat(jstate.params).items():
        got = state.params[name].detach().numpy()
        moved = np.linalg.norm(want - start[name])
        assert np.linalg.norm(got - want) <= PARAM_MOVE_SHARE * moved, name
        assert np.abs(got - want).max() <= PARAM_MAX_LR * LR, name


def test_audio_step_and_eval_step_match_jax():
    jax_cfg, cfg = configs("float32")
    params = jax.device_get(init_params(jax.random.PRNGKey(2), jax_cfg))
    rs = np.random.RandomState(3)
    fc = FeatureConfig()
    n = [8000, 6400, 4000]
    audio = np.zeros((3, 8000 + 320 * 3), np.float32)
    for i, k in enumerate(n):
        audio[i, :k] = rs.uniform(-0.5, 0.5, k)
    frames = np.array([(k - fc.window_samples) // fc.step_samples + 1 for k in n], np.int32)
    labels = rs.randint(0, 28, size=(3, 8)).astype(np.int32)
    label_lens = np.array([8, 5, 3], np.int32)
    arrays = (audio, frames, labels, label_lens)

    optimizer = jax_create_optimizer(learning_rate=LR)
    jstate = jax_create_train_state(None, jax_cfg, optimizer, params=params)
    _, jm = jax_make_train_step_audio(jax_cfg, optimizer, JaxFeatureConfig())(
        jstate, jax_batch(arrays), jax.random.PRNGKey(0))
    state = create_train_state(cfg, device="cpu", model=params_from_numpy(params, cfg))
    _, m = make_train_step_audio(fc)(state, port_batch(arrays), 0)
    np.testing.assert_allclose(m.per_example_loss.numpy(), np.asarray(jm.per_example_loss),
                               rtol=1e-5)

    feats, feat_lens, labels, label_lens = make_batch(4, B=3)
    jlosses, jlogits = jax_make_eval_step(jax_cfg)(params, jax_batch(make_batch(4, B=3)))
    model = params_from_numpy(params, cfg)
    losses, logits = make_eval_step()(model, port_batch((feats, feat_lens, labels, label_lens)))
    assert not logits.requires_grad
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-5)


def test_adam_matches_optax_with_eps_outside_the_root():
    """With gradients of the size of eps, eps inside or outside the square
    root of v_hat gives visibly different updates; torch's Adam must give
    optax's."""
    grads = [np.array([1e-8, -3e-8, 2e-7, 0.5], np.float32),
             np.array([-2e-8, 1e-8, -1e-7, 0.25], np.float32)]
    p0 = np.array([1.0, -1.0, 0.5, 0.0], np.float32)
    opt = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)
    jp, jstate = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    adam = create_optimizer([param], learning_rate=LR)
    for g in grads:
        updates, jstate = opt.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        param.grad = torch.from_numpy(g)
        adam.step()
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-7)
    # eps outside the root moves the first element by 0.276 lr in these two
    # steps; inside it (sqrt(v_hat + eps)), by about 1e-4 lr
    moved = np.abs(param.detach().numpy() - p0)
    assert moved[0] > 0.2 * LR
