"""The port's DeepSpeech forward against stt_tpu.models.apply_model on the
CPU, with parameters carried across by params_from_numpy: the inference
route (under no_grad, K1's plain version) and the training route (autograd
recording, the plain versions of K3/K4).

Tolerance on logits and (c, h): 1e-5 in f32 and bf16 (five layers of
float32 products summed in another order; both sides round to bf16 at the
same points, and a port that skipped the LSTM's h rounding is 2e-3 off).
With layer norm in bf16, 2e-2: XLA's rsqrt and torch's differ in the last
bits, which tips some normalised activations across a bf16 rounding
boundary before the next layer (6e-3 measured on these inputs).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stt_tpu.models import ModelConfig as JaxModelConfig
from stt_tpu.models import apply_model, create_overlapping_windows as jax_windows, init_params
from stt_tpu_torch.artifact import params_from_numpy
from stt_tpu_torch.models import DeepSpeech, ModelConfig, create_overlapping_windows

TOL = {"float32": 1e-5, "bfloat16": 1e-5}
BF16_LAYER_NORM_TOL = 2e-2
GEOMETRY = dict(n_input=26, n_context=9, n_hidden=96, n_cell_dim=128, n_out=29)


def configs(dtype, layer_norm=False):
    kw = dict(GEOMETRY, layer_norm=layer_norm, compute_dtype=dtype, dropout_rates=(0.0,) * 6)
    return JaxModelConfig(**kw), ModelConfig(**kw)


def inputs(seed, B=3, T=23):
    rs = np.random.RandomState(seed)
    feats = (rs.randn(B, T, GEOMETRY["n_input"]) * 3).astype(np.float32)
    seq = rs.randint(1, T + 1, size=B).astype(np.int32)
    seq[0] = T
    H = GEOMETRY["n_cell_dim"]
    state = ((rs.randn(B, H) * 0.1).astype(np.float32),
             rs.uniform(-0.2, 0.2, (B, H)).astype(np.float32))
    return feats, seq, state


def test_overlapping_windows_are_the_same():
    feats = np.random.RandomState(0).randn(2, 11, 5).astype(np.float32)
    got = create_overlapping_windows(torch.from_numpy(feats), 3).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_windows(jnp.asarray(feats), 3)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer_norm", [False, True])
def test_forward_matches_apply_model(dtype, layer_norm):
    jax_cfg, cfg = configs(dtype, layer_norm)
    params = jax.device_get(init_params(jax.random.PRNGKey(1), jax_cfg))
    model = params_from_numpy(params, cfg, device="cpu")
    feats, seq, state = inputs(2)
    want, (c_want, h_want) = apply_model(
        params, jnp.asarray(feats), seq_len=jnp.asarray(seq), config=jax_cfg,
        previous_state=tuple(map(jnp.asarray, state)),
    )
    with torch.no_grad():
        got, (c, h) = model(
            torch.from_numpy(feats), seq_len=torch.from_numpy(seq),
            previous_state=tuple(map(torch.from_numpy, state)),
        )
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = BF16_LAYER_NORM_TOL if layer_norm and dtype == "bfloat16" else TOL[dtype]
    for g, w in ((got, want), (c, c_want), (h, h_want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol)


def test_forward_without_lengths_or_state():
    jax_cfg, cfg = configs("float32")
    params = jax.device_get(init_params(jax.random.PRNGKey(3), jax_cfg))
    feats, _, _ = inputs(4, B=1, T=16)
    want, _ = apply_model(params, jnp.asarray(feats), config=jax_cfg)
    with torch.no_grad():
        got, _ = params_from_numpy(params, cfg)(torch.from_numpy(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL["float32"])


def test_state_dict_keeps_the_flat_names_and_init_ranges():
    _, cfg = configs("float32", layer_norm=True)
    model = DeepSpeech(cfg, generator=torch.Generator().manual_seed(0))
    jax_cfg, _ = configs("float32", layer_norm=True)
    params = jax.device_get(init_params(jax.random.PRNGKey(0), jax_cfg))
    flat = {f"{k}/{leaf}": v for k, d in params.items() for leaf, v in d.items()}
    state = model.state_dict()
    assert set(state) == set(flat)
    for name, value in flat.items():
        got = state[name].numpy()
        assert got.shape == value.shape, name
        # the same distribution: equal bounds for uniform draws, equal constants
        if name.endswith(("/w", "/kernel")):
            limit = np.abs(value).max()
            assert np.abs(got).max() <= limit * 1.05 and np.abs(got).max() >= limit * 0.9, name
        else:
            np.testing.assert_array_equal(got, value, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_training_route_forward_matches_apply_model(dtype):
    """With autograd recording, the LSTM runs lstm_train; values are the
    same function."""
    from stt_tpu_torch.ops import lstm_recurrence, lstm_train_fwd

    jax_cfg, cfg = configs(dtype)
    params = jax.device_get(init_params(jax.random.PRNGKey(5), jax_cfg))
    model = params_from_numpy(params, cfg)
    feats, seq, _ = inputs(6)
    want, (c_want, h_want) = apply_model(params, jnp.asarray(feats), seq_len=jnp.asarray(seq),
                                         config=jax_cfg)
    calls = []
    for fn in (lstm_recurrence, lstm_train_fwd):
        calls.append(fn.launches)
    got, (c, h) = model(torch.from_numpy(feats), seq_len=torch.from_numpy(seq))
    assert got.requires_grad
    # CPU tensors take the plain versions, which count no launches
    assert [lstm_recurrence.launches, lstm_train_fwd.launches] == calls
    for g, w in ((got, want), (c, c_want), (h, h_want)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=TOL[dtype])


def test_dropout_masks_and_scales_like_the_jax_dense():
    """Dropout only with a generator; the kept share is 1 - rate and kept
    values are scaled by 1 / (1 - rate); the same generator seed gives the
    same masks."""
    rate = 0.25
    cfg = ModelConfig(**dict(GEOMETRY, dropout_rates=(rate, rate, rate, 0.0, 0.0, rate)))
    model = DeepSpeech(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.rand(4000, GEOMETRY["n_hidden"]) + 0.5
    model.get_parameter("layer_2/b").data.zero_()
    plain = model._dense("layer_2", x)
    dropped = model._dense("layer_2", x, dropout_rate=rate,
                           generator=torch.Generator().manual_seed(1))
    kept = dropped != 0
    live = plain != 0  # the clipped ReLU zeroes some values before dropout
    assert abs(kept[live].float().mean().item() - (1 - rate)) < 0.01
    np.testing.assert_allclose(dropped[kept].detach().numpy(),
                               (plain[kept] / (1 - rate)).detach().numpy(), rtol=1e-6)
    feats = torch.from_numpy(inputs(7)[0])
    with torch.no_grad():
        a, _ = model(feats, dropout_generator=torch.Generator().manual_seed(3))
        b, _ = model(feats, dropout_generator=torch.Generator().manual_seed(3))
        c, _ = model(feats, dropout_generator=torch.Generator().manual_seed(4))
        d, _ = model(feats)
        e, _ = model(feats)
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.equal(d, e)
    assert not torch.equal(a, d)
