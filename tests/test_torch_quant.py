"""The port's int8 inference path against stt_tpu's on the CPU: weight
quantization, the int8 recurrence's plain version (against stt_tpu's
lax.scan twin and its Pallas kernel K2 in interpret mode), the quantized
forward, the weight-only artifact, and `Model(quantized_inference=True)`.

Tolerances. Quantized weights: int8 equal, scales to 1e-7 (the same
float32 divisions). The recurrence from the same x_proj: 1e-5, unless an
h * 127 lands within a last-bit difference (XLA's and ATen's sigmoid and
tanh) of a rounding boundary; that h_q then differs by one step, which
moves later values by about step_scale * |W_h_q| ~ 1e-2. The tests count
those flips and allow 2e-2 only where there is one; on these seeded inputs
there is none. The forward: logits, c and h within 1e-4 of the JAX int8
path's on the same quantized weights (measured 2.4e-7; one x_q flip
between layers, counted after the first, would show as ~1e-2 and fail:
the inputs are seeded and no value sits that close to a boundary).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stt_tpu.artifact import load_artifact as jax_load_artifact
from stt_tpu.models import ModelConfig as JaxModelConfig
from stt_tpu.models import init_params
from stt_tpu.ops import quant as jax_quant
from stt_tpu.ops.lstm_kernel import lstm_fused_q_impl
from stt_tpu_torch.alphabet import Alphabet
from stt_tpu_torch.artifact import (
    build_metadata,
    load_artifact,
    params_from_numpy,
    qparams_from_numpy,
    save_artifact,
)
from stt_tpu_torch.frontend import FeatureConfig
from stt_tpu_torch.models import ModelConfig
from stt_tpu_torch.ops import quant
from stt_tpu_torch.ops.lstm_kernel import lstm_recurrence_q, pack_w_h_q
from stt_tpu_torch.serve import Model

GEOMETRY = dict(n_input=26, n_context=9, n_hidden=128, n_cell_dim=128, n_out=29)
REC_TOL = 2e-2  # with rounding-boundary flips; without any, 1e-5
LOGITS_TOL = 1e-4
LABELS = list(" abcdefghijklmnopqrstuvwxyz'")


def configs(dtype="float32", layer_norm=False):
    kw = dict(GEOMETRY, layer_norm=layer_norm, compute_dtype=dtype, dropout_rates=(0.0,) * 6)
    return JaxModelConfig(**kw), ModelConfig(**kw)


def jax_params(seed=1, layer_norm=False):
    return jax.device_get(init_params(jax.random.PRNGKey(seed), configs(layer_norm=layer_norm)[0]))


def jax_qparams(params, calibration=None):
    jax_cfg, _ = configs()
    calib = None if calibration is None else jnp.asarray(calibration)
    return jax.device_get(jax_quant.quantize_params(params, jax_cfg, calib))


def features(seed, B=8, T=30):
    rs = np.random.RandomState(seed)
    feats = (rs.randn(B, T, 26) * 6).astype(np.float32)
    seq = rs.randint(1, T + 1, size=B).astype(np.int32)
    seq[0] = T
    return feats, seq


def rec_case(seed, T=30, B=8, H=128, dtype=np.float32):
    rs = np.random.RandomState(seed)
    limit = (6.0 / (6 * H)) ** 0.5
    w_h = rs.uniform(-limit, limit, (H, 4 * H)).astype(np.float32)
    w_h_q, scale = jax_quant._quantize_weight(jnp.asarray(w_h))
    x_proj = (rs.randn(T, B, 4 * H) * 0.5).astype(np.float32)
    seq = rs.randint(1, T + 1, size=B).astype(np.int32)
    seq[0] = T
    c0 = (rs.randn(B, H) * 0.1).astype(np.float32)
    h0 = rs.uniform(-0.9, 0.9, (B, H)).astype(np.float32)
    step_scale = (np.asarray(scale) / np.float32(127.0)).reshape(1, -1).astype(np.float32)
    return x_proj, np.asarray(w_h_q), step_scale, c0, h0, seq


def flips(got, want):
    """Share of values whose int8 image (round(v * 127)) differs."""
    return float((np.round(np.asarray(got) * 127) != np.round(np.asarray(want) * 127)).mean())


def test_quantize_weight_equals_jax():
    rs = np.random.RandomState(0)
    w = (rs.randn(300, 64) * rs.uniform(0.01, 2.0, 64)).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero channel takes the 1e-8 floor
    want_q, want_scale = jax_quant._quantize_weight(jnp.asarray(w))
    got_q, got_scale = quant._quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_allclose(got_scale.numpy(), np.asarray(want_scale), rtol=0, atol=1e-7)


@pytest.mark.parametrize("calibrated", [False, True])
def test_quantize_params_equals_jax_through_qparams_from_numpy(calibrated):
    params = jax_params()
    _, cfg = configs()
    calib = features(3)[0] if calibrated else None
    want = qparams_from_numpy(jax_qparams(params, calib))
    model = params_from_numpy(params, cfg)
    got = quant.quantize_params(
        dict(model.named_parameters()), cfg,
        None if calib is None else torch.from_numpy(calib))
    assert set(got) == set(want)
    for name in (*quant.DENSE, "lstm_in"):
        assert torch.equal(got[name].w_q, want[name].w_q), name
        assert got[name].w_q.dtype == torch.int8
        np.testing.assert_allclose(got[name].w_scale.numpy(), want[name].w_scale.numpy(),
                                   rtol=0, atol=1e-7, err_msg=name)
        assert torch.equal(got[name].b, want[name].b), name
        assert got[name].x_scale == pytest.approx(want[name].x_scale, rel=1e-6), name
    for leaf in ("w_h_q", "w_h_q_packed"):
        assert torch.equal(got["lstm_rec"][leaf], want["lstm_rec"][leaf]), leaf
    np.testing.assert_allclose(got["lstm_rec"]["step_scale"].numpy(),
                               want["lstm_rec"]["step_scale"].numpy(), rtol=0, atol=1e-9)
    assert got["lstm_rec"]["step_scale"].shape == (1, 4 * GEOMETRY["n_cell_dim"])


def test_layer_norm_models_are_refused():
    params = jax_params(layer_norm=True)
    _, cfg = configs(layer_norm=True)
    model = params_from_numpy(params, cfg)
    with pytest.raises(ValueError, match="layer_norm"):
        quant.quantize_params(dict(model.named_parameters()), cfg)
    with pytest.raises(ValueError, match="layer_norm"):
        jax_quant.quantize_params(params, configs(layer_norm=True)[0])


def test_packed_weights_hold_four_k_per_word():
    """`pack_w_h_q`'s layout [tiles, chunks, 64 columns, 256 k]: column m of
    tile i is unit 16 i + m % 16 of gate m // 16, and once the pieces' swizzle
    is undone its k lie together, so each 32-bit word holds four consecutive
    k, low byte first; the padding is zero. H = 6, no multiple of 4, is taken
    as stt_tpu takes it (tests/test_torch_lstm_q_plan.py holds the layout at
    larger H)."""
    from stt_tpu_torch.ops.lstm_kernel import swizzle_column_pieces

    for H in (6, 8, 20):
        w = torch.from_numpy(np.random.RandomState(H).randint(-127, 128, (H, 4 * H)).astype(np.int8))
        packed = pack_w_h_q(w)
        tiles = -(-H // 16)
        assert packed.shape == (tiles, 1, 64, 256) and packed.is_contiguous()
        cols = swizzle_column_pieces(packed)
        for tile in range(tiles):
            for m in range(64):
                gate, unit = m // 16, 16 * tile + m % 16
                got = cols[tile, 0, m]
                if unit < H:
                    assert torch.equal(got[:H], w[:, gate * H + unit]), (tile, m)
                    got = got[H:]
                assert not got.any(), (tile, m)
        word = int(cols[0, 0, 0, :4].view(torch.int32))
        assert [(word >> (8 * i)) & 0xFF for i in range(4)] == [v & 0xFF for v in w[:4, 0].tolist()]


@pytest.mark.parametrize("m,k,n", [(16, 2048, 29), (3, 2048, 8), (1, 494, 16)])
def test_int8_matmul_is_the_exact_int32_sum(m, k, n):
    """All operands at +-127 with K = 2048: 33.0 M per sum, which an int8
    product wraps and a float32 product cannot hold (> 2^24)."""
    rs = np.random.RandomState(m + n)
    x = rs.choice([-127, 127], (m, k)).astype(np.int8)
    w = rs.choice([-127, 127], (k, n)).astype(np.int8)
    x[0], w[:, 0] = 127, 127
    got = quant.int8_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    assert got[0, 0].item() == k * 127 * 127
    np.testing.assert_array_equal(got.numpy(), x.astype(np.int64) @ w.astype(np.int64))
    want = jax.lax.dot(jnp.asarray(x), jnp.asarray(w), preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 8])
def test_plain_recurrence_q_matches_jax_scan_and_pallas(dtype, B):
    x_proj, w_h_q, step_scale, c0, h0, seq = rec_case(B, B=B)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    xp_j = jnp.asarray(x_proj).astype(jdt)
    xp_t = torch.from_numpy(np.array(xp_j.astype(jnp.float32))).to(tdt)
    out, (c, h) = lstm_recurrence_q(  # CPU tensors: the plain version
        xp_t, torch.from_numpy(w_h_q), torch.from_numpy(step_scale),
        torch.from_numpy(c0), torch.from_numpy(h0), torch.from_numpy(seq))
    scan_out, (scan_c, scan_h) = jax_quant._lstm_recurrence_scan(
        xp_j, jnp.asarray(w_h_q), jnp.asarray(step_scale), jnp.asarray(c0), jnp.asarray(h0),
        jnp.asarray(seq))
    k_out, k_c, k_h = lstm_fused_q_impl(
        xp_j, jnp.asarray(w_h_q), jnp.asarray(step_scale), jnp.asarray(c0), jnp.asarray(h0),
        jnp.asarray(seq).reshape(B, 1), interpret=True)
    for name, want in (("scan", (scan_out, scan_c, scan_h)), ("pallas", (k_out, k_c, k_h))):
        share = flips(out.numpy(), want[0])
        tol = REC_TOL if share else 1e-5
        for g, w in zip((out, c, h), want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol,
                                       err_msg=f"{name}: {share:.3%} of h_q differ")
        assert share < 0.01, (name, share)
    for b, n in enumerate(seq.tolist()):
        assert torch.all(out[n:, b] == 0)


def test_recurrence_q_one_step_is_exact_in_acc():
    """From a common state one step's z differs from the JAX twin's only by
    float32 rounding of x + acc * scale: the int32 sums are equal."""
    x_proj, w_h_q, step_scale, c0, h0, seq = rec_case(5, T=1)
    out, (c, h) = quant.recurrence_q(
        *(torch.from_numpy(a) for a in (x_proj, w_h_q, step_scale, c0, h0, seq)))
    want, (c_w, h_w) = jax_quant._lstm_recurrence_scan(
        *(jnp.asarray(a) for a in (x_proj, w_h_q, step_scale, c0, h0, seq)))
    for g, w in ((out, want), (c, c_w), (h, h_w)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_apply_model_quantized_matches_jax_on_the_same_qparams():
    params = jax_params()
    jax_cfg, cfg = configs()
    # the Pallas route needs one device; the scan twin computes the same
    jax_cfg = JaxModelConfig(**dict(GEOMETRY, dropout_rates=(0.0,) * 6, fused_lstm=False))
    jq = jax_quant.quantize_params(params, jax_cfg)
    feats, seq = features(4)
    rs = np.random.RandomState(9)
    state = ((rs.randn(8, 128) * 0.1).astype(np.float32),
             rs.uniform(-0.5, 0.5, (8, 128)).astype(np.float32))
    want, (c_w, h_w) = jax_quant.apply_model_quantized(
        jq, jnp.asarray(feats), seq_len=jnp.asarray(seq), config=jax_cfg,
        previous_state=tuple(map(jnp.asarray, state)))
    q = qparams_from_numpy(jax.device_get(jq))
    got, (c, h) = quant.apply_model_quantized(
        q, torch.from_numpy(feats), seq_len=torch.from_numpy(seq), config=cfg,
        previous_state=tuple(map(torch.from_numpy, state)))
    # x_q flips after the first layer: how often the two disagree on the int8
    # image of layer_1's output
    x = jnp.asarray(feats)
    x1_j = jax_quant._qdense_apply(
        jq["layer_1"], jax_quant.create_overlapping_windows(x, 9).reshape(8 * 30, -1), 20.0)
    x1_t = quant._qdense_apply(
        q["layer_1"], quant.create_overlapping_windows(torch.from_numpy(feats), 9).reshape(8 * 30, -1), 20.0)
    scale = q["layer_2"].x_scale
    x_q_flips = float((np.round(np.asarray(x1_j) / scale) != np.round(x1_t.numpy() / scale)).mean())
    assert x_q_flips < 0.01, x_q_flips
    assert got.shape == (8, 30, 29) and got.dtype == torch.float32
    for g, w, name in ((got, want, "logits"), (c, c_w, "c"), (h, h_w, "h")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=LOGITS_TOL,
                                   err_msg=f"{name}; x_q flips after layer_1: {x_q_flips:.3%}")


def narrow_configs(H):
    """A model whose n_cell_dim is H (any H, not only multiples of 4), for
    the JAX scan path and the port."""
    kw = dict(GEOMETRY, n_hidden=32, n_cell_dim=H, dropout_rates=(0.0,) * 6)
    return JaxModelConfig(**kw, fused_lstm=False), ModelConfig(**kw)


@pytest.mark.parametrize("H", [6, 10, 12])
def test_any_n_cell_dim_quantizes_and_matches_jax(H):
    """Each package quantizes stt_tpu's init_params at its own hand, and
    `apply_model_quantized` gives the same logits on the same seeded features
    at n_cell_dim 6 and 10 (which the int8 path once refused) and 12. The
    logits are equal where no h_q crosses a rounding boundary between the
    two recurrences (the carried state then differs by the last bits of
    XLA's and ATen's sigmoid and tanh: 1e-5); where one does, REC_TOL."""
    jax_cfg, cfg = narrow_configs(H)
    params = jax.device_get(init_params(jax.random.PRNGKey(H), jax_cfg))
    jq = jax_quant.quantize_params(params, jax_cfg)
    got_q = quant.quantize_params(dict(params_from_numpy(params, cfg).named_parameters()), cfg)
    assert torch.equal(got_q["lstm_rec"]["w_h_q"], torch.from_numpy(np.array(jq["lstm_rec"]["w_h_q"])))
    feats, seq = features(H, B=4, T=20)
    want, (c_w, h_w) = jax_quant.apply_model_quantized(
        jq, jnp.asarray(feats), seq_len=jnp.asarray(seq), config=jax_cfg)
    got, (c, h) = quant.apply_model_quantized(
        got_q, torch.from_numpy(feats), seq_len=torch.from_numpy(seq), config=cfg)
    # the recurrences' outputs from the same input projection: h_q flips
    x_proj = quant.input_projection_q(got_q, torch.from_numpy(feats), cfg)
    rec = got_q["lstm_rec"]
    zeros = torch.zeros(4, H)
    out, _ = quant.recurrence_q(x_proj, rec["w_h_q"], rec["step_scale"], zeros, zeros,
                                torch.from_numpy(seq))
    want_out, _ = jax_quant._lstm_recurrence_scan(
        jnp.asarray(x_proj.numpy()), jq["lstm_rec"]["w_h_q"], jq["lstm_rec"]["step_scale"],
        jnp.zeros((4, H)), jnp.zeros((4, H)), jnp.asarray(seq))
    share = flips(out.numpy(), want_out)
    assert got.shape == (4, 20, 29)
    if share:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=REC_TOL,
                                   err_msg=f"{share:.3%} of h_q differ")
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for g, w in ((c, c_w), (h, h_w)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=REC_TOL if share else 1e-5)


def test_qparams_from_numpy_takes_n_cell_dim_6():
    """stt_tpu's quantized parameters at n_cell_dim 6 read by the port: the
    int8 weights and scales as they were, W_h_q packed for the kernel."""
    jax_cfg, cfg = narrow_configs(6)
    params = jax.device_get(init_params(jax.random.PRNGKey(3), jax_cfg))
    jq = jax.device_get(jax_quant.quantize_params(params, jax_cfg))
    q = qparams_from_numpy(jq)
    for name in (*quant.DENSE, "lstm_in"):
        np.testing.assert_array_equal(q[name].w_q.numpy(), np.asarray(jq[name].w_q), err_msg=name)
        np.testing.assert_array_equal(q[name].w_scale.numpy(), np.asarray(jq[name].w_scale))
    rec = q["lstm_rec"]
    np.testing.assert_array_equal(rec["w_h_q"].numpy(), np.asarray(jq["lstm_rec"]["w_h_q"]))
    np.testing.assert_array_equal(rec["step_scale"].numpy(), np.asarray(jq["lstm_rec"]["step_scale"]))
    assert torch.equal(rec["w_h_q_packed"], pack_w_h_q(rec["w_h_q"]))
    assert rec["w_h_q_packed"].shape == (1, 1, 64, 256)
    feats, seq = features(8, B=3, T=12)
    want, _ = jax_quant.apply_model_quantized(jq, jnp.asarray(feats), seq_len=jnp.asarray(seq),
                                              config=jax_cfg)
    got, _ = quant.apply_model_quantized(q, torch.from_numpy(feats),
                                         seq_len=torch.from_numpy(seq), config=cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGITS_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_input_projection_q_is_what_the_recurrence_receives(dtype):
    """`input_projection_q` followed by the plain recurrence and the two
    last int8 layers is `apply_model_quantized` bit for bit, and every layer
    keeps its weights widened once (the float64 image `int8_matmul` takes)."""
    params = jax_params()
    jax_cfg, cfg = configs(dtype)
    q = qparams_from_numpy(jax.device_get(jax_quant.quantize_params(params, jax_cfg)))
    feats, seq = features(6)
    feats, seq = torch.from_numpy(feats), torch.from_numpy(seq)
    x_proj = quant.input_projection_q(q, feats, cfg)
    assert x_proj.shape == (30, 8, 4 * 128) and x_proj.dtype == cfg.dtype
    rec = q["lstm_rec"]
    zeros = torch.zeros(8, 128)
    out, (c, h) = quant.recurrence_q(x_proj, rec["w_h_q"], rec["step_scale"], zeros, zeros, seq)
    x = quant._qdense_apply(q["layer_5"], out.transpose(0, 1).reshape(8 * 30, -1), 20.0)
    logits = quant._qdense_apply(q["layer_6"], x, None).reshape(8, 30, 29)
    want, (c_w, h_w) = quant.apply_model_quantized(q, feats, seq_len=seq, config=cfg)
    assert torch.equal(logits, want) and torch.equal(c, c_w) and torch.equal(h, h_w)
    for name in ("layer_1", "layer_2", "layer_3", "lstm_in", "layer_5", "layer_6"):
        layer = q[name].to("cpu")
        assert layer.w_wide.dtype == torch.float64
        assert torch.equal(layer.w_wide, layer.w_q.double())
        x_q = torch.randint(-127, 128, (3, layer.w_q.shape[0]), dtype=torch.int8)
        assert torch.equal(quant.int8_matmul(x_q, layer.w_q, layer.w_wide),
                           quant.int8_matmul(x_q, layer.w_q))


@pytest.fixture(scope="module")
def int8_artifact(tmp_path_factory):
    _, cfg = configs()
    cfg = ModelConfig(**dict(GEOMETRY, dropout_rates=(0.0,) * 6))
    alphabet = Alphabet().init_from_labels(LABELS)
    model = params_from_numpy(jax_params(7), cfg)
    root = tmp_path_factory.mktemp("int8")
    meta = build_metadata(cfg, FeatureConfig(), alphabet, beam_width=8)
    return (save_artifact(str(root / "plain"), model, meta, alphabet),
            save_artifact(str(root / "int8"), model, meta, alphabet, quantize=True), model)


def test_quantized_artifact_is_read_by_both_packages(int8_artifact):
    _, path, model = int8_artifact
    got, meta, _ = load_artifact(path)
    want, want_meta, _ = jax_load_artifact(path)
    assert meta == want_meta and meta["quantized"] is True
    with np.load(f"{path}/weights.npz") as npz:
        assert npz["layer_2/w_q"].dtype == np.int8 and npz["lstm/w_h_f16"].dtype == np.float16
        # the entries are those of stt_tpu's writer on the same weights
        state = {k: v.detach().numpy() for k, v in model.state_dict().items()}
        tree = {}
        for name, value in state.items():
            layer, leaf = name.split("/")
            tree.setdefault(layer, {})[leaf] = value
        ref = jax_quant.flatten_weight_only(tree, n_cell=GEOMETRY["n_cell_dim"])
        assert set(npz.files) == set(ref)
        for name in ref:
            if name.endswith("scale"):
                np.testing.assert_allclose(npz[name], ref[name], rtol=0, atol=1e-7, err_msg=name)
            else:
                np.testing.assert_array_equal(npz[name], ref[name], err_msg=name)
    for layer in want:
        for leaf in want[layer]:
            np.testing.assert_array_equal(got[layer][leaf], want[layer][leaf])
    # dequantized weights are within half a quantization step of the originals
    w = model.state_dict()["layer_2/w"].numpy()
    step = np.abs(w).max(axis=0) / 127.0
    assert (np.abs(got["layer_2"]["w"] - w) <= step * 0.5 + 1e-7).all()


def test_model_quantized_inference_on_the_cpu(int8_artifact):
    from stt_tpu.serve import Model as JaxModel

    path, _, _ = int8_artifact
    feats, seq = features(6, B=3, T=25)
    model = Model(path, quantized_inference=True, device="cpu")
    got = model.infer_logits(feats, seq)
    want = np.asarray(JaxModel(path, quantized_inference=True).infer_logits(feats, seq))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGITS_TOL)
    # int8 is an approximation of the float path, and a close one
    float_logits = Model(path, device="cpu").infer_logits(feats, seq).numpy()
    mask = np.arange(25)[None, :] < seq[:, None]
    assert 0 < np.abs(got.numpy() - float_logits)[mask].max() < 0.5
    # streams stay float
    audio = np.random.RandomState(0).uniform(-0.3, 0.3, 16000).astype(np.float32)
    assert model.stt(audio) == Model(path, device="cpu").stt(audio)
