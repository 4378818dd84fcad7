"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA card and nvcc, and skips without them. The
file imports no JAX, so it runs where JAX is not installed; tests/conftest.py
does import JAX, so run it on the card without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: 1e-5 in f32 (float32 sums in another order). In bf16 those
~1e-7 differences tip a few h values across a bf16 rounding boundary,
which moves later steps by up to ~1e-4: 3e-4. The training forward's zs
stash is bf16 in both dtypes: each value within one bf16 ulp (2^-7 of
it) plus the dtype's tolerance, since z differs as h does and the bf16
rounding can then land on either side. The training backward's dz, dc0,
dh0 from the same stashes: 1e-5 in f32 and 3e-4 in bf16, where dz is
rounded to bf16 before the product with W_h and the same tipping applies.
The int8 recurrence (K2): its int32 sums are exact, so one step from a
common state gives the plain version's z-derived values to 1e-5; over a
sequence a last-bit difference in expf/tanhf moves some h * 127 across a
rounding boundary, that h_q then differs by one step (1/127 of h's range),
and the difference spreads through W_h: 2e-2, with the share of differing
h_q printed on failure. The beam scan (K5): backpointers equal, scores to
1e-4.
Gradients of `lstm_train` on the card against the CPU: in f32 1e-4 of each
gradient's largest value; in bf16 the gradients of x and W_x pass through
bf16 casts, so, as in tests/test_torch_lstm_train.py, by relative norm
(2e-3) and largest difference (2^-7 of the largest value).
"""

import numpy as np
import pytest
import torch

from stt_tpu_torch.models import DeepSpeech, ModelConfig
from stt_tpu_torch.models.lstm import project_inputs, recurrence
from stt_tpu_torch.ops import lstm_recurrence, lstm_train, lstm_train_bwd, lstm_train_fwd
from stt_tpu_torch.ops.lstm_train import train_backward, train_forward

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-4}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernels have no CPU mode)")
    from stt_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def lstm_case(seed, T, B, H, n_in):
    rs = np.random.RandomState(seed)
    limit = (6.0 / (n_in + 5 * H)) ** 0.5
    params = {
        "kernel": torch.from_numpy(rs.uniform(-limit, limit, (n_in + H, 4 * H)).astype(np.float32)),
        "bias": torch.from_numpy((rs.randn(4 * H) * 0.1).astype(np.float32)),
    }
    x = torch.from_numpy((rs.randn(T, B, n_in) * 0.5).astype(np.float32))
    seq = rs.randint(1, T + 1, size=B).astype(np.int32)
    seq[0] = T
    c0 = torch.from_numpy((rs.randn(B, H) * 0.1).astype(np.float32))
    h0 = torch.from_numpy(rs.uniform(-0.1, 0.1, (B, H)).astype(np.float32))
    return params, x, torch.from_numpy(seq), c0, h0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H", [(1, 128), (3, 100), (8, 128), (32, 256)])
def test_lstm_kernel_matches_plain(device, dtype, B, H):
    params, x, seq, c0, h0 = lstm_case(B + H, T=40, B=B, H=H, n_in=64)
    params = {k: v.to(device) for k, v in params.items()}
    x_proj, w_h = project_inputs(params, x.to(device), dtype)
    args = (x_proj, w_h, c0.to(device), h0.to(device), seq.to(device))
    before = lstm_recurrence.launches
    out, (c, h) = lstm_recurrence(*args)
    want, (c_ref, h_ref) = recurrence(*args)
    torch.cuda.synchronize()
    assert lstm_recurrence.launches == before + 1
    for got, ref in ((out, want), (c, c_ref), (h, h_ref)):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=TOL[dtype])
    for b, n in enumerate(seq.tolist()):
        assert torch.all(out[n:, b] == 0)


# T = 1; a long T; B past one group of rows (17, 40); the full width with
# the batch request's B; an H that is no multiple of the tile or the chunk;
# more tiles than SMs (H = 2128: two tiles a block)
EDGE_SHAPES = [(1, 2, 128), (600, 3, 100), (12, 17, 256), (9, 40, 128),
               (6, 16, 2048), (5, 2, 2049), (5, 2, 2128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H", EDGE_SHAPES)
def test_lstm_forward_kernels_edge_shapes(device, dtype, T, B, H):
    """K1 and K3 at the edges of the launch plan, against their plain
    versions; K3's hs is K1's out, bit for bit (one kernel, two epilogues)."""
    params, x, seq, c0, h0 = lstm_case(T + B + H, T=T, B=B, H=H, n_in=32)
    params = {k: v.to(device) for k, v in params.items()}
    x_proj, w_h = project_inputs(params, x.to(device), dtype)
    args = (x_proj, w_h, c0.to(device), h0.to(device), seq.to(device))
    out, (c, h) = lstm_recurrence(*args)
    hs, cs, zs, c_T, h_T = lstm_train_fwd(*args)
    want = train_forward(*args)
    torch.cuda.synchronize()
    # the bf16 roundings of h tip over more steps at T = 600
    tol = TOL[dtype] if T <= 40 or dtype == torch.float32 else 5e-4
    for name, g, w in zip(("hs", "cs", "c_T", "h_T"), (hs, cs, c_T, h_T),
                          (want[0], want[1], want[3], want[4])):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0, atol=tol,
                                   err_msg=name)
    assert_zs_close(zs, want[2], tol)
    assert torch.equal(out, hs) and torch.equal(c, c_T) and torch.equal(h, h_T)
    for b, n in enumerate(seq.tolist()):
        assert torch.all(out[n:, b] == 0)


def test_lstm_kernel_calls_in_a_row_are_bit_equal(device):
    """Two calls queued on one stream without a synchronise between them,
    and the same call again: the barrier's counter starts each call anew and
    the sums are taken in a fixed order."""
    params, x, seq, c0, h0 = lstm_case(3, T=33, B=5, H=256, n_in=32)
    params = {k: v.to(device) for k, v in params.items()}
    x_proj, w_h = project_inputs(params, x.to(device), torch.float32)
    args = (x_proj, w_h, c0.to(device), h0.to(device), seq.to(device))
    first = lstm_recurrence(*args)
    second = lstm_recurrence(*args)
    torch.cuda.synchronize()
    third = lstm_recurrence(*args)
    fwd = [lstm_train_fwd(*args) for _ in range(2)]
    torch.cuda.synchronize()
    for other in (second, third):
        assert torch.equal(first[0], other[0])
        assert torch.equal(first[1][0], other[1][0]) and torch.equal(first[1][1], other[1][1])
    for a, b in zip(*fwd):
        assert torch.equal(a, b)


def test_serving_uses_the_new_packed_weights_after_a_weight_change(device):
    """The model keeps W_h in K1's layout across requests and makes it anew
    when the weights change, in place or by a load."""
    config = ModelConfig(n_hidden=64, n_cell_dim=128, n_out=29)
    card = DeepSpeech(config, device=device)
    card.load_state_dict(DeepSpeech(config, generator=torch.Generator().manual_seed(0)).state_dict())
    feats = torch.from_numpy((np.random.RandomState(1).randn(2, 30, 26) * 3).astype(np.float32))

    def logits_both():
        cpu = DeepSpeech(config)
        cpu.load_state_dict(card.state_dict())
        with torch.no_grad():
            return card(feats.to(device))[0].cpu().numpy(), cpu(feats)[0].numpy()

    got, want = logits_both()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    packed = card.packed_w_h()
    assert card.packed_w_h() is packed  # kept, not made per request
    with torch.no_grad():
        card.param("lstm/kernel").mul_(-0.5)
    got2, want2 = logits_both()
    assert card.packed_w_h() is not packed
    assert np.abs(want2 - want).max() > 1e-3
    np.testing.assert_allclose(got2, want2, rtol=0, atol=1e-4)
    other = DeepSpeech(config, generator=torch.Generator().manual_seed(5))
    card.load_state_dict(other.state_dict())
    got3, want3 = logits_both()
    np.testing.assert_allclose(got3, want3, rtol=0, atol=1e-4)


def test_lstm_kernel_zero_steps(device):
    params, x, seq, c0, h0 = lstm_case(0, T=3, B=2, H=64, n_in=16)
    x_proj, w_h = project_inputs({k: v.to(device) for k, v in params.items()},
                                 x[:0].to(device), torch.float32)
    out, (c, h) = lstm_recurrence(x_proj, w_h, c0.to(device), h0.to(device),
                                  torch.zeros(2, dtype=torch.int32, device=device))
    assert out.shape == (0, 2, 64)
    assert torch.equal(c.cpu(), c0) and torch.equal(h.cpu(), h0)


def test_model_on_card_matches_cpu(device):
    config = ModelConfig(n_hidden=96, n_cell_dim=128, n_out=29)
    cpu = DeepSpeech(config, generator=torch.Generator().manual_seed(0))
    card = DeepSpeech(config, device=device)
    card.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(1)
    feats = torch.from_numpy((rs.randn(3, 37, 26) * 3).astype(np.float32))
    seq = torch.tensor([37, 20, 5], dtype=torch.int32)
    before = lstm_recurrence.launches
    with torch.no_grad():
        got, (c, h) = card(feats.to(device), seq_len=seq.to(device))
        want, (c_ref, h_ref) = cpu(feats, seq_len=seq)
    assert lstm_recurrence.launches == before + 1
    for g, w in ((got, want), (c, c_ref), (h, h_ref)):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=0, atol=1e-4)


def assert_zs_close(got: torch.Tensor, want: torch.Tensor, tol: float):
    """bf16 stashes: within one bf16 ulp (2^-7 of the value) plus tol."""
    got, want = got.float().cpu(), want.float().cpu()
    bad = (got - want).abs() > 2.0 ** -7 * want.abs() + tol
    assert not bad.any(), (bad.float().mean().item(), (got - want).abs().max().item())


def assert_grads_close(got: torch.Tensor, want: torch.Tensor, dtype, name: str):
    got, want = got.cpu().double(), want.cpu().double()
    scale = want.abs().max().item()
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
    else:
        diff = got - want
        assert diff.norm() <= 2e-3 * want.norm(), (name, (diff.norm() / want.norm()).item())
        assert diff.abs().max() <= 2.0 ** -7 * scale, (name, diff.abs().max().item(), scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H", [(1, 128), (3, 100), (8, 128), (32, 256)])
def test_lstm_train_kernels_match_plain(device, dtype, B, H):
    T = 30
    params, x, seq, c0, h0 = lstm_case(B * 7 + H, T=T, B=B, H=H, n_in=64)
    params = {k: v.to(device) for k, v in params.items()}
    x_proj, w_h = project_inputs(params, x.to(device), dtype)
    seq, c0, h0 = seq.to(device), c0.to(device), h0.to(device)
    before = (lstm_train_fwd.launches, lstm_train_bwd.launches)
    got = lstm_train_fwd(x_proj, w_h, c0, h0, seq)
    want = train_forward(x_proj, w_h, c0, h0, seq)
    torch.cuda.synchronize()
    for name, g, w in zip(("hs", "cs", "c_T", "h_T"), (got[0], got[1], got[3], got[4]),
                          (want[0], want[1], want[3], want[4])):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0,
                                   atol=TOL[dtype], err_msg=name)
    assert_zs_close(got[2], want[2], TOL[dtype])

    gen = torch.Generator().manual_seed(B + H)
    dout = (torch.randn(T, B, H, generator=gen) * 0.1).to(device)
    dc_T = (torch.randn(B, H, generator=gen) * 0.1).to(device)
    dh_T = (torch.randn(B, H, generator=gen) * 0.1).to(device)
    zs, cs = want[2], want[1]
    cs_prev = torch.cat([c0[None], cs[:-1]]).contiguous()
    dz, dc0, dh0 = lstm_train_bwd(zs, cs, cs_prev, dout, w_h, seq, dc_T, dh_T)
    dz_ref, dc_ref, dh_ref = train_backward(zs, cs, cs_prev, dout, w_h, seq, dc_T, dh_T)
    torch.cuda.synchronize()
    assert (lstm_train_fwd.launches, lstm_train_bwd.launches) == (before[0] + 1, before[1] + 1)
    for name, g, w in (("dz", dz, dz_ref), ("dc0", dc0, dc_ref), ("dh0", dh0, dh_ref)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0,
                                   atol=TOL[dtype], err_msg=name)
    for b, n in enumerate(seq.tolist()):
        assert torch.all(dz[n:, b] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_train_grads_on_card_match_cpu(device, dtype):
    params, x, seq, c0, h0 = lstm_case(5, T=20, B=8, H=128, n_in=64)

    def grads(dev):
        leaves = {k: v.clone().to(dev).requires_grad_() for k, v in params.items()}
        xs = [t.clone().to(dev).requires_grad_() for t in (x, c0, h0)]
        out, (c, h) = lstm_train(leaves, xs[0], seq_len=seq.to(dev),
                                 initial_state=(xs[1], xs[2]), compute_dtype=dtype)
        weights = torch.cos(torch.arange(out.numel(), device=dev).reshape(out.shape).float())
        ((out * weights).sum() + (c * 0.3).sum() + (h * 0.7).sum()).backward()
        return [leaves["kernel"].grad, leaves["bias"].grad] + [t.grad for t in xs]

    before = (lstm_train_fwd.launches, lstm_train_bwd.launches)
    card = grads(device)
    assert (lstm_train_fwd.launches, lstm_train_bwd.launches) == (before[0] + 1, before[1] + 1)
    for name, g, w in zip(("kernel", "bias", "x", "c0", "h0"), card, grads("cpu")):
        assert g.dtype == torch.float32, name
        assert_grads_close(g, w, dtype, name)


def test_train_step_on_card_launches_k3_k4_and_matches_cpu(device):
    """One train step on the card and on the CPU from the same weights: the
    loss, the gradient norm and every gradient agree. (Parameters after
    Adam's first step are not compared: it moves each by about +-lr
    whatever the size of its gradient, so a gradient near 0 whose sign
    differs between the two would move a parameter 2 lr apart.)"""
    from stt_tpu_torch.train.step import Batch, create_train_state, make_train_step

    config = ModelConfig(n_hidden=64, n_cell_dim=128, n_out=29, dropout_rates=(0.0,) * 6)
    rs = np.random.RandomState(2)
    feats = torch.from_numpy((rs.randn(3, 40, 26) * 3).astype(np.float32))
    batch = Batch(feats, torch.tensor([40, 31, 22], dtype=torch.int32),
                  torch.from_numpy(rs.randint(0, 28, (3, 8)).astype(np.int32)),
                  torch.tensor([8, 5, 3], dtype=torch.int32))
    results = []
    for dev in (device, torch.device("cpu")):
        state = create_train_state(config, seed=0, device=dev)
        before = (lstm_train_fwd.launches, lstm_train_bwd.launches)
        state, metrics = make_train_step()(state, batch.to(dev), 1)
        if dev.type == "cuda":
            assert (lstm_train_fwd.launches, lstm_train_bwd.launches) == (
                before[0] + 1, before[1] + 1)
        results.append((metrics, {k: p.grad.cpu() for k, p in state.model.named_parameters()}))
    (m_card, g_card), (m_cpu, g_cpu) = results
    assert torch.isfinite(m_card.per_example_loss).all()
    np.testing.assert_allclose(m_card.loss.item(), m_cpu.loss.item(), rtol=1e-5)
    np.testing.assert_allclose(m_card.grad_norm.item(), m_cpu.grad_norm.item(), rtol=1e-4)
    for name, want in g_cpu.items():
        np.testing.assert_allclose(g_card[name].numpy(), want.numpy(), rtol=0,
                                   atol=1e-4 * want.abs().max().item(), err_msg=name)


def test_serving_on_card_launches_k1_and_no_training_kernel(device, tmp_path):
    from stt_tpu_torch.alphabet import Alphabet
    from stt_tpu_torch.artifact import build_metadata, save_artifact
    from stt_tpu_torch.frontend import FeatureConfig
    from stt_tpu_torch.serve import Model

    config = ModelConfig(n_hidden=64, n_cell_dim=128, n_out=4)
    alphabet = Alphabet().init_from_labels(["a", "b", " "])
    path = save_artifact(str(tmp_path / "m"), DeepSpeech(config, generator=torch.Generator().manual_seed(0)),
                         build_metadata(config, FeatureConfig(), alphabet, beam_width=4), alphabet)
    model = Model(path)
    audio = np.random.RandomState(0).uniform(-0.3, 0.3, 16000).astype(np.float32)
    before = (lstm_recurrence.launches, lstm_train_fwd.launches, lstm_train_bwd.launches)
    model.stt(audio)
    model.infer_logits(np.zeros((2, 20, 26), np.float32), [20, 9])
    after = (lstm_recurrence.launches, lstm_train_fwd.launches, lstm_train_bwd.launches)
    assert after[0] > before[0] and after[1:] == before[1:]


# --- K2: the int8 recurrence ---------------------------------------------

K2_STEP_TOL = 1e-5
K2_SEQ_TOL = 2e-2


def q_case(seed, T, B, H, dtype, device):
    from stt_tpu_torch.ops.quant import _quantize_weight

    rs = np.random.RandomState(seed)
    limit = (6.0 / (6 * H)) ** 0.5
    w_h = torch.from_numpy(rs.uniform(-limit, limit, (H, 4 * H)).astype(np.float32))
    w_h_q, scale = _quantize_weight(w_h)
    x_proj = torch.from_numpy((rs.randn(T, B, 4 * H) * 0.5).astype(np.float32)).to(dtype)
    seq = rs.randint(1, T + 1, size=B).astype(np.int32)
    seq[0] = T
    c0 = torch.from_numpy((rs.randn(B, H) * 0.1).astype(np.float32))
    h0 = torch.from_numpy(rs.uniform(-0.9, 0.9, (B, H)).astype(np.float32))
    return tuple(t.to(device) for t in (
        x_proj, w_h_q.contiguous(), (scale / 127.0).reshape(1, -1), c0, h0, torch.from_numpy(seq)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H", [(1, 128), (3, 100), (8, 128), (17, 256)])
def test_lstm_q_kernel_one_step_matches_plain(device, dtype, B, H):
    from stt_tpu_torch.ops.lstm_kernel import lstm_recurrence_q
    from stt_tpu_torch.ops.quant import recurrence_q

    args = q_case(B + H, 1, B, H, dtype, device)
    before = lstm_recurrence_q.launches
    out, (c, h) = lstm_recurrence_q(*args)
    want, (c_ref, h_ref) = recurrence_q(*args)
    torch.cuda.synchronize()
    assert lstm_recurrence_q.launches == before + 1
    for got, ref in ((out, want), (c, c_ref), (h, h_ref)):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=K2_STEP_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H", [(1, 128), (3, 100), (8, 128), (17, 256)])
def test_lstm_q_kernel_sequence_matches_plain(device, dtype, B, H):
    from stt_tpu_torch.ops.lstm_kernel import lstm_recurrence_q, pack_w_h_q
    from stt_tpu_torch.ops.quant import recurrence_q

    args = q_case(B * 3 + H, 40, B, H, dtype, device)
    out, (c, h) = lstm_recurrence_q(*args, packed=pack_w_h_q(args[1]))
    want, (c_ref, h_ref) = recurrence_q(*args)
    torch.cuda.synchronize()
    flips = (torch.round(out * 127) != torch.round(want * 127)).float().mean().item()
    for got, ref in ((out, want), (c, c_ref), (h, h_ref)):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0,
                                   atol=K2_SEQ_TOL, err_msg=f"h_q differing: {flips:.2%}")
    for b, n in enumerate(args[5].tolist()):
        assert torch.all(out[n:, b] == 0)


def test_int8_matmul_is_exact_on_the_card(device):
    """K = 2048 with every operand at +-127: 33.0 M per sum, past float32's
    2^24; narrow and ragged shapes too."""
    from stt_tpu_torch.ops.quant import int8_matmul

    rs = np.random.RandomState(0)
    for m, k, n in ((16, 2048, 29), (1, 494, 2048), (60, 104, 64)):
        x = torch.from_numpy(rs.choice([-127, 127], (m, k)).astype(np.int8))
        w = torch.from_numpy(rs.choice([-127, 127], (k, n)).astype(np.int8))
        x[0], w[:, 0] = 127, 127
        got = int8_matmul(x.to(device), w.to(device))
        assert got.dtype == torch.int32 and got[0, 0].item() == k * 127 * 127
        assert torch.equal(got.cpu(), x.int() @ w.int())


def test_int8_model_on_card_launches_k2_and_matches_cpu(device, tmp_path):
    from stt_tpu_torch.alphabet import Alphabet
    from stt_tpu_torch.artifact import build_metadata, save_artifact
    from stt_tpu_torch.frontend import FeatureConfig
    from stt_tpu_torch.ops.lstm_kernel import lstm_recurrence_q
    from stt_tpu_torch.serve import Model

    config = ModelConfig(n_hidden=64, n_cell_dim=128, n_out=4)
    alphabet = Alphabet().init_from_labels(["a", "b", " "])
    path = save_artifact(str(tmp_path / "m"), DeepSpeech(config, generator=torch.Generator().manual_seed(0)),
                         build_metadata(config, FeatureConfig(), alphabet, beam_width=4), alphabet)
    card = Model(path, quantized_inference=True)
    cpu = Model(path, quantized_inference=True, device="cpu")
    rs = np.random.RandomState(3)
    feats = (rs.randn(2, 30, 26) * 3).astype(np.float32)
    before = (lstm_recurrence_q.launches, lstm_recurrence.launches)
    got = card.infer_logits(feats, [30, 17])
    assert (lstm_recurrence_q.launches, lstm_recurrence.launches) == (before[0] + 1, before[1])
    want = cpu.infer_logits(feats, [30, 17])
    # rounding-boundary flips of x_q and h_q between the two devices
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0, atol=5e-2)


# --- K5: the beam scan ------------------------------------------------------

BEAM_FIXTURES = [
    # B, T, C, W, cutoff_top_n, cutoff_prob, seed, peaky, blank_id, ignored
    (2, 12, 8, 8, 40, 1.0, 0, False, None, ()),
    (2, 24, 29, 16, 40, 1.0, 2, True, None, ()),
    (2, 16, 29, 24, 10, 0.9, 4, False, None, ()),
    (1, 16, 29, 16, 20, 1.0, 5, False, None, ()),
    (2, 16, 32, 16, 40, 1.0, 6, False, 0, (1, 2)),
    (3, 40, 29, 32, 40, 1.0, 7, True, None, ()),
    (2, 20, 29, 128, 40, 1.0, 8, False, None, ()),
    (1, 10, 127, 128, 40, 1.0, 9, True, None, ()),
    (2, 20, 5, 3, 40, 1.0, 10, False, None, ()),
    # beams above the TPU kernel's 128 slots: 512-slot state, int32 plane
    (2, 16, 29, 130, 40, 1.0, 11, True, None, ()),
    (2, 20, 29, 500, 40, 1.0, 12, False, None, ()),
    (1, 12, 31, 512, 40, 1.0, 13, True, None, ()),
    (1, 12, 63, 256, 20, 0.9, 14, False, None, ()),
]


def beam_probs(B, T, C, seed, peaky):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, T, C)).astype(np.float32)
    if peaky:
        logits = logits * 4.0
        logits[:, ::3, -1] += 6.0  # frequent strong blanks
    lens = np.full((B,), T, np.int32)
    lens[0] = max(1, T - 3)
    return torch.softmax(torch.from_numpy(logits), dim=-1), torch.from_numpy(lens)


@pytest.mark.parametrize("fixture", BEAM_FIXTURES)
def test_beam_kernel_matches_plain(device, fixture):
    from stt_tpu_torch.decode.device import beam_scan_plain, logaddexp
    from stt_tpu_torch.ops import beam_kernel

    B, T, C, W, top_n, cprob, seed, peaky, blank_id, ignored = fixture
    probs, lens = beam_probs(B, T, C, seed, peaky)
    probs, lens = probs.to(device), lens.to(device)
    before = beam_kernel.beam_scan.launches
    state, scores, packed = beam_kernel.beam_scan(probs, lens, W, top_n, cprob, blank_id, ignored)
    torch.cuda.synchronize()
    assert beam_kernel.beam_scan.launches == before + 1
    assert packed.dtype == (torch.int16 if W <= 128 else torch.int32)
    start = beam_kernel.init_state(B, device, beam_kernel.state_slots(W))
    plain, src, char = beam_scan_plain(
        beam_kernel.state_to_plain(start, W), probs, lens, W, top_n, cprob, blank_id, ignored)
    got_src, got_char = beam_kernel.unpack_bp(packed.cpu().numpy())
    np.testing.assert_array_equal(got_src, src.cpu().numpy())
    np.testing.assert_array_equal(got_char, char.cpu().numpy())
    want = logaddexp(plain[0], plain[1]).cpu().numpy()
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(scores.cpu().numpy()), finite)
    np.testing.assert_allclose(scores.cpu().numpy()[finite], want[finite], rtol=0, atol=1e-4)
    # the kernel's final state is the plain version's, slot for slot
    for got, ref in zip(beam_kernel.state_to_plain(state, W)[2:], plain[2:]):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("W", [32, 500])
def test_beam_kernel_chunks_and_handover(device, W):
    """Chunks of 16 with the state carried equal one launch; a state made by
    the plain version mid-stream continues in the kernel."""
    from stt_tpu_torch.decode.device import beam_scan_plain
    from stt_tpu_torch.ops import beam_kernel

    B, T, C = 2, 48, 29
    probs, _ = beam_probs(B, T, C, 11, True)
    probs = probs.to(device)
    lens = torch.tensor([T, T - 5], dtype=torch.int32, device=device)
    _, scores, packed = beam_kernel.beam_scan(probs, lens, W)
    state, parts = None, []
    for t0 in range(0, T, 16):
        state, chunk_scores, bp = beam_kernel.beam_scan(
            probs[:, t0:t0 + 16].contiguous(), (lens - t0).clamp(0, 16), W, state=state)
        parts.append(bp)
    assert torch.equal(torch.cat(parts, dim=1), packed)
    assert torch.equal(chunk_scores, scores)
    plain, src, char = beam_scan_plain(
        beam_kernel.state_to_plain(
            beam_kernel.init_state(B, device, beam_kernel.state_slots(W)), W),
        probs[:, :16].contiguous(), lens.clamp(max=16), W)
    _, scores2, bp2 = beam_kernel.beam_scan(
        probs[:, 16:].contiguous(), (lens - 16).clamp(min=0), W,
        state=beam_kernel.state_from_plain(plain))
    assert torch.equal(torch.cat([beam_kernel.pack_bp(src, char), bp2], dim=1), packed)
    np.testing.assert_allclose(scores2.cpu().numpy(), scores.cpu().numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("beam", [8, 500])
def test_device_decode_stream_on_card_launches_k5(device, tmp_path, beam):
    """A device-decode stream launches K5 once per chunk, at a narrow beam
    and at the serving default of 500, and never runs the plain scan."""
    from stt_tpu_torch.alphabet import Alphabet
    from stt_tpu_torch.artifact import build_metadata, save_artifact
    from stt_tpu_torch.decode import device as decode_device
    from stt_tpu_torch.frontend import FeatureConfig
    from stt_tpu_torch.ops import beam_kernel
    from stt_tpu_torch.serve import Model

    config = ModelConfig(n_hidden=64, n_cell_dim=128, n_out=4)
    alphabet = Alphabet().init_from_labels(["a", "b", " "])
    path = save_artifact(str(tmp_path / "m"), DeepSpeech(config, generator=torch.Generator().manual_seed(0)),
                         build_metadata(config, FeatureConfig(), alphabet, beam_width=beam), alphabet)
    model = Model(path)
    audio = np.random.RandomState(0).uniform(-0.3, 0.3, 24000).astype(np.float32)
    before = (beam_kernel.beam_scan.launches, decode_device.scan.plain_scans)
    stream = model.create_stream(device_decode=True)
    stream.feed_audio_content(audio)
    text = stream.finish_stream()
    _, probs = model.stt_with_emissions(audio)
    chunks = -(-probs.shape[0] // 16)
    assert beam_kernel.beam_scan.launches == before[0] + chunks
    assert decode_device.scan.plain_scans == before[1]
    # a host array goes to the card by default and launches the kernel too
    want = decode_device.ctc_beam_search_decoder_device(
        probs[None], [probs.shape[0]], alphabet, beam_size=beam)[0][0]
    assert beam_kernel.beam_scan.launches == before[0] + chunks + 1
    assert text == want.transcript


def test_shapes_beyond_the_beam_kernel_raise_on_the_card(device):
    """The plain scan never stands in for the kernel on CUDA tensors."""
    from stt_tpu_torch.alphabet import Alphabet
    from stt_tpu_torch.decode import device as decode_device

    probs = torch.softmax(torch.randn(1, 8, 5, generator=torch.Generator().manual_seed(0)), -1)
    alphabet = Alphabet().init_from_labels(["a", "b", "c", " "])
    before = decode_device.scan.plain_scans
    with pytest.raises(ValueError, match="on the card"):
        decode_device.ctc_beam_search_decoder_device(probs.to(device), [8], alphabet, beam_size=600)
    with pytest.raises(ValueError, match="on the card"):
        decode_device.device_beam_search(torch.full((1, 4, 256), 1 / 256, device=device), [4], 16)
    assert decode_device.scan.plain_scans == before
