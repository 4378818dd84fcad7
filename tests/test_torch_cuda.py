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
1e-4. The backtrace on K5's backpointers: paths equal to its plain
version's, bit for bit.
Gradients of `lstm_train` on the card against the CPU: in f32 1e-4 of each
gradient's largest value; in bf16 the gradients of x and W_x pass through
bf16 casts, so, as in tests/test_torch_lstm_train.py, by relative norm
(2e-3) and largest difference (2^-7 of the largest value).
"""

import ctypes
import os
import sys

import numpy as np
import pytest
import torch

from stt_tpu_torch.models import DeepSpeech, ModelConfig
from stt_tpu_torch.models.lstm import project_inputs, recurrence
from stt_tpu_torch.ops import lstm_recurrence, lstm_train, lstm_train_bwd, lstm_train_fwd
from stt_tpu_torch.ops.lstm_train import train_backward, train_forward

pytestmark = pytest.mark.cuda
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


def bwd_case(device, dtype, T, B, H, seed):
    """K4's inputs at full width: stashes from the plain forward, ragged
    lengths, non-zero final-state gradients."""
    params, x, seq, c0, h0 = lstm_case(seed, T=T, B=B, H=H, n_in=32)
    params = {k: v.to(device) for k, v in params.items()}
    x_proj, w_h = project_inputs(params, x.to(device), dtype)
    seq, c0, h0 = seq.to(device), c0.to(device), h0.to(device)
    _, cs, zs, _, _ = train_forward(x_proj, w_h, c0, h0, seq)
    gen = torch.Generator().manual_seed(seed)
    dout = (torch.randn(T, B, H, generator=gen) * 0.1).to(device)
    dc_T = (torch.randn(B, H, generator=gen) * 0.1).to(device)
    dh_T = (torch.randn(B, H, generator=gen) * 0.1).to(device)
    cs_prev = torch.cat([c0[None], cs[:-1]]).contiguous()
    return zs, cs, cs_prev, dout, w_h, seq, dc_T, dh_T


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B", [(1, 16), (2, 3), (50, 16), (50, 1), (50, 8), (50, 32)])
def test_lstm_train_bwd_kernel_at_full_width(device, dtype, T, B):
    """K4, one persistent launch, at H = 2048 against its plain version."""
    args = bwd_case(device, dtype, T, B, 2048, seed=T + B)
    before = lstm_train_bwd.launches
    got = lstm_train_bwd(*args)
    want = train_backward(*args)
    torch.cuda.synchronize()
    assert lstm_train_bwd.launches == before + 1
    for name, g, w in zip(("dz", "dc0", "dh0"), got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0,
                                   atol=TOL[dtype], err_msg=name)
    for b, n in enumerate(args[5].tolist()):
        assert torch.all(got[0][n:, b] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_train_bwd_calls_are_bit_equal(device, dtype):
    """The tiles' partials are summed in a fixed order: two calls, queued
    without a synchronise between them, give the same bits; so does the
    weights' packed copy handed in instead of packed per call."""
    from stt_tpu_torch.ops.lstm_kernel import pack_w_h

    args = bwd_case(device, dtype, 20, 16, 2048, seed=3)
    first = lstm_train_bwd(*args)
    second = lstm_train_bwd(*args)
    third = lstm_train_bwd(*args, packed=pack_w_h(args[4]))
    torch.cuda.synchronize()
    for other in (second, third):
        for a, b in zip(first, other):
            assert torch.equal(a, b)


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


def test_traced_train_step_on_card_marks_each_device_span(device):
    """A train step under a profiler session of the card's activity: each
    device span (`train.step`, `ctc.loss`, `ctc.loss.bwd`) puts a marker
    kernel on the stream at its entry and its exit, the trace holds all
    six, the step's come first and last, and the loss's and the
    recurrence's backward run on autograd's device thread under
    `train.backward`."""
    from torch.profiler import ProfilerActivity, profile

    from stt_tpu_torch import trace
    from stt_tpu_torch.train.step import Batch, create_train_state, make_train_step

    config = ModelConfig(n_hidden=64, n_cell_dim=128, n_out=29, dropout_rates=(0.0,) * 6)
    rs = np.random.RandomState(2)
    batch = Batch(torch.from_numpy((rs.randn(3, 40, 26) * 3).astype(np.float32)),
                  torch.tensor([40, 31, 22], dtype=torch.int32),
                  torch.from_numpy(rs.randint(0, 28, (3, 8)).astype(np.int32)),
                  torch.tensor([8, 5, 3], dtype=torch.int32)).to(device)
    state = create_train_state(config, seed=0, device=device)
    step = make_train_step()
    step(state, batch, 1)
    torch.cuda.synchronize()
    trace.reset()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(state, batch, 1)
            torch.cuda.synchronize()
        markers = [e for e in prof.profiler.kineto_results.events() if trace.MARKER in e.name()]
        spans = trace.spans()
    finally:
        trace.reset()
    marked = {s.name: s for s in spans if s.marks}
    assert set(marked) == {"train.step", "ctc.loss", "ctc.loss.bwd"}
    numbers = sorted(n for s in marked.values() for n, _, _ in s.marks)
    assert len(markers) == len(numbers) == 6
    step_span = marked["train.step"]
    assert (step_span.marks[0][0], step_span.marks[1][0]) == (numbers[0], numbers[-1])
    assert marked["ctc.loss"].marks[1][0] < marked["ctc.loss.bwd"].marks[0][0]
    [lstm_bwd] = [s for s in spans if s.name == "lstm.bwd"]
    for s in (lstm_bwd, marked["ctc.loss.bwd"]):
        assert s.tid != step_span.tid and s.parent.name == "train.backward"


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


# the serving width at every batch row group, and widths that are no
# multiple of the tile or of the 256 k of an int8 chunk
K2_SHAPES = [(1, 2048), (8, 2048), (16, 2048), (32, 2048), (3, 100), (5, 2050)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 200])
@pytest.mark.parametrize("B,H", K2_SHAPES)
def test_lstm_q_kernel_at_full_width_and_edges(device, dtype, T, B, H):
    """K2 against `recurrence_q` with ragged lengths and a non-zero start:
    one step within K2_STEP_TOL, 200 within K2_SEQ_TOL."""
    from stt_tpu_torch.ops.lstm_kernel import lstm_recurrence_q, pack_w_h_q
    from stt_tpu_torch.ops.quant import recurrence_q

    args = q_case(T + B + H, T, B, H, dtype, device)
    packed = pack_w_h_q(args[1])
    before = lstm_recurrence_q.launches
    out, (c, h) = lstm_recurrence_q(*args, packed=packed)
    want, (c_ref, h_ref) = recurrence_q(*args)
    torch.cuda.synchronize()
    assert lstm_recurrence_q.launches == before + 1
    tol = K2_STEP_TOL if T == 1 else K2_SEQ_TOL
    flips = (torch.round(out * 127) != torch.round(want * 127)).float().mean().item()
    for got, ref in ((out, want), (c, c_ref), (h, h_ref)):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=tol,
                                   err_msg=f"h_q differing: {flips:.2%}")
    for b, n in enumerate(args[5].tolist()):
        assert torch.all(out[n:, b] == 0)


def test_lstm_q_kernel_is_one_kernel_per_call(device):
    """All T steps of K2 run in one kernel on the card, at the dp4a shape
    (B = 1) and on the tensor cores (B = 16)."""
    from torch.profiler import ProfilerActivity, profile

    from stt_tpu_torch.ops.lstm_kernel import lstm_recurrence_q

    for B in (1, 16):
        args = q_case(B, 30, B, 256, torch.float32, device)
        lstm_recurrence_q(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            lstm_recurrence_q(*args)
            lstm_recurrence_q(*args)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages() if "recurrence_kernel" in e.key]
        counts = sum(e.count for e in prof.key_averages() if "recurrence_kernel" in e.key)
        assert counts == 2 and all("signed char" in n for n in names), (B, names, counts)


def test_lstm_q_kernel_calls_are_bit_equal(device):
    """Two calls queued without a synchronise, and a third after one: the
    barrier's counter starts anew and the int32 sums are exact, so the bits
    are the same."""
    from stt_tpu_torch.ops.lstm_kernel import lstm_recurrence_q

    for dtype, B in ((torch.float32, 1), (torch.bfloat16, 16)):
        args = q_case(7, 50, B, 2048, dtype, device)
        first = lstm_recurrence_q(*args)
        second = lstm_recurrence_q(*args)
        torch.cuda.synchronize()
        third = lstm_recurrence_q(*args)
        torch.cuda.synchronize()
        for other in (second, third):
            assert torch.equal(first[0], other[0])
            assert torch.equal(first[1][0], other[1][0]) and torch.equal(first[1][1], other[1][1])


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
    # the serving default on flat emissions: the beam fills, then ~14,000 of
    # the 15,000 pool keys stay live every frame and the radix select decides
    (3, 40, 29, 500, 40, 1.0, 15, False, None, ()),
    # the wide instance: byte alphabets and other pools past 16,384 keys,
    # the pool in device memory
    (1, 16, 256, 32, 40, 1.0, 16, True, None, ()),
    (2, 20, 200, 128, 40, 1.0, 17, False, None, ()),
    (2, 24, 256, 500, 40, 1.0, 18, False, None, ()),
    (1, 16, 256, 512, 40, 1.0, 19, True, None, ()),
    (2, 16, 256, 64, 10, 0.9, 20, False, None, ()),
    (2, 16, 200, 130, 40, 1.0, 21, False, 0, (1, 2)),
    (2, 12, 64, 256, 40, 1.0, 22, True, None, ()),
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


def test_beam_kernel_wide_chunks_and_handover(device):
    """The wide instance (beam 500 over 256 classes): chunks of 16 with the
    state carried equal one launch, and a state made by the plain version
    mid-stream continues in the kernel."""
    from stt_tpu_torch.decode.device import beam_scan_plain
    from stt_tpu_torch.ops import beam_kernel

    B, T, C, W = 2, 40, 256, 500
    probs, _ = beam_probs(B, T, C, 23, False)
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
        beam_kernel.state_to_plain(beam_kernel.init_state(B, device, beam_kernel.WIDE_SLOTS), W),
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
    before = beam_kernel.beam_scan.launches
    stream = model.create_stream(device_decode=True)
    stream.feed_audio_content(audio)
    text = stream.finish_stream()
    _, probs = model.stt_with_emissions(audio)
    chunks = -(-probs.shape[0] // 16)
    assert beam_kernel.beam_scan.launches == before + chunks
    # a host array goes to the card by default and launches the kernel too
    want = decode_device.ctc_beam_search_decoder_device(
        probs[None], [probs.shape[0]], alphabet, beam_size=beam)[0][0]
    assert beam_kernel.beam_scan.launches == before + chunks + 1
    assert text == want.transcript


def test_shapes_beyond_the_beam_kernel_raise_on_the_card(device):
    """Shapes past the wide instance (beam 600, 257 classes, 256 classes
    with the blank first) no longer raise on the card: they launch K5's huge
    instance, and the decoded results are the plain scan's on the same CUDA
    tensors."""
    from stt_tpu_torch.alphabet import Alphabet
    from stt_tpu_torch.decode import device as decode_device
    from stt_tpu_torch.ops import beam_kernel

    for W, C, blank_id in ((600, 5, None), (16, 257, None), (16, 256, 0)):
        probs, lens = beam_probs(2, 8, C, W + C, True)
        probs, lens = probs.to(device), lens.to(device)
        labels = [chr(0x4E00 + i) for i in range(C - 1)]
        alphabet = Alphabet().init_from_labels(["-"] + labels if blank_id == 0 else labels)
        before = beam_kernel.beam_scan.launches
        got = decode_device.ctc_beam_search_decoder_device(
            probs, lens.tolist(), alphabet, beam_size=W, num_results=2, blank_id=blank_id)
        assert beam_kernel.beam_scan.launches == before + 1
        assert beam_kernel.instance(W, C, blank_id) == "huge"
        st, src, char = decode_device.beam_scan_plain(
            decode_device.init_beam_state(2, W, device), probs, lens, W, 40, 1.0, blank_id)
        scores = decode_device.logaddexp(st[0], st[1]).cpu().numpy()
        for i in range(2):
            want = decode_device.rebuild_results(scores[i], src[i].cpu().numpy(),
                                                 char[i].cpu().numpy(), alphabet, 2)
            assert [(r.tokens, r.timesteps) for r in got[i]] == \
                [(r.tokens, r.timesteps) for r in want]


HUGE_FIXTURES = [
    # B, T, C, W, cutoff_top_n, cutoff_prob, seed, peaky, blank_id, ignored
    (1, 12, 29, 1024, 40, 1.0, 30, True, None, ()),  # a beam past 512; top_n above C
    (2, 16, 1000, 500, 40, 1.0, 31, False, None, ()),
    (1, 12, 4096, 500, 40, 1.0, 32, True, None, ()),  # strike-out bits in the workspace
    (2, 16, 4096, 500, 10, 0.9, 33, False, None, ()),
    (2, 16, 256, 128, 40, 1.0, 34, False, 0, ()),  # 256 classes, the blank first
    (2, 16, 300, 64, 400, 1.0, 35, True, None, ()),  # cutoff_top_n above C
    (2, 16, 300, 64, 10, 0.9, 36, False, 0, (1, 2)),
    (1, 10, 8, 2048, 40, 1.0, 37, False, None, ()),  # per-slot arrays in the workspace
    (2, 20, 5, 600, 40, 1.0, 38, True, None, ()),
]


@pytest.mark.parametrize("fixture", HUGE_FIXTURES)
def test_beam_kernel_huge_instance_matches_plain(device, fixture):
    """K5's huge instance: the (bp_src, bp_char) planes equal the plain
    version's bit for bit, scores to 1e-4, the final state slot for slot."""
    from stt_tpu_torch.decode.device import beam_scan_plain, logaddexp
    from stt_tpu_torch.ops import beam_kernel

    B, T, C, W, top_n, cprob, seed, peaky, blank_id, ignored = fixture
    probs, lens = beam_probs(B, T, C, seed, peaky)
    probs, lens = probs.to(device), lens.to(device)
    assert beam_kernel.instance(W, C, blank_id) == "huge"
    before = beam_kernel.beam_scan.launches
    state, scores, bp = beam_kernel.beam_scan(probs, lens, W, top_n, cprob, blank_id, ignored)
    torch.cuda.synchronize()
    assert beam_kernel.beam_scan.launches == before + 1
    start = beam_kernel.init_state(B, device, beam_kernel.state_slots(W))
    plain, src, char = beam_scan_plain(
        beam_kernel.state_to_plain(start, W), probs, lens, W, top_n, cprob, blank_id, ignored)
    assert torch.equal(bp[0], src) and torch.equal(bp[1], char)
    want = logaddexp(plain[0], plain[1]).cpu().numpy()
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(scores.cpu().numpy()), finite)
    np.testing.assert_allclose(scores.cpu().numpy()[finite], want[finite], rtol=0, atol=1e-4)
    for got, ref in zip(beam_kernel.state_to_plain(state, W)[2:], plain[2:]):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("W,C", [(1024, 29), (500, 4096)])
def test_beam_kernel_huge_chunks_and_handover(device, W, C):
    """The huge instance: chunks of 16 with the state carried equal one
    launch, and a state made by the plain version continues in the kernel."""
    from stt_tpu_torch.decode.device import beam_scan_plain
    from stt_tpu_torch.ops import beam_kernel

    B, T = 2, 40
    probs, _ = beam_probs(B, T, C, 39, True)
    probs = probs.to(device)
    lens = torch.tensor([T, T - 5], dtype=torch.int32, device=device)
    _, scores, (src, char) = beam_kernel.beam_scan(probs, lens, W)
    state, parts = None, []
    for t0 in range(0, T, 16):
        state, chunk_scores, bp = beam_kernel.beam_scan(
            probs[:, t0:t0 + 16].contiguous(), (lens - t0).clamp(0, 16), W, state=state)
        parts.append(bp)
    assert torch.equal(torch.cat([p[0] for p in parts], dim=1), src)
    assert torch.equal(torch.cat([p[1] for p in parts], dim=1), char)
    assert torch.equal(chunk_scores, scores)
    plain, p_src, p_char = beam_scan_plain(
        beam_kernel.state_to_plain(beam_kernel.init_state(B, device, beam_kernel.state_slots(W)), W),
        probs[:, :16].contiguous(), lens.clamp(max=16), W)
    _, scores2, (k_src, k_char) = beam_kernel.beam_scan(
        probs[:, 16:].contiguous(), (lens - 16).clamp(min=0), W,
        state=beam_kernel.state_from_plain(plain))
    assert torch.equal(torch.cat([p_src, k_src], dim=1), src)
    assert torch.equal(torch.cat([p_char, k_char], dim=1), char)
    np.testing.assert_allclose(scores2.cpu().numpy(), scores.cpu().numpy(), rtol=0, atol=1e-4)


# the batch cells' shapes: K5's narrow (29 classes) and wide (256) instances
# at beam 500, and the huge instance's (bp_src, bp_char) pair at beam 600
BACKTRACK_SHAPES = [(128, 750, 500, 29), (128, 750, 500, 256), (128, 750, 600, 5)]


@pytest.mark.parametrize("B,T,W,C", BACKTRACK_SHAPES)
def test_backtrack_kernel_matches_plain_on_k5_output(device, B, T, W, C):
    """The backtrace kernel on K5's own backpointers, in the form K5 wrote
    them, equals its plain version on the same tensors, for one and three
    results, with rows shorter than T; launching it leaves K5's count
    alone; the paths give the results `rebuild_results` builds on the host
    from the copied plane."""
    from stt_tpu_torch.alphabet import Alphabet
    from stt_tpu_torch.decode import device as decode_device
    from stt_tpu_torch.ops import beam_kernel

    probs, lens = beam_probs(B, T, C, B + T + W + C, True)
    lens[1:] = torch.from_numpy(np.random.default_rng(C).integers(0, T + 1, B - 1).astype(np.int32))
    probs, lens = probs.to(device), lens.to(device)
    _, scores, bp = beam_kernel.beam_scan(probs, lens, W)
    assert isinstance(bp, tuple) == (W > 512)
    scans = beam_kernel.beam_scan.launches
    paths = {}
    for R in (1, 3):
        before = beam_kernel.beam_backtrack.launches
        paths[R] = beam_kernel.beam_backtrack(scores, bp, R)
        torch.cuda.synchronize()
        assert beam_kernel.beam_backtrack.launches == before + 1
        want = decode_device.backtrack_plain(scores, bp, R)
        assert torch.equal(paths[R], want), (paths[R] != want).nonzero()[:5]
    assert beam_kernel.beam_scan.launches == scans
    alphabet = Alphabet().init_from_labels([chr(0x4E00 + i) for i in range(C - 1)])
    src, char = beam_kernel.unpack_bp(
        tuple(p.cpu() for p in bp) if isinstance(bp, tuple) else bp.cpu().numpy())
    host_scores = scores.cpu().numpy()
    got = decode_device.paths_to_results(paths[3].cpu().numpy(), alphabet)
    for i in range(B):
        assert got[i] == decode_device.rebuild_results(host_scores[i], src[i], char[i], alphabet, 3)


def test_batch_device_decode_walks_on_the_card(device):
    """`evaluate`'s batch device decode launches K5 and the backtrace once a
    batch, copies to the host no more than the paths, B x R x (2 T + 4) x 4
    bytes (`decode.d2h_bytes` on its `decode.batch` span), and returns what
    `rebuild_results` builds from the whole plane."""
    from torch.profiler import ProfilerActivity, profile

    from stt_tpu_torch import trace
    from stt_tpu_torch.alphabet import Alphabet
    from stt_tpu_torch.config import SttConfig
    from stt_tpu_torch.decode import device as decode_device
    from stt_tpu_torch.evaluate import decode_batch
    from stt_tpu_torch.ops import beam_kernel

    labels = list(" abcdefghijklmnopqrstuvwxyz'")
    alphabet = Alphabet().init_from_labels(labels)
    config = SttConfig(device_decode="full", export_beam_width=500, test_batch_size=16,
                       alphabet=alphabet)
    B, T, C = 16, 300, len(labels) + 1
    batches = []
    for k in range(2):
        probs, lens = beam_probs(B, T, C, 40 + k, True)
        batches.append((probs.to(device), lens.tolist()))
    before = (beam_kernel.beam_scan.launches, beam_kernel.beam_backtrack.launches)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = [decode_batch(config, probs, lens, alphabet) for probs, lens in batches]
    copied = [s.counters["decode.d2h_bytes"] for s in trace.spans() if s.name == "decode.batch"]
    trace.reset()
    assert (beam_kernel.beam_scan.launches, beam_kernel.beam_backtrack.launches) == (
        before[0] + 2, before[1] + 2)
    assert len(copied) == 2 and all(n <= B * 1 * (2 * T + 4) * 4 for n in copied)
    for (probs, lens), results in zip(batches, got):
        scores, src, char = decode_device.device_beam_search(probs, lens, 500)
        assert results == [decode_device.rebuild_results(scores[i], src[i], char[i], alphabet, 1)
                           for i in range(B)]


def test_pool_on_card_with_device_decode_slots(device, tmp_path):
    """A StreamPool of 8 device-decode slots on the card: one K1 launch a
    round at B = 8, K5 once a round for each emitting slot, and every pooled
    transcript the single stream's."""
    from stt_tpu_torch.alphabet import Alphabet
    from stt_tpu_torch.artifact import build_metadata, save_artifact
    from stt_tpu_torch.frontend import FeatureConfig
    from stt_tpu_torch.ops import beam_kernel
    from stt_tpu_torch.ops.lstm_kernel import lstm_recurrence
    from stt_tpu_torch.serve import Model, StreamPool

    config = ModelConfig(n_hidden=64, n_cell_dim=128, n_out=4)
    alphabet = Alphabet().init_from_labels(["a", "b", " "])
    model = DeepSpeech(config, generator=torch.Generator().manual_seed(1))
    path = save_artifact(str(tmp_path / "m"), model,
                         build_metadata(config, FeatureConfig(), alphabet, beam_width=16), alphabet)
    gpu = Model(path)
    rs = np.random.RandomState(2)
    audios = [rs.uniform(-0.3, 0.3, int(rs.uniform(1.0, 2.0) * 16000)).astype(np.float32)
              for _ in range(8)]
    pool = StreamPool(gpu, max_streams=8, device_decode=True)
    streams = [pool.create_stream() for _ in range(8)]
    chunk, step = pool._chunk_samples, 16 * 320
    for s, a in zip(streams, audios):
        s.feed_audio_content(a[:chunk])  # the priming round
    k1, k5 = lstm_recurrence.launches, beam_kernel.beam_scan.launches
    for s, a in zip(streams, audios):
        s.feed_audio_content(a[chunk:chunk + step])  # one emitting round
    assert lstm_recurrence.launches == k1 + 1
    assert beam_kernel.beam_scan.launches == k5 + 8
    pooled = [s.finish_stream() for s in streams]
    for a, got in zip(audios, pooled):
        single = gpu.create_stream(device_decode=True)
        single.feed_audio_content(a[:chunk + step])  # what the pooled stream was fed
        assert got == single.finish_stream()


def test_device_augment_on_card_matches_cpu(device):
    """The device pass on CUDA tensors against CPU tensors on the same drawn
    parameters: lengths equal, features within 2e-3 (the MFCC's float32
    products summed in another order); the random family repeats per seed
    on the card, with its moments."""
    from stt_tpu_torch.data import augmentations as augs
    from stt_tpu_torch.data.device_augment import DeviceAugmentPipeline
    from stt_tpu_torch.frontend import FeatureConfig

    fc = FeatureConfig()
    chain = [augs.Pitch(p=1.0, pitch="0.9:1.1"), augs.Tempo(p=1.0, factor="0.8:1.2"),
             augs.Warp(p=1.0, num_t=2, num_f=2, warp_t=0.2, warp_f=0.1),
             augs.FrequencyMask(p=1.0, n=2, size=4), augs.TimeMask(p=1.0, n=2, size=40.0),
             augs.TimeMask(p=1.0, domain="features", n=1, size=30.0)]
    pipeline = DeviceAugmentPipeline(chain, fc)
    rs = np.random.RandomState(4)
    lens = [180, 97, 150, 64]
    batch = np.zeros((4, 192, fc.n_bins), np.float32)
    for i, n in enumerate(lens):
        batch[i, :n] = np.abs(rs.randn(n, fc.n_bins)) * 10
    params = pipeline.draw([f"u{i}" for i in range(4)], lens, [0.3] * 4)
    x, n = torch.from_numpy(batch), torch.tensor(lens)
    got, got_lens = pipeline.apply(x.to(device), n.to(device), params)
    want, want_lens = pipeline.apply(x, n, params)
    assert torch.equal(got_lens.cpu(), want_lens)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-3, atol=2e-3)
    noise = DeviceAugmentPipeline([augs.Add(p=1.0, domain="features", stddev=2.0),
                                   augs.Dropout(p=1.0, domain="features", rate=0.2)], fc)
    drawn = noise.draw(["a", "b", "c", "d"], lens, [0.1] * 4)
    first, _ = noise.apply(x.to(device), n.to(device), drawn)
    again, _ = noise.apply(x.to(device), n.to(device), drawn)
    assert torch.equal(first, again)
    zeros = (first[0, :lens[0]] == 0).float().mean().item()
    assert 0.12 < zeros < 0.28


def test_one_rank_nccl_step_equals_the_step_without_a_group(device):
    """A group of one rank on NCCL: its train step runs the all-reduces on
    the card, and its loss is the step's without a group."""
    import socket

    import torch.distributed as dist

    from stt_tpu_torch.parallel import distributed
    from stt_tpu_torch.train import Batch, create_train_state, make_train_step

    config = ModelConfig(n_hidden=64, n_cell_dim=128, n_out=6, dropout_rates=(0.0,) * 6)
    rs = np.random.RandomState(0)
    batch = Batch(torch.from_numpy(rs.randn(4, 30, 26).astype(np.float32)),
                  torch.tensor([30, 25, 20, 12], dtype=torch.int32),
                  torch.from_numpy(rs.randint(0, 5, (4, 6)).astype(np.int32)),
                  torch.tensor([6, 5, 4, 3], dtype=torch.int32)).to(device)
    losses = []
    for grouped in (False, True):
        if grouped:
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            assert distributed.initialize(f"localhost:{port}", 1, 0, backend="nccl") == (0, 1)
            assert dist.get_backend() == "nccl"
        try:
            state = create_train_state(config, seed=3, device=device)
            _, metrics = make_train_step()(state, batch, 0)
            losses.append(metrics.loss.item())
        finally:
            if grouped:
                dist.destroy_process_group()
    assert losses[0] == losses[1]


@pytest.mark.parametrize("K,m", [(2, 0), (2, 1), (4, 3)])
def test_tp_rank_recurrence_on_card_matches_plain(device, K, m):
    """What one model rank of `parallel.tp.apply_model_tp` runs: K3 and K4
    at its B/K rows of the all_to_all'd gate projection [T, B/K, 4H],
    against the W_h gathered that step, forward and backward against the
    plain versions on the CPU. The next step's W_h differs, and the kernels
    must use it (the packed copy is made anew at every forward)."""
    from stt_tpu_torch.ops.lstm_train import _Recurrence

    B, H, T = 16, 256, 30
    rows = B // K
    for step in range(2):
        params, x, seq, _, _ = lstm_case(100 + step, T, B, H, n_in=H)
        x_proj, _ = project_inputs(params, x, torch.float32)
        x_proj = x_proj[:, m * rows:(m + 1) * rows].contiguous()
        w_h = params["kernel"][H:].contiguous()
        seq_m = seq[m * rows:(m + 1) * rows].contiguous()
        results = []
        for dev in (torch.device("cpu"), device):
            xp = x_proj.detach().to(dev).requires_grad_()
            wh = w_h.detach().to(dev).requires_grad_()
            c0 = torch.zeros(rows, H, device=dev)
            fwd, bwd = lstm_train_fwd.launches, lstm_train_bwd.launches
            hs, c, h = _Recurrence.apply(xp, wh, c0, c0.clone(), seq_m.to(dev), torch.float32)
            (hs.square().sum() + c.sum() + 0.5 * h.sum()).backward()
            torch.cuda.synchronize()
            launched = (lstm_train_fwd.launches - fwd, lstm_train_bwd.launches - bwd)
            assert launched == ((1, 1) if dev.type == "cuda" else (0, 0))
            results.append([t.detach().cpu().numpy() for t in (hs, c, h, xp.grad, wh.grad)])
        for got, want in zip(results[1][:3], results[0][:3]):
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL[torch.float32])
        for got, want in zip(results[1][3:], results[0][3:]):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


# --- the native decoder with a scorer, behind the card's model ------------

LM_WORDS = "the of and to in is was he for it with water dark suit greasy wash year all".split()


def test_stream_with_scorer_on_card_matches_cpu(device, tmp_path):
    """A Stream on the card, decoded on the host by the native decoder with
    a scorer (built here by the port's own tools) and hot words, gives the
    transcript the same Stream gives with device="cpu"."""
    from stt_tpu_torch.alphabet import Alphabet
    from stt_tpu_torch.artifact import build_metadata, save_artifact
    from stt_tpu_torch.decode.native import NativeDecoderState
    from stt_tpu_torch.frontend import FeatureConfig
    from stt_tpu_torch.lm.arpa import estimate_kneser_ney, write_arpa
    from stt_tpu_torch.serve import Model
    from stt_tpu_torch.tools.generate_scorer_package import create_package

    labels = list(" abcdefghijklmnopqrstuvwxyz'")
    rs = np.random.RandomState(0)
    sentences = [list(rs.choice(LM_WORDS, size=rs.randint(3, 9))) for _ in range(300)]
    (tmp_path / "alphabet.txt").write_text("".join(f"{c}\n" for c in labels))
    (tmp_path / "vocab.txt").write_text("\n".join(sorted(set(LM_WORDS))) + "\n")
    write_arpa(estimate_kneser_ney(sentences), str(tmp_path / "lm.arpa"))
    scorer = create_package(str(tmp_path / "alphabet.txt"), str(tmp_path / "lm.arpa"),
                            str(tmp_path / "vocab.txt"), str(tmp_path / "lm.scorer"), 0.93, 1.18)
    config = ModelConfig(n_hidden=64, n_cell_dim=128, n_out=len(labels) + 1)
    net = DeepSpeech(config, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # peaky emissions: card and CPU cannot tip a near-tie
        net.param("layer_6/w").mul_(20.0)
        net.param("layer_6/b").copy_(torch.from_numpy(rs.randn(len(labels) + 1) * 3))
        net.param("layer_6/b")[-1] = -2.0  # and not all blank
    alphabet = Alphabet().init_from_labels(labels)
    path = save_artifact(str(tmp_path / "m"), net,
                         build_metadata(config, FeatureConfig(), alphabet, beam_width=32), alphabet)
    audio = np.random.RandomState(1).uniform(-0.3, 0.3, 40000).astype(np.float32)
    texts = {}
    for where in ("cuda", "cpu"):
        model = Model(path, device=where)
        model.enable_external_scorer(scorer)
        model.add_hot_word("water", 3.0)
        stream = model.create_stream()
        assert isinstance(stream._state.decoder, NativeDecoderState)
        for start in range(0, len(audio), 5120):
            stream.feed_audio_content(audio[start:start + 5120])
        texts[where] = stream.finish_stream_with_metadata(2)
    got, want = texts["cuda"], texts["cpu"]
    assert [c.transcript for c in got.transcripts] == [c.transcript for c in want.transcripts]
    assert got.transcripts[0].transcript
    assert set(got.transcripts[0].transcript.split()) <= set(LM_WORDS)


# --- evaluate, the chunked prune and transcribe on the card ---------------

M9_LABELS = list(" abcdefghijklmnopqrstuvwxyz'")


def m9_setup(tmp_path, n_out=len(M9_LABELS) + 1, bytes_mode=False):
    """A tiny model with peaky emissions (so that card and CPU cannot tip a
    near-tie), saved as an artifact, an alphabet file and a test CSV of
    four seeded utterances."""
    from stt_tpu_torch.alphabet import Alphabet, UTF8Alphabet
    from stt_tpu_torch.artifact import build_metadata, save_artifact
    from stt_tpu_torch.data.sources import CSVWriter, Sample
    from stt_tpu_torch.frontend import FeatureConfig

    rs = np.random.RandomState(0)
    config = ModelConfig(n_hidden=64, n_cell_dim=64, n_out=n_out)
    net = DeepSpeech(config, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        net.param("layer_6/w").mul_(20.0)
        net.param("layer_6/b").copy_(torch.from_numpy(rs.randn(n_out) * 3))
        net.param("layer_6/b")[-1] = -2.0
    (tmp_path / "alphabet.txt").write_text("".join(f"{c}\n" for c in M9_LABELS))
    alphabet = UTF8Alphabet() if bytes_mode else Alphabet(str(tmp_path / "alphabet.txt"))
    path = save_artifact(str(tmp_path / "m"), net,
                         build_metadata(config, FeatureConfig(), alphabet, beam_width=32), alphabet)
    csv = str(tmp_path / "test.csv")
    with CSVWriter(csv) as writer:
        for i in range(4):
            audio = rs.uniform(-0.3, 0.3, int(rs.uniform(0.8, 2.0) * 16000)).astype(np.float32)
            writer.add(Sample(f"u{i}", "".join(rs.choice(M9_LABELS[1:], 6)), _audio=audio,
                              _rate=16000))
    return net, path, str(tmp_path / "alphabet.txt"), csv


def kernel_launches():
    from stt_tpu_torch.ops import beam_kernel
    from stt_tpu_torch.ops.lstm_kernel import lstm_recurrence_q

    return {"k1": lstm_recurrence.launches, "k2": lstm_recurrence_q.launches,
            "k3": lstm_train_fwd.launches, "k4": lstm_train_bwd.launches,
            "k5": beam_kernel.beam_scan.launches}


@pytest.mark.parametrize("mode", ["off", "prune", "full"])
def test_evaluate_on_card_matches_cpu(device, tmp_path, mode):
    """evaluate on the card: K1 in the eval step, K5 in full mode only, no
    training kernel; transcripts and WER those of the CPU, losses within
    1e-4 relative (card and CPU sum in other orders)."""
    import copy

    from stt_tpu_torch.config import SttConfig
    from stt_tpu_torch.evaluate import evaluate

    net, _, alphabet, csv = m9_setup(tmp_path)
    config = SttConfig(test_files=[csv], alphabet_config_path=alphabet, n_hidden=64,
                       test_batch_size=2, export_beam_width=32, device_decode=mode)
    before = kernel_launches()
    [got] = evaluate(config, model=copy.deepcopy(net))
    launches = {k: v - before[k] for k, v in kernel_launches().items()}
    assert launches["k1"] >= 2 and launches["k2"] == launches["k3"] == launches["k4"] == 0
    assert (launches["k5"] > 0) == (mode == "full")
    [want] = evaluate(config, model=net, device="cpu")
    assert [(r.res, r.wer, r.cer) for r in got] == [(r.res, r.wer, r.cer) for r in want]
    assert any(r.res for r in got)
    np.testing.assert_allclose([r.loss for r in got], [r.loss for r in want], rtol=1e-4)


def test_evaluate_full_in_bytes_mode_on_card_matches_cpu(device, tmp_path):
    """Bytes mode (256 classes) at beam 500 runs in K5's wide instance on the
    card: transcripts and WER those of the CPU, whose plain scan
    tests/test_torch_evaluate.py holds against stt_tpu."""
    import copy

    from stt_tpu_torch.config import SttConfig
    from stt_tpu_torch.evaluate import evaluate

    net, _, _, csv = m9_setup(tmp_path, n_out=256, bytes_mode=True)
    config = SttConfig(test_files=[csv], bytes_output_mode=True, n_hidden=64,
                       test_batch_size=2, export_beam_width=500, device_decode="full")
    before = kernel_launches()
    [got] = evaluate(config, model=copy.deepcopy(net))
    assert kernel_launches()["k5"] > before["k5"]
    [want] = evaluate(config, model=net, device="cpu")
    assert [(r.res, r.wer, r.cer) for r in got] == [(r.res, r.wer, r.cer) for r in want]
    assert any(r.res for r in got)


@pytest.mark.parametrize("cutoff_top_n,cutoff_prob", [(8, 0.99), (5, 1.0), (40, 1.0)])
def test_batch_pruned_decoder_on_card_matches_host(device, cutoff_top_n, cutoff_prob):
    """The chunked path (pruned on the card in 128-frame planes, copied into
    pinned memory without blocking) and the bulk fetch (cutoff_top_n + 2 >=
    C) give the host path's candidates; confidences within 1e-6 relative
    (the card's float32 log against numpy's)."""
    from stt_tpu_torch.alphabet import Alphabet
    from stt_tpu_torch.decode.device import ctc_beam_search_decoder_batch_pruned

    rs = np.random.RandomState(cutoff_top_n)
    logits = rs.randn(3, 300, len(M9_LABELS) + 1).astype(np.float32) * 3.0
    probs = torch.softmax(torch.from_numpy(logits), -1).numpy()
    alphabet = Alphabet().init_from_labels(M9_LABELS)
    args = dict(beam_size=16, num_processes=3, cutoff_top_n=cutoff_top_n,
                cutoff_prob=cutoff_prob, num_results=2)
    lengths = [300, 200, 129]
    got = ctc_beam_search_decoder_batch_pruned(torch.from_numpy(probs).to(device), lengths,
                                               alphabet, **args)
    want = ctc_beam_search_decoder_batch_pruned(probs, lengths, alphabet, **args)
    key = lambda rs: [[(r.transcript, list(r.tokens), list(r.timesteps)) for r in x] for x in rs]
    assert key(got) == key(want)
    np.testing.assert_allclose([[r.confidence for r in x] for x in got],
                               [[r.confidence for r in x] for x in want], rtol=1e-6)


@pytest.mark.parametrize("quantized", [False, True])
def test_transcribe_on_card_matches_cpu(device, tmp_path, quantized):
    """transcribe_file on the card: K1 (float) or K2 (int8), no training
    kernel; the CPU's segments."""
    from stt_tpu_torch.data import write_wav
    from stt_tpu_torch.serve import Model
    from stt_tpu_torch.transcribe import transcribe_file

    _, path, _, _ = m9_setup(tmp_path)
    rs = np.random.RandomState(3)
    audio = rs.randn(6 * 16000).astype(np.float32) * 2e-3
    for i0, i1 in ((4800, 22400), (32000, 49600), (64000, 88000)):
        audio[i0:i1] += rs.uniform(-0.3, 0.3, i1 - i0).astype(np.float32)
    wav = str(tmp_path / "long.wav")
    write_wav(wav, audio)
    before = kernel_launches()
    got = transcribe_file(Model(path, quantized_inference=quantized), wav, batch_size=2,
                          beam_width=32)
    launches = {k: v - before[k] for k, v in kernel_launches().items()}
    assert launches["k2" if quantized else "k1"] > 0
    assert launches["k1" if quantized else "k2"] == launches["k3"] == launches["k4"] == 0
    want = transcribe_file(Model(path, quantized_inference=quantized, device="cpu"), wav,
                           batch_size=2, beam_width=32)
    assert len(got) >= 2
    if quantized:  # int8 on the card vs the CPU: h_q may differ by one step
        assert [(s["start"], s["end"]) for s in got] == [(s["start"], s["end"]) for s in want]
    else:
        assert got == want


# --- the C API and the imported reference .tflite on the card -------------

CAPI_HOT_WORDS = {"water": 2.0, "the": -0.5, "year": 1.0}


def capi_setup(tmp_path):
    """A 64-wide model with peaky emissions (m9_setup's), a word scorer
    built by the port's tools, and a 2.5 s utterance as 16-bit PCM."""
    from stt_tpu_torch.lm.arpa import estimate_kneser_ney, write_arpa
    from stt_tpu_torch.tools.generate_scorer_package import create_package

    _, path, alphabet_path, _ = m9_setup(tmp_path)
    rs = np.random.RandomState(5)
    sentences = [list(rs.choice(LM_WORDS, size=rs.randint(3, 9))) for _ in range(300)]
    (tmp_path / "vocab.txt").write_text("\n".join(sorted(set(LM_WORDS))) + "\n")
    write_arpa(estimate_kneser_ney(sentences), str(tmp_path / "lm.arpa"))
    scorer = create_package(alphabet_path, str(tmp_path / "lm.arpa"), str(tmp_path / "vocab.txt"),
                            str(tmp_path / "lm.scorer"), 0.93, 1.18)
    pcm = (rs.uniform(-0.3, 0.3, 40000) * 32767).astype(np.int16)
    return path, scorer, pcm


def test_c_api_on_card_equals_model(device, tmp_path):
    """Through ctypes in this process, the C API serves on the card (its
    default): one-shot with metadata, then a 320 ms-chunk stream with a
    scorer and hot words, each equal to `Model(path)`'s on the card and
    launching K1."""
    from stt_tpu_torch.serve import Model, capi, cbridge

    path, scorer, pcm = capi_setup(tmp_path)
    audio = pcm.astype(np.float32) / 32768.0
    lib = capi.load()
    handle = ctypes.c_void_p()
    assert lib.STT_CreateModel(path.encode(), ctypes.byref(handle)) == 0
    assert [m.device.type for m in cbridge._MODELS.values()] == ["cuda"]
    model = Model(path)
    before = lstm_recurrence.launches
    text = capi.take_string(lib, lib.STT_SpeechToText(handle, capi.pcm_pointer(pcm), len(pcm)))
    assert lstm_recurrence.launches > before
    assert text and text == model.stt(audio)
    meta = capi.take_metadata(lib, lib.STT_SpeechToTextWithMetadata(
        handle, capi.pcm_pointer(pcm), len(pcm), 2))
    want = model.stt_with_metadata(audio, 2).transcripts
    assert [[(t, s) for t, s, _ in c[1]] for c in meta] == \
        [[(k.text, k.timestep) for k in c.tokens] for c in want]
    assert all(abs(c[0] - w.confidence) <= 1e-6 for c, w in zip(meta, want))
    assert lib.STT_EnableExternalScorer(handle, scorer.encode()) == 0
    model.enable_external_scorer(scorer)
    for word, boost in CAPI_HOT_WORDS.items():
        assert lib.STT_AddHotWord(handle, word.encode(), boost) == 0
        model.add_hot_word(word, boost)
    stream, ours = ctypes.c_void_p(), model.create_stream()
    assert lib.STT_CreateStream(handle, ctypes.byref(stream)) == 0
    before = lstm_recurrence.launches
    for off in range(0, len(pcm), 5120):
        chunk = np.ascontiguousarray(pcm[off:off + 5120])
        lib.STT_FeedAudioContent(stream, capi.pcm_pointer(chunk), len(chunk))
        ours.feed_audio_content(audio[off:off + 5120])
        assert capi.take_string(lib, lib.STT_IntermediateDecode(stream)) == \
            ours.intermediate_decode()
    assert capi.take_string(lib, lib.STT_FinishStream(stream)) == ours.finish_stream()
    assert lstm_recurrence.launches - before >= 2 * (len(pcm) // 5120)  # both streams
    assert not cbridge._STREAMS
    lib.STT_FreeModel(handle)


@pytest.mark.parametrize("mode", [[], ["--stream"]], ids=["one_shot", "stream"])
def test_stt_client_on_card_prints_models_transcript(device, tmp_path, mode):
    import subprocess
    import wave

    from stt_tpu_torch.serve import Model, capi

    path, _, pcm = capi_setup(tmp_path)
    wav = str(tmp_path / "a.wav")
    with wave.open(wav, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(pcm.tobytes())
    proc = subprocess.run([str(capi.client()), "--model", path, "--audio", wav, *mode],
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == Model(path).stt(pcm.astype(np.float32) / 32768.0)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_imported_tflite_fixture_served_on_card(device, tmp_path, kind):
    """The committed reference .tflite (tests/fixtures/), imported by the
    port's reader and saved as an artifact, served on the card: K1, logits
    of the CPU's within 1e-4 (64 wide), the CPU's transcript."""
    from stt_tpu_torch.artifact import save_tflite_as_artifact
    from stt_tpu_torch.frontend import FeatureConfig, audio_to_mfcc
    from stt_tpu_torch.serve import Model

    import torch_tflite_fixture as fixture

    path, geometry = save_tflite_as_artifact(fixture.PATHS[kind], str(tmp_path / kind))
    assert geometry["n_hidden"] == 64
    gpu, cpu = Model(path), Model(path, device="cpu")
    audio = np.random.RandomState(6).uniform(-0.3, 0.3, 30000).astype(np.float32)
    feats = audio_to_mfcc(torch.from_numpy(audio), FeatureConfig()).numpy()[None]
    before = lstm_recurrence.launches
    logits = gpu.infer_logits(feats, [feats.shape[1]])
    assert lstm_recurrence.launches > before
    torch.testing.assert_close(logits.cpu(), cpu.infer_logits(feats, [feats.shape[1]]),
                               rtol=0, atol=1e-4)
    assert gpu.stt(audio) == cpu.stt(audio)
