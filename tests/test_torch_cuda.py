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
