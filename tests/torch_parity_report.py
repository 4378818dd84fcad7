"""Print the port's parity table: for each stt_tpu_torch module, the largest
absolute difference from its stt_tpu counterpart on the CPU, on the seeded
inputs of the tests/test_torch_*.py files.

    JAX_PLATFORMS=cpu python tests/torch_parity_report.py
"""

import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_ctc as ctc  # noqa: E402
import test_torch_decode as dec  # noqa: E402
import test_torch_device_decode as ddc  # noqa: E402
import test_torch_lstm as lst  # noqa: E402
import test_torch_lstm_train as ltr  # noqa: E402
import test_torch_model as mod  # noqa: E402
import test_torch_quant as qnt  # noqa: E402
import test_torch_serve as srv  # noqa: E402
import test_torch_train_step as stp  # noqa: E402
from stt_tpu.artifact import build_metadata, save_artifact  # noqa: E402
from stt_tpu.frontend import FeatureConfig as JaxFeatureConfig  # noqa: E402
from stt_tpu.frontend import audio_to_mfcc as jax_audio_to_mfcc  # noqa: E402
from stt_tpu.models import apply_model, init_params  # noqa: E402
from stt_tpu.serve import Model as JaxModel  # noqa: E402
from stt_tpu_torch.artifact import params_from_numpy  # noqa: E402
from stt_tpu_torch.frontend import audio_to_mfcc  # noqa: E402
from stt_tpu_torch.serve import Model  # noqa: E402


def maxdiff(pairs):
    return max(float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())
               for a, b in pairs)


def main():
    rows = []
    audio = srv.speech_like(0, 2.3)
    got = audio_to_mfcc(torch.from_numpy(audio)).numpy()
    rows.append(("frontend.audio_to_mfcc", "frontend.audio_to_mfcc", "float32",
                 maxdiff([(got, jax_audio_to_mfcc(jnp.asarray(audio)))])))

    for dtype in ("float32", "bfloat16"):
        jdt, tdt = lst.DTYPES[dtype]
        for ref_name, ref in (("models.lstm.lstm_scan", lst.jax_lstm_scan),
                              ("ops.lstm_fused (Pallas, interpret)", lst.jax_lstm_fused)):
            diffs = []
            for B in (1, 3, 8):
                case = lst.make_case(B, T=12, B=B)
                diffs.append(maxdiff(zip(lst.run_port(lst.lstm_scan, *case, tdt),
                                         lst.run_jax(ref, *case, jdt))))
            rows.append(("models.lstm.lstm_scan", ref_name, dtype, max(diffs)))

    for dtype, layer_norm in (("float32", False), ("bfloat16", False),
                              ("float32", True), ("bfloat16", True)):
        jax_cfg, cfg = mod.configs(dtype, layer_norm)
        params = jax.device_get(init_params(jax.random.PRNGKey(1), jax_cfg))
        feats, seq, state = mod.inputs(2)
        want, (c_w, h_w) = apply_model(params, jnp.asarray(feats), seq_len=jnp.asarray(seq),
                                       config=jax_cfg, previous_state=tuple(map(jnp.asarray, state)))
        with torch.no_grad():
            got, (c, h) = params_from_numpy(params, cfg)(
                torch.from_numpy(feats), seq_len=torch.from_numpy(seq),
                previous_state=tuple(map(torch.from_numpy, state)))
        name = "models.DeepSpeech.forward (logits, c, h)" + (", layer norm" if layer_norm else "")
        rows.append((name, "models.apply_model", dtype, maxdiff([(got, want), (c, c_w), (h, h_w)])))

    probs = dec.seeded_probs(20)
    ulps = []
    for top_n, prob in dec.CUTOFFS:
        want = dec.jax_prune_host(probs, top_n, prob)
        got = dec.prune_emissions(torch.from_numpy(probs), top_n, prob)
        assert all(np.array_equal(g.numpy(), w) for g, w in zip(got[::2], want[::2]))
        ulps.append(int(np.abs(got[1].numpy().view(np.int32) - want[1].view(np.int32)).max()))
    rows.append(("decode.device.prune_emissions (logp)", "decode.device.prune_emissions_host",
                 "float32", f"{max(ulps)} ulp; idx, count, blank equal"))

    with tempfile.TemporaryDirectory() as tmp:
        alphabet = srv.JaxAlphabet().init_from_labels(srv.LABELS)
        config = srv.JaxModelConfig(n_hidden=64, n_cell_dim=64, n_out=len(srv.LABELS) + 1,
                                    dropout_rates=(0.0,) * 6)
        params = jax.device_get(init_params(jax.random.PRNGKey(7), config))
        save_artifact(tmp, params, build_metadata(config, JaxFeatureConfig(), alphabet,
                                                  beam_width=srv.BEAM), alphabet)
        jax_model, model = JaxModel(tmp), Model(tmp, device="cpu")
        want_text, want = jax_model.stt_with_emissions(audio)
        text, got = model.stt_with_emissions(audio)
        rows.append(("serve.Model.stt_with_emissions (probs)", "serve.Model.stt_with_emissions",
                     "float32", maxdiff([(got, want)])))
        rows.append(("serve.Model.stt (transcript)", "serve.Model.stt", "float32",
                     "equal" if text == want_text else "differs"))

    rows.extend(training_rows())
    rows.extend(opt_in_rows())

    print("| port (stt_tpu_torch.) | held against (stt_tpu.) | dtype | max abs diff, CPU |")
    print("|---|---|---|---|")
    for port, ref, dtype, diff in rows:
        print(f"| `{port}` | `{ref}` | {dtype} | {diff if isinstance(diff, str) else f'{diff:.3g}'} |")


def training_rows():
    rows = []
    diffs = []
    for seed in (0, 1, 2):
        loss, grad, want, want_grad = ctc.both(*ctc.case(seed))
        finite = np.isfinite(want)
        diffs.append(maxdiff([(loss[finite], want[finite]), (grad, want_grad)]))
    rows.append(("ctc.ctc_loss (loss, grad; inf rows equal)", "ctc.ctc_loss", "float32",
                 max(diffs)))

    for dtype in ("float32", "bfloat16"):
        jdt, tdt = ltr.DTYPES[dtype]
        params, x, seq, c0, h0 = ltr.make_case(0, 7, 8, 128)
        x_proj, w_h = ltr.project_inputs({k: torch.from_numpy(v) for k, v in params.items()},
                                         torch.from_numpy(x), tdt)
        hs, cs, zs, c_T, h_T = ltr.train_forward(x_proj, w_h, torch.from_numpy(c0),
                                                 torch.from_numpy(h0), torch.from_numpy(seq))
        jw = jnp.asarray(w_h.float().numpy()).astype(jdt)
        want = ltr._lstm_train_fwd_impl(jnp.asarray(x_proj.float().numpy()).astype(jdt), jw,
                                        jnp.asarray(c0), jnp.asarray(h0),
                                        jnp.asarray(seq)[:, None], interpret=True)
        share, _ = ltr.bf16_mismatch(zs.float().numpy(), np.asarray(want[2].astype(jnp.float32)))
        rows.append(("ops.lstm_train.train_forward (hs, cs, c_T, h_T)", "ops._lstm_train_fwd_impl "
                     "(Pallas K3, interpret)", dtype,
                     maxdiff([(hs, want[0]), (cs, want[1]), (c_T, want[3]), (h_T, want[4])])))
        rows.append(("ops.lstm_train.train_forward (zs, bf16)", "ops._lstm_train_fwd_impl", dtype,
                     f"{share:.2%} of values 1 bf16 ulp apart, rest equal"))
        rs = np.random.RandomState(1)
        T, B, H = 7, 8, 128
        dout, dc_T, dh_T = ((rs.randn(*shape) * 0.1).astype(np.float32)
                            for shape in ((T, B, H), (B, H), (B, H)))
        cs_prev = np.concatenate([c0[None], np.asarray(want[1])[:-1]])
        j_zs = np.array(want[2].astype(jnp.float32))
        dz_w, dc_w, dh_w = ltr._lstm_train_bwd_impl(
            want[2], want[1], jnp.asarray(cs_prev), jnp.asarray(dout), jw.T,
            jnp.asarray(seq)[:, None], jnp.asarray(dc_T), jnp.asarray(dh_T), interpret=True)
        dz, dc0, dh0 = ltr.train_backward(
            torch.from_numpy(j_zs).to(torch.bfloat16), torch.from_numpy(np.array(want[1])),
            torch.from_numpy(cs_prev), torch.from_numpy(dout), w_h, torch.from_numpy(seq),
            torch.from_numpy(dc_T), torch.from_numpy(dh_T))
        rows.append(("ops.lstm_train.train_backward (dz, dc0, dh0)", "ops._lstm_train_bwd_impl "
                     "(Pallas K4, interpret)", dtype,
                     maxdiff([(dz, dz_w), (dc0, dc_w), (dh0, dh_w)])))
        params, x, seq, c0, h0 = ltr.make_case(7 + 8 + 128, 7, 8, 128, n_in=48)
        _, grads, _ = ltr.port_grads(params, x, seq, c0, h0, tdt)
        _, want_grads = ltr.jax_grads(lambda *a, **k: ltr.jax_lstm_train(*a, interpret=True, **k),
                                      params, x, seq, c0, h0, jdt)
        worst = max(stp.rel_norm(grads[k], np.asarray(v)) for k, v in want_grads.items())
        rows.append(("ops.lstm_train.lstm_train grads (kernel, bias, x, c0, h0)",
                     "jax.grad of ops.lstm_train.lstm_train", dtype,
                     f"{maxdiff([(grads[k], want_grads[k]) for k in grads]):.3g} "
                     f"(largest relative norm {worst:.2g})"))

    for dtype in ("float32", "bfloat16"):
        jax_cfg, cfg = stp.configs(dtype)
        params = jax.device_get(init_params(jax.random.PRNGKey(0), jax_cfg))
        arrays = stp.make_batch(1)
        optimizer = stp.jax_create_optimizer(learning_rate=stp.LR)
        jstate = stp.jax_create_train_state(None, jax_cfg, optimizer, params=params)
        jstate, jm = stp.jax_make_train_step(jax_cfg, optimizer)(
            jstate, stp.jax_batch(arrays), jax.random.PRNGKey(9))
        state = stp.create_train_state(cfg, device="cpu", model=params_from_numpy(params, cfg),
                                       learning_rate=stp.LR)
        state, m = stp.make_train_step()(state, stp.port_batch(arrays), 9)
        finite = ~m.non_finite.numpy()
        rows.append(("train.make_train_step, one step (loss; grad_norm)",
                     "train.make_train_step (autodiff of lstm_scan)", dtype,
                     f"{abs(m.loss.item() - float(jm.loss)):.3g}; "
                     f"{abs(m.grad_norm.item() - float(jm.grad_norm)):.3g} "
                     f"(non_finite equal: {bool(np.array_equal(~finite, np.asarray(jm.non_finite)))})"))
    return rows


def opt_in_rows():
    """int8 inference (K2's plain version and the quantized forward) and
    device decode (K5's plain version)."""
    from stt_tpu_torch.artifact import qparams_from_numpy
    from stt_tpu_torch.decode import device
    from stt_tpu_torch.ops import beam_kernel, quant
    from stt_tpu_torch.ops.lstm_kernel import lstm_recurrence_q

    rows = []
    params = qnt.jax_params()
    jax_cfg, cfg = qnt.configs()
    want = qparams_from_numpy(qnt.jax_qparams(params))
    got = quant.quantize_params(dict(params_from_numpy(params, cfg).named_parameters()), cfg)
    equal = all(torch.equal(got[n].w_q, want[n].w_q) for n in (*quant.DENSE, "lstm_in"))
    equal = equal and torch.equal(got["lstm_rec"]["w_h_q"], want["lstm_rec"]["w_h_q"])
    scale = maxdiff([(got[n].w_scale, want[n].w_scale) for n in (*quant.DENSE, "lstm_in")])
    rows.append(("ops.quant.quantize_params (int8 weights; scales)", "ops.quant.quantize_params",
                 "int8 / float32", f"{'equal' if equal else 'differ'}; {scale:.3g}"))

    for dtype, (jdt, tdt) in (("float32", (jnp.float32, torch.float32)),
                              ("bfloat16", (jnp.bfloat16, torch.bfloat16))):
        x_proj, w_h_q, step_scale, c0, h0, seq = qnt.rec_case(8)
        xp_j = jnp.asarray(x_proj).astype(jdt)
        xp_t = torch.from_numpy(np.array(xp_j.astype(jnp.float32))).to(tdt)
        out, (c, h) = lstm_recurrence_q(xp_t, *(torch.from_numpy(a) for a in
                                                (w_h_q, step_scale, c0, h0, seq)))
        k_out, k_c, k_h = qnt.lstm_fused_q_impl(
            xp_j, *(jnp.asarray(a) for a in (w_h_q, step_scale, c0, h0)),
            jnp.asarray(seq).reshape(-1, 1), interpret=True)
        rows.append(("ops.quant.recurrence_q (out, c, h)", "ops.lstm_fused_q_impl (Pallas K2, "
                     "interpret)", dtype,
                     f"{maxdiff([(out, k_out), (c, k_c), (h, k_h)]):.3g} "
                     f"({qnt.flips(out.numpy(), k_out):.3%} of h_q differ)"))

    jax_cfg = qnt.JaxModelConfig(**dict(qnt.GEOMETRY, dropout_rates=(0.0,) * 6, fused_lstm=False))
    jq = qnt.jax_quant.quantize_params(params, jax_cfg)
    feats, seq = qnt.features(4)
    want_logits, (c_w, h_w) = qnt.jax_quant.apply_model_quantized(
        jq, jnp.asarray(feats), seq_len=jnp.asarray(seq), config=jax_cfg)
    logits, (c, h) = quant.apply_model_quantized(
        qparams_from_numpy(jax.device_get(jq)), torch.from_numpy(feats),
        seq_len=torch.from_numpy(seq), config=cfg)
    rows.append(("ops.quant.apply_model_quantized (logits, c, h)", "ops.quant.apply_model_quantized",
                 "int8", maxdiff([(logits, want_logits), (c, c_w), (h, h_w)])))

    ddc.jax_beam_kernel._INTERPRET = True
    equal, diffs = True, []
    for B, T, C, W, top_n, cprob, seed, peaky, blank_id, ignored in ddc.FIXTURES.values():
        probs, lens = ddc.fixture_probs(B, T, C, seed, peaky)
        scores, src, char = device._device_beam_scan(
            torch.from_numpy(probs), torch.from_numpy(lens), W, top_n, cprob, blank_id, ignored)
        s_x, src_x, char_x = ddc.jax_device._device_beam_scan(
            jnp.asarray(probs), jnp.asarray(lens), W, top_n, cprob, blank_id, tuple(ignored))
        _, s_k, packed = ddc.jax_beam_kernel.beam_scan(probs, lens, W, top_n, cprob, blank_id,
                                                       tuple(ignored))
        src_k, char_k = beam_kernel.unpack_bp(np.asarray(packed))
        equal = equal and all(np.array_equal(a, b) for a, b in (
            (src.numpy(), np.asarray(src_x)), (char.numpy(), np.asarray(char_x)),
            (src.numpy(), src_k), (char.numpy(), char_k)))
        finite = np.isfinite(np.asarray(s_x))
        diffs.append(maxdiff([(scores.numpy()[finite], np.asarray(s_x)[finite]),
                              (scores.numpy()[finite], np.asarray(s_k)[finite])]))
    rows.append(("decode.device.beam_scan_plain (backpointers; scores), 5 fixtures",
                 "decode.device._device_beam_scan and ops.beam_kernel.beam_scan (Pallas K5, "
                 "interpret)", "float32",
                 f"{'equal' if equal else 'differ'}; {max(diffs):.3g}"))
    return rows


if __name__ == "__main__":
    main()
