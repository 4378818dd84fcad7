"""The port's wav2vec 2.0 (`stt_tpu_torch.models.wav2vec2`) on the CPU at a
tiny size (width 32, 2 layers of 2 heads, 7 convolutions of 16 channels,
seeded weights):

- the batched forward of 3 rows of different lengths, padded, against the
  plain reference (`port_bench/reference/wav2vec2.py`, each utterance
  alone) and against the module one row at a time, to float32 rounding;
- with `transformers` importable, against its Wav2Vec2ForCTC (stable layer
  norm, LayerNorm feature encoder) on the same weights, loaded by
  `load_wav2vec2` from its `save_pretrained` directory (safetensors and
  pytorch_model.bin, and the weight norm's older weight_g / weight_v
  names): the layer equations are the published implementation's;
- padded keys attended to, and a post-LN ordering of the layers, each fail
  the comparison with the reference;
- the frame arithmetic, the layouts refused, and `transcribe_batch`
  (normalisation on the device, results equal to one row at a time).
"""

import json
import os

import numpy as np
import pytest
import torch

from port_bench.reference import wav2vec2 as ref
from stt_tpu_torch import evaluate_wav2vec2am
from stt_tpu_torch.alphabet import Alphabet
from stt_tpu_torch.models import wav2vec2

CFG = {"conv_dim": [16] * 7, "conv_kernel": [10, 3, 3, 3, 3, 2, 2],
       "conv_stride": [5, 2, 2, 2, 2, 2, 2], "conv_bias": True, "hidden_size": 32,
       "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 64,
       "num_conv_pos_embeddings": 16, "num_conv_pos_embedding_groups": 2,
       "layer_norm_eps": 1e-5, "vocab_size": 32, "pad_token_id": 0,
       "do_stable_layer_norm": True, "feat_extract_norm": "layer"}
LENGTHS = [16000, 11111, 4800]
LABELS = ["<pad>", "<s>", "</s>", "<unk>", " "] + list("ETAONIHSRDLUMWCFGYPBVK'XJQZ")
# float32 rounding of logits of magnitude ~1 through 2 layers: measured
# 1e-6 at most; TF32 operands move them by ~1e-3
TOL = dict(rtol=1e-5, atol=1e-5)


def params(seed=7, logit_scale=1.0):
    return ref.weights(CFG, seed, "cpu", logit_scale)


def model(seed=7, logit_scale=1.0):
    return wav2vec2.build(wav2vec2.Wav2Vec2Config.from_dict(CFG), params(seed, logit_scale),
                          "cpu")


def audio(lengths=LENGTHS, seed=3):
    gen = torch.Generator().manual_seed(seed)
    x = torch.zeros(len(lengths), max(lengths))
    for i, n in enumerate(lengths):
        x[i, :n] = 0.1 * torch.randn(n, generator=gen)
    return x


def reference_rows(p, x, lengths=LENGTHS, tf32=False):
    return [ref.logits(p, x[i, :n], CFG, tf32) for i, n in enumerate(lengths)]


def batched(m, x, lengths=LENGTHS):
    with torch.no_grad():
        logits, frames = m(x, torch.tensor(lengths))
    return [logits[i, :int(f)] for i, f in enumerate(frames)]


def test_frames_follow_the_convolutions():
    cfg = wav2vec2.Wav2Vec2Config()
    assert cfg.frames(16000) == 49 and cfg.frames(400) == 1 and cfg.frames(399) == 0
    n = np.array([16000, 240000, 80000])
    assert list(cfg.frames(n)) == [ref.frames(CFG, int(v)) for v in n] == [49, 749, 249]
    assert cfg.frames(torch.tensor(n)).tolist() == [49, 749, 249]


def test_batched_forward_equals_the_reference_and_each_row_alone():
    m, p, x = model(), params(), audio()
    got = batched(m, x)
    want = reference_rows(p, x)
    for i, (g, w, n) in enumerate(zip(got, want, LENGTHS)):
        assert g.shape == w.shape == (ref.frames(CFG, n), 32)
        torch.testing.assert_close(g, w, **TOL)
        [alone] = batched(m, x[i:i + 1, :n].clone(), [n])
        torch.testing.assert_close(g, alone, **TOL)
    # the control: TF32 operands leave the tolerance
    tf32 = reference_rows(p, x, tf32=True)
    assert max(float((a - b).abs().max()) for a, b in zip(tf32, want)) > 10 * TOL["atol"]


def test_padded_keys_attended_fail_the_comparison(monkeypatch):
    m, p, x = model(), params(), audio()
    real = wav2vec2.key_mask
    monkeypatch.setattr(wav2vec2, "key_mask", lambda frames, T: torch.ones_like(real(frames, T)))
    got = batched(m, x)
    want = reference_rows(p, x)
    torch.testing.assert_close(got[0], want[0], **TOL)  # the longest row has no padding
    assert float((got[2] - want[2]).abs().max()) > 100 * TOL["atol"]


def test_a_post_ln_ordering_fails_the_comparison(monkeypatch):
    def post_ln(self, x, mask):
        x = self.layer_norm(x + self.attention(x, mask))
        return self.final_layer_norm(x + self.feed_forward(x))

    m, p, x = model(), params(), audio()
    monkeypatch.setattr(wav2vec2._EncoderLayer, "forward", post_ln)
    got, want = batched(m, x), reference_rows(p, x)
    assert all(float((g - w).abs().max()) > 100 * TOL["atol"] for g, w in zip(got, want))


@pytest.mark.parametrize("key,value", [("do_stable_layer_norm", False),
                                       ("feat_extract_norm", "group"),
                                       ("hidden_act", "relu"), ("add_adapter", True)])
def test_layouts_not_implemented_are_refused(key, value):
    with pytest.raises(ValueError, match="not implemented"):
        wav2vec2.Wav2Vec2Config.from_dict(dict(CFG, **{key: value}))


def test_a_checkpoint_with_a_missing_name_is_refused():
    p = params()
    del p["lm_head.bias"]
    with pytest.raises(RuntimeError, match="lm_head.bias"):
        wav2vec2.build(wav2vec2.Wav2Vec2Config.from_dict(CFG), p, "cpu")


def _transformers():
    return pytest.importorskip("transformers")


@pytest.fixture(scope="module")
def hf_model():
    transformers = _transformers()
    config = transformers.Wav2Vec2Config(
        **{k: v for k, v in CFG.items()}, num_feat_extract_layers=7, hidden_act="gelu",
        feat_extract_activation="gelu", hidden_dropout=0.0, attention_dropout=0.0,
        activation_dropout=0.0, feat_proj_dropout=0.0, final_dropout=0.0, layerdrop=0.0)
    torch.manual_seed(11)
    hf = transformers.Wav2Vec2ForCTC(config).eval()
    gen = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for name, p in hf.named_parameters():  # every parameter takes part
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return hf


def _hf_logits(hf, x, lengths=LENGTHS):
    mask = (torch.arange(x.shape[1])[None, :] < torch.tensor(lengths)[:, None]).long()
    with torch.no_grad():
        logits = hf(x, attention_mask=mask).logits
    return logits


@pytest.mark.parametrize("form", ["safetensors", "bin", "weight_g"])
def test_equals_transformers_wav2vec2forctc(hf_model, tmp_path, form):
    folder = str(tmp_path / form)
    if form == "weight_g":
        os.makedirs(folder)
        state = {k.replace("parametrizations.weight.original0", "weight_g")
                 .replace("parametrizations.weight.original1", "weight_v"): v
                 for k, v in hf_model.state_dict().items()}
        assert any(k.endswith("weight_g") for k in state)
        torch.save(state, os.path.join(folder, "pytorch_model.bin"))
        hf_model.config.to_json_file(os.path.join(folder, "config.json"))
    else:
        hf_model.save_pretrained(folder, safe_serialization=form == "safetensors")
    names = set(os.listdir(folder))
    assert ("model.safetensors" in names) == (form == "safetensors")
    m = wav2vec2.load_wav2vec2(folder, "cpu")
    x = audio()
    want = _hf_logits(hf_model, x)
    for i, g in enumerate(batched(m, x)):
        torch.testing.assert_close(g, want[i, :g.shape[0]], **TOL)


def test_transcribe_batch_normalises_on_the_device_and_equals_one_row_at_a_time():
    m, x = model(logit_scale=30.0), audio()
    alphabet = Alphabet().init_from_labels(LABELS)
    normed = evaluate_wav2vec2am.rms_normalize_rows(3 * x, torch.tensor(LENGTHS))
    for i, n in enumerate(LENGTHS):
        np.testing.assert_allclose(normed[i, :n].numpy(),
                                   evaluate_wav2vec2am.rms_normalize(3 * x[i, :n].numpy()),
                                   rtol=1e-5, atol=1e-7)
        assert not normed[i, n:].any()
    kw = dict(blank_id=0, ignored_symbols=[1, 2, 3], beam_width=16)
    out = evaluate_wav2vec2am.transcribe_batch(m, x, LENGTHS, alphabet, **kw)
    assert list(out.frames) == [ref.frames(CFG, n) for n in LENGTHS]
    assert out.log_probs.shape == (3, ref.frames(CFG, LENGTHS[0]), 32)
    for i, n in enumerate(LENGTHS):
        one = evaluate_wav2vec2am.transcribe_batch(m, x[i:i + 1, :n].clone(), [n], alphabet, **kw)
        assert one.results[0][0].tokens == out.results[i][0].tokens
        assert one.results[0][0].confidence == pytest.approx(out.results[i][0].confidence,
                                                             rel=1e-5)
        assert out.results[i][0].tokens and not set(out.results[i][0].tokens) & {0, 1, 2, 3}


def test_the_default_is_the_card(tmp_path):
    folder = tmp_path / "m"
    folder.mkdir()
    (folder / "config.json").write_text(json.dumps(CFG))
    torch.save(params(), folder / "pytorch_model.bin")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            wav2vec2.load_wav2vec2(str(folder))
    m = wav2vec2.load_wav2vec2(str(folder), "cpu")
    torch.testing.assert_close(batched(m, audio())[1], reference_rows(params(), audio())[1],
                               **TOL)
