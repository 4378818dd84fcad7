"""Plain wav2vec 2.0 with its CTC head, for one unpadded utterance, and the
benchmark's weights for it.

The forward follows the paper (Baevski et al. 2020, arXiv:2006.11477) in
the order of HuggingFace's published Wav2Vec2ForCTC with
`do_stable_layer_norm` and `feat_extract_norm="layer"` (the large LV-60
models):

- the feature encoder: per layer a strided convolution (`F.conv1d`), a
  LayerNorm over the channels of each frame, GELU (the exact, erf form);
- the projection: LayerNorm over the 512 channels, a linear map to the width;
- the position embedding: a grouped convolution of K taps with K / 2 zeros
  on either side, its weight g * v / |v| (the norm over output and input
  channels, for each tap), the last output frame dropped where K is even,
  GELU, added to the projection's output;
- each layer pre-LN: x + out(softmax(q k^T / sqrt(d)) v) over LN(x), then
  x + W2 GELU(W1 LN(x) + b1) + b2; a LayerNorm after the last layer;
- the CTC head: a linear map to the vocabulary; log-probabilities by a
  float64 log-softmax of its float32 logits.

Departures from the published model, all of them of training or of
batching: dropout and LayerDrop are off (they are at inference); the
masked-frame embedding of pre-training is not used; the utterance is alone,
so nothing is padded and nothing is masked. Everything is float32 with TF32
off, in plain operations (no fused attention), each LayerNorm and GELU
written out. `tf32=True` rounds every operand of every matmul and
convolution to TF32's 10-bit mantissa: the control, the same arithmetic one
precision below.

It imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.generator import rng
from port_bench.reference.model import _tf32


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def frames(cfg: dict, samples: int) -> int:
    """Output frames of `samples` input samples: floor((n - k) / s) + 1
    through each convolution."""
    n = samples
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        n = (n - k) // s + 1
    return max(n, 0)


def shapes(cfg: dict) -> Dict[str, tuple]:
    """Every parameter's shape, under HuggingFace's Wav2Vec2ForCTC names
    (the position convolution's weight norm as weight_g, weight_v)."""
    out = {}
    chans = [1] + list(cfg["conv_dim"])
    for i, k in enumerate(cfg["conv_kernel"]):
        p = f"wav2vec2.feature_extractor.conv_layers.{i}."
        out[p + "conv.weight"] = (chans[i + 1], chans[i], k)
        out[p + "conv.bias"] = (chans[i + 1],)
        out[p + "layer_norm.weight"] = out[p + "layer_norm.bias"] = (chans[i + 1],)
    c, h, f = chans[-1], cfg["hidden_size"], cfg["intermediate_size"]
    out["wav2vec2.feature_projection.layer_norm.weight"] = (c,)
    out["wav2vec2.feature_projection.layer_norm.bias"] = (c,)
    out["wav2vec2.feature_projection.projection.weight"] = (h, c)
    out["wav2vec2.feature_projection.projection.bias"] = (h,)
    k, g = cfg["num_conv_pos_embeddings"], cfg["num_conv_pos_embedding_groups"]
    out["wav2vec2.encoder.pos_conv_embed.conv.weight_g"] = (1, 1, k)
    out["wav2vec2.encoder.pos_conv_embed.conv.weight_v"] = (h, h // g, k)
    out["wav2vec2.encoder.pos_conv_embed.conv.bias"] = (h,)
    for i in range(cfg["num_hidden_layers"]):
        p = f"wav2vec2.encoder.layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out[p + f"attention.{proj}.weight"] = (h, h)
            out[p + f"attention.{proj}.bias"] = (h,)
        for norm in ("layer_norm", "final_layer_norm"):
            out[p + f"{norm}.weight"] = out[p + f"{norm}.bias"] = (h,)
        out[p + "feed_forward.intermediate_dense.weight"] = (f, h)
        out[p + "feed_forward.intermediate_dense.bias"] = (f,)
        out[p + "feed_forward.output_dense.weight"] = (h, f)
        out[p + "feed_forward.output_dense.bias"] = (h,)
    out["wav2vec2.encoder.layer_norm.weight"] = out["wav2vec2.encoder.layer_norm.bias"] = (h,)
    out["lm_head.weight"] = (cfg["vocab_size"], h)
    out["lm_head.bias"] = (cfg["vocab_size"],)
    return out


def _half_width(name: str, shape: tuple) -> tuple:
    """(centre, half width) of the uniform draw of a parameter: the
    initializer's deviations (HuggingFace's: He for the feature encoder's
    convolutions, 0.02 for linear maps, 2 / sqrt(K H) for the position
    convolution) as uniform half widths sqrt(3) times the deviation;
    biases and LayerNorms drawn about 0 and 1 so that each takes part."""
    if name.endswith("weight_g"):
        return 1.0, 0.5  # times |v|, below
    if "layer_norm" in name:
        return (1.0, 0.2) if name.endswith("weight") else (0.0, 0.2)
    if name.endswith("bias"):
        return 0.0, 0.02
    if "conv_layers" in name:
        return 0.0, math.sqrt(6.0 / (shape[1] * shape[2]))
    if "pos_conv" in name:
        return 0.0, math.sqrt(3.0) * 2.0 / math.sqrt(shape[0] * shape[2])
    return 0.0, math.sqrt(3.0) * 0.02


def weights(cfg: dict, seed: int, device, logit_scale: float) -> Dict[str, torch.Tensor]:
    """The model's parameters, under HuggingFace's names, drawn on `device`
    from the seed in one call, float32; the CTC head's matrix times
    `logit_scale` (at the initializer's 0.02 the emissions are near uniform,
    on which a beam of 500 keeps one of many near-equal prefixes by its
    rounding; a served model is a trained one, whose emissions are peaky).
    The position convolution's g is |v| times a draw in [0.5, 1.5], so the
    weight norm's scale is not v's own."""
    shape = shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(int(rng(seed, "weights").integers(1 << 62)))
    flat = torch.rand(sum(math.prod(s) for s in shape.values()), generator=gen, device=device)
    params, at = {}, 0
    for name, s in shape.items():
        n = math.prod(s)
        centre, half = _half_width(name, s)
        params[name] = (flat[at:at + n].view(s) * 2 - 1) * half + centre
        at += n
    pos = "wav2vec2.encoder.pos_conv_embed.conv."
    params[pos + "weight_g"] = params[pos + "weight_g"] * params[pos + "weight_v"].norm(
        dim=(0, 1), keepdim=True)
    params["lm_head.weight"] = params["lm_head.weight"] * logit_scale
    return params


# --- the forward ----------------------------------------------------------------


def _layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _linear(x, p, name, tf32):
    w = p[name + ".weight"]
    if tf32:
        x, w = _tf32(x), _tf32(w)
    return x @ w.T + p[name + ".bias"]


def _conv(x, w, b, tf32, **kw):
    if tf32:
        x, w = _tf32(x), _tf32(w)
    return F.conv1d(x, w, b, **kw)


def _matmul(a, b, tf32):
    return _tf32(a) @ _tf32(b) if tf32 else a @ b


@torch.no_grad()
def logits(params: Dict[str, torch.Tensor], audio: torch.Tensor, cfg: dict,
           tf32: bool = False) -> torch.Tensor:
    """One utterance's samples [S] -> logits [T, vocab], float32."""
    _no_tf32()
    p, eps = params, cfg["layer_norm_eps"]
    x = audio.float()[None, None]  # [1, 1, S]
    for i, s in enumerate(cfg["conv_stride"]):
        q = f"wav2vec2.feature_extractor.conv_layers.{i}."
        x = _conv(x, p[q + "conv.weight"], p[q + "conv.bias"], tf32, stride=s)
        x = _layer_norm(x.transpose(1, 2), p[q + "layer_norm.weight"],
                        p[q + "layer_norm.bias"], eps).transpose(1, 2)
        x = _gelu(x)
    x = x[0].T  # [T, C]
    q = "wav2vec2.feature_projection."
    x = _layer_norm(x, p[q + "layer_norm.weight"], p[q + "layer_norm.bias"], eps)
    x = _linear(x, p, q + "projection", tf32)  # [T, H]
    T, H = x.shape

    q = "wav2vec2.encoder.pos_conv_embed.conv."
    v, g = p[q + "weight_v"], p[q + "weight_g"]
    w = g * v / torch.sqrt((v * v).sum(dim=(0, 1), keepdim=True))
    k = v.shape[-1]
    pos = _conv(x.T[None], w, p[q + "bias"], tf32, padding=k // 2,
                groups=cfg["num_conv_pos_embedding_groups"])[0]  # [H, T + 1 or T]
    x = x + _gelu(pos[:, :T]).T

    heads = cfg["num_attention_heads"]
    d = H // heads
    for i in range(cfg["num_hidden_layers"]):
        q = f"wav2vec2.encoder.layers.{i}."
        y = _layer_norm(x, p[q + "layer_norm.weight"], p[q + "layer_norm.bias"], eps)
        qh, kh, vh = (_linear(y, p, q + f"attention.{n}", tf32).view(T, heads, d).transpose(0, 1)
                      for n in ("q_proj", "k_proj", "v_proj"))  # [heads, T, d]
        scores = _matmul(qh, kh.transpose(1, 2), tf32) / math.sqrt(d)
        scores = scores - scores.max(dim=-1, keepdim=True).values
        attn = torch.exp(scores)
        attn = attn / attn.sum(dim=-1, keepdim=True)
        ctx = _matmul(attn, vh, tf32).transpose(0, 1).reshape(T, H)
        x = x + _linear(ctx, p, q + "attention.out_proj", tf32)
        y = _layer_norm(x, p[q + "final_layer_norm.weight"], p[q + "final_layer_norm.bias"], eps)
        y = _gelu(_linear(y, p, q + "feed_forward.intermediate_dense", tf32))
        x = x + _linear(y, p, q + "feed_forward.output_dense", tf32)
    q = "wav2vec2.encoder.layer_norm."
    x = _layer_norm(x, p[q + "weight"], p[q + "bias"], eps)
    return _linear(x, p, "lm_head", tf32)


def log_probs(params, audios: List[np.ndarray], cfg: dict, device,
              tf32: bool = False) -> List[torch.Tensor]:
    """Each utterance's samples, alone, normalised (`rms_normalize`) ->
    its log-probabilities [T_i, vocab], float64, on `device`."""
    out = []
    for a in audios:
        x = torch.as_tensor(rms_normalize(a), dtype=torch.float32, device=device)
        out.append(torch.log_softmax(logits(params, x, cfg, tf32).double(), dim=-1))
    return out


def rms_normalize(audio: np.ndarray, db_level: float = -27.0) -> np.ndarray:
    """The entry's input rule: samples scaled to an RMS of db_level dBFS
    (untouched where all are zero), in float64."""
    audio = np.asarray(audio, np.float64)
    energy = float(np.sum(audio ** 2))
    if energy <= 0:
        return audio
    return audio * math.sqrt(len(audio) * (10 ** (db_level / 20)) ** 2 / energy)
