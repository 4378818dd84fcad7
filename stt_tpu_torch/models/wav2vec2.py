"""wav2vec 2.0 with a CTC head (Baevski et al. 2020, arXiv:2006.11477), in the
layout of HuggingFace's `Wav2Vec2ForCTC` with `do_stable_layer_norm` and a
LayerNorm feature encoder: the "large-lv60" models, such as
facebook/wav2vec2-large-960h-lv60-self.

    raw audio [B, S]
    -> 7 strided convolutions, each with LayerNorm over channels and GELU
    -> LayerNorm(512), Linear to the width             (the feature encoder
                                                          and its projection)
    -> padded frames zeroed
    -> + GELU(grouped position convolution, weight-normalised over its
         taps, its last frame dropped)
    -> pre-LN layers: x + attention(LN(x)), x + FFN(LN(x)), with padded
       frames masked out of the keys
    -> LayerNorm -> Linear to the vocabulary (blank at `pad_token_id`)

The forward is batched: each row holds `lengths[i]` valid samples, and its
frame count follows the convolutions' arithmetic (`Wav2Vec2Config.frames`).
A valid frame of a padded row equals that of the row alone, up to rounding:
the convolutions read only valid samples for valid frames, the position
convolution sees zeros past the row's end as it sees its own zero padding,
and attention gives padded keys no weight. The module runs in float32
under `device.resolve_device`'s settings (no TF32 in cuBLAS or cuDNN);
attention is `scaled_dot_product_attention`.

`load_wav2vec2` builds the model from a HuggingFace checkpoint directory
(config.json and model.safetensors or pytorch_model.bin) by the checkpoint's
own parameter names, without the `transformers` package. Layouts this
module does not implement (post-LN layers, the group-norm feature encoder,
adapters, other activations) are refused, not approximated.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from stt_tpu_torch import trace


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """The shape of the model, under HuggingFace's config.json names; the
    defaults are wav2vec 2.0 Large (LV-60)'s."""

    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = True
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    vocab_size: int = 32
    pad_token_id: int = 0
    do_stable_layer_norm: bool = True
    feat_extract_norm: str = "layer"

    # config.json keys outside the fields, each with the one value the module implements
    REQUIRED = {"hidden_act": "gelu", "feat_extract_activation": "gelu", "add_adapter": False}

    def __post_init__(self):
        for key in ("conv_dim", "conv_kernel", "conv_stride"):
            object.__setattr__(self, key, tuple(int(v) for v in getattr(self, key)))
        if not len(self.conv_dim) == len(self.conv_kernel) == len(self.conv_stride):
            raise ValueError("conv_dim, conv_kernel and conv_stride differ in length")
        if self.hidden_size % self.num_attention_heads:
            raise ValueError("hidden_size is not a multiple of num_attention_heads")
        if not self.do_stable_layer_norm:
            raise ValueError("post-LN layers (do_stable_layer_norm false) are not implemented")
        if self.feat_extract_norm != "layer":
            raise ValueError(f"feat_extract_norm={self.feat_extract_norm!r} is not implemented "
                             "(only 'layer')")

    @classmethod
    def from_dict(cls, config: dict) -> "Wav2Vec2Config":
        """The fields of a HuggingFace config.json; raises on a layout that
        the module does not implement."""
        for key, want in cls.REQUIRED.items():
            if key in config and config[key] != want:
                raise ValueError(f"{key}={config[key]!r} is not implemented (only {want!r})")
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in config.items() if k in fields})

    def frames(self, samples):
        """Output frames of `samples` input samples (an int, a numpy array or
        a tensor): floor((n - kernel) / stride) + 1 through each
        convolution, and 0 for an input shorter than the receptive field."""
        n = samples
        for k, s in zip(self.conv_kernel, self.conv_stride):
            n = (n - k) // s + 1
        if isinstance(n, torch.Tensor):
            return n.clamp(min=0)
        return np.maximum(n, 0)


def key_mask(frames: torch.Tensor, T: int) -> torch.Tensor:
    """[B, 1, 1, T] bool, True where a key is one of its row's `frames`
    valid frames: what attention may attend to."""
    return (torch.arange(T, device=frames.device) < frames[:, None])[:, None, None, :]


class _ConvLayer(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int, bias: bool, eps: float):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel, stride=stride, bias=bias)
        self.layer_norm = nn.LayerNorm(c_out, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, T]
        x = self.layer_norm(self.conv(x).transpose(1, 2)).transpose(1, 2)
        return F.gelu(x)


class _FeatureEncoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        chans = (1,) + cfg.conv_dim
        self.conv_layers = nn.ModuleList(
            _ConvLayer(chans[i], chans[i + 1], k, s, cfg.conv_bias, cfg.layer_norm_eps)
            for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)))

    def forward(self, audio: torch.Tensor) -> torch.Tensor:  # [B, S] -> [B, C, T]
        x = audio[:, None]
        for layer in self.conv_layers:
            x = layer(x)
        return x


class _FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, C] -> [B, T, H]
        return self.projection(self.layer_norm(x))


class _WeightNormConv(nn.Module):
    """The position convolution: weight = g * v / |v|, the norm over the
    output and input channels of each tap (PyTorch's weight_norm, dim=2)."""

    def __init__(self, width: int, kernel: int, groups: int):
        super().__init__()
        v = torch.randn(width, width // groups, kernel) * (2 / math.sqrt(kernel * width))
        self.weight_v = nn.Parameter(v)
        self.weight_g = nn.Parameter(v.norm(dim=(0, 1), keepdim=True))
        self.bias = nn.Parameter(torch.zeros(width))
        self.groups = groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, T] -> [B, H, T + 1]
        v = self.weight_v
        weight = v * (self.weight_g / v.norm(dim=(0, 1), keepdim=True))
        return F.conv1d(x, weight, self.bias, padding=v.shape[-1] // 2, groups=self.groups)


class _PositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.conv = _WeightNormConv(cfg.hidden_size, cfg.num_conv_pos_embeddings,
                                    cfg.num_conv_pos_embedding_groups)
        self.drop_last = cfg.num_conv_pos_embeddings % 2 == 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, H]
        y = self.conv(x.transpose(1, 2))
        if self.drop_last:  # an even kernel puts out one frame more
            y = y[:, :, :-1]
        return F.gelu(y).transpose(1, 2)


class _Attention(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        h = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj, self.k_proj = nn.Linear(h, h), nn.Linear(h, h)
        self.v_proj, self.out_proj = nn.Linear(h, h), nn.Linear(h, h)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, T, H = x.shape

        def split(proj):
            return proj(x).view(B, T, self.heads, H // self.heads).transpose(1, 2)

        out = F.scaled_dot_product_attention(split(self.q_proj), split(self.k_proj),
                                             split(self.v_proj), attn_mask=mask)
        return self.out_proj(out.transpose(1, 2).reshape(B, T, H))


class _FeedForward(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class _EncoderLayer(nn.Module):
    """One pre-LN ("stable layer norm") layer."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.attention = _Attention(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = _FeedForward(cfg)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        with trace.span("w2v2.attention", device=True):
            x = x + self.attention(self.layer_norm(x), mask)
        return x + self.feed_forward(self.final_layer_norm(x))


class _Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.pos_conv_embed = _PositionalConvEmbedding(cfg)
        self.layers = nn.ModuleList(_EncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class _Wav2Vec2(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.feature_extractor = _FeatureEncoder(cfg)
        self.feature_projection = _FeatureProjection(cfg)
        self.encoder = _Encoder(cfg)


class Wav2Vec2CTC(nn.Module):
    """wav2vec 2.0 with its CTC head; parameters under the names of
    HuggingFace's Wav2Vec2ForCTC (the position convolution's weight norm as
    `weight_g`, `weight_v`)."""

    def __init__(self, config: Wav2Vec2Config = Wav2Vec2Config()):
        super().__init__()
        self.config = config
        self.wav2vec2 = _Wav2Vec2(config)
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size)

    def forward(self, audio: torch.Tensor, lengths) -> Tuple[torch.Tensor, torch.Tensor]:
        """audio [B, S] float32, zero or anything past each row's length;
        lengths [B] valid samples (a tensor or a sequence; on the host, it
        costs no wait for the device) -> (logits [B, T, vocab], frames [B],
        the valid frames of each row, on the lengths' device). Logits past
        a row's frames are padding's."""
        model = self.wav2vec2
        frames = self.config.frames(torch.as_tensor(lengths))
        on_device = frames.to(audio.device)
        with trace.span("w2v2.forward", device=True):
            with trace.span("w2v2.features", device=True):
                x = model.feature_projection(model.feature_extractor(audio).transpose(1, 2))
            B, T = x.shape[:2]
            if trace.enabled():
                trace.count("w2v2.frames", B * T)
                trace.count("w2v2.valid_frames", int(frames.sum()))
            valid = torch.arange(T, device=x.device)[None, :] < on_device[:, None]
            x = x.masked_fill(~valid[..., None], 0.0)
            x = x + model.encoder.pos_conv_embed(x)
            mask = key_mask(on_device, T)
            for layer in model.encoder.layers:
                x = layer(x, mask)
            logits = self.lm_head(model.encoder.layer_norm(x))
        return logits, frames


# checkpoint names of the position convolution's weight norm -> the module's
_WEIGHT_NORM_NAMES = {"parametrizations.weight.original0": "weight_g",
                      "parametrizations.weight.original1": "weight_v"}
_SAFETENSORS_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
                       "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a .safetensors file (an 8-byte little-endian header
    size, a JSON header of dtype, shape and byte offsets, then the data)."""
    with open(path, "rb") as f:
        size = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(size))
        data = bytearray(f.read())
    out = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES[entry["dtype"]]
        start, end = entry["data_offsets"]
        flat = torch.frombuffer(data, dtype=dtype, offset=start,
                                count=(end - start) // dtype.itemsize)
        out[name] = flat.reshape(entry["shape"]).clone()
    return out


def state_from_checkpoint(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A Wav2Vec2ForCTC checkpoint's tensors under the module's names: the
    weight norm's newer spelling mapped to weight_g / weight_v, and the
    pre-training's masked-frame embedding dropped."""
    state = {}
    for name, value in tensors.items():
        if name.endswith("masked_spec_embed"):
            continue
        for old, new in _WEIGHT_NORM_NAMES.items():
            if name.endswith(old):
                name = name[: -len(old)] + new
        state[name] = value
    return state


def build(config: Wav2Vec2Config, tensors: Dict[str, torch.Tensor], device="cuda") -> Wav2Vec2CTC:
    """The model holding a checkpoint's tensors (HuggingFace's names), in
    float32 on `device`, in eval mode; raises on a missing or extra name."""
    from stt_tpu_torch.device import resolve_device

    device = resolve_device(device)
    with torch.device(device):
        model = Wav2Vec2CTC(config)
    model.load_state_dict({k: v.float() for k, v in state_from_checkpoint(tensors).items()})
    return model.eval()


def load_wav2vec2(model_dir: str, device="cuda") -> Wav2Vec2CTC:
    """The model of a HuggingFace Wav2Vec2ForCTC checkpoint directory
    (config.json, and model.safetensors or pytorch_model.bin) on `device`."""
    from stt_tpu_torch.device import resolve_device

    device = resolve_device(device)
    with open(os.path.join(model_dir, "config.json"), encoding="utf-8") as f:
        config = Wav2Vec2Config.from_dict(json.load(f))
    path = os.path.join(model_dir, "model.safetensors")
    if os.path.isfile(path):
        tensors = read_safetensors(path)
    else:
        tensors = torch.load(os.path.join(model_dir, "pytorch_model.bin"), map_location="cpu",
                             weights_only=True)
    return build(config, tensors, device)
