"""The benchmark's fixed arithmetic for wav2vec 2.0: the forward's matmul
and convolution operations of an utterance, counted from its valid samples
and the configuration's shapes alone, never from how the program computes
them. Beside `yardstick.py`, whose counts are DeepSpeech's."""

from __future__ import annotations

from typing import List


def conv_frames(cfg: dict, samples: int) -> List[int]:
    """Output frames of each feature-encoder convolution for `samples`
    input samples: floor((n - kernel) / stride) + 1, layer after layer."""
    out, n = [], int(samples)
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        n = max((n - k) // s + 1, 0)
        out.append(n)
    return out


def forward_flops(cfg: dict, samples: int) -> int:
    """Operations (2 a multiply-add) of one utterance of `samples` valid
    samples through the model, over its valid frames F only:
    - each convolution: its output frames x c_out x c_in x kernel;
    - the projection: F x 512 x H;
    - the position convolution: F x H x (H / groups) x kernel;
    - each layer's four projections and the FFN: F x (4 H^2 + 2 H I);
    - each layer's attention: q k^T and the weights times v, 2 x F^2 x H;
    - the CTC head: F x H x vocabulary.
    LayerNorms, GELUs, softmaxes and biases are not counted."""
    lengths = conv_frames(cfg, samples)
    chans = [1] + list(cfg["conv_dim"])
    macs = sum(n * chans[i + 1] * chans[i] * k
               for i, (n, k) in enumerate(zip(lengths, cfg["conv_kernel"])))
    F = lengths[-1]
    H, inner = cfg["hidden_size"], cfg["intermediate_size"]
    K, groups = cfg["num_conv_pos_embeddings"], cfg["num_conv_pos_embedding_groups"]
    macs += F * chans[-1] * H
    macs += F * H * (H // groups) * K
    macs += cfg["num_hidden_layers"] * (F * (4 * H * H + 2 * H * inner) + 2 * F * F * H)
    macs += F * H * cfg["vocab_size"]
    return 2 * macs
