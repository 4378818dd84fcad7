"""What the wav2vec 2.0 cell adds to the benchmark: the hand count of
`w2v2.mfu`'s operations, the parameters of its configuration, the readers
of the program's `w2v2.*` spans and counters against a hand-made trace,
that its fixed arithmetic imports nothing of the program, and that the
DeepSpeech cells' runs load nothing of the wav2vec2 path."""

import json
import math
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from port_bench import generator, harness, spans, yardstick_w2v2
from port_bench.reference import wav2vec2 as ref
from port_bench.test_pb_imports import _imports
from port_bench.test_pb_spans import ANCHOR, BASE, marker, ms, span
from stt_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2CTC

CFG = generator.load_json("configs", "w2v2-large-lv60")


def test_operations_of_an_utterance_by_hand():
    # 15 s at 16 kHz: the convolutions' frames
    lengths = yardstick_w2v2.conv_frames(CFG, 240_000)
    assert lengths == [47_999, 23_999, 11_999, 5_999, 2_999, 1_499, 749]
    F = 749
    convs = (47_999 * 512 * 10 + 23_999 * 512 * 512 * 3 + 11_999 * 512 * 512 * 3
             + 5_999 * 512 * 512 * 3 + 2_999 * 512 * 512 * 3 + 1_499 * 512 * 512 * 2
             + 749 * 512 * 512 * 2)
    projection = F * 512 * 1024
    position = F * 1024 * 64 * 128
    layers = 24 * F * (4 * 1024 ** 2 + 2 * 1024 * 4096)
    attention = 24 * 2 * F * F * 1024
    head = F * 1024 * 32
    want = 2 * (convs + projection + position + layers + attention + head)
    assert yardstick_w2v2.forward_flops(CFG, 240_000) == want
    # per frame: the encoder ~98 MFLOP, the projection 1.05, the position
    # convolution 16.8, the layers' GEMMs 604, attention 0.098 T
    assert 2 * convs / F == pytest.approx(98.2e6, rel=2e-3)
    assert 2 * projection / F == 1_048_576
    assert 2 * position / F == 16_777_216
    assert 2 * layers / F == 603_979_776
    assert 2 * attention / F / F == 98_304
    # ~770 MFLOP a frame at 500 frames
    n = 500 * 320 + 80
    assert yardstick_w2v2.conv_frames(CFG, n)[-1] == 500
    assert yardstick_w2v2.forward_flops(CFG, n) / 500 == pytest.approx(770e6, rel=0.02)


def test_too_short_an_utterance_counts_nothing():
    assert yardstick_w2v2.conv_frames(CFG, 399)[-1] == 0
    assert yardstick_w2v2.forward_flops(CFG, 0) == 0


def test_parameters_are_counted_from_the_shapes():
    shapes = ref.shapes(CFG)
    total = sum(math.prod(s) for s in shapes.values())
    assert total == CFG["params"] == 315_470_496
    # the module's own count
    with torch.device("meta"):
        model = Wav2Vec2CTC(Wav2Vec2Config.from_dict(CFG))
    assert sum(p.numel() for p in model.parameters()) == total
    assert set(model.state_dict()) == set(shapes)


def test_the_fixed_arithmetic_imports_nothing_of_the_program():
    assert "stt_tpu_torch" not in _imports(yardstick_w2v2.__file__)
    assert "stt_tpu_torch" not in _imports(os.path.join(harness.HERE, "metrics", "w2v2.mfu.py"))


# One forward (ms): its markers (0, 5), the feature encoder's (1, 2), one
# attention block's (3, 4); a convolution in the encoder, attention in its
# block, an FFN after it, each 40 ms.
OPS = [marker(100), marker(101), ("conv", ms(110), ms(150)), marker(160), marker(170),
       ("attn", ms(180), ms(220)), marker(230), ("ffn", ms(240), ms(280)), marker(300)]


def forward_spans():
    fwd = span("w2v2.forward", ms(99.995), ms(299.985), marks=(0, 5),
               launched=(ms(99.99), ms(299.99)), **{"w2v2.frames": 1000,
                                                    "w2v2.valid_frames": 880})
    return [fwd,
            span("w2v2.features", ms(100.995), ms(159.985), fwd, marks=(1, 2),
                 launched=(ms(100.99), ms(159.99))),
            span("w2v2.attention", ms(169.995), ms(229.985), fwd, marks=(3, 4),
                 launched=(ms(169.99), ms(229.99)))]


def traced(monkeypatch, raw):
    monkeypatch.setattr(spans, "recorded", lambda: (raw, ANCHOR) if raw else None)
    data = {"intervals": [(n, BASE + s, BASE + e) for n, s, e in OPS],
            "lo": BASE, "hi": BASE + ms(1000)}
    return SimpleNamespace(trace_data=data)


@pytest.mark.parametrize("metric,want", [("w2v2.features_share", 100 * 40 / 120),
                                         ("w2v2.attn_share", 100 * 40 / 120),
                                         ("w2v2.pad_share", 100 * (1 - 880 / 1000))])
def test_span_readers_by_hand(monkeypatch, metric, want):
    run = traced(monkeypatch, forward_spans())
    assert harness.load_metric(metric).read(run) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["w2v2.features_share", "w2v2.attn_share", "w2v2.pad_share"])
def test_span_readers_read_nothing_without_the_spans(monkeypatch, metric):
    assert harness.load_metric(metric).read(traced(monkeypatch, [])) is None


SCRIPT = """
import json, sys, time
sys.path.insert(0, {root!r})
from port_bench import harness, tiny
for cell in {cells!r}:
    run = tiny.run(cell, seconds=0.3)
    run.records["started"] = time.perf_counter()
    drv, ctx = harness.measure(run)
    drv.release(ctx)
loaded = [m for m in sys.modules if m.split(".")[0] == "transformers"
          or m in ("stt_tpu_torch.models.wav2vec2", "stt_tpu_torch.evaluate_wav2vec2am")]
print(json.dumps(loaded))
"""


def test_the_deepspeech_cells_load_nothing_of_the_wav2vec2_path():
    cells = [w["name"] for w in harness.manifest()["workloads"]
             if w["config"] != "w2v2-large-lv60"]
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=harness.ROOT, cells=cells)],
                         capture_output=True, text=True, timeout=600, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
