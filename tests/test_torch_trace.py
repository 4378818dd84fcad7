"""The port's tracer (`stt_tpu_torch.trace`) on the CPU: nothing recorded or
allocated without a profiler session; during one, spans with their parents,
threads, counters and `record_function` ranges, on a clock that maps onto
the profiler's; and the span tree of each instrumented path (a train step,
a batch device decode, a stream pool, a wav2vec2 batch transcription) at a
tiny size."""

import json
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stt_tpu_torch import trace
from stt_tpu_torch.alphabet import Alphabet
from stt_tpu_torch.artifact import build_metadata, save_artifact
from stt_tpu_torch.config import SttConfig
from stt_tpu_torch.evaluate import decode_batch
from stt_tpu_torch.evaluate_wav2vec2am import transcribe_batch
from stt_tpu_torch.frontend import FeatureConfig
from stt_tpu_torch.models import DeepSpeech, ModelConfig
from stt_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2CTC
from stt_tpu_torch.serve import Model, StreamPool
from stt_tpu_torch.train.step import Batch, create_train_state, make_train_step

LABELS = list(" abcdefghijklmnopqrstuvwxyz'")


@pytest.fixture(autouse=True)
def fresh():
    trace.reset()
    yield
    trace.reset()


def traced():
    return profile(activities=[ProfilerActivity.CPU])


def tree(spans) -> set:
    """(parent name, name) of every span."""
    return {(s.parent.name if s.parent is not None else None, s.name) for s in spans}


def test_off_records_and_allocates_nothing():
    assert not trace.enabled()
    assert trace.span("a") is trace.OFF and trace.begin("b", device=True) is trace.OFF

    def calls(n):
        for _ in range(n):
            with trace.span("x", device=True, k=1):
                trace.count("c", 3)
            trace.begin("y").close()

    calls(100)
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        calls(10000)
        after = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert after == before
    assert trace.spans() == [] and trace.anchor() is None


def test_nested_spans_take_their_parents_threads_and_counters():
    seen = {}

    def worker():
        with trace.span("worker.outer"):  # no span open on this thread
            with trace.span("worker.inner"):
                trace.count("n", 2)
                trace.count("n", 3)
        seen["tid"] = threading.get_ident()

    with traced():
        with trace.span("main.root", device=True, kind="test"):
            with trace.span("main.child"):
                trace.count("rows", 7)
                thread = threading.Thread(target=worker)
                thread.start()
                thread.join(timeout=30)
                assert not thread.is_alive()
            late = trace.begin("main.cross")
            closer = threading.Thread(target=late.close)
            closer.start()
            closer.join(timeout=30)
            assert not closer.is_alive()
    spans = {s.name: s for s in trace.spans()}
    assert tree(spans.values()) == {
        (None, "main.root"), ("main.root", "main.child"), ("main.child", "worker.outer"),
        ("worker.outer", "worker.inner"), ("main.root", "main.cross")}
    main = threading.get_ident()
    assert {s.name for s in spans.values() if s.tid == main} == {
        "main.root", "main.child", "main.cross"}
    assert spans["worker.outer"].tid == spans["worker.inner"].tid == seen["tid"]
    assert spans["worker.inner"].counters == {"n": 5}
    assert spans["main.child"].counters == {"rows": 7}
    assert spans["main.root"].attrs == {"kind": "test"}
    # no CUDA here: no marker, no launch counts
    assert spans["main.root"].marks is None and spans["main.root"].counters == {}
    for s in spans.values():
        if s.parent is not None:
            assert s.parent.start <= s.start and s.end <= s.parent.end
    assert not trace.enabled()


def test_a_span_around_mm_encloses_the_profilers_interval_after_the_anchor():
    a, b = torch.randn(256, 256), torch.randn(256, 256)
    with traced() as prof:
        time.sleep(0.002)
        with trace.span("matmul"):
            torch.mm(a, b)
        time.sleep(0.002)
    [mm] = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    start = mm.start_ns() if hasattr(mm, "start_ns") else mm.start_us() * 1000
    end = start + (mm.duration_ns() if hasattr(mm, "duration_ns") else mm.duration_us() * 1000)
    anchor = trace.anchor()
    now = {"time": time.time_ns(), "monotonic": time.monotonic_ns(),
           "perf": time.perf_counter_ns()}
    # the clock the profiler's trace is on: the one whose readings hold it
    clock = next(k for k in anchor if anchor[k] <= start <= now[k])
    offset = anchor[clock] - anchor["perf"]
    [span] = trace.spans()
    assert span.start + offset <= start and end <= span.end + offset
    assert end - start <= span.end - span.start


def test_record_function_ranges_carry_the_span_names(tmp_path):
    with traced() as prof:
        with trace.span("layer.outer"):
            with trace.span("layer.inner"):
                torch.ones(8) * 2
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = {e["name"]: e for e in events if e.get("name") in ("layer.outer", "layer.inner")}
    assert set(ranges) == {"layer.outer", "layer.inner"}
    outer, inner = ranges["layer.outer"], ranges["layer.inner"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


# -- the instrumented paths, tiny ---------------------------------------------


def _config():
    return ModelConfig(n_hidden=16, n_cell_dim=16, n_out=len(LABELS) + 1,
                       dropout_rates=(0.0,) * 6)


def _train():
    state = create_train_state(_config(), seed=1, device="cpu")
    rs = np.random.RandomState(0)
    batch = Batch(torch.as_tensor(rs.randn(2, 30, 26).astype(np.float32)),
                  torch.tensor([30, 24], dtype=torch.int32),
                  torch.as_tensor(rs.randint(0, len(LABELS), (2, 5)), dtype=torch.int32),
                  torch.tensor([5, 3], dtype=torch.int32))
    make_train_step()(state, batch, 0)


def _decode():
    alphabet = Alphabet().init_from_labels(LABELS)
    probs = torch.softmax(torch.randn(3, 20, len(LABELS) + 1, generator=torch.Generator()
                                      .manual_seed(2)) * 3, dim=-1)
    config = SttConfig(device_decode="full", export_beam_width=8, test_batch_size=3,
                       alphabet=alphabet)
    decoded = decode_batch(config, probs, [20, 15, 9], alphabet)
    assert len(decoded) == 3


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    alphabet = Alphabet().init_from_labels(LABELS)
    model = DeepSpeech(_config(), generator=torch.Generator().manual_seed(3))
    folder = str(tmp_path_factory.mktemp("traced") / "m")
    save_artifact(folder, model, build_metadata(model.config, FeatureConfig(), alphabet,
                                                beam_width=8), alphabet)
    return Model(folder, device="cpu")


def _pool(served):
    pool = StreamPool(served, max_streams=3, device_decode=True)
    streams = [pool.create_stream() for _ in range(2)]
    audio = (0.1 * np.sin(np.arange(16000) / 7.0)).astype(np.float32)
    for start in range(0, len(audio), 5120):  # 320 ms pieces, fed in step
        for stream in streams:
            stream.feed_audio_content(audio[start:start + 5120])
    # a chunk more for the second stream: the first one's finish forces its round
    streams[1].feed_audio_content(audio[:5120])
    for stream in streams:
        stream.finish_stream_with_metadata()


W2V2 = Wav2Vec2Config(conv_dim=(8,) * 7, hidden_size=16, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=32, num_conv_pos_embeddings=8,
                      num_conv_pos_embedding_groups=2)
W2V2_LENGTHS = [8000, 5000]


def _w2v2():
    torch.manual_seed(4)
    model = Wav2Vec2CTC(W2V2).eval()
    audio = 0.1 * torch.randn(2, 8000, generator=torch.Generator().manual_seed(5))
    labels = ["<pad>", "<s>", "</s>", "<unk>"] + list(" abcdefghijklmnopqrstuvwxyz'")
    out = transcribe_batch(model, audio, W2V2_LENGTHS, Alphabet().init_from_labels(labels),
                           blank_id=0, ignored_symbols=[1, 2, 3], beam_width=8)
    assert len(out.results) == 2


PATHS = {
    "train": (lambda served: _train(), {
        (None, "train.step"), ("train.step", "train.forward"), ("train.step", "ctc.loss"),
        ("train.step", "train.backward"), ("train.backward", "ctc.loss.bwd"),
        ("train.backward", "lstm.bwd"), ("train.step", "train.optim")}),
    "decode": (lambda served: _decode(), {
        (None, "decode.batch"), ("decode.batch", "decode.rebuild")}),
    "pool": (_pool, {(None, "pool.round"), ("pool.round", "pool.beam")}),
    "w2v2": (lambda served: _w2v2(), {
        (None, "w2v2.forward"), ("w2v2.forward", "w2v2.features"),
        ("w2v2.forward", "w2v2.attention"), (None, "decode.batch"),
        ("decode.batch", "decode.rebuild")}),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_an_untraced_path_records_no_span(path, served):
    PATHS[path][0](served)
    assert trace.spans() == [] and trace.anchor() is None


@pytest.mark.parametrize("path", sorted(PATHS))
def test_a_traced_path_emits_its_span_tree(path, served):
    run, want = PATHS[path]
    with traced():
        run(served)
    spans = trace.spans()
    assert tree(spans) == want
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    if path == "train":
        [bwd], [backward] = by_name["ctc.loss.bwd"], by_name["train.backward"]
        [lstm_bwd] = by_name["lstm.bwd"]
        # the loss's backward runs from its output's gradient to the
        # logits', before the recurrence's backward starts
        assert backward.start <= bwd.start and bwd.end <= lstm_bwd.start
    elif path == "decode":
        # the paths of 3 rows, one result each, over 20 frames: 3 x (3 + 2 x 20) int32
        [batch] = by_name["decode.batch"]
        assert batch.counters == {"decode.d2h_bytes": 3 * (3 + 2 * 20) * 4}
    elif path == "pool":
        rounds = by_name["pool.round"]
        assert all(r.counters["pool.slots"] == 3 for r in rounds)
        assert sum(r.counters["pool.slots_emitting"] for r in rounds) > 0
        assert all(r.counters["pool.slots_emitting"] <= 2 for r in rounds)
    elif path == "w2v2":
        # one forward of 2 rows padded to 8000 samples; a span per layer's attention
        [forward] = by_name["w2v2.forward"]
        frames = [int(W2V2.frames(n)) for n in W2V2_LENGTHS]
        assert forward.counters == {"w2v2.frames": 2 * frames[0],
                                    "w2v2.valid_frames": sum(frames)}
        assert len(by_name["w2v2.attention"]) == W2V2.num_hidden_layers
        [features] = by_name["w2v2.features"]
        assert features.end <= min(a.start for a in by_name["w2v2.attention"])


def test_a_new_session_drops_the_spans_of_the_last():
    with traced():
        with trace.span("first"):
            pass
    first = trace.anchor()
    with trace.span("between"):  # no session: the next span starts a new one
        pass
    assert [s.name for s in trace.spans()] == ["first"]
    with traced():
        with trace.span("second"):
            pass
    assert [s.name for s in trace.spans()] == ["second"]
    assert trace.anchor() is not first and trace.anchor()["perf"] > first["perf"]
