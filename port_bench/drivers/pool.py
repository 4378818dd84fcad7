"""Live streams through one `StreamPool` with device decoding: S streams fed
in step on one clock of `piece_seconds`, as a gateway forwards its callers'
audio, each stream finished (`finish_stream_with_metadata`) with its last
piece and replaced at once by the next caller. The pieces are due on the
clock whether or not the pool has kept up: an open loop.

Set-up makes a bank of utterances (the mix's range of durations) on the
card, serves the benchmark's weights through the program's artifact and
`Model`, and runs `warmup_ticks` of the same traffic without waiting, so
that every shape, the flush and the decode have run. The window then keeps
the cadence, and `drain_ticks` more ticks after it let the pieces due in
the window complete.

What the harness observes: each round's slot modes (the pool's public
`fused_round(chunks, mode)`, copied to the host without waiting), and a
CUDA event after every call of the harness that fired a round. A stream's
first round primes it (mode 1); its (j + 1)-th emits the frames of its
piece j, whose work is then complete when that round's work is; pieces
that no round emits are emitted by the flush, complete when the finish
returns.
"""

from __future__ import annotations

import shutil
import tempfile
import sys
import time

import numpy as np
import torch

from port_bench import generator
from port_bench.drivers import common

# The CPU tests' cut (tiny.py): streams, bank, beam and durations cut so
# that a run takes seconds, the model 32 wide; the logit scale and the
# limit as the batch mix's (drivers/batch.py).
TINY = {"traffic": dict(streams=3, seconds=[0.5, 1.5], bank=8, beam_width=8, warmup_ticks=6,
                        sample=3, logit_scale=100.0),
        "cfg": {"n_hidden": 32, "n_cell_dim": 32},
        "limits": {"beam_gap": 1e-4}}


def _altered_results(real):
    def rebuild_results(*args, **kw):
        return [common.altered_result(r) for r in real(*args, **kw)]
    return rebuild_results


# The faults the CPU tests plant in the program, by name: (module,
# attribute, wrapper of the real one). The pool's device decoder walks each
# finished stream's backpointers on the host.
FAULTS = {"altered_token": ("stt_tpu_torch.decode.device", "rebuild_results", _altered_results)}


def _bank(run) -> tuple:
    t, feat = run.traffic, run.cfg["features"]
    secs = generator.durations(run.seed, t["bank"], *t["seconds"], "pool")
    return secs, generator.samples(secs, feat["sample_rate"])


def bank_audio(run, device) -> list:
    _, lens = _bank(run)
    audio = generator.synth(run.seed, lens, run.cfg["features"]["sample_rate"], device, "pool")
    return [a[:n] for a, n in zip(audio.cpu().numpy(), lens)]


def serving_model(run, device):
    """The program's `Model` over an artifact of the benchmark's weights,
    written by the program and removed once loaded."""
    from stt_tpu_torch.artifact import build_metadata, save_artifact
    from stt_tpu_torch.serve.model import Model

    cfg, beam = run.cfg, run.traffic["beam_width"]
    alphabet = common.alphabet(cfg)
    model = common.program_model(run, device)
    folder = tempfile.mkdtemp(prefix="port_bench_model_")
    try:
        save_artifact(folder, model, build_metadata(
            model.config, common.feature_config(cfg["features"]), alphabet, beam_width=beam),
            alphabet)
        del model
        served = Model(folder, device=str(device))
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    served.set_model_beam_width(beam)
    return served


class Stream:
    def __init__(self, handle, slot: int, index: int, audio: np.ndarray, piece: int,
                 created_round: int):
        self.handle, self.slot, self.index = handle, slot, index
        self.pieces = [audio[i:i + piece] for i in range(0, len(audio), piece)]
        self.due: list = []  # each fed piece's due time
        self.created_round = created_round
        self.finished_round = None
        self.final = None  # (due of the last piece, host time the finish returned)
        self.result = None  # (labels, confidence)


def setup(run) -> dict:
    from stt_tpu_torch.serve.pool import StreamPool

    t = run.traffic
    device = torch.device(run.device)
    served = serving_model(run, device)
    pool = StreamPool(served, max_streams=t["streams"], device_decode=True)
    ctx = {"pool": pool, "model": served, "bank": bank_audio(run, device),
           "piece": int(round(t["piece_seconds"] * run.cfg["features"]["sample_rate"])),
           "modes": [], "calls": [], "streams": [], "next": 0}
    inner = pool.fused_round

    def observed(chunks, mode):
        held = torch.empty(mode.shape, dtype=mode.dtype, pin_memory=mode.is_cuda)
        held.copy_(mode, non_blocking=True)
        ctx["modes"].append(held)
        return inner(chunks, mode)

    pool.fused_round = observed
    ctx["live"] = [_start(ctx, q) for q in range(t["streams"])]
    for _ in range(t["warmup_ticks"]):
        _tick(run, ctx, time.perf_counter(), counted=False)
    run.sync()
    return ctx


def _start(ctx, slot: int) -> Stream:
    index = ctx["next"]
    ctx["next"] += 1
    audio = ctx["bank"][index % len(ctx["bank"])]
    stream = Stream(ctx["pool"].create_stream(), slot, index, audio, ctx["piece"],
                    len(ctx["modes"]))
    ctx["streams"].append(stream)
    return stream


def _call(run, ctx, name: str, fn):
    """fn() inside a span; if it fired rounds, a marker of their completion
    on the card (for a finish, which returns host results, its return)."""
    before = len(ctx["modes"])
    start = time.perf_counter()
    with run.span(name):
        out = fn()
    if len(ctx["modes"]) > before:
        mark = run.marker() if name == "pool.feed" else time.perf_counter()
        ctx["calls"].append((before, len(ctx["modes"]), start, mark))
    return out


def _tick(run, ctx, due: float, counted: bool) -> None:
    alphabet = ctx["model"].alphabet
    for q, stream in enumerate(ctx["live"]):
        piece = stream.pieces[len(stream.due)]
        _call(run, ctx, "pool.feed", lambda: stream.handle.feed_audio_content(piece))
        stream.due.append(due if counted else None)
        if len(stream.due) == len(stream.pieces):
            meta = _call(run, ctx, "pool.finish",
                         lambda: stream.handle.finish_stream_with_metadata(1))
            stream.finished_round = len(ctx["modes"])
            best = meta.transcripts[0]
            stream.result = ([alphabet.encode(tok.text)[0] for tok in best.tokens],
                             float(best.confidence))
            stream.final = (due if counted else None, time.perf_counter())
            ctx["live"][q] = _start(ctx, q)


def window(run, ctx, seconds: float) -> None:
    t = run.traffic
    tick = t["piece_seconds"]
    run.sync()
    start_host = time.perf_counter()
    start = run.marker()
    deadline = start_host + seconds
    late, k = [], 0
    while True:
        due = start_host + k * tick
        if due >= deadline + t["drain_ticks"] * tick:
            break
        wait = due - time.perf_counter()
        if wait > 0:
            with run.span("pool.wait"):
                time.sleep(wait)
        late.append(time.perf_counter() - due)
        _tick(run, ctx, due, counted=due < deadline)
        k += 1
    run.sync()
    _account(run, ctx, start, start_host, deadline, late)


def _account(run, ctx, start, start_host, deadline, late) -> None:
    modes = [m.numpy() for m in ctx["modes"]]
    done_at, begun_at = [None] * len(modes), [None] * len(modes)
    events = [c[3] for c in ctx["calls"] if not isinstance(c[3], float)]
    when = iter(run.times(start, start_host, events) if run.is_cuda else [])
    for first, end, call_start, mark in ctx["calls"]:
        t = mark if isinstance(mark, float) else next(when)
        for r in range(first, end):
            done_at[r], begun_at[r] = t, call_start
    inside = [r for r in range(len(modes)) if begun_at[r] is not None and begun_at[r] >= start_host]
    feat = run.cfg["features"]
    pieces, finals, flush_frames, flush_calls = [], [], 0, 0
    for stream in ctx["streams"]:
        last = stream.finished_round if stream.finished_round is not None else len(modes)
        joined = [r for r in range(stream.created_round, last) if modes[r][stream.slot] >= 1]
        if joined and (modes[joined[0]][stream.slot] != 1
                       or any(modes[r][stream.slot] != 2 for r in joined[1:])):
            raise RuntimeError(f"stream {stream.index}: its rounds do not prime then emit in "
                               f"slot {stream.slot}; the pool's slots are not those assumed")
        for j, due in enumerate(stream.due):
            if due is None or due >= deadline:
                continue
            if j + 1 < len(joined):
                pieces.append((due, done_at[joined[j + 1]] - due))
            elif stream.final is not None:
                pieces.append((due, stream.final[1] - due))
            else:
                pieces.append((due, None))  # not served by the window's end
        if stream.final is None or stream.final[1] < start_host:
            continue
        if stream.final[0] is not None and stream.final[0] < deadline:
            finals.append(stream.final[1] - stream.final[0])
        total = int(generator.frames(sum(len(p) for p in stream.pieces), feat))
        rest = max(0, total - 16 * (len(joined) - 1))
        flush_frames += rest
        flush_calls += -(-rest // 16)
    emits = sum(int((modes[r] == 2).sum()) for r in inside)
    served = [p for p in pieces if p[1] is not None]
    run.records.update(
        window_start=start_host, window_end=deadline,
        piece_latencies=[p[1] for p in served], piece_dues=[p[0] for p in served],
        final_latencies=finals,
        round_seconds=[done_at[r] - begun_at[r] for r in inside],
        lateness=late, emitted_frames=16 * emits + flush_frames,
        beam_calls=emits + flush_calls, beam=run.traffic["beam_width"],
        streams=run.traffic["streams"],
        attempted=len(pieces), failed=len(pieces) - len(served),
    )


def release(ctx) -> None:
    for key in ("pool", "model", "modes"):
        ctx.pop(key, None)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _picked(run, ctx) -> list:
    done = [s for s in ctx["streams"] if s.final is not None and s.final[0] is not None]
    longest = int(np.argmax([len(ctx["bank"][s.index % len(ctx["bank"])]) for s in done]))
    return [done[i] for i in common.sample(run.seed, len(done), run.traffic["sample"], longest)]


VARIANTS = ("tf32", "altered_token")  # the control, and a planted fault


def reference(run, ctx, variant=None) -> list:
    bank = ctx["bank"]
    audios = [bank[s.index % len(bank)] for s in _picked(run, ctx)]
    return common.reference_search(run, audios, torch.device(run.device), tf32=variant == "tf32")


def program(run, ctx) -> list:
    return [s.result for s in _picked(run, ctx)]


numbers = common.numbers


def variant(run, ctx, name: str, want: list) -> dict:
    return common.variant_numbers(sys.modules[__name__], run, ctx, name, want)


def readings(run, ctx) -> dict:
    got, want = program(run, ctx), reference(run, ctx)
    common.report(got, want)
    return numbers(got, want)

