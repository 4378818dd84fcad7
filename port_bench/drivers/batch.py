"""Batch transcription, as `evaluate` runs it with --device_decode full and
no scorer: audio on the card -> the program's MFCC -> the acoustic model
(K1) -> softmax -> `evaluate.decode_batch` (the beam kernel K5 at the
mix's beam, then the backtrace of its backpointers on the card) ->
transcripts on the host.

The utterances take the mix's range of durations, are sorted by length
and cut into batches, as evaluate batches a test set; each batch's audio is
made on the card in set-up and every batch's shapes are warmed there. The
window transcribes the batches in turn. The comparison takes a sample of
the utterances, drawn from the seed with the longest among them, and holds
each transcript of the window's last pass over its batch against the
reference's beam search over the same audio.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from port_bench import generator
from port_bench.drivers import common

# The CPU tests' cut (tiny.py): batches, beam and durations cut so that a
# run takes seconds, the model 32 wide. The mix's logit scale (1000) is set
# for the full widths: at 32 wide it gives the program readings up to 8e-4,
# where 100 gives 3e-7 to 3e-6 against the control's 5e-3 and above.
TINY = {"traffic": dict(batch=3, seconds=[0.5, 1.5], batches=2, beam_width=8, sample=3,
                        logit_scale=100.0),
        "cfg": {"n_hidden": 32, "n_cell_dim": 32},
        "limits": {"beam_gap": 1e-4}}


def _altered_rows(real):
    def decode_batch(*args, **kw):
        return [[common.altered_result(row[0])] + list(row[1:]) if row else row
                for row in real(*args, **kw)]
    return decode_batch


# The faults the CPU tests plant in the program, by name: (module,
# attribute, wrapper of the real one). The token is altered at the entry
# the window calls, so the fault bites whatever runs below it.
FAULTS = {"altered_token": ("stt_tpu_torch.evaluate", "decode_batch", _altered_rows)}


def _utterances(run):
    """(durations, samples) of every utterance, sorted by length."""
    t, feat = run.traffic, run.cfg["features"]
    secs = np.sort(generator.durations(run.seed, t["batch"] * t["batches"], *t["seconds"],
                                       "batch"))
    return secs, generator.samples(secs, feat["sample_rate"])


def _audio(run, lens, k: int, device) -> torch.Tensor:
    B = run.traffic["batch"]
    return generator.synth(run.seed, lens[k * B:(k + 1) * B], run.cfg["features"]["sample_rate"],
                           device, f"batch{k}")


def setup(run) -> dict:
    from stt_tpu_torch.config import SttConfig

    t, cfg = run.traffic, run.cfg
    device = torch.device(run.device)
    B = t["batch"]
    secs, lens = _utterances(run)
    frames = generator.frames(lens, cfg["features"])
    alphabet = common.alphabet(cfg)
    stt = SttConfig(device_decode="full", export_beam_width=t["beam_width"],
                    cutoff_prob=t["cutoff_prob"], cutoff_top_n=t["cutoff_top_n"],
                    test_batch_size=B, bytes_output_mode=cfg["bytes_output_mode"],
                    alphabet=alphabet)
    batches = []
    for k in range(t["batches"]):
        rows = slice(k * B, (k + 1) * B)
        batches.append({"audio": _audio(run, lens, k, device),
                        "frames": torch.as_tensor(frames[rows], device=device),
                        "lengths": frames[rows].tolist(),
                        "audio_s": float(secs[rows].sum())})
    ctx = {"model": common.program_model(run, device),
           "fc": common.feature_config(cfg["features"]), "stt": stt, "alphabet": alphabet,
           "batches": batches, "results": [None] * len(batches)}
    for k in range(len(batches)):  # every batch's shapes, once
        _transcribe(run, ctx, k)
    run.sync()
    return ctx


def _transcribe(run, ctx, k: int) -> None:
    from stt_tpu_torch.evaluate import decode_batch
    from stt_tpu_torch.frontend import audio_to_mfcc

    b = ctx["batches"][k]
    with run.span("batch.forward"), torch.no_grad():
        mfcc = common.mask_frames(audio_to_mfcc(b["audio"], ctx["fc"]), b["frames"])
        logits, _ = ctx["model"](mfcc, seq_len=b["frames"].to(torch.int32))
        probs = torch.softmax(logits, dim=-1)
    with run.span("batch.decode"):
        decoded = decode_batch(ctx["stt"], probs, b["lengths"], ctx["alphabet"])
    ctx["results"][k] = [(list(r[0].tokens), float(r[0].confidence)) for r in decoded]


def window(run, ctx, seconds: float) -> None:
    n = len(ctx["batches"])
    done = []
    run.sync()
    start = time.perf_counter()
    deadline = start + seconds
    k = 0
    while time.perf_counter() < deadline:
        _transcribe(run, ctx, k % n)
        done.append((k % n, time.perf_counter()))
        k += 1
    whole = [i for i, (_, end) in enumerate(done) if end <= deadline or run.trace]
    b = ctx["batches"]
    run.records.update(
        window_start=start,
        window_end=done[whole[-1]][1] if whole else None,
        audio_s=sum(b[done[i][0]]["audio_s"] for i in whole),
        frames=sum(sum(b[done[i][0]]["lengths"]) for i in whole),
        shapes=[(len(b[done[i][0]]["lengths"]), int(b[done[i][0]]["audio"].shape[1]),
                 sum(b[done[i][0]]["lengths"]), max(b[done[i][0]]["lengths"])) for i in whole],
        beam=run.traffic["beam_width"],
        attempted=len(whole) * run.traffic["batch"],
        failed=0,
    )


def release(ctx) -> None:
    for key in ("model", "batches"):
        ctx.pop(key, None)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _picked(run) -> list:
    secs, _ = _utterances(run)
    return common.sample(run.seed, len(secs), run.traffic["sample"], int(np.argmax(secs)))


VARIANTS = ("tf32", "altered_token")  # the control, and a planted fault


def reference(run, ctx, variant=None) -> list:
    """The reference's beam search over the sampled utterances; with
    "tf32", the control's."""
    device = torch.device(run.device)
    B = run.traffic["batch"]
    _, lens = _utterances(run)
    picked = _picked(run)
    audios = []
    for k in sorted({i // B for i in picked}):
        audio = _audio(run, lens, k, device).cpu().numpy()
        audios += [audio[i - k * B][:lens[i]] for i in picked if i // B == k]
    return common.reference_search(run, audios, device, tf32=variant == "tf32")


def program(run, ctx) -> list:
    B = run.traffic["batch"]
    return [ctx["results"][i // B][i % B] for i in _picked(run)]


numbers = common.numbers


def variant(run, ctx, name: str, want: list) -> dict:
    return common.variant_numbers(sys.modules[__name__], run, ctx, name, want)


def readings(run, ctx) -> dict:
    got, want = program(run, ctx), reference(run, ctx)
    common.report(got, want)
    return numbers(got, want)
