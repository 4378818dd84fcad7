"""Batch transcription with wav2vec 2.0, as `evaluate_wav2vec2am` runs it
with --model_dir and no scorer: audio on the card ->
`evaluate_wav2vec2am.transcribe_batch` (each row normalised to -27 dBFS,
the port's forward `models.wav2vec2`, the log-softmax, K5's wide instance
at the mix's beam over 32 classes with the blank first and <s>, </s>,
<unk> ignored, the backtrace on the card) -> transcripts on the host.

The utterances take the mix's range of durations, are sorted by length
and cut into batches, as `batch.py` makes them; each batch's audio is made
on the card in set-up and every batch's shapes are warmed there. The window
transcribes the batches in turn. The comparison takes a sample of the
utterances, drawn from the seed with the longest among them, and holds
what the window's last pass over each one's batch computed against the
reference's run of the utterance alone: its log-probabilities on the
row's valid frames (`logit_gap`: the largest difference over the mean
spread of a frame's reference log-probabilities, the largest and the
smallest), and its transcript against the reference's float64 beam search
over the reference's emissions (`beam_gap`, `common.transcript_gap`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import generator
from port_bench.drivers import common
from port_bench.reference import beam as ref_beam
from port_bench.reference import wav2vec2 as ref

# The CPU tests' cut (tiny.py): 3 rows of 0.5-1.5 s in 2 batches, beam 8,
# the model 32 wide with 2 layers of 2 heads and 16 channels in the feature
# encoder; limits from CPU readings at that size.
TINY = {"traffic": dict(batch=3, seconds=[0.5, 1.5], batches=2, beam_width=8, sample=3,
                        logit_scale=100.0),
        "cfg": {"hidden_size": 32, "num_attention_heads": 2, "num_hidden_layers": 2,
                "intermediate_size": 64, "conv_dim": [16] * 7, "num_conv_pos_embeddings": 16,
                "num_conv_pos_embedding_groups": 2},
        "limits": {"logit_gap": 1e-4, "beam_gap": 1e-4}}


def _altered_rows(real):
    def transcribe_batch(*args, **kw):
        out = real(*args, **kw)
        return out._replace(results=[[common.altered_result(row[0])] + list(row[1:])
                                     if row else row for row in out.results])
    return transcribe_batch


def _pads_attended(real):
    def key_mask(frames, T):
        return torch.ones_like(real(frames, T))
    return key_mask


# The faults the CPU tests plant in the program, by name: (module,
# attribute, wrapper of the real one): a token altered at the entry the
# window calls, and attention over every frame of a padded row.
FAULTS = {"altered_token": ("stt_tpu_torch.evaluate_wav2vec2am", "transcribe_batch",
                            _altered_rows),
          "pads_attended": ("stt_tpu_torch.models.wav2vec2", "key_mask", _pads_attended)}


def labels(cfg: dict) -> list:
    """The model's labels in index order, its word separator "|" as a space."""
    by_index = sorted(cfg["vocab"].items(), key=lambda kv: kv[1])
    return [" " if token == "|" else token for token, _ in by_index]


def class_layout(cfg: dict) -> tuple:
    """(blank, ignored classes, the classes that spell, in order)."""
    blank = cfg["pad_token_id"]
    ignored = sorted(i for token, i in cfg["vocab"].items()
                     if token in ("<s>", "</s>", "<unk>") and i != blank)
    spelled = [c for c in range(cfg["vocab_size"]) if c != blank and c not in ignored]
    return blank, ignored, spelled


def _utterances(run):
    """(durations, samples) of every utterance, sorted by length."""
    t = run.traffic
    secs = np.sort(generator.durations(run.seed, t["batch"] * t["batches"], *t["seconds"],
                                       "batch"))
    return secs, generator.samples(secs, run.cfg["sample_rate"])


def _audio(run, lens, k: int, device) -> torch.Tensor:
    B = run.traffic["batch"]
    return generator.synth(run.seed, lens[k * B:(k + 1) * B], run.cfg["sample_rate"], device,
                           f"batch{k}")


def _weights(run, device) -> dict:
    """The mix's one served model, drawn from its `weights_seed`."""
    return ref.weights(run.cfg, run.traffic["weights_seed"], device, run.traffic["logit_scale"])


def _picked(run) -> list:
    secs, _ = _utterances(run)
    return common.sample(run.seed, len(secs), run.traffic["sample"], int(np.argmax(secs)))


def setup(run) -> dict:
    # the program's batch entry and forward; a tree without them fails here
    from stt_tpu_torch import evaluate_wav2vec2am
    from stt_tpu_torch.alphabet import Alphabet
    from stt_tpu_torch.models import wav2vec2

    t, cfg = run.traffic, run.cfg
    device = torch.device(run.device)
    B = t["batch"]
    secs, lens = _utterances(run)
    model = wav2vec2.build(wav2vec2.Wav2Vec2Config.from_dict(cfg), _weights(run, device),
                           device)
    blank, ignored, _ = class_layout(cfg)
    batches = []
    for k in range(t["batches"]):
        rows = slice(k * B, (k + 1) * B)
        batches.append({"audio": _audio(run, lens, k, device), "lengths": lens[rows].tolist(),
                        "audio_s": float(secs[rows].sum())})
    ctx = {"entry": evaluate_wav2vec2am, "model": model, "batches": batches,
           "alphabet": Alphabet().init_from_labels(labels(cfg)), "blank": blank,
           "ignored": ignored, "B": B, "picked": _picked(run),
           "results": [None] * len(batches), "log_probs": [None] * len(batches),
           "frames": [None] * len(batches)}
    for k in range(len(batches)):  # every batch's shapes, once
        _transcribe(run, ctx, k)
    run.sync()
    return ctx


def _transcribe(run, ctx, k: int) -> None:
    t, b = run.traffic, ctx["batches"][k]
    with run.span("w2v2.batch"):
        out = ctx["entry"].transcribe_batch(
            ctx["model"], b["audio"], b["lengths"], ctx["alphabet"], ctx["blank"],
            ctx["ignored"], t["beam_width"], cutoff_prob=t["cutoff_prob"],
            cutoff_top_n=t["cutoff_top_n"])
    ctx["results"][k] = [(list(r[0].tokens), float(r[0].confidence)) for r in out.results]
    ctx["log_probs"][k], ctx["frames"][k] = out.log_probs, out.frames


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
    whole = [done[i][0] for i, (_, end) in enumerate(done) if end <= deadline or run.trace]
    b, frames = ctx["batches"], ctx["frames"]
    run.records.update(
        window_start=start,
        window_end=done[len(whole) - 1][1] if whole else None,
        audio_s=sum(b[j]["audio_s"] for j in whole),
        frames=sum(int(frames[j].sum()) for j in whole),
        shapes=[(len(b[j]["lengths"]), int(b[j]["audio"].shape[1]), int(frames[j].sum()),
                 int(frames[j].max())) for j in whole],
        samples=[b[j]["lengths"] for j in whole],
        beam=run.traffic["beam_width"],
        attempted=len(whole) * run.traffic["batch"],
        failed=0,
    )


def release(ctx) -> None:
    """Keep, of the window's emissions, the sampled rows' valid frames on
    the host; drop the model and the batches."""
    B = ctx["B"]
    ctx["sampled"] = [ctx["log_probs"][i // B][i % B, :int(ctx["frames"][i // B][i % B])]
                      .double().cpu() for i in ctx["picked"]]
    for key in ("model", "batches", "log_probs"):
        ctx.pop(key, None)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


VARIANTS = ("tf32", "altered_token")  # the control, and a planted fault


def reference(run, ctx, variant=None) -> list:
    """The reference's run of each sampled utterance alone: {"log_probs"
    [T, C] float64 on the host, "best", "beam"} with the beam's labels in
    the model's classes; with "tf32", the control's."""
    device = torch.device(run.device)
    B = run.traffic["batch"]
    _, lens = _utterances(run)
    picked = _picked(run)
    audios = []
    for k in sorted({i // B for i in picked}):
        audio = _audio(run, lens, k, device).cpu().numpy()
        audios += [audio[i - k * B][:lens[i]] for i in picked if i // B == k]
    params = _weights(run, device)
    log_probs = ref.log_probs(params, audios, run.cfg, device, tf32=variant == "tf32")
    del params
    blank, _, spelled = class_layout(run.cfg)
    T = max(lp.shape[0] for lp in log_probs)
    probs = torch.zeros((len(audios), T, len(spelled) + 1), dtype=torch.float64, device=device)
    probs[..., -1] = 1.0
    for i, lp in enumerate(log_probs):  # the spelled classes, then the blank last
        probs[i, :lp.shape[0]] = torch.exp(lp[:, spelled + [blank]])
    found = ref_beam.search(probs, [lp.shape[0] for lp in log_probs], run.traffic["beam_width"])
    out = []
    for lp, r in zip(log_probs, found):
        def to_model(seq):
            return tuple(spelled[j] for j in seq)
        out.append({"log_probs": lp.cpu(), "best": (to_model(r["best"][0]), r["best"][1]),
                    "beam": {to_model(k): v for k, v in r["beam"].items()}})
    return out


def program(run, ctx) -> list:
    """(labels, confidence, log-probabilities) of each sampled utterance."""
    B = run.traffic["batch"]
    return [ctx["results"][i // B][i % B] + (lp,) for i, lp in zip(ctx["picked"], ctx["sampled"])]


def logit_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest difference of log-probabilities over the mean spread of
    a frame's reference log-probabilities (its largest less its smallest);
    infinity where the frame counts differ."""
    if got.shape != want.shape or not want.numel():
        return float("inf")
    spread = (want.max(dim=1).values - want.min(dim=1).values).mean()
    return float((got.double() - want).abs().max() / spread)


def numbers(got: list, want: list) -> dict:
    return {"logit_gap": max(logit_gap(g[2], w["log_probs"]) for g, w in zip(got, want)),
            "beam_gap": max(common.transcript_gap(g[:2], w) for g, w in zip(got, want))}


def variant(run, ctx, name: str, want: list) -> dict:
    """The compared numbers of the control ("tf32": the reference one
    precision below) or of a planted fault ("altered_token")."""
    if name == "tf32":
        served = [(list(r["best"][0]), r["best"][1], r["log_probs"])
                  for r in reference(run, ctx, "tf32")]
    else:
        got = program(run, ctx)
        served = [a + (g[2],) for a, g in zip(common.altered([g[:2] for g in got]), got)]
    return numbers(served, want)


def readings(run, ctx) -> dict:
    got, want = program(run, ctx), reference(run, ctx)
    common.report([g[:2] for g in got], want)
    return numbers(got, want)
