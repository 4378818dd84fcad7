"""Training from cached features through `make_train_step()`.

Set-up computes every utterance's MFCC on the card with the program's
frontend (the trainer's --feature_cache after its first epoch), builds the
model from the benchmark's weights and one Adam over it, and drives that
state through its first `compare_steps` steps, on batches whose rows all
differ; those steps also warm every shape. The window goes on stepping
the same state over the batches in turn, without waiting for the card.

The comparison follows those first steps with the plain reference (see
reference/model.py): each step's loss, the first gradient as Adam holds it
after one step (its first moment over 1 - beta1), and the parameters'
change after the last, each by leaf as the gap between the program's norm
and the reference's, over the larger of the reference leaf's norm and the
median leaf's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import generator
from port_bench.drivers.common import feature_config, mask_frames, program_model, weights
from port_bench.reference import model as ref

BETA1 = 0.9

# The CPU tests' cut (tiny.py): batch, durations and padding cut so that a
# run takes seconds, the model 32 wide. The limits from CPU readings at
# these sizes: the program's loss, first-gradient and change gaps read
# 1e-7, 1.4e-5 and 4.4e-5 against the control's (the reference with TF32
# operands) 1.0e-5, 3.5e-4 and 1.3e-3.
TINY = {"traffic": dict(batch=4, seconds=[1.0, 1.4], pad_frames=70, reference_rows=2),
        "cfg": {"n_hidden": 32, "n_cell_dim": 32},
        "limits": {"loss_gap": 2e-6, "grad_gap": 1e-4, "change_gap": 3e-4}}


def _unchanged(real):
    """A step that returns its state unchanged."""
    def update(state, batch, seed):
        kept = [p.detach().clone() for p in state.model.parameters()]
        metrics = real(state, batch, seed)
        with torch.no_grad():
            for p, k in zip(state.model.parameters(), kept):
                p.copy_(k)
        return metrics
    return update


def _half_batch(real):
    """A step over half of the batch, the mean taken over the rest."""
    def update(state, batch, seed):
        rows = batch.features.shape[0] // 2
        return real(state, type(batch)(*(t[:rows] for t in batch)), seed)
    return update


# The faults the CPU tests plant in the program, by name: (module,
# attribute, wrapper of the real one).
FAULTS = {"unchanged": ("stt_tpu_torch.train.step", "_update", _unchanged),
          "half_batch": ("stt_tpu_torch.train.step", "_update", _half_batch)}


def _batches(run, device) -> tuple:
    """The mix's batches: (audio lengths [n], transcripts, durations) and
    for each batch the seed purpose of its audio."""
    t, feat = run.traffic, run.cfg["features"]
    n = t["batch"] * t["distinct_batches"]
    secs = generator.durations(run.seed, n, *t["seconds"], "train")
    lens = generator.samples(secs, feat["sample_rate"])
    labels = generator.transcripts(run.seed, secs, t["chars_per_second"],
                                   run.cfg["n_out"] - 1, "labels")
    return secs, lens, labels


def _audio(run, lens, k: int, device) -> torch.Tensor:
    B = run.traffic["batch"]
    return generator.synth(run.seed, lens[k * B:(k + 1) * B], run.cfg["features"]["sample_rate"],
                           device, f"train{k}")


def setup(run) -> dict:
    from stt_tpu_torch.frontend import audio_to_mfcc
    from stt_tpu_torch.train.step import Batch, create_train_state, make_train_step

    t, cfg, feat = run.traffic, run.cfg, run.cfg["features"]
    device = torch.device(run.device)
    B, pad = t["batch"], t["pad_frames"]
    secs, lens, labels = _batches(run, device)
    frames = generator.frames(lens, feat)
    if frames.max() > pad:
        raise ValueError(f"utterances of {frames.max()} frames exceed pad_frames {pad}")
    label_pad = max(len(l) for l in labels)
    fc = feature_config(feat)
    batches, audio_s = [], []
    for k in range(t["distinct_batches"]):
        rows = slice(k * B, (k + 1) * B)
        with torch.no_grad():
            mfcc = audio_to_mfcc(_audio(run, lens, k, device), fc)[:, :pad]
            valid = torch.as_tensor(frames[rows], device=device)
            mfcc = mask_frames(mfcc, valid)
            feats = torch.zeros((B, pad, feat["n_mfcc"]), device=device)
            feats[:, :mfcc.shape[1]] = mfcc
        lab = np.zeros((B, label_pad), np.int32)
        for i, l in enumerate(labels[rows]):
            lab[i, :len(l)] = l
        batches.append(Batch(feats, valid.to(torch.int32),
                             torch.as_tensor(lab, device=device),
                             torch.as_tensor([len(l) for l in labels[rows]], dtype=torch.int32,
                                             device=device)))
        audio_s.append(float(secs[rows].sum()))
    model = program_model(run, device)
    state = create_train_state(model.config, device=device, model=model,
                               learning_rate=cfg["learning_rate"])
    step = make_train_step()
    losses, grad_norms = [], None
    for k in range(t["compare_steps"]):
        state, metrics = step(state, batches[k % len(batches)], run.seed)
        losses.append(float(metrics.loss))
        if k == 0:
            grad_norms = {name: float(state.optimizer.state[p]["exp_avg"].norm() / (1 - BETA1))
                          for name, p in state.model.named_parameters()}
    with torch.no_grad():
        start = weights(run, device)
        change_norms = {name: float((p - start[name]).norm())
                        for name, p in state.model.named_parameters()}
        del start
    run.sync()
    return {"state": state, "step": step, "batches": batches, "audio_s": audio_s,
            "frames": [int(frames[k * B:(k + 1) * B].sum()) for k in range(len(batches))],
            "program": {"losses": losses, "grad": grad_norms, "change": change_norms}}


def window(run, ctx, seconds: float) -> None:
    state, step, batches = ctx["state"], ctx["step"], ctx["batches"]
    k = run.traffic["compare_steps"]
    issued, marks, flags = [], [], []
    run.sync()
    start_host = time.perf_counter()
    start = run.marker()
    deadline = start_host + seconds
    while time.perf_counter() < deadline:
        b = k % len(batches)
        with run.span("train.step"):
            state, metrics = step(state, batches[b], run.seed)
        marks.append(run.marker())
        issued.append(b)
        flags.append(metrics.non_finite)
        k += 1
    ends = run.times(start, start_host, marks)
    # whole steps: those the card had finished by the window's end
    whole = [i for i, e in enumerate(ends) if e <= deadline] if not run.trace else list(range(len(ends)))
    run.records.update(
        window_start=start_host,
        window_end=ends[whole[-1]] if whole else None,
        audio_s=sum(ctx["audio_s"][issued[i]] for i in whole),
        frames=sum(ctx["frames"][issued[i]] for i in whole),
        steps=len(whole),
        batch=run.traffic["batch"],
        attempted=len(whole) * run.traffic["batch"],
        failed=int(sum(int(flags[i].sum()) for i in whole)),
        valid_steps=[ctx["frames"][issued[i]] for i in whole],
        pad_frames=run.traffic["pad_frames"],
    )


def release(ctx) -> None:
    for key in ("state", "step", "batches"):
        ctx.pop(key, None)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_batches(run, device) -> list:
    """The first steps' batches, made again from the seed, featurized by
    the reference: [(feats, lengths, labels)]."""
    t, feat = run.traffic, run.cfg["features"]
    B = t["batch"]
    _, lens, labels = _batches(run, device)
    out = []
    for k in range(t["compare_steps"]):
        audio = _audio(run, lens, k, device).cpu().numpy()
        rows = range(k * B, (k + 1) * B)
        audios = [audio[i][:lens[r]] for i, r in enumerate(rows)]
        feats, lengths = ref.features(audios, feat, t["pad_frames"], device)
        out.append((feats, lengths, [labels[r] for r in rows]))
    return out


VARIANTS = ("tf32", "half_batch")  # the control, and a fault planted in the reference


def reference(run, ctx, variant=None) -> dict:
    """The reference's losses, first gradient and change after the first
    steps; with a variant, those of the control (TF32 operands) or of the
    fault that leaves half of each batch out and takes the mean over the
    rest."""
    device = torch.device(run.device)
    B = run.traffic["batch"]
    rows = slice(0, B // 2) if variant == "half_batch" else slice(None)
    batches = [(f[rows], l[rows], lab[rows]) for f, l, lab in reference_batches(run, device)]
    params0 = weights(run, device)
    out = ref.train(params0, batches, run.cfg, run.cfg["learning_rate"], tf32=variant == "tf32",
                    block=run.traffic["reference_rows"])
    return {"losses": out["losses"],
            "grad": {k: float(v.norm()) for k, v in out["grad"].items()},
            "change": {k: float(v.norm()) for k, v in out["change"].items()}}


def program(run, ctx) -> dict:
    return ctx["program"]


def numbers(got: dict, want: dict) -> dict:
    """The compared numbers of `got` against the reference's `want`.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's move under Adam by round-off alone and are left out of the
    change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    g_med = float(np.median(list(want["grad"].values())))
    grad = max(abs(got["grad"][k] - w) / max(w, g_med) for k, w in want["grad"].items())
    moved = [k for k, w in want["grad"].items() if w >= 1e-3 * g_med]
    c_med = float(np.median([want["change"][k] for k in moved]))
    change = max(abs(got["change"][k] - want["change"][k]) / max(want["change"][k], c_med)
                 for k in moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def variant(run, ctx, name: str, want: dict) -> dict:
    """The compared numbers of the control or of the planted fault."""
    return numbers(reference(run, ctx, name), want)


def readings(run, ctx) -> dict:
    return numbers(program(run, ctx), reference(run, ctx))
