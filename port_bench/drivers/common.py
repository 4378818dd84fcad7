"""What the drivers share: the program's configuration objects made from a
configuration file, the model built from the benchmark's weights, and the
comparison of transcripts with the reference's beam search."""

from __future__ import annotations

import sys

import torch

from port_bench import generator
from port_bench.reference import beam as ref_beam
from port_bench.reference import model as ref


def program_config(cfg: dict):
    from stt_tpu_torch.models import ModelConfig

    return ModelConfig(n_input=cfg["n_input"], n_context=cfg["n_context"],
                       n_hidden=cfg["n_hidden"], n_cell_dim=cfg["n_cell_dim"],
                       n_out=cfg["n_out"], relu_clip=cfg["relu_clip"],
                       dropout_rates=tuple(cfg["dropout_rates"]), compute_dtype=cfg["dtype"])


def feature_config(feat: dict):
    from stt_tpu_torch.frontend import FeatureConfig

    return FeatureConfig(sample_rate=feat["sample_rate"], window_samples=feat["window_samples"],
                         step_samples=feat["step_samples"], n_mfcc=feat["n_mfcc"],
                         n_mels=feat["n_mels"], lower_frequency_hz=feat["lower_hz"])


def alphabet(cfg: dict):
    from stt_tpu_torch.alphabet import Alphabet, UTF8Alphabet

    if cfg["bytes_output_mode"]:
        return UTF8Alphabet()
    return Alphabet().init_from_labels(list(cfg["alphabet"]))


def program_model(run, device):
    """The program's DeepSpeech holding the benchmark's weights."""
    from stt_tpu_torch.models import DeepSpeech

    model = DeepSpeech(program_config(run.cfg), device=device)
    model.load_state_dict(weights(run, device))
    return model


def mask_frames(mfcc: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
    """Zero every frame at or past a row's count of full windows, as the
    input pipeline pads each utterance's own features."""
    t = torch.arange(mfcc.shape[1], device=mfcc.device)[None, :, None]
    return torch.where(t < frames[:, None, None], mfcc, torch.zeros_like(mfcc))


def weights(run, device) -> dict:
    """The mix's model: a serving mix serves one model, drawn from its own
    `weights_seed` whatever the run's seed (as a deployment serves one
    released model); a training mix (`weights_seed` null) starts each run
    from an initialization drawn from the run's seed."""
    seed = run.traffic["weights_seed"]
    return generator.weights(run.cfg, run.seed if seed is None else seed, device,
                             run.traffic["logit_scale"])


def reference_search(run, audios, device, tf32: bool = False) -> list:
    """The reference's beam search over each utterance's whole audio:
    MFCC, the forward and the softmax, then the prefix beam search."""
    cfg = run.cfg
    frames = max(int(generator.frames(len(a), cfg["features"])) for a in audios)
    feats, lengths = ref.features(audios, cfg["features"], frames, device)
    probs = ref.probabilities(weights(run, device), feats, lengths, cfg, tf32)
    return ref_beam.search(probs, lengths.numpy(), run.traffic["beam_width"])


def transcript_gap(got: tuple, want: dict) -> float:
    """How far a served transcript lies from the reference's beam: the gap
    between its confidence and the reference's score of the same labels,
    plus how far that score lies below the reference's best, in nats over
    the best's magnitude, or over 1 where that is smaller (a transcript
    all but certain has a score of ~0, whose float32 rounding alone would
    be a large share of it). A transcript that is not in the reference's
    final beam reads infinity."""
    labels, confidence = got
    best = want["best"][1]
    score = want["beam"].get(tuple(labels))
    if score is None:
        return float("inf")
    return (abs(confidence - score) + (best - score)) / max(abs(best), 1.0)


def numbers(got: list, want: list) -> dict:
    return {"beam_gap": max(transcript_gap(g, w) for g, w in zip(got, want))}


def report(got: list, want: list) -> None:
    """One line a compared transcript on standard error: what the gap is
    made of."""
    for i, (g, w) in enumerate(zip(got, want)):
        print(f"transcript {i}: {len(g[0])} labels, confidence {g[1]!r}, reference score "
              f"{w['beam'].get(tuple(g[0]))!r}, reference best {w['best'][1]!r} "
              f"({len(w['best'][0])} labels)", file=sys.stderr)


def sample(seed: int, n: int, k: int, longest: int) -> list:
    """k indices of n drawn from the seed, with `longest` among them."""
    pick = generator.rng(seed, "sample").choice(n, size=min(k, n), replace=False).tolist()
    if longest not in pick:
        pick[-1] = longest
    return sorted(pick)


def altered_result(result):
    """A program's DecodeResult with its first label changed to its
    neighbour (label ^ 1): the fault of a token altered where it is
    produced, planted in the program by a driver's FAULTS."""
    if not result.tokens:
        return result
    return result._replace(tokens=[result.tokens[0] ^ 1] + list(result.tokens[1:]))


def as_served(results: list) -> list:
    """A reference's results in the program's form, (labels, confidence)."""
    return [(list(r["best"][0]), r["best"][1]) for r in results]


def altered(results: list) -> list:
    """The fault of a token altered where it is produced: each transcript's
    first label changed to its neighbour (label ^ 1), or one label added."""
    return [([labels[0] ^ 1] + labels[1:] if labels else [0], conf)
            for labels, conf in results]


def variant_numbers(drv, run, ctx, name: str, want: list) -> dict:
    """The compared numbers of the control ("tf32": the reference one
    precision below) or of a planted fault ("altered_token")."""
    if name == "tf32":
        return numbers(as_served(drv.reference(run, ctx, "tf32")), want)
    return numbers(altered(drv.program(run, ctx)), want)
