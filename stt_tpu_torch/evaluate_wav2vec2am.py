"""Evaluate a wav2vec2-style CTC acoustic model with the framework's
decoder + scorer (the counterpart of `stt_tpu.evaluate_wav2vec2am`, a
copy of its host code).

The reference runs an ONNX wav2vec2 AM (onnxruntime, not in this build)
whose directory carries a config.json with alphabet_labels / blank_id /
ignored_symbols, then decodes with
ctc_beam_search_decoder_for_wav2vec2am. Here emissions come from either:

  --emissions_dir  precomputed per-wav <stem>.npy [T, n_labels] log-prob
                   or prob matrices (the offline path), or
  --model_dir      a local HuggingFace Wav2Vec2ForCTC checkpoint (the
                   stable-layer-norm layout of the large LV-60 models),
                   run by the port's own forward (`models.wav2vec2`) on
                   the card unless the caller passes the CPU; weights
                   must already be on disk.

Decoding behavior matches the reference: AM labels absent from the
scorer alphabet are added to ignored_symbols (evaluate_wav2vec2am.py
EvaluationPool.init), audio is RMS-normalized to -27 dBFS and truncated
at 250k samples before inference. Without a scorer the batch decodes
in the beam kernel K5 (`decode.device`), on the card unless the caller
passes device="cpu" (`--device cpu`). With --model_dir and no scorer the
test set is sorted by length and cut into batches of --test_batch_size
(`transcribe_batch`): audio, emissions and the decode's backpointers
stay on the device, and only the chosen paths come to the host.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import random
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from stt_tpu_torch import trace
from stt_tpu_torch.alphabet import Alphabet
from stt_tpu_torch.decode import DecodeResult, ctc_beam_search_decoder_for_wav2vec2am
from stt_tpu_torch.decode.device import ctc_beam_search_decoder_device
from stt_tpu_torch.device import resolve_device
from stt_tpu_torch.evaluate_tools import calculate_and_print_report, process_decode_result
from stt_tpu_torch.models.wav2vec2 import Wav2Vec2CTC, load_wav2vec2
from stt_tpu_torch.text import wer_cer_batch

MAX_INPUT_SAMPLES = 250000
RMS_DB = -27.0


def rms_normalize(wav: np.ndarray, db_level: float = RMS_DB) -> np.ndarray:
    r = 10 ** (db_level / 20)
    energy = np.sum(wav**2)
    if energy <= 0:
        return wav
    return wav * np.sqrt((len(wav) * (r**2)) / energy)


def rms_normalize_rows(audio: torch.Tensor, lengths: torch.Tensor,
                       db_level: float = RMS_DB) -> torch.Tensor:
    """`rms_normalize` of each row's first lengths[i] samples, where the
    batch lies; samples past a row's length become 0."""
    valid = torch.arange(audio.shape[1], device=audio.device)[None, :] < lengths[:, None]
    audio = torch.where(valid, audio, torch.zeros_like(audio))
    energy = (audio * audio).sum(dim=1)
    target = lengths.to(audio.dtype) * (10 ** (db_level / 20)) ** 2
    scale = torch.where(energy > 0, torch.sqrt(target / energy), torch.ones_like(energy))
    return audio * scale[:, None]


class BatchTranscripts(NamedTuple):
    results: List[List[DecodeResult]]  # per row, its num_results best
    log_probs: torch.Tensor  # [B, T, C] emissions, where the model ran
    frames: np.ndarray  # [B] valid frames of each row


def transcribe_batch(model: Wav2Vec2CTC, audio: torch.Tensor, lengths: Sequence[int],
                     alphabet: Alphabet, blank_id: int = 0, ignored_symbols: Sequence[int] = (),
                     beam_width: int = 500, cutoff_prob: float = 1.0, cutoff_top_n: int = 40,
                     num_results: int = 1) -> BatchTranscripts:
    """A batch of utterances, audio [B, S] float32 on the model's device
    with lengths[i] valid samples in row i, -> transcripts, without a
    language model: each row truncated at MAX_INPUT_SAMPLES and normalised
    to -27 dBFS over its samples, the forward, the log-softmax, and the
    beam search of `decode.device` (K5 and the backtrace on the card) over
    the emissions where they lie. Only the chosen paths reach the host."""
    lengths = torch.as_tensor(np.minimum(np.asarray(lengths, np.int64), MAX_INPUT_SAMPLES))
    on_device = lengths.to(audio.device)  # first: a wait here finds the device idle
    with torch.no_grad():
        audio = rms_normalize_rows(audio[:, :MAX_INPUT_SAMPLES].float(), on_device)
        logits, frames = model(audio, lengths)
        log_probs = torch.log_softmax(logits, dim=-1)
        frames = frames.numpy()
        with trace.span("decode.batch"):
            results = ctc_beam_search_decoder_device(
                log_probs.exp(), frames, alphabet, beam_size=beam_width,
                cutoff_prob=cutoff_prob, cutoff_top_n=cutoff_top_n, num_results=num_results,
                blank_id=blank_id, ignored_symbols=ignored_symbols)
    return BatchTranscripts(results, log_probs, frames)


def load_am_config(model_dir: str) -> dict:
    """alphabet_labels / blank_id / ignored_symbols from the AM dir.
    Accepts the reference's config.json contract directly, or derives the
    labels from a HuggingFace vocab.json (| -> space, <pad> = blank)."""
    with open(os.path.join(model_dir, "config.json"), encoding="utf-8") as f:
        config = json.load(f)
    if "alphabet_labels" in config:
        return {
            "alphabet_labels": config["alphabet_labels"],
            "blank_id": config.get("blank_id", 0),
            "ignored_symbols": set(config.get("ignored_symbols", ())),
        }
    vocab_path = os.path.join(model_dir, "vocab.json")
    if not os.path.isfile(vocab_path):
        raise FileNotFoundError(
            f"{model_dir}: neither alphabet_labels in config.json nor a "
            "HuggingFace vocab.json found"
        )
    with open(vocab_path, encoding="utf-8") as f:
        vocab: Dict[str, int] = json.load(f)
    labels = [""] * len(vocab)
    ignored = set()
    blank_id = config.get("pad_token_id", 0)
    for token, idx in vocab.items():
        if token == "|":
            labels[idx] = " "
        elif token in ("<pad>", "<s>", "</s>", "<unk>"):
            labels[idx] = token
            if idx != blank_id:
                ignored.add(idx)
        else:
            labels[idx] = token
    return {
        "alphabet_labels": labels,
        "blank_id": blank_id,
        "ignored_symbols": ignored,
    }


def read_csv_entries(csv_files: Sequence[str]):
    entries = []
    for path in csv_files:
        base = os.path.dirname(os.path.abspath(path))
        with open(path, newline="", encoding="utf-8") as f:
            for row in csv.DictReader(f):
                wav = row["wav_filename"]
                if not os.path.isabs(wav):
                    wav = os.path.join(base, wav)
                entries.append((wav, row.get("transcript", "")))
    return entries


def collect_emissions_precomputed(emissions_dir: str, wav_filenames):
    emissions = []
    for wav in wav_filenames:
        stem = os.path.splitext(os.path.basename(wav))[0]
        path = os.path.join(emissions_dir, stem + ".npy")
        emissions.append(np.load(path))
    return emissions


def _read_inputs(wav_filenames) -> List[np.ndarray]:
    """Each file's samples at 16 kHz, float32, truncated at MAX_INPUT_SAMPLES."""
    from stt_tpu_torch.data.audio import read_audio

    return [read_audio(wav, desired_rate=16000)[0][:MAX_INPUT_SAMPLES].astype(np.float32)
            for wav in wav_filenames]


def collect_emissions_torch(model_dir: str, wav_filenames, device="cuda"):
    """Run the checkpoint in `model_dir` (`load_wav2vec2`) on `device` (the
    onnxruntime replacement), one file at a time; each file's emissions
    [T, C] log-probabilities come back as numpy."""
    device = resolve_device(device)
    model = load_wav2vec2(model_dir, device)
    emissions = []
    with torch.no_grad():
        for audio in _read_inputs(wav_filenames):
            audio = rms_normalize(audio)
            logits, frames = model(torch.from_numpy(audio)[None].to(device), [len(audio)])
            emissions.append(torch.log_softmax(logits[0, :int(frames[0])].float(), dim=-1)
                             .cpu().numpy())
    return emissions


def transcribe_files(model_dir: str, wav_filenames, alphabet: Alphabet, blank_id: int,
                     ignored_symbols: Sequence[int], beam_width: int, batch_size: int,
                     num_results: int = 1, dump_emissions: Optional[str] = None,
                     device="cuda") -> List[str]:
    """The checkpoint's transcripts of the files, in their order, without a
    language model: sorted by length, cut into batches of `batch_size`,
    each through `transcribe_batch` on `device`. With `dump_emissions`,
    each file's emissions are saved there as <stem>.npy."""
    device = resolve_device(device)
    model = load_wav2vec2(model_dir, device)
    audios = _read_inputs(wav_filenames)
    order = sorted(range(len(audios)), key=lambda i: len(audios[i]))
    transcripts = [""] * len(audios)
    for start in range(0, len(order), max(1, batch_size)):
        rows = order[start:start + max(1, batch_size)]
        lengths = [len(audios[i]) for i in rows]
        batch = np.zeros((len(rows), max(lengths)), np.float32)
        for j, i in enumerate(rows):
            batch[j, :lengths[j]] = audios[i]
        out = transcribe_batch(model, torch.from_numpy(batch).to(device), lengths, alphabet,
                               blank_id, ignored_symbols, beam_width, num_results=num_results)
        for j, i in enumerate(rows):
            transcripts[i] = out.results[j][0].transcript
            if dump_emissions:
                stem = os.path.splitext(os.path.basename(wav_filenames[i]))[0]
                np.save(os.path.join(dump_emissions, stem + ".npy"),
                        out.log_probs[j, :out.frames[j]].cpu().numpy())
    return transcripts


def build_decode_inputs(model_dir: str,
                        scorer_path: Optional[str] = None,
                        scorer_alphabet_path: Optional[str] = None):
    am = load_am_config(model_dir)
    am_alphabet = Alphabet().init_from_labels(am["alphabet_labels"])
    ignored = set(am["ignored_symbols"])
    scorer = None
    scorer_alphabet = am_alphabet
    if scorer_path:
        from stt_tpu_torch.decode.scorer_package import KenLMScorer

        if not scorer_alphabet_path:
            raise ValueError("--scorer_alphabet is required with --scorer")
        scorer_alphabet = Alphabet(scorer_alphabet_path)
        scorer = KenLMScorer(scorer_path)
        scorer_labels = set(scorer_alphabet.labels)
        for idx, label in enumerate(am["alphabet_labels"]):
            if label not in scorer_labels:
                ignored.add(idx)
    return am_alphabet, scorer_alphabet, scorer, ignored, am["blank_id"]


def evaluate_wav2vec2am(
    csv_files: Sequence[str],
    model_dir: str,
    emissions_dir: Optional[str] = None,
    scorer_path: Optional[str] = None,
    scorer_alphabet_path: Optional[str] = None,
    beam_width: int = 500,
    lm_alpha: Optional[float] = None,
    lm_beta: Optional[float] = None,
    num_results: int = 1,
    dump_emissions: Optional[str] = None,
    device="cuda",
    test_batch_size: int = 1,
) -> list:
    entries = read_csv_entries(csv_files)
    wavs = [e[0] for e in entries]
    alphabet, scorer_alphabet, scorer, ignored, blank_id = (
        build_decode_inputs(model_dir, scorer_path, scorer_alphabet_path)
    )
    if dump_emissions:
        os.makedirs(dump_emissions, exist_ok=True)
    if scorer is None and not emissions_dir:
        # the model and the decode in batches on the device
        transcripts = transcribe_files(model_dir, wavs, scorer_alphabet, blank_id,
                                       sorted(ignored), beam_width, test_batch_size,
                                       num_results, dump_emissions, device)
        return [process_decode_result(wav, truth, transcript, 0.0)
                for (wav, truth), transcript in zip(entries, transcripts)]
    if emissions_dir:
        emissions = collect_emissions_precomputed(emissions_dir, wavs)
    else:
        emissions = collect_emissions_torch(model_dir, wavs, device)
    if dump_emissions:
        for wav, em in zip(wavs, emissions):
            stem = os.path.splitext(os.path.basename(wav))[0]
            np.save(os.path.join(dump_emissions, stem + ".npy"), em)
    if scorer is not None and lm_alpha is not None and lm_beta is not None:
        scorer.reset_params(lm_alpha, lm_beta)

    results = []
    if scorer is None:
        # no LM: token remap is identity, so the whole batch decodes on
        # the device in the beam kernel (decode/device.py, wav2vec2
        # class layout via blank_id/ignored_symbols)
        probs_batch = [
            np.exp(e) if e.min() < 0 else e for _, e in zip(entries, emissions)
        ]
        decoded_batch = ctc_beam_search_decoder_device(
            probs_batch,
            [p.shape[0] for p in probs_batch],
            scorer_alphabet,
            beam_size=beam_width,
            num_results=num_results,
            blank_id=blank_id,
            ignored_symbols=sorted(ignored),
            device=device,
        )
        for (wav, truth), decoded in zip(entries, decoded_batch):
            results.append(
                process_decode_result(wav, truth, decoded[0].transcript, 0.0)
            )
        return results
    for (wav, truth), emission in zip(entries, emissions):
        probs = np.exp(emission) if emission.min() < 0 else emission
        decoded = ctc_beam_search_decoder_for_wav2vec2am(
            probs, scorer_alphabet, beam_width, blank_id,
            am_alphabet=alphabet, ignored_symbols=sorted(ignored),
            scorer=scorer, num_results=num_results,
        )
        results.append(
            process_decode_result(wav, truth, decoded[0].transcript, 0.0)
        )
    calculate_and_print_report(results, dataset_name=",".join(csv_files))
    return results


def compute_lm_optimization_wav2vec2am(
    csv_files: Sequence[str],
    model_dir: str,
    scorer_path: str,
    scorer_alphabet_path: str,
    emissions_dir: Optional[str] = None,
    beam_width: int = 500,
    n_trials: int = 30,
    alpha_max: float = 5.0,
    beta_max: float = 5.0,
    device="cuda",
):
    """(alpha, beta) search over cached emissions (parity:
    util/lm_optimize_wav2vec2am.py) — the AM runs once, on `device`."""
    entries = read_csv_entries(csv_files)
    wavs = [e[0] for e in entries]
    refs = [e[1] for e in entries]
    if emissions_dir:
        emissions = collect_emissions_precomputed(emissions_dir, wavs)
    else:
        emissions = collect_emissions_torch(model_dir, wavs, device)
    alphabet, scorer_alphabet, scorer, ignored, blank_id = (
        build_decode_inputs(model_dir, scorer_path, scorer_alphabet_path)
    )

    def objective(alpha: float, beta: float) -> float:
        scorer.reset_params(alpha, beta)
        hyps = []
        for emission in emissions:
            probs = np.exp(emission) if emission.min() < 0 else emission
            decoded = ctc_beam_search_decoder_for_wav2vec2am(
                probs, scorer_alphabet, beam_width, blank_id,
                am_alphabet=alphabet, ignored_symbols=sorted(ignored),
                scorer=scorer,
            )
            hyps.append(decoded[0].transcript)
        wer, _ = wer_cer_batch(refs, hyps)
        return wer

    rng = random.Random(4568)
    best = (scorer.alpha, scorer.beta, objective(scorer.alpha, scorer.beta))
    explore = max(1, int(n_trials * 0.7))
    for trial in range(n_trials):
        if trial < explore:
            alpha, beta = rng.uniform(0, alpha_max), rng.uniform(0, beta_max)
        else:
            alpha = min(alpha_max, max(0.0, rng.gauss(best[0], alpha_max * 0.05)))
            beta = min(beta_max, max(0.0, rng.gauss(best[1], beta_max * 0.05)))
        metric = objective(alpha, beta)
        print(f"trial {trial}: alpha={alpha:.4f} beta={beta:.4f} -> {metric:.4f}")
        if metric < best[2]:
            best = (alpha, beta, metric)
    print(
        f"Best params: lm_alpha={best[0]:.6f} lm_beta={best[1]:.6f} "
        f"WER={best[2]:.6f}"
    )
    return best


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model_dir", required=True,
                        help="AM dir with config.json (+ weights or vocab)")
    parser.add_argument("--csv_files", required=True,
                        help="comma-separated test CSVs")
    parser.add_argument("--emissions_dir",
                        help="precomputed per-wav .npy emissions")
    parser.add_argument("--dump_emissions",
                        help="save computed emissions here for reuse")
    parser.add_argument("--scorer")
    parser.add_argument("--scorer_alphabet")
    parser.add_argument("--beam_width", type=int, default=500)
    parser.add_argument("--lm_alpha", type=float)
    parser.add_argument("--lm_beta", type=float)
    parser.add_argument("--optimize_lm", action="store_true",
                        help="search (alpha, beta) instead of evaluating once")
    parser.add_argument("--n_trials", type=int, default=30)
    parser.add_argument("--test_output_file",
                        help="write per-sample JSON results here")
    parser.add_argument("--test_batch_size", type=int, default=1,
                        help="utterances a batch of the model and the decode (--model_dir "
                             "without a scorer)")
    parser.add_argument("--device", default="cuda",
                        help="where the acoustic model (--model_dir without --emissions_dir) and the "
             "no-scorer batch decode run (cuda or cpu)")
    args = parser.parse_args(argv)
    csv_files = args.csv_files.split(",")
    if args.optimize_lm:
        compute_lm_optimization_wav2vec2am(
            csv_files, args.model_dir, args.scorer, args.scorer_alphabet,
            emissions_dir=args.emissions_dir, beam_width=args.beam_width,
            n_trials=args.n_trials, device=args.device,
        )
        return
    results = evaluate_wav2vec2am(
        csv_files, args.model_dir, emissions_dir=args.emissions_dir,
        scorer_path=args.scorer, scorer_alphabet_path=args.scorer_alphabet,
        beam_width=args.beam_width, lm_alpha=args.lm_alpha,
        lm_beta=args.lm_beta, dump_emissions=args.dump_emissions, device=args.device,
        test_batch_size=args.test_batch_size,
    )
    if args.test_output_file:
        from stt_tpu_torch.evaluate_tools import save_samples_json

        save_samples_json(results, args.test_output_file)


if __name__ == "__main__":
    main()
