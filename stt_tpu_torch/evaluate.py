"""Test-set evaluation: logits and loss on the card, the beam decode on the
host, with emissions pruned on the card, or whole on the card (no LM), and
the WER/CER report (the counterpart of `stt_tpu.evaluate`).

Per batch: `make_eval_step` (the forward, whose LSTM runs the inference
kernel K1, and the CTC loss), a softmax that stays on the card, then the
decode of `--device_decode`:
  off    ctc_beam_search_decoder_batch on the host probabilities;
  prune  ctc_beam_search_decoder_batch_pruned (auto = prune);
  full   without a scorer, ctc_beam_search_decoder_device: the beam kernel
         K5 at --export_beam_width; with one, as prune.
The decode timer does not wait for the card: it holds the decode and
whatever of the batch's forward is still in flight when the decode starts.

With several processes (`--num_processes`, joined by the command line's
`config.maybe_initialize_distributed`) each rank takes every
num_processes-th test batch, and the corpus WER and CER merge over the
ranks' edit-distance counters (`parallel.distributed.merge_wer_counters`),
logged by rank 0.

Run: python -m stt_tpu_torch.evaluate --test_files ... --checkpoint_dir ...
     [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

import torch

from stt_tpu_torch import trace
from stt_tpu_torch.config import SttConfig, initialize_globals_from_cli, log_info
from stt_tpu_torch.data.feeding import create_batches
from stt_tpu_torch.decode import ctc_beam_search_decoder_batch
from stt_tpu_torch.decode.device import (
    ctc_beam_search_decoder_batch_pruned,
    ctc_beam_search_decoder_device,
)
from stt_tpu_torch.device import resolve_device
from stt_tpu_torch.evaluate_tools import (
    SampleResult,
    calculate_and_print_report,
    char_distance,
    process_decode_result,
    save_samples_json,
    word_distance,
)
from stt_tpu_torch.models import DeepSpeech
from stt_tpu_torch.parallel import distributed
from stt_tpu_torch.train.checkpoints import CheckpointManager, load_graph_for_evaluation
from stt_tpu_torch.train.step import create_train_state, make_eval_step


def load_model(config: SttConfig, device) -> DeepSpeech:
    """The checkpoint that `--load_evaluate` names (best, then last), on
    `device`."""
    state = create_train_state(config.model_config(training=False), device=device)
    manager = CheckpointManager(config.load_checkpoint_dir)
    state, method = load_graph_for_evaluation(manager, state, config.load_evaluate)
    log_info(f"Loaded '{method}' checkpoint for evaluation")
    return state.model


def decode_batch(config: SttConfig, probs: torch.Tensor, lengths: List[int], alphabet,
                 scorer=None):
    """One batch's softmax probabilities [B, T, C], where they lie, ->
    per-utterance DecodeResult lists, by `config.device_decode`."""
    num_processes = max(1, min(config.test_batch_size, os.cpu_count() or 1))
    mode = config.device_decode
    if mode == "auto":
        mode = "prune"
    if mode == "full" and scorer is None:
        # the whole per-frame expansion and prune, and the walk of the
        # backpointers, on the device; the host gets the chosen paths
        with trace.span("decode.batch"):
            return ctc_beam_search_decoder_device(
                probs, lengths, alphabet, beam_size=config.export_beam_width,
                cutoff_prob=config.cutoff_prob, cutoff_top_n=config.cutoff_top_n,
            )
    if mode in ("prune", "full"):
        # emission pruning on the device, beam and LM on the host
        return ctc_beam_search_decoder_batch_pruned(
            probs, lengths, alphabet, beam_size=config.export_beam_width,
            num_processes=num_processes, cutoff_prob=config.cutoff_prob,
            cutoff_top_n=config.cutoff_top_n, scorer=scorer,
        )
    return ctc_beam_search_decoder_batch(
        list(probs.cpu().numpy()), lengths, alphabet, beam_size=config.export_beam_width,
        num_processes=num_processes, cutoff_prob=config.cutoff_prob,
        cutoff_top_n=config.cutoff_top_n, scorer=scorer,
    )


def evaluate(
    config: SttConfig,
    model: Optional[DeepSpeech] = None,
    test_files: Optional[List[str]] = None,
    device="cuda",
) -> List[List[SampleResult]]:
    """Evaluate `model` (or the checkpoint in `config.load_checkpoint_dir`)
    on each test CSV: one list of SampleResult per CSV. Runs on the card
    unless the caller passes device="cpu"."""
    device = distributed.local_device(resolve_device(device))
    proc_id, proc_count = distributed.process_index(), distributed.process_count()
    alphabet = config.resolve_alphabet()
    feature_config = config.feature_config
    model = load_model(config, device) if model is None else model.to(device)

    scorer = None
    if config.scorer_path:
        from stt_tpu_torch.decode.scorer_package import KenLMScorer

        scorer = KenLMScorer(config.scorer_path, alpha=config.lm_alpha, beta=config.lm_beta)

    eval_step = make_eval_step()
    reports = []
    for test_csv in test_files or config.test_files:
        results: List[SampleResult] = []
        decode_walls: List[float] = []
        decode_audio_s = 0.0
        for batch_index, (batch, ids) in enumerate(create_batches(
            [test_csv], alphabet, feature_config, batch_size=config.test_batch_size,
            train_phase=False,
        )):
            if batch_index % proc_count != proc_id:  # another rank's batch
                continue
            lengths = batch.feature_lengths.tolist()
            losses, logits = eval_step(model, batch.to(device))
            probs = torch.softmax(logits, dim=-1)  # stays on the device
            decode_t0 = time.time()
            decoded = decode_batch(config, probs, lengths, alphabet, scorer)
            decode_walls.append(time.time() - decode_t0)
            decode_audio_s += sum(lengths) * (
                feature_config.step_samples / feature_config.sample_rate
            )
            losses = losses.cpu().tolist()
            for i, sample_id in enumerate(ids):
                src = alphabet.decode(batch.labels[i, : batch.label_lengths[i]].tolist())
                res = decoded[i][0].transcript
                results.append(process_decode_result(sample_id, src, res, losses[i]))
        calculate_and_print_report(
            results, dataset_name=test_csv, report_count=config.report_count
        )
        if decode_walls:
            log_info(decode_throughput(test_csv, config, decode_walls, decode_audio_s))
        if proc_count > 1:
            wd = wn = cd = cn = 0
            for r in results:
                d, n = word_distance(r.src, r.res)
                wd, wn = wd + d, wn + n
                d, n = char_distance(r.src, r.res)
                cd, cn = cd + d, cn + n
            wer, cer = distributed.merge_wer_counters(wd, wn, cd, cn)
            if proc_id == 0:
                log_info(f"All-hosts corpus on {test_csv} - WER: {wer:.6f}, CER: {cer:.6f}")
        reports.append(results)
    if config.test_output_file and reports:
        save_samples_json(
            [r for rs in reports for r in rs], config.test_output_file
        )
    return reports


def decode_throughput(test_csv: str, config: SttConfig, decode_walls: List[float],
                      decode_audio_s: float) -> str:
    """stt_tpu's decode-throughput log line, over every batch: each batch's
    time holds its decode and the forward work still in flight."""
    decode_wall = sum(decode_walls)
    return (
        f"Decode throughput on {test_csv}: "
        f"{decode_audio_s / decode_wall:.1f} audio-s/s "
        f"({decode_audio_s:.1f} audio-s in {decode_wall:.2f} s of decode and the forward "
        f"work in flight, mode={config.device_decode}, "
        f"beam={config.export_beam_width})"
    )


def main(argv=None):
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default="cuda")
    args, rest = parser.parse_known_args(argv)
    config = initialize_globals_from_cli(rest, device=args.device)
    if not config.test_files:
        print("--test_files is required", file=sys.stderr)
        sys.exit(1)
    evaluate(config, device=args.device)


if __name__ == "__main__":
    main()
