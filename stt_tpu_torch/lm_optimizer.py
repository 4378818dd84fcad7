"""LM hyperparameter search: the (lm_alpha, lm_beta) that minimize the WER
(or CER) on a test set (the counterpart of `stt_tpu.lm_optimizer`).

The acoustic model runs once, on the card (its LSTM in the inference
kernel K1), and every trial re-decodes the kept probabilities on the host
with the scorer at the trial's weights. The search is stt_tpu's: the
baseline at the config's weights, then `random.Random(4568)`'s uniform
draws for the first 70% of the trials and Gaussian steps around the best
for the rest, so both packages try the same (alpha, beta) pairs in the
same order.

Run: python -m stt_tpu_torch.lm_optimizer --test_files ... --checkpoint_dir ... \
       --scorer_path ... [--n_trials 30] [--lm_alpha_max 5] [--lm_beta_max 5] [--device cpu]
"""

from __future__ import annotations

import argparse
import random
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from stt_tpu_torch.config import SttConfig, initialize_globals_from_cli, log_info
from stt_tpu_torch.data.feeding import create_batches
from stt_tpu_torch.decode import ctc_beam_search_decoder_batch
from stt_tpu_torch.decode.scorer_package import KenLMScorer
from stt_tpu_torch.device import resolve_device
from stt_tpu_torch.evaluate import load_model
from stt_tpu_torch.models import DeepSpeech
from stt_tpu_torch.text import wer_cer_batch
from stt_tpu_torch.train.step import make_eval_step


def compute_lm_optimization(
    config: SttConfig,
    n_trials: int = 30,
    alpha_max: float = 5.0,
    beta_max: float = 5.0,
    use_cer: bool = False,
    model: Optional[DeepSpeech] = None,
    device="cuda",
) -> Tuple[float, float, float]:
    """Returns (best_alpha, best_beta, best_metric). `model` (else the
    checkpoint in `config.load_checkpoint_dir`) runs on the card unless
    device="cpu"."""
    device = resolve_device(device)
    alphabet = config.resolve_alphabet()
    model = load_model(config, device) if model is None else model.to(device)

    # run the acoustic model ONCE; trials only re-decode
    eval_step = make_eval_step()
    all_probs: List[np.ndarray] = []
    all_lengths: List[int] = []
    all_refs: List[str] = []
    for batch, ids in create_batches(
        config.test_files, alphabet, config.feature_config,
        batch_size=config.test_batch_size, train_phase=False,
    ):
        _, logits = eval_step(model, batch.to(device))
        probs = torch.softmax(logits, dim=-1).cpu().numpy()
        for i in range(len(ids)):
            all_probs.append(probs[i])
            all_lengths.append(int(batch.feature_lengths[i]))
            all_refs.append(alphabet.decode(batch.labels[i, : batch.label_lengths[i]].tolist()))

    scorer = KenLMScorer(config.scorer_path)

    def objective(alpha: float, beta: float) -> float:
        scorer.reset_params(alpha, beta)
        decoded = ctc_beam_search_decoder_batch(
            all_probs, all_lengths, alphabet,
            beam_size=config.export_beam_width,
            num_processes=max(1, config.test_batch_size),
            cutoff_prob=config.cutoff_prob,
            cutoff_top_n=config.cutoff_top_n,
            scorer=scorer,
        )
        hyps = [d[0].transcript for d in decoded]
        wer, cer = wer_cer_batch(all_refs, hyps)
        return cer if use_cer else wer

    rng = random.Random(4568)
    best = (config.lm_alpha, config.lm_beta, objective(config.lm_alpha, config.lm_beta))
    log_info(f"baseline alpha={best[0]:.4f} beta={best[1]:.4f} -> {best[2]:.4f}")
    explore = max(1, int(n_trials * 0.7))
    for trial in range(n_trials):
        if trial < explore:
            alpha = rng.uniform(0, alpha_max)
            beta = rng.uniform(0, beta_max)
        else:  # refine around the incumbent
            alpha = min(alpha_max, max(0.0, rng.gauss(best[0], alpha_max * 0.05)))
            beta = min(beta_max, max(0.0, rng.gauss(best[1], beta_max * 0.05)))
        metric = objective(alpha, beta)
        log_info(f"trial {trial}: alpha={alpha:.4f} beta={beta:.4f} -> {metric:.4f}")
        if metric < best[2]:
            best = (alpha, beta, metric)
    log_info(
        f"Best params: lm_alpha={best[0]:.6f} lm_beta={best[1]:.6f} "
        f"with {'CER' if use_cer else 'WER'}={best[2]:.6f}"
    )
    return best


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--n_trials", type=int, default=30)
    parser.add_argument("--lm_alpha_max", type=float, default=5.0)
    parser.add_argument("--lm_beta_max", type=float, default=5.0)
    parser.add_argument("--use_cer", action="store_true")
    parser.add_argument("--device", default="cuda")
    args, rest = parser.parse_known_args(argv)
    config = initialize_globals_from_cli(rest, device=args.device)
    if not (config.test_files and config.scorer_path):
        print("--test_files and --scorer_path are required", file=sys.stderr)
        sys.exit(1)
    compute_lm_optimization(
        config, args.n_trials, args.lm_alpha_max, args.lm_beta_max, args.use_cer,
        device=args.device,
    )


if __name__ == "__main__":
    main()
