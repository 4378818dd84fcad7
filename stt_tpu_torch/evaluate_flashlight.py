"""Evaluate a checkpoint with the flashlight-style decoders (the
counterpart of `stt_tpu.evaluate_flashlight`): the acoustic pass of
`evaluate` on the card (its LSTM in the inference kernel K1), decoded on
the host by the lexicon or lexicon-free beam decoder
(`decode.flashlight`) with a word-level KenLM instead of the
character-level prefix search.

Run:
  python -m stt_tpu_torch.evaluate_flashlight --test_files t.csv \
    --checkpoint_dir ckpt --alphabet_config_path alphabet.txt \
    --scorer_path lm.scorer [--decoder_type lexicon|lexicon_free] \
    [--vocab_file words.txt] [--beam_size 64] [--lm_weight 1.0] \
    [--word_score 0.0] [--one_shot_infer utt.wav] [--device cpu]
"""

from __future__ import annotations

import sys
from typing import List, Optional

import torch

from stt_tpu_torch.config import SttConfig, parse_flags
from stt_tpu_torch.data.feeding import create_batches
from stt_tpu_torch.decode.flashlight import flashlight_beam_search_decoder
from stt_tpu_torch.device import resolve_device
from stt_tpu_torch.evaluate import load_model
from stt_tpu_torch.evaluate_tools import (
    calculate_and_print_report,
    process_decode_result,
    save_samples_json,
)
from stt_tpu_torch.models import DeepSpeech
from stt_tpu_torch.train.step import make_eval_step


def _result_text(result, alphabet, decoder_type: str) -> str:
    """Lexicon results carry words; lexicon-free results carry collapsed
    token ids."""
    if decoder_type == "lexicon":
        return " ".join(result.words)
    return alphabet.decode(result.tokens).strip()


def _scorer(config: SttConfig):
    if not config.scorer_path:
        return None
    from stt_tpu_torch.decode.scorer_package import KenLMScorer

    return KenLMScorer(config.scorer_path)


def evaluate_flashlight(
    config: SttConfig,
    decoder_type: str = "lexicon",
    vocabulary: Optional[List[str]] = None,
    beam_size: int = 64,
    lm_weight: float = 1.0,
    word_score: float = 0.0,
    model: Optional[DeepSpeech] = None,
    device="cuda",
) -> List[List]:
    """One list of SampleResult per test CSV. `model` (else the checkpoint
    in `config.load_checkpoint_dir`) runs on the card unless device="cpu"."""
    device = resolve_device(device)
    alphabet = config.resolve_alphabet()
    model = load_model(config, device) if model is None else model.to(device)
    scorer = _scorer(config)
    if scorer is None and decoder_type == "lexicon" and vocabulary is None:
        raise ValueError(
            "lexicon decoding needs --scorer_path (vocabulary FST) or "
            "--vocab_file"
        )

    eval_step = make_eval_step()
    reports = []
    for test_csv in config.test_files:
        results = []
        for batch, ids in create_batches(
            [test_csv], alphabet, config.feature_config,
            batch_size=config.test_batch_size, train_phase=False,
        ):
            losses, logits = eval_step(model, batch.to(device))
            log_probs = torch.log_softmax(logits, dim=-1).cpu().numpy()
            losses = losses.cpu().tolist()
            for i, sample_id in enumerate(ids):
                decoded = flashlight_beam_search_decoder(
                    log_probs[i, : int(batch.feature_lengths[i])], alphabet, scorer,
                    vocabulary=vocabulary, decoder_type=decoder_type,
                    beam_size=beam_size, lm_weight=lm_weight,
                    word_score=word_score,
                )
                src = alphabet.decode(batch.labels[i, : batch.label_lengths[i]].tolist())
                res = _result_text(decoded[0], alphabet, decoder_type) if decoded else ""
                results.append(process_decode_result(sample_id, src, res, losses[i]))
        calculate_and_print_report(
            results, dataset_name=f"{test_csv} [flashlight/{decoder_type}]",
            report_count=config.report_count,
        )
        reports.append(results)
    if config.test_output_file and reports:
        save_samples_json(
            [r for rs in reports for r in rs], config.test_output_file
        )
    return reports


def one_shot_infer(config: SttConfig, wav_path: str, decoder_type: str = "lexicon",
                   beam_size: int = 64, vocabulary: Optional[List[str]] = None,
                   device="cuda") -> str:
    """The flashlight decode of one file by the checkpoint, featurized on
    the card (unless device="cpu")."""
    from stt_tpu_torch.data.audio import read_audio
    from stt_tpu_torch.frontend import audio_to_mfcc

    device = resolve_device(device)
    alphabet = config.resolve_alphabet()
    model = load_model(config, device)
    audio, _ = read_audio(wav_path, desired_rate=config.feature_config.sample_rate)
    feats = audio_to_mfcc(torch.from_numpy(audio).to(device), config.feature_config)
    seq = torch.tensor([feats.shape[0]], dtype=torch.int32, device=device)
    with torch.no_grad():
        logits, _ = model(feats[None], seq_len=seq)
    log_probs = torch.log_softmax(logits[0], dim=-1).cpu().numpy()
    decoded = flashlight_beam_search_decoder(
        log_probs, alphabet, _scorer(config), vocabulary=vocabulary,
        decoder_type=decoder_type, beam_size=beam_size,
    )
    text = _result_text(decoded[0], alphabet, decoder_type) if decoded else ""
    print(text)
    return text


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)

    def take(flag, default=None):
        if flag in argv:
            i = argv.index(flag)
            value = argv[i + 1]
            del argv[i : i + 2]
            return value
        return default

    decoder_type = take("--decoder_type", "lexicon")
    vocab_file = take("--vocab_file")
    beam_size = int(take("--beam_size", "64"))
    lm_weight = float(take("--lm_weight", "1.0"))
    word_score = float(take("--word_score", "0.0"))
    wav = take("--one_shot_infer")
    device = take("--device", "cuda")
    config = parse_flags(argv)
    vocabulary = None
    if vocab_file:
        with open(vocab_file, encoding="utf-8") as f:
            vocabulary = [w for w in f.read().split() if w]
    if wav:
        one_shot_infer(config, wav, decoder_type, beam_size, vocabulary, device=device)
        return
    evaluate_flashlight(
        config, decoder_type=decoder_type, vocabulary=vocabulary,
        beam_size=beam_size, lm_weight=lm_weight, word_score=word_score, device=device,
    )


if __name__ == "__main__":
    main()
