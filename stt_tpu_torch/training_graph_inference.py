"""One-shot inference straight from a training checkpoint, without an
export: a debugging aid (the counterpart of
`stt_tpu.training_graph_inference`).

The file is featurized on the host (`audio_to_mfcc_numpy`), the checkpoint's
model runs on the card (its LSTM in the inference kernel K1), and the host
beam decoder, with the scorer when one is named, prints the transcript.

Run: python -m stt_tpu_torch.training_graph_inference --checkpoint_dir ... \
       --one_shot_infer audio.wav [--scorer_path ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch

from stt_tpu_torch.config import SttConfig, initialize_globals_from_cli
from stt_tpu_torch.data.audio import read_wav
from stt_tpu_torch.decode import ctc_beam_search_decoder
from stt_tpu_torch.device import resolve_device
from stt_tpu_torch.evaluate import load_model
from stt_tpu_torch.frontend import audio_to_mfcc_numpy


def do_single_file_inference(config: SttConfig, audio_path: str, device="cuda") -> str:
    """The transcript of one file by the checkpoint in
    `config.load_checkpoint_dir`, on the card unless device="cpu"."""
    device = resolve_device(device)
    alphabet = config.resolve_alphabet()
    model = load_model(config, device)
    audio, _ = read_wav(audio_path, desired_rate=config.audio_sample_rate)
    feats = torch.from_numpy(audio_to_mfcc_numpy(audio, config.feature_config)[None])
    lengths = torch.tensor([feats.shape[1]], dtype=torch.int32, device=device)
    with torch.no_grad():
        logits, _ = model(feats.to(device), seq_len=lengths)
    probs = torch.softmax(logits[0], dim=-1).cpu().numpy()

    scorer = None
    if config.scorer_path:
        from stt_tpu_torch.decode.scorer_package import KenLMScorer

        scorer = KenLMScorer(config.scorer_path, alpha=config.lm_alpha, beta=config.lm_beta)
    [result] = ctc_beam_search_decoder(
        probs,
        alphabet,
        beam_size=config.beam_width,
        cutoff_prob=config.cutoff_prob,
        cutoff_top_n=config.cutoff_top_n,
        scorer=scorer,
    )
    print(result.transcript)
    return result.transcript


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--one_shot_infer", required=True)
    parser.add_argument("--device", default="cuda")
    args, rest = parser.parse_known_args(argv)
    config = initialize_globals_from_cli(rest, device=args.device)
    do_single_file_inference(config, args.one_shot_infer, device=args.device)


if __name__ == "__main__":
    main()
