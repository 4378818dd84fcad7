"""Batch transcription of long recordings with VAD segmentation (the
counterpart of `stt_tpu.transcribe`).

Per file: `data.vad.split_audio_file` cuts the recording into voiced
segments and batches them; each segment's MFCC comes from `audio_to_mfcc`
on the model's device, `Model.infer_logits` runs the acoustic model (its
LSTM in the inference kernel K1, or the int8 kernel K2 when the model was
opened with quantized_inference=True), a softmax stays on the device, and
`ctc_beam_search_decoder_batch_pruned` decodes, with the scorer if one is
given. The segments go to a .tlog JSON file beside the audio (or --dst).

A WAV recording at another rate than the model's is resampled, as
`stt_tpu.transcribe` does. Several processes (--coordinator_address,
--num_processes above 1, --process_id) join one process group and share
the sources round-robin (`shard_sources`).

Run: python -m stt_tpu_torch.transcribe --src audio.wav --dst out.tlog \\
       --model_dir exported_model [--scorer_path ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List

import torch

from stt_tpu_torch.config import log_error, log_info
from stt_tpu_torch.data.audio import read_wav
from stt_tpu_torch.data.vad import split_audio_file
from stt_tpu_torch.decode.device import ctc_beam_search_decoder_batch_pruned
from stt_tpu_torch.frontend import audio_to_mfcc


def transcribe_file(
    model,
    audio_path: str,
    scorer=None,
    batch_size: int = 8,
    aggressiveness: int = 3,
    beam_width: int = 500,
    vad_classifier: str = "energy",
) -> List[dict]:
    """One audio file -> list of {start, end, transcript} segments."""
    audio, rate = read_wav(audio_path, desired_rate=model.sample_rate())
    fc = model.feature_config
    segments_out = []
    for batch in split_audio_file(
        audio, rate, batch_size=batch_size, aggressiveness=aggressiveness,
        classifier=vad_classifier,
    ):
        feats = [audio_to_mfcc(torch.from_numpy(seg).to(model.device), fc)
                 for _, _, seg in batch]
        t_max = max(f.shape[0] for f in feats)
        padded = feats[0].new_zeros((len(feats), max(t_max, 1), fc.n_mfcc))
        for i, f in enumerate(feats):
            padded[i, : f.shape[0]] = f
        lengths = [f.shape[0] for f in feats]
        logits = model.infer_logits(padded, lengths)
        probs = torch.softmax(logits, dim=-1)  # stays on the device
        decoded = ctc_beam_search_decoder_batch_pruned(
            probs,
            lengths,
            model.alphabet,
            beam_size=beam_width,
            num_processes=batch_size,
            scorer=scorer,
        )
        for (start, end, _), results in zip(batch, decoded):
            segments_out.append(
                {
                    "start": start,
                    "end": end,
                    "transcript": results[0].transcript,
                }
            )
    segments_out.sort(key=lambda s: s["start"])
    return segments_out


def resolve_sources(src: str) -> List[str]:
    """file | .catalog (JSON list of paths) | directory (transcribe.py:224-260)."""
    if os.path.isdir(src):
        return sorted(glob.glob(os.path.join(src, "**", "*.wav"), recursive=True))
    if src.endswith(".catalog"):
        with open(src) as f:
            catalog = json.load(f)
        base = os.path.dirname(os.path.abspath(src))
        out = []
        for entry in catalog:
            path = entry["audio"] if isinstance(entry, dict) else entry
            if not os.path.isabs(path):
                path = os.path.join(base, path)
            out.append(path)
        return out
    return [src]


def shard_sources(sources: List[str], proc_id: int, proc_count: int) -> List[str]:
    """A process's share of the sources: every proc_count-th, from its id
    (the reference ran one transcription process per GPU)."""
    return sources[proc_id::proc_count]


def main(argv=None):
    parser = argparse.ArgumentParser(prog="stt_tpu_torch.transcribe")
    parser.add_argument("--src", required=True,
                        help="audio file, .catalog file, or directory")
    parser.add_argument("--dst", default="",
                        help="output .tlog path (single-file mode)")
    parser.add_argument("--model_dir", required=True)
    parser.add_argument("--scorer_path", default="")
    parser.add_argument("--lm_alpha", type=float, default=None)
    parser.add_argument("--lm_beta", type=float, default=None)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--beam_width", type=int, default=500)
    parser.add_argument("--vad_aggressiveness", type=int, default=3)
    parser.add_argument(
        "--vad_classifier", default="energy", choices=("energy", "gmm"),
        help="frame classifier: 'energy' (stationary floors) or 'gmm' "
             "(webrtcvad-class adaptive sub-band GMM; tracks moving "
             "noise floors)",
    )
    parser.add_argument("--force", action="store_true")
    parser.add_argument("--coordinator_address", default="")
    parser.add_argument("--num_processes", type=int, default=0)
    parser.add_argument("--process_id", type=int, default=-1)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda)")
    args = parser.parse_args(argv)

    proc_id, proc_count = 0, 1
    if args.num_processes and args.num_processes > 1:
        from stt_tpu_torch.config import SttConfig, maybe_initialize_distributed
        from stt_tpu_torch.parallel import distributed

        maybe_initialize_distributed(
            SttConfig(coordinator_address=args.coordinator_address,
                      num_processes=args.num_processes, process_id=args.process_id),
            device=args.device)
        proc_id, proc_count = distributed.process_index(), distributed.process_count()
        args.device = distributed.local_device(args.device)

    from stt_tpu_torch.serve import Model

    model = Model(args.model_dir, device=args.device)
    scorer = None
    if args.scorer_path:
        from stt_tpu_torch.decode.scorer_package import KenLMScorer

        scorer = KenLMScorer(args.scorer_path, alpha=args.lm_alpha, beta=args.lm_beta)

    sources = shard_sources(resolve_sources(args.src), proc_id, proc_count)
    for path in sources:
        tlog = args.dst if (args.dst and len(sources) == 1) else (
            os.path.splitext(path)[0] + ".tlog"
        )
        if os.path.exists(tlog) and not args.force:
            log_error(f"{tlog} exists — use --force to overwrite")
            continue
        segments = transcribe_file(
            model,
            path,
            scorer=scorer,
            batch_size=args.batch_size,
            aggressiveness=args.vad_aggressiveness,
            vad_classifier=args.vad_classifier,
            beam_width=args.beam_width,
        )
        with open(tlog, "w") as f:
            json.dump(segments, f, indent=2)
        log_info(f"{path}: {len(segments)} segments -> {tlog}")


if __name__ == "__main__":
    main()
