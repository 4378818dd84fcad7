"""Common Voice v2+ importer: converts an extracted corpus release
(clips/ + {train,dev,test}.tsv) into per-split CSVs with validated
transcripts (parity: bin/import_cv2.py, including the LabelFilter
options --normalize/--filter_alphabet, --space_after_every_character,
MAX_SECS=10, and multiprocess clip conversion).

Audio handling: Common Voice ships mp3/wav clips; both import directly
(mp3 decodes in-process via libmpg123), resampled to 16 kHz mono.

Run: python -m stt_tpu_torch.tools.import_cv2 --audio_dir cv/clips \
       --tsv_dir cv/ --target_dir out [--validate_label_locale x.py]
       [--filter_alphabet alphabet.txt] [--normalize]
       [--space_after_every_character] [--workers N]
"""

from __future__ import annotations

import csv
import os
from typing import Optional

from stt_tpu_torch.data.audio import write_wav
from stt_tpu_torch.tools.importers import (
    LabelFilter,
    add_filter_args,
    format_transcript,
    get_counter,
    get_importers_parser,
    label_filter_from_args,
    print_import_report,
)

SAMPLE_RATE = 16000
MAX_SECS = 10  # bin/import_cv2.py:30

_FILTER: Optional[LabelFilter] = None
_WAV_DIR = ""

SPLITS = ("train", "dev", "test")


def _init_worker(filter_obj: LabelFilter, wav_dir: str) -> None:
    global _FILTER, _WAV_DIR
    _FILTER = filter_obj
    _WAV_DIR = wav_dir


def _one_sample(sample):
    """(clip_path, sentence) -> (counter, row or None). Runs in worker
    processes (bin/import_cv2.py one_sample)."""
    from stt_tpu_torch.data.audio import read_audio

    src, sentence = sample
    counter = get_counter()
    counter["all"] += 1
    row = None
    label = _FILTER.filter(sentence)
    try:
        audio, _ = read_audio(src, desired_rate=SAMPLE_RATE)
    except Exception:
        counter["failed"] += 1
        return counter, row
    frames = len(audio)
    counter["total_time"] += frames
    secs = frames / SAMPLE_RATE
    if label is None:
        counter["invalid_label"] += 1
    elif int(secs * 1000 / 10 / 2) < len(str(label)):
        # too short to fit the transcript (reference heuristic)
        counter["too_short"] += 1
    elif secs > MAX_SECS:
        counter["too_long"] += 1
    else:
        dst = os.path.join(
            _WAV_DIR, os.path.splitext(os.path.basename(src))[0] + ".wav"
        )
        write_wav(dst, audio, SAMPLE_RATE)
        counter["imported_time"] += frames
        row = (dst, os.path.getsize(dst), label)
    return counter, row


def import_split(
    tsv_path: str,
    audio_dir: str,
    target_dir: str,
    filter_obj: LabelFilter,
    space_after_every_character: bool = False,
    workers: int = 1,
):
    wav_dir = os.path.join(target_dir, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    samples = []
    with open(tsv_path, newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            clip = row.get("path") or row.get("filename") or ""
            sentence = row.get("sentence") or row.get("text") or ""
            samples.append((os.path.join(audio_dir, clip), sentence))

    counter = get_counter()
    rows = []
    if workers > 1:
        # process pool like the reference's one_sample pool
        # (bin/import_cv2.py:103-160); spawn (not fork): the parent may
        # hold torch threads or a CUDA context (a forked child would risk
        # a deadlock); a spawned child imports this module and no CUDA
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(
            workers, initializer=_init_worker, initargs=(filter_obj, wav_dir)
        ) as pool:
            for c, row in pool.imap_unordered(_one_sample, samples):
                counter.update(c)
                if row is not None:
                    rows.append(row)
        rows.sort()  # deterministic output independent of worker order
    else:
        _init_worker(filter_obj, wav_dir)
        for sample in samples:
            c, row = _one_sample(sample)
            counter.update(c)
            if row is not None:
                rows.append(row)

    split = os.path.splitext(os.path.basename(tsv_path))[0]
    csv_path = os.path.join(target_dir, f"{split}.csv")
    with open(csv_path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f)
        writer.writerow(["wav_filename", "wav_filesize", "transcript"])
        for dst, size, label in rows:
            writer.writerow(
                [dst, size, format_transcript(label, space_after_every_character)]
            )
    print_import_report(counter, SAMPLE_RATE, MAX_SECS)
    print(f"Wrote {csv_path} ({len(rows)} samples)")
    return csv_path


def main(argv=None):
    parser = get_importers_parser(
        description="Import CommonVoice v2.0 corpora"
    )
    parser.add_argument("--audio_dir", required=True)
    parser.add_argument("--tsv_dir", required=True)
    parser.add_argument("--target_dir", required=True)
    parser.add_argument(
        "--workers", type=int, default=1,
        help="clip-conversion worker processes",
    )
    add_filter_args(parser)
    args = parser.parse_args(argv)
    filter_obj = label_filter_from_args(args)
    os.makedirs(args.target_dir, exist_ok=True)
    for split in SPLITS:
        tsv = os.path.join(args.tsv_dir, f"{split}.tsv")
        if os.path.isfile(tsv):
            import_split(
                tsv, args.audio_dir, args.target_dir, filter_obj,
                space_after_every_character=args.space_after_every_character,
                workers=args.workers,
            )


if __name__ == "__main__":
    main()
