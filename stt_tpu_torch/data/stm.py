"""TED-LIUM .stm segment parser (parity: util/stm.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List


@dataclass
class STMSegment:
    filename: str
    channel: str
    speaker_id: str
    start_time: float
    stop_time: float
    labels: str
    transcript: str


def parse_stm_line(line: str) -> STMSegment:
    tokens = line.split()
    return STMSegment(
        filename=tokens[0],
        channel=tokens[1],
        speaker_id=tokens[2],
        start_time=float(tokens[3]),
        stop_time=float(tokens[4]),
        labels=tokens[5],
        transcript=" ".join(tokens[6:]).replace(" <unk>", "").strip(),
    )


def parse_stm_file(path: str) -> List[STMSegment]:
    segments = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(";;"):
                continue
            seg = parse_stm_line(line)
            if seg.transcript and seg.transcript.lower() != "ignore_time_segment_in_scoring":
                segments.append(seg)
    return segments
