"""Dataset sources: the CSV format of `stt_tpu.data.sources` (and of the
reference's sample collections).

- A CSV has the columns wav_filename[,wav_filesize][,transcript]; relative
  audio paths resolve against the CSV's directory; rows iterate sorted by
  wav_filesize, a cheap duration proxy.
- Several sources merge by that proxy.
- Samples load their audio lazily, on first access.

SDB sample databases and webdataset tars are not ported yet (ROADMAP.md,
P6) and raise NotImplementedError; the port reads WAV only.
"""

from __future__ import annotations

import csv
import heapq
import os
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from stt_tpu_torch.data.audio import read_wav, write_wav


@dataclass
class Sample:
    """One utterance. Audio may be lazy: `loader` fills `audio`/`rate` on
    first access."""

    sample_id: str
    transcript: Optional[str] = None
    duration_hint: float = 0.0  # sort key before audio is loaded (bytes or s)
    _audio: Optional[np.ndarray] = field(default=None, repr=False)
    _rate: int = 16000
    loader: Optional[Callable[[], Tuple[np.ndarray, int]]] = field(default=None, repr=False)

    def _load(self):
        if self._audio is None:
            if self.loader is None:
                raise ValueError(f"sample {self.sample_id} has no audio")
            self._audio, self._rate = self.loader()
        return self._audio, self._rate

    @property
    def audio(self) -> np.ndarray:
        return self._load()[0]

    @audio.setter
    def audio(self, value: np.ndarray) -> None:
        self._audio = value

    @property
    def rate(self) -> int:
        return self._load()[1]

    @property
    def duration(self) -> float:
        audio, rate = self._load()
        return len(audio) / rate


class CSVSource:
    """Reader for the CSV dataset format."""

    def __init__(self, csv_path: str, labeled: Optional[bool] = None):
        self.csv_path = csv_path
        base = os.path.dirname(os.path.abspath(csv_path))
        self.rows: List[dict] = []
        with open(csv_path, newline="", encoding="utf-8") as f:
            for row in csv.DictReader(f):
                path = row["wav_filename"]
                if not os.path.isabs(path):
                    path = os.path.join(base, path)
                row["wav_filename"] = path
                self.rows.append(row)
        if labeled is None:
            labeled = bool(self.rows) and "transcript" in self.rows[0]
        self.labeled = labeled
        self.rows.sort(key=lambda r: int(r.get("wav_filesize", 0) or 0))

    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self) -> Iterator[Sample]:
        for row in self.rows:
            path = row["wav_filename"]
            yield Sample(
                sample_id=path,
                transcript=row.get("transcript") if self.labeled else None,
                duration_hint=float(row.get("wav_filesize", 0) or 0),
                loader=lambda path=path: read_wav(path),
            )


class CSVWriter:
    """Writes the CSV and one WAV file per sample, in a directory named
    after the CSV. The CSV names each file relative to its own directory,
    as CSVSource resolves it."""

    def __init__(self, csv_path: str, labeled: bool = True):
        self.csv_path = csv_path
        self.dir = os.path.splitext(csv_path)[0]
        os.makedirs(self.dir, exist_ok=True)
        self._file = open(csv_path, "w", newline="", encoding="utf-8")
        cols = ["wav_filename", "wav_filesize"] + (["transcript"] if labeled else [])
        self._writer = csv.writer(self._file)
        self._writer.writerow(cols)
        self.labeled = labeled
        self._count = 0

    def add(self, sample: Sample) -> str:
        path = os.path.join(self.dir, f"sample{self._count:010d}.wav")
        write_wav(path, sample.audio, sample.rate)
        name = os.path.join(os.path.basename(self.dir), os.path.basename(path))
        row = [name, os.path.getsize(path)] + ([sample.transcript] if self.labeled else [])
        self._writer.writerow(row)
        self._count += 1
        return path

    def close(self):
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def samples_from_source(path: str, labeled: Optional[bool] = None) -> CSVSource:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".csv":
        return CSVSource(path, labeled)
    if ext in (".sdb", ".tar"):
        raise NotImplementedError(
            f"{ext} sources are not ported to stt_tpu_torch yet (ROADMAP.md, P6); "
            "use a CSV of WAV files"
        )
    raise ValueError(f"unknown dataset source type: {path}")


def samples_from_sources(
    paths: Iterable[str], labeled: Optional[bool] = None
) -> Iterator[Sample]:
    """Iterate several sources merged by ascending duration proxy."""
    sources = [samples_from_source(p, labeled) for p in paths]
    if len(sources) == 1:
        yield from sources[0]
        return

    def keyed(src, src_idx):
        for j, s in enumerate(src):
            yield (s.duration_hint, src_idx, j, s)

    for _, _, _, sample in heapq.merge(*(keyed(src, i) for i, src in enumerate(sources))):
        yield sample
