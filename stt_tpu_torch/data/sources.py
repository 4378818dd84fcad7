"""Dataset sources: CSV, SDB sample databases, webdataset tars (the
counterpart of `stt_tpu.data.sources`, and of the reference's sample
collections).

- A CSV has the columns wav_filename[,wav_filesize][,transcript]; relative
  audio paths resolve against the CSV's directory; rows iterate sorted by
  wav_filesize, a cheap duration proxy. The audio is read by extension
  (`read_audio`: WAV, FLAC, Ogg Vorbis, SPHERE, Opus, MP3).
- SDB binary format: b"SAMPLEDB" magic, big-endian lengths; JSON schema
  chunk; sample chunk of length-prefixed rows (each: int32 entry_len, then
  per column int32 len + bytes); trailing offset index (int64 count + per
  row absolute offsets). Audio columns may be WAV- or Opus-coded; Opus
  rows go through the system libopus (`data.opus`) and raise a clear error
  where it is absent. `SDBWriter` writes the bytes `stt_tpu`'s does.
- webdataset tar source: .wav/.txt member pairs grouped by key.
- Several sources merge by the duration proxy.
- Samples load their audio lazily, on first access.
"""

from __future__ import annotations

import csv
import heapq
import io
import json
import os
import tarfile
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from stt_tpu_torch.data.audio import read_audio, write_wav

MAGIC = b"SAMPLEDB"
INT_SIZE = 4
BIGINT_SIZE = 8
SCHEMA_KEY = "schema"
CONTENT_KEY = "content"
MIME_TYPE_KEY = "mime-type"
MIME_WAV = "audio/wav"
MIME_OPUS = "application/vnd.mozilla.opus"  # reference audio.py:24 (Opus-in-SDB)
MIME_TEXT = "text/plain"
CONTENT_SPEECH = "speech"
CONTENT_TRANSCRIPT = "transcript"


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
                loader=lambda path=path: read_audio(path),
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


# -- SDB --------------------------------------------------------------------


class SDBWriter:
    def __init__(self, sdb_path: str, labeled: bool = True,
                 audio_type: str = "wav", bitrate: Optional[int] = None):
        """audio_type: "wav" (lossless, default) or "opus" (the
        reference DirectSDBWriter's default, sample_collections.py:124);
        bitrate applies to opus only."""
        if audio_type not in ("wav", "opus"):
            raise ValueError(f"unsupported SDB audio_type {audio_type!r}")
        self.sdb_path = sdb_path
        self.labeled = labeled
        self.audio_type = audio_type
        self.bitrate = bitrate
        self._file = open(sdb_path, "wb")
        self._offsets: List[int] = []
        self._file.write(MAGIC)
        mime = MIME_OPUS if audio_type == "opus" else MIME_WAV
        schema = [{CONTENT_KEY: CONTENT_SPEECH, MIME_TYPE_KEY: mime}]
        if labeled:
            schema.append(
                {CONTENT_KEY: CONTENT_TRANSCRIPT, MIME_TYPE_KEY: MIME_TEXT}
            )
        meta = json.dumps({SCHEMA_KEY: schema}).encode()
        self._file.write(len(meta).to_bytes(BIGINT_SIZE, "big"))
        self._file.write(meta)
        self._offset_samples = self._file.tell()
        self._file.seek(2 * BIGINT_SIZE, 1)

    def add(self, sample: Sample) -> int:
        pcm = (
            np.clip(sample.audio * 32768.0, -32768, 32767)
            .astype(np.int16)
            .tobytes()
        )
        buf = io.BytesIO()
        if self.audio_type == "opus":
            from stt_tpu_torch.data.opus import write_opus

            write_opus(buf, pcm, rate=sample.rate, channels=1, width=2,
                       bitrate=self.bitrate)
        else:
            import wave

            with wave.open(buf, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(sample.rate)
                w.writeframes(pcm)
        chunks = [buf.getvalue()]
        if self.labeled:
            chunks.append((sample.transcript or "").encode())
        entry = b"".join(
            len(c).to_bytes(INT_SIZE, "big") + c for c in chunks
        )
        self._offsets.append(self._file.tell())
        self._file.write(len(entry).to_bytes(INT_SIZE, "big") + entry)
        return len(self._offsets) - 1

    def close(self):
        if self._file is None:
            return
        offset_index = self._file.tell()
        self._file.seek(self._offset_samples)
        self._file.write(
            (offset_index - self._offset_samples - BIGINT_SIZE).to_bytes(
                BIGINT_SIZE, "big"
            )
        )
        self._file.write(len(self._offsets).to_bytes(BIGINT_SIZE, "big"))
        self._file.seek(offset_index + BIGINT_SIZE)
        self._file.write(len(self._offsets).to_bytes(BIGINT_SIZE, "big"))
        for offset in self._offsets:
            self._file.write(offset.to_bytes(BIGINT_SIZE, "big"))
        offset_end = self._file.tell()
        self._file.seek(offset_index)
        self._file.write(
            (offset_end - offset_index - BIGINT_SIZE).to_bytes(BIGINT_SIZE, "big")
        )
        self._file.close()
        self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SDBSource:
    def __init__(self, sdb_path: str, labeled: Optional[bool] = None):
        self.sdb_path = sdb_path
        self._file = open(sdb_path, "rb")
        if self._file.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{sdb_path} is not an SDB file")
        meta_len = int.from_bytes(self._file.read(BIGINT_SIZE), "big")
        self.meta = json.loads(self._file.read(meta_len).decode())
        schema = self.meta[SCHEMA_KEY]
        self.speech_index = next(
            i for i, c in enumerate(schema) if c[CONTENT_KEY] == CONTENT_SPEECH
        )
        mime = schema[self.speech_index][MIME_TYPE_KEY]
        if mime == MIME_OPUS:
            from stt_tpu_torch.data.opus import opus_available

            if not opus_available():
                raise NotImplementedError(
                    f"SDB audio mime {mime!r} needs libopus, which is not "
                    "available on this system"
                )
        elif mime != MIME_WAV:
            raise NotImplementedError(
                f"SDB audio mime {mime!r} is not supported (audio/wav and "
                "Opus SDBs are)"
            )
        self.audio_mime = mime
        transcript_idx = [
            i for i, c in enumerate(schema) if c[CONTENT_KEY] == CONTENT_TRANSCRIPT
        ]
        if labeled is None:
            labeled = bool(transcript_idx)
        if labeled and not transcript_idx:
            raise ValueError(f"{sdb_path} has no transcripts")
        self.labeled = labeled
        self.transcript_index = transcript_idx[0] if transcript_idx else None
        sample_chunk_len = int.from_bytes(self._file.read(BIGINT_SIZE), "big")
        self._file.seek(sample_chunk_len + BIGINT_SIZE, 1)
        num_samples = int.from_bytes(self._file.read(BIGINT_SIZE), "big")
        self.offsets = [
            int.from_bytes(self._file.read(BIGINT_SIZE), "big")
            for _ in range(num_samples)
        ]

    def __len__(self):
        return len(self.offsets)

    def _read_row(self, i: int, *columns: int) -> List[bytes]:
        self._file.seek(self.offsets[i] + INT_SIZE)
        want = set(columns)
        out: dict = {}
        for col in range(max(want) + 1):
            n = int.from_bytes(self._file.read(INT_SIZE), "big")
            if col in want:
                out[col] = self._file.read(n)
            else:
                self._file.seek(n, 1)
        return [out[c] for c in columns]

    def __getitem__(self, i: int) -> Sample:
        cols = [self.speech_index]
        if self.labeled:
            cols.append(self.transcript_index)
        data = self._read_row(i, *cols)
        if self.audio_mime == MIME_OPUS:
            from stt_tpu_torch.data.opus import read_opus

            pcm_bytes, rate, channels, _ = read_opus(io.BytesIO(data[0]))
            audio = (
                np.frombuffer(pcm_bytes, np.int16).astype(np.float32) / 32768.0
            )
            if channels > 1:
                audio = audio.reshape(-1, channels).mean(axis=1)
        else:
            audio, rate = read_wav_bytes(data[0])
        return Sample(
            sample_id=f"{self.sdb_path}:{i}",
            transcript=data[1].decode() if self.labeled else None,
            _audio=audio,
            _rate=rate,
        )

    def __iter__(self) -> Iterator[Sample]:
        for i in range(len(self)):
            yield self[i]

    def close(self):
        if self._file:
            self._file.close()
            self._file = None


def read_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    import wave

    with wave.open(io.BytesIO(data), "rb") as w:
        rate = w.getframerate()
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    return (pcm / 32768.0).astype(np.float32), rate


# -- webdataset tar ---------------------------------------------------------


class TarSource:
    """webdataset-style tar: members grouped by basename key with .wav
    audio and .txt transcript (sample_collections.py:575)."""

    def __init__(self, tar_path: str, labeled: Optional[bool] = None):
        self.tar_path = tar_path
        self._tar = tarfile.open(tar_path, "r")
        groups: dict = {}
        for member in self._tar.getmembers():
            if not member.isfile():
                continue
            key, ext = os.path.splitext(member.name)
            groups.setdefault(key, {})[ext.lower()] = member
        self.items = []
        for key in sorted(groups):
            g = groups[key]
            if ".wav" in g:
                self.items.append((key, g[".wav"], g.get(".txt")))
        if labeled is None:
            labeled = all(t is not None for _, _, t in self.items)
        self.labeled = labeled

    def __len__(self):
        return len(self.items)

    def __iter__(self) -> Iterator[Sample]:
        for key, wav_member, txt_member in self.items:
            audio, rate = read_wav_bytes(
                self._tar.extractfile(wav_member).read()
            )
            transcript = None
            if self.labeled and txt_member is not None:
                transcript = (
                    self._tar.extractfile(txt_member).read().decode().strip()
                )
            yield Sample(
                sample_id=f"{self.tar_path}:{key}",
                transcript=transcript,
                _audio=audio,
                _rate=rate,
            )


def samples_from_source(path: str, labeled: Optional[bool] = None):
    ext = os.path.splitext(path)[1].lower()
    if ext == ".csv":
        return CSVSource(path, labeled)
    if ext == ".sdb":
        return SDBSource(path, labeled)
    if ext == ".tar":
        return TarSource(path, labeled)
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
