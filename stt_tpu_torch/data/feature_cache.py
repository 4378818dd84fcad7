"""Disk/RAM feature cache — the reference's --feature_cache /
--cache_for_epochs (training/coqui_stt_training/util/feeding.py:223-224
`dataset.cache(cache_path)`, util/config.py:387-399, invalidation
train.py:467-474).

Semantics mirrored:
- The first epoch featurizes normally while filling the cache; once the
  epoch completes the cache is flushed to ``path`` and later epochs (and
  later RUNS pointed at the same path) read features + encoded labels
  from it instead of re-decoding + re-featurizing audio.
- With augmentations enabled, the cached (epoch-0) augmentations repeat
  on later epochs — exactly the reference's warned behavior
  (util/config.py:47-55); ``cache_for_epochs`` > 0 drops the cache every
  N epochs so fresh augmentations are drawn (train.py:467-474).
- An empty path means a RAM-only cache (still skips featurize for
  epochs > 0 within one run).

Rows are keyed by their index in the duration-sorted sample list, which
is deterministic across epochs and across hosts (multi-host row_range
sharding caches only the host's own rows).

File format (little-endian):
  magic  b"STTFCACH"
  u32    version (1)
  u32    n_mfcc
  u64    n_rows
  u64[n_rows]  record offsets (0 = row absent)
  records: u32 T, u32 L, f32 feats[T*n_mfcc], i32 labels[L]
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Dict, Optional, Tuple

import numpy as np

_MAGIC = b"STTFCACH"
_VERSION = 1


class FeatureCache:
    """Fill-then-serve cache of (features [T, n_mfcc] f32, labels i32)."""

    def __init__(self, path: str = "", cache_for_epochs: int = 0):
        self.path = path or ""
        self.cache_for_epochs = cache_for_epochs
        self._ram: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._lock = threading.Lock()
        self._complete = False
        self._mmap: Optional[np.memmap] = None
        self._offsets: Optional[np.ndarray] = None
        self._n_mfcc = 0
        if self.path and os.path.isfile(self.path):
            self._open_file()

    # -- epoch lifecycle -------------------------------------------------

    def maybe_invalidate(self, epoch: int) -> bool:
        """Reference train.py:467-474: at the start of every
        cache_for_epochs-th epoch the cache is removed so features (and
        augmentations) are recomputed. Returns True when invalidated."""
        if (
            self.cache_for_epochs > 0
            and epoch > 0
            and epoch % self.cache_for_epochs == 0
        ):
            self.clear()
            return True
        return False

    def clear(self) -> None:
        with self._lock:
            self._ram.clear()
            self._complete = False
            self._mmap = None
            self._offsets = None
        if self.path and os.path.isfile(self.path):
            os.remove(self.path)

    # -- read ------------------------------------------------------------

    @property
    def complete(self) -> bool:
        return self._complete

    def get(self, row: int):
        """(features, labels) or None when the row is not cached."""
        if self._offsets is not None:
            if row >= len(self._offsets) or self._offsets[row] == 0:
                return None
            return self._read_record(int(self._offsets[row]))
        with self._lock:
            return self._ram.get(row)

    # -- fill ------------------------------------------------------------

    def put(self, row: int, feats: np.ndarray, labels: np.ndarray) -> None:
        if self._complete:
            return
        with self._lock:
            self._ram[row] = (
                np.ascontiguousarray(feats, np.float32),
                np.ascontiguousarray(labels, np.int32),
            )

    def finalize(self, n_rows: int) -> None:
        """Mark the fill epoch complete; persist when all rows present
        (a partial fill — interrupted epoch, limit/reverse dummy run —
        keeps serving from RAM but is not persisted)."""
        with self._lock:
            if self._offsets is not None:
                return
            have_all = len(self._ram) == n_rows and all(
                r in self._ram for r in range(n_rows)
            )
            # a partial fill keeps serving hits from RAM and keeps
            # accepting puts on later epochs; only a full fill freezes
            self._complete = have_all
            if not (self.path and have_all):
                return
            rows = [self._ram[r] for r in range(n_rows)]
        self._write_file(rows)
        self._open_file()
        with self._lock:
            self._ram.clear()

    # -- disk format -----------------------------------------------------

    def _write_file(self, rows) -> None:
        n_mfcc = rows[0][0].shape[1] if rows and rows[0][0].ndim == 2 else 0
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<II", _VERSION, n_mfcc))
            f.write(struct.pack("<Q", len(rows)))
            table_pos = f.tell()
            f.write(b"\x00" * (8 * len(rows)))
            offsets = []
            for feats, labels in rows:
                offsets.append(f.tell())
                f.write(struct.pack("<II", feats.shape[0], len(labels)))
                f.write(feats.tobytes())
                f.write(labels.tobytes())
            f.seek(table_pos)
            f.write(struct.pack(f"<{len(rows)}Q", *offsets))
        os.replace(tmp, self.path)

    def _open_file(self) -> None:
        with open(self.path, "rb") as f:
            head = f.read(len(_MAGIC) + 16)
        if head[: len(_MAGIC)] != _MAGIC:
            raise ValueError(f"not a feature cache file: {self.path}")
        version, n_mfcc = struct.unpack_from("<II", head, len(_MAGIC))
        if version != _VERSION:
            raise ValueError(f"feature cache version {version} unsupported")
        (n_rows,) = struct.unpack_from("<Q", head, len(_MAGIC) + 8)
        self._n_mfcc = n_mfcc
        self._mmap = np.memmap(self.path, np.uint8, mode="r")
        table_start = len(_MAGIC) + 16
        self._offsets = np.frombuffer(
            self._mmap[table_start : table_start + 8 * n_rows], "<u8"
        )
        self._complete = True

    def _read_record(self, off: int):
        t, l = struct.unpack_from("<II", self._mmap, off)
        off += 8
        feats = np.frombuffer(
            self._mmap[off : off + 4 * t * self._n_mfcc], "<f4"
        ).reshape(t, self._n_mfcc)
        off += 4 * t * self._n_mfcc
        labels = np.frombuffer(self._mmap[off : off + 4 * l], "<i4")
        return feats, labels
