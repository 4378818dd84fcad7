"""Reader for the OpenFST ConstFst vocabulary trie inside .scorer packages.

The reference serializes the dictionary as ConstFst<StdArc> with aligned
writes (generate_scorer_package.cpp via Scorer::save_dictionary,
scorer.cpp:224-268) and walks it with a SortedMatcher during beam
expansion (path_trie.cpp:54-90). Layout:

  FstHeader: int32 magic 2125659606, (int32 len + bytes) fst type "const",
    (len+bytes) arc type "standard", int32 version (1 = aligned), int32
    flags, uint64 properties, int64 start, int64 numstates, int64 numarcs
  align to 16 (absolute file offset)
  states: numstates x {f32 final_weight, u32 arc_pos, u32 narcs,
                       u32 niepsilons, u32 noepsilons}
  align to 16
  arcs: numarcs x {i32 ilabel, i32 olabel, f32 weight, i32 nextstate}

Arc input labels are alphabet indices + 1 (scorer.cpp:92-105: label 0 is
reserved for epsilon). Final weight +inf means non-final.

The port's copy of `stt_tpu/decode/fst_dict.py`, so the two packages
read and write the same files.
"""

from __future__ import annotations

import math
import struct
from typing import Optional

import numpy as np

FST_MAGIC = 2125659606


class FstDictionary:
    """Same walk interface as stt_tpu_torch.decode.trie.DictionaryTrie: `start`
    property and `step(state, label, reset)` where a final successor
    restarts the walk at the root (completed word)."""

    def __init__(self, data: bytes, base_offset: int = 0):
        off = base_offset
        magic, = struct.unpack_from("<i", data, off)
        off += 4
        if magic != FST_MAGIC:
            raise ValueError(f"bad FST magic {magic:#x}")

        def read_string(off):
            n, = struct.unpack_from("<i", data, off)
            return bytes(data[off + 4 : off + 4 + n]).decode(), off + 4 + n

        self.fst_type, off = read_string(off)
        self.arc_type, off = read_string(off)
        if self.fst_type != "const" or self.arc_type != "standard":
            raise ValueError(
                f"unsupported FST ({self.fst_type}/{self.arc_type}); the "
                "scorer dictionary is always const/standard"
            )
        version, flags = struct.unpack_from("<ii", data, off)
        off += 8
        properties, start, nstates, narcs = struct.unpack_from("<Qqqq", data, off)
        off += 32
        aligned = version == 1 or (flags & 4)

        def align16(o):
            return (o + 15) & ~15 if aligned else o

        off = align16(off)
        self._states = np.frombuffer(
            data,
            dtype=np.dtype(
                [("final", "<f4"), ("pos", "<u4"), ("narcs", "<u4"),
                 ("nieps", "<u4"), ("noeps", "<u4")]
            ),
            count=nstates,
            offset=off,
        )
        off += nstates * 20
        off = align16(off)
        self._arcs = np.frombuffer(
            data,
            dtype=np.dtype(
                [("ilabel", "<i4"), ("olabel", "<i4"), ("weight", "<f4"),
                 ("nextstate", "<i4")]
            ),
            count=narcs,
            offset=off,
        )
        self.end_offset = off - base_offset + narcs * 16
        self._start = int(start)
        self.num_states = int(nstates)
        self.num_arcs = int(narcs)

    @property
    def start(self) -> int:
        return self._start

    def is_final(self, state: int) -> bool:
        return math.isfinite(float(self._states[state]["final"]))

    def _find_arc(self, state: int, ilabel: int) -> Optional[int]:
        s = self._states[state]
        pos, narcs = int(s["pos"]), int(s["narcs"])
        arcs = self._arcs[pos : pos + narcs]
        idx = np.searchsorted(arcs["ilabel"], ilabel)
        if idx < narcs and int(arcs[idx]["ilabel"]) == ilabel:
            return int(arcs[idx]["nextstate"])
        return None

    def arcs(self, state: int) -> list:
        """(ilabel, nextstate) pairs out of a state (tooling surface,
        trie_load.cc `arcs` inspection)."""
        s = self._states[state]
        pos, narcs = int(s["pos"]), int(s["narcs"])
        return [
            (int(a["ilabel"]), int(a["nextstate"]))
            for a in self._arcs[pos : pos + narcs]
        ]

    def step(self, state: int, label: int, reset: bool = True) -> Optional[int]:
        nxt = self._find_arc(state, label + 1)
        if nxt is None:
            return None
        if reset and self.is_final(nxt):
            return self._start
        return nxt

    def words(self, alphabet) -> list:
        """Enumerate the vocabulary by depth-first walk (tooling surface:
        inspect a scorer's dictionary)."""
        out = []

        def dfs(state, prefix):
            if self.is_final(state):
                word = alphabet.decode(prefix)
                out.append(word.rstrip(" "))
                if not self._states[state]["narcs"]:
                    return
            s = self._states[state]
            for arc in self._arcs[int(s["pos"]) : int(s["pos"]) + int(s["narcs"])]:
                dfs(int(arc["nextstate"]), prefix + [int(arc["ilabel"]) - 1])

        dfs(self._start, [])
        return out
