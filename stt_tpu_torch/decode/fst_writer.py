"""Writer for the ConstFst vocabulary trie inside .scorer packages.

Inverse of stt_tpu_torch.decode.fst_dict: builds the determinized character
trie the reference builds with OpenFST (scorer.cpp:398-437
fill_dictionary: words as alphabet-index+1 arcs, word-mode words
terminated by the space label with the post-space state final) and
serializes it as an aligned ConstFst<StdArc> the reference runtime can
mmap.

The port's copy of `stt_tpu/decode/fst_writer.py`, so the two packages
read and write the same files.
"""

from __future__ import annotations

import struct
from typing import Iterable, List

import numpy as np

from stt_tpu_torch.decode.fst_dict import FST_MAGIC

_INF = float("inf")


class _TrieNode:
    __slots__ = ("children", "final")

    def __init__(self):
        self.children = {}
        self.final = False


def build_dictionary_fst(
    words: Iterable[str], alphabet, utf8_mode: bool = False
) -> "np.ndarray":
    """Build trie structure; returns (states, arcs) arrays in ConstFst
    layout. Arc ilabels are alphabet index + 1."""
    root = _TrieNode()
    for word in words:
        if word in ("<s>", "</s>", "<unk>", "<UNK>"):
            continue
        if utf8_mode:
            try:
                labels = [b - 1 for b in word.encode("utf-8")]
            except UnicodeEncodeError:
                continue
            if any(l < 0 for l in labels):
                continue
        else:
            if not alphabet.can_encode(word):
                continue
            labels = alphabet.encode(word) + [alphabet.space_index]
        node = root
        for label in labels:
            node = node.children.setdefault(label, _TrieNode())
        node.final = True

    # BFS assign state ids (start = 0)
    states: List[_TrieNode] = []
    order = {}
    queue = [root]
    while queue:
        node = queue.pop(0)
        order[id(node)] = len(states)
        states.append(node)
        for label in sorted(node.children):
            queue.append(node.children[label])

    n_arcs = sum(len(s.children) for s in states)
    state_arr = np.zeros(
        len(states),
        dtype=np.dtype(
            [("final", "<f4"), ("pos", "<u4"), ("narcs", "<u4"),
             ("nieps", "<u4"), ("noeps", "<u4")]
        ),
    )
    arc_arr = np.zeros(
        n_arcs,
        dtype=np.dtype(
            [("ilabel", "<i4"), ("olabel", "<i4"), ("weight", "<f4"),
             ("nextstate", "<i4")]
        ),
    )
    pos = 0
    for i, node in enumerate(states):
        state_arr[i]["final"] = 0.0 if node.final else _INF
        state_arr[i]["pos"] = pos
        state_arr[i]["narcs"] = len(node.children)
        for label in sorted(node.children):
            arc_arr[pos]["ilabel"] = label + 1
            arc_arr[pos]["olabel"] = label + 1
            arc_arr[pos]["weight"] = 0.0
            arc_arr[pos]["nextstate"] = order[id(node.children[label])]
            pos += 1
    return state_arr, arc_arr


def write_const_fst(state_arr, arc_arr, base_offset: int = 0) -> bytes:
    """Serialize as aligned ConstFst v1 (the format save_dictionary
    emits). base_offset = absolute file position where these bytes will
    land (alignment is relative to the file start)."""
    out = bytearray()

    def write_string(s: str):
        out.extend(struct.pack("<i", len(s)))
        out.extend(s.encode())

    out.extend(struct.pack("<i", FST_MAGIC))
    write_string("const")
    write_string("standard")
    # version 1 (aligned), flags 0, properties: expanded|accessible-ish
    out.extend(struct.pack("<ii", 1, 0))
    properties = 0x1  # kExpanded
    out.extend(struct.pack("<Qqqq", properties, 0, len(state_arr), len(arc_arr)))

    def align16():
        total = base_offset + len(out)
        pad = (-total) % 16
        out.extend(b"\x00" * pad)

    align16()
    out.extend(state_arr.tobytes())
    align16()
    out.extend(arc_arr.tobytes())
    return bytes(out)
