"""Vocabulary trie constraining beam expansion to dictionary words.

Equivalent of the reference's OpenFST-based dictionary (scorer.cpp:398-437
fill_dictionary + path_trie.cpp:54-90 SortedMatcher walk): a determinized
character trie where, in word mode, each word is stored followed by the
space label and the post-space state is final (so a completed word resets
the walk); in UTF-8/bytes mode words are stored as raw bytes with the
word-end state final.

The port's copy of `stt_tpu/decode/trie.py`, so the two packages read
and write the same files.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional


class _Node:
    __slots__ = ("children", "final")

    def __init__(self):
        self.children: Dict[int, "_Node"] = {}
        self.final = False


class DictionaryTrie:
    def __init__(self, utf8_mode: bool = False):
        self.utf8_mode = utf8_mode
        self.root = _Node()
        self._n_words = 0

    @classmethod
    def from_words(
        cls, words: Iterable[str], alphabet, utf8_mode: bool = False
    ) -> "DictionaryTrie":
        trie = cls(utf8_mode)
        for word in words:
            trie.add_word(word, alphabet)
        return trie

    def add_word(self, word: str, alphabet) -> bool:
        """Encode word with the alphabet and insert. Returns False (without
        inserting) if any character is outside the alphabet."""
        if not alphabet.can_encode(word):
            return False
        labels: List[int] = alphabet.encode(word)
        if not self.utf8_mode:
            labels = labels + [alphabet.space_index]
        node = self.root
        for label in labels:
            node = node.children.setdefault(label, _Node())
        node.final = True
        self._n_words += 1
        return True

    def __len__(self) -> int:
        return self._n_words

    # -- decoder-facing walk ----------------------------------------------

    @property
    def start(self) -> _Node:
        return self.root

    def step(self, state: _Node, label: int, reset: bool = True) -> Optional[_Node]:
        """Advance the walk by one label. None = expansion not in
        vocabulary. A final successor restarts at the root when reset."""
        nxt = state.children.get(label)
        if nxt is None:
            return None
        if nxt.final and reset:
            return self.root
        return nxt
