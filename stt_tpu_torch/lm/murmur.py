"""MurmurHash64A — the hash KenLM's vocabulary uses (util/murmur_hash.cc
semantics, 64-bit variant, seed 0 for vocab words).

The port's copy of `stt_tpu/lm/murmur.py`, so the two packages read and
write the same files.
"""

from __future__ import annotations

_MASK = (1 << 64) - 1
_M = 0xC6A4A7935BD1E995
_R = 47


def murmur_hash64a(data: bytes, seed: int = 0) -> int:
    h = (seed ^ ((len(data) * _M) & _MASK)) & _MASK
    n8 = len(data) & ~7
    for i in range(0, n8, 8):
        k = int.from_bytes(data[i : i + 8], "little")
        k = (k * _M) & _MASK
        k ^= k >> _R
        k = (k * _M) & _MASK
        h ^= k
        h = (h * _M) & _MASK
    tail = data[n8:]
    if tail:
        h ^= int.from_bytes(tail, "little")
        h = (h * _M) & _MASK
    h ^= h >> _R
    h = (h * _M) & _MASK
    h ^= h >> _R
    return h
