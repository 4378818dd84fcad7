"""Pure-Python FLAC decoder (subset: everything FLAC encoders emit for
speech corpora — CONSTANT/VERBATIM/FIXED/LPC subframes, all channel
assignments, Rice residuals).

Why: LibriSpeech and many corpora ship FLAC; this image has no codec
libraries, and the reference's CI exercises FLAC inputs
(bin/run-ci-ldc93s1-flac.sh). FLAC is lossless, so the decode is gated
bit-exactly against the WAV twin of the smoke utterance.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


class _BitReader:
    __slots__ = ("data", "pos", "bit")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.bit = 0

    def read_uint(self, bits: int) -> int:
        value = 0
        data, pos, bit = self.data, self.pos, self.bit
        while bits > 0:
            avail = 8 - bit
            take = min(bits, avail)
            byte = data[pos]
            value = (value << take) | ((byte >> (avail - take)) & ((1 << take) - 1))
            bit += take
            if bit == 8:
                bit = 0
                pos += 1
            bits -= take
        self.pos, self.bit = pos, bit
        return value

    def read_int(self, bits: int) -> int:
        value = self.read_uint(bits)
        if value >> (bits - 1):
            value -= 1 << bits
        return value

    def read_unary(self) -> int:
        count = 0
        data, pos, bit = self.data, self.pos, self.bit
        while True:
            byte = data[pos] & ((1 << (8 - bit)) - 1)
            if byte == 0:
                count += 8 - bit
                pos += 1
                bit = 0
                continue
            # highest set bit position within remaining bits
            top = byte.bit_length()
            zeros = (8 - bit) - top
            count += zeros
            bit += zeros + 1  # consume zeros and the terminating 1
            if bit >= 8:
                bit -= 8
                pos += 1
            self.pos, self.bit = pos, bit
            return count

    def read_rice(self, param: int) -> int:
        quotient = self.read_unary()
        remainder = self.read_uint(param) if param else 0
        value = (quotient << param) | remainder
        return (value >> 1) ^ -(value & 1)  # zigzag

    def align(self) -> None:
        if self.bit:
            self.bit = 0
            self.pos += 1

    def read_utf8_number(self) -> int:
        first = self.read_uint(8)
        if first < 0x80:
            return first
        n_extra = 0
        mask = 0x40
        while first & mask:
            n_extra += 1
            mask >>= 1
        value = first & (mask - 1)
        for _ in range(n_extra):
            value = (value << 6) | (self.read_uint(8) & 0x3F)
        return value


_FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}

_BLOCK_SIZES = {
    1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
    13: 8192, 14: 16384, 15: 32768,
}

_SAMPLE_RATES = {
    1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
    7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000,
}

_BIT_DEPTHS = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


def _decode_residuals(br: _BitReader, block_size: int, order: int) -> List[int]:
    method = br.read_uint(2)
    if method > 1:
        raise ValueError("invalid residual coding method")
    param_bits = 4 if method == 0 else 5
    escape = (1 << param_bits) - 1
    partition_order = br.read_uint(4)
    n_partitions = 1 << partition_order
    residuals: List[int] = []
    for p in range(n_partitions):
        count = (block_size >> partition_order) - (order if p == 0 else 0)
        param = br.read_uint(param_bits)
        if param == escape:
            raw_bits = br.read_uint(5)
            residuals.extend(br.read_int(raw_bits) for _ in range(count))
        else:
            residuals.extend(br.read_rice(param) for _ in range(count))
    return residuals


def _decode_subframe(br: _BitReader, block_size: int, bits_per_sample: int):
    if br.read_uint(1) != 0:
        raise ValueError("invalid subframe padding bit")
    subframe_type = br.read_uint(6)
    wasted = 0
    if br.read_uint(1):  # wasted bits flag
        wasted = 1 + br.read_unary()
    bps = bits_per_sample - wasted

    if subframe_type == 0:  # CONSTANT
        value = br.read_int(bps)
        samples = [value] * block_size
    elif subframe_type == 1:  # VERBATIM
        samples = [br.read_int(bps) for _ in range(block_size)]
    elif 8 <= subframe_type <= 12:  # FIXED
        order = subframe_type - 8
        samples = [br.read_int(bps) for _ in range(order)]
        residuals = _decode_residuals(br, block_size, order)
        coeffs = _FIXED_COEFFS[order]
        for res in residuals:
            pred = sum(c * samples[-i - 1] for i, c in enumerate(coeffs))
            samples.append(res + pred)
    elif subframe_type >= 32:  # LPC
        order = subframe_type - 31
        samples = [br.read_int(bps) for _ in range(order)]
        precision = br.read_uint(4) + 1
        shift = br.read_int(5)
        coeffs = [br.read_int(precision) for _ in range(order)]
        residuals = _decode_residuals(br, block_size, order)
        for res in residuals:
            pred = sum(c * samples[-i - 1] for i, c in enumerate(coeffs)) >> shift
            samples.append(res + pred)
    else:
        raise ValueError(f"reserved subframe type {subframe_type}")
    if wasted:
        samples = [s << wasted for s in samples]
    return samples


def decode_flac(data: bytes) -> Tuple[np.ndarray, int]:
    """FLAC bytes -> (float32 mono audio in [-1,1), sample_rate)."""
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC file")
    pos = 4
    sample_rate = None
    n_channels = None
    bits_per_sample = None
    total_samples = 0
    while True:
        header = data[pos]
        last = header & 0x80
        block_type = header & 0x7F
        length = int.from_bytes(data[pos + 1 : pos + 4], "big")
        body = pos + 4
        if block_type == 0:  # STREAMINFO
            br = _BitReader(data, body)
            br.read_uint(16)  # min block
            br.read_uint(16)  # max block
            br.read_uint(24)  # min frame
            br.read_uint(24)  # max frame
            sample_rate = br.read_uint(20)
            n_channels = br.read_uint(3) + 1
            bits_per_sample = br.read_uint(5) + 1
            total_samples = br.read_uint(36)
        pos = body + length
        if last:
            break
    if sample_rate is None:
        raise ValueError("FLAC missing STREAMINFO")

    channels_out: List[List[int]] = [[] for _ in range(n_channels)]
    while pos < len(data) - 2:
        # frame sync: 14 bits 0b11111111111110
        if data[pos] != 0xFF or (data[pos + 1] & 0xFC) != 0xF8:
            raise ValueError(f"lost FLAC frame sync at {pos}")
        br = _BitReader(data, pos)
        br.read_uint(14)
        br.read_uint(1)  # reserved
        br.read_uint(1)  # blocking strategy
        bs_code = br.read_uint(4)
        sr_code = br.read_uint(4)
        ch_code = br.read_uint(4)
        depth_code = br.read_uint(3)
        br.read_uint(1)  # reserved
        br.read_utf8_number()  # frame/sample number
        if bs_code == 6:
            block_size = br.read_uint(8) + 1
        elif bs_code == 7:
            block_size = br.read_uint(16) + 1
        else:
            block_size = _BLOCK_SIZES[bs_code]
        if sr_code == 12:
            br.read_uint(8)
        elif sr_code in (13, 14):
            br.read_uint(16)
        br.read_uint(8)  # header CRC
        depth = _BIT_DEPTHS.get(depth_code, bits_per_sample)

        if ch_code < 8:
            n_ch = ch_code + 1
            subframes = [
                _decode_subframe(br, block_size, depth) for _ in range(n_ch)
            ]
        else:
            # stereo decorrelation: 8 = left/side, 9 = right/side, 10 = mid/side
            side_first = ch_code == 9
            bits_a = depth + (1 if side_first else 0)
            bits_b = depth + (0 if side_first else 1)
            a = _decode_subframe(br, block_size, bits_a)
            b = _decode_subframe(br, block_size, bits_b)
            if ch_code == 8:  # left, side
                left = a
                right = [l - s for l, s in zip(a, b)]
            elif ch_code == 9:  # side, right
                right = b
                left = [s + r for s, r in zip(a, b)]
            else:  # mid, side
                left, right = [], []
                for m, s in zip(a, b):
                    mm = (m << 1) | (s & 1)
                    left.append((mm + s) >> 1)
                    right.append((mm - s) >> 1)
            subframes = [left, right]
        br.align()
        br.read_uint(16)  # frame CRC
        pos = br.pos
        for ch, samples in enumerate(subframes):
            channels_out[ch].extend(samples)
        if total_samples and len(channels_out[0]) >= total_samples:
            break

    arr = np.asarray(channels_out, np.float64)
    if total_samples:
        arr = arr[:, :total_samples]
    mono = arr.mean(axis=0)
    scale = float(1 << (bits_per_sample - 1))
    return (mono / scale).astype(np.float32), sample_rate


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        return decode_flac(f.read())
