"""Pure-Python Ogg Vorbis decoder (Vorbis I).

The reference reads OGG_VORBIS samples through pyogg/libvorbis
(util/audio.py Sample conversions); neither library exists in this
build, so this module implements the decode spec directly: Ogg packet
reassembly (stt_tpu_torch.data.ogg), setup-header parsing (codebooks with
canonical Huffman codeword assignment, floor type 1, residue types
0/1/2, mappings, modes), then per-packet floor-curve synthesis, residue
VQ accumulation, channel un-coupling, IMDCT and lapped windowing.

Scope: Vorbis I as produced by every mainstream encoder — floor type 0
(legacy, unused by encoders for ~20 years) is rejected with a clear
error. Output is float32 in [-1, 1].

Spec: https://xiph.org/vorbis/doc/Vorbis_I_spec.html (implemented from
the published specification; no code derived from libvorbis).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from stt_tpu_torch.data.ogg import ogg_packets


def ilog(x: int) -> int:
    """Position of the highest set bit (spec §9.2.1); ilog(0) = 0."""
    return x.bit_length() if x > 0 else 0


def float32_unpack(x: int) -> float:
    """Vorbis packed float (spec §9.2.2)."""
    mantissa = x & 0x1FFFFF
    sign = x & 0x80000000
    exponent = (x & 0x7FE00000) >> 21
    if sign:
        mantissa = -mantissa
    return float(mantissa) * (2.0 ** (exponent - 788))


def lookup1_values(entries: int, dim: int) -> int:
    """Largest integer v with v**dim <= entries (spec §9.2.3)."""
    v = int(entries ** (1.0 / dim))
    while (v + 1) ** dim <= entries:
        v += 1
    while v**dim > entries:
        v -= 1
    return v


class EndOfPacket(Exception):
    pass


class BitReader:
    """LSb-first bit reader over one packet (spec §2)."""

    __slots__ = ("data", "pos", "acc", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def read(self, n: int) -> int:
        while self.nbits < n:
            if self.pos >= len(self.data):
                raise EndOfPacket()
            self.acc |= self.data[self.pos] << self.nbits
            self.pos += 1
            self.nbits += 8
        value = self.acc & ((1 << n) - 1)
        self.acc >>= n
        self.nbits -= n
        return value

    def read_bit(self) -> int:
        if self.nbits == 0:
            if self.pos >= len(self.data):
                raise EndOfPacket()
            self.acc = self.data[self.pos]
            self.pos += 1
            self.nbits = 8
        value = self.acc & 1
        self.acc >>= 1
        self.nbits -= 1
        return value


def assign_codewords(lengths: List[int]) -> Dict[Tuple[int, int], int]:
    """Canonical Vorbis codeword assignment: each used entry, in order,
    takes the lowest available codeword of its length (spec §3.2.1).
    Returns {(length, codeword): entry} with codewords MSb-first."""
    table: Dict[Tuple[int, int], int] = {}
    marker = [0] * 33
    used = [i for i, l in enumerate(lengths) if l > 0]
    if not used:
        return table
    if len(used) == 1:
        # single-entry codebook: one 1-bit codeword (spec special case)
        table[(1, 0)] = used[0]
        return table
    for entry in used:
        length = lengths[entry]
        word = marker[length]
        if length < 32 and (word >> length):
            raise ValueError("overspecified Huffman tree")
        table[(length, word)] = entry
        # increment markers (libvorbis-equivalent bookkeeping, re-derived)
        for j in range(length, 0, -1):
            if marker[j] & 1:
                if j == 1:
                    marker[1] += 1
                else:
                    marker[j] = marker[j - 1] << 1
                break
            marker[j] += 1
        for j in range(length + 1, 33):
            if (marker[j] >> 1) == word:
                word = marker[j]
                marker[j] = marker[j - 1] << 1
            else:
                break
    return table


@dataclasses.dataclass
class Codebook:
    dimensions: int
    entries: int
    table: Dict[Tuple[int, int], int]
    max_length: int
    vq: Optional[np.ndarray]  # [entries, dimensions] float32 or None

    def decode(self, br: BitReader) -> int:
        code = 0
        length = 0
        table = self.table
        while length <= self.max_length:
            code = (code << 1) | br.read_bit()
            length += 1
            entry = table.get((length, code))
            if entry is not None:
                return entry
        raise ValueError("invalid Huffman codeword")


def read_codebook(br: BitReader) -> Codebook:
    if br.read(24) != 0x564342:  # 'BCV'
        raise ValueError("bad codebook sync")
    dimensions = br.read(16)
    entries = br.read(24)
    lengths = [0] * entries
    if br.read_bit():  # ordered
        current_entry = 0
        current_length = br.read(5) + 1
        while current_entry < entries:
            number = br.read(ilog(entries - current_entry))
            for i in range(current_entry, current_entry + number):
                lengths[i] = current_length
            current_entry += number
            current_length += 1
            if current_entry > entries:
                raise ValueError("codebook lengths overflow")
    else:
        sparse = br.read_bit()
        for i in range(entries):
            if sparse:
                if br.read_bit():
                    lengths[i] = br.read(5) + 1
            else:
                lengths[i] = br.read(5) + 1

    table = assign_codewords(lengths)
    max_length = max((l for l in lengths if l), default=0)
    if len(table) == 1:
        max_length = 1

    lookup_type = br.read(4)
    vq = None
    if lookup_type in (1, 2):
        minimum = float32_unpack(br.read(32))
        delta = float32_unpack(br.read(32))
        value_bits = br.read(4) + 1
        sequence_p = br.read_bit()
        if lookup_type == 1:
            mult_count = lookup1_values(entries, dimensions)
        else:
            mult_count = entries * dimensions
        mults = np.array(
            [br.read(value_bits) for _ in range(mult_count)], np.float64
        )
        vq = np.zeros((entries, dimensions), np.float64)
        if lookup_type == 1:
            for e in range(entries):
                last = 0.0
                index_divisor = 1
                for d in range(dimensions):
                    offset = (e // index_divisor) % mult_count
                    value = mults[offset] * delta + minimum + last
                    vq[e, d] = value
                    if sequence_p:
                        last = value
                    index_divisor *= mult_count
        else:
            for e in range(entries):
                last = 0.0
                for d in range(dimensions):
                    value = mults[e * dimensions + d] * delta + minimum + last
                    vq[e, d] = value
                    if sequence_p:
                        last = value
        vq = vq.astype(np.float32)
    elif lookup_type != 0:
        raise ValueError(f"bad codebook lookup type {lookup_type}")
    return Codebook(dimensions, entries, table, max_length, vq)


@dataclasses.dataclass
class Floor1:
    partition_class_list: List[int]
    class_dimensions: List[int]
    class_subclasses: List[int]
    class_masterbooks: List[int]
    subclass_books: List[List[int]]
    multiplier: int
    x_list: List[int]
    # precomputed
    neighbors: List[Tuple[int, int]]
    sort_order: List[int]


def read_floor1(br: BitReader) -> Floor1:
    partitions = br.read(5)
    partition_class_list = [br.read(4) for _ in range(partitions)]
    maximum_class = max(partition_class_list, default=-1)
    class_dimensions, class_subclasses = [], []
    class_masterbooks, subclass_books = [], []
    for _ in range(maximum_class + 1):
        class_dimensions.append(br.read(3) + 1)
        subclasses = br.read(2)
        class_subclasses.append(subclasses)
        class_masterbooks.append(br.read(8) if subclasses else -1)
        subclass_books.append(
            [br.read(8) - 1 for _ in range(1 << subclasses)]
        )
    multiplier = br.read(2) + 1
    rangebits = br.read(4)
    x_list = [0, 1 << rangebits]
    for i in range(partitions):
        cls = partition_class_list[i]
        for _ in range(class_dimensions[cls]):
            x_list.append(br.read(rangebits))
    if len(set(x_list)) != len(x_list):
        raise ValueError("floor1 X values not unique")

    # low/high neighbors (spec §9.2.4): nearest smaller/greater X among
    # positions BEFORE i
    neighbors = [(0, 0), (0, 0)]
    for i in range(2, len(x_list)):
        low = max(range(i), key=lambda j: (x_list[j] < x_list[i], x_list[j]))
        high = min(
            range(i),
            key=lambda j: (x_list[j] <= x_list[i], x_list[j]),
        )
        neighbors.append((low, high))
    sort_order = sorted(range(len(x_list)), key=lambda j: x_list[j])
    return Floor1(
        partition_class_list, class_dimensions, class_subclasses,
        class_masterbooks, subclass_books, multiplier, x_list,
        neighbors, sort_order,
    )


RANGES = [256, 128, 86, 64]

# floor1 amplitude -> linear (spec's inverse dB table; table[255] = 1.0,
# each step ~0.547 dB)
INVERSE_DB_TABLE = np.exp((np.arange(256) - 255) * 0.06296938).astype(
    np.float32
)


def render_point(x0: int, y0: int, x1: int, y1: int, x: int) -> int:
    dy = y1 - y0
    adx = x1 - x0
    err = abs(dy) * (x - x0)
    off = err // adx
    return y0 - off if dy < 0 else y0 + off


def render_line(x0: int, y0: int, x1: int, y1: int, v: np.ndarray) -> None:
    n = len(v)
    dy = y1 - y0
    adx = x1 - x0
    base = int(dy / adx)  # C truncation toward zero
    x = x0
    y = y0
    err = 0
    ady = abs(dy) - abs(base) * adx
    sy = base + 1 if dy >= 0 else base - 1
    if x0 < n:
        v[x0] = y0
    for x in range(x0 + 1, min(x1, n)):
        err += ady
        if err >= adx:
            err -= adx
            y += sy
        else:
            y += base
        v[x] = y


def decode_floor1(br: BitReader, floor: Floor1, books: List[Codebook],
                  n2: int) -> Optional[np.ndarray]:
    """-> linear floor curve [n2] or None when the channel is unused."""
    if not br.read_bit():
        return None
    rng = RANGES[floor.multiplier - 1]
    x_list = floor.x_list
    posts = len(x_list)
    y = [0] * posts
    bits = ilog(rng - 1)
    y[0] = br.read(bits)
    y[1] = br.read(bits)
    offset = 2
    for cls in floor.partition_class_list:
        cdim = floor.class_dimensions[cls]
        cbits = floor.class_subclasses[cls]
        csub = (1 << cbits) - 1
        cval = 0
        if cbits:
            cval = books[floor.class_masterbooks[cls]].decode(br)
        for _ in range(cdim):
            book = floor.subclass_books[cls][cval & csub]
            cval >>= cbits
            y[offset] = books[book].decode(br) if book >= 0 else 0
            offset += 1

    # amplitude synthesis (spec §7.2.2.2)
    final_y = [0] * posts
    step2 = [False] * posts
    final_y[0], final_y[1] = y[0], y[1]
    step2[0] = step2[1] = True
    for i in range(2, posts):
        low, high = floor.neighbors[i]
        predicted = render_point(
            x_list[low], final_y[low], x_list[high], final_y[high], x_list[i]
        )
        val = y[i]
        highroom = rng - predicted
        lowroom = predicted
        room = 2 * min(highroom, lowroom)
        if val:
            step2[low] = step2[high] = step2[i] = True
            if val >= room:
                final_y[i] = (
                    val - lowroom + predicted
                    if highroom > lowroom
                    else predicted - (val - highroom) - 1
                )
            elif val & 1:
                final_y[i] = predicted - ((val + 1) >> 1)
            else:
                final_y[i] = predicted + (val >> 1)
        else:
            final_y[i] = predicted

    # curve synthesis (spec §7.2.3): render lines between step2 posts
    curve = np.zeros(n2, np.int32)
    order = floor.sort_order
    lx, ly = 0, final_y[order[0]] * floor.multiplier
    for j in order[1:]:
        if not step2[j]:
            continue
        hx = x_list[j]
        hy = (final_y[j] & (rng - 1)) * floor.multiplier
        if hx > lx:
            render_line(lx, ly, min(hx, n2), hy, curve)
        lx, ly = hx, hy
        if lx >= n2:
            break
    if lx < n2:
        curve[lx:] = ly
    return INVERSE_DB_TABLE[np.clip(curve, 0, 255)]


@dataclasses.dataclass
class Residue:
    kind: int
    begin: int
    end: int
    partition_size: int
    classifications: int
    classbook: int
    books: List[List[int]]  # [class][pass] (-1 = unused)


def read_residue(br: BitReader, kind: int) -> Residue:
    begin = br.read(24)
    end = br.read(24)
    partition_size = br.read(24) + 1
    classifications = br.read(6) + 1
    classbook = br.read(8)
    cascade = []
    for _ in range(classifications):
        low = br.read(3)
        high = br.read(5) if br.read_bit() else 0
        cascade.append((high << 3) | low)
    books = []
    for c in range(classifications):
        row = []
        for p in range(8):
            row.append(br.read(8) if (cascade[c] >> p) & 1 else -1)
        books.append(row)
    return Residue(kind, begin, end, partition_size, classifications,
                   classbook, books)


def decode_residue(br: BitReader, res: Residue, books: List[Codebook],
                   n2: int, do_not_decode: List[bool]) -> np.ndarray:
    """-> [ch, n2] float32 residue vectors (spec §8.6.2)."""
    ch = len(do_not_decode)
    if res.kind == 2:
        vectors = np.zeros((1, n2 * ch), np.float32)
        decode_ch = [not all(do_not_decode)]
        actual_size = n2 * ch
    else:
        vectors = np.zeros((ch, n2), np.float32)
        decode_ch = [not d for d in do_not_decode]
        actual_size = n2
    begin = min(res.begin, actual_size)
    end = min(res.end, actual_size)
    psize = res.partition_size
    partitions_to_read = (end - begin) // psize
    if partitions_to_read == 0:
        out = vectors
    else:
        classbook = books[res.classbook]
        cdim = classbook.dimensions
        n_vec = len(vectors)
        classifs = np.zeros((n_vec, partitions_to_read + cdim), np.int64)
        for p in range(8):
            partition_count = 0
            while partition_count < partitions_to_read:
                if p == 0:
                    for j in range(n_vec):
                        if not decode_ch[j]:
                            continue
                        temp = classbook.decode(br)
                        for i in range(cdim - 1, -1, -1):
                            classifs[j, partition_count + i] = (
                                temp % res.classifications
                            )
                            temp //= res.classifications
                i = 0
                while i < cdim and partition_count < partitions_to_read:
                    offset = begin + partition_count * psize
                    for j in range(n_vec):
                        if not decode_ch[j]:
                            continue
                        vqclass = int(classifs[j, partition_count])
                        book_idx = res.books[vqclass][p]
                        if book_idx < 0:
                            continue
                        book = books[book_idx]
                        dim = book.dimensions
                        v = vectors[j]
                        if res.kind == 0:
                            step = psize // dim
                            for k in range(step):
                                vec = book.vq[book.decode(br)]
                                v[offset + k : offset + k + step * dim : step] += vec
                        else:  # types 1 and 2
                            t = 0
                            while t < psize:
                                vec = book.vq[book.decode(br)]
                                v[offset + t : offset + t + dim] += vec
                                t += dim
                    i += 1
                    partition_count += 1
        out = vectors
    if res.kind == 2 and ch > 1:
        return out.reshape(n2, ch).T.copy()
    if res.kind == 2:
        return out.reshape(1, n2)
    return out


@dataclasses.dataclass
class Mapping:
    coupling_steps: List[Tuple[int, int]]  # (magnitude_ch, angle_ch)
    mux: List[int]
    submap_floor: List[int]
    submap_residue: List[int]


def read_mapping(br: BitReader, channels: int) -> Mapping:
    if br.read(16) != 0:
        raise ValueError("unsupported mapping type")
    submaps = br.read(4) + 1 if br.read_bit() else 1
    coupling_steps = []
    if br.read_bit():
        for _ in range(br.read(8) + 1):
            bits = ilog(channels - 1)
            coupling_steps.append((br.read(bits), br.read(bits)))
    if br.read(2) != 0:
        raise ValueError("reserved mapping bits set")
    if submaps > 1:
        mux = [br.read(4) for _ in range(channels)]
    else:
        mux = [0] * channels
    submap_floor, submap_residue = [], []
    for _ in range(submaps):
        br.read(8)  # unused time configuration placeholder
        submap_floor.append(br.read(8))
        submap_residue.append(br.read(8))
    return Mapping(coupling_steps, mux, submap_floor, submap_residue)


@dataclasses.dataclass
class Mode:
    blockflag: int
    mapping: int


class VorbisDecoder:
    def __init__(self, data: bytes):
        packets = ogg_packets(data)
        ident, _ = next(packets)
        if ident[:7] != b"\x01vorbis":
            raise ValueError("not a Vorbis stream")
        br = BitReader(ident[7:])
        if br.read(32) != 0:
            raise ValueError("unsupported Vorbis version")
        self.channels = br.read(8)
        self.sample_rate = br.read(32)
        br.read(32)  # bitrate max
        br.read(32)  # bitrate nominal
        br.read(32)  # bitrate min
        self.blocksize0 = 1 << br.read(4)
        self.blocksize1 = 1 << br.read(4)

        comment, _ = next(packets)  # skipped
        setup, _ = next(packets)
        if setup[:7] != b"\x05vorbis":
            raise ValueError("missing setup header")
        self._parse_setup(BitReader(setup[7:]))
        self._packets = packets
        self._imdct_cache: Dict[int, np.ndarray] = {}
        self._window_cache: Dict[int, np.ndarray] = {}

    def _parse_setup(self, br: BitReader) -> None:
        self.codebooks = [read_codebook(br) for _ in range(br.read(8) + 1)]
        for _ in range(br.read(6) + 1):  # time domain transforms (unused)
            if br.read(16) != 0:
                raise ValueError("nonzero time transform")
        self.floors = []
        for _ in range(br.read(6) + 1):
            floor_type = br.read(16)
            if floor_type == 1:
                self.floors.append(read_floor1(br))
            elif floor_type == 0:
                raise ValueError(
                    "floor type 0 (legacy) is not supported by this decoder"
                )
            else:
                raise ValueError(f"bad floor type {floor_type}")
        self.residues = []
        for _ in range(br.read(6) + 1):
            kind = br.read(16)
            if kind > 2:
                raise ValueError(f"bad residue type {kind}")
            self.residues.append(read_residue(br, kind))
        self.mappings = [
            read_mapping(br, self.channels) for _ in range(br.read(6) + 1)
        ]
        self.modes = []
        for _ in range(br.read(6) + 1):
            blockflag = br.read_bit()
            if br.read(16) != 0 or br.read(16) != 0:
                raise ValueError("nonzero mode window/transform type")
            self.modes.append(Mode(blockflag, br.read(8)))
        if not br.read_bit():
            raise ValueError("setup framing bit unset")

    # -- transforms ----------------------------------------------------------

    def _imdct_matrix(self, n: int) -> np.ndarray:
        if n not in self._imdct_cache:
            k = np.arange(n // 2, dtype=np.float64)
            t = np.arange(n, dtype=np.float64)
            self._imdct_cache[n] = np.cos(
                (2.0 * np.pi / n)
                * np.outer(t + 0.5 + n / 4.0, k + 0.5)
            ).astype(np.float32)
        return self._imdct_cache[n]

    def _slope(self, half: int) -> np.ndarray:
        if half not in self._window_cache:
            i = np.arange(half, dtype=np.float64) + 0.5
            s = np.sin(i / (2 * half) * np.pi)
            self._window_cache[half] = np.sin(0.5 * np.pi * s * s).astype(
                np.float32
            )
        return self._window_cache[half]

    # -- audio packets ---------------------------------------------------------

    def _decode_packet(self, packet: bytes):
        """-> (pcm [n, ch] windowed block, n) or None for non-audio."""
        br = BitReader(packet)
        try:
            if br.read_bit() != 0:
                return None
            mode = self.modes[br.read(ilog(len(self.modes) - 1))]
            n = self.blocksize1 if mode.blockflag else self.blocksize0
            prev_flag = next_flag = 1
            if mode.blockflag:
                prev_flag = br.read_bit()
                next_flag = br.read_bit()
            mapping = self.mappings[mode.mapping]
            n2 = n // 2

            floors = []
            no_residue = []
            for c in range(self.channels):
                floor_idx = mapping.submap_floor[mapping.mux[c]]
                curve = decode_floor1(
                    br, self.floors[floor_idx], self.codebooks, n2
                )
                floors.append(curve)
                no_residue.append(curve is None)
            # nonzero-vector propagation through coupling (spec §4.3.3)
            for mag, ang in mapping.coupling_steps:
                if not (no_residue[mag] and no_residue[ang]):
                    no_residue[mag] = no_residue[ang] = False

            residue_vectors = np.zeros((self.channels, n2), np.float32)
            n_submaps = len(mapping.submap_residue)
            for s in range(n_submaps):
                chans = [c for c in range(self.channels)
                         if mapping.mux[c] == s]
                dnd = [no_residue[c] for c in chans]
                res = self.residues[mapping.submap_residue[s]]
                decoded = decode_residue(br, res, self.codebooks, n2, dnd)
                for i, c in enumerate(chans):
                    residue_vectors[c] = decoded[i]
        except EndOfPacket:
            # end-of-packet during audio decode: spec says the partial
            # data decoded so far is used as-is
            if "residue_vectors" not in dir():
                return None
            pass

        # inverse coupling (spec §4.3.5)
        for mag, ang in reversed(mapping.coupling_steps):
            m = residue_vectors[mag].copy()
            a = residue_vectors[ang].copy()
            new_m = np.where(
                m > 0, np.where(a > 0, m, m + a), np.where(a > 0, m, m - a)
            )
            new_a = np.where(
                m > 0, np.where(a > 0, m - a, m), np.where(a > 0, m + a, m)
            )
            residue_vectors[mag] = new_m
            residue_vectors[ang] = new_a

        # floor multiply + IMDCT + window
        imdct = self._imdct_matrix(n)
        pcm = np.zeros((n, self.channels), np.float32)
        for c in range(self.channels):
            if floors[c] is None:
                continue
            spectral = residue_vectors[c] * floors[c]
            pcm[:, c] = imdct @ spectral

        window = np.ones(n, np.float32)
        n0 = self.blocksize0
        if mode.blockflag and not prev_flag:
            left_start = n // 4 - n0 // 4
            window[:left_start] = 0.0
            window[left_start : left_start + n0 // 2] = self._slope(n0 // 2)
        else:
            window[: n // 2] = self._slope(n // 2)
        if mode.blockflag and not next_flag:
            right_start = (3 * n) // 4 - n0 // 4
            window[right_start : right_start + n0 // 2] = self._slope(
                n0 // 2
            )[::-1]
            window[right_start + n0 // 2 :] = 0.0
        else:
            window[n // 2 :] = self._slope(n // 2)[::-1]
        return pcm * window[:, None], n

    def decode(self) -> Tuple[np.ndarray, int]:
        """Decode the whole stream -> (float32 [samples, channels], rate)."""
        chunks = []
        pos = 0
        prev_n = 0
        total = 0
        last_granule = -1
        for packet, granule in self._packets:
            out = self._decode_packet(packet)
            if out is None:
                continue
            pcm, n = out
            if prev_n:
                pos += prev_n // 4 + n // 4
            chunks.append((pos, pcm))
            total = pos + n
            prev_n = n
            if granule >= 0:
                last_granule = granule
        if not chunks:
            return np.zeros((0, self.channels), np.float32), self.sample_rate
        acc = np.zeros((total, self.channels), np.float32)
        for start, pcm in chunks:
            acc[start : start + len(pcm)] += pcm
        first_n = len(chunks[0][1])
        start = first_n // 2
        audio = acc[start:]
        if last_granule >= 0:
            audio = audio[: last_granule]
        return np.clip(audio, -1.0, 1.0), self.sample_rate


def read_vorbis(path: str) -> Tuple[np.ndarray, int]:
    """Decode an Ogg Vorbis file -> (float32 mono-or-[n, ch] audio, rate)."""
    with open(path, "rb") as f:
        decoder = VorbisDecoder(f.read())
    audio, rate = decoder.decode()
    if audio.ndim == 2 and audio.shape[1] == 1:
        audio = audio[:, 0]
    return audio, rate
