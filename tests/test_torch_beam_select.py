"""A numpy replay of K5's top-W selection (`csrc/beam_scan.cu`): the pool's
keys as `make_key` builds them, the compaction of the live keys by warp
segments, the most-significant-byte-first radix select that starts at the
highest byte in which the keys differ, the gathering of the W keys at or
above the W-th (in any order: the kernel gathers them by atomics), and the
final bitonic network. The kernel runs only on the card; this holds the
selection's logic against a stable descending sort of the values, which is
the order the plain scan (`decode/device.py`) ranks its pool in: value
descending, ties to the lower flat index. Only the finite keys are ranked;
-inf ones become dead slots whose fields do not depend on which won.
The wide instance (byte alphabets) runs the same selection over a pool in
device memory of up to 512 x 257 keys; its replay reads the limits of both
instances from the source.
"""

import re
from pathlib import Path

import numpy as np
import pytest

MASK32 = 0xFFFFFFFF


def make_key(v: float, flat: int) -> int:
    """beam_scan.cu's make_key: order-preserving float bits above ~flat."""
    bits = int(np.array([v + np.float32(0.0)], np.float32).view(np.uint32)[0])
    hi = (~bits & MASK32) if bits & 0x80000000 else (bits | 0x80000000)
    return (hi << 32) | (~flat & MASK32)


def key_value(key: int) -> float:
    hi = key >> 32
    bits = (hi & 0x7FFFFFFF) if hi & 0x80000000 else (~hi & MASK32)
    return float(np.array([bits], np.uint32).view(np.float32)[0])


def compact(values: np.ndarray, threads: int) -> list:
    """The live keys, warp by warp: warp w takes flat indices [w seg,
    (w + 1) seg) and writes its live keys in order at its offset."""
    n_pool = len(values)
    seg = -(-n_pool // threads) * 32
    keys = []
    for warp in range(threads // 32):
        for f in range(warp * seg, min((warp + 1) * seg, n_pool)):
            if values[f] > -np.inf:
                keys.append(make_key(values[f], f))
    return keys


def radix_select(keys: list, W: int):
    """(prefix, shift): the W largest keys are those whose bits at and above
    `shift` are at least the prefix's."""
    lo, hi = min(keys), max(keys)
    shift = ((hi ^ lo).bit_length() - 1) // 8 * 8
    prefix = 0 if shift == 56 else (hi >> (shift + 8)) << (shift + 8)
    need = W
    while True:
        above = shift + 8
        hist = [0] * 256
        for key in keys:
            if above == 64 or key >> above == prefix >> above:
                hist[(key >> shift) & 255] += 1
        before = 0
        for digit in range(255, -1, -1):  # the bins from the top
            if before < need <= before + hist[digit]:
                break
            before += hist[digit]
        prefix |= digit << shift
        need -= before
        if hist[digit] == need or shift == 0:
            return prefix, shift
        shift -= 8


def bitonic_desc(keys: list) -> list:
    """The kernel's network over L = len(keys) (a power of two), key i held
    by thread i."""
    x = list(keys)
    L = len(x)
    k = 2
    while k <= L:
        j = k >> 1
        while j > 0:
            y = [x[i ^ j] for i in range(L)]
            x = [max(x[i], y[i]) if ((i & j) == 0) == ((i & k) == 0) else min(x[i], y[i])
                 for i in range(L)]
            j >>= 1
        k <<= 1
    return x


def select(values: np.ndarray, W: int, threads: int, rng) -> list:
    """The kernel's top W of the pool: the winners' keys, best first; the
    slots past them are dead."""
    live = compact(values, threads)
    if len(live) > W:
        prefix, shift = radix_select(live, W)
        top = [key for key in live if key >> shift >= prefix >> shift]
        assert len(top) == W
    else:
        top = live
    order = rng.permutation(len(top))  # gathered by atomics: any order
    top = [top[i] for i in order]
    L = 1 << max(len(top) - 1, 0).bit_length()
    return bitonic_desc(top + [0] * (L - len(top)))[:len(top)]


def reference(values: np.ndarray, W: int) -> list:
    order = np.argsort(-values, kind="stable")  # value descending, ties by index
    return [make_key(values[f], int(f)) for f in order[:W] if values[f] > -np.inf]


def pool(kind: str, W: int, C: int, rng) -> np.ndarray:
    n = W + W * C
    if kind == "flat":  # log-probabilities of near-uniform emissions
        v = np.log(rng.uniform(0.02, 0.05, n)).astype(np.float32) - 3.0
    elif kind == "peaky":
        v = (rng.normal(size=n) * 8 - 20).astype(np.float32)
    elif kind == "ties":  # few distinct values: ranks decided by flat index
        v = rng.choice(np.float32([-1.5, -2.25, -2.5, -7.0]), n)
    elif kind == "few_live":
        v = np.full(n, -np.inf, np.float32)
        live = rng.choice(n, size=max(1, W // 3), replace=False)
        v[live] = rng.normal(size=len(live)).astype(np.float32)
    elif kind == "all_dead":
        v = np.full(n, -np.inf, np.float32)
    else:  # mixed: dead slots and struck children among flat values, and +-0
        v = np.log(rng.uniform(0.01, 1.0, n)).astype(np.float32)
        v[rng.uniform(size=n) < 0.3] = -np.inf
        v[:2] = [0.0, -0.0]
    return v


@pytest.mark.parametrize("kind", ["flat", "peaky", "ties", "few_live", "all_dead", "mixed"])
@pytest.mark.parametrize("W,C", [(8, 8), (32, 29), (500, 29), (512, 31)])
def test_selection_equals_a_stable_descending_sort(kind, W, C):
    rng = np.random.default_rng(W * 7 + C + len(kind))
    values = pool(kind, W, C, rng)
    n_pool = len(values)
    threads = 128 if n_pool <= 512 else 256 if n_pool <= 2048 else 512 if n_pool <= 8192 else 1024
    threads = max(threads, 1 << (W - 1).bit_length())
    got = select(values, W, threads, rng)
    want = reference(values, W)
    assert got == want
    assert len(got) == min(W, int(np.isfinite(values).sum()))
    for key in got:  # a winner's value and flat index come back off its key
        flat = ~key & MASK32
        assert key_value(key) == values[flat] + np.float32(0.0)


def test_keys_order_as_value_then_flat_index():
    assert make_key(-1.0, 5) > make_key(-1.0, 6) > make_key(-1.5, 0)
    assert make_key(0.5, 9) > make_key(0.0, 0) == make_key(-0.0, 0) > make_key(-1e-30, 0)
    assert make_key(-3e38, 16383) > 0  # every real key is above the sort's padding


def table_place(key: int) -> int:
    """beam_scan.cu's table_place: 10 bits of a multiplicative hash."""
    return (((key ^ (key >> 29)) * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF) >> 54


def parents_by_table(ha, hb, pha, phb, live, last, rng) -> list:
    """The kernel's parent lookup: every live slot inserted, in any order,
    under its hash pair (linear probing over 1,024 places, the pair (0, 0)
    counted beside the table), each place keeping the first slot and the
    count; then each slot with a last label looks its parent pair up."""
    tab, zero = {}, [512, 0]
    keys = [None] * 1024
    for i in rng.permutation(len(ha)):
        if not live[i]:
            continue
        key = (int(ha[i]) & MASK32) << 32 | (int(hb[i]) & MASK32)
        if key == 0:
            zero = [min(zero[0], i), zero[1] + 1]
            continue
        at = table_place(key)
        while keys[at] is not None and keys[at] != key:
            at = (at + 1) % 1024
        keys[at] = key
        first, hits = tab.get(at, (512, 0))
        tab[at] = (min(first, i), hits + 1)
    out = []
    for j in range(len(ha)):
        par = hits = 0
        if last[j] >= 0:
            key = (int(pha[j]) & MASK32) << 32 | (int(phb[j]) & MASK32)
            if key == 0:
                first, hits = zero
            else:
                at = table_place(key)
                while keys[at] is not None and keys[at] != key:
                    at = (at + 1) % 1024
                first, hits = tab.get(at, (0, 0)) if keys[at] == key else (0, 0)
            par = first if hits else 0
        out.append((par, hits))
    return out


@pytest.mark.parametrize("W", [8, 32, 500, 512])
def test_parent_table_finds_what_the_scan_finds(W):
    """par = the first live slot whose hashes are j's parent hashes, hits =
    how many: hash collisions (several live slots with one pair), dead slots
    that share a pair, the pair (0, 0), and pairs crowded into a few places."""
    rng = np.random.default_rng(W)
    ha = rng.integers(-2**31, 2**31, W, dtype=np.int64).astype(np.int32)
    hb = rng.integers(-2**31, 2**31, W, dtype=np.int64).astype(np.int32)
    ha[1::7], hb[1::7] = ha[0], hb[0]  # one pair in many slots
    ha[2], hb[2] = 0, 0
    live = rng.uniform(size=W) < 0.8
    live[0] = False  # the first slot with the shared pair is dead
    pick = rng.integers(0, W, W)
    pha, phb = ha[pick].copy(), hb[pick].copy()
    pha[::5] = rng.integers(-2**31, 2**31, len(pha[::5]), dtype=np.int64).astype(np.int32)
    pha[3], phb[3] = 0, 0
    last = rng.integers(-1, 29, W)
    ha[W - 1], hb[W - 1] = ha[0], hb[0]
    live[1] = live[W - 1] = True
    pha[4], phb[4], last[4] = ha[0], hb[0], 3  # two live matches
    want = []
    for j in range(W):
        matches = [i for i in range(W) if live[i] and ha[i] == pha[j] and hb[i] == phb[j]]
        want.append(((matches[0] if matches else 0), len(matches)) if last[j] >= 0 else (0, 0))
    assert parents_by_table(ha, hb, pha, phb, live, last, rng) == want
    assert any(h > 1 for _, h in want) and any(h == 0 for _, h in want)


# --- the wide instance: byte alphabets, the pool in device memory -----------

CSRC = Path(__file__).resolve().parents[1] / "stt_tpu_torch" / "ops" / "csrc" / "beam_scan.cu"


def cu_constant(name: str) -> int:
    """An `constexpr int` of beam_scan.cu, as the kernel compiles it."""
    text = CSRC.read_text()
    expr = re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)
    names = {n: cu_constant(n) for n in re.findall(r"[A-Z_]{2,}", expr)}
    return int(eval(expr, {}, names))


def keys_np(values: np.ndarray, flats: np.ndarray) -> np.ndarray:
    """make_key over arrays: uint64 keys."""
    bits = (values.astype(np.float32) + np.float32(0.0)).view(np.uint32).astype(np.uint64)
    hi = np.where(bits & 0x80000000, ~bits & MASK32, bits | 0x80000000)
    return (hi << np.uint64(32)) | (~flats.astype(np.uint64) & MASK32)


def compact_np(values: np.ndarray, threads: int) -> np.ndarray:
    """The live keys as the wide instance writes them into its pool, warp
    segment by warp segment (the order of `compact`)."""
    seg = -(-len(values) // threads) * 32
    flats = np.concatenate([np.arange(w * seg, min((w + 1) * seg, len(values)))
                            for w in range(threads // 32)])
    flats = flats[values[flats] > -np.inf]
    return keys_np(values[flats], flats)


def radix_select_np(keys: np.ndarray, W: int):
    """radix_select over a uint64 array: the same passes, histograms by
    bincount."""
    lo, hi = int(keys.min()), int(keys.max())
    shift = ((hi ^ lo).bit_length() - 1) // 8 * 8
    prefix = 0 if shift == 56 else (hi >> (shift + 8)) << (shift + 8)
    need = W
    while True:
        above = shift + 8
        mine = keys if above == 64 else keys[(keys >> np.uint64(above)) == np.uint64(prefix >> above)]
        hist = np.bincount(((mine >> np.uint64(shift)) & np.uint64(255)).astype(np.int64),
                           minlength=256)
        before = 0
        for digit in range(255, -1, -1):
            if before < need <= before + hist[digit]:
                break
            before += hist[digit]
        prefix |= digit << shift
        need -= before
        if hist[digit] == need or shift == 0:
            return prefix, shift
        shift -= 8


def test_limits_of_the_two_instances_come_from_the_source():
    from stt_tpu_torch.ops import beam_kernel

    assert cu_constant("LN") == beam_kernel.LANES == 128
    assert cu_constant("WIDE_LN") == beam_kernel.WIDE_LANES == beam_kernel.MAX_CLASSES == 256
    assert cu_constant("MAX_POOL") == beam_kernel.MAX_POOL
    assert cu_constant("MAX_SLOTS") == beam_kernel.WIDE_SLOTS
    assert cu_constant("WIDE_POOL") == 512 * 257 == 131_584  # 1.05 MB of keys an utterance
    for W, C in ((500, 29), (128, 127), (512, 31), (8, 128), (256, 64), (500, 256)):
        narrow = C <= cu_constant("LN") - 1 and W * (C + 1) <= cu_constant("MAX_POOL")
        assert beam_kernel.is_narrow(W, C) == narrow
        assert W * (C + 1) <= (cu_constant("MAX_POOL") if narrow else cu_constant("WIDE_POOL"))
    # the wide instance's strike-out bits and masks fit its static shared memory
    static = (cu_constant("WIDE_POOL") + 31) // 32 * 4 + 5 * cu_constant("WIDE_LN") * 4
    static += 2 * 256 * 4 + cu_constant("TABLE") * 16 + 32 * 20
    assert static <= 48 * 1024


@pytest.mark.parametrize("kind", ["flat", "peaky", "ties", "mixed"])
@pytest.mark.parametrize("W,C", [(32, 256), (128, 200), (500, 256), (512, 256)])
def test_wide_selection_equals_a_stable_descending_sort(kind, W, C):
    """The wide instance's selection: the live keys compacted into the pool
    in device memory, the radix select over all of them (128,500 keys at
    beam 500), the W winners gathered in any order and sorted by the
    bitonic network: the flat indices of a stable descending sort."""
    from stt_tpu_torch.ops import beam_kernel

    assert not beam_kernel.is_narrow(W, C) and beam_kernel.supports(W, C)
    rng = np.random.default_rng(W + C + len(kind))
    values = pool(kind, W, C, rng)
    n_pool = len(values)
    threads = 1024 if n_pool > 8192 else 512
    live = compact_np(values, threads)
    assert len(live) == np.isfinite(values).sum()
    prefix, shift = radix_select_np(live, W)
    top = live[(live >> np.uint64(shift)) >= np.uint64(prefix >> shift)]
    assert len(top) == W
    top = [int(k) for k in rng.permutation(top)]
    L = 1 << (W - 1).bit_length()
    got = bitonic_desc(top + [0] * (L - W))[:W]
    order = np.argsort(-values, kind="stable")[:W]
    assert [~k & MASK32 for k in got] == order.tolist()
    assert got == reference(values, W)
