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
"""

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
