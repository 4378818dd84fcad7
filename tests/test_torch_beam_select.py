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
instances from the source. The huge instance (every other shape: beams past
512, alphabets past 256 classes) ranks its classes and sorts its winners by
a bitonic network in memory that every thread walks pair by pair, finds
parents in a table of at least 2 W places, and lays its arrays out in
shared memory or a workspace by `huge_layout`; the replays below read its
constants from the source too.
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


def table_place(key: int, bits: int = 10) -> int:
    """beam_scan.cu's table_place: `bits` bits of a multiplicative hash (10
    in the narrow and wide instances)."""
    return (((key ^ (key >> 29)) * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF) >> (64 - bits)


def parents_by_table(ha, hb, pha, phb, live, last, rng, bits: int = 10) -> list:
    """The kernel's parent lookup: every live slot inserted, in any order,
    under its hash pair (linear probing over 2^bits places, the pair (0, 0)
    counted beside the table), each place keeping the first slot and the
    count; then each slot with a last label looks its parent pair up."""
    places = 1 << bits
    tab, zero = {}, [2**31 - 1, 0]
    keys = [None] * places
    for i in rng.permutation(len(ha)):
        if not live[i]:
            continue
        key = (int(ha[i]) & MASK32) << 32 | (int(hb[i]) & MASK32)
        if key == 0:
            zero = [min(zero[0], i), zero[1] + 1]
            continue
        at = table_place(key, bits)
        while keys[at] is not None and keys[at] != key:
            at = (at + 1) % places
        keys[at] = key
        first, hits = tab.get(at, (2**31 - 1, 0))
        tab[at] = (min(first, i), hits + 1)
    out = []
    for j in range(len(ha)):
        par = hits = 0
        if last[j] >= 0:
            key = (int(pha[j]) & MASK32) << 32 | (int(phb[j]) & MASK32)
            if key == 0:
                first, hits = zero
            else:
                at = table_place(key, bits)
                while keys[at] is not None and keys[at] != key:
                    at = (at + 1) % places
                first, hits = tab.get(at, (0, 0)) if keys[at] == key else (0, 0)
            par = first if hits else 0
        out.append((par, hits))
    return out


@pytest.mark.parametrize("W", [8, 32, 500, 512, 1024, 3000])
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
    bits = 10 if W <= 512 else huge_table_bits(W)  # the huge instance's table
    assert parents_by_table(ha, hb, pha, phb, live, last, rng, bits) == want
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


# --- the huge instance: every other shape -----------------------------------

def cu_long(name: str) -> int:
    """A `constexpr long long` of beam_scan.cu."""
    expr = re.search(rf"constexpr long long {name} = ([^;]+);", CSRC.read_text()).group(1)
    return int(eval(expr.replace("LL", ""), {}, {}))


def huge_table_bits(W: int) -> int:
    bits = cu_constant("TABLE_BITS")
    while (1 << bits) < 2 * W:
        bits += 1
    return bits


def huge_layout(W: int, S: int, C: int) -> dict:
    """beam_scan.cu's huge_layout: each region in order to shared memory
    while HUGE_SMEM lasts, else to the workspace, 16-byte aligned."""
    bits = huge_table_bits(W)
    lsort = 1 << (max(W, C) - 1).bit_length()
    sizes = [cu_constant("SLOT_ARRAYS") * S * 4, 5 * C * 4, (1 << bits) * 16, lsort * 8,
             (W * (C + 1) + 31) // 32 * 4]
    smem, ws, where = 0, 0, []
    for size in sizes:
        size = (size + 15) & ~15
        if smem + size <= cu_constant("HUGE_SMEM"):
            where.append("smem")
            smem += size
        else:
            where.append("workspace")
            ws += size
    return {"where": where, "smem": smem, "ws": ws, "bits": bits, "lsort": lsort}


@pytest.mark.parametrize("W,C,where", [
    (1024, 29, ["smem"] * 5),
    (500, 1000, ["smem"] * 5),
    (64, 300, ["smem"] * 5),
    (48, 256, ["smem"] * 5),
    (500, 4096, ["smem"] * 4 + ["workspace"]),  # 256 KB of strike-out bits
    (4096, 29, ["workspace"] + ["smem"] * 4),  # 320 KB of per-slot arrays
])
def test_huge_layout_fits_the_block(W, C, where):
    """The huge instance's arrays: what shared memory holds and what goes to
    the workspace, with the static shared memory beside HUGE_SMEM within
    the 227 KB a block can have, and the limits the wrapper states."""
    from stt_tpu_torch.ops import beam_kernel

    assert cu_long("MAX_FLAT") == beam_kernel.MAX_FLAT
    assert beam_kernel.instance(W, C, 0 if C == 256 else None) == "huge"
    S = beam_kernel.state_slots(W)
    lay = huge_layout(W, S, C)
    assert lay["where"] == where
    static = 2 * 256 * 4 + 32 * 4 + 3 * 4 + 4 + 2 * 32 * 8 + 4 * 4
    assert lay["smem"] <= cu_constant("HUGE_SMEM") and lay["smem"] + static <= 227 * 1024
    assert (1 << lay["bits"]) >= 2 * W and lay["lsort"] >= max(W, C)


def sort_desc_mem(keys: np.ndarray, threads: int) -> np.ndarray:
    """The huge instance's in-memory bitonic network: per stage every thread
    takes the indices i = tid, tid + threads, ... and orders the pair (i,
    i ^ j) with i < i ^ j, descending where i & k is 0."""
    a = keys.copy()
    L = len(a)
    k = 2
    while k <= L:
        j = k >> 1
        while j > 0:
            for tid in range(min(threads, L)):
                i = np.arange(tid, L, threads)
                i = i[(i ^ j) > i]
                x, y = a[i], a[i ^ j]
                desc = (i & k) == 0
                swap = np.where(desc, x < y, x > y)
                a[i[swap]], a[(i ^ j)[swap]] = y[swap], x[swap]
            j >>= 1
        k <<= 1
    return a


@pytest.mark.parametrize("C", [300, 1000, 4096])
def test_huge_class_rank_by_sorting_equals_the_count(C):
    """Where the other instances rank a class by counting the classes above
    it, the huge one sorts the classes' keys (probability descending, then
    class ascending; padding keys of 0 below every real one) and reads
    rank[order[r]] = r off the sorted keys: the same ranks, ties and zeros
    (ignored classes) included."""
    rng = np.random.default_rng(C)
    sprob = rng.dirichlet(np.ones(C) * 0.3).astype(np.float32)
    sprob[rng.integers(0, C, C // 10)] = sprob[0]  # ties
    sprob[rng.integers(0, C, C // 20)] = 0.0  # ignored classes sort at 0
    L = 1 << (C - 1).bit_length()
    keys = np.zeros(L, np.uint64)
    keys[:C] = keys_np(sprob, np.arange(C))
    got = sort_desc_mem(keys, 1024)
    order = (~got[:C] & np.uint64(MASK32)).astype(np.int64)
    rank = np.empty(C, np.int64)
    rank[order] = np.arange(C)
    counted = np.array([np.sum((sprob > sprob[c]) | ((sprob == sprob[c]) & (np.arange(C) < c)))
                        for c in range(C)])
    np.testing.assert_array_equal(rank, counted)


@pytest.mark.parametrize("kind", ["flat", "peaky", "ties", "mixed"])
@pytest.mark.parametrize("W,C", [(1024, 29), (600, 5), (500, 1000), (64, 300), (2048, 8)])
def test_huge_selection_equals_a_stable_descending_sort(kind, W, C):
    """The huge instance's selection: the live keys compacted into the pool
    in device memory by 1,024 threads, the radix select, the W winners
    gathered in any order and sorted by the in-memory network (W may pass
    the block's threads): the flat indices of a stable descending sort."""
    rng = np.random.default_rng(W + C + len(kind))
    values = pool(kind, W, C, rng)
    live = compact_np(values, 1024)
    assert len(live) == np.isfinite(values).sum()
    n_top = min(W, len(live))
    if len(live) > W:
        prefix, shift = radix_select_np(live, W)
        top = live[(live >> np.uint64(shift)) >= np.uint64(prefix >> shift)]
    else:
        top = live
    assert len(top) == n_top
    L = 1 << max(n_top - 1, 0).bit_length()
    padded = np.zeros(L, np.uint64)
    padded[:n_top] = rng.permutation(top)
    got = sort_desc_mem(padded, 1024)[:n_top]
    order = np.argsort(-values, kind="stable")[:n_top]
    np.testing.assert_array_equal((~got & np.uint64(MASK32)).astype(np.int64), order)
