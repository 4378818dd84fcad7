"""The host side of the int8 recurrence (K2), which runs K1's persistent
kernel with int8 weights: `pack_w_h_q`, `launch_plan` at itemsize 1 and the
int8 `stage_h` of `stt_tpu_torch.ops.lstm_kernel`. The kernel runs only on
the card; what the wrapper hands it is plain Python and torch and is held
here.

The last test replays the kernel's walk over the packed int8 weights in
numpy - block by block, tile by tile, chunk by chunk, each warp's k and
columns, the tensor cores' fragments as ldmatrix and mma.sync m16n8k32 lay
them out (from 8 rows up) or each lane's __dp4a runs (below) - and holds
the int32 sums it forms against `h_q @ W_h_q` of the step of
`stt_tpu.ops.quant._lstm_recurrence_scan`: equal, since int32 sums are exact
in any order. The step it completes is held against that scan's to 1e-5
(numpy's and XLA's sigmoid and tanh).
"""

import numpy as np
import pytest
import torch

from stt_tpu_torch.ops.lstm_kernel import (
    CHUNK_BYTES,
    SMEM_LIMIT,
    TILE_COLUMNS,
    UNITS_PER_TILE,
    launch_plan,
    pack_w_h_q,
    packed_shape,
    stage_h,
    swizzle_column_pieces,
)

SMS = 132  # an H100
KC = 256  # k of one int8 chunk: 16 KB over 64 columns
HS = [6, 100, 256, 2048, 2050]
BS = [1, 3, 8, 16, 17, 32]


def w_h_q_case(H, seed=0):
    rs = np.random.RandomState(seed + H)
    return torch.from_numpy(rs.randint(-127, 128, (H, 4 * H)).astype(np.int8))


def unpack(packed, H):
    """`pack_w_h_q`'s tiles back to W_h_q [HP, 4 * 16 * tiles]: tile, chunk,
    column (gate, unit), k -> k, gate, tile * 16 + unit."""
    tiles, chunks = packed.shape[:2]
    cols = swizzle_column_pieces(packed)
    back = cols.reshape(tiles, chunks, 4, UNITS_PER_TILE, KC).permute(1, 4, 2, 0, 3)
    return back.reshape(chunks * KC, 4, tiles * UNITS_PER_TILE)


@pytest.mark.parametrize("H", HS)
def test_pack_w_h_q_round_trips_and_pads_with_zeros(H):
    w = w_h_q_case(H)
    packed = pack_w_h_q(w)
    tiles, chunks = -(-H // UNITS_PER_TILE), -(-H // KC)
    assert packed.shape == (tiles, chunks, TILE_COLUMNS, KC) == packed_shape(H, torch.int8)
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert packed[0, 0].numel() == CHUNK_BYTES  # a chunk is one copy
    back = unpack(packed, H)
    assert torch.equal(back[:H, :, :H].reshape(H, 4 * H), w)
    assert not back[H:].any() and not back[:, :, H:].any()  # padding is zero
    assert (packed != 0).sum() == (w != 0).sum()


@pytest.mark.parametrize("H", [6, 100, 300])
def test_every_piece_lands_where_the_swizzle_says(H):
    """Piece p (k 16 p .. 16 p + 15) of column m lies at p ^ (m & 7): the
    pieces of one k from 8 consecutive columns fill all 32 banks."""
    w = w_h_q_case(H, seed=1)
    packed = pack_w_h_q(w)
    plain = unpack(packed, H)  # [HP, 4, units], the logical order
    tiles, chunks = packed.shape[:2]
    for tile in range(tiles):
        for chunk in range(chunks):
            for m in (0, 1, 7, 8, 13, 16, 31, 47, 63):
                gate, unit = m // 16, tile * UNITS_PER_TILE + m % 16
                column = plain[chunk * KC:(chunk + 1) * KC, gate, unit]
                for p in range(16):
                    stored = packed[tile, chunk, m, 16 * (p ^ (m & 7)):16 * (p ^ (m & 7)) + 16]
                    assert torch.equal(stored, column[16 * p:16 * p + 16]), (tile, chunk, m, p)
    # one k from 8 columns: 8 distinct 16-byte places within 128 bytes
    for p in range(16):
        places = {(p ^ (m & 7)) % 8 for m in range(8)}
        assert places == set(range(8))
    assert torch.equal(swizzle_column_pieces(swizzle_column_pieces(packed)), packed)


@pytest.mark.parametrize("B", BS)
@pytest.mark.parametrize("H", HS)
def test_int8_launch_plan_covers_every_unit_once_within_the_card(H, B):
    plan = launch_plan(B, H, 1, SMS)
    owned = [tile * UNITS_PER_TILE + u
             for block in range(plan.blocks) for tile in plan.tiles_of(block)
             for u in range(UNITS_PER_TILE)]
    assert len(owned) == len(set(owned))
    assert set(range(H)) <= set(owned) and max(owned) < H + UNITS_PER_TILE
    assert 1 <= plan.blocks <= SMS and plan.smem_bytes <= SMEM_LIMIT == 232448
    assert plan.chunk_rows == KC and plan.chunks == -(-H // KC)
    assert plan.rows in (1, 8, 16, 32) and plan.padded_rows >= B > plan.padded_rows - plan.rows
    assert plan.h_row(1) == KC + 16  # staged h_q rows padded by 16 bytes
    # at these widths a tile's W_h_q (at most 9 chunks, 144 KB) stays whole
    assert plan.resident_chunks == plan.chunks
    if H == 2048:
        assert plan.blocks == 128 and plan.chunks == 8


def test_int8_shared_memory_by_batch_rows():
    """At H = 2048 every chunk is resident, so the ring carries h_q alone:
    4 slots x rows x 272 B, the partial sums (8 x 80 int32 on __dp4a, 2 x rows
    x 80 on the tensor cores), 64 B of barriers and 8 chunks of 16 KB."""
    smem = {B: launch_plan(B, 2048, 1, SMS).smem_bytes for B in (1, 8, 16, 32)}
    assert smem == {1: 69248 - 65536 + 131072, 8: 79424 - 65536 + 131072,
                    16: 93248 - 65536 + 131072, 32: 120896 - 65536 + 131072}


def test_int8_plan_streams_only_when_the_tiles_do_not_fit():
    """Two tiles a block (H = 4096 on 128 SMs: 16 chunks each) do not fit:
    the ring's weight slots come back and part of the chunks streams."""
    plan = launch_plan(16, 4096, 1, 128)
    assert plan.tiles_per_block == 2 and 0 < plan.resident_chunks < plan.chunks
    fixed = 4 * (CHUNK_BYTES + 16 * 272) + 2 * 16 * 80 * 4 + 64
    assert plan.smem_bytes == fixed + plan.resident_chunks * 2 * CHUNK_BYTES <= SMEM_LIMIT


def test_int8_staged_h_rounds_half_to_even():
    """The int8 plane holds round(h0 * 127) half to even, as the plain
    version quantizes, not h0 cast (which would cut toward zero)."""
    halves = torch.tensor([0.5, -0.5, 1.5, -1.5, 2.5, 126.5, 0.49, 63.0], dtype=torch.float32)
    h0 = (halves / 127.0)[None]
    assert torch.equal(h0 * 127.0, halves[None])  # exact ties in float32
    plan = launch_plan(1, 8, 1, SMS)
    scratch, plane = stage_h(h0, plan, torch.int8)
    assert scratch.dtype == torch.int8 and scratch.numel() == 2 * plane + 4
    staged = scratch[:plane].view(plan.groups, plan.chunks, plan.rows, plan.h_row(1))
    assert staged[0, 0, 0, :8].tolist() == [0, 0, 2, -2, 2, 126, 0, 63]
    assert torch.equal(staged[0, 0, 0, :8], torch.round(h0 * 127.0).to(torch.int8)[0])
    assert not staged[..., 8:].any() and not scratch[plane:].any()


@pytest.mark.parametrize("B,H", [(1, 6), (3, 100), (40, 300)])
def test_int8_staged_h_is_h_q_chunk_by_chunk(B, H):
    plan = launch_plan(B, H, 1, SMS)
    h0 = torch.from_numpy(np.random.RandomState(B).uniform(-1, 1, (B, H)).astype(np.float32))
    scratch, plane = stage_h(h0, plan, torch.int8)
    staged = scratch[:plane].view(plan.groups, plan.chunks, plan.rows, plan.h_row(1))
    want = torch.round(h0 * 127.0).to(torch.int8)
    for b in range(B):
        g, r = divmod(b, plan.rows)
        got = staged[g, :, r, :KC].reshape(-1)
        assert torch.equal(got[:H], want[b]) and not got[H:].any()
    assert (staged != 0).sum() == (want != 0).sum()


def ldmatrix_x4(chunk, addresses):
    """ldmatrix.x4 (no .trans) of 16-byte rows: lane l gives the address of
    row l % 8 of matrix l // 8; register i of lane t holds bytes 4 (t % 4) ..
    4 (t % 4) + 3 of row t // 4 of matrix i. Returns regs [32 lanes, 4, 4 bytes]."""
    rows = np.stack([chunk[m, off:off + 16] for m, off in addresses])  # [32, 16]
    matrices = rows.reshape(4, 8, 16)
    t = np.arange(32)
    return np.stack([matrices[i, t // 4].reshape(32, 4, 4)[t, t % 4] for i in range(4)], axis=1)


def mma_m16n8k32(regs_a, h_rows, k):
    """D [16, 8] += A [16, 32] . B [32, 8] as mma.sync m16n8k32 s8 takes its
    fragments: A from each lane's 4 registers (rows gid, gid + 8; k 4 tig ..,
    16 + 4 tig ..), B from the staged h rows (row gid, k 4 tig .., 16 + 4 tig ..)."""
    a = np.zeros((16, 32), np.int64)
    b = np.zeros((32, 8), np.int64)
    for lane in range(32):
        gid, tig = lane // 4, lane % 4
        for i, (row, k0) in enumerate(((gid, 0), (gid + 8, 0), (gid, 16), (gid + 8, 16))):
            a[row, k0 + 4 * tig:k0 + 4 * tig + 4] = regs_a[lane, i]
        for k0 in (0, 16):
            b[k0 + 4 * tig:k0 + 4 * tig + 4, gid] = h_rows[gid, k + k0 + 4 * tig:k + k0 + 4 * tig + 4]
    return a @ b


def replay_acc(packed, plan, staged, B, H):
    """acc [B, 4H] int32 as the kernel forms it from the packed weights and
    the staged h_q: per block its tiles, per tile the groups of rows, per
    group the chunks; from 8 rows up warp w takes the columns of gate w % 4
    and half w // 4 of each chunk's k on the tensor cores (two partial sums
    per column), below warp w takes k 32 w .. 32 w + 31 and lane l columns l
    and l + 32 on __dp4a (eight partial sums); the partial sums meet as
    int32."""
    w = packed.numpy()
    acc = np.zeros((B, 4 * H), np.int64)
    R = plan.rows
    for block in range(plan.blocks):
        for tile in plan.tiles_of(block):
            for g in range(plan.groups):
                if R >= 8:
                    part = np.zeros((2, R, TILE_COLUMNS), np.int64)
                else:
                    part = np.zeros((8, R, TILE_COLUMNS), np.int64)
                for c in range(plan.chunks):
                    chunk = w[tile, c].astype(np.int64)  # [64 columns, 256 k], swizzled
                    hs = staged[g, c].astype(np.int64)   # [R, 272]
                    for warp in range(8):
                        if R >= 8:
                            m0, kh = (warp & 3) * 16, (warp >> 2) * (KC // 2)
                            for ks in range(KC // 64):
                                k = kh + ks * 32
                                addresses = []
                                for lane in range(32):
                                    m = m0 + (lane & 15)
                                    piece = k // 16 + (lane >> 4)
                                    addresses.append((m, 16 * (piece ^ (m & 7))))
                                regs = ldmatrix_x4(chunk, addresses)
                                for nt in range(R // 8):
                                    d = mma_m16n8k32(regs, hs[nt * 8:nt * 8 + 8], k)
                                    part[warp >> 2, nt * 8:nt * 8 + 8, m0:m0 + 16] += d.T
                        else:
                            for p in range(KC // 8 // 16):
                                piece = warp * 2 + p
                                hv = hs[:, 16 * piece:16 * piece + 16]
                                for lane in range(32):
                                    for m in (lane, lane + 32):
                                        off = 16 * (piece ^ (m & 7))
                                        part[warp, :, m] += hv @ chunk[m, off:off + 16]
                total = part.sum(axis=0)
                assert np.abs(total).max() < 2 ** 31  # the int32 the kernel holds
                for u in range(UNITS_PER_TILE):
                    j = tile * UNITS_PER_TILE + u
                    for r in range(R):
                        row = g * R + r
                        if j < H and row < B:
                            acc[row, j::H] = total[r, u::UNITS_PER_TILE]
    return acc


@pytest.mark.parametrize("B,H", [(1, 6), (1, 300), (3, 100), (9, 40), (16, 20), (40, 10)])
def test_the_kernels_walk_over_the_packed_int8_weights_matches_the_jax_scan(B, H):
    import jax.numpy as jnp

    from stt_tpu.ops.quant import _lstm_recurrence_scan

    rs = np.random.RandomState(B + H)
    w_h_q = rs.randint(-127, 128, (H, 4 * H)).astype(np.int8)
    w_h_q[0, :] = 127  # a column of extremes: the sums run far from zero
    step_scale = (rs.uniform(0.005, 0.02, (1, 4 * H)) / 127.0).astype(np.float32)
    x_proj = (rs.randn(1, B, 4 * H) * 0.5).astype(np.float32)
    c0 = (rs.randn(B, H) * 0.1).astype(np.float32)
    h0 = rs.uniform(-0.99, 0.99, (B, H)).astype(np.float32)
    h0[0, 0] = 0.99
    seq = np.ones(B, np.int32)
    out, (c_ref, h_ref) = _lstm_recurrence_scan(
        *(jnp.asarray(a) for a in (x_proj, w_h_q, step_scale, c0, h0, seq)))
    # the scan's step: h_q, then the exact int32 product
    h_q = jnp.round(jnp.asarray(h0) * 127.0).astype(jnp.int8)
    want_acc = np.asarray(jnp.matmul(h_q, jnp.asarray(w_h_q), preferred_element_type=jnp.int32))

    # few SMs: several tiles a block
    plan = launch_plan(B, H, 1, sm_count=1 if H <= 32 else 2)
    assert plan.tiles_per_block > 1 or plan.tiles == 1
    packed = pack_w_h_q(torch.from_numpy(w_h_q))
    scratch, plane = stage_h(torch.from_numpy(h0), plan, torch.int8)
    staged = scratch[:plane].view(plan.groups, plan.chunks, plan.rows, plan.h_row(1)).numpy()
    acc = replay_acc(packed, plan, staged, B, H)
    np.testing.assert_array_equal(acc, want_acc)

    # the epilogue: x + float(acc) * scale, each rounded once, then the gates
    z = x_proj[0] + acc.astype(np.float32) * step_scale
    i, g, f, o = np.split(z, 4, axis=-1)

    def sigmoid(v):
        return 1.0 / (1.0 + np.exp(-v))

    c = sigmoid(f) * c0 + sigmoid(i) * np.tanh(g)
    h = sigmoid(o) * np.tanh(c)
    for got, want in ((h, out[0]), (c, c_ref), (h, h_ref)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
