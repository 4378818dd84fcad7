"""The host side of the persistent LSTM recurrence (K1, K3): `pack_w_h` and
`launch_plan` of `stt_tpu_torch.ops.lstm_kernel`. The kernel runs only on the
card; what the wrapper hands it is plain Python and torch and is held here.

The last test replays the kernel's walk over the packed weights in numpy -
block by block, tile by tile, chunk by chunk, each thread's k in the
kernel's order - and holds it against the JAX package's `lstm_scan` step, so
the layout the kernel reads is the one the wrapper writes (f32: 1e-5, sums in
another order).
"""

import numpy as np
import pytest
import torch

from stt_tpu_torch.ops.lstm_kernel import (
    CHUNK_BYTES,
    SMEM_LIMIT,
    TILE_COLUMNS,
    UNITS_PER_TILE,
    chunk_rows,
    launch_plan,
    pack_w_h,
    stage_h,
    swizzle_pieces,
)

SMS = 132  # an H100
HS = [100, 128, 256, 2048, 2049]
BS = [1, 3, 8, 16, 17, 32, 64]
DTYPES = [torch.float32, torch.bfloat16]


def itemsize(dtype):
    return torch.finfo(dtype).bits // 8


def unswizzled(packed):
    """The tiles as [tiles, HP, 64] columns in order: bf16 tiles are stored
    with the 16-byte pieces of each row exchanged (its own inverse)."""
    return swizzle_pieces(packed) if packed.dtype == torch.bfloat16 else packed


def w_h_case(H, dtype, seed=0):
    rs = np.random.RandomState(seed + H)
    return torch.from_numpy(rs.uniform(-1, 1, (H, 4 * H)).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H", HS)
def test_pack_w_h_round_trips(H, dtype):
    w_h = w_h_case(H, dtype)
    packed = pack_w_h(w_h)
    kc = chunk_rows(itemsize(dtype))
    tiles = -(-H // UNITS_PER_TILE)
    hp = -(-H // kc) * kc
    assert packed.shape == (tiles, hp, TILE_COLUMNS) and packed.dtype == dtype
    assert packed.is_contiguous()
    # back to [H, 4H]: tile, k, gate, unit -> k, gate, tile * 16 + unit
    back = unswizzled(packed).reshape(tiles, hp, 4, UNITS_PER_TILE).permute(1, 2, 0, 3)
    back = back.reshape(hp, 4, tiles * UNITS_PER_TILE)
    assert torch.equal(back[:H, :, :H].reshape(H, 4 * H), w_h)
    assert not back[H:].any() and not back[:, :, H:].any()  # padding is zero


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H", HS)
def test_every_tile_is_the_columns_of_its_units_for_all_four_gates(H, dtype):
    w_h = w_h_case(H, dtype, seed=1)
    packed = pack_w_h(w_h)
    assert packed.is_contiguous()
    tiles_in_order = unswizzled(packed)
    plan = launch_plan(1, H, itemsize(dtype), SMS)
    for block in range(plan.blocks):
        for tile in plan.tiles_of(block):
            units = range(tile * UNITS_PER_TILE, min((tile + 1) * UNITS_PER_TILE, H))
            for gate in range(4):
                cols = [gate * H + j for j in units]
                got = tiles_in_order[tile, :H, gate * UNITS_PER_TILE:gate * UNITS_PER_TILE + len(units)]
                assert torch.equal(got, w_h[:, cols]), (block, tile, gate)
    # a chunk of a tile is one contiguous run of CHUNK_BYTES
    assert plan.chunk_rows * TILE_COLUMNS * itemsize(dtype) == CHUNK_BYTES
    assert packed[0, :plan.chunk_rows].is_contiguous()


def test_bf16_pieces_are_exchanged_by_row():
    """Piece p of row k lies at p ^ (k & 7); f32 tiles are not touched."""
    H = 128
    w_h = w_h_case(H, torch.float32)
    plain, moved = pack_w_h(w_h), pack_w_h(w_h.to(torch.bfloat16))
    want = plain[:, :H].to(torch.bfloat16).reshape(-1, H, 8, 8)
    got = moved.reshape(-1, H, 8, 8)
    for k in (0, 1, 7, 8, 77):
        for p in range(8):
            assert torch.equal(got[:, k, p ^ (k & 7)], want[:, k, p])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", BS)
@pytest.mark.parametrize("H", HS)
def test_launch_plan_covers_every_unit_once_within_the_card(H, B, dtype):
    plan = launch_plan(B, H, itemsize(dtype), SMS)
    owned = [tile * UNITS_PER_TILE + u
             for block in range(plan.blocks) for tile in plan.tiles_of(block)
             for u in range(UNITS_PER_TILE)]
    assert len(owned) == len(set(owned))
    assert set(range(H)) <= set(owned) and max(owned) < H + UNITS_PER_TILE
    assert all(len(plan.tiles_of(b)) <= plan.tiles_per_block for b in range(plan.blocks))
    assert 1 <= plan.blocks <= SMS
    assert plan.smem_bytes <= SMEM_LIMIT == 232448
    assert plan.rows in (1, 8, 16, 32) and plan.padded_rows >= B > plan.padded_rows - plan.rows
    assert plan.padded_h >= H > plan.padded_h - plan.chunk_rows
    assert 0 <= plan.resident_chunks <= plan.chunks
    assert sum(plan.is_resident(c) for c in range(plan.chunks)) == plan.resident_chunks
    if H == 2048:  # the serving width: part of W_h stays on chip, part streams
        assert 0 < plan.resident_rows < H
        assert plan.blocks == 128 and plan.units_per_block == 16
    if H <= 256:  # a small slice is resident whole
        assert plan.resident_rows == plan.padded_h


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H", HS)
def test_resident_share_does_not_grow_with_the_batch(H, dtype):
    rows = [launch_plan(B, H, itemsize(dtype), SMS).resident_rows for B in BS]
    assert rows == sorted(rows, reverse=True)
    if H >= 2048:
        assert rows[0] > rows[-1]


@pytest.mark.parametrize("sms,H", [(132, 4096), (8, 256), (1, 64), (132, 2128)])
def test_launch_plan_with_more_tiles_than_sms(sms, H):
    plan = launch_plan(4, H, 4, sms)
    tiles = -(-H // UNITS_PER_TILE)
    assert plan.blocks <= sms and plan.tiles_per_block == -(-tiles // sms)
    assert sorted(t for b in range(plan.blocks) for t in plan.tiles_of(b)) == list(range(tiles))
    assert plan.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H", [(1, 100), (1, 128), (3, 128), (16, 2048), (17, 256), (40, 2049)])
def test_staged_h_is_h0_rounded_chunk_by_chunk(B, H, dtype):
    """Plane 0 of the scratch holds h0 in the weights' dtype as [group,
    chunk, row, staged row]; the padding, plane 1 and the counter are zero."""
    plan = launch_plan(B, H, itemsize(dtype), SMS)
    h0 = torch.from_numpy(np.random.RandomState(B).uniform(-1, 1, (B, H)).astype(np.float32))
    scratch, plane = stage_h(h0, plan, dtype)
    row = plan.h_row(itemsize(dtype))
    assert scratch.dtype == dtype and row * itemsize(dtype) % 16 == 0
    assert scratch.numel() * itemsize(dtype) == 2 * plane * itemsize(dtype) + 4
    staged = scratch[:plane].view(plan.groups, plan.chunks, plan.rows, row)
    want = h0.to(dtype)
    for b in (0, B // 2, B - 1):
        g, r = divmod(b, plan.rows)
        got = staged[g, :, r, :plan.chunk_rows].reshape(-1)
        assert torch.equal(got[:H], want[b]) and not got[H:].any()
    assert not staged[..., plan.chunk_rows:].any()
    assert (staged != 0).sum() == (want != 0).sum()  # nothing else is set
    assert not scratch[plane:].any()


def test_launch_plan_and_pack_refuse_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        launch_plan(0, 128, 4, SMS)
    with pytest.raises(ValueError):
        launch_plan(1, 128, 1, SMS)
    with pytest.raises(ValueError):
        pack_w_h(torch.zeros(8, 30))
    with pytest.raises(ValueError):
        pack_w_h(torch.zeros(8, 32, dtype=torch.float64))


def replay_step(packed, plan, h, B, H):
    """h [B, H] . W_h as the kernel walks it: a block per tile list, the
    groups of rows, the chunks (resident or streamed alike), each thread's 4
    k per pass of 64, the two half-warps, then the 8 warps."""
    w = packed.numpy().astype(np.float32)
    hm = np.zeros((plan.padded_rows, plan.padded_h), np.float32)
    hm[:B, :H] = h
    z = np.zeros((B, 4 * H), np.float32)
    kc = plan.chunk_rows
    for block in range(plan.blocks):
        for tile in plan.tiles_of(block):
            for g in range(plan.groups):
                rows = hm[g * plan.rows:(g + 1) * plan.rows]
                # acc[kg][row][col]: thread (kg, cg) sums its k in order
                acc = np.zeros((16, plan.rows, TILE_COLUMNS), np.float32)
                for c in range(plan.chunks):
                    chunk = w[tile, c * kc:(c + 1) * kc]
                    for p in range(kc // 64):
                        for kg in range(16):
                            for r in range(4):
                                k = p * 64 + kg * 4 + r
                                acc[kg] += np.outer(rows[:, c * kc + k], chunk[k])
                halves = acc[0::2] + acc[1::2]  # the shuffle: kg and kg + 1
                total = np.zeros_like(halves[0])
                for warp in range(8):
                    total = total + halves[warp]
                for u in range(UNITS_PER_TILE):
                    j = tile * UNITS_PER_TILE + u
                    for b in range(plan.rows):
                        row = g * plan.rows + b
                        if j < H and row < B:
                            z[row, j::H] = total[b, u::UNITS_PER_TILE]
    return z


@pytest.mark.parametrize("B,H", [(1, 100), (3, 128), (9, 100), (40, 72)])
def test_the_kernels_walk_over_the_packed_weights_matches_lstm_scan(B, H):
    import jax.numpy as jnp

    from stt_tpu.models.lstm import lstm_scan

    rs = np.random.RandomState(B + H)
    n_in = 8
    kernel = rs.uniform(-0.3, 0.3, (n_in + H, 4 * H)).astype(np.float32)
    bias = (rs.randn(4 * H) * 0.1).astype(np.float32)
    x = (rs.randn(1, B, n_in) * 0.5).astype(np.float32)
    c0 = (rs.randn(B, H) * 0.1).astype(np.float32)
    h0 = rs.uniform(-0.5, 0.5, (B, H)).astype(np.float32)
    want, (c_ref, h_ref) = lstm_scan(
        {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}, jnp.asarray(x),
        initial_state=(jnp.asarray(c0), jnp.asarray(h0)))

    plan = launch_plan(B, H, 4, sm_count=3)  # few SMs: several tiles a block
    assert plan.tiles_per_block > 1
    packed = pack_w_h(torch.from_numpy(kernel[n_in:]).contiguous())
    z = x[0] @ kernel[:n_in] + bias + replay_step(packed, plan, h0, B, H)
    i, g, f, o = np.split(z, 4, axis=-1)

    def sigmoid(v):
        return 1.0 / (1.0 + np.exp(-v))

    c = sigmoid(f) * c0 + sigmoid(i) * np.tanh(g)
    h = sigmoid(o) * np.tanh(c)
    np.testing.assert_allclose(h, np.asarray(want[0]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(c, np.asarray(c_ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(h, np.asarray(h_ref), rtol=0, atol=1e-5)
