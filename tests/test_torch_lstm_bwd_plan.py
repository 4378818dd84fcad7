"""The host side of K4, the persistent reverse sweep of the LSTM training
recurrence (`csrc/lstm_train.cu`): `bwd_launch_plan`, whose constants must
be those of the CUDA sources, and a numpy replay of the kernel's walk held
against `train_backward`, K4's plain version. The kernel runs only on the
card; what it computes from the wrapper's layout is replayed here.

The replay follows the kernel: per step the gate grads of every tile's 16
units, rounded to W_h's dtype; per tile the partial products over its 64
packed columns (bf16 pieces un-swizzled), for every k row; the sum over
tiles in the kernel's fixed slices; the freeze past each row's length.
Tolerance 1e-5 in f32 (sums in another order); in bf16 the same roundings
of dz and W_h are made on both sides, so 1e-5 holds too.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from stt_tpu_torch.ops import lstm_kernel
from stt_tpu_torch.ops.lstm_kernel import (
    CHUNK_BYTES,
    SMEM_LIMIT,
    TILE_COLUMNS,
    UNITS_PER_TILE,
    bwd_launch_plan,
    launch_plan,
    pack_w_h,
    swizzle_pieces,
)
from stt_tpu_torch.ops.lstm_train import train_backward

CSRC = Path(lstm_kernel.__file__).resolve().parent / "csrc"
SMS = 132  # an H100


def itemsize(dtype):
    return torch.finfo(dtype).bits // 8


def constant(source: str, name: str) -> int:
    found = re.search(rf"constexpr int {name} = (.+?);", (CSRC / source).read_text())
    assert found, name
    return int(eval(found.group(1).split("//")[0], {"UT": UNITS_PER_TILE, "PTHREADS": 256}))


def test_the_plan_mirrors_the_constants_of_the_sources():
    assert constant("lstm_step.cuh", "UT") == UNITS_PER_TILE
    assert constant("lstm_step.cuh", "TC") == TILE_COLUMNS
    assert constant("lstm_step.cuh", "CHUNK_BYTES") == CHUNK_BYTES
    assert constant("lstm_step.cuh", "STAGES") == lstm_kernel.STAGES
    assert constant("lstm_step.cuh", "PTHREADS") == lstm_kernel.THREADS
    assert constant("lstm_step.cuh", "BAR_BYTES") == lstm_kernel.BARRIER_BYTES
    assert constant("lstm_train.cu", "RED_SLICES") == lstm_kernel.RED_SLICES
    # the row groups the entry point dispatches
    cases = re.findall(r"case (\d+): return lstm::launch_cooperative\(bwd_kernel",
                       (CSRC / "lstm_train.cu").read_text())
    assert tuple(int(c) for c in cases) == lstm_kernel.BWD_ROW_GROUPS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 8, 16, 32])
@pytest.mark.parametrize("H", [2048, 40, 100])
def test_bwd_launch_plan(H, B, dtype):
    item = itemsize(dtype)
    plan = bwd_launch_plan(B, H, item, SMS)
    assert plan.rows == (1 if B == 1 else 8 if B <= 8 else 16)
    assert plan.padded_rows >= B > plan.padded_rows - plan.rows
    assert plan.chunk_rows * TILE_COLUMNS * item == CHUNK_BYTES
    assert plan.padded_h >= H > plan.padded_h - plan.chunk_rows
    assert 1 <= plan.blocks <= SMS
    owned = sorted(t for b in range(plan.blocks) for t in plan.tiles_of(b))
    assert owned == list(range(-(-H // UNITS_PER_TILE)))
    # the kernel's shared memory: ring, dz of the block's units, the
    # reduction's slices, the barriers, then the resident chunks
    tpb = plan.tiles_per_block
    fixed = (lstm_kernel.STAGES * CHUNK_BYTES + tpb * plan.padded_rows * TILE_COLUMNS * 4
             + max(256 * 4, tpb * UNITS_PER_TILE * plan.padded_rows) * 4 + 64)
    assert plan.smem_bytes == fixed + plan.resident_chunks * tpb * CHUNK_BYTES <= SMEM_LIMIT
    assert 0 <= plan.resident_chunks <= plan.chunks
    if plan.resident_chunks < plan.chunks:  # no room for one more
        assert plan.smem_bytes + tpb * CHUNK_BYTES > SMEM_LIMIT
    if H == 2048:
        assert plan.blocks == 128 and 0 < plan.resident_chunks < plan.chunks
        # no h staged: at least as many chunks stay on chip as in the forward
        assert plan.resident_chunks >= launch_plan(B, H, item, SMS).resident_chunks
    else:  # a narrow slice is resident whole
        assert plan.resident_chunks == plan.chunks


def test_bwd_launch_plan_at_the_training_shape_keeps_more_than_the_forward():
    assert bwd_launch_plan(16, 2048, 4, SMS).resident_chunks == 9
    assert launch_plan(16, 2048, 4, SMS).resident_chunks == 7


def test_bwd_launch_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        bwd_launch_plan(0, 128, 4, SMS)
    with pytest.raises(ValueError):
        bwd_launch_plan(1, 128, 8, SMS)


def reduction_slices(plan, my_tiles: int) -> int:
    """The kernel's S: the tiles are summed in S fixed slices."""
    rv = 4 if plan.rows % 4 == 0 else 1
    n_items = my_tiles * UNITS_PER_TILE * plan.padded_rows // rv
    return 1 if n_items >= 256 else min(lstm_kernel.RED_SLICES, 256 // n_items)


def replay_backward(zs, cs, cs_prev, dout, w_h, seq, dc_T, dh_T, plan):
    """K4's walk in numpy float32, on the packed weights."""
    T, B, four_h = zs.shape
    H = four_h // 4
    packed = pack_w_h(w_h)
    if w_h.dtype == torch.bfloat16:
        packed = swizzle_pieces(packed)
    w = packed.float().numpy()  # [tiles, HP, 64]: column q * 16 + u is gate q of unit u
    tiles = plan.tiles
    rows = plan.padded_rows
    z = zs.float().numpy()
    cs, cs_prev, dout = cs.numpy(), cs_prev.numpy(), dout.numpy()
    seq = seq.numpy()
    dc, dh = dc_T.numpy().copy(), dh_T.numpy().copy()
    dz = np.zeros((T, B, four_h), np.float32)

    def sigmoid(v):
        return (1.0 / (1.0 + np.exp(-v))).astype(np.float32)

    for t in reversed(range(T)):
        i, g, f, o = sigmoid(z[t, :, :H]), np.tanh(z[t, :, H:2 * H]), \
            sigmoid(z[t, :, 2 * H:3 * H]), sigmoid(z[t, :, 3 * H:])
        tanh_c = np.tanh(cs[t])
        dh_total = dout[t] + dh
        dc_total = dc + dh_total * o * (1 - tanh_c * tanh_c)
        valid = (t < seq)[:, None]
        d = np.concatenate([dc_total * g * i * (1 - i), dc_total * i * (1 - g * g),
                            dc_total * cs_prev[t] * f * (1 - f),
                            dh_total * tanh_c * o * (1 - o)], axis=1)
        d = np.where(valid, d, 0).astype(np.float32)
        dz[t] = d
        dc = np.where(valid, dc_total * f, dc).astype(np.float32)
        rounded = torch.from_numpy(d).to(w_h.dtype).float().numpy()
        # each tile's 64 columns of dz, zero for units past H and rows past B
        dzs = np.zeros((tiles, rows, TILE_COLUMNS), np.float32)
        for tile in range(tiles):
            for u in range(UNITS_PER_TILE):
                j = tile * UNITS_PER_TILE + u
                if j < H:
                    dzs[tile, :B, u::UNITS_PER_TILE] = rounded[:, j::H]
        # the partials: per tile, every k row j contracted over the 64 columns
        part = np.einsum("trc,tjc->tjr", dzs, w)  # [tiles, HP, rows]
        total = np.zeros((H, rows), np.float32)
        for block in range(plan.blocks):
            mine = list(plan.tiles_of(block))
            S = reduction_slices(plan, len(mine))
            units = [tile * UNITS_PER_TILE + u for tile in mine for u in range(UNITS_PER_TILE)]
            units = [j for j in units if j < H]
            slices = [part[s::S, units].sum(axis=0, dtype=np.float32) for s in range(S)]
            acc = np.zeros_like(slices[0])
            for sl in slices:  # the slices in order
                acc = acc + sl
            total[units] = acc
        dh = np.where(valid, total[:, :B].T, dh).astype(np.float32)
    return dz, dc, dh


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H,sms", [(5, 3, 40, SMS), (4, 9, 100, 2), (3, 1, 72, SMS),
                                       (6, 17, 48, 2)])
def test_the_kernels_walk_matches_train_backward(T, B, H, sms, dtype):
    rs = np.random.RandomState(T * 100 + B + H)
    w_h = torch.from_numpy(rs.uniform(-0.3, 0.3, (H, 4 * H)).astype(np.float32)).to(dtype)
    zs = torch.from_numpy(rs.randn(T, B, 4 * H).astype(np.float32)).to(torch.bfloat16)
    cs, cs_prev, dout = (torch.from_numpy((rs.randn(T, B, H) * s).astype(np.float32))
                         for s in (0.5, 0.5, 0.1))
    seq = torch.from_numpy(rs.randint(1, T + 1, B).astype(np.int32))
    seq[0] = T
    dc_T, dh_T = (torch.from_numpy((rs.randn(B, H) * 0.1).astype(np.float32)) for _ in range(2))
    args = (zs, cs, cs_prev, dout, w_h, seq, dc_T, dh_T)
    plan = bwd_launch_plan(B, H, itemsize(dtype), sms)
    if sms == 2:  # several tiles a block
        assert plan.tiles_per_block > 1
    got = replay_backward(*args, plan)
    want = train_backward(*args)
    for name, g, w in zip(("dz", "dc0", "dh0"), got, want):
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=1e-5, err_msg=name)
    for b, n in enumerate(seq.tolist()):
        assert not got[0][n:, b].any()
