"""LSTM inference recurrences: the wrappers of the Hopper kernels in
`csrc/lstm_recurrence.cu` and `csrc/lstm_recurrence_q.cu`, which replace the
TPU kernels `stt_tpu/ops/lstm_kernel.py::_kernel` and `::_kernel_q`.

`lstm_recurrence` launches the float kernel for CUDA tensors and runs the
plain version (`stt_tpu_torch.models.lstm.recurrence`) for CPU tensors;
`lstm_recurrence_q` does the same for the int8 recurrence, whose plain
version is `stt_tpu_torch.ops.quant.recurrence_q`. There is no shape gate:
batch 1 and ragged batches take the kernels too.

Both are one persistent launch for all T steps (see `csrc/lstm_step.cuh`).
Their host side is here and runs on the CPU too: `pack_w_h` (float) and
`pack_w_h_q` (int8) re-lay W_h so that a block's slice is contiguous, and
`launch_plan` sizes the grid and the shared memory from (B, H, itemsize)
and the card's SM count. The training forward (`ops/lstm_train.py`) launches
the same kernel through `run_persistent`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from stt_tpu_torch.models.lstm import (
    State,
    input_projection,
    lengths,
    recurrence,
    recurrent_weights,
    start_state,
)
from stt_tpu_torch.ops._build import check_tensors, launch, load

_ENTRY = {torch.float32: "lstm_recurrence_f32", torch.bfloat16: "lstm_recurrence_bf16"}

# The constants of csrc/lstm_step.cuh that the launch plan depends on.
UNITS_PER_TILE = 16  # hidden units a tile holds, for all four gates
TILE_COLUMNS = 4 * UNITS_PER_TILE
CHUNK_BYTES = 16384  # a tile's weights are cut along k into chunks of this size
STAGES = 4  # slots of the ring that streams weights and h
WARPS = 8  # each sums its own k; their partial sums meet in shared memory
EPILOGUE_ROWS = 8  # batch rows whose sums meet per round
PART_STRIDE = TILE_COLUMNS + 16  # padded row of partial sums
BARRIER_BYTES = 64  # the ring's mbarriers
ROW_GROUPS = (1, 8, 16, 32)  # batch rows a block carries in registers at once
SMEM_LIMIT = 232448  # dynamic shared memory a block can have on an H100


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How the persistent recurrence is launched for one (B, H, dtype)."""

    rows: int  # batch rows per group (the kernel's BT)
    groups: int  # groups of `rows` that cover B, taken one after another
    tiles: int  # tiles of UNITS_PER_TILE hidden units
    tiles_per_block: int
    blocks: int  # block i owns tiles i, i + blocks, ...
    chunk_rows: int  # k rows of one chunk
    chunks: int  # chunks that cover H
    resident_chunks: int  # chunks per tile that stay in shared memory
    smem_bytes: int

    @property
    def units_per_block(self) -> int:
        return self.tiles_per_block * UNITS_PER_TILE

    @property
    def resident_rows(self) -> int:
        """k rows of H whose weights stay on chip for the whole call."""
        return self.resident_chunks * self.chunk_rows

    @property
    def padded_h(self) -> int:
        return self.chunks * self.chunk_rows

    @property
    def padded_rows(self) -> int:
        return self.groups * self.rows

    def h_row(self, itemsize: int) -> int:
        """Values in a staged row of h: a chunk's k, bf16 and int8 rows
        padded by 16 bytes (see csrc/lstm_step.cuh)."""
        return self.chunk_rows + row_padding(itemsize)

    def tiles_of(self, block: int) -> range:
        return range(block, self.tiles, self.blocks)

    def is_resident(self, chunk: int) -> bool:
        """Resident chunks are spread evenly over k, so that the ring streams
        all through a step."""
        n, r = self.chunks, self.resident_chunks
        return (chunk + 1) * r // n > chunk * r // n

    def describe(self) -> Dict[str, int]:
        return {
            "blocks": self.blocks, "units_per_block": self.units_per_block,
            "rows_per_group": self.rows, "groups": self.groups,
            "resident_k_rows": self.resident_rows, "of_k_rows": self.padded_h,
            "smem_bytes": self.smem_bytes,
        }


def chunk_rows(itemsize: int) -> int:
    return CHUNK_BYTES // (TILE_COLUMNS * itemsize)


def row_padding(itemsize: int) -> int:
    """Values a staged row of h is padded by: 16 bytes in bf16 and int8, so
    that the tensor cores' loads of one k from 8 rows meet no bank conflict."""
    return 16 // itemsize if itemsize < 4 else 0


@functools.lru_cache(maxsize=None)
def launch_plan(B: int, H: int, itemsize: int, sm_count: int,
                smem_limit: int = SMEM_LIMIT) -> LaunchPlan:
    """The launch of the persistent recurrence for B rows of H units with
    weights of `itemsize` bytes (4 f32, 2 bf16, 1 int8) on a card of
    `sm_count` SMs: at most one block per SM, each owning whole tiles. When
    every chunk of a block's tiles fits beside the ring's h slots and the
    meeting place of the partial sums, all stay resident and the ring carries
    h alone; else the ring's weight slots come first too, and the shared
    memory left holds as many chunks of each tile as fit (fewer as B grows:
    the ring's h slots and the sums take more)."""
    if min(B, H, sm_count) < 1 or itemsize not in (1, 2, 4):
        raise ValueError(f"no launch plan for B={B} H={H} itemsize={itemsize} SMs={sm_count}")
    rows = next((r for r in ROW_GROUPS if B <= r), ROW_GROUPS[-1])
    groups = -(-B // rows)
    tiles = -(-H // UNITS_PER_TILE)
    tiles_per_block = -(-tiles // sm_count)
    blocks = -(-tiles // tiles_per_block)
    kc = chunk_rows(itemsize)
    chunks = -(-H // kc)
    # bf16 and int8 from 8 rows up take the tensor cores: two partial sums
    # per column over all the group's rows; else one per warp over a round's
    # rows
    tensor_cores = itemsize < 4 and rows >= 8
    part_rows = 2 * rows if tensor_cores else WARPS * min(rows, EPILOGUE_ROWS)
    h_row = (kc + row_padding(itemsize)) * itemsize  # bytes
    fixed = STAGES * rows * h_row + part_rows * PART_STRIDE * 4 + BARRIER_BYTES
    whole = chunks * tiles_per_block * CHUNK_BYTES
    if fixed + whole <= smem_limit:
        return LaunchPlan(rows, groups, tiles, tiles_per_block, blocks, kc, chunks, chunks,
                          fixed + whole)
    fixed += STAGES * CHUNK_BYTES
    if fixed > smem_limit:
        raise ValueError(f"the ring alone needs {fixed} bytes of shared memory, over {smem_limit}")
    resident = (smem_limit - fixed) // (CHUNK_BYTES * tiles_per_block)
    return LaunchPlan(rows, groups, tiles, tiles_per_block, blocks, kc, chunks, resident,
                      fixed + resident * tiles_per_block * CHUNK_BYTES)


THREADS = 32 * WARPS  # threads per block
BWD_ROW_GROUPS = (1, 8, 16)  # batch rows whose dz a thread of K4 holds at once
RED_SLICES = 8  # K4 sums the tiles' partials in at most this many slices


def reduction_floats(tiles_per_block: int, rows: int) -> int:
    """Floats of K4's reduction slices in shared memory (`red_floats`)."""
    return max(THREADS * 4, tiles_per_block * UNITS_PER_TILE * rows)


@functools.lru_cache(maxsize=None)
def bwd_launch_plan(B: int, H: int, itemsize: int, sm_count: int,
                    smem_limit: int = SMEM_LIMIT) -> LaunchPlan:
    """The launch of K4, the persistent reverse sweep (`csrc/lstm_train.cu`):
    the forward's tiles and chunks; shared memory holds the ring, the
    block's dz (rows x 64 f32 per tile), the reduction's slices and the
    barriers, and the rest keeps resident chunks. It stages no h, so it keeps
    more chunks than `launch_plan`. Rows are taken 16 at a time at most."""
    if min(B, H, sm_count) < 1 or itemsize not in (2, 4):
        raise ValueError(f"no launch plan for B={B} H={H} itemsize={itemsize} SMs={sm_count}")
    rows = next((r for r in BWD_ROW_GROUPS if B <= r), BWD_ROW_GROUPS[-1])
    groups = -(-B // rows)
    tiles = -(-H // UNITS_PER_TILE)
    tiles_per_block = -(-tiles // sm_count)
    blocks = -(-tiles // tiles_per_block)
    kc = chunk_rows(itemsize)
    chunks = -(-H // kc)
    padded_rows = groups * rows
    fixed = (STAGES * CHUNK_BYTES + tiles_per_block * padded_rows * TILE_COLUMNS * 4
             + reduction_floats(tiles_per_block, padded_rows) * 4 + BARRIER_BYTES)
    if fixed > smem_limit:
        raise ValueError(f"K4's ring and dz need {fixed} bytes of shared memory, over {smem_limit}")
    resident = min(chunks, (smem_limit - fixed) // (CHUNK_BYTES * tiles_per_block))
    return LaunchPlan(rows, groups, tiles, tiles_per_block, blocks, kc, chunks, resident,
                      fixed + resident * tiles_per_block * CHUNK_BYTES)


def pack_w_h(w_h: torch.Tensor) -> torch.Tensor:
    """W_h [H, 4H] (f32 or bf16, gate blocks i, g, f, o) -> the persistent
    kernel's layout [tiles, HP, 64]: tile i holds, for every k, the columns
    of hidden units 16 i .. 16 i + 15 for the four gates (gate-major), so a
    block's slice is one contiguous run and each 16 KB chunk of it one copy.
    Units past H and k rows past H (HP is H rounded up to whole chunks) are
    zero. In bf16 the eight 16-byte pieces of row k change places, piece p
    going to p ^ (k & 7): the kernel's tensor-core loads then meet no bank
    conflict, and a chunk still travels as one copy."""
    H, four_h = w_h.shape
    if four_h != 4 * H or w_h.dtype not in _ENTRY:
        raise ValueError(f"w_h must be [H, 4H] float32 or bfloat16, got "
                         f"{tuple(w_h.shape)} {w_h.dtype}")
    tiles, hp, _ = packed_shape(H, w_h.dtype)
    padded = torch.zeros((hp, 4, tiles * UNITS_PER_TILE), dtype=w_h.dtype, device=w_h.device)
    padded[:H, :, :H] = w_h.reshape(H, 4, H)
    packed = (padded.reshape(hp, 4, tiles, UNITS_PER_TILE).permute(2, 0, 1, 3)
              .reshape(tiles, hp, TILE_COLUMNS).contiguous())
    if w_h.dtype == torch.bfloat16:
        packed = swizzle_pieces(packed)
    return packed


def swizzle_pieces(packed: torch.Tensor) -> torch.Tensor:
    """Exchange the 16-byte pieces of every row k of bf16 tiles [tiles, HP, 64]
    by piece ^ (k & 7). Its own inverse."""
    tiles, hp, _ = packed.shape
    return (packed.reshape(tiles, hp * 8, 8)
            .index_select(1, _swizzled(hp, 8, packed.device))
            .reshape(tiles, hp, TILE_COLUMNS))


@functools.lru_cache(maxsize=None)
def _swizzled(rows: int, pieces: int, device) -> torch.Tensor:
    """For each of `rows` x `pieces` 16-byte pieces, the piece that takes its
    place when piece p of row r moves to p ^ (r & 7)."""
    r = torch.arange(rows, device=device)[:, None]
    piece = torch.arange(pieces, device=device)[None, :]
    return (r * pieces + (piece ^ (r & 7))).reshape(-1)


def plan_for(B: int, H: int, dtype: torch.dtype, device, backward: bool = False) -> LaunchPlan:
    """The launch plan on `device` (a CUDA device): the forward's, or with
    `backward` K4's."""
    props = torch.cuda.get_device_properties(device)
    limit = getattr(props, "shared_memory_per_block_optin", SMEM_LIMIT)
    plan = bwd_launch_plan if backward else launch_plan
    return plan(B, H, dtype.itemsize, props.multi_processor_count, limit)


def stage_h(h0: torch.Tensor, plan: LaunchPlan, dtype: torch.dtype) -> Tuple[torch.Tensor, int]:
    """The kernel's scratch for h, as (a flat tensor of `dtype`, the elements
    of one plane): two planes of h rounded to and stored in the weights'
    dtype (int8: h_q = round(h * 127), half to even, as the plain version
    quantizes), laid out as the kernel stages it ([group, chunk, row, staged
    row]: a chunk's rows lie together), zero where padded, the first holding
    h0; and behind them the four bytes of the barrier's counter, zeroed with
    them by the one fill."""
    B, H = h0.shape
    item = dtype.itemsize
    if dtype == torch.int8:
        h0 = torch.round(h0 * 127.0).to(torch.int8)
    shape = (plan.groups, plan.chunks, plan.rows, plan.h_row(item))
    plane = plan.groups * plan.chunks * plan.rows * plan.h_row(item)
    scratch = torch.zeros(2 * plane + 4 // item, dtype=dtype, device=h0.device)
    if (B, H) != (plan.padded_rows, plan.padded_h):  # else one copy less
        padded = torch.zeros((plan.padded_rows, plan.padded_h), dtype=dtype, device=h0.device)
        padded[:B, :H] = h0
        h0 = padded
    scratch[:plane].view(shape)[..., :plan.chunk_rows] = h0.view(
        plan.groups, plan.rows, plan.chunks, plan.chunk_rows).permute(0, 2, 1, 3)
    return scratch, plane


def packed_shape(H: int, dtype: torch.dtype) -> Tuple[int, ...]:
    """The shape of W_h [H, 4H] in the persistent kernel's layout:
    [tiles, HP, 64] for `pack_w_h`, [tiles, chunks, 64, 256] for
    `pack_w_h_q`."""
    tiles = -(-H // UNITS_PER_TILE)
    kc = chunk_rows(dtype.itemsize)
    chunks = -(-H // kc)
    if dtype == torch.int8:
        return (tiles, chunks, TILE_COLUMNS, kc)
    return (tiles, chunks * kc, TILE_COLUMNS)


def run_persistent(fn, name: str, x_proj, packed, c0, h0, seq,
                   outputs: Sequence[torch.Tensor],
                   step_scale: Optional[torch.Tensor] = None) -> State:
    """Launch the persistent recurrence `fn` (K1's or K3's entry point, or
    with `step_scale` K2's, whose weights are int8) once for all T >= 1
    steps on CUDA tensors: allocates the state, the scratch for the rounded
    h and the barrier's counter, hands the kernel the launch plan, and
    returns the final (c, h). `outputs` are the tensors the entry point
    writes per step, in its order."""
    T, B, four_h = x_proj.shape
    H = four_h // 4
    device = x_proj.device
    w_dtype = x_proj.dtype if step_scale is None else torch.int8
    plan = plan_for(B, H, w_dtype, device)
    shape = packed_shape(H, w_dtype)
    if tuple(packed.shape) != shape or packed.dtype != w_dtype or packed.device != device \
            or not packed.is_contiguous():
        raise ValueError(
            f"packed W_h must be {shape} {w_dtype} on {device}, got "
            f"{tuple(packed.shape)} {packed.dtype} on {packed.device}"
        )
    c = torch.empty_like(c0)
    h = torch.empty_like(h0)
    scratch, plane = stage_h(h0, plan, w_dtype)
    launch(
        fn, name, device,
        x_proj.data_ptr(), packed.data_ptr(),
        *(() if step_scale is None else (step_scale.data_ptr(),)),
        c0.data_ptr(), h0.data_ptr(),
        c.data_ptr(), h.data_ptr(), scratch.data_ptr(), seq.data_ptr(),
        *(o.data_ptr() for o in outputs),
        scratch.data_ptr() + 2 * plane * w_dtype.itemsize, T, B, H, plan.rows, plan.blocks,
        plan.tiles_per_block, plan.resident_chunks, plan.smem_bytes,
    )
    return c, h


@functools.lru_cache(maxsize=None)
def _library_function(dtype: torch.dtype):
    fn = getattr(load("lstm_recurrence"), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x_proj, w_h, c0, h0, seq) -> None:
    if x_proj.dim() != 3 or x_proj.shape[2] % 4:
        raise ValueError(f"x_proj must be [T, B, 4H], got {tuple(x_proj.shape)}")
    T, B, four_h = x_proj.shape
    H = four_h // 4
    if x_proj.dtype not in _ENTRY or (w_h is not None and w_h.dtype != x_proj.dtype):
        raise ValueError(
            f"x_proj and w_h must both be float32 or bfloat16, got "
            f"{x_proj.dtype} and {None if w_h is None else w_h.dtype}"
        )
    expected = {
        "x_proj": (x_proj, (T, B, four_h), x_proj.dtype),
        "c0": (c0, (B, H), torch.float32),
        "h0": (h0, (B, H), torch.float32),
        "seq": (seq, (B,), torch.int32),
    }
    if w_h is not None:
        expected["w_h"] = (w_h, (H, four_h), w_h.dtype)
    check_tensors(expected, x_proj.device)


def lstm_recurrence(
    x_proj: torch.Tensor,
    w_h: Optional[torch.Tensor],
    c0: torch.Tensor,
    h0: torch.Tensor,
    seq: torch.Tensor,
    packed: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, State]:
    """x_proj [T, B, 4H] and w_h [H, 4H] (both f32 or both bf16); c0, h0
    [B, H] f32; seq [B] int32 -> (out [T, B, H] f32, (c, h) f32). `packed` is
    `pack_w_h(w_h)` where the caller keeps it (the model does, for serving);
    without it the weights are packed per call. On CUDA tensors w_h may be
    None when `packed` is given."""
    _check(x_proj, w_h, c0, h0, seq)
    if x_proj.device.type == "cpu":
        if w_h is None:
            raise ValueError("the plain version needs w_h")
        return recurrence(x_proj, w_h, c0, h0, seq)
    T, B, four_h = x_proj.shape
    H = four_h // 4
    out = torch.empty((T, B, H), dtype=torch.float32, device=x_proj.device)
    if T == 0 or B == 0 or H == 0:
        return out, (c0.clone(), h0.clone())
    if packed is None:
        if w_h is None:
            raise ValueError("lstm_recurrence needs w_h or packed")
        packed = pack_w_h(w_h)
    lstm_recurrence.launches += 1
    state = run_persistent(_library_function(x_proj.dtype), "lstm_recurrence",
                           x_proj, packed, c0, h0, seq, (out,))
    return out, state


lstm_recurrence.launches = 0


def lstm_fused(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    seq_len: Optional[torch.Tensor] = None,
    initial_state: Optional[State] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    packed_w_h: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, State]:
    """Counterpart of `stt_tpu.ops.lstm_fused` (inference).

    x [T, B, n_in] -> (outputs [T, B, n_cell] f32, (c, h)). The input
    projection is one matmul outside the kernel; the recurrence runs in
    the kernel on CUDA tensors. `packed_w_h` is `pack_w_h` of the recurrent
    weights in compute_dtype, where the caller keeps it across calls."""
    T, B, n_in = x.shape
    x_proj = input_projection(params, x, compute_dtype)
    on_card = x.device.type == "cuda" and packed_w_h is not None
    w_h = None if on_card else recurrent_weights(params, n_in, compute_dtype)
    c0, h0 = start_state(initial_state, B, x_proj.shape[2] // 4, x.device)
    return lstm_recurrence(x_proj, w_h, c0, h0, lengths(seq_len, T, B, x.device),
                           packed=packed_w_h if on_card else None)


_ENTRY_Q = {torch.float32: "lstm_recurrence_q_f32", torch.bfloat16: "lstm_recurrence_q_bf16"}


@functools.lru_cache(maxsize=None)
def _library_function_q(dtype: torch.dtype):
    fn = getattr(load("lstm_recurrence_q"), _ENTRY_Q[dtype])
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pack_w_h_q(w_h_q: torch.Tensor) -> torch.Tensor:
    """W_h_q [H, 4H] int8 (gate blocks i, g, f, o) -> the int8 kernel's layout
    [tiles, chunks, 64, 256]: tile i holds the 64 columns of hidden units
    16 i .. 16 i + 15 for the four gates (gate-major), as `pack_w_h` does,
    cut along k into chunks of 256 k, and within a chunk each column's 256 k
    lie together (four consecutive k to a 32-bit word), as the tensor cores'
    A operand takes them. Units past H and k past H are zero, so any H >= 1
    is taken. The sixteen 16-byte pieces of column m change places, piece p
    going to p ^ (m & 7): the kernel's loads of one piece from 8 columns
    then meet no bank conflict, and a chunk still travels as one copy."""
    if w_h_q.dim() != 2 or w_h_q.dtype != torch.int8 or w_h_q.shape[1] != 4 * w_h_q.shape[0] \
            or w_h_q.shape[0] < 1:
        raise ValueError(f"w_h_q must be [H, 4H] int8, got {tuple(w_h_q.shape)} {w_h_q.dtype}")
    H = w_h_q.shape[0]
    tiles, chunks, _, kc = packed_shape(H, torch.int8)
    padded = torch.zeros((chunks * kc, 4, tiles * UNITS_PER_TILE), dtype=torch.int8,
                         device=w_h_q.device)
    padded[:H, :, :H] = w_h_q.reshape(H, 4, H)
    packed = (padded.reshape(chunks, kc, 4, tiles, UNITS_PER_TILE).permute(3, 0, 2, 4, 1)
              .reshape(tiles, chunks, TILE_COLUMNS, kc))
    return swizzle_column_pieces(packed)


def swizzle_column_pieces(packed: torch.Tensor) -> torch.Tensor:
    """Exchange the 16-byte pieces of every column m of int8 chunks
    [tiles, chunks, 64, 256] by piece ^ (m & 7). Its own inverse."""
    return (packed.reshape(-1, TILE_COLUMNS * 16, 16)
            .index_select(1, _swizzled(TILE_COLUMNS, 16, packed.device))
            .reshape(packed.shape))


def lstm_recurrence_q(
    x_proj: torch.Tensor,
    w_h_q: torch.Tensor,
    step_scale: torch.Tensor,
    c0: torch.Tensor,
    h0: torch.Tensor,
    seq: torch.Tensor,
    packed: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, State]:
    """The int8 recurrence. x_proj [T, B, 4H] f32 or bf16 (bias included);
    w_h_q [H, 4H] int8; step_scale [1, 4H] f32 (W_h's per-channel scale /
    127); c0, h0 [B, H] f32; seq [B] int32 -> (out [T, B, H] f32, (c, h)
    f32). `packed` is `pack_w_h_q(w_h_q)` where the caller keeps it (the
    quantized parameters do); without it the weights are packed per call."""
    from stt_tpu_torch.ops.quant import recurrence_q

    if x_proj.dim() != 3 or x_proj.shape[2] % 4:
        raise ValueError(f"x_proj must be [T, B, 4H], got {tuple(x_proj.shape)}")
    T, B, four_h = x_proj.shape
    H = four_h // 4
    if x_proj.dtype not in _ENTRY_Q:
        raise ValueError(f"x_proj must be float32 or bfloat16, got {x_proj.dtype}")
    device = x_proj.device
    expected = {
        "x_proj": (x_proj, (T, B, four_h), x_proj.dtype),
        "w_h_q": (w_h_q, (H, four_h), torch.int8),
        "step_scale": (step_scale, (1, four_h), torch.float32),
        "c0": (c0, (B, H), torch.float32),
        "h0": (h0, (B, H), torch.float32),
        "seq": (seq, (B,), torch.int32),
    }
    if packed is not None:
        expected["packed"] = (packed, packed_shape(H, torch.int8), torch.int8)
    check_tensors(expected, device)
    if device.type == "cpu":
        return recurrence_q(x_proj, w_h_q, step_scale, c0, h0, seq)
    out = torch.empty((T, B, H), dtype=torch.float32, device=device)
    if T == 0 or B == 0 or H == 0:
        return out, (c0.clone(), h0.clone())
    if packed is None:
        packed = pack_w_h_q(w_h_q)
    lstm_recurrence_q.launches += 1
    state = run_persistent(_library_function_q(x_proj.dtype), "lstm_recurrence_q",
                           x_proj, packed, c0, h0, seq, (out,), step_scale)
    return out, state


lstm_recurrence_q.launches = 0
