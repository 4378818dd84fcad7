"""LSTM inference recurrences: the wrappers of the Hopper kernels in
`csrc/lstm_recurrence.cu` and `csrc/lstm_recurrence_q.cu`, which replace the
TPU kernels `stt_tpu/ops/lstm_kernel.py::_kernel` and `::_kernel_q`.

`lstm_recurrence` launches the float kernel for CUDA tensors and runs the
plain version (`stt_tpu_torch.models.lstm.recurrence`) for CPU tensors;
`lstm_recurrence_q` does the same for the int8 recurrence, whose plain
version is `stt_tpu_torch.ops.quant.recurrence_q`. There is no shape gate:
batch 1 and ragged batches take the kernels too.

The float kernel is one persistent launch for all T steps (see
`csrc/lstm_step.cuh`). Its host side is here and runs on the CPU too:
`pack_w_h` re-lays W_h so that a block's slice is contiguous, and
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
        """Values in a staged row of h: a chunk's k, bf16 rows padded by 16
        bytes (see csrc/lstm_step.cuh)."""
        return self.chunk_rows + (8 if itemsize == 2 else 0)

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


@functools.lru_cache(maxsize=None)
def launch_plan(B: int, H: int, itemsize: int, sm_count: int,
                smem_limit: int = SMEM_LIMIT) -> LaunchPlan:
    """The launch of the persistent recurrence for B rows of H units with
    weights of `itemsize` bytes on a card of `sm_count` SMs: at most one
    block per SM, each owning whole tiles; the ring and the meeting place of
    the partial sums come first, and the shared memory left holds as many
    chunks of each tile's weights as fit (fewer as B grows: the ring's h
    slots and the sums take more)."""
    if min(B, H, sm_count) < 1 or itemsize not in (2, 4):
        raise ValueError(f"no launch plan for B={B} H={H} itemsize={itemsize} SMs={sm_count}")
    rows = next((r for r in ROW_GROUPS if B <= r), ROW_GROUPS[-1])
    groups = -(-B // rows)
    tiles = -(-H // UNITS_PER_TILE)
    tiles_per_block = -(-tiles // sm_count)
    blocks = -(-tiles // tiles_per_block)
    kc = chunk_rows(itemsize)
    chunks = -(-H // kc)
    # bf16 from 8 rows up takes the tensor cores: two partial sums per column
    # over all the group's rows; else one per warp over a round's rows
    tensor_cores = itemsize == 2 and rows >= 8
    part_rows = 2 * rows if tensor_cores else WARPS * min(rows, EPILOGUE_ROWS)
    # a staged row of h: kc values in the weights' dtype, bf16 rows padded
    h_row = (kc + (8 if itemsize == 2 else 0)) * itemsize
    fixed = (STAGES * (CHUNK_BYTES + rows * h_row) + part_rows * PART_STRIDE * 4
             + BARRIER_BYTES)
    if fixed > smem_limit:
        raise ValueError(f"the ring alone needs {fixed} bytes of shared memory, over {smem_limit}")
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
    kc = chunk_rows(w_h.element_size())
    tiles = -(-H // UNITS_PER_TILE)
    hp = -(-H // kc) * kc
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
            .index_select(1, _swizzled_pieces(hp, packed.device))
            .reshape(tiles, hp, TILE_COLUMNS))


@functools.lru_cache(maxsize=None)
def _swizzled_pieces(hp: int, device) -> torch.Tensor:
    """For each of a tile's hp * 8 pieces, the piece that takes its place."""
    k = torch.arange(hp, device=device)[:, None]
    piece = torch.arange(8, device=device)[None, :]
    return (k * 8 + (piece ^ (k & 7))).reshape(-1)


def plan_for(B: int, H: int, dtype: torch.dtype, device) -> LaunchPlan:
    """The launch plan on `device` (a CUDA device)."""
    props = torch.cuda.get_device_properties(device)
    limit = getattr(props, "shared_memory_per_block_optin", SMEM_LIMIT)
    return launch_plan(B, H, torch.finfo(dtype).bits // 8, props.multi_processor_count, limit)


def stage_h(h0: torch.Tensor, plan: LaunchPlan, dtype: torch.dtype) -> Tuple[torch.Tensor, int]:
    """The kernel's scratch for h, as (a flat tensor of `dtype`, the elements
    of one plane): two planes of h rounded to and stored in the weights'
    dtype, laid out as the kernel stages it ([group, chunk, row, staged row]:
    a chunk's rows lie together), zero where padded, the first holding h0;
    and behind them the four bytes of the barrier's counter, zeroed with
    them by the one fill."""
    B, H = h0.shape
    item = torch.finfo(dtype).bits // 8
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


def run_persistent(fn, name: str, x_proj, packed, c0, h0, seq,
                   outputs: Sequence[torch.Tensor]) -> State:
    """Launch the persistent recurrence `fn` (K1's or K3's entry point) once
    for all T >= 1 steps on CUDA tensors: allocates the state, the scratch
    for the rounded h and the barrier's counter, hands the kernel the launch
    plan, and returns the final (c, h). `outputs` are the tensors the entry
    point writes per step, in its order."""
    T, B, four_h = x_proj.shape
    H = four_h // 4
    device = x_proj.device
    plan = plan_for(B, H, x_proj.dtype, device)
    if tuple(packed.shape) != (plan.tiles, plan.padded_h, TILE_COLUMNS) or \
            packed.dtype != x_proj.dtype or packed.device != device or not packed.is_contiguous():
        raise ValueError(
            f"packed W_h must be {(plan.tiles, plan.padded_h, TILE_COLUMNS)} {x_proj.dtype} "
            f"on {device}, got {tuple(packed.shape)} {packed.dtype} on {packed.device}"
        )
    c = torch.empty_like(c0)
    h = torch.empty_like(h0)
    item = x_proj.element_size()
    scratch, plane = stage_h(h0, plan, x_proj.dtype)
    launch(
        fn, name, device,
        x_proj.data_ptr(), packed.data_ptr(), c0.data_ptr(), h0.data_ptr(),
        c.data_ptr(), h.data_ptr(), scratch.data_ptr(), seq.data_ptr(),
        *(o.data_ptr() for o in outputs),
        scratch.data_ptr() + 2 * plane * item, T, B, H, plan.rows, plan.blocks,
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
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pack_w_h_q(w_h_q: torch.Tensor) -> torch.Tensor:
    """W_h_q [H, 4H] int8 -> the int8 kernel's layout [H/4, 4H, 4] int8: the
    four consecutive k of one column lie in one 32-bit word, low byte
    first, as `__dp4a` takes them. H must be a multiple of 4."""
    H, four_h = w_h_q.shape
    if w_h_q.dtype != torch.int8 or H % 4 or four_h != 4 * H:
        raise ValueError(
            f"w_h_q must be [H, 4H] int8 with H a multiple of 4, got "
            f"{tuple(w_h_q.shape)} {w_h_q.dtype}"
        )
    return w_h_q.reshape(H // 4, 4, four_h).permute(0, 2, 1).contiguous()


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

    if x_proj.dim() != 3 or x_proj.shape[2] % 16:
        raise ValueError(
            f"x_proj must be [T, B, 4H] with H a multiple of 4, got {tuple(x_proj.shape)}"
        )
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
        expected["packed"] = (packed, (H // 4, four_h, 4), torch.int8)
    check_tensors(expected, device)
    if device.type == "cpu":
        return recurrence_q(x_proj, w_h_q, step_scale, c0, h0, seq)
    if packed is None:
        packed = pack_w_h_q(w_h_q)
    c = c0.clone()
    h = torch.empty((2, B, H), dtype=torch.float32, device=device)
    h[0].copy_(h0)
    h_q = torch.empty((2, B, H), dtype=torch.int8, device=device)
    out = torch.empty((T, B, H), dtype=torch.float32, device=device)
    if T == 0:
        return out, (c, h[0])
    lstm_recurrence_q.launches += 1
    launch(
        _library_function_q(x_proj.dtype), "lstm_recurrence_q", device,
        x_proj.data_ptr(), packed.data_ptr(), step_scale.data_ptr(), c.data_ptr(),
        h.data_ptr(), h_q.data_ptr(), seq.data_ptr(), out.data_ptr(), T, B, H,
    )
    return out, (c, h[T % 2])


lstm_recurrence_q.launches = 0
