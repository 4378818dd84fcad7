"""CTC beam expansion and prune over a chunk of frames: the wrapper of the
Hopper kernel in `csrc/beam_scan.cu`, which replaces the TPU kernel
`stt_tpu/ops/beam_kernel.py::_make_kernel` (one frame per grid step, beam
state resident across frames).

`beam_scan` launches the kernel for CUDA tensors and runs the plain version
(`stt_tpu_torch.decode.device.beam_scan_plain`) for CPU tensors. The state
between chunks keeps the JAX package's layout (`init_state`): beams padded
with dead slots (-inf, hash (0, 0)), so the kernel's state and the plain
version's interchange mid-stream (`state_to_plain`, `state_from_plain`).

Capacity (`supports`): the TPU kernel takes beam <= 128 and classes <= 127;
the Hopper kernel takes every beam and every alphabet, in three instances
(`instance`). Shapes whose candidate pool beam x (classes + 1) fits
MAX_POOL = 16,384 keys over at most 127 classes run in the narrow
instance, with the pool in shared memory and masks of 128 lanes; beams up
to WIDE_SLOTS = 512 over up to MAX_CLASSES = 256 classes (the blank last at
256) run in the wide instance, whose pool lies in a scratch of device
memory that the wrapper allocates and whose masks have 256 lanes; every
other shape (beams above 512, larger alphabets, 256 classes with another
blank) runs in the huge instance, which also keeps in device memory
whatever of its per-slot, per-class, table, sort and strike-out arrays its
shared memory does not hold (a workspace the wrapper allocates). Beams up to
WSLOTS = 128 keep the TPU kernel's 128-slot state and, in the narrow and
wide instances, its int16 backpointer plane (7 bits of source slot above 8
bits of character + 1); beams up to 512 have a 512-slot state and an int32
plane of the same packing; beams above 512 a state of the beam rounded up
to a multiple of 128 slots. The huge instance returns its backpointers as
the pair of int32 planes (bp_src, bp_char) that the plain version returns,
since its characters may pass 254. Its flat candidate indices are ints:
beam x (classes + 1) may be at most MAX_FLAT = 2^30.

`beam_backtrack` walks each row's best beams back through those
backpointers where they lie, with a second kernel of the same source (the
backtrace) on CUDA tensors, so that a batch decode sends the host its
paths and not its [B, T, W] planes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from stt_tpu_torch.decode.device import (
    NEG_INF,
    PATH_HEAD,
    BeamState,
    backtrack_plain,
    beam_scan_plain,
    class_masks,
    logaddexp,
)
from stt_tpu_torch.ops._build import check_tensors, launch, load

WSLOTS = 128  # beam slots of the state between chunks, beams up to 128
WIDE_SLOTS = 512  # the same for beams up to 512, the wide instance's most
SLOT_STEP = 128  # beams above 512: the state's slots are the beam rounded up to this
LANES = 128  # class lanes of the narrow instance's masks: classes <= 127
WIDE_LANES = 256  # of the wide instance's
MAX_CLASSES = WIDE_LANES  # classes the wide instance takes
MAX_POOL = 16384  # candidates per frame, beam x (classes + 1), of the narrow instance
MAX_FLAT = 1 << 30  # candidates per frame of the huge instance

# (f [2, B, 1, S] f32: p_b, p_nb; i [5, B, 1, S] int32: last, ha, hb,
#  par_ha, par_hb; started [B, 1, 1] int32), S = state_slots(beam)
KernelState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def supports(beam_width: int, n_class: int, blank_id: Optional[int] = None) -> bool:
    """Shapes the kernel takes: every beam and alphabet, up to MAX_FLAT
    candidates a frame."""
    return beam_width >= 1 and n_class >= 1 and beam_width * (n_class + 1) <= MAX_FLAT


def is_narrow(beam_width: int, n_class: int) -> bool:
    """Whether the shape runs in the narrow instance (pool in shared memory)."""
    return (beam_width <= WIDE_SLOTS and n_class <= LANES - 1
            and beam_width * (n_class + 1) <= MAX_POOL)


def instance(beam_width: int, n_class: int, blank_id: Optional[int] = None) -> str:
    """The kernel instance that takes the shape (blank_id None: the last
    class): "narrow", "wide" (beam <= 512, classes <= 256, a character of
    at most 254) or "huge" (every other shape)."""
    if is_narrow(beam_width, n_class):
        return "narrow"
    last_is_blank = blank_id is None or blank_id == n_class - 1
    if (beam_width <= WIDE_SLOTS and n_class <= MAX_CLASSES
            and (n_class < MAX_CLASSES or last_is_blank)):
        return "wide"
    return "huge"


def state_slots(beam_width: int) -> int:
    """Slots of the state tensors for this beam."""
    if beam_width <= WSLOTS:
        return WSLOTS
    if beam_width <= WIDE_SLOTS:
        return WIDE_SLOTS
    return -(-beam_width // SLOT_STEP) * SLOT_STEP


def _masks(n_class: int, blank: int, ignored_symbols: Sequence[int],
           default_blank: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(not-ignored [1, 1, lanes] int32, 0 on ignored and padded lanes;
    static rank [1, 1, lanes] int32), with LANES lanes up to 127 classes,
    WIDE_LANES up to 256 and one a class above."""
    lanes = LANES if n_class <= LANES - 1 else max(WIDE_LANES, n_class)
    not_ignored, rank_c = class_masks(n_class, blank, ignored_symbols, default_blank)
    nign = np.zeros((lanes,), np.int32)
    nign[:n_class] = not_ignored
    rank = np.arange(lanes, dtype=np.int32)
    rank[:n_class] = rank_c
    return nign.reshape(1, 1, lanes), rank.reshape(1, 1, lanes)


@functools.lru_cache(maxsize=64)
def _device_masks(n_class, blank, ignored_symbols, default_blank, device):
    nign, rank = _masks(n_class, blank, ignored_symbols, default_blank)
    return torch.from_numpy(nign.ravel()).to(device), torch.from_numpy(rank.ravel()).to(device)


def init_state(batch: int, device="cpu", slots: int = WSLOTS) -> KernelState:
    """Root-only beam state, padded to `slots` slots (dead = -inf, hash 0)."""
    f = torch.full((2, batch, 1, slots), NEG_INF, device=device)
    f[0, :, 0, 0] = 0.0
    i = torch.zeros((5, batch, 1, slots), dtype=torch.int32, device=device)
    i[0] = -1
    i[1:3, :, 0, 0] = 1
    return f, i, torch.zeros((batch, 1, 1), dtype=torch.int32, device=device)


def state_to_plain(state: KernelState, beam_width: int) -> BeamState:
    """The first `beam_width` slots as the plain version's state."""
    f, i, started = state
    W = beam_width
    return (f[0, :, 0, :W], f[1, :, 0, :W], *(i[k, :, 0, :W] for k in range(5)),
            started[:, 0, 0] != 0)


def state_from_plain(state: BeamState) -> KernelState:
    """The plain version's state padded with dead slots to its beam's
    `state_slots`."""
    p_b, p_nb, last, ha, hb, par_ha, par_hb, started = state
    B, W = p_b.shape
    f, i, _ = init_state(B, p_b.device, state_slots(W))
    f[0, :, 0, 0] = NEG_INF
    i[1:3, :, 0, 0] = 0
    f[0, :, 0, :W], f[1, :, 0, :W] = p_b, p_nb
    for k, plane in enumerate((last, ha, hb, par_ha, par_hb)):
        i[k, :, 0, :W] = plane
    return f, i, started.to(torch.int32).reshape(B, 1, 1)


def pack_bp(src: torch.Tensor, char: torch.Tensor) -> torch.Tensor:
    """(bp_src, bp_char) [..., W] -> the packed plane (src << 8) | (char + 1),
    int16 for beams up to WSLOTS and int32 above."""
    packed = (src.to(torch.int32) << 8) | (char.to(torch.int32) + 1)
    return packed.to(torch.int16) if src.shape[-1] <= WSLOTS else packed


def unpack_bp(packed) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side unpack of beam_scan's packed plane, or of the huge
    instance's (bp_src, bp_char) pair -> (bp_src, bp_char)."""
    if isinstance(packed, tuple):
        return tuple(np.asarray(p.cpu() if isinstance(p, torch.Tensor) else p) for p in packed)
    p = np.asarray(packed).astype(np.int32)
    return p >> 8, (p & 0xFF) - 1


@functools.lru_cache(maxsize=None)
def _library_function(define: str = "", kind: str = "narrow"):
    """The entry point of the instance `kind`: the wide one takes the pool's
    scratch after cutoff_prob, the huge one the pool and its workspace (and
    no bp_wide)."""
    lib = load("beam_scan", define)
    fn = getattr(lib, {"narrow": "beam_scan", "wide": "beam_scan_wide",
                       "huge": "beam_scan_huge"}[kind])
    n_int = 8 if kind == "huge" else 9
    n_tail = {"narrow": 1, "wide": 2, "huge": 3}[kind]
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * n_int + [ctypes.c_float]
                   + [ctypes.c_void_p] * n_tail)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=256)
def huge_workspace_bytes(beam_width: int, slots: int, n_class: int) -> int:
    """Bytes of device memory per utterance that the huge instance's
    layout puts outside shared memory (`huge_layout` in the source)."""
    fn = load("beam_scan").beam_scan_huge_workspace
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return int(fn(beam_width, slots, n_class))


def beam_scan(
    probs: torch.Tensor,
    seq_lengths: torch.Tensor,
    beam_width: int,
    cutoff_top_n: int = 40,
    cutoff_prob: float = 1.0,
    blank_id: Optional[int] = None,
    ignored_symbols: Sequence[int] = (),
    state: Optional[KernelState] = None,
):
    """Advance B beams over probs [B, T, C] (softmax, f32); frames at or
    past seq_lengths [B] int32 are no-ops.

    Returns (state', scores [B, W] with W = beam_width, bp). For the narrow
    and wide instances' shapes bp packs each frame's backpointers [B, T, W]
    as (src << 8) | (char + 1), int16 for W <= 128 and int32 above, and
    `unpack_bp` recovers the (bp_src, bp_char) pair `rebuild_results`
    walks; for the huge instance's shapes bp is that pair of int32 [B, T,
    W] tensors. `state` threads streaming chunks (the layout of
    `init_state` with `state_slots(W)` slots)."""
    if probs.dim() != 3:
        raise ValueError(f"probs must be [B, T, C], got {tuple(probs.shape)}")
    B, T, C = probs.shape
    W = int(beam_width)
    if not supports(W, C, blank_id):
        raise ValueError(
            f"the beam kernel takes W >= 1 and W (C + 1) <= {MAX_FLAT} candidates a "
            f"frame; got W = {W}, C = {C}")
    blank = C - 1 if blank_id is None else int(blank_id)
    ignored = tuple(int(s) for s in ignored_symbols)
    if not 0 <= blank < C or any(not 0 <= s < C for s in ignored):
        raise ValueError("blank_id and ignored_symbols must be class indices")
    device = probs.device
    slots = state_slots(W)
    kind = instance(W, C, blank_id)
    if state is None:
        state = init_state(B, device, slots)
    f, i, started = state
    check_tensors({
        "probs": (probs, (B, T, C), torch.float32),
        "seq_lengths": (seq_lengths, (B,), torch.int32),
        "state[0]": (f, (2, B, 1, slots), torch.float32),
        "state[1]": (i, (5, B, 1, slots), torch.int32),
        "state[2]": (started, (B, 1, 1), torch.int32),
    }, device)
    if device.type == "cpu":
        plain, src, char = beam_scan_plain(
            state_to_plain(state, W), probs, seq_lengths, W, int(cutoff_top_n),
            float(cutoff_prob), blank_id, ignored,
        )
        bp = (src, char) if kind == "huge" else pack_bp(src, char)
        return state_from_plain(plain), logaddexp(plain[0], plain[1]), bp
    out_f, out_i, out_started = torch.empty_like(f), torch.empty_like(i), torch.empty_like(started)
    nign, rank = _device_masks(C, blank, ignored, blank_id is None, device)
    # what the frame's emission cutoff does: 2 sorts the classes and cuts by
    # cumulative mass or count, 1 only sorts, 0 keeps the static order
    mode = 2 if cutoff_prob < 1.0 else 1 if cutoff_top_n < C else 0
    # the wide and huge instances' pool: every key of a frame, in device memory
    pool = None if kind == "narrow" else torch.empty(
        (B, W * (C + 1)), dtype=torch.int64, device=device)
    args = (probs.data_ptr(), seq_lengths.data_ptr(), nign.data_ptr(), rank.data_ptr(),
            f.data_ptr(), i.data_ptr(), started.data_ptr(),
            out_f.data_ptr(), out_i.data_ptr(), out_started.data_ptr())
    if kind == "huge":
        bp = torch.empty((2, B, T, W), dtype=torch.int32, device=device)
        ws_bytes = huge_workspace_bytes(W, slots, C)
        ws = torch.empty((B * ws_bytes,), dtype=torch.uint8, device=device) if ws_bytes else None
        beam_scan.launches += 1
        launch(_library_function(kind=kind), "beam_scan", device, *args, bp.data_ptr(),
               B, T, W, slots, C, blank, int(cutoff_top_n), mode, float(cutoff_prob),
               pool.data_ptr(), None if ws is None else ws.data_ptr())
        bp = (bp[0], bp[1])
    else:
        wide = W > WSLOTS
        bp = torch.empty((B, T, W), dtype=torch.int32 if wide else torch.int16, device=device)
        beam_scan.launches += 1
        launch(_library_function(kind=kind), "beam_scan", device, *args, bp.data_ptr(),
               B, T, W, slots, C, blank, int(cutoff_top_n), mode, int(wide),
               float(cutoff_prob), *(() if pool is None else (pool.data_ptr(),)))
    scores = logaddexp(out_f[0, :, 0, :W], out_f[1, :, 0, :W])
    return (out_f, out_i, out_started), scores, bp


beam_scan.launches = 0


@functools.lru_cache(maxsize=None)
def _backtrack_function():
    fn = load("beam_scan").beam_backtrack
    # scores, bp, bp_char; bp's bytes; out; B, T, W, R; the stream
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def beam_backtrack(scores: torch.Tensor, bp, num_results: int = 1) -> torch.Tensor:
    """The paths of each row's `num_results` best beams, walked back through
    `beam_scan`'s backpointers where they lie: the backtrace kernel in
    `csrc/beam_scan.cu` on CUDA tensors, its plain version
    (`stt_tpu_torch.decode.device.backtrack_plain`, which documents the
    [B, num_results, PATH_HEAD + 2 T] int32 result) on CPU tensors.

    scores [B, W] and bp as `beam_scan` returns them: the packed plane
    [B, T, W] (int16 or int32) or the huge instance's (bp_src, bp_char)
    pair; the kernel reads whichever it is given."""
    pair = isinstance(bp, tuple)
    plane = bp[0] if pair else bp
    if plane.dim() != 3:
        raise ValueError(f"backpointers must be [B, T, W], got {tuple(plane.shape)}")
    B, T, W = plane.shape
    R = int(num_results)
    if R < 0:
        raise ValueError(f"num_results must be at least 0, got {R}")
    device = plane.device
    scores = scores.contiguous()
    if pair:
        planes = {"bp_src": (bp[0], (B, T, W), torch.int32),
                  "bp_char": (bp[1], (B, T, W), torch.int32)}
    else:  # the packed plane: int16 or int32
        planes = {"bp": (bp, (B, T, W), bp.dtype if bp.dtype == torch.int16 else torch.int32)}
    check_tensors({"scores": (scores, (B, W), torch.float32), **planes}, device)
    if device.type == "cpu":
        return backtrack_plain(scores, bp, R)
    out = torch.empty((B, R, PATH_HEAD + 2 * T), dtype=torch.int32, device=device)
    if B * R == 0:
        return out
    beam_backtrack.launches += 1
    launch(_backtrack_function(), "beam_backtrack", device, scores.data_ptr(), plane.data_ptr(),
           bp[1].data_ptr() if pair else None, plane.element_size(), out.data_ptr(), B, T, W, R)
    return out


beam_backtrack.launches = 0
