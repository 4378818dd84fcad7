"""The benchmark's fixed arithmetic: the card's peaks, the operations and
bytes of each layer's work counted from the call's shapes, and the profiler
reduction. Frozen copies of what chip_smoke.py computes (`bound_ms`,
`recurrence_bounds`, K5's bound in `k5_phase`), so that a change to the
program cannot move the yardstick. The reduction reads each device
operation's interval, not chip_smoke.py's sums by name (`device_events`):
the idle share needs their union.

Every count here depends on shapes and lengths alone, never on how the
program computes them.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}  # dense, H100 SXM data sheet


def bound_ms(moved_bytes: float, ops: float, dtype: str) -> tuple:
    """Least time for a function's work on the card: the bytes it must move
    (each input read once, each output written once) at the memory rate
    against its matmul operations at the peak rate of the input type.
    Returns (bound_ms, bound_by)."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def recurrence_bounds(kind: str, T: int, B: int, H: int, valid_steps: int,
                      dtype: str) -> tuple:
    """(bound_ms, bound_by) of the inference recurrence ("k1"), the training
    forward with stashes ("fwd") or the reverse sweep ("bwd") over T steps
    of B rows, of which valid_steps (the sum of the lengths) need the
    product h . W_h (or dz . W_h^T), 2 H 4H operations each."""
    item = 4 if dtype == "float32" else 2
    state = 2 * B * H * 4  # (c, h) or (dc, dh), f32
    w_h = H * 4 * H * item
    if kind == "k1":  # x_proj, W_h, state, seq -> out, state
        moved = T * B * 4 * H * item + w_h + state + B * 4 + T * B * H * 4 + state
    elif kind == "fwd":  # ... -> hs, cs (f32), zs (bf16), state
        moved = (T * B * 4 * H * item + w_h + state + B * 4 + 2 * T * B * H * 4
                 + T * B * 4 * H * 2 + state)
    else:  # zs (bf16), cs, cs_prev, dout, W_h, seq, state -> dz (f32), state
        moved = (T * B * 4 * H * 2 + 3 * T * B * H * 4 + w_h + B * 4 + state
                 + T * B * 4 * H * 4 + state)
    return bound_ms(moved, 2 * valid_steps * H * 4 * H, dtype)


def beam_bound_ms(calls: int, frames: int, beam: int, classes: int) -> tuple:
    """(bound_ms, bound_by) of the CTC prefix beam search over `frames`
    valid frames in `calls` calls of one utterance each: the emissions read
    once, a backpointer per (frame, beam slot) written once (2 bytes where
    a slot index and a class fit in 16 bits, else 4), and each call's beam
    state (two log probabilities and five words a slot) read and written.
    The expansion's arithmetic is no matmul: the bound is bytes."""
    bp_bytes = 2 if beam * (classes + 1) <= 1 << 16 else 4
    state_bytes = (2 + 5) * beam * 4 + 4
    moved = frames * (classes * 4 + beam * bp_bytes) + calls * (4 + 2 * classes * 4
                                                                 + 2 * state_bytes)
    return bound_ms(moved, 0, "float32")


def forward_flops_per_frame(cfg: dict) -> int:
    """Matmul operations of one frame through the acoustic model: 2 per
    multiply-add of each dense layer and of the LSTM's [x, h] . W."""
    n_in = (2 * cfg["n_context"] + 1) * cfg["n_input"]
    h, cell, out = cfg["n_hidden"], cfg["n_cell_dim"], cfg["n_out"]
    macs = n_in * h + h * h + h * cell + (cell + cell) * 4 * cell + cell * h + h * out
    return 2 * macs


def train_flops_per_frame(cfg: dict) -> int:
    """The forward and its backward (the input and the weight gradients,
    twice the forward's products)."""
    return 3 * forward_flops_per_frame(cfg)


def param_count(cfg: dict) -> int:
    """Weights (one per multiply-add of a frame) and biases."""
    h, cell, out = cfg["n_hidden"], cfg["n_cell_dim"], cfg["n_out"]
    biases = h + h + cell + 4 * cell + h + out
    return forward_flops_per_frame(cfg) // 2 + biases


def kernel_intervals(prof) -> list:
    """Every operation the profiler saw on the card, as (name, start_ns,
    end_ns) in the profiler's clock."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns(), e.duration_ns()
        else:
            start, dur = e.start_us() * 1000, e.duration_us() * 1000
        if dur > 0:
            out.append((e.name(), int(start), int(start + dur)))
    return out


def union_ns(intervals: list, lo: int, hi: int) -> tuple:
    """(nanoseconds covered by the union of intervals clipped to [lo, hi],
    the idle gaps between them as (start, end) pairs)."""
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in intervals if e > lo and s < hi)
    busy, gaps, cursor = 0, [], lo
    for s, e in spans:
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if hi > cursor:
        gaps.append((cursor, hi))
    return busy, gaps
