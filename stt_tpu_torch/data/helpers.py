"""Small data-layer helpers: augmentation value ranges with curriculum
"clock" support (parity: util/helpers.py:166-244)."""

from __future__ import annotations

import random
from collections import namedtuple

ValueRange = namedtuple("ValueRange", ["start", "end", "r"])


def get_value_range(value, target_type) -> ValueRange:
    """Parse "<v>", "<v>~<r>", "<start>:<end>~<r>" (or numbers/tuples)."""
    if isinstance(value, str):
        if "~" in value:
            value, _, r = value.partition("~")
        else:
            r = 0
        parts = value.split(":")
        if len(parts) == 1:
            parts.append(parts[0])
        if len(parts) != 2:
            raise ValueError(f"cannot parse value range {value!r}")
        return ValueRange(target_type(parts[0]), target_type(parts[1]), target_type(r))
    if isinstance(value, tuple):
        if len(value) == 2:
            return ValueRange(target_type(value[0]), target_type(value[1]), target_type(0))
        if len(value) == 3:
            return ValueRange(*(target_type(v) for v in value))
        raise ValueError("cannot convert to ValueRange: wrong tuple size")
    if isinstance(value, (int, float)):
        return ValueRange(target_type(value), target_type(value), target_type(0))
    raise ValueError(f"cannot convert {value!r} to ValueRange")


def int_range(value) -> ValueRange:
    return get_value_range(value, int)


def float_range(value) -> ValueRange:
    return get_value_range(value, float)


def pick_value_from_range(value_range: ValueRange, clock=None, rng=None):
    """Linear sweep start->end over the training "clock" in [0,1], with
    uniform jitter of radius r."""
    rng = rng or random
    clock = rng.random() if clock is None else max(0.0, min(1.0, float(clock)))
    value = value_range.start + clock * (value_range.end - value_range.start)
    value = rng.uniform(value - value_range.r, value + value_range.r)
    return round(value) if isinstance(value_range.start, int) else value
