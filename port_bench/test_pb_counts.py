"""The operations and bytes of each roofline against hand counts at the
configurations' sizes, and the reduction of a trace."""

import pytest

from port_bench import generator, yardstick

EN = generator.load_json("configs", "ds-en-2048")
ZH = generator.load_json("configs", "ds-zh-bytes-2048")


def test_forward_and_training_operations_a_frame():
    # 494 x 2048 + 2 x 2048^2 + (2048 + 2048) x 8192 + 2048^2 + 2048 x 29 multiply-adds
    macs = 494 * 2048 + 2048 * 2048 * 2 + 4096 * 8192 + 2048 * 2048 + 2048 * 29
    assert macs == 47_208_448
    assert yardstick.forward_flops_per_frame(EN) == 2 * macs == 94_416_896
    assert yardstick.train_flops_per_frame(EN) == 283_250_688
    assert yardstick.forward_flops_per_frame(ZH) == 2 * (macs + 2048 * (256 - 29))


def test_parameter_counts_are_the_releases():
    assert yardstick.param_count(EN) == EN["params"] == 47_224_861
    assert yardstick.param_count(ZH) == ZH["params"] == 47_224_861 + 227 * 2049


@pytest.mark.parametrize("kind", ["k1", "fwd", "bwd"])
def test_recurrence_bounds_by_hand(kind):
    T, B, H, valid = 500, 512, 2048, 230_000
    ops = 2 * valid * H * 4 * H
    state = 2 * B * H * 4
    moved = {
        "k1": T * B * 4 * H * 4 + H * 4 * H * 4 + 2 * state + B * 4 + T * B * H * 4,
        "fwd": T * B * 4 * H * 4 + H * 4 * H * 4 + 2 * state + B * 4 + 2 * T * B * H * 4
        + T * B * 4 * H * 2,
        "bwd": T * B * 4 * H * 2 + 3 * T * B * H * 4 + H * 4 * H * 4 + B * 4 + 2 * state
        + T * B * 4 * H * 4,
    }[kind]
    ms, by = yardstick.recurrence_bounds(kind, T, B, H, valid, "float32")
    assert by == "operations"
    assert ms == pytest.approx(max(ops / 67e12, moved / 3.35e12) * 1e3)
    assert ms == pytest.approx(115.19, abs=0.01)  # 7.72 TFLOP at 67 TFLOP/s


def test_beam_bound_by_hand():
    # one utterance of 500 frames, beam 500 over 256 classes: 4-byte backpointers
    frames, W, C = 500, 500, 256
    moved = frames * (C * 4 + W * 4) + (4 + 2 * C * 4 + 2 * (7 * W * 4 + 4))
    ms, by = yardstick.beam_bound_ms(1, frames, W, C)
    assert by == "bytes" and ms == pytest.approx(moved / 3.35e12 * 1e3)
    # 29 classes: a slot and a class fit in 16 bits
    ms29, _ = yardstick.beam_bound_ms(1, frames, W, 29)
    assert ms29 == pytest.approx((frames * (29 * 4 + W * 2) + 4 + 2 * 29 * 4
                                  + 2 * (7 * W * 4 + 4)) / 3.35e12 * 1e3)


def test_union_and_gaps():
    intervals = [("a", 10, 20), ("b", 15, 30), ("c", 40, 50), ("d", 60, 70)]
    busy, gaps = yardstick.union_ns(intervals, 0, 65)
    assert busy == (30 - 10) + (50 - 40) + (65 - 60)
    assert gaps == [(0, 10), (30, 40), (50, 60)]
