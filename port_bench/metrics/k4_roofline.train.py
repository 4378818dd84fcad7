"""K4's share of its roofline: the least time of the training backward's
reverse sweep over each step's shape (yardstick.recurrence_bounds "bwd")
over the device time of its kernels in the traced window. The weight
gradient's matmul lies outside K4 and outside this bound."""

from port_bench import harness, yardstick

UNIT = "%"
SOURCE = "device_trace"
LAYER = "K4 (ops/lstm_train.py)"
MOVES = "train_audio_s_per_s"
KERNELS = ("bwd_kernel",)


def read(run):
    r = run.records
    seconds = harness.kernel_seconds(run, KERNELS)
    if not seconds:
        return None
    bound = sum(yardstick.recurrence_bounds("bwd", r["pad_frames"], r["batch"],
                                            run.cfg["n_cell_dim"], v, run.cfg["dtype"])[0]
                for v in r["valid_steps"]) / 1e3
    return 100 * bound / seconds
