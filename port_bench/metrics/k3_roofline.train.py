"""K3's share of its roofline: the least time of the training forward's
recurrence over each step's shape (T = pad_frames, B rows, the valid steps
that need h . W_h; yardstick.recurrence_bounds "fwd") over the device time
of its kernels in the traced window."""

from port_bench import harness, yardstick

UNIT = "%"
SOURCE = "device_trace"
LAYER = "K3 (ops/lstm_train.py)"
MOVES = "train_audio_s_per_s"
KERNELS = ("recurrence_kernel",)


def read(run):
    r = run.records
    seconds = harness.kernel_seconds(run, KERNELS)
    if not seconds:
        return None
    bound = sum(yardstick.recurrence_bounds("fwd", r["pad_frames"], r["batch"],
                                            run.cfg["n_cell_dim"], v, run.cfg["dtype"])[0]
                for v in r["valid_steps"]) / 1e3
    return 100 * bound / seconds
