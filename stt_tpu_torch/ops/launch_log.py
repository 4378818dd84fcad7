"""Kernel launch counts of a whole process, for a caller that runs the
port's command lines as child processes and cannot read their wrappers'
`.launches`: with STT_TORCH_LAUNCH_LOG=FILE in the environment, the
process appends one JSON line to FILE when it exits,

    {"pid": ..., "argv": [...], "k1": n, "k2": n, "k3": n, "k4": n, "k5": n}

where each count is the `.launches` of that kernel's wrapper (0 where its
module was never imported). `stt_tpu_torch.ops` installs the hook on import.
"""

from __future__ import annotations

import atexit
import json
import os
import sys

ENV = "STT_TORCH_LAUNCH_LOG"
WRAPPERS = {  # kernel -> (module, wrapper)
    "k1": ("stt_tpu_torch.ops.lstm_kernel", "lstm_recurrence"),
    "k2": ("stt_tpu_torch.ops.lstm_kernel", "lstm_recurrence_q"),
    "k3": ("stt_tpu_torch.ops.lstm_train", "lstm_train_fwd"),
    "k4": ("stt_tpu_torch.ops.lstm_train", "lstm_train_bwd"),
    "k5": ("stt_tpu_torch.ops.beam_kernel", "beam_scan"),
}
_installed = []


def counts() -> dict:
    """Each kernel's launches in this process so far."""
    out = {}
    for key, (module, name) in WRAPPERS.items():
        loaded = sys.modules.get(module)
        out[key] = getattr(loaded, name).launches if loaded is not None else 0
    return out


def _write(path: str) -> None:
    line = json.dumps({"pid": os.getpid(), "argv": sys.argv, **counts()})
    with open(path, "a") as f:
        f.write(line + "\n")


def install() -> None:
    """Register the exit hook when the environment names a file (once)."""
    path = os.environ.get(ENV)
    if path and not _installed:
        _installed.append(path)
        atexit.register(_write, os.path.abspath(path))


def read(path: str) -> dict:
    """The counts of every process that wrote to `path`, summed, and the
    number of processes."""
    total = dict.fromkeys(WRAPPERS, 0)
    processes = 0
    if os.path.isfile(path):
        with open(path) as f:
            for line in f:
                record = json.loads(line)
                processes += 1
                for key in total:
                    total[key] += record[key]
    return {**total, "processes": processes}
