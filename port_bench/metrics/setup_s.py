"""Set-up: from the process's start (before torch is imported) to the
window's start: imports, the card's context, the kernels' build on a
checkout's first run, the inputs and weights, the warm-up."""

UNIT = "s"
SOURCE = "host_clock"


def read(run):
    return run.records["setup_end"] - run.records["started"]
