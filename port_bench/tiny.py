"""Tiny versions of each cell for the CPU tests: the cell's configuration
and mix with the widths, batches, beams and durations cut so that a run
takes seconds on the CPU. Nothing that runs on the card uses them.

The serving mixes' logit scale (1000) is set for the full widths: at 32
wide it gives the program readings up to 8e-4 on the CPU, where a scale
of 100 gives 3e-7 against the control's 5e-3 and above; the tiny mixes
take 100."""

from port_bench import generator, harness

CUTS = {
    "train": dict(batch=4, seconds=[1.0, 1.4], pad_frames=70, reference_rows=2),
    "batch": dict(batch=3, seconds=[0.5, 1.5], batches=2, beam_width=8, sample=3,
                  logit_scale=100.0),
    "pool": dict(streams=3, seconds=[0.5, 1.5], bank=8, beam_width=8, warmup_ticks=6, sample=3,
                 logit_scale=100.0),
}


# The comparison's limits at these sizes, from CPU readings of the program
# and of the control (the reference with TF32 operands): training, the
# program's loss, first-gradient and change gaps read 1e-7, 1.4e-5 and
# 4.4e-5 against the control's 1.0e-5, 3.5e-4 and 1.3e-3; transcription,
# the program's beam gap 3e-7 to 3e-6 against the control's 5e-3 and above.
LIMITS = {"train": {"loss_gap": 2e-6, "grad_gap": 1e-4, "change_gap": 3e-4},
          "batch": {"beam_gap": 1e-4}, "pool": {"beam_gap": 1e-4}}


def run(cell: str, seed: int = 2 ** 31 + 12345, seconds: float = 2.0) -> harness.Run:
    workload = generator.load_json("workloads", cell)
    cfg = dict(generator.load_json("configs", workload["config"]), n_hidden=32, n_cell_dim=32)
    traffic = generator.load_json("traffic", workload["traffic"])
    traffic.update(CUTS[traffic["driver"]])
    workload = dict(workload, limits=LIMITS[traffic["driver"]])
    return harness.Run(cell, seed, seconds, False, device="cpu", workload=workload, cfg=cfg,
                       traffic=traffic)
