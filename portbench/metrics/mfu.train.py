"""Model FLOPs of the window's untraced steps (three times the forward,
no recomputation; the benchmark's own count) over their wall and the
card's bf16 peak, in percent."""

from portbench import readers, yardstick


def read(run):
    peak = readers.peak(run)
    wall = sum(r["wall_s"] for r in run.steps)
    if peak is None or not wall:
        return None
    flops = yardstick.train_step_flops(
        yardstick.widths(run.cfg), run.traffic["batch"], run.traffic["seq"])
    return 100.0 * flops * len(run.steps) / wall / peak["bf16_flops"]
