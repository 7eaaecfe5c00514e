"""Model FLOPs of the window's prefills and decode steps (the
benchmark's own count from the work each iteration handed the
program) over the window and the card's bf16 peak, in percent."""

from portbench import readers, yardstick


def read(run):
    peak = readers.peak(run)
    if peak is None or "shapes" not in run.work or not run.window_s:
        return None
    w = yardstick.widths(run.cfg)
    flops = sum(yardstick.prefill_flops(w, n)
                for n in readers.prefill_shapes(run))
    flops += sum(yardstick.decode_step_cost(w, c)["flops"]
                 for c in readers.decode_shapes(run))
    return 100.0 * flops / run.window_s / peak["bf16_flops"]
