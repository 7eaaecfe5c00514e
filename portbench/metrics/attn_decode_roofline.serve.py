"""Paged decode attention of the traced decode steps (each row's live
K/V read once, 4·D FLOPs a live key) over the device time of the
kernels that run it, in percent."""

from portbench import readers, yardstick

KERNELS = ("paged_split_kernel", "paged_combine_kernel")


def read(run):
    peak = readers.peak(run)
    if peak is None:
        return None
    w = yardstick.widths(run.cfg)
    bound = sum(w["L"] * yardstick.bound_s(yardstick.k4_cost(w, c), peak)
                for c in readers.decode_shapes(run, "trace_shapes"))
    return readers.roofline(run, bound, KERNELS)
