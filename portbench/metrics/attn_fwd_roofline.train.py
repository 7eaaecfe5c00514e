"""Causal attention forward of the traced train steps: the least time
the card could take for the work (4·D FLOPs a visible pair, q, k, v
read and o written once) over the device time of the kernels that run
it, in percent."""

from portbench import readers, yardstick

KERNELS = ("flash_fwd_kernel",)


def read(run):
    peak = readers.peak(run)
    n = run.work.get("trace_steps", 0)
    if peak is None or not n:
        return None
    w = yardstick.widths(run.cfg)
    cost = yardstick.k1_cost(w, run.traffic["batch"], run.traffic["seq"])
    return readers.roofline(run, n * w["L"] * yardstick.bound_s(cost, peak),
                            KERNELS)
