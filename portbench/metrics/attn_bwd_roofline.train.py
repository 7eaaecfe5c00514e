"""Causal attention backward of the traced train steps (dK/dV at 8·D
FLOPs a visible pair, dQ at 6·D): the least time for the work over
the device time of the kernels that run it, in percent."""

from portbench import readers, yardstick

KERNELS = ("flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")


def read(run):
    peak = readers.peak(run)
    n = run.work.get("trace_steps", 0)
    if peak is None or not n:
        return None
    w = yardstick.widths(run.cfg)
    b, t = run.traffic["batch"], run.traffic["seq"]
    bound = (yardstick.bound_s(yardstick.k2_cost(w, b, t), peak)
             + yardstick.bound_s(yardstick.k3_cost(w, b, t), peak))
    return readers.roofline(run, n * w["L"] * bound, KERNELS)
