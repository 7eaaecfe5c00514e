"""Causal attention of the traced prefills (4·D FLOPs a visible pair of
the prompt's real tokens, q, k, v read and o written once) over the
device time of the kernels that run it, in percent."""

from portbench import readers, yardstick

KERNELS = ("flash_fwd_kernel",)


def read(run):
    peak = readers.peak(run)
    if peak is None:
        return None
    w = yardstick.widths(run.cfg)
    bound = sum(w["L"] * yardstick.bound_s(yardstick.k1_cost(w, 1, n), peak)
                for n in readers.prefill_shapes(run, "trace_shapes"))
    return readers.roofline(run, bound, KERNELS)
