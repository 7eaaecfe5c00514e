"""The whole decode step's roofline share: over the window's decode
steps, the least time the card could take (the larger of FLOPs over the
bf16 peak and bytes over the HBM bandwidth, the bytes being the weights
read once, the live K/V read and the new K/V written) over the steps'
wall (step ledger), in percent."""

from portbench import readers, yardstick


def read(run):
    peak = readers.peak(run)
    wall = sum(r["wall_s"] for r in run.steps)
    shapes = readers.decode_shapes(run)
    if peak is None or not wall or not shapes:
        return None
    w = yardstick.widths(run.cfg)
    bound = sum(yardstick.bound_s(yardstick.decode_step_cost(w, c), peak)
                for c in shapes)
    return 100.0 * bound / wall
