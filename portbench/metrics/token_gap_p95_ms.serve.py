"""95th percentile (nearest rank) of the gap between a row's tokens:
over the window's decode steps, the time from the previous step's end
to this one's (the step ledger's ``between_s + wall_s``, prefills in
between included), each step counted once per token it committed, in
milliseconds.  Nothing where the records carry no ``between_s``."""

from portbench import yardstick


def read(run):
    gaps = []
    for r in run.steps:
        if r.get("between_s") is not None and r.get("tokens"):
            gaps += [r["between_s"] + r["wall_s"]] * int(round(r["tokens"]))
    return None if not gaps else 1e3 * yardstick.nearest_rank(gaps, 0.95)
