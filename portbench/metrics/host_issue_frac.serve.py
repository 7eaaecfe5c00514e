"""Share of the window's decode steps' wall that the host spent before
its first wait on the card (the step ledger's ``host_issue_s``, which a
decode step ends at its ``serving.decode.wait`` span, over ``wall_s``),
in percent.  Nothing where the records carry no ``device_wait_s``: a
program that does not mark the wait stamps ``host_issue_s`` after it."""


def read(run):
    steps = [r for r in run.steps if r.get("device_wait_s") is not None]
    wall = sum(r["wall_s"] for r in steps)
    if not wall:
        return None
    return 100.0 * sum(r["host_issue_s"] for r in steps) / wall
