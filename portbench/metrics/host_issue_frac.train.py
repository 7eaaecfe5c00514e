"""Share of the window's steps' wall that the host spent issuing the
step before it waited on the card (the step ledger's ``host_issue_s``
over ``wall_s``), in percent."""


def read(run):
    wall = sum(r["wall_s"] for r in run.steps)
    if not wall:
        return None
    return 100.0 * sum(r["host_issue_s"] for r in run.steps) / wall
