"""Share of the window's steps' wall that the step waited on the device
feed (the step ledger's ``feed_wait_s``, the feed's ``feed.wait``
span), in percent."""


def read(run):
    wall = sum(r["wall_s"] for r in run.steps)
    if not wall:
        return None
    return 100.0 * sum(r["feed_wait_s"] for r in run.steps) / wall
