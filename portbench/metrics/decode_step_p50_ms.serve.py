"""Median wall of the window's decode steps (the step ledger's
``wall_s``, each ending after the engine reads the step's tokens), in
milliseconds."""

from portbench import yardstick


def read(run):
    return None if not run.steps else 1e3 * yardstick.nearest_rank(
        [r["wall_s"] for r in run.steps], 0.5)
