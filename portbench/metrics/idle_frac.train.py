"""Share of the traced window in which no operation ran on the card,
in percent (torch.profiler)."""

from portbench import readers


def read(run):
    return readers.idle_percent(run)
