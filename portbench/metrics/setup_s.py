"""Set-up seconds: process start to the window's start (imports, the
seed's weights and data, the program's build and warm-up, a serving
cell's pre-roll)."""


def read(run):
    return run.setup_s
