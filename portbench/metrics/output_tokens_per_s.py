"""Tokens the engine generated inside the window over its seconds."""


def read(run):
    n = run.work.get("tokens_in_window")
    if n is None or not run.window_s:
        return None
    return n / run.window_s
