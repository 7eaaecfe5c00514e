"""Tokens of every train step completed in the window over the window's
seconds (host clock; the window closes on a step's end event)."""


def read(run):
    tokens = run.work.get("tokens")
    if not tokens or not run.window_s:
        return None
    return tokens / run.window_s
