"""Share of the serving loop's time that the host spent on neither a
prefill, nor the forward's issue, nor a wait on the card, nor an idle
sleep: over the window's decode steps, the step ledger's ``build_s``,
plus ``wall_s - host_issue_s - device_wait_s`` (sampling and the rest
after the wait), plus ``between_s - between_prefill_s -
between_idle_s`` (completions, admission, the loop), over ``between_s +
wall_s``, in percent.  Nothing where the records carry no
``between_s`` or ``device_wait_s``."""


def read(run):
    steps = [r for r in run.steps if r.get("between_s") is not None
             and r.get("device_wait_s") is not None]
    total = sum(r["between_s"] + r["wall_s"] for r in steps)
    if not total:
        return None
    host = sum(r["build_s"]
               + (r["wall_s"] - r["host_issue_s"] - r["device_wait_s"])
               + (r["between_s"] - r["between_prefill_s"]
                  - r["between_idle_s"]) for r in steps)
    return 100.0 * host / total
