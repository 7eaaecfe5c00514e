"""Share of the serving loop's time that went to prefills: over the
window's decode steps, the ``serving.prefill`` spans between each step
and the one before it (the step ledger's ``between_prefill_s``) over
``between_s + wall_s``, in percent.  Nothing where the records carry no
``between_s``."""


def read(run):
    steps = [r for r in run.steps if r.get("between_s") is not None]
    total = sum(r["between_s"] + r["wall_s"] for r in steps)
    if not total:
        return None
    return 100.0 * sum(r["between_prefill_s"] for r in steps) / total
