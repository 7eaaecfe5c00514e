"""Mean share of the paged KV pool's blocks in use over the window
(``cache.stats()`` sampled every 0.1 s), in percent."""


def read(run):
    occ = run.work.get("occupancy")
    return 100.0 * sum(occ) / len(occ) if occ else None
