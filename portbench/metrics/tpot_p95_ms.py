"""95th percentile, over the window's judged requests (in a mix that
follows the window, every request due in it), of (last token less first
token) / (tokens - 1), in milliseconds; a failed request counts as the
run's longest wait."""

from portbench import readers, yardstick


def read(run):
    return yardstick.nearest_rank(
        [r["tpot_ms"] for r in readers.served(run)
         if r.get("segment", "window") == "window"], 0.95)
