"""Find a serving cell's knee: the highest arrival rate its engine
sustains, on the card, in one process (not part of a benchmark run).

    python3 portbench/sweep.py --workload <cell> --rates 4,5,6,7 \\
        [--seed n] [--seconds s]

The model and engine are built once.  Each rate runs the cell's
traffic (a pre-roll and a window of ``--seconds`` each, every request
due in the window followed to its end, the engine emptied before the
next rate) and prints one JSON line: requests due and failed, tokens
per second in the window, the first and second half's median time to
first token, the 95th percentiles, and the requests in the system
(waiting and active) when the window opened and closed.  A rate is
sustained where nothing failed and the backlog did not grow: the
requests in the system at the close are at most a tenth of the
window's arrivals above those at the open, and the second half's
median time to first token is under 1.5 times the first half's.  The
knee is the highest rate of the ladder below its first rate that is
not sustained.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from portbench import harness, traffic, yardstick  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args()
    torch.set_num_threads(2)
    cell = harness.load_json("workloads", args.workload)
    cfg = harness.load_json("configs", cell["config"])
    mix = dict(harness.load_json("traffic", cell["traffic"]),
               preroll_s=args.seconds)
    drv = harness.load_module("drivers", mix["driver"])
    device = torch.device("cuda", 0)
    vocab = yardstick.widths(cfg)["V"]
    prog = drv.Program(cfg, mix, args.seed, device)
    best, climbing = None, True
    try:
        prog.warm(mix, vocab)
        for rate in [float(r) for r in args.rates.split(",")]:
            arrivals = traffic.serve_schedule(mix, rate, args.seconds,
                                              args.seed)
            prompts = traffic.prompt_ids(arrivals, vocab, args.seed)
            t0 = time.monotonic() + args.seconds
            load = drv.Load(prog.engine, arrivals, prompts, t0)
            time.sleep(max(0.0, t0 - time.monotonic()))
            open_n, tok0 = sum(prog.engine.scheduler.counts()), \
                prog.tokens_generated()
            time.sleep(max(0.0, t0 + args.seconds - time.monotonic()))
            close_n, tok1 = sum(prog.engine.scheduler.counts()), \
                prog.tokens_generated()
            load.wait_window(t0 + args.seconds + float(mix["drain_s"]))
            load.stop()
            window = load.window
            res = load.outcomes(args.seconds + float(mix["drain_s"]))
            half = [a.due_s < args.seconds / 2 for a in window]
            first = [r["ttft_s"] for r, h in zip(res, half) if h]
            second = [r["ttft_s"] for r, h in zip(res, half) if not h]
            p50a = yardstick.nearest_rank(first, 0.5)
            p50b = yardstick.nearest_rank(second, 0.5)
            failed = sum(not r["ok"] for r in res)
            ok = (failed == 0 and close_n - open_n <= 0.1 * len(window)
                  and p50b < 1.5 * p50a)
            print(json.dumps({
                "rate_per_s": rate, "requests": len(window), "failed": failed,
                "tokens_per_s": (tok1 - tok0) / args.seconds,
                "ttft_p50_first_half_s": p50a,
                "ttft_p50_second_half_s": p50b,
                "ttft_p95_s": yardstick.nearest_rank(
                    [r["ttft_s"] for r in res], 0.95),
                "tpot_p95_ms": yardstick.nearest_rank(
                    [r["tpot_ms"] for r in res], 0.95),
                "in_system_open": open_n, "in_system_close": close_n,
                "sustained": ok}), flush=True)
            climbing = climbing and ok
            if climbing:
                best = rate
            while any(prog.engine.scheduler.counts()):
                time.sleep(0.05)
    finally:
        prog.close()
    print(json.dumps({"knee_rate_per_s": best,
                      "cell_rate_per_s": None if best is None
                      else round(0.8 * best, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
