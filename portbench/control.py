"""The readings the correctness limits are set from, on the card at a
cell's own size (not part of a benchmark run).

    python3 portbench/control.py --workload <cell> --seeds a,b,c \\
        [--program-seeds d,e,...] [--seconds s]

For each ``--program-seeds`` seed: the numbers a sound run of the
program gives (the lower readings).  For each ``--seeds`` seed: the
control's numbers, the reference run in float8 in the program's place
(the upper readings), and each fault the cell can have.  A training
cell's faults: half of each batch left out, the mean taken over the
rest (planted in the reference); a step that leaves its state unchanged
reads 1 on ``change_gap`` and needs no run.  A serving cell's fault: one
served token of each sampled request altered to another; its numbers
come from the same reference pass.

Serving readings run the cell's traffic for a shortened window (pre-roll
and window ``--seconds`` each, every request due in it followed to its
end) in one process: the engine is built once and each seed's weights
are copied into its model.  One JSON line per seed and reading, then a
summary line: the largest program reading and the smallest control and
fault readings of each number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from portbench import check, harness, port, traffic, yardstick  # noqa: E402
from portbench import weights as wts  # noqa: E402
from portbench.reference import model as ref  # noqa: E402


def emit(doc: dict) -> None:
    print(json.dumps(doc), flush=True)


def train_readings(cell: dict, cfg: dict, mix: dict, drv, program_seeds,
                   seeds, device) -> dict:
    import tempfile

    out = {"program": [], "control": [], "half_batch": []}
    for seed in sorted(set(program_seeds) | set(seeds)):
        tokens = traffic.train_tokens(mix, yardstick.widths(cfg)["V"], seed)
        f32 = drv.reference(cfg, mix, seed, device, tokens)
        if seed in program_seeds:
            with tempfile.TemporaryDirectory() as tmp:
                prog = drv.Program(cfg, mix, seed, device, tmp)
                readings = prog.first_steps()
                prog.close()
                del prog
                drv.free_device()
            gaps = check.train_gaps(readings, f32)
            out["program"].append(gaps)
            emit({"seed": seed, "reading": "program", **gaps})
        if seed in seeds:
            for name, kw in (("control", {"prec": "fp8"}),
                             ("half_batch", {"half_batch": True})):
                gaps = check.train_gaps(
                    drv.reference(cfg, mix, seed, device, tokens, **kw), f32)
                out[name].append(gaps)
                emit({"seed": seed, "reading": name, **gaps})
    return out


def serve_readings(cell: dict, cfg: dict, mix: dict, drv, program_seeds,
                   seeds, device, seconds: float) -> dict:
    vocab = yardstick.widths(cfg)["V"]
    mix = dict(mix, preroll_s=seconds)
    rate = float(cell["rate_per_s"])
    seed0 = sorted(set(program_seeds) | set(seeds))[0]
    prog = drv.Program(cfg, mix, seed0, device)
    out = {"program": [], "control": [], "altered_token": []}
    try:
        prog.warm(mix, vocab)
        for seed in sorted(set(program_seeds) | set(seeds)):
            _load(prog.model, cfg, seed, device)
            arrivals = traffic.serve_schedule(mix, rate, seconds, seed)
            prompts = traffic.prompt_ids(arrivals, vocab, seed)
            load = drv.Load(prog.engine, arrivals, prompts,
                            time.monotonic() + seconds)
            load.wait_window(time.monotonic() + 2 * seconds
                             + float(mix["drain_s"]))
            load.stop()
            done = load.outcomes(seconds + float(mix["drain_s"]))
            while any(prog.engine.scheduler.counts()):
                time.sleep(0.05)        # the post-window requests finish
            sample = drv._sample([r for r in done if r["ok"]],
                                 int(mix["check_requests"]), seed)
            seqs, starts = drv.sequences(sample)
            precs = ("f32", "fp8") if seed in seeds else ("f32",)
            logits = ref.served_logits(cfg, seed, device, seqs, starts, precs)
            served = [r["generated"] for r in sample]
            base = {"seed": seed, "requests": len(done),
                    "failed": sum(not r["ok"] for r in done),
                    "tokens": sum(len(s) for s in served)}
            if seed in program_seeds:
                gap = float(check.token_gaps(logits["f32"], served).max())
                out["program"].append({"max_gap": gap})
                emit(dict(base, reading="program", max_gap=gap))
            if seed in seeds:
                firsts = [lg.argmax(-1).tolist() for lg in logits["fp8"]]
                gap = float(check.token_gaps(logits["f32"], firsts).max())
                out["control"].append({"max_gap": gap})
                emit(dict(base, reading="control", max_gap=gap))
                g = torch.Generator()
                g.manual_seed(seed & ((1 << 63) - 1))
                altered = []
                for toks in served:
                    toks = list(toks)
                    i = int(torch.randint(len(toks), (1,), generator=g))
                    toks[i] = (toks[i] + 1 + int(torch.randint(
                        vocab - 1, (1,), generator=g))) % vocab
                    altered.append(toks)
                gap = float(check.token_gaps(logits["f32"], altered).max())
                out["altered_token"].append({"max_gap": gap})
                emit(dict(base, reading="altered_token", max_gap=gap))
            del logits
            torch.cuda.empty_cache()
    finally:
        prog.close()
    return out


@torch.no_grad()
def _load(model, cfg: dict, seed: int, device) -> None:
    """Copy ``seed``'s weights into the program's model in place."""
    named = port.leaves(model, cfg)
    named["embed"].copy_(wts.embedding(cfg, seed, device))
    named["unembed"].copy_(wts.unembedding(cfg, seed, device))
    for li in range(yardstick.widths(cfg)["L"]):
        for k, t in wts.layer(cfg, seed, li, device).items():
            named[f"layers.{li}.{k}"].copy_(t)


def summary(out: dict) -> dict:
    doc = {}
    for reading, rows in out.items():
        for row in rows:
            for k, v in row.items():
                key = f"{reading}.{k}"
                agg = max if reading == "program" else min
                doc[key] = v if key not in doc else agg(doc[key], v)
    return doc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args()
    torch.set_num_threads(2)
    ints = lambda s: [int(x) for x in s.split(",") if x]
    seeds, program_seeds = ints(args.seeds), ints(args.program_seeds)
    cell = harness.load_json("workloads", args.workload)
    cfg = harness.load_json("configs", cell["config"])
    mix = harness.load_json("traffic", cell["traffic"])
    drv = harness.load_module("drivers", mix["driver"])
    device = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    if mix["driver"] == "train":
        out = train_readings(cell, cfg, mix, drv, program_seeds, seeds,
                             device)
    else:
        out = serve_readings(cell, cfg, mix, drv, program_seeds, seeds,
                             device, args.seconds)
    emit({"summary": summary(out)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
