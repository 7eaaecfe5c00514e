#!/usr/bin/env python3
"""Host-clock A/B of the port's serving and training steps between two
checkouts, on one CUDA card.

    python3 torch_walls_ab.py PARENT_ROOT CHANGE_ROOT [--pairs 12] [--reps 3]

Each root is a checkout holding ``dmlc_tpu_torch``.  One worker process
per root imports the port from it, builds its kernels, and sets up the
flagship model (random weights, seed 0) as ``chip_smoke.py``'s profile
phase does: a prefill at T=512, a decode step at B=8 (lengths 17..511,
paged pools of 16-token blocks) and a train step at B=8 x T=1024.  The
two workers then take turns on the card, in the order parent, change,
change, parent, ... for ``--pairs`` pairs; in each turn a worker runs
each step ``--reps`` times, and for every call records the host ms until
the call returns (``enqueue_ms``) and until the card has finished it
(``wall_ms``).  Only one worker runs at a time; the other waits on its
pipe.  Then, in turns likewise, each worker times its two serving
kernel wrappers alone: the host us per call of ``paged_attention`` (the
decode step's shape, one layer) and of ``flash_attention`` (the
prefill's shape), the card kept busy by a spin kernel so no call waits
on it, and the host us of one small launch with the card idle and busy.
``--change-first`` starts the change's worker first; the same root
given twice measures the noise of the comparison itself.

Prints the card's name and power limit (nvidia-smi), then one JSON line:
per step and side the median, min and max over all calls, and the
paired differences (change minus parent, by pair medians) with how many
pairs the change lost.  Details go to ``chiprun_out/walls_ab.json``
(``--out``).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

STEPS = ("prefill", "decode", "train")


# ---------------------------------------------------------------------------
# the worker: one checkout of the port
# ---------------------------------------------------------------------------

def _setup(root):
    sys.path.insert(0, os.path.abspath(root))
    from dmlc_tpu_torch.models import transformer as tfm
    from dmlc_tpu_torch.ops import _build
    from dmlc_tpu_torch.ops import flash_attention as fa
    from dmlc_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    cfg = tfm.flagship_config()
    gen = torch.Generator("cuda").manual_seed(3)
    t, b, w, bs = 512, 8, 40, 16
    ids = torch.randint(0, cfg.vocab, (1, t), generator=gen, device="cuda")
    dids = torch.randint(0, cfg.vocab, (b, 1), generator=gen, device="cuda")
    lengths = torch.tensor([17, 64, 100, 200, 255, 300, 400, 511],
                           dtype=torch.int32, device="cuda")
    tables = torch.arange(b * w, device="cuda",
                          dtype=torch.int32).reshape(b, w)
    model = tfm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            "cuda")

    def prefill():
        with torch.inference_mode():
            return tfm.forward_prefill_last(
                model, ids, torch.tensor([t - 1], device="cuda"))

    _, k, v = prefill()
    # every decode row holds the prefilled context
    shape = (cfg.n_layers, b * w, bs, cfg.n_heads, cfg.head_dim)
    kp = torch.zeros(shape, dtype=k.dtype, device="cuda")
    vp = torch.zeros_like(kp)
    n = k.shape[2] // bs
    for i in range(b):
        kp[:, i * w:i * w + n] = k[:, 0].reshape(shape[0], n, *shape[2:])
        vp[:, i * w:i * w + n] = v[:, 0].reshape(shape[0], n, *shape[2:])
    del k, v
    positions = lengths.long()[:, None]

    def decode():
        with torch.inference_mode():
            return tfm.forward_decode_paged(model, dids, positions, kp, vp,
                                            tables, lengths)

    train_model = tfm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                  "cuda")
    step = tfm.make_train_step(train_model,
                               tfm.adamw(train_model.parameters(), 1e-4))
    tgen = torch.Generator("cuda").manual_seed(1)
    tids = torch.randint(0, cfg.vocab, (8, 1024), generator=tgen,
                         device="cuda")
    labels = tids.roll(-1, 1)

    # the two serving wrappers alone, at the shapes the steps give them
    wq = torch.randn((b, 1, cfg.n_heads, cfg.head_dim), generator=gen,
                     device="cuda").to(kp.dtype)
    fq, fk, fv = (torch.randn((1, t, cfg.n_heads, cfg.head_dim),
                              generator=gen, device="cuda").to(kp.dtype)
                  for _ in range(3))

    def paged():
        return pa.paged_attention(wq, kp[0], vp[0], tables, lengths)

    def flash():
        with torch.inference_mode():
            return fa.flash_attention(fq, fk, fv, causal=True)

    steps = {"prefill": prefill, "decode": decode,
             "train": lambda: step(tids, labels)}
    wrappers = {"paged_attention": (paged, pa.PAGED_ATTENTION),
                "flash_attention": (flash, fa.FLASH_FWD)}
    for fn in steps.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    return steps, wrappers


def _time_steps(steps, reps):
    out = {}
    for name, fn in steps.items():
        rows = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            rows.append({"enqueue_ms": (t1 - t0) * 1e3,
                         "wall_ms": (t2 - t0) * 1e3})
        out[name] = rows
    return out


def _time_wrappers(wrappers, calls, batches):
    out = {}
    # host us of one small launch (an in-place add) with the card idle
    # between launches, and with it busy (the launches queue behind a
    # spin kernel)
    x = torch.zeros(1024, device="cuda")
    for mode in ("idle", "busy"):
        per_call = []
        for _ in range(batches):
            torch.cuda.synchronize()
            if mode == "busy":
                torch.cuda._sleep(35_000_000)
            t0 = time.perf_counter()
            for _ in range(calls):
                x.add_(1.0)
            per_call.append((time.perf_counter() - t0) / calls * 1e6)
        out[f"small_launch_{mode}"] = per_call
    torch.cuda.synchronize()
    for name, (fn, kern) in wrappers.items():
        fn()
        torch.cuda.synchronize()
        before = kern.launches
        per_call = []
        for _ in range(batches):
            torch.cuda._sleep(35_000_000)   # ~20 ms: no call waits on the card
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            per_call.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        check = kern.launches - before
        if check != calls * batches:
            raise RuntimeError(f"{name}: {check} launches, want "
                               f"{calls * batches}")
        out[name] = per_call
    return out


def worker(root):
    steps, wrappers = _setup(root)
    print(json.dumps({"ready": True}), flush=True)
    for line in sys.stdin:
        cmd = json.loads(line)
        if cmd["cmd"] == "steps":
            doc = _time_steps(steps, cmd["reps"])
        elif cmd["cmd"] == "wrappers":
            doc = _time_wrappers(wrappers, cmd["calls"], cmd["batches"])
        else:
            return 0
        print(json.dumps(doc), flush=True)
    return 0


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

class _Worker:
    def __init__(self, root):
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", root],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def read(self):
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"worker exited with {self.proc.wait()}")
        return json.loads(line)

    def ask(self, **cmd):
        self.proc.stdin.write(json.dumps(cmd) + "\n")
        self.proc.stdin.flush()
        return self.read()

    def stop(self):
        if self.proc.poll() is None:
            try:
                self.proc.stdin.write(json.dumps({"cmd": "quit"}) + "\n")
                self.proc.stdin.close()
                self.proc.wait(timeout=60)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()


def _stats(xs):
    xs = sorted(xs)
    return {"median": statistics.median(xs), "min": xs[0], "max": xs[-1],
            "n": len(xs)}


def summarise(turns, wrapper_turns):
    doc = {}
    for name in STEPS:
        for key in ("wall_ms", "enqueue_ms"):
            med = {side: [statistics.median(r[key] for r in t[name])
                          for t in turns[side]] for side in turns}
            diffs = [c - p for p, c in zip(med["parent"], med["change"])]
            doc[f"{name}_{key}"] = {
                **{side: _stats([r[key] for t in turns[side]
                                 for r in t[name]]) for side in turns},
                "pair_diff_median": statistics.median(diffs),
                "pair_diffs": diffs,
                "pairs_change_slower": sum(d > 0 for d in diffs),
                "pairs": len(diffs)}
    for name in ("paged_attention", "flash_attention", "small_launch_idle",
                 "small_launch_busy"):
        doc[f"{name}_host_us"] = {
            side: _stats([x for t in wrapper_turns[side] for x in t[name]])
            for side in wrapper_turns}
    return doc


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", help="PARENT_ROOT CHANGE_ROOT")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="walls_ab.json",
                    help="file under chiprun_out/ for the details")
    ap.add_argument("--change-first", action="store_true",
                    help="start the change's worker before the parent's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_walls_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.worker:
        return worker(args.worker)
    if len(args.roots) != 2:
        ap.error("give PARENT_ROOT and CHANGE_ROOT")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    workers = {}
    try:
        sides = list(zip(("parent", "change"), args.roots))
        for side, root in sides[::-1] if args.change_first else sides:
            workers[side] = _Worker(root)
        for w in workers.values():
            w.read()                                   # ready
        turns = {"parent": [], "change": []}
        wrapper_turns = {"parent": [], "change": []}
        for i in range(args.pairs):
            order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
            for side in order:
                turns[side].append(workers[side].ask(cmd="steps",
                                                     reps=args.reps))
        for i in range(6):
            order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
            for side in order:
                wrapper_turns[side].append(workers[side].ask(
                    cmd="wrappers", calls=100, batches=3))
    finally:
        for w in workers.values():
            w.stop()
    summary = summarise(turns, wrapper_turns)
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, args.out), "w") as f:
        json.dump({"nvidia_smi": smi, "roots": args.roots,
                   "change_first": args.change_first,
                   "pairs": args.pairs, "reps": args.reps,
                   "summary": summary, "turns": turns,
                   "wrapper_turns": wrapper_turns}, f, indent=1)
    print(json.dumps({"nvidia_smi": smi, "roots": args.roots,
                      "change_first": args.change_first,
                      "pairs": args.pairs, "reps": args.reps, **summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
