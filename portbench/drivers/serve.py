"""Serving driver: the program's ``InferenceEngine`` under an open loop.

Set-up builds the model from the seed's weights and the engine with the
configuration's settings (paged KV pool, ``max_active``), starts the
engine's own loop thread, and warms it with the mix's longest and
shortest prompts.  One scheduling thread then submits every arrival of
the seed's schedule (``portbench.traffic``) at its due time, in
process: a pre-roll, the window, and arrivals after it that keep the
load on.  The window opens when the pre-roll ends.

After the close the run follows every request of the mix's ``follow``
segments to its end (or until ``drain_s`` has passed): ``["window"]``,
the default, for a mix below the engine's capacity, whose requests due
in the window all end soon after it; ``["pre"]`` for a mix above it,
where the queue grows all through the run and the window's last
requests would take a minute more.  The run judges every request of
those segments and every request of the window that has ended by then:
one that was refused, failed, never ended, or served fewer tokens than
it asked for is ``failed``, and any failed request makes the run not
correct.

Each request due in the window is timed from its due time: its first
token (``submit_t + ttft_s``, the engine's own stamps) and its last
(``finish_t``).  After the window the engine and model are freed and
the reference runs a sample of the finished requests, drawn from the
seed with the longest among them: every served token's gap below the
reference's best logit at its position.

A traced run traces once the followed requests have ended, while the
arrivals after the window keep the load on: ``trace_s`` of device
activity for the per-layer metrics, then ``host_trace_s`` with host ops
to name the idle gaps.  Host-op tracing slows the engine's host loop,
and the device slice slows it too, so neither may overlap the window
the other metrics are read from.
"""

from __future__ import annotations

import gc
import os
import threading
import time

import torch

from portbench import check, port, traffic, yardstick
from portbench.reference import model as ref


class Recorder:
    """The device work each engine iteration hands to its programs:
    (monotonic time, "prefill", n) and (time, "decode", committed
    lengths).  Installed in traced runs only."""

    def __init__(self, engine):
        self.events = []
        inner = engine._exec

        def recorded(plan):
            op = plan["op"]
            if op == "prefill":
                self.events.append((time.monotonic(), "prefill",
                                    int(plan["n"])))
            elif op == "paged":
                self.events.append((time.monotonic(), "decode",
                                    plan["lengths"].tolist()))
            return inner(plan)

        engine._exec = recorded

    def between(self, t0: float, t1: float):
        return [(op, x) for t, op, x in self.events if t0 <= t < t1]


class Program:
    """The program's engine over the seed's model."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        for k, v in cfg.get("program", {}).get("env", {}).items():
            os.environ[k] = str(v)
        from dmlc_tpu_torch import telemetry
        from dmlc_tpu_torch.serving.engine import InferenceEngine

        self.telemetry = telemetry
        telemetry.reset_steps()
        eng = cfg["program"]["engine"]
        self.model = port.build_model(cfg, seed, device)
        self.engine = InferenceEngine(
            self.model, device=device, n_blocks=eng["n_blocks"],
            block_size=eng["block_size"], max_active=eng["max_active"],
            queue_depth=eng["queue_depth"],
            admit_timeout_s=eng["admit_timeout_s"],
            max_new_tokens=mix["output_tokens"]["hi"], spec_k=0)
        self.engine.start()

    def warm(self, mix: dict, vocab: int) -> None:
        for n in (mix["prompt_tokens"]["hi"], mix["prompt_tokens"]["lo"]):
            self.engine.generate([i % vocab for i in range(n)], 2,
                                 timeout=600)

    def tokens_generated(self) -> int:
        return int(self.engine.counters["tokens_generated"])

    def close(self) -> None:
        self.engine.close()


class Load:
    """One thread that submits each arrival at its due time (``t0`` +
    ``due_s``, monotonic clock) and keeps ``(due, the request or the
    exception submit raised)`` by arrival index."""

    def __init__(self, engine, arrivals, prompts, t0: float):
        self.out = {}
        self.arrivals = arrivals
        self.window = [a for a in arrivals if a.segment == "window"]
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._submit, name="portbench-arrivals", daemon=True,
            args=(engine, arrivals, prompts, t0))
        self._thread.start()

    def _submit(self, engine, arrivals, prompts, t0: float) -> None:
        for a in arrivals:
            due = t0 + a.due_s
            delay = due - time.monotonic()
            if (delay > 0 and self._stop.wait(delay)) or self._stop.is_set():
                return
            try:
                req = engine.submit(prompts[a.index], max_new_tokens=a.output)
            except Exception as e:  # noqa: BLE001 - a refused request fails
                req = e
            self.out[a.index] = (due, req)

    def wait_for(self, segments, deadline: float) -> None:
        """Until every request of ``segments`` has ended, or
        ``deadline``."""
        for a in self.arrivals:
            if a.segment not in segments:
                continue
            while a.index not in self.out and time.monotonic() < deadline:
                time.sleep(0.01)
            got = self.out.get(a.index)
            if got is not None and not isinstance(got[1], Exception):
                got[1].wait(max(0.0, deadline - time.monotonic()))

    def wait_window(self, deadline: float) -> None:
        self.wait_for(("window",), deadline)

    def judged(self, follow) -> list:
        """Every arrival of the ``follow`` segments, and those of the
        window that have ended."""
        return [a for a in self.arrivals if a.segment in follow
                or (a.segment == "window" and _ended(self.out.get(a.index)))]

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()

    def outcomes(self, cap_s: float, arrivals=None) -> list:
        return [outcome(a, self.out.get(a.index), cap_s)
                for a in (self.window if arrivals is None else arrivals)]


def _ended(got) -> bool:
    return got is not None and (isinstance(got[1], Exception)
                                or got[1].wait(0))


def outcome(a, got, cap_s: float) -> dict:
    """A window request's record: ok, ttft_s, tpot_ms and its tokens; a
    request that failed, was refused or never ended counts ``cap_s``."""
    req = None if got is None else got[1]
    ok = (req is not None and not isinstance(req, Exception)
          and req.error is None and req.finish_t is not None
          and req.ttft_s is not None and req.n_generated == a.output)
    if not ok:
        return {"ok": False, "ttft_s": cap_s, "tpot_ms": cap_s * 1e3,
                "id": getattr(req, "id", None), "index": a.index,
                "segment": a.segment}
    first = req.submit_t + req.ttft_s
    return {"ok": True, "ttft_s": first - got[0], "id": req.id,
            "segment": a.segment,
            "tpot_ms": (req.finish_t - first) / (req.n_generated - 1) * 1e3,
            "index": a.index, "prompt": list(req.prompt_ids),
            "generated": list(req.generated)}


def run(run) -> None:
    cfg, mix, dev = run.cfg, run.traffic, run.device
    vocab = yardstick.widths(cfg)["V"]
    rate = float(run.cell_spec["rate_per_s"])
    arrivals = traffic.serve_schedule(mix, rate, run.seconds, run.seed)
    prompts = traffic.prompt_ids(arrivals, vocab, run.seed)
    marks = [("start", time.perf_counter() - run.t_start)]
    prog = Program(cfg, mix, run.seed, dev)
    marks.append(("model, engine", time.perf_counter() - run.t_start))
    load = None
    try:
        prog.warm(mix, vocab)
        marks.append(("warm-up", time.perf_counter() - run.t_start))
        rec = Recorder(prog.engine) if run.trace else None
        tel = prog.telemetry
        t0 = time.monotonic() + float(mix["preroll_s"]) + 0.05
        load = Load(prog.engine, arrivals, prompts, t0)
        t1 = t0 + run.seconds
        time.sleep(max(0.0, t0 - time.monotonic()))
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        tok0, seq0 = prog.tokens_generated(), _last_seq(tel)
        held0 = prog.engine.scheduler.counts()
        run.setup_s = time.perf_counter() - run.t_start
        marks.append(("pre-roll", run.setup_s))
        run.note("set-up: " + ", ".join(f"{k} {b - a:.2f} s" for (_, a), (k, b)
                                        in zip(marks, marks[1:]))
                 + f" (imports before: {marks[0][1]:.2f} s)")
        occupancy = []
        while time.monotonic() < t1:
            occupancy.append(prog.engine.cache.stats()["occupancy"])
            time.sleep(min(0.05, max(0.0, t1 - time.monotonic())))
        tok1 = prog.tokens_generated()
        held1 = prog.engine.scheduler.counts()
        run.window_s = time.monotonic() - t0
        run.steps = [dict(r) for r in tel.ledger().records()
                     if r["seq"] > seq0]
        follow = tuple(mix.get("follow", ["window"]))
        load.wait_for(follow, t1 + float(mix["drain_s"]))
        stamps = []
        if run.trace:
            # after the followed requests have ended, while the arrivals
            # after the window keep the load on, so tracing slows none of
            # the window's timed work
            from portbench.trace import Trace
            slices = [(Trace(), float(mix["trace_s"])),
                      (Trace(host=True), float(mix["host_trace_s"]))]
            for tracer, secs in slices:
                stamps.append(time.monotonic())
                tracer.start()
                time.sleep(secs)
                tracer.stop()
            stamps.append(time.monotonic())
        load.stop()
        if dev.type == "cuda":
            run.peak_bytes = torch.cuda.max_memory_allocated(dev)
        judged = load.judged(follow)
        pending = len(load.window) - sum(a.segment == "window"
                                         for a in judged)
        results = load.outcomes(run.seconds + float(mix["drain_s"]), judged)
        queue = {r["id"]: r["queue_s"] for r in prog.engine.requests.records()}
        for r in results:
            r["queue_s"] = queue.get(r["id"])
        run.attempted = len(results)
        run.failed = sum(not r["ok"] for r in results)
        submitted = [load.out[a.index] for a in load.window
                     if a.index in load.out]
        late = sorted(max(0.0, req.submit_t - due) for due, req in submitted
                      if not isinstance(req, Exception))
        run.work.update(requests=results, occupancy=occupancy,
                        tokens_in_window=tok1 - tok0)
        if rec is not None:
            run.work["shapes"] = rec.between(t0, t1)
        if stamps:
            run.work["trace_shapes"] = rec.between(stamps[0], stamps[1])
            run.trace_summary = slices[0][0].summarize()
            run.work["gap_names"] = slices[1][0].summarize()["idle_gaps"]
        run.note(f"window: {len(load.window)} requests due, {pending} not "
                 f"ended when judged; {len(results)} judged, {run.failed} "
                 f"failed; {tok1 - tok0} tokens; submit lateness p95 "
                 f"{yardstick.nearest_rank(late, 0.95)} s; active, waiting "
                 f"at the open {held0}, at the close {held1}")
        prog.close()
        sample = _sample([r for r in results if r["ok"]],
                         int(mix["check_requests"]), run.seed)
        prog = load = None
        del results
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        gap = max_gap(cfg, run.seed, dev, sample)
        run.check("failed", run.failed, 0)
        run.check("max_gap", gap, run.cell_spec["limits"]["max_gap"])
        run.note(f"checked {len(sample)} requests, "
                 f"{sum(len(r['generated']) for r in sample)} served tokens")
    finally:
        if load is not None:
            load.stop()
        if prog is not None:
            prog.close()


def _last_seq(tel) -> int:
    return max([r["seq"] for r in tel.ledger().records()] or [0])


def _sample(ok: list, n: int, seed: int) -> list:
    """The longest finished request and ``n - 1`` others from the seed."""
    if not ok:
        return []
    longest = max(ok, key=lambda r: (len(r["generated"]), -r["index"]))
    rest = [r for r in ok if r is not longest]
    g = torch.Generator()
    g.manual_seed(int(seed) & ((1 << 63) - 1))
    pick = torch.randperm(len(rest), generator=g)[:max(0, n - 1)].tolist()
    return [longest] + [rest[i] for i in sorted(pick)]


def sequences(sample: list):
    """Reference inputs of each sampled request: its prompt and served
    tokens but the last, and where the served tokens start."""
    seqs = [r["prompt"] + r["generated"][:-1] for r in sample]
    return seqs, [len(r["prompt"]) for r in sample]


def max_gap(cfg: dict, seed: int, device, sample: list) -> float:
    if not sample:
        return float("inf")
    seqs, starts = sequences(sample)
    logits = ref.served_logits(cfg, seed, device, seqs, starts)["f32"]
    gaps = check.token_gaps(logits, [r["generated"] for r in sample])
    return float(gaps.max())
