"""Training driver: the program's fed train step, as its example trainer
(``dmlc_tpu_torch/examples/train_lm_recordio.py``) drives it.

Set-up writes the seed's token rows to a RecordIO shard under
``TMPDIR``, builds the model from the seed's weights, AdamW
(``models.transformer.adamw``), ``make_train_step(..., ledger=False)``
and ``feed.recordio_feed`` over the shard, and opens each step of the
step ledger before the batch pull (so ``feed_wait_s`` is the feed's
wait).  Its first three steps are the compared ones: the loss of each,
the first gradient as AdamW holds it after step 1 (``exp_avg / (1 -
beta1)``), and the parameters' change after step 3.  More warm-up
steps follow; then the same step object and feed run for the window.
After the window the program is freed and the reference takes the same
three batches from the seed.
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time

import torch

from portbench import check, port, traffic, yardstick
from portbench import weights as wts
from portbench.reference import model as ref

COMPARED_STEPS = 3


class Program:
    """The program's train step, model, optimizer and feed for a run."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, workdir):
        from dmlc_tpu_torch import telemetry
        from dmlc_tpu_torch.feed import recordio_feed
        from dmlc_tpu_torch.models.transformer import adamw, make_train_step

        self.telemetry = telemetry
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        w = yardstick.widths(cfg)
        b, t = mix["batch"], mix["seq"]
        if mix["records"] % b:
            raise ValueError("records must fill whole batches")
        self.tokens = traffic.train_tokens(mix, w["V"], seed)
        shard = os.path.join(workdir, "tokens.rec")
        traffic.write_recordio(shard, self.tokens)
        telemetry.reset_steps()
        self.model = port.build_model(cfg, seed, device)
        self.optimizer = adamw(self.model.parameters(),
                               float(mix["optimizer"]["lr"]))
        self.step_fn = make_train_step(self.model, self.optimizer,
                                       ledger=False)
        self.feed = recordio_feed(shard, batch_records=b,
                                  max_bytes=(t + 1) * 4, device=device)
        self._it = iter(self.feed)
        self.tokens_per_step = b * t

    def step(self) -> torch.Tensor:
        """One fed step, the step ledger open from before the batch pull."""
        tel = self.telemetry
        tel.step_begin()
        batch = next(self._it, None)
        if batch is None:               # a new epoch of the shard
            self._it = iter(self.feed)
            batch = next(self._it)
        toks = batch["data"].view(torch.int32)
        loss = self.step_fn(toks[:, :-1], toks[:, 1:])
        tel.step_end(tokens=float(self.tokens_per_step))
        return loss

    def first_steps(self) -> dict:
        """The compared steps and what they are compared by."""
        beta1 = float(self.mix["optimizer"]["betas"][0])
        leaves = port.leaves(self.model, self.cfg)
        losses, grad_norms = [], None
        for i in range(COMPARED_STEPS):
            losses.append(self.step())
            if i == 0:
                grad_norms = {}
                for name, t in leaves.items():
                    p = t if t._base is None else t._base
                    # an optimizer that kept no state got no gradient
                    m = self.optimizer.state.get(p, {}).get("exp_avg")
                    grad_norms[name] = 0.0 if m is None else \
                        float(m.float().norm()) / (1 - beta1)
        change = {}
        with torch.no_grad():
            for name, t in leaves.items():
                start = self._start(name)
                change[name] = float((t.float() - start.float()).norm())
        return {"losses": [float(x) for x in losses],
                "grad_norms": grad_norms, "change_norms": change}

    def _start(self, name: str) -> torch.Tensor:
        cfg, seed, dev = self.cfg, self.seed, self.device
        if name == "embed":
            return wts.embedding(cfg, seed, dev)
        if name == "unembed":
            return wts.unembedding(cfg, seed, dev)
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith("ln"):
            return torch.ones(yardstick.widths(cfg)["E"], device=dev)
        return wts.layer(cfg, seed, int(name.split(".")[1]), dev)[leaf]

    def compile_passes(self) -> int:
        site = self.telemetry.compute.sites().get("train.step")
        return site.traces if site is not None else 0

    def close(self) -> None:
        self.feed.close()


def reference(cfg: dict, mix: dict, seed: int, device, tokens,
              prec: str = "f32", half_batch: bool = False) -> dict:
    batches = [traffic.train_batch(tokens, mix, s)
               for s in range(COMPARED_STEPS)]
    return ref.train_steps(cfg, seed, device, batches, mix["optimizer"],
                           prec=prec, rows_at_once=mix.get("ref_rows", 2),
                           half_batch=half_batch)


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(run) -> None:
    cfg, mix, dev = run.cfg, run.traffic, run.device
    workdir = tempfile.mkdtemp(prefix="portbench-")
    prog = None
    try:
        marks = [("start", time.perf_counter() - run.t_start)]
        prog = Program(cfg, mix, run.seed, dev, workdir)
        marks.append(("data, model, feed", time.perf_counter() - run.t_start))
        readings = prog.first_steps()
        marks.append(("compared steps", time.perf_counter() - run.t_start))
        for _ in range(mix["warmup_steps"] - COMPARED_STEPS):
            prog.step()
        tel = prog.telemetry
        tokens = prog.tokens
        passes0 = prog.compile_passes()
        seq0 = max([r["seq"] for r in tel.ledger().records()] or [0])
        n_trace = mix["trace_steps"] if run.trace else 0
        n_host = mix["host_trace_steps"] if run.trace else 0
        slices = []
        if run.trace:
            from portbench.trace import Trace
            slices = [(0, n_trace, Trace()),
                      (n_trace, n_trace + n_host, Trace(host=True))]
        losses = []
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        run.setup_s = t0 - run.t_start
        marks.append(("warm-up steps", run.setup_s))
        run.note("set-up: " + ", ".join(f"{k} {b - a:.2f} s" for (_, a), (k, b)
                                        in zip(marks, marks[1:]))
                 + f" (imports before: {marks[0][1]:.2f} s)")
        while True:
            for first, last, tracer in slices:
                if len(losses) == first:
                    tracer.start()
            losses.append(prog.step())
            for first, last, tracer in slices:
                if len(losses) == last:
                    tracer.stop()
            if (time.perf_counter() - t0 >= run.seconds
                    and len(losses) >= n_trace + n_host):
                break
        t1 = time.perf_counter()
        run.window_s = t1 - t0
        recs = [dict(r) for r in tel.ledger().records() if r["seq"] > seq0]
        run.steps = recs[n_trace + n_host:]
        run.work.update(steps=len(losses), trace_steps=n_trace,
                        tokens=len(losses) * prog.tokens_per_step)
        finite = torch.isfinite(torch.stack(losses)).tolist()
        run.attempted, run.failed = len(losses), finite.count(False)
        run.note(f"window: {len(losses)} steps in {run.window_s:.3f} s; "
                 f"cost passes in the window: "
                 f"{prog.compile_passes() - passes0}")
        if dev.type == "cuda":
            run.peak_bytes = torch.cuda.max_memory_allocated(dev)
        if slices:
            run.trace_summary = slices[0][2].summarize()
            run.work["gap_names"] = slices[1][2].summarize()["idle_gaps"]
        prog.close()
        prog = None
        del losses, slices
        free_device()
        ref_readings = reference(cfg, mix, run.seed, dev, tokens)
        gaps = check.train_gaps(readings, ref_readings)
        run.note("losses: program " + ", ".join(
            f"{x:.6f}" for x in readings["losses"]) + "; reference "
            + ", ".join(f"{x:.6f}" for x in ref_readings["losses"])
            + "; gaps " + ", ".join(f"{k} {v!r}" for k, v in gaps.items()))
        run.check("failed", run.failed, 0)
        for name, limit in run.cell_spec["limits"].items():
            run.check(name, gaps[name], limit)
    finally:
        if prog is not None:
            prog.close()
        shutil.rmtree(workdir, ignore_errors=True)
