"""The serving engine's iteration on the step ledger and on the
profiler's clock.

The engine marks its loop's phases with ``serving`` spans
(``serving.iteration``, ``serving.prefill``, ``serving.decode.build`` /
``issue`` / ``wait`` / ``sample`` / ``finish``, ``serving.idle``); the
step ledger classifies them into a decode step's ``build_s``,
``device_wait_s`` and ``host_issue_s`` and the time between two steps
(``between_s``, ``between_prefill_s``, ``between_idle_s``,
``n_between_prefills``); each span is also a ``torch.profiler`` range
while a profiler records, placed on the profiler's timeline by the
ring's anchor.  Also here: ``spans_since`` on a full, wrapped ring, and
the benchmark's four readers of these records against hand-worked
values.
"""

import collections
import threading
import time
import types

import pytest
import torch

from dmlc_tpu_torch import telemetry
from dmlc_tpu_torch.models import transformer as tfm
from dmlc_tpu_torch.serving import InferenceEngine
from dmlc_tpu_torch.telemetry import core
from portbench import harness

CFG = tfm.TransformerConfig(vocab=64, d_model=32, n_heads=2, head_dim=8,
                            d_ff=48, n_layers=2, n_experts=1)
PHASES = ("serving.iteration", "serving.prefill", "serving.decode.build",
          "serving.decode.issue", "serving.decode.wait",
          "serving.decode.sample", "serving.decode.finish")


@pytest.fixture(autouse=True)
def clean():
    telemetry.reset()
    telemetry.reset_steps()
    yield
    telemetry.reset()
    telemetry.reset_steps()


@pytest.fixture(scope="module")
def model():
    return tfm.init_params(CFG, torch.Generator().manual_seed(0),
                           device="cpu")


def _engine(model):
    return InferenceEngine(model, device="cpu", n_blocks=64, block_size=4,
                           max_active=8)


def _prompt(i):
    return [1 + (7 * i + j) % 60 for j in range(5 + 3 * i)]


def _spans(name):
    return [r for r in core.spans() if r["name"] == name]


# -- the step ledger ------------------------------------------------------

def test_decode_steps_split_into_phases_and_count_the_prefills(model):
    """A step after k admissions counts k prefills, and their seconds are
    the ``serving.prefill`` spans'; a step's phases nest inside its
    wall, and the time between steps inside ``between_s``."""
    eng = _engine(model)
    eng.submit(_prompt(0), max_new_tokens=6)
    assert eng.step()
    first = telemetry.ledger().records()[-1]
    assert first["between_s"] is None and first["n_between_prefills"] is None
    cursor = core.span_seq()
    for i in range(1, 4):
        eng.submit(_prompt(i), max_new_tokens=6)
    assert eng.step()
    rec = telemetry.ledger().records()[-1]
    # the engine's own (the request ledger draws a serving.prefill row
    # per request too, on a row of its own)
    prefills = [r for r in core.spans_since(cursor)[0]
                if r["name"] == "serving.prefill"
                and r["tid"] == threading.get_ident()]
    assert rec["n_between_prefills"] == len(prefills) == 3
    assert rec["between_prefill_s"] == pytest.approx(
        sum(r["dur"] for r in prefills) / 1e6, rel=1e-9)
    assert rec["between_idle_s"] == 0.0
    for _ in range(3):
        assert eng.step()
        rec = telemetry.ledger().records()[-1]
        assert rec["n_between_prefills"] == 0
    for rec in telemetry.ledger().records():
        assert 0 < rec["build_s"] <= rec["host_issue_s"]
        assert 0 < rec["device_wait_s"]
        assert rec["host_issue_s"] + rec["device_wait_s"] <= rec["wall_s"]
        if rec["between_s"] is not None:
            assert rec["between_prefill_s"] <= rec["between_s"]
    eng.close()


def test_slow_sampling_is_not_host_issue(model, monkeypatch):
    """Work after the step's wait on the card (here the cache advance of
    the sampling phase, slowed by 20 ms) is in the wall, not in the
    host's issue."""
    eng = _engine(model)
    inner = eng.cache.advance_many

    def slow(*a, **kw):
        time.sleep(0.02)
        return inner(*a, **kw)

    monkeypatch.setattr(eng.cache, "advance_many", slow)
    eng.submit(_prompt(2), max_new_tokens=4)
    assert eng.step()
    rec = telemetry.ledger().records()[-1]
    assert rec["wall_s"] - rec["host_issue_s"] >= 0.02
    sample = _spans("serving.decode.sample")
    assert len(sample) == 1 and sample[0]["dur"] >= 2e4
    eng.close()


def test_idle_between_steps_on_the_loop(model):
    """The loop's sleeps when nothing runs are one ``serving.idle`` span a
    stretch, billed to the next step's ``between_idle_s``."""
    eng = _engine(model)
    eng.start()
    try:
        assert len(eng.generate(_prompt(1), 3, timeout=60)) == 3
        time.sleep(0.1)
        n = len(telemetry.ledger().records())
        assert len(eng.generate(_prompt(2), 3, timeout=60)) == 3
    finally:
        eng.close()
    rec = telemetry.ledger().records()[n]
    assert rec["n_between_prefills"] == 1
    assert rec["between_idle_s"] >= 0.05
    assert (rec["between_idle_s"] + rec["between_prefill_s"]
            <= rec["between_s"])
    idle = _spans("serving.idle")
    # one span per idle stretch, not one per 2 ms sleep
    assert 1 <= len(idle) <= 3 and max(r["dur"] for r in idle) >= 5e4


# -- the profiler's clock -------------------------------------------------

def test_engine_spans_are_profiler_ranges_on_the_same_clock(model):
    """Under a CPU ``torch.profiler`` each engine span has a range of its
    name, starting where the ring's span starts, converted by the
    anchor of the ring's Chrome export, to within 1 ms."""
    from torch.profiler import ProfilerActivity, profile

    eng = _engine(model)
    eng.submit(_prompt(0), max_new_tokens=3)
    eng.submit(_prompt(1), max_new_tokens=3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        while any(eng.scheduler.counts()):
            eng.step()
    eng.close()
    doc = telemetry.to_chrome_trace()
    anchor = [e for e in doc["traceEvents"] if e["name"] == "clock_anchor"]
    assert len(anchor) == 1
    epoch_ns = anchor[0]["args"]["epoch_ns"]
    assert epoch_ns == core.anchor_epoch_ns()
    ranges = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name() in PHASES:
            ranges[e.name()].append(e.start_ns())
    ring = [e for e in doc["traceEvents"] if e["ph"] == "X"
            and e["name"] in PHASES and e["tid"] == threading.get_ident()]
    assert {e["name"] for e in ring} == set(PHASES)
    for e in ring:
        at = epoch_ns + e["ts"] * 1e3
        starts = ranges[e["name"]]
        assert starts and min(abs(s - at) for s in starts) < 1e6, e
    for name in PHASES:
        assert len(ranges[name]) == sum(e["name"] == name for e in ring)


def test_no_profiler_no_range(monkeypatch):
    """Without a recording profiler a profiled span never reaches
    ``record_function``."""
    import torch.autograd.profiler as tprof

    def refuse(name):
        raise AssertionError("record_function without a profiler")

    monkeypatch.setattr(tprof, "record_function", refuse)
    assert not core.profiling()
    with core.span("serving.decode.wait", stage="serving", profile=True):
        pass
    assert _spans("serving.decode.wait")


# -- the span ring --------------------------------------------------------

def test_spans_since_on_a_full_wrapped_ring(monkeypatch):
    """The walk from the ring's newest end gives what a scan of the whole
    ring gives: the spans after the cursor, the high-water mark past an
    evicted gap, and the oldest ``limit`` with the last one's seq."""
    monkeypatch.setattr(core, "_spans", collections.deque(maxlen=16))
    base = core.span_seq()
    for i in range(40):
        core.record_span(f"s{i}", t0=float(i), t1=float(i) + 0.5)
    ring = core.spans()
    assert len(ring) == 16 and ring[0]["seq"] == base + 25

    def scan(after):
        return [r for r in ring if r["seq"] > after]

    for after in (0, base, base + 10, base + 25, base + 30, base + 39,
                  base + 40):
        got, last = core.spans_since(after)
        assert got == scan(after) and last == base + 40, after
    got, last = core.spans_since(base + 10, limit=5)
    assert got == ring[:5] and last == ring[4]["seq"]
    got, last = core.spans_since(base + 36, limit=5)
    assert got == scan(base + 36) and last == base + 40


# -- the benchmark's readers ----------------------------------------------

def _rec(wall, issue, wait, build, tokens, between=None, prefill=None,
         idle=None):
    return {"wall_s": wall, "host_issue_s": issue, "device_wait_s": wait,
            "build_s": build, "tokens": tokens, "between_s": between,
            "between_prefill_s": prefill, "between_idle_s": idle}


STEPS = [_rec(0.04, 0.03, 0.01, 0.001, 3.0),
         _rec(0.05, 0.04, 0.008, 0.002, 1.0, 0.03, 0.02, 0.004),
         _rec(0.06, 0.05, 0.009, 0.003, 30.0, 0.01, 0.0, 0.0)]


@pytest.mark.parametrize("name,want", [
    # (0.03 + 0.04 + 0.05) / (0.04 + 0.05 + 0.06)
    ("host_issue_frac.serve", 80.0),
    # 0.02 / (0.03 + 0.05 + 0.01 + 0.06): the first step has no between
    ("prefill_frac.serve", 100 * 0.02 / 0.15),
    # (0.002 + 0.002 + 0.006) + (0.003 + 0.001 + 0.01) over 0.15
    ("loop_overhead_frac.serve", 100 * 0.024 / 0.15),
    # one token at 80 ms, thirty at 70 ms: the 30th of 31 is 70 ms
    ("token_gap_p95_ms.serve", 70.0)])
def test_readers_by_hand(name, want):
    read = harness.load_module("metrics", name).read
    assert read(types.SimpleNamespace(steps=STEPS)) == pytest.approx(
        want, rel=1e-9)
    # records without the phase fields (a program that does not mark
    # them) give nothing, and no window gives nothing
    old = [{k: r[k] for k in ("wall_s", "host_issue_s", "tokens")}
           for r in STEPS]
    assert read(types.SimpleNamespace(steps=old)) is None
    assert read(types.SimpleNamespace(steps=[])) is None
