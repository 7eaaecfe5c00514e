"""The step ledger on a card: a step closes on an event recorded on its
own stream, so its wall is the step's (not the enqueue's) and work on
another stream is not billed to it.  Marked ``cuda``: skips without a
card.  The module imports no jax, so it runs where jax is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_telemetry_card.py
"""

import time

import pytest
import torch

from dmlc_tpu_torch import telemetry
from dmlc_tpu_torch.models import transformer as tfm

pytestmark = pytest.mark.cuda

CFG = tfm.TransformerConfig(vocab=512, d_model=128, n_heads=2, head_dim=64,
                            d_ff=256, n_layers=2, n_experts=1,
                            dtype="bfloat16")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ledger's events are CUDA events")
    telemetry.reset_steps()
    yield torch.device("cuda")
    telemetry.reset_steps()


def test_train_step_wall_agrees_with_a_synchronised_host_clock(card):
    """A ledgered step's ``wall_s`` against a host clock around the same
    step ended by ``torch.cuda.synchronize()``: the clock brackets the
    ledger's window, and the two differ by the call overheads only
    (within 1 ms + 5%)."""
    model = tfm.init_params(CFG, torch.Generator("cuda").manual_seed(0),
                            card)
    step = tfm.make_train_step(model)
    ids = torch.randint(0, CFG.vocab, (4, 256), device=card)
    labels = ids.roll(-1, 1)
    for _ in range(3):
        step(ids, labels)
    torch.cuda.synchronize()
    for _ in range(5):
        t0 = time.perf_counter()
        step(ids, labels)
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
        rec = telemetry.ledger().records()[-1]
        assert rec["wall_s"] <= host
        assert host - rec["wall_s"] <= 1e-3 + 0.05 * host
        assert 0 < rec["host_issue_s"] <= rec["wall_s"]
        assert 0 < rec["event_span_s"]
        assert rec["tokens"] == ids.numel() and rec["mfu"] is not None


def test_step_waits_on_its_own_event_not_the_device(card):
    """A long kernel on another stream (as the feed's placer runs its
    copies) is not billed to a step on the current stream."""
    side = torch.cuda.Stream()
    x = torch.randn(256, 256, device=card)
    x @ x                                    # cuBLAS set up before timing
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        torch.cuda._sleep(1_000_000_000)     # cycles: ~0.5 s at ~2 GHz
    t0 = time.perf_counter()
    telemetry.step_begin()
    y = x @ x
    rec = telemetry.step_end(tokens=1.0)
    t_step = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    assert bool(torch.isfinite(y).all())
    assert rec["wall_s"] <= t_step < t_all / 4, (rec["wall_s"], t_all)


def test_serving_decode_steps_close_on_the_card(card):
    """The engine's decode steps are ledger steps with their events."""
    from dmlc_tpu_torch.serving import InferenceEngine

    model = tfm.init_params(CFG, torch.Generator("cuda").manual_seed(1),
                            card)
    eng = InferenceEngine(model, device=card, n_blocks=64, block_size=16,
                          max_active=4)
    reqs = [eng.submit(list(range(1, 40 + 7 * i)), max_new_tokens=8)
            for i in range(3)]
    for _ in range(100):
        if all(r.state == "done" for r in reqs):
            break
        eng.step()
    eng.close()
    assert all(r.state == "done" and r.n_generated == 8 for r in reqs)
    recs = telemetry.ledger().records()
    assert recs and all(r["event_span_s"] is not None
                        and r["host_issue_s"] <= r["wall_s"] for r in recs)
    assert sum(r["tokens"] for r in recs) == 3 * 7


def test_decode_steps_time_their_wait_on_the_card(card):
    """A decode step's first wait on the card (its ``serving.decode.wait``
    span) is timed apart: ``host_issue_s`` ends where it starts, so the
    host's issue is shorter than the wall and the wait is not empty."""
    from dmlc_tpu_torch.serving import InferenceEngine

    model = tfm.init_params(CFG, torch.Generator("cuda").manual_seed(2),
                            card)
    eng = InferenceEngine(model, device=card, n_blocks=64, block_size=16,
                          max_active=4)
    reqs = [eng.submit(list(range(1, 30 + 5 * i)), max_new_tokens=6)
            for i in range(3)]
    for _ in range(100):
        if all(r.state == "done" for r in reqs):
            break
        eng.step()
    eng.close()
    recs = telemetry.ledger().records()
    assert len(recs) >= 5
    for r in recs:
        assert 0 < r["device_wait_s"] and r["host_issue_s"] < r["wall_s"]
        assert r["build_s"] <= r["host_issue_s"]
        assert r["host_issue_s"] + r["device_wait_s"] <= r["wall_s"]
