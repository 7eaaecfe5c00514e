"""The port's self-heal guard and the self-healing loop of its LM trainer.

* The guard's cases of tests/test_selfheal.py, run against the port, and
  the port's and the JAX package's guards giving the same verdicts on
  one stream of losses and gradient norms (with injected faults).
* The heartbeat ships the guard's status doc.
* The port's trainer (``examples/train_lm_recordio.run``) on the CPU, at
  a tiny width: an oracle run of 30 steps with commits every 20; a
  faulted run (3 poisoned steps at step 21: 2 skips, a rollback to step
  20, a replay) whose losses equal the oracle's bit for bit; a drift run
  (a transient skip before the commit, then a rollback) that replays the
  snapshotted stream position and so equals a run with the transient
  skip alone; a rollback before the first commit to the genesis state;
  and an abort whose postmortem names the quarantined spans.  On the CPU
  every step is deterministic, so the trajectories are held bitwise.
"""

import json
import math
import os

import pytest
import torch

from dmlc_tpu.resilience import install_injector as jinstall
from dmlc_tpu.resilience import reset_injector as jreset
from dmlc_tpu.resilience import selfheal as jselfheal
from dmlc_tpu_torch import telemetry
from dmlc_tpu_torch.examples import train_lm_recordio as example
from dmlc_tpu_torch.io import integrity
from dmlc_tpu_torch.models.transformer import TransformerConfig, init_params
from dmlc_tpu_torch.resilience import install_injector, reset_injector
from dmlc_tpu_torch.resilience.selfheal import (ABORT, OK, ROLLBACK, SKIP,
                                                SelfHealAbort, SelfHealGuard,
                                                reset_selfheal, status)

NAN = float("nan")


@pytest.fixture(autouse=True)
def _clean():
    for fn in (reset_selfheal, reset_injector, jselfheal.reset_selfheal,
               jreset, integrity.reset_quarantine):
        fn()
    yield
    for fn in (reset_selfheal, reset_injector, jselfheal.reset_selfheal,
               jreset, integrity.reset_quarantine):
        fn()


# ---------------------------------------------------------------------------
# the guard (tests/test_selfheal.py's cases)
# ---------------------------------------------------------------------------

def test_healthy_steps_are_ok_and_update_ewma():
    g = SelfHealGuard(max_skips=2)
    for i in range(5):
        assert g.observe(1.0 - 0.1 * i, grad_norm=0.5, step=i) == OK
    assert g.finite_steps == 5
    assert g.ewma is not None and 0.5 < g.ewma < 1.0


def test_nonfinite_loss_escalation_ladder():
    g = SelfHealGuard(max_skips=2, max_rollbacks=1)
    g.observe(1.0, step=0)
    assert [g.observe(NAN, step=1) for _ in range(3)] == \
        [SKIP, SKIP, ROLLBACK]
    assert g.rollbacks == 1 and g.consecutive_bad == 0
    assert [g.observe(NAN, step=1) for _ in range(3)] == [SKIP, SKIP, ABORT]
    with pytest.raises(SelfHealAbort):
        g.raise_abort(1)


def test_recovery_resets_consecutive_count():
    g = SelfHealGuard(max_skips=2)
    g.observe(1.0, step=0)
    assert g.observe(NAN, step=1) == SKIP
    assert g.observe(1.0, step=1) == OK
    assert g.consecutive_bad == 0
    assert g.observe(NAN, step=2) == SKIP
    assert g.observe(NAN, step=2) == SKIP


def test_nonfinite_grad_norm_detected_before_loss():
    assert SelfHealGuard(max_skips=3).observe(
        0.7, grad_norm=float("inf"), step=1) == SKIP


def test_ewma_spike_gate_after_warmup():
    g = SelfHealGuard(max_skips=3, spike_factor=10.0, warmup=4)
    for i in range(6):
        assert g.observe(1.0, step=i) == OK
    assert g.observe(1.5, step=6) == OK
    assert g.observe(50.0, step=7) == SKIP
    assert g.ewma < 2.0


def test_spike_gate_disabled_below_factor_one():
    g = SelfHealGuard(max_skips=3, spike_factor=0.0, warmup=0)
    for i in range(5):
        g.observe(1.0, step=i)
    assert g.observe(1e9, step=9) == OK


def test_fault_spec_injection_hook_targets_exact_step():
    install_injector("selfheal.loss@step:7=corrupt::2")
    g = SelfHealGuard(max_skips=5)
    assert [g.observe(1.0, step=s) for s in (6, 7, 7, 7)] == \
        [OK, SKIP, SKIP, OK]
    assert math.isfinite(g.ewma)


def test_status_doc_ships_last_action():
    g = SelfHealGuard(max_skips=1, max_rollbacks=1)
    g.observe(1.0, step=3)
    g.observe(NAN, step=4)
    doc = status()
    assert doc["last_action"] == SKIP
    assert doc["step"] == 4 and doc["skips"] == 1
    g.observe(NAN, step=4)
    assert status()["last_action"] == ROLLBACK


def test_abort_writes_postmortem_naming_suspect_spans(tmp_path, monkeypatch):
    monkeypatch.setenv("DMLC_POSTMORTEM_DIR", str(tmp_path))
    integrity.record_quarantine("poison.rec", 128, 192)
    g = SelfHealGuard(max_skips=0, max_rollbacks=0)
    g.observe(1.0, step=0)
    assert g.observe(NAN, step=1) == ABORT
    dumps = [f for f in os.listdir(tmp_path) if f.startswith("postmortem")]
    assert dumps, "abort wrote no postmortem"
    doc = json.load(open(tmp_path / dumps[0]))
    assert "selfheal abort" in doc["reason"]
    assert "poison.rec[128:192]" in doc["reason"]


def test_selfheal_counters():
    before = telemetry.counters_snapshot().get("selfheal", {})
    g = SelfHealGuard(max_skips=1, max_rollbacks=1)
    g.observe(1.0, step=0)
    g.observe(NAN, step=1)
    g.observe(NAN, step=1)
    after = telemetry.counters_snapshot().get("selfheal", {})

    def delta(name):
        return after.get(name, 0) - before.get(name, 0)

    assert (delta("skips"), delta("rollbacks"), delta("nonfinite_steps")) \
        == (1, 1, 2)


def test_verdicts_equal_the_jax_guard(monkeypatch):
    """One stream of losses and norms (a spike, NaN losses, an inf norm,
    injected steps) through both guards under the same knobs: the same
    verdicts, counts and status fields."""
    for k, v in (("DMLC_SELFHEAL_MAX_SKIPS", "2"),
                 ("DMLC_SELFHEAL_MAX_ROLLBACKS", "2"),
                 ("DMLC_SELFHEAL_SPIKE_FACTOR", "4"),
                 ("DMLC_SELFHEAL_WARMUP", "3")):
        monkeypatch.setenv(k, v)
    spec = "selfheal.loss@step:9=corrupt::2"
    install_injector(spec)
    jinstall(spec)
    stream = [(2.0, 1.0, 1), (1.9, 1.1, 2), (1.8, 0.9, 3), (1.7, 1.0, 4),
              (30.0, 1.0, 5), (1.6, float("inf"), 5), (NAN, 1.0, 5),
              (1.6, 1.0, 5), (1.5, 1.0, 6), (1.5, 1.0, 9), (1.5, 1.0, 9),
              (1.4, 1.0, 9), (NAN, None, 10), (NAN, None, 10),
              (NAN, None, 10), (NAN, None, 10), (NAN, None, 10),
              (NAN, None, 10), (NAN, None, 10), (NAN, None, 10),
              (NAN, None, 10)]
    port, ref = SelfHealGuard(), jselfheal.SelfHealGuard()
    got = [port.observe(l, grad_norm=g, step=s) for l, g, s in stream]
    want = [ref.observe(l, grad_norm=g, step=s) for l, g, s in stream]
    assert got == want
    assert {SKIP, ROLLBACK, ABORT} <= set(got)
    for attr in ("ewma", "finite_steps", "consecutive_bad", "skips",
                 "rollbacks"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    ps, js = status(), jselfheal.status()
    ps.pop("t"), js.pop("t")
    assert ps == js


def test_heartbeat_ships_the_selfheal_status():
    class Client:
        rank = 0
        payloads = []

        def send_metrics(self, payload):
            self.payloads.append(json.loads(payload))

    hb = telemetry.HeartbeatSender(Client(), interval=60.0,
                                   auto_start=False, ship_trace=False)
    hb.send_once()
    assert "selfheal" not in Client.payloads[-1]
    g = SelfHealGuard(max_skips=1)
    g.observe(1.0, step=1)
    g.observe(NAN, step=2)
    hb.send_once()
    doc = Client.payloads[-1]["selfheal"]
    assert doc["last_action"] == SKIP and doc["step"] == 2
    assert doc["skips"] == 1 and doc["rollbacks"] == 0


# ---------------------------------------------------------------------------
# the trainer's self-healing loop, on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("selfheal") / "d.rec")
    example.make_data(path, n_records=256)
    return path


def _tiny():
    cfg = TransformerConfig(vocab=example.VOCAB, d_model=32, n_heads=2,
                            head_dim=16, d_ff=64, n_layers=2, n_experts=1,
                            remat=True)
    return init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _run(shard, tmp_path, tag, monkeypatch, spec=None, steps=30, ckpt=True):
    monkeypatch.setenv("DMLC_SELFHEAL_MAX_SKIPS", "2")
    reset_injector()
    reset_selfheal()
    integrity.reset_quarantine()
    if spec:
        install_injector(spec)
    try:
        return example.run(shard, steps,
                           str(tmp_path / tag) if ckpt else None,
                           device="cpu", model=_tiny())
    finally:
        reset_injector()


def _counts():
    c = telemetry.counters_snapshot().get("selfheal", {})
    return {k: c.get(k, 0) for k in ("skips", "rollbacks",
                                     "nonfinite_steps")}


def test_faulted_run_rolls_back_and_equals_the_oracle(shard, tmp_path,
                                                      monkeypatch, capsys):
    oracle = _run(shard, tmp_path, "oracle", monkeypatch)
    assert len(oracle) == 30 and oracle[-1] < oracle[0]
    telemetry.reset()
    healed = _run(shard, tmp_path, "faulted", monkeypatch,
                  "selfheal.loss@step:21=corrupt::3")
    out = capsys.readouterr().out
    assert "rolled back to committed step 20; replaying 20 batches" in out
    assert healed == oracle
    assert _counts() == {"skips": 2, "rollbacks": 1, "nonfinite_steps": 3}
    assert status()["last_action"] == ROLLBACK


def test_drift_run_replays_the_snapshotted_stream_position(
        shard, tmp_path, monkeypatch, capsys):
    """A transient skip at step 15 consumes a batch without a step, so
    the step-20 commit sits 21 batches into the stream; the rollback at
    step 25 must replay 21 batches, not 20.  The healed run then equals
    a run with the transient skip alone."""
    transient = "selfheal.loss@step:15=corrupt::1"
    want = _run(shard, tmp_path, "transient", monkeypatch, transient)
    capsys.readouterr()
    got = _run(shard, tmp_path, "drift", monkeypatch,
               transient + ";selfheal.loss@step:25=corrupt::3")
    out = capsys.readouterr().out
    assert "rolled back to committed step 20; replaying 21 batches" in out
    assert got == want


def test_rollback_before_the_first_commit_restores_the_genesis_state(
        shard, tmp_path, monkeypatch, capsys):
    oracle = _run(shard, tmp_path, "oracle", monkeypatch, steps=12)
    got = _run(shard, tmp_path, "genesis", monkeypatch,
               "selfheal.loss@step:6=corrupt::3", steps=12)
    assert "rolling back to the genesis state" in capsys.readouterr().out
    assert got == oracle


def test_abort_without_a_checkpoint_names_the_suspect_spans(
        shard, tmp_path, monkeypatch):
    """No checkpoint dir: the ladder is skip → abort.  The postmortem
    and the exception name the quarantined span."""
    monkeypatch.setenv("DMLC_POSTMORTEM_DIR", str(tmp_path / "pm"))
    integrity.record_quarantine("poison.rec", 128, 192)
    install_injector("selfheal.loss@step:4=corrupt::3")
    monkeypatch.setenv("DMLC_SELFHEAL_MAX_SKIPS", "2")
    with pytest.raises(SelfHealAbort, match="poison.rec"):
        example.run(shard, 10, None, device="cpu", model=_tiny())
    dumps = os.listdir(tmp_path / "pm")
    assert dumps
    doc = json.load(open(tmp_path / "pm" / dumps[0]))
    assert "selfheal abort at step 4" in doc["reason"]
    assert "poison.rec[128:192]" in doc["reason"]
