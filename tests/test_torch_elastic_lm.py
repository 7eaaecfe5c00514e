"""The port's elastic LM trainer against the JAX example's, on the CPU:
``DeviceFeed.resize`` batch by batch against the JAX feed's, the feed's
autotune decisions against the JAX controller's, the repaired ledger
billing (the feed's wait inside the step), a 2-rank port gang against a
2-rank JAX gang from one committed checkpoint, a 3-rank port gang that
loses a worker, shrinks and grows back through ``POST /resize``, and an
elastic self-heal rollback.

The gangs are real processes against a real tracker on 127.0.0.1, each
worker on two (or one) CPU threads: several torch processes each
spinning eight OpenMP threads on one host slow each other down a
hundredfold."""

import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from dmlc_tpu.feed import recordio_feed as jrecordio_feed
from dmlc_tpu.parallel import build_mesh
from dmlc_tpu_torch import telemetry as ptel
from dmlc_tpu_torch.base import DMLCError
from dmlc_tpu_torch.examples import train_lm_recordio as example
from dmlc_tpu_torch.feed import DeviceFeed
from dmlc_tpu_torch.feed import recordio_feed as precordio_feed
from dmlc_tpu_torch.feed.autotune import FeedAutotuner as PAutotuner
from dmlc_tpu_torch.models.transformer import TransformerConfig, init_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = example.__name__.split(".")[0]
WAIT_S = 240   # bound on every wait for a gang


# ---------------------------------------------------------------------------
# DeviceFeed.resize against the JAX feed's
# ---------------------------------------------------------------------------

def _indexed_rec(tmp_path, n=60, body_bytes=24):
    """Record i's first 4 bytes encode i (the JAX feed tests' file)."""
    from dmlc_tpu_torch.io.recordio import RecordIOWriter
    from dmlc_tpu_torch.io.stream import Stream

    rng = np.random.default_rng(11)
    path = str(tmp_path / "el.rec")
    with Stream.create(path, "w") as s:
        w = RecordIOWriter(s)
        for i in range(n):
            w.write_record(np.int32(i).tobytes() + rng.integers(
                0, 256, body_bytes - 4, dtype=np.uint8).tobytes())
    return path


def _batches(feed, max_batches=None):
    """One full (or truncated) epoch as host (data, length) pairs."""
    out = []
    for k, b in enumerate(feed):
        out.append((np.asarray(b["data"]).copy(),
                    np.asarray(b["length"]).copy()))
        if max_batches is not None and k + 1 >= max_batches:
            feed.close()
            break
    return out


def _ids(batches):
    return [int(np.frombuffer(row[:4].tobytes(), np.int32)[0])
            for data, length in batches for row, ln in zip(data, length)
            if ln > 0]


def _feeds(path, world):
    mesh1 = build_mesh(1, dp=1, sp=1, tp=1, pp=1, ep=1)
    return (jrecordio_feed(path, mesh1, batch_records=4, max_bytes=32,
                           world=world),
            precordio_feed(path, batch_records=4, max_bytes=32,
                           device="cpu", world=world))


def _assert_same(got, want):
    assert len(got) == len(want)
    for (gd, gl), (wd, wl) in zip(got, want):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)


def test_feed_resize_shrink_mid_epoch_equals_jax(tmp_path):
    """Shrink 3 -> 2 mid-epoch on both packages: the first epoch after
    resize() is batch-for-batch the JAX feed's, covers every record
    exactly once, and the feed stays multi-epoch."""
    path = _indexed_rec(tmp_path)
    pairs = [_feeds(path, (r, 3)) for r in range(3)]
    for k in (0, 1):   # each package's feeds get the same treatment
        _batches(pairs[0][k], max_batches=2)
        _batches(pairs[1][k], max_batches=1)
        pairs[2][k].close()
        pairs[0][k].resize((0, 2))
        pairs[1][k].resize((1, 2))
    post = []
    for r in (0, 1):
        jf, pf = pairs[r]
        assert pf.world == jf.world == (r, 2)
        want, got = _batches(jf), _batches(pf)
        _assert_same(got, want)
        post += _ids(got)
        _assert_same(_batches(pf), want)   # multi-epoch after a resize
    assert sorted(post) == list(range(60))


def test_feed_resize_grow_and_determinism_equals_jax(tmp_path):
    path = _indexed_rec(tmp_path)
    jf, pf = _feeds(path, (0, 2))
    first = _batches(pf)
    _assert_same(first, _batches(jf))
    jf.resize((1, 3))
    pf.resize((1, 3))
    grown = _batches(pf)
    _assert_same(grown, _batches(jf))
    _assert_same(grown, _batches(_feeds(path, (1, 3))[1]))
    pf.resize((0, 2))
    _assert_same(_batches(pf), first)


def test_feed_resize_counts_and_records_the_event(tmp_path):
    ptel.reset()
    path = _indexed_rec(tmp_path)
    pf = _feeds(path, (0, 3))[1]
    pf.resize((1, 2))
    assert ptel.counters_snapshot()["feed"]["resizes"] == 1
    ev = [e for e in ptel.events_tail() if e["kind"] == "feed_resized"]
    assert ev[-1]["old_world"] == [0, 3] and ev[-1]["world"] == [1, 2]
    assert ev[-1]["local_parts"] == 1


def test_feed_resize_requires_a_source_builder():
    def factory():
        yield {"x": np.zeros(4, np.float32)}

    feed = DeviceFeed([factory], device="cpu")
    with pytest.raises(DMLCError, match="source_builder"):
        feed.resize((0, 1))
    feed.close()


# ---------------------------------------------------------------------------
# the feed's autotune against the JAX controller
# ---------------------------------------------------------------------------

def _traces():
    """The synthetic feed-wait traces of the JAX autotune tests: each a
    controller and a rule mapping its state to the next observation."""
    return [
        (dict(workers=1, depth=2, max_workers=6, max_depth=4), None, 30,
         lambda t: max(0.0, 0.6 - 0.12 * t.workers)),
        (dict(workers=4, depth=2, max_workers=6, max_depth=4), None, 20,
         lambda t: 0.0 if t.workers >= 4 else 0.5),
        (dict(workers=2, depth=2, max_workers=6, max_depth=4), 4, 24,
         lambda t: 0.0 if t.depth >= 3 else 0.5),
    ]


def test_autotuner_decisions_equal_jax():
    from dmlc_tpu.feed import FeedAutotuner as JAutotuner

    for kw, depth, n, rule in _traces():
        j, p = JAutotuner(min_workers=1, **kw), PAutotuner(min_workers=1,
                                                           **kw)
        if depth is not None:
            j.depth = p.depth = depth
        for _ in range(n):
            fw = rule(j)
            assert p.observe(fw) == j.observe(fw)
            assert p.last_action == j.last_action
        if rule(j) <= j.high:
            assert j.last_action == "hold"


def _synthetic_steps(n, share=0.9):
    """``n`` ledger records whose feed wait is ``share`` of the wall."""
    led = ptel.ledger()
    for _ in range(n):
        led.step_begin()
        led.step_end(tokens=1)
    with led._lock:
        for rec in led._records:
            rec["wall_s"] = max(rec["wall_s"], 1e-3)
            rec["feed_wait_s"] = share * rec["wall_s"]


def test_autotune_applies_between_epochs_only(tmp_path, monkeypatch):
    """DMLC_FEED_AUTOTUNE=1: a 90% feed-wait ledger grows the worker
    count at the next epoch boundary (within DMLC_FEED_WORKERS_MAX), not
    inside the epoch that saw it; evidence below the window is pooled
    across short epochs, as in the JAX feed."""
    monkeypatch.setenv("DMLC_FEED_AUTOTUNE", "1")
    monkeypatch.setenv("DMLC_FEED_WORKERS", "1")
    monkeypatch.setenv("DMLC_FEED_WORKERS_MAX", "3")
    path = _indexed_rec(tmp_path, n=64)
    feed = precordio_feed(path, batch_records=2, max_bytes=32,
                          num_parts=4, device="cpu")
    assert feed._autotuner is not None
    ptel.reset_steps()
    _batches(feed)                 # no ledger evidence: no change
    assert feed._workers == 1
    it = iter(feed)
    next(it)
    _synthetic_steps(6)
    for _ in it:                   # the epoch in flight keeps its workers
        assert feed._workers == 1
    _batches(feed)                 # the boundary applies the controller
    assert feed._workers == 2
    assert ptel.counters_snapshot()["feed"]["autotune_adjustments"] == 1
    for n, want in ((2, 2), (2, 2), (2, 3)):   # pooled: 6 >= the window
        _synthetic_steps(n)
        _batches(feed)
        assert feed._workers == want


# ---------------------------------------------------------------------------
# the bucketer after a failed bucket
# ---------------------------------------------------------------------------

def test_bucketer_runs_no_collective_after_a_failed_bucket():
    """The first bucket's collective raises (a lost peer); the buckets
    queued behind it start no collective of their own (against a dead
    peer each would wait out a shm or setup timeout), and the error
    still re-raises at the join with the gradients untouched."""
    import threading

    import torch

    from dmlc_tpu_torch.parallel.overlap import GradientBucketer

    calls = []
    gate = threading.Event()

    def collective(a):
        calls.append(a.size)
        gate.wait(10)   # every bucket is queued before the first fails
        raise ConnectionError("peer lost")

    leaves = [torch.full((64,), float(i)) for i in range(8)]
    bucketer = GradientBucketer(collective, bucket_bytes_=256)
    try:
        timer = threading.Timer(0.5, gate.set)
        timer.start()
        with pytest.raises(ConnectionError, match="peer lost"):
            bucketer.reduce_leaves(leaves)
        timer.join(10)
        assert len(calls) == 1
        assert all(torch.equal(lf, torch.full((64,), float(i)))
                   for i, lf in enumerate(leaves))
    finally:
        bucketer.close()


# ---------------------------------------------------------------------------
# the trainer's ledger billing
# ---------------------------------------------------------------------------

def _tiny():
    cfg = TransformerConfig(vocab=example.VOCAB, d_model=32, n_heads=2,
                            head_dim=16, d_ff=64, n_layers=2, n_experts=1,
                            remat=True)
    return init_params(cfg, __import__("torch").Generator().manual_seed(0),
                       "cpu")


def test_trainer_bills_the_feed_wait_to_its_step(tmp_path, capsys):
    """The reference opens each step before the batch pull
    (examples/train_lm_recordio.py:459-465), so the consumer's feed.wait
    span lies inside the step and is its feed_wait_s.  Every recorded
    step of the port's trainer holds exactly one feed.wait span, and its
    feed_wait_s is that span's time (1e-9 s: float sums); the closing
    line carries the ledger summary."""
    shard = str(tmp_path / "d.rec")
    example.make_data(shard, n_records=128)
    ptel.reset()
    ptel.reset_steps()
    example.run(shard, 6, None, device="cpu", model=_tiny())
    recs = ptel.ledger().records()
    assert len(recs) == 6
    spans = ptel.spans()
    steps = {s["args"]["n"]: s for s in spans
             if s["name"] == "step" and s["cat"] == "step"}
    waits = [s for s in spans if s["name"] == "feed.wait"]
    for rec in recs:
        st = steps[rec["seq"]]
        lo, hi = st["ts"], st["ts"] + st["dur"]
        inside = [w for w in waits if w["tid"] == st["tid"]
                  and lo <= w["ts"] and w["ts"] + w["dur"] <= hi]
        assert len(inside) == 1, rec["seq"]
        assert rec["feed_wait_s"] == pytest.approx(
            inside[0]["dur"] / 1e6, abs=1e-9)
    assert re.search(r"ledger: step p50 [0-9.]+ ms, p99 [0-9.]+ ms, "
                     r"feed-wait \d+%, collective exposed \d+% / "
                     r"overlapped \d+%, goodput [0-9,]+ tok/s",
                     capsys.readouterr().out)


# ---------------------------------------------------------------------------
# gangs
# ---------------------------------------------------------------------------

def _env(threads=2, **extra):
    env = os.environ.copy()
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # one CPU device for the JAX example, as the port's one partition
    env["XLA_FLAGS"] = re.sub(r"--xla_force_host_platform_device_count=\d+",
                              "", env.get("XLA_FLAGS", "")).strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = str(threads)
    env.pop("DMLC_FAULT_SPEC", None)
    env.update(extra)
    return env


def _losses(text):
    """{step: [printed loss per rank]} from the gang's output."""
    out = {}
    for m in re.finditer(r"step (\d+): loss ([0-9.]+)", text):
        out.setdefault(int(m.group(1)), []).append(float(m.group(2)))
    return out


def _jax_init_checkpoint(*dirs):
    """The JAX example's initial state (seed 0, optax.adamw(3e-4)),
    committed as step 0 in each of ``dirs``."""
    import jax
    import optax

    from dmlc_tpu.checkpoint import CheckpointManager
    from dmlc_tpu.models import TransformerConfig as JConfig
    from dmlc_tpu.models import init_params as jinit

    cfg = JConfig(vocab=example.VOCAB, d_model=256, n_heads=4, head_dim=64,
                  d_ff=512, n_layers=4, n_experts=1, microbatches=1,
                  dtype="float32", remat=True)
    params = jinit(jax.random.PRNGKey(0), cfg, n_stages=1)
    tree = {"params": params, "opt": optax.adamw(example.LR).init(params)}
    for d in dirs:
        CheckpointManager(d, max_to_keep=2).save(0, tree)
    return tree


def test_two_rank_gang_matches_the_jax_gang(tmp_path):
    """Two ranks of each package under its own launcher, DMLC_ELASTIC=1,
    --device cpu, both resuming from one committed JAX-init checkpoint
    and training to step 30.  Every printed loss (4 decimals) lies within
    2e-4 of the JAX gang's.  Rank 0's final checkpoints agree leaf by
    leaf: 99.99% of the elements within rtol 1e-4 plus 1e-4 of the
    leaf's largest magnitude, and every element within 1e-3 of it
    (AdamW divides a near-zero gradient by its own noise, so an element
    whose gradient is float32 rounding noise may move by a fraction of
    the learning rate)."""
    import jax

    from dmlc_tpu.checkpoint import CheckpointManager

    shard = str(tmp_path / "d.rec")
    example.make_data(shard)
    jdir, pdir = str(tmp_path / "jck"), str(tmp_path / "pck")
    tmpl = _jax_init_checkpoint(jdir, pdir)
    common = ["--cluster", "local", "--num-workers", "2", "--host-ip",
              "127.0.0.1", "--max-attempts", "1", "--"]
    jrun = subprocess.run(
        [sys.executable, os.path.join(REPO, "bin", "dmlc-submit"), *common,
         sys.executable, os.path.join(REPO, "examples",
                                      "train_lm_recordio.py"),
         shard, "30", jdir],
        capture_output=True, text=True, timeout=WAIT_S, cwd=REPO,
        env=_env(DMLC_ELASTIC="1"))
    assert jrun.returncode == 0, jrun.stderr[-3000:]
    prun = subprocess.run(
        [sys.executable, "-m", f"{PORT}.tracker.submit", *common,
         sys.executable, "-m", f"{PORT}.examples.train_lm_recordio",
         shard, "30", pdir, "--device", "cpu"],
        capture_output=True, text=True, timeout=WAIT_S, cwd=REPO,
        env=_env(DMLC_ELASTIC="1"))
    assert prun.returncode == 0, prun.stderr[-3000:]
    want, got = _losses(jrun.stdout), _losses(prun.stdout)
    assert sorted(got) == sorted(want) == [1, 10, 20, 30]
    for step in want:
        assert len(got[step]) == len(want[step]) == 2
        for g in got[step]:
            assert abs(g - want[step][0]) <= 2e-4, (step, got, want)
    assert prun.stdout.count("resumed from step 0") == 2
    j = CheckpointManager(jdir).restore_latest(tmpl)
    p = CheckpointManager(pdir).restore_latest(tmpl)
    assert j[0] == p[0] == 30
    for jl, pl in zip(jax.tree_util.tree_leaves(j[1]),
                      jax.tree_util.tree_leaves(p[1])):
        jl, pl = np.asarray(jl, np.float64), np.asarray(pl, np.float64)
        scale = max(float(np.max(np.abs(jl))), 1e-30)
        assert np.max(np.abs(pl - jl)) <= 1e-3 * scale
        close = np.isclose(pl, jl, rtol=1e-4, atol=1e-4 * scale)
        assert close.mean() >= 0.9999


WORKER = r"""
import hashlib, json, os, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from {port} import resilience
from {port}.examples import train_lm_recordio as ex
from {port}.models.convert import train_state_to_jax
from {port}.models.transformer import TransformerConfig, init_params
from {port}.resilience import selfheal
from {port}.telemetry import goodput

shard, steps, ckpt, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
pace = float(os.environ.get("TEST_PACE_S", "0"))
task = os.environ["DMLC_TASK_ID"]
with open(os.path.join(out, "pid." + task), "w") as f:
    json.dump({{"pid": os.getpid(),
               "port": os.environ["DMLC_TRACKER_PORT"]}}, f)


def digest(tree):
    from torch.utils import _pytree as pytree
    h = hashlib.sha256()
    for leaf in pytree.tree_leaves(tree):
        a = leaf.numpy() if isinstance(leaf, torch.Tensor) else \
            np.asarray(leaf)
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


syncs = []
orig = ex._ElasticTrainer._broadcast_state


def hooked(self, done):
    done = orig(self, done)
    step, tree = self.manager.restore_latest(
        train_state_to_jax(self.model, self.optimizer, device="meta"))
    syncs.append({{"done": done, "rank": self.client.rank,
                  "world": self.client.world_size,
                  "state": digest(train_state_to_jax(self.model,
                                                     self.optimizer)),
                  "ckpt_step": step,
                  "ckpt": None if tree is None else digest(tree)}})
    with open(os.path.join(out, "syncs." + task), "a") as f:
        f.write(json.dumps(syncs[-1]) + "\n")
    return done


ex._ElasticTrainer._broadcast_state = hooked
observed = {{}}   # step -> (loss, verdict): the last observation wins


class Guard(resilience.SelfHealGuard):
    def observe(self, loss, grad_norm=None, step=None):
        verdict = super().observe(loss, grad_norm=grad_norm, step=step)
        observed[step] = (float(loss), verdict)
        return verdict


resilience.SelfHealGuard = Guard
if pace:
    tokens = ex.batch_tokens

    def paced(batch):   # the failure detector needs steps to take time
        time.sleep(pace)
        return tokens(batch)

    ex.batch_tokens = paced
cfg = TransformerConfig(vocab=ex.VOCAB, d_model=32, n_heads=2, head_dim=16,
                        d_ff=64, n_layers=2, n_experts=1, remat=True)
model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
ex.run(shard, steps, ckpt, device="cpu", model=model)
doc = {{"task": task, "pid": os.getpid(), "syncs": syncs,
       "observed": {{str(k): v for k, v in observed.items()}},
       "goodput": goodput.status(), "selfheal": selfheal.status(),
       "final": digest([p.detach() for p in model.parameters()])}}
with open(os.path.join(out, "out.%s.json" % task), "w") as f:
    json.dump(doc, f)
"""


def _gang_env(tracker, **extra):
    return _env(threads=1, DMLC_ELASTIC="1", DMLC_TRACKER_URI="127.0.0.1",
                DMLC_TRACKER_PORT=str(tracker.port),
                DMLC_CLIENT_OP_TIMEOUT_S="60", **extra)


def _spawn(script, env, task, args, log):
    return subprocess.Popen(
        [sys.executable, script, *args], cwd=REPO,
        env=dict(env, DMLC_TASK_ID=str(task)),
        stdout=open(log, "w"), stderr=subprocess.STDOUT)


def _until(cond, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.1)


def _get(url):
    return urllib.request.urlopen(url, timeout=10).read()


def _wait(procs):
    deadline = time.monotonic() + WAIT_S
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=max(1.0, deadline -
                                             time.monotonic())))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    return codes


def _docs(out, tasks):
    return {t: json.load(open(os.path.join(out, f"out.{t}.json")))
            for t in tasks}


def _assert_losses_agree(docs):
    """Each step's loss is the allreduced one: equal (bitwise) on every
    process whose last observation of that step was an applied update."""
    by_step = {}
    for d in docs:
        for step, (loss, verdict) in d["observed"].items():
            if verdict == "ok":
                by_step.setdefault(int(step), set()).add(loss)
    assert by_step
    for step, vals in by_step.items():
        assert len(vals) == 1, (step, vals)
    return by_step


def _assert_syncs_are_the_commit(doc):
    """After every broadcast that followed a commit, the state equals the
    committed checkpoint bit for bit."""
    for s in doc["syncs"]:
        if s["ckpt_step"] is not None:
            assert s["ckpt_step"] == s["done"], s
            assert s["state"] == s["ckpt"], s


def _tracker(n):
    import dmlc_tpu_torch.tracker as ptr

    # heartbeats come every second: a 3 s miss window never declares a
    # live rank dead; a 1 s grace evicts a dead one soon after
    t = ptr.RabitTracker("127.0.0.1", n, metrics_port=0, miss_window_s=3.0,
                         elastic=True, elastic_grace_s=1.0)
    t.start(n)
    return t


def test_killed_worker_shrinks_then_grows_back(tmp_path):
    """Three ranks train the tiny model to step 120, paced 0.2 s a step
    (so a fresh worker has ~20 s to join before the survivors finish).
    One is SIGKILLed once step 20 is committed; the survivors' tree
    allreduce breaks at once, they renumber into [0, 2), restore the
    commit (their broadcast state equals it bit for bit) and go on;
    POST /resize {"world": 3} and a fresh worker grow the world back.
    No survivor restarts; every step's loss agrees
    across the processes that trained it; the final parameters are equal
    everywhere; /metrics counts both resizes and /goodput's buckets sum
    to each rank's wall within 2%, with resize and checkpoint_restore
    badput attributed."""
    shard = str(tmp_path / "d.rec")
    example.make_data(shard, n_records=512)
    out = tmp_path / "out"
    out.mkdir()
    ckpt = str(tmp_path / "ck")
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO, port=PORT))
    tracker = _tracker(3)
    procs = []
    try:
        # the tree allreduce over TCP: a SIGKILLed peer's sockets close,
        # so the survivors raise WorldResized at once
        env = _gang_env(tracker, TEST_PACE_S="0.2", DMLC_COLL_ALGO="tree")
        args = [shard, "120", ckpt, str(out)]
        procs = [_spawn(str(script), env, t, args, out / f"log.{t}")
                 for t in range(3)]
        base = f"http://127.0.0.1:{tracker.metrics_port}"
        _until(lambda: os.path.exists(os.path.join(
            ckpt, "step_00000020", "manifest.json")), "the first commit")
        victim = json.load(open(out / "pid.2"))["pid"]
        os.kill(victim, signal.SIGKILL)

        def world():
            return json.loads(_get(base + "/healthz"))["elastic"]

        def synced(task, size):
            path = out / f"syncs.{task}"
            return path.exists() and any(
                json.loads(ln)["world"] == size
                for ln in path.read_text().splitlines())

        # the shrink settled once both survivors resynced at world 2
        _until(lambda: synced(0, 2) and synced(1, 2), "the shrink")
        assert world()["world"] == 2
        req = urllib.request.Request(
            base + "/resize", data=json.dumps({"world": 3}).encode(),
            headers={"Content-Type": "application/json"})
        assert json.loads(urllib.request.urlopen(
            req, timeout=10).read())["requested"]
        procs.append(_spawn(str(script), env, 3, args, out / "log.3"))
        _until(lambda: world()["world"] == 3 and world()["gen"] >= 2,
               "the grow")
        codes = _wait(procs)
        assert codes == [0, 0, -signal.SIGKILL, 0], codes
        tracker.join(timeout=60)
        metrics = _get(base + "/metrics").decode()
        good = json.loads(_get(base + "/goodput"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        tracker.close()
    docs = _docs(out, (0, 1, 3))
    for t in (0, 1):   # the survivors: both resizes, renumbered
        log = (out / f"log.{t}").read_text()
        sizes = re.findall(r"resized into rank (\d+)/(\d+)", log)
        assert [w for _, w in sizes] == ["2", "3"], log[-2000:]
        assert int(sizes[0][0]) < 2
        assert [s["world"] for s in docs[t]["syncs"]] == [3, 2, 3]
        assert docs[t]["syncs"][1]["done"] == 20
    assert [s["world"] for s in docs[3]["syncs"]] == [3]
    for d in docs.values():
        _assert_syncs_are_the_commit(d)
        assert max(int(k) for k in d["observed"]) == 120
    assert len({d["final"] for d in docs.values()}) == 1
    _assert_losses_agree(docs.values())
    got = re.search(r'^dmlc_elastic_resizes_total\{rank="tracker"\} '
                    r'([0-9.]+)$', metrics, re.MULTILINE)
    assert got and float(got.group(1)) >= 2
    cl = good["cluster"]
    for doc in list(good["per_rank"].values()) + [cl]:
        assert abs(sum(doc["buckets"].values()) - doc["wall_s"]) <= \
            0.02 * doc["wall_s"]
    assert cl["buckets"]["resize"] > 0
    assert cl["buckets"]["checkpoint_restore"] > 0


def test_gang_resumed_from_a_later_commit_numbers_absolute_steps(tmp_path):
    """Two ranks resume from a commit at step 20 (the tiny model's seed-0
    state, written by the test) and train to step 40.  An elastic resume
    counts absolute steps: the ranks print steps 30 and 40, observe steps
    21-40 once each, save step 40 (never 60), and their first broadcast
    is the commit bit for bit."""
    from dmlc_tpu_torch.checkpoint import CheckpointManager
    from dmlc_tpu_torch.models.transformer import adamw

    shard = str(tmp_path / "d.rec")
    example.make_data(shard, n_records=256)
    ckpt = str(tmp_path / "ck")
    model = _tiny()
    CheckpointManager(ckpt, max_to_keep=2).save(20, example.train_state(
        model, adamw(model.parameters(), example.LR)))
    out = tmp_path / "out"
    out.mkdir()
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO, port=PORT))
    tracker = _tracker(2)
    procs = [_spawn(str(script), _gang_env(tracker), t,
                    [shard, "40", ckpt, str(out)], out / f"log.{t}")
             for t in range(2)]
    try:
        assert _wait(procs) == [0, 0]
        tracker.join(timeout=60)
    finally:
        tracker.close()
    logs = "".join((out / f"log.{t}").read_text() for t in range(2))
    assert logs.count("resumed from step 20") == 2, logs[-2000:]
    assert sorted(_losses(logs)) == [30, 40], logs[-2000:]
    assert sorted(n for n in os.listdir(ckpt) if n.startswith("step_")) \
        == ["step_00000020", "step_00000040"]
    docs = _docs(out, (0, 1))
    for d in docs.values():
        assert sorted(int(k) for k in d["observed"]) == list(range(21, 41))
        assert [s["done"] for s in d["syncs"]] == [20]
        _assert_syncs_are_the_commit(d)
    assert docs[0]["final"] == docs[1]["final"]
    _assert_losses_agree(docs.values())


def test_flat_gradient_path_equals_the_bucketed_one(tmp_path):
    """DMLC_COLL_OVERLAP=0 averages the gradients in one flat float32
    allreduce instead of the bucketer's: the same float32 sums divided
    by the same world size, so two ranks end on bit-equal parameters
    either way."""
    shard = str(tmp_path / "d.rec")
    example.make_data(shard, n_records=256)
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO, port=PORT))
    finals = {}
    for overlap in ("1", "0"):
        out = tmp_path / f"o{overlap}"
        out.mkdir()
        tracker = _tracker(2)
        env = _gang_env(tracker, DMLC_COLL_OVERLAP=overlap)
        procs = [_spawn(str(script), env, t,
                        [shard, "12", str(tmp_path / f"ck{overlap}"),
                         str(out)], out / f"log.{t}") for t in range(2)]
        try:
            assert _wait(procs) == [0, 0]
            tracker.join(timeout=60)
        finally:
            tracker.close()
        docs = _docs(out, (0, 1))
        assert docs[0]["final"] == docs[1]["final"]
        finals[overlap] = docs[0]["final"]
    assert finals["0"] == finals["1"]


def test_elastic_self_heal_rolls_back_on_every_rank(tmp_path):
    """Two ranks, three poisoned steps from step 21 (the guard sees the
    same injected loss on both): both skip twice, roll back to the commit
    at step 20 on the same step, replay its 20 batches and end equal to
    an unpoisoned gang, bit for bit; the goodput ledger bills the replay
    to rollback_replay."""
    shard = str(tmp_path / "d.rec")
    example.make_data(shard, n_records=512)
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO, port=PORT))
    runs = {}
    for tag, spec in (("oracle", None),
                      ("healed", "selfheal.loss@step:21=corrupt::3")):
        out = tmp_path / tag
        out.mkdir()
        tracker = _tracker(2)
        extra = {"DMLC_SELFHEAL_MAX_SKIPS": "2"}
        if spec:
            extra["DMLC_FAULT_SPEC"] = spec
        env = _gang_env(tracker, **extra)
        procs = [_spawn(str(script), env, t,
                        [shard, "30", str(tmp_path / f"ck.{tag}"),
                         str(out)], out / f"log.{t}") for t in range(2)]
        try:
            assert _wait(procs) == [0, 0]
            tracker.join(timeout=60)
        finally:
            tracker.close()
        runs[tag] = (out, _docs(out, (0, 1)))
    out, healed = runs["healed"]
    for t in (0, 1):
        log = (out / f"log.{t}").read_text()
        assert re.search(r"selfheal: rolled back to committed step 20 "
                         r"\(rank \d\)", log), log[-2000:]
        assert "selfheal: replaying 20 batches" in log
        doc = healed[t]
        assert doc["selfheal"]["rollbacks"] == 1
        assert doc["selfheal"]["skips"] == 2
        assert doc["goodput"]["buckets"]["rollback_replay"] > 0
        _assert_syncs_are_the_commit(doc)
    assert healed[0]["selfheal"]["step"] == healed[1]["selfheal"]["step"]
    oracle = runs["oracle"][1]
    assert healed[0]["final"] == healed[1]["final"] == oracle[0]["final"]
    want = _assert_losses_agree(oracle.values())
    got = _assert_losses_agree(healed.values())
    assert got == want
