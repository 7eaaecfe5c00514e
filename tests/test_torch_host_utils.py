"""The port's host utilities against the JAX package's: ``config``,
``json_helper``, ``memory``, ``metrics`` and ``logging``, and the port's
log sites routed through its ``logging``.

The same inputs (a config corpus with comments, escapes, repeats and
multi-value keys; JSON documents good and bad; seeded pool op
sequences; the same metric calls and log calls) go through both
packages and must give equal results: iteration, values and proto text
byte-equal, the same error types on the same malformed input, equal
pool counts, equal snapshot keys and counts, and equal log lines once
the timestamp is masked.  Each re-routed site (feed, checkpoint,
self-heal, integrity, cached split, row iterator) is driven in both
packages with a sink installed, and its line held against the
reference's.
"""

import json
import os
import re
import threading

import numpy as np
import pytest

import dmlc_tpu
import dmlc_tpu_torch
from dmlc_tpu import config as jconfig
from dmlc_tpu import json_helper as jjson
from dmlc_tpu import logging as jlog
from dmlc_tpu import memory as jmemory
from dmlc_tpu import metrics as jmetrics
from dmlc_tpu.base import DMLCError as JError
from dmlc_tpu_torch import config as pconfig
from dmlc_tpu_torch import json_helper as pjson
from dmlc_tpu_torch import logging as plog
from dmlc_tpu_torch import memory as pmemory
from dmlc_tpu_torch import metrics as pmetrics
from dmlc_tpu_torch.base import DMLCError as PError

# ---------------------------------------------------------------------------
# the top-level surface
# ---------------------------------------------------------------------------

SURFACE = ("base", "common", "concurrency", "config", "memory", "param",
           "registry", "serializer", "DMLCError", "ParamError", "get_env",
           "Config", "Parameter", "field", "Registry")


def test_top_level_surface_matches_reference():
    for name in SURFACE:
        assert hasattr(dmlc_tpu, name), name
        assert hasattr(dmlc_tpu_torch, name), name
    assert dmlc_tpu_torch.Config is pconfig.Config
    assert dmlc_tpu_torch.DMLCError is PError


def test_package_import_touches_no_card():
    """The package alone imports nothing (no torch: a worker that needs
    none of it starts in a fraction of a second); its surface and the
    host utilities import without initialising CUDA or building
    anything (checked in a fresh interpreter)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = dmlc_tpu_torch.__name__
    code = (f"import sys, {pkg} as pkg\n"
            "assert 'torch' not in sys.modules\n"
            "assert pkg.Config.__module__ == pkg.config.__name__\n"
            "assert pkg.serializer and pkg.DMLCError and pkg.field\n"
            f"from {pkg} import (config, json_helper, logging, memory, "
            "metrics)\n"
            "import torch\n"
            "assert not torch.cuda.is_initialized()\n"
            "assert 'jax' not in sys.modules\n"
            "assert not any(m.startswith('dmlc_tpu.') or m == 'dmlc_tpu' "
            "for m in sys.modules)\n"
            f"assert not any(m.startswith('{pkg}.ops') "
            "for m in sys.modules)\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=repo,
                       env=dict(os.environ, PYTHONPATH=repo))
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
    with pytest.raises(AttributeError):
        getattr(dmlc_tpu_torch, "no_such_name")


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

CORPUS = r'''
# a comment line
   # an indented comment
lr = 0.1
name = "sgd \"fast\" path"   # quoted, escaped, trailing comment
path = '/tmp/a b#c'
tags = a
tags = b
tags = "c d"
empty =
hash = value # trailing comment
lr = 0.2
spaced   =   several words here
back = "a\\b"
'''

BAD = ["novalue", " = value", 'key = "unterminated', "key = 'open"]


def _config_view(cfg):
    return (list(cfg), cfg.items(), cfg.to_proto_string(),
            {k: cfg.get_all(k) for k, _ in cfg})


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_config_corpus_equal_reference(multi):
    p = pconfig.Config(CORPUS, multi_value=multi)
    j = jconfig.Config(CORPUS, multi_value=multi)
    assert _config_view(p) == _config_view(j)
    assert p.to_proto_string().encode() == j.to_proto_string().encode()
    for key in ("lr", "name", "tags", "path", "empty", "hash", "back"):
        assert p.get_param(key) == j.get_param(key)
        assert (key in p) == (key in j)
    p.set_param("extra", 3)
    j.set_param("extra", 3)
    assert _config_view(p) == _config_view(j)


def test_config_file_and_missing_key(tmp_path):
    f = tmp_path / "c.conf"
    f.write_text(CORPUS)
    p, j = pconfig.Config(), jconfig.Config()
    p.load_file(str(f))
    j.load_file(str(f))
    assert _config_view(p) == _config_view(j)
    with pytest.raises(PError, match="not found"):
        p.get_param("nope")
    with pytest.raises(JError, match="not found"):
        j.get_param("nope")


@pytest.mark.parametrize("line", BAD)
def test_config_malformed_lines_raise_alike(line):
    with pytest.raises(PError) as pe:
        pconfig.Config("ok = 1\n" + line)
    with pytest.raises(JError) as je:
        jconfig.Config("ok = 1\n" + line)
    assert str(pe.value) == str(je.value)


# ---------------------------------------------------------------------------
# JSONObjectReadHelper
# ---------------------------------------------------------------------------

def _helper(mod, strict=True):
    inner = mod.JSONObjectReadHelper(strict=strict)
    inner.declare_field("beta", float)
    inner.declare_field("steps", int, required=False, default=10)
    h = mod.JSONObjectReadHelper(strict=strict)
    h.declare_field("name", str)
    h.declare_field("lr", float)
    h.declare_field("tags", list, required=False, default=[])
    h.declare_field("opt", inner, required=False)
    return h


DOCS = [
    '{"name": "sgd", "lr": 0.1}',
    '{"name": "adam", "lr": 1, "tags": ["a"], "opt": {"beta": 0.9}}',
    {"name": "x", "lr": 2.5, "opt": {"beta": 1, "steps": 3}},
    '{"name": "x", "lr": 0.1, "extra": 1}',
    '{"lr": 0.1}',
    '{"name": 3, "lr": 0.1}',
    '{"name": "x", "lr": true}',
    '{"name": "x", "lr": 0.1, "opt": {"beta": "no"}}',
    '{"name": "x", "lr": 0.1, "opt": {"beta": 1, "bogus": 2}}',
    '{not json',
    '[1, 2]',
]


def _read(mod, doc, strict):
    try:
        return ("ok", _helper(mod, strict).read_object(doc))
    except Exception as e:  # noqa: BLE001 - the outcome under test
        return ("err", type(e).__name__, str(e))


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "lax"])
def test_json_reads_and_errors_equal_reference(strict):
    for doc in DOCS:
        assert _read(pjson, doc, strict) == _read(jjson, doc, strict), doc


def test_json_read_into_and_write_object():
    class Target:
        pass

    doc = DOCS[1]
    p = _helper(pjson).read_into(Target(), doc)
    j = _helper(jjson).read_into(Target(), doc)
    assert vars(p) == vars(j)
    assert _helper(pjson).write_object(vars(p)) == \
        _helper(jjson).write_object(vars(j))
    assert json.loads(_helper(pjson).write_object(p))["lr"] == 1.0
    h = _helper(pjson)
    h.declare_field("must", int)
    with pytest.raises(PError, match="missing field"):
        h.write_object({"name": "x", "lr": 1.0})


# ---------------------------------------------------------------------------
# memory pools
# ---------------------------------------------------------------------------

def _memory_pool_script(mod, seed):
    rng = np.random.default_rng(seed)
    pool = mod.MemoryPool(100, arena_objects=4, max_free=3)
    held, out = [], []
    for _ in range(300):
        if held and rng.random() < 0.45:
            pool.free(held.pop(int(rng.integers(len(held)))))
        else:
            b = pool.alloc()
            assert b.nbytes == 100 and b.dtype == np.uint8
            held.append(b)
        out.append((pool.allocated, pool.recycled, len(pool._free),
                    len(held)))
    return out


def _buffer_pool_script(mod, seed):
    rng = np.random.default_rng(seed)
    pool = mod.BufferPool(max_bytes=8192)
    held, out, drops = [], [], 0
    for _ in range(400):
        r = rng.random()
        if held and r < 0.4:
            before = pool.held_bytes
            buf = held.pop(int(rng.integers(len(held))))
            pool.release(buf)
            drops += pool.held_bytes == before
        elif r < 0.5:
            # foreign buffers: a view, a wrong dtype, an odd size
            foreign = (np.empty(256, np.uint8)[:128],
                       np.empty(64, np.float32), np.empty(100, np.uint8))
            pool.release(foreign[int(rng.integers(3))])
            drops += 1
        else:
            buf = pool.acquire(int(rng.integers(0, 3000)))
            held.append(buf)
            out.append(buf.nbytes)
        out.append((pool.hits, pool.misses, pool.held_bytes, drops))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pools_count_alike(seed):
    assert _memory_pool_script(pmemory, seed) == \
        _memory_pool_script(jmemory, seed)
    got = _buffer_pool_script(pmemory, seed)
    assert got == _buffer_pool_script(jmemory, seed)
    hits, misses, _, drops = got[-1]
    assert hits and misses and drops


def test_thread_local_pools_count_alike():
    def run(mod):
        tlp = mod.ThreadLocalPool(max_bytes_per_thread=4096)
        res = {}

        def body(k):
            for n in (100, 200, 100, 5000, 64):
                tlp.release(tlp.acquire(n * (k + 1)))
            p = tlp._pool()
            res[k] = (p.hits, p.misses, p.held_bytes)

        ths = [threading.Thread(target=body, args=(k,)) for k in range(3)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        return res

    assert run(pmemory) == run(jmemory)


# ---------------------------------------------------------------------------
# the metrics shim
# ---------------------------------------------------------------------------

def test_metrics_snapshot_keys_and_counts_equal_reference():
    snaps = []
    for mod in (pmetrics, jmetrics):
        mod.reset()
        mod.inc("io", "bytes", 10)
        mod.inc("io", "bytes", 5)
        mod.inc("feed", "batches")
        with mod.timed("feed", "wait"):
            pass
        with mod.annotate("region"):
            pass
        snaps.append(mod.snapshot())
        mod.reset()
    p, j = snaps
    assert {s: sorted(v) for s, v in p.items()} == \
        {s: sorted(v) for s, v in j.items()}
    assert p["io"] == j["io"] == {"bytes": 15.0}
    assert p["feed"]["batches"] == j["feed"]["batches"] == 1.0
    assert p["feed"]["wait_secs"] >= 0
    assert callable(pmetrics.trace)


# ---------------------------------------------------------------------------
# logging
# ---------------------------------------------------------------------------

_TS = re.compile(r"^\[\d{4}-\d\d-\d\d \d\d:\d\d:\d\d\] ")


def _mask(line):
    assert _TS.match(line), line
    return _TS.sub("[TS] ", line)


@pytest.fixture
def sinks(monkeypatch):
    """A list sink on each package's logging, verbosity INFO, no rank;
    everything restored after."""
    for var in ("DMLC_TASK_ID", "DMLC_RANK"):
        monkeypatch.delenv(var, raising=False)
    got = {"port": [], "jax": []}
    for name, mod in (("port", plog), ("jax", jlog)):
        mod._reset_rank_prefix_cache()
        mod.set_verbosity("INFO")
        mod.set_log_sink(got[name].append)
    yield got
    for mod in (plog, jlog):
        mod.set_log_sink(None)
        mod.set_verbosity("INFO")
        mod._reset_rank_prefix_cache()


def _masked(got):
    return {k: [_mask(ln) for ln in v] for k, v in got.items()}


def test_log_lines_equal_reference(sinks):
    for mod in (plog, jlog):
        mod.info("feed: 12 MB to device")
        mod.warning("a warning")
        mod.error("an error")
        mod.log("debug", "hidden at INFO")
        mod.log("info", "via log()")
    m = _masked(sinks)
    assert m["port"] == m["jax"]
    assert m["port"][0] == "[TS] INFO MainThread: feed: 12 MB to device"
    assert len(m["port"]) == 4


@pytest.mark.parametrize("level", ["DEBUG", "INFO", "WARNING", "ERROR"])
def test_verbosity_filters_alike(sinks, level):
    for mod in (plog, jlog):
        mod.set_verbosity(level)
        for lvl in ("DEBUG", "INFO", "WARNING", "ERROR"):
            mod.log(lvl, f"at {lvl}")
    m = _masked(sinks)
    assert m["port"] == m["jax"]
    assert len(m["port"]) == 4 - ["DEBUG", "INFO", "WARNING",
                                  "ERROR"].index(level)


@pytest.mark.parametrize("var", ["DMLC_TASK_ID", "DMLC_RANK"])
def test_rank_prefix_from_env(sinks, monkeypatch, var):
    monkeypatch.setenv(var, "3")
    for mod in (plog, jlog):
        mod._reset_rank_prefix_cache()
        mod.info("ranked")
    m = _masked(sinks)
    assert m["port"] == m["jax"] == ["[TS] r3 INFO MainThread: ranked"]
    # read once: a later change of the variable does not move it
    monkeypatch.setenv(var, "5")
    plog.info("still r3")
    assert _mask(sinks["port"][-1]).startswith("[TS] r3 INFO")


def test_fatal_emits_dumps_and_raises(sinks, monkeypatch, tmp_path):
    monkeypatch.setenv("DMLC_POSTMORTEM_DIR", str(tmp_path))
    with pytest.raises(PError, match="^dying words$"):
        plog.fatal("dying words")
    plog.set_verbosity("ERROR")
    with pytest.raises(PError):
        plog.log("fatal", "never suppressed")
    assert [_mask(ln) for ln in sinks["port"]] == [
        "[TS] FATAL MainThread: dying words",
        "[TS] FATAL MainThread: never suppressed"]
    dumps = sorted(os.listdir(tmp_path))
    assert len(dumps) == 2 and all(d.startswith("postmortem-")
                                   for d in dumps)
    reasons = {json.load(open(tmp_path / d))["reason"] for d in dumps}
    assert reasons == {"FATAL: dying words", "FATAL: never suppressed"}


# ---------------------------------------------------------------------------
# the port's log sites, each held against its reference counterpart
# ---------------------------------------------------------------------------

def _same_lines(sinks, n=1):
    m = _masked(sinks)
    assert m["port"] == m["jax"], m
    assert len(m["port"]) == n, m
    return m["port"]


def test_feed_autotune_line_equal_reference(sinks, tmp_path, monkeypatch):
    from dmlc_tpu import telemetry as jtel
    from dmlc_tpu.feed import recordio_feed as jfeed
    from dmlc_tpu.io.recordio import RecordIOWriter
    from dmlc_tpu.io.stream import Stream
    from dmlc_tpu.parallel import build_mesh
    from dmlc_tpu_torch import telemetry as ptel
    from dmlc_tpu_torch.feed import recordio_feed as pfeed

    monkeypatch.setenv("DMLC_FEED_AUTOTUNE", "1")
    monkeypatch.setenv("DMLC_FEED_WORKERS", "1")
    monkeypatch.setenv("DMLC_FEED_WORKERS_MAX", "3")
    path = str(tmp_path / "a.rec")
    with Stream.create(path, "w") as s:
        w = RecordIOWriter(s)
        for i in range(24):
            w.write_record(bytes([i]) * 20)
    # four partitions each: the JAX feed's from dp=4 of its mesh
    mesh = build_mesh(8, dp=4, sp=2, tp=1, pp=1, ep=1)
    feeds = ((jtel, jfeed(path, mesh, batch_records=2, max_bytes=32)),
             (ptel, pfeed(path, batch_records=2, max_bytes=32,
                          num_parts=4, device="cpu")))
    for tel, feed in feeds:
        tel.reset_steps()
        led = tel.ledger()
        for _ in range(6):
            led.step_begin()
            led.step_end(tokens=1)
        with led._lock:
            for rec in led._records:
                rec["wall_s"] = 1e-3
                rec["feed_wait_s"] = 0.9e-3
        for _ in feed:
            pass
        assert feed._workers == 2
        feed.close()
        tel.reset_steps()
    line, = _same_lines(sinks)
    assert line == ("[TS] INFO MainThread: feed autotune: feed-wait 0.90 "
                    "over 6 steps -> workers 1->2, depth 2->2")


def test_checkpoint_fallback_line_equal_reference(sinks, tmp_path):
    from dmlc_tpu.checkpoint import CheckpointManager as JManager
    from dmlc_tpu_torch.checkpoint import CheckpointManager as PManager

    tree = lambda v: {"w": np.full((4, 3), v, np.float32)}  # noqa: E731
    mgr = PManager(str(tmp_path), max_to_keep=3)
    for step in (1, 2):
        mgr.save(step, tree(float(step)))
    shard = next(p for p in (tmp_path / "step_00000002").iterdir()
                 if p.name.startswith("w."))
    raw = bytearray(shard.read_bytes())
    raw[3] ^= 0x40
    shard.write_bytes(bytes(raw))
    assert mgr.restore_latest(tree(0.0))[0] == 1
    assert JManager(str(tmp_path)).restore_latest(tree(0.0))[0] == 1
    line, = _same_lines(sinks)
    assert line.startswith("[TS] WARNING MainThread: checkpoint step 2 "
                           "failed to restore (")
    assert line.endswith("falling back to the previous committed step")


def test_selfheal_report_lines_equal_reference(sinks):
    from dmlc_tpu.resilience import selfheal as jsh
    from dmlc_tpu_torch.resilience import selfheal as psh

    for mod in (psh, jsh):
        g = mod.SelfHealGuard(max_skips=1, max_rollbacks=1)
        g.observe(1.0, step=1)
        g.observe(float("nan"), step=2)
        g.observe(float("inf"), step=3)
        mod.reset_selfheal()
    lines = _same_lines(sinks, 2)
    assert lines[0].startswith("[TS] WARNING MainThread: selfheal: skip "
                               "at step 2 — ")


def test_integrity_line_equal_reference(sinks, monkeypatch):
    from dmlc_tpu.io import integrity as jint
    from dmlc_tpu_torch.io import integrity as pint

    monkeypatch.setenv("DMLC_INTEGRITY_POLICY", "quarantine")
    for mod in (pint, jint):
        mod.handle_corrupt("bad magic", source="/data/a.rec", begin=8,
                           end=40)
        mod.handle_corrupt("torn record")
        mod.reset_quarantine()
    lines = _same_lines(sinks, 2)
    assert lines[0] == ("[TS] WARNING MainThread: integrity: bad magic at "
                        "/data/a.rec @[8,40) — record quarantined")


def test_cached_split_line_equal_reference(sinks, tmp_path):
    from dmlc_tpu.io import input_split as jsplit
    from dmlc_tpu_torch.io import input_split as psplit

    src = tmp_path / "a.txt"
    src.write_text("".join(f"{i} 1:{i}\n" for i in range(300)))
    cache = str(tmp_path / "a.cache")

    def epoch_then_corrupt(mod):
        s = mod.create(f"{src}#{cache}", 0, 1, "text")
        recs = [bytes(r) for r in iter(s.next_record, None)]
        s.close()
        raw = bytearray(open(cache, "rb").read())
        raw[len(raw) // 2] ^= 0x01
        open(cache, "wb").write(bytes(raw))
        return recs

    first = epoch_then_corrupt(psplit)
    assert epoch_then_corrupt(psplit) == first   # re-parsed, re-cached
    assert epoch_then_corrupt(jsplit) == first
    lines = _same_lines(sinks)
    assert lines[0] == (f"[TS] WARNING MainThread: epoch cache {cache} "
                        f"failed integrity verification (crc32c "
                        f"mismatch); discarding and re-parsing from the "
                        f"source")


class _BigParser:
    """A parser that reports 11 MB read after one tiny block."""

    def __init__(self, mod):
        self._blk = mod.RowBlockContainer()
        self._blk.push_arrays(labels=np.ones(1, np.float32),
                              offsets=np.array([0, 1], np.uint64),
                              index=np.zeros(1, np.uint32),
                              value=np.ones(1, np.float32))
        self._read = 0

    def __iter__(self):
        self._read = 11 << 20
        yield self._blk.get_block()

    def bytes_read(self):
        return self._read


def test_row_iter_progress_line_equal_reference(sinks):
    from dmlc_tpu.data import row_block as jrb
    from dmlc_tpu.data import row_iter as jri
    from dmlc_tpu_torch.data import row_block as prb
    from dmlc_tpu_torch.data import row_iter as pri

    for ri, rb in ((pri, prb), (jri, jrb)):
        assert ri.BasicRowIter(_BigParser(rb)).num_col() == 1
    m = _masked(sinks)
    rate = re.compile(r"\d+\.\d\d MB/sec$")
    assert [rate.sub("R MB/sec", ln) for ln in m["port"]] == \
        [rate.sub("R MB/sec", ln) for ln in m["jax"]] == \
        ["[TS] INFO MainThread: 11 MB read, R MB/sec"]


def test_log_sites_use_the_port_logging():
    """No re-routed module keeps a stdlib logger of its own."""
    import importlib

    for name in ("feed.device_feed", "checkpoint.sharded",
                 "resilience.selfheal", "io.integrity",
                 "io.cached_input_split", "data.row_iter"):
        mod = importlib.import_module(f"{dmlc_tpu_torch.__name__}.{name}")
        assert mod.log is plog, name
        assert not any(k in vars(mod) for k in ("_logger", "logger",
                                                 "_log")), name
