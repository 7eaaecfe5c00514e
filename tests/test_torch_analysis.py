"""The port's static-analysis suite, knob registry and lock-order checker
against the JAX package's.

* Every seeded-bad (and clean) fixture of ``tests/test_analysis.py`` is
  written once as a JAX-package tree and once as a port tree, and goes
  through both packages' passes: the findings (path, line, check id)
  must be equal.  Where a port pass has to differ, its case says so.
* The port's tree runs clean under the port's passes, the port's knob
  registry covers every env read and ``PASS_ENVS`` and its README table
  is current, and every knob it shares with the JAX registry has the
  same type, default and forwarding flag.
* The port's ``DMLC_LOCKCHECK`` watchdog gives the JAX watchdog's report
  kinds on the same scripted threads, and a CPU gang of the port's
  tracker runs clean under it.
"""

import os
import re
import threading
import time

import numpy as np
import pytest

import dmlc_tpu_torch
from dmlc_tpu import concurrency as jconc
from dmlc_tpu import config_registry as jreg
from dmlc_tpu.analysis import ALL_PASSES as J_PASSES
from dmlc_tpu.analysis import run_passes as j_run_passes
from dmlc_tpu.analysis.core import RepoIndex as JIndex
from dmlc_tpu_torch import concurrency as pconc
from dmlc_tpu_torch import config_registry as preg
from dmlc_tpu_torch.analysis import ALL_PASSES as P_PASSES
from dmlc_tpu_torch.analysis import run_passes as p_run_passes
from dmlc_tpu_torch.analysis import __main__ as p_main
from dmlc_tpu_torch.analysis.core import RepoIndex as PIndex
from dmlc_tpu_torch.analysis.core import default_paths, repo_root

REPO = repo_root()
#: the port's package name, read at run time: the JAX package's
#: metric-name lint reads the string literals of tests/ against the JAX
#: registry, which does not know it
PKG = dmlc_tpu_torch.__name__
J_PKG = "dmlc_tpu"

SIDES = {
    "jax": (JIndex, {c.name: c for c in J_PASSES}, j_run_passes),
    "port": (PIndex, {c.name: c for c in P_PASSES}, p_run_passes),
}


# ---------------------------------------------------------------------------
# fixture harness: one mini-repo per package
# ---------------------------------------------------------------------------

def _port_rel(rel):
    """Where a JAX-tree fixture path sits in the port's tree: the package
    prefix, and the LM example, which the port keeps in its package."""
    if rel.startswith(J_PKG + "/"):
        return PKG + rel[len(J_PKG):]
    if rel == "examples/train_lm_recordio.py":
        return f"{PKG}/{rel}"
    return rel


def _jax_rel(rel):
    """The inverse of :func:`_port_rel`, so findings compare by path."""
    if rel == f"{PKG}/examples/train_lm_recordio.py":
        return "examples/train_lm_recordio.py"
    if rel.startswith(PKG + os.sep):
        return J_PKG + "/" + rel[len(PKG) + 1:]
    return rel


def _index(tmp_path, side, files):
    root = tmp_path / side
    paths = []
    for rel, src in files.items():
        p = root / (_port_rel(rel) if side == "port" else rel)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
        paths.append(str(p))
    return SIDES[side][0](paths, str(root))


def _findings(tmp_path, side, files, pass_name):
    index = _index(tmp_path, side, files)
    found = SIDES[side][1][pass_name]().run(index)
    return sorted((_jax_rel(f.rel), f.line, f.check) for f in found)


def _both(tmp_path, files, pass_name):
    return (_findings(tmp_path, "jax", files, pass_name),
            _findings(tmp_path, "port", files, pass_name))


# ---- the fixtures of tests/test_analysis.py -------------------------------

BAD_BLOCKING = '''\
import threading
import time

_lock = threading.Lock()


def slow():
    with _lock:
        time.sleep(1.0)
'''

CLEAN_BLOCKING = '''\
import threading
import time

_lock = threading.Lock()


def fast():
    with _lock:
        x = 1
    time.sleep(1.0)
    return x
'''

BAD_INVERSION = '''\
import threading


class M:
    def __init__(self):
        self._a_lock = threading.Lock()
        self._b_lock = threading.Lock()

    def one(self):
        with self._a_lock:
            with self._b_lock:
                return 1

    def two(self):
        with self._b_lock:
            with self._a_lock:
                return 2
'''

CLEAN_NESTING = BAD_INVERSION.replace(
    "        with self._b_lock:\n            with self._a_lock:",
    "        with self._a_lock:\n            with self._b_lock:")

CALL_CYCLE = '''\
import threading


class A:
    def __init__(self, b):
        self._a_lock = threading.Lock()
        self.b = b

    def go(self):
        with self._a_lock:
            self.b.poke()


class B:
    def __init__(self, a):
        self._b_lock = threading.Lock()
        self.a = a

    def poke(self):
        with self._b_lock:
            return 1

    def back(self):
        with self._b_lock:
            self.a.go()
'''

NON_DAEMON = ("import threading\n\n\n"
              "def spawn(fn):\n"
              "    t = threading.Thread(target=fn)\n"
              "    t.start()\n")

UNREGISTERED = ("from dmlc_tpu.base import get_env\n\n"
                "v = get_env(\"DMLC_NO_SUCH_KNOB_EVER\", 1)\n")

RAW_READ = "import os\n\nv = os.environ.get(\"DMLC_FEED_DEPTH\")\n"

SWALLOW = '''\
def pull(sock):
    try:
        return sock.recv_thing()
    except Exception:
        return None
'''

SWALLOW_HANDLED = '''\
from ..base import DMLCError
from .client import WorldResized


def pull(sock):
    try:
        return sock.recv_thing()
    except WorldResized:
        raise
    except Exception:
        return None
'''

SWALLOW_TRANSPORTED = '''\
def pull(sock, fut):
    try:
        return sock.recv_thing()
    except BaseException as e:
        fut.set_exception(e)
'''

SOCKET_BAD = ("import socket\n\n\n"
              "def dial():\n"
              "    s = socket.socket()\n"
              "    return s\n")

FAULT_SITE_OK = ('from dmlc_tpu.resilience import fault_point\n\n'
                 'SPEC = "my.site@rank:1=kill:137"\n\n\n'
                 'def go(rank):\n'
                 '    fault_point("my.site", rank=rank)\n')

FAULT_SITE_EMBEDDED = ("WORKER = '''\n"
                       "from dmlc_tpu.resilience import fault_point\n"
                       'fault_point("embedded.site", rank=0)\n'
                       "'''\n"
                       'SPEC = "embedded.site=delay:0.1"\n')

STYLE_CLASSICS = ("import os\n\n\n"
                  "def f(x=[]):\n"
                  "    try:\n"
                  "        return x\n"
                  "    except:\n"
                  "        pass\n")

METRIC_BOGUS = ('from dmlc_tpu import telemetry\n\n'
                'telemetry.inc("bogus_stage", "bogus_name")\n')

#: (case id, files, pass, check, whether the check must fire)
CASES = [
    ("blocking-bad", {"dmlc_tpu/mod.py": BAD_BLOCKING}, "concurrency",
     "blocking-under-lock", True),
    ("blocking-clean", {"dmlc_tpu/mod.py": CLEAN_BLOCKING}, "concurrency",
     "blocking-under-lock", False),
    ("inversion-bad", {"dmlc_tpu/mod.py": BAD_INVERSION}, "concurrency",
     "lock-cycle", True),
    ("nesting-clean", {"dmlc_tpu/mod.py": CLEAN_NESTING}, "concurrency",
     "lock-cycle", False),
    ("cycle-via-call", {"dmlc_tpu/mod.py": CALL_CYCLE}, "concurrency",
     "lock-cycle", True),
    ("non-daemon-bad", {"dmlc_tpu/mod.py": NON_DAEMON}, "concurrency",
     "non-daemon-thread", True),
    ("non-daemon-daemon", {"dmlc_tpu/mod.py": NON_DAEMON.replace(
        "target=fn)", "target=fn, daemon=True)")}, "concurrency",
     "non-daemon-thread", False),
    ("non-daemon-joined", {"dmlc_tpu/mod.py": NON_DAEMON
                           + "    t.join()\n"}, "concurrency",
     "non-daemon-thread", False),
    ("knob-unregistered", {"dmlc_tpu/mod.py": UNREGISTERED}, "knobs",
     "unregistered-knob", True),
    ("knob-registered", {"dmlc_tpu/mod.py": UNREGISTERED.replace(
        "DMLC_NO_SUCH_KNOB_EVER", "DMLC_FEED_DEPTH")}, "knobs",
     "unregistered-knob", False),
    ("raw-read-package", {"dmlc_tpu/mod.py": RAW_READ}, "knobs",
     "raw-env-read", True),
    ("raw-read-scripts", {"scripts/mod.py": RAW_READ}, "knobs",
     "raw-env-read", False),
    ("knob-token-unknown", {"dmlc_tpu/mod.py":
                            'DOC = "set DMLC_TOTALLY_MADE_UP to tune"\n'},
     "knobs", "unknown-knob-token", True),
    ("knob-token-family", {"dmlc_tpu/mod.py":
                           'DOC = "the DMLC_COLL_ knobs are uniform"\n'},
     "knobs", "unknown-knob-token", False),
    ("pass-envs-unknown", {"dmlc_tpu/tracker/launch.py":
                           'PASS_ENVS = [\n    "DMLC_BOGUS_FORWARD",\n]\n'},
     "knobs", "pass-envs-unknown", True),
    ("swallow-protected", {"dmlc_tpu/tracker/client.py": SWALLOW},
     "contracts", "swallowed-exception", True),
    ("swallow-unprotected", {"dmlc_tpu/telemetry/foo.py": SWALLOW},
     "contracts", "swallowed-exception", False),
    ("swallow-handled-first", {"dmlc_tpu/tracker/client.py":
                               SWALLOW_HANDLED},
     "contracts", "swallowed-exception", False),
    ("swallow-transported", {"dmlc_tpu/tracker/client.py":
                             SWALLOW_TRANSPORTED},
     "contracts", "swallowed-exception", False),
    # the port keeps the LM example in its package: the same protection
    # at its place there (the port side writes it under the package)
    ("swallow-lm-example", {"examples/train_lm_recordio.py": SWALLOW},
     "contracts", "swallowed-exception", True),
    ("socket-no-timeout", {"dmlc_tpu/mod.py": SOCKET_BAD}, "contracts",
     "socket-no-timeout", True),
    ("socket-timeout", {"dmlc_tpu/mod.py": SOCKET_BAD.replace(
        "    return s\n", "    s.settimeout(5.0)\n    return s\n")},
     "contracts", "socket-no-timeout", False),
    ("fault-site-typo", {"dmlc_tpu/mod.py":
                         'SPEC = "tracker.dail=error::2"\n'},
     "contracts", "unknown-fault-site", True),
    ("fault-site-resolves", {"dmlc_tpu/mod.py": FAULT_SITE_OK},
     "contracts", "unknown-fault-site", False),
    ("fault-site-embedded", {"scripts/smoke.py": FAULT_SITE_EMBEDDED},
     "contracts", "unknown-fault-site", False),
    ("style-unused-import", {"dmlc_tpu/mod.py": STYLE_CLASSICS}, "style",
     "unused-import", True),
    ("style-mutable-default", {"dmlc_tpu/mod.py": STYLE_CLASSICS},
     "style", "mutable-default", True),
    ("style-bare-except", {"dmlc_tpu/mod.py": STYLE_CLASSICS}, "style",
     "bare-except", True),
    ("metric-unregistered", {"dmlc_tpu/mod.py": METRIC_BOGUS}, "metrics",
     "metric-name", True),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_seeded_fixture_same_findings_both_packages(tmp_path, case):
    _, files, pass_name, check, fires = case
    want, got = _both(tmp_path, files, pass_name)
    assert got == want
    assert any(c == check for _, _, c in got) == fires, got


def test_pass_envs_missing_counts_each_registry(tmp_path):
    """Every other forwarded knob is reported missing, by each package
    against its own registry (the two forward the same knobs)."""
    files = {"dmlc_tpu/tracker/launch.py":
             'PASS_ENVS = [\n    "DMLC_INTERFACE",\n]\n'}
    want, got = _both(tmp_path, files, "knobs")
    assert got == want
    missing = [f for f in got if f[2] == "pass-envs-missing"]
    assert len(missing) == len(preg.pass_env_names()) - 1
    assert preg.pass_env_names() == jreg.pass_env_names()


@pytest.mark.parametrize("side", ["jax", "port"])
def test_suppression_comment_and_counting(tmp_path, side):
    src = ("import threading\n"
           "import time\n\n"
           "_lock = threading.Lock()\n\n\n"
           "def slow():\n"
           "    with _lock:\n"
           "        # dmlc-check: disable=blocking-under-lock -- test\n"
           "        time.sleep(1.0)\n")
    index_cls, passes, run = SIDES[side]
    index = _index(tmp_path, side, {"dmlc_tpu/mod.py": src})
    findings, suppressed = run(index, [passes["concurrency"]()])
    assert not findings
    assert [s.check for s in suppressed] == ["blocking-under-lock"]


# ---- where the port's passes differ ---------------------------------------

def test_cuda_sync_under_a_lock_is_blocking_on_the_port_only(tmp_path):
    """The port counts ``torch.cuda.synchronize`` as blocking, the
    counterpart of the JAX package's ``jax.block_until_ready``."""
    src = ("import threading\n\nimport torch\n\n"
           "_lock = threading.Lock()\n\n\n"
           "def sync():\n"
           "    with _lock:\n"
           "        torch.cuda.synchronize()\n")
    want, got = _both(tmp_path, {"dmlc_tpu/mod.py": src}, "concurrency")
    assert want == []
    assert got == [("dmlc_tpu/mod.py", 10, "blocking-under-lock")]


def test_port_knows_its_own_tokens_as_non_metric(tmp_path):
    """The port's package name and its C and CUDA symbols are known to
    the port's registry (the JAX registry knows its own the same way)."""
    tokens = [PKG, "dmlc_" + "flash_fwd", "dmlc_" + "paged_attention",
              "dmlc_" + "crc32c_hw"]
    src = "".join(f'N{i} = "{t}"\n' for i, t in enumerate(tokens))
    want, got = _both(tmp_path, {"dmlc_tpu/mod.py": src}, "metrics")
    assert [line for _, line, _ in want] == [1, 2, 3, 4]
    assert got == []


def test_strict_checks_apply_to_each_packages_own_tree(tmp_path):
    """The JAX package's passes skip a port tree and the port's skip a
    JAX tree: ``in_package`` names each package's own prefix."""
    jtree = _write(tmp_path / "a", f"{PKG}/m.py", RAW_READ)
    ptree = _write(tmp_path / "b", "dmlc_tpu/m.py", RAW_READ)
    jfound = SIDES["jax"][1]["knobs"]().run(
        JIndex([str(jtree)], str(tmp_path / "a")))
    pfound = SIDES["port"][1]["knobs"]().run(
        PIndex([str(ptree)], str(tmp_path / "b")))
    for found in (jfound, pfound):
        assert not [f for f in found if f.check == "raw-env-read"], found


def _write(root, rel, src):
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(src)
    return p


# ---------------------------------------------------------------------------
# the port's own tree
# ---------------------------------------------------------------------------

def test_port_runs_clean(capsys):
    """The port's surface passes every port pass; the suppressions are
    inline, name their checks and are counted."""
    index = PIndex(default_paths(None, REPO), REPO)
    findings, suppressed = p_run_passes(index,
                                        [cls() for cls in P_PASSES])
    assert not findings, "\n".join(str(f) for f in findings[:40])
    assert any(f.rel.startswith(PKG + os.sep) for f in index.files)
    assert any(f.rel == "chip_smoke.py" for f in index.files)
    blanket = [(ctx.rel, ln) for ctx in index.files
               for ln, ids in ctx.suppress.items() if "*" in ids]
    assert not blanket, blanket
    with capsys.disabled():
        print(f"\nport dmlc-check: {len(index.files)} files, "
              f"{len(suppressed)} suppressed "
              f"({sorted({s.check for s in suppressed})})")


LAST_MODULES = ("analysis/interleave.py", "analysis/scenarios.py",
                "concurrency.py", "config.py", "json_helper.py",
                "logging.py", "memory.py", "metrics.py")


def test_last_modules_run_clean_without_suppressions(capsys):
    """The modules that completed the port (the explorer and its
    scenarios, the queue classes, the host utilities) and their tests
    pass every port pass, clear their findings with annotations or in
    code and carry no suppression; the runner exits 0 over them."""
    paths = [os.path.join(REPO, PKG, rel) for rel in LAST_MODULES] + [
        os.path.join(REPO, "tests", f"test_torch_{name}.py") for name in (
            "interleave", "concurrency_queues", "host_utils",
            "sanitizers")]
    index = PIndex(paths, REPO)
    assert len(index.files) == len(paths)
    findings, suppressed = p_run_passes(index, [cls() for cls in P_PASSES])
    assert not findings, "\n".join(str(f) for f in findings[:40])
    assert not suppressed, suppressed
    assert p_main.main(paths) == 0
    capsys.readouterr()


def test_every_reference_file_has_a_port_counterpart():
    """Each ``.py``/``.cc``/``.c``/``.h`` of the JAX package has its
    counterpart in the port (``cpp/`` under ``native/csrc/``)."""
    def files(pkg):
        root = os.path.join(REPO, pkg)
        out = set()
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in filenames:
                if fn.endswith((".py", ".cc", ".c", ".h")):
                    out.add(os.path.relpath(os.path.join(dirpath, fn), root))
        return out

    ref = {re.sub(r"^cpp/", "native/csrc/", f) for f in files(J_PKG)}
    assert not ref - files(PKG), sorted(ref - files(PKG))
    for name in ("ConcurrentBlockingQueue", "MultiThreadedIter"):
        assert name in pconc.__all__


def test_runner_exits_by_findings(tmp_path, capsys):
    """The runner (``python -m <package>.analysis``): 0 clean, 1 with
    findings, 2 on an unknown pass; --list names every pass."""
    clean = _write(tmp_path, "ok.py", "X = 1\n")
    bad = _write(tmp_path, "bad.py", "import os\n")
    assert p_main.main([str(clean)]) == 0
    assert p_main.main([str(bad), "--passes", "style"]) == 1
    assert "unused-import" in capsys.readouterr().out
    assert p_main.main(["--passes", "nope"]) == 2
    assert p_main.main(["--list"]) == 0
    listed = capsys.readouterr().out
    for cls in P_PASSES:
        assert cls.name in listed


_READ_RE = re.compile(
    r"(?:os\.environ(?:\.get)?\s*[\[\(]|os\.getenv\(|get_env\()"
    r"\s*[\"'](DMLC_[A-Z0-9_]+)[\"']")


def test_port_registry_covers_every_env_read_grep():
    """A raw regex grep over the port's package (no AST, no shared code
    with the knob pass) finds no env read the registry does not know."""
    known = set(preg.names())
    unknown = {}
    for dirpath, dirnames, filenames in os.walk(os.path.join(REPO, PKG)):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if fn.endswith(".py"):
                with open(os.path.join(dirpath, fn), encoding="utf-8") as f:
                    for key in _READ_RE.findall(f.read()):
                        if key not in known:
                            unknown.setdefault(key, fn)
    assert not unknown, unknown


def test_port_pass_envs_matches_registry():
    from dmlc_tpu_torch.tracker.launch import PASS_ENVS

    missing = [k for k in preg.pass_env_names() if k not in PASS_ENVS]
    assert not missing, missing
    bogus = [k for k in PASS_ENVS if k.startswith("DMLC_")
             and preg.get(k) is None]
    assert not bogus, bogus


def test_port_readme_knob_table_current_and_complete():
    from dmlc_tpu_torch.analysis.knob_pass import (README_BEGIN,
                                                   readme_with_table)

    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as f:
        src = f.read()
    table = preg.render_markdown_table()
    assert readme_with_table(src, table) == src, (
        "the port's README knob table drifted: run python -m "
        "<package>.analysis --write-knob-table")
    assert src.count(README_BEGIN) == 1
    for k in preg.names():
        assert f"`{k}`" in table, k


def test_port_registry_agrees_with_reference():
    """The port adds no knob the JAX registry lacks, and every knob both
    list has the JAX package's type, default, forwarding flag and group."""
    extra = [k for k in preg.names() if jreg.get(k) is None]
    assert not extra, extra
    for k in preg.KNOBS:
        j = jreg.get(k.name)
        assert (k.type, k.default, k.pass_to_workers, k.group) == (
            j.type, j.default, j.pass_to_workers, j.group), k.name
    assert preg.NON_KNOB_TOKENS == jreg.NON_KNOB_TOKENS


# ---------------------------------------------------------------------------
# the runtime lock-order watchdog, both packages on the same threads
# ---------------------------------------------------------------------------

@pytest.fixture
def lockcheck(monkeypatch):
    monkeypatch.setenv("DMLC_LOCKCHECK", "1")
    monkeypatch.delenv("DMLC_RACECHECK", raising=False)
    for conc in (jconc, pconc):
        conc.lockcheck_reset()
    yield
    for conc in (jconc, pconc):
        conc.lockcheck_reset()


def _threads(*fns):
    for fn in fns:
        t = threading.Thread(target=fn, daemon=True)
        t.start()
        t.join(10.0)


def _abba(conc, names):
    a, b = (conc.make_lock(n) for n in names)

    def ab():
        with a:
            with b:
                pass

    def ba():
        with b:
            with a:
                pass

    # the two threads never overlap: the order graph still convicts
    _threads(ab, ba)


def _held_while_blocked(conc):
    x = conc.make_lock("test.X")
    y = conc.make_lock("test.Y")
    release = threading.Event()
    got = []

    def holder():
        with x:
            release.wait(2.0)

    def contender():
        with y:
            with x:
                got.append(1)

    t = threading.Thread(target=holder, daemon=True)
    t.start()
    time.sleep(0.05)
    t2 = threading.Thread(target=contender, daemon=True)
    t2.start()
    time.sleep(0.3)
    release.set()
    t2.join(5.0)
    t.join(5.0)
    assert got == [1]


def _consistent(conc):
    a = conc.make_lock("test.C")
    b = conc.make_lock("test.D")

    def ab():
        with a:
            with b:
                pass

    _threads(ab, ab, ab)


def _reentrant(conc):
    r = conc.make_rlock("test.R")
    with r:
        with r:
            pass


SCRIPTS = {
    "abba": (lambda c: _abba(c, ("test.A", "test.B")), ["order-inversion"]),
    "same-class-instances": (lambda c: _abba(c, ("Queue._lock",) * 2),
                             ["order-inversion"]),
    "held-while-blocked": (_held_while_blocked, ["held-while-blocked"]),
    "consistent-order": (_consistent, []),
    "reentrant": (_reentrant, []),
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_watchdog_reports_the_reference_kinds(lockcheck, monkeypatch,
                                              script):
    monkeypatch.setenv("DMLC_LOCKCHECK_BLOCK_S", "0.1")
    fn, kinds = SCRIPTS[script]
    got = {}
    for name, conc in (("jax", jconc), ("port", pconc)):
        fn(conc)
        got[name] = sorted({v["kind"] for v in conc.lockcheck_report()})
    assert got["port"] == got["jax"] == kinds
    if kinds:
        with pytest.raises(Exception, match=kinds[0]):
            pconc.lockcheck_assert_clean()
    else:
        pconc.lockcheck_assert_clean()


def test_watchdog_witness_site_is_user_frame(lockcheck):
    for conc in (jconc, pconc):
        _abba(conc, ("site.A", "site.B"))
        (v,) = conc.lockcheck_report()
        assert os.path.basename(__file__) in v["detail"], v
        assert "threading.py" not in v["detail"], v


@pytest.mark.parametrize("knobs", [{}, {"DMLC_LOCKCHECK": "0"},
                                   {"DMLC_RACECHECK": "0"}])
def test_make_lock_plain_when_disabled(monkeypatch, knobs):
    monkeypatch.delenv("DMLC_LOCKCHECK", raising=False)
    monkeypatch.delenv("DMLC_RACECHECK", raising=False)
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    lk, rlk = pconc.make_lock("x"), pconc.make_rlock("y")
    assert type(lk) is type(threading.Lock())
    assert type(rlk) is type(threading.RLock())
    with lk, rlk, rlk:
        pass


def test_condition_over_checked_lock_wait_notify(lockcheck):
    for lk in (pconc.make_rlock("test.CV"), pconc.make_lock("test.CV2")):
        assert isinstance(lk, pconc.CheckedLock)
        cv = threading.Condition(lk)
        done = []

        def waiter():
            with cv:
                cv.wait(timeout=5.0)
                done.append(1)

        t = threading.Thread(target=waiter, daemon=True)
        t.start()
        time.sleep(0.1)
        with cv:
            cv.notify_all()
        t.join(5.0)
        assert done == [1]
    pconc.lockcheck_assert_clean()


def test_bufferpool_clean_under_lockcheck(lockcheck):
    pool = pconc.BufferPool(lambda: object(), capacity=2)
    assert isinstance(pool._lock, pconc.CheckedLock)
    a = pool.acquire()
    b = pool.acquire()
    pool.release(a)
    pool.release(b)
    pool.kill()
    assert pool.acquire() is None
    pconc.lockcheck_assert_clean()


def test_tracker_gang_runs_clean_under_lockcheck(lockcheck):
    """Three port TrackerClients against the port's tracker, each with a
    heartbeat thread, through a few allreduces: every lock of the tracker
    and its telemetry aggregator is checked and none is taken out of
    order or held across a blocked acquire."""
    import dmlc_tpu_torch.tracker as ptr
    from dmlc_tpu_torch.telemetry.heartbeat import HeartbeatSender

    n = 3
    tracker = ptr.RabitTracker("127.0.0.1", n, metrics_port=0)
    tracker.start(n)
    assert isinstance(tracker._dead_lock, pconc.CheckedLock)
    sums, errors = {}, []

    def work(i):
        try:
            c = ptr.TrackerClient("127.0.0.1", tracker.port,
                                  jobid=f"job{i}").start()
            hb = HeartbeatSender(c, interval=0.05)
            for step in range(3):
                out = c.allreduce_sum(np.full(4, float(c.rank + step)))
                sums.setdefault(c.rank, []).append(float(out[0]))
                time.sleep(0.06)
            hb.close()
            c.shutdown()
        except Exception as e:  # surfaced below
            errors.append((i, e))

    threads = [threading.Thread(target=work, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    tracker.join(timeout=30)
    tracker.close()
    assert not errors, errors
    assert {r: v for r, v in sums.items()} == {
        r: [3.0, 6.0, 9.0] for r in range(n)}
    assert pconc.lockcheck_report() == []
    pconc.lockcheck_assert_clean()
