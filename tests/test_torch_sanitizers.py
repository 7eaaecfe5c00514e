"""Sanitizers over the port's C++ (its ``native/csrc/``).

The port's counterpart of the JAX package's sanitizer stages: the
native core (``crc32c.cc`` + ``dmlc_native.cc``) under ThreadSanitizer
and UBSan through the stress program ``test_native_tsan.cc``, and the
collective (``dmlc_collective.cc``) under AddressSanitizer and UBSan
through ``test_collective.c``, four workers of the port's launcher with
the shm group on and off (one build under both sanitizers).  Every
build starts at once, into a temporary directory.  A case skips only
when a trivial probe program under its sanitizer does not build or run
here; a build failure of the port's sources fails it, and so does any
sanitizer report.
"""

import os
import re
import subprocess
import sys

import pytest

from dmlc_tpu_torch import native

PKG = native.__name__.split(".")[0]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = str(native.CSRC)
REPORT = re.compile(r"ThreadSanitizer|AddressSanitizer|LeakSanitizer|"
                    r"runtime error:")
FLAGS = {"thread": ["-fsanitize=thread"],
         "undefined": ["-fsanitize=undefined",
                       "-fno-sanitize-recover=undefined"],
         "address+undefined": ["-fsanitize=address,undefined",
                               "-fno-sanitize-recover=undefined"]}


def _src(name):
    return os.path.join(CSRC, name)


def _probe(san, workdir):
    """Whether a trivial program builds and runs under ``san`` here."""
    src = os.path.join(workdir, "probe.cc")
    exe = os.path.join(workdir, f"probe_{san}")
    with open(src, "w") as f:
        f.write("int main(){return 0;}\n")
    try:
        built = subprocess.run(["g++", *FLAGS[san], src, "-o", exe,
                                "-pthread"], capture_output=True,
                               timeout=120)
        return (built.returncode == 0
                and subprocess.run([exe], timeout=60).returncode == 0)
    except (OSError, subprocess.TimeoutExpired):
        return False


class _Builds:
    """Every sanitizer build of the module, started together (the
    collective library under ASan takes ~12 s of g++ alone)."""

    def __init__(self, workdir):
        self.workdir = workdir
        self.ok = {san: _probe(san, workdir) for san in FLAGS}
        self.exe = {}
        self._procs = {}
        for san in ("thread", "undefined"):
            if self.ok[san]:
                self._start(f"native-{san}",
                            ["g++", "-O1", "-g", "-std=c++17", *FLAGS[san],
                             _src("crc32c.cc"), _src("dmlc_native.cc"),
                             _src("test_native_tsan.cc"), "-o",
                             self._out(f"native-{san}"), "-pthread"])
        if self.ok["address+undefined"]:
            self._start("collective-lib",
                        ["g++", "-O1", "-g", *FLAGS["address+undefined"],
                         "-std=c++17", "-shared", "-fPIC",
                         _src("dmlc_collective.cc"), "-o",
                         self._out("libdmlc_collective.so"), "-lrt"])

    def _out(self, name):
        return os.path.join(self.workdir, name)

    def _start(self, name, cmd):
        self._procs[name] = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)

    def _wait(self, name):
        proc = self._procs[name]
        out, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{name} did not build:\n{out}"

    def native(self, san):
        self._wait(f"native-{san}")
        return self._out(f"native-{san}")

    def collective(self):
        if "collective" not in self.exe:
            self._wait("collective-lib")
            exe = self._out("test_collective")
            self._start("collective", [
                "gcc", "-O1", "-g", *FLAGS["address+undefined"], "-std=c99",
                "-I", CSRC, _src("test_collective.c"),
                self._out("libdmlc_collective.so"), "-o", exe, "-lm",
                "-lasan", "-lubsan", "-lrt", f"-Wl,-rpath,{self.workdir}"])
            self._wait("collective")
            self.exe["collective"] = exe
        return self.exe["collective"]

    def close(self):
        for proc in self._procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    b = _Builds(str(tmp_path_factory.mktemp("sanitizers")))
    yield b
    b.close()


def _need(builds, san):
    if not builds.ok[san]:
        pytest.skip(f"the {san} sanitizer runtime does not build or run "
                    f"a trivial program here")


def _clean(text, what):
    bad = [ln for ln in text.splitlines() if REPORT.search(ln)]
    assert not bad, f"{what}: sanitizer reports:\n" + "\n".join(bad[:40])


@pytest.mark.parametrize("san", ["thread", "undefined"])
def test_native_core_stress_runs_clean(san, builds):
    """The parse fanout and the fused feed entry points, from several
    caller threads at once, with no report."""
    _need(builds, san)
    r = subprocess.run([builds.native(san)], capture_output=True,
                       text=True, timeout=180)
    out = r.stdout + r.stderr
    assert r.returncode == 0, out[-3000:]
    assert "tsan stress OK" in r.stdout, out[-3000:]
    _clean(out, f"native core under {san}")


@pytest.mark.parametrize("shm", [1, 0], ids=["shm", "tcp"])
def test_collective_abi_runs_clean_at_four_workers(shm, builds):
    """allreduce sum/max/min, broadcast and allgather across 4 workers of
    the port's launcher under ASan and UBSan, every rank OK and no
    report."""
    _need(builds, "address+undefined")
    exe = builds.collective()
    env = os.environ.copy()
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["DMLC_COLL_SHM"] = str(shm)
    r = subprocess.run(
        [sys.executable, "-m", f"{PKG}.tracker.submit",
         "--cluster", "local", "--num-workers", "4", "--max-attempts", "1",
         "--host-ip", "127.0.0.1", "--", exe],
        capture_output=True, text=True, timeout=180, env=env, cwd=REPO)
    out = r.stdout + r.stderr
    assert r.returncode == 0, out[-3000:]
    for rank in range(4):
        assert f"rank {rank}/4: collective ABI OK" in out, out[-3000:]
    _clean(out, f"collective under ASan and UBSan, DMLC_COLL_SHM={shm}")
