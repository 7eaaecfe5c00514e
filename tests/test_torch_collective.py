"""The port's native collective (``native/csrc/dmlc_collective.{cc,h}``,
byte-equal to the JAX package's C source): the shm group through the
port's binding across processes, for every op and dtype, in a group of
port and JAX processes; abort; and the C consumers of the repo built
against the port's header and library, run under the port's launcher."""

import filecmp
import multiprocessing as mp
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from dmlc_tpu_torch.native import shm_collective as pshm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = pshm.__name__.split(".")[0]


@pytest.mark.parametrize("name", ["dmlc_collective.cc", "dmlc_collective.h"])
def test_sources_byte_equal_to_jax(name):
    assert filecmp.cmp(pshm.CSRC / name,
                       os.path.join(REPO, "dmlc_tpu", "cpp", name),
                       shallow=False)


def _group_child(pkg, name, rank, world, q):
    import numpy as np

    if pkg == "port":
        from dmlc_tpu_torch.native.shm_collective import ShmCollective
    else:
        from dmlc_tpu.native.shm_collective import ShmCollective
    try:
        g = ShmCollective(name, rank, world, chunk_kb=4)
        out = {}
        for dtype in (np.float32, np.float64, np.int32, np.int64):
            arr = (np.arange(3001).astype(dtype) % 97) * (rank + 1)
            g.reduce_scatter(arr, "sum")
            g.allgather(arr)
            out[f"rsag_{np.dtype(dtype).name}"] = arr
            for op in ("sum", "max", "min"):
                arr = (np.arange(3001).astype(dtype) % 89) - rank * 3
                g.allreduce(arr, op)
                out[f"{op}_{np.dtype(dtype).name}"] = arr
        b = (np.full(257, rank, np.float64) if rank != 1
             else np.arange(257, dtype=np.float64))
        g.broadcast(b, root=1)
        out["bcast"] = b
        g.close()
        q.put((rank, out))
    except BaseException as e:  # noqa: BLE001 - surfaced by the parent
        q.put((rank, repr(e)))


def _run_group(pkgs, tag):
    ctx = mp.get_context("fork")
    q = ctx.Queue()
    name = f"dmlc-test-tgrp-{os.getpid()}-{tag}"
    world = len(pkgs)
    procs = [ctx.Process(target=_group_child, args=(pkg, name, r, world, q))
             for r, pkg in enumerate(pkgs)]
    for p in procs:
        p.start()
    results = dict(q.get(timeout=90) for _ in range(world))
    for p in procs:
        p.join(30)
    assert not any(p.is_alive() for p in procs)
    for rank, out in results.items():
        assert not isinstance(out, str), (rank, out)
    return results


@pytest.mark.parametrize("pkgs", [
    ("port", "port", "port"), ("port", "jax", "port", "jax"),
    ("jax", "port")], ids=["port3", "mixed4", "mixed2"])
def test_shm_group_every_op_and_dtype(pkgs):
    """Port processes alone and beside JAX processes in one shm group
    (4 KB chunks: many chunks a call): every op and dtype equals the
    numpy fold, and a broadcast from rank 1 reaches every member."""
    assert pshm.available()
    world = len(pkgs)
    results = _run_group(pkgs, "-".join(pkgs))
    scale = world * (world + 1) // 2
    for rank, out in results.items():
        for dtype in ("float32", "float64", "int32", "int64"):
            np.testing.assert_array_equal(
                out[f"rsag_{dtype}"],
                ((np.arange(3001) % 97) * scale).astype(dtype))
            members = [((np.arange(3001).astype(dtype) % 89) - r * 3)
                       for r in range(world)]
            want = {"sum": members[0].copy(), "max": members[0].copy(),
                    "min": members[0].copy()}
            for m in members[1:]:
                want["sum"] = want["sum"] + m
                want["max"] = np.maximum(want["max"], m)
                want["min"] = np.minimum(want["min"], m)
            for op, w in want.items():
                got = out[f"{op}_{dtype}"]
                assert got.dtype == np.dtype(dtype)
                assert got.tobytes() == w.astype(dtype).tobytes(), (op, dtype)
        np.testing.assert_array_equal(out["bcast"],
                                      np.arange(257, dtype=np.float64))


def _abort_child(name, rank, q):
    import numpy as np

    from dmlc_tpu_torch.native.shm_collective import (ShmCollective,
                                                     ShmGroupError)
    try:
        g = ShmCollective(name, rank, 2)
        if rank == 1:
            g.abort()
            g.close()
            q.put((rank, "aborted"))
            return
        try:
            g.allreduce(np.ones(64, np.float32), "sum")
            q.put((rank, "unexpected success"))
        except ShmGroupError:
            q.put((rank, "woke"))
        g.close()
    except BaseException as e:  # noqa: BLE001
        q.put((rank, repr(e)))


def test_abort_wakes_a_blocked_peer():
    ctx = mp.get_context("fork")
    q = ctx.Queue()
    name = f"dmlc-test-tabort-{os.getpid()}"
    procs = [ctx.Process(target=_abort_child, args=(name, r, q))
             for r in range(2)]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    results = dict(q.get(timeout=60) for _ in range(2))
    for p in procs:
        p.join(30)
    assert results == {0: "woke", 1: "aborted"}, results
    assert time.monotonic() - t0 < 30, "abort did not wake the peer"


def test_binding_validates_its_arguments():
    g = object.__new__(pshm.ShmCollective)
    with pytest.raises(ValueError, match="C-contiguous 1-D"):
        g.allreduce(np.ones((2, 2)), "sum")
    with pytest.raises(ValueError, match="C-contiguous 1-D"):
        g.reduce_scatter(np.ones(8)[::2], "sum")
    with pytest.raises(pshm.ShmGroupError, match="unsupported dtype"):
        g._codes(np.ones(2, np.int16), "sum")
    assert pshm.supports_dtype(np.float64)
    assert not pshm.supports_dtype(np.float16)


def test_library_name_follows_sources_and_flags():
    path = pshm.library_path()
    assert path.parent.name == PORT and path.parent.parent.name == "build"
    assert path.name.startswith("dmlc_collective-") and path.suffix == ".so"
    assert pshm.build() == path and path.exists()


# ---------------------------------------------------------------------------
# C consumers against the port's header and library, under its launcher
# ---------------------------------------------------------------------------

def _build_c(tmp_path_factory, src, exe_name):
    lib = pshm.build()
    out = tmp_path_factory.mktemp("cconsumer") / exe_name
    r = subprocess.run(
        ["gcc", "-O2", "-std=c99", "-I", str(pshm.CSRC), src, str(lib),
         "-o", str(out), "-lm", "-lrt", f"-Wl,-rpath,{lib.parent}"],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return str(out)


@pytest.fixture(scope="module")
def gbdt(tmp_path_factory):
    return _build_c(tmp_path_factory,
                    os.path.join(REPO, "examples", "gbdt_allreduce.c"),
                    "gbdt_allreduce")


@pytest.fixture(scope="module")
def kv_ps(tmp_path_factory):
    return _build_c(tmp_path_factory,
                    os.path.join(REPO, "examples", "kv_ps_worker.c"),
                    "kv_ps_worker")


def _submit(args, timeout=180):
    env = os.environ.copy()
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", f"{PORT}.tracker.submit", "--cluster",
         "local", "--host-ip", "127.0.0.1", "--max-attempts", "1", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)
    assert r.returncode == 0, f"stdout={r.stdout}\nstderr={r.stderr}"
    assert "FAIL" not in r.stderr
    return r


def _gbdt_rmse(exe, world):
    r = _submit(["--num-workers", str(world), "--", exe])
    line = next(ln for ln in r.stdout.splitlines()
                if ln.startswith("gbdt rmse="))
    return float(line.split("rmse=")[1].split()[0])


def test_gbdt_allreduce_matches_single_process(gbdt):
    single = _gbdt_rmse(gbdt, 1)
    multi = _gbdt_rmse(gbdt, 4)
    assert single < 0.3, single
    assert abs(multi - single) < 1e-4 * max(single, 1e-9), (single, multi)


def test_kv_parameter_server_under_the_port_launcher(kv_ps):
    r = _submit(["--num-workers", "3", "--num-servers", "2", "--", kv_ps],
                timeout=120)
    for rank in range(3):
        assert f"kv OK rank={rank} workers=3" in r.stdout, r.stdout
