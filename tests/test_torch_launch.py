"""The port's launcher against the JAX package's: CLI options, the cluster
commands, the bootstrap shipped as a lone file, the dispatcher,
retries and the PS role, and the port's distributed LibSVM/CSV examples
under the port's launcher against the JAX examples under
``bin/dmlc-submit`` on the same file (``--device cpu``)."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from dmlc_tpu.tracker import launch as jlaunch
from dmlc_tpu.tracker import opts as jopts
from dmlc_tpu_torch.tracker import launch as plaunch
from dmlc_tpu_torch.tracker import opts as popts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = plaunch.__name__.split(".")[0]


def _penv(**extra):
    env = os.environ.copy()
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _port_submit(args, timeout=240, **env):
    return subprocess.run(
        [sys.executable, "-m", f"{PORT}.tracker.submit", "--cluster",
         "local", "--host-ip", "127.0.0.1", *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO,
        env=_penv(**env))


@pytest.mark.parametrize("argv", [
    ["--cluster", "local", "--num-workers", "3", "--worker-memory", "2g",
     "--env", "FOO=bar", "--", "python", "x.py", "--flag"],
    ["--cluster", "ssh", "--num-workers", "2", "--num-servers", "1",
     "--host-file", "h.txt", "--max-restarts", "0", "--files", "a",
     "--files", "b", "--no-auto-file-cache", "python", "w.py"],
    ["--cluster", "slurm", "--num-workers", "8", "--slurm-worker-nodes",
     "2", "--jobname", "j", "--server-memory", "512m", "--log-level",
     "DEBUG", "--", "srun-me"],
    ["--cluster", "tpu-vm", "--num-workers", "4", "--archives", "lib.zip",
     "--sync-dst-dir", "/d", "--max-attempts", "5", "--", "a", "--", "b"],
])
def test_get_opts_namespaces_equal_jax(argv):
    assert vars(popts.get_opts(argv)) == vars(jopts.get_opts(argv))
    assert popts.parse_memory_mb("3g") == jopts.parse_memory_mb("3g")
    assert popts.CLUSTERS == jopts.CLUSTERS


def test_get_opts_errors_equal_jax(monkeypatch):
    monkeypatch.delenv("DMLC_SUBMIT_CLUSTER", raising=False)
    for argv in (["--num-workers", "1", "x"],
                 ["--cluster", "local", "--num-workers", "1"],
                 ["--cluster", "local", "--num-workers", "1",
                  "--max-restarts", "-1", "x"]):
        with pytest.raises(SystemExit) as pe:
            popts.get_opts(argv)
        with pytest.raises(SystemExit) as je:
            jopts.get_opts(argv)
        assert str(pe.value) == str(je.value)


def _launch_args():
    return SimpleNamespace(
        host_file="hosts", extra_env={"FOO": "1"},
        command=["python", "w.py", "--x"], queue="q", sge_log_dir="/logs",
        slurm_worker_nodes=2, slurm_server_nodes=None, sync_dst_dir=None,
        jobname="j1", worker_cores=2, server_cores=1,
        worker_memory_mb=1024, server_memory_mb=512, mesos_master="m:5050",
        auto_file_cache=True, files=[], archives=[])


def test_cluster_commands_equal_jax(monkeypatch):
    import uuid

    monkeypatch.setattr(uuid, "uuid4",
                        lambda: uuid.UUID("12345678" * 4))
    monkeypatch.setenv("OMP_NUM_THREADS", "3")
    monkeypatch.setenv("DMLC_COLL_ALGO", "hier")
    args = _launch_args()
    envs = {"DMLC_TRACKER_URI": "10.0.0.1", "DMLC_TRACKER_PORT": "9091",
            "DMLC_NUM_WORKER": "4", "DMLC_NUM_SERVER": "1"}
    assert plaunch.PASS_ENVS == jlaunch.PASS_ENVS
    for role in ("worker", "server"):
        for openmpi in (True, False):
            assert plaunch.build_mpi_cmd(args, envs, 4, role,
                                         openmpi=openmpi) == \
                jlaunch.build_mpi_cmd(args, envs, 4, role, openmpi=openmpi)
        assert plaunch.build_slurm_cmd(args, envs, role, 4) == \
            jlaunch.build_slurm_cmd(args, envs, role, 4)
        assert plaunch.build_sge_script(args, envs, role) == \
            jlaunch.build_sge_script(args, envs, role)
        assert plaunch.build_mesos_cmd(args, envs, role, 2) == \
            jlaunch.build_mesos_cmd(args, envs, role, 2)
        env = plaunch.task_env(envs, role, 1, 2, "ssh", args.extra_env,
                               plaunch.resource_envs(args, role))
        assert env == jlaunch.task_env(envs, role, 1, 2, "ssh",
                                       args.extra_env,
                                       jlaunch.resource_envs(args, role))
        for host, sync in (("h1:2222", None), ("h2", "/work")):
            assert plaunch.build_ssh_cmd(host, args.command, env, sync) == \
                jlaunch.build_ssh_cmd(host, args.command, env, sync)


def test_stage_cache_equal_jax_but_for_the_bootstrap(tmp_path, monkeypatch):
    """Auto file cache: the same files shipped, the same rewritten
    command and env; only the bootstrap's own path differs (each
    launcher ships its package's copy)."""
    (tmp_path / "worker.py").write_text("print('hi')\n")
    (tmp_path / "lib.zip").write_bytes(b"")
    monkeypatch.chdir(tmp_path)
    shipped = {}

    def fake_copy(tag):
        def copy(host, paths, dest):
            shipped.setdefault(tag, []).append((host, list(paths), dest))
        return copy

    monkeypatch.setattr(plaunch, "_copy_to_host", fake_copy("port"))
    monkeypatch.setattr(jlaunch, "_copy_to_host", fake_copy("jax"))
    argv = ["--cluster", "ssh", "--num-workers", "2", "--host-file", "h",
            "--jobname", "jj", "--archives", "lib.zip", "--", "python",
            "worker.py", "3"]
    p = plaunch._stage_cache(popts.get_opts(argv), ["h1", "h2"])
    j = jlaunch._stage_cache(jopts.get_opts(argv), ["h1", "h2"])
    assert p == j
    assert p[0] == ["python3", "./bootstrap.py", "--", "python",
                    "./worker.py", "3"]
    for (ph, pp, pd), (jh, jp, jd) in zip(shipped["port"], shipped["jax"]):
        assert (ph, pd, pp[:-1]) == (jh, jd, jp[:-1])
        assert pp[-1].endswith(os.path.join(PORT, "tracker", "bootstrap.py"))
        assert jp[-1].endswith(os.path.join("dmlc_tpu", "tracker",
                                            "bootstrap.py"))


def test_bootstrap_runs_as_a_lone_file(tmp_path):
    """The launcher ships bootstrap.py alone: copied to a directory where
    the package cannot be imported, it imports only the standard
    library, unpacks the shipped archive, enters the cache dir and runs
    the command."""
    import zipfile

    from dmlc_tpu_torch.tracker import bootstrap

    lone = tmp_path / "ship" / "bootstrap.py"
    lone.parent.mkdir()
    shutil.copy(bootstrap.__file__, lone)
    tree = ast.parse(lone.read_text())
    mods = {a.name.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    assert mods <= set(sys.stdlib_module_names), mods
    assert not any(isinstance(n, ast.ImportFrom) and n.level
                   for n in ast.walk(tree))

    cache = tmp_path / "cache"
    cache.mkdir()
    with zipfile.ZipFile(cache / "lib.zip", "w") as z:
        z.writestr("shipped_lib/mod.py", "VALUE = 7\n")
    (cache / "probe.py").write_text(
        "import os, sys\n"
        "sys.path.insert(0, '.')\n"
        "from shipped_lib.mod import VALUE\n"
        "assert VALUE == 7\n"
        "assert os.getcwd() == os.environ['DMLC_JOB_CACHE_DIR']\n"
        "assert os.environ['LD_LIBRARY_PATH'].endswith(os.getcwd())\n"
        "assert os.environ['DMLC_ROLE'] == 'server'\n"
        "print('bootstrap-ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update({"DMLC_JOB_CLUSTER": "sge", "DMLC_TASK_ID": "3",
                "DMLC_NUM_WORKER": "2", "DMLC_JOB_CACHE_DIR": str(cache),
                "DMLC_JOB_ARCHIVES": "lib.zip"})
    r = subprocess.run([sys.executable, "-I", str(lone), "--",
                        sys.executable, "probe.py"], cwd=tmp_path,
                       capture_output=True, text=True, env=env, timeout=60)
    assert r.returncode == 0, r.stderr
    assert "bootstrap-ok" in r.stdout
    env.pop("DMLC_JOB_CLUSTER")
    r = subprocess.run([sys.executable, "-I", str(lone), "true"],
                       capture_output=True, text=True, env=env, timeout=60)
    assert r.returncode == 2 and "DMLC_JOB_CLUSTER" in r.stderr


def test_bootstrap_refuses_traversal_archive(tmp_path):
    import io
    import tarfile

    from dmlc_tpu_torch.tracker import bootstrap

    cache = tmp_path / "cache"
    cache.mkdir()
    with tarfile.open(cache / "evil.tar", "w") as t:
        info = tarfile.TarInfo("../escape.txt")
        data = b"pwned"
        info.size = len(data)
        t.addfile(info, io.BytesIO(data))
    with pytest.raises(Exception):
        bootstrap.unpack_archives(["evil.tar"], str(cache))
    assert not (tmp_path / "escape.txt").exists()


def test_dispatcher_routes_every_cluster():
    from dmlc_tpu.tracker import submit as jsubmit
    from dmlc_tpu_torch.tracker import submit as psubmit

    assert sorted(psubmit.DISPATCH) == sorted(jsubmit.DISPATCH)
    assert sorted(psubmit.DISPATCH) == sorted(popts.CLUSTERS)
    for name, fn in psubmit.DISPATCH.items():
        if name != "yarn":
            assert fn is getattr(plaunch, fn.__name__)
            assert fn.__name__ == jsubmit.DISPATCH[name].__name__
    with pytest.raises(SystemExit, match="yarn backend"):
        psubmit.DISPATCH["yarn"](None)


def test_local_retry_then_fail_counts_restarts():
    from dmlc_tpu_torch import telemetry

    before = telemetry.counters_snapshot().get("resilience", {})
    args = popts.get_opts([
        "--cluster", "local", "--num-workers", "1", "--host-ip",
        "127.0.0.1", "--max-attempts", "2", "--", sys.executable, "-c",
        "exit(1)"])
    with pytest.raises(RuntimeError, match="tasks failed"):
        plaunch.submit_local(args)
    after = telemetry.counters_snapshot()["resilience"]
    assert after["task_restarts"] - before.get("task_restarts", 0) == 1
    assert after["task_budget_exhausted"] - \
        before.get("task_budget_exhausted", 0) == 1


class _FakeRunner:
    def __init__(self, bad_hosts):
        self.bad_hosts = set(bad_hosts)
        self.calls = []

    def __call__(self, host, role, task_id, env):
        self.calls.append((host, role, task_id,
                           int(env["DMLC_NUM_ATTEMPT"])))
        return 1 if host in self.bad_hosts else 0


def test_gang_scheduler_places_and_blacklists_as_jax():
    envs = {"DMLC_TRACKER_URI": "x", "DMLC_TRACKER_PORT": "1"}
    out = []
    for mod in (plaunch, jlaunch):
        runner = _FakeRunner(bad_hosts=["bad"])
        sched = mod.GangScheduler(["bad", "good", "ok"], runner,
                                  max_attempts=3, blacklist_after=2)
        for tid in range(4):
            sched.run_task("worker", tid, envs, "tpu-vm")
        out.append((runner.calls, sched.blacklist, sched.host_failures))
    assert out[0] == out[1]
    assert "bad" in out[0][1]
    runner = _FakeRunner(bad_hosts=["h0", "h1"])
    sched = plaunch.GangScheduler(["h0", "h1"], runner, max_attempts=2,
                                  blacklist_after=99)
    with pytest.raises(RuntimeError, match="failed after 2 attempts"):
        sched.run_task("worker", 0, {}, "tpu-vm")


PS_PROG = '''
import os, socket, sys, time

role = os.environ["DMLC_ROLE"]
uri = os.environ["DMLC_PS_ROOT_URI"]
port = int(os.environ["DMLC_PS_ROOT_PORT"])
n = int(os.environ["DMLC_NUM_WORKER"]) + int(os.environ["DMLC_NUM_SERVER"])
if role == "scheduler":
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((uri, port))
    s.listen(n)
    for _ in range(n):
        c, _ = s.accept()
        c.sendall(b"k")
        c.close()
else:
    assert role in ("worker", "server"), role
    assert "DMLC_TASK_ID" in os.environ
    for _ in range(200):  # scheduler may not be up yet
        try:
            c = socket.create_connection((uri, port), 2)
            break
        except OSError:
            time.sleep(0.1)
    else:
        sys.exit(3)
    assert c.recv(1) == b"k"
'''


def test_ps_role_job(tmp_path):
    """--num-servers > 0: the port's PSTracker runs the scheduler (the
    user command with DMLC_ROLE=scheduler) and every worker and server
    reaches it through DMLC_PS_ROOT_URI/PORT; a scheduler that dies at
    start aborts the job."""
    prog = tmp_path / "ps_prog.py"
    prog.write_text(PS_PROG)
    args = popts.get_opts([
        "--cluster", "local", "--num-workers", "2", "--num-servers", "1",
        "--host-ip", "127.0.0.1", "--", sys.executable, str(prog)])
    plaunch.submit_local(args)
    bad = tmp_path / "ps_bad.py"
    bad.write_text("import os, sys, time\n"
                   "if os.environ['DMLC_ROLE'] == 'scheduler':\n"
                   "    sys.exit(7)\n"
                   "time.sleep(60)\n")
    args = popts.get_opts([
        "--cluster", "local", "--num-workers", "1", "--num-servers", "1",
        "--host-ip", "127.0.0.1", "--max-attempts", "1", "--",
        sys.executable, str(bad)])
    with pytest.raises(RuntimeError, match="tracker failed"):
        plaunch.submit_local(args)


def test_coordinator_port_handed_out_apart_from_the_tracker():
    from dmlc_tpu_torch.tracker import rendezvous

    seen = {}

    def fun_submit(n_workers, n_servers, envs):
        seen.update(envs)

    tracker = rendezvous.submit_job(1, 0, fun_submit, host_ip="127.0.0.1",
                                    join=False)
    try:
        assert seen["DMLC_JAX_COORD_URI"] == "127.0.0.1"
        assert seen["DMLC_JAX_COORD_PORT"] != seen["DMLC_TRACKER_PORT"]
        assert seen["DMLC_NUM_WORKER"] == "1"
    finally:
        tracker.close()


MIXED_WORKER = '''
import os, runpy, sys
if int(os.environ["DMLC_TASK_ID"]) % 2:
    runpy.run_path(os.path.join({repo!r}, "examples", "allreduce_worker.py"),
                   run_name="__main__")
else:
    runpy.run_module("{port}.examples.allreduce_worker", run_name="__main__")
'''


@pytest.mark.parametrize("launcher", ["port", "jax"])
def test_jax_and_port_workers_share_one_job(tmp_path, launcher):
    """Odd tasks run the JAX package's allreduce worker, even tasks the
    port's: one rendezvous, one allreduce, under either launcher."""
    prog = tmp_path / "mixed.py"
    prog.write_text(MIXED_WORKER.format(repo=REPO, port=PORT))
    argv = ["--num-workers", "4", "--max-attempts", "1", "--",
            sys.executable, str(prog)]
    if launcher == "port":
        r = _port_submit(argv)
    else:
        r = subprocess.run(
            [sys.executable, os.path.join(REPO, "bin", "dmlc-submit"),
             "--cluster", "local", "--host-ip", "127.0.0.1", *argv],
            capture_output=True, text=True, timeout=240, env=_penv())
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stderr.count("allreduce OK -> 10.0") == 4, r.stderr[-3000:]


def test_killed_worker_recovers_under_the_port_launcher(tmp_path):
    flag = tmp_path / "kill.flag"
    r = _port_submit(["--num-workers", "2", "--max-attempts", "2", "--env",
                      f"DMLC_RECOVER_KILL_FLAG={flag}", "--",
                      sys.executable, "-m",
                      f"{PORT}.examples.recover_worker"])
    assert r.returncode == 0, r.stderr[-3000:]
    assert flag.exists(), "the worker was never killed"
    assert r.stderr.count("recovered allreduce OK") == 2, r.stderr[-3000:]


def test_allreduce_bench_under_the_port_launcher():
    """The bench's tree/ring/hier sweep, the overlap pass under the step
    ledger, and the tensor pass held equal to the numpy pass."""
    r = _port_submit(["--num-workers", "3", "--max-attempts", "1", "--",
                      sys.executable, "-m",
                      f"{PORT}.examples.allreduce_worker", "bench",
                      str(2 << 20), "2", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [json.loads(ln) for ln in r.stdout.splitlines()
             if ln.startswith("{")]
    ops = [d["op"] for d in lines]
    for algo in ("tree", "ring", "hier"):
        assert ops.count(f"host_allreduce_{algo}") == 3
    ov = next(d for d in lines if d["op"] == "host_allreduce_overlap")
    assert ov["world"] == 3 and len(ov["bucket_timings"]) == 1
    assert ov["sync_exposed_s"] > 0
    tens = next(d for d in lines
                if d["op"] == "host_allreduce_overlap_tensors")
    assert tens["equal_to_numpy"] is True and tens["device"] == "cpu"


# ---------------------------------------------------------------------------
# the distributed examples against the JAX examples
# ---------------------------------------------------------------------------

def _libsvm_file(path):
    rng = np.random.default_rng(0)
    lines = []
    for _ in range(1200):
        x = rng.normal(size=6)
        y = int(x @ [1.0, -2.0, 0.5, 1.5, 0.0, -1.0] > 0)
        feats = " ".join(f"{j}:{x[j]:.3f}" for j in range(6) if j != 4)
        lines.append(f"{y} {feats}")
    path.write_text("\n".join(lines) + "\n")


def _csv_file(path):
    rng = np.random.default_rng(1)
    X = rng.normal(size=(1500, 4))
    y = X @ [1.0, -2.0, 0.5, 1.5]
    with open(path, "w") as f:
        for yi, xi in zip(y, X):
            f.write(",".join([f"{yi:.4f}"] + [f"{v:.4f}" for v in xi])
                    + "\n")


def _epoch_values(stderr, word):
    out = {}
    for m in re.finditer(rf"rank (\d+): epoch (\d+) {word} ([0-9.]+)",
                         stderr):
        out[(int(m.group(1)), int(m.group(2)))] = float(m.group(3))
    return out


def _final_lines(stderr):
    return {int(m.group(1)): json.loads(m.group(2)) for m in
            re.finditer(r"final rank (\d+): (\{.*\})", stderr)}


@pytest.mark.parametrize("example,word,make", [
    ("train_libsvm", "loss", _libsvm_file), ("train_csv", "mse", _csv_file)])
def test_examples_match_jax_examples(tmp_path, example, word, make):
    """Two workers each, same file: every rank's epoch loss from the
    port (unrounded, from its final line) lies within 1e-5 relative of
    the JAX example's printed value, give or take that value's 4-decimal
    rounding; the printed lines agree; both ranks end on one weight."""
    data = tmp_path / f"data.{example}"
    make(data)
    port = _port_submit(["--num-workers", "2", "--max-attempts", "1", "--",
                         sys.executable, "-m", f"{PORT}.examples.{example}",
                         str(data), "3", "--device", "cpu"])
    assert port.returncode == 0, port.stderr[-3000:]
    jax = subprocess.run(
        [sys.executable, os.path.join(REPO, "bin", "dmlc-submit"),
         "--cluster", "local", "--num-workers", "2", "--max-attempts", "1",
         "--host-ip", "127.0.0.1", "--", sys.executable,
         os.path.join(REPO, "examples", f"{example}.py"), str(data), "3"],
        capture_output=True, text=True, timeout=240, env=_penv())
    assert jax.returncode == 0, jax.stderr[-3000:]
    want = _epoch_values(jax.stderr, word)
    printed = _epoch_values(port.stderr, word)
    final = _final_lines(port.stderr)
    assert sorted(want) == sorted(printed) == \
        [(r, e) for r in range(2) for e in range(3)]
    for (rank, epoch), j in want.items():
        got = final[rank]["losses"][epoch]
        assert abs(got - j) <= 1e-5 * abs(j) + 0.5e-4, (rank, epoch, got, j)
        assert abs(printed[(rank, epoch)] - j) <= 1.01e-4
    assert want[(0, 2)] < want[(0, 0)]
    assert final[0]["sha256"] == final[1]["sha256"]
    assert final[0]["allreduce_algos"] == {"tree": 3 * final[0]["steps"]}
