"""Launch backends: start worker/server processes on a cluster (the port
of ``dmlc_tpu/tracker/launch.py``: the same backends, env contract and
``PASS_ENVS``, so either package's launcher starts either package's
workers).

Each backend exposes submit(args) and builds per-task environments from
the DMLC env contract (reference §2.7: DMLC_ROLE, DMLC_TASK_ID,
DMLC_NUM_ATTEMPT, DMLC_JOB_CLUSTER, DMLC_NODE_HOST, tracker URI/PORT,
worker/server counts).  Command construction is factored out of
execution so every backend is unit-testable without a cluster.

The ``tpu-vm`` backend is the YARN ApplicationMaster analog
(yarn/src/.../ApplicationMaster.java:49-687 behavior): per-task attempt
counters, restart budget, failing-host blacklist — mapped onto
preemptible TPU VM slices reached by ssh.
"""

from __future__ import annotations

import logging
import os
import subprocess
import threading
from typing import Callable, Dict, List, Optional, Sequence

from .rendezvous import submit_job
from ..concurrency import make_lock

logger = logging.getLogger("dmlc_tpu_torch.tracker")

# Env vars forwarded to remote tasks (reference ssh.py:26 plus JAX/TPU
# plus every DMLC_* knob workers must see): the JAX package's list, so
# a mixed job forwards the same knobs whichever launcher starts it.  A
# knob a worker reads but the launcher does not forward works locally
# and silently does nothing on ssh/tpu-vm (the gang-uniform DMLC_COLL_*
# cutovers depend on forwarding).  Kept explicit rather than imported:
# the ssh export line is security-sensitive, so what it ships should
# be reviewable here, not computed at launch time.
PASS_ENVS = [
    "OMP_NUM_THREADS", "LD_LIBRARY_PATH", "PYTHONPATH",
    "AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY",
    "GOOGLE_APPLICATION_CREDENTIALS", "JAX_PLATFORMS", "XLA_FLAGS",
    "TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES",
    # -- registry pass_to_workers knobs (config_registry.py order) ----
    "DMLC_INTERFACE", "DMLC_FEED_WORKERS", "DMLC_FEED_DEPTH",
    "DMLC_FEED_AUTOTUNE", "DMLC_FEED_WORKERS_MIN",
    "DMLC_FEED_WORKERS_MAX", "DMLC_FEED_DEPTH_MAX",
    "DMLC_TPU_PARSE_NTHREAD", "DMLC_TPU_DISABLE_NATIVE",
    "DMLC_TPU_DISABLE_MMAP", "DMLC_COLL_ALGO", "DMLC_COLL_BUCKET_MB",
    "DMLC_COLL_RING_MIN_BYTES", "DMLC_COLL_HIER_MIN_BYTES",
    "DMLC_COLL_HIER_GROUPS", "DMLC_COLL_HIER_SETUP_TIMEOUT_S",
    "DMLC_COLL_SHM", "DMLC_COLL_SHM_CHUNK_KB",
    "DMLC_COLL_SHM_JOIN_TIMEOUT_S", "DMLC_COLL_SHM_TIMEOUT_S",
    "DMLC_COLL_OVERLAP", "DMLC_CLIENT_CONNECT_TIMEOUT_S",
    "DMLC_CLIENT_OP_TIMEOUT_S", "DMLC_CLIENT_RETRIES",
    "DMLC_CLIENT_RETRY_BASE_S", "DMLC_ELASTIC", "DMLC_ELASTIC_GRACE_S",
    "DMLC_ELASTIC_RESIZE_TIMEOUT_S", "DMLC_S3_ENDPOINT",
    "DMLC_S3_RETRIES", "DMLC_S3_WRITE_BUFFER_MB", "DMLC_GCS_RETRIES",
    "DMLC_GCS_RETRY_BASE_S", "DMLC_GCS_WRITE_BUFFER_MB",
    "DMLC_AZURE_ENDPOINT", "DMLC_AZURE_RETRIES", "DMLC_AZURE_BLOCK_MB",
    "DMLC_HDFS_USER", "DMLC_HDFS_RETRIES", "DMLC_HDFS_WRITE_BUFFER_MB",
    "DMLC_WEBHDFS_ENDPOINT", "DMLC_WEBHDFS_PORT", "DMLC_HTTP_RETRIES",
    "DMLC_REST_RETRIES", "DMLC_REST_TIMEOUT_S", "DMLC_RETRY_ATTEMPTS",
    "DMLC_RETRY_MAX_S", "DMLC_RETRY_DEADLINE_S",
    "DMLC_RECORDIO_CHECKSUM", "DMLC_INTEGRITY_POLICY",
    "DMLC_INTEGRITY_VERIFY_READS", "DMLC_INTEGRITY_READ_RETRIES",
    "DMLC_SELFHEAL_MAX_SKIPS", "DMLC_SELFHEAL_MAX_ROLLBACKS",
    "DMLC_SELFHEAL_SPIKE_FACTOR", "DMLC_SELFHEAL_WARMUP",
    "DMLC_FAULT_SPEC", "DMLC_TELEMETRY_MAX_SPANS",
    "DMLC_TELEMETRY_MAX_EVENTS", "DMLC_TELEMETRY_SHIP_TRACE",
    "DMLC_TELEMETRY_MAX_BEAT_BYTES", "DMLC_POSTMORTEM_DIR",
    "DMLC_STEP_LEDGER_MAX", "DMLC_PEAK_FLOPS", "DMLC_PEAK_HBM_GBPS",
    "DMLC_COMPUTE_PROFILE", "DMLC_COMPUTE_TRACE_PHASES",
    "DMLC_COMPUTE_STORM_WINDOW_S", "DMLC_COMPUTE_STORM_TRACES",
    "DMLC_TRACE_FLEET", "DMLC_TRACE_EXEMPLARS",
    "DMLC_GOODPUT_MIN_FRACTION", "DMLC_GOODPUT_WINDOW_S",
    "DMLC_GOODPUT_MAX_INTERVALS",
    "DMLC_LOCKCHECK",
    "DMLC_LOCKCHECK_BLOCK_S", "DMLC_RACECHECK",
    "DMLC_RACECHECK_MAX_SITES", "DMLC_FLASH_BH_BLOCK",
    "DMLC_FLASH_BLOCK_Q", "DMLC_FLASH_BLOCK_K",
    "DMLC_FLASH_BWD_BLOCK_Q", "DMLC_FLASH_BWD_BLOCK_K",
]


def _elastic() -> bool:
    from ..base import get_env

    return get_env("DMLC_ELASTIC", False)


_postmortem_scan_lock = make_lock("launch._postmortem_scan_lock")


def collect_postmortems(seen: set, role: str, task_id,
                        log=logger) -> List[str]:
    """Collect postmortem dumps that appeared since the last scan.

    Called after a task attempt fails: any fresh dump in
    ``DMLC_POSTMORTEM_DIR`` is a dead incarnation's flight record — its
    reason, recorded rank, open spans, and event tail are summarized
    into the launcher log (the full JSON stays on disk) and counted as
    ``resilience.postmortems_collected``.  Best-effort: a no-op when no
    directory is configured, and an unreadable dump is reported, not
    fatal.  ``seen`` must be ONE set shared by every task of the job
    (the directory is shared too): the claim under the module lock is
    what keeps concurrent failing tasks from double-counting each
    other's dumps.  Attribution in the log comes from the dump's own
    recorded rank — the scanning task merely noticed it; which rank
    died is the dump's to say."""
    import json as _json

    from .. import telemetry
    from ..telemetry import postmortem

    with _postmortem_scan_lock:
        fresh = [p for p in postmortem.list_dumps() if p not in seen]
        seen.update(fresh)
    for p in fresh:
        summary = ""
        try:
            with open(p) as f:
                doc = _json.load(f)
            open_names = [s.get("name") for s in doc.get("open_spans", [])]
            tail = [e.get("kind") for e in doc.get("events", [])[-5:]]
            summary = (f": rank={doc.get('rank')} "
                       f"reason={doc.get('reason')!r} "
                       f"open_spans={open_names} event_tail={tail}")
        except (OSError, ValueError) as e:
            summary = f" (unreadable: {e})"
        log.warning("postmortem collected (scan after %s %s failed) %s%s",
                    role, task_id, p, summary)
    if fresh:
        telemetry.inc("resilience", "postmortems_collected", len(fresh))
    return fresh


def task_env(base: Dict[str, str], role: str, task_id: Optional[int],
             attempt: int, cluster: str,
             extra: Optional[Dict[str, str]] = None,
             resources: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Per-task env. task_id=None omits DMLC_TASK_ID — required for
    mpi/slurm where one launch command covers many ranks: a shared task
    id would collapse the tracker's job_map rank keying (every worker
    would present jobid "0" and steal each other's rank on recover)."""
    env = dict(base)
    env.update({
        "DMLC_ROLE": role,
        "DMLC_NUM_ATTEMPT": str(attempt),
        "DMLC_JOB_CLUSTER": cluster,
    })
    if task_id is not None:
        env["DMLC_TASK_ID"] = str(task_id)
    if resources:
        env.update(resources)
    if extra:
        env.update(extra)
    return env


def resource_envs(args, role: str) -> Dict[str, str]:
    """DMLC_{WORKER,SERVER}_{CORES,MEMORY_MB} env contract (the reference
    yarn backend sets these, yarn.py:16-118)."""
    if role == "server":
        return {"DMLC_SERVER_CORES": str(args.server_cores),
                "DMLC_SERVER_MEMORY_MB": str(args.server_memory_mb)}
    return {"DMLC_WORKER_CORES": str(args.worker_cores),
            "DMLC_WORKER_MEMORY_MB": str(args.worker_memory_mb)}


def _roles(n_workers: int, n_servers: int):
    return [("server", i) for i in range(n_servers)] + [
        ("worker", i) for i in range(n_workers)
    ]


# ---------------------------------------------------------------------------
# local
# ---------------------------------------------------------------------------

def _await_job(tracker, failures, threads):
    """Wait for tracker completion, aborting early on task failures.

    A failed task never sends 'shutdown', so a blind tracker join would
    hang forever — poll both."""
    import time

    def abort(msg):
        # a lingering PS scheduler child would hold the launcher's
        # stdio pipes open past our exit — kill it before raising
        if tracker is not None and hasattr(tracker, "terminate"):
            tracker.terminate()
        raise RuntimeError(msg)

    while True:
        if failures:
            abort(f"tasks failed: {failures}")
        if tracker is not None and getattr(tracker, "error", None) is not None:
            abort(f"tracker failed: {tracker.error}")
        tracker_done = tracker is None or not tracker.alive()
        if tracker_done and all(not t.is_alive() for t in threads):
            break
        time.sleep(0.05)
    if failures:
        abort(f"tasks failed: {failures}")
    if tracker is not None and getattr(tracker, "error", None) is not None:
        abort(f"tracker failed: {tracker.error}")
    return tracker


def submit_local(args):
    """Threads × subprocess with per-task retry (reference local.py:12-72)."""
    failures = []
    threads = []
    procs: List[subprocess.Popen] = []

    def fun_submit(n_workers, n_servers, envs):
        collected: set = set()  # shared: ONE claim set for the whole job

        def run_task(role, task_id):
            from .. import telemetry

            for attempt in range(args.max_attempts):
                env = os.environ.copy()
                env.update(task_env(envs, role, task_id, attempt, "local",
                                    args.extra_env,
                                    resource_envs(args, role)))
                p = subprocess.Popen(args.command, env=env)
                procs.append(p)
                ret = p.wait()
                if ret == 0:
                    return
                logger.warning("%s %d attempt %d exited %d", role, task_id,
                               attempt, ret)
                # a failed task may have left its flight record behind
                collect_postmortems(collected, role, task_id)
                if attempt + 1 < args.max_attempts:
                    # supervised restart: visible on the tracker's
                    # /metrics as dmlc_resilience_task_restarts
                    telemetry.inc("resilience", "task_restarts")
                    telemetry.record_event("task_restart", role=role,
                                           task_id=task_id,
                                           attempt=attempt, exit=ret)
            telemetry.inc("resilience", "task_budget_exhausted")
            telemetry.record_event("task_budget_exhausted", role=role,
                                   task_id=task_id,
                                   attempts=args.max_attempts)
            if _elastic():
                # the world already resized past this task (or will at
                # the grace window); the survivors carry the job, so a
                # permanently-lost rank is not a job failure
                logger.warning(
                    "%s %d restart budget exhausted; elastic world "
                    "resizes past it and the job continues", role,
                    task_id)
                return
            failures.append((role, task_id, args.max_attempts))

        for role, tid in _roles(n_workers, n_servers):
            t = threading.Thread(target=run_task, args=(role, tid), daemon=True)
            t.start()
            threads.append(t)

    try:
        tracker = submit_job(args.num_workers, args.num_servers, fun_submit,
                             host_ip=args.host_ip or "127.0.0.1",
                             pscmd=_pscmd(args), join=False)
        return _await_job(tracker, failures, threads)
    except Exception:
        # an aborting job must not orphan still-running task processes
        # (e.g. workers blocking on a scheduler that died at startup)
        for p in procs:
            if p.poll() is None:
                p.terminate()
        raise


def _pscmd(args) -> Optional[str]:
    """PS jobs run the user command as the scheduler too (DMLC_ROLE=
    scheduler), the reference local.py/ssh.py pscmd contract."""
    import shlex

    if args.num_servers > 0:
        return shlex.join(args.command)
    return None


# ---------------------------------------------------------------------------
# ssh / tpu-vm shared machinery
# ---------------------------------------------------------------------------

def read_host_file(path: str) -> List[str]:
    hosts = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                hosts.append(line)
    if not hosts:
        raise ValueError(f"no hosts in {path}")
    return hosts


def build_ssh_cmd(host: str, command: Sequence[str], env: Dict[str, str],
                  sync_dst_dir: Optional[str] = None) -> List[str]:
    """One ssh invocation running `command` on `host` with env exported.

    Forwards the task's DMLC_* contract plus the launcher's own PASS_ENVS
    values from os.environ (reference ssh.py:26 behavior)."""
    hostname, _, port = host.partition(":")
    full = {k: os.environ[k] for k in PASS_ENVS if k in os.environ}
    full.update(env)
    exports = "; ".join(
        f"export {k}={v!r}" for k, v in sorted(full.items())
        if k.startswith("DMLC_") or k in PASS_ENVS
    )
    cd = f"cd {sync_dst_dir}; " if sync_dst_dir else ""
    remote = f"{exports}; {cd}{' '.join(command)}"
    cmd = ["ssh", "-o", "StrictHostKeyChecking=no", hostname]
    if port:
        cmd += ["-p", port]
    cmd.append(remote)
    return cmd


class GangScheduler:
    """Task scheduler with attempt budget + host blacklist (YARN-AM analog).

    ``runner(host, role, task_id, env) -> int`` performs one task attempt
    and returns its exit code; injected so tests (and backends) choose
    the transport.  A host accumulating ``blacklist_after`` failures is
    excluded from future placements (ApplicationMaster.java:554 behavior);
    tasks are re-queued until the per-task attempt budget is exhausted.
    """

    def __init__(self, hosts: List[str], runner: Callable,
                 max_attempts: int = 3, blacklist_after: int = 2):
        self.hosts = list(hosts)
        self.runner = runner
        self.max_attempts = max_attempts
        self.blacklist_after = blacklist_after
        self.host_failures: Dict[str, int] = {}
        self.blacklist: set = set()
        self._collected: set = set()  # postmortems: one claim set per job
        self._lock = make_lock("GangScheduler._lock")

    def _pick_host(self, idx: int) -> str:
        with self._lock:
            live = [h for h in self.hosts if h not in self.blacklist]
            if not live:
                raise RuntimeError("all hosts blacklisted")
            return live[idx % len(live)]

    def _pick_host_for(self, role: str, task_id: int, attempt: int) -> str:
        # worker 0 stays on live[0] across retries: its host is exported
        # to the whole job as DMLC_JAX_COORD_URI before placement, so
        # moving it on a transient failure would strand the
        # jax.distributed coordinator address.  (Blacklisting hosts[0]
        # still shifts it — the coordinator URI then goes stale, the one
        # unrecoverable corner of pre-announced coordination.)  Other
        # tasks rotate hosts on retry.
        if role == "worker" and task_id == 0:
            return self._pick_host(0)
        return self._pick_host(task_id + attempt)

    def _record(self, host: str, ok: bool) -> None:
        with self._lock:
            if ok:
                return
            self.host_failures[host] = self.host_failures.get(host, 0) + 1
            if self.host_failures[host] >= self.blacklist_after \
                    and host not in self.blacklist:
                self.blacklist.add(host)
                logger.warning("blacklisted host %s", host)
                from .. import telemetry

                telemetry.inc("resilience", "hosts_blacklisted")

    def run_task(self, role: str, task_id: int, envs: Dict[str, str],
                 cluster: str, extra_env=None) -> None:
        from .. import telemetry

        for attempt in range(self.max_attempts):
            host = self._pick_host_for(role, task_id, attempt)
            env = task_env(envs, role, task_id, attempt, cluster, extra_env)
            env["DMLC_NODE_HOST"] = host
            ret = self.runner(host, role, task_id, env)
            self._record(host, ret == 0)
            if ret == 0:
                return
            logger.warning("%s %d attempt %d on %s exited %d",
                           role, task_id, attempt, host, ret)
            # only finds dumps on a filesystem this process can see
            # (shared FS, or local-transport tests); remote-only dumps
            # stay on the failing host for manual collection
            collect_postmortems(self._collected, role, task_id)
            if _elastic():
                # elastic job: the WORLD survived this task's loss (the
                # tracker shrinks past it at the grace window); the
                # reschedule below is a gang-reschedule of the lost
                # slice — it re-joins as a same-rank readmission inside
                # grace, or as a scale-up generation after eviction,
                # never by restarting the surviving world
                telemetry.inc("elastic", "gang_reschedules")
                telemetry.record_event(
                    "elastic_gang_reschedule", role=role,
                    task_id=task_id, host=host, attempt=attempt,
                    exit=ret)
            if attempt + 1 < self.max_attempts:
                # supervised restart onto a (possibly different) healthy
                # host; surfaces as dmlc_resilience_task_restarts
                telemetry.inc("resilience", "task_restarts")
                telemetry.record_event("task_restart", role=role,
                                       task_id=task_id, attempt=attempt,
                                       host=host, exit=ret)
        telemetry.inc("resilience", "task_budget_exhausted")
        telemetry.record_event("task_budget_exhausted", role=role,
                               task_id=task_id,
                               attempts=self.max_attempts)
        if _elastic():
            # elastic jobs outlive a permanently-lost slice: the world
            # shrank past it at the grace window, survivors keep going
            logger.warning(
                "%s %d restart budget exhausted; elastic world resizes "
                "past it and the job continues", role, task_id)
            return
        raise RuntimeError(
            f"{role} {task_id} failed after {self.max_attempts} attempts")

    def run_all(self, n_workers: int, n_servers: int, envs, cluster,
                extra_env=None) -> None:
        errors = []

        def run(role, tid):
            try:
                self.run_task(role, tid, envs, cluster, extra_env)
            except Exception as e:
                errors.append((role, tid, e))

        threads = [
            threading.Thread(target=run, args=(role, tid), daemon=True)
            for role, tid in _roles(n_workers, n_servers)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise RuntimeError(f"tasks failed: {errors}")


def _ssh_call(cmd: List[str]) -> int:
    """One transport invocation; module-level so tests can fake it."""
    return subprocess.call(cmd)


def _copy_to_host(host: str, paths: Sequence[str], dest: str) -> None:
    """Ship ``paths`` into ``dest/`` on ``host`` (module-level: fakeable).

    The remote dir is created via --rsync-path (portable back to old
    rsync, unlike --mkpath which needs >= 3.2.3)."""
    hostname = host.partition(":")[0]
    subprocess.check_call(
        ["rsync", "-az", f"--rsync-path=mkdir -p {dest!r} && rsync",
         *paths, f"{hostname}:{dest}/"])


def _copy_to_hosts_excluding(hosts: List[str], paths: Sequence[str],
                             dest: str, what: str) -> List[str]:
    """Ship ``paths`` to every host; a failing host is EXCLUDED with a
    warning rather than fatal (host failure is the GangScheduler
    blacklist's job).  Raises only when every host fails."""
    ok = []
    for h in hosts:
        try:
            _copy_to_host(h, paths, dest)
            ok.append(h)
        except Exception as e:  # noqa: BLE001
            logger.warning("%s to %s failed, excluding host: %s", what, h, e)
    if not ok:
        raise RuntimeError(f"{what} failed on every host: {hosts}")
    return ok


def _make_ssh_runner(command: Sequence[str], sync_dst_dir=None):
    def runner(host, role, task_id, env):
        cmd = build_ssh_cmd(host, command, env, sync_dst_dir)
        return _ssh_call(cmd)
    return runner


def _stage_cache(args, hosts: List[str]):
    """Auto file cache (reference opts.py:6-36,110-124): ship command
    files / --files / --archives plus the bootstrap script to a job
    cache dir on every host; the remote command becomes
    ``python3 ./bootstrap.py <rewritten command>`` running from there.

    Returns (remote_command, remote_dir, extra_env, staged_hosts); a
    no-op (original command, --sync-dst-dir, {}, hosts) when nothing
    needs shipping.  Hosts where staging fails are excluded (with a
    warning) rather than aborting — host failure is the GangScheduler
    blacklist's job; only all-hosts-failed raises.
    """
    from .opts import cache_file_set

    fset, rewritten = cache_file_set(args)
    archives = list(getattr(args, "archives", []))
    for a in archives:
        if not os.path.exists(a):
            raise FileNotFoundError(f"--archives {a!r} does not exist")
    if not fset and not archives:
        return list(args.command), args.sync_dst_dir, {}, hosts
    dest = args.sync_dst_dir or "/tmp/dmlc-cache-{}".format(
        args.jobname or os.getpid())
    bootstrap = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "bootstrap.py")
    paths = sorted(fset) + archives + [bootstrap]
    # the cache dir is flat: ANY staged basename collision (files,
    # archives, or the launcher's own bootstrap.py) is a silent clobber
    by_base: Dict[str, str] = {}
    for p in paths:
        base = os.path.basename(p)
        if base in by_base and by_base[base] != p:
            raise ValueError(
                f"staged files {by_base[base]!r} and {p!r} collide on "
                f"basename {base!r} in the flat job cache dir")
        by_base[base] = p
    ok_hosts = _copy_to_hosts_excluding(hosts, paths, dest,
                                        "file-cache staging")
    extra_env = {"DMLC_JOB_CACHE_DIR": dest}
    if archives:
        extra_env["DMLC_JOB_ARCHIVES"] = ":".join(
            os.path.basename(a) for a in archives)
    return (["python3", "./bootstrap.py", "--"] + rewritten, dest,
            extra_env, ok_hosts)


def submit_ssh(args):
    """ssh backend (reference ssh.py:37-86), via GangScheduler for retry."""
    hosts = read_host_file(args.host_file)
    if args.sync_dst_dir:  # whole-workdir sync (reference ssh.py:13-21)
        hosts = _copy_to_hosts_excluding(
            hosts, [os.getcwd() + "/"], args.sync_dst_dir, "workdir sync")
    command, remote_dir, cache_env, hosts = _stage_cache(args, hosts)
    sched = GangScheduler(hosts, _make_ssh_runner(command, remote_dir),
                          max_attempts=args.max_attempts)
    return _submit_gang(args, sched, "ssh", cache_env, coord_host=hosts[0])


def submit_tpu_vm(args):
    """Gang-schedule onto TPU VM slice hosts with preemption-aware retry.

    The TPU-native stand-in for the YARN backend: slice hosts come from
    --host-file (e.g. `gcloud compute tpus tpu-vm list` output); tasks are
    placed round-robin with attempt counters and failing-host blacklist.

    With ``DMLC_ELASTIC=1`` a preempted slice no longer restarts the
    world: the tracker runs elastic resize generations, so while this
    scheduler gang-reschedules the lost tasks onto healthy hosts
    (``dmlc_elastic_gang_reschedules``), the surviving ranks shrink to
    N-1 at the grace window and keep training; the rescheduled tasks
    re-join as a same-rank readmission (inside grace) or a scale-up
    generation (after eviction).  Every resize lands in the tracker's
    event ring and on /metrics as ``dmlc_elastic_*``.
    """
    hosts = read_host_file(args.host_file)
    command, remote_dir, cache_env, hosts = _stage_cache(args, hosts)
    sched = GangScheduler(hosts, _make_ssh_runner(command, remote_dir),
                          max_attempts=args.max_attempts)
    return _submit_gang(args, sched, "tpu-vm", cache_env, coord_host=hosts[0])


def _submit_gang(args, sched: "GangScheduler", cluster: str,
                 cache_env: Optional[Dict[str, str]] = None,
                 coord_host: Optional[str] = None):
    failures = []
    threads = []
    extra = dict(args.extra_env)
    if cache_env:
        extra.update(cache_env)
    if coord_host and "DMLC_JAX_COORD_URI" not in extra:
        # task 0 (attempt 0) lands on hosts[0] (GangScheduler._pick_host),
        # so the jax.distributed coordinator service lives there, not on
        # the tracker machine
        extra["DMLC_JAX_COORD_URI"] = coord_host.partition(":")[0]

    def fun_submit(n_workers, n_servers, envs):
        def run():
            try:
                sched.run_all(n_workers, n_servers, envs, cluster, extra)
            except Exception as e:
                failures.append(e)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        threads.append(t)

    tracker = submit_job(args.num_workers, args.num_servers, fun_submit,
                         host_ip=args.host_ip or "auto",
                         pscmd=_pscmd(args), join=False)
    return _await_job(tracker, failures, threads)


# ---------------------------------------------------------------------------
# mpi / sge / slurm (thin command builders + subprocess)
# ---------------------------------------------------------------------------

def build_mpi_cmd(args, envs: Dict[str, str], n_tasks: int,
                  role: str, mpirun: str = "mpirun",
                  openmpi: bool = True) -> List[str]:
    cmd = [mpirun, "-n", str(n_tasks)]
    if args.host_file:
        cmd += ["--hostfile", args.host_file]
    # task_id=None: one mpirun covers many ranks; per-rank identity comes
    # from the tracker's rank assignment, not the env
    env = task_env(envs, role, None, 0, "mpi", args.extra_env,
                   resource_envs(args, role))
    for k, v in sorted(env.items()):
        if openmpi:
            cmd += ["-x", f"{k}={v}"]
        else:
            cmd += ["-env", k, v]
    return cmd + list(args.command)


def _reap_procs(procs, failures):
    """Wait each Popen; record non-zero exits so _await_job aborts."""
    def wait(p):
        ret = p.wait()
        if ret != 0:
            failures.append((" ".join(p.args[:3]), ret))

    threads = [threading.Thread(target=wait, args=(p,), daemon=True)
               for p in procs]
    for t in threads:
        t.start()
    return threads


def submit_mpi(args):
    failures = []
    threads = []

    def fun_submit(n_workers, n_servers, envs):
        try:
            probe = subprocess.run(["mpirun", "--version"],
                                   capture_output=True, text=True).stdout
        except FileNotFoundError as e:
            raise RuntimeError("mpirun not found on PATH") from e
        openmpi = "Open MPI" in probe
        procs = []
        if n_servers:
            procs.append(subprocess.Popen(
                build_mpi_cmd(args, envs, n_servers, "server",
                              openmpi=openmpi)))
        procs.append(subprocess.Popen(
            build_mpi_cmd(args, envs, n_workers, "worker", openmpi=openmpi)))
        threads.extend(_reap_procs(procs, failures))

    tracker = submit_job(args.num_workers, args.num_servers, fun_submit,
                         host_ip=args.host_ip or "auto",
                         pscmd=_pscmd(args), join=False)
    return _await_job(tracker, failures, threads)


def build_sge_script(args, envs: Dict[str, str], role: str) -> str:
    env = task_env(envs, role, None, 0, "sge", args.extra_env,
                   resource_envs(args, role))
    lines = ["#!/bin/bash", "#$ -S /bin/bash"]
    lines += [f"export {k}={v!r}" for k, v in sorted(env.items())]
    # SGE array task ids are 1-based (reference sge.py runscript)
    lines.append("export DMLC_TASK_ID=$((SGE_TASK_ID - 1))")
    lines.append(" ".join(args.command))
    return "\n".join(lines) + "\n"


def submit_sge(args):
    import tempfile

    def fun_submit(n_workers, n_servers, envs):
        for role, n in (("server", n_servers), ("worker", n_workers)):
            if n == 0:
                continue
            script = build_sge_script(args, envs, role)
            fd, path = tempfile.mkstemp(prefix=f"dmlc_sge_{role}_",
                                        suffix=".sh")
            with os.fdopen(fd, "w") as f:
                f.write(script)
            cmd = ["qsub", "-cwd", "-t", f"1-{n}", "-S", "/bin/bash"]
            if args.jobname:
                cmd += ["-N", args.jobname]
            if args.queue:
                cmd += ["-q", args.queue]
            if args.sge_log_dir:
                cmd += ["-o", args.sge_log_dir, "-e", args.sge_log_dir]
            subprocess.check_call(cmd + [path])

    return submit_job(args.num_workers, args.num_servers, fun_submit,
                      host_ip=args.host_ip or "auto", pscmd=_pscmd(args))


def build_mesos_cmd(args, envs: Dict[str, str], role: str,
                    task_id: int) -> List[str]:
    """One mesos-execute invocation per task (the reference's
    non-pymesos path, tracker/dmlc_tracker/mesos.py:30-57): command is
    run from the current workdir, env ships as a JSON dict, and
    cpus/mem come from the worker/server resource opts."""
    import json
    import shlex
    import uuid

    master = args.mesos_master or os.environ.get("MESOS_MASTER")
    if not master:
        raise RuntimeError("no mesos master: set --mesos-master or "
                           "MESOS_MASTER")
    if ":" not in master:
        master += ":5050"
    env = task_env(envs, role, task_id, 0, "mesos", args.extra_env,
                   resource_envs(args, role))
    # ship the scheduler-discovery whitelist the reference ships
    for k in ("OMP_NUM_THREADS", "KMP_AFFINITY", "LD_LIBRARY_PATH"):
        if k in os.environ:
            env.setdefault(k, os.environ[k])
    if role == "server":
        cores, mem = args.server_cores, args.server_memory_mb
    else:
        cores, mem = args.worker_cores, args.worker_memory_mb
    prog = f"cd {shlex.quote(os.getcwd())} && " \
           + " ".join(shlex.quote(c) for c in args.command)
    return ["mesos-execute", f"--master={master}",
            f"--name=dmlc-{role}-{task_id}-{uuid.uuid4().hex[:8]}",
            f"--command={prog}",
            f"--env={json.dumps({k: str(v) for k, v in env.items()})}",
            f"--resources=cpus:{cores};mem:{mem}"]


def submit_mesos(args):
    """mesos backend: per-task mesos-execute, gated on the binary being
    on PATH (pymesos is not bundled; reference mesos.py falls back to
    mesos-execute the same way)."""
    import shutil

    if shutil.which("mesos-execute") is None:
        raise RuntimeError(
            "mesos-execute not found on PATH (pymesos is not bundled); "
            "install Mesos CLI tools or use --cluster ssh/tpu-vm")
    logger.warning(
        "mesos-execute mode provides no task stdout/stderr here; a failed "
        "task reports only its exit code — check the Mesos agent's task "
        "logs for output")
    failures = []
    threads = []

    def fun_submit(n_workers, n_servers, envs):
        procs = [subprocess.Popen(build_mesos_cmd(args, envs, role, tid),
                                  stdout=subprocess.DEVNULL,
                                  stderr=subprocess.STDOUT)
                 for role, tid in _roles(n_workers, n_servers)]
        threads.extend(_reap_procs(procs, failures))

    tracker = submit_job(args.num_workers, args.num_servers, fun_submit,
                         host_ip=args.host_ip or "auto",
                         pscmd=_pscmd(args), join=False)
    return _await_job(tracker, failures, threads)


def build_slurm_cmd(args, envs: Dict[str, str], role: str,
                    n_tasks: int) -> List[str]:
    cmd = ["srun", "-n", str(n_tasks)]
    nodes = (args.slurm_worker_nodes if role == "worker"
             else args.slurm_server_nodes)
    if nodes:
        cmd += ["-N", str(nodes)]
    if args.jobname:
        cmd += ["--job-name", args.jobname]
    env = task_env(envs, role, None, 0, "slurm", args.extra_env,
                   resource_envs(args, role))
    exports = ",".join(f"{k}={v}" for k, v in sorted(env.items()))
    cmd += [f"--export=ALL,{exports}", "--kill-on-bad-exit=1"]
    return cmd + list(args.command)


def submit_slurm(args):
    """slurm backend — actually routed, unlike reference submit.py:42-53."""
    failures = []
    threads = []

    def fun_submit(n_workers, n_servers, envs):
        procs = []
        if n_servers:
            procs.append(subprocess.Popen(
                build_slurm_cmd(args, envs, "server", n_servers)))
        procs.append(subprocess.Popen(
            build_slurm_cmd(args, envs, "worker", n_workers)))
        threads.extend(_reap_procs(procs, failures))

    tracker = submit_job(args.num_workers, args.num_servers, fun_submit,
                         host_ip=args.host_ip or "auto",
                         pscmd=_pscmd(args), join=False)
    return _await_job(tracker, failures, threads)
