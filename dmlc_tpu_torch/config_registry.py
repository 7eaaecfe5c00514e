"""The checked-in registry of every ``DMLC_*`` environment knob the port
reads or forwards (the port of ``dmlc_tpu/config_registry.py``).

This module is the single source of truth the port's knob pass
(``analysis/knob_pass.py``) enforces everything against:

  * every literal ``DMLC_*`` env read in the port's package must resolve
    to a :class:`Knob` here (or to :data:`NON_KNOB_TOKENS` for
    reference-analog names that are not environment variables);
  * every knob with ``pass_to_workers=True`` must appear in
    ``tracker/launch.py``'s ``PASS_ENVS`` (that list stays explicit —
    the ssh export path is security-sensitive — but can no longer be
    incomplete);
  * the README knob table between the port's ``KNOB TABLE`` markers is
    generated from here (``python -m dmlc_tpu_torch.analysis
    --write-knob-table``) and the pass fails when it drifts.

Every knob carries the JAX package's type, default, ``ship`` flag and
group, so one environment configures a mixed job of JAX and port
workers alike.  The docs say where the port reads a knob differently:
the kernel-tile, native-fallback and mmap knobs are forwarded by the
port's launcher for the JAX workers of a mixed job and read by no port
module.

``pass_to_workers`` means: a value set on the *submit host* must reach
every worker for the job to behave as configured — gang-uniform
algorithm cutovers (``DMLC_COLL_*``), data-plane policies
(``DMLC_INTEGRITY_*``), chaos specs.  Identity variables the launcher
computes per task (``DMLC_ROLE``, ``DMLC_TASK_ID``, ...) are False:
``task_env()`` sets them explicitly.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

__all__ = ["Knob", "KNOBS", "NON_KNOB_TOKENS", "get", "names",
           "pass_env_names", "render_markdown_table"]


class Knob(NamedTuple):
    name: str
    type: type
    default: object        # None = unset/off
    doc: str               # one line, used verbatim in the README table
    pass_to_workers: bool = False
    group: str = "misc"


def _k(name: str, ty: type, default, doc: str, *, ship: bool = False,
       group: str = "misc") -> Knob:
    return Knob(name, ty, default, doc, ship, group)


KNOBS: Tuple[Knob, ...] = (
    # ---- job identity: computed per task by the launcher/tracker ------
    _k("DMLC_ROLE", str, None,
       "task role (worker/server/scheduler); set by the launcher",
       group="identity"),
    _k("DMLC_TASK_ID", str, None,
       "task id within the job; the tracker's rank-recovery key",
       group="identity"),
    _k("DMLC_RANK", str, None,
       "rank hint for log prefixes when DMLC_TASK_ID is absent",
       group="identity"),
    _k("DMLC_NUM_ATTEMPT", str, None,
       "restart attempt counter; set by the launcher", group="identity"),
    _k("DMLC_JOB_CLUSTER", str, None,
       "launch backend name (local/ssh/tpu-vm/...); set by the launcher",
       group="identity"),
    _k("DMLC_NODE_HOST", str, None,
       "host a gang-scheduled task was placed on; set by the launcher",
       group="identity"),
    _k("DMLC_NUM_WORKER", str, None,
       "world worker count; set by the tracker", group="identity"),
    _k("DMLC_NUM_SERVER", str, None,
       "PS server count; set by the tracker", group="identity"),
    _k("DMLC_TRACKER_URI", str, None,
       "tracker host; set by the tracker for its workers",
       group="identity"),
    _k("DMLC_TRACKER_PORT", str, None,
       "tracker rendezvous port; set by the tracker", group="identity"),
    _k("DMLC_PS_ROOT_URI", str, None,
       "PS scheduler host; set by PSTracker", group="identity"),
    _k("DMLC_PS_ROOT_PORT", str, None,
       "PS scheduler port; set by PSTracker", group="identity"),
    _k("DMLC_JAX_COORD_URI", str, None,
       "distributed coordinator host (rank 0's machine; "
       "parallel.initialize_distributed on the port)",
       group="identity"),
    _k("DMLC_JAX_COORD_PORT", str, None,
       "distributed coordinator port (tracker-assigned free port)",
       group="identity"),
    _k("DMLC_JOB_CACHE_DIR", str, None,
       "staged file-cache dir on remote hosts; set by the launcher",
       group="identity"),
    _k("DMLC_JOB_ARCHIVES", str, None,
       "colon-separated archive names bootstrap.py unpacks",
       group="identity"),
    _k("DMLC_WORKER_CORES", str, None,
       "worker cpu resource contract; set by the launcher",
       group="identity"),
    _k("DMLC_WORKER_MEMORY_MB", str, None,
       "worker memory resource contract; set by the launcher",
       group="identity"),
    _k("DMLC_SERVER_CORES", str, None,
       "server cpu resource contract; set by the launcher",
       group="identity"),
    _k("DMLC_SERVER_MEMORY_MB", str, None,
       "server memory resource contract; set by the launcher",
       group="identity"),
    _k("DMLC_SUBMIT_CLUSTER", str, None,
       "default --cluster for dmlc-submit (submit host only)",
       group="identity"),
    _k("DMLC_INTERFACE", str, None,
       "network interface hint, forwarded to remote tasks", ship=True,
       group="identity"),
    _k("DMLC_RECOVER_KILL_FLAG", str, None,
       "recover_worker example: path of its die-once flag file",
       group="identity"),

    # ---- feed / data plane --------------------------------------------
    _k("DMLC_FEED_WORKERS", int, None,
       "parser worker threads (default min(4, n_cpus), capped at "
       "n_parts); worker w owns partitions p = w mod W", ship=True,
       group="feed"),
    _k("DMLC_FEED_DEPTH", int, 2,
       "staging buffers in the feed pool = pipeline depth "
       "(2 = double buffering)", ship=True, group="feed"),
    _k("DMLC_FEED_AUTOTUNE", bool, False,
       "1 = ledger-driven auto-tuning: adapt feed workers/depth to the "
       "step ledger's feed-wait fraction at epoch boundaries", ship=True,
       group="feed"),
    _k("DMLC_FEED_WORKERS_MIN", int, 1,
       "autotune lower bound on parser worker threads", ship=True,
       group="feed"),
    _k("DMLC_FEED_WORKERS_MAX", int, 0,
       "autotune upper bound on parser worker threads (0 = cpu count, "
       "always capped at n_parts)", ship=True, group="feed"),
    _k("DMLC_FEED_DEPTH_MAX", int, 4,
       "autotune upper bound on staging-pool depth", ship=True,
       group="feed"),
    _k("DMLC_TPU_PARSE_NTHREAD", int, None,
       "native parse fanout threads (default: cpu count)", ship=True,
       group="feed"),
    _k("DMLC_TPU_DISABLE_NATIVE", bool, False,
       "1 = skip the C extension, use pure-Python fallbacks (JAX "
       "workers only: the port's native core has no fallback)", ship=True,
       group="feed"),
    _k("DMLC_TPU_DISABLE_MMAP", bool, False,
       "1 = disable mmap'd chunk reads in input_split (JAX workers "
       "only: not read by the port)", ship=True,
       group="feed"),

    # ---- host collectives ---------------------------------------------
    _k("DMLC_COLL_ALGO", str, "auto",
       "tree|ring|hier pin the allreduce algorithm; auto picks by "
       "payload size.  Must be gang-uniform", ship=True, group="coll"),
    _k("DMLC_COLL_BUCKET_MB", float, 4.0,
       "gradient bucket size for the overlapped allreduce", ship=True,
       group="coll"),
    _k("DMLC_COLL_RING_MIN_BYTES", int, 1 << 20,
       "payload size where auto cuts over tree -> flat ring; 0 always "
       "rings, negative disables the ring", ship=True, group="coll"),
    _k("DMLC_COLL_HIER_MIN_BYTES", int, 64 << 10,
       "payload size where auto prefers the hierarchical shm+ring "
       "path; negative disables hier in auto", ship=True, group="coll"),
    _k("DMLC_COLL_HIER_GROUPS", int, 0,
       "override host auto-grouping with fixed rank blocks of this "
       "size (0 = auto)", ship=True, group="coll"),
    _k("DMLC_COLL_HIER_SETUP_TIMEOUT_S", float, 20.0,
       "bound on hier setup (job-map poll, leader dial/accept)",
       ship=True, group="coll"),
    _k("DMLC_COLL_SHM", int, 1,
       "0 disables the shm leg (auto then skips hier); the C-ABI "
       "DmlcComm transport honors the same switch", ship=True,
       group="coll"),
    _k("DMLC_COLL_SHM_CHUNK_KB", int, 4096,
       "shm slot size for the DmlcComm transport and the hier shm "
       "group, capped to free /dev/shm", ship=True, group="coll"),
    _k("DMLC_COLL_SHM_JOIN_TIMEOUT_S", int, 60,
       "shm group attach bound (C side)", ship=True, group="coll"),
    _k("DMLC_COLL_SHM_TIMEOUT_S", int, 300,
       "in-collective shm wait bound (C side); abort wakes peers "
       "earlier", ship=True, group="coll"),
    _k("DMLC_COLL_OVERLAP", bool, True,
       "elastic LM example: 0 falls back to the serial "
       "single-allreduce gradient path (example default on; "
       "make_train_step(overlap='auto') overlaps only when set to 1)",
       ship=True, group="coll"),

    # ---- tracker client / elasticity ----------------------------------
    _k("DMLC_CLIENT_CONNECT_TIMEOUT_S", float, 15.0,
       "worker-side connect timeout (tracker + peer dials); 0 disables",
       ship=True, group="client"),
    _k("DMLC_CLIENT_OP_TIMEOUT_S", float, 300.0,
       "worker-side socket op timeout; a dead peer raises instead of "
       "hanging; 0 disables", ship=True, group="client"),
    _k("DMLC_CLIENT_RETRIES", int, 5,
       "reconnect attempts for tracker dials and brokering rounds",
       ship=True, group="client"),
    _k("DMLC_CLIENT_RETRY_BASE_S", float, 0.3,
       "base backoff between tracker dial attempts", ship=True,
       group="client"),
    _k("DMLC_TRACKER_TIMEOUT", float, 300.0,
       "tracker-side per-connection recv timeout mid-brokering; "
       "0 disables", group="tracker"),
    _k("DMLC_TRACKER_MISS_WINDOW_S", float, 0.0,
       "declare a rank dead after this many heartbeat-less seconds "
       "(0 = detector off)", group="tracker"),
    _k("DMLC_TRACKER_METRICS_PORT", int, None,
       "tracker HTTP port for /metrics + /healthz + /trace + "
       "/anomalies (0 = ephemeral)", group="tracker"),
    _k("DMLC_ELASTIC", bool, False,
       "1 = elastic world: resize generations instead of world "
       "restarts", ship=True, group="tracker"),
    _k("DMLC_ELASTIC_GRACE_S", float, 5.0,
       "seconds a dead rank may stay dead before eviction opens a "
       "shrink generation", ship=True, group="tracker"),
    _k("DMLC_ELASTIC_RESIZE_TIMEOUT_S", float, 120.0,
       "bound on one client resize() re-rendezvous, settle-wait "
       "included", ship=True, group="tracker"),

    # ---- io backends ---------------------------------------------------
    _k("DMLC_S3_ENDPOINT", str, None,
       "S3-compatible endpoint override", ship=True, group="io"),
    _k("DMLC_S3_RETRIES", int, 4,
       "S3 attempt budget (shared RetryPolicy loop)", ship=True,
       group="io"),
    _k("DMLC_S3_WRITE_BUFFER_MB", int, 64,
       "S3 multipart part size", ship=True, group="io"),
    _k("DMLC_GCS_RETRIES", int, 5,
       "GCS attempt budget", ship=True, group="io"),
    _k("DMLC_GCS_RETRY_BASE_S", float, 0.5,
       "GCS base backoff", ship=True, group="io"),
    _k("DMLC_GCS_WRITE_BUFFER_MB", int, 64,
       "GCS resumable-upload chunk size", ship=True, group="io"),
    _k("DMLC_AZURE_ENDPOINT", str, None,
       "Azure blob endpoint override", ship=True, group="io"),
    _k("DMLC_AZURE_RETRIES", int, 4,
       "Azure attempt budget", ship=True, group="io"),
    _k("DMLC_AZURE_BLOCK_MB", int, 64,
       "Azure block-blob block size", ship=True, group="io"),
    _k("DMLC_HDFS_USER", str, None,
       "WebHDFS user.name (default: $USER)", ship=True, group="io"),
    _k("DMLC_HDFS_RETRIES", int, 4,
       "WebHDFS attempt budget (idempotent ops only)", ship=True,
       group="io"),
    _k("DMLC_HDFS_WRITE_BUFFER_MB", int, 64,
       "WebHDFS append buffer size", ship=True, group="io"),
    _k("DMLC_WEBHDFS_ENDPOINT", str, None,
       "explicit WebHDFS endpoint (scheme://host:port)", ship=True,
       group="io"),
    _k("DMLC_WEBHDFS_PORT", str, "9870",
       "WebHDFS port when only hdfs://host paths are given", ship=True,
       group="io"),
    _k("DMLC_HTTP_RETRIES", int, 3,
       "plain-HTTP ranged-read attempt budget", ship=True, group="io"),
    _k("DMLC_REST_RETRIES", int, 4,
       "shared REST transport attempt budget", ship=True, group="io"),
    _k("DMLC_REST_TIMEOUT_S", float, 60.0,
       "per-request timeout on the shared REST transport", ship=True,
       group="io"),
    _k("DMLC_RETRY_ATTEMPTS", int, 4,
       "default attempt budget for RetryPolicy.from_env call sites "
       "without their own knob", ship=True, group="io"),
    _k("DMLC_RETRY_MAX_S", float, 30.0,
       "global retry backoff ceiling", ship=True, group="io"),
    _k("DMLC_RETRY_DEADLINE_S", float, None,
       "overall per-call retry deadline (unset = none)", ship=True,
       group="io"),

    # ---- data integrity / self-heal -----------------------------------
    _k("DMLC_RECORDIO_CHECKSUM", bool, False,
       "1 = RecordIOWriter emits the CRC32C record variant", ship=True,
       group="integrity"),
    _k("DMLC_INTEGRITY_POLICY", str, "raise",
       "raise|skip|quarantine: what a reader does with a corrupt "
       "record", ship=True, group="integrity"),
    _k("DMLC_INTEGRITY_VERIFY_READS", bool, False,
       "1 = double-fetch + compare ranged remote reads", ship=True,
       group="integrity"),
    _k("DMLC_INTEGRITY_READ_RETRIES", int, 4,
       "re-fetch budget for verified ranged reads", ship=True,
       group="integrity"),
    _k("DMLC_SELFHEAL_MAX_SKIPS", int, 3,
       "consecutive skipped steps before rollback-and-replay",
       ship=True, group="integrity"),
    _k("DMLC_SELFHEAL_MAX_ROLLBACKS", int, 2,
       "rollbacks before the guard aborts with a postmortem", ship=True,
       group="integrity"),
    _k("DMLC_SELFHEAL_SPIKE_FACTOR", float, 10.0,
       "loss spike gate vs EWMA baseline", ship=True, group="integrity"),
    _k("DMLC_SELFHEAL_WARMUP", int, 10,
       "steps before the spike gate arms", ship=True, group="integrity"),
    _k("DMLC_FAULT_SPEC", str, None,
       "deterministic fault injection spec "
       "(site[@key:value...]=action[:arg][:count];...)", ship=True,
       group="integrity"),

    # ---- telemetry / observability ------------------------------------
    _k("DMLC_TELEMETRY_MAX_SPANS", int, 8192,
       "per-process span ring capacity", ship=True, group="telemetry"),
    _k("DMLC_TELEMETRY_MAX_EVENTS", int, 2048,
       "per-process event ring capacity", ship=True, group="telemetry"),
    _k("DMLC_TELEMETRY_SHIP_TRACE", bool, True,
       "ship spans + steps + clock samples with heartbeats (0 = "
       "metrics-only beats)", ship=True, group="telemetry"),
    _k("DMLC_TELEMETRY_MAX_BEAT_BYTES", int, 262144,
       "heartbeat payload cap; over-budget beats drop oldest "
       "spans/steps", ship=True, group="telemetry"),
    _k("DMLC_TRACE_MAX_SPANS_PER_RANK", int, 4096,
       "tracker-side per-rank span store capacity", group="telemetry"),
    _k("DMLC_POSTMORTEM_DIR", str, None,
       "directory for crash postmortem dumps (unset = off)", ship=True,
       group="telemetry"),
    _k("DMLC_STEP_LEDGER_MAX", int, 1024,
       "per-process step record ring capacity", ship=True,
       group="telemetry"),
    _k("DMLC_PEAK_FLOPS", float, None,
       "peak FLOP/s for MFU accounting; overrides the device-kind "
       "table", ship=True, group="telemetry"),
    _k("DMLC_WATCHDOG_K", float, 4.0,
       "straggler band: k*MAD above the cluster median",
       group="telemetry"),
    _k("DMLC_WATCHDOG_WINDOW", int, 5,
       "consecutive offending steps before an anomaly flag fires",
       group="telemetry"),
    _k("DMLC_WATCHDOG_REGRESSION", float, 0.5,
       "regression flag when fast EWMA > (1+r) * slow baseline",
       group="telemetry"),
    _k("DMLC_WATCHDOG_FEED_FRAC", float, 0.5,
       "feed-stall flag when feed-wait fraction EWMA exceeds this",
       group="telemetry"),
    _k("DMLC_WATCHDOG_GOODPUT_FRAC", float, 0.5,
       "collapse flag when goodput EWMA < this * its peak EWMA",
       group="telemetry"),
    _k("DMLC_PEAK_HBM_GBPS", float, None,
       "peak HBM bandwidth in GB/s for roofline accounting; overrides "
       "the device-kind table", ship=True, group="telemetry"),
    _k("DMLC_COMPUTE_PROFILE", bool, True,
       "compute observability: profiled_site compile ledger, "
       "counted cost/roofline accounting, HBM gauges (counter/gauge "
       "cost only); 0 = plain calls, zero per-call overhead", ship=True,
       group="telemetry"),
    _k("DMLC_COMPUTE_TRACE_PHASES", bool, False,
       "deep device-phase tracing: profiler TraceAnnotation scopes "
       "around decode/train phases (profile-capture runs only)",
       ship=True, group="telemetry"),
    _k("DMLC_COMPUTE_STORM_WINDOW_S", float, 60.0,
       "recompile-storm sliding window (seconds)", ship=True,
       group="telemetry"),
    _k("DMLC_COMPUTE_STORM_TRACES", int, 4,
       "jit traces within the storm window that flag a jit site as a "
       "recompile storm", ship=True, group="telemetry"),
    _k("DMLC_TRACE_FLEET", bool, False,
       "fleet-wide distributed tracing: X-DMLC-Trace propagation, "
       "per-attempt router spans, cross-process trace assembly "
       "(0 = zero per-request overhead)", ship=True, group="telemetry"),
    _k("DMLC_TRACE_FLEET_MAX_SPANS", int, 16384,
       "router-side per-source span store capacity for fleet trace "
       "assembly", group="telemetry"),
    _k("DMLC_TRACE_MAX_DECISIONS", int, 1024,
       "cluster-brain decision audit ring capacity (GET /decisions)",
       group="telemetry"),
    _k("DMLC_TRACE_EXEMPLARS", int, 16,
       "exemplar trace ids retained per latency signal / SLO "
       "objective", ship=True, group="telemetry"),
    _k("DMLC_GOODPUT_MIN_FRACTION", float, 0.5,
       "watchdog effective-goodput collapse gate: flag a rank whose "
       "windowed effective (wall-clock) tokens/s drops below this "
       "fraction of its in-step tokens/s", ship=True, group="telemetry"),
    _k("DMLC_GOODPUT_WINDOW_S", float, 60.0,
       "goodput ledger window for the effective-vs-in-step tokens/s "
       "comparison the collapse detector judges", ship=True,
       group="telemetry"),
    _k("DMLC_GOODPUT_MAX_INTERVALS", int, 64,
       "closed badput intervals retained per rank for incident "
       "forensics (GET /incidents)", ship=True, group="telemetry"),

    # ---- lock-order watchdog ------------------------------------------
    _k("DMLC_LOCKCHECK", bool, False,
       "1 = instrument concurrency.make_lock locks: record the dynamic "
       "lock-acquisition graph, flag order inversions and "
       "held-while-blocked waits", ship=True, group="lockcheck"),
    _k("DMLC_LOCKCHECK_BLOCK_S", float, 1.0,
       "lockcheck: an acquire blocking longer than this while the "
       "thread holds another lock is flagged held-while-blocked",
       ship=True, group="lockcheck"),
    _k("DMLC_RACECHECK", bool, False,
       "1 = lockcheck plus attribute->lock pairing capture: every "
       "CheckedLock acquire site is recorded and cross-checked against "
       "the static guarded-by analysis (analysis.race_pass)",
       ship=True, group="lockcheck"),
    _k("DMLC_RACECHECK_MAX_SITES", int, 4096,
       "racecheck: bound on distinct acquire sites recorded (memory "
       "guard for very long runs)", ship=True, group="lockcheck"),

    # ---- kernels -------------------------------------------------------
    _k("DMLC_FLASH_BH_BLOCK", int, 0,
       "flash attention: batch*heads grid block (0 = auto); "
       "JAX workers only: the port's CUDA kernels fix their tiles",
       ship=True,
       group="kernel"),
    _k("DMLC_FLASH_BLOCK_Q", int, 0,
       "flash attention fwd: query block (0 = auto); "
       "JAX workers only: the port's CUDA kernels fix their tiles",
       ship=True,
       group="kernel"),
    _k("DMLC_FLASH_BLOCK_K", int, 0,
       "flash attention fwd: key block (0 = auto); "
       "JAX workers only: the port's CUDA kernels fix their tiles",
       ship=True,
       group="kernel"),
    _k("DMLC_FLASH_BWD_BLOCK_Q", int, 0,
       "flash attention bwd: query block (0 = auto); "
       "JAX workers only: the port's CUDA kernels fix their tiles",
       ship=True,
       group="kernel"),
    _k("DMLC_FLASH_BWD_BLOCK_K", int, 0,
       "flash attention bwd: key block (0 = auto); "
       "JAX workers only: the port's CUDA kernels fix their tiles",
       ship=True,
       group="kernel"),

    # ---- serving -------------------------------------------------------
    _k("DMLC_SERVE_HOST", str, "127.0.0.1",
       "serving endpoint bind host (python -m "
       "dmlc_tpu_torch.serving.serve)", group="serving"),
    _k("DMLC_SERVE_PORT", int, 8901,
       "serving endpoint bind port", group="serving"),
    _k("DMLC_SERVE_KV_BLOCKS", int, 256,
       "total KV blocks in the paged pool", group="serving"),
    _k("DMLC_SERVE_KV_BLOCK_SIZE", int, 16,
       "tokens per KV block (paging granule and prefill bucket)",
       group="serving"),
    _k("DMLC_SERVE_MAX_ACTIVE", int, 8,
       "max sequences decoding concurrently (decode batch shape)",
       group="serving"),
    _k("DMLC_SERVE_QUEUE_DEPTH", int, 64,
       "admission slots (waiting + active); full -> 429",
       group="serving"),
    _k("DMLC_SERVE_ADMIT_TIMEOUT_S", float, 2.0,
       "how long a submit may wait for a slot before 429",
       group="serving"),
    _k("DMLC_SERVE_MAX_TOKENS", int, 64,
       "default per-request generation cap", group="serving"),
    _k("DMLC_SERVE_DRAIN_S", float, 30.0,
       "graceful drain bound: finish in-flight decodes within this",
       group="serving"),
    _k("DMLC_SERVE_REQUEST_LEDGER_MAX", int, 2048,
       "finished requests retained in the request ledger ring",
       group="serving"),
    _k("DMLC_SERVE_TRACE_REQUESTS", bool, True,
       "draw per-request lifecycle rows on the Chrome /trace",
       group="serving"),
    _k("DMLC_SERVE_DEDUPE_MAX", int, 512,
       "finished request_ids retained in the idempotency dedupe ring",
       group="serving"),
    _k("DMLC_SERVE_CRASH_REQUEUE_MAX", int, 2,
       "engine-iteration crashes a request may survive by requeue "
       "(recompute-resume) before failing with reason crash",
       group="serving"),
    _k("DMLC_SERVE_MAX_DECODE_SIGS", int, 64,
       "distinct decode jit signatures (context-length buckets) the "
       "engine may compile before erroring (recompile-storm guard)",
       group="serving"),
    _k("DMLC_SERVE_PRIORITY_LEVELS", int, 3,
       "priority classes a /generate request may carry (ints "
       "0..levels-1; batch/standard/interactive name the defaults)",
       group="serving"),
    _k("DMLC_SERVE_PRIORITY_DEFAULT", int, 1,
       "priority assigned to a request that carries none",
       group="serving"),
    _k("DMLC_SERVE_PAGED_ATTN", str, "auto",
       "decode fast path: attend the paged KV pool in place "
       "(auto|on|off; auto falls back to the dense gather only when "
       "the mesh shards the gathered view)", group="serving"),
    _k("DMLC_SERVE_SPEC_K", int, 0,
       "speculative decoding: draft tokens per verify window "
       "(0 = off; greedy output stays bit-identical)", group="serving"),
    _k("DMLC_SERVE_SPEC_MIN_CTX", int, 4,
       "min context tokens before the n-gram drafter proposes",
       group="serving"),

    # ---- fleet router (serving/router.py) -----------------------------
    _k("DMLC_ROUTER_HOST", str, "127.0.0.1",
       "router endpoint bind host (python -m "
       "dmlc_tpu_torch.serving.route)", group="router"),
    _k("DMLC_ROUTER_PORT", int, 8900,
       "router endpoint bind port", group="router"),
    _k("DMLC_ROUTER_REPLICAS", str, None,
       "comma-separated replica base URLs (the router module's "
       "default)",
       group="router"),
    _k("DMLC_ROUTER_HEALTH_INTERVAL_S", float, 1.0,
       "seconds between health/load sweeps over the replica fleet",
       group="router"),
    _k("DMLC_ROUTER_PROBE_TIMEOUT_S", float, 2.0,
       "per-replica /healthz probe timeout", group="router"),
    _k("DMLC_ROUTER_PROBE_BASE_S", float, 0.5,
       "circuit-breaker re-probe backoff base after a replica is "
       "marked down (doubles per consecutive failure)", group="router"),
    _k("DMLC_ROUTER_PROBE_MAX_S", float, 15.0,
       "circuit-breaker re-probe backoff ceiling", group="router"),
    _k("DMLC_ROUTER_RETRIES", int, 3,
       "max re-dispatches per client request (each to a replica not "
       "yet tried for it)", group="router"),
    _k("DMLC_ROUTER_DISPATCH_TIMEOUT_S", float, 120.0,
       "one dispatch's HTTP timeout (must exceed the longest "
       "generation)", group="router"),
    _k("DMLC_ROUTER_REQUEST_TIMEOUT_S", float, 300.0,
       "total per-client-request deadline across retries and hedges",
       group="router"),
    _k("DMLC_ROUTER_HEDGE_AFTER_P99_MULT", float, 0.0,
       "hedge a dispatch outliving this multiple of the router's "
       "observed p99 latency on a second replica (0 = hedging off)",
       group="router"),

    # ---- tenant fairness (serving/router.py TenantGovernor) -----------
    _k("DMLC_TENANT_RATE", float, 0.0,
       "per-weight-unit tenant admission rate in req/s; <= 0 means "
       "accounting-only (per-tenant metrics, never a 429)",
       group="tenant"),
    _k("DMLC_TENANT_BURST_S", float, 10.0,
       "token-bucket depth in seconds of a tenant's own fill rate",
       group="tenant"),
    _k("DMLC_TENANT_WEIGHTS", str, None,
       "per-tenant weights, e.g. paid=4,free=1 (unlisted tenants get "
       "the default weight)", group="tenant"),
    _k("DMLC_TENANT_DEFAULT_WEIGHT", float, 1.0,
       "weight for tenants not named in DMLC_TENANT_WEIGHTS",
       group="tenant"),
    _k("DMLC_TENANT_MAX", int, 64,
       "distinct tenants tracked before new ones fold into the "
       "overflow pseudo-tenant (label-cardinality bound)",
       group="tenant"),

    # ---- fleet autoscaler (fleet/autoscaler.py) -----------------------
    _k("DMLC_AUTOSCALE_INTERVAL_S", float, 2.0,
       "autoscaler control-loop tick interval", group="fleet"),
    _k("DMLC_AUTOSCALE_HIGH_WATER", float, 0.8,
       "aggregate fleet utilization at/above this counts toward "
       "scale-up", group="fleet"),
    _k("DMLC_AUTOSCALE_LOW_WATER", float, 0.3,
       "aggregate fleet utilization at/below this counts toward "
       "scale-down", group="fleet"),
    _k("DMLC_AUTOSCALE_HYSTERESIS", int, 3,
       "consecutive over/under-water ticks required before acting",
       group="fleet"),
    _k("DMLC_AUTOSCALE_COOLDOWN_S", float, 30.0,
       "minimum seconds between two scale actions", group="fleet"),
    _k("DMLC_AUTOSCALE_MIN_REPLICAS", int, 1,
       "never scale the fleet below this replica count", group="fleet"),
    _k("DMLC_AUTOSCALE_MAX_REPLICAS", int, 4,
       "never scale the fleet above this replica count", group="fleet"),

    # ---- serving SLOs (telemetry.slo) ---------------------------------
    _k("DMLC_SLO_TTFT_P99_S", float, None,
       "TTFT p99 objective in seconds (unset = objective disabled)",
       group="slo"),
    _k("DMLC_SLO_TBT_P99_S", float, None,
       "time-between-tokens p99 objective in seconds (unset = off)",
       group="slo"),
    _k("DMLC_SLO_ERROR_RATE", float, None,
       "request error-rate objective, 0..1 (unset = off)", group="slo"),
    _k("DMLC_SLO_FAST_WINDOW_S", float, 60.0,
       "fast burn-rate window (detection latency)", group="slo"),
    _k("DMLC_SLO_SLOW_WINDOW_S", float, 300.0,
       "slow burn-rate window (blip suppression)", group="slo"),
    _k("DMLC_SLO_FAST_BURN", float, 14.4,
       "burn-rate threshold over the fast window", group="slo"),
    _k("DMLC_SLO_SLOW_BURN", float, 6.0,
       "burn-rate threshold over the slow window", group="slo"),
)

#: ``DMLC_``-prefixed names that are NOT environment knobs — reference
#: C-macro/ABI analogs that appear in docstrings and constant tables.
NON_KNOB_TOKENS = frozenset({
    "DMLC_DECLARE_FIELD", "DMLC_REGISTER_DATA_PARSER",
    "DMLC_REGISTRY_ENABLE", "DMLC_REGISTRY_FILE_TAG",
    "DMLC_LOG_FATAL_THROW", "DMLC_USE_X",
    "DMLC_F32", "DMLC_F64", "DMLC_I32", "DMLC_I64",
    "DMLC_SUM", "DMLC_MAX", "DMLC_MIN",
    # reference-repo C preprocessor defines
    "DMLC_USE_HDFS", "DMLC_USE_S3", "DMLC_USE_AZURE",
})

_BY_NAME: Dict[str, Knob] = {k.name: k for k in KNOBS}
if len(_BY_NAME) != len(KNOBS):  # duplicate registration is a bug
    raise RuntimeError("duplicate knob names in config_registry.KNOBS")

_GROUP_TITLES = (
    ("identity", "Job identity & launcher contract"),
    ("feed", "Feed / data plane"),
    ("coll", "Host collectives"),
    ("client", "Tracker client"),
    ("tracker", "Tracker & elasticity"),
    ("io", "Remote filesystems & retries"),
    ("integrity", "Data integrity & self-healing"),
    ("telemetry", "Telemetry & observability"),
    ("lockcheck", "Lock-order watchdog"),
    ("kernel", "Kernels"),
    ("serving", "Serving"),
    ("router", "Fleet router"),
    ("tenant", "Tenant fairness"),
    ("fleet", "Fleet autoscaler"),
    ("slo", "Serving SLOs"),
    ("misc", "Misc"),
)


def get(name: str) -> Optional[Knob]:
    return _BY_NAME.get(name)


def names() -> List[str]:
    return [k.name for k in KNOBS]


def pass_env_names() -> List[str]:
    """Knobs the launcher must forward to workers (PASS_ENVS check)."""
    return [k.name for k in KNOBS if k.pass_to_workers]


def _default_str(knob: Knob) -> str:
    if knob.default is None:
        return "unset"
    if knob.type is bool:
        return "1" if knob.default else "0"
    return str(knob.default)


def render_markdown_table() -> str:
    """The generated README knob reference (one table per group).

    Regenerate with ``python scripts/dmlc_check.py --write-knob-table``;
    the knob pass fails CI when the README block differs from this."""
    out = []
    for group, title in _GROUP_TITLES:
        knobs = [k for k in KNOBS if k.group == group]
        if not knobs:
            continue
        out.append(f"**{title}**")
        out.append("")
        out.append("| knob | type | default | to workers | purpose |")
        out.append("|---|---|---|---|---|")
        for k in knobs:
            ship = "yes" if k.pass_to_workers else "-"
            out.append(f"| `{k.name}` | {k.type.__name__} | "
                       f"{_default_str(k)} | {ship} | {k.doc} |")
        out.append("")
    return "\n".join(out).rstrip() + "\n"
