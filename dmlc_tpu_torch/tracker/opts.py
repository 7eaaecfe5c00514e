"""CLI options for dmlc-submit (reference tracker/dmlc_tracker/opts.py;
the port's copy of ``dmlc_tpu/tracker/opts.py``, same flags).

Memory strings accept g/m suffixes like the reference (opts.py:39-57).
The cluster list adds ``tpu-vm`` (gang-scheduling onto TPU VM slices —
the YARN-AM role) and actually exposes ssh/slurm, which the reference
parses but never routes (submit.py:42-53)."""

from __future__ import annotations

import argparse
import os

from ..base import get_env

CLUSTERS = ["local", "ssh", "mpi", "sge", "slurm", "mesos", "yarn", "tpu-vm"]


def parse_memory_mb(text: str) -> int:
    t = text.strip().lower()
    if t.endswith("g"):
        return int(float(t[:-1]) * 1024)
    if t.endswith("m"):
        return int(float(t[:-1]))
    return int(t)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dmlc-submit",
        description="submit a distributed dmlc_tpu_torch job",
    )
    p.add_argument("--cluster",
                   default=get_env("DMLC_SUBMIT_CLUSTER", None, str),
                   choices=CLUSTERS, help="cluster backend")
    p.add_argument("--num-workers", required=True, type=int)
    p.add_argument("--num-servers", default=0, type=int)
    p.add_argument("--worker-cores", default=1, type=int)
    p.add_argument("--server-cores", default=1, type=int)
    p.add_argument("--worker-memory", default="1g")
    p.add_argument("--server-memory", default="1g")
    p.add_argument("--jobname", default=None)
    p.add_argument("--queue", default="default",
                   help="scheduler queue (sge backend only)")
    p.add_argument("--log-level", default="INFO",
                   choices=["INFO", "DEBUG", "WARNING", "ERROR"])
    p.add_argument("--log-file", default=None)
    p.add_argument("--host-ip", default=None,
                   help="tracker bind IP (default: auto-detect)")
    p.add_argument("--host-file", default=None,
                   help="hosts for ssh/mpi/tpu-vm backends, one ip[:port] per line")
    p.add_argument("--sge-log-dir", default=None)
    p.add_argument("--slurm-worker-nodes", default=None, type=int)
    p.add_argument("--slurm-server-nodes", default=None, type=int)
    p.add_argument("--mesos-master", default=None,
                   help="mesos master host[:port]; defaults to "
                        "$MESOS_MASTER (reference mesos.py:97-100)")
    p.add_argument("--sync-dst-dir", default=None,
                   help="rsync the working dir to this path on each host first")
    p.add_argument("--auto-file-cache", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="ship files named in the command to the remote job "
                        "cache dir and rewrite them to ./basename "
                        "(ssh/tpu-vm backends)")
    p.add_argument("--files", action="append", default=[],
                   help="extra files to ship to the job cache dir")
    p.add_argument("--archives", action="append", default=[],
                   help="archives (.zip/.tar[.gz]) shipped and unpacked in "
                        "the job cache dir — python-library shipping")
    p.add_argument("--max-attempts", default=3, type=int,
                   help="per-task attempt budget (DMLC_NUM_ATTEMPT contract)")
    p.add_argument("--max-restarts", default=None, type=int,
                   help="per-task RESTART budget (attempts = restarts + 1); "
                        "overrides --max-attempts when given.  Default: "
                        "--max-attempts 3, i.e. 2 restarts; 0 = fail fast "
                        "on the first crash")
    p.add_argument("--env", action="append", default=[],
                   metavar="KEY=VALUE", help="extra env passed to every task")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="command to run on every task")
    return p


def cache_file_set(args):
    """Files to ship to the execution environment + the rewritten command
    (reference opts.py:6-36): with auto-file-cache on, every command
    token naming an existing file is shipped and rewritten to
    ``./basename``; --files adds extras without rewriting.

    With --sync-dst-dir the whole working tree is already shipped, so
    command rewriting is suppressed (relative paths stay valid there)
    and only --files extras are staged.  A --files path that does not
    exist is an error (a typo surfacing remotely is much harder to
    trace); basename collisions in the flat cache dir are an error too.
    """
    fset = set()
    cmds = []
    auto = (getattr(args, "auto_file_cache", False)
            and not getattr(args, "sync_dst_dir", None))
    if auto:
        for token in args.command:
            if os.path.exists(token):
                fset.add(token)
                cmds.append("./" + os.path.basename(token))
            else:
                cmds.append(token)
    else:
        cmds = list(args.command)
    for fname in getattr(args, "files", []):
        if not os.path.exists(fname):
            raise FileNotFoundError(f"--files {fname!r} does not exist")
        fset.add(fname)
    by_base = {}
    for f in sorted(fset):
        base = os.path.basename(f)
        if base in by_base and by_base[base] != f:
            raise ValueError(
                f"cache files {by_base[base]!r} and {f!r} collide on "
                f"basename {base!r} in the flat job cache dir")
        by_base[base] = f
    return fset, cmds


def get_opts(argv=None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    if args.cluster is None:
        raise SystemExit("--cluster required (or set DMLC_SUBMIT_CLUSTER)")
    if not args.command:
        raise SystemExit("missing command to run")
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]
    if args.max_restarts is not None:
        if args.max_restarts < 0:
            raise SystemExit("--max-restarts must be >= 0")
        args.max_attempts = args.max_restarts + 1
    args.worker_memory_mb = parse_memory_mb(args.worker_memory)
    args.server_memory_mb = parse_memory_mb(args.server_memory)
    extra = {}
    for kv in args.env:
        k, _, v = kv.partition("=")
        extra[k] = v
    args.extra_env = extra
    return args
