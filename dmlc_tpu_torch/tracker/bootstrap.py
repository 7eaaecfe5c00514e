#!/usr/bin/env python3
"""In-container task bootstrap (reference tracker launcher.py:18-77 role).

Runs ON THE REMOTE HOST before the user command, so it is deliberately
standalone — it imports nothing of the package (the launcher ships this
single file into the job cache dir next to the user's binaries).  Duties:

  * enforce the DMLC_JOB_CLUSTER contract;
  * derive DMLC_ROLE for SGE array tasks (task_id < num_worker → worker,
    else server — reference launcher.py:42-47);
  * enter DMLC_JOB_CACHE_DIR (where the submitter staged cached files);
  * unpack DMLC_JOB_ARCHIVES (colon-separated .zip/.tar[.gz] names) into
    the workdir, the python-library shipping mechanism;
  * prepend the workdir to PATH and LD_LIBRARY_PATH so `./prog` and
    shipped .so files resolve;
  * exec the user command, propagating its exit code.

Usage: python3 bootstrap.py [--] command args...
"""

import os
import subprocess
import sys


def unpack_archives(names, workdir):
    import tarfile
    import zipfile

    for name in names:
        path = os.path.join(workdir, name)
        if not os.path.exists(path):
            continue
        if name.endswith(".zip"):
            with zipfile.ZipFile(path) as z:
                z.extractall(workdir)
        elif ".tar" in name or name.endswith(".tgz"):
            with tarfile.open(path) as t:
                try:
                    t.extractall(workdir, filter="data")  # no path traversal
                except TypeError:  # Python < 3.12: no filter= kwarg
                    # manual screen: absolute paths, .. components, and
                    # links pointing outside the cache dir are rejected —
                    # a shipped archive must not escape workdir
                    for m in t.getmembers():
                        parts = m.name.split("/")
                        if (m.name.startswith("/") or ".." in parts
                                or not (m.isfile() or m.isdir())):
                            # allow-list plain files/dirs: links escape
                            # the dir, FIFOs/devices hang later readers
                            raise ValueError(
                                f"unsafe archive member {m.name!r} in "
                                f"{name!r}")
                    t.extractall(workdir)


def main(argv):
    if argv and argv[0] == "--":
        argv = argv[1:]
    if not argv:
        print("Usage: bootstrap.py [--] command args...", file=sys.stderr)
        return 2

    env = os.environ.copy()
    if not env.get("DMLC_JOB_CLUSTER"):
        print("bootstrap: DMLC_JOB_CLUSTER must be set", file=sys.stderr)
        return 2

    if env["DMLC_JOB_CLUSTER"] == "sge" and "DMLC_ROLE" not in env:
        task_id = int(env["DMLC_TASK_ID"])
        n_workers = int(env["DMLC_NUM_WORKER"])
        env["DMLC_ROLE"] = "worker" if task_id < n_workers else "server"

    workdir = env.get("DMLC_JOB_CACHE_DIR")
    if workdir and os.path.isdir(workdir):
        os.chdir(workdir)
    workdir = os.getcwd()

    if env.get("DMLC_JOB_ARCHIVES"):
        unpack_archives(env["DMLC_JOB_ARCHIVES"].split(":"), workdir)

    env["PATH"] = workdir + os.pathsep + env.get("PATH", "")
    ld = env.get("LD_LIBRARY_PATH", "")
    env["LD_LIBRARY_PATH"] = (ld + os.pathsep if ld else "") + workdir

    return subprocess.call(argv, env=env)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
