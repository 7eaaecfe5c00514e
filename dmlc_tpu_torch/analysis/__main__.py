"""dmlc-check over the port: run the static-analysis suite (the port of
``scripts/dmlc_check.py``).

  style        unused imports, bare except, mutable defaults, whitespace
  metrics      every emittable dmlc_* family is registered
  concurrency  blocking-under-lock, static lock-graph cycles,
               non-daemon threads nobody joins
  knobs        every DMLC_* env read resolves against the port's
               config_registry.py; raw os.environ reads are banned in
               the package; PASS_ENVS + the README knob table complete
  contracts    swallowed WorldResized/CorruptRecord/EngineDraining/
               AlreadyFinished, sockets without timeouts, typo'd
               DMLC_FAULT_SPEC sites
  races        guarded-by classification of threaded-class state:
               mixed locked/unlocked access, divergent guards, leaked
               guarded container refs, annotation hygiene

Usage (from the repo root):
  python -m dmlc_tpu_torch.analysis [paths...]    # all passes
  python -m dmlc_tpu_torch.analysis --passes knobs,contracts
  python -m dmlc_tpu_torch.analysis --changed     # git-diff-scoped run
  python -m dmlc_tpu_torch.analysis --list        # show passes/checks
  python -m dmlc_tpu_torch.analysis --write-knob-table  # regenerate

With no paths the run covers ``core.DEFAULT_ROOTS``: the port's
package, the root scripts that drive it on the card, and
``tests/test_torch_*.py``.  ``--changed`` restricts the index to files
touched vs HEAD (staged, unstaged, and untracked); cross-file
invariants that need files outside the diff are checked only as far as
the partial index reaches.

Suppress one finding with an inline comment on (or directly above) the
offending line::

    something_noisy()  # dmlc-check: disable=<check-id> -- why

Suppressions are counted in the summary so they stay visible.  Exit 0
clean, 1 with findings, 2 on bad arguments, 3 over ``--budget-s``.
"""

from __future__ import annotations

import argparse
import fnmatch
import os
import subprocess
import sys
import time
from typing import List, Optional

from . import ALL_PASSES, run_passes
from .core import (DEFAULT_ROOTS, PACKAGE, RepoIndex, _py_shebang,
                   default_paths, repo_root)

REPO = repo_root()


def write_knob_table() -> int:
    from .. import config_registry
    from .knob_pass import readme_with_table

    path = os.path.join(REPO, "README.md")
    with open(path, encoding="utf-8") as f:
        src = f.read()
    out = readme_with_table(src, config_registry.render_markdown_table())
    if out is None:
        print("README.md: the port's knob-table markers not found",
              file=sys.stderr)
        return 1
    if out != src:
        with open(path, "w", encoding="utf-8") as f:
            f.write(out)
        print("README.md: knob table regenerated", file=sys.stderr)
    else:
        print("README.md: knob table already current", file=sys.stderr)
    return 0


def _in_roots(rel: str) -> bool:
    for r in DEFAULT_ROOTS:
        if set(r) & set("*?["):
            if fnmatch.fnmatch(rel, r):
                return True
        elif rel == r or rel.startswith(r + "/"):
            return True
    return False


def changed_paths() -> Optional[List[str]]:
    """Repo files touched vs HEAD (staged + unstaged + untracked),
    filtered to the default check surface; None when git fails."""
    out = set()
    for cmd in (["git", "diff", "--name-only", "HEAD"],
                ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            text = subprocess.run(
                cmd, cwd=REPO, capture_output=True, text=True,
                timeout=30, check=True).stdout
        except (OSError, subprocess.SubprocessError) as e:
            print(f"--changed: {' '.join(cmd)} failed ({e}); "
                  f"falling back to the full sweep", file=sys.stderr)
            return None
        out.update(line.strip() for line in text.splitlines()
                   if line.strip())
    keep = []
    for rel in sorted(out):
        full = os.path.join(REPO, rel)
        if not _in_roots(rel) or not os.path.isfile(full):
            continue
        # .py files and extensionless python-shebang executables only
        if rel.endswith(".py") or (not os.path.splitext(rel)[1]
                                   and _py_shebang(full)):
            keep.append(rel)
    return keep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog=f"python -m {PACKAGE}.analysis",
        description="repo-invariant static-analysis suite over the port")
    ap.add_argument("paths", nargs="*", help="files/dirs to check "
                    "(default: the port's whole surface)")
    ap.add_argument("--passes", default=None,
                    help="comma-separated subset of pass names")
    ap.add_argument("--changed", action="store_true",
                    help="check only files changed vs git HEAD "
                         "(incl. staged + untracked); exits 0 when "
                         "nothing relevant changed")
    ap.add_argument("--budget-s", type=float, default=None,
                    help="fail (exit 3) when the run exceeds this "
                         "many seconds")
    ap.add_argument("--list", action="store_true",
                    help="list passes and their check ids")
    ap.add_argument("--write-knob-table", action="store_true",
                    help="regenerate the port's README knob table from "
                         "config_registry.py and exit")
    args = ap.parse_args(argv)

    if args.list:
        for cls in ALL_PASSES:
            print(f"{cls.name}: {', '.join(cls.checks)}")
        return 0
    if args.write_knob_table:
        return write_knob_table()

    passes = [cls() for cls in ALL_PASSES]
    if args.passes:
        wanted = {p.strip() for p in args.passes.split(",") if p.strip()}
        unknown = wanted - {p.name for p in passes}
        if unknown:
            print(f"unknown passes: {sorted(unknown)}", file=sys.stderr)
            return 2
        passes = [p for p in passes if p.name in wanted]

    t0 = time.monotonic()
    roots = args.paths or None
    if args.changed:
        if args.paths:
            print("--changed and explicit paths are exclusive",
                  file=sys.stderr)
            return 2
        roots = changed_paths()
        if roots is not None and not roots:
            print("dmlc-check: no relevant files changed vs HEAD",
                  file=sys.stderr)
            return 0
    index = RepoIndex(default_paths(roots, REPO), REPO)
    findings, suppressed = run_passes(index, passes)
    for f in findings:
        print(f)
    by_check = {}
    for s in suppressed:
        by_check[s.check] = by_check.get(s.check, 0) + 1
    supp = ", ".join(f"{k}={v}" for k, v in sorted(by_check.items()))
    elapsed = time.monotonic() - t0
    print(f"dmlc-check: {len(index.files)} files, "
          f"{len(passes)} passes, {len(findings)} findings, "
          f"{len(suppressed)} suppressed"
          + (f" ({supp})" if supp else "")
          + f" in {elapsed:.1f}s", file=sys.stderr)
    if findings:
        return 1
    if args.budget_s is not None and elapsed > args.budget_s:
        print(f"dmlc-check: runtime {elapsed:.1f}s exceeded the "
              f"--budget-s {args.budget_s:g}s ceiling", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
