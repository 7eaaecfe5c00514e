"""dmlc-submit dispatcher (reference tracker/dmlc_tracker/submit.py; the
port's copy of ``dmlc_tpu/tracker/submit.py``):
``python -m dmlc_tpu_torch.tracker.submit --cluster local --num-workers N
-- <command>``.

Routes every cluster backend — including ssh and slurm, which the
reference parses but never dispatches (submit.py:42-53)."""

from __future__ import annotations

import logging
import sys

from . import launch
from .opts import get_opts


def _submit_yarn(args):
    raise SystemExit(
        "yarn backend is not supported in the TPU rebuild; use --cluster "
        "tpu-vm for gang-scheduled slices (the YARN-AM role) or ssh/slurm"
    )


DISPATCH = {
    "local": launch.submit_local,
    "ssh": launch.submit_ssh,
    "mpi": launch.submit_mpi,
    "sge": launch.submit_sge,
    "slurm": launch.submit_slurm,
    "mesos": launch.submit_mesos,
    "tpu-vm": launch.submit_tpu_vm,
    "yarn": _submit_yarn,
}


def main(argv=None):
    args = get_opts(argv)
    handlers = None
    if args.log_file:
        handlers = [logging.FileHandler(args.log_file),
                    logging.StreamHandler()]
    logging.basicConfig(
        level=getattr(logging, args.log_level),
        format="%(asctime)s %(levelname)s %(message)s",
        handlers=handlers,
    )
    return DISPATCH[args.cluster](args)


if __name__ == "__main__":
    main(sys.argv[1:])
