"""Fault-tolerant worker (the port of ``examples/recover_worker.py``):
rides out a peer's death via tracker `recover`.

The worker whose DMLC_RECOVER_KILL_FLAG file does not exist yet and
whose rank is 1 kills itself mid-job (after rendezvous, before any
collective) — simulating a preempted host.  The launcher's per-task
retry restarts it; the restarted process gets its old rank back through
the tracker's jobid map, while the surviving ranks catch the dropped
link as an OSError and re-admit the newcomer with `recover` — the
reference's rabit restart story (tracker.py cmd='recover'), end to end.

Run under the launcher (needs >= 2 attempts so the killed task returns):
    python -m dmlc_tpu_torch.tracker.submit --cluster local \
        --num-workers 2 --max-attempts 2 \
        --env DMLC_RECOVER_KILL_FLAG=/tmp/kill.flag \
        -- python -m dmlc_tpu_torch.examples.recover_worker
"""

import os

import numpy as np

from ..base import check, get_env
from ..tracker.client import TrackerClient


def main():
    flag = get_env("DMLC_RECOVER_KILL_FLAG", "")
    check(flag, "recover_worker needs DMLC_RECOVER_KILL_FLAG")
    client = TrackerClient()
    client.start()
    if client.rank == 1 and not os.path.exists(flag):
        with open(flag, "w") as f:
            f.write(str(os.getpid()))
        os._exit(137)  # die without shutdown: peers see a dropped link

    out = None
    for _ in range(8):
        try:
            out = client.allreduce_sum(np.full(4, float(client.rank + 1)))
            break
        except OSError:
            # a peer died mid-collective: drop all links, re-broker
            # through the tracker, retry once the gang re-forms
            client.recover()
    assert out is not None, "allreduce never completed after recover"
    expected = client.world_size * (client.world_size + 1) / 2
    assert np.allclose(out, expected), (out, expected)
    client.log(f"rank {client.rank}/{client.world_size}: "
               f"recovered allreduce OK -> {out[0]}")
    client.shutdown()


if __name__ == "__main__":
    main()
