"""Minimal distributed worker (the port of ``examples/allreduce_worker.py``):
rendezvous through the DMLC env contract, tree-allreduce a vector, report
through the tracker's print relay.

    python -m dmlc_tpu_torch.tracker.submit --cluster local \
        --num-workers 4 -- python -m dmlc_tpu_torch.examples.allreduce_worker

With ``bench <bytes> <reps>`` it becomes the host-collective microbench:
every rank allreduces the same f64 payload through the binomial tree,
the chunked ring and the hierarchical shm+ring path (tracker/client.py)
at a small/medium/full size sweep, then runs the bucketed-overlap pass
(parallel.overlap.GradientBucketer) under a step-ledger window so the
exposed-vs-overlapped collective split is measured by the same
machinery production uses, then reduces the same 16 leaves as tensors
on ``--device`` (default: the card) through the bucketer and checks
them equal to the numpy pass.  Rank 0 prints one JSON line per
measurement (busbw = 2·(n-1)/n · algbw).
"""

import argparse
import json
import time

import numpy as np


def _emit(client, payload):
    if client.rank == 0:
        print(json.dumps(payload), flush=True)


def bench(client, nbytes, reps):
    w = client.world_size
    # full payload + the cutover sweep: 64 KB sits under the 1 MB ring
    # cutover (tree territory), 1 MB right at it, `nbytes` far above
    sizes = sorted({1 << 16, 1 << 20, nbytes})
    for algo in ("tree", "ring", "hier"):
        for sz in sizes:
            arr = np.full(sz // 8, 1.0, np.float64)
            # out=arr: the steady-state in-place path — no production
            # loop pays a fresh result allocation per op.  Values grow
            # w× per rep.
            client.allreduce(arr, "sum", algo=algo, out=arr)  # warmup
            t0 = time.perf_counter()
            for _ in range(reps):
                client.allreduce(arr, "sum", algo=algo, out=arr)
            dt = time.perf_counter() - t0
            want = float(w) ** (reps + 1)
            assert abs(arr[0] - want) < 1e-9 * want, (arr[0], want)
            algbw = sz * reps / dt / 1e6
            _emit(client, {
                "op": f"host_allreduce_{algo}", "bytes": sz,
                "algbw_MBps": round(algbw, 1),
                "busbw_MBps": round(algbw * 2 * (w - 1) / w, 1),
                "world": w,
            })


def bench_overlap(client, nbytes, reps, device):
    """Bucketed-overlap pass: the same payload as 16 'gradient leaves'
    through a GradientBucketer (background collective thread, default
    DMLC_COLL_ALGO routing) inside a step-ledger window, against a
    synchronous single-allreduce step — the ledger's exposed vs
    overlapped collective split is the before/after.  Then the leaves
    as tensors on ``device``, held equal to the numpy pass."""
    import torch

    from .. import telemetry
    from ..parallel.overlap import GradientBucketer

    w = client.world_size
    n_leaves = 16
    leaves = [np.full(nbytes // n_leaves // 8, 1.0, np.float64)
              for _ in range(n_leaves)]
    flat = np.concatenate(leaves)

    # --- before: the serial step (allreduce fully exposed) ---
    client.allreduce_sum(flat, out=flat)  # warmup (hier setup)
    telemetry.step_begin()
    t0 = time.perf_counter()
    for _ in range(reps):
        client.allreduce_sum(flat, out=flat)
    sync_wall = time.perf_counter() - t0
    rec_sync = telemetry.step_end()
    want = float(w) ** (reps + 1)
    assert abs(flat[0] - want) < 1e-9 * want, (flat[0], want)

    # --- after: bucketed overlap (collectives hide under packing);
    # in-place on the bucket buffers the bucketer owns ---
    bucketer = GradientBucketer(lambda a: client.allreduce_sum(a, out=a),
                                dtype=np.float64)
    bucketer.reduce_leaves(leaves)  # warmup
    telemetry.step_begin()
    t0 = time.perf_counter()
    for _ in range(reps):
        red = bucketer.reduce_leaves(leaves)
    ov_wall = time.perf_counter() - t0
    rec_ov = telemetry.step_end()
    for r in red:
        assert abs(r[0] - w) < 1e-9, r[0]
    timings = bucketer.last_timings()
    _emit(client, {
        "op": "host_allreduce_overlap", "bytes": nbytes, "world": w,
        "reps": reps, "n_leaves": n_leaves,
        "sync_wall_s": round(sync_wall, 4),
        "overlap_wall_s": round(ov_wall, 4),
        "sync_exposed_s": round(rec_sync["collective_s"], 4),
        "overlap_exposed_s": round(rec_ov["collective_s"], 4),
        "overlap_overlapped_s":
            round(rec_ov["collective_overlapped_s"], 4),
        "exposed_fraction_sync":
            round(rec_sync["collective_s"] / rec_sync["wall_s"], 3),
        "exposed_fraction_overlap":
            round(rec_ov["collective_s"] / rec_ov["wall_s"], 3),
        # last rep's per-bucket (bytes, seconds) — the bucket-granular
        # view of where collective time went
        "bucket_timings": [[b, round(s, 5)] for b, s in timings],
    })

    # --- the same leaves (distinct values a rank) as tensors on the
    # device: staged through pinned buckets, equal to the numpy pass ---
    rng = np.random.default_rng(client.rank)
    vals = [rng.standard_normal(lf.size) for lf in leaves]
    want_np = bucketer.reduce_leaves(vals)
    tensors = [torch.from_numpy(v).to(device) for v in vals]
    t0 = time.perf_counter()
    got = bucketer.reduce_leaves(tensors)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    bucketer.close()
    equal = all(g.device == device and np.array_equal(g.cpu().numpy(), e)
                for g, e in zip(got, want_np))
    _emit(client, {
        "op": "host_allreduce_overlap_tensors", "bytes": nbytes,
        "world": w, "device": str(device), "n_leaves": n_leaves,
        "wall_s": round(dt, 4), "equal_to_numpy": equal})
    assert equal, "tensor leaves reduced differently from numpy leaves"


def main(argv=None):
    p = argparse.ArgumentParser(prog="allreduce_worker")
    p.add_argument("mode", nargs="?", choices=["bench"])
    p.add_argument("nbytes", nargs="?", type=int, default=64 << 20)
    p.add_argument("reps", nargs="?", type=int, default=3)
    p.add_argument("--device", default=None,
                   help="device of the bench's tensor pass (default: the "
                        "CUDA card; 'cpu' for the plain CPU run)")
    args = p.parse_args(argv)

    from ..base import resolve_device
    from ..tracker.client import TrackerClient

    device = resolve_device(args.device) if args.mode else None
    client = TrackerClient()
    client.start()
    if args.mode == "bench":
        bench(client, args.nbytes, args.reps)
        bench_overlap(client, args.nbytes, args.reps, device)
    else:
        out = client.allreduce_sum(np.full(4, float(client.rank + 1)))
        expected = client.world_size * (client.world_size + 1) / 2
        assert np.allclose(out, expected), (out, expected)
        client.log(f"rank {client.rank}/{client.world_size}: "
                   f"allreduce OK -> {out[0]}")
    client.shutdown()


if __name__ == "__main__":
    main()
