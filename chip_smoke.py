#!/usr/bin/env python3
"""GPU smoke of the PyTorch/H100 port (``dmlc_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. device   the card's name; its name and power limit as nvidia-smi
            gives them, on a line of their own
2. build    nvcc builds every kernel in ``dmlc_tpu_torch/ops/csrc``
            (one process per source, all at once); ptxas's register and
            spill lines, and from ``cuobjdump -sass`` (where the toolkit
            has it) the tensor-core instructions (HGMMA, HMMA) of each
            bf16 forward and backward kernel, which must use wgmma
3. flash    kernel K1 (flash-attention forward) against its plain
            PyTorch version on the card: B=1, H=16, D=128, T in
            {512, 1000}, causal and not, bf16 and f32, plus (pv, m, l)
            calls at non-zero offsets in both dtypes; kernel, plain and
            ``F.scaled_dot_product_attention`` (yardstick only) times
   flash_bwd  kernels K2 (dK/dV) and K3 (dQ) against the plain backward
            at the same shapes, then at the two train shapes (B=8 x
            T=1024 and B=1 x T=8192, H=16, D=128, bf16, causal), where
            K1's output is held against the plain forward too; at both
            train shapes each of K1, K2, K3 timed alone (with its
            TFLOP/s and share of its bound) and two launches of each held
            bit-identical, beside the plain versions and SDPA's forward
            and backward (yardsticks only)
4. paged    kernel K4 (paged decode attention) likewise: B=8, H=16,
            D=128, bf16 pools, block 16, windows S in {1, 4}; two
            launches held bit-identical
5. slice    the flagship model (full width and depth, random weights
            from seed 0) served by the port's engine behind its HTTP
            server (POST /generate on localhost): 8 requests, prompt
            lengths 17..511, 32 new tokens, then 8 looping prompts with
            speculative decoding (spec_k=3); kernel launch counts are
            zeroed just before and read just after; one prefill and one
            decode step are then held against the plain versions (gated
            on a float32 copy of the weights; bf16 reported beside its
            own rounding noise floor)
6. train    the flagship train step (remat save_flash, AdamW lr 1e-4)
            at B=8 x T=1024: 2 warm-up and 8 timed steps on one batch,
            losses finite and falling, exactly 16 launches of each of
            K1, K2 and K3 per step (counts zeroed just before the timed
            steps); step ms, tokens/s, MFU, peak memory
   train_long  2 steps at B=1 x T=8192: finite losses, step ms, memory
   train_grads  gradients of the loss through the kernels against the
            plain versions on a float32 copy of the flagship at depth 2,
            B=2, T=1024 (bf16 reported beside its own noise floor)
   profile  device time by kernel category for one flagship prefill, one
            decode step and one train step at each shape
            (torch.profiler), beside their wall times
7. spine    the data spine under ``build/spine`` (removed at the end):
            a RecordIO shard of 512 records of 1025 int32 tokens written
            by the port; the flagship trained from it through
            ``recordio_feed`` (4 partitions x 2 records, B=8 x T=1024;
            2 warm-up steps, then 24 fed steps paired in ABBA order with
            steps on a batch already on the card): the first batch
            byte-exact against the records, losses finite and falling,
            16 launches of each of K1, K2 and K3 per step, the paired
            step ms and the feed wait; a fresh model's full train state
            (a depth-4 copy where build/ has under 14 GB free) saved
            through ``CheckpointManager`` after 2 fed steps, 2 more
            steps, restored bitwise into a fresh model and AdamW, and
            the same 2 steps from a feed fast-forwarded to the saved
            stream position (losses within 1e-3 relative); save,
            restore and CRC32C GB/s.  One epoch through the packed
            transport byte-equal to the padded route; then a 256 MB
            shard's payload MB/s into HBM on three routes (each route's
            first batch on the card equal to the CPU's) beside the pinned
            H2D rate at the same transfer size
   telemetry  the port's ``LoadGenerator`` drives the port's server (the
            flagship, spec_k=3, seed 0): 8 streams x 2 requests, prompts
            of 17..511 tokens, 32 new tokens; gates: /metrics parses as
            exposition text, /requests holds one finished record per
            request, a duplicate request_id returns the original's
            tokens without a second prefill (K1's count does not move),
            a drain started during a request finishes it and answers the
            next POST with 503; the ledger's own host cost per step
            (empty steps timed on the card).  The train phase's 8 timed
            steps run through the step ledger (gate: its MFU within 1%
            of the smoke's own over the same steps), then 12 ABBA pairs
            of ledgered against bare steps; the spine's fed steps report
            the ledger's feed-wait share beside the feed's own wait, and
            a checkpoint save made inside a step its stall.  All of it
            goes on one ``telemetry`` line, beside the card's name and
            power limit
8. sparse   dmlc-core's sparse text path under ``build/sparse`` (removed
            at the end): a ~256 MB LibSVM file in the Criteo Display
            Advertising Challenge's row shape (a 0/1 label from a planted
            logistic model, 13 integer and 26 hashed categorical
            features, indices in [0, 2^20)) and a 1,000,000-row CSV in
            UCI HIGGS's (a label, 28 floats), written from seed 0; each
            through ``libsvm_feed`` onto the card at 4 partitions x 2048
            rows (LibSVM on the fused native route and, as ``fmt="auto"``,
            on the classic route, ``create_row_iter`` + ``pack_rowblock``;
            CSV on the classic route): gates: each route's first batch
            equal to the same route on the CPU, the LibSVM routes' epoch
            row counts and checksums equal; text MB/s, placed MB/s, rows/s, parse and
            consumer-wait seconds beside the pinned H2D rate; 50 SGD
            steps on fed batches of the examples' logistic loss (a [2^20]
            weight) and squared loss, both falling; then the spine's
            RecordIO routes' MB/s through the native scan and packs
            beside the rates of the numpy route they replaced (one
            ``sparse_recordio`` line)
   tracker  dmlc-core's tracker, launcher and host collectives, run as
            ``python -m dmlc_tpu_torch.tracker.submit --cluster local
            --num-workers 4`` jobs on the sparse phase's files before
            they are removed: ``train_libsvm`` on the Criteo-shaped file
            (2 epochs, a [2^20] weight on the card, an 8 MB f64 gradient
            allreduced every step) — gates: every rank logs both epochs,
            the mean epoch loss falls, the four final-weight SHA-256s
            are equal, every gradient allreduce ran on ``hier``; the
            rendezvous seconds (the tracker's listen to its last rank
            assigned), steps/s, epoch seconds, allreduce ms p50/p99 and
            share of the step; the same job on the file's first 32768
            rows on the card and with ``--device cpu`` — gate: every
            rank's unrounded epoch losses agree within 1e-5 relative;
            ``train_csv`` on the HIGGS-shaped CSV (mse falls); the
            ``allreduce_worker bench 67108864 3`` sweep (tree, ring and
            hier algbw/busbw, the bucketed-overlap pass's exposed and
            overlapped seconds, the 16 leaves as CUDA tensors through
            the GradientBucketer equal to the numpy pass); the repo's
            ``examples/gbdt_allreduce.c`` built with gcc against the
            port's ``dmlc_collective`` and run with 4 workers, matching
            its single-process RMSE.  Beside the numbers: the card's
            name and power limit, its compute mode, the host's CPU
            count, the free /dev/shm and the shm group's chunk.  Gates:
            no launched process and no new ``/dev/shm/dmlc*`` segment
            left behind
9. kernels  one line ``{"kernels": [...]}``: per kernel its launches on
            its path (and on the spine's timed steps), max error, times
            and roofline bound

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card
the script exits with code 2 and prints no result.  Details go to
``chiprun_out/chip_smoke.json``.
"""

import dataclasses
import gc
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM dense
PEAK_BYTES = 3.35e12
BF16_TOL = (2e-2, 2e-3)   # max, mean abs error: ~1 bf16 ulp of the output
F32_TOL = 1e-4            # f32, summation order only
LOGIT_TOL = 2e-2          # max |kernel - plain| / std(logits), f32 model
# backward kernels, |g - g_plain| / |g_plain| per gradient: f32 summation
# order only; bf16 one rounding of each gradient (an ulp is 2^-8 ~ 3.9e-3)
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
TRAIN_GRAD_TOL = 1e-4     # max over params of |dg| / |g_plain|, f32 model
TRAIN_B, TRAIN_T = 8, 1024   # bench.py's train shapes
LONG_T = 8192

RESULTS = {}
TELEMETRY = {}   # the telemetry line, filled by the serving, train and spine phases


def emit(doc):
    print(json.dumps(doc), flush=True)
    RESULTS.setdefault("lines", []).append(doc)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, iters=20, warmup=3):
    """Device ms per call.  A ~20 ms spin kernel goes first, so the host
    has enqueued the timed calls before the first one starts and a slow
    host cannot stretch the events' interval."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(35_000_000)      # cycles: ~20 ms at 1.7-2 GHz
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def errors(got, want):
    d = (got.float() - want.float()).abs()
    return d.max().item(), d.mean().item()


def bound_ms(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def sass_mma_counts(libs):
    """Tensor-core instructions in each bf16 flash kernel of the built
    libraries, from ``cuobjdump -sass``: ``{kernel<D[, normalize]>:
    {"HGMMA": n, "HMMA": m}}`` (wgmma and mma.sync); None where the
    toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = "\n".join(subprocess.run(
        [tool, "-sass", str(lib)], capture_output=True, text=True,
        timeout=300, check=True).stdout for lib in libs)
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"(flash_(?:fwd|bwd_dkv|bwd_dq)_kernel_bf16)"
                          r"ILi(\d+)E(?:Lb([01])E)?", line)
            name = (f"{m.group(1)}<{m.group(2)}"
                    f"{', ' + m.group(3) if m.group(3) else ''}>"
                    if m else None)
            if name:
                counts[name] = {"HGMMA": 0, "HMMA": 0}
        elif name:
            for op in ("HGMMA", "HMMA"):
                counts[name][op] += bool(re.search(rf"\b{op}\.", line))
    return counts


# ---------------------------------------------------------------------------
# phase 3: K1
# ---------------------------------------------------------------------------

def flash_phase(fa):
    gen = torch.Generator("cuda").manual_seed(1)
    b, h, d = 1, 16, 128
    main, worst = None, 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for t in (512, 1000):
            q, k, v = (torch.randn((b, t, h, d), generator=gen,
                                   device="cuda").to(dtype) for _ in range(3))
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            for causal in (True, False):
                got = fa.flash_attention(q, k, v, causal=causal)
                want = fa.flash_attention(q, k, v, causal=causal,
                                          impl="torch")
                torch.cuda.synchronize()
                mx, mean = errors(got, want)
                if dtype == torch.bfloat16:
                    check(mx <= BF16_TOL[0] and mean <= BF16_TOL[1],
                          f"flash bf16 T={t} causal={causal}: {mx} {mean}")
                else:
                    check(mx <= F32_TOL, f"flash f32 T={t}: {mx}")
                worst = max(worst, mx)
                pairs = t * (t + 1) // 2 if causal else t * t
                flops = 4.0 * b * h * pairs * d
                # q, k, v read and o written once, m and l written (f32)
                nbytes = 4 * b * t * h * d * q.element_size() + 2 * b * h * t * 4
                bnd, by = bound_ms(flops, nbytes, dtype)
                row = {
                    "phase": "flash", "dtype": str(dtype).split(".")[1],
                    "B": b, "T": t, "H": h, "D": d, "causal": causal,
                    "max_abs_err": mx, "mean_abs_err": mean,
                    "ms": time_ms(lambda: fa.flash_attention(
                        q, k, v, causal=causal)),
                    "plain_ms": time_ms(lambda: fa.flash_attention(
                        q, k, v, causal=causal, impl="torch"), iters=5),
                    "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal)),
                    "bound_ms": bnd, "bound_by": by,
                }
                emit(row)
                if dtype == torch.bfloat16 and t == 512 and causal:
                    main = row
    # the ring-step (pv, m, l) contract at non-zero offsets, including a
    # KV range past every query (rows with no visible key); m and l come
    # from f32 scores in both dtypes, o = pv / l carries bf16's rounding
    # of P in bf16
    for dtype in (torch.float32, torch.bfloat16):
        for q_off, kv_off, tq, tk in ((512, 0, 256, 768), (0, 64, 128, 192)):
            q, k, v = (torch.randn((b, t, h, d), generator=gen,
                                   device="cuda").to(dtype)
                       for t in (tq, tk, tk))
            kw = dict(scale=d ** -0.5, causal=True, q_offset=q_off,
                      kv_offset=kv_off)
            pv, m, l = fa.block_attend(q, k, v, **kw)
            pv_r, m_r, l_r = fa.block_attend(q, k, v, impl="torch", **kw)
            torch.cuda.synchronize()
            o = pv / l.clamp_min(1e-20).transpose(1, 2)[..., None]
            o_r = pv_r / l_r.clamp_min(1e-20).transpose(1, 2)[..., None]
            e_o, mean_o = errors(o, o_r)
            e_m = errors(m, m_r)[0]
            e_l = ((l - l_r).abs() / l_r.clamp_min(1.0)).max().item()
            dead = l_r == 0
            check(all(torch.isfinite(x).all() for x in (pv, m, l)),
                  "non-finite (pv, m, l)")
            check(bool((l[dead] == 0).all() and (m[dead] == -1e30).all()),
                  "rows with no visible key: want m = -1e30, l = 0")
            o_ok = (e_o <= F32_TOL if dtype == torch.float32 else
                    e_o <= BF16_TOL[0] and mean_o <= BF16_TOL[1])
            check(o_ok and max(e_m, e_l) <= F32_TOL,
                  f"block_attend {dtype} offsets {q_off}/{kv_off}: "
                  f"{e_o} {mean_o} {e_m} {e_l}")
            emit({"phase": "flash_offsets", "dtype": str(dtype).split(".")[1],
                  "q_offset": q_off, "kv_offset": kv_off, "Tq": tq, "Tk": tk,
                  "o_err": e_o, "o_mean_err": mean_o, "m_err": e_m,
                  "l_rel_err": e_l, "rows_without_key": int(dead.sum())})
    return main, worst


# ---------------------------------------------------------------------------
# phase 3: K2 and K3
# ---------------------------------------------------------------------------

def rel_norm(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def bwd_inputs(gen, b, t, h, d, dtype, causal):
    """q, k, v, dO from ``gen`` and the forward's (o, lse) from K1."""
    q, k, v, do = (torch.randn((b, t, h, d), generator=gen,
                               device="cuda").to(dtype) for _ in range(4))
    o, lse = torch.ops.dmlc_tpu_torch.flash_attn_fwd(q, k, v, d ** -0.5,
                                                     causal, None)
    return q, k, v, o, lse, do


def bwd_check(fa, args, row):
    """K2 and K3 on ``args`` against the plain backward: each gradient's
    relative-norm error within ``GRAD_TOL`` (and in f32 each element
    within 3e-4 + 1e-3 |ref|); adds the errors to ``row`` and emits it."""
    dtype = args[0].dtype
    kw = dict(scale=row["D"] ** -0.5, causal=row["causal"])
    got = fa.flash_backward(*args, **kw)
    want = fa.flash_backward_reference(*args, **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        check(bool(torch.isfinite(g).all()), f"non-finite {name} {row}")
        err = rel_norm(g, w)
        mx = (g.float() - w.float()).abs().max().item()
        check(err <= GRAD_TOL[dtype], f"{name} {row}: rel err {err}")
        if dtype == torch.float32:
            excess = ((g - w).abs() - 3e-4 - 1e-3 * w.abs()).max().item()
            check(excess <= 0, f"{name} {row}: max abs {mx}")
        row[f"{name}_rel_err"] = err
        row[f"{name}_max_abs_err"] = mx
    emit(row)
    return row


def fwd_check(fa, q, k, v, o):
    """K1's ``o`` (from the op the train step calls) against the plain
    forward, bf16 tolerances; returns the max abs error."""
    want = fa.attention_reference(q, k, v, causal=True)
    mx, mean = errors(o, want)
    check(mx <= BF16_TOL[0] and mean <= BF16_TOL[1],
          f"flash fwd B={q.shape[0]} T={q.shape[1]}: {mx} {mean}")
    return mx, mean


def fwd_timing(fa, q, k, v, b, t, h, d):
    """K1 timed alone on q, k, v (bf16, causal, o normalised as the
    train step calls it), two launches held bit-identical, beside the
    plain forward and SDPA's forward (yardstick only); emits and returns
    its row."""
    kw = dict(scale=d ** -0.5, causal=True, q_offset=0, kv_offset=0,
              normalize=True)
    first = fa._launch(q, k, v, **kw)
    second = fa._launch(q, k, v, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(first, second))
    check(same, f"flash_fwd B={b} T={t}: two launches differ")
    del first, second
    ms = time_ms(lambda: fa._launch(q, k, v, **kw))
    plain_ms = time_ms(lambda: fa.attention_reference(q, k, v, causal=True),
                       iters=5)
    torch.cuda.empty_cache()
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    del qt, kt, vt
    flops = 4.0 * d * b * h * (t * (t + 1) // 2)
    # q, k, v read and o written once (bf16), m and l written (f32)
    bnd, by = bound_ms(flops, 4 * q.numel() * q.element_size()
                       + 2 * b * h * t * 4, torch.bfloat16)
    row = {"phase": "flash_fwd_train_shape", "B": b, "T": t, "H": h, "D": d,
           "dtype": "bfloat16", "causal": True, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "SDPA forward", "bound_ms": bnd, "bound_by": by,
           "gflop": flops / 1e9, "tflops": flops / ms / 1e9,
           "bound_share": bnd / ms, "over_library": ms / library_ms,
           "bit_identical": same}
    emit(row)
    return row


def bwd_timing(fa, args, b, t, h, d):
    """K2 and K3 each timed alone on ``args`` (bf16, causal), two
    launches of each held bit-identical, beside the plain backward and
    SDPA's backward (yardstick only: one call computes K2's and K3's
    outputs together); emits and returns one row per kernel."""
    q, k, v, o, lse, do = args
    kw = dict(scale=d ** -0.5, causal=True)
    bwd = fa._Backward(*args, **kw)
    ms, same = {}, {}
    for name, launch, outs in (
            ("flash_bwd_dkv", bwd.launch_dkv, lambda: (bwd.dk, bwd.dv)),
            ("flash_bwd_dq", bwd.launch_dq, lambda: (bwd.dq,))):
        launch()
        first = [x.clone() for x in outs()]
        launch()
        torch.cuda.synchronize()
        same[name] = all(torch.equal(x, y) for x, y in zip(first, outs()))
        check(same[name], f"{name} B={b} T={t}: two launches differ")
        ms[name] = time_ms(launch)
    del bwd, first
    plain_ms = time_ms(lambda: fa.flash_backward_reference(*args, **kw),
                       iters=5)
    torch.cuda.empty_cache()
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    library_ms = time_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True))
    del ot, qt, kt, vt, dot
    pairs = b * h * t * (t + 1) // 2
    el = q.element_size()
    inputs = 4 * q.numel() * el + 2 * b * h * t * 4      # q dO k v, lse delta
    rows = {}
    for name, flops, out in (("flash_bwd_dkv", 8.0 * d * pairs, 2),
                             ("flash_bwd_dq", 6.0 * d * pairs, 1)):
        bnd, by = bound_ms(flops, inputs + out * q.numel() * el,
                           torch.bfloat16)
        rows[name] = {"ms": ms[name], "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": bnd,
                      "bound_by": by, "gflop": flops / 1e9,
                      "tflops": flops / ms[name] / 1e9,
                      "bound_share": bnd / ms[name],
                      "bit_identical": same[name]}
    emit({"phase": "flash_bwd_train_shape", "B": b, "T": t, "H": h, "D": d,
          "dtype": "bfloat16", "causal": True,
          "library": "SDPA backward, dq+dk+dv in one call",
          "k2_plus_k3_over_library": (ms["flash_bwd_dkv"] + ms["flash_bwd_dq"])
          / library_ms, **rows})
    return rows


def flash_bwd_phase(fa):
    """K2/K3 against the plain backward at B=1 (T 512, 1000, causal or
    not, bf16 and f32), then at the two train shapes (bf16, causal), where
    K1's forward is held against the plain one too and each kernel is
    timed alone (:func:`fwd_timing`, :func:`bwd_timing`).  Returns the
    K2/K3 timing rows at B=8 x T=1024, each one's max abs error there,
    and K1's timing rows by (B, T)."""
    gen = torch.Generator("cuda").manual_seed(5)
    h, d = 16, 128
    fwd_rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        for t in (512, 1000):
            for causal in (True, False):
                bwd_check(fa, bwd_inputs(gen, 1, t, h, d, dtype, causal),
                          {"phase": "flash_bwd",
                           "dtype": str(dtype).split(".")[1], "B": 1, "T": t,
                           "H": h, "D": d, "causal": causal})
    # the train step's shapes: B=1 x T=8192 and B=8 x T=1024 (the plain
    # versions' T x T f32 tensors, ~4.3 GB each at T=8192, fit on the card)
    for b, t in ((1, LONG_T), (TRAIN_B, TRAIN_T)):
        args = bwd_inputs(gen, b, t, h, d, torch.bfloat16, True)
        fwd_mx, fwd_mean = fwd_check(fa, *args[:4])
        main = bwd_check(fa, args,
                         {"phase": "flash_bwd", "dtype": "bfloat16", "B": b,
                          "T": t, "H": h, "D": d, "causal": True,
                          "fwd_max_abs_err": fwd_mx,
                          "fwd_mean_abs_err": fwd_mean})
        torch.cuda.empty_cache()
        fwd_rows[(b, t)] = fwd_timing(fa, *args[:3], b, t, h, d)
        torch.cuda.empty_cache()
        rows = bwd_timing(fa, args, b, t, h, d)
        del args
        torch.cuda.empty_cache()
    errs = {"flash_bwd_dkv": max(main["dk_max_abs_err"],
                                 main["dv_max_abs_err"]),
            "flash_bwd_dq": main["dq_max_abs_err"]}
    return rows, errs, fwd_rows


# ---------------------------------------------------------------------------
# phase 4: K4
# ---------------------------------------------------------------------------

def paged_case(pa, gen, *, dtype, s_w, lengths, w, b=8, h=16, d=128, bs=16):
    n_blocks = b * w
    kp = torch.randn((n_blocks, bs, h, d), generator=gen,
                     device="cuda").to(dtype)
    vp = torch.randn((n_blocks, bs, h, d), generator=gen,
                     device="cuda").to(dtype)
    perm = torch.randperm(n_blocks, generator=gen, device="cuda")
    tables = perm.reshape(b, w).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = torch.randn((b, s_w, h, d), generator=gen, device="cuda").to(dtype)
    got = pa.paged_attention(q, kp, vp, tables, lens)
    again = pa.paged_attention(q, kp, vp, tables, lens)
    want = pa.paged_attention(q, kp, vp, tables, lens, impl="torch")
    torch.cuda.synchronize()
    same = torch.equal(got, again)
    check(same, f"paged {dtype} S={s_w}: two launches differ")
    mx, mean = errors(got, want)
    if dtype == torch.bfloat16:
        check(mx <= BF16_TOL[0] and mean <= BF16_TOL[1],
              f"paged bf16 S={s_w}: {mx} {mean}")
    else:
        check(mx <= F32_TOL, f"paged f32 S={s_w}: {mx}")
    # yardstick: SDPA over the same context gathered dense beforehand
    # (the gather is not timed; the port never calls SDPA)
    kd = kp[tables.long()].reshape(b, w * bs, h, d).transpose(1, 2).contiguous()
    vd = vp[tables.long()].reshape(b, w * bs, h, d).transpose(1, 2).contiguous()
    qd = q.transpose(1, 2).contiguous()
    pos = torch.arange(w * bs, device="cuda")
    mask = (pos[None, None, :] <= (lens.long()[:, None]
                                   + torch.arange(s_w, device="cuda"))[:, :, None])
    mask = mask[:, None]
    visible = sum(min(n + s_w, w * bs) for n in lengths)
    el = q.element_size()
    nbytes = (2 * visible * h * d * el + 2 * q.numel() * el
              + tables.numel() * 4 + lens.numel() * 4)
    flops = sum(4.0 * h * d * sum(min(n + s + 1, w * bs) for s in range(s_w))
                for n in lengths)
    bnd, by = bound_ms(flops, nbytes, dtype)
    row = {
        "phase": "paged", "dtype": str(dtype).split(".")[1], "B": b,
        "S": s_w, "H": h, "D": d, "block_size": bs, "W": w,
        "lengths": list(lengths), "max_abs_err": mx, "mean_abs_err": mean,
        "bit_identical": same,
        "ms": time_ms(lambda: pa.paged_attention(q, kp, vp, tables, lens),
                      iters=50),
        "plain_ms": time_ms(lambda: pa.paged_attention(
            q, kp, vp, tables, lens, impl="torch"), iters=10),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask), iters=50),
        "bound_ms": bnd, "bound_by": by,
    }
    emit(row)
    return row


def paged_phase(pa, prompt_lens):
    gen = torch.Generator("cuda").manual_seed(2)
    worst = 0.0
    w = 64
    for dtype, s_w in ((torch.bfloat16, 1), (torch.bfloat16, 4),
                       (torch.float32, 4)):
        row = paged_case(pa, gen, dtype=dtype, s_w=s_w, w=w,
                         lengths=[1, 15, 16, 17, 100, 333, 511, w * 16 - s_w])
        worst = max(worst, row["max_abs_err"])
    # the engine's shapes mid-generation: the 8 prompts 16 tokens in,
    # tables as wide as the longest request's reservation
    main = paged_case(pa, gen, dtype=torch.bfloat16, s_w=1,
                      lengths=[n + 16 for n in prompt_lens],
                      w=math.ceil((max(prompt_lens) + 32 + 3) / 16))
    worst = max(worst, main["max_abs_err"])
    return main, worst


# ---------------------------------------------------------------------------
# phase 5: the slice
# ---------------------------------------------------------------------------

def serve_batch(serving, model, prompts, spec_k):
    """Start an engine and its HTTP server on the card, POST every prompt
    to /generate at once (one client thread each), and check that each
    answer is 200 with 32 tokens."""
    eng = serving.InferenceEngine(model, device="cuda", n_blocks=256,
                                  block_size=16, max_active=8,
                                  queue_depth=64, spec_k=spec_k)
    eng.start()
    srv = serving.ServingHTTPServer(eng)
    results = [None] * len(prompts)

    def post(i, prompt):
        body = json.dumps({"prompt": prompt, "max_tokens": 32}).encode()
        req = urllib.request.Request(srv.url + "/generate", data=body,
                                     headers={"Content-Type":
                                              "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                results[i] = (r.status, json.loads(r.read()))
        except (OSError, ValueError) as e:   # HTTPError is an OSError
            results[i] = (None, repr(e))

    try:
        t0 = time.perf_counter()
        clients = [threading.Thread(target=post, args=(i, p))
                   for i, p in enumerate(prompts)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        wall = time.perf_counter() - t0
        for code, doc in results:
            check(code == 200, f"/generate answered {code}: {doc}")
            check(doc["state"] == "done" and doc["n_generated"] == 32,
                  f"request {doc['id']}: {doc['state']} "
                  f"{doc['n_generated']}")
        ttft = sorted(doc["ttft_s"] for _, doc in results)
        tokens = sum(doc["n_generated"] for _, doc in results)
        return {"requests": len(prompts), "spec_k": spec_k, "wall_s": wall,
                "tokens": tokens, "tokens_per_s": tokens / wall,
                "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
                **eng.stats()["counters"]}
    finally:
        srv.close()
        eng.close()


def http(url, doc=None, timeout=600):
    """``(status, body)`` of a GET (``doc`` None) or a JSON POST; a JSON
    body is decoded, any other is text."""
    data = None if doc is None else json.dumps(doc).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            code, body, ctype = r.status, r.read(), r.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        code, body, ctype = e.code, e.read(), e.headers["Content-Type"]
    return code, (json.loads(body) if ctype == "application/json"
                  else body.decode())


def pctl(xs, q):
    """Nearest-rank percentile (the ledgers' convention)."""
    xs = sorted(xs)
    return xs[min(int(q / 100 * len(xs)), len(xs) - 1)]


def ledger_cost(tele, n=400):
    """Host microseconds of the ledger's own work per step on the card:
    ``n`` empty steps (begin event, end event and its wait, the span
    walk over two spans, the record and the registry mirror) through a
    ledger of their own, then the per-step request-ledger work of a
    batch of 8 (8 token bursts and one iteration record)."""
    led = tele.StepLedger()
    led.declare_dtype("bfloat16")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        led.step_begin()
        with tele.span("feed.wait", stage="feed"):
            pass
        with tele.span("serving.prefill", stage="serving"):
            pass
        led.step_end(tokens=8.0, flops=1e12, tokens_per_step=1.0)
    step_us = (time.perf_counter() - t0) / n * 1e6
    reqs = tele.RequestLedger(slo=tele.SLOMonitor(), trace_rows=True)
    for i in range(8):
        reqs.on_submit(i, 100)
        reqs.on_prefill_begin(i)
        reqs.on_first_token(i)
    kv = {"blocks_in_use": 10, "n_blocks": 256, "occupancy": 0.04,
          "waste_tokens": 3, "cached_tokens": 157}
    t0 = time.perf_counter()
    for _ in range(n):
        now = time.perf_counter()
        for i in range(8):
            reqs.on_token(i, t=now)
        reqs.on_iteration(active=8, waiting=0, tokens=8, kv_stats=kv)
    return {"ledger_step_us": step_us,
            "request_ledger_step_us": (time.perf_counter() - t0) / n * 1e6}


def telemetry_serving(serving, tele, fa, model, cfg):
    """The port's load generator against the port's server, then the
    serving telemetry gates (see the module docstring)."""
    from dmlc_tpu_torch.telemetry.exporters import validate_exposition_text

    tele.reset()
    tele.reset_steps()
    tele.reset_events()
    eng = serving.InferenceEngine(model, device="cuda", n_blocks=256,
                                  block_size=16, max_active=8,
                                  queue_depth=64, spec_k=3)
    eng.start()
    srv = serving.ServingHTTPServer(eng)
    try:
        gen = serving.LoadGenerator(srv.url, n_streams=8,
                                    requests_per_stream=2,
                                    prompt_len=(17, 511), max_tokens=32,
                                    vocab=cfg.vocab, seed=0)
        load = gen.run()
        check(load["n_requests_ok"] == 16 and not gen.failures,
              f"loadgen: {load} {gen.failures[:2]}")
        _, text = http(srv.url + "/metrics")
        samples = validate_exposition_text(text)
        _, reqs = http(srv.url + "/requests")
        recent = reqs["recent"]
        check(reqs["summary"]["requests_done"] == 16 and len(recent) == 16
              and len({r["id"] for r in recent}) == 16
              and all(r["state"] == "done" and r["n_generated"] == 32
                      for r in recent),
              f"/requests: {reqs['summary']}")
        steps = tele.ledger().records()
        led = tele.ledger().summary()
        check(led["mfu"] is not None, "decode MFU unreported")
        # a duplicate request_id: the original's tokens, no second prefill
        doc = {"prompt": list(range(1, 200)), "max_tokens": 32,
               "request_id": "smoke-dedupe"}
        code1, first = http(srv.url + "/generate", doc)
        k1 = fa.FLASH_FWD.launches
        code2, again = http(srv.url + "/generate", doc)
        check(code1 == code2 == 200 and again["id"] == first["id"]
              and again["output_ids"] == first["output_ids"]
              and fa.FLASH_FWD.launches == k1,
              f"dedupe: {code1} {code2}, K1 {k1} -> "
              f"{fa.FLASH_FWD.launches}")
        # a drain started during a request finishes it; the next POST 503s
        inflight = {}
        t = threading.Thread(target=lambda: inflight.setdefault(
            "r", http(srv.url + "/generate", {"prompt": [5] * 64,
                                              "max_tokens": 256})))
        t.start()
        deadline = time.monotonic() + 300
        while eng.scheduler.counts()[0] < 1:
            check(time.monotonic() < deadline, "drain: never active")
            time.sleep(0.005)
        eng.begin_drain()
        code3, refused = http(srv.url + "/generate",
                              {"prompt": [1, 2], "max_tokens": 2})
        clean = srv.drain(timeout_s=300)
        t.join(timeout=300)
        code4, done = inflight["r"]
        check(code3 == 503 and clean and code4 == 200
              and done["n_generated"] == 256,
              f"drain: POST {code3}, clean {clean}, in-flight {code4}")
    finally:
        srv.close()
        eng.close()
    walls = [r["wall_s"] for r in steps]
    issue = [r["host_issue_s"] for r in steps]
    return {
        "requests": 16, "streams": 8, "spec_k": 3,
        "loadgen": {k: load[k] for k in (
            "wall_s", "total_generated_tokens", "aggregate_tokens_per_s",
            "p50_ttft_s", "p99_ttft_s", "p50_latency_s",
            "tokens_per_s_per_user", "client_server_delta_p99_s")},
        "requests_summary": reqs["summary"],
        "gap_p99_s": reqs["summary"]["tbt_p99_s"],
        "decode_steps": len(steps),
        "decode_wall_p50_s": pctl(walls, 50),
        "decode_wall_p99_s": pctl(walls, 99),
        "decode_host_issue_p50_s": pctl(issue, 50),
        "decode_host_issue_p99_s": pctl(issue, 99),
        "decode_mfu": led["mfu"],
        "tokens_per_step": led["tokens_per_step"],
        "spec_accept_rate": led["spec_accept_rate"],
        "metrics_samples": samples,
        "dedupe_same_tokens_no_prefill": True,
        "drain": {"refused": code3, "clean": clean,
                  "inflight_tokens": done["n_generated"]},
        **ledger_cost(tele)}


def slice_inputs(cfg):
    """Inputs of one prefill (T=512) and one decode step (B=8, every row
    on the prefilled context, lengths 17..511) at flagship shapes."""
    gen = torch.Generator("cuda").manual_seed(3)
    t, b, w = 512, 8, 40
    return {
        "ids": torch.randint(0, cfg.vocab, (1, t), generator=gen,
                             device="cuda"),
        "dids": torch.randint(0, cfg.vocab, (b, 1), generator=gen,
                              device="cuda"),
        "lengths": torch.tensor([17, 64, 100, 200, 255, 300, 400, 511],
                                dtype=torch.int32, device="cuda"),
        "tables": torch.arange(b * w, device="cuda", dtype=torch.int32
                               ).reshape(b, w),
    }


def prefill(tfm, model, inp, impl=None):
    t = inp["ids"].shape[1]
    with torch.inference_mode():
        return tfm.forward_prefill_last(
            model, inp["ids"], torch.tensor([t - 1], device="cuda"),
            impl=impl)


def decode_pools(cfg, k, v, inp, bs=16):
    """Pools where every decode row holds the prefilled context."""
    b, w = inp["tables"].shape
    shape = (cfg.n_layers, b * w, bs, cfg.n_heads, cfg.head_dim)
    kp = torch.zeros(shape, dtype=k.dtype, device="cuda")
    vp = torch.zeros_like(kp)
    n = k.shape[2] // bs
    for i in range(b):
        kp[:, i * w:i * w + n] = k[:, 0].reshape(shape[0], n, *shape[2:])
        vp[:, i * w:i * w + n] = v[:, 0].reshape(shape[0], n, *shape[2:])
    return kp, vp


def decode(tfm, model, inp, kp, vp, impl=None):
    with torch.inference_mode():
        return tfm.forward_decode_paged(
            model, inp["dids"], inp["lengths"].long()[:, None], kp, vp,
            inp["tables"], inp["lengths"], impl=impl)


def slice_logits(tfm, model, cfg):
    """One prefill and one decode step through the kernels and through
    the plain versions: ``{impl: (prefill logits, decode logits)}``."""
    inp = slice_inputs(cfg)
    out = {}
    for impl in (None, "torch"):
        lp, k, v = prefill(tfm, model, inp, impl)
        kp, vp = decode_pools(cfg, k, v, inp)
        out[impl] = (lp.float(), decode(tfm, model, inp, kp, vp, impl).float())
    check(all(bool(torch.isfinite(x).all()) for x in out[None]),
          "non-finite logits")
    return out


def _category(name):
    low = name.lower()
    for kernel, cat in (("flash_fwd_kernel", "flash_fwd"),
                        ("flash_bwd_dkv_kernel", "flash_bwd_dkv"),
                        ("flash_bwd_dq_kernel", "flash_bwd_dq"),
                        ("paged_split_kernel", "paged_attention"),
                        ("paged_combine_kernel", "paged_attention")):
        if kernel in low:
            return cat
    if "multi_tensor_apply" in low or "adam" in low:
        return "optimizer"
    if any(s in low for s in ("gemm", "cutlass", "nvjet", "xmma", "cublas")):
        return "gemm"
    if "memcpy" in low or "memset" in low:
        return "memcpy"
    return "other"


def profile_phase(tfm, model, cfg, train_steps):
    """Device time by kernel category for one flagship prefill (T=512),
    one decode step (B=8) and the train steps in ``train_steps`` (name
    -> step), beside the step's wall time (host clock around a
    synchronised call, profiler off); idle = 1 - busy / wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    inp = slice_inputs(cfg)
    _, k, v = prefill(tfm, model, inp)
    kp, vp = decode_pools(cfg, k, v, inp)
    steps = {"prefill": lambda: prefill(tfm, model, inp),
             "decode": lambda: decode(tfm, model, inp, kp, vp),
             **train_steps}
    doc = {"phase": "profile"}
    for name, fn in steps.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        cats, kernels = {}, []
        for e in prof.key_averages():
            # a user annotation (the optimizer's record_function range)
            # spans kernels already counted; its time is not added again
            if (e.device_type == DeviceType.CUDA and e.self_device_time_total
                    and not getattr(e, "is_user_annotation", False)):
                c = _category(e.key)
                cats[c] = cats.get(c, 0.0) + e.self_device_time_total / 1e3
                kernels.append((e.self_device_time_total / 1e3, e.count,
                                e.key[:100]))
        wall_ms = sorted(walls)[len(walls) // 2] * 1e3
        busy = sum(cats.values())
        host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                       for e in prof.key_averages()
                       if e.key.startswith("aten::")), reverse=True)[:8]
        doc[name] = {"wall_ms": wall_ms, "device_ms": cats,
                     "device_busy_ms": busy,
                     "idle_share": (1 - busy / wall_ms) if busy else None,
                     "device_top_ms_calls": [[k, ms, n] for ms, n, k in
                                             sorted(kernels)[::-1][:12]],
                     "host_top_ms_calls": [[k, ms, n] for ms, n, k in host]}
    return doc


def rel_err(a, b):
    return ((a - b).abs().max() / b.std()).item()


def logit_checks(tfm, model, cfg):
    """The kernel path against the plain path end to end.  Gated on a
    float32 copy of the flagship: in bf16 the random-weight model
    amplifies single-ulp rounding differences through 16 layers, so the
    bf16 numbers are reported beside that model's own bf16 noise floor
    (plain bf16 against plain float32)."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = tfm.Transformer(cfg32, device="cuda")
    with torch.no_grad():
        for p32, p in zip(m32.parameters(), model.parameters()):
            p32.copy_(p.float())
    r16 = slice_logits(tfm, model, cfg)
    r32 = slice_logits(tfm, m32, cfg32)
    del m32
    doc = {"phase": "slice_logits", "prefill_T": 512, "decode_B": 8}
    for i, name in enumerate(("prefill", "decode")):
        doc[f"{name}_rel_err_f32"] = rel_err(r32[None][i], r32["torch"][i])
        doc[f"{name}_rel_err_bf16"] = rel_err(r16[None][i], r16["torch"][i])
        doc[f"{name}_bf16_noise_floor"] = rel_err(r16["torch"][i],
                                                  r32["torch"][i])
        check(doc[f"{name}_rel_err_f32"] <= LOGIT_TOL,
              f"{name} logits rel err {doc[f'{name}_rel_err_f32']}")
    return doc


# ---------------------------------------------------------------------------
# phase 6: training
# ---------------------------------------------------------------------------

def train_batch(cfg, b, t, seed):
    """Random ids from a seeded generator, labels the ids shifted by one
    (as bench.py's train benchmark)."""
    gen = torch.Generator("cuda").manual_seed(seed)
    ids = torch.randint(0, cfg.vocab, (b, t), generator=gen, device="cuda")
    return ids, ids.roll(-1, 1)


def train_stats(tfm, cfg, b, t, walls):
    wall = sorted(walls)[len(walls) // 2]
    tok_s = b * t / wall
    return {"step_ms_p50": wall * 1e3, "step_ms": [w * 1e3 for w in walls],
            "tokens_per_s": tok_s,
            # against the H100 SXM's dense bf16 peak (989 TFLOP/s)
            "mfu": (tfm.train_flops_per_token(cfg, t) * tok_s
                    / PEAK_FLOPS[torch.bfloat16]),
            "peak_bytes": torch.cuda.max_memory_allocated()}


def timed_steps(step, ids, labels, n, kernels=()):
    """``n`` synchronised steps: (wall seconds, losses, launches of each
    kernel in each step)."""
    walls, losses, launches = [], [], []
    for _ in range(n):
        before = [kern.launches for kern in kernels]
        t0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(loss.item())
        launches.append([kern.launches - n0
                         for kern, n0 in zip(kernels, before)])
    return walls, losses, launches


def ledger_pairs(step, bare, ids, labels, pairs=12):
    """``pairs`` pairs of a ledgered and a bare step on one model, in ABBA
    order, each a host wall ended by ``torch.cuda.synchronize()``: the
    ledgered minus the bare wall per pair, in ms."""
    walls = {True: [], False: []}
    for i in range(2 * pairs):
        ledgered = i % 4 in (0, 3)
        t0 = time.perf_counter()
        (step if ledgered else bare)(ids, labels)
        torch.cuda.synchronize()
        walls[ledgered].append(time.perf_counter() - t0)
    diffs = [(a - b) * 1e3 for a, b in zip(walls[True], walls[False])]
    return {"pairs": pairs, "ledgered_ms_p50": median(walls[True]) * 1e3,
            "bare_ms_p50": median(walls[False]) * 1e3,
            "diff_ms_p50": median(diffs), "diff_ms_min": min(diffs),
            "diff_ms_max": max(diffs),
            "ledgered_slower": sum(d > 0 for d in diffs),
            "diff_ms": diffs}


def train_phase(tfm, fa, tele, cfg):
    """The flagship train step at B=8 x T=1024: 2 warm-up steps, then the
    counters are zeroed and 8 steps timed on the same batch, all through
    the step ledger (reset first: the serving phases declared decode
    FLOPs), then 12 ABBA pairs of ledgered against bare steps."""
    tele.reset_steps()
    model = tfm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            "cuda")
    opt = tfm.adamw(model.parameters(), 1e-4)
    step = tfm.make_train_step(model, opt)
    ids, labels = train_batch(cfg, TRAIN_B, TRAIN_T, 1)
    torch.cuda.reset_peak_memory_stats()
    _, warm, _ = timed_steps(step, ids, labels, 2)
    kernels = {"flash_fwd": fa.FLASH_FWD, "flash_bwd_dkv": fa.FLASH_BWD_DKV,
               "flash_bwd_dq": fa.FLASH_BWD_DQ}
    for kern in kernels.values():
        kern.launches = 0
    walls, losses, per_step = timed_steps(step, ids, labels, 8,
                                          tuple(kernels.values()))
    launches = {name: kern.launches for name, kern in kernels.items()}
    recs = tele.ledger().records()[-8:]
    peak = tele.ledger().peak_flops()
    check(len(recs) == 8 and peak == PEAK_FLOPS[torch.bfloat16]
          and all(r["mfu"] is not None for r in recs),
          f"ledger: {len(recs)} records, peak {peak}")
    ledger_mfu = sum(r["flops"] for r in recs) / sum(
        r["wall_s"] for r in recs) / peak
    own_mfu = (tfm.train_flops_per_token(cfg, TRAIN_T) * TRAIN_B * TRAIN_T
               * len(walls) / sum(walls) / PEAK_FLOPS[torch.bfloat16])
    check(abs(ledger_mfu / own_mfu - 1) <= 0.01,
          f"ledger MFU {ledger_mfu} vs the smoke's {own_mfu}")
    TELEMETRY["train"] = {
        "B": TRAIN_B, "T": TRAIN_T, "steps": len(recs),
        "step_p50_s": pctl([r["wall_s"] for r in recs], 50),
        "step_p99_s": pctl([r["wall_s"] for r in recs], 99),
        "host_issue_p50_s": pctl([r["host_issue_s"] for r in recs], 50),
        "event_span_p50_s": pctl([r["event_span_s"] for r in recs], 50),
        "ledger_mfu": ledger_mfu, "smoke_mfu_same_steps": own_mfu,
        "mfu_rel_diff": ledger_mfu / own_mfu - 1,
        "ledger_vs_bare": ledger_pairs(
            step, tfm.make_train_step(model, opt, ledger=False), ids,
            labels)}
    losses = warm + losses
    check(all(math.isfinite(x) for x in losses), f"train losses {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    check(all(n == [cfg.n_layers] * 3 for n in per_step),
          f"launches per step {per_step}, want {cfg.n_layers} of each")
    emit({"phase": "train", "model": "flagship", "B": TRAIN_B,
          "T": TRAIN_T, "remat_policy": cfg.remat_policy, "lr": 1e-4,
          "losses": losses, "launches_per_step": dict(zip(kernels,
                                                          per_step[0])),
          **train_stats(tfm, cfg, TRAIN_B, TRAIN_T, walls)})
    emit({"phase": "launches_train", **launches})
    return model, (lambda: step(ids, labels)), launches, step


def train_long_phase(tfm, cfg, step):
    """Two steps at the reference's long-context shape, B=1 x T=8192."""
    ids, labels = train_batch(cfg, 1, LONG_T, 2)
    torch.cuda.reset_peak_memory_stats()
    walls, losses, _ = timed_steps(step, ids, labels, 2)
    check(all(math.isfinite(x) for x in losses), f"long losses {losses}")
    emit({"phase": "train_long", "B": 1, "T": LONG_T, "losses": losses,
          **train_stats(tfm, cfg, 1, LONG_T, walls)})
    return lambda: step(ids, labels)


def grad_checks(tfm, cfg):
    """Gradients of the loss through the kernels against the plain
    versions, on a float32 copy of the flagship at full width and depth
    2 (the plain attention's T x T tensors stay small), B=2, T=1024.  The
    bf16 copy is reported beside its own noise floor (plain bf16 against
    plain f32)."""
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    m32 = tfm.init_params(cfg32, torch.Generator("cuda").manual_seed(4),
                          "cuda")
    m16 = tfm.Transformer(dataclasses.replace(cfg32, dtype="bfloat16"),
                          device="cuda")
    with torch.no_grad():
        for p16, p32 in zip(m16.parameters(), m32.parameters()):
            p16.copy_(p32)
    ids, labels = train_batch(cfg, 2, TRAIN_T, 3)

    def grads(model, impl):
        model.zero_grad(set_to_none=True)
        tfm.unsharded_loss(model, ids, labels, impl=impl).backward()
        out = [p.grad.float() for p in model.parameters()]
        model.zero_grad(set_to_none=True)
        return out

    def worst(got, want):
        # a gradient that is exactly 0 on the plain path (the one-expert
        # gate) is held to 0 in absolute terms
        return max(rel_norm(g, w) if w.norm() > 0 else g.norm().item()
                   for g, w in zip(got, want))

    g32 = {impl: grads(m32, impl) for impl in (None, "torch")}
    g16 = {impl: grads(m16, impl) for impl in (None, "torch")}
    doc = {"phase": "train_grads", "n_layers": 2, "B": 2, "T": TRAIN_T,
           "rel_err_f32": worst(g32[None], g32["torch"]),
           "rel_err_bf16": worst(g16[None], g16["torch"]),
           "bf16_noise_floor": worst(g16["torch"], g32["torch"])}
    check(doc["rel_err_f32"] <= TRAIN_GRAD_TOL,
          f"train grads rel err {doc['rel_err_f32']}")
    return doc


# ---------------------------------------------------------------------------
# phase 7: the data spine
# ---------------------------------------------------------------------------

SPINE_T = 1024                  # tokens a record holds beyond the first
SPINE_REC = (SPINE_T + 1) * 4   # 4100 bytes a record
SPINE_PARTS, SPINE_PER_PART = 4, 2
SPINE_RECORDS = 512
FEED_SHARD_BYTES = 256 << 20
FEED_PER_PART = 384             # ~6.3 MB a feed-rate batch (4 parts)


def spine_tokens(n, vocab, seed):
    """``n`` records of SPINE_T + 1 int32 tokens, arithmetic sequences
    mod ``vocab`` (the JAX example's ``make_data`` at the flagship's
    vocab and T, drawn in one go)."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, vocab, n)[:, None]
    step = rng.integers(1, 7, n)[:, None]
    return ((start + step * np.arange(SPINE_T + 1)) % vocab).astype(np.int32)


def write_shard(path, toks):
    """One RecordIO shard, a record per row, through the port's writer."""
    from dmlc_tpu_torch.io.recordio import RecordIOWriter
    from dmlc_tpu_torch.io.stream import Stream

    with Stream.create(path, "w") as s:
        w = RecordIOWriter(s)
        for row in toks:
            w.write_record(row.tobytes())


def bits_equal(a, b):
    """Two checkpoint trees hold the same paths and the same bits."""
    from dmlc_tpu_torch.checkpoint.sharded import flatten_with_path

    fa, fb = flatten_with_path(a), flatten_with_path(b)
    if [p for p, _ in fa] != [p for p, _ in fb]:
        return False
    for (_, x), (_, y) in zip(fa, fb):
        x = torch.as_tensor(x).reshape(-1).view(torch.uint8)
        y = torch.as_tensor(y).reshape(-1).view(torch.uint8)
        if not torch.equal(x, y):
            return False
    return True


def spine_feed(uri):
    from dmlc_tpu_torch.feed import recordio_feed

    return recordio_feed(uri, batch_records=SPINE_PER_PART,
                         max_bytes=SPINE_REC, num_parts=SPINE_PARTS,
                         device="cuda")


def spine_step(step, it, inside=None):
    """One bare train step on the next feed batch, or on a batch already
    on the card when ``it`` is a pair ``(ids, labels)``, as one step of
    the process step ledger opened before the batch is pulled (so the
    feed's wait is the step's feed-wait), with ``inside()`` run after
    the train step and before the step closes: ``(batch, loss, seconds
    in next(), step wall)``.  ``ledger().records()[-1]`` is its record."""
    from dmlc_tpu_torch import telemetry as tele
    from dmlc_tpu_torch.examples import train_lm_recordio as ex

    t0 = time.perf_counter()
    tele.step_begin()
    batch = None if isinstance(it, tuple) else next(it)
    t1 = time.perf_counter()
    ids, labels = it if batch is None else ex.batch_tokens(batch)
    loss = step(ids, labels)
    if inside is not None:
        inside()
    tele.step_end(tokens=float(ids.numel()))
    torch.cuda.synchronize()
    return batch, loss.item(), t1 - t0, time.perf_counter() - t0


def spine_train(tfm, fa, cfg, uri, toks):
    """Train the flagship from the RecordIO shard through the feed: 2
    warm-up steps, then 24 fed steps each paired with a step on a batch
    already on the card, in ABBA order (launch counts zeroed before the
    timed ones), so the paired walls show what the feed's threads cost
    the step."""
    from dmlc_tpu_torch.examples import train_lm_recordio as ex
    from dmlc_tpu_torch.io import input_split

    # the records each partition starts with, from the split's spans
    split = input_split.create(uri, 0, 1, "recordio", threaded=False)
    first = [b // (SPINE_REC + 8)
             for b, _ in split.partition_spans(SPINE_PARTS)]
    split.close()
    want = torch.from_numpy(np.concatenate(
        [toks[i:i + SPINE_PER_PART] for i in first]).view(np.uint8)).cuda()
    resident = ex.batch_tokens({"data": torch.from_numpy(spine_tokens(
        SPINE_PARTS * SPINE_PER_PART, cfg.vocab, 2).view(np.uint8)).cuda()})

    from dmlc_tpu_torch import telemetry as tele

    model = tfm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            "cuda")
    opt = tfm.adamw(model.parameters(), 1e-4)
    # bare: spine_step brackets the ledger's step around the feed's wait
    step = tfm.make_train_step(model, opt, ledger=False)
    kernels = {"flash_fwd": fa.FLASH_FWD, "flash_bwd_dkv": fa.FLASH_BWD_DKV,
               "flash_bwd_dq": fa.FLASH_BWD_DQ}
    f = spine_feed(uri)
    it = iter(f)
    losses, walls, waits, res_walls, per_step = [], [], [], [], []
    fed_recs, fed_stats_wait = [], []
    try:
        for _ in range(2):
            batch, loss, _, _ = spine_step(step, it)
            if not losses:
                first_exact = (torch.equal(batch["data"], want) and bool(
                    (batch["length"] == SPINE_REC).all()))
                probe = ex.batch_tokens(batch)
            losses.append(loss)
        for kern in kernels.values():
            kern.launches = 0
        for i in range(48):
            fed = i % 4 in (0, 3)
            before = [k.launches for k in kernels.values()]
            wait0 = f.stats()["wait_s"]
            _, loss, wait, wall = spine_step(step, it if fed else resident)
            if fed:
                fed_recs.append(tele.ledger().records()[-1])
                fed_stats_wait.append(f.stats()["wait_s"] - wait0)
            per_step.append([k.launches - n0 for k, n0 in
                             zip(kernels.values(), before)])
            if not fed:
                res_walls.append(wall)
            else:
                losses.append(loss)
                walls.append(wall)
                waits.append(wait)
        launches = {n: k.launches for n, k in kernels.items()}
        # each step trains on new records, whose loss moves less than its
        # noise in 26 steps at lr 1e-4; the first batch's loss, taken
        # again after them, shows the updates landed
        with torch.no_grad():
            probe_loss = tfm.unsharded_loss(model, *probe).item()
        stats = f.stats()
    finally:
        f.close()
    check(first_exact, "spine: the first feed batch differs from the "
          "records as written")
    check(all(math.isfinite(x) for x in losses + [probe_loss]),
          f"spine losses {losses}, {probe_loss}")
    check(probe_loss < losses[0],
          f"spine: the first batch's loss did not fall: {losses[0]} -> "
          f"{probe_loss}")
    check(all(n == [cfg.n_layers] * 3 for n in per_step),
          f"spine launches per step {per_step}, want {cfg.n_layers} of each")
    ledger_wait = sum(r["feed_wait_s"] for r in fed_recs)
    feed_wait = sum(fed_stats_wait)
    ledger_wall = sum(r["wall_s"] for r in fed_recs)
    # the ledger bills the consumer's feed.wait span, which wraps the
    # block the feed's own wait clock times
    check(abs(ledger_wait - feed_wait) <= 1e-3 + 0.05 * feed_wait,
          f"spine: ledger feed wait {ledger_wait} s, the feed's {feed_wait}")
    TELEMETRY["spine"] = {
        "fed_steps": len(fed_recs),
        "ledger_feed_wait_share": ledger_wait / ledger_wall,
        "feed_own_wait_share": feed_wait / ledger_wall,
        "ledger_feed_wait_s": ledger_wait, "feed_own_wait_s": feed_wait,
        "ledger_fed_step_p50_s": pctl([r["wall_s"] for r in fed_recs], 50),
        "host_issue_p50_s": pctl([r["host_issue_s"] for r in fed_recs], 50)}
    diffs = [a - b for a, b in zip(walls, res_walls)]
    return {
        "phase": "spine_train", "model": "flagship",
        "feed": f"recordio_feed(num_parts={SPINE_PARTS}, "
                f"batch_records={SPINE_PER_PART}, max_bytes={SPINE_REC})",
        "B": SPINE_PARTS * SPINE_PER_PART, "T": SPINE_T, "lr": 1e-4,
        "first_batch_byte_exact": first_exact, "losses": losses,
        "first_batch_loss_after": probe_loss,
        "launches_per_step": dict(zip(kernels, per_step[0])),
        "launches": launches, "step_ms_p50": median(walls) * 1e3,
        "step_ms": [w * 1e3 for w in walls],
        "resident_step_ms_p50": median(res_walls) * 1e3,
        "resident_step_ms": [w * 1e3 for w in res_walls],
        "fed_minus_resident_ms_p50": median(diffs) * 1e3,
        "fed_minus_resident_ms": [d * 1e3 for d in diffs],
        "feed_wait_ms_p50": median(waits) * 1e3,
        "feed_wait_ms": [w * 1e3 for w in waits],
        "feed_wait_share": sum(waits) / sum(walls), "feed_stats": stats}


def median(xs):
    return sorted(xs)[len(xs) // 2]


def spine_checkpoint(tfm, cfg, uri, ckpt_dir):
    """Train a model at ``cfg`` 2 steps from the feed, checkpoint its
    full train state with the stream position, take 2 more steps, then
    restore into a fresh model and AdamW and take the same 2 steps from
    a feed fast-forwarded to the saved position."""
    from dmlc_tpu_torch import native
    from dmlc_tpu_torch.checkpoint import CheckpointManager
    from dmlc_tpu_torch.examples import train_lm_recordio as ex
    from dmlc_tpu_torch.models.convert import (train_state_from_jax,
                                               train_state_to_jax)

    from dmlc_tpu_torch import telemetry as tele

    model = tfm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            "cuda")
    opt = tfm.adamw(model.parameters(), 1e-4)
    step = tfm.make_train_step(model, opt, ledger=False)
    consumed = 2
    mgr = CheckpointManager(ckpt_dir, max_to_keep=1)
    held = {}

    def save_inside():
        """The checkpoint, made inside the second step."""
        t0 = time.perf_counter()
        held["saved"] = ex.train_state(model, opt, consumed)
        t1 = time.perf_counter()
        mgr.save(consumed, held["saved"])
        held["to_host_s"], held["save_s"] = t1 - t0, time.perf_counter() - t1

    f = spine_feed(uri)
    try:
        it = iter(f)
        for i in range(consumed):
            spine_step(step, it, save_inside if i == consumed - 1 else None)
        rec = tele.ledger().records()[-1]
        saved, to_host_s, save_s = (held["saved"], held["to_host_s"],
                                    held["save_s"])
        check(0 < rec["checkpoint_stall_s"] <= save_s,
              f"checkpoint stall {rec['checkpoint_stall_s']} s of a "
              f"{save_s} s save")
        TELEMETRY["checkpoint"] = {
            "n_layers": cfg.n_layers, "step_wall_s": rec["wall_s"],
            "checkpoint_stall_s": rec["checkpoint_stall_s"],
            "save_s": save_s, "to_host_s": to_host_s}
        nbytes = mgr.stats()["bytes_written"]
        after = [spine_step(step, it)[1] for _ in range(2)]
    finally:
        f.close()
    del model, opt, step, it
    torch.cuda.empty_cache()

    model = tfm.Transformer(cfg, device="cuda")
    opt = tfm.adamw(model.parameters(), 1e-4)
    template = dict(train_state_to_jax(model, opt, device="meta"),
                    stream=np.zeros(1, np.int64))
    t0 = time.perf_counter()
    at, restored = mgr.restore_latest(template)
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_state_from_jax(restored, model, opt)
    torch.cuda.synchronize()
    to_card_s = time.perf_counter() - t0
    check(at == consumed and int(restored["stream"][0]) == consumed,
          f"restored step {at}, stream {restored['stream']}")
    restored_equal = bits_equal(restored, saved)
    del restored
    back = dict(train_state_to_jax(model, opt), stream=saved["stream"])
    state_equal = bits_equal(back, saved)
    del back
    check(restored_equal and state_equal,
          f"restored state differs: file {restored_equal}, "
          f"model {state_equal}")
    big = max((t for t in saved["params"]["blocks"].values()),
              key=lambda t: t.numel())
    raw = big.reshape(-1).view(torch.uint8).numpy()
    t0 = time.perf_counter()
    native.crc32c(raw)
    crc_s = time.perf_counter() - t0
    del saved, held
    step = tfm.make_train_step(model, opt, ledger=False)
    f = spine_feed(uri)
    try:
        it = iter(f)
        for _ in range(consumed):   # fast-forward to the stream position
            next(it)
        resumed = [spine_step(step, it)[1] for _ in range(2)]
    finally:
        f.close()
    del model, opt, step, it
    torch.cuda.empty_cache()
    diff = [abs(a - b) / abs(b) for a, b in zip(resumed, after)]
    check(max(diff) <= 1e-3, f"resumed losses {resumed} vs {after}")
    return {
        "phase": "spine_checkpoint", "n_layers": cfg.n_layers,
        "step": consumed, "bytes": nbytes,
        "leaves": len(mgr_leaves(ckpt_dir, consumed)),
        "to_host_s": to_host_s, "save_s": save_s,
        "save_GBps": nbytes / save_s / 1e9, "restore_s": restore_s,
        "restore_GBps": nbytes / restore_s / 1e9, "to_card_s": to_card_s,
        "crc32c_bytes": raw.size, "crc32c_GBps": raw.size / crc_s / 1e9,
        "crc32c_sse42": native.crc32c_hardware(),
        "state_bitwise_equal": restored_equal and state_equal,
        "losses_uninterrupted": after, "losses_resumed": resumed,
        "loss_abs_diff": [abs(a - b) for a, b in zip(resumed, after)],
        "loss_rel_diff": diff, "manager_stats": mgr.stats()}


def mgr_leaves(ckpt_dir, step):
    with open(os.path.join(ckpt_dir, f"step_{step:08d}",
                           "manifest.json")) as fh:
        return json.load(fh)["leaves"]


def spine_routes(uri):
    """One epoch through the packed transport and through the padded
    route of the same shard: every batch byte-equal on the card."""
    from dmlc_tpu_torch.feed import recordio_feed

    kw = dict(batch_records=SPINE_PER_PART, max_bytes=SPINE_REC,
              num_parts=SPINE_PARTS, device="cuda")
    padded = recordio_feed(uri, **kw)
    packed = recordio_feed(uri, pack_bytes=SPINE_PER_PART * SPINE_REC, **kw)
    n = 0
    try:
        for a, b in itertools.zip_longest(padded, packed):
            check(a is not None and b is not None,
                  f"the routes end at different batches ({n})")
            check(sorted(a) == sorted(b), f"keys {sorted(a)} {sorted(b)}")
            for k in a:
                check(torch.equal(a[k], b[k]), f"batch {n} {k} differs")
            n += 1
    finally:
        padded.close()
        packed.close()
    check(n == SPINE_RECORDS // (SPINE_PARTS * SPINE_PER_PART),
          f"{n} batches in the epoch")
    return {"phase": "spine_routes", "batches": n,
            "packed_equals_padded": True,
            "bytes_to_device": {"padded": padded.stats()["bytes_to_device"],
                                "packed": packed.stats()["bytes_to_device"]}}


def h2d_ceiling(nbytes, iters=32):
    """MB/s of non-blocking copies from one pinned host buffer of
    ``nbytes`` to the card, timed with CUDA events."""
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        dst.copy_(src, non_blocking=True)
    b.record()
    torch.cuda.synchronize()
    return nbytes * iters / 1e6 / (a.elapsed_time(b) / 1e3)


def spine_feed_rate(uri):
    """Payload MB/s into HBM over one epoch of the large shard on three
    routes, beside the pinned H2D rate at the same transfer size."""
    from dmlc_tpu_torch.feed import recordio_feed, recordio_packed_feed

    per_part_bytes = FEED_PER_PART * SPINE_REC
    routes = {
        "padded": lambda device: recordio_feed(
            uri, batch_records=FEED_PER_PART, max_bytes=SPINE_REC,
            num_parts=SPINE_PARTS, device=device),
        "packed_transport": lambda device: recordio_feed(
            uri, batch_records=FEED_PER_PART, max_bytes=SPINE_REC,
            num_parts=SPINE_PARTS, device=device, pack_bytes=per_part_bytes),
        "recordio_packed_feed": lambda device: recordio_packed_feed(
            uri, buf_bytes=per_part_bytes, max_records=FEED_PER_PART,
            num_parts=SPINE_PARTS, device=device),
    }
    doc = {"phase": "spine_feed_rate", "shard_bytes": os.path.getsize(uri),
           "num_parts": SPINE_PARTS, "batch_bytes": SPINE_PARTS
           * per_part_bytes}
    for name, make in routes.items():
        cpu = make("cpu")
        try:
            want = {k: v.clone() for k, v in next(iter(cpu)).items()}
        finally:
            cpu.close()
        f = make("cuda")
        payload = torch.zeros((), dtype=torch.int64, device="cuda")
        batches, exact = 0, None
        try:
            t0 = time.perf_counter()
            for b in f:
                if exact is None:
                    exact = sorted(b) == sorted(want) and all(
                        torch.equal(b[k].cpu(), want[k]) for k in want)
                if "length" in b:
                    payload += b["length"].sum()
                else:
                    offs = b["offsets"].view(SPINE_PARTS, -1)
                    payload += offs.gather(
                        1, b["count"].view(-1, 1).long()).sum()
                batches += 1
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            f.close()
        payload = int(payload)
        check(payload == (doc["shard_bytes"] // (SPINE_REC + 8)) * SPINE_REC,
              f"{name}: {payload} payload bytes")
        check(exact, f"{name}: the first batch on the card differs from the "
              "CPU's")
        doc[name] = {"MBps": payload / 1e6 / dt, "seconds": dt,
                     "payload_bytes": payload, "batches": batches,
                     "first_batch_equals_cpu": exact, "stats": f.stats()}
    doc["h2d_pinned_MBps"] = h2d_ceiling(doc["batch_bytes"])
    return doc


def spine_phase(tfm, fa, cfg):
    """The data spine on the card: RecordIO shards written by the port,
    read through the input split and the device feed into the flagship
    train step, checkpointed and resumed in the JAX package's format.
    The ~6 GB train state is checkpointed at full depth where build/ has
    14 GB free, else a depth-4 copy at full width.  ``build/spine`` goes
    at the end."""
    root = os.path.join(ROOT, "build", "spine")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        free = shutil.disk_usage(root).free
        uri = os.path.join(root, "tokens.rec")
        toks = spine_tokens(SPINE_RECORDS, cfg.vocab, 0)
        write_shard(uri, toks)
        train_doc = spine_train(tfm, fa, cfg, uri, toks)
        torch.cuda.empty_cache()
        ckpt_cfg = (cfg if free >= 14e9
                    else dataclasses.replace(cfg, n_layers=4))
        ckpt_doc = spine_checkpoint(tfm, ckpt_cfg, uri,
                                    os.path.join(root, "ckpt"))
        ckpt_doc["disk_free_bytes"] = free
        shutil.rmtree(os.path.join(root, "ckpt"))
        routes_doc = spine_routes(uri)
        big = os.path.join(root, "feed.rec")
        t0 = time.perf_counter()
        write_shard(big, spine_tokens(FEED_SHARD_BYTES // (SPINE_REC + 8),
                                      cfg.vocab, 1))
        rate_doc = spine_feed_rate(big)
        rate_doc["write_s"] = time.perf_counter() - t0 - sum(
            rate_doc[r]["seconds"] for r in ("padded", "packed_transport",
                                             "recordio_packed_feed"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return train_doc, routes_doc, rate_doc, ckpt_doc


# ---------------------------------------------------------------------------
# phase 8: the sparse text path
# ---------------------------------------------------------------------------

SPARSE_PARTS, SPARSE_PER_PART = 4, 2048   # ~3.9 MB a global batch
CRITEO_INT, CRITEO_CAT = 13, 26           # Criteo's 39 features a row
SPARSE_NUM_COL = 1 << 20                  # hashed index space
SPARSE_LIBSVM_BYTES = 256 << 20
HIGGS_ROWS, HIGGS_COLS = 1_000_000, 28    # HIGGS-1M: a label, 28 floats
LOSS_STEPS = 50
# the RecordIO routes' MB/s on the 256 MB shard when the feed's scan and
# packs ran in numpy and Python (an earlier run of this script, H100
# 80GB HBM3, 700.00 W), printed beside this run's
NUMPY_ROUTE_RECORDIO_MBPS = {"padded": 439.65, "packed_transport": 158.62,
                             "recordio_packed_feed": 162.65}


def _ndigits(v):
    n = np.ones(v.shape, np.int64)
    for p in range(1, 19):
        n += v >= 10 ** p
    return n


def _put_uint(buf, pos, v, width=None):
    """Decimal digits of ``v`` (uint64) into ``buf`` at ``pos``, zero-padded
    to ``width`` when given; returns the digit counts."""
    nd = _ndigits(v) if width is None else np.full(v.shape, width, np.int64)
    for d in range(int(nd.max(initial=1))):
        m = nd > d
        buf[(pos + nd - 1 - d)[m]] = 48 + (v[m] // 10 ** d) % 10
    return nd


def _emit_rows(fields, seps):
    """One text block from ``fields``: a list of (kind, array [rows, k])
    items, kind ``"u"`` unsigned integers, ``"f6"`` signed fixed-point with
    6 decimals, ``"f3"`` fixed-point in [0, 1) with 3 decimals, each cell
    followed by the byte ``seps[i]`` (space, ':' or ',') and every row by
    a newline.  All vectorized: a cell's length, then offsets, then the
    digits in place."""
    rows = fields[0][1].shape[0]
    cells = []   # per column: (kind, values, length)
    for (kind, arr), sep in zip(fields, seps):
        for j in range(arr.shape[1]):
            v = arr[:, j]
            if kind == "u":
                ln = _ndigits(v) + 1
            elif kind == "f3":
                ln = np.full(rows, 6, np.int64)          # 0.xyz + sep
            else:
                q = np.rint(np.abs(v) * 1e6).astype(np.int64)
                ln = (v < 0) + _ndigits(q // 1_000_000) + 8   # . 6 digits sep
            cells.append((kind, v, ln, sep))
    lens = np.stack([c[2] for c in cells], 1)
    row_len = lens.sum(1)
    row_off = np.zeros(rows + 1, np.int64)
    np.cumsum(row_len, out=row_off[1:])
    buf = np.empty(int(row_off[-1]), np.uint8)
    pos = row_off[:-1].copy()
    for kind, v, ln, sep in cells:
        if kind == "u":
            _put_uint(buf, pos, v.astype(np.uint64))
        elif kind == "f3":
            buf[pos] = 48
            buf[pos + 1] = 46
            _put_uint(buf, pos + 2, np.rint(v * 1000).astype(np.uint64)
                      .clip(0, 999), width=3)
        else:
            q = np.rint(np.abs(v) * 1e6).astype(np.int64)
            neg = v < 0
            buf[pos[neg]] = 45
            p = pos + neg
            nd = _put_uint(buf, p, (q // 1_000_000).astype(np.uint64))
            buf[p + nd] = 46
            _put_uint(buf, p + nd + 1, (q % 1_000_000).astype(np.uint64),
                      width=6)
        pos = pos + ln
        buf[pos - 1] = ord(sep)
    buf[row_off[1:] - 1] = 10
    return buf


def criteo_rows(rng, n, w_true):
    """``n`` LibSVM rows in Criteo's shape: a 0/1 label drawn from the
    planted logistic model ``w_true``, 13 integer features (indices 0..12,
    values in [0, 1)) and 26 hashed categorical ones (indices in
    [13, 2^20), value 1)."""
    dense = np.round(rng.random((n, CRITEO_INT)), 3)
    cat = np.sort(rng.integers(CRITEO_INT, SPARSE_NUM_COL, (n, CRITEO_CAT)),
                  axis=1)
    logit = dense @ w_true[:CRITEO_INT] + w_true[cat].sum(1)
    label = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.int64)
    idx_dense = np.broadcast_to(np.arange(CRITEO_INT), (n, CRITEO_INT))
    fields = [("u", label[:, None])]
    seps = [" "]
    for j in range(CRITEO_INT):
        fields += [("u", idx_dense[:, j:j + 1]), ("f3", dense[:, j:j + 1])]
        seps += [":", " "]
    for j in range(CRITEO_CAT):
        fields += [("u", cat[:, j:j + 1]), ("u", np.ones((n, 1), np.int64))]
        seps += [":", " "]
    return _emit_rows(fields, seps)


def higgs_rows(rng, n, w_true):
    """``n`` CSV rows in HIGGS's shape: a 0/1 label (a planted linear
    rule on the features) and 28 float columns, 6 decimals."""
    x = rng.standard_normal((n, HIGGS_COLS))
    label = (x @ w_true + 0.5 * rng.standard_normal(n) > 0).astype(np.int64)
    return _emit_rows([("u", label[:, None]), ("f6", x)], [",", ","])


def write_sparse_files(root, libsvm_bytes=SPARSE_LIBSVM_BYTES,
                       higgs_rows_n=HIGGS_ROWS, seed=0):
    """The LibSVM and CSV files under ``root`` from ``seed``, in blocks
    of rows; returns their paths and row counts."""
    rng = np.random.default_rng(seed)
    w_svm = np.concatenate([rng.standard_normal(CRITEO_INT) * 2.0,
                            rng.standard_normal(SPARSE_NUM_COL - CRITEO_INT)
                            * 0.3])
    w_svm[:CRITEO_INT] -= w_svm[:CRITEO_INT].mean()
    svm = os.path.join(root, "criteo.libsvm")
    rows_svm = 0
    with open(svm, "wb") as f:
        size = 0
        while size < libsvm_bytes:
            n = min(100_000, max(1, (libsvm_bytes - size) // 380 + 1))
            buf = criteo_rows(rng, n, w_svm)
            f.write(buf.tobytes())
            size += buf.size
            rows_svm += n
    w_csv = rng.standard_normal(HIGGS_COLS)
    csv = os.path.join(root, "higgs.csv")
    with open(csv, "wb") as f:
        for lo in range(0, higgs_rows_n, 100_000):
            f.write(higgs_rows(rng, min(100_000, higgs_rows_n - lo),
                               w_csv).tobytes())
    return svm, rows_svm, csv, higgs_rows_n


def _batch_checksum(b):
    """(rows, checksum) of one sparse batch as int64 tensors on its
    device: the words of every label, value and index summed as integers,
    so equal batches give equal sums in any order."""
    rows = (b["mask"].sum(1) > 0).sum()
    chk = (b["label"].view(torch.int32).long().sum()
           + b["value"].view(torch.int32).long().sum()
           + b["index"].long().sum() + b["mask"].view(torch.int32).long()
           .sum())
    return rows, chk


def sparse_route(make, text_bytes):
    """One route of ``libsvm_feed``: its first batch on the CPU, then one
    epoch on the card, timed: the first batch byte-equal to the CPU's,
    the epoch's row count and checksum, MB/s of text parsed and of bytes
    placed, rows/s, the feed's parse and consumer-wait seconds."""
    cpu = make("cpu")
    try:
        want = {k: v.clone() for k, v in next(iter(cpu)).items()}
    finally:
        cpu.close()
    f = make("cuda")
    rows = torch.zeros((), dtype=torch.int64, device="cuda")
    chk = torch.zeros((), dtype=torch.int64, device="cuda")
    batches, first = 0, None
    try:
        t0 = time.perf_counter()
        for b in f:
            if first is None:
                first = {k: v.cpu() for k, v in b.items()}
            r, c = _batch_checksum(b)
            rows += r
            chk += c
            batches += 1
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        f.close()
    exact = sorted(first) == sorted(want) and all(
        torch.equal(first[k], want[k]) for k in want)
    st = f.stats()
    return {"first_batch_equals_cpu": exact, "rows": int(rows),
            "checksum": int(chk), "batches": batches, "seconds": dt,
            "text_MBps": text_bytes / 1e6 / dt,
            "placed_MBps": st["bytes_to_device"] / 1e6 / dt,
            "rows_per_s": int(rows) / dt, "parse_s": st["parse_s"],
            "consumer_wait_s": st["wait_s"], "stats": st}


def sparse_losses(make_svm, make_csv):
    """50 SGD steps on the card on fed batches with each example's loss:
    logistic on a [2^20] weight (``examples/train_libsvm.py:49-58``,
    lr 0.5) from the LibSVM feed and squared (``examples/train_csv.py:46-50``,
    lr 0.1) on a [28] weight from the CSV feed."""
    def logistic(w, b):
        x = b["value"] * b["mask"]
        p = torch.sigmoid((x * w[b["index"].long()]).sum(1))
        eps = 1e-7
        y = b["label"]
        return -(y * torch.log(p + eps)
                 + (1 - y) * torch.log(1 - p + eps)).mean()

    def squared(w, b):
        pred = (b["value"] * b["mask"] * w[b["index"].long()]).sum(1)
        return (pred - b["label"]).square().mean()

    out = {}
    for name, make, n_w, lr, loss_fn in (
            ("logistic", make_svm, SPARSE_NUM_COL, 0.5, logistic),
            ("squared", make_csv, HIGGS_COLS, 0.1, squared)):
        w = torch.zeros(n_w, device="cuda", requires_grad=True)
        f = make("cuda")
        losses = []
        try:
            for b in itertools.islice(f, LOSS_STEPS):
                loss = loss_fn(w, b)
                loss.backward()
                with torch.no_grad():
                    w -= lr * w.grad
                    w.grad = None
                losses.append(loss.detach())
        finally:
            f.close()
        losses = [x.item() for x in losses]
        check(len(losses) == LOSS_STEPS
              and all(math.isfinite(x) for x in losses),
              f"sparse {name} losses {losses}")
        first, last = losses[0], sum(losses[-5:]) / 5
        check(last < first, f"sparse {name} loss did not fall: {first} -> "
              f"{last} (mean of the last 5)")
        out[name] = {"losses": losses, "first": first, "last5_mean": last,
                     "lr": lr, "weight": n_w}
    return out


def sparse_phase(smi, rate_doc, spine_first_exact):
    """The sparse text path on the card: LibSVM (Criteo's row shape) and
    CSV (HIGGS's) files written from seed 0 under ``build/sparse``
    (removed after), fed through ``libsvm_feed`` on both routes, checked
    against the CPU and across routes, then 50 steps of each example's
    loss; the RecordIO routes' MB/s through the native scan beside the
    numpy route's.  The ``tracker`` phase runs on the same files before
    they are removed; its line comes back third.
    """
    from dmlc_tpu_torch.feed import libsvm_feed

    root = os.path.join(ROOT, "build", "sparse")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        t0 = time.perf_counter()
        svm, n_svm, csv, n_csv = write_sparse_files(root)
        write_s = time.perf_counter() - t0
        csv_uri = csv + "?format=csv&label_column=0"

        def make_svm(fmt):   # "libsvm": the fused route; "auto": classic
            return lambda device: libsvm_feed(
                svm, batch_size=SPARSE_PER_PART, max_nnz=CRITEO_INT
                + CRITEO_CAT, fmt=fmt, num_parts=SPARSE_PARTS,
                device=device)

        def make_csv(device):
            return libsvm_feed(csv_uri, batch_size=SPARSE_PER_PART,
                               max_nnz=HIGGS_COLS, fmt="csv",
                               num_parts=SPARSE_PARTS, device=device)

        svm_bytes, csv_bytes = os.path.getsize(svm), os.path.getsize(csv)
        routes = {"libsvm_fused": sparse_route(make_svm("libsvm"),
                                               svm_bytes),
                  "libsvm_classic": sparse_route(make_svm("auto"),
                                                 svm_bytes),
                  "csv_classic": sparse_route(make_csv, csv_bytes)}
        batch_bytes = SPARSE_PARTS * SPARSE_PER_PART * (
            4 + 12 * (CRITEO_INT + CRITEO_CAT))
        doc = {"phase": "sparse", "card": smi, "write_s": write_s,
               "libsvm": {"path": "criteo.libsvm", "bytes": svm_bytes,
                          "rows": n_svm, "features_per_row":
                          CRITEO_INT + CRITEO_CAT},
               "csv": {"path": "higgs.csv", "bytes": csv_bytes,
                       "rows": n_csv, "columns": HIGGS_COLS + 1},
               "num_parts": SPARSE_PARTS, "batch_rows": SPARSE_PER_PART,
               "libsvm_batch_bytes": batch_bytes, **routes,
               "h2d_pinned_MBps": h2d_ceiling(batch_bytes)}
        for name, r in routes.items():
            check(r["first_batch_equals_cpu"],
                  f"sparse {name}: the first batch on the card differs from "
                  "the CPU's")
        a, b = routes["libsvm_fused"], routes["libsvm_classic"]
        check(a["rows"] == b["rows"] == n_svm and a["checksum"]
              == b["checksum"], f"sparse: the LibSVM routes disagree: "
              f"{a['rows']}/{a['checksum']} vs {b['rows']}/{b['checksum']} "
              f"({n_svm} rows written)")
        check(routes["csv_classic"]["rows"] == n_csv,
              f"sparse csv: {routes['csv_classic']['rows']} of {n_csv} rows")
        doc["losses"] = sparse_losses(make_svm("libsvm"), make_csv)
        tracker_doc = tracker_phase(smi, svm, csv)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec = {"phase": "sparse_recordio", "card": smi,
           "first_batch_byte_exact": spine_first_exact,
           "shard_bytes": rate_doc["shard_bytes"]}
    for name, before in NUMPY_ROUTE_RECORDIO_MBPS.items():
        rec[name] = {"MBps": rate_doc[name]["MBps"],
                     "numpy_route_MBps": before,
                     "first_batch_equals_cpu":
                     rate_doc[name]["first_batch_equals_cpu"],
                     "parse_s": rate_doc[name]["stats"]["parse_s"],
                     "consumer_wait_s": rate_doc[name]["stats"]["wait_s"]}
    rec["h2d_pinned_MBps"] = rate_doc["h2d_pinned_MBps"]
    return doc, rec, tracker_doc


# ---------------------------------------------------------------------------
# phase 8b: the tracker, the launcher and the host collectives
# ---------------------------------------------------------------------------

TRACKER_WORKERS = 4
GBDT_TOL = 1e-4   # relative: the tree allreduce's fold order vs a local sum
PARITY_ROWS = 32768   # the head of the Criteo-shaped file, card vs CPU
PARITY_RTOL = 1e-5    # per-rank epoch losses, card vs --device cpu


def _dmlc_shm():
    return {n for n in os.listdir("/dev/shm") if n.startswith("dmlc")}


def _submit(name, argv, timeout, workers=TRACKER_WORKERS):
    """One ``python -m dmlc_tpu_torch.tracker.submit --cluster local`` job
    in a session of its own (so a job cut at its timeout is killed whole);
    its output goes to ``chiprun_out/tracker_<name>.log``.  Fails unless
    it exits 0 and leaves no process of its session behind."""
    cmd = [sys.executable, "-m", "dmlc_tpu_torch.tracker.submit",
           "--cluster", "local", "--num-workers", str(workers),
           "--max-attempts", "1", "--host-ip", "127.0.0.1", "--", *argv]
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, err = proc.communicate()
    wall = time.perf_counter() - t0
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"tracker_{name}.log"),
              "w") as f:
        f.write(f"$ {' '.join(cmd)}\nexit {proc.returncode}\n"
                f"--- stdout\n{out}\n--- stderr\n{err}")
    try:
        os.killpg(proc.pid, 0)
        left = True
    except ProcessLookupError:
        left = False
    if left:
        os.killpg(proc.pid, 9)
    check(proc.returncode == 0, f"tracker {name}: exit {proc.returncode}: "
          f"{err[-2000:]}")
    check(not left, f"tracker {name}: processes left behind")
    return out, err, wall


def _epochs(err, word):
    """{rank: {epoch: value}} from the examples' epoch lines."""
    out = {}
    for m in re.finditer(rf"rank (\d+): epoch (\d+) {word} ([0-9.]+)", err):
        out.setdefault(int(m.group(1)), {})[int(m.group(2))] = \
            float(m.group(3))
    return out


def _rendezvous_s(err):
    """Seconds from the tracker's ``listening`` line to its ``all N
    workers started`` line (the launcher's log clock): process start,
    imports and the brokering of every rank."""
    stamps = {}
    for key, pat in (("listen", r"INFO tracker listening on"),
                     ("started", r"INFO @tracker all \d+ workers started")):
        m = re.search(r"(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3}) " + pat,
                      err)
        check(m is not None, f"tracker log has no {key} line")
        h, mi, sec = m.group(1).split(" ")[1].replace(",", ".").split(":")
        stamps[key] = int(h) * 3600 + int(mi) * 60 + float(sec)
    return (stamps["started"] - stamps["listen"]) % 86400


def _finals(err):
    return {int(m.group(1)): json.loads(m.group(2)) for m in
            re.finditer(r"final rank (\d+): (\{.*\})", err)}


def _job_report(name, err, word, epochs, want_algo):
    """Gates and numbers of one distributed example run."""
    per = _epochs(err, word)
    fin = _finals(err)
    check(sorted(per) == list(range(TRACKER_WORKERS))
          and all(sorted(v) == list(range(epochs)) for v in per.values()),
          f"tracker {name}: epoch lines {per}")
    check(sorted(fin) == list(range(TRACKER_WORKERS)),
          f"tracker {name}: final lines for ranks {sorted(fin)}")
    mean = [sum(per[r][e] for r in per) / len(per) for e in range(epochs)]
    check(mean[-1] < mean[0], f"tracker {name}: mean epoch {word} did not "
          f"fall: {mean}")
    shas = {f["sha256"] for f in fin.values()}
    check(len(shas) == 1, f"tracker {name}: final weights differ across "
          f"ranks: {shas}")
    for r, f in fin.items():
        check(f["allreduce_algos"] == {want_algo: epochs * f["steps"]},
              f"tracker {name}: rank {r}'s gradient allreduces ran on "
              f"{f['allreduce_algos']}, not all on {want_algo}")
    steps = fin[0]["steps"]
    return {"epoch_" + word: mean, "per_rank": per, "steps": steps,
            "rendezvous_s": _rendezvous_s(err),
            "epoch_s": {r: f["epoch_s"] for r, f in fin.items()},
            "steps_per_s": {r: epochs * steps / sum(f["epoch_s"])
                            for r, f in fin.items()},
            "allreduce_algos": fin[0]["allreduce_algos"],
            "allreduce_ms_p50": {r: f["allreduce_ms_p50"]
                                 for r, f in fin.items()},
            "allreduce_ms_p99": {r: f["allreduce_ms_p99"]
                                 for r, f in fin.items()},
            "step_ms_p50": {r: f["step_ms_p50"] for r, f in fin.items()},
            "allreduce_share": {r: f["allreduce_share"]
                                for r, f in fin.items()},
            "sha256": shas.pop()}


def _libsvm_parity(svm):
    """The same 4-worker ``train_libsvm`` job on the head of the
    Criteo-shaped file, once on the card and once with ``--device cpu``:
    every rank's unrounded epoch losses agree within ``PARITY_RTOL``, so
    the card's gradient (the int64 gather and its backward) is the
    CPU's, not only one that lowers the loss."""
    head = svm + f".head{PARITY_ROWS}"
    with open(svm, "rb") as f, open(head, "wb") as g:
        g.writelines(itertools.islice(f, PARITY_ROWS))
    argv = [sys.executable, "-m", "dmlc_tpu_torch.examples.train_libsvm",
            head, "2"]
    try:
        card = _finals(_submit("libsvm_head", argv, 300)[1])
        plain = _finals(_submit("libsvm_head_cpu", argv + ["--device", "cpu"],
                                300)[1])
    finally:
        os.unlink(head)
    ranks = list(range(TRACKER_WORKERS))
    check(sorted(card) == sorted(plain) == ranks
          and all(len(card[r]["losses"]) == len(plain[r]["losses"]) == 2
                  for r in ranks),
          f"tracker libsvm parity: final lines {card} vs {plain}")
    rel = max(abs(a - b) / abs(b) for r in ranks
              for a, b in zip(card[r]["losses"], plain[r]["losses"]))
    check(rel <= PARITY_RTOL, f"tracker libsvm parity: card losses "
          f"{[card[r]['losses'] for r in ranks]} vs CPU "
          f"{[plain[r]['losses'] for r in ranks]} (max rel {rel})")
    return {"rows": PARITY_ROWS, "epochs": 2, "rtol": PARITY_RTOL,
            "max_rel_diff": rel,
            "losses_card": {r: card[r]["losses"] for r in ranks},
            "losses_cpu": {r: plain[r]["losses"] for r in ranks},
            "allreduce_algos_card": card[0]["allreduce_algos"]}


def _gbdt(exe, workers):
    out, _, wall = _submit(f"gbdt_{workers}", [exe], 180, workers=workers)
    line = next((ln for ln in out.splitlines()
                 if ln.startswith("gbdt rmse=")), None)
    check(line is not None, f"gbdt with {workers} workers printed no rmse")
    return float(line.split("rmse=")[1].split()[0]), wall


def tracker_phase(smi, svm, csv):
    """4-worker jobs through the port's launcher: the distributed LibSVM
    and CSV examples on the card, the host-collective bench, and the C
    ABI's GBDT consumer (see the module docstring's ``tracker`` entry)."""
    from dmlc_tpu_torch.native import shm_collective as shmc

    shm_before = _dmlc_shm()
    shm_free = shutil.disk_usage("/dev/shm").free
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    # the hier group's chunk, by the C source's rule: the 4 MB default
    # capped at half the free /dev/shm over 2 slots a rank, floor 64 KB
    chunk = max(64 << 10, min(4 << 20, (shm_free // 2 // (TRACKER_WORKERS
                                                          * 2)) & ~7))
    doc = {"phase": "tracker", "card": smi, "compute_mode": mode,
           "host_cpus": os.cpu_count(), "workers": TRACKER_WORKERS,
           "dev_shm_free_bytes": shm_free, "shm_group_chunk_bytes": chunk}

    _, err, wall = _submit("libsvm", [sys.executable, "-m",
                                      "dmlc_tpu_torch.examples.train_libsvm",
                                      svm, "2"], 600)
    doc["libsvm"] = {"launcher_wall_s": wall, **_job_report(
        "libsvm", err, "loss", 2, "hier")}
    doc["libsvm_vs_cpu"] = _libsvm_parity(svm)
    _, err, wall = _submit("csv", [sys.executable, "-m",
                                   "dmlc_tpu_torch.examples.train_csv",
                                   csv, "2"], 300)
    doc["csv"] = {"launcher_wall_s": wall, **_job_report(
        "csv", err, "mse", 2, "tree")}

    out, _, wall = _submit("bench", [
        sys.executable, "-m", "dmlc_tpu_torch.examples.allreduce_worker",
        "bench",
        str(64 << 20), "3"], 300)
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    sweep = [d for d in lines if d["op"].startswith("host_allreduce_")
             and "algbw_MBps" in d]
    check(sorted({d["op"] for d in sweep}) == [
        "host_allreduce_hier", "host_allreduce_ring", "host_allreduce_tree"]
        and len(sweep) == 9, f"tracker bench: sweep lines {sweep}")
    tensors = next((d for d in lines
                    if d["op"] == "host_allreduce_overlap_tensors"), None)
    check(tensors is not None and tensors["equal_to_numpy"]
          and tensors["device"].startswith("cuda"),
          f"tracker bench: CUDA leaves through the bucketer: {tensors}")
    doc["bench"] = {"launcher_wall_s": wall, "sweep": sweep,
                    "overlap": next(d for d in lines
                                    if d["op"] == "host_allreduce_overlap"),
                    "cuda_leaves": tensors}

    lib = shmc.build()
    exe = os.path.join(ROOT, "build", "gbdt_allreduce")
    res = subprocess.run(
        ["gcc", "-O2", "-std=c99", "-I", str(shmc.CSRC),
         os.path.join(ROOT, "examples", "gbdt_allreduce.c"), str(lib),
         "-o", exe, "-lm", "-lrt", f"-Wl,-rpath,{lib.parent}"],
        capture_output=True, text=True, timeout=120)
    check(res.returncode == 0, f"gcc gbdt_allreduce.c: {res.stderr}")
    try:
        single, _ = _gbdt(exe, 1)
        multi, wall = _gbdt(exe, TRACKER_WORKERS)
    finally:
        os.unlink(exe)
    check(single < 0.3 and abs(multi - single) <= GBDT_TOL * single,
          f"gbdt: {TRACKER_WORKERS}-worker rmse {multi} vs single {single}")
    doc["gbdt"] = {"rmse_single": single, "rmse_4": multi,
                   "launcher_wall_s": wall, "tol_rel": GBDT_TOL}

    left = sorted(_dmlc_shm() - shm_before)
    check(not left, f"tracker: /dev/shm segments left behind: {left}")
    doc["dev_shm_left"] = left
    return doc


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from dmlc_tpu_torch.models import transformer as tfm
    from dmlc_tpu_torch.ops import _build
    from dmlc_tpu_torch.ops import flash_attention as fa
    from dmlc_tpu_torch.ops import paged_attention as pa
    from dmlc_tpu_torch import serving
    from dmlc_tpu_torch import telemetry as tele

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build
    secs = _build.build_all()
    ptxas = []
    for src in sorted(_build.CSRC.glob("*.cu")):
        log = _build.library_path(src).with_suffix(".log")
        if log.exists():
            ptxas += [ln.strip() for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln]
    sass = sass_mma_counts([_build.library_path(_build.CSRC / name)
                            for name in ("flash_fwd.cu", "flash_bwd.cu")])
    if sass is not None:
        # K1 at D 64/128, normalised or not; K2 and K3 at D 64/128
        check(len(sass) == 8 and all(c["HGMMA"] > 0 for c in sass.values()),
              f"bf16 flash kernels without wgmma: {sass}")
    emit({"phase": "build", "seconds": secs, "ptxas": ptxas,
          "sass_tensor_core_ops": sass})

    # 3. / 4. kernels against their plain versions
    prompt_lens = [int(x) for x in np.linspace(17, 511, 8)]
    k1, k1_err = flash_phase(fa)
    k23, k23_err, k1_train = flash_bwd_phase(fa)
    k4, k4_err = paged_phase(pa, prompt_lens)

    # 5. the slice
    cfg = tfm.flagship_config()
    t0 = time.perf_counter()
    model = tfm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            "cuda")
    torch.cuda.synchronize()
    emit({"phase": "model", "params": tfm.count_params(cfg),
          "init_s": time.perf_counter() - t0,
          "bytes": sum(p.numel() * p.element_size()
                       for p in model.parameters())})
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in prompt_lens]
    loop = rng.integers(0, cfg.vocab, 7).tolist()
    looping = [(loop * (n // 7 + 1))[:n] for n in prompt_lens]
    serve_batch(serving, model, [prompts[0][:17]], 0)   # warm-up
    fa.FLASH_FWD.launches = 0
    pa.PAGED_ATTENTION.launches = 0
    plain = serve_batch(serving, model, prompts, 0)
    spec = serve_batch(serving, model, looping, 3)
    launches = {"flash_fwd": fa.FLASH_FWD.launches,
                "paged_attention": pa.PAGED_ATTENTION.launches}
    emit({"phase": "slice", "model": "flagship", **plain})
    emit({"phase": "slice_spec", "model": "flagship", **spec})
    emit({"phase": "launches", **launches})
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    emit(logit_checks(tfm, model, cfg))
    TELEMETRY["serving"] = telemetry_serving(serving, tele, fa, model, cfg)
    # a closed engine's KV pools live until the collector breaks the
    # server's handler-class cycle; free them before training's peak
    gc.collect()
    torch.cuda.empty_cache()

    # 6. training
    train_model, one_step, train_launches, step = train_phase(tfm, fa, tele,
                                                              cfg)
    long_step = train_long_phase(tfm, cfg, step)
    emit(grad_checks(tfm, cfg))
    emit(profile_phase(tfm, model, cfg, {"train": one_step,
                                         "train_long": long_step}))
    del train_model, one_step, long_step, step
    torch.cuda.empty_cache()

    # 7. the data spine: the train step fed from RecordIO, checkpointed
    spine_docs = spine_phase(tfm, fa, cfg)
    for doc in spine_docs:
        emit(doc)
    spine_launches = spine_docs[0]["launches"]

    # 8. the sparse text path: LibSVM and CSV through libsvm_feed; then
    # the tracker phase's 4-worker jobs on the same files
    for doc in sparse_phase(smi, spine_docs[2],
                            spine_docs[0]["first_batch_byte_exact"]):
        emit(doc)
    emit({"phase": "telemetry", "card": smi, **TELEMETRY})

    # 9. the kernels line: each kernel's launches on its own path (K1 and
    # K4 serving, K2 and K3 training; K1 also runs 16 times per train step)
    kernels = []
    for kname, src, replaces, row, err, path, counts in (
            ("flash_fwd", "dmlc_tpu_torch/ops/csrc/flash_fwd.cu",
             "dmlc_tpu/ops/flash_attention.py:212", k1, k1_err, "serve",
             launches),
            ("flash_bwd_dkv", "dmlc_tpu_torch/ops/csrc/flash_bwd.cu",
             "dmlc_tpu/ops/flash_attention.py:475",
             k23["flash_bwd_dkv"], k23_err["flash_bwd_dkv"], "train",
             train_launches),
            ("flash_bwd_dq", "dmlc_tpu_torch/ops/csrc/flash_bwd.cu",
             "dmlc_tpu/ops/flash_attention.py:501",
             k23["flash_bwd_dq"], k23_err["flash_bwd_dq"], "train",
             train_launches),
            ("paged_attention", "dmlc_tpu_torch/ops/csrc/paged_attention.cu",
             "dmlc_tpu/ops/paged_attention.py:126", k4, k4_err, "serve",
             launches)):
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": replaces, "path": path,
                        "launches": counts[kname],
                        "spine_launches": spine_launches.get(kname, 0),
                        "max_abs_err": err, "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    # K1 timed alone at the train step's shapes besides its serving row
    kernels[0]["train_ms"] = {f"B{b}xT{t}": r["ms"]
                              for (b, t), r in k1_train.items()}
    emit({"kernels": kernels})
    RESULTS["total_s"] = time.perf_counter() - t_start
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(RESULTS, f, indent=1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
