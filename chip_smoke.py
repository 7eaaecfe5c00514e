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
7. kernels  one line ``{"kernels": [...]}``: per kernel its launches on
            its path, max error, times and roofline bound

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card
the script exits with code 2 and prints no result.  Details go to
``chiprun_out/chip_smoke.json``.
"""

import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
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


def train_phase(tfm, fa, cfg):
    """The flagship train step at B=8 x T=1024: 2 warm-up steps, then the
    counters are zeroed and 8 steps timed on the same batch."""
    model = tfm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            "cuda")
    step = tfm.make_train_step(model, tfm.adamw(model.parameters(), 1e-4))
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

    # 6. training
    train_model, one_step, train_launches, step = train_phase(tfm, fa, cfg)
    long_step = train_long_phase(tfm, cfg, step)
    emit(grad_checks(tfm, cfg))
    emit(profile_phase(tfm, model, cfg, {"train": one_step,
                                         "train_long": long_step}))
    del train_model, one_step, long_step, step

    # 7. the kernels line: each kernel's launches on its own path (K1 and
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
