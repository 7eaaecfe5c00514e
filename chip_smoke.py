#!/usr/bin/env python3
"""GPU smoke of the PyTorch/H100 port (``dmlc_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. device   the card's name; its name and power limit as nvidia-smi
            gives them, on a line of their own
2. build    nvcc builds every kernel in ``dmlc_tpu_torch/ops/csrc``
3. flash    kernel K1 (flash-attention forward) against its plain
            PyTorch version on the card: B=1, H=16, D=128, T in
            {512, 1000}, causal and not, bf16 and f32, plus (pv, m, l)
            calls at non-zero offsets; kernel, plain and
            ``F.scaled_dot_product_attention`` (yardstick only) times
4. paged    kernel K4 (paged decode attention) likewise: B=8, H=16,
            D=128, bf16 pools, block 16, windows S in {1, 4}
5. slice    the flagship model (full width and depth, random weights
            from seed 0) served by the port's engine behind its HTTP
            server (POST /generate on localhost): 8 requests, prompt
            lengths 17..511, 32 new tokens, then 8 looping prompts with
            speculative decoding (spec_k=3); kernel launch counts are
            zeroed just before and read just after; one prefill and one
            decode step are then held against the plain versions (gated
            on a float32 copy of the weights; bf16 reported beside its
            own rounding noise floor)
   profile  device time by kernel category for one flagship prefill and
            one decode step (torch.profiler), beside their wall times
6. kernels  one line ``{"kernels": [...]}``: per kernel its launches on
            the main path, max error, times and roofline bound

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card
the script exits with code 2 and prints no result.  Details go to
``chiprun_out/chip_smoke.json``.
"""

import dataclasses
import json
import math
import os
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

RESULTS = {}


def emit(doc):
    print(json.dumps(doc), flush=True)
    RESULTS.setdefault("lines", []).append(doc)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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
                nbytes = 4 * b * t * h * d * q.element_size()
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
    # KV range past every query (rows with no visible key)
    for q_off, kv_off, tq, tk in ((512, 0, 256, 768), (0, 64, 128, 192)):
        q = torch.randn((b, tq, h, d), generator=gen, device="cuda")
        k = torch.randn((b, tk, h, d), generator=gen, device="cuda")
        v = torch.randn((b, tk, h, d), generator=gen, device="cuda")
        kw = dict(scale=d ** -0.5, causal=True, q_offset=q_off,
                  kv_offset=kv_off)
        pv, m, l = fa.block_attend(q, k, v, **kw)
        pv_r, m_r, l_r = fa.block_attend(q, k, v, impl="torch", **kw)
        torch.cuda.synchronize()
        o = pv / l.clamp_min(1e-20).transpose(1, 2)[..., None]
        o_r = pv_r / l_r.clamp_min(1e-20).transpose(1, 2)[..., None]
        e_o = errors(o, o_r)[0]
        e_m = errors(m, m_r)[0]
        e_l = ((l - l_r).abs() / l_r.clamp_min(1.0)).max().item()
        check(all(torch.isfinite(x).all() for x in (pv, m, l)),
              "non-finite (pv, m, l)")
        check(max(e_o, e_m, e_l) <= F32_TOL,
              f"block_attend offsets {q_off}/{kv_off}: {e_o} {e_m} {e_l}")
        emit({"phase": "flash_offsets", "q_offset": q_off,
              "kv_offset": kv_off, "Tq": tq, "Tk": tk, "o_err": e_o,
              "m_err": e_m, "l_rel_err": e_l})
    return main, worst


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
    want = pa.paged_attention(q, kp, vp, tables, lens, impl="torch")
    torch.cuda.synchronize()
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
    if "flash_fwd_kernel" in low:
        return "flash_fwd"
    if "paged_attention_kernel" in low:
        return "paged_attention"
    if any(s in low for s in ("gemm", "cutlass", "nvjet", "xmma", "cublas")):
        return "gemm"
    if "memcpy" in low or "memset" in low:
        return "memcpy"
    return "other"


def profile_phase(tfm, model, cfg):
    """Device time by kernel category for one flagship prefill (T=512)
    and one decode step (B=8), beside the step's wall time (host clock
    around a synchronised call, profiler off); idle = 1 - busy / wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    inp = slice_inputs(cfg)
    _, k, v = prefill(tfm, model, inp)
    kp, vp = decode_pools(cfg, k, v, inp)
    steps = {"prefill": lambda: prefill(tfm, model, inp),
             "decode": lambda: decode(tfm, model, inp, kp, vp)}
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
        cats = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total:
                c = _category(e.key)
                cats[c] = cats.get(c, 0.0) + e.self_device_time_total / 1e3
        wall_ms = sorted(walls)[len(walls) // 2] * 1e3
        busy = sum(cats.values())
        host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                       for e in prof.key_averages()
                       if e.key.startswith("aten::")), reverse=True)[:8]
        doc[name] = {"wall_ms": wall_ms, "device_ms": cats,
                     "device_busy_ms": busy,
                     "idle_share": (1 - busy / wall_ms) if busy else None,
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
    emit({"phase": "build", "seconds": secs, "ptxas": ptxas})

    # 3. / 4. kernels against their plain versions
    prompt_lens = [int(x) for x in np.linspace(17, 511, 8)]
    k1, k1_err = flash_phase(fa)
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
    emit(profile_phase(tfm, model, cfg))

    # 6. the kernels line
    kernels = []
    for kname, src, replaces, row, err in (
            ("flash_fwd", "dmlc_tpu_torch/ops/csrc/flash_fwd.cu",
             "dmlc_tpu/ops/flash_attention.py:212", k1, k1_err),
            ("paged_attention", "dmlc_tpu_torch/ops/csrc/paged_attention.cu",
             "dmlc_tpu/ops/paged_attention.py:126", k4, k4_err)):
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[kname],
                        "max_abs_err": err, "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
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
