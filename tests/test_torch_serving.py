"""Port parity and invariants of the port's serving package.

* Greedy outputs of the port's engine are token-identical to the JAX
  engine's (paged path on) on the same weights, through forced
  preemption, with and without speculative decoding (the pattern of
  tests/test_decode_fast_path.py).
* Allocator and scheduler invariants, the HTTP surface, the device rule
  (no card and no device → raise), and the import rule (the port and
  chip_smoke.py pull in no jax and nothing of dmlc_tpu).
"""

import ast
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import dmlc_tpu_torch
from dmlc_tpu.models import transformer as jtfm
from dmlc_tpu.serving import InferenceEngine as JaxEngine
from dmlc_tpu_torch.base import DMLCError
from dmlc_tpu_torch.models import transformer as ttfm
from dmlc_tpu_torch.models.convert import params_from_jax
from dmlc_tpu_torch.serving import (BlockAllocator, ContinuousBatchScheduler,
                                    InferenceEngine, PagedKVCache, Request,
                                    ServingHTTPServer)

ROOT = Path(__file__).resolve().parents[1]
DIMS = dict(vocab=64, d_model=32, n_heads=2, head_dim=8, d_ff=64,
            n_layers=2, n_experts=1)


@pytest.fixture(scope="module")
def weights():
    jcfg = jtfm.TransformerConfig(**DIMS, microbatches=1)
    params = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            ttfm.TransformerConfig(**DIMS), device="cpu")
    return params, jcfg, model


def _drive(engine, max_new):
    """3 requests through a pool too small for them to coexist."""
    engine.start()
    try:
        reqs = [engine.submit([i + 1] * 4, max_new_tokens=max_new)
                for i in range(3)]
        for r in reqs:
            assert r.wait(300), f"request {r.id} never finished"
            assert r.error is None, r.error
            assert r.n_generated == max_new
        return [list(r.generated) for r in reqs]
    finally:
        engine.close()


@pytest.mark.parametrize("spec_k", [0, 3])
def test_greedy_outputs_match_jax_engine_through_preemption(
        weights, monkeypatch, spec_k):
    params, jcfg, model = weights
    monkeypatch.setenv("DMLC_SERVE_PAGED_ATTN", "on")
    monkeypatch.setenv("DMLC_SERVE_SPEC_K", str(spec_k))
    monkeypatch.setenv("DMLC_SERVE_SPEC_MIN_CTX", "4")
    max_new = 12
    kw = dict(n_blocks=6, block_size=4, max_active=3, queue_depth=8)
    want = _drive(JaxEngine(params, jcfg, **kw), max_new)
    eng = InferenceEngine(model, device="cpu", **kw)
    assert eng.spec_k == spec_k
    got = _drive(eng, max_new)
    assert got == want
    assert eng.counters["preemptions"] > 0, "pool must force preemption"
    if spec_k:
        assert eng.counters["spec_proposed"] > 0


def test_crashed_iteration_requeues_and_output_is_unchanged(weights,
                                                            monkeypatch):
    """A decode step that raises once: the active requests are requeued
    for recompute-resume and finish with the same greedy output."""
    from dmlc_tpu_torch.serving import engine as eng_mod

    _, _, model = weights
    kw = dict(device="cpu", n_blocks=16, block_size=4, max_active=3)
    want = _drive(InferenceEngine(model, **kw), 6)
    real, calls = eng_mod.forward_decode_paged, []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected decode failure")
        return real(*a, **k)

    monkeypatch.setattr(eng_mod, "forward_decode_paged", flaky)
    eng = InferenceEngine(model, **kw)
    assert _drive(eng, 6) == want
    assert eng.counters["crash_requeues"] > 0


def test_allocator_double_free_and_all_or_nothing():
    a = BlockAllocator(4)
    got = a.alloc_many(3)
    assert a.alloc_many(2) is None and a.n_free == 1   # nothing taken
    a.free(got[:1])
    with pytest.raises(DMLCError):
        a.free(got[:1])
    with pytest.raises(DMLCError):                      # validated first
        a.free([got[1], 99])
    assert a.n_in_use == 2


def test_scheduler_preempts_youngest_and_requeues_front():
    cache = PagedKVCache(1, 1, 4, n_blocks=8, block_size=4, device="cpu")
    sched = ContinuousBatchScheduler(cache, max_active=3)
    reqs = [Request([1, 2, 3], 4) for _ in range(3)]
    for r in reqs:
        sched.enqueue(r)
        got = sched.next_prefill()
        assert got is r
        assert cache.allocate(r.id, 3)
        sched.activate(r)
    victim = sched.preempt_youngest()
    assert victim is reqs[-1] and victim.preemptions == 1
    assert reqs[-1].id not in cache.live_sequences()
    late = Request([4], 2)
    sched.enqueue(late)
    assert sched.next_prefill() is victim   # front of the queue


def test_cache_write_and_advance_bookkeeping():
    cache = PagedKVCache(2, 1, 3, n_blocks=4, block_size=2, device="cpu")
    assert cache.allocate(7, 3)
    k = torch.arange(2 * 3 * 3, dtype=torch.float32).reshape(2, 3, 1, 3)
    cache.write(7, k, -k)
    blocks = cache.block_table(7)
    assert cache.length(7) == 3
    torch.testing.assert_close(cache.k_pool[:, blocks[1], 0], k[:, 2])
    with pytest.raises(DMLCError):                  # past the reservation
        cache.advance_many([(7, 2)])
    assert cache.extend(7, 2)
    cache.advance_many([(7, 2)])
    tables, lengths = cache.block_tables_array([7])
    assert lengths.tolist() == [5] and tables.dtype == torch.int32


def test_http_generate_and_healthz(weights):
    _, _, model = weights
    eng = InferenceEngine(model, device="cpu", n_blocks=16, block_size=4,
                          max_active=2)
    eng.start()
    srv = ServingHTTPServer(eng)
    try:
        def post(doc):
            req = urllib.request.Request(
                srv.url + "/generate", data=json.dumps(doc).encode(),
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        code, doc = post({"prompt": [1, 2, 3], "max_tokens": 5})
        assert code == 200 and doc["n_generated"] == 5 \
            and doc["state"] == "done"
        assert post({"prompt": "nope"})[0] == 400
        assert post({"prompt": [999]})[0] == 400          # out of vocab
        assert post({"prompt": [1], "max_tokens": 500})[0] == 413
        assert eng.generate([1, 2, 3], 5) == doc["output_ids"]  # greedy
        with urllib.request.urlopen(srv.url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["counters"]["prefills"] >= 1
        assert set(health["kernel_launches"]) == {"flash_fwd",
                                                  "paged_attention"}
    finally:
        srv.close()
        eng.close()


def test_engine_without_device_raises_without_card(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device resolves")
    with pytest.raises(DMLCError, match="no CUDA device"):
        InferenceEngine(weights[2])


def test_kv_cache_without_device_raises_without_card():
    """A cache built without a device goes to the card, as the engine's
    does; with no card it raises instead of building its pools on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device resolves")
    with pytest.raises(DMLCError, match="no CUDA device"):
        PagedKVCache(1, 1, 4, n_blocks=2, block_size=2)
    assert PagedKVCache(1, 1, 4, n_blocks=2, block_size=2,
                        device="cpu").k_pool.device.type == "cpu"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _foreign(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "dmlc_tpu") or top.startswith("jax_")


def test_port_and_chip_smoke_import_no_jax_or_reference():
    smoke = ROOT / "chip_smoke.py"
    assert not [m for m in _imported_modules(smoke) if _foreign(m)]
    pkg = dmlc_tpu_torch.__name__
    for py in Path(dmlc_tpu_torch.__file__).parent.rglob("*.py"):
        assert not [m for m in _imported_modules(py) if _foreign(m)], py
    code = (
        "import importlib, pkgutil, sys\n"
        f"import {pkg}\n"
        f"for m in pkgutil.walk_packages({pkg}.__path__, '{pkg}.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in"
        " ('jax', 'jaxlib', 'dmlc_tpu'))\n"
        # every kernel source is bound by a wrapper in a walked module
        f"from {pkg}.ops._build import CSRC, Kernel\n"
        "bound = {v.source.name for m in list(sys.modules.values())"
        f" if m and m.__name__.startswith('{pkg}')"
        " for v in vars(m).values() if isinstance(v, Kernel)}\n"
        "bad += sorted(p.name for p in CSRC.glob('*.cu')"
        " if p.name not in bound)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stdout + res.stderr
