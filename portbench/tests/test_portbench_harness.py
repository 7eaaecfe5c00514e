"""CPU tests of the port's benchmark harness (``portbench``).

Run from the repository root:

    python -m pytest portbench/tests -q

They check that every cell and metric file loads, the yardstick's
arithmetic against hand-worked values, the traffic generator, a whole
run of a train cell and a serve cell at a tiny size on the CPU (a
configuration that lives only here), that a run whose timed path is
broken reads ``correct`` false, that the float8 control separates from
the program, that new cells, configurations and metrics are added as
files alone, and that nothing under ``portbench/`` imports JAX or the
JAX package (nor the reference the program).  One test needs the card
and skips without it.
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import check, harness, traffic, yardstick
from portbench.reference import model as ref

REPO = Path(__file__).resolve().parents[2]
PB = REPO / "portbench"
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
SEED = 2 ** 33 + 12345

TINY = {"name": "tiny", "source": "tests only", "vocab_size": 128,
        "hidden_size": 32, "num_attention_heads": 2,
        "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 64,
        "num_hidden_layers": 2, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
        "initializer_range": 0.3, "torch_dtype": "float32", "reduced": [],
        "program": {"remat": True, "remat_policy": "save_flash",
                    "engine": {"n_blocks": 64, "block_size": 4,
                               "max_active": 8, "queue_depth": 256,
                               "admit_timeout_s": 10},
                    "env": {"DMLC_COMPUTE_PROFILE": "0"}}}


def _cells(driver: str):
    return [w["name"] for w in SPEC["workloads"]
            if harness.load_json("traffic", w["traffic"])["driver"] == driver]


def _limits(driver: str) -> dict:
    return harness.load_json("workloads", _cells(driver)[0])["limits"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A copy of ``portbench/`` with a tiny train cell and serve cell
    (the real cells' limits), and the spec with them added."""
    root = tmp_path_factory.mktemp("pb") / "portbench"
    shutil.copytree(PB, root, ignore=shutil.ignore_patterns("__pycache__"))
    (root / "configs/tiny.json").write_text(json.dumps(TINY))
    opt = {"lr": 3e-4, "betas": [0.9, 0.999], "eps": 1e-8,
           "weight_decay": 1e-4}
    (root / "traffic/tiny-train.json").write_text(json.dumps(
        {"driver": "train", "batch": 4, "seq": 16, "records": 64,
         "optimizer": opt, "warmup_steps": 5, "trace_steps": 2,
         "host_trace_steps": 1,
         "ref_rows": 2}))
    (root / "traffic/tiny-chat.json").write_text(json.dumps(
        {"driver": "serve", "prompt_tokens": {"lo": 4, "hi": 24},
         "output_tokens": {"lo": 4, "hi": 12}, "preroll_s": 0.5,
         "drain_s": 20, "trace_s": 0.3,
         "host_trace_s": 0.2,
         "check_requests": 3}))
    (root / "traffic/tiny-chat-sat.json").write_text(json.dumps(
        dict(json.loads((root / "traffic/tiny-chat.json").read_text()),
             follow=["pre"])))
    (root / "workloads/tiny-train.json").write_text(json.dumps(
        {"config": "tiny", "traffic": "tiny-train", "chips": 1, "why": "t",
         "limits": _limits("train")}))
    (root / "workloads/tiny-chat.json").write_text(json.dumps(
        {"config": "tiny", "traffic": "tiny-chat", "chips": 1, "why": "t",
         "rate_per_s": 20, "limits": _limits("serve")}))
    (root / "workloads/tiny-chat-sat.json").write_text(json.dumps(
        {"config": "tiny", "traffic": "tiny-chat-sat", "chips": 1,
         "why": "t", "rate_per_s": 40, "limits": _limits("serve")}))
    spec = json.loads(json.dumps(SPEC))
    for group in ("end_to_end", "per_layer"):
        for m in spec[group]:
            if "workloads" in m:
                train = m["workloads"][0] in _cells("train")
                m["workloads"] += (["tiny-train"] if train else
                                   ["tiny-chat", "tiny-chat-sat"])
    torch.set_num_threads(2)
    return root, spec


def _run(tiny, cell: str, trace: bool = False, seconds: float = 1.5,
         seed: int = SEED):
    root, spec = tiny
    run = harness.execute(cell, seed, seconds, trace, torch.device("cpu"),
                          time.perf_counter(), root=root)
    return run, harness.result(run, spec, {"platform": "cpu"}, root=root)


# -- the files ------------------------------------------------------------

def test_every_cell_and_metric_file_loads():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    configs = {c["name"]: c for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        cell = harness.load_json("workloads", w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"],
                cell["why"]) == (w["config"], w["traffic"], w["chips"],
                                 w["why"])
        assert w["config"] in configs
        mix = harness.load_json("traffic", w["traffic"])
        assert (PB / "drivers" / f"{mix['driver']}.py").is_file()
        reported = {m["name"] for m in harness.cell_metrics(
            SPEC, w["name"], False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.cell_metrics(SPEC, w["name"], True)
    for c in SPEC["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", [w["name"] for w in SPEC["workloads"]]):
            reported = {x["name"] for x in harness.cell_metrics(
                SPEC, cell, False)}
            assert m["moves"] in reported, (m["name"], cell)


# -- the yardstick --------------------------------------------------------

def test_flagship_train_step_flops():
    w = yardstick.widths(harness.load_json("configs", "flagship-1b"))
    flops = yardstick.train_step_flops(w, 8, 1024)
    # 5.84 GFLOP a token (3 x the forward's 1.879 G of products and
    # 0.0672 G of attention at T=1024) x 8192 tokens
    assert flops == pytest.approx(47.8e12, rel=1e-3)
    per_layer = 2 * (2048 * 2048 * 4 + 3 * 2048 * 6144)
    assert yardstick.dense_flops_per_token(w) == 16 * per_layer


def test_attention_kernel_costs_by_hand():
    w = yardstick.widths(TINY)               # H=2, D=16, bf16 not: float32
    # a causal sequence of 4: 10 visible pairs, 4·D FLOPs a pair and head
    assert yardstick.k1_cost(w, 1, 4)["flops"] == 4 * 16 * 2 * 10
    assert yardstick.k1_cost(w, 2, 4)["bytes"] == 4 * 2 * 4 * 32 * 4
    assert yardstick.k2_cost(w, 1, 4)["flops"] == 8 * 16 * 2 * 10
    assert yardstick.k3_cost(w, 1, 4)["flops"] == 6 * 16 * 2 * 10
    # rows with 3 and 0 committed tokens read 4 + 1 live K/V each
    k4 = yardstick.k4_cost(w, [3, 0])
    assert k4["flops"] == 4 * 16 * 2 * 5
    assert k4["bytes"] == 2 * 5 * 2 * 16 * 4 + 2 * 2 * 32 * 4
    peak = {"bf16_flops": 1e12, "hbm_bytes": 1e9}
    assert yardstick.bound_s(k4, peak) == k4["bytes"] / 1e9


def test_decode_step_cost_by_hand():
    w = yardstick.widths(TINY)
    layer = 32 * 32 * 4 + 3 * 32 * 64 + 2 * 32
    weights = (2 * layer + 32 + 32 * 128) * 4
    assert yardstick.weight_bytes(w) == weights
    cost = yardstick.decode_step_cost(w, [5])
    kv = 2 * 2 * 2 * 16 * 4                  # K and V, 2 layers, a token
    assert cost["bytes"] == weights + 32 * 4 + 5 * kv + kv
    assert cost["flops"] == pytest.approx(
        2 * 2 * (32 * 32 * 4 + 3 * 32 * 64) + 2 * 32 * 128 + 2 * 4 * 32 * 6)


# -- traffic --------------------------------------------------------------

def test_every_seed_gets_the_same_work_in_another_order():
    mix = harness.load_json("traffic", "chat-sat")
    a = traffic.serve_schedule(mix, 5.0, 40.0, 1)
    b = traffic.serve_schedule(mix, 5.0, 40.0, 2 ** 40 + 3)
    for seg in ("pre", "window", "post"):
        sa = [x for x in a if x.segment == seg]
        sb = [x for x in b if x.segment == seg]
        assert sorted(x.prompt for x in sa) == sorted(x.prompt for x in sb)
        assert sorted(x.output for x in sa) == sorted(x.output for x in sb)
        assert [x.prompt for x in sa] != [x.prompt for x in sb]
    win = [x for x in a if x.segment == "window"]
    assert len(win) == 200 and 0 <= win[0].due_s and win[-1].due_s < 40
    assert all(128 <= x.prompt <= 1024 and 64 <= x.output <= 512 for x in a)


def test_the_program_reads_the_benchmarks_recordio(tmp_path):
    from dmlc_tpu_torch.io.recordio import RecordIOReader
    from dmlc_tpu_torch.io.stream import Stream

    mix = {"records": 5, "seq": 7}
    toks = traffic.train_tokens(mix, 1000, SEED)
    path = str(tmp_path / "t.rec")
    traffic.write_recordio(path, toks)
    with Stream.create(path, "r") as s:
        r = RecordIOReader(s)
        rows = []
        while True:
            rec = r.next_record()
            if rec is None:
                break
            rows.append(bytes(rec))
    assert rows == [row.numpy().astype("<i4").tobytes() for row in toks]


# -- whole runs -----------------------------------------------------------

@pytest.mark.parametrize("cell", ["tiny-train", "tiny-chat",
                                  "tiny-chat-sat"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_end_to_end(tiny, cell, trace):
    run, out = _run(tiny, cell, trace)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["checks"]["failed"] == {"value": 0.0, "limit": 0.0}
    if cell == "tiny-chat-sat":
        # the pre-roll's requests are followed to their end and judged
        assert {r["segment"] for r in run.work["requests"]} >= {"pre"}
    assert list(out)[-1] == "checks"
    names = {m["name"] for m in harness.cell_metrics(tiny[1], cell, trace)}
    assert set(out["metrics"]) <= names
    if not trace:
        assert set(out["metrics"]) == names


def _half_batch(monkeypatch):
    from dmlc_tpu_torch.models import transformer as tfm

    inner = tfm.unsharded_loss

    def half(model, ids, labels, impl=None):
        n = ids.shape[0] // 2
        return inner(model, ids[:n], labels[:n], impl)

    monkeypatch.setattr(tfm, "unsharded_loss", half)


def _unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)


def _altered_token(monkeypatch):
    from dmlc_tpu_torch.serving.engine import InferenceEngine

    inner = InferenceEngine._exec

    def altered(self, plan):
        out = inner(self, plan)
        if plan["op"] == "paged":
            out = out.clone()
            out[0, 0, (int(out[0, 0].argmax()) + 7) % out.shape[-1]] += 1e3
        return out

    monkeypatch.setattr(InferenceEngine, "_exec", altered)


def _refused(monkeypatch):
    from dmlc_tpu_torch.serving.engine import AdmissionFull, InferenceEngine

    inner = InferenceEngine.submit
    calls = []

    def refuse_third(self, prompt_ids, max_new_tokens=None, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise AdmissionFull("refused")
        return inner(self, prompt_ids, max_new_tokens=max_new_tokens, **kw)

    monkeypatch.setattr(InferenceEngine, "submit", refuse_third)


def _truncated(monkeypatch):
    from dmlc_tpu_torch.serving.engine import InferenceEngine

    inner = InferenceEngine.submit

    def one_short(self, prompt_ids, max_new_tokens=None, **kw):
        return inner(self, prompt_ids, max_new_tokens=max_new_tokens - 1,
                     **kw)

    monkeypatch.setattr(InferenceEngine, "submit", one_short)


@pytest.mark.parametrize("cell,fault", [
    ("tiny-train", _unchanged), ("tiny-train", _half_batch),
    ("tiny-chat", _altered_token), ("tiny-chat-sat", _refused),
    ("tiny-chat-sat", _truncated)],
    ids=["state-unchanged", "half-batch", "altered-token",
         "refused-request", "truncated-request"])
def test_a_broken_timed_path_reads_incorrect(tiny, monkeypatch, cell, fault):
    fault(monkeypatch)
    run, out = _run(tiny, cell)
    assert out["correct"] is False, out["checks"]


def test_the_float8_control_fails_the_train_limits(tiny):
    cfg = TINY
    mix = harness.load_json("traffic", "tiny-train", tiny[0])
    drv = harness.load_module("drivers", "train", tiny[0])
    toks = traffic.train_tokens(mix, cfg["vocab_size"], SEED)
    f32 = drv.reference(cfg, mix, SEED, torch.device("cpu"), toks)
    fp8 = drv.reference(cfg, mix, SEED, torch.device("cpu"), toks,
                        prec="fp8")
    gaps = check.train_gaps(fp8, f32)
    limits = _limits("train")
    assert any(gaps[k] > limits[k] for k in limits), gaps


def test_the_float8_control_fails_the_serve_limit():
    seqs = [torch.randint(0, 128, (60,), generator=torch.Generator()
                          .manual_seed(i)).tolist() for i in range(3)]
    logits = ref.served_logits(TINY, SEED, torch.device("cpu"), seqs,
                               [20] * 3, ("f32", "fp8"))
    firsts = [lg.argmax(-1).tolist() for lg in logits["fp8"]]
    gap = float(check.token_gaps(logits["f32"], firsts).max())
    assert gap > _limits("serve")["max_gap"]


# -- what later changes add ------------------------------------------------

def test_new_files_alone_add_a_config_a_cell_and_a_metric(tiny, tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(tiny[0], root)
    cfg = dict(TINY, num_hidden_layers=1)
    (root / "configs/tiny-1l.json").write_text(json.dumps(cfg))
    (root / "workloads/tiny-1l-train.json").write_text(json.dumps(
        {"config": "tiny-1l", "traffic": "tiny-train", "chips": 1,
         "why": "t", "limits": _limits("train")}))
    (root / "metrics/steps_in_window.train.py").write_text(
        "def read(run):\n    return run.work.get('steps')\n")
    spec = json.loads(json.dumps(tiny[1]))
    for m in spec["end_to_end"]:
        if "workloads" in m and "tiny-train" in m["workloads"]:
            m["workloads"].append("tiny-1l-train")
    spec["end_to_end"].append({"name": "steps_in_window.train",
                               "unit": "steps", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["tiny-1l-train"]})
    run = harness.execute("tiny-1l-train", SEED, 1.0, False,
                          torch.device("cpu"), time.perf_counter(), root=root)
    out = harness.result(run, spec, {"platform": "cpu"}, root=root)
    assert out["metrics"]["steps_in_window.train"]["value"] >= 1
    assert out["correct"] is True


# -- what the harness may load --------------------------------------------

def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    for path in PB.rglob("*.py"):
        bad = {"jax", "jaxlib", "flax", "dmlc_tpu"}
        if "reference" in path.relative_to(PB).parts:
            bad.add("dmlc_tpu_torch")
        found = set(_imports(path)) & bad
        assert not found, (path, found)


def test_a_loaded_jax_is_refused(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax", object())
    monkeypatch.setitem(sys.modules, "dmlc_tpu_torch_x", object())
    assert harness.forbidden_modules() == ["jax"]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, str(PB / "run.py"), "--workload",
         SPEC["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0 and p.stdout == ""


# -- on the card ----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_the_float8_control_fails_on_the_card(card):
    """The first train cell's control at its own size, one seed."""
    p = subprocess.run(
        [sys.executable, str(PB / "control.py"), "--workload",
         _cells("train")[0], "--seeds", str(SEED)], cwd=REPO,
        capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    summ = json.loads(p.stdout.strip().splitlines()[-1])["summary"]
    limits = _limits("train")
    assert any(summ[f"control.{k}"] > v for k, v in limits.items()), summ
