"""The port's data spine end to end on the CPU against the JAX package:
RecordIO shards from the JAX example's ``make_data`` → input split →
device feed → train steps (JAX ``unsharded_loss`` + ``optax.adamw``
against the port's loop, 5 steps, losses within 1e-5 relative: the
same f32 arithmetic summed in another order, the tolerance of the
port's train-step parity) → checkpoint at step 3 and resume, exact on
the CPU → the example module run as a program."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import optax

from dmlc_tpu.feed import recordio_feed as jax_recordio_feed
from dmlc_tpu.models import transformer as jtfm
from dmlc_tpu.parallel import build_mesh
from dmlc_tpu_torch.examples import train_lm_recordio as port_example
from dmlc_tpu_torch.models import transformer as ttfm
from dmlc_tpu_torch.models.convert import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
DIMS = dict(vocab=512, d_model=64, n_heads=4, head_dim=16, d_ff=128,
            n_layers=2, n_experts=1)
STEPS = 5


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_train_lm_recordio", ROOT / "examples" / "train_lm_recordio.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("spine") / "tokens.rec")
    _jax_example().make_data(path, n_records=48, seed=3)
    return path


def _jax_params():
    jcfg = jtfm.TransformerConfig(**DIMS, microbatches=1, remat=True,
                                  dtype="float32")
    return jtfm.init_params(jax.random.PRNGKey(1), jcfg, n_stages=1), jcfg


def _port_model(params):
    return params_from_jax(jax.tree.map(np.asarray, params),
                           ttfm.TransformerConfig(**DIMS, remat=True),
                           device="cpu")


def test_make_data_matches_jax_example(tmp_path):
    _jax_example().make_data(str(tmp_path / "j.rec"), n_records=20, seed=5)
    port_example.make_data(str(tmp_path / "p.rec"), n_records=20, seed=5)
    assert (tmp_path / "j.rec").read_bytes() == \
        (tmp_path / "p.rec").read_bytes()


def test_spine_losses_match_jax(shard):
    params, jcfg = _jax_params()
    opt = optax.adamw(port_example.LR)
    state = opt.init(params)
    loss_grad = jax.jit(jax.value_and_grad(
        lambda p, i, l: jtfm.unsharded_loss(p, i, l, jcfg)))
    mesh = build_mesh(1, dp=1, sp=1, tp=1, pp=1, ep=1)
    feed = jax_recordio_feed(
        shard, mesh, batch_records=port_example.PER_PART,
        max_bytes=(port_example.SEQ + 1) * 4)
    want = []
    for batch in feed:
        if len(want) == STEPS:
            break
        toks = np.asarray(batch["data"]).view("<i4")
        loss, g = loss_grad(params, toks[:, :-1], toks[:, 1:])
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
        want.append(float(loss))
    feed.close()
    got = port_example.run(shard, STEPS, device="cpu",
                           model=_port_model(_jax_params()[0]))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_resume_is_exact_on_cpu(shard, tmp_path):
    def model():
        return _port_model(_jax_params()[0])

    whole = port_example.run(shard, STEPS, device="cpu", model=model())
    ckpt = str(tmp_path / "ckpt")
    # each run saves at its end: step 3, then step 5 after resuming
    first = port_example.run(shard, 3, ckpt, device="cpu", model=model())
    rest = port_example.run(shard, STEPS - 3, ckpt, device="cpu",
                            model=model())
    assert first == whole[:3]
    assert rest == whole[3:]          # exact: same arithmetic on the CPU
    assert sorted(os.listdir(ckpt)) == ["LATEST", "step_00000003",
                                        "step_00000005"]


def test_example_runs_as_a_program(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    mod = [sys.executable, "-m", port_example.__name__]
    rec = str(tmp_path / "out.rec")
    res = subprocess.run(mod + ["--make-data", rec], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    res = subprocess.run(mod + [rec, "2", str(tmp_path / "ck"), "--device",
                                "cpu"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    assert "step 1: loss" in res.stdout and "final loss" in res.stdout
    assert os.path.exists(tmp_path / "ck" / "step_00000002" /
                          "manifest.json")


def test_example_without_device_raises_without_card(shard):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from dmlc_tpu_torch.base import DMLCError

    with pytest.raises(DMLCError, match="no CUDA device"):
        port_example.run(shard, 1)


def test_example_raises_on_a_shard_without_a_full_batch(tmp_path):
    from dmlc_tpu_torch.base import DMLCError

    rec = str(tmp_path / "short.rec")
    port_example.make_data(rec, n_records=port_example.PER_PART - 1)
    with pytest.raises(DMLCError, match="no full batch"):
        port_example.run(rec, 1, device="cpu",
                         model=_port_model(_jax_params()[0]))
