"""The port's checkpoints and its LM example on object stores, against the
JAX package over the JAX package's own emulators: a tree saved by either
package on gs://, s3://, hdfs:// or azure:// restores bitwise in the
other (a sharded JAX save too), a train state crosses on gs://, the
port's manager on gs:// skips a torn step and keeps every step, falls
back on the ``LATEST`` hint where the store cannot be listed (an
http:// mirror), and the example trains from an s3:// shard against the
JAX loop and resumes exactly from gs://.  Last, ``chip_smoke``'s
``remote`` phase end to end on the CPU at a small width."""

import http.server
import importlib.util
import os
import sys
import threading
from functools import partial
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from dmlc_tpu.checkpoint import CheckpointManager as JaxManager
from dmlc_tpu.checkpoint import restore_pytree as jax_restore
from dmlc_tpu.checkpoint import save_pytree as jax_save
from dmlc_tpu.feed import recordio_feed as jax_recordio_feed
from dmlc_tpu.io.filesys import FileSystem as JaxFileSystem
from dmlc_tpu.models import transformer as jtfm
from dmlc_tpu.parallel import build_mesh
from dmlc_tpu_torch.checkpoint import (CheckpointManager, restore_pytree,
                                       save_pytree)
from dmlc_tpu_torch.examples import train_lm_recordio as port_example
from dmlc_tpu_torch.io import gcs_filesys
from dmlc_tpu_torch.io.filesys import FileSystem
from dmlc_tpu_torch.io.stream import Stream
from dmlc_tpu_torch.models import transformer as ttfm
from dmlc_tpu_torch.models.convert import (params_from_jax,
                                           train_state_from_jax,
                                           train_state_to_jax)
from tests.test_gcs_http import _FakeGCS
from tests.test_hdfs_azure import _FakeAzure, _FakeNameNode
from tests.test_s3 import _FakeS3

ROOT = Path(__file__).resolve().parents[1]
DIMS = dict(vocab=512, d_model=64, n_heads=4, head_dim=16, d_ff=128,
            n_layers=2, n_experts=1)


def _drop_instances():
    for fs in (FileSystem, JaxFileSystem):
        for key in [k for k in fs._instances if k != "file://"]:
            del fs._instances[key]


@pytest.fixture
def stores(monkeypatch):
    """All four emulators, each store cleared, both packages'
    FileSystems dropped before and after."""
    for handler in (_FakeS3, _FakeGCS, _FakeNameNode, _FakeAzure):
        handler.store.clear()
    _FakeS3.uploads.clear()
    _FakeGCS.sessions.clear()
    _FakeAzure.blocks.clear()
    servers = {}
    for name, handler in (("s3", _FakeS3), ("gs", _FakeGCS),
                          ("hdfs", _FakeNameNode), ("azure", _FakeAzure)):
        srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers[name] = srv
    port = {n: f"127.0.0.1:{s.server_port}" for n, s in servers.items()}
    for key, value in (("DMLC_S3_ENDPOINT", port["s3"]),
                       ("AWS_ACCESS_KEY_ID", "AKIACKPT"),
                       ("AWS_SECRET_ACCESS_KEY", "ckpt-secret"),
                       ("AWS_REGION", "us-test-1"),
                       ("STORAGE_EMULATOR_HOST", port["gs"]),
                       ("DMLC_WEBHDFS_ENDPOINT", port["hdfs"]),
                       ("DMLC_AZURE_ENDPOINT", port["azure"]),
                       ("AZURE_STORAGE_ACCOUNT", "testacct"),
                       ("AZURE_STORAGE_ACCESS_KEY",
                        "c2VjcmV0LWtleS1mb3ItdGVzdHM=")):
        monkeypatch.setenv(key, value)
    for key in ("AWS_SESSION_TOKEN", "AZURE_STORAGE_SAS_TOKEN",
                "GCS_OAUTH_TOKEN", "DMLC_FAULT_SPEC"):
        monkeypatch.delenv(key, raising=False)
    _drop_instances()
    yield servers
    _drop_instances()
    for srv in servers.values():
        srv.shutdown()
        srv.server_close()
    for handler in (_FakeS3, _FakeGCS, _FakeNameNode, _FakeAzure):
        handler.store.clear()


BASES = {"gs": "gs://ckpts/run1", "s3": "s3://ckpts/run1",
         "hdfs": "hdfs://nn/ckpts/run1", "azure": "azure://ckpts/run1"}


def _tree():
    rng = np.random.default_rng(0)
    return {"w": torch.from_numpy(rng.standard_normal((8, 8)).astype(
                np.float32)),
            "b": np.ones(3, np.float32),
            "h": torch.from_numpy(rng.standard_normal((4, 6)).astype(
                np.float32)).to(torch.bfloat16),
            "n": np.arange(5, dtype=np.int64)}


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("store", sorted(BASES))
def test_tree_roundtrip_on_each_store_both_ways(stores, store):
    """The port's save restores bitwise in both packages, and a JAX save
    in the port (the counterparts of ``tests/test_checkpoint.py``'s
    gs:// and s3:// / hdfs:// round trips)."""
    tree = _tree()
    uri = f"{BASES[store]}/port"
    nbytes = save_pytree(uri, tree)
    assert nbytes == 8 * 8 * 4 + 3 * 4 + 4 * 6 * 2 + 5 * 8
    got = restore_pytree(uri, tree)
    want = jax_restore(uri, jax.tree.map(np.asarray, {
        "w": tree["w"].numpy(), "b": tree["b"],
        "h": np.zeros((4, 6), jnp.bfloat16), "n": tree["n"]}))
    for k in tree:
        np.testing.assert_array_equal(_bits(got[k]), _bits(tree[k]))
        np.testing.assert_array_equal(_bits(want[k]), _bits(tree[k]))
    juri = f"{BASES[store]}/jax"
    jax_save(juri, {"w": tree["w"].numpy(), "b": tree["b"],
                    "h": jnp.asarray(tree["h"].float().numpy(),
                                     jnp.bfloat16), "n": tree["n"]})
    back = restore_pytree(juri, tree)
    for k in tree:
        np.testing.assert_array_equal(_bits(back[k]), _bits(tree[k]))


@pytest.mark.parametrize("store", ["gs", "s3"])
def test_sharded_jax_save_restores_in_port(stores, store):
    mesh = build_mesh(8, pp=2, sp=2, tp=2, dp=1, ep=1)
    x = jnp.arange(64.0).reshape(8, 8)
    sharded = jax.device_put(x, NamedSharding(mesh, P(("pp", "sp"), "tp")))
    uri = f"{BASES[store]}/sharded"
    jax_save(uri, {"w": sharded, "b": np.ones(3, np.float32)})
    got = restore_pytree(uri, {"w": torch.zeros(8, 8),
                               "b": np.zeros(3, np.float32)})
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(x))
    np.testing.assert_array_equal(got["b"], np.ones(3, np.float32))
    # and the port's save restores on the JAX mesh with its spec
    save_pytree(f"{uri}_port", {"w": torch.from_numpy(np.array(x))})
    back = jax_restore(f"{uri}_port", {"w": sharded}, mesh=mesh)
    np.testing.assert_array_equal(np.asarray(back["w"]), np.asarray(x))


def _jax_state(steps=2):
    jcfg = jtfm.TransformerConfig(**DIMS, microbatches=1, dtype="bfloat16")
    params = jtfm.init_params(jax.random.PRNGKey(0), jcfg, n_stages=1)
    opt = optax.adamw(1e-3)
    state = opt.init(params)
    rng = np.random.default_rng(0)
    loss = jax.jit(lambda p, i, l: jtfm.unsharded_loss(p, i, l, jcfg))
    for _ in range(steps):
        ids = rng.integers(0, DIMS["vocab"], (2, 8)).astype(np.int32)
        g = jax.grad(loss)(params, ids, np.roll(ids, -1, 1))
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
    return {"params": params, "opt": state,
            "stream": np.asarray([7], np.int64)}


def test_train_state_crosses_packages_on_gcs(stores):
    """A JAX train state saved on gs:// restores into the port's model and
    AdamW bitwise, and the port's save of it restores in JAX with equal
    leaves."""
    state = _jax_state()
    jax_save("gs://ckpts/state/jax", state)
    cfg = ttfm.TransformerConfig(**DIMS, dtype="bfloat16")
    model = ttfm.Transformer(cfg, device="cpu")
    opt = ttfm.adamw(model.parameters(), 1e-3)
    template = dict(train_state_to_jax(model, opt, device="meta"),
                    stream=np.zeros(1, np.int64))
    tree = restore_pytree("gs://ckpts/state/jax", template)
    train_state_from_jax(tree, model, opt)
    mine = dict(train_state_to_jax(model, opt), stream=tree["stream"])
    save_pytree("gs://ckpts/state/port", mine)
    back = jax_restore("gs://ckpts/state/port", state)
    for (pa, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(state)[0]):
        np.testing.assert_array_equal(_bits(np.asarray(a)),
                                      _bits(np.asarray(b)), err_msg=str(pa))


def _write_torn(base, step, like):
    """A step directory holding one shard of ``like``'s step and no
    manifest (a save preempted before its commit)."""
    src = f"{base}/step_{like:08d}/w.0-4"
    with Stream.create(src, "r") as a, \
            Stream.create(f"{base}/step_{step:08d}/w.0-4", "w") as b:
        b.write(a.read(1 << 20))


@pytest.mark.parametrize("store", ["gs", "s3", "hdfs"])
def test_manager_on_a_store_skips_a_torn_step(stores, store):
    base = f"{BASES[store]}/mgr"
    mgr = CheckpointManager(base, max_to_keep=1)
    assert mgr.latest_step() is None
    assert mgr.restore_latest({"w": np.zeros(4, np.float32)}) == (None, None)
    for step in (1, 2, 3):
        mgr.save(step, {"w": np.full(4, step, np.float32)})
    _write_torn(base, 4, 3)
    assert sorted(mgr._step_dirs()) == [1, 2, 3, 4]
    assert mgr.latest_step() == 3
    step, tree = mgr.restore_latest({"w": np.zeros(4, np.float32)})
    assert step == 3 and tree["w"].tolist() == [3.0] * 4
    # retention is local-only: the store keeps every step
    assert all(mgr._has_manifest(s) for s in (1, 2, 3))
    # the JAX manager on the same base sees the same
    jmgr = JaxManager(base)
    assert jmgr.latest_step() == 3
    assert jmgr.restore_latest({"w": np.zeros(4, np.float32)})[0] == 3
    assert mgr.stats()["saves"] == 3


def test_manager_commit_fault_keeps_the_previous_step(stores, monkeypatch):
    mgr = CheckpointManager("gs://ckpts/fault", max_to_keep=2)
    mgr.save(1, {"w": np.ones(4, np.float32)})
    monkeypatch.setenv("DMLC_FAULT_SPEC", "checkpoint.commit=error")
    with pytest.raises(ConnectionError):
        mgr.save(2, {"w": np.full(4, 2.0, np.float32)})
    monkeypatch.delenv("DMLC_FAULT_SPEC")
    assert sorted(mgr._step_dirs()) == [1, 2]   # shards of 2, no manifest
    assert mgr.latest_step() == 1
    assert JaxManager("gs://ckpts/fault").latest_step() == 1


class _Quiet(http.server.SimpleHTTPRequestHandler):
    def log_message(self, *a):
        pass


def test_manager_reads_the_latest_hint_where_the_store_cannot_list(
        tmp_path):
    """A checkpoint directory mirrored over plain HTTP cannot be listed:
    the manager restores the step the ``LATEST`` hint names, if its
    manifest is committed, and reads each leaf without a listing."""
    base = tmp_path / "run"
    mgr = CheckpointManager(str(base))
    for step in (1, 2):
        mgr.save(step, {"w": np.full(4, step, np.float32),
                        "h": torch.full((3,), step, dtype=torch.bfloat16)})
    srv = ThreadingHTTPServer(("127.0.0.1", 0),
                              partial(_Quiet, directory=str(tmp_path)))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        remote = CheckpointManager(f"http://127.0.0.1:{srv.server_port}/run")
        assert remote._step_dirs() is None
        assert remote.latest_step() == 2
        step, tree = remote.restore_latest({"w": np.zeros(4, np.float32),
                                            "h": torch.zeros(3)})
        assert step == 2 and tree["w"].tolist() == [2.0] * 4
        assert tree["h"].dtype == torch.bfloat16
        # a hint naming a step without a committed manifest is refused
        os.remove(base / "step_00000002" / "manifest.json")
        assert remote.latest_step() is None
        assert remote.restore_latest({"w": np.zeros(4, np.float32),
                                      "h": torch.zeros(3)}) == (None, None)
    finally:
        srv.shutdown()
        srv.server_close()


def test_manager_reads_the_hint_when_listing_raises(stores, monkeypatch):
    mgr = CheckpointManager("gs://ckpts/hint")
    mgr.save(5, {"w": np.full(2, 5.0, np.float32)})

    def unlistable(self, path):
        raise OSError("listing unavailable")

    monkeypatch.setattr(gcs_filesys.GCSFileSystem, "list_directory",
                        unlistable)
    assert mgr._step_dirs() is None
    assert mgr.restore_latest({"w": np.zeros(2, np.float32)})[0] == 5


# ---------------------------------------------------------------------------
# the slice: the example over s3:// and gs://
# ---------------------------------------------------------------------------

def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_train_lm_recordio_remote", ROOT / "examples" /
        "train_lm_recordio.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _params():
    jcfg = jtfm.TransformerConfig(**DIMS, microbatches=1, remat=True,
                                  dtype="float32")
    return jtfm.init_params(jax.random.PRNGKey(1), jcfg, n_stages=1), jcfg


def _port_model():
    return params_from_jax(jax.tree.map(np.asarray, _params()[0]),
                           ttfm.TransformerConfig(**DIMS, remat=True),
                           device="cpu")


def test_example_over_object_stores_matches_jax_and_resumes(stores):
    """The JAX example's shard, written to s3:// by the JAX package, feeds
    both loops: the port's losses within 1e-5 of the JAX loop's (the
    spine's tolerance); a run to step 3 saving to gs:// and a resumed run
    give the uninterrupted losses exactly, and the JAX manager finds the
    port's commits."""
    shard = "s3://data/lm/tokens.rec"
    _jax_example().make_data(shard, n_records=48, seed=3)
    params, jcfg = _params()
    opt = optax.adamw(port_example.LR)
    state = opt.init(params)
    loss_grad = jax.jit(jax.value_and_grad(
        lambda p, i, l: jtfm.unsharded_loss(p, i, l, jcfg)))
    feed = jax_recordio_feed(shard, build_mesh(1, dp=1, sp=1, tp=1, pp=1,
                                               ep=1),
                             batch_records=port_example.PER_PART,
                             max_bytes=(port_example.SEQ + 1) * 4)
    want = []
    for batch in feed:
        if len(want) == 5:
            break
        toks = np.asarray(batch["data"]).view("<i4")
        loss, g = loss_grad(params, toks[:, :-1], toks[:, 1:])
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
        want.append(float(loss))
    feed.close()
    whole = port_example.run(shard, 5, device="cpu", model=_port_model())
    np.testing.assert_allclose(whole, want, rtol=1e-5)
    ckpt = "gs://ckpts/lm"
    first = port_example.run(shard, 3, ckpt, device="cpu",
                             model=_port_model())
    rest = port_example.run(shard, 2, ckpt, device="cpu",
                            model=_port_model())
    assert first == whole[:3] and rest == whole[3:]
    assert CheckpointManager(ckpt).latest_step() == 5
    assert sorted(CheckpointManager(ckpt)._step_dirs()) == [3, 5]
    assert JaxManager(ckpt).latest_step() == 5


def test_chip_smoke_remote_phase_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.remote_phase`` with a small model and a 20 MB feed
    shard on the CPU, through ``chip_stores.py``'s emulators in a child
    process: every gate of the phase."""
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    import chip_smoke

    cfg = ttfm.TransformerConfig(**DIMS, dtype="float32", remat=True)
    line, launches = chip_smoke.remote_phase(
        "cpu", run={"device": "cpu", "cfg": cfg, "feed_bytes": 20 << 20,
                    "dir": str(tmp_path / "remote")})
    assert launches == {"flash_fwd": 0, "flash_bwd_dkv": 0,
                        "flash_bwd_dq": 0}
    assert line["uploads"]["feed_parts"] == 3
    assert line["uploads"]["signature_rejects"] == 0
    assert line["integrity"]["read_verify_failures"] == 2
    assert line["train"]["state_bitwise_equal"]
    assert line["train"]["torn_step"]["latest_step"] == 4
    assert max(line["train"]["loss_rel_diff"]) <= 1e-3
    for name in ("local", "s3", "gs"):
        assert line["feed_rate"][name]["first_batch_equals_cpu"]
    assert not (tmp_path / "remote").exists()
    assert not [k for k in FileSystem._instances if k.startswith("s3://")]
    assert "DMLC_S3_ENDPOINT" not in os.environ


def test_serve_layers_option_cuts_the_depth():
    """``serve --layers`` (the smoke's ``fleet`` replicas run the
    flagship's widths at depth 2) keeps every width."""
    from dmlc_tpu_torch.serving import serve

    model = serve.build_model("tiny", 0, torch.device("cpu"), layers=2)
    assert model.cfg == serve.TINY.__class__(**{
        **serve.TINY.__dict__, "n_layers": 2})
    assert serve.build_model("tiny", 0, torch.device("cpu")).cfg == serve.TINY


def test_store_emulators_import_the_standard_library_only():
    """``chip_stores.py`` runs beside the smoke as a plain Python process:
    no JAX, no torch, nothing of either package."""
    import ast

    tree = ast.parse((ROOT / "chip_stores.py").read_text())
    tops = {a.name.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.Import) for a in n.names}
    tops |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert tops <= set(sys.stdlib_module_names), tops
