"""Checkpoints across the packages: a train state the JAX package saves
({"params", "opt": optax.adamw's state, "stream"}) restores into the
port's model and AdamW exactly, the port's save restores in JAX exactly
with the same manifest, and the port's manager keeps the crash-
consistency and fallback contracts."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from dmlc_tpu.checkpoint import CheckpointManager as JaxManager
from dmlc_tpu.models import transformer as jtfm
from dmlc_tpu_torch.checkpoint import (CheckpointManager, CorruptCheckpoint,
                                       MissingLeaf, restore_pytree,
                                       save_pytree)
from dmlc_tpu_torch.models import transformer as ttfm
from dmlc_tpu_torch.models.convert import (params_from_jax,
                                           train_state_from_jax,
                                           train_state_to_jax)

DIMS = dict(vocab=64, d_model=32, n_heads=2, head_dim=8, d_ff=48,
            n_layers=3, n_experts=1)


def _jax_state(dtype, steps=2):
    """A JAX train state after ``steps`` AdamW updates (non-zero moments
    and count) and its config."""
    jcfg = jtfm.TransformerConfig(**DIMS, microbatches=1, dtype=dtype)
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
            "stream": np.asarray([7], np.int64)}, jcfg


def _port(dtype):
    cfg = ttfm.TransformerConfig(**DIMS, dtype=dtype)
    model = ttfm.Transformer(cfg, device="cpu")
    return model, ttfm.adamw(model.parameters(), 1e-3)


def _bits(x):
    """A leaf's bits as numpy (bf16 through int16, never float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_trees_equal(jax_tree, port_tree):
    jl = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    from dmlc_tpu_torch.checkpoint.sharded import flatten_with_path

    pl = flatten_with_path(port_tree)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in pl]
    for (path, a), (_, b) in zip(jl, pl):
        a, b = _bits(a), _bits(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_into_port(tmp_path, dtype):
    tree, _ = _jax_state(dtype)
    JaxManager(str(tmp_path), max_to_keep=2).save(3, tree)
    model, opt = _port(dtype)
    template = dict(train_state_to_jax(model, opt, device="meta"),
                    stream=np.zeros(1, np.int64))
    step, restored = CheckpointManager(str(tmp_path)).restore_latest(template)
    assert step == 3 and int(restored["stream"][0]) == 7
    train_state_from_jax(restored, model, opt)
    got = dict(train_state_to_jax(model, opt), stream=restored["stream"])
    _assert_trees_equal(tree, got)
    assert all(int(s["step"]) == 2 for s in opt.state.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_jax(tmp_path, dtype):
    jtree, _ = _jax_state(dtype, steps=0)
    model = params_from_jax(jax.tree.map(np.asarray, jtree["params"]),
                            ttfm.TransformerConfig(**DIMS, dtype=dtype),
                            device="cpu")
    opt = ttfm.adamw(model.parameters(), 1e-3)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        ids = torch.randint(0, DIMS["vocab"], (2, 8), generator=gen)
        opt.zero_grad()
        ttfm.unsharded_loss(model, ids, ids.roll(-1, 1)).backward()
        opt.step()
    state = dict(train_state_to_jax(model, opt),
                 stream=np.asarray([11], np.int64))
    CheckpointManager(str(tmp_path / "port")).save(5, state)
    step, restored = JaxManager(str(tmp_path / "port")).restore_latest(
        jtree)
    assert step == 5
    _assert_trees_equal(restored, state)
    # the same state saved by the JAX package: the manifests agree
    adam = state["opt"][0]
    as_np = lambda t: jnp.asarray(_bits(t)).view(  # noqa: E731
        jnp.bfloat16) if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy())
    jstate = {"params": jax.tree.map(as_np, state["params"]),
              "opt": (jtree["opt"][0]._replace(
                  count=jnp.asarray(adam.count.numpy()),
                  mu=jax.tree.map(as_np, adam.mu),
                  nu=jax.tree.map(as_np, adam.nu)),) + jtree["opt"][1:],
              "stream": state["stream"]}
    JaxManager(str(tmp_path / "jax")).save(5, jstate)
    manifests = [json.loads((tmp_path / d / "step_00000005" /
                             "manifest.json").read_text())
                 for d in ("port", "jax")]
    assert manifests[0] == manifests[1]
    assert manifests[0]["leaves"]["opt___0_.count"]["dtype"] == "int32"
    for name in os.listdir(tmp_path / "jax" / "step_00000005"):
        assert (tmp_path / "jax" / "step_00000005" / name).read_bytes() == \
            (tmp_path / "port" / "step_00000005" / name).read_bytes(), name


def _tree(v):
    return {"w": torch.full((4, 3), float(v)),
            "b": [torch.arange(5, dtype=torch.int32) + v,
                  np.asarray([v], np.int64)]}


def test_restore_latest_falls_back_past_torn_and_corrupt_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=5)
    for step in (1, 2, 3, 4):
        mgr.save(step, _tree(step))
    # step 5: shards written, manifest never committed (a torn save)
    save_pytree(str(tmp_path / "step_00000005"), _tree(5))
    os.remove(tmp_path / "step_00000005" / "manifest.json")
    # step 4: a flipped shard byte; step 3: a corrupt manifest
    shard = tmp_path / "step_00000004" / "w.0-4_0-3"
    raw = bytearray(shard.read_bytes())
    raw[5] ^= 0x40
    shard.write_bytes(bytes(raw))
    (tmp_path / "step_00000003" / "manifest.json").write_text("{not json")
    assert mgr.latest_step() == 4
    step, tree = mgr.restore_latest(_tree(0))
    assert step == 2
    assert torch.equal(tree["w"], _tree(2)["w"])
    assert isinstance(tree["b"][1], np.ndarray) and tree["b"][1][0] == 2
    with pytest.raises(CorruptCheckpoint):
        restore_pytree(str(tmp_path / "step_00000004"), _tree(0))
    assert mgr.stats()["saves"] == 4 and mgr.stats()["bytes_read"] > 0


def test_retention_counts_committed_steps_only(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    mgr.save(1, _tree(1))
    # a torn directory newer than every committed step: a save in flight
    save_pytree(str(tmp_path / "step_00000009"), _tree(9))
    os.remove(tmp_path / "step_00000009" / "manifest.json")
    mgr.save(2, _tree(2))
    mgr.save(3, _tree(3))
    steps = sorted(os.listdir(tmp_path))
    assert steps == ["LATEST", "step_00000002", "step_00000003",
                     "step_00000009"]
    mgr.save(10, _tree(10))   # now the torn step 9 is dead litter
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000003",
                                            "step_00000010"]


def test_missing_leaf_raises(tmp_path):
    save_pytree(str(tmp_path), _tree(1))
    with pytest.raises(MissingLeaf):
        restore_pytree(str(tmp_path), dict(_tree(0), extra=torch.zeros(1)))


def test_jax_mesh_sharded_checkpoint_restores_into_port(tmp_path):
    """A leaf the JAX package saved as shards of a mesh (one file per
    box) is assembled whole on restore."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dmlc_tpu.checkpoint import save_pytree as jax_save
    from dmlc_tpu.parallel import build_mesh

    mesh = build_mesh(8, dp=4, sp=2, tp=1, pp=1, ep=1)
    full = np.arange(8 * 6 * 4, dtype=np.float32).reshape(8, 6, 4)
    arr = jax.device_put(full, NamedSharding(mesh, P("dp", "sp")))
    jax_save(str(tmp_path), {"w": arr, "b": jnp.ones((3,), jnp.bfloat16)})
    assert len([n for n in os.listdir(tmp_path) if n.startswith("w.")]) == 8
    got = restore_pytree(str(tmp_path), {"w": torch.zeros(1),
                                         "b": torch.zeros(1)})
    np.testing.assert_array_equal(got["w"].numpy(), full)
    assert got["b"].dtype == torch.bfloat16 and bool((got["b"] == 1).all())
