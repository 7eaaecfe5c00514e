"""Port parity: sharded checkpoints with specs, across the packages, on a
pp2 x tp2 mesh.

The JAX package saves the reference's parameters placed by
``param_specs()`` on ``build_mesh(4, pp=2, tp=2)``; a 4-rank gloo gang of
the port (``run_gang``) on the same mesh shape holds the same weights
(``shard_params_from_jax`` of the tree) and:

* restores the JAX checkpoint with ``restore_pytree(..., mesh=)``: every
  rank's slice bit-equal to its shard;
* restores it again from a copy whose manifest lists one process's
  shards only (tests/test_checkpoint.py's multi-host case);
* saves the same parameters with ``save_pytree(..., mesh=, specs=)``;
  the JAX package's ``restore_pytree`` reads that back bit-equal, onto
  its mesh and to the host;
* saves its train state after one AdamW step, restores it into a fresh
  model and optimizer on the mesh, bit-equal leaf by leaf, and one more
  step from each gives the same loss and bit-equal parameters.

The two manifests of the same parameters carry equal ``spec`` fields and
the same shard file names."""

import json
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

from dmlc_tpu.checkpoint.sharded import restore_pytree as jrestore
from dmlc_tpu.checkpoint.sharded import save_pytree as jsave
from dmlc_tpu.models import transformer as jtfm
from dmlc_tpu_torch.checkpoint import restore_pytree
from dmlc_tpu_torch.checkpoint.sharded import leaf_key
from dmlc_tpu_torch.models import transformer as ttfm

from tests.test_torch_parallel import PKG, run_gang
from tests.test_torch_pipeline import DIMS, batch, flat, jax_mesh, weights

SHAPE = {"pp": 2, "tp": 2}

_BODY = """
from {pkg}.checkpoint import restore_pytree, save_pytree
from {pkg}.models import transformer as tfm
from {pkg}.models.convert import (shard_params_from_jax, state_specs,
                                  train_state_from_jax, train_state_to_jax)
cfg = tfm.TransformerConfig(**json.loads({dims!r}))
tree = {{"blocks": {{}}}}
for key, a in IN.items():
    if key.startswith("w."):
        parts = key[2:].split(".")
        (tree["blocks"] if len(parts) == 2 else tree)[parts[-1]] = a
ids = torch.from_numpy(IN["ids"]).long()
model = shard_params_from_jax(tree, cfg, mesh, device="cpu")
opt = tfm.adamw(model.parameters(), 1e-3)
local = train_state_to_jax(model, opt)["params"]
template = train_state_to_jax(model, opt, device="meta")["params"]
def same(a, b, prefix=""):
    for k in a:
        if isinstance(a[k], dict):
            same(a[k], b[k], prefix + k + ".")
        else:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), \\
                prefix + k
for name in ("jax", "jax_one_process"):
    same(restore_pytree(ARGS["out"] + "/../" + name, template, mesh=mesh),
         local)
    OUT["restored_" + name] = 1
save_pytree(ARGS["out"] + "/../port", local, mesh=mesh,
            specs=state_specs(local))
# the train state: a step, a save, a restore into a fresh model
step = tfm.make_train_step(model, opt, ledger=False, mesh=mesh)
OUT["loss1"] = float(step(ids, ids))
state = train_state_to_jax(model, opt)
save_pytree(ARGS["out"] + "/../state", state, mesh=mesh,
            specs=state_specs(state))
fresh = shard_params_from_jax(tree, cfg, mesh, device="cpu")
fresh_opt = tfm.adamw(fresh.parameters(), 1e-3)
back = restore_pytree(ARGS["out"] + "/../state",
                      train_state_to_jax(fresh, fresh_opt, device="meta"),
                      mesh=mesh)
train_state_from_jax(back, fresh, fresh_opt)
again = train_state_to_jax(fresh, fresh_opt)
same(again["params"], state["params"])
same(again["opt"][0].mu, state["opt"][0].mu)
same(again["opt"][0].nu, state["opt"][0].nu)
assert int(again["opt"][0].count) == int(state["opt"][0].count) == 1
fresh_step = tfm.make_train_step(fresh, fresh_opt, ledger=False, mesh=mesh)
OUT["loss2"] = np.array([float(step(ids, ids)), float(fresh_step(ids, ids))])
same(train_state_to_jax(fresh, fresh_opt)["params"],
     train_state_to_jax(model, opt)["params"])
OUT["state_ok"] = 1
"""


def _placed(tree, jmesh):
    specs = jtfm.param_specs()

    def put(a, spec):
        return jax.device_put(jnp.asarray(a), NamedSharding(jmesh, spec))

    out = {k: put(v, specs[k]) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = {k: put(v, specs["blocks"][k])
                     for k, v in tree["blocks"].items()}
    return out


def _manifest(path):
    return json.loads((path / "manifest.json").read_text())


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    tree, jcfg = weights(DIMS, n_stages=SHAPE["pp"])
    jsave(str(root / "jax"), _placed(tree, jax_mesh(SHAPE)))
    # process 0's manifest: one shard a leaf listed, the rest on disk
    shutil.copytree(root / "jax", root / "jax_one_process")
    man = _manifest(root / "jax_one_process")
    for entry in man["leaves"].values():
        entry["shards"] = dict(list(entry["shards"].items())[:1])
    (root / "jax_one_process" / "manifest.json").write_text(json.dumps(man))
    ids, _ = batch(DIMS["vocab"])
    ins = {"w." + k: v for k, v in flat(tree).items()}
    ins["ids"] = ids
    outs = run_gang(root / "gang", 4, SHAPE,
                    _BODY.format(pkg=PKG, dims=json.dumps(DIMS)), ins)
    return root, tree, outs


def test_jax_checkpoint_restores_bit_equal_into_the_port_mesh(ckpt):
    _, _, outs = ckpt
    for o in outs:
        assert int(o["restored_jax"]) == 1


def test_one_process_manifest_restores_on_the_port_mesh_and_host(ckpt):
    root, tree, outs = ckpt
    for o in outs:
        assert int(o["restored_jax_one_process"]) == 1
    man = _manifest(root / "jax_one_process")
    assert all(len(e["shards"]) == 1 for e in man["leaves"].values())
    got = restore_pytree(str(root / "jax_one_process"),
                         jax.tree.map(lambda a: torch.empty(0), tree))
    for name, want in flat(tree).items():
        np.testing.assert_array_equal(flat(got)[name], want)


def test_port_checkpoint_restores_bit_equal_through_jax(ckpt):
    root, tree, _ = ckpt
    jmesh = jax_mesh(SHAPE)
    template = jax.tree.map(jnp.asarray, tree)
    on_mesh = jrestore(str(root / "port"), template, mesh=jmesh)
    on_host = jrestore(str(root / "port"), template)
    specs = jtfm.param_specs()
    for name, want in flat(tree).items():
        *blocks, leaf = name.split(".")
        arr = (on_mesh["blocks"] if blocks else on_mesh)[leaf]
        np.testing.assert_array_equal(np.asarray(arr), want)
        np.testing.assert_array_equal(flat(on_host)[name], want)
        assert arr.sharding.spec == (specs["blocks"] if blocks
                                     else specs)[leaf], name


def test_manifests_carry_equal_specs_and_shard_files(ckpt):
    root, _, _ = ckpt
    mj, mp = _manifest(root / "jax"), _manifest(root / "port")
    assert set(mj["leaves"]) == set(mp["leaves"])
    for key, ej in mj["leaves"].items():
        ep = mp["leaves"][key]
        assert ep["spec"] == ej["spec"], key
        assert sorted(ep["shards"].values()) == \
            sorted(ej["shards"].values()), key
        assert ep["crc32c"] == ej["crc32c"], key
        assert (ep["shape"], ep["dtype"]) == (ej["shape"], ej["dtype"])
    assert mp["leaves"][leaf_key("['blocks']['wq']")]["spec"] == \
        ["pp", None, None, "tp", None]


def test_train_state_round_trip_on_the_mesh_is_bitwise(ckpt):
    root, _, outs = ckpt
    for o in outs:
        assert int(o["state_ok"]) == 1
        a, b = o["loss2"]
        assert a == b
    assert len({float(o["loss1"]) for o in outs}) == 1
    man = _manifest(root / "state")["leaves"]
    assert man[leaf_key("['opt'][0].mu['blocks']['w_in']")]["spec"] == \
        ["pp", None, "ep", None, "tp"]
    assert man[leaf_key("['opt'][0].count")]["spec"] == []


def test_param_spec_tree_is_the_reference_param_specs():
    def as_json(spec):
        return [list(e) if isinstance(e, tuple) else e for e in spec]

    specs = jtfm.param_specs()
    for name, spec in specs.items():
        if name == "blocks":
            for leaf, s in spec.items():
                assert ttfm.PARAM_SPEC_TREE["blocks"][leaf] == as_json(s)
        else:
            assert ttfm.PARAM_SPEC_TREE[name] == as_json(spec)
    assert set(ttfm.PARAM_SPEC_TREE["blocks"]) == set(specs["blocks"])
