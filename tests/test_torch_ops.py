"""Port parity: the port's ops.core against dmlc_tpu.ops.core.

The same numpy inputs (from a seed) go through the JAX op and its
PyTorch counterpart on the CPU, in float32; the ops are elementwise or
single reductions, so the two agree to 1e-6 (summation order only)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dmlc_tpu.models import transformer as jtfm
from dmlc_tpu.ops import core as jcore
from dmlc_tpu_torch.models import transformer as ttfm
from dmlc_tpu_torch.ops import core as tcore

TOL = 1e-6


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, scale = _rand(rng, 2, 5, 32), _rand(rng, 32)
    _close(tcore.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           jcore.rms_norm(jnp.asarray(x), jnp.asarray(scale)))


def test_rms_norm_casts_before_scale_in_bf16():
    """bf16: the normalised x is rounded to bf16 BEFORE the scale
    multiply, as the reference does; the port gives the same bits."""
    rng = np.random.default_rng(1)
    x, scale = _rand(rng, 3, 64), _rand(rng, 64) * 3
    got = tcore.rms_norm(torch.from_numpy(x).bfloat16(),
                         torch.from_numpy(scale).bfloat16())
    want = jcore.rms_norm(jnp.asarray(x, jnp.bfloat16),
                          jnp.asarray(scale, jnp.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_rope():
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 7, 3, 16)
    pos = np.arange(5, 12, dtype=np.int32)
    _close(tcore.rope(torch.from_numpy(x), torch.from_numpy(pos)),
           jcore.rope(jnp.asarray(x), jnp.asarray(pos)))


def test_rope_window():
    rng = np.random.default_rng(3)
    x = _rand(rng, 3, 4, 2, 16)
    pos = rng.integers(0, 500, size=(3, 4)).astype(np.int32)
    _close(ttfm._rope_window(torch.from_numpy(x), torch.from_numpy(pos)),
           jtfm._rope_window(jnp.asarray(x), jnp.asarray(pos)), tol=1e-5)


def test_embed_lookup():
    rng = np.random.default_rng(4)
    table = _rand(rng, 50, 8)
    ids = rng.integers(0, 50, size=(3, 6)).astype(np.int64)
    _close(tcore.embed_lookup(torch.from_numpy(table), torch.from_numpy(ids)),
           jcore.embed_lookup(jnp.asarray(table), jnp.asarray(ids),
                              jcore.ShardAxes()))


def test_swiglu_ffn():
    rng = np.random.default_rng(5)
    x = _rand(rng, 2, 3, 16)
    w_in, w_gate, w_out = (_rand(rng, 16, 24) * 0.2, _rand(rng, 16, 24) * 0.2,
                           _rand(rng, 24, 16) * 0.2)
    got = tcore.swiglu_ffn(*(torch.from_numpy(a)
                             for a in (x, w_in, w_gate, w_out)))
    want = jcore.swiglu_ffn(*(jnp.asarray(a) for a in (x, w_in, w_gate, w_out)),
                            jcore.ShardAxes())
    _close(got, want)


@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_softmax_xent(scale):
    rng = np.random.default_rng(6)
    logits = _rand(rng, 4, 5, 40) * scale
    labels = rng.integers(0, 40, size=(4, 5)).astype(np.int64)
    _close(tcore.softmax_xent(torch.from_numpy(logits),
                              torch.from_numpy(labels)),
           jcore.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                              jcore.ShardAxes()), tol=1e-5 * scale)
