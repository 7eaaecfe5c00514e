"""Port parity: the port's ops.core against dmlc_tpu.ops.core.

The same numpy inputs (from a seed) go through the JAX op and its
PyTorch counterpart on the CPU, in float32; the ops are elementwise or
single reductions, so the two agree to 1e-6 (summation order only).
Gradients are those of ``sum(op(...) * w)`` for a random cotangent w,
through torch autograd and ``jax.grad``, to the same 1e-6."""

import numpy as np
import pytest
import torch

import jax
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


def _grads(t_fn, j_fn, inputs, n_diff, tol=TOL):
    """Gradients of sum(fn(*inputs) * w) with respect to the first
    ``n_diff`` inputs, port against reference."""
    rng = np.random.default_rng(11)
    out = np.asarray(j_fn(*(jnp.asarray(a) for a in inputs)))
    w = rng.standard_normal(out.shape).astype(np.float32)
    ts = [torch.from_numpy(a) for a in inputs]
    for t in ts[:n_diff]:
        t.requires_grad_(True)
    (t_fn(*ts) * torch.from_numpy(w)).sum().backward()
    want = jax.grad(lambda *a: jnp.sum(j_fn(*a) * w),
                    argnums=tuple(range(n_diff)))(
                        *(jnp.asarray(a) for a in inputs))
    for t, g in zip(ts, want):
        _close(t.grad, g, tol)


def test_rms_norm_gradients():
    rng = np.random.default_rng(12)
    _grads(tcore.rms_norm, jcore.rms_norm,
           (_rand(rng, 2, 5, 32), _rand(rng, 32)), 2)


def test_rope_gradients():
    rng = np.random.default_rng(13)
    _grads(tcore.rope, jcore.rope,
           (_rand(rng, 2, 7, 3, 16), np.arange(3, 10, dtype=np.int32)), 1)


def test_swiglu_ffn_gradients():
    rng = np.random.default_rng(14)
    _grads(tcore.swiglu_ffn,
           lambda *a: jcore.swiglu_ffn(*a, jcore.ShardAxes()),
           (_rand(rng, 2, 3, 16), _rand(rng, 16, 24) * 0.2,
            _rand(rng, 16, 24) * 0.2, _rand(rng, 24, 16) * 0.2), 4)


def test_embed_lookup_gradients():
    """The table's gradient is a scatter-add: repeated ids accumulate."""
    rng = np.random.default_rng(15)
    ids = np.array([[1, 4, 1, 7], [4, 4, 0, 9]], np.int64)
    _grads(tcore.embed_lookup,
           lambda t, i: jcore.embed_lookup(t, i, jcore.ShardAxes()),
           (_rand(rng, 10, 8), ids), 1)


@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_softmax_xent_gradients(scale):
    rng = np.random.default_rng(16)
    logits = _rand(rng, 4, 5, 40) * scale
    logits[0, 0, :2] = logits[0, 0].max() + 1.0     # a tied max
    labels = rng.integers(0, 40, size=(4, 5)).astype(np.int64)
    _grads(tcore.softmax_xent,
           lambda x, y: jcore.softmax_xent(x, y, jcore.ShardAxes()),
           (logits, labels), 1)


def test_softmax_xent_max_is_detached():
    """The max only stabilises the exp (the reference stops its
    gradient): no amax backward, which splits ties, is in the graph."""
    logits = torch.zeros(2, 6, requires_grad=True)
    loss = tcore.softmax_xent(logits, torch.tensor([1, 2])).sum()
    seen, todo = set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo += [f for f, _ in fn.next_functions]
    names = {type(f).__name__ for f in seen}
    assert not [n for n in names if "Amax" in n or "Max" in n], names
