"""Weights to and from the JAX package's parameter pytree, as numpy arrays.

``params_from_jax`` takes the tree ``dmlc_tpu.models.transformer.
init_params`` builds (after ``jax.tree.map(np.asarray, ...)``): blocks
stacked ``[S, L/S, ...]``, every leaf a numpy array.  ``params_to_jax``
is its inverse.  Neither needs jax nor the JAX package.  bfloat16
leaves are ``ml_dtypes``' bfloat16 on the numpy side, which
``torch.from_numpy`` refuses; they go through their uint16 bits instead,
so both directions are bit-exact.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .transformer import Transformer, TransformerConfig

__all__ = ["params_from_jax", "params_to_jax", "tensor_from_numpy"]

_BLOCK_LEAVES = ("ln1", "ln2", "wq", "wk", "wv", "wo", "gate", "w_in",
                 "w_gate", "w_out")


def tensor_from_numpy(a) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU numpy copy; bfloat16 becomes ``ml_dtypes.bfloat16`` with the
    same bits (imported here: only a bfloat16 tensor needs it)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


@torch.no_grad()
def params_from_jax(tree: Mapping, cfg: TransformerConfig,
                    device=None) -> Transformer:
    """A :class:`Transformer` holding the JAX tree's weights, in the
    config's dtype, on ``device`` (default: the CUDA card; no card
    raises)."""
    model = Transformer(cfg, device=device)

    def put(dst: torch.Tensor, src) -> None:
        t = tensor_from_numpy(src)
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"shape {tuple(t.shape)} != {tuple(dst.shape)}")
        dst.copy_(t.to(dst.dtype))

    put(model.embed, tree["embed"])
    put(model.unembed, tree["unembed"])
    put(model.ln_f, tree["ln_f"])
    blocks = tree["blocks"]
    n_layers = cfg.n_layers
    for name in _BLOCK_LEAVES:
        stacked = np.asarray(blocks[name])
        flat = stacked.reshape((n_layers,) + stacked.shape[2:])
        for li, layer in enumerate(model.layers):
            put(getattr(layer, name), flat[li])
    return model


def params_to_jax(model: Transformer, n_stages: int = 1) -> Dict:
    """The inverse of :func:`params_from_jax`: the JAX pytree layout with
    blocks stacked ``[S, L/S, ...]`` (``init_params`` :128-155), every
    leaf a numpy array in the parameter's dtype."""
    n_layers = model.cfg.n_layers
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split into {n_stages} "
                         "stages")
    blocks = {}
    for name in _BLOCK_LEAVES:
        flat = np.stack([_to_numpy(getattr(layer, name))
                         for layer in model.layers])
        blocks[name] = flat.reshape((n_stages, n_layers // n_stages)
                                    + flat.shape[1:])
    return {"embed": _to_numpy(model.embed),
            "unembed": _to_numpy(model.unembed),
            "ln_f": _to_numpy(model.ln_f), "blocks": blocks}
