"""Weights from the JAX package's parameter pytree, as numpy arrays.

``params_from_jax`` takes the tree ``dmlc_tpu.models.transformer.
init_params`` builds (after ``jax.tree.map(np.asarray, ...)``): blocks
stacked ``[S, L/S, ...]``, every leaf a numpy array.  It needs neither
jax nor the JAX package.  bfloat16 leaves arrive as ``ml_dtypes``'
bfloat16, which ``torch.from_numpy`` refuses; they go through their
uint16 bits instead.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .transformer import Transformer, TransformerConfig

__all__ = ["params_from_jax", "tensor_from_numpy"]


def tensor_from_numpy(a) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@torch.no_grad()
def params_from_jax(tree: Mapping, cfg: TransformerConfig,
                    device=None) -> Transformer:
    """A :class:`Transformer` holding the JAX tree's weights, in the
    config's dtype, on ``device``."""
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
    for name in ("ln1", "ln2", "wq", "wk", "wv", "wo", "gate", "w_in",
                 "w_gate", "w_out"):
        stacked = np.asarray(blocks[name])
        flat = stacked.reshape((n_layers,) + stacked.shape[2:])
        for li, layer in enumerate(model.layers):
            put(getattr(layer, name), flat[li])
    return model
