"""Seeded weights, made by the benchmark and handed to both sides.

Every weight is ``N(0, initializer_range)`` drawn in float32 and rounded
to the configuration's dtype; the norms' scales are 1.  The draws come
in a few large calls, each from a generator of its own seeded from the
run's seed and the call's index, so the reference can make any layer
again alone, on the card and in the same order, and get the same bits:

    call 0        the embedding  [V, E]
    call 1 + l    layer l's products, one flat draw split in the order
                  wq [E, H·D], wk [E, KV·D], wv [E, KV·D], wo [H·D, E],
                  w_up [E, F], w_gate [E, F], w_down [F, E]
    call L + 1    the unembedding [E, V]
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import yardstick

LAYER_LEAVES = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down")
_MASK = (1 << 63) - 1

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def dtype_of(cfg: dict) -> torch.dtype:
    return _DTYPES[cfg.get("torch_dtype", "bfloat16")]


def generator(seed: int, call: int, device) -> torch.Generator:
    """The generator of draw ``call`` for run ``seed`` (any integer)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 7919 * (call + 1)) & _MASK)
    return g


def layer_shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    w = yardstick.widths(cfg)
    e, hd, kv, f = w["E"], w["HD"], w["KV"] * w["D"], w["F"]
    return [("wq", (e, hd)), ("wk", (e, kv)), ("wv", (e, kv)),
            ("wo", (hd, e)), ("w_up", (e, f)), ("w_gate", (e, f)),
            ("w_down", (f, e))]


def _draw(seed: int, call: int, numel: int, cfg: dict, device,
          dtype: torch.dtype) -> torch.Tensor:
    std = float(cfg.get("initializer_range", 0.02))
    t = torch.randn(numel, generator=generator(seed, call, device),
                    device=device, dtype=torch.float32)
    return t.mul_(std).to(dtype_of(cfg)).to(dtype)


def embedding(cfg: dict, seed: int, device,
              dtype: torch.dtype = None) -> torch.Tensor:
    w = yardstick.widths(cfg)
    return _draw(seed, 0, w["V"] * w["E"], cfg, device,
                 dtype or dtype_of(cfg)).view(w["V"], w["E"])


def unembedding(cfg: dict, seed: int, device,
                dtype: torch.dtype = None) -> torch.Tensor:
    w = yardstick.widths(cfg)
    return _draw(seed, w["L"] + 1, w["E"] * w["V"], cfg, device,
                 dtype or dtype_of(cfg)).view(w["E"], w["V"])


def layer(cfg: dict, seed: int, index: int, device,
          dtype: torch.dtype = None) -> Dict[str, torch.Tensor]:
    """Layer ``index``'s products, as views of one draw."""
    shapes = layer_shapes(cfg)
    numel = sum(a * b for _, (a, b) in shapes)
    flat = _draw(seed, 1 + index, numel, cfg, device, dtype or dtype_of(cfg))
    out, pos = {}, 0
    for name, shape in shapes:
        n = shape[0] * shape[1]
        out[name] = flat[pos:pos + n].view(shape)
        pos += n
    return out
