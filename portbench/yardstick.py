"""The benchmark's own arithmetic: peaks, model FLOPs, the attention
kernels' operations and bytes, and a percentile.

Later changes to the program may not change the yardstick, so nothing
here is imported from the program.  The formulas follow the bounds the
port's kernel table uses (``PERF.md``, Findings): K1 4·D FLOPs for each
visible (query, key) pair and head, K2 8·D, K3 6·D, K4 4·D for each
live key of each row and head; bytes count each input read once and each
output written once, so a share of the roofline never exceeds 100% for
a kernel that does the work.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Sequence

#: published dense peaks of one card, by ``torch.cuda.get_device_name()``
#: (NVIDIA's H100 SXM data sheet: bf16 tensor cores without sparsity,
#: HBM3 bandwidth); a card not listed gets no roofline or MFU
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def peaks(kind: str) -> Optional[Dict[str, float]]:
    return PEAKS.get(kind)


def widths(cfg: dict) -> dict:
    """The sizes the formulas need, from a configuration file's keys
    (Hugging Face names)."""
    e = int(cfg["hidden_size"])
    h = int(cfg["num_attention_heads"])
    d = int(cfg.get("head_dim", e // h))
    return {"E": e, "H": h, "D": d, "HD": h * d,
            "KV": int(cfg.get("num_key_value_heads", h)),
            "F": int(cfg["intermediate_size"]),
            "L": int(cfg["num_hidden_layers"]),
            "V": int(cfg["vocab_size"]),
            "bytes": DTYPE_BYTES[cfg.get("torch_dtype", "bfloat16")]}


def layer_matmul_params(w: dict) -> int:
    """Weights of one layer's products: q, k, v, o and the SwiGLU's up,
    gate and down (the norms are not products)."""
    kv = w["KV"] * w["D"]
    return w["E"] * w["HD"] * 2 + w["E"] * kv * 2 + 3 * w["E"] * w["F"]


def weight_bytes(w: dict) -> int:
    """Bytes of every weight a forward reads whole: the layers' products
    and norms, the final norm and the unembedding (the embedding is
    read by rows, counted per token)."""
    per_layer = layer_matmul_params(w) + 2 * w["E"]
    return (w["L"] * per_layer + w["E"] + w["E"] * w["V"]) * w["bytes"]


def dense_flops_per_token(w: dict) -> float:
    """Forward FLOPs of one token through every layer's products, the
    attention scores excluded, the unembedding excluded."""
    return 2.0 * w["L"] * layer_matmul_params(w)


def attn_pairs_causal(t: int) -> int:
    """Visible (query, key) pairs of a causal sequence of ``t``."""
    return t * (t + 1) // 2


def train_step_flops(w: dict, batch: int, t: int) -> float:
    """Model FLOPs of one train step on ``[batch, t]`` causal
    sequences: three times the forward (forward, and the backward's two
    products), no recomputation counted."""
    fwd = (batch * t * (dense_flops_per_token(w) + 2.0 * w["E"] * w["V"])
           + batch * w["L"] * 4.0 * w["HD"] * attn_pairs_causal(t))
    return 3.0 * fwd


def prefill_flops(w: dict, n: int) -> float:
    """Forward FLOPs of a prompt of ``n`` tokens, logits at its last
    position only (what the first token needs)."""
    return (n * dense_flops_per_token(w) + 2.0 * w["E"] * w["V"]
            + w["L"] * 4.0 * w["HD"] * attn_pairs_causal(n))


def decode_token_flops(w: dict, ctx: int) -> float:
    """Forward FLOPs of one generated token that attends ``ctx`` keys
    (its own among them)."""
    return (dense_flops_per_token(w) + 2.0 * w["E"] * w["V"]
            + w["L"] * 4.0 * w["HD"] * ctx)


def kv_bytes_per_token(w: dict) -> int:
    """Bytes of one token's K and V in every layer."""
    return 2 * w["L"] * w["KV"] * w["D"] * w["bytes"]


def decode_step_cost(w: dict, committed: Sequence[int]) -> Dict[str, float]:
    """FLOPs and bytes of one decode step over rows that hold
    ``committed`` tokens each before the step: the weights read once,
    the embedding rows, the live K/V read, the new K/V written."""
    flops = sum(decode_token_flops(w, c + 1) for c in committed)
    kvb = kv_bytes_per_token(w)
    nbytes = (weight_bytes(w) + len(committed) * w["E"] * w["bytes"]
              + sum(committed) * kvb + len(committed) * kvb)
    return {"flops": flops, "bytes": float(nbytes)}


# -- the attention kernels: work the operation needs, whatever runs it --

def k1_cost(w: dict, batch: int, t: int) -> Dict[str, float]:
    """Causal attention forward over ``[batch, t]`` (one layer)."""
    pairs = batch * attn_pairs_causal(t)
    io = 4 * batch * t * w["HD"] * w["bytes"]             # q, k, v, o
    return {"flops": 4.0 * w["D"] * w["H"] * pairs, "bytes": float(io)}


def k2_cost(w: dict, batch: int, t: int) -> Dict[str, float]:
    """dK/dV of causal attention (one layer): q, k, v, dO and the two
    row statistics read, dK and dV written."""
    pairs = batch * attn_pairs_causal(t)
    act = batch * t * w["HD"] * w["bytes"]
    stats = 2 * batch * w["H"] * t * 4
    return {"flops": 8.0 * w["D"] * w["H"] * pairs,
            "bytes": float(6 * act + stats)}


def k3_cost(w: dict, batch: int, t: int) -> Dict[str, float]:
    """dQ of causal attention (one layer): q, k, v, dO and the row
    statistics read, dQ written."""
    pairs = batch * attn_pairs_causal(t)
    act = batch * t * w["HD"] * w["bytes"]
    stats = 2 * batch * w["H"] * t * 4
    return {"flops": 6.0 * w["D"] * w["H"] * pairs,
            "bytes": float(5 * act + stats)}


def k4_cost(w: dict, committed: Sequence[int]) -> Dict[str, float]:
    """Paged decode attention of one layer, one query a row: each row
    reads its ``committed + 1`` live keys and values."""
    live = sum(c + 1 for c in committed)
    b = len(committed)
    kv = 2 * live * w["KV"] * w["D"] * w["bytes"]
    qo = 2 * b * w["HD"] * w["bytes"]
    return {"flops": 4.0 * w["D"] * w["H"] * live, "bytes": float(kv + qo)}


def bound_s(cost: Dict[str, float], peak: Dict[str, float]) -> float:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the peak bandwidth."""
    return max(cost["flops"] / peak["bf16_flops"],
               cost["bytes"] / peak["hbm_bytes"])


# -- statistics ---------------------------------------------------------

def nearest_rank(values: Iterable[float], q: float) -> Optional[float]:
    """The ``q``-quantile (0..1) by nearest rank: the smallest value with
    at least ``q`` of the sample at or below it."""
    xs = sorted(values)
    if not xs:
        return None
    k = max(1, math.ceil(q * len(xs)))
    return xs[k - 1]

