"""The numbers the correctness check compares, program against reference.

Training (the first three steps of the object the window drives):

    loss_gap    the largest relative gap of a step's mean loss
    grad_gap    the worst leaf's gap between the norms of the first
                gradient, as a share of the reference leaf's norm or of
                the median leaf's, whichever is larger
    change_gap  the same of the parameters' change after the steps,
                over the leaves whose first gradient in the reference is
                at least a thousandth of the median leaf's (leaves with
                a gradient of nought to rounding move by round-off)

Serving:

    max_gap     over a sample of served tokens, the widest gap by which
                a served token's reference logit lies below the
                reference's best at that position
"""

from __future__ import annotations

import statistics
from typing import Dict, Sequence

import torch

GRAD_FLOOR = 1e-3


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep=None) -> float:
    names = [k for k in ref if k in prog and (keep is None or k in keep)]
    scale = statistics.median(ref[k] for k in names)
    return max(abs(prog[k] - ref[k]) / max(ref[k], scale) for k in names)


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref`` each hold ``losses``, ``grad_norms`` and
    ``change_norms`` (by leaf name)."""
    loss = max(abs(p - r) / abs(r)
               for p, r in zip(prog["losses"], ref["losses"]))
    g = ref["grad_norms"]
    median = statistics.median(g.values())
    moved = {k for k, v in g.items() if v >= GRAD_FLOOR * median}
    return {"loss_gap": loss,
            "grad_gap": leaf_gap(prog["grad_norms"], g),
            "change_gap": leaf_gap(prog["change_norms"],
                                   ref["change_norms"], moved)}


def token_gaps(logits: Sequence[torch.Tensor],
               tokens: Sequence[Sequence[int]]) -> torch.Tensor:
    """Every position's gap: reference best minus the token's logit."""
    out = []
    for lg, toks in zip(logits, tokens):
        t = torch.as_tensor(list(toks), device=lg.device, dtype=torch.long)
        out.append(lg.max(dim=-1).values - lg.gather(1, t[:, None])[:, 0])
    return torch.cat(out)
