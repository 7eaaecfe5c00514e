"""The plain reference: a decoder LM written out in float32 PyTorch.

It follows the published equations of the configurations the benchmark
runs (DeepSeek LLM 7B and the repository's flagship share them):

    x   = embed[ids]
    h   = x + Wo · attn(rope(Wq · n1(x)), rope(Wk · n1(x)), Wv · n1(x))
    x'  = h + W_down · (silu(W_gate · n2(h)) * (W_up · n2(h)))
    out = unembed · n_f(x_L)

with RMSNorm ``x / sqrt(mean(x^2) + eps) * w``, causal softmax attention
scaled by ``1/sqrt(D)``, and rotary embeddings that rotate the halves of
each head (``theta ** (-i / (D/2))``).  It imports nothing of the
program and takes only what the benchmark made: the seed's weights
(``portbench.weights``) and the token ids.  Products run in float32
with TF32 off.  ``prec="fp8"`` runs every product on operands rounded
to float8 (e4m3, one scale a tensor): the control that a run in a
lower precision than the configuration's must fail.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import weights as wts
from .. import yardstick

FP8_MAX = 448.0
_ATTN_BUDGET = 1 << 30      # bytes of float32 scores at once


def strict_float32() -> None:
    """Float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class _RoundFP8(torch.autograd.Function):
    """Rounds to float8 going forward; passes the gradient straight
    through (the usual simulation of float8 training)."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t)

    @staticmethod
    def backward(ctx, g):
        return g


def _q(t: torch.Tensor, prec: str) -> torch.Tensor:
    return _RoundFP8.apply(t) if prec == "fp8" else t


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    return _q(a, prec) @ _q(b, prec)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """``x [B, T, H, D]`` at positions ``0..T-1``."""
    t, d = x.shape[1], x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    pos = torch.arange(t, dtype=torch.float32, device=x.device)
    ang = (pos[:, None] * freqs)[None, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, prec: str) -> torch.Tensor:
    """Causal attention of ``[B, T, H, D]`` tensors, a few heads at a
    time so the scores fit."""
    b, t, h, d = q.shape
    group = max(1, min(h, _ATTN_BUDGET // max(1, b * t * t * 4)))
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).triu(1)
    outs = []
    for lo in range(0, h, group):
        qh = q[:, :, lo:lo + group].transpose(1, 2)          # [B, g, T, D]
        kh = k[:, :, lo:lo + group].transpose(1, 2)
        vh = v[:, :, lo:lo + group].transpose(1, 2)
        s = mm(qh, kh.transpose(-1, -2), prec) / math.sqrt(d)
        p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
        outs.append(mm(p, vh, prec).transpose(1, 2))
    return torch.cat(outs, dim=2)


def block(x: torch.Tensor, lw: Dict[str, torch.Tensor], cfg: dict,
          prec: str) -> torch.Tensor:
    """One decoder layer on ``x [B, T, E]``."""
    w = yardstick.widths(cfg)
    eps = float(cfg.get("rms_norm_eps", 1e-6))
    theta = float(cfg.get("rope_theta", 10000.0))
    b, t, _ = x.shape
    xn = rms_norm(x, lw["ln1"], eps)
    q = rope(mm(xn, lw["wq"], prec).view(b, t, w["H"], w["D"]), theta)
    k = rope(mm(xn, lw["wk"], prec).view(b, t, w["KV"], w["D"]), theta)
    v = mm(xn, lw["wv"], prec).view(b, t, w["KV"], w["D"])
    if w["KV"] != w["H"]:
        rep = w["H"] // w["KV"]
        k, v = k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)
    o = attention(q, k, v, prec).reshape(b, t, w["HD"])
    h = x + mm(o, lw["wo"], prec)
    hn = rms_norm(h, lw["ln2"], eps)
    up = mm(hn, lw["w_up"], prec)
    gate = mm(hn, lw["w_gate"], prec)
    return h + mm(F.silu(gate) * up, lw["w_down"], prec)


def layer_weights(cfg: dict, seed: int, index: int, device) -> Dict:
    """Layer ``index``'s weights in float32 (the served bits, widened)."""
    lw = wts.layer(cfg, seed, index, device, torch.float32)
    e = yardstick.widths(cfg)["E"]
    ones = torch.ones(e, device=device)
    lw["ln1"], lw["ln2"] = ones, ones.clone()
    return lw


# -- serving: logits of served sequences, layer by layer ---------------------

def served_logits(cfg: dict, seed: int, device, sequences: Sequence[list],
                  starts: Sequence[int], precs: Sequence[str] = ("f32",)
                  ) -> Dict[str, List[torch.Tensor]]:
    """For each token sequence of ``n``, the float32 logits
    ``[n - start + 1, V]`` at positions ``start - 1 .. n - 1`` (each
    predicts the token after it),
    under each precision in ``precs``.  Layers run one at a time over
    every sequence, their weights made again from the seed, so the
    whole model is never held at once."""
    strict_float32()
    eps = float(cfg.get("rms_norm_eps", 1e-6))
    w = yardstick.widths(cfg)
    with torch.no_grad():
        embed = wts.embedding(cfg, seed, device, torch.float32)
        ids = [torch.tensor(s, dtype=torch.long, device=device)
               for s in sequences]
        xs = {p: [embed[i][None] for i in ids] for p in precs}
        del embed
        for li in range(w["L"]):
            lw = layer_weights(cfg, seed, li, device)
            for p in precs:
                xs[p] = [block(x, lw, cfg, p) for x in xs[p]]
            del lw
        unembed = wts.unembedding(cfg, seed, device, torch.float32)
        ln_f = torch.ones(w["E"], device=device)
        out = {}
        for p in precs:
            out[p] = [mm(rms_norm(x[0, s - 1:], ln_f, eps), unembed, p)
                      for x, s in zip(xs[p], starts)]
    return out


# -- training: three AdamW steps ---------------------------------------------

def _params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    w = yardstick.widths(cfg)
    ps = {"embed": wts.embedding(cfg, seed, device, torch.float32),
          "unembed": wts.unembedding(cfg, seed, device, torch.float32),
          "ln_f": torch.ones(w["E"], device=device)}
    for li in range(w["L"]):
        for k, t in layer_weights(cfg, seed, li, device).items():
            ps[f"layers.{li}.{k}"] = t.clone()
    return ps


def _loss_sum(ps: Dict[str, torch.Tensor], cfg: dict, ids: torch.Tensor,
              labels: torch.Tensor, prec: str) -> torch.Tensor:
    w = yardstick.widths(cfg)
    eps = float(cfg.get("rms_norm_eps", 1e-6))
    x = ps["embed"][ids]
    for li in range(w["L"]):
        lw = {k: ps[f"layers.{li}.{k}"]
              for k in wts.LAYER_LEAVES + ("ln1", "ln2")}
        x = checkpoint(lambda x_, lw_: block(x_, lw_, cfg, prec), x, lw,
                       use_reentrant=False)
    logits = mm(rms_norm(x, ps["ln_f"], eps), ps["unembed"], prec)
    return F.cross_entropy(logits.reshape(-1, w["V"]), labels.reshape(-1),
                           reduction="sum")


def train_steps(cfg: dict, seed: int, device, batches: Sequence,
                hp: dict, prec: str = "f32", rows_at_once: int = 2,
                half_batch: bool = False) -> Dict:
    """AdamW steps (``hp``: lr, betas, eps, weight_decay, torch's
    AdamW rule) on ``batches`` of ``(ids, labels)`` from the seed's
    weights.  Returns each step's mean loss, each leaf's norm of the
    first step's gradient, and each leaf's norm of the change of the
    parameters after the last step.  ``half_batch`` keeps the first
    half of each batch's rows, or of a single row's tokens (a fault the
    check must catch)."""
    strict_float32()
    ps = _params(cfg, seed, device)
    for t in ps.values():
        t.requires_grad_(True)
    m = {k: torch.zeros_like(t) for k, t in ps.items()}
    v = {k: torch.zeros_like(t) for k, t in ps.items()}
    lr, (b1, b2) = float(hp["lr"]), hp["betas"]
    eps, wd = float(hp["eps"]), float(hp["weight_decay"])
    losses, grad_norms = [], None
    for step, (ids, labels) in enumerate(batches, start=1):
        ids, labels = ids.to(device), labels.to(device)
        if half_batch and ids.shape[0] > 1:
            ids, labels = ids[:ids.shape[0] // 2], labels[:ids.shape[0] // 2]
        elif half_batch:        # one row: its first half of the tokens
            t = ids.shape[1] // 2
            ids, labels = ids[:, :t], labels[:, :t]
        n = labels.numel()
        total = 0.0
        for lo in range(0, ids.shape[0], rows_at_once):
            part = _loss_sum(ps, cfg, ids[lo:lo + rows_at_once],
                             labels[lo:lo + rows_at_once], prec) / n
            part.backward()
            total += float(part.detach())
        losses.append(total)
        with torch.no_grad():
            if grad_norms is None:
                grad_norms = {k: float(t.grad.norm()) for k, t in ps.items()}
            c1, c2 = 1 - b1 ** step, 1 - b2 ** step
            for k, p in ps.items():
                g = p.grad
                p.mul_(1 - lr * wd)
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[k].sqrt() / math.sqrt(c2)).add_(eps)
                p.addcdiv_(m[k], denom, value=-lr / c1)
                p.grad = None
    del m, v
    with torch.no_grad():
        start = _params(cfg, seed, device)
        change = {k: float((ps[k] - start[k]).norm()) for k in ps}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
