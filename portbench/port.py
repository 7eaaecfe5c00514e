"""Where the benchmark meets the program under test (``dmlc_tpu_torch``):
the configuration's sizes as the program's ``TransformerConfig``, and
the seed's weights copied into its model.  Everything else the drivers
take from the program is its entry points, spans and counters."""

from __future__ import annotations

import torch

from . import weights as wts
from . import yardstick


def transformer_config(cfg: dict):
    """The program's config of a configuration file: the published
    widths, one dense expert (the program's dense FFN), the file's
    dtype and, for training, its remat policy."""
    from dmlc_tpu_torch.models.transformer import TransformerConfig

    w = yardstick.widths(cfg)
    if w["KV"] != w["H"]:
        raise ValueError("the program's attention has as many K/V heads "
                         "as query heads")
    port = cfg.get("program", {})
    return TransformerConfig(
        vocab=w["V"], d_model=w["E"], n_heads=w["H"], head_dim=w["D"],
        d_ff=w["F"], n_layers=w["L"], n_experts=1, microbatches=1,
        dtype=cfg.get("torch_dtype", "bfloat16"),
        remat=bool(port.get("remat", False)),
        remat_policy=port.get("remat_policy", "save_flash"))


def leaves(model, cfg: dict):
    """The program's parameters under the reference's names (the
    one-expert ``gate`` has no counterpart and is left out)."""
    w = yardstick.widths(cfg)
    out = {"embed": model.embed, "unembed": model.unembed,
           "ln_f": model.ln_f}
    for li, layer in enumerate(model.layers):
        p = f"layers.{li}."
        out.update({
            p + "ln1": layer.ln1, p + "ln2": layer.ln2,
            p + "wq": layer.wq.view(w["E"], w["HD"]),
            p + "wk": layer.wk.view(w["E"], w["HD"]),
            p + "wv": layer.wv.view(w["E"], w["HD"]),
            p + "wo": layer.wo.view(w["HD"], w["E"]),
            p + "w_up": layer.w_in[0], p + "w_gate": layer.w_gate[0],
            p + "w_down": layer.w_out[0]})
    return out


@torch.no_grad()
def build_model(cfg: dict, seed: int, device):
    """The program's model holding the seed's weights."""
    from dmlc_tpu_torch.models.transformer import Transformer

    model = Transformer(transformer_config(cfg), device=device)
    named = leaves(model, cfg)
    named["embed"].copy_(wts.embedding(cfg, seed, device))
    named["unembed"].copy_(wts.unembedding(cfg, seed, device))
    named["ln_f"].fill_(1.0)
    for li, layer in enumerate(model.layers):
        for k, t in wts.layer(cfg, seed, li, device).items():
            named[f"layers.{li}.{k}"].copy_(t)
        layer.ln1.fill_(1.0)
        layer.ln2.fill_(1.0)
        layer.gate.zero_()      # one expert: its softmax is exactly 1
    return model
