"""Launch the port's serving plane on the GPU.

Builds the model (random weights from ``--seed``), the paged KV cache
and the continuous-batching engine on the CUDA card, then serves
POST /generate and GET /healthz until interrupted.  Capacity knobs come
from the ``DMLC_SERVE_*`` environment family, as in the JAX package's
``bin/dmlc-serve``.

Usage:
  python -m dmlc_tpu_torch.serving.serve [--host H] [--port P]
      [--model tiny|flagship] [--seed N] [--eos-id ID] [--device DEV]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from ..models import transformer as tfm
from .engine import InferenceEngine, resolve_device
from .server import ServingHTTPServer

TINY = tfm.TransformerConfig(vocab=512, d_model=64, n_heads=4, head_dim=16,
                             d_ff=128, n_layers=4, n_experts=1,
                             dtype="float32")


def build_model(name: str, seed: int, device: torch.device):
    cfg = tfm.flagship_config() if name == "flagship" else TINY
    gen = torch.Generator(device=device).manual_seed(seed)
    return tfm.init_params(cfg, gen, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dmlc_tpu_torch.serving.serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--host", default=os.environ.get("DMLC_SERVE_HOST",
                                                     "127.0.0.1"))
    ap.add_argument("--port", type=int, default=int(os.environ.get(
        "DMLC_SERVE_PORT", "8901")))
    ap.add_argument("--model", choices=("tiny", "flagship"), default="tiny")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; required "
                         "to run without one, e.g. --device cpu)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    model = build_model(args.model, args.seed, device)
    engine = InferenceEngine(model, device=device, eos_id=args.eos_id)
    engine.start()
    server = ServingHTTPServer(engine, host=args.host, port=args.port)
    print(f"dmlc_tpu_torch serve: {server.url}/generate (model={args.model},"
          f" device={device}, kv={engine.cache.n_blocks}x"
          f"{engine.cache.block_size} tokens, max_active="
          f"{engine.max_active})", flush=True)
    try:
        while True:
            time.sleep(0.5)
    except KeyboardInterrupt:
        print("dmlc_tpu_torch serve: shutting down", flush=True)
    finally:
        server.close()
        engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
