"""Launch the port's serving plane on the GPU.

Builds the model (random weights from ``--seed``), the paged KV cache
and the continuous-batching engine on the CUDA card, then serves
POST /generate and the telemetry endpoints (/metrics, /healthz,
/requests, /slo, /goodput, /compute, /trace, /spans) until interrupted.
SIGTERM drains: new requests get 503 + Retry-After, in-flight ones finish
within ``DMLC_SERVE_DRAIN_S``, then the process exits.  Capacity knobs
come from the ``DMLC_SERVE_*`` environment family and SLOs from
``DMLC_SLO_*``, as in the JAX package's ``bin/dmlc-serve``.

Usage:
  python -m dmlc_tpu_torch.serving.serve [--host H] [--port P]
      [--model tiny|flagship] [--layers N] [--seed N] [--eos-id ID]
      [--device DEV]

``--layers`` serves the model's widths at another depth.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from ..base import get_env
from ..models import transformer as tfm
from .engine import InferenceEngine, resolve_device
from .server import ServingHTTPServer

TINY = tfm.TransformerConfig(vocab=512, d_model=64, n_heads=4, head_dim=16,
                             d_ff=128, n_layers=4, n_experts=1,
                             dtype="float32")


def build_model(name: str, seed: int, device: torch.device,
                layers: int = None):
    cfg = tfm.flagship_config() if name == "flagship" else TINY
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    gen = torch.Generator(device=device).manual_seed(seed)
    return tfm.init_params(cfg, gen, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dmlc_tpu_torch.serving.serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--host", default=get_env("DMLC_SERVE_HOST",
                                              "127.0.0.1"))
    ap.add_argument("--port", type=int, default=get_env(
        "DMLC_SERVE_PORT", 8901))
    ap.add_argument("--model", choices=("tiny", "flagship"), default="tiny")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: the model's own)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; required "
                         "to run without one, e.g. --device cpu)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    model = build_model(args.model, args.seed, device, args.layers)
    engine = InferenceEngine(model, device=device, eos_id=args.eos_id)
    engine.start()
    server = ServingHTTPServer(engine, host=args.host, port=args.port)
    server.install_drain_handler()
    print(f"dmlc_tpu_torch serve: {server.url}/generate (model={args.model},"
          f" layers={model.cfg.n_layers}, device={device}, "
          f"kv={engine.cache.n_blocks}x{engine.cache.block_size} tokens, "
          f"max_active="
          f"{engine.max_active}); /metrics /healthz /requests /slo /trace "
          f"(SLOs {'on' if engine.slo.enabled else 'off: set DMLC_SLO_*'})",
          flush=True)
    try:
        while not engine.draining:
            time.sleep(0.2)
        server.wait_drained()
        print("dmlc_tpu_torch serve: drained, exiting", flush=True)
    except KeyboardInterrupt:
        print("dmlc_tpu_torch serve: shutting down", flush=True)
    finally:
        server.close()
        engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
