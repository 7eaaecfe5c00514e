"""Launch the fleet router: a health-checked, retrying, hedging HTTP
front door over N serving replicas.

Replicas come from --replicas (comma-separated base URLs, or the
DMLC_ROUTER_REPLICAS env default) or from a tracker job map via
--tracker HOST:PORT, where rank r of the current generation is
expected to serve on --serve-port-base + r on its brokered host.  The
replicas are ``python -m dmlc_tpu_torch.serving.serve`` processes (any
server with the same wire format will do); the router itself loads no
model and needs no card.

A replica crash under live traffic is absorbed by idempotent retry
(dmlc_router_failovers_total counts them); a SIGTERM'd (draining)
replica sheds traffic onto the fleet with zero client-facing 503s;
when every replica is saturated the router answers 429 with a
Retry-After computed from the aggregate queue depth.  Routing, health,
hedging, and timeout knobs are the DMLC_ROUTER_* family (README
"Fleet serving on the port").  SIGTERM stops the router.

Usage:
  python -m dmlc_tpu_torch.serving.route \\
      --replicas http://h1:8901,http://h2:8901 [--host H] [--port P]
  python -m dmlc_tpu_torch.serving.route --tracker 10.0.0.1:9091 \\
      --serve-port-base 8901
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

from ..base import get_env
from .router import Router, RouterHTTPServer, discover_replicas


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="dmlc_tpu_torch.serving.route", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--host", default=get_env(
        "DMLC_ROUTER_HOST", "127.0.0.1"))
    ap.add_argument("--port", type=int, default=get_env(
        "DMLC_ROUTER_PORT", 8900))
    ap.add_argument("--replicas", default=get_env(
        "DMLC_ROUTER_REPLICAS", ""),
        help="comma-separated replica base URLs")
    ap.add_argument("--tracker", default=None, metavar="HOST:PORT",
                    help="discover replicas from this tracker's job map")
    ap.add_argument("--serve-port-base", type=int, default=8901,
                    help="with --tracker: rank r serves on base+r")
    args = ap.parse_args(argv)

    urls = [u.strip() for u in args.replicas.split(",") if u.strip()]
    if args.tracker:
        host, _, port = args.tracker.partition(":")
        urls += discover_replicas(host, int(port or 9091),
                                  args.serve_port_base)
    if not urls:
        ap.error("no replicas: pass --replicas or --tracker")

    router = Router(urls)
    server = RouterHTTPServer(router, host=args.host, port=args.port)
    print(f"dmlc-router: {server.url}/generate over {len(urls)} "
          f"replicas:", flush=True)
    for u in urls:
        print(f"dmlc-router:   {u}", flush=True)
    print(f"dmlc-router: fleet health at /healthz /replicas /metrics; "
          f"hedging "
          f"{'on' if router.hedge_after_p99_mult > 0 else 'off'} "
          f"(DMLC_ROUTER_HEDGE_AFTER_P99_MULT)", flush=True)
    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: done.set())
    try:
        done.wait()
        print("dmlc-router: SIGTERM, exiting", flush=True)
    except KeyboardInterrupt:
        print("dmlc-router: shutting down", flush=True)
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
