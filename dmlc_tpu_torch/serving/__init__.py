"""dmlc_tpu_torch.serving: the port's request-serving plane.

  * ``kv_cache``   paged KV pools on the device + free-list allocator
                   (on a mesh, this rank's heads; ``kv_partition_spec``)
  * ``scheduler``  iteration-level admit/evict with preemption-by-recompute
  * ``engine``     the prefill/decode loop (flash and paged kernels),
                   greedy sampling, n-gram speculative decoding, the
                   request / SLO / availability ledgers and the decode
                   step ledger, idempotent submits and drain; on a dp x
                   tp mesh one controller (rank 0) and followers
                   (``InferenceEngine.follow``)
  * ``server``     POST /generate + the telemetry endpoints (/metrics,
                   /healthz, /requests, /slo, /goodput, /trace, /spans)
                   and drain on SIGTERM
  * ``loadgen``    N-stream closed-loop load against a server
  * ``serve``      ``python -m dmlc_tpu_torch.serving.serve``
  * ``router``     the fleet front door over N replicas: health circuit,
                   least-loaded placement, idempotent retry and
                   failover, hedging, drain shift, tenant fairness, the
                   fleet trace store behind /trace
  * ``route``      ``python -m dmlc_tpu_torch.serving.route``
"""

from .engine import (AdmissionFull, EngineDraining, InferenceEngine,  # noqa: F401
                     RequestTooLarge)
from .kv_cache import BlockAllocator, PagedKVCache  # noqa: F401
from .loadgen import LoadGenerator  # noqa: F401
from .router import Router, RouterHTTPServer, discover_replicas  # noqa: F401
from .scheduler import ContinuousBatchScheduler, Request  # noqa: F401
from .server import ServingHTTPServer  # noqa: F401

__all__ = ["AdmissionFull", "BlockAllocator", "ContinuousBatchScheduler",
           "EngineDraining", "InferenceEngine", "LoadGenerator",
           "PagedKVCache", "Request", "RequestTooLarge", "Router",
           "RouterHTTPServer", "ServingHTTPServer", "discover_replicas"]
