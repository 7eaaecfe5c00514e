"""dmlc_tpu_torch.serving: the port's request-serving plane.

  * ``kv_cache``   paged KV pools on the device + free-list allocator
  * ``scheduler``  iteration-level admit/evict with preemption-by-recompute
  * ``engine``     the prefill/decode loop (flash and paged kernels),
                   greedy sampling, n-gram speculative decoding
  * ``server``     POST /generate + GET /healthz
  * ``serve``      ``python -m dmlc_tpu_torch.serving.serve``
"""

from .engine import AdmissionFull, InferenceEngine, RequestTooLarge  # noqa: F401
from .kv_cache import BlockAllocator, PagedKVCache  # noqa: F401
from .scheduler import ContinuousBatchScheduler, Request  # noqa: F401
from .server import ServingHTTPServer  # noqa: F401

__all__ = ["AdmissionFull", "BlockAllocator", "ContinuousBatchScheduler",
           "InferenceEngine", "PagedKVCache", "Request", "RequestTooLarge",
           "ServingHTTPServer"]
