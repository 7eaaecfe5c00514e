"""The REST request loop the S3 and Azure backends share (the port of
``dmlc_tpu/io/rest.py``).

One ``resilience.RetryPolicy`` loop: transient 408/429/5xx and
connection errors are resent with exponential backoff and jitter, a
permanent failure raises ``DMLCError`` with the HTTP code as its
``status``.  GCS keeps its own loop (its resumable upload answers 308
and recovers between attempts) and WebHDFS its own (the namenode's 307
redirect), on the same policy.

Each attempt crosses the ``<service>.request`` fault point, so
``DMLC_FAULT_SPEC='s3.request=error::2'`` tears the first two S3
requests.
"""

from __future__ import annotations

import urllib.error
import urllib.request
from typing import Callable, Optional

from ..base import DMLCError, check, get_env
from ..resilience import RetryPolicy, fault_point
from ..resilience.retry import TRANSIENT_HTTP  # noqa: F401  (re-export)

__all__ = ["TRANSIENT_HTTP", "rest_request"]

Signer = Callable[[str, str, dict, Optional[bytes]], dict]


def rest_request(service: str, url: str, method: str = "GET",
                 data: Optional[bytes] = None,
                 headers: Optional[dict] = None,
                 ok=(200, 201, 204, 206),
                 sign: Optional[Signer] = None,
                 retries_env: str = "DMLC_REST_RETRIES"):
    """One signed call with transient-error retry.

    ``sign(method, url, headers, data) -> headers`` runs on every
    attempt, so a time-stamped signature stays fresh across retries.
    Route only idempotent operations here (a transient error resends
    blindly).  An HTTPError whose code is in ``ok`` is returned, not
    raised (a DELETE of an absent path answering 404)."""
    policy = RetryPolicy.from_env(retries_env=retries_env,
                                  name=service.lower())
    timeout = get_env("DMLC_REST_TIMEOUT_S", 60.0)
    short_url = url.split("?")[0]
    site = f"{service.lower()}.request"

    def attempt():
        fault_point(site, method=method, url=short_url)
        hdrs = sign(method, url, headers or {}, data) if sign \
            else dict(headers or {})
        hdrs.pop("host", None)   # urllib sets Host itself
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=hdrs)
        try:
            resp = urllib.request.urlopen(req, timeout=timeout)
        except urllib.error.HTTPError as e:
            if e.code in ok:
                return e
            raise DMLCError(
                f"{service} {method} {short_url} failed: "
                f"HTTP {e.code} {e.read()[:300]!r}", status=e.code) from e
        except urllib.error.URLError as e:   # DNS, refused, timeouts
            raise DMLCError(f"{service} {method} {short_url} "
                            f"failed: {e.reason}", transient=True) from e
        check(resp.status in ok,
              f"{service} {method}: unexpected HTTP {resp.status}")
        return resp

    return policy.call(attempt)
