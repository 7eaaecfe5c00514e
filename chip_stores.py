#!/usr/bin/env python3
"""Object-store emulators for ``chip_smoke.py``'s ``remote`` phase: the
slice of the S3 REST API and of the GCS JSON API that the port's
``s3://`` and ``gs://`` backends speak, on the standard library only.

    python3 chip_stores.py

starts both on 127.0.0.1 at free ports, prints one JSON line
``{"s3": PORT, "gcs": PORT}`` and serves until killed.  The smoke runs
it as a child process, so the servers' Python shares no interpreter lock
with the feed it measures.

S3 (path style, ``/<bucket>/<key>``): HEAD, ranged GET, ListObjectsV2
with a delimiter, PUT, and the multipart lifecycle (initiate, upload a
part, complete, abort).  Every request must carry a SigV4 signature,
recomputed here from the request as received with the secret in
``AWS_SECRET_ACCESS_KEY`` (this file's own implementation of the
scheme), and a payload hash equal to the body's SHA-256; a mismatch is
403.  GCS: object metadata, media download with Range, listing with a
delimiter, and resumable uploads (session, chunk PUTs answered 308 with
the committed range, the final PUT, DELETE of a session).  ``GET
/_stats`` on either server returns its request counts.
"""

import hashlib
import hmac
import json
import os
import re
import sys
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

STATS = {}
_STATS_LOCK = threading.Lock()


def _count(name):
    with _STATS_LOCK:
        STATS[name] = STATS.get(name, 0) + 1


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def reply(self, code, body=b"", headers=(), head=False):
        self.send_response(code)
        for k, v in headers:
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body and not head:
            self.wfile.write(body)

    def body(self):
        return self.rfile.read(int(self.headers.get("Content-Length", 0)))

    def stats(self):
        if self.path != "/_stats":
            return False
        with _STATS_LOCK:
            self.reply(200, json.dumps(STATS).encode(),
                       headers=[("Content-Type", "application/json")])
        return True


def _ranged(handler, data, head=False):
    rng = handler.headers.get("Range")
    if not rng:
        handler.reply(200, memoryview(data), head=head)
        return
    lo, hi = rng.split("=")[1].split("-")
    lo, hi = int(lo), min(int(hi), len(data) - 1)
    handler.reply(206, memoryview(data)[lo: hi + 1], head=head)


# ---------------------------------------------------------------------------
# S3
# ---------------------------------------------------------------------------

def _quote(s):
    return urllib.parse.quote(s, safe="-_.~")


def sigv4_ok(method, path, headers, payload):
    """Whether the request carries a valid SigV4 signature over what was
    received: the canonical request rebuilt from the raw path, query and
    signed headers, the payload hash checked against the body."""
    auth = headers.get("Authorization") or ""
    m = re.match(r"AWS4-HMAC-SHA256 Credential=([^/]+)/(\d{8})/([^/]+)/s3/"
                 r"aws4_request, SignedHeaders=([^,]+), Signature=([0-9a-f]+)$",
                 auth)
    secret = os.environ.get("AWS_SECRET_ACCESS_KEY", "")
    if not m or not secret or m.group(1) != os.environ.get(
            "AWS_ACCESS_KEY_ID"):
        return False
    _, day, region, names, sig = m.groups()
    digest = headers.get("x-amz-content-sha256", "")
    if digest != hashlib.sha256(payload).hexdigest():
        return False
    amzdate = headers.get("x-amz-date", "")
    if not amzdate.startswith(day):
        return False
    u = urllib.parse.urlsplit(path)
    query = "&".join(
        f"{_quote(k)}={_quote(v)}"
        for k, vals in sorted(urllib.parse.parse_qs(
            u.query, keep_blank_values=True).items()) for v in sorted(vals))
    canon_headers = "".join(
        f"{n}:{(headers.get(n) or '').strip()}\n" for n in names.split(";"))
    canonical = "\n".join([method, u.path or "/", query, canon_headers,
                           names, digest])
    scope = f"{day}/{region}/s3/aws4_request"
    to_sign = "\n".join(["AWS4-HMAC-SHA256", amzdate, scope,
                         hashlib.sha256(canonical.encode()).hexdigest()])
    key = ("AWS4" + secret).encode()
    for part in (day, region, "s3", "aws4_request"):
        key = hmac.new(key, part.encode(), hashlib.sha256).digest()
    want = hmac.new(key, to_sign.encode(), hashlib.sha256).hexdigest()
    return hmac.compare_digest(want, sig)


class S3Handler(_Handler):
    store = {}     # (bucket, key) -> bytes
    uploads = {}   # upload id -> {"target": (bucket, key), "parts": {n: bytes}}
    _next = [0]
    _lock = threading.Lock()

    def parse(self, payload=b""):
        """(bucket, key, query) of a request with a valid signature, else
        None after answering 403."""
        if not sigv4_ok(self.command, self.path, self.headers, payload):
            _count("s3_rejected")
            self.reply(403, b"SignatureDoesNotMatch")
            return None
        u = urllib.parse.urlsplit(self.path)
        bucket, _, key = u.path.lstrip("/").partition("/")
        q = {k: v[0] for k, v in urllib.parse.parse_qs(
            u.query, keep_blank_values=True).items()}
        return bucket, urllib.parse.unquote(key), q

    def do_HEAD(self):
        got = self.parse()
        if got is None:
            return
        _count("s3_head")
        data = self.store.get(got[:2])
        if data is None:
            self.reply(404, head=True)
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()

    def do_GET(self):
        if self.stats():
            return
        got = self.parse()
        if got is None:
            return
        bucket, key, q = got
        if q.get("list-type") == "2":
            _count("s3_list")
            prefix, delim = q.get("prefix", ""), q.get("delimiter")
            objs, prefixes = [], set()
            for (b, k), data in sorted(self.store.items()):
                if b != bucket or not k.startswith(prefix):
                    continue
                rest = k[len(prefix):]
                if delim and delim in rest:
                    prefixes.add(prefix + rest.split(delim)[0] + delim)
                else:
                    objs.append(f"<Contents><Key>{k}</Key><Size>{len(data)}"
                                "</Size></Contents>")
            xml = ("<?xml version='1.0'?><ListBucketResult>" + "".join(objs)
                   + "".join(f"<CommonPrefixes><Prefix>{p}</Prefix>"
                             "</CommonPrefixes>" for p in sorted(prefixes))
                   + "</ListBucketResult>")
            self.reply(200, xml.encode())
            return
        _count("s3_get")
        data = self.store.get((bucket, key))
        if data is None:
            self.reply(404)
            return
        _ranged(self, data)

    def do_PUT(self):
        payload = self.body()
        got = self.parse(payload)
        if got is None:
            return
        bucket, key, q = got
        if "partNumber" in q:
            _count("s3_part")
            up = self.uploads.get(q.get("uploadId"))
            if up is None:
                self.reply(404)
                return
            up["parts"][int(q["partNumber"])] = payload
            self.reply(200, headers=[
                ("ETag", f'"{hashlib.md5(payload).hexdigest()}"')])
            return
        _count("s3_put")
        self.store[(bucket, key)] = payload
        self.reply(200)

    def do_POST(self):
        payload = self.body()
        got = self.parse(payload)
        if got is None:
            return
        bucket, key, q = got
        if "uploads" in q:
            _count("s3_initiate")
            with self._lock:
                self._next[0] += 1
                uid = f"upload-{self._next[0]}"
            self.uploads[uid] = {"target": (bucket, key), "parts": {}}
            self.reply(200, (
                "<?xml version='1.0'?><InitiateMultipartUploadResult>"
                f"<UploadId>{uid}</UploadId>"
                "</InitiateMultipartUploadResult>").encode())
            return
        if "uploadId" in q:
            _count("s3_complete")
            up = self.uploads.pop(q["uploadId"], None)
            if up is None:
                self.reply(404, b"NoSuchUpload")
                return
            nums = [int(n) for n in re.findall(
                rb"<PartNumber>(\d+)</PartNumber>", payload)]
            if nums != sorted(up["parts"]) or not nums:
                self.reply(400, b"InvalidPart")
                return
            self.store[up["target"]] = b"".join(up["parts"][n] for n in nums)
            STATS.setdefault("s3_parts_committed", []).append(len(nums))
            self.reply(200, b"<CompleteMultipartUploadResult/>")
            return
        self.reply(400)

    def do_DELETE(self):
        got = self.parse()
        if got is None:
            return
        _count("s3_abort")
        if self.uploads.pop(got[2].get("uploadId"), None) is None:
            self.reply(404)
        else:
            self.reply(204)


# ---------------------------------------------------------------------------
# GCS
# ---------------------------------------------------------------------------

class GCSHandler(_Handler):
    store = {}      # (bucket, name) -> bytes
    sessions = {}   # session id -> {"target": (bucket, name), "data": bytearray}
    _next = [0]
    _lock = threading.Lock()

    def json(self, obj, code=200):
        self.reply(code, json.dumps(obj).encode(),
                   headers=[("Content-Type", "application/json")])

    def do_POST(self):
        self.body()
        u = urllib.parse.urlsplit(self.path)
        q = urllib.parse.parse_qs(u.query)
        m = re.match(r"^/upload/storage/v1/b/([^/]+)/o$", u.path)
        if not m or q.get("uploadType") != ["resumable"]:
            self.reply(404)
            return
        _count("gcs_session")
        with self._lock:
            self._next[0] += 1
            sid = str(self._next[0])
        self.sessions[sid] = {"target": (m.group(1), q["name"][0]),
                              "data": bytearray()}
        self.reply(200, headers=[
            ("Location", f"http://{self.headers['Host']}/session/{sid}")])

    def do_PUT(self):
        payload = self.body()
        m = re.match(r"^/session/(\d+)$", self.path)
        sess = self.sessions.get(m.group(1)) if m else None
        if sess is None:
            self.reply(404)
            return
        _count("gcs_chunk")
        crange = self.headers.get("Content-Range", "")
        span = re.match(r"^bytes (\d+)-(\d+)/", crange)
        if span:
            start, have = int(span.group(1)), len(sess["data"])
            if start > have:
                self.reply(400, b"gap in Content-Range")
                return
            sess["data"] += memoryview(payload)[have - start:]
        if crange.endswith("/*"):   # a chunk, or a status query
            n = len(sess["data"])
            self.reply(308, headers=[("Range", f"bytes=0-{n - 1}")]
                       if n else ())
            return
        self.store[sess["target"]] = bytes(sess["data"])
        del self.sessions[m.group(1)]
        self.json({"name": sess["target"][1],
                   "size": str(len(self.store[sess["target"]]))})

    def do_DELETE(self):
        m = re.match(r"^/session/(\d+)$", self.path)
        if m and self.sessions.pop(m.group(1), None) is not None:
            _count("gcs_cancel")
            self.reply(204)
            return
        self.reply(404)

    def do_HEAD(self):
        self.do_GET(head=True)

    def do_GET(self, head=False):
        if self.stats():
            return
        u = urllib.parse.urlsplit(self.path)
        q = urllib.parse.parse_qs(u.query)
        m = re.match(r"^/(download/)?storage/v1/b/([^/]+)/o/(.+)$", u.path)
        if m:
            key = (m.group(2), urllib.parse.unquote(m.group(3)))
            data = self.store.get(key)
            if data is None:
                self.reply(404, head=head)
            elif m.group(1):   # media
                _count("gcs_head" if head else "gcs_get")
                _ranged(self, data, head)
            else:
                _count("gcs_stat")
                self.json({"name": key[1], "size": str(len(data))})
            return
        m = re.match(r"^/storage/v1/b/([^/]+)/o$", u.path)
        if not m:
            self.reply(404)
            return
        _count("gcs_list")
        prefix = q.get("prefix", [""])[0]
        delim = q.get("delimiter", [None])[0]
        items, prefixes = [], set()
        for (b, name), data in sorted(self.store.items()):
            if b != m.group(1) or not name.startswith(prefix):
                continue
            rest = name[len(prefix):]
            if delim and delim in rest:
                prefixes.add(prefix + rest.split(delim)[0] + delim)
            else:
                items.append({"name": name, "size": str(len(data))})
        self.json({"items": items, "prefixes": sorted(prefixes)})


class _Server(ThreadingHTTPServer):
    # a listen backlog of socketserver's 5 overflows when a feed's
    # partition readers connect at once, and a connection lost there
    # waits out the client's 60 s timeout
    request_queue_size = 128
    daemon_threads = True


def serve():
    """Both emulators on free ports of 127.0.0.1, in daemon threads;
    returns the servers."""
    servers = {name: _Server(("127.0.0.1", 0), handler)
               for name, handler in (("s3", S3Handler), ("gcs", GCSHandler))}
    for srv in servers.values():
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    return servers


def main():
    servers = serve()
    print(json.dumps({n: s.server_port for n, s in servers.items()}),
          flush=True)
    threading.Event().wait()


if __name__ == "__main__":
    sys.exit(main())
