"""HttpStore: read-only byte store over any static HTTP(S) file server.

The paper's ex situ workflow assumes compressed datasets live on shared
storage and are read back over the network.  This backend closes that loop
with nothing but the stdlib: a dataset directory exported by *any* static
file server (nginx, an S3 website endpoint, ``python -m
repro_torch.store.backends.http``) becomes an ``http://`` / ``https://``
store that the container's readers (``read_field``, ``describe``,
``FieldReader``) take as ``store=``.

Design points:

* **byte-range GETs** — ``get(key, (start, end))`` sends ``Range:
  bytes=start-end-1``, so ``FieldReader`` pulls footers and chunks without
  ever transferring whole members.  Servers that ignore ``Range`` (plain
  ``python -m http.server``) answer 200 with the full object; the store
  slices client-side so reads stay *correct*, at whole-object transfer
  cost — the bytes_fetched meter makes that amplification visible;
* **keep-alive connection pooling** — a small pool of
  :class:`http.client.HTTPConnection` per store, reused across requests;
  a request that trips over a stale pooled connection is retried once on a
  fresh one (server restarts between requests are invisible);
* **read-only** — ``put``/``delete``/``list`` raise: a static file server
  has no write or enumeration protocol; writes need a writable backend;
* **remote** — ``Store.remote = True``, so ``open_store`` wraps HttpStore
  in a :class:`~repro_torch.store.backends.retry.RetryStore` by default and
  transient network faults are absorbed by policy.

:class:`StaticFileServer` is the loopback half: a threaded,
range-capable static server over a local directory (stdlib
``http.server`` does **not** honor ``Range``), used by tests and
``chip_smoke.py`` — and runnable standalone via ``python -m
repro_torch.store.backends.http <dir>`` as the quickest way to export a
directory of containers.
"""
from __future__ import annotations

import os
import re
import threading
import time
from http.client import HTTPConnection, HTTPException, HTTPSConnection
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import quote, unquote, urlsplit

from .base import (Store, StoreKeyError, StoreRangeError, check_key,
                   shared_io_pool)
from .instrument import StoreMeter

__all__ = ["HttpStore", "StaticFileServer"]


class HttpStore(Store):
    """Read-only ranged-get store speaking HTTP(S) to a static file server.

    ``base_url`` is the dataset root (``http://host:port/path/to/ds``);
    keys are resolved beneath it.  ``timeout`` is the per-request socket
    timeout (connect + each read); ``pool_size`` bounds the keep-alive
    connection pool.
    """

    scheme = "http"
    remote = True

    def __init__(self, base_url: str, timeout: float = 30.0,
                 pool_size: int = 8):
        super().__init__()
        if "://" not in base_url:
            base_url = "http://" + base_url
        u = urlsplit(base_url)
        if u.scheme not in ("http", "https"):
            raise ValueError(f"HttpStore needs an http(s) URL: {base_url!r}")
        if not u.hostname:
            raise ValueError(f"HttpStore URL needs a host: {base_url!r}")
        self.secure = u.scheme == "https"
        self.host = u.hostname
        self.port = u.port  # None -> protocol default
        self.prefix = u.path.rstrip("/")
        self.timeout = float(timeout)
        self.pool_size = int(pool_size)
        self._pool: list[HTTPConnection] = []
        self._pool_guard = threading.Lock()
        self.meter = StoreMeter("http")

    @classmethod
    def from_url(cls, rest: str, secure: bool = False) -> "HttpStore":
        return cls(("https://" if secure else "http://") + rest)

    # -- connection pool ---------------------------------------------------

    def _connect(self) -> HTTPConnection:
        cls = HTTPSConnection if self.secure else HTTPConnection
        return cls(self.host, self.port, timeout=self.timeout)

    def _borrow(self) -> HTTPConnection:
        with self._pool_guard:
            if self._pool:
                return self._pool.pop()
        return self._connect()

    def _give_back(self, conn: HTTPConnection) -> None:
        with self._pool_guard:
            if len(self._pool) < self.pool_size:
                self._pool.append(conn)
                return
        conn.close()

    def close(self) -> None:
        """Close pooled keep-alive connections (idempotent)."""
        with self._pool_guard:
            pool, self._pool = self._pool, []
        for conn in pool:
            conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _request(self, method: str, key: str, headers=None):
        """One HTTP exchange -> ``(status, lowercase headers, body)``.

        The single stale-keep-alive helper: a pooled connection whose peer
        has since closed fails here, not at the caller — the request is
        replayed once on a fresh connection (safe: everything this store
        sends is an idempotent GET/HEAD).
        """
        target = f"{self.prefix}/{quote(check_key(key))}"
        last: Exception | None = None
        for attempt in (0, 1):
            conn = self._borrow() if attempt == 0 else self._connect()
            try:
                conn.request(method, target, headers=headers or {})
                r = conn.getresponse()
                body = r.read()  # drain fully so the connection is reusable
            except (HTTPException, ConnectionError, OSError) as e:
                conn.close()
                last = e
                continue
            self._give_back(conn)
            return r.status, {k.lower(): v for k, v in r.getheaders()}, body
        raise IOError(f"{method} {self.url}/{key}: {last}") from last

    def _size(self, key: str) -> int:
        status, rh, _ = self._request("HEAD", key)
        if status == 404:
            raise StoreKeyError(key)
        if status != 200:
            raise IOError(f"HEAD {self.url}/{key} -> HTTP {status}")
        return int(rh.get("content-length", 0))

    # -- primitives --------------------------------------------------------

    def get(self, key, byte_range=None):
        t0 = time.perf_counter()
        headers = {}
        start = end = None
        if byte_range is not None:
            start, end = byte_range
            start = int(start)
            if start < 0:
                raise ValueError(f"byte_range start must be >= 0, got {start}")
            if end is not None and int(end) <= start:
                # empty span: nothing to transfer, but the contract still
                # requires key-exists and start-in-range — one HEAD settles
                # both (Range: bytes=N-M with M < N is not expressible)
                size = self._size(key)
                if start and start >= size:
                    raise StoreRangeError(key, start, size)
                return b""
            headers["Range"] = (f"bytes={start}-" if end is None
                                else f"bytes={start}-{int(end) - 1}")
        status, rh, body = self._request("GET", key, headers)
        if status == 404:
            raise StoreKeyError(key)
        if status == 416:
            m = re.match(r"bytes \*/(\d+)", rh.get("content-range", ""))
            raise StoreRangeError(key, start or 0, int(m.group(1)) if m else -1)
        if status == 206:
            data = body
        elif status == 200:
            if byte_range is None:
                data = body
            else:
                # server ignored Range: slice client-side (correct, but the
                # full object crossed the wire — see bytes_fetched)
                if start and start >= len(body):
                    raise StoreRangeError(key, start, len(body))
                data = body[start:] if end is None else body[start:int(end)]
        else:
            raise IOError(f"GET {self.url}/{key} -> HTTP {status}")
        self.meter.record("get", len(data), time.perf_counter() - t0,
                          ranged=byte_range is not None)
        return data

    def get_many(self, requests):
        """Pipelined ranged gets over the connection pool: one pooled
        connection per in-flight request, round-trips overlapped."""
        reqs = list(requests)
        if len(reqs) < 2:
            return [self.get(k, r) for k, r in reqs]
        pool = shared_io_pool()
        return [f.result()
                for f in [pool.submit(self.get, k, r) for k, r in reqs]]

    def exists(self, key):
        status, _, _ = self._request("HEAD", key)
        if status == 200:
            return True
        if status in (404, 410):
            return False
        raise IOError(f"HEAD {self.url}/{key} -> HTTP {status}")

    def put(self, key, data):
        raise IOError(f"HttpStore is read-only ({self.url}): cannot put "
                      f"{key!r} — write through the server's native backend")

    def delete(self, key):
        raise IOError(f"HttpStore is read-only ({self.url}): cannot delete "
                      f"{key!r}")

    def list(self, prefix=""):
        raise IOError(f"HttpStore cannot enumerate keys ({self.url}): static"
                      " HTTP has no listing protocol — gc and append need a"
                      " writable backend")

    def stats(self) -> dict:
        """Request/traffic counters since construction (meter shape)."""
        return self.meter.stats()

    @property
    def url(self) -> str:
        scheme = "https" if self.secure else "http"
        port = f":{self.port}" if self.port else ""
        return f"{scheme}://{self.host}{port}{self.prefix}"


# ---------------------------------------------------------------------------
# loopback static server (tests / benchmarks / quickstart)


class _StaticHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"  # keep-alive, so the pool gets exercised
    server_version = "cz-static/1"

    def log_message(self, fmt, *args):
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def _path_for(self) -> str | None:
        key = unquote(urlsplit(self.path).path).lstrip("/")
        try:
            check_key(key)
        except ValueError:
            return None
        return os.path.join(self.server.root, *key.split("/"))

    def do_GET(self):
        self._serve(head=False)

    def do_HEAD(self):
        self._serve(head=True)

    def _serve(self, head: bool):
        path = self._path_for()
        if path is None or not os.path.isfile(path):
            body = b"not found\n"
            self.send_response(404)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if not head:
                self.wfile.write(body)
            return
        size = os.path.getsize(path)
        start, end, status = 0, size, 200
        rng = self.headers.get("Range")
        if rng and size:
            m = re.match(r"bytes=(\d+)-(\d*)$", rng.strip())
            if m:  # unparsable Range falls through to a full 200
                start = int(m.group(1))
                if start >= size:
                    self.send_response(416)
                    self.send_header("Content-Range", f"bytes */{size}")
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                end = min(int(m.group(2)) + 1 if m.group(2) else size, size)
                status = 206
        self.send_response(status)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Accept-Ranges", "bytes")
        self.send_header("Content-Length", str(end - start))
        if status == 206:
            self.send_header("Content-Range", f"bytes {start}-{end - 1}/{size}")
        self.end_headers()
        if head:
            return
        with open(path, "rb") as f:
            f.seek(start)
            remaining = end - start
            while remaining > 0:
                buf = f.read(min(remaining, 1 << 16))
                if not buf:
                    break
                self.wfile.write(buf)
                remaining -= len(buf)


class StaticFileServer(ThreadingHTTPServer):
    """Range-capable threaded static file server over a directory.

    Exists because ``python -m http.server`` ignores ``Range`` headers —
    correct but amplified for ranged readers.  This one answers 206/416
    properly, so tests and benchmarks exercise true byte-range transfer.

    Usage::

        with StaticFileServer(ds_dir) as srv:
            store = HttpStore(srv.url)
    """

    daemon_threads = True

    def __init__(self, root, host: str = "127.0.0.1", port: int = 0,
                 verbose: bool = False):
        self.root = os.path.abspath(os.fspath(root))
        self.verbose = verbose
        self._thread: threading.Thread | None = None
        super().__init__((host, port), _StaticHandler)

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "StaticFileServer":
        """Serve on a daemon thread until :meth:`close`."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self.serve_forever, name="cz-static", daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        if self._thread is not None:
            self.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()


def main(argv=None) -> int:
    """``python -m repro_torch.store.backends.http DIR`` — export a dataset
    directory over loopback HTTP with byte-range support."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.store.backends.http",
        description="Range-capable static file server (stdlib http.server "
                    "ignores Range; this one answers 206/416).")
    ap.add_argument("dir", help="directory to export (a dataset root)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--verbose", action="store_true",
                    help="log each request to stderr")
    args = ap.parse_args(argv)

    srv = StaticFileServer(args.dir, host=args.host, port=args.port,
                           verbose=args.verbose)
    print(f"serving {srv.root} at {srv.url} (byte ranges supported) — "
          "Ctrl-C to stop")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
