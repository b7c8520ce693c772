"""Tiny shared HTTP helper (stdlib only): JSON in/out plus a raw-body
variant, over pooled keep-alive connections.

One place for the POST-a-dict/parse-a-dict pattern used by the agent
control plane on both sides; keeps timeout and decode behavior from
drifting between copies. Being the single transport choke point also
makes it the natural home for three cross-cutting concerns:

* **Typed failures**: HTTP error responses raise `HttpJsonError`, which
  subclasses `urllib.error.HTTPError` (so every existing `except
  HTTPError` site keeps working, including `.code` checks and
  `.read()` of the error body) but additionally exposes ``.status``
  and the already-read ``.body`` so `utils.retry.RetryPolicy` can stop
  retrying permanent 4xx without re-reading a consumed stream.
* **Fault injection**: callers name their `chaos_site` and the module
  applies transport-level faults (drop / delay / error / duplicate)
  from `cook_tpu.chaos` in one place, so every RPC in the repo is
  injectable without per-call-site fault code.
* **Connection reuse**: requests ride a process-wide pool of
  `http.client` connections keyed by (scheme, host, port), so the
  steady-state RPC streams (heartbeats, status posts, launch fan-out)
  pay the TCP handshake once per peer instead of once per request.
  Transport-level failures surface as `urllib.error.URLError` exactly
  as the previous urllib-based implementation did.

`raw_request` carries an arbitrary request body + Content-Type (the
binary launch-spec frame) but still parses the *response* as JSON —
every control-plane endpoint answers JSON regardless of request
encoding.
"""
from __future__ import annotations

import http.client
import io
import json
import threading
import time
import urllib.error
import urllib.parse
from typing import Optional

from cook_tpu_torch import chaos


class HttpJsonError(urllib.error.HTTPError):
    """An HTTP error response with its status and body captured.

    The body is read eagerly: `urllib` error objects wrap the live
    socket, so a caller that catches, releases, and later `.read()`s
    would get nothing. Here `.read()` replays from memory.
    """

    def __init__(self, url: str, status: int, body: bytes,
                 headers=None):
        super().__init__(url, status, f"HTTP {status}", headers or {},
                         io.BytesIO(body))
        # .status is inherited read-only (mirrors .code); only the
        # captured body is new state
        self.body = body

    def __reduce__(self):  # HTTPError's pickle support loses the body
        return (self.__class__,
                (self.url, self.status, self.body, None))


# -- keep-alive connection pool ----------------------------------------

class _ConnectionPool:
    """Idle `http.client` connections keyed by (scheme, host, port,
    ssl-context). `get` pops (a connection is never shared between
    threads); callers return it via `put` only after the response body
    has been fully read, or `discard` it on any transport doubt."""

    def __init__(self, max_idle_per_key: int = 8):
        self._idle: dict[tuple, list] = {}
        self._lock = threading.Lock()
        self.max_idle_per_key = max_idle_per_key

    def get(self, key: tuple, timeout: float):
        """-> (connection, reused_flag)."""
        with self._lock:
            conns = self._idle.get(key)
            if conns:
                return conns.pop(), True
        return self.open(key, timeout), False

    def open(self, key: tuple, timeout: float):
        scheme, host, port, context = key
        if scheme == "https":
            return http.client.HTTPSConnection(
                host, port, timeout=timeout, context=context)
        return http.client.HTTPConnection(host, port, timeout=timeout)

    def put(self, key: tuple, conn) -> None:
        with self._lock:
            conns = self._idle.setdefault(key, [])
            if len(conns) < self.max_idle_per_key:
                conns.append(conn)
                return
        conn.close()

    def discard(self, conn) -> None:
        try:
            conn.close()
        except Exception:
            pass

    def clear(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, {}
        for conns in idle.values():
            for c in conns:
                self.discard(c)


_pool = _ConnectionPool()


def json_request(method: str, url: str, body: Optional[dict] = None,
                 headers: Optional[dict] = None, timeout: float = 10.0,
                 context=None, chaos_site: str = "") -> dict:
    data = json.dumps(body).encode() if body is not None else None
    return raw_request(method, url, data, "application/json",
                       headers=headers, timeout=timeout, context=context,
                       chaos_site=chaos_site)


def raw_request(method: str, url: str, data: Optional[bytes],
                content_type: str, headers: Optional[dict] = None,
                timeout: float = 10.0, context=None,
                chaos_site: str = "") -> dict:
    h = {"Content-Type": content_type, **(headers or {})}
    if chaos_site:
        a = chaos.act(chaos_site)
        if a.kind:
            if a.kind == "drop":
                # the request never reaches the wire
                raise urllib.error.URLError(
                    f"chaos[{chaos_site}]: dropped")
            if a.kind == "error":
                raise HttpJsonError(url, a.status,
                                    b'{"error": "chaos injected"}')
            if a.kind == "delay":
                time.sleep(a.delay_s)
            elif a.kind == "duplicate":
                # at-least-once delivery: send once, discard, resend
                _send(method, url, data, h, timeout, context)

    return _send(method, url, data, h, timeout, context)


def _send(method: str, url: str, data: Optional[bytes], headers: dict,
          timeout: float, context) -> dict:
    parts = urllib.parse.urlsplit(url)
    path = parts.path or "/"
    if parts.query:
        path += "?" + parts.query
    key = (parts.scheme or "http", parts.hostname, parts.port, context)
    conn, reused = _pool.get(key, timeout)
    try:
        resp, body = _roundtrip(conn, method, path, data, headers,
                                timeout)
    except (OSError, http.client.HTTPException) as e:
        _pool.discard(conn)
        if not reused:
            raise urllib.error.URLError(e) from e
        # a pooled connection can go stale between requests (the server
        # closed the idle socket): one reopen on a provably-fresh
        # connection. This is deliberately NOT a retry loop — a request
        # that failed on a fresh socket may already have been
        # delivered, and redelivery policy belongs to utils.retry at
        # the call sites.
        conn = _pool.open(key, timeout)
        try:
            resp, body = _roundtrip(conn, method, path, data, headers,
                                    timeout)
        except (OSError, http.client.HTTPException) as e2:
            _pool.discard(conn)
            raise urllib.error.URLError(e2) from e2
    if resp.will_close:
        _pool.discard(conn)
    else:
        _pool.put(key, conn)
    if resp.status >= 400:
        raise HttpJsonError(url, resp.status, body or b"",
                            resp.headers)
    raw = body.decode()
    return json.loads(raw) if raw else {}


def _roundtrip(conn, method: str, path: str, data: Optional[bytes],
               headers: dict, timeout: float):
    conn.timeout = timeout
    if conn.sock is not None:
        conn.sock.settimeout(timeout)
    conn.request(method, path, body=data, headers=headers)
    resp = conn.getresponse()
    return resp, resp.read()
