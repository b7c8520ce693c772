"""Sandbox file server — same wire API as the reference sidecar
(sidecar/cook/sidecar/file_server.py:145-233), which itself replicates
the Mesos agent /files API the CLI's ls/cat/tail use:

  GET /files/read?path=&offset=&length=   {"data": ..., "offset": ...};
                                          offset=-1 returns file size
  GET /files/download?path=               raw bytes
  GET /files/browse?path=                 [{path,size,mode,mtime,nlink}]
  GET /readiness-probe                    ""

Paths are confined to the sandbox root (path_is_valid equivalent).
Stdlib ThreadingHTTPServer instead of gunicorn.
"""
from __future__ import annotations

import json
import os
import stat as stat_mod
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

MAX_READ_LENGTH = 4 * 1024 * 1024


def _mode_string(st_mode: int) -> str:
    kind = "d" if stat_mod.S_ISDIR(st_mode) else "-"
    bits = stat_mod.S_IMODE(st_mode)
    return kind + "".join("rwxrwxrwx"[i] if bits & (1 << (8 - i)) else "-"
                          for i in range(9))


def make_handler(sandbox_root: str):
    root = os.path.realpath(sandbox_root)

    def valid(path: str) -> bool:
        return os.path.exists(path) and \
            os.path.realpath(path).startswith(root)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_GET(self):
            parts = urlsplit(self.path)
            q = {k: v[0] for k, v in parse_qs(parts.query).items()}
            route = parts.path.removesuffix(".json")
            if route == "/files/read":
                self._read(q)
            elif route == "/files/download":
                self._download(q)
            elif route == "/files/browse":
                self._browse(q)
            elif route == "/readiness-probe":
                self._send(200, b"")
            else:
                self._send(404, b"")

        def _read(self, q):
            path = q.get("path")
            if path is None:
                return self._send(400, b"Expecting 'path=value' in query.\n")
            try:
                offset = int(q.get("offset", -1))
                length = int(q.get("length", -1))
            except ValueError:
                return self._send(400, b"Failed to parse offset/length.\n")
            if offset < -1 or length < -1:
                return self._send(400, b"Negative offset/length.\n")
            if not valid(path):
                return self._send(404, b"")
            if os.path.isdir(path):
                return self._send(400, b"Cannot read a directory.\n")
            if offset == -1:
                return self._json({"data": "",
                                   "offset": os.path.getsize(path)})
            length = MAX_READ_LENGTH if length == -1 else length
            if length > MAX_READ_LENGTH:
                return self._send(400, b"Requested length too large.\n")
            with open(path, errors="replace") as f:
                f.seek(offset)
                data = f.read(length)
            self._json({"data": data, "offset": offset})

        def _download(self, q):
            path = q.get("path")
            if path is None:
                return self._send(400, b"Expecting 'path=value' in query.\n")
            if not valid(path):
                return self._send(404, b"")
            if os.path.isdir(path):
                return self._send(400, b"Cannot download a directory.\n")
            with open(path, "rb") as f:
                self._send(200, f.read(),
                           content_type="application/octet-stream")

        def _browse(self, q):
            path = q.get("path")
            if path is None:
                return self._send(400, b"Expecting 'path=value' in query.\n")
            if not valid(path):
                return self._send(404, b"")
            if not os.path.isdir(path):
                return self._json([])
            out = []
            for name in os.listdir(path):
                p = os.path.join(path, name)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                out.append({"path": p, "size": st.st_size,
                            "mode": _mode_string(st.st_mode),
                            "mtime": int(st.st_mtime),
                            "nlink": st.st_nlink})
            self._json(sorted(out, key=lambda e: e["path"]))

        def _json(self, obj):
            self._send(200, json.dumps(obj).encode(),
                       content_type="application/json")

        def _send(self, status, payload: bytes,
                  content_type="text/plain"):
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            if payload:
                self.wfile.write(payload)

        def log_message(self, *args):
            pass

    return Handler


class FileServer:
    """Embedded sandbox file server (one per node agent)."""

    def __init__(self, sandbox_root: str, port: int = 0,
                 host: str = "0.0.0.0"):
        self.httpd = ThreadingHTTPServer((host, port),
                                         make_handler(sandbox_root))
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)

    def start(self) -> "FileServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
