"""Per-invocation CLI metrics (cli/cook/metrics.py equivalent).

The reference CLI times every invocation and ships
{command, duration, outcome, user} events to a configured sink. Here
the sink is either a local JSONL file or an HTTP endpoint, selected by
config:

    {"metrics": {"enabled": true, "path": "~/.cs-metrics.jsonl"}}
    {"metrics": {"enabled": true, "url": "https://.../cli-metrics"}}

Disabled by default; failures never break the invocation (metrics are
strictly best-effort, like the reference's except-pass posting).
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional


class CliMetrics:
    def __init__(self, cfg: dict, user: str = ""):
        m = cfg.get("metrics") or {}
        self.enabled = bool(m.get("enabled"))
        self.path = os.path.expanduser(m.get("path",
                                             "~/.cs-metrics.jsonl"))
        self.url = m.get("url")
        self.user = user
        self._t0 = time.perf_counter()
        self._cmd: Optional[str] = None

    def start(self, cmd: str) -> None:
        self._cmd = cmd
        self._t0 = time.perf_counter()

    def finish(self, status) -> None:
        if not self.enabled or self._cmd is None:
            return
        try:
            event = {
                "command": self._cmd,
                "status": int(status) if status is not None else 0,
                "duration_ms": round(
                    (time.perf_counter() - self._t0) * 1e3, 1),
                "user": self.user,
                "at_ms": int(time.time() * 1e3),
            }
            if self.url:
                import urllib.request
                req = urllib.request.Request(
                    self.url, data=json.dumps(event).encode(),
                    headers={"Content-Type": "application/json"},
                    method="POST")
                urllib.request.urlopen(req, timeout=2.0).close()
            else:
                with open(self.path, "a") as f:
                    f.write(json.dumps(event) + "\n")
        except Exception:
            pass   # metrics must never break the invocation
