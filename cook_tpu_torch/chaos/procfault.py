"""Process-level fault injection: seeded SIGKILL at named kill points.

The transport/store chaos sites (``cook_tpu.chaos``) inject faults the
process survives. This module injects the one it cannot: the process
dies, mid-operation, with no chance to flush, unwind, or apologise —
exactly what a machine reboot or OOM kill does to the coordinator in
production.

A *kill point* is a named site compiled into the code path under test
(``kill_point("store.launch_txn")``). Disarmed — the default — it costs
one module-attribute read. Armed (via env, so it crosses the exec
boundary into the server subprocess), each pass draws from a per-site
``random.Random(f"{seed}:{incarnation}:{site}")``; a draw below the
site's probability appends a record to the shared *budget file* and
then ``os.kill(os.getpid(), SIGKILL)`` — no atexit, no finally blocks,
no flushes. The budget file lives in the store directory so the kill
count survives restarts: once it holds ``max_kills`` records the
controller disarms itself in every later incarnation, guaranteeing the
supervised run eventually makes progress.

Determinism: the schedule is a pure function of
``(seed, incarnation, sites)`` and the sequence of site passes, so a
red soak replays from the seed alone. The incarnation (restart count,
stamped by the supervisor) is mixed into the rng so a restarted
process does not re-draw the identical schedule and livelock killing
itself at the same early site forever.

``ServerSupervisor`` is the other half: it spawns the port's server
(``python -m cook_tpu_torch.rest.server --device <device>``) as a
subprocess with the kill sites armed, detects SIGKILL death, and
restarts it against the same store directory with the incarnation
bumped — the harness ``tests/torch_livestack.py`` (and through it
``bench_torch.py failover``) drives it.
"""
from __future__ import annotations

import json
import os
import random
import signal
import sys
import threading
import time
from typing import Optional

ENV_SITES = "COOK_PROCFAULT_SITES"
ENV_SEED = "COOK_PROCFAULT_SEED"
ENV_BUDGET = "COOK_PROCFAULT_BUDGET"
ENV_MAX = "COOK_PROCFAULT_MAX"
ENV_INCARNATION = "COOK_PROCFAULT_INCARNATION"


class ProcFaultController:
    """Seeded SIGKILL injection at named kill points."""

    def __init__(self):
        self.enabled = False
        self.seed = 0
        self.incarnation = 0
        self.max_kills = 1
        self._budget_file: Optional[str] = None
        self._sites: dict[str, tuple[float, random.Random]] = {}
        self._lock = threading.Lock()

    def configure(self, seed: int, sites: dict[str, float],
                  budget_file: Optional[str] = None, max_kills: int = 1,
                  incarnation: int = 0) -> None:
        """Arm the controller. ``sites`` maps kill-point name → per-pass
        kill probability. ``budget_file`` (append-only, one JSON line
        per kill) bounds total kills ACROSS process incarnations."""
        with self._lock:
            self.seed = int(seed)
            self.incarnation = int(incarnation)
            self.max_kills = int(max_kills)
            self._budget_file = budget_file
            self._sites = {
                name: (float(p),
                       random.Random(f"{seed}:{incarnation}:{name}"))
                for name, p in sites.items()
            }
            self.enabled = bool(self._sites) and \
                self._kills_so_far() < self.max_kills

    def configure_from_env(self, env=None) -> bool:
        """Arm from the environment; returns True when armed. This is
        how the schedule crosses exec into the server subprocess."""
        env = os.environ if env is None else env
        raw = env.get(ENV_SITES)
        if not raw:
            return False
        try:
            sites = json.loads(raw)
        except ValueError:
            sys.stderr.write("procfault: unparsable %s ignored\n" % ENV_SITES)
            return False
        self.configure(
            seed=int(env.get(ENV_SEED, "0") or "0"),
            sites={str(k): float(v) for k, v in sites.items()},
            budget_file=env.get(ENV_BUDGET) or None,
            max_kills=int(env.get(ENV_MAX, "1") or "1"),
            incarnation=int(env.get(ENV_INCARNATION, "0") or "0"),
        )
        return self.enabled

    def reset(self) -> None:
        with self._lock:
            self.enabled = False
            self._sites = {}
            self._budget_file = None

    def _kills_so_far(self) -> int:
        # caller holds self._lock
        if not self._budget_file:
            return 0
        try:
            with open(self._budget_file, "rb") as f:
                return sum(1 for line in f if line.strip())
        except OSError:
            return 0

    def _record_kill(self, site: str) -> None:
        # caller holds self._lock. Durable BEFORE the kill: the record
        # must survive the SIGKILL we are about to deliver, or the
        # budget resets every restart and the run never terminates.
        if not self._budget_file:
            return
        rec = json.dumps({"site": site, "pid": os.getpid(),
                          "incarnation": self.incarnation,
                          "t": time.time()})
        fd = os.open(self._budget_file,
                     os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, (rec + "\n").encode())
            os.fsync(fd)
        finally:
            os.close(fd)

    def kill_point(self, site: str) -> None:
        """Maybe die here. Zero-cost when disarmed."""
        if not self.enabled:
            return
        with self._lock:
            if not self.enabled:
                return
            st = self._sites.get(site)
            if st is None:
                return
            prob, rng = st
            if rng.random() >= prob:
                return
            if self._kills_so_far() >= self.max_kills:
                self.enabled = False
                return
            self._record_kill(site)
        sys.stderr.write("procfault: SIGKILL at %s (pid %d, inc %d)\n"
                         % (site, os.getpid(), self.incarnation))
        sys.stderr.flush()
        os.kill(os.getpid(), signal.SIGKILL)
        # unreachable — SIGKILL is not deliverable-to-handler — but if
        # a test monkeypatches os.kill, fall through harmlessly.


controller = ProcFaultController()


def kill_point(site: str) -> None:
    """Module-level shim: ``procfault.kill_point("store.rotate")``."""
    if controller.enabled:
        controller.kill_point(site)


class ServerSupervisor:
    """Spawn the real server as a subprocess with kill points armed;
    restart it against the same store directory when it dies.

    Records per-incarnation time-to-ready (a live proxy for restore +
    reconcile latency) in ``ready_times_s`` and every observed death in
    ``deaths``. ``ensure_alive()`` is the poll-driven heart: call it
    from the harness loop; it respawns a dead child with the
    incarnation bumped so the procfault rng re-rolls. ``device`` is the
    server's ``--device``: "cuda" unless the caller asks for "cpu".
    """

    def __init__(self, config_path: str, url: str,
                 sites: Optional[dict[str, float]] = None,
                 seed: int = 0, max_kills: int = 3,
                 budget_file: Optional[str] = None,
                 log_path: Optional[str] = None,
                 extra_env: Optional[dict] = None,
                 device: str = "cuda"):
        self.config_path = config_path
        self.device = device
        self.url = url.rstrip("/")
        self.sites = dict(sites or {})
        self.seed = seed
        self.max_kills = max_kills
        self.budget_file = budget_file
        self.log_path = log_path
        self.extra_env = dict(extra_env or {})
        self.incarnation = 0
        self.restarts = 0
        self.deaths: list[dict] = []
        self.ready_times_s: list[float] = []
        self._proc = None
        self._log_f = None

    def _spawn(self):
        import subprocess
        env = dict(os.environ)
        env.update(self.extra_env)
        if self.sites:
            env[ENV_SITES] = json.dumps(self.sites)
            env[ENV_SEED] = str(self.seed)
            env[ENV_MAX] = str(self.max_kills)
            env[ENV_INCARNATION] = str(self.incarnation)
            if self.budget_file:
                env[ENV_BUDGET] = self.budget_file
        if self.log_path:
            self._log_f = open(self.log_path, "ab")
            out = self._log_f
        else:
            out = None
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "cook_tpu_torch.rest.server",
             "--config", self.config_path, "--device", self.device],
            stdout=out, stderr=out, env=env)

    def start(self, ready_timeout_s: float = 60.0) -> None:
        self._spawn()
        self.wait_ready(ready_timeout_s)

    def alive(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    def ensure_alive(self, ready_timeout_s: float = 60.0) -> bool:
        """Respawn the child if it died. Returns True when a restart
        happened (the caller may want to log it)."""
        if self.alive():
            return False
        rc = self._proc.poll() if self._proc else None
        self.deaths.append({"incarnation": self.incarnation,
                            "returncode": rc, "t": time.time()})
        self.incarnation += 1
        self.restarts += 1
        self._spawn()
        self.wait_ready(ready_timeout_s)
        return True

    def wait_ready(self, timeout_s: float = 60.0) -> float:
        """Poll /debug until the server answers; returns (and records)
        time-to-ready. Raises RuntimeError if the child dies without
        ever answering AND the budget says no kill caused it."""
        import urllib.request
        t0 = time.monotonic()
        deadline = t0 + timeout_s
        while time.monotonic() < deadline:
            if self._proc is not None and self._proc.poll() is not None:
                # died during boot — a boot-time kill site; count the
                # death and respawn with the next incarnation.
                self.deaths.append({"incarnation": self.incarnation,
                                    "returncode": self._proc.poll(),
                                    "t": time.time(), "during_boot": True})
                self.incarnation += 1
                self.restarts += 1
                self._spawn()
                continue
            try:
                with urllib.request.urlopen(
                        self.url + "/debug", timeout=2.0) as r:
                    if r.status == 200:
                        dt = time.monotonic() - t0
                        self.ready_times_s.append(dt)
                        return dt
            except Exception:
                pass
            time.sleep(0.05)
        raise RuntimeError("server at %s not ready after %.1fs"
                           % (self.url, timeout_s))

    def kill(self) -> None:
        """SIGKILL the child (a supervisor-scheduled kill, for
        schedules that want kills at wall-clock times rather than
        code-path sites)."""
        if self.alive():
            try:
                self._proc.kill()
            except OSError:
                pass

    def stop(self, timeout_s: float = 10.0) -> None:
        if self._proc is not None:
            try:
                self._proc.terminate()
                self._proc.wait(timeout=timeout_s)
            except Exception:
                try:
                    self._proc.kill()
                    self._proc.wait(timeout=timeout_s)
                except Exception:
                    pass
        if self._log_f is not None:
            try:
                self._log_f.close()
            except OSError:
                pass
            self._log_f = None
