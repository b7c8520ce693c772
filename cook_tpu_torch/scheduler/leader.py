"""HA leader election: single active scheduler, API-only standbys.

Equivalent of cook.mesos/start-leader-selector (mesos.clj:111-270,
Curator LeaderSelector on ZooKeeper):
  - candidates race for a lease; exactly one wins;
  - the winner publishes its URL so standby API nodes can redirect
    (leader-url, cook-info-handler);
  - on leadership loss the process SUICIDES (System/exit) so supervisor
    restart is the only recovery path (mesos.clj:247-261) — partial
    in-memory state is never trusted;
  - non-leaders can serve the read API only (components.clj:101-105).

The elector protocol is pluggable like the reference's curator layer.
Implementations:
  StandaloneElector   no-HA single instance
  FileLeaderElector   fcntl file lock (single host / shared filesystem)
  LeaseElector        Kubernetes coordination.k8s.io/v1 Lease objects
                      over plain HTTP — distributed HA with no shared
                      filesystem, the modern stand-in for the
                      reference's Curator-on-ZooKeeper
                      (mesos.clj:111-270). Mutual exclusion rides the
                      apiserver's resourceVersion compare-and-swap
                      (409 Conflict on a lost race), exactly like
                      client-go's leaderelection package.
"""
from __future__ import annotations

import datetime
import fcntl
import json
import logging
import os
import socket
import threading
import time
from typing import Callable, Optional

from cook_tpu_torch.utils.httpjson import json_request

log = logging.getLogger(__name__)


class LeaderElector:
    def start(self, on_leadership: Callable[[], None]) -> None:
        raise NotImplementedError

    def is_leader(self) -> bool:
        raise NotImplementedError

    def current_leader(self) -> Optional[str]:
        """The published leader URL (for /info and redirects)."""
        raise NotImplementedError

    def stop(self) -> None:
        pass


class StandaloneElector(LeaderElector):
    """No-HA mode: immediately leader (single-instance deploys)."""

    def __init__(self, url: str = ""):
        self.url = url
        self._leader = False

    def start(self, on_leadership) -> None:
        self._leader = True
        on_leadership()

    def is_leader(self) -> bool:
        return self._leader

    def current_leader(self) -> Optional[str]:
        return self.url


class FileLeaderElector(LeaderElector):
    """flock-based elector. The lock file IS the lease: holding the
    exclusive lock means leadership; its JSON body names the leader.

    on_loss: by default calls os._exit(1) — the reference's deliberate
    suicide — override in tests."""

    def __init__(self, path: str, url: str,
                 retry_interval_s: float = 1.0,
                 on_loss: Optional[Callable[[], None]] = None):
        self.path = path
        self.url = url
        self.retry_interval_s = retry_interval_s
        self.on_loss = on_loss or self._suicide
        self._fd: Optional[int] = None
        self._leader = False
        # guards _leader/_fd: written by the campaign thread, read by
        # is_leader() (request threads) and stop() (which can race the
        # campaign's own _release when join times out)
        self._state_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _suicide() -> None:
        log.error("leadership lost — exiting so the supervisor restarts "
                  "us from durable state")
        os._exit(1)

    def start(self, on_leadership: Callable[[], None]) -> None:
        def campaign():
            while not self._stop.is_set():
                fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o644)
                try:
                    fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                except OSError:
                    os.close(fd)
                    self._stop.wait(self.retry_interval_s)
                    continue
                # we are the leader: publish and hand off
                os.ftruncate(fd, 0)
                os.write(fd, json.dumps({"url": self.url,
                                         "pid": os.getpid(),
                                         "since": time.time()}).encode())
                os.fsync(fd)
                with self._state_lock:
                    self._fd = fd
                    self._leader = True
                log.info("acquired leadership (%s)", self.path)
                try:
                    on_leadership()
                except Exception:
                    log.exception("on_leadership failed")
                    self._release()
                    self.on_loss()
                    return
                # hold until stopped; watch for lease-file deletion
                # (the ZK-session-expired analog)
                while not self._stop.wait(self.retry_interval_s):
                    try:
                        if os.stat(self.path).st_ino != os.fstat(fd).st_ino:
                            raise OSError("lease file replaced")
                    except OSError:
                        self._release()
                        self.on_loss()
                        return
                self._release()
                return
        self._thread = threading.Thread(target=campaign, daemon=True)
        self._thread.start()

    def _release(self) -> None:
        # swap the fd out under the lock so a stop()/campaign release
        # race can't double-close it; the syscalls run unlocked
        with self._state_lock:
            self._leader = False
            fd, self._fd = self._fd, None
        if fd is not None:
            try:
                fcntl.flock(fd, fcntl.LOCK_UN)
                os.close(fd)
            except OSError:
                pass

    def is_leader(self) -> bool:
        with self._state_lock:
            return self._leader

    def current_leader(self) -> Optional[str]:
        try:
            with open(self.path) as f:
                data = json.load(f)
            return data.get("url")
        except (OSError, ValueError):
            return None

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=3)
        self._release()


def _rfc3339(t: float) -> str:
    return datetime.datetime.fromtimestamp(
        t, datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%fZ")


def _parse_rfc3339(s: str) -> float:
    return datetime.datetime.strptime(
        s, "%Y-%m-%dT%H:%M:%S.%fZ").replace(
        tzinfo=datetime.timezone.utc).timestamp()


class LeaseElector(LeaderElector):
    """Distributed elector on a Kubernetes Lease object.

    Campaign: read the Lease; if absent, create it naming us; if held
    but expired (renewTime + leaseDurationSeconds < now), take it over
    with a resourceVersion-preconditioned update — a concurrent
    takeover loses with 409 and goes back to waiting. While leader,
    renew every duration/3; losing the renewal race or failing to renew
    for a full lease duration triggers on_loss (suicide by default,
    mesos.clj:247-261). holderIdentity doubles as the published leader
    URL."""

    def __init__(self, apiserver_url: str, url: str,
                 name: str = "cook-leader", namespace: str = "cook",
                 lease_duration_s: float = 10.0,
                 retry_interval_s: Optional[float] = None,
                 token: Optional[str] = None,
                 on_loss: Optional[Callable[[], None]] = None,
                 identity: Optional[str] = None):
        self.base = apiserver_url.rstrip("/")
        self.url = url
        self.name = name
        self.namespace = namespace
        self.duration_s = lease_duration_s
        self.retry_interval_s = retry_interval_s or lease_duration_s / 3.0
        self.token = token
        self.on_loss = on_loss or FileLeaderElector._suicide
        # identity must be REPLICA-unique, never the (shared) service
        # URL: replicas sharing an identity would all pass the
        # holder==self check and run concurrently (client-go defaults
        # to the pod-unique hostname for the same reason)
        self.identity = identity or f"{socket.gethostname()}-{os.getpid()}"
        self._leader = False
        # guards _leader, _last_renewed and _observed: written by the
        # campaign/renew thread, read by is_leader()/current_leader()
        # on request threads (and _observed is also written from
        # current_leader()'s cache-miss fallback). on_leadership/
        # on_loss callbacks always run OUTSIDE this lock.
        self._state_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # (holder_url, observed_at) cache fed by the campaign/renew
        # loop so current_leader() doesn't GET the apiserver per call
        self._observed: tuple[Optional[str], float] = (None, 0.0)
        # monotonic time of the last successful acquire/renew, stamped
        # from BEFORE the round-trip began (the lease's renewTime is
        # holder-stamped pre-PUT, so the fence must measure from the
        # same instant); monotonic so a local NTP step can't stretch
        # the asserted freshness. The self-fencing clock (see is_leader).
        self._last_renewed = 0.0
        # (renewTime string, monotonic when WE first observed it): the
        # challenger judges expiry by how long the SAME renewTime has
        # sat unchanged on its OWN monotonic clock — never by comparing
        # the holder's wall-clock stamp against ours. Cross-host clock
        # skew therefore cannot defeat the holder's 0.8x self-fencing
        # margin (client-go's observedTime discipline).
        self._renew_seen: tuple[str, float] = ("", 0.0)
        # fencing epoch = leaseTransitions + 1 of OUR acquisition; the
        # store stamps it into every log entry so replay can drop
        # zombie appends from a deposed leader's stall window
        self.epoch = 0

    # -- wire ----------------------------------------------------------
    def _path(self) -> str:
        return (f"/apis/coordination.k8s.io/v1/namespaces/"
                f"{self.namespace}/leases/{self.name}")

    def _headers(self) -> dict:
        return {"Authorization": f"Bearer {self.token}"} if self.token \
            else {}

    def _get(self) -> Optional[dict]:
        import urllib.error
        try:
            lease = json_request("GET", self.base + self._path(),
                                 headers=self._headers(), timeout=5.0)
        except urllib.error.HTTPError as e:
            if e.code == 404:
                with self._state_lock:
                    self._observed = (None, time.time())
                return None
            raise
        with self._state_lock:
            self._observed = (self._holder_url_of(lease), time.time())
        return lease

    def _holder_url_of(self, lease: Optional[dict]) -> Optional[str]:
        if lease is None:
            return None
        spec = lease.get("spec", {})
        renew = spec.get("renewTime", "")
        duration = float(spec.get("leaseDurationSeconds",
                                  self.duration_s))
        try:
            if renew and _parse_rfc3339(renew) + duration < time.time():
                return None
        except ValueError:
            pass
        return spec.get("holderUrl") or spec.get("holderIdentity")

    def _lease_body(self, transitions: int, rv: Optional[str]) -> dict:
        now = _rfc3339(time.time())
        meta: dict = {"name": self.name, "namespace": self.namespace}
        if rv is not None:
            meta["resourceVersion"] = rv
        return {
            "apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
            "metadata": meta,
            "spec": {"holderIdentity": self.identity,
                     "holderUrl": self.url,
                     "leaseDurationSeconds": int(self.duration_s),
                     "renewTime": now,
                     "leaseTransitions": transitions},
        }

    def _try_acquire(self) -> bool:
        import urllib.error
        try:
            lease = self._get()
            if lease is None:
                json_request(
                    "POST",
                    self.base + self._path().rsplit("/", 1)[0],
                    self._lease_body(0, None),
                    headers=self._headers(), timeout=5.0)
                with self._state_lock:
                    self._observed = (self.url, time.time())
                self.epoch = 1
                return True
            spec = lease.get("spec", {})
            holder = spec.get("holderIdentity", "")
            renew = spec.get("renewTime", "")
            # judge expiry by the lease's RECORDED duration, not our
            # configured one — a candidate with a shorter setting must
            # not steal a live lease during a rolling config change
            duration = float(spec.get("leaseDurationSeconds",
                                      self.duration_s))
            expired = not holder        # a cleanly released lease
            if renew and holder:
                # OBSERVER-clock expiry: a renewTime is stale only once
                # it has sat unchanged for a full duration on OUR
                # monotonic clock since we first saw it. Parsing the
                # holder's wall-clock stamp against our wall clock
                # would let skew > the holder's 0.2x-duration fencing
                # margin hand the lease to us while the holder still
                # believes it is fresh.
                key = f"{holder}|{renew}"
                if key != self._renew_seen[0]:
                    self._renew_seen = (key, time.monotonic())
                expired = (time.monotonic() - self._renew_seen[1]
                           > duration)
            if holder != self.identity and not expired:
                return False
            transitions = int(spec.get("leaseTransitions", 0)) + \
                (1 if holder != self.identity else 0)
            json_request(
                "PUT", self.base + self._path(),
                self._lease_body(
                    transitions,
                    lease.get("metadata", {}).get("resourceVersion")),
                headers=self._headers(), timeout=5.0,
                chaos_site="leader.acquire")
            with self._state_lock:
                self._observed = (self.url, time.time())
            self.epoch = transitions + 1
            return True
        except urllib.error.HTTPError as e:
            if e.code == 409:      # lost the race
                return False
            raise

    def _renew(self) -> bool:
        """One renewal attempt; False when the lease is gone or held by
        someone else (we lost)."""
        import urllib.error
        try:
            lease = self._get()
            if lease is None or \
                    lease.get("spec", {}).get("holderIdentity") \
                    != self.identity:
                return False
            # chaos "error"/"drop" here surfaces as a failed renewal:
            # the campaign loop's freshness fencing (0.2x-duration
            # margin) must step down before a rival can win the lease
            json_request(
                "PUT", self.base + self._path(),
                self._lease_body(
                    int(lease["spec"].get("leaseTransitions", 0)),
                    lease.get("metadata", {}).get("resourceVersion")),
                headers=self._headers(), timeout=5.0,
                chaos_site="leader.renew")
            with self._state_lock:
                self._observed = (self.url, time.time())
            return True
        except urllib.error.HTTPError as e:
            if e.code in (404, 409):
                return False
            raise

    # -- protocol ------------------------------------------------------
    def start(self, on_leadership: Callable[[], None]) -> None:
        def campaign():
            while not self._stop.is_set():
                t0 = time.monotonic()   # pre-round-trip, like renewTime
                try:
                    acquired = self._try_acquire()
                except Exception as e:
                    log.warning("lease campaign error: %s", e)
                    acquired = False
                if not acquired:
                    self._stop.wait(self.retry_interval_s)
                    continue
                with self._state_lock:
                    self._leader = True
                    self._last_renewed = t0
                log.info("acquired leadership lease %s as %s",
                         self.name, self.identity)
                # Run takeover work (store replay, backend init — can
                # take seconds) in its own thread so renewal is NOT
                # starved during it: a takeover longer than the lease
                # duration must not hand the lease to a second standby
                # mid-initialization.
                init_failed = threading.Event()

                def run_init():
                    # a thread-scheduling stall between acquire and
                    # here must not run takeover work (which trims the
                    # shared log) on a node that already lost the lease
                    if not self.is_leader():
                        init_failed.set()
                        return
                    try:
                        on_leadership()
                    except Exception:
                        log.exception("on_leadership failed")
                        init_failed.set()

                threading.Thread(target=run_init, daemon=True,
                                 name="leader-init").start()
                while not self._stop.wait(self.duration_s / 3.0):
                    if init_failed.is_set():
                        with self._state_lock:
                            self._leader = False
                        self.on_loss()
                        return
                    t0 = time.monotonic()   # pre-round-trip, like the
                    #                         lease's own renewTime stamp
                    try:
                        if self._renew():
                            with self._state_lock:
                                self._last_renewed = t0
                        else:
                            with self._state_lock:
                                self._leader = False
                            self.on_loss()
                            return
                    except Exception as e:
                        log.warning("lease renewal error: %s", e)
                        with self._state_lock:
                            stale = time.monotonic() - self._last_renewed \
                                > self.duration_s
                            if stale:
                                # can't prove we still hold it: step down
                                self._leader = False
                        if stale:
                            self.on_loss()
                            return
                with self._state_lock:
                    self._leader = False
                return
        self._thread = threading.Thread(target=campaign, daemon=True)
        self._thread.start()

    def is_leader(self) -> bool:
        """Self-fencing leadership check. A deposed-but-unaware leader
        is the split-brain hazard: a successor may take the lease at
        renewTime + duration, while this process would only notice on a
        renew-loop tick (up to duration/3 late). So leadership is only
        asserted while the last successful renew is FRESH — under 80%
        of the lease duration — guaranteeing the old holder stops
        acking writes strictly before any successor can acquire
        (client-go's renewDeadline < leaseDuration serves the same
        purpose). Normal renew cadence is duration/3, so freshness
        never exceeds ~40% in a healthy process; a stalled/partitioned
        one closes its write gates here first and suicides at the full
        duration."""
        with self._state_lock:
            return self._leader and \
                (time.monotonic() - self._last_renewed) \
                < self.duration_s * 0.8

    def current_leader(self) -> Optional[str]:
        # serve from the campaign/renew loop's observation when fresh
        # (/info calls this per request; a blocking apiserver GET per
        # request would hammer the apiserver and stall during outages)
        with self._state_lock:
            holder, seen = self._observed
        if time.time() - seen <= self.duration_s / 3.0:
            return holder
        try:
            return self._holder_url_of(self._get())
        except Exception:
            return None

    def _release_lease(self) -> None:
        """Clear the holder on clean shutdown so the successor doesn't
        wait out the TTL (client-go's ReleaseOnCancel)."""
        import urllib.error
        try:
            lease = self._get()
            if lease is None or \
                    lease.get("spec", {}).get("holderIdentity") \
                    != self.identity:
                return
            body = self._lease_body(
                int(lease["spec"].get("leaseTransitions", 0)),
                lease.get("metadata", {}).get("resourceVersion"))
            body["spec"]["holderIdentity"] = ""
            body["spec"]["holderUrl"] = ""
            json_request("PUT", self.base + self._path(), body,
                         headers=self._headers(), timeout=5.0)
        except (urllib.error.HTTPError, OSError):
            pass                     # successor falls back to the TTL

    def stop(self) -> None:
        with self._state_lock:
            was_leader = self._leader
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=3)
        with self._state_lock:
            self._leader = False
        if was_leader:
            self._release_lease()
