"""Python job client for the cook_tpu scheduler.

Equivalent of the reference's Python jobclient
(jobclient/python/cookclient/__init__.py: JobClient.submit/query/kill/
wait + dataclasses in jobs.py/instance.py).  Stdlib-only (urllib).

    from cook_tpu_torch.client import JobClient
    client = JobClient("http://localhost:12321")
    uuid = client.submit(command="echo hi", mem=128, cpus=1)
    job = client.wait_for_job(uuid)
    assert job.state == "success"
"""
from __future__ import annotations

import json
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from typing import Any, Iterable, Optional


class JobClientError(Exception):
    def __init__(self, status: int, body,
                 retry_after: Optional[float] = None):
        super().__init__(f"HTTP {status}: {body}")
        self.status = status
        self.body = body
        # seconds from the Retry-After header (ingest backpressure:
        # 429 responses say when to come back)
        self.retry_after = retry_after


@dataclass
class InstanceInfo:
    """One job attempt (cookclient/instance.py equivalent)."""

    task_id: str
    status: str
    hostname: str = ""
    start_time: int = 0
    end_time: Optional[int] = None
    progress: int = 0
    progress_message: str = ""
    exit_code: Optional[int] = None
    sandbox_directory: str = ""
    output_url: str = ""
    reason_code: Optional[int] = None
    reason_string: Optional[str] = None
    preempted: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "InstanceInfo":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})


@dataclass
class JobInfo:
    """Job status snapshot (cookclient/jobs.py equivalent)."""

    uuid: str
    name: str = ""
    command: str = ""
    user: str = ""
    status: str = ""          # waiting | running | completed
    state: str = ""           # waiting | running | success | failed
    priority: int = 50
    mem: float = 0.0
    cpus: float = 0.0
    gpus: float = 0.0
    max_retries: int = 1
    retries_remaining: int = 0
    submit_time: int = 0
    pool: str = ""
    env: dict = field(default_factory=dict)
    labels: dict = field(default_factory=dict)
    groups: list = field(default_factory=list)
    instances: list = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "JobInfo":
        out = cls(**{k: d[k] for k in cls.__dataclass_fields__
                     if k in d and k != "instances"})
        out.instances = [InstanceInfo.from_dict(i)
                         for i in d.get("instances", [])]
        return out

    @property
    def completed(self) -> bool:
        return self.status == "completed"


class JobClient:
    """Typed client over the REST API (JobClient.java:97-827 /
    cookclient JobClient)."""

    def __init__(self, url: str, user: Optional[str] = None,
                 auth_headers: Optional[dict] = None, timeout: float = 30.0):
        """`url` may be a comma-separated list of candidate coordinator
        URLs (an HA deployment's members): the client rotates on
        connection failure and follows 503 leader hints."""
        self._urls = [u.strip().rstrip("/")
                      for u in url.split(",") if u.strip()]
        if not self._urls:
            raise ValueError("url is empty")
        self.url = self._urls[0]
        self.user = user
        self.timeout = timeout
        self._headers = dict(auth_headers or {})
        if user:
            self._headers.setdefault("X-Cook-User", user)

    # -- transport -----------------------------------------------------
    def _request(self, method: str, path: str, query: Optional[dict] = None,
                 body: Any = None, _follow_leader: bool = True):
        qs = "?" + urllib.parse.urlencode(query, doseq=True) if query else ""
        data = json.dumps(body).encode() if body is not None else None
        # candidate order for this request: the current URL (possibly an
        # adopted leader hint outside the configured list) then every
        # other configured member
        cands = [self.url] + [u for u in self._urls if u != self.url]
        if not _follow_leader:
            cands = cands[:1]
        last_exc: Optional[Exception] = None
        for cand in cands:
            self.url = cand
            req = urllib.request.Request(
                self.url + path + qs, data=data, method=method,
                headers={"Content-Type": "application/json",
                         **self._headers})
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    payload = r.read()
                    return json.loads(payload) if payload else None
            except urllib.error.HTTPError as e:
                payload = e.read()
                try:
                    parsed = json.loads(payload) if payload else None
                except ValueError:
                    parsed = payload.decode(errors="replace")
                # HA: a non-leader answers writes with 503 + the
                # leader's address; retry once there and keep the
                # address only on success — a stale hint (dead
                # ex-leader during the leaderless window) must not pin
                # the client to a dead URL (the reference's clients
                # reach the leader via redirects/ZK discovery)
                if (_follow_leader and e.code == 503
                        and isinstance(parsed, dict)
                        and parsed.get("leader")):
                    leader = str(parsed["leader"]).rstrip("/")
                    if leader and leader != self.url:
                        original = self.url
                        self.url = leader
                        try:
                            out = self._request(method, path, query=query,
                                                body=body,
                                                _follow_leader=False)
                        except Exception:
                            self.url = original
                            raise
                        return out
                try:
                    retry_after = float(e.headers["Retry-After"])
                except (KeyError, TypeError, ValueError):
                    retry_after = None
                raise JobClientError(e.code, parsed,
                                     retry_after=retry_after)
            except urllib.error.URLError as e:
                last_exc = e
                if len(cands) < 2:
                    raise
                # Writes may only rotate when the connection was
                # REFUSED (nothing was sent, so no duplicate-submission
                # risk); a connection that died mid-request could have
                # committed the write on the server. Reads are
                # idempotent and rotate on any connection failure.
                refused = isinstance(getattr(e, "reason", None),
                                     ConnectionRefusedError)
                if method != "GET" and not refused:
                    raise
        raise last_exc

    # -- submission ----------------------------------------------------
    def submit(self, command: str, mem: float = 128.0, cpus: float = 1.0,
               gpus: float = 0.0, uuid: Optional[str] = None,
               name: Optional[str] = None, priority: Optional[int] = None,
               max_retries: int = 1, pool: Optional[str] = None,
               env: Optional[dict] = None, labels: Optional[dict] = None,
               constraints: Optional[list] = None,
               group: Optional[str] = None,
               max_runtime_ms: Optional[int] = None, **extra) -> str:
        """Submit one job; returns its uuid."""
        spec: dict[str, Any] = {"command": command, "mem": mem, "cpus": cpus,
                                "gpus": gpus, "max_retries": max_retries,
                                **extra}
        for k, v in (("uuid", uuid), ("name", name), ("priority", priority),
                     ("env", env), ("labels", labels),
                     ("constraints", constraints), ("group", group),
                     ("max_runtime", max_runtime_ms)):
            if v is not None:
                spec[k] = v
        return self.submit_jobs([spec], pool=pool)[0]

    def submit_jobs(self, jobs: list[dict], groups: Optional[list] = None,
                    pool: Optional[str] = None) -> list[str]:
        body: dict[str, Any] = {"jobs": jobs}
        if groups:
            body["groups"] = groups
        if pool:
            body["pool"] = pool
        return self._request("POST", "/jobs", body=body)["jobs"]

    def submit_jobs_bulk(self, jobs: list[dict],
                         groups: Optional[list] = None,
                         pool: Optional[str] = None,
                         max_wait_s: float = 30.0) -> list[str]:
        """High-throughput submission via POST /jobs/bulk (skips the
        per-uuid resubmit-idempotency scan; validation and atomicity
        are unchanged). The ingest admission queue answers 429 +
        Retry-After under overload — honored here by waiting at least
        the server's hint before re-submitting, up to `max_wait_s`."""
        from cook_tpu_torch.utils.retry import RetryPolicy
        body: dict[str, Any] = {"jobs": jobs}
        if groups:
            body["groups"] = groups
        if pool:
            body["pool"] = pool
        hint = [0.0]

        def on_retry(_n, exc):
            hint[0] = float(getattr(exc, "retry_after", 0.0) or 0.0)

        policy = RetryPolicy(max_attempts=0, base_delay_s=0.05,
                             max_delay_s=1.0, deadline_s=max_wait_s)
        return policy.call(
            lambda: self._request("POST", "/jobs/bulk", body=body),
            retryable=lambda e: isinstance(e, JobClientError)
            and e.status == 429,
            on_retry=on_retry,
            sleep=lambda d: time.sleep(max(d, hint[0])))["jobs"]

    # -- queries -------------------------------------------------------
    def query(self, uuid: str) -> JobInfo:
        return JobInfo.from_dict(self._request("GET", f"/jobs/{uuid}"))

    def query_jobs(self, uuids: Iterable[str]) -> list[JobInfo]:
        return [JobInfo.from_dict(d) for d in
                self._request("GET", "/jobs", query={"uuid": list(uuids)})]

    def list_jobs(self, user: Optional[str] = None,
                  states: str = "waiting+running+completed",
                  start_ms: Optional[int] = None,
                  end_ms: Optional[int] = None,
                  name: Optional[str] = None, limit: int = 150
                  ) -> list[JobInfo]:
        q: dict[str, Any] = {"user": user or self.user, "state": states,
                             "limit": limit}
        if start_ms is not None:
            q["start-ms"] = start_ms
        if end_ms is not None:
            q["end-ms"] = end_ms
        if name:
            q["name"] = name
        return [JobInfo.from_dict(d)
                for d in self._request("GET", "/list", query=q)]

    def query_instance(self, task_id: str) -> InstanceInfo:
        return InstanceInfo.from_dict(
            self._request("GET", f"/instances/{task_id}"))

    def usage(self, user: Optional[str] = None) -> dict:
        q = {"user": user} if user else {}
        return self._request("GET", "/usage", query=q)

    def unscheduled_reasons(self, uuid: str) -> list[dict]:
        return self._request("GET", "/unscheduled_jobs",
                             query={"job": uuid})[0]["reasons"]

    # -- mutation ------------------------------------------------------
    def kill(self, *uuids: str) -> None:
        self._request("DELETE", "/jobs", query={"uuid": list(uuids)})

    def kill_instances(self, *task_ids: str) -> None:
        self._request("DELETE", "/instances", query={"uuid": list(task_ids)})

    def retry(self, uuid: str, retries: Optional[int] = None,
              increment: Optional[int] = None) -> None:
        body: dict[str, Any] = {"job": uuid}
        if retries is not None:
            body["retries"] = retries
        if increment is not None:
            body["increment"] = increment
        self._request("POST", "/retry", body=body)

    # -- waiting (JobClient listener-polling equivalent) ---------------
    def wait_for_job(self, uuid: str, timeout: float = 300.0,
                     poll_interval: float = 1.0) -> JobInfo:
        """Poll until the job completes; returns the final JobInfo."""
        deadline = time.monotonic() + timeout
        while True:
            job = self.query(uuid)
            if job.completed:
                return job
            if time.monotonic() >= deadline:
                raise TimeoutError(f"job {uuid} still {job.status} after "
                                   f"{timeout}s")
            time.sleep(poll_interval)
