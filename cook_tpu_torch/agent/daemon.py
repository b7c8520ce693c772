"""Standalone network agent: run tasks on this machine for a remote
coordinator.

The reference's on-node story is executor + sidecar under a Mesos agent
speaking framework messages through libmesos
(/root/reference/executor/cook/executor.py:421,
mesos_compute_cluster.clj:94-195). This daemon replaces that transport
with plain HTTP:

  - registers with the coordinator (POST /agents/register) advertising
    capacity + its own control URL, and re-registers whenever the
    coordinator says it doesn't know us (coordinator restart);
  - serves POST /launch and POST /kill from the coordinator plus
    GET /state for debugging;
  - runs tasks through cook_tpu.agent.executor.Executor (process
    groups, sandboxes, stdout/stderr, progress regex) and relays
    status/progress upstream (POST /agents/status, /agents/progress);
  - heartbeats (POST /agents/heartbeat) with the live task list so the
    coordinator can detect lost tasks/agents;
  - serves sandboxes over the sidecar FileServer.

Entry point:  python -m cook_tpu_torch.agent --coordinator URL [--mem MB]
              [--cpus N] [--pool P] [--hostname H] [--port P] ...
"""
from __future__ import annotations

import argparse
import json
import logging
import socket
import threading
import time
import urllib.error
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from cook_tpu_torch.agent.executor import Executor
from cook_tpu_torch.agent.file_server import FileServer
from cook_tpu_torch.backends import specwire
from cook_tpu_torch.utils.httpjson import json_request
from cook_tpu_torch.utils.metrics import registry as metrics_registry
from cook_tpu_torch.utils.retry import RetryPolicy

logger = logging.getLogger(__name__)

# coordinator-bound RPC path -> chaos injection site (utils/httpjson
# applies the fault; empty-string sites are free)
_CHAOS_SITES = {
    "/agents/register": "agent.register",
    "/agents/heartbeat": "agent.heartbeat",
    "/agents/status": "agent.status_post",
    "/agents/status/bulk": "agent.status_post",
    "/agents/progress": "agent.progress_post",
}


class AgentDaemon:
    """`coordinator_url` may be a comma-separated list of candidate
    coordinator URLs (an HA deployment's members): the daemon posts to
    one, rotates on connection failure, and follows the `leader` hint a
    non-leader standby returns with 503 — the agent-side half of leader
    failover. After any switch, the new leader's heartbeat response
    carries `reregister` (it doesn't know us) and the existing
    re-registration path restores capacity + the live task list."""

    def __init__(self, coordinator_url: str,
                 hostname: Optional[str] = None,
                 mem: float = 8192.0, cpus: float = 8.0, gpus: float = 0.0,
                 pool: str = "default",
                 sandbox_root: str = "/tmp/cook_tpu_agent_sandboxes",
                 port: int = 0, file_server_port: int = 0,
                 heartbeat_interval_s: float = 5.0,
                 attributes: Optional[dict] = None,
                 advertise_host: str = "127.0.0.1",
                 agent_token: str = "",
                 bind_host: str = "127.0.0.1",
                 outbox_max: int = 256):
        self._urls = [u.strip().rstrip("/")
                      for u in coordinator_url.split(",") if u.strip()]
        if not self._urls:
            raise ValueError("coordinator_url is empty")
        self._url_idx = 0
        self._hint_url: Optional[str] = None  # at most ONE learned URL
        # _post runs from heartbeat, executor-callback, and HTTP handler
        # threads concurrently: all failover-state mutation is locked
        self._url_lock = threading.Lock()
        # terminal statuses that couldn't be delivered (leaderless
        # window); flushed after each successful heartbeat. Bounded:
        # a coordinator outage longer than outbox_max terminal events
        # drops the OLDEST (the coordinator's heartbeat-diff safety net
        # will eventually fail those tasks anyway); drops are counted
        # in agent_outbox_dropped_total and self.outbox_dropped.
        self._outbox: list[dict] = []
        self._outbox_lock = threading.Lock()
        self.outbox_max = int(outbox_max)
        self.outbox_dropped = 0
        # status coalescer: callbacks enqueue here and the FIRST caller
        # becomes the sender, draining whatever accumulated while the
        # previous send was on the wire as ONE bulk POST. Uncontended,
        # a status still delivers synchronously inside its own callback
        # (no detached sender thread — callers see delivery/outbox
        # effects when _on_status returns, exactly like the old path).
        self._status_q: list[dict] = []
        self._status_lock = threading.Lock()
        self._status_sending = False
        # latched on the first 404/405 from /agents/status/bulk: an old
        # coordinator without the bulk route gets singular posts forever
        self._bulk_unsupported = False
        # delivery policies: statuses get a few jittered tries, the
        # blocking register loop retries until shutdown (the daemon is
        # useless unregistered, so there is no deadline)
        self._status_policy = RetryPolicy(max_attempts=3,
                                          base_delay_s=0.2,
                                          max_delay_s=5.0)
        self._register_policy = RetryPolicy(max_attempts=0,
                                            base_delay_s=0.2,
                                            max_delay_s=5.0)
        # task_id -> trace context + locally-timed span bounds: the
        # daemon has no tracer of its own — it echoes the launch spec's
        # traceparent and its wall-clock launch/run windows back on
        # status posts, and the coordinator folds them into the trace
        self._task_traces: dict[str, dict] = {}
        self._task_traces_lock = threading.Lock()
        self.hostname = hostname or socket.gethostname()
        self.mem, self.cpus, self.gpus = mem, cpus, gpus
        self.pool = pool
        self.attributes = attributes or {}
        self.heartbeat_interval_s = heartbeat_interval_s
        self.advertise_host = advertise_host
        self.agent_token = agent_token
        self._stop = threading.Event()
        # chaos churn "partition": while set, every coordinator-bound
        # RPC fails as if the network were cut — the process (and its
        # tasks) keep running, which is exactly the case the liveness
        # layer must resurrect-and-adopt rather than double-launch
        self._partitioned = threading.Event()
        self.executor = Executor(
            sandbox_root,
            on_status=self._on_status,
            on_progress=self._on_progress,
            on_heartbeat=lambda tid: None,   # agent-level heartbeat below
            heartbeat_interval_s=heartbeat_interval_s)
        self.file_server = FileServer(sandbox_root, port=file_server_port)

        daemon = self

        class Handler(BaseHTTPRequestHandler):
            # 1.1 keeps the coordinator's pooled connections alive
            # across launch/kill posts (every response sets
            # Content-Length, so framing is sound)
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _json(self, code: int, body: dict) -> None:
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):
                # the agent's /launch runs arbitrary commands: when a
                # token is configured the coordinator must present it
                if daemon.agent_token and \
                        self.headers.get("X-Cook-Agent-Token", "") \
                        != daemon.agent_token:
                    self._json(401, {"error": "bad agent token"})
                    return
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                ctype = self.headers.get("Content-Type", "")
                if ctype.split(";", 1)[0].strip() == \
                        specwire.CONTENT_TYPE:
                    try:
                        payload = {"specs": specwire.decode_specs(body)}
                    except ValueError:
                        self._json(400,
                                   {"error": "malformed spec frame"})
                        return
                else:
                    try:
                        payload = json.loads(body or b"{}")
                    except ValueError:
                        self._json(400, {"error": "malformed json"})
                        return
                if self.path == "/launch":
                    self._json(200, daemon.handle_launch(payload))
                elif self.path == "/kill":
                    self._json(200, daemon.handle_kill(payload))
                else:
                    self._json(404, {"error": "no route"})

            def do_GET(self):
                if self.path == "/state":
                    self._json(200, daemon.state())
                else:
                    self._json(404, {"error": "no route"})

        self.httpd = ThreadingHTTPServer((bind_host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._server_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)

    # -- lifecycle -----------------------------------------------------
    @property
    def url(self) -> str:
        return f"http://{self.advertise_host}:{self.port}"

    def start(self) -> "AgentDaemon":
        self.file_server.start()
        self._server_thread.start()
        self._register(block=True)
        threading.Thread(target=self._heartbeat_loop, daemon=True).start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for tid in list(self.executor.alive_task_ids()):
            self.executor.kill(tid)
        self.httpd.shutdown()
        self.file_server.stop()

    def run_forever(self) -> None:
        self.start()
        try:
            while not self._stop.is_set():
                time.sleep(1.0)
        except KeyboardInterrupt:
            self.stop()

    # -- coordinator-facing --------------------------------------------
    def _register_payload(self) -> dict:
        return {
            "hostname": self.hostname, "url": self.url,
            "mem": self.mem, "cpus": self.cpus, "gpus": self.gpus,
            "pool": self.pool, "attributes": self.attributes,
            "file_server_url":
                f"http://{self.advertise_host}:{self.file_server.port}",
            "tasks": sorted(self.executor.alive_task_ids()),
            "outbox_dropped": self.outbox_dropped,
            # binary launch framings this daemon can decode; the
            # coordinator falls back to JSON when absent
            "spec_wire": [specwire.WIRE_FORMAT],
        }

    def _register(self, block: bool = False) -> None:
        def attempt():
            self._post("/agents/register", self._register_payload())

        if block:
            try:
                # every failure retries here (even a 4xx: the daemon
                # has nothing better to do than wait out a coordinator
                # that is mid-upgrade or mid-election)
                self._register_policy.call(
                    attempt, retryable=lambda _e: True,
                    should_abort=self._stop.is_set,
                    on_retry=lambda n, e: logger.warning(
                        "register failed (%s); attempt %d", e, n))
            except BaseException:
                if self._stop.is_set():
                    return  # shutdown interrupted the loop; stay quiet
                raise
        else:
            attempt()
        logger.info("registered with %s as %s",
                    self.coordinator_url, self.hostname)

    def _heartbeat_loop(self) -> None:
        while not self._stop.is_set():
            time.sleep(self.heartbeat_interval_s)
            try:
                resp = self._post("/agents/heartbeat", {
                    "hostname": self.hostname,
                    "tasks": sorted(self.executor.alive_task_ids()),
                    "outbox_dropped": self.outbox_dropped})
                if resp.get("reregister"):
                    self._register(block=True)
                self._flush_outbox()
                for tid in resp.get("kill", []):
                    # coordinator doesn't know this task: orphan from a
                    # torn launch or a previous coordinator life
                    logger.warning("killing orphan task %s", tid)
                    self.executor.kill(tid)
            except Exception as e:
                logger.warning("heartbeat failed: %s", e)

    def _on_status(self, task_id: str, event: str, info: dict) -> None:
        payload = {
            "task_id": task_id, "event": event,
            "exit_code": info.get("exit_code"),
            "sandbox": info.get("sandbox", ""),
            "hostname": self.hostname}
        # echo the trace context + this task's locally-timed spans:
        # "launch" rides the first status that goes out, "run" the
        # terminal one ("running" is the only non-terminal event)
        with self._task_traces_lock:
            entry = self._task_traces.get(task_id) if event == "running" \
                else self._task_traces.pop(task_id, None)
            if entry is not None:
                spans = []
                if not entry["sent_launch"]:
                    spans.append({"name": "launch", "t0": entry["t0"],
                                  "t1": entry["t_launched"]})
                    entry["sent_launch"] = True
                if event != "running":
                    spans.append({"name": "run",
                                  "t0": entry["t_launched"],
                                  "t1": time.time() * 1000.0})
                payload["traceparent"] = entry["tp"]
                payload["spans"] = spans
        self._send_status(payload)

    def _send_status(self, payload: dict) -> None:
        """Enqueue one status and drain the queue unless another
        thread is already sending. A burst of executor completions
        (bench scale: hundreds of mock tasks finishing in one tick)
        collapses into a handful of bulk POSTs instead of a per-task
        round trip each; a lone status delivers synchronously."""
        with self._status_lock:
            self._status_q.append(payload)
            if self._status_sending:
                return
            self._status_sending = True
        try:
            while True:
                with self._status_lock:
                    if not self._status_q:
                        self._status_sending = False
                        return
                    batch, self._status_q = self._status_q, []
                self._deliver_statuses(batch)
        except BaseException:
            with self._status_lock:
                self._status_sending = False
            raise

    def _deliver_statuses(self, batch: list) -> None:
        if len(batch) > 1 and not self._bulk_unsupported:
            try:
                self._post("/agents/status/bulk", {"updates": batch})
                return
            except urllib.error.HTTPError as e:
                if e.code in (404, 405):
                    # old coordinator: remember and stop probing
                    self._bulk_unsupported = True
            except Exception:
                pass  # singular path below owns retry + outbox
        for payload in batch:
            if not self._post_retry("/agents/status", payload):
                # terminal statuses must not be lost to a leaderless
                # window (the task is gone from later heartbeat task
                # lists, so the diff safety net can't recover it):
                # queue for redelivery after the next successful
                # register/heartbeat
                with self._outbox_lock:
                    self._outbox.append(payload)
                    self._trim_outbox_locked()
                logger.warning("queued undelivered status for %s",
                               payload.get("task_id"))

    def _trim_outbox_locked(self) -> None:
        while len(self._outbox) > self.outbox_max:
            dropped = self._outbox.pop(0)
            self.outbox_dropped += 1
            metrics_registry.counter("agent_outbox_dropped_total").inc()
            logger.warning("outbox full (%d): dropped oldest status for "
                           "%s", self.outbox_max,
                           dropped.get("task_id"))

    def _flush_outbox(self) -> None:
        with self._outbox_lock:
            pending, self._outbox = self._outbox, []
        for i, payload in enumerate(pending):
            if not self._post_retry("/agents/status", payload, attempts=1):
                # redeliver in arrival order: stop at the first failure
                # and put the unsent remainder back at the FRONT, so
                # statuses queued while we flushed stay behind them
                with self._outbox_lock:
                    self._outbox[0:0] = pending[i:]
                    self._trim_outbox_locked()
                return

    def _on_progress(self, task_id: str, sequence: int, percent: int,
                     message: str) -> None:
        self._post_retry("/agents/progress", {
            "task_id": task_id, "sequence": sequence,
            "percent": percent, "message": message}, attempts=1)

    @property
    def coordinator_url(self) -> str:
        with self._url_lock:
            return self._urls[self._url_idx]

    def _switch_to(self, url: str) -> None:
        url = url.rstrip("/")
        with self._url_lock:
            if url not in self._urls:
                # keep at most one hint-learned URL beyond the configured
                # candidates: dead ex-leader addresses must not
                # accumulate (each dead entry costs a full connect
                # timeout per rotation)
                if self._hint_url is not None \
                        and self._hint_url in self._urls:
                    self._urls.remove(self._hint_url)
                self._hint_url = url
                self._urls.append(url)
                self._url_idx %= len(self._urls)
            if self._urls[self._url_idx] != url:
                logger.info("coordinator failover: %s -> %s",
                            self._urls[self._url_idx], url)
                self._url_idx = self._urls.index(url)

    def _rotate_from(self, url: str) -> None:
        """Advance past `url` — only if another thread hasn't already
        moved the pointer elsewhere."""
        with self._url_lock:
            if self._urls[self._url_idx] == url:
                self._url_idx = (self._url_idx + 1) % len(self._urls)

    def set_partitioned(self, cut: bool) -> None:
        """Churn-chaos hook (chaos/churn.py PARTITION): sever or heal
        this daemon's coordinator link without touching its tasks."""
        if cut:
            self._partitioned.set()
        else:
            self._partitioned.clear()

    def _post(self, path: str, payload: dict) -> dict:
        """POST to the current coordinator; on connection failure rotate
        through the candidate list, on a 503 not-leader answer follow
        its leader hint. Raises after one full cycle of candidates."""
        if self._partitioned.is_set():
            raise ConnectionError("agent partitioned (chaos churn)")
        headers = {}
        if self.agent_token:
            headers["X-Cook-Agent-Token"] = self.agent_token
        last_exc: Exception = RuntimeError("no coordinator candidates")
        with self._url_lock:
            attempts = len(self._urls) + 1
        for _ in range(attempts):
            url = self.coordinator_url
            try:
                return json_request("POST", url + path, payload,
                                    headers=headers,
                                    chaos_site=_CHAOS_SITES.get(path, ""))
            except urllib.error.HTTPError as e:
                if e.code != 503:
                    raise
                try:
                    hint = json.loads(e.read() or b"{}").get("leader")
                except Exception:
                    hint = None
                last_exc = e
                if hint and hint.rstrip("/") != url:
                    self._switch_to(hint)
                else:
                    # standby with no leader yet: try the next candidate
                    self._rotate_from(url)
            except (urllib.error.URLError, ConnectionError, OSError) as e:
                last_exc = e
                self._rotate_from(url)
        raise last_exc

    def _post_retry(self, path: str, payload: dict,
                    attempts: int = 3) -> bool:
        policy = self._status_policy if attempts == 3 \
            else RetryPolicy(max_attempts=attempts,
                             base_delay_s=self._status_policy.base_delay_s,
                             max_delay_s=self._status_policy.max_delay_s)
        try:
            policy.call(lambda: self._post(path, payload),
                        should_abort=self._stop.is_set)
            return True
        except Exception as e:
            logger.warning("post %s undelivered after %d attempt(s): %s",
                           path, attempts, e)
            return False

    # -- coordinator-issued work ---------------------------------------
    def handle_launch(self, payload: dict) -> dict:
        for spec in payload.get("specs", []):
            env = dict(spec.get("env", {}))
            for i, p in enumerate(spec.get("ports", [])):
                env[f"PORT{i}"] = str(p)
            tp = spec.get("traceparent", "")
            t0 = time.time() * 1000.0
            try:
                self.executor.launch(
                    spec["task_id"], spec.get("command", ""), env=env,
                    progress_regex=spec.get("progress_regex", ""),
                    progress_output_file=spec.get("progress_output_file",
                                                  ""),
                    uris=spec.get("uris", []))
            except Exception as e:
                logger.warning("launch %s failed: %s", spec.get("task_id"),
                               e)
                fail = {"task_id": spec["task_id"],
                        "event": "fetch_failed",
                        "hostname": self.hostname}
                if tp:
                    fail["traceparent"] = tp
                    fail["spans"] = [{"name": "launch", "t0": t0,
                                      "t1": time.time() * 1000.0}]
                self._post_retry("/agents/status", fail)
                continue
            if tp:
                with self._task_traces_lock:
                    self._task_traces[spec["task_id"]] = {
                        "tp": tp, "t0": t0,
                        "t_launched": time.time() * 1000.0,
                        "sent_launch": False}
        return {"ok": True}

    def handle_kill(self, payload: dict) -> dict:
        self.executor.kill(payload.get("task_id", ""))
        return {"ok": True}

    def state(self) -> dict:
        # `undelivered` carries the outbox's terminal statuses so a
        # restarted coordinator's reconciliation census can fold in a
        # task that finished while it was down, instead of
        # mis-classifying it as never-launched and re-running the
        # command (the outbox would eventually deliver them on the next
        # heartbeat, but reconciliation runs before that).
        with self._outbox_lock:
            undelivered = list(self._outbox)
        with self._status_lock:
            # statuses still in the coalescer queue are just as
            # undelivered as the outbox's from the census's viewpoint
            undelivered += list(self._status_q)
        return {"hostname": self.hostname,
                "tasks": sorted(self.executor.alive_task_ids()),
                "undelivered": undelivered,
                "mem": self.mem, "cpus": self.cpus, "pool": self.pool}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="cook_tpu_torch.agent",
        description="cook_tpu network agent (remote task execution)")
    ap.add_argument("--coordinator", required=True,
                    help="coordinator base URL(s), comma-separated for "
                         "an HA deployment, e.g. "
                         "http://head1:12321,http://head2:12321")
    ap.add_argument("--hostname", default=None)
    ap.add_argument("--mem", type=float, default=8192.0)
    ap.add_argument("--cpus", type=float, default=8.0)
    ap.add_argument("--gpus", type=float, default=0.0)
    ap.add_argument("--pool", default="default")
    ap.add_argument("--sandbox-root",
                    default="/tmp/cook_tpu_agent_sandboxes")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--file-server-port", type=int, default=0)
    ap.add_argument("--heartbeat-interval", type=float, default=5.0)
    ap.add_argument("--advertise-host", default="127.0.0.1")
    ap.add_argument("--bind-host", default="127.0.0.1",
                    help="interface for the control server (set to "
                         "0.0.0.0 for real remote deployments)")
    ap.add_argument("--agent-token", default="")
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    AgentDaemon(
        args.coordinator, hostname=args.hostname, mem=args.mem,
        cpus=args.cpus, gpus=args.gpus, pool=args.pool,
        sandbox_root=args.sandbox_root, port=args.port,
        file_server_port=args.file_server_port,
        heartbeat_interval_s=args.heartbeat_interval,
        advertise_host=args.advertise_host, bind_host=args.bind_host,
        agent_token=args.agent_token).run_forever()


if __name__ == "__main__":
    main()
