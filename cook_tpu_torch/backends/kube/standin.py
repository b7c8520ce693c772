"""HTTP-level Kubernetes apiserver stand-in.

Serves a FakeKube over the real Kubernetes wire protocol — list
responses with resourceVersions, chunk-streamed watch events
({"type": ..., "object": ...} lines), pod CRUD, 410 Gone when a watch
asks for an expired resourceVersion — so HttpKube exercises its full
list/watch/reconnect machinery against genuine apiserver JSON without a
cluster. The reference gets the same leverage from its in-repo fake
(testutil.clj:545 make-kubernetes-compute-cluster); shipping it in src
(not tests/) mirrors that choice and lets the simulator use it too.

Test hooks: `drop_streams()` severs live watch connections (network
blip -> client resumes from its resourceVersion); `expire_history()`
ages out the event window (client's resume hits 410 -> full relist).
"""
from __future__ import annotations

import json
import logging
import queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from cook_tpu_torch.backends.kube.api import (FakeKube, Node, Pod,
                                        PodPhase)
from cook_tpu_torch.backends.kube.http_api import (fmt_cpu, fmt_mem_mb,
                                             pod_from_json, pod_to_json,
                                             POOL_LABEL)


def pod_wire(pod: Pod, namespace: str, rv: int) -> dict:
    """Pod dataclass -> V1Pod wire JSON including status (the inverse of
    http_api.pod_from_json)."""
    obj = pod_to_json(pod, namespace)
    obj["metadata"]["resourceVersion"] = str(rv)
    if pod.deleting:
        obj["metadata"]["deletionTimestamp"] = "2026-01-01T00:00:00Z"
    status: dict = {"phase": pod.phase.value}
    if pod.exit_code is not None:
        status["containerStatuses"] = [{
            "name": "cook-job",
            "state": {"terminated": {"exitCode": pod.exit_code}},
        }]
    if pod.preempted:
        status["reason"] = "Preempted"
    obj["status"] = status
    return obj


def node_wire(node: Node, rv: int) -> dict:
    alloc = {"memory": fmt_mem_mb(node.mem), "cpu": fmt_cpu(node.cpus)}
    if node.gpus:
        alloc["nvidia.com/gpu"] = str(int(node.gpus))
    obj = {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {"name": node.name,
                     "resourceVersion": str(rv),
                     "labels": {**node.labels, POOL_LABEL: node.pool}},
        "spec": {},
        "status": {"allocatable": alloc,
                   "conditions": [{"type": "Ready", "status": "True"}]},
    }
    if not node.schedulable:
        obj["spec"]["unschedulable"] = True
    return obj


class ApiServerStandIn:
    """ThreadingHTTPServer speaking the apiserver wire protocol over a
    FakeKube. One global resourceVersion counter across resources (like
    etcd's revision)."""

    def __init__(self, fake: Optional[FakeKube] = None,
                 namespace: str = "cook",
                 require_token: Optional[str] = None,
                 history_window: int = 1024,
                 port: int = 0):
        self.fake = fake or FakeKube()
        self.namespace = namespace
        self.require_token = require_token
        self._lock = threading.RLock()
        self._rv = 0
        # (rv, resource, wire-event-dict) ring; oldest entries age out
        self._history: deque = deque(maxlen=history_window)
        self._oldest_rv = 0
        self._streams: list[tuple[str, queue.Queue]] = []
        self._events: list[dict] = []      # CoreV1Event objects
        # coordination.k8s.io/v1 Lease objects (leader election); writes
        # are resourceVersion compare-and-swap like a real apiserver
        self._leases: dict[str, dict] = {}
        self.list_counts = {"pods": 0, "nodes": 0}   # test observability
        # raw wire JSON of every POSTed pod, keyed by name: tests assert
        # the client materialized tolerations/selectors/priority/sidecar
        # on the WIRE, not just on the dataclass
        self.pod_specs: dict[str, dict] = {}
        # >0: the next N non-watch requests are answered 429 with
        # Retry-After (apiserver priority-and-fairness throttling)
        self._throttle_left = 0
        self._throttle_retry_after = 1
        self.fake.watch_pods(self._on_pod)
        self.fake.watch_nodes(self._on_node)

        standin = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.0: no chunked framing needed; EOF ends the stream
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):
                standin._handle(self, "GET")

            def do_POST(self):
                standin._handle(self, "POST")

            def do_PUT(self):
                standin._handle(self, "PUT")

            def do_DELETE(self):
                standin._handle(self, "DELETE")

        self.server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.server.daemon_threads = True
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        host, port = self.server.server_address
        return f"http://{host}:{port}"

    def close(self) -> None:
        self.drop_streams()
        self.server.shutdown()

    # -- test hooks ----------------------------------------------------
    def drop_streams(self) -> None:
        """Sever all live watch connections (simulated network blip)."""
        with self._lock:
            streams, self._streams = self._streams, []
        for _, q, _bm in streams:
            q.put(None)

    def expire_history(self) -> None:
        """Age the whole watch-event window out, so any in-flight
        resourceVersion resume gets 410 Gone."""
        with self._lock:
            self._history.clear()
            self._oldest_rv = self._rv

    def throttle_next(self, n: int, retry_after: int = 1) -> None:
        """The next n non-watch requests get 429 + Retry-After — the
        apiserver's priority-and-fairness backpressure clients must
        honor (kubernetes/api.clj-class clients break here)."""
        with self._lock:
            self._throttle_left = n
            self._throttle_retry_after = retry_after

    def post_bookmark(self) -> None:
        """Broadcast a BOOKMARK event carrying the current rv to every
        live watch that asked for bookmarks (allowWatchBookmarks): lets
        idle watchers advance their resume point past history they never
        saw, so a later reconnect doesn't 410."""
        with self._lock:
            for res, q, bookmarks in list(self._streams):
                if bookmarks:
                    q.put({"type": "BOOKMARK", "object": {
                        "kind": {"pods": "Pod", "nodes": "Node",
                                 "events": "Event"}.get(res, "Pod"),
                        "metadata": {"resourceVersion": str(self._rv)}}})

    def post_event(self, reason: str, message: str,
                   involved_name: str = "", etype: str = "Warning") -> None:
        """Append a CoreV1Event (the apiserver emits these for e.g.
        FailedScheduling; tests drive them explicitly)."""
        with self._lock:
            self._rv += 1
            obj = {
                "apiVersion": "v1", "kind": "Event",
                "metadata": {"name": f"evt-{self._rv}",
                             "namespace": self.namespace,
                             "resourceVersion": str(self._rv)},
                "reason": reason, "message": message, "type": etype,
                "involvedObject": {"kind": "Pod", "name": involved_name,
                                   "namespace": self.namespace},
            }
            self._events.append(obj)
            self._broadcast("events", {"type": "ADDED", "object": obj})

    # -- watch fan-out -------------------------------------------------
    def _on_pod(self, kind: str, pod: Pod) -> None:
        with self._lock:
            self._rv += 1
            wire = pod_wire(pod, self.namespace, self._rv)
            etype = {"added": "ADDED", "modified": "MODIFIED",
                     "deleted": "DELETED"}[kind]
            self._broadcast("pods", {"type": etype, "object": wire})

    def _on_node(self, kind: str, node: Node) -> None:
        with self._lock:
            self._rv += 1
            wire = node_wire(node, self._rv)
            etype = {"added": "ADDED", "modified": "MODIFIED",
                     "deleted": "DELETED"}[kind]
            self._broadcast("nodes", {"type": etype, "object": wire})

    def _broadcast(self, resource: str, event: dict) -> None:
        # callers hold self._lock
        if len(self._history) == self._history.maxlen:
            self._oldest_rv = self._history[0][0]
        self._history.append((self._rv, resource, event))
        for res, q, _bm in list(self._streams):
            if res == resource:
                q.put(event)

    # -- request handling ----------------------------------------------
    def _handle(self, h: BaseHTTPRequestHandler, method: str) -> None:
        if self.require_token is not None:
            auth = h.headers.get("Authorization", "")
            if auth != f"Bearer {self.require_token}":
                self._send_json(h, 401, {"kind": "Status", "code": 401,
                                         "message": "Unauthorized"})
                return
        parsed = urlparse(h.path)
        parts = [p for p in parsed.path.split("/") if p]
        qs = parse_qs(parsed.query)
        if qs.get("watch", ["false"])[0] != "true":
            with self._lock:
                if self._throttle_left > 0:
                    self._throttle_left -= 1
                    data = json.dumps({"kind": "Status", "code": 429,
                                       "reason": "TooManyRequests"}).encode()
                    h.send_response(429)
                    h.send_header("Retry-After",
                                  str(self._throttle_retry_after))
                    h.send_header("Content-Type", "application/json")
                    h.send_header("Content-Length", str(len(data)))
                    h.end_headers()
                    h.wfile.write(data)
                    return
        try:
            self._route(h, method, parts, qs)
        except BrokenPipeError:
            pass

    def _route(self, h, method: str, parts: list[str], qs: dict) -> None:
        ns_pods = ["api", "v1", "namespaces", self.namespace, "pods"]
        ns_events = ["api", "v1", "namespaces", self.namespace, "events"]
        ns_leases = ["apis", "coordination.k8s.io", "v1", "namespaces",
                     self.namespace, "leases"]
        if parts[:6] == ns_leases:
            self._route_lease(h, method, parts[6:])
            return
        if method == "GET" and parts == ns_pods:
            if qs.get("watch", ["false"])[0] == "true":
                self._serve_watch(h, "pods", qs)
            else:
                self.list_counts["pods"] += 1
                # take the fake's lock BEFORE ours: the watch fan-out
                # path holds the fake's lock when it calls _on_pod ->
                # our lock, so the reverse order here would deadlock.
                # And read rv BEFORE the snapshot: a stale rv with newer
                # items only means duplicate (idempotent) events on a
                # later watch, while a newer rv with older items would
                # permanently hide the missed event from watchers.
                with self._lock:
                    rv = self._rv
                pods = self.fake.list_pods()
                with self._lock:
                    items = [pod_wire(p, self.namespace, rv)
                             for p in pods]
                self._send_json(h, 200, {
                    "kind": "PodList",
                    "metadata": {"resourceVersion": str(rv)},
                    "items": items})
        elif method == "GET" and parts == ["api", "v1", "nodes"]:
            if qs.get("watch", ["false"])[0] == "true":
                self._serve_watch(h, "nodes", qs)
            else:
                self.list_counts["nodes"] += 1
                with self._lock:
                    rv = self._rv
                nodes = self.fake.list_nodes()
                items = [node_wire(n, rv) for n in nodes]
                self._send_json(h, 200, {
                    "kind": "NodeList",
                    "metadata": {"resourceVersion": str(rv)},
                    "items": items})
        elif method == "GET" and parts == ns_events:
            if qs.get("watch", ["false"])[0] == "true":
                self._serve_watch(h, "events", qs)
            else:
                with self._lock:
                    self._send_json(h, 200, {
                        "kind": "EventList",
                        "metadata": {"resourceVersion": str(self._rv)},
                        "items": list(self._events)})
        elif method == "POST" and parts == ns_pods:
            length = int(h.headers.get("Content-Length", 0))
            body = json.loads(h.rfile.read(length).decode())
            bad = self._invalid_pod_reason(body)
            if bad:
                self._send_json(h, 422, {"kind": "Status", "code": 422,
                                         "reason": "Invalid",
                                         "message": bad})
                return
            pod = pod_from_json(body)
            if pod.name in self.fake.pods:
                self._send_json(h, 409, {"kind": "Status", "code": 409,
                                         "reason": "AlreadyExists"})
                return
            self.pod_specs[pod.name] = body
            self.fake.create_pod(pod)
            with self._lock:
                self._send_json(h, 201,
                                pod_wire(pod, self.namespace, self._rv))
        elif method == "DELETE" and len(parts) == 6 and \
                parts[:5] == ns_pods:
            name = parts[5]
            if name not in self.fake.pods:
                self._send_json(h, 404, {"kind": "Status", "code": 404,
                                         "reason": "NotFound"})
                return
            self.fake.delete_pod(name)
            self._send_json(h, 200, {"kind": "Status", "status": "Success"})
        else:
            self._send_json(h, 404, {"kind": "Status", "code": 404,
                                     "message": f"no route {parts}"})

    def _route_lease(self, h, method: str, tail: list[str]) -> None:
        """coordination.k8s.io Lease CRUD with resourceVersion CAS —
        the mutual-exclusion primitive LeaseElector's takeover races
        ride on (a stale resourceVersion loses with 409)."""
        def read_body():
            length = int(h.headers.get("Content-Length", 0))
            return json.loads(h.rfile.read(length).decode() or "{}")

        if method == "GET" and len(tail) == 1:
            with self._lock:
                lease = self._leases.get(tail[0])
            if lease is None:
                self._send_json(h, 404, {"kind": "Status", "code": 404,
                                         "reason": "NotFound"})
            else:
                self._send_json(h, 200, lease)
        elif method == "POST" and not tail:
            body = read_body()
            name = body.get("metadata", {}).get("name", "")
            with self._lock:
                if name in self._leases:
                    self._send_json(h, 409, {"kind": "Status", "code": 409,
                                             "reason": "AlreadyExists"})
                    return
                self._rv += 1
                body.setdefault("metadata", {})["resourceVersion"] = \
                    str(self._rv)
                self._leases[name] = body
            self._send_json(h, 201, body)
        elif method == "PUT" and len(tail) == 1:
            body = read_body()
            name = tail[0]
            want_rv = body.get("metadata", {}).get("resourceVersion")
            with self._lock:
                cur = self._leases.get(name)
                if cur is None:
                    self._send_json(h, 404, {"kind": "Status", "code": 404,
                                             "reason": "NotFound"})
                    return
                cur_rv = cur.get("metadata", {}).get("resourceVersion")
                if want_rv != cur_rv:
                    self._send_json(h, 409, {"kind": "Status", "code": 409,
                                             "reason": "Conflict"})
                    return
                self._rv += 1
                body.setdefault("metadata", {})["resourceVersion"] = \
                    str(self._rv)
                self._leases[name] = body
            self._send_json(h, 200, body)
        elif method == "DELETE" and len(tail) == 1:
            with self._lock:
                gone = self._leases.pop(tail[0], None)
            self._send_json(h, 200 if gone else 404,
                            {"kind": "Status",
                             "status": "Success" if gone else "Failure"})
        else:
            self._send_json(h, 404, {"kind": "Status", "code": 404,
                                     "message": "no lease route"})

    def _serve_watch(self, h, resource: str, qs: dict) -> None:
        rv = int(qs.get("resourceVersion", ["0"])[0] or 0)
        q: queue.Queue = queue.Queue()
        with self._lock:
            if rv < self._oldest_rv:
                self._send_json(h, 410, {
                    "kind": "Status", "code": 410, "reason": "Expired",
                    "message": f"too old resource version: {rv} "
                               f"({self._oldest_rv})"})
                return
            backlog = [ev for (erv, res, ev) in self._history
                       if res == resource and erv > rv]
            bookmarks = qs.get("allowWatchBookmarks",
                               ["false"])[0] == "true"
            self._streams.append((resource, q, bookmarks))
        h.send_response(200)
        h.send_header("Content-Type", "application/json")
        h.end_headers()
        try:
            for ev in backlog:
                h.wfile.write((json.dumps(ev) + "\n").encode())
            h.wfile.flush()
            while True:
                ev = q.get()
                if ev is None:          # drop_streams(): sever
                    return
                h.wfile.write((json.dumps(ev) + "\n").encode())
                h.wfile.flush()
        finally:
            with self._lock:
                self._streams = [(r, sq, bm) for (r, sq, bm)
                                 in self._streams if sq is not q]

    @staticmethod
    def _invalid_pod_reason(body: dict) -> str:
        """Apiserver-grade structural validation of a POSTed pod: the
        fields a real admission chain would reject on. Returns "" when
        valid."""
        if body.get("apiVersion") != "v1" or body.get("kind") != "Pod":
            return "apiVersion/kind must be v1/Pod"
        if not (body.get("metadata") or {}).get("name"):
            return "metadata.name required"
        spec = body.get("spec") or {}
        containers = spec.get("containers") or []
        if not containers:
            return "spec.containers must be non-empty"
        names = set()
        vol_names = {v.get("name") for v in spec.get("volumes") or []}
        for c in containers + (spec.get("initContainers") or []):
            if not c.get("name"):
                return "container name required"
            if c["name"] in names:
                return f"duplicate container name {c['name']}"
            names.add(c["name"])
            for m in c.get("volumeMounts") or []:
                if m.get("name") not in vol_names:
                    return (f"container {c['name']} mounts unknown "
                            f"volume {m.get('name')}")
        req = (containers[0].get("resources") or {}).get("requests") or {}
        if "memory" not in req or "cpu" not in req:
            return "first container must request memory and cpu"
        for t in spec.get("tolerations") or []:
            if t.get("operator", "Equal") not in ("Equal", "Exists"):
                return f"bad toleration operator {t.get('operator')}"
        return ""

    @staticmethod
    def _send_json(h, code: int, body: dict) -> None:
        data = json.dumps(body).encode()
        h.send_response(code)
        h.send_header("Content-Type", "application/json")
        h.send_header("Content-Length", str(len(data)))
        h.end_headers()
        h.wfile.write(data)


class KubeletSim:
    """Autonomous kubelet/scheduler simulation over a FakeKube: binds
    pending pods (schedule_pending), starts bound pods, and succeeds
    running pods after `runtime_s` — so the full kube backend stack is
    drivable as real processes without a cluster (the minimesos role
    for the kube path; the reference's dev story is
    run-local-kubernetes.sh against a real minikube)."""

    def __init__(self, fake: FakeKube, interval_s: float = 0.5,
                 runtime_s: float = 5.0):
        self.fake = fake
        self.interval_s = interval_s
        self.runtime_s = runtime_s
        self._started_at: dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def step(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        self.fake.schedule_pending()
        live = self.fake.list_pods()
        for pod in live:
            try:
                if pod.terminal:
                    continue
                if pod.phase == PodPhase.PENDING and pod.node:
                    # bound synthetic pods start too: the backend's
                    # RUNNING-phase GC (_on_synthetic_event) then deletes
                    # them, releasing the capacity they held — leaving
                    # them bound-but-pending would wedge the cluster
                    self.fake.start_pod(pod.name)
                    self._started_at[pod.name] = now
                elif pod.phase == PodPhase.RUNNING and not pod.synthetic:
                    t0 = self._started_at.setdefault(pod.name, now)
                    if now - t0 >= self.runtime_s:
                        self.fake.succeed_pod(pod.name)
                        self._started_at.pop(pod.name, None)
            except KeyError:
                # pod deleted concurrently (kill, synthetic GC): next
                # pod, not next step
                continue
        # prune start times of pods that vanished while running
        names = {p.name for p in live}
        for gone in [n for n in self._started_at if n not in names]:
            self._started_at.pop(gone, None)

    def start(self) -> "KubeletSim":
        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.step()
                except Exception:
                    logging.getLogger(__name__).exception(
                        "kubelet sim step failed")
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)


def main(argv=None) -> None:
    """`python -m cook_tpu_torch.backends.kube.standin --port 12380
    --nodes 2 --kubelet-sim` — a standalone apiserver stand-in with an
    optional kubelet simulation, for the local kube dev story."""
    import argparse

    ap = argparse.ArgumentParser(description="apiserver stand-in")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--node-mem", type=float, default=8192.0)
    ap.add_argument("--node-cpus", type=float, default=8.0)
    ap.add_argument("--namespace", default="cook")
    ap.add_argument("--kubelet-sim", action="store_true",
                    help="bind/start/succeed pods automatically")
    ap.add_argument("--pod-runtime", type=float, default=5.0,
                    help="simulated pod runtime seconds")
    args = ap.parse_args(argv)
    fake = FakeKube(nodes=[
        Node(name=f"node{i}", mem=args.node_mem, cpus=args.node_cpus)
        for i in range(args.nodes)])
    server = ApiServerStandIn(fake, namespace=args.namespace,
                              port=args.port)
    sim = KubeletSim(fake, runtime_s=args.pod_runtime).start() \
        if args.kubelet_sim else None
    print(f"apiserver stand-in on {server.url} "
          f"({args.nodes} nodes, kubelet-sim={'on' if sim else 'off'})",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        if sim:
            sim.stop()
        server.close()


if __name__ == "__main__":
    main()
