"""Kubernetes apiserver HTTP client: the real-cluster KubeApi.

Equivalent of the watch/CRUD machinery in the reference's
kubernetes/api.clj (pod watch :200, node watch :281, event watch :333,
create-namespaced-pod :1088, delete-pod :1048, WatchHelper.java): list +
streaming watches against a real apiserver, speaking the standard
Kubernetes wire JSON with stdlib HTTP only (no client-java equivalent
dependency).

Watch protocol (api.clj:200-280 semantics, re-expressed):
  1. LIST to capture a resourceVersion and the current object set.
     On every (re)list the client diffs against its last-known set and
     synthesizes added/modified/deleted callbacks, so a deletion that
     happened during a watch gap is not lost (the reference covers this
     with its controller scan; here the watch layer itself heals).
  2. WATCH ?watch=true&resourceVersion=RV as a chunked stream of
     {"type": ADDED|MODIFIED|DELETED|BOOKMARK|ERROR, "object": ...}
     lines, updating RV as events arrive.
  3. On HTTP 410 Gone (or an ERROR event carrying code 410) the RV is
     too old: full relist + diff, then a fresh watch.
  4. On socket errors / EOF: reconnect with exponential backoff from the
     last good RV.

Auth: bearer token (in-cluster token file or literal), optional CA
bundle / insecure TLS — the corners of kubeconfig the scheduler needs.
"""
from __future__ import annotations

import json
import logging
import os
import shlex
import ssl
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Optional

from cook_tpu_torch.backends.kube.api import (KubeApi, Node, Pod, PodPhase,
                                        POOL_LABEL, SYNTHETIC_LABEL,
                                        WatchCallback)

logger = logging.getLogger(__name__)

_PHASES = {p.value: p for p in PodPhase}


# ---------------------------------------------------------------------------
# quantity / wire translation

def parse_cpu(q) -> float:
    if isinstance(q, (int, float)):
        return float(q)
    s = str(q)
    if s.endswith("m"):
        return float(s[:-1]) / 1000.0
    return float(s)


_MEM_SUFFIX = {"Ki": 1.0 / 1024, "Mi": 1.0, "Gi": 1024.0, "Ti": 1024.0 ** 2,
               "K": 1e3 / 1e6, "M": 1.0, "G": 1e3, "T": 1e6,
               "k": 1e3 / 1e6}


def parse_mem_mb(q) -> float:
    """Memory quantity -> MB (MiB treated as MB, like the reference's
    to-double conversions)."""
    if isinstance(q, (int, float)):
        return float(q) / 1e6            # plain number = bytes
    s = str(q)
    for suf, mult in _MEM_SUFFIX.items():
        if s.endswith(suf):
            return float(s[: -len(suf)]) * mult
    return float(s) / 1e6


def fmt_mem_mb(mb: float) -> str:
    return f"{int(round(mb))}Mi"


def fmt_cpu(cores: float) -> str:
    return f"{int(round(cores * 1000))}m"


def pod_to_json(pod: Pod, namespace: str) -> dict:
    """Pod dataclass -> V1Pod wire JSON (task-metadata->pod
    api.clj:661-882: container, env, resources, labels, init-container
    for URI fetches, volumes, tolerations, node selectors, priority
    class, docker port-mappings/volumes/network from the job container
    spec (task.clj:338-405), sidecar file-server injection;
    restartPolicy Never like the reference)."""
    requests = {"memory": fmt_mem_mb(pod.mem), "cpu": fmt_cpu(pod.cpus)}
    if pod.gpus:
        requests["nvidia.com/gpu"] = str(int(pod.gpus))
    env = [{"name": k, "value": str(v)} for k, v in sorted(pod.env.items())]
    cdict = pod.container or {}
    docker = cdict.get("docker") or {}
    container = {
        "name": "cook-job",
        "image": docker.get("image", "busybox:latest"),
        "command": ["/bin/sh", "-c", pod.command] if pod.command else None,
        "env": env,
        "resources": {"requests": requests, "limits": dict(requests)},
    }
    # docker port mappings -> containerPorts (task.clj:367-380)
    cports = [
        {k: v for k, v in {
            "containerPort": int(m.get("container-port", 0)),
            "hostPort": int(m["host-port"]) if m.get("host-port")
            else None,
            "protocol": (m.get("protocol") or "TCP").upper(),
        }.items() if v is not None}
        for m in (docker.get("port-mapping") or [])
    ]
    if cports:
        container["ports"] = cports
    # docker volumes -> hostPath volumes + mounts (task.clj:338-366)
    dvols, dmounts = [], []
    for i, v in enumerate(cdict.get("volumes") or []):
        host_path = v.get("host-path", "")
        if not host_path:
            continue
        name = f"cook-docker-vol-{i}"
        dvols.append({"name": name, "hostPath": {"path": host_path}})
        dmounts.append({
            "name": name,
            "mountPath": v.get("container-path", host_path),
            "readOnly": (v.get("mode", "RO").upper() != "RW"),
        })
    if dmounts:
        container["volumeMounts"] = dmounts
    container = {k: v for k, v in container.items() if v is not None}
    spec: dict = {
        "restartPolicy": "Never",
        "containers": [container],
    }
    if dvols:
        spec["volumes"] = list(dvols)
    if (docker.get("network") or "").upper() == "HOST":
        spec["hostNetwork"] = True
    if pod.tolerations:
        spec["tolerations"] = [dict(t) for t in pod.tolerations]
    if pod.node_selector:
        spec["nodeSelector"] = dict(pod.node_selector)
    if pod.priority_class:
        spec["priorityClassName"] = pod.priority_class
    if pod.sidecar:
        # in-pod file server sharing the sandbox volume: serves the
        # /files/{read,download,browse} API for `cs ls/cat/tail`
        port = int(pod.sidecar.get("port", 28501))
        spec["containers"].append({
            "name": "cook-sidecar",
            "image": pod.sidecar.get("image", "busybox:latest"),
            "command": ["/bin/sh", "-c",
                        pod.sidecar.get(
                            "command",
                            "python -m cook_tpu_torch.agent.file_server "
                            f"--root /cook-sandbox --port {port}")],
            "ports": [{"containerPort": port}],
            "volumeMounts": [{"name": "cook-sandbox",
                              "mountPath": "/cook-sandbox"}],
        })
        if not any(v.get("name") == "cook-sandbox"
                   for v in spec.get("volumes", [])):
            spec.setdefault("volumes", []).append(
                {"name": "cook-sandbox", "emptyDir": {}})
    if pod.node:
        spec["nodeName"] = pod.node
    if pod.init_uris:
        # URI fetch init-container (the reference renders fetches into
        # an init-container, api.clj:661-882); shell-quote so URIs with
        # &, ;, spaces, or query strings can't split into extra tokens
        fetch = " && ".join(
            "wget -O "
            + shlex.quote("/cook-sandbox/"
                          + (os.path.basename(u) or "fetched"))
            + " " + shlex.quote(u) for u in pod.init_uris)
        spec["initContainers"] = [{
            "name": "cook-init", "image": "busybox:latest",
            "command": ["/bin/sh", "-c", fetch],
            "volumeMounts": [{"name": "cook-sandbox",
                              "mountPath": "/cook-sandbox"}],
        }]
        if not any(v.get("name") == "cook-sandbox"
                   for v in spec.get("volumes", [])):
            spec.setdefault("volumes", []).append(
                {"name": "cook-sandbox", "emptyDir": {}})
    if any(v.get("name") == "cook-sandbox"
           for v in spec.get("volumes", [])):
        # the job container must see the sandbox the init-container
        # staged and the sidecar serves
        spec["containers"][0].setdefault("volumeMounts", []).append(
            {"name": "cook-sandbox", "mountPath": "/cook-sandbox"})
    for vol in pod.volumes:
        spec.setdefault("volumes", []).append(vol)
    labels = {**pod.labels, POOL_LABEL: pod.pool}
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": pod.name, "namespace": namespace,
                     "labels": labels},
        "spec": spec,
    }


def pod_from_json(obj: dict) -> Pod:
    """V1Pod wire JSON -> Pod dataclass (pod->synthesized-pod-state
    api.clj:942: phase, node, requests, exit code, deletionTimestamp)."""
    meta = obj.get("metadata", {})
    spec = obj.get("spec", {})
    status = obj.get("status", {})
    labels = dict(meta.get("labels") or {})
    containers = spec.get("containers") or [{}]
    c0 = containers[0]
    req = ((c0.get("resources") or {}).get("requests") or {})
    env = {e["name"]: e.get("value", "")
           for e in (c0.get("env") or []) if "name" in e}
    command = ""
    cmd = c0.get("command") or []
    if len(cmd) >= 3 and cmd[:2] == ["/bin/sh", "-c"]:
        command = cmd[2]
    exit_code = None
    for cs in status.get("containerStatuses") or []:
        term = (cs.get("state") or {}).get("terminated")
        if term is not None and term.get("exitCode") is not None:
            exit_code = int(term["exitCode"])
    phase = _PHASES.get(status.get("phase", "Pending"), PodPhase.UNKNOWN)
    # recover image / volumes / URI fetches so the round trip through an
    # apiserver keeps the launch-relevant fields
    image = c0.get("image")
    docker: dict = {}
    if image and image != "busybox:latest":
        docker["image"] = image
    if spec.get("hostNetwork"):
        docker["network"] = "HOST"
    pmaps = [
        {"container-port": p.get("containerPort"),
         **({"host-port": p["hostPort"]} if p.get("hostPort") else {}),
         "protocol": p.get("protocol", "TCP")}
        for p in (c0.get("ports") or [])
    ]
    if pmaps:
        docker["port-mapping"] = pmaps
    dvols = []
    mounts = {m.get("name"): m for m in (c0.get("volumeMounts") or [])}
    cvolumes = []
    for v in spec.get("volumes") or []:
        name = v.get("name", "")
        if name == "cook-sandbox":
            continue
        if name.startswith("cook-docker-vol-") and "hostPath" in v:
            m = mounts.get(name, {})
            dvols.append({
                "host-path": v["hostPath"].get("path", ""),
                "container-path": m.get("mountPath", ""),
                "mode": "RO" if m.get("readOnly") else "RW"})
        else:
            cvolumes.append(v)
    container = None
    if docker or dvols:
        container = {"type": "docker", "docker": docker}
        if dvols:
            container["volumes"] = dvols
    volumes = cvolumes
    sidecar = None
    for c in containers[1:]:
        if c.get("name") == "cook-sidecar":
            sport = next((p.get("containerPort")
                          for p in c.get("ports") or []), 28501)
            sidecar = {"image": c.get("image", ""), "port": sport}
            scmd = c.get("command") or []
            if len(scmd) >= 3 and scmd[:2] == ["/bin/sh", "-c"]:
                sidecar["command"] = scmd[2]
    init_uris = []
    for ic in spec.get("initContainers") or []:
        cmd = ic.get("command") or []
        if ic.get("name") == "cook-init" and len(cmd) >= 3:
            for part in cmd[2].split(" && "):
                try:
                    toks = shlex.split(part)
                except ValueError:
                    toks = part.split()
                if toks:
                    init_uris.append(toks[-1])
    return Pod(
        name=meta.get("name", ""),
        mem=parse_mem_mb(req.get("memory", 0)),
        cpus=parse_cpu(req.get("cpu", 0)),
        gpus=float(req.get("nvidia.com/gpu", 0) or 0),
        node=spec.get("nodeName", "") or "",
        phase=phase,
        labels=labels,
        env=env,
        command=command,
        exit_code=exit_code,
        deleting=meta.get("deletionTimestamp") is not None,
        preempted=status.get("reason") == "Preempted",
        pool=labels.get(POOL_LABEL, "default"),
        volumes=volumes,
        init_uris=init_uris,
        container=container,
        tolerations=list(spec.get("tolerations") or []),
        node_selector=dict(spec.get("nodeSelector") or {}),
        priority_class=spec.get("priorityClassName", "") or "",
        sidecar=sidecar,
    )


def node_from_json(obj: dict) -> Node:
    meta = obj.get("metadata", {})
    status = obj.get("status", {})
    spec = obj.get("spec", {})
    alloc = status.get("allocatable") or status.get("capacity") or {}
    labels = dict(meta.get("labels") or {})
    unschedulable = bool(spec.get("unschedulable", False))
    # a NotReady condition also makes the node unschedulable
    # (node-schedulable? api.clj:378)
    for cond in status.get("conditions") or []:
        if cond.get("type") == "Ready" and cond.get("status") != "True":
            unschedulable = True
    return Node(
        name=meta.get("name", ""),
        mem=parse_mem_mb(alloc.get("memory", 0)),
        cpus=parse_cpu(alloc.get("cpu", 0)),
        gpus=float(alloc.get("nvidia.com/gpu", 0) or 0),
        pool=labels.get(POOL_LABEL, "default"),
        labels=labels,
        schedulable=not unschedulable,
    )


def event_from_json(obj: dict) -> dict:
    """CoreV1Event -> plain dict (the event watch api.clj:333 feeds
    diagnostics, not the state machine)."""
    meta = obj.get("metadata", {})
    involved = obj.get("involvedObject", {})
    return {
        "name": meta.get("name", ""),
        "reason": obj.get("reason", ""),
        "message": obj.get("message", ""),
        "type": obj.get("type", ""),
        "involved_kind": involved.get("kind", ""),
        "involved_name": involved.get("name", ""),
    }


# ---------------------------------------------------------------------------

class WatchGone(Exception):
    """HTTP 410: the requested resourceVersion fell out of the window."""


class HttpKube(KubeApi):
    """KubeApi over a real apiserver (or an HTTP-level stand-in)."""

    def __init__(self, base_url: str, namespace: str = "cook",
                 token: Optional[str] = None,
                 token_path: Optional[str] = None,
                 ca_path: Optional[str] = None,
                 insecure: bool = False,
                 timeout_s: float = 30.0,
                 watch_backoff_s: tuple[float, float] = (0.1, 5.0)):
        self.base_url = base_url.rstrip("/")
        self.namespace = namespace
        self._token = token
        self._token_path = token_path
        self.timeout_s = timeout_s
        self.watch_backoff_s = watch_backoff_s
        self._stopping = threading.Event()
        self._watch_threads: list[threading.Thread] = []
        # watch-fed snapshots: once a pod/node watch is live, list_*()
        # serves from its object cache instead of re-LISTing the
        # apiserver on every scheduler cycle (the reference's offers are
        # likewise synthesized from watch state, compute_cluster.clj:48)
        self._cache: dict[str, dict] = {}
        self._cache_ready: dict[str, threading.Event] = {}
        self._cache_lock = threading.Lock()
        # names whose DELETED event arrived recently: blocks the
        # create_pod write-through from resurrecting a pod that was
        # created and deleted before the POST returned
        self._recent_deletes: dict[str, float] = {}
        self._ctx: Optional[ssl.SSLContext] = None
        if self.base_url.startswith("https"):
            if insecure:
                self._ctx = ssl._create_unverified_context()
            else:
                self._ctx = ssl.create_default_context(cafile=ca_path)

    # -- plumbing ------------------------------------------------------
    def _headers(self) -> dict:
        h = {"Accept": "application/json",
             "Content-Type": "application/json"}
        token = self._token
        if token is None and self._token_path and \
                os.path.exists(self._token_path):
            with open(self._token_path) as f:
                token = f.read().strip()
        if token:
            h["Authorization"] = f"Bearer {token}"
        return h

    def _request(self, method: str, path: str, body: Optional[dict] = None,
                 timeout: Optional[float] = None):
        req = urllib.request.Request(
            self.base_url + path,
            data=json.dumps(body).encode() if body is not None else None,
            headers=self._headers(), method=method)
        return urllib.request.urlopen(
            req, timeout=timeout or self.timeout_s, context=self._ctx)

    def _json(self, method: str, path: str, body: Optional[dict] = None,
              max_429_retries: int = 4):
        """One JSON request, honoring apiserver 429 + Retry-After
        backpressure with bounded retries (the priority-and-fairness
        production failure mode of kubernetes/api.clj-class clients)."""
        attempt = 0
        while True:
            try:
                with self._request(method, path, body) as resp:
                    return json.loads(resp.read().decode())
            except urllib.error.HTTPError as e:
                if e.code != 429 or attempt >= max_429_retries or \
                        self._stopping.is_set():
                    raise
                retry_after = 1.0
                try:
                    retry_after = float(e.headers.get("Retry-After", 1))
                except (TypeError, ValueError):
                    pass
                attempt += 1
                logger.info("apiserver 429; retrying in %.1fs "
                            "(attempt %d)", retry_after, attempt)
                time.sleep(min(retry_after, 30.0))

    # -- CRUD (api.clj:1048,1088) --------------------------------------
    def _pods_path(self) -> str:
        return f"/api/v1/namespaces/{self.namespace}/pods"

    def list_pods(self) -> list[Pod]:
        if self._cache_ready.get("pods", threading.Event()).is_set():
            with self._cache_lock:
                return list(self._cache["pods"].values())
        data = self._json("GET", self._pods_path())
        return [pod_from_json(i) for i in data.get("items", [])]

    def list_nodes(self) -> list[Node]:
        if self._cache_ready.get("nodes", threading.Event()).is_set():
            with self._cache_lock:
                return list(self._cache["nodes"].values())
        data = self._json("GET", "/api/v1/nodes")
        return [node_from_json(i) for i in data.get("items", [])]

    def create_pod(self, pod: Pod) -> None:
        try:
            self._json("POST", self._pods_path(),
                       pod_to_json(pod, self.namespace))
        except urllib.error.HTTPError as e:
            if e.code == 409:        # already exists: launch retry, fine
                return
            raise
        # write through to the watch cache so the very next offers
        # cycle already counts this pod's consumption (the ADDED event
        # will overwrite with the server's view); a DELETED that already
        # streamed for this name wins — don't resurrect a phantom
        with self._cache_lock:
            cache = self._cache.get("pods")
            if cache is not None and pod.name not in cache \
                    and pod.name not in self._recent_deletes:
                cache[pod.name] = pod

    def delete_pod(self, name: str) -> None:
        try:
            with self._request("DELETE", f"{self._pods_path()}/{name}"):
                pass
        except urllib.error.HTTPError as e:
            if e.code == 404:        # already gone
                return
            raise
        with self._cache_lock:
            cache = self._cache.get("pods")
            if cache is not None and name in cache:
                cache[name].deleting = True

    # -- watches (api.clj:200,281,333) ---------------------------------
    def watch_pods(self, cb: WatchCallback) -> None:
        self._spawn_watch("pods", self._pods_path(), pod_from_json, cb)

    def watch_nodes(self, cb: WatchCallback) -> None:
        self._spawn_watch("nodes", "/api/v1/nodes", node_from_json, cb)

    def watch_events(self, cb: Callable[[str, dict], None]) -> None:
        self._spawn_watch(
            "events", f"/api/v1/namespaces/{self.namespace}/events",
            event_from_json, cb, diff_deletes=False)

    def stop(self) -> None:
        self._stopping.set()

    def _spawn_watch(self, kind: str, path: str, translate, cb,
                     diff_deletes: bool = True) -> None:
        t = threading.Thread(
            target=self._watch_loop,
            args=(kind, path, translate, cb, diff_deletes),
            name=f"kube-watch-{kind}", daemon=True)
        t.start()
        self._watch_threads.append(t)

    # one full list -> diff -> callbacks; returns (resourceVersion, seen)
    def _relist(self, path: str, translate, cb, known: dict,
                diff_deletes: bool):
        data = self._json("GET", path)
        rv = data.get("metadata", {}).get("resourceVersion", "0")
        seen = {}
        for item in data.get("items", []):
            obj = translate(item)
            name = item.get("metadata", {}).get("name", "")
            seen[name] = obj
            cb("added" if name not in known else "modified", obj)
        if diff_deletes:
            for name, obj in known.items():
                if name not in seen:
                    cb("deleted", obj)
        with self._cache_lock:
            self._recent_deletes.clear()   # relist supersedes tombstones
        return rv, seen

    def _watch_loop(self, kind: str, path: str, translate, cb,
                    diff_deletes: bool) -> None:
        backoff_lo, backoff_hi = self.watch_backoff_s
        backoff = backoff_lo
        rv: Optional[str] = None
        known: dict = {}
        # Intentional infinite watch-reconnect loop, not a bounded
        # retry: shutdown-aware via _stopping, honors Retry-After on
        # 429, resets backoff on clean EOF. RetryPolicy's bounded
        # attempts/deadline semantics do not fit a lifelong watch.
        while not self._stopping.is_set():  # cookcheck: disable=R6
            try:
                if rv is None:
                    rv, known = self._relist(path, translate, cb, known,
                                             diff_deletes)
                    if kind in ("pods", "nodes"):
                        with self._cache_lock:
                            self._cache[kind] = known
                        self._cache_ready.setdefault(
                            kind, threading.Event()).set()
                rv = self._stream_watch(path, rv, translate, cb, known)
                backoff = backoff_lo     # clean EOF: reconnect from rv
            except WatchGone:
                logger.info("kube %s watch: resourceVersion expired, "
                            "relisting", kind)
                rv = None                # 410: full relist
            except TimeoutError:
                continue                 # quiet watch: resume from rv
            except urllib.error.HTTPError as e:
                if self._stopping.is_set():
                    return
                if e.code == 429:
                    # watch-establishment throttled: honor Retry-After
                    # and resume from rv — the cache stays warm
                    try:
                        wait = float(e.headers.get("Retry-After", 1))
                    except (TypeError, ValueError):
                        wait = 1.0
                    logger.info("kube %s watch throttled; retrying in "
                                "%.1fs", kind, wait)
                    time.sleep(min(wait, 30.0))
                    continue
                logger.warning("kube %s watch HTTP error (%s); "
                               "reconnecting in %.1fs", kind, e, backoff)
                time.sleep(backoff)
                backoff = min(backoff * 2, backoff_hi)
                rv = None
            except Exception as e:
                if self._stopping.is_set():
                    return
                logger.warning("kube %s watch error (%s); reconnecting "
                               "in %.1fs", kind, e, backoff)
                time.sleep(backoff)
                backoff = min(backoff * 2, backoff_hi)
                rv = None                # conservatively relist after errors

    def _stream_watch(self, path: str, rv: str, translate, cb,
                      known: dict) -> str:
        """Consume one streaming watch connection until EOF; returns the
        last delivered resourceVersion so the caller reconnects without
        a gap. Mutates `known` (the per-watch object cache used for
        relist diffing). Raises WatchGone on 410."""
        query = (f"?watch=true&resourceVersion={rv}"
                 f"&allowWatchBookmarks=true")
        try:
            resp = self._request("GET", path + query,
                                 timeout=self.timeout_s)
        except urllib.error.HTTPError as e:
            if e.code == 410:
                raise WatchGone()
            raise
        with resp:
            try:
                for raw in resp:
                    if self._stopping.is_set():
                        return rv
                    line = raw.strip()
                    if not line:
                        continue
                    ev = json.loads(line)
                    etype = ev.get("type", "")
                    obj = ev.get("object", {})
                    if etype == "ERROR":
                        if obj.get("code") == 410:
                            raise WatchGone()
                        raise RuntimeError(f"watch ERROR event: {obj}")
                    new_rv = obj.get("metadata", {}).get("resourceVersion")
                    if etype != "BOOKMARK":
                        name = obj.get("metadata", {}).get("name", "")
                        tobj = translate(obj)
                        if etype == "DELETED":
                            with self._cache_lock:
                                known.pop(name, None)
                                if len(self._recent_deletes) > 4096:
                                    self._recent_deletes.clear()
                                self._recent_deletes[name] = time.time()
                            cb("deleted", tobj)
                        else:
                            first = name not in known
                            with self._cache_lock:
                                known[name] = tobj
                            cb("added" if first and etype == "ADDED"
                               else "modified", tobj)
                    if new_rv:
                        rv = new_rv      # advance only after delivery
            except TimeoutError:
                # idle watch: keep the progress made on this connection
                # so the reconnect doesn't replay delivered events
                pass
        return rv
