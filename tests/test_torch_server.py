"""The port's scheduler server (cook_tpu_torch.rest.server) against
cook_tpu's.

Both packages build their scheduler with `build_scheduler` from one
config dict (64 mock hosts in two pools, resident match on, pipeline
depth 0, statuses applied inline for a fixed order): cook_tpu on JAX's CPU backend with `use_pallas: false`, the
port with `device="cpu"` (its plain PyTorch versions) and `use_pallas`
as true, false and "auto" (the port has no such switch, so all three
must give the same result). Clocks are pinned as in
tests/torch_coord_harness.py, and uuids count per thread role (the
resident consumer thread makes task ids while the main thread records
spans: one shared counter would number them as the threads' timing
falls). The same jobs are posted through
`CookApi.handle`, and for the port also over HTTP through one
`ApiServer`; match and rebalance cycles are driven by hand. The runs
must launch the same (job, host) pairs cycle by cycle, preempt the same
jobs, end in the same job states, and answer GET /jobs/<uuid>,
/unscheduled and /usage with the same bodies, apart from the fields
named in WALL_CLOCK_FIELDS.

Also: boot without a card raises unless asked for the CPU; a shard
claim beyond the visible devices warns and runs on one device; a
read-only replica opens no log writer; the federation placement falls
back to the coordinator's device; the build wiring matches cook_tpu's;
and `python -m cook_tpu_torch.rest.server --device cpu` runs a job
posted over HTTP to success, exits on SIGTERM and never imports jax or
cook_tpu.
"""
import importlib
import itertools
import json
import logging
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import uuid
import zlib
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from tests.torch_coord_harness import WALL

ROOT = Path(__file__).resolve().parent.parent
POOLS = ("default", "b")
HOSTS_PER_POOL = 32
# the bodies' fields that carry a trace id drawn at random per request
WALL_CLOCK_FIELDS = ("traceparent",)


def config(use_pallas=False, **over):
    cfg = {
        "pools": [{"name": p} for p in POOLS],
        "clusters": [{"kind": "mock", "name": f"m-{p}", "pool": p,
                      "hosts": HOSTS_PER_POOL, "host_mem": 4096.0,
                      "host_cpus": 8.0} for p in POOLS],
        "auth": {"scheme": "header"},
        "scheduler": {"use_pallas": use_pallas, "pipeline_depth": 0,
                      "status_shards": 0,
                      "rebalancer_safe_dru_threshold": 0.0,
                      "rebalancer_min_dru_diff": 0.05},
    }
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(cfg.get(k), dict):
            cfg[k] = {**cfg[k], **v}
        else:
            cfg[k] = v
    return cfg


def _jobs(rng, n, user_prefix, users, pool, seq):
    out = {}
    for _ in range(n):
        u = f"{user_prefix}{int(rng.integers(0, users))}"
        out.setdefault(u, []).append({
            "uuid": str(uuid.UUID(int=(1 << 64) + next(seq))),
            "command": "true", "pool": pool,
            "mem": float(rng.uniform(128, 1024)),
            "cpus": float(rng.uniform(0.5, 2.0)),
            "max_retries": 2})
    return out


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items()
                if k not in WALL_CLOCK_FIELDS}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


class _Http:
    """CookApi.handle's signature over HTTP to an ApiServer."""

    def __init__(self, url):
        self.url = url

    def handle(self, method, path, query, body, headers):
        qs = "&".join(f"{k}={v}" for k, vs in query.items() for v in vs)
        req = urllib.request.Request(
            self.url + path + (f"?{qs}" if qs else ""),
            data=json.dumps(body).encode() if body is not None else None,
            method=method, headers={"Content-Type": "application/json",
                                    **headers})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                status, raw = r.status, r.read()
        except urllib.error.HTTPError as e:
            status, raw = e.code, e.read()
        return SimpleNamespace(status=status,
                               body=json.loads(raw) if raw else None)


def scenario(root, use_pallas=False, transport="handle"):
    """One run of the server scenario under package `root`, clocks and
    uuids pinned. Returns the trace: per cycle the launched (job uuid,
    hostname) pairs, per rebalance the preempted jobs, then every job's
    state and instances and the REST bodies."""
    server_mod = importlib.import_module(f"{root}.rest.server")
    model = importlib.import_module(f"{root}.state.model")
    counters = {}
    lock = threading.Lock()

    def uuid4():
        # one counter per thread role, so that no uuid depends on how
        # two threads' calls interleave (the consumer thread makes task
        # ids while the main thread records the cycle's spans). The
        # main thread and the HTTP request threads, which run while it
        # waits on them, share role 0; a pool of workers shares its role
        name = threading.current_thread().name
        role = 0 if name == "MainThread" or name.startswith("Thread-") \
            else zlib.crc32(re.sub(r"[0-9]+", "", name).encode())
        with lock:
            n = counters[role] = counters.get(role, 0) + 1
        return uuid.UUID(int=role << 80 | n)

    saved = (uuid.uuid4, time.time)
    uuid.uuid4, time.time = uuid4, (lambda: WALL)
    model.set_clock(lambda: WALL)
    kw = {"device": "cpu"} if root == "cook_tpu_torch" else {}
    store, coord, api = server_mod.build_scheduler(config(use_pallas), **kw)
    server = None
    trace = []
    try:
        front = api
        if transport == "http":
            server = server_mod.ApiServer(api).start()
            front = _Http(server.url)
        clusters = list(coord.clusters.all())
        for p in POOLS:
            coord.shares.set("default", p, mem=8192.0, cpus=16.0)
        rng = np.random.default_rng(0)
        seq = itertools.count()
        uuids = []

        def post(batch, route="/jobs"):
            for user, specs in batch.items():
                for i in range(0, len(specs), 50):
                    resp = front.handle("POST", route, {},
                                        {"jobs": specs[i:i + 50]},
                                        {"x-cook-user": user})
                    assert resp.status == 201, resp.body
                    uuids.extend(s["uuid"] for s in specs[i:i + 50])

        seen = {}

        def launches():
            new = []
            for u in uuids:
                job = store.get_job(u)
                n = seen.get(u, 0)
                new += [(u, i.hostname) for i in job.instances[n:]]
                seen[u] = len(job.instances)
            return new

        def cycles(n, advance_s):
            for _ in range(n):
                for p in POOLS:
                    coord.match_cycle(p)
                    coord.drain_resident(p)
                    # match_cycle returns the stats of the last cycle the
                    # consumer thread had consumed by then: this cycle's
                    # or the one before, as the threads' timing falls.
                    # Drained, the pool's consumed stats are this cycle's
                    matched = coord._resident[p].stats_last["matched"]
                    trace.append(("cycle", p, matched, launches()))
                for c in clusters:
                    c.advance(advance_s)

        # the greedy users fill both pools past capacity (the mock's
        # tasks run 60 s), then the poor users arrive
        post(_jobs(rng, 260, "greedy", 3, "default", seq))
        post(_jobs(rng, 240, "greedy", 3, "b", seq), route="/jobs/bulk")
        cycles(3, 5.0)
        post(_jobs(rng, 40, "poor", 4, "default", seq))
        post(_jobs(rng, 20, "poor", 4, "b", seq), route="/jobs/bulk")
        for p in POOLS:
            res = coord.rebalance_cycle(p)
            coord.drain_resident(p)
            victims = sorted(u for u in uuids
                             if any(i.preempted for i in
                                    store.get_job(u).instances))
            trace.append(("rebalance", p, res["preempted"], victims))
        cycles(3, 20.0)
        for u in uuids:
            job = store.get_job(u)
            trace.append(("job", u, job.state.name, bool(job.success),
                          [(i.status.name, i.hostname, i.reason_code,
                            bool(i.preempted)) for i in job.instances]))
        for u in uuids:
            r = front.handle("GET", f"/jobs/{u}", {}, None,
                             {"x-cook-user": "greedy0"})
            trace.append(("GET /jobs", r.status, _strip(r.body)))
        pending = [u for u in uuids
                   if store.get_job(u).state.name == "WAITING"]
        for u in pending[:20] + uuids[:5]:
            r = front.handle("GET", "/unscheduled", {"job": [u]}, None,
                             {"x-cook-user": "greedy0"})
            trace.append(("GET /unscheduled", r.status, _strip(r.body)))
        for user in ("greedy0", "greedy1", "greedy2", "poor0", "poor3"):
            r = front.handle("GET", "/usage", {"user": [user]}, None,
                             {"x-cook-user": user})
            trace.append(("GET /usage", r.status, _strip(r.body)))
    finally:
        if server is not None:
            server.stop()
        if api.ingest is not None:
            api.ingest.stop()
        coord.stop()
        uuid.uuid4, time.time = saved
        model.reset_clock()
    return trace


@pytest.fixture(scope="module")
def reference():
    return scenario("cook_tpu")


def _first_diff(got, ref) -> str:
    for k, (a, b) in enumerate(zip(got, ref)):
        if a != b:
            return f"entry {k}: port {a!r} != cook_tpu {b!r}"
    return f"lengths: port {len(got)} != cook_tpu {len(ref)}"


@pytest.mark.parametrize("transport", ["handle", "http"])
@pytest.mark.parametrize("use_pallas", [False, True, "auto"])
def test_server_equals_cook_tpu(reference, use_pallas, transport):
    got = scenario("cook_tpu_torch", use_pallas, transport)
    kinds = [t[0] for t in reference]
    assert sum(len(t[3]) for t in reference if t[0] == "cycle") > 300
    assert any(t[2] for t in reference if t[0] == "rebalance")
    assert kinds.count("GET /unscheduled") == 25
    assert got == reference, _first_diff(got, reference)


def test_server_trace_does_not_depend_on_the_consumer_timing(
        reference, monkeypatch):
    """The resident consumer thread finishing each cycle before
    match_cycle reads the pool's last consumed stats (the order a loaded
    machine can give; the harness once recorded match_cycle's lagging
    stats and then differed from cook_tpu by a cycle) leaves the trace
    equal to cook_tpu's."""
    from cook_tpu_torch.scheduler.shards import InOrderShards

    submit = InOrderShards.submit

    def submit_and_wait(self, key, *args, **kwargs):
        submit(self, key, *args, **kwargs)
        with self._idle:
            assert self._idle.wait_for(lambda: self._inflight == 0, 60)

    monkeypatch.setattr(InOrderShards, "submit", submit_and_wait)
    got = scenario("cook_tpu_torch", False, "http")
    assert got == reference, _first_diff(got, reference)


def test_boot_without_a_card_raises():
    import torch
    from cook_tpu_torch.rest.server import build_scheduler
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_scheduler(config())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_scheduler(config(), device="cuda")


def test_shard_claim_beyond_the_visible_devices_runs_on_one(caplog):
    from cook_tpu_torch.rest.server import build_scheduler
    with caplog.at_level(logging.WARNING, logger="cook_tpu.rest.access"):
        store, coord, api = build_scheduler(
            config(scheduler={"resident_shard_devices": 2}), device="cpu")
    try:
        assert "resident_shard_devices=2 but only 0 devices" in caplog.text
        for p in POOLS:
            rp = coord._resident[p]
            assert rp.device.type == "cpu"
        resp = api.handle("POST", "/jobs", {}, {"jobs": [
            {"uuid": str(uuid.uuid4()), "command": "true", "mem": 64,
             "cpus": 1}]}, {"x-cook-user": "alice"})
        assert resp.status == 201
        coord.match_cycle("default")
        coord.drain_resident("default")
        assert len(store.running_instances("default")) == 1
    finally:
        api.ingest.stop()
        coord.stop()


def test_shard_claim_the_visible_devices_meet_runs_sharded(monkeypatch):
    """A claim the visible devices meet gives every pool a working
    sharded resident pool (two CPU shards stand in for two cards)."""
    import torch
    from cook_tpu_torch.rest import server
    monkeypatch.setattr(server, "_devices",
                        lambda device, n: [torch.device("cpu")] * n)
    store, coord, api = server.build_scheduler(
        config(scheduler={"resident_shard_devices": 2}), device="cpu")
    try:
        for p in POOLS:
            rp = coord._resident[p]
            assert rp.mesh is not None and rp.mesh.devices.size == 2
            assert len(rp.state["host"]) == 2
        resp = api.handle("POST", "/jobs", {}, {"jobs": [
            {"uuid": str(uuid.uuid4()), "command": "true", "mem": 64,
             "cpus": 1}]}, {"x-cook-user": "alice"})
        assert resp.status == 201
        coord.match_cycle("default")
        coord.drain_resident("default")
        assert len(store.running_instances("default")) == 1
    finally:
        api.ingest.stop()
        coord.stop()


def test_federation_placement_falls_back_to_the_coordinator_device(caplog):
    from cook_tpu_torch.rest.server import build_scheduler
    fed = {"group": "g0", "groups": {"g0": {
        "pools": list(POOLS), "url": "http://127.0.0.1:1",
        "devices": [0, 1]}}}
    with caplog.at_level(logging.WARNING, logger="cook_tpu.rest.access"):
        store, coord, api = build_scheduler(
            config(url="http://127.0.0.1:1", federation=fed),
            device="cpu")
    try:
        assert caplog.text.count("visible; using default device") == \
            len(POOLS)
        assert {coord._resident[p].device.type for p in POOLS} == {"cpu"}
    finally:
        api.ingest.stop()
        coord.stop()


def test_read_only_opens_no_log_writer(tmp_path):
    from cook_tpu_torch.rest.server import build_scheduler
    log_path = str(tmp_path / "events.log")
    store, coord, api = build_scheduler(config(log_path=log_path),
                                        device="cpu")
    try:
        assert store._log is not None
    finally:
        api.ingest.stop()
        coord.stop()
        store._log.close()
    store, coord, api = build_scheduler(config(log_path=log_path),
                                        read_only=True, device="cpu")
    try:
        assert store._log is None and api.ingest is None
    finally:
        coord.stop()


def _wiring(root, cfg):
    kw = {"device": "cpu"} if root == "cook_tpu_torch" else {}
    _, coord, api = importlib.import_module(
        f"{root}.rest.server").build_scheduler(cfg, **kw)
    try:
        return {
            "pools": sorted(p.name for p in coord.pools.all()),
            "clusters": sorted((c.name, type(c).__name__)
                               for c in coord.clusters.all()),
            "pipeline_depth": coord.config.pipeline_depth,
            "resident": sorted(getattr(coord, "_resident", {})),
            "heartbeat_timeout_s": coord.heartbeats.timeout_s,
            "overload": coord.overload is not None,
            "ingest": api.ingest is not None,
            "max_jobs_considered": coord.config.max_jobs_considered,
        }
    finally:
        if api.ingest is not None:
            api.ingest.stop()
        coord.stop()


WIRING = {
    "kube_and_extra_pool": {"clusters": [{"kind": "kube", "name": "k1",
                                          "hosts": 2}],
                            "pools": [{"name": "extra"}]},
    "agent_cluster": {"dev_mode": True,
                      "clusters": [{"kind": "agent", "name": "agents"}],
                      "scheduler": {"launch_fanout_workers": 3}},
    "settings": {"clusters": [{"kind": "mock", "hosts": 1}],
                 "scheduler": {"pipeline_depth": 3,
                               "heartbeat_timeout_s": 42.0,
                               "overload_enabled": False,
                               "max_jobs_considered": 8192},
                 "ingest_workers": 0},
    "legacy_cycle": {"clusters": [{"kind": "mock", "hosts": 2}],
                     "scheduler": {"resident_match": False}},
}


@pytest.mark.parametrize("name", sorted(WIRING))
def test_build_wiring_equals_cook_tpu(name):
    assert _wiring("cook_tpu_torch", WIRING[name]) == \
        _wiring("cook_tpu", WIRING[name])


# the server as `python -m` runs it; on SIGTERM, before the process
# ends (at once, as the default action would end it), the jax and
# cook_tpu modules it imported
_BOOT_CHILD = r"""
import json, os, runpy, signal, sys
sys.argv = ["cook_tpu_torch.rest.server"] + sys.argv[1:]
def on_term(signum, frame):
    bad = sorted(n for n in sys.modules
                 if n == "jax" or n.startswith("jax.") or n == "jaxlib"
                 or n == "cook_tpu" or n.startswith("cook_tpu."))
    print("BAD " + json.dumps(bad), flush=True)
    os._exit(0)
signal.signal(signal.SIGTERM, on_term)
runpy.run_module("cook_tpu_torch.rest.server", run_name="__main__")
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_python_m_server_runs_a_posted_job_and_exits_on_sigterm(tmp_path):
    port = _free_port()
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "clusters": [{"kind": "local", "name": "local",
                      "sandbox_root": str(tmp_path / "sandboxes"),
                      "file_server_port": 0}],
        "log_path": str(tmp_path / "events.log"),
        "scheduler": {"match_interval_s": 0.1}}))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-c", _BOOT_CHILD, "--device", "cpu", "--port",
         str(port), "--config", str(cfg)], cwd=str(tmp_path), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                urllib.request.urlopen(url + "/info", timeout=2).close()
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read()
                assert time.monotonic() < deadline, "server never listened"
                time.sleep(0.2)
        u = str(uuid.uuid4())
        req = urllib.request.Request(
            url + "/jobs", method="POST",
            data=json.dumps({"jobs": [{"uuid": u, "command": "echo hi",
                                       "mem": 64, "cpus": 1}]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 201
        state = None
        while time.monotonic() < deadline:
            with urllib.request.urlopen(f"{url}/jobs/{u}", timeout=10) as r:
                body = json.loads(r.read())
            state = body["state"]
            if state == "success":
                break
            time.sleep(0.2)
        assert state == "success", body
        assert body["instances"][0]["status"] == "success"
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out, err = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
    assert proc.returncode == 0, err[-2000:]
    assert out.splitlines()[-1] == "BAD []", out[-2000:]
