"""The port's network agent (cook_tpu_torch.agent) against cook_tpu's.

Both packages build their scheduler with `build_scheduler` from one
config (one cluster of kind "agent" with an agent token, resident match,
pipeline depth 0, statuses applied inline), serve it with an ApiServer
and register three in-process `AgentDaemon`s of their own package in a
fixed order: cook_tpu on JAX's CPU backend, the port with
`device="cpu"`. Clocks and uuids are pinned as in
tests/test_torch_server.py, and cycles are driven by hand. After each
cycle the scenario waits until every launched task is terminal (the
sleeper of cycle 2 only running), so the next cycle sees the same
offers in both runs. Then the sleeper's daemon is cut off (heartbeats
stop, its posts fail) and the liveness clock advanced past the lease:
its task fails mea culpa and is retried on a survivor. The runs must
launch the same {job: hostname} pairs cycle by cycle, end in the same
states, exit codes and instance reasons, and answer GET /jobs/<uuid>
with the same bodies apart from WALL_CLOCK_FIELDS.

Also, as operators run it: `python -m cook_tpu_torch.rest.server
--device cpu` with two `python -m cook_tpu_torch.agent` processes,
jobs submitted through `python -m cook_tpu_torch.cli`, one agent
SIGKILLed while it runs a task: every job succeeds, the lost task on
the survivor.
"""
import contextlib
import importlib
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
import uuid
import zlib
from pathlib import Path

from tests.torch_coord_harness import WALL

ROOT = Path(__file__).resolve().parent.parent
TOKEN = "hunter2"
USERS = ("u0", "u1", "u2")
HOSTS = ("a0", "a1", "a2")
# fields drawn at random per request (the trace id) or per run (the
# ports the daemons' file servers listen on, inside the output url)
WALL_CLOCK_FIELDS = ("traceparent", "output_url")


def strip(x):
    if isinstance(x, dict):
        return {k: strip(v) for k, v in x.items()
                if k not in WALL_CLOCK_FIELDS}
    if isinstance(x, list):
        return [strip(v) for v in x]
    return x


def wait_until(fn, timeout=30.0, interval=0.02, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = fn()
        if v:
            return v
        time.sleep(interval)
    raise AssertionError(f"{what} not met within {timeout} s")


@contextlib.contextmanager
def pinned(root):
    """time.time and the store's clock read WALL; uuid4 counts per
    thread role (tests/test_torch_server.py: the consumer thread makes
    task ids while the main thread records spans)."""
    model = importlib.import_module(f"{root}.state.model")
    counters = {}
    lock = threading.Lock()

    def uuid4():
        name = threading.current_thread().name
        role = 0 if name == "MainThread" or name.startswith("Thread-") \
            else zlib.crc32(re.sub(r"[0-9]+", "", name).encode())
        with lock:
            n = counters[role] = counters.get(role, 0) + 1
        return uuid.UUID(int=role << 80 | n)

    saved = (uuid.uuid4, time.time)
    uuid.uuid4, time.time = uuid4, (lambda: WALL)
    model.set_clock(lambda: WALL)
    try:
        yield
    finally:
        uuid.uuid4, time.time = saved
        model.reset_clock()


def config(**sched):
    return {"clusters": [{"kind": "agent", "name": "agents",
                          "agent_heartbeat_timeout_s": 10.0}],
            "auth": {"scheme": "header", "agent_token": TOKEN},
            "scheduler": {"pipeline_depth": 0, "status_shards": 0,
                          **sched}}


def job_specs():
    """23 jobs of three users, then the sleeper (first in its cycle by
    priority): every sixth job exits 3 (two attempts), the rest run
    `true`."""
    specs = []
    for i in range(23):
        specs.append({"uuid": str(uuid.UUID(int=(1 << 64) + i)),
                      "command": "exit 3" if i % 6 == 5 else "true",
                      "mem": 256.0, "cpus": 1.0, "max_retries": 2,
                      "user": USERS[i % 3]})
    specs.append({"uuid": str(uuid.UUID(int=(1 << 64) + 23)),
                  "command": "sleep 1", "mem": 256.0, "cpus": 1.0,
                  "max_retries": 1, "priority": 100, "user": "u0"})
    return specs


TERMINAL = ("SUCCESS", "FAILED")


def scenario(root, sandboxes):
    """One run under package `root`. Returns the trace."""
    server_mod = importlib.import_module(f"{root}.rest.server")
    daemon_mod = importlib.import_module(f"{root}.agent.daemon")
    shutil.rmtree(sandboxes, ignore_errors=True)
    specs = job_specs()
    uuids = [s["uuid"] for s in specs]
    trace = []
    with pinned(root):
        kw = {"device": "cpu"} if root == "cook_tpu_torch" else {}
        store, coord, api = server_mod.build_scheduler(config(), **kw)
        server = server_mod.ApiServer(api).start()
        (cluster,) = coord.clusters.all()
        now = [1000.0]
        cluster.liveness._clock = lambda: now[0]
        daemons = []
        try:
            for h in HOSTS:
                # start() returns once registered: a fixed host order
                daemons.append(daemon_mod.AgentDaemon(
                    server.url, hostname=h, mem=4096.0, cpus=4.0,
                    sandbox_root=str(sandboxes / h),
                    heartbeat_interval_s=0.1, agent_token=TOKEN).start())
            assert list(cluster.agents) == list(HOSTS)

            def post(batch):
                for user in USERS:
                    jobs = [{k: v for k, v in s.items() if k != "user"}
                            for s in batch if s["user"] == user]
                    if jobs:
                        r = api.handle("POST", "/jobs", {}, {"jobs": jobs},
                                       {"x-cook-user": user})
                        assert r.status == 201, r.body

            seen = {}

            def launches():
                new = {}
                for k, u in enumerate(uuids):
                    job = store.get_job(u)
                    if job is None:
                        continue
                    n = seen.get(u, 0)
                    for inst in job.instances[n:]:
                        new.setdefault(k, []).append(inst.hostname)
                    seen[u] = len(job.instances)
                return new

            def settled(running_ok=()):
                for u in uuids:
                    job = store.get_job(u)
                    for inst in (job.instances if job else ()):
                        st = inst.status.name
                        if st in TERMINAL:
                            continue
                        if u in running_ok and st == "RUNNING":
                            continue
                        return False
                return True

            def cycle(running_ok=()):
                coord.match_cycle("default")
                coord.drain_resident("default")
                trace.append(("cycle", launches()))
                wait_until(lambda: settled(running_ok),
                           what="launched tasks terminal")

            post(specs[:23])
            cycle()
            post(specs[23:])
            cycle(running_ok=(uuids[23],))
            sleeper = store.get_job(uuids[23])
            assert [i.status.name for i in sleeper.instances] == ["RUNNING"]
            victim = HOSTS.index(sleeper.instances[0].hostname)
            d = daemons[victim]
            # cut off: heartbeats stop and every post to the server
            # fails, while its task runs on
            d._partitioned.set()
            d._stop.set()
            now[0] += 11.0
            survivors = [h for k, h in enumerate(HOSTS) if k != victim]
            wait_until(lambda: all(
                cluster.liveness._leases[h].last_seen == now[0]
                for h in survivors), what="survivors heartbeat")
            trace.append(("dead", cluster.check_agents()))
            for _ in range(4):
                cycle()
            for u in uuids:
                job = store.get_job(u)
                trace.append(("job", u, job.state.name, bool(job.success),
                              [(i.status.name, i.hostname, i.reason_code,
                                i.exit_code) for i in job.instances]))
            for k, u in enumerate(uuids):
                r = api.handle("GET", f"/jobs/{u}", {}, None,
                               {"x-cook-user": USERS[k % 3]
                                if k < 23 else "u0"})
                trace.append(("GET /jobs", r.status, strip(r.body)))
        finally:
            for d in daemons:
                d._partitioned.set()
                d.stop()
            server.stop()
            if api.ingest is not None:
                api.ingest.stop()
            coord.stop()
    return trace


def _first_diff(got, ref) -> str:
    for k, (a, b) in enumerate(zip(got, ref)):
        if a != b:
            return f"entry {k}: port {a!r} != cook_tpu {b!r}"
    return f"lengths: port {len(got)} != cook_tpu {len(ref)}"


def test_agents_equal_cook_tpu(tmp_path):
    ref = scenario("cook_tpu", tmp_path / "sandboxes")
    got = scenario("cook_tpu_torch", tmp_path / "sandboxes")
    cycles = [t[1] for t in ref if t[0] == "cycle"]
    # 12 slots a cycle on three hosts; the exit-3 jobs retried, the
    # sleeper's lost task on a survivor
    assert sum(len(c) for c in cycles[:2]) == 24
    dead = next(t[1] for t in ref if t[0] == "dead")
    assert len(dead) == 1
    jobs = {t[1]: t for t in ref if t[0] == "job"}
    sleeper = jobs[str(uuid.UUID(int=(1 << 64) + 23))]
    assert sleeper[2:4] == ("COMPLETED", True)
    assert [(i[0], i[2]) for i in sleeper[4]] == [("FAILED", 5000),
                                                  ("SUCCESS", None)]
    assert sleeper[4][1][1] != dead[0]
    failed = [t for t in jobs.values() if not t[3]]
    assert len(failed) == 3 and all(
        [(i[0], i[2], i[3]) for i in t[4]] == [("FAILED", 1003, 3)] * 2
        for t in failed)
    assert all(t[1] == 200 for t in ref if t[0] == "GET /jobs")
    assert got == ref, _first_diff(got, ref)


# -- as operators run it ----------------------------------------------
def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    env["HOME"] = str(tmp_path)
    return env


def _spawn_agent(url, hostname, tmp_path):
    return subprocess.Popen(
        [sys.executable, "-m", "cook_tpu_torch.agent", "--coordinator",
         url, "--hostname", hostname, "--mem", "1000", "--cpus", "1",
         "--sandbox-root", str(tmp_path / hostname),
         "--heartbeat-interval", "0.3", "--agent-token", TOKEN],
        env=_env(tmp_path), cwd=str(tmp_path),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def _cli(url, tmp_path, *argv):
    proc = subprocess.run(
        [sys.executable, "-m", "cook_tpu_torch.cli", "--url", url,
         "--user", "alice", *argv], env=_env(tmp_path),
        cwd=str(tmp_path), capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_python_m_server_agents_and_cli_survive_an_agent_sigkill(
        tmp_path):
    from cook_tpu_torch.client import JobClient

    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "clusters": [{"kind": "agent", "name": "agents",
                      "agent_heartbeat_timeout_s": 2.0}],
        "auth": {"scheme": "header", "agent_token": TOKEN},
        "scheduler": {"match_interval_s": 0.1}}))
    server = subprocess.Popen(
        [sys.executable, "-m", "cook_tpu_torch.rest.server", "--device",
         "cpu", "--port", str(port), "--config", str(cfg)],
        env=_env(tmp_path), cwd=str(tmp_path),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    procs = [server]
    try:
        def listening():
            assert server.poll() is None, server.stderr.read()
            try:
                urllib.request.urlopen(url + "/info", timeout=2).close()
                return True
            except OSError:
                return False
        wait_until(listening, timeout=120, interval=0.2, what="listen")

        def hosts():
            with urllib.request.urlopen(url + "/debug", timeout=5) as r:
                d = json.loads(r.read())
            return sum(c.get("hosts", 0) for c in d["clusters"].values())
        for k, h in enumerate(("agent-a", "agent-b")):
            procs.append(_spawn_agent(url, h, tmp_path))
            wait_until(lambda: hosts() == k + 1, timeout=60,
                       interval=0.1, what=f"{h} registered")
        client = JobClient(url, user="alice")
        quick = [_cli(url, tmp_path, "submit", "--mem", "64", "echo",
                      "hi").strip() for _ in range(2)]
        sleepers = [_cli(url, tmp_path, "submit", "--mem", "64",
                         "--max-retries", "1", "sleep", "3").strip()
                    for _ in range(2)]
        for u in quick + sleepers:
            assert len(u) == 36, u
        wait_until(lambda: all(client.query(u).status == "running"
                               for u in sleepers), timeout=60,
                   interval=0.1, what="sleepers running")
        on = {client.query(u).instances[0].hostname: u for u in sleepers}
        assert set(on) == {"agent-a", "agent-b"}
        procs[2].send_signal(signal.SIGKILL)
        procs[2].wait(timeout=10)
        out = _cli(url, tmp_path, "wait", *quick, *sleepers,
                   "--timeout", "60")
        assert out.count("success") == 4, out
        victim = client.query(on["agent-b"])
        assert [(i.hostname, i.status) for i in victim.instances] == [
            ("agent-b", "failed"), ("agent-a", "success")]
        assert victim.instances[0].reason_code == 5000
        assert client.query(on["agent-a"]).instances[0].status == \
            "success"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait(timeout=10)
        server.stderr.close()


# the status lines of tasks that report exit codes, folded by the
# port's native consume library built as toolchains that default to
# _FORTIFY_SOURCE=3 build it (Ubuntu 24.04's g++): glibc then checks
# each snprintf's stated size against the allocation it writes into
_FOLD_CHILD = r"""
import subprocess, sys
so = sys.argv[1] + "/libconsume.so"
subprocess.run(["g++", "-O2", "-D_FORTIFY_SOURCE=3", "-std=c++17",
                "-shared", "-fPIC", "-pthread", "-o", so,
                "cook_tpu_torch/native/consume.cpp"], check=True)
from cook_tpu_torch import native
from cook_tpu_torch.native import consumefold as cf
native.build = lambda name: so
rows = [(b"t%d" % k, b',"s":"failed","r":', 1003 if k % 2 else None,
         k == 1, k if k % 3 else None) for k in range(7)]
rows.append((b"t7", b',"s":"failed","r":', 1003, False, 3))
assert cf.native_available()
got = cf.fold_status_lines(b'{"t":', b"}\n", rows)
assert got == cf._fold_status_py(b'{"t":', b"}\n", rows), got
print("OK")
"""


def test_native_status_lines_with_exit_codes_under_fortify_3(tmp_path):
    proc = subprocess.run([sys.executable, "-c", _FOLD_CHILD,
                           str(tmp_path)], cwd=str(ROOT), env=_env(tmp_path),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-2000:])
    assert proc.stdout.strip() == "OK"
