"""The port's kube path over HTTP and its leader failover.

`HttpKube` against each package's API-server stand-in
(`backends/kube/standin.py`): both packages build their scheduler with
`build_scheduler` and one cluster of kind "kube" whose `kube_url` is
their own stand-in over four nodes (cook_tpu on JAX's CPU backend, the
port with `device="cpu"`), clocks and uuids pinned, cycles driven by
hand, the pods started and finished by `KubeletSim.step` between
cycles. Midway the watch streams drop, a running pod vanishes and the
event history expires: the resumed watch gets 410 Gone, relists, and
the vanished pod's instance fails. The runs must launch the same
{job: node} pairs cycle by cycle and end in the same states.

Then the failover story on the port: two `python -m
cook_tpu_torch.rest.server --device cpu` processes race for a Lease on
the port's stand-in and share one durable log; one `python -m
cook_tpu_torch.agent` carries both URLs. A job submitted to the standby
follows its leader hint; the leader is SIGKILLed while that job runs;
the standby takes the lease, replays the log, adopts the running task
(which ends a success, never retried), places the jobs the old leader
left waiting without waiting for a periodic resync, and runs a new job
on the agent.
"""
import importlib
import json
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from tests.test_torch_agents import _env, _free_port, pinned, wait_until

ROOT = Path(__file__).resolve().parent.parent
NODES = 4


def kube_scenario(root):
    server_mod = importlib.import_module(f"{root}.rest.server")
    kube = importlib.import_module(f"{root}.backends.kube")
    standin_mod = importlib.import_module(f"{root}.backends.kube.standin")
    standin = standin_mod.ApiServerStandIn(kube.FakeKube([
        kube.Node(f"n{i}", mem=1000.0, cpus=4.0) for i in range(NODES)]))
    sim = standin_mod.KubeletSim(standin.fake, runtime_s=1.0)
    uuids = [f"00000000-0000-0001-0000-{i:012d}" for i in range(24)]
    trace = []
    try:
        with pinned(root):
            kw = {"device": "cpu"} if root == "cook_tpu_torch" else {}
            store, coord, api = server_mod.build_scheduler({
                "clusters": [{"kind": "kube", "name": "k1",
                              "kube_url": standin.url,
                              "max_synthetic_pods": 0}],
                "scheduler": {"pipeline_depth": 0, "status_shards": 0}},
                **kw)
            (cluster,) = coord.clusters.all()
            cluster.initialize()
            try:
                for user in ("u0", "u1"):
                    r = api.handle("POST", "/jobs", {}, {"jobs": [
                        {"uuid": u, "command": "true", "mem": 100.0,
                         "cpus": 1.0, "max_retries": 3}
                        for k, u in enumerate(uuids) if k % 2 ==
                        int(user[1])]}, {"x-cook-user": user})
                    assert r.status == 201, r.body
                seen = {}
                clock = [0.0]

                def instances():
                    return [i for u in uuids
                            for i in store.get_job(u).instances]

                def launches():
                    new = {}
                    for k, u in enumerate(uuids):
                        job = store.get_job(u)
                        for inst in job.instances[seen.get(u, 0):]:
                            new.setdefault(k, []).append(inst.hostname)
                        seen[u] = len(job.instances)
                    return new

                def pods_up():
                    names = {p.name for p in standin.fake.list_pods()}
                    return all(i.task_id in names for i in instances()
                               if i.status.name not in ("SUCCESS",
                                                        "FAILED"))

                def statuses(*ok):
                    return all(i.status.name in ok for i in instances())

                def cycle(finish=True):
                    coord.match_cycle("default")
                    coord.drain_resident("default")
                    trace.append(("cycle", launches()))
                    wait_until(pods_up, what="pods created")
                    sim.step(clock[0])           # bind and start
                    wait_until(lambda: statuses("RUNNING", "SUCCESS",
                                                "FAILED"),
                               what="instances running")
                    if finish:
                        clock[0] += 1.0
                        sim.step(clock[0])       # succeed
                        wait_until(lambda: statuses("SUCCESS", "FAILED"),
                                   what="instances terminal")

                cycle()
                cycle(finish=False)
                running = sorted(i.task_id for i in instances()
                                 if i.status.name == "RUNNING")
                victim = running[0]
                standin.drop_streams()
                standin.fake.vanish_pod(victim)
                standin.expire_history()
                wait_until(lambda: store.get_instance(victim).status.name
                           == "FAILED", what="relist sees the deletion")
                clock[0] += 1.0
                sim.step(clock[0])
                wait_until(lambda: statuses("SUCCESS", "FAILED"),
                           what="instances terminal")
                trace.append(("vanished", uuids.index(
                    store.task_to_job[victim])))
                while any(store.get_job(u).state.name != "COMPLETED"
                          for u in uuids):
                    assert len(trace) < 12, trace
                    cycle()
                for u in uuids:
                    job = store.get_job(u)
                    trace.append(("job", u, job.state.name,
                                  bool(job.success),
                                  [(i.status.name, i.hostname,
                                    i.reason_code) for i in
                                   job.instances]))
            finally:
                if api.ingest is not None:
                    api.ingest.stop()
                coord.stop()
                cluster.api.stop()
    finally:
        standin.close()
    return trace


def test_http_kube_equals_cook_tpu():
    ref = kube_scenario("cook_tpu")
    got = kube_scenario("cook_tpu_torch")
    cycles = [t[1] for t in ref if t[0] == "cycle"]
    # four 1-cpu pods a 4-cpu node, then the other 8
    assert [len(c) for c in cycles[:2]] == [4 * NODES, 8]
    vanished = next(t[1] for t in ref if t[0] == "vanished")
    job = [t for t in ref if t[0] == "job"][vanished]
    assert job[2:4] == ("COMPLETED", True) and len(job[4]) == 2
    assert job[4][0][0] == "FAILED"
    assert got == ref


# -- the failover story --------------------------------------------------
def _req(url, method="GET", body=None, timeout=5):
    data = json.dumps(body).encode() if body is not None else None
    r = urllib.request.Request(url, data=data, method=method,
                               headers={"Content-Type": "application/json",
                                        "x-cook-user": "root"})
    with urllib.request.urlopen(r, timeout=timeout) as resp:
        raw = resp.read()
        return json.loads(raw) if raw else None


def _try(fn):
    try:
        return fn()
    except (OSError, ValueError):
        return None


def _leader(urls):
    for u in urls:
        info = _try(lambda: _req(u + "/info"))
        if info and info.get("is-leader"):
            return u
    return None


def _hosts(url):
    d = _req(url + "/debug")
    return sum(c.get("hosts", 0) for c in d.get("clusters", {}).values())


def _spawn_server(tmp_path, port, lease_url):
    cfg = tmp_path / f"server{port}.json"
    cfg.write_text(json.dumps({
        "port": port, "url": f"http://127.0.0.1:{port}", "dev_mode": True,
        "clusters": [{"kind": "agent", "name": "agents",
                      "agent_heartbeat_timeout_s": 5.0}],
        "leader_lease_url": lease_url, "leader_lease_duration_s": 2.0,
        "log_path": str(tmp_path / "shared-eventlog"),
        "scheduler": {"match_interval_s": 0.1}}))
    return subprocess.Popen(
        [sys.executable, "-m", "cook_tpu_torch.rest.server", "--device",
         "cpu", "--config", str(cfg)], env=_env(tmp_path),
        cwd=str(tmp_path), stdout=open(tmp_path / f"server{port}.log",
                                       "wb"),
        stderr=subprocess.STDOUT)


def test_leader_failover_on_the_port(tmp_path):
    from cook_tpu_torch.backends.kube.standin import ApiServerStandIn
    from cook_tpu_torch.client import JobClient

    lease = ApiServerStandIn()
    ports = [_free_port(), _free_port()]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    procs = []
    try:
        procs.append(_spawn_server(tmp_path, ports[0], lease.url))
        wait_until(lambda: _leader(urls[:1]), timeout=120, interval=0.2,
                   what="first leader")
        procs.append(_spawn_server(tmp_path, ports[1], lease.url))
        wait_until(lambda: _try(lambda: _req(urls[1] + "/info")),
                   timeout=120, interval=0.2, what="standby up")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cook_tpu_torch.agent",
             "--coordinator", ",".join(urls), "--hostname", "ha-agent",
             "--mem", "1024", "--cpus", "4", "--sandbox-root",
             str(tmp_path / "sandboxes"), "--heartbeat-interval", "0.3"],
            env=_env(tmp_path), cwd=str(tmp_path),
            stdout=open(tmp_path / "agent.log", "wb"),
            stderr=subprocess.STDOUT))
        wait_until(lambda: _try(lambda: _hosts(urls[0])) == 1,
                   timeout=60, interval=0.1, what="agent registered")
        assert _leader(urls) == urls[0]
        # the standby refuses the agent channel with a leader hint
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(urls[1] + "/agents/heartbeat", "POST",
                 {"hostname": "probe", "tasks": []})
        assert e.value.code == 503
        assert json.loads(e.value.read())["leader"] == urls[0]

        client = JobClient(urls[1], user="root")
        running = client.submit(command="sleep 3", mem=64, cpus=1)
        assert client.url == urls[0]          # the hint followed
        wait_until(lambda: _req(f"{urls[0]}/jobs/{running}")["status"]
                   == "running", timeout=60, what="job running")
        # two jobs that need the whole agent wait behind the sleeper
        waiting = client.submit_jobs([{"command": "echo w", "mem": 64,
                                       "cpus": 4} for _ in range(2)])
        time.sleep(0.5)
        assert [client.query(u).status for u in waiting] == \
            ["waiting"] * 2

        procs[0].send_signal(signal.SIGKILL)
        procs[0].wait(timeout=10)
        wait_until(lambda: _leader(urls[1:]), timeout=60, interval=0.2,
                   what="standby takes over")
        wait_until(lambda: _try(lambda: _hosts(urls[1])) == 1,
                   timeout=60, interval=0.1, what="agent re-registered")
        fresh = _req(urls[1] + "/jobs", "POST", {"jobs": [
            {"command": "echo two", "mem": 64, "cpus": 1}]})["jobs"][0]
        # the jobs the old leader left waiting are placed from the
        # replayed log at once, not at the resident pool's periodic
        # resync (512 cycles, 51 s at this interval)
        for u in (running, *waiting, fresh):
            job = wait_until(
                lambda: (j := _try(lambda: _req(f"{urls[1]}/jobs/{u}")))
                and j["status"] == "completed" and j, timeout=25,
                interval=0.2, what=f"job {u} completes")
            assert job["state"] == "success", job
            assert [i["hostname"] for i in job["instances"]] == \
                ["ha-agent"]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait(timeout=10)
        lease.close()
