"""The port's clients against its server, held against cook_tpu's.

Each client of the port (`cook_tpu_torch.client.JobClient`, the `cs`
CLI, the native C++ client through its ctypes binding, Dask's
`CookCluster` and Spark's coarse backend) runs one scenario against the
port's server, built by `build_scheduler` with `device="cpu"` and served
by an ApiServer; the same scenario runs cook_tpu's client against
cook_tpu's server on JAX's CPU backend. Clocks and uuids are pinned
(tests/test_torch_agents.py) and cycles driven by hand on the mock
cluster, so the two runs must give equal answers: the same uuids,
states, instances, usage, exit codes, and the same `cs` stdout.
"""
import contextlib
import importlib
import io
from types import SimpleNamespace

import pytest

from tests.test_torch_agents import pinned, strip

USER = "alice"


def config():
    return {"clusters": [{"kind": "mock", "name": "m1", "hosts": 4,
                          "host_mem": 16000.0, "host_cpus": 16.0}],
            "auth": {"scheme": "header", "admins": ["admin"]},
            "scheduler": {"pipeline_depth": 0, "status_shards": 0}}


@contextlib.contextmanager
def stack(root):
    """`root`'s server on a free port, clocks and uuids pinned; yields
    the package's modules, the store, a hand-driven cycle and the url."""
    server_mod = importlib.import_module(f"{root}.rest.server")
    with pinned(root):
        kw = {"device": "cpu"} if root == "cook_tpu_torch" else {}
        store, coord, api = server_mod.build_scheduler(config(), **kw)
        server = server_mod.ApiServer(api).start()
        (cluster,) = coord.clusters.all()

        def cycle(advance_s=0.0):
            coord.match_cycle("default")
            coord.drain_resident("default")
            if advance_s:
                cluster.advance(advance_s)

        def mod(name):
            return importlib.import_module(f"{root}.{name}")

        try:
            yield SimpleNamespace(mod=mod, store=store, cycle=cycle,
                                  cluster=cluster, url=server.url)
        finally:
            server.stop()
            if api.ingest is not None:
                api.ingest.stop()
            coord.stop()


def _job(info):
    """A JobInfo as plain data."""
    return (info.uuid, info.user, info.status, info.state, info.command,
            info.mem, info.cpus,
            [(i.status, i.hostname, i.exit_code) for i in info.instances])


def jobclient(s):
    c = s.mod("client").JobClient(s.url, user=USER)
    out = []
    u1 = c.submit(command="echo hi", mem=64, cpus=1, name="cj")
    u2 = c.submit(command="sleep 99", mem=64, cpus=1)
    u3 = c.submit_jobs_bulk([{"command": "true", "mem": 32, "cpus": 0.5}
                             for _ in range(3)])
    out.append(("submitted", u1, u2, u3, _job(c.query(u1))))
    s.cycle()
    out.append(("running", [_job(j) for j in
                            c.list_jobs(states="running")]))
    out.append(("usage", strip(c.usage())))
    c.kill(u2)
    out.append(("killed", _job(c.query(u2))))
    s.cycle(120.0)
    out.append(("done", _job(c.wait_for_job(u1, timeout=5,
                                            poll_interval=0.05))))
    c.retry(u2, retries=3)
    out.append(("retried", _job(c.query(u2))))
    out.append(("jobs", [_job(j) for j in c.query_jobs([u1, u2, *u3])]))
    err = s.mod("client").JobClientError
    with pytest.raises(err) as e:
        c.submit(command="x", mem=-1)
    out.append(("error", e.value.status))
    return out


def cli(s):
    main = s.mod("cli").main
    out = []

    def run(*argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(["--url", s.url, "--user", USER, *argv])
        out.append((argv, rc, buf.getvalue()))
        return buf.getvalue().strip()

    u1 = run("submit", "--mem", "64", "echo", "hello")
    u2 = run("submit", "--mem", "100000", "big")
    run("show", u1)
    s.cycle()
    run("jobs", "--state", "waiting")
    run("why", u2)
    run("usage")
    s.cycle(120.0)
    run("wait", u1, "--timeout", "5")
    run("show", "--json", u1)
    u3 = run("submit", "sleep", "99")
    s.cycle()
    run("kill", u3)
    run("show", u3)
    run("retry", u3, "--retries", "3")
    run("jobs", "--state", "waiting+running+completed")
    return out


def native(s):
    njc = s.mod("native.jobclient")
    assert njc.available()
    host, port = s.url.replace("http://", "").split(":")
    out = []
    with njc.NativeJobClient(host, int(port), "carol",
                             timeout_ms=10000) as c:
        u1 = c.submit(command="echo native", mem=64, cpus=1, name="cppjob")
        u2 = c.submit_spec({"command": "t", "mem": 32, "cpus": 0.5,
                            "env": {"K": "v \"quoted\"\n"},
                            "labels": {"team": "tpu"}, "max_retries": 2})
        out.append(("query", strip(c.query(u1)), strip(c.query(u2))))
        s.cycle()
        out.append(("state", c.job_state(u1), c.job_state(u2)))
        c.kill(u2)
        s.cycle(120.0)
        out.append(("waited", strip(c.wait_for_job(u1, timeout_ms=5000,
                                                   poll_ms=50))))
        c.retry(u2, 3)
        out.append(("retried", c.job_state(u2), strip(c.query(u2))))
        with pytest.raises(njc.NativeClientError) as e:
            c.query("00000000-0000-0000-0000-000000000000")
        out.append(("error", str(e.value)))
    return out


def dask(s):
    dc = s.mod("integrations.dask_cook")
    spec = dc.WorkerSpec(scheduler_addr="tcp://sched:8786", mem=1024,
                         cpus=2)
    cluster = dc.CookCluster(s.url, scheduler_addr="tcp://sched:8786",
                             user="dask", worker_spec=spec)
    out = [("command", spec.command(), spec.job_spec())]
    cluster.scale(3)
    workers = cluster.worker_uuids()
    s.cycle()
    out.append(("scaled", workers,
                [s.store.get_job(u).state.name for u in workers]))
    cluster.scale(1)
    out.append(("down", cluster.worker_uuids(),
                [s.store.get_job(u).state.name for u in workers]))
    out.append(("adapt", cluster.adapt(minimum=1, maximum=3,
                                       queued_tasks=10),
                cluster.worker_uuids()))
    job = dc.CookJob(s.mod("client").JobClient(s.url, user="a"),
                     dc.WorkerSpec(scheduler_addr="tcp://s:1"))
    out.append(("job", job.status(), job.start(), job.status()))
    s.cycle()
    out.append(("job running", job.running()))
    job.close()
    cluster.close()
    out.append(("closed", job.status(), cluster.worker_uuids(),
                [s.store.get_job(u).state.name
                 for u in workers + [job.uuid]]))
    return out


def spark(s):
    sc = s.mod("integrations.spark_cook")
    conf = sc.SparkConf(driver_url="spark://CoarseGrainedScheduler@"
                                   "10.0.0.1:7077", max_cores=10,
                        cores_per_job=4)
    be = sc.CookSparkBackend(s.mod("client").JobClient(s.url,
                                                       user="sparky"),
                             conf)
    lost = []
    be.on_executor_lost = lost.append
    uuids = be.start()
    out = [("start", uuids, be.total_cores_requested)]
    s.cycle()
    jobs = [s.store.get_job(u) for u in uuids]
    out.append(("running", [(j.state.name, j.mem, j.priority,
                             j.instances[0].hostname) for j in jobs]))
    s.cluster.fail_task(jobs[0].instances[0].task_id)
    be.poll()
    out.append(("lost", list(lost), be.current_cores_limit()))
    out.append(("more", be.request_remaining_cores()))
    out.append(("total", be.request_total_executors(1)))
    out.append(("kill", be.kill_executors(["cook-2", "cook-99"])))
    s.cycle()
    be.poll()
    out.append(("after kill", sorted(be.jobs), be.current_cores_limit(),
                be.total_failures))
    be.stop()
    out.append(("stopped", [s.store.get_job(u).state.name
                            for u in uuids]))
    return out


CLIENTS = {"jobclient": jobclient, "cli": cli, "native": native,
           "dask": dask, "spark": spark}


def run(root, name):
    with stack(root) as s:
        return CLIENTS[name](s)


@pytest.mark.parametrize("name", sorted(CLIENTS))
def test_client_equals_cook_tpu(name):
    ref = run("cook_tpu", name)
    got = run("cook_tpu_torch", name)
    assert ref and got == ref
