"""Parity harness for the port's coordinator and resident pool.

Each scenario is written once, against a namespace of one package's
classes (`package("cook_tpu")` or `package("cook_tpu_torch")`), and run
under both: cook_tpu on JAX's CPU backend with its defaults
(`use_pallas=False`, as its own tests run it), the port with
`device="cpu"` (its plain PyTorch versions). `run` pins the clocks and
the uuids, so the two runs see the same submit times and task ids, and
records a trace: per cycle the launched `{job index: hostname}` and the
matched count, per rebalance the preempted job indices, and at the end
every job's state and instances. The tests assert the traces equal.
"""
from __future__ import annotations

import importlib
import itertools
import threading
import time
import uuid
from types import SimpleNamespace

import numpy as np

_NAMES = {
    "backends.base": ("ClusterRegistry",),
    "backends.mock": ("MockCluster", "MockHost"),
    "scheduler.coordinator": ("Coordinator", "SchedulerConfig",
                              "RebalancerParams",
                              "EstimatedCompletionConfig"),
    "scheduler.data_locality": ("DataLocalityCosts",),
    "scheduler.resident": ("ResidentPool", "_NeedResync"),
    "state.limits": ("QuotaStore", "RateLimiter", "ShareStore"),
    "state.model": ("Group", "InstanceStatus", "Job", "JobState"),
    "state.pools": ("DruMode", "Pool", "PoolRegistry"),
    "state.store": ("JobStore",),
}

# the fixed wall clock both runs see (seconds since the epoch)
WALL = 1_700_000_000.0


def package(root: str) -> SimpleNamespace:
    ns = {"root": root, "torch": root == "cook_tpu_torch"}
    for mod, names in _NAMES.items():
        m = importlib.import_module(f"{root}.{mod}")
        for n in names:
            ns[n] = getattr(m, n)
    ns["coord_kw"] = {"device": "cpu"} if ns["torch"] else {}
    return SimpleNamespace(**ns)


def fetch_state(pkg, rp) -> dict:
    """The pool's device state as numpy, in the reference's layout."""
    if pkg.torch:
        from cook_tpu_torch.scheduler.resident import state_to_numpy
        return state_to_numpy(rp.state)
    import jax
    return jax.tree.map(np.asarray, rp.state)


class Sim:
    """One scenario run: builds the package's objects, numbers the jobs
    it makes, and records the trace."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.jobs: list = []
        self.index: dict[str, int] = {}
        self.trace: list = []
        self._seen: dict[str, int] = {}
        self.clusters: list = []
        self.coords: list = []

    # -- construction ---------------------------------------------------
    def mkjob(self, user="alice", mem=100, cpus=1, uuid_=None, **kw):
        job = self.pkg.Job(uuid=uuid_ or str(uuid.uuid4()), user=user,
                           command="true", mem=mem, cpus=cpus, **kw)
        self.index[job.uuid] = len(self.jobs)
        self.jobs.append(job)
        return job

    def group(self, **kw):
        return self.pkg.Group(uuid=str(uuid.uuid4()), **kw)

    def host(self, name, **kw):
        return self.pkg.MockHost(name, **kw)

    def build(self, hosts=None, runtime_fn=None, n_hosts=2, store_kw=None,
              **kw):
        p = self.pkg
        store = p.JobStore(**(store_kw or {}))
        cluster = p.MockCluster(hosts or [
            p.MockHost(f"h{i}", mem=1000, cpus=16) for i in range(n_hosts)
        ], runtime_fn=runtime_fn)
        reg = p.ClusterRegistry()
        reg.register(cluster)
        coord = p.Coordinator(store, reg, **kw, **p.coord_kw)
        self.clusters.append(cluster)
        self.coords.append(coord)
        return store, cluster, coord

    # -- recording ------------------------------------------------------
    def launches(self) -> dict:
        """{job index: hostname} of instances not recorded before."""
        new = {}
        for i, job in enumerate(self.jobs):
            n = self._seen.get(job.uuid, 0)
            for inst in job.instances[n:]:
                new.setdefault(i, []).append(inst.hostname)
            self._seen[job.uuid] = len(job.instances)
        return new

    def cycle(self, coord, pool=None, drain=False):
        stats = coord.match_cycle(pool)
        if drain:
            coord.drain_resident()
        self.trace.append(("cycle", stats.matched, self.launches()))
        return stats

    def rebalance(self, coord, pool=None):
        res = coord.rebalance_cycle(pool)
        preempted = sorted(
            self.index[j.uuid] for j in self.jobs
            if any(i.preempted for i in j.instances))
        self.trace.append(("rebalance", res["preempted"], res["placed"],
                           [self.index.get(u) for u, _ in
                            res.get("decisions", [])], preempted))
        return res

    def note(self, *what):
        self.trace.append(("note",) + what)

    def final(self) -> list:
        return [(j.state.name, bool(j.success),
                 [(i.status.name, i.hostname, i.reason_code,
                   bool(i.preempted), list(i.ports or ()))
                  for i in j.instances]) for j in self.jobs]

    def stop(self):
        for c in self.coords:
            c.stop()


def run(scenario, root: str):
    """Run `scenario(sim)` under package `root` with pinned clocks and
    uuids; returns (trace, final states)."""
    pkg = package(root)
    counter = itertools.count(1)
    lock = threading.Lock()

    def uuid4():
        with lock:
            return uuid.UUID(int=next(counter))

    model = importlib.import_module(f"{root}.state.model")
    saved = (uuid.uuid4, time.time)
    uuid.uuid4, time.time = uuid4, (lambda: WALL)
    model.set_clock(lambda: WALL)   # the store's clock (now_ms)
    sim = Sim(pkg)
    try:
        scenario(sim)
        return sim.trace, sim.final()
    finally:
        sim.stop()
        uuid.uuid4, time.time = saved
        model.reset_clock()


def assert_state_matches_rebuild(sim, coord, pool="default"):
    """tests/test_resident.py's invariant, for either package: after any
    event sequence, the delta-maintained device state describes the
    same problem as a fresh rebuild from the store (same multiset of
    valid pending and running rows, same host availability)."""
    pkg = sim.pkg
    rp = coord._resident[pool]
    try:
        rp.flush()
        if not rp.reconcile_hosts():
            rp.resync()
    except pkg._NeedResync:
        rp.resync()
    live = fetch_state(pkg, rp)
    fresh = pkg.ResidentPool(coord, pool, synchronous=True)
    ref = fetch_state(pkg, fresh)

    def rows(state, block, key_fields):
        v = state[block]["valid"]
        return {tuple(round(float(state[block][f][i]), 4)
                      for f in key_fields) for i in np.flatnonzero(v)}

    pend_key = ("user", "mem", "cpus", "gpus", "priority", "ports")
    run_key = ("user", "mem", "cpus", "priority")
    assert rows(live, "pend", pend_key) == rows(ref, "pend", pend_key)
    assert rows(live, "run", run_key) == rows(ref, "run", run_key)
    common = sorted(rp.host_ids.keys() & fresh.host_ids.keys())
    li = [rp.host_ids[h] for h in common]
    fi = [fresh.host_ids[h] for h in common]
    for f in ("mem", "cpus", "gpus"):
        np.testing.assert_allclose(live["host"][f][li],
                                   ref["host"][f][fi], atol=1e-3)
    for h in rp.host_ids.keys() - fresh.host_ids.keys():
        i = rp.host_ids[h]
        assert live["host"]["mem"][i] <= 1e-3
        assert live["host"]["cpus"][i] <= 1e-3
    assert not (fresh.host_ids.keys() - rp.host_ids.keys())


def assert_parity(scenario):
    """The scenario's trace and final states under cook_tpu equal the
    port's, exactly."""
    ref = run(scenario, "cook_tpu")
    got = run(scenario, "cook_tpu_torch")
    assert got[0] == ref[0], _first_diff(got[0], ref[0])
    assert got[1] == ref[1], _first_diff(got[1], ref[1])
    return got


def _first_diff(got, ref) -> str:
    for k, (a, b) in enumerate(zip(got, ref)):
        if a != b:
            return f"entry {k}: port {a!r} != cook_tpu {b!r}"
    return f"lengths: port {len(got)} != cook_tpu {len(ref)}"
