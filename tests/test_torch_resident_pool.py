"""The port's ResidentPool against cook_tpu's, through the coordinator:
the scenarios of tests/test_resident.py, each run under both packages on
the CPU with pinned clocks and uuids (tests/torch_coord_harness.py).
Per cycle the launched {job index: hostname} must be equal, and at the
end every job's state and instances; the port's delta-maintained state
must equal a fresh rebuild where the reference's test checks that.
"""
import threading
import time

import numpy as np
import pytest

from tests.torch_coord_harness import (WALL, assert_parity,
                                       assert_state_matches_rebuild)


def _rebuild_check(t, coord):
    if t.pkg.torch:
        assert_state_matches_rebuild(t, coord)


def sc_basic(t):
    store, cluster, coord = t.build()
    coord.enable_resident()
    job = t.mkjob()
    store.create_jobs([job])
    t.cycle(coord)
    cluster.advance(120.0)
    t.cycle(coord)
    _rebuild_check(t, coord)


def sc_legacy_inline_pipelined(t):
    """Legacy, inline-resident and pipelined-resident launch the same
    job set (the reference checks the counts; the traces here hold the
    assignments too)."""
    for mode in ("legacy", "inline", "pipelined"):
        store, _, coord = t.build(n_hosts=4)
        if mode == "inline":
            coord.enable_resident()
        elif mode == "pipelined":
            coord.enable_resident(pipeline_depth=1)
        jobs = [t.mkjob(user=f"u{i % 3}", mem=50 + 10 * (i % 5), cpus=1)
                for i in range(40)]
        store.create_jobs(jobs)
        t.cycle(coord, drain=mode != "legacy")
        t.note(mode, sorted(t.index[j.uuid] % 40 for j in jobs
                            if j.state.name == "RUNNING"))


def sc_pipelined_vs_inline(t):
    for depth in (0, 1):
        store, _, coord = t.build(n_hosts=4)
        coord.enable_resident(pipeline_depth=depth)
        for c in range(4):
            jobs = [t.mkjob(user=f"u{(c * 7 + i) % 3}",
                            mem=50 + 10 * ((c + i) % 5), cpus=1)
                    for i in range(12)]
            store.create_jobs(jobs)
            t.cycle(coord)
        coord.drain_resident()
        t.note(depth, t.launches())
        if depth:
            _rebuild_check(t, coord)


def sc_failure_retry(t):
    fates = iter([(10.0, False, 1003), (10.0, True, None)])
    store, cluster, coord = t.build(runtime_fn=lambda spec: next(fates))
    coord.enable_resident()
    job = t.mkjob(max_retries=2)
    store.create_jobs([job])
    t.cycle(coord)
    cluster.advance(11)
    t.cycle(coord)   # novel-host: the retry lands on the other host
    cluster.advance(11)
    t.cycle(coord)
    _rebuild_check(t, coord)


def sc_kill_while_pending(t):
    store, _, coord = t.build()
    coord.enable_resident()
    jobs = [t.mkjob() for _ in range(5)]
    store.create_jobs(jobs)
    store.kill_job(jobs[0].uuid)
    t.cycle(coord)
    _rebuild_check(t, coord)


def sc_quota(t):
    quotas = t.pkg.QuotaStore()
    quotas.set("alice", "default", cpus=2)
    store, _, coord = t.build(quotas=quotas, n_hosts=4)
    coord.enable_resident()
    store.create_jobs([t.mkjob(cpus=1) for _ in range(6)])
    t.cycle(coord)


def sc_constraint_mask(t):
    hosts = [t.host("special", mem=1000, cpus=16, attributes={"rack": "a"}),
             t.host("other", mem=1000, cpus=16, attributes={"rack": "b"})]
    store, _, coord = t.build(hosts=hosts)
    coord.enable_resident()
    store.create_jobs([t.mkjob(constraints=[["rack", "EQUALS", "a"]]),
                       t.mkjob(constraints=[["rack", "EQUALS", "b"]]),
                       t.mkjob()])
    t.cycle(coord)


def sc_group_unique(t):
    store, _, coord = t.build(n_hosts=3)
    coord.enable_resident()
    g = t.group(name="g", host_placement={"type": "unique"})
    jobs = [t.mkjob(group=g.uuid) for _ in range(4)]
    store.create_jobs(jobs, groups=[g])
    t.cycle(coord)
    t.cycle(coord)


def sc_churn(t):
    """Random submit / kill / complete / retry churn; the port's state
    equals a fresh rebuild every third step."""
    rng = np.random.default_rng(7)
    fates = {}

    def runtime(spec):
        return fates.get(spec.job_uuid, (30.0, True, None))

    store, cluster, coord = t.build(
        n_hosts=6, runtime_fn=runtime,
        config=t.pkg.SchedulerConfig(max_jobs_considered=64))
    coord.enable_resident()
    live = []
    for step in range(12):
        jobs = [t.mkjob(user=f"u{int(rng.integers(0, 4))}",
                        mem=float(rng.integers(20, 200)),
                        cpus=float(rng.integers(1, 4)), max_retries=2)
                for _ in range(int(rng.integers(1, 8)))]
        for j in jobs:
            if rng.random() < 0.3:
                fates[j.uuid] = (float(rng.integers(5, 40)),
                                 bool(rng.random() < 0.5), 1003)
        store.create_jobs(jobs)
        live.extend(jobs)
        if live and rng.random() < 0.5:
            store.kill_job(live[int(rng.integers(0, len(live)))].uuid)
        t.cycle(coord)
        cluster.advance(float(rng.integers(0, 25)))
        if step % 3 == 2:
            t.cycle(coord)
            _rebuild_check(t, coord)
    for _ in range(10):
        t.cycle(coord)
        cluster.advance(50.0)


def sc_async_consumer(t):
    store, _, coord = t.build(n_hosts=4)
    coord.enable_resident(synchronous=False)
    store.create_jobs([t.mkjob() for _ in range(20)])
    t.cycle(coord, drain=True)
    t.cycle(coord, drain=True)   # must not double-launch


def sc_ports(t):
    store, _, coord = t.build(
        hosts=[t.host("h0", mem=1000, cpus=16, port_range=(31000, 31003))])
    coord.enable_resident()
    store.create_jobs([t.mkjob(ports=2) for _ in range(3)])
    t.cycle(coord)


def sc_host_set_change(t):
    store, cluster, coord = t.build(n_hosts=2)
    coord.enable_resident()
    store.create_jobs([t.mkjob(cpus=16) for _ in range(4)])
    t.cycle(coord)
    cluster.add_host(t.host("h-new", mem=4000, cpus=64))
    t.cycle(coord)   # generation bump: reconcile, then match


def sc_data_locality(t):
    hosts = [t.host("far", mem=1000, cpus=16),
             t.host("near", mem=1000, cpus=16)]
    store, _, coord = t.build(hosts=hosts)
    coord.data_locality = t.pkg.DataLocalityCosts(
        fetcher=lambda uuids: {u: {"near": 0.0, "far": 1.0} for u in uuids},
        weight=0.9)
    coord.enable_resident()
    jobs = [t.mkjob(datasets=[{"dataset": {"bucket": "b"}}])
            for _ in range(3)] + [t.mkjob()]
    coord.data_locality.update(jobs)
    store.create_jobs(jobs)
    t.cycle(coord)


def sc_estimated_completion(t):
    cfg = t.pkg.SchedulerConfig(
        estimated_completion=t.pkg.EstimatedCompletionConfig(
            expected_runtime_multiplier=1.0, host_lifetime_mins=30.0))
    hosts = [t.host("dying", mem=1000, cpus=16,
                    attributes={"host-start-time": str(WALL - 29 * 60)}),
             t.host("fresh", mem=1000, cpus=16,
                    attributes={"host-start-time": str(WALL)})]
    store, _, coord = t.build(hosts=hosts, config=cfg)
    coord.enable_resident()
    assert coord._resident["default"].with_est
    store.create_jobs([t.mkjob(expected_runtime_ms=10 * 60 * 1000)])
    t.cycle(coord)
    store.create_jobs([t.mkjob(), t.mkjob()])
    t.cycle(coord)


def sc_light_resync(t):
    store, cluster, coord = t.build(n_hosts=4)
    coord.enable_resident(resync_interval=8, full_resync_every=1000)
    store.create_jobs([t.mkjob() for _ in range(4)])
    t.cycle(coord)
    # missed creates and terminals: the listener is off meanwhile
    store._listeners.remove(coord._resident_listener)
    store.create_jobs([t.mkjob() for _ in range(3)])
    cluster.advance(120.0)
    store.add_listener(coord._resident_listener)
    for _ in range(11):   # across the resync_interval boundary
        t.cycle(coord)
    t.note(coord._resident["default"]._light_since_full)
    _rebuild_check(t, coord)


def sc_periodic_full_rebuild(t):
    store, cluster, coord = t.build(n_hosts=4)
    coord.enable_resident(resync_interval=4, full_resync_every=3)
    rp = coord._resident["default"]
    store.create_jobs([t.mkjob() for _ in range(8)])
    for _ in range(30):
        t.note(rp.resync_reason())
        t.cycle(coord)
        cluster.advance(2.0)
    t.note(rp._build_count)
    _rebuild_check(t, coord)


def sc_host_add_remove(t):
    hosts = [t.host(f"h{i}", mem=1000, cpus=16, attributes={"rack": "a"})
             for i in range(3)]
    store, cluster, coord = t.build(hosts=hosts)
    coord.enable_resident()
    rp = coord._resident["default"]
    jobs = [t.mkjob(cpus=16) for _ in range(3)]
    rack_b = t.mkjob(constraints=[["rack", "EQUALS", "b"]])
    store.create_jobs(jobs + [rack_b])
    t.cycle(coord)
    cluster.add_host(t.host("h-new", mem=2000, cpus=32,
                            attributes={"rack": "b"}))
    t.cycle(coord)
    t.cycle(coord)
    cluster.remove_host("h1")
    for _ in range(3):
        t.cycle(coord)
    cluster.add_host(t.host("h1", mem=1000, cpus=16))
    t.cycle(coord)
    store.create_jobs([t.mkjob(cpus=8) for _ in range(4)])
    t.cycle(coord)
    t.note(rp._build_count, rp._host_index_all["h1"])
    _rebuild_check(t, coord)


def _mesh_devices(t, n=8):
    """n shards: the JAX package's first n (virtual CPU) devices, the
    port's CPU device listed n times."""
    if t.pkg.torch:
        import torch
        return [torch.device("cpu")] * n
    import jax
    return jax.devices()[:n]


def _assert_sharded(t, rp, n=8):
    """The pool's host tensors really shard: n blocks, each on its own
    shard's device (the port), or spread over n devices (JAX)."""
    if t.pkg.torch:
        shards = list(rp.mesh.devices.flat)
        assert len(shards) == n
        for k in ("forb", "bonus"):
            assert [b.device for b in rp.state[k]] == shards
        assert [h["mem"].device for h in rp.state["host"]] == shards
        assert all(h[f].device == d for h, d in zip(rp.state["host"], shards)
                   for f in h)
    else:
        assert len(rp.state["host"]["mem"].sharding.device_set) == n


def _background_rebuild(t, devices=None):
    store, cluster, coord = t.build(n_hosts=4)
    coord.enable_resident(synchronous=True, background_rebuild=True,
                          resync_interval=4, full_resync_every=1,
                          devices=devices)
    rp = coord._resident["default"]
    gate, entered = threading.Event(), threading.Event()

    def hook(shadow):
        entered.set()
        assert gate.wait(10.0)

    rp._bg_build_hook = hook
    store.create_jobs([t.mkjob() for _ in range(4)])
    for _ in range(5):   # across the periodic-full boundary
        t.cycle(coord)
    assert entered.wait(5.0)
    t.note(rp.rebuilding(), rp._build_count)
    store.create_jobs([t.mkjob() for _ in range(3)])
    t.cycle(coord)
    doomed = t.mkjob(mem=10_000)   # unschedulable, stays WAITING
    store.create_jobs([doomed])
    t.cycle(coord)
    store.kill_job(doomed.uuid)
    gate.set()
    for _ in range(500):
        if rp.rebuild_ready():
            break
        time.sleep(0.01)
    assert rp.rebuild_ready()
    store.create_jobs([t.mkjob() for _ in range(2)])
    t.cycle(coord)   # swap + match in one cycle
    t.note(rp._build_count, rp._bg is None)
    cluster.advance(200.0)
    t.cycle(coord)
    _rebuild_check(t, coord)


def sc_background_rebuild(t):
    _background_rebuild(t)


def sc_background_rebuild_sharded(t):
    """The background rebuild of a pool sharded over 8 devices: the
    shadow is built sharded the same way and swapped in."""
    _background_rebuild(t, _mesh_devices(t))
    _assert_sharded(t, t.coords[-1]._resident["default"])


def sc_sharded_pool(t):
    """tests/test_resident.py::
    test_sharded_resident_pool_equals_single_device_oracle: ONE pool's
    host axis sharded over 8 devices launches what the single-device
    pool launches, unique-host groups included, and keeps scheduling
    across completions."""
    def scenario(coord, store):
        g = t.group(name="g", host_placement={"type": "unique"})
        jobs = [t.mkjob(user=f"u{i % 3}", mem=50 + 10 * (i % 5),
                        cpus=1 + (i % 3)) for i in range(24)]
        gjobs = [t.mkjob(group=g.uuid) for _ in range(4)]
        store.create_jobs(jobs + gjobs, groups=[g])
        t.cycle(coord)
        return jobs + gjobs, gjobs

    store_a, _, coord_a = t.build(n_hosts=6)
    coord_a.enable_resident()
    all_a, _ = scenario(coord_a, store_a)
    hosts_a = sorted(j.instances[0].hostname for j in all_a if j.instances)

    store_b, cluster_b, coord_b = t.build(n_hosts=6)
    coord_b.enable_resident(devices=_mesh_devices(t))
    all_b, gjobs_b = scenario(coord_b, store_b)
    hosts_b = sorted(j.instances[0].hostname for j in all_b if j.instances)
    assert hosts_a == hosts_b
    gh = [j.instances[0].hostname for j in gjobs_b if j.instances]
    assert len(gh) == len(set(gh)), gh   # unique placement held
    t.note(hosts_b, gh)
    cluster_b.advance(200.0)
    t.cycle(coord_b)
    _rebuild_check(t, coord_b)
    _assert_sharded(t, coord_b._resident["default"])


def sc_batched_resident(t):
    """The resident batched cycle (match_rounds), which the e2e bench
    takes at consider=8192."""
    store, cluster, coord = t.build(
        hosts=[t.host(f"h{i}", mem=4000, cpus=32) for i in range(4)],
        config=t.pkg.SchedulerConfig(max_jobs_considered=64,
                                     sequential_match_threshold=16))
    coord.enable_resident()
    store.create_jobs([t.mkjob(user=f"u{i % 5}", mem=50 + (i % 7) * 30,
                               cpus=1 + (i % 3)) for i in range(120)])
    for _ in range(3):
        t.cycle(coord)
        cluster.advance(30.0)
    _rebuild_check(t, coord)


SCENARIOS = {name[3:]: fn for name, fn in sorted(globals().items())
             if name.startswith("sc_")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_resident_pool_parity(name):
    assert_parity(SCENARIOS[name])


def test_pools_pinned_per_device():
    """Each pool's state lives on the device it was pinned to, and the
    coordinator's device is the default (the CPU has one device, so a
    second pinned device is tested only on a machine with two cards)."""
    import torch

    from cook_tpu_torch.state.pools import Pool, PoolRegistry
    from tests.torch_coord_harness import Sim, package
    t = Sim(package("cook_tpu_torch"))
    pools = PoolRegistry()
    pools.add(Pool(name="b"))
    store, _, coord = t.build(pools=pools)
    coord.enable_resident()
    coord.enable_resident("b", device="cpu")
    for name in ("default", "b"):
        rp = coord._resident[name]
        assert rp.device == torch.device("cpu")
        assert rp.state["host"]["mem"].device == torch.device("cpu")
    store.create_jobs([t.mkjob()])
    t.cycle(coord)
    t.stop()
