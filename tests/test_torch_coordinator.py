"""The port's Coordinator against cook_tpu's: the scenarios of
tests/test_coordinator.py (the legacy cycle, which re-tensorizes the
queue each cycle, the rebalancer and its DRU head), each run under both
packages on the CPU with pinned clocks and uuids
(tests/torch_coord_harness.py). Launches per cycle, preemptions and the
final job and instance states must be equal. Also: host arrays reach
the ops with JAX's x64-off dtypes (`device.to_device`).
"""
import numpy as np
import pytest

from tests.torch_coord_harness import assert_parity


def _gpu_pool(t, **cfg):
    p = t.pkg
    pools = p.PoolRegistry()
    pools.add(p.Pool(name="gpu", dru_mode=p.DruMode.GPU))
    config = p.SchedulerConfig(
        rebalancer=p.RebalancerParams(**cfg)) if cfg else None
    store, cluster, coord = t.build(
        hosts=[t.host("g0", mem=1000, cpus=64, gpus=8, pool="gpu")],
        pools=pools, config=config)
    coord.shares.set("default", "gpu", gpus=8.0, mem=1e6, cpus=1e6)
    return store, cluster, coord


def sc_submit_complete(t):
    store, cluster, coord = t.build()
    jobs = [t.mkjob(cpus=1, mem=10) for _ in range(40)]
    store.create_jobs(jobs)
    t.cycle(coord)
    t.cycle(coord)
    cluster.advance(61)
    t.cycle(coord)
    cluster.advance(120)
    t.cycle(coord)


def sc_failure_retry(t):
    fates = iter([(10.0, False, 1003), (10.0, True, None)])
    store, cluster, coord = t.build(runtime_fn=lambda spec: next(fates))
    store.create_jobs([t.mkjob(max_retries=2)])
    t.cycle(coord)
    cluster.advance(11)
    t.cycle(coord)
    cluster.advance(11)


def sc_fair_share(t):
    for resident in (False, True):
        store, _, coord = t.build(hosts=[t.host("h0", mem=100, cpus=4)])
        coord.shares.set("default", "default", mem=1000, cpus=1000)
        if resident:
            coord.enable_resident()
        store.create_jobs([t.mkjob(user="alice", mem=10, cpus=1)
                           for _ in range(10)]
                          + [t.mkjob(user="bob", mem=10, cpus=1)])
        t.cycle(coord)


def sc_quota(t):
    for resident in (False, True):
        quotas = t.pkg.QuotaStore()
        quotas.set("alice", "default", count=2, mem=1e9, cpus=1e9)
        store, _, coord = t.build(quotas=quotas)
        if resident:
            coord.enable_resident()
        store.create_jobs([t.mkjob() for _ in range(5)])
        t.cycle(coord)


def sc_unique_group(t):
    store, _, coord = t.build()
    g = t.group(user="alice", host_placement={"type": "unique"})
    jobs = [t.mkjob(group=g.uuid) for _ in range(3)]
    g.jobs = [j.uuid for j in jobs]
    store.create_jobs(jobs, groups=[g])
    t.cycle(coord)
    t.cycle(coord)


def sc_gpu_pool_rank(t):
    for resident in (False, True):
        store, _, coord = _gpu_pool(t)
        if resident:
            coord.enable_resident("gpu")
        store.create_jobs([
            t.mkjob(user="alice", mem=1, cpus=1, gpus=5.0, pool="gpu"),
            t.mkjob(user="bob", mem=800, cpus=32, gpus=1.0, pool="gpu")])
        t.cycle(coord, "gpu")
        store.create_jobs([
            t.mkjob(user="alice", mem=1, cpus=1, gpus=2.0, pool="gpu"),
            t.mkjob(user="bob", mem=1, cpus=1, gpus=2.0, pool="gpu")])
        t.cycle(coord, "gpu")


def sc_preemption_end_to_end(t):
    p = t.pkg
    for resident in (False, True):
        store, _, coord = t.build(
            hosts=[t.host("h0", mem=100, cpus=10)],
            config=p.SchedulerConfig(rebalancer=p.RebalancerParams(
                safe_dru_threshold=0.0, min_dru_diff=0.1,
                max_preemption=4)))
        coord.shares.set("default", "default", mem=100, cpus=10)
        if resident:
            coord.enable_resident()
        store.create_jobs([t.mkjob(user="greedy", mem=20, cpus=2)
                           for _ in range(5)])
        t.cycle(coord)
        store.create_jobs([t.mkjob(user="poor", mem=20, cpus=2)])
        t.cycle(coord)
        t.rebalance(coord)
        t.cycle(coord)


def sc_rebalancer_dru_queue(t):
    p = t.pkg
    store, _, coord = t.build(
        hosts=[t.host("h0", mem=100, cpus=10)],
        config=p.SchedulerConfig(rebalancer=p.RebalancerParams(
            safe_dru_threshold=0.0, min_dru_diff=0.1, max_preemption=1)))
    coord.shares.set("default", "default", mem=100.0, cpus=10.0)
    store.create_jobs([t.mkjob(user="greedy", mem=40, cpus=4)
                       for _ in range(2)]
                      + [t.mkjob(user="rich", mem=20, cpus=2, priority=95)])
    t.cycle(coord)
    store.create_jobs([t.mkjob(user="rich", mem=30, cpus=3, priority=90),
                       t.mkjob(user="poor", mem=30, cpus=3, priority=10)])
    t.cycle(coord)
    t.rebalance(coord)
    t.cycle(coord)


def sc_gpu_rebalancer(t):
    for poor_mem in (10, 500):   # preempts; then mem/cpu-infeasible
        store, _, coord = _gpu_pool(t, safe_dru_threshold=0.0,
                                    min_dru_diff=0.05, max_preemption=4)
        store.create_jobs([t.mkjob(user="greedy", mem=10, cpus=1, gpus=2.0,
                                   pool="gpu") for _ in range(4)])
        t.cycle(coord, "gpu")
        store.create_jobs([t.mkjob(user="poor", mem=poor_mem, cpus=1,
                                   gpus=2.0, pool="gpu")])
        t.cycle(coord, "gpu")
        t.rebalance(coord, "gpu")
        t.cycle(coord, "gpu")


def sc_port_assignment(t):
    for resident in (False, True):
        store, cluster, coord = t.build(
            hosts=[t.host("h0", mem=1000, cpus=16,
                          port_range=(31000, 31002))])
        if resident:
            coord.enable_resident()
        store.create_jobs([t.mkjob(ports=2), t.mkjob(ports=2), t.mkjob()])
        t.cycle(coord)
        cluster.advance(61)
        t.cycle(coord)


def sc_batched_audit(t):
    store, _, coord = t.build(
        hosts=[t.host(f"h{i}", mem=4000, cpus=32) for i in range(4)],
        config=t.pkg.SchedulerConfig(max_jobs_considered=64,
                                     sequential_match_threshold=16))
    store.create_jobs([t.mkjob(user=f"u{i % 5}", mem=50 + (i % 7) * 30,
                               cpus=1 + (i % 3)) for i in range(120)])
    t.cycle(coord)
    t.note(coord.metrics["match.default.head_inversions"],
           coord.metrics["match.default.head_exact"])


def sc_placement_failure(t):
    store, _, coord = t.build(hosts=[
        t.host("a", mem=1000, cpus=16, port_range=(31000, 30999)),
        t.host("b", mem=50, cpus=16, port_range=(31000, 31010))])
    job = t.mkjob(mem=100, ports=1)
    store.create_jobs([job])
    t.cycle(coord)
    pf = dict(job.last_placement_failure)
    pf.pop("at_ms")
    t.note(pf)


SCENARIOS = {name[3:]: fn for name, fn in sorted(globals().items())
             if name.startswith("sc_")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_coordinator_parity(name):
    assert_parity(SCENARIOS[name])


def test_use_pallas_defaults_on(monkeypatch):
    """The port's hand kernels are its path, always: its config has no
    switch to the plain walk (the reference's `use_pallas`, off there
    for a Pallas that no longer lowers on libtpu), and both the legacy
    and the resident cycle ask `rank_and_match` for the kernels (a CPU
    tensor then takes their plain versions)."""
    import dataclasses
    from cook_tpu_torch.ops import cycle as cycle_ops
    from cook_tpu_torch.scheduler.coordinator import SchedulerConfig
    from tests.torch_coord_harness import Sim, package

    assert "use_pallas" not in {
        f.name for f in dataclasses.fields(SchedulerConfig)}
    asked = []
    rank = cycle_ops.rank_and_match

    def spy(*a, **kw):
        asked.append(kw["use_kernel"])
        return rank(*a, **kw)

    monkeypatch.setattr(cycle_ops, "rank_and_match", spy)
    t = Sim(package("cook_tpu_torch"))
    store, _, coord = t.build()
    try:
        store.create_jobs([t.mkjob() for _ in range(3)])
        t.cycle(coord)
        coord.enable_resident()
        store.create_jobs([t.mkjob() for _ in range(3)])
        t.cycle(coord)
    finally:
        t.stop()
    assert asked == [True, True]
    assert sum(e[1] for e in t.trace) == 6


@pytest.mark.parametrize("dtype", [np.float64, np.int64, np.uint64,
                                   np.float32, np.int32, np.bool_])
def test_to_device_casts_as_jax(dtype):
    """Host arrays reach the port's ops with the dtype and the values
    `jnp.asarray` gives them with x64 off: f64 rounds to f32, i64 wraps
    to i32."""
    import jax.numpy as jnp

    from cook_tpu_torch.device import to_device
    rng = np.random.default_rng(3)
    if dtype == np.float64:
        a = rng.standard_normal(257) * 1e3
    elif dtype == np.bool_:
        a = rng.random(257) < 0.5
    else:
        info = np.iinfo(dtype) if dtype != np.float32 else None
        a = (rng.standard_normal(257).astype(np.float32) if info is None
             else rng.integers(0, min(info.max, 2 ** 40), 257,
                               dtype=np.int64).astype(dtype))
    want = np.asarray(jnp.asarray(a))
    got = to_device(a, "cpu").numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for x in (2.5, 7, True):
        assert to_device(x, "cpu").numpy().dtype == \
            np.asarray(jnp.asarray(x)).dtype


def test_dru_head_from_f64_arrays_equals_jax():
    """The rebalancer's DRU head ranks arrays that arrive as f64 (shares
    given as Python floats, mem as doubles): the port's rank of those
    inputs equals the JAX package's, bit for bit."""
    from cook_tpu.ops import dru as jdru
    from cook_tpu_torch.device import to_device
    from cook_tpu_torch.ops import dru as tdru
    rng = np.random.default_rng(11)
    n = 300
    user = rng.integers(0, 7, n)
    mem = rng.random(n) * 100.0 + 0.1
    cpus = rng.random(n) * 8.0 + 0.01
    prio = rng.integers(0, 100, n)
    start = rng.integers(0, 1000, n)
    valid = rng.random(n) < 0.9
    ms = rng.random(n) * 1000.0 + 1.0
    cs = rng.random(n) * 100.0 + 1.0
    args = (user, mem, cpus, prio, start, valid, ms, cs)
    want = jdru.dru_rank(*args)
    got = tdru.dru_rank(*(to_device(a, "cpu") for a in args))
    np.testing.assert_array_equal(got.rank.numpy(), np.asarray(want.rank))
    np.testing.assert_array_equal(got.dru.numpy(), np.asarray(want.dru))
