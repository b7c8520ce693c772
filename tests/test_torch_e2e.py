"""bench.py::bench_e2e's workload (cook_tpu_torch/e2e.py) on the port
against cook_tpu: the same seeded store, hosts and refills, driven
through Coordinator.match_cycle under both packages on the CPU with
pinned clocks and uuids, must launch the same (job, host) pairs cycle by
cycle, at a small size (tier 1) and at bench_e2e's full width (slow).
Also: cycles in flight (pipeline_depth 1, an async consumer) launch what
the inline run launches, on the CPU and on the card.
"""
import numpy as np
import pytest

from cook_tpu_torch.e2e import job_uuid
from tests.torch_coord_harness import run


def bench_e2e_scenario(P0, H, U, cycles, consider=None):
    """bench_e2e's workload for either package (hosts, backlog and
    refills drawn in its order; statuses applied inline)."""
    def scenario(t):
        p = t.pkg
        rng = np.random.default_rng(0)
        hosts = [p.MockHost(f"h{i}", mem=float(rng.uniform(64, 256) * 1024),
                            cpus=float(rng.uniform(16, 64)))
                 for i in range(H)]
        cfg = p.SchedulerConfig()
        if consider:
            cfg.max_jobs_considered = consider
        store, cluster, coord = t.build(
            hosts=hosts, runtime_fn=lambda s: (10.0, True, None),
            config=cfg)
        cluster.bulk_status = True

        def mkjobs(n):
            base = len(t.jobs)
            return [t.mkjob(uuid_=job_uuid(base + i),
                            user=f"u{int(rng.integers(0, U))}",
                            mem=float(rng.uniform(1, 10) * 1024),
                            cpus=float(rng.uniform(0.5, 4)))
                    for i in range(n)]

        store.create_jobs(mkjobs(P0))
        coord.enable_resident()
        for _ in range(cycles):
            t.cycle(coord)
            done = cluster.advance(1.0)
            if done:
                store.create_jobs(mkjobs(done))
        t.note(len(store.pending_jobs()), len(store.running_instances()))
    return scenario


def _assert_equal(scenario):
    ref = run(scenario, "cook_tpu")
    got = run(scenario, "cook_tpu_torch")
    for c, (a, b) in enumerate(zip(got[0], ref[0])):
        assert a == b, f"cycle {c} differs"
    assert got == ref
    return got


@pytest.mark.parametrize("consider", [None, 8192],
                         ids=["sequential", "batched"])
def test_bench_e2e_small_equals_jax(consider):
    trace, _ = _assert_equal(bench_e2e_scenario(3000, 200, 40, 4,
                                                consider))
    assert sum(e[1] for e in trace if e[0] == "cycle") > 0


def test_workload_is_bench_e2e_scenario():
    """e2e.Workload draws the same hosts and jobs as the scenario above
    (bench_e2e's order), and launches what it launches."""
    from cook_tpu_torch import e2e
    trace, _ = run(bench_e2e_scenario(1500, 80, 20, 3), "cook_tpu_torch")
    got = e2e.launch_trace("cpu", 3, P0=1500, H=80, U=20)
    want = [e[2] for e in trace if e[0] == "cycle"]
    index = {job_uuid(i): i for i in range(1500)}
    assert [{index[u]: [h] for u, h in cyc}
            for cyc in got["per_cycle"][:3]] == want


@pytest.mark.parametrize("mode", ["pipelined", "async"])
def test_cycles_in_flight_launch_what_inline_launches(mode):
    from cook_tpu_torch import e2e
    kw = dict(P0=2000, H=100, U=1, advance=False)
    ref = e2e.launch_trace("cpu", 4, mode="inline", **kw)
    got = e2e.launch_trace("cpu", 4, mode=mode, **kw)
    assert ref["launched"] and got["launched"] == ref["launched"]
    if mode == "pipelined":
        assert got["max_inflight"] == 2


@pytest.mark.parametrize("corrupt", [False, True])
def test_readback_audit(monkeypatch, corrupt):
    """launch_trace's audit holds every read of a cycle's early copies
    against a plain copy of its outputs. The CPU has no early copies, so
    this stands one in (a clone at dispatch, or a clone with the first
    matched host changed): the audit passes the first and names the
    second. Completions flow back from the tenth cycle."""
    from cook_tpu_torch import e2e
    from cook_tpu_torch.scheduler import resident

    class Ready:
        def synchronize(self):
            pass

    def start(out, names):
        out.host = {k: getattr(out, k).clone() for k in names}
        if corrupt:
            out.host["mat_host"][0] += 1
        out.ready = Ready()

    monkeypatch.setattr(resident, "start_readback", start)
    got = e2e.launch_trace("cpu", 12, mode="pipelined", audit=True,
                           P0=2000, H=100, U=20)
    assert got["audited_reads"] > 0 and got["completed"] > 0
    assert bool(got["audit_mismatches"]) == corrupt
    assert resident.read_outputs.__name__ == "read_outputs"


def test_device_paths_cover_every_path():
    """e2e.device_paths (chip_smoke.py runs it on the card and on the
    CPU path) reaches what it is there to reach: a batched legacy cycle
    with dense rounds and launches, the sequential one, the gpu pool,
    and preemptions in both pools; two runs give one trace."""
    from cook_tpu_torch import e2e
    trace = e2e.device_paths("cpu")
    cycles = [t for t in trace if t[0] == "cycle"]
    rebalances = {t[1]: t for t in trace if t[0] == "rebalance"}
    assert cycles[0][2] == 8192 and cycles[0][3] > 0 and cycles[0][4]
    assert {t[2] for t in cycles} == {1024, 8192}
    assert any(t[1] == "gpu" and t[4] for t in cycles)
    assert set(rebalances) == {"default", "gpu"}
    assert all(t[2] > 0 and t[4] for t in rebalances.values())
    assert e2e.device_paths("cpu") == trace


@pytest.mark.cuda
def test_async_readback_per_cycle_on_cuda():
    """Two cycles in flight (pipeline_depth=1) and a consumer thread
    (synchronous=False) on the card: each consume reads its own cycle's
    prefix from that cycle's pinned copies, so the launches equal the
    inline run's and the CPU path's."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cook_tpu_torch import e2e
    kw = dict(P0=3000, H=100, U=1, advance=False)
    ref = e2e.launch_trace("cuda", 4, mode="inline", **kw)
    assert ref["launched"]
    for mode in ("pipelined", "async"):
        got = e2e.launch_trace("cuda", 4, mode=mode, audit=True, **kw)
        assert got["launched"] == ref["launched"], mode
        assert got["audited_reads"] and not got["audit_mismatches"]
        assert got["launched"] == \
            e2e.launch_trace("cpu", 4, mode=mode, **kw)["launched"]
        if mode == "pipelined":
            assert got["max_inflight"] == 2


@pytest.mark.slow
@pytest.mark.parametrize("consider", [None, 8192],
                         ids=["sequential", "batched"])
def test_bench_e2e_full_width_equals_jax(consider):
    """bench_e2e's full width: 100k pending x 10k hosts, 500 users, 3
    cycles."""
    trace, _ = _assert_equal(bench_e2e_scenario(100_000, 10_000, 500, 3,
                                                consider))
    assert sum(e[1] for e in trace if e[0] == "cycle") > 0
