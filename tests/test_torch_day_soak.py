"""The compressed production-day soak on the port (tests/torch_daysoak.py
over tests/torch_livestack.py): one `python -m cook_tpu_torch.rest.server
--device cpu` process under transport chaos, seeded SIGKILLs and
agent-fleet churn, at tests/test_day_soak.py's QUICK tier and seed 101,
held to the same gates (`_assert_gates`) and quick-tier asserts; every
server incarnation ran the port's server on the device it was given;
the quiet baseline; bench_torch.day_soak_gates names a breach wherever
`_assert_gates` fails, and on cuda holds the RSS ceiling with the
server's own memory; that reading counts allocations and not library
images; and `bench_torch.py day-soak`'s function at the QUICK tier
prints bench.py's keys. Three soak runs in all.
"""
import copy

import pytest

import bench_torch
import tests.test_day_soak as ref
from tests.test_day_soak import QUICK, _assert_gates
from tests.torch_daysoak import run_day_soak

SEED = 101


@pytest.fixture(scope="module")
def soak(tmp_path_factory):
    store = tmp_path_factory.mktemp("daysoak") / "store"
    return run_day_soak(store, SEED, device="cpu", **QUICK)


def test_day_soak_quick_gates(soak):
    """tests/test_day_soak.py::test_day_soak_quick's asserts on the
    port's evidence: every gate, and all three fault layers bit."""
    r = soak
    _assert_gates(r)
    assert r["transport_injected"] > 0
    assert r["churn_events"]
    assert r["server_deaths"] >= 1
    assert bench_torch.day_soak_gates(r) == []


def test_every_incarnation_ran_the_ports_server(soak):
    """The server log names every incarnation's pid and device (the
    port's server on the CPU, as asked), one per boot; the last one
    wrote its kernel launches on SIGTERM, the killed ones never did;
    and the log has no boot line of the JAX package's server."""
    r = soak
    incs = r["incarnations"]
    assert len(incs) == 1 + r["server_deaths"], incs
    assert {i["device"] for i in incs} == {"cpu"}
    with open(r["server_log"], errors="replace") as f:
        text = f.read()
    assert text.count("cook_tpu_torch scheduler listening") == len(incs)
    assert "cook_tpu scheduler listening" not in text
    assert incs[-1]["kernel_launches"] is not None
    assert all(i["kernel_launches"] is None for i in incs[:-1])
    # the plain versions on the CPU launch no kernel
    assert not any(incs[-1]["kernel_launches"].values())


def test_day_soak_quiet_baseline(tmp_path):
    """tests/test_day_soak.py::test_day_soak_quiet_baseline on the port:
    no churn, no kills, no transport faults; zero violations, one
    instance a job, the overload ladder never engaged, one incarnation."""
    r = run_day_soak(tmp_path / "store", seed=7, jobs=6, agents=2,
                     window_s=2.0, wall_s=60.0, max_kills=0, churn=False,
                     transport=False, device="cpu")
    _assert_gates(r)
    assert bench_torch.day_soak_gates(r) == []
    assert r["transport_injected"] == 0
    assert r["kills"] == [] and r["server_deaths"] == 0
    assert r["overload_level_max"] == 0
    assert all(len(j.instances) == 1 for j in r["jobs"].values())
    assert [i["device"] for i in r["incarnations"]] == ["cpu"]


def _lose_a_job(r):
    del r["jobs"][next(iter(r["jobs"]))]


def _stick_a_job(r):
    next(iter(r["jobs"].values())).status = "running"


def _fail_a_job(r):
    next(iter(r["jobs"].values())).state = "failed"


def _too_many_instances(r):
    j = next(iter(r["jobs"].values()))
    j.instances = list(j.instances) * 17


def _double_launch(r):
    r["launch_counts"][next(iter(r["launch_counts"]))] = 2


def _slow_restart(r):
    r["ready_times_s"] = list(r["ready_times_s"]) + [20.5]


def _rss_over_ceiling(r):
    r["max_rss_mb"] = ref.RSS_CEILING_MB


def _p99_over_ceiling(r):
    r["submit_p99_ms"] = ref.SUBMIT_P99_CEILING_MS


def _violation(r):
    r["violations"] = ["submit of x never landed"]


BREACHES = {f.__name__.lstrip("_"): f for f in (
    _lose_a_job, _stick_a_job, _fail_a_job, _too_many_instances,
    _double_launch, _slow_restart, _rss_over_ceiling, _p99_over_ceiling,
    _violation)}


@pytest.mark.parametrize("breach", sorted(BREACHES))
def test_day_soak_gates_agree_with_assert_gates(soak, breach):
    """chip_smoke.py and bench_torch.py cannot import the reference's
    test module: their gates (bench_torch.day_soak_gates) fail exactly
    where _assert_gates does, on the soak's evidence with one breach."""
    r = copy.deepcopy(soak)
    BREACHES[breach](r)
    with pytest.raises(AssertionError):
        _assert_gates(r)
    assert bench_torch.day_soak_gates(r)


def test_ceilings_and_bounds_are_the_reference_tests():
    assert bench_torch.RSS_CEILING_MB == ref.RSS_CEILING_MB
    assert bench_torch.SUBMIT_P99_CEILING_MS == ref.SUBMIT_P99_CEILING_MS
    assert bench_torch.DAY_SOAK == ref.FULL
    # the instance bound: 16 a job passes the quick tier and 17 fails
    # it, 24 passes the full one and 25 fails it
    job = type("J", (), {"uuid": "u", "status": "completed",
                         "state": "success"})
    for full, bound in ((False, 16), (True, 24)):
        assert bench_torch.INSTANCE_BOUND[full] == bound
        for n, ok in ((bound, True), (bound + 1, False)):
            j = job()
            j.instances = [None] * n
            r = {"seed": 0, "kill_ledger": "", "server_log": "",
                 "violations": [], "jobs": {"u": j}, "expected_jobs": 1,
                 "launch_counts": {}, "ready_times_s": [],
                 "max_rss_mb": 0.0, "submit_p99_ms": 0.0}
            if ok:
                _assert_gates(r, full=full)
            else:
                with pytest.raises(AssertionError):
                    _assert_gates(r, full=full)
            assert (bench_torch.day_soak_gates(r, full) == []) == ok


def test_bench_day_soak_on_the_cpu():
    """bench_torch.bench_day_soak at the QUICK tier on the CPU: bench.py's
    keys, every gate held, every incarnation on the CPU, the final
    incarnation's launches read (none on the CPU)."""
    out = bench_torch.bench_day_soak(seed=SEED, device="cpu", **QUICK)
    assert {"metric", "value", "unit", "ok", "seed", "wall_s",
            "violations", "double_launches", "transport_injected",
            "server_deaths", "churn_events", "submit_p99_ms",
            "max_rss_mb", "overload_level_max", "kill_ledger"} <= set(out)
    assert out["ok"] and out["bench_ok"], out
    assert out["gate_breaches"] == [] and out["incarnations_on_device"]
    assert out["value"] == QUICK["jobs"]
    assert out["server_deaths"] >= 1 and out["transport_injected"] > 0
    assert out["churn_events"] > 0
    assert len(out["incarnations"]) == 1 + out["server_deaths"]
    assert out["final_exact_scan_launches"] == 0
    assert out["final_kernel_launches"] == {}
    assert out["device"] == {"platform": "cpu"}
    # the scale given is run_day_soak's arguments, its defaults beside
    assert out["scale"] == QUICK
    assert 0 < out["max_rss_own_mb"] <= out["max_rss_mb"]


@pytest.mark.parametrize("device,rss,own,breached", [
    ("cpu", 3000.0, 100.0, True),      # the reference's gate: the RSS
    ("cpu", 2999.0, 100.0, False),
    ("cuda", 5249.0, 2999.0, False),   # a CUDA server: its own memory
    ("cuda", 5249.0, 3000.0, True),
    ("cuda", 5249.0, 0.0, True),       # and it must have been read
])
def test_rss_gate_reads_own_memory_on_cuda(soak, device, rss, own,
                                           breached):
    """day_soak_gates' listed difference: a server on cuda holds the RSS
    ceiling with its own memory (max_rss_own_mb), since its CUDA
    libraries' clean images alone are over it; on the CPU, its RSS."""
    r = copy.deepcopy(soak)
    r["max_rss_mb"], r["max_rss_own_mb"] = rss, own
    bad = bench_torch.day_soak_gates(r, device=device)
    assert bool(bad) == breached, bad
    assert all("RSS" in b for b in bad)


_ALLOC_CHILD = r"""
import sys
import torch
x = torch.ones(64 << 20)            # 256 MB the process allocates
print("ready", flush=True)
sys.stdin.read()
"""


def test_own_rss_counts_allocations_not_library_images():
    """tests/torch_daysoak.py's reading of the server's own memory, on a
    process that imported torch and allocated 256 MB: it counts the
    allocation (about the kernel's RssAnon) and leaves out the clean
    pages of torch's libraries (below VmRSS)."""
    import os
    import subprocess
    import sys

    from tests.torch_daysoak import _server_own_rss_mb, _server_rss_mb
    if not os.path.exists("/proc/self/smaps"):
        pytest.skip("needs /proc/self/smaps (Linux)")
    proc = subprocess.Popen([sys.executable, "-c", _ALLOC_CHILD],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True)
    try:
        assert proc.stdout.readline().strip() == "ready"
        sup = type("Sup", (), {"_proc": proc})
        own, rss = _server_own_rss_mb(sup), _server_rss_mb(sup)
        with open(f"/proc/{proc.pid}/status") as f:
            status = {line.split(":")[0]: int(line.split()[1]) / 1024.0
                      for line in f if line.startswith(("Rss", "VmRSS"))}
    finally:
        proc.communicate("", timeout=30)
    assert 256.0 <= own < rss, (own, rss, status)
    if "RssAnon" in status:
        assert abs(own - status["RssAnon"]) <= \
            0.1 * status["RssAnon"] + 32.0, (own, status)
    assert _server_own_rss_mb(sup) == 0.0       # the process has ended
