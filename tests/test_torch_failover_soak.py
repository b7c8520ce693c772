"""The leader-failover soak on the port (tests/torch_fedsoak.py over
tests/torch_livestack.py): an HA pair of `python -m
cook_tpu_torch.rest.server --device cpu` processes sharing one durable
store, at tests/test_federation_soak.py's QUICK tier and seed 31, held
to the same gates (`_assert_gates`); every server incarnation ran the
port's server on the device it was given; bench_torch.failover_gates
names a breach wherever `_assert_gates` fails; and `bench_torch.py
failover`'s function at the QUICK tier prints bench.py's keys.
"""
import copy

import pytest

import bench_torch
from tests.test_federation_soak import QUICK, _assert_gates
from tests.torch_fedsoak import run_failover_soak
from tests.torch_livestack import incarnations

SEED = 31


@pytest.fixture(scope="module")
def soak(tmp_path_factory):
    store = tmp_path_factory.mktemp("failover") / "store"
    r = run_failover_soak(store, SEED, device="cpu", **QUICK)
    logs = {n: store / f"server-{n}.log" for n in ("a", "b")}
    return r, logs


def test_failover_soak_quick_gates(soak):
    r, _ = soak
    _assert_gates(r, kills=QUICK["kills"])
    assert r["churn_events"]
    assert sum(r["server_deaths"].values()) >= QUICK["kills"]
    assert bench_torch.failover_gates(r, QUICK["kills"]) == []


def test_every_incarnation_ran_the_ports_server(soak):
    """Each member's log names every incarnation's module, pid and
    device (the port's server on the CPU, as asked), one per boot; the
    two alive at the end wrote their kernel launches on SIGTERM; and no
    log has the JAX package's server's boot line."""
    r, logs = soak
    for name, path in logs.items():
        incs = incarnations(path)
        assert len(incs) == 1 + r["server_deaths"][name], (name, incs)
        assert {i["device"] for i in incs} == {"cpu"}
        text = path.read_text(errors="replace")
        assert text.count("cook_tpu_torch scheduler listening") == len(incs)
        assert "cook_tpu scheduler listening" not in text
        # the last incarnation was stopped by SIGTERM, the killed ones
        # never reported
        assert incs[-1]["kernel_launches"] is not None
        assert all(i["kernel_launches"] is None for i in incs[:-1])
        # the plain versions on the CPU launch no kernel
        assert not any(incs[-1]["kernel_launches"].values())


def _lose_a_job(r):
    j = next(iter(r["jobs"]))
    del r["jobs"][j]


def _stick_a_job(r):
    next(iter(r["jobs"].values())).status = "running"


def _fail_a_job(r):
    next(iter(r["jobs"].values())).state = "failed"


def _double_launch(r):
    t = next(iter(r["launch_counts"]))
    r["launch_counts"][t] = 2


def _double_log(r):
    r["inst_tasks"].append(dict(r["inst_tasks"][0]))


def _epochs_not_increasing(r):
    r["epochs"] = r["epochs"][:1] * 2


def _slow_takeover(r):
    for t in r["transitions"]:
        if t["action"] == "leader_kill":
            t["mttr_ms"] = 20_001.0


def _no_epoch_advance(r):
    for t in r["transitions"]:
        if t["action"] == "leader_kill":
            t["epoch_after"] = t["epoch_before"]


def _fence_breached(r):
    r["stale_fence"] = dict(r["stale_fence"], rejected=False)


def _fence_uncounted(r):
    r["stale_fence"] = dict(r["stale_fence"], counter_delta=0.0)


def _one_epoch_stamp(r):
    for rec in r["inst_tasks"]:
        rec["ep"] = 1


def _violation(r):
    r["violations"] = ["submit of x never landed"]


BREACHES = {f.__name__.lstrip("_"): f for f in (
    _lose_a_job, _stick_a_job, _fail_a_job, _double_launch, _double_log,
    _epochs_not_increasing, _slow_takeover, _no_epoch_advance,
    _fence_breached, _fence_uncounted, _one_epoch_stamp, _violation)}


@pytest.mark.parametrize("breach", sorted(BREACHES))
def test_failover_gates_agree_with_assert_gates(soak, breach):
    """chip_smoke.py and bench_torch.py cannot import the reference's
    test module: their gates (bench_torch.failover_gates) fail exactly
    where _assert_gates does, on the soak's evidence with one breach."""
    r = copy.deepcopy(soak[0])
    BREACHES[breach](r)
    with pytest.raises(AssertionError):
        _assert_gates(r, kills=QUICK["kills"])
    assert bench_torch.failover_gates(r, QUICK["kills"])


def test_bench_failover_on_the_cpu():
    """bench_torch.bench_failover at the QUICK tier on the CPU: bench.py's
    keys, every gate held, every incarnation on the CPU, the survivors'
    launches read (none on the CPU)."""
    out = bench_torch.bench_failover(seed=SEED, device="cpu", **QUICK)
    assert {"metric", "value", "unit", "ok", "seed", "wall_s",
            "mttr_ms_median", "mttr_ms_all", "epochs", "violations",
            "stale_fence", "completed", "expected_jobs"} <= set(out)
    assert out["ok"], out
    assert out["gate_breaches"] == [] and out["incarnations_on_device"]
    assert len(out["mttr_ms_all"]) == QUICK["kills"]
    assert out["value"] <= bench_torch.FAILOVER_CEILING_MS
    assert out["completed"] == out["expected_jobs"]
    assert sum(map(len, out["incarnations"].values())) == \
        2 + sum(out["server_deaths"].values())
    assert out["survivor_exact_scan_launches"] == [0, 0]
    assert out["device"] == {"platform": "cpu"}
