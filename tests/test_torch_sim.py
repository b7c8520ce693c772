"""The port's simulator (cook_tpu_torch.sim) against cook_tpu's.

Each scenario of tests/test_simulator.py, and three more generated
traces, runs through both packages: cook_tpu on JAX's CPU backend with
its defaults (`use_pallas=False`), the port with `device="cpu"` (its
plain PyTorch versions). Task ids come from `uuid.uuid4`, which both
runs see as the same counter, so the run traces (`run_trace_rows()`)
and the summaries must be equal as they are, every column included.
Also the port's CLI round trip (`python -m cook_tpu_torch.sim --device
cpu`, `sim.gen`, `sim.analysis`) against the reference's on the same
files.
"""
import csv
import importlib
import itertools
import json
import threading
import uuid

import pytest
import torch

from tests.test_simulator import make_trace_entry


def _sim(root):
    return importlib.import_module(f"{root}.sim")


def _gen(root):
    return importlib.import_module(f"{root}.sim.gen")


def _run(root, trace_raw, hosts_raw, configure):
    """One simulator run of `root`'s package with task ids counted from
    1: (run_trace_rows, summary, the Simulator)."""
    sim_mod = _sim(root)
    counter = itertools.count(1)
    lock = threading.Lock()

    def uuid4():
        with lock:
            return uuid.UUID(int=next(counter))

    saved = uuid.uuid4
    uuid.uuid4 = uuid4
    try:
        cfg = sim_mod.SimConfig()
        configure(cfg)
        kw = {"device": "cpu"} if root == "cook_tpu_torch" else {}
        sim = sim_mod.Simulator(sim_mod.parse_trace(trace_raw),
                                sim_mod.parse_hosts(hosts_raw), cfg, **kw)
        summary = sim.run()
    finally:
        uuid.uuid4 = saved
    return sim.run_trace_rows(), summary, sim


def _generated(n_jobs, n_users, window_ms, runtime_ms, fail, seed,
               n_hosts, cpus, mem, step):
    def make(gen):
        trace = gen.generate_trace(n_jobs=n_jobs, n_users=n_users,
                                   submit_window_ms=window_ms,
                                   mean_runtime_ms=runtime_ms,
                                   fail_fraction=fail, seed=seed)
        return trace, gen.generate_hosts(n_hosts=n_hosts, cpus=cpus,
                                         mem=mem)

    def configure(cfg):
        cfg.cycle_step_ms = step
    return make, configure


def _fixed(trace, n_hosts, cpus, mem, configure):
    def make(gen):
        return trace, gen.generate_hosts(n_hosts=n_hosts, cpus=cpus,
                                         mem=mem)
    return make, configure


def _step(ms, **rebalancer):
    def configure(cfg):
        cfg.cycle_step_ms = ms
        for k, v in rebalancer.items():
            if k in ("rebalance_interval_ms", "max_sim_time_ms"):
                setattr(cfg, k, v)
            else:
                setattr(cfg.scheduler.rebalancer, k, v)
    return configure


_HOG = ([make_trace_entry(uuid=f"a-{i}", user="a", submit=0,
                          runtime=3_600_000, cpus=1.0, mem=100.0)
         for i in range(8)] +
        [make_trace_entry(uuid=f"b-{i}", user="b", submit=30_000,
                          runtime=10_000, cpus=1.0, mem=100.0)
         for i in range(4)])

# tests/test_simulator.py's scenarios, then three generated seeds
SCENARIOS = {
    "end_to_end": _generated(60, 4, 300_000, 120_000, 0.1, 7, 5, 8, 8000,
                             15_000),
    "determinism": _generated(40, 3, 120_000, 60_000, 0.0, 3, 4, 4, 8000,
                              10_000),
    "failed_job_retries": _fixed(
        [make_trace_entry(uuid="f-1", status="failed", runtime=10_000,
                          **{"job/max-retries": 3})], 3, 4, 4000,
        _step(5_000)),
    "max_runtime_kill": _fixed(
        [make_trace_entry(uuid="l-1", runtime=10 ** 9,
                          **{"job/max-runtime": 60_000})], 1, 4, 4000,
        _step(30_000)),
    "rebalancer_preempts_hog": _fixed(
        _HOG, 2, 4, 4000,
        _step(10_000, rebalance_interval_ms=60_000,
              max_sim_time_ms=7_200_000, min_dru_diff=0.0,
              safe_dru_threshold=0.0)),
    "generated_seed_11": _generated(120, 6, 600_000, 180_000, 0.1, 11, 6,
                                    8, 16_000, 20_000),
    "generated_seed_12": _generated(150, 8, 300_000, 240_000, 0.2, 12, 4,
                                    16, 32_000, 30_000),
    "generated_seed_13": _generated(90, 3, 900_000, 60_000, 0.05, 13, 8, 4,
                                    8000, 10_000),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_simulator_equals_cook_tpu(name):
    make, configure = SCENARIOS[name]
    trace, hosts = make(_gen("cook_tpu"))
    assert make(_gen("cook_tpu_torch")) == (trace, hosts)
    rows, summary, _ = _run("cook_tpu", trace, hosts, configure)
    got_rows, got_summary, sim = _run("cook_tpu_torch", trace, hosts,
                                      configure)
    assert rows and summary["completed"]
    assert got_rows == rows
    assert got_summary == summary
    if name == "rebalancer_preempts_hog":
        assert got_summary["preemptions"] > 0
    if name == "max_runtime_kill":
        assert sim.trace[0].job.instances[0].reason_code == 4000


def test_simulator_on_the_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    sim_mod = _sim("cook_tpu_torch")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sim_mod.Simulator([], [])


def _cli(root, tmp, cfg_f, device_args):
    import_module = importlib.import_module
    trace_f, hosts_f = tmp / f"{root}-trace.json", tmp / f"{root}-hosts.json"
    out_f = tmp / f"{root}-out.csv"
    import_module(f"{root}.sim.gen").main(
        ["--jobs", "20", "--users", "3", "--hosts", "3",
         "--trace-out", str(trace_f), "--hosts-out", str(hosts_f)])
    counter = itertools.count(1)
    saved = uuid.uuid4
    uuid.uuid4 = lambda: uuid.UUID(int=next(counter))
    try:
        rc = import_module(f"{root}.sim.__main__").main(
            ["--trace-file", str(trace_f), "--host-file", str(hosts_f),
             "--out-trace-file", str(out_f), "--config-file", str(cfg_f),
             *device_args])
    finally:
        uuid.uuid4 = saved
    assert rc == 0
    with open(out_f) as f:
        rows = list(csv.DictReader(f))
    res = import_module(f"{root}.sim.analysis").analyze(
        import_module(f"{root}.sim.analysis").load_run_trace(str(out_f)))
    return (trace_f.read_text(), hosts_f.read_text()), rows, res


def test_cli_round_trip_and_analysis_equal_cook_tpu(tmp_path, capsys):
    cfg_f = tmp_path / "cfg.json"
    cfg_f.write_text(json.dumps({
        "cycle-step-ms": 20000,
        "shares": [{"user": "default", "mem": 5000, "cpus": 10}],
        "scheduler-config": {"max-jobs-considered": 512,
                             "use-pallas": False},
    }))
    want = _cli("cook_tpu", tmp_path, cfg_f, [])
    ref_out = capsys.readouterr().out
    got = _cli("cook_tpu_torch", tmp_path, cfg_f, ["--device", "cpu"])
    got_out = capsys.readouterr().out
    assert got[0] == want[0]
    assert len(got[1]) >= 20 and got[1] == want[1]
    assert got[2] == want[2] and got[2]["jobs"] == 20
    # after sim.gen's "wrote ..." line, the CLI's JSON summary
    assert json.loads(got_out[got_out.index("{"):]) == \
        json.loads(ref_out[ref_out.index("{"):])
