"""bench.py's four e2e overhead A/Bs on the port (bench_torch.py
decision-overhead, trace-overhead, profile-overhead, chaos-overhead) on
the CPU at a toy scale, 4 cycles an arm of which 1 untimed:

* each prints the keys bench.py's function prints (bench.py's own
  function run with its bench_e2e stubbed, which also shows the arms
  ask bench_e2e for the same settings in the same order), plus the
  port's: each arm's kernel launches, the shape, the cycles, the card;
* each toggle takes, as chip_smoke.py's phase 15 requires: provenance
  off records no decision and on records some, the tracer's flight
  spans export as JSON, the profiler commits cycles, the armed chaos
  sites draw and the controller ends disarmed;
* with decision provenance off and on, the port's bench_e2e launches
  what cook_tpu's launches, cycle by cycle, and with it on records the
  same decisions.
"""
import json

import pytest

import bench
import bench_torch
from cook_tpu_torch import e2e
from tests.test_torch_bench_modes import reference_e2e

TOY = dict(P0=3000, H=200, U=100)
CYCLES, WARMUP = 4, 1
# the port's keys beside bench.py's: every arm's launches, the shape and
# cycles, the card; decision-overhead's rounds, chaos-overhead's state
# after the run
EXTRA = {"kernel_launches", "shape", "cycles", "warmup", "card", "device"}
EXTRA_BY_MODE = {"decision-overhead": {"rounds"},
                 "chaos-overhead": {"armed_after"}}
MODES = {
    "decision-overhead": ("bench_decision_overhead",
                          "bench_decision_overhead"),
    "trace-overhead": ("bench_trace_overhead", "bench_trace_overhead"),
    "profile-overhead": ("bench_profile_overhead", "bench_profile_overhead"),
    "chaos-overhead": ("bench_chaos_overhead", "bench_chaos_overhead"),
}


def _stub_line(label, decision_provenance):
    """The keys bench.py's A/Bs read from a bench_e2e line, with values
    that make every branch run."""
    return {"value": 1000.0, "p99_cycle_ms": 10.0, "readback_mean_ms": 1.0,
            "phase_means_ms": {"consume_fold_ms": 2.0,
                               "consume_frame_ms": 3.0,
                               "launch_txn_ms": 4.0,
                               "backend_launch_ms": 5.0},
            "label": label, "decision_provenance": decision_provenance}


def _reference_line(monkeypatch, capsys, mode, tmp_path):
    """bench.py's A/B with its bench_e2e stubbed: its printed line and
    the settings each arm asked bench_e2e for."""
    calls = []

    def stub(label=None, stats_out=None, decision_provenance=None, **kw):
        calls.append((label.split(" @ ")[0], decision_provenance,
                      kw["cycles"], kw["warmup"], kw["P0"], kw["H"]))
        stats_out.update(_stub_line(label, decision_provenance))

    monkeypatch.setattr(bench, "bench_e2e", stub)
    fn = getattr(bench, MODES[mode][0])
    if mode in ("trace-overhead", "profile-overhead"):
        fn(str(tmp_path / "ref.json"))
    else:
        fn()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    return json.loads(lines[-1]), calls


@pytest.fixture(scope="module")
def port_lines(tmp_path_factory):
    """Each A/B of the port at the toy scale, with the arms' bench_e2e
    settings recorded."""
    out = {}
    real = bench_torch.bench_e2e
    for mode, (_, name) in MODES.items():
        calls = []

        def spy(label=None, decision_provenance=None, **kw):
            calls.append((label.split(" @ ")[0], decision_provenance,
                          kw["cycles"], kw["warmup"], kw["P0"], kw["H"]))
            return real(label=label, decision_provenance=decision_provenance,
                        **kw)

        bench_torch.bench_e2e = spy
        try:
            kw = dict(cycles=CYCLES, warmup=WARMUP, device="cpu", **TOY)
            if mode in ("trace-overhead", "profile-overhead"):
                path = tmp_path_factory.mktemp(mode) / "out.json"
                kw["out_path"] = str(path)
            line = getattr(bench_torch, name)(**kw)
        finally:
            bench_torch.bench_e2e = real
        out[mode] = (line, calls, kw.get("out_path"))
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_prints_bench_py_keys_and_asks_for_its_arms(
        monkeypatch, capsys, tmp_path, port_lines, mode):
    ref, ref_calls = _reference_line(monkeypatch, capsys, mode, tmp_path)
    got, calls, _ = port_lines[mode]
    assert set(got) - EXTRA - EXTRA_BY_MODE.get(mode, set()) == set(ref)
    assert got["budget_pct"] == ref["budget_pct"] == 2.0
    assert got["metric"].split(", e2e @")[0] == ref["metric"].split(
        ", e2e @")[0]
    # the same arms in the same order, bench.py's at its 20k x 2k and
    # 120 cycles of which 20 untimed, the port's at the toy scale
    assert [c[:2] for c in calls] == [c[:2] for c in ref_calls]
    assert {c[2:] for c in ref_calls} == {(120, 20, 20_000, 2_000)}
    assert {c[2:] for c in calls} == {(CYCLES, WARMUP, TOY["P0"],
                                       TOY["H"])}
    assert set(got["kernel_launches"]) == {
        c[0].split("[")[1].rstrip("]") for c in calls}
    assert got["device"] == {"platform": "cpu"} and got["card"] is None


def test_decision_provenance_toggle_takes(port_lines):
    line = port_lines["decision-overhead"][0]
    assert line["decisions_recorded_disabled"] == 0
    assert line["decisions_recorded_enabled"] > 0
    assert line["decisions_per_sec_disabled"] > 0


def test_trace_toggle_takes(port_lines):
    line, _, path = port_lines["trace-overhead"]
    assert line["flight_spans_exported"] > 0
    with open(path) as f:
        trace = json.load(f)
    assert trace and line["chrome_trace"] == path
    assert line["tracer"]["enabled"]   # the process-wide default again


def test_profile_toggle_takes(port_lines):
    from cook_tpu_torch import obs
    line, _, path = port_lines["profile-overhead"]
    assert line["committed"] > 0
    with open(path) as f:
        json.load(f)
    assert isinstance(line["dominant_match"], bool)
    assert obs.profiler.enabled


def test_chaos_toggle_takes(port_lines):
    from cook_tpu_torch import chaos
    line = port_lines["chaos-overhead"][0]
    assert line["armed_draws"] > 0
    assert line["armed_stats"]["sites"] == ["store.append", "store.fsync"]
    assert not line["armed_stats"]["injected"]
    assert line["armed_after"] is False and not chaos.controller.enabled


@pytest.mark.parametrize("provenance", [False, True], ids=["off", "on"])
def test_provenance_launches_and_decisions_equal_cook_tpu(
        monkeypatch, capsys, provenance):
    """bench_e2e with decision_provenance off and on, clocks and uuids
    pinned: the port launches, cycle by cycle, what cook_tpu launches,
    and records the same decisions (none with it off)."""
    from cook_tpu_torch.utils.metrics import registry

    def recorded():
        return sum(v["value"] for k, v in registry.snapshot().items()
                   if k.startswith("decisions_total"))

    kw = dict(cycles=CYCLES, warmup=WARMUP, decision_provenance=provenance,
              **TOY)
    ref, want, ref_recorded = reference_e2e(monkeypatch, capsys, **kw)
    before = recorded()
    with e2e.pinned_clocks():
        got = bench_torch.bench_e2e(device="cpu", digests=True, **kw)
    got_recorded = recorded() - before
    capsys.readouterr()
    assert got["launch_digests"] == want
    assert got["cycles"] == ref["cycles"] == CYCLES - WARMUP
    assert got_recorded == ref_recorded
    assert (got_recorded > 0) == provenance
