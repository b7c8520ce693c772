"""Isolation and device rules of the port (cook_tpu_torch):

* a process running the port (the entry points, a Coordinator with a
  resident pool that runs cycles and the rebalancer, the server built by
  `rest.server.build_scheduler` taking a job through its API, the
  simulator, and the mesh paths of `entry.dryrun_multichip`) never
  imports jax nor any cook_tpu module;
* the node agent (`python -m cook_tpu_torch.agent`, for --help and
  while it runs), the `cs` CLI and the API-server stand-in import
  neither torch, jax nor cook_tpu; the server imports torch but neither
  of the others;
* no file of the port, nor chip_smoke.py nor bench_torch.py, imports jax
  or cook_tpu, and bench_torch.py runs on the CPU without them;
* no string of the port, chip_smoke.py, bench_torch.py or
  tests/torch_*.py asks to run a module of cook_tpu or sets
  JAX_PLATFORMS (`runs_reference`), so every child process the port
  starts runs the port;
* entry points default to CUDA and raise when it is absent;
* on a CUDA tensor each kernel wrapper launches its kernel and never
  reaches its plain version, and agrees with that plain version (the
  cluster exact_scan at its edge shapes; best_host at its tiling's
  edges; blocked_cumsum and ordered_scatter bit for bit and from run to
  run); the batched matcher's host depletion, through ordered_scatter,
  is bit-reproducible there and equal to the CPU's; the host-sharded
  scan and the pool-sharded cycle on four shards of one card equal the
  one-device scan and the CPU path (needs the card; skipped without
  one).
"""
import ast
import json
import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "cook_tpu_torch"

_CHILD = r"""
import importlib, pkgutil, sys
import cook_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(cook_tpu_torch.__path__,
                                              "cook_tpu_torch.")]
# the agent's and the CLI's __main__ run their entry point when
# imported: test_entry_point_imports_no_banned_package runs them
mods = [m for m in mods if m not in ("cook_tpu_torch.agent.__main__",
                                     "cook_tpu_torch.cli.__main__")]
for m in mods:
    importlib.import_module(m)
from cook_tpu_torch import entry
w = entry.resident_workload(R=40, P=200, H=32, U=4, C=16, forb_cap=32,
                            device="cpu")
out, mat_idx, _ = w.cycle()
out, bat_idx, _ = w.cycle(sequential=False)
assert len(bat_idx) > 0
fn, args = entry.entry(device="cpu")
res = fn(*args)
assert int(res.n_matched) > 0 and len(mat_idx) > 0
from cook_tpu_torch.backends.base import ClusterRegistry
from cook_tpu_torch.backends.mock import MockCluster, MockHost
from cook_tpu_torch.scheduler.coordinator import Coordinator
from cook_tpu_torch.state.model import Job, JobState
from cook_tpu_torch.state.store import JobStore
store = JobStore()
cluster = MockCluster([MockHost(f"h{i}", mem=100, cpus=8)
                       for i in range(3)])
reg = ClusterRegistry()
reg.register(cluster)
coord = Coordinator(store, reg, device="cpu")
coord.enable_resident()
jobs = [Job(uuid=f"00000000-0000-0000-0000-{i:012d}", user=f"u{i % 2}",
            command="true", mem=10, cpus=1) for i in range(30)]
store.create_jobs(jobs)
assert coord.match_cycle().matched == 24
cluster.advance(120.0)
coord.match_cycle()
coord.rebalance_cycle()
coord.stop()
assert sum(j.state == JobState.COMPLETED for j in jobs) == 24
from cook_tpu_torch.rest.server import build_scheduler
from cook_tpu_torch.sim import SimConfig, Simulator, parse_hosts, parse_trace
from cook_tpu_torch.sim.gen import generate_hosts, generate_trace
store, coord, api = build_scheduler(
    {"clusters": [{"kind": "mock", "hosts": 3}],
     "scheduler": {"pipeline_depth": 0}}, device="cpu")
resp = api.handle("POST", "/jobs", {}, {"jobs": [
    {"uuid": "00000000-0000-0000-0001-000000000000", "command": "true",
     "mem": 10, "cpus": 1}]}, {})
assert resp.status == 201, resp.body
coord.match_cycle("default")
coord.drain_resident("default")
coord.stop()
api.ingest.stop()
assert len(store.running_instances("default")) == 1
sim = Simulator(parse_trace(generate_trace(n_jobs=20, n_users=2, seed=0)),
                parse_hosts(generate_hosts(n_hosts=3)),
                SimConfig(cycle_step_ms=10_000), device="cpu")
assert sim.run()["completed"] == 20
from cook_tpu_torch.entry import dryrun_multichip
dryrun_multichip(4, device="cpu", devices=["cpu"] * 4)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "jaxlib"
             or n == "cook_tpu" or n.startswith("cook_tpu."))
print("MODULES", len(mods), "BAD", bad)
"""


def test_port_process_never_imports_jax_or_cook_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("MODULES")][-1]
    assert line.endswith("BAD []"), line
    assert int(line.split()[1]) >= 10


# an entry point as `python -m` runs it; at its exit, or on SIGTERM
# while it serves, the modules of the banned packages it imported
_ENTRY_CHILD = r"""
import json, os, runpy, signal, sys
mod, banned = sys.argv[1], sys.argv[2].split(",")
sys.argv = [mod] + sys.argv[3:]
def report(*_):
    bad = sorted(n for n in sys.modules if n.split(".")[0] in banned)
    print("BAD " + json.dumps(bad), flush=True)
    os._exit(0)
signal.signal(signal.SIGTERM, report)
try:
    runpy.run_module(mod, run_name="__main__", alter_sys=True)
except SystemExit:
    pass
report()
"""

_HOST_ONLY = "torch,jax,jaxlib,cook_tpu"
# (module, banned packages, arguments, a line it prints once serving;
# None: it exits by itself)
ENTRY_POINTS = {
    "agent --help": ("cook_tpu_torch.agent", _HOST_ONLY, ["--help"], None),
    # up, retrying its registration with a coordinator that never answers
    "agent": ("cook_tpu_torch.agent", _HOST_ONLY,
              ["--coordinator", "http://127.0.0.1:9", "--hostname", "iso",
               "--sandbox-root", "{tmp}/sandboxes"], "register failed"),
    "cli --help": ("cook_tpu_torch.cli", _HOST_ONLY, ["--help"], None),
    "cli config": ("cook_tpu_torch.cli", _HOST_ONLY,
                   ["--config", "{tmp}/cs.json", "config", "--get",
                    "clusters"], None),
    "standin": ("cook_tpu_torch.backends.kube.standin", _HOST_ONLY,
                ["--port", "0", "--nodes", "2", "--kubelet-sim"],
                "apiserver stand-in on"),
    "server": ("cook_tpu_torch.rest.server", "jax,jaxlib,cook_tpu",
               ["--device", "cpu", "--port", "0", "--config",
                "{tmp}/server.json"], "listening"),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_imports_no_banned_package(name, tmp_path):
    """The node agent, the CLI and the stand-in import neither torch,
    jax nor cook_tpu; the server imports torch but neither of the
    others."""
    mod, banned, args, ready = ENTRY_POINTS[name]
    (tmp_path / "server.json").write_text(json.dumps({
        "clusters": [{"kind": "agent", "name": "agents"}],
        "auth": {"agent_token": "t"}}))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    env["HOME"] = str(tmp_path)
    proc = subprocess.Popen(
        [sys.executable, "-u", "-c", _ENTRY_CHILD, mod, banned,
         *[a.format(tmp=tmp_path) for a in args]], cwd=str(tmp_path),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if ready is not None and ready in line:
                proc.send_signal(signal.SIGTERM)
            if line.startswith("BAD "):
                break
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
    assert proc.returncode == 0, lines[-20:]
    assert lines and lines[-1] == "BAD []", lines[-20:]


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("name", ["package", "chip_smoke", "bench_torch"])
def test_no_static_import_of_jax_or_cook_tpu(name):
    files = sorted(PORT.rglob("*.py")) if name == "package" \
        else [ROOT / f"{name}.py"]
    assert files
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "cook_tpu"), (f, mod)


# `python -m cook_tpu.<module>` (or `cook_tpu` alone) in a command
# string; cook_tpu_torch does not match
_RUN_REF = re.compile(r"python[\d.]*\s+-m\s+cook_tpu(?!\w)")


def _docstrings(tree):
    return {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)
            and isinstance(n.body[0].value.value, str)}


def runs_reference(src):
    """The lines of `src` whose string constants ask to run a module of
    the JAX package or set JAX_PLATFORMS: a "-m", "cook_tpu..." pair in
    an argv list or tuple, `python -m cook_tpu.` in a command string,
    JAX_PLATFORMS anywhere (a key, a keyword, a command's setting).
    Docstrings are text for readers and logger names are not argv, so
    neither is read."""
    tree = ast.parse(src)
    skip, lines = _docstrings(tree), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in skip:
            if _RUN_REF.search(node.value) or "JAX_PLATFORMS" in node.value:
                lines.add(node.lineno)
        elif isinstance(node, (ast.List, ast.Tuple)):
            for a, b in zip(node.elts, node.elts[1:]):
                if isinstance(a, ast.Constant) and a.value == "-m" \
                        and isinstance(b, ast.Constant) \
                        and isinstance(b.value, str) \
                        and b.value.split(".")[0] == "cook_tpu":
                    lines.add(b.lineno)
        elif isinstance(node, ast.keyword) and node.arg == "JAX_PLATFORMS":
            lines.add(node.value.lineno)
    return sorted(lines)


def _port_files(name):
    return {"package": sorted(PORT.rglob("*.py")),
            "harnesses": sorted((ROOT / "tests").glob("torch_*.py"))}.get(
                name, [ROOT / f"{name}.py"])


@pytest.mark.parametrize("name", ["package", "chip_smoke", "bench_torch",
                                  "harnesses"])
def test_nothing_runs_a_module_of_the_jax_package(name):
    """No string constant of the port, chip_smoke.py, bench_torch.py or
    tests/torch_*.py starts a module of cook_tpu or sets JAX_PLATFORMS:
    a child process of the port runs the port, on the device it was
    given (the card's machine has no JAX)."""
    files = _port_files(name)
    assert files
    found = {str(f.relative_to(ROOT)): runs_reference(f.read_text())
             for f in files}
    assert not {f: ls for f, ls in found.items() if ls}


# (source, the lines runs_reference must name): the port's files as they
# stood before they ran the port's own modules (each then equal to its
# original in cook_tpu, imports rewritten), and snippets
_REF_CASES = {
    # ServerSupervisor._spawn: JAX_PLATFORMS=cpu, then the JAX
    # package's server
    "procfault_before": ("cook_tpu/chaos/procfault.py", [214, 221]),
    # the kube pod sidecar's default command
    "http_api_before": ("cook_tpu/backends/kube/http_api.py", [158]),
    # the analysis CLI's usage names the JAX package's module (the
    # docstring's mentions are not read)
    "sim_analysis_before": ("cook_tpu/sim/analysis.py", [160]),
    "argv_tuple": ('cmd = (sys.executable, "-m", "cook_tpu.agent")\n', [1]),
    "shell_command": ('run("python3 -m cook_tpu.cli ls", shell=True)\n',
                      [1]),
    "f_string": ('c = f"python -m cook_tpu.sim --port {p}"\n', [1]),
    "env_keyword": ('env = dict(os.environ, JAX_PLATFORMS="cpu")\n', [1]),
    "env_key": ('env["JAX_PLATFORMS"] = "cpu"\n', [1]),
    "the_port": ('cmd = [sys.executable, "-m", "cook_tpu_torch.agent",\n'
                 '       "--x"]\nc = "python -m cook_tpu_torch.cli"\n', []),
    "logger_name": ('log = logging.getLogger("cook_tpu.rest.access")\n', []),
    "docstring": ('def f():\n    """Run `python -m cook_tpu.cli`."""\n',
                  []),
}


@pytest.mark.parametrize("case", sorted(_REF_CASES))
def test_runs_reference_names_each_site(case):
    src, want = _REF_CASES[case]
    if src.endswith(".py"):
        src = re.sub(r"^(\s*)(from|import) cook_tpu(?=[.\s])",
                     r"\1\2 cook_tpu_torch", (ROOT / src).read_text(),
                     flags=re.M)
    assert runs_reference(src) == want


_BENCH_CHILD = r"""
import json, runpy, sys
sys.argv = ["bench_torch.py"] + sys.argv[1:]
runpy.run_path("bench_torch.py", run_name="__main__")
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "jaxlib"
             or n == "cook_tpu" or n.startswith("cook_tpu."))
print("BAD", json.dumps(bad))
"""

BENCH_TOY = {
    "rebalance": ["--T0", "400", "--P", "6", "--H", "24", "--U", "10",
                  "--sweeps", "2"],
    "headline": ["--R", "200", "--P", "1000", "--H", "64", "--U", "16",
                 "--C", "256", "--cycles", "3"],
    "sequential": ["--R", "200", "--P", "1000", "--H", "64", "--U", "16",
                   "--C", "128", "--cycles", "3"],
    # 4 cycles in all, the first untimed (bench.py's sense)
    "e2e": ["--P0", "1500", "--H", "60", "--U", "12", "--cycles", "4",
            "--warmup", "1"],
    "pools": ["--R", "40", "--P", "200", "--H", "32", "--U", "4", "--C",
              "64", "--cycles", "2"],
    "contended": ["--R", "200", "--P", "1000", "--H", "64", "--U", "16",
                  "--C", "256", "--cycles", "3"],
    "stream": ["--R", "200", "--P", "1000", "--H", "64", "--U", "16",
               "--C", "256", "--total-jobs", "10000"],
    "e2e-smoke": ["--P0", "1200", "--H", "48", "--U", "12", "--cycles", "4",
                  "--warmup", "1", "--consider", "64"],
    "ingest": ["--n-single", "10", "--n-conc", "40", "--n-bulk", "2048"],
    "fleet-worker": [],
}
# a mode's environment (the fleet member's scale, as bench.py's: 4
# cycles, the first untimed)
BENCH_TOY_ENV = {
    "fleet-worker": {"FLEET_BENCH_P0": "500", "FLEET_BENCH_H": "50",
                     "FLEET_BENCH_U": "20", "FLEET_BENCH_CYCLES": "4",
                     "FLEET_BENCH_WARMUP": "1"},
}
# bench.py's other bench_e2e modes at the same toy shape (their own
# settings; the cycle counts cut)
for _mode in ("e2e-small", "e2e-batched", "e2e-async", "longevity",
              "longevity-async"):
    BENCH_TOY[_mode] = BENCH_TOY["e2e"]
# the four e2e overhead A/Bs at a shape where the timed cycles place jobs
for _mode in ("decision-overhead", "trace-overhead", "profile-overhead",
              "chaos-overhead"):
    BENCH_TOY[_mode] = ["--P0", "3000", "--H", "200", "--U", "100",
                        "--cycles", "4", "--warmup", "1"]


@pytest.mark.parametrize("mode", sorted(BENCH_TOY))
def test_bench_torch_runs_on_cpu_without_jax(mode):
    """bench_torch.py MODE --device cpu at a toy shape: one JSON line
    with bench.py's fields, device fields that say CPU (no device metric
    measured), and no jax or cook_tpu module in the process."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    env.update(BENCH_TOY_ENV.get(mode, {}))
    proc = subprocess.run(
        [sys.executable, "-c", _BENCH_CHILD, mode, "--device", "cpu",
         *BENCH_TOY[mode]], cwd=str(ROOT), env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1] == "BAD []", lines[-1]
    out = json.loads(lines[-2])
    assert out["device"] == {"platform": "cpu"} and out["card"] is None
    if mode == "ingest":
        assert out["acked_total"] == 10 + 40 + 2048
        assert out["durability_check"]["acked_all_durable"]
        assert out["durability_check"]["replayed"] == 2098
    elif mode == "fleet-worker":
        assert out["metric"] == "sched decisions/sec, fleet member 0"
        assert out["cycles"] == 3 and out["pools"] == 1
        assert out["durability_check"]["acked_all_durable"]
        assert out["durability_check"]["state_hash_match"]
        assert out["kernel_launches"]["exact_scan"] == 0
        assert len(out["launch_digests"]) == 4 + 1
    elif mode.endswith("-overhead"):
        on = "armed" if mode == "chaos-overhead" else "enabled"
        for k in ("value", "budget_pct", "overhead_ok",
                  "decisions_per_sec_disabled", f"decisions_per_sec_{on}",
                  "p99_cycle_ms_disabled", f"p99_cycle_ms_{on}"):
            assert out[k] is not None, k
        assert out["decisions_per_sec_disabled"] > 0
        assert out["cycles"] == 4 and out["warmup"] == 1
    elif mode == "rebalance":
        for k in ("value", "placed", "preempted", "capped8192_ms",
                  "capped8192_preempted"):
            assert out[k] is not None, k
        assert out["placed"] > 0 and out["launches_per_sweep"] is None
    elif mode.startswith(("e2e", "longevity")):
        for k in ("value", "p50_cycle_ms", "p99_cycle_ms",
                  "matched_per_cycle", "phase_median_ms", "resyncs"):
            assert out[k] is not None, k
        assert {"drain_ms", "ship_ms", "dispatch_ms", "readback_ms",
                "launch_txn_ms", "backend_launch_ms"} <= set(
                    out["phase_median_ms"])
        assert out["cycles"] == 3
        assert out["sequential"] == (mode != "e2e-batched")
        assert out["async_consumer"] == mode.endswith("async")
        assert out["launches_per_cycle"] is None
        if mode == "e2e-smoke":
            assert (out["pools"], out["store_shards"],
                    out["pipeline_depth"], out["native_consume"]) == \
                (4, 4, 2, True)
            assert out["durability_check"]["acked_all_durable"]
            assert out["durability_check"]["state_hash_match"]
            assert out["metric"].endswith(
                "4 pools x 4 shards, depth 2, native on")
    elif mode == "stream":
        assert out["jobs_placed"] >= 10_000 and out["cycles"] % 32 == 0
        assert out["value"] > 0 and out["host_syncs_per_cycle"] is None
    elif mode == "pools":
        for k in ("value", "cycle_ms_median", "p99_cycle_ms",
                  "matched_per_cycle"):
            assert out[k] is not None, k
        assert out["matched_per_cycle"] > 0
        assert out["shape"]["n_pools"] == 8
        assert out["event_ms_p99"] is None
        assert out["launches_per_cycle"] is None
    else:
        for k in ("value", "cycle_ms_median", "cycle_ms_iqr",
                  "p50_cycle_ms", "p99_cycle_ms", "p99_method",
                  "matched_per_cycle", "head_window_inversions"):
            assert out[k] is not None, k
        assert out["matched_per_cycle"] > 0
        assert out["head_window_inversions"] == 0
        assert out["event_ms_p99"] is None
        assert (out["adaptive_head_converged"] is None) == \
            (mode == "sequential")
        assert out["shape"]["contended"] == (mode == "contended")
        if mode == "contended":
            assert out["adaptive_head_converged"] > 0
            assert "contended mix" in out["metric"]


@pytest.mark.parametrize("mode", ["contended", "stream", "e2e-small",
                                  "e2e-smoke", "e2e-batched", "e2e-async",
                                  "longevity", "longevity-async", "ingest",
                                  "fleet", "fleet-worker", "failover",
                                  "day-soak", "decision-overhead", "trace-overhead",
                                  "profile-overhead", "chaos-overhead"])
def test_bench_torch_mode_raises_without_cuda(mode):
    """Without a card and without `--device cpu` a mode raises before
    any work and prints no result line: there is no fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "bench_torch.py", mode],
                          cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not [ln for ln in proc.stdout.splitlines()
                if ln.startswith("{")]


def test_default_device_raises_without_cuda(monkeypatch):
    from cook_tpu_torch import entry
    from cook_tpu_torch.device import resolve_device
    from cook_tpu_torch.ops import match

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError):
        entry.entry()
    with pytest.raises(RuntimeError):
        entry.resident_workload(R=10, P=50, H=8, U=2, C=8, forb_cap=8)
    with pytest.raises(RuntimeError):
        match.make_hosts(np.ones(4), np.ones(4))
    assert resolve_device("cpu").type == "cpu"


def test_exact_scan_rejects_other_devices():
    from cook_tpu_torch.ops import fused_match as fm

    jp = torch.zeros((8, fm.JOB_COLS), device="meta")
    hp = torch.zeros((fm.HOST_ROWS, 64), device="meta")
    forb = torch.zeros((8, 64), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fm.exact_scan(jp, hp, forb)


def test_blocked_cumsum_rejects_other_devices():
    from cook_tpu_torch.ops import segments

    with pytest.raises(ValueError, match="unsupported device"):
        segments.blocked_cumsum(torch.zeros(40, device="meta"))


@pytest.mark.cuda
def test_blocked_cumsum_kernel_equals_plain_on_cuda(monkeypatch):
    """The f32 prefix-sum kernel is bit-equal to its plain version (which
    tests/test_torch_cumsum.py holds bit-equal to XLA-CPU's cumsum) and
    to itself from run to run, on contiguous and strided inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the GPU machine only")
    from cook_tpu_torch.ops import fused_match as fm
    from cook_tpu_torch.ops import segments

    rng = np.random.default_rng(2)
    bits = lambda t: t.view(torch.int32)
    for shape in ((262144, 2), (8192,), (17,), (1,), (4097, 4)):
        x = torch.from_numpy((10.0 ** rng.uniform(-3, 3, shape)
                              * rng.choice([-1.0, 1.0], shape))
                             .astype(np.float32)).to("cuda")
        views = [x] if x.dim() == 1 else [x, x[:, 1:3]]
        for v in views:
            want = segments.blocked_cumsum_plain(v)
            before = fm.LAUNCHES["blocked_cumsum"]
            with monkeypatch.context() as m:
                m.setattr(segments, "blocked_cumsum_plain", None)
                first = segments.blocked_cumsum(v)
                second = segments.blocked_cumsum(v)
            torch.cuda.synchronize()
            assert fm.LAUNCHES["blocked_cumsum"] == before + 2
            assert torch.equal(bits(first), bits(want)), shape
            assert torch.equal(bits(first), bits(second)), shape


@pytest.mark.cuda
def test_exact_scan_cluster_edges_on_cuda():
    """The cluster kernel against its plain version at chip_smoke.py's
    edge shapes: H in {1, 33, cluster x 32, 100,000} x S in {8, 256}, one
    host taking every job, unique jobs against occupied hosts, ties, no
    feasible host, H = 16411."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the GPU machine only")
    import chip_smoke
    from cook_tpu_torch.ops import fused_match as fm

    dev = torch.device("cuda")
    for label, jp, hp, forb in chip_smoke.adversarial(
            dev, fm.exact_scan_cluster()):
        got = fm.exact_scan(jp, hp, forb)
        want = fm.exact_scan_plain(jp, hp, forb)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]), label
        assert torch.equal(got[1], want[1]), label
        chip_smoke.check_adversarial(label, jp, hp, got[0])


@pytest.mark.cuda
def test_exact_scan_group_and_bonus_routes_on_cuda():
    """The walk's bonus and groups routes against their plain versions at
    chip_smoke.py's edges (one job, S past the bonus route's job tile,
    every host on chip and beyond, plain loads, 100,000 hosts with 64
    groups, one unique group): job_host, the host stack and the (G, H)
    occupancy bit for bit, one launch each on its route's counter."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the GPU machine only")
    import chip_smoke
    from cook_tpu_torch.ops import fused_match as fm

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    for label, S, H, G, with_bonus, off in chip_smoke.scan_route_edges(
            dev, fm.exact_scan_cluster()):
        jp, hp, forb, occ, bonus = chip_smoke.group_problem(
            rng, S, H, G, with_bonus, dev)
        if off:
            bonus = chip_smoke.misaligned(bonus, 4)
        name = ("exact_scan/groups" if occ is not None else
                "exact_scan/bonus" if bonus is not None else "exact_scan")
        before = fm.LAUNCHES[name]
        got = fm.exact_scan(jp, hp, forb, occ=occ, bonus=bonus)
        want = fm.exact_scan_plain(jp, hp, forb, occ=occ, bonus=bonus)
        torch.cuda.synchronize()
        assert fm.LAUNCHES[name] == before + 1, label
        assert torch.equal(got[0], want[0]), label
        assert torch.equal(got[1].view(torch.int32),
                           want[1].view(torch.int32)), label
        if occ is not None:
            assert torch.equal(got[2], want[2]), label


@pytest.mark.cuda
def test_best_host_groups_route_on_cuda():
    """best_host with a (G, H) occupancy against its plain version: G in
    {4, 2048}, with and without a bonus and the jitter, ragged shapes and
    a misaligned occupancy (byte loads)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the GPU machine only")
    import chip_smoke
    from cook_tpu_torch.ops import fused_match as fm

    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    for N, H, G, off in ((256, 4096, 4, False), (1024, 16384, 2048, False),
                         (33, 515, 64, False), (200, 2048, 64, True)):
        jp, hp, forb, occ, bonus = chip_smoke.group_problem(rng, N, H, G,
                                                            True, dev)
        if off:
            occ = chip_smoke.misaligned(occ, 1)
        for b, spread in ((None, 0.2), (bonus, 0.0), (bonus, 0.2)):
            before = fm.LAUNCHES["best_host/groups"]
            got = fm.best_host(jp, hp, forb, b, spread, occ=occ)
            want = fm.best_host_plain(jp, hp, forb, b, spread, occ=occ)
            torch.cuda.synchronize()
            assert fm.LAUNCHES["best_host/groups"] == before + 1
            assert torch.equal(got[1], want[1]), (N, H, G)
            assert torch.equal(got[0].view(torch.int32),
                               want[0].view(torch.int32)), (N, H, G)


@pytest.mark.cuda
def test_cuda_tensor_never_reaches_plain_version(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the GPU machine only")
    from cook_tpu_torch.ops import fused_match as fm

    def refuse(*a, **k):
        raise AssertionError("plain version reached with CUDA tensors")

    monkeypatch.setattr(fm, "exact_scan_plain", refuse)
    rng = np.random.default_rng(0)
    S, H = 16, 300
    dev = torch.device("cuda")
    t = lambda a: torch.from_numpy(a).to(dev)
    hp = fm.pack_hosts(*(t(rng.uniform(8, 32, H).astype(np.float32))
                         for _ in range(2)),
                       t(np.zeros(H, np.float32)),
                       *(t(np.full(H, 32.0, np.float32)) for _ in range(2)),
                       t(np.zeros(H, np.float32)),
                       t(np.full(H, 3, np.int32)), t(np.ones(H, bool)),
                       t(np.zeros(H, bool)))
    jp = fm.pack_jobs(t(rng.uniform(1, 4, S).astype(np.float32)),
                      t(rng.uniform(1, 2, S).astype(np.float32)),
                      t(np.zeros(S, np.float32)), t(np.ones(S, bool)),
                      t(np.zeros(S, bool)))
    before = fm.LAUNCHES["exact_scan"]
    jh, _ = fm.exact_scan(jp, hp, torch.zeros((S, H), dtype=torch.uint8,
                                              device=dev))
    torch.cuda.synchronize()
    assert fm.LAUNCHES["exact_scan"] == before + 1
    assert (jh >= 0).any()


@pytest.mark.cuda
def test_best_host_kernel_equals_plain_on_cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the GPU machine only")
    from cook_tpu_torch.ops import fused_match as fm

    rng = np.random.default_rng(7)
    N, H = 200, 1000
    dev = torch.device("cuda")
    t = lambda a: torch.from_numpy(a).to(dev)
    cap = rng.uniform(16, 64, H).astype(np.float32)
    hp = fm.pack_hosts(t(cap * rng.uniform(0, 1, H).astype(np.float32)),
                       t(cap / 4), t(np.zeros(H, np.float32)), t(cap),
                       t(cap / 4), t(np.zeros(H, np.float32)),
                       t(rng.integers(0, 4, H).astype(np.int32)),
                       t(rng.random(H) < 0.95), t(rng.random(H) < 0.1))
    jp = fm.pack_jobs(t(rng.uniform(1, 10, N).astype(np.float32)),
                      t(rng.uniform(0.5, 3, N).astype(np.float32)),
                      t(np.zeros(N, np.float32)), t(rng.random(N) < 0.9),
                      t(rng.random(N) < 0.2))
    forb = t((rng.random((N, H)) < 0.1).astype(np.uint8))
    bonus = t(rng.uniform(0, 0.5, (N, H)).astype(np.float32))
    for b, spread in ((None, 0.2), (None, 0.0), (bonus, 0.0), (bonus, 0.2)):
        want = fm.best_host_plain(jp, hp, forb, b, spread)
        before = fm.LAUNCHES["best_host"]
        with monkeypatch.context() as m:
            m.setattr(fm, "best_host_plain", None)
            got = fm.best_host(jp, hp, forb, b, spread)
        torch.cuda.synchronize()
        assert fm.LAUNCHES["best_host"] == before + 1
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
        assert (got[1] >= 0).any()


@pytest.mark.cuda
def test_round_glue_does_not_sync_on_cuda():
    """The batched matcher's accept/commit glue and the segment scans
    enqueue work without a host synchronisation (a Python scalar stored
    into a CUDA tensor would stage it on the host and sync)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the GPU machine only")
    from cook_tpu_torch.ops import match, segments

    rng = np.random.default_rng(3)
    n, H = 64, 16
    dev = torch.device("cuda")
    t = lambda a: torch.from_numpy(a).to(dev)
    state = (t(np.full(n, -1, np.int32)),
             t(rng.uniform(8, 16, H).astype(np.float32)),
             t(rng.uniform(2, 4, H).astype(np.float32)),
             t(np.zeros(H, np.float32)), t(np.full(H, 3, np.int32)),
             t(np.zeros((1, H), bool)))
    choice = t(rng.integers(0, H, n))
    bids = t(rng.random(n) < 0.8)
    jobs = [t(rng.uniform(1, 4, n).astype(np.float32)),
            t(rng.uniform(0.5, 1, n).astype(np.float32)),
            t(np.zeros(n, np.float32)), t(np.zeros(n, np.int32)),
            t(rng.random(n) < 0.3)]
    seg = t(np.sort(rng.integers(0, 9, n)))
    row_idx = t(np.arange(n, dtype=np.int32))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        segments.segment_cumsum(jobs[0], seg)
        accept = match.compute_accept(state, choice, bids, *jobs, 1)
        out = match.apply_accept(state, choice, accept, *jobs, 1)
        match.apply_accept(state, choice, accept, *jobs, 1, row_idx=row_idx)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool((out[0] >= 0).any())


@pytest.mark.cuda
def test_best_host_tiling_edges_on_cuda():
    """best_host against its plain version at chip_smoke.py's tiling
    edges: N = 1, H = 1, ragged N = 33 x H = 515 (byte mask loads), a tie
    between hosts of three tiles won by the lowest index, a negative
    bonus that pushes feasible fits to <= -1.0, and operands beyond
    [2^-60, 2^60] in some host tiles and rows (those pairs divide with
    `__fdiv_rn`, the others by the per-host reciprocal)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the GPU machine only")
    import chip_smoke
    from cook_tpu_torch.ops import fused_match as fm

    for label, jp, hp, forb, bonus, spread in chip_smoke.best_host_edges(
            torch.device("cuda")):
        got = fm.best_host(jp, hp, forb, bonus, spread)
        want = fm.best_host_plain(jp, hp, forb, bonus, spread)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1]), label
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32)), label
        chip_smoke.check_best_host_edge(label, got[1])


@pytest.mark.cuda
def test_best_host_division_equals_ieee_on_cuda():
    """best_host's division (a per-host reciprocal and one correction)
    equals IEEE division at every one of the 2^46 pairs of mantissas
    (~50 s on an H100); chip_smoke.py checks the first and last 2,048 b
    mantissas x every a."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the GPU machine only")
    from cook_tpu_torch.ops import fused_match as fm

    assert fm.best_host_division_mismatches() == 0


@pytest.mark.cuda
def test_ordered_scatter_kernel_equals_plain_on_cuda(monkeypatch):
    """The ordered f32 scatter-add kernel is bit-equal to its plain
    version (which tests/test_torch_scatter.py holds bit-equal to
    XLA-CPU's segment_sum / .at[].add) and to itself from run to run, at
    the main path's shapes: 8,192 bids over 16,384 hosts (k=3), 32,768
    running tasks over 500 users (k=3), 2,048 credits with duplicates
    onto a 16,384-host lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the GPU machine only")
    import chip_smoke
    from cook_tpu_torch.ops import fused_match as fm
    from cook_tpu_torch.ops import segments

    bits = lambda t: t.view(torch.int32)
    for label, out, idx, vals in chip_smoke.scatter_cases(
            torch.device("cuda")):
        want = segments.scatter_add_ordered_plain_(out.clone(), idx, vals)
        before = fm.LAUNCHES["ordered_scatter"]
        with monkeypatch.context() as m:
            m.setattr(segments, "scatter_add_ordered_plain_", None)
            first = segments.scatter_add_ordered_(out.clone(), idx, vals)
            second = segments.scatter_add_ordered_(out.clone(), idx, vals)
        torch.cuda.synchronize()
        assert fm.LAUNCHES["ordered_scatter"] == before + 2
        assert torch.equal(bits(first), bits(want)), label
        assert torch.equal(bits(first), bits(second)), label
        ref = segments.scatter_add_ordered_plain_(out.cpu(), idx.cpu(),
                                                  vals.cpu())
        assert torch.equal(bits(first.cpu()), bits(ref)), label


@pytest.mark.cuda
def test_ordered_scatter_cluster_route_on_cuda(monkeypatch):
    """The rebalancer's usage scatter (chip_smoke.rebalance_usage_case:
    50,064 and 300,064 task slots over 501 users, k=2) takes the cluster
    route, one launch a call and no torch.sort: bit-equal to its plain
    version, to itself from run to run and to the plain version on the
    CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the GPU machine only")
    import chip_smoke
    from cook_tpu_torch.ops import fused_match as fm
    from cook_tpu_torch.ops import segments

    bits = lambda t: t.view(torch.int32)
    for T0 in (50_000, 300_000):
        out, idx, vals = chip_smoke.rebalance_usage_case(
            torch.device("cuda"), T0)
        assert segments.scatter_plan(idx.shape[0], out.shape[0])[0] == \
            "ordered_scatter/cluster"
        want = segments.scatter_add_ordered_plain_(out.clone(), idx, vals)
        before = dict(fm.LAUNCHES)
        with monkeypatch.context() as m:
            m.setattr(segments, "scatter_add_ordered_plain_", None)
            m.setattr(torch, "sort", None)
            first = segments.scatter_add_ordered_(out.clone(), idx, vals)
            second = segments.scatter_add_ordered_(out.clone(), idx, vals)
        torch.cuda.synchronize()
        assert fm.LAUNCHES["ordered_scatter/cluster"] == \
            before["ordered_scatter/cluster"] + 2, T0
        assert sum(fm.LAUNCHES.values()) == sum(before.values()) + 2, T0
        assert torch.equal(bits(first), bits(want)), T0
        assert torch.equal(bits(first), bits(second)), T0
        ref = segments.scatter_add_ordered_plain_(out.cpu(), idx.cpu(),
                                                  vals.cpu())
        assert torch.equal(bits(first.cpu()), bits(ref)), T0


@pytest.mark.cuda
def test_host_depletion_is_bit_reproducible_on_cuda():
    """apply_accept's per-host depletion of demands spanning 2**30 (wider
    than any f32 sum is exact over) goes through the ordered_scatter
    kernel on the card and gives bit-equal host lanes in two runs there,
    and the same bits as the call on the CPU (XLA's update order,
    `segments.scatter_add_ordered_`, on every device)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the GPU machine only")
    from cook_tpu_torch.ops import fused_match as fm
    from cook_tpu_torch.ops import match

    rng = np.random.default_rng(11)
    n, H = 8192, 300
    arrays = dict(
        state=(np.full(n, -1, np.int32),
               np.full(H, 2.0 ** 31, np.float32),
               np.full(H, 2.0 ** 31, np.float32),
               np.full(H, 2.0 ** 31, np.float32),
               np.full(H, n, np.int32), np.zeros((1, H), bool)),
        choice=rng.integers(0, H, n),
        accept=rng.random(n) < 0.9,
        jobs=tuple((2.0 ** rng.uniform(-10, 20, n)).astype(np.float32)
                   for _ in range(3))
        + (np.zeros(n, np.int32), np.zeros(n, bool)))

    def run(dev):
        t = lambda a: torch.from_numpy(a).to(dev)
        return match.apply_accept(
            tuple(t(a) for a in arrays["state"]), t(arrays["choice"]),
            t(arrays["accept"]), *(t(a) for a in arrays["jobs"]), 1)

    before = fm.LAUNCHES["ordered_scatter"]
    first, second = run("cuda"), run("cuda")
    assert fm.LAUNCHES["ordered_scatter"] == before + 2
    on_cpu = run("cpu")
    for lane in (1, 2, 3, 4):
        assert torch.equal(first[lane], second[lane])
        assert torch.equal(first[lane].cpu(), on_cpu[lane])


def test_sum_ordered_rejects_other_devices():
    from cook_tpu_torch.ops import segments

    with pytest.raises(ValueError, match="unsupported device"):
        segments.sum_ordered(torch.zeros(40, device="meta"))


@pytest.mark.cuda
def test_sum_ordered_kernel_equals_plain_on_cuda(monkeypatch):
    """The ordered f32 sum kernel is bit-equal to its plain version (which
    tests/test_torch_sum.py holds bit-equal to XLA-CPU's jnp.sum) and to
    itself from run to run, its last launch on the route
    sum_ordered_route names, at chip_smoke.py's sizes: one element (-0.0
    stays), sizes around a window and a level, the dense round's D =
    1,024 and H = 16,384, the one-CTA kernel's largest n, the cluster's,
    and beyond."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the GPU machine only")
    import chip_smoke
    from cook_tpu_torch.ops import fused_match as fm
    from cook_tpu_torch.ops import segments

    bits = lambda t: t.view(torch.int32)
    for label, x in chip_smoke.sum_cases(torch.device("cuda")):
        want = segments.sum_ordered_plain(x)
        plan = segments.sum_ordered_plan(x.shape[0])
        route = segments.sum_ordered_route(
            plan[-1][1] if plan else x.shape[0])
        before = fm.LAUNCHES[route]
        with monkeypatch.context() as m:
            m.setattr(segments, "sum_ordered_plain", None)
            first = segments.sum_ordered(x)
            second = segments.sum_ordered(x)
        torch.cuda.synchronize()
        assert fm.LAUNCHES[route] == before + 2, label
        assert torch.equal(bits(first), bits(want)), label
        assert torch.equal(bits(first), bits(second)), label


@pytest.mark.cuda
def test_sum_ordered_levels_route_on_cuda(monkeypatch):
    """Past 262,144 elements sum_ordered is one launch of one cluster
    (the counted "sum_ordered/cluster" route) up to 8,388,608; beyond, it
    first reduces the lower tree levels over many CTAs (the counted
    "levels" route: one launch a level), then runs the cluster: bit-equal
    to its plain version and run to run at 262,145, the 300k rebalance
    pool's T, ~1M, 8,388,608 and 8,388,609 (a level, then the
    cluster)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the GPU machine only")
    from cook_tpu_torch.ops import fused_match as fm
    from cook_tpu_torch.ops import segments

    rng = np.random.default_rng(19)
    bits = lambda t: t.view(torch.int32)
    for n in (262145, 300064, 1048573, segments.SUM_CLUSTER_MAX,
              segments.SUM_CLUSTER_MAX + 1):
        x = torch.from_numpy((10.0 ** rng.uniform(-3, 3, n)
                              * rng.choice([-1.0, 1.0], n))
                             .astype(np.float32)).to("cuda")
        want = segments.sum_ordered_plain(x)
        levels = len(segments.sum_ordered_plan(n))
        assert levels == (n > segments.SUM_CLUSTER_MAX), n
        before = dict(fm.LAUNCHES)
        with monkeypatch.context() as m:
            m.setattr(segments, "sum_ordered_plain", None)
            first = segments.sum_ordered(x)
            second = segments.sum_ordered(x)
        torch.cuda.synchronize()
        assert fm.LAUNCHES["sum_ordered/levels"] == \
            before["sum_ordered/levels"] + 2 * levels, n
        assert fm.LAUNCHES["sum_ordered/cluster"] == \
            before["sum_ordered/cluster"] + 2, n
        assert fm.LAUNCHES["sum_ordered"] == before["sum_ordered"], n
        assert torch.equal(bits(first), bits(want)), n
        assert torch.equal(bits(first), bits(second)), n


@pytest.mark.cuda
def test_rebalance_kernels_equal_plain_without_host_sync_on_cuda():
    """The rebalancer on the card at a reduced bench_rebalance shape:
    exact and capped, its sweep makes no host sync before the readback
    (PyTorch's sync debug mode set to error), launches blocked_cumsum,
    ordered_scatter and sum_ordered, and equals the same sweep with every
    kernel routed to its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the GPU machine only")
    import chip_smoke
    from cook_tpu_torch.entry import rebalance_args
    from cook_tpu_torch.ops import fused_match as fm
    from cook_tpu_torch.ops import rebalance as reb

    for gpu, cap in ((False, None), (False, 512), (True, None)):
        args, kw = rebalance_args(6000, 8, 200, 50, gpu=gpu, device="cuda")
        fm.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = reb.rebalance(*args, 0.5, 0.1, candidate_cap=cap, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for k in ("blocked_cumsum", "ordered_scatter", "sum_ordered"):
            assert fm.LAUNCHES[k] > 0, (gpu, cap, k)
        with chip_smoke.plain_kernels():
            want = reb.rebalance(*args, 0.5, 0.1, candidate_cap=cap, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.uint8), w.view(torch.uint8)), \
                (gpu, cap)
        assert bool(got.job_placed.any())


@pytest.mark.cuda
def test_blocked_cumsum_routes_on_cuda():
    """blocked_cumsum at its routes' edges (chip_smoke.cumsum_edges: one
    CTA, the cluster around its chunk edges and at its largest n, the
    device-memory route one row past it, k = 1..3, strided views):
    bit-equal to its plain version and run to run, each call counted
    under its route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the GPU machine only")
    import chip_smoke
    from cook_tpu_torch.ops import fused_match as fm
    from cook_tpu_torch.ops import segments

    bits = lambda t: t.view(torch.int32)
    for label, x in chip_smoke.cumsum_edges(torch.device("cuda")):
        route = segments.blocked_cumsum_plan(x.shape[0])[0]
        name = "blocked_cumsum/global" if route == "global" \
            else "blocked_cumsum"
        before = fm.LAUNCHES[name]
        first, second = segments.blocked_cumsum(x), segments.blocked_cumsum(x)
        want = segments.blocked_cumsum_plain(x)
        torch.cuda.synchronize()
        assert fm.LAUNCHES[name] == before + 2, label
        assert torch.equal(bits(first), bits(want)), label
        assert torch.equal(bits(first), bits(second)), label


@pytest.mark.cuda
def test_ordered_scatter_edges_on_cuda():
    """ordered_scatter at its edges (chip_smoke.scatter_edges: one
    target, all dropped, int64 keys beyond int32, k = 1..4, many long
    runs, the credits' transposed copy, the cluster route's edges, and
    the shapes beyond it): bit-equal to its plain version and run to
    run, one launch a call under the route scatter_plan names, and the
    one-launch and the cluster route call no torch.sort."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the GPU machine only")
    import chip_smoke
    from cook_tpu_torch.ops import fused_match as fm
    from cook_tpu_torch.ops import segments

    bits = lambda t: t.view(torch.int32)
    sort = torch.sort
    for label, out, idx, vals in chip_smoke.scatter_edges(
            torch.device("cuda")):
        route = segments.scatter_plan(idx.shape[0], out.shape[0])[0]
        want = segments.scatter_add_ordered_plain_(out.clone(), idx, vals)
        before = fm.LAUNCHES[route]
        if route != "ordered_scatter/sorted":
            torch.sort = None       # the on-chip routes sort on chip
        try:
            first = segments.scatter_add_ordered_(out.clone(), idx, vals)
            second = segments.scatter_add_ordered_(out.clone(), idx, vals)
        finally:
            torch.sort = sort
        torch.cuda.synchronize()
        assert fm.LAUNCHES[route] == before + 2, label
        assert torch.equal(bits(first), bits(want)), label
        assert torch.equal(bits(first), bits(second)), label


@pytest.mark.cuda
def test_sharded_scan_on_cuda_equals_exact_scan_without_step_syncs():
    """Four shards of one card: the host-sharded scan gives match_scan's
    (the exact_scan kernel's) job_host and bit-equal lanes, and reads the
    device once a call (the jobs' flags before the loop), never in a
    step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke
    from cook_tpu_torch.ops import match
    from cook_tpu_torch.parallel import sharded_match
    from cook_tpu_torch.profile_cycle import sync_sources

    dev = torch.device("cuda")
    jobs, hosts, forb, _ = chip_smoke.par_scan_problem(
        np.random.default_rng(6), 256, 1000, dev)
    scan = sharded_match.sharded_match_scan(
        sharded_match.make_host_mesh(devices=[dev] * 4))
    want = match.match_scan(jobs, hosts, forb, use_kernel=True)
    got = []
    syncs = sync_sources(lambda: got.append(scan(jobs, hosts, forb)))
    assert sum(syncs.values()) == 1, syncs
    assert list(syncs)[0].startswith(
        "cook_tpu_torch/parallel/sharded_match.py:"), syncs
    chip_smoke.check_sharded_scan(got[0], want, "cuda test")


@pytest.mark.cuda
def test_pool_sharded_cycle_on_cuda_equals_cpu():
    """The pool-sharded cycle on four shards of one card equals the same
    cycle on the CPU (the plain versions), every CycleResult field."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cook_tpu_torch.entry import pool_cycle_args
    from cook_tpu_torch.ops import cycle
    from cook_tpu_torch.parallel import pools

    dev = torch.device("cuda")
    kw = dict(num_considerable=256, sequential=False)
    got = pools.pool_sharded_cycle(pools.make_pool_mesh(devices=[dev] * 4),
                                   **kw)(pool_cycle_args(
                                       4, R=300, Pn=1500, H=192, U=12,
                                       device=dev))
    want = pools.pool_sharded_cycle(pools.make_pool_mesh(device="cpu"),
                                    **kw)(pool_cycle_args(
                                        4, R=300, Pn=1500, H=192, U=12,
                                        device="cpu"))
    for f in cycle.CycleResult._fields:
        assert torch.equal(getattr(got.result, f).cpu(),
                           getattr(want.result, f)), f
    assert int(got.stats.total_matched) == int(want.stats.total_matched) > 0
