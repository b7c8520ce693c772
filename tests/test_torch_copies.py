"""The port's host-only modules are copies of cook_tpu's: each file
equals its original once the `cook_tpu` imports are rewritten to
`cook_tpu_torch`, apart from the deliberate differences listed here by
file and hunk. The originals are read as text, never imported.
"""
import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
REF, PORT = ROOT / "cook_tpu", ROOT / "cook_tpu_torch"

COPIES = """
config.py
utils/__init__.py utils/lockwitness.py utils/metrics.py utils/httpjson.py
utils/breaker.py
chaos/__init__.py chaos/procfault.py chaos/churn.py
state/__init__.py state/model.py state/limits.py state/pools.py
state/store.py state/task_stats.py
native/__init__.py native/consumefold.py native/eventlog.py
native/matchbook.py native/consume.cpp native/eventlog.cpp
native/matchbook.cpp
obs/__init__.py obs/decisions.py obs/export.py obs/metrics.py
obs/profiler.py obs/trace.py
scheduler/__init__.py scheduler/tensorize.py scheduler/constraints.py
scheduler/shards.py scheduler/data_locality.py scheduler/heartbeat.py scheduler/progress.py
scheduler/monitor.py scheduler/liveness.py scheduler/overload.py
scheduler/optimizer.py scheduler/unscheduled.py scheduler/federation.py
scheduler/leader.py
plugins/__init__.py plugins/pool_mover.py
rest/__init__.py rest/auth.py rest/openapi.py rest/ingest.py rest/api.py
backends/__init__.py backends/base.py backends/specwire.py
backends/mock.py backends/local.py backends/agent.py
backends/kube/__init__.py backends/kube/api.py backends/kube/checkpoint.py
backends/kube/cluster.py backends/kube/controller.py
backends/kube/http_api.py
agent/__init__.py agent/executor.py agent/file_server.py
sim/gen.py sim/analysis.py
utils/retry.py client/__init__.py agent/daemon.py agent/__main__.py
backends/kube/standin.py cli/metrics.py cli/plugins.py cli/__init__.py
cli/__main__.py native/jobclient.py native/jobclient.cpp
integrations/__init__.py integrations/dask_cook.py
integrations/spark_cook.py
analysis/__init__.py analysis/__main__.py analysis/core.py analysis/sarif.py
analysis/lock_discipline.py analysis/async_hygiene.py analysis/rest_drift.py
analysis/span_discipline.py analysis/retry_discipline.py
analysis/metrics_discipline.py analysis/epoch_discipline.py
analysis/shard_discipline.py analysis/consume_discipline.py
analysis/membership_discipline.py analysis/profiler_discipline.py
analysis/interproc.py analysis/lock_order.py analysis/durability.py
analysis/witness.py
""".split()

# (original hunk, port hunk) pairs, each applied once to the rewritten
# original. The native build writes into the port's git-ignored build
# directory through a temp name of its own process and thread: the
# original's one shared `lib<name>.so.tmp` races between test workers.
DIFFERENCES = {
    "native/__init__.py": [
        ("""the image) and cached next to the source; a stale .so (older than its
.cpp) is rebuilt.  Every consumer must degrade gracefully when the
toolchain is missing: `build(...)` returns None and callers fall back to
pure-Python implementations.""",
         """the image) and cached in the package's build directory; a stale .so
(older than its .cpp) is rebuilt.  Every consumer must degrade
gracefully when the toolchain is missing: `build(...)` returns None and
callers fall back to pure-Python implementations."""),
        ("""_DIR = os.path.dirname(os.path.abspath(__file__))
""",
         """_DIR = os.path.dirname(os.path.abspath(__file__))
# built objects go to the package's git-ignored build directory, each
# through a temp name of its own process and thread: concurrent
# processes (test workers) may build the same library at once, and the
# last os.replace installs a complete file
_OUT = os.path.join(os.path.dirname(_DIR), "_build", "native")
"""),
        ('''    """Compile native/<name>.cpp → native/lib<name>.so if needed; return
    the .so path, or None if the build fails (callers fall back)."""''',
         '''    """Compile native/<name>.cpp → _build/native/lib<name>.so if
    needed; return the .so path, or None if the build fails (callers
    fall back)."""'''),
        ("""    so = os.path.join(_DIR, f"lib{name}.so")
""",
         """    so = os.path.join(_OUT, f"lib{name}.so")
"""),
        ("""            tmp = so + ".tmp"
""",
         """            os.makedirs(_OUT, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
"""),
    ],
    # numbers are formatted into a scratch buffer and copied: the
    # original's snprintf(p, 24, ...) into the output, where fewer bytes
    # may remain, aborts under glibc's _FORTIFY_SOURCE=3 (the default of
    # some toolchains) once a task reports an exit code
    "native/consume.cpp": [
        ("""    // +1: snprintf NUL-terminates each number in place; the terminator
    // is overwritten by the next field's memcpy except possibly after
    // the very last field when tail is empty
""",
         """    // each number is formatted into numbuf and copied: snprintf in
    // place could be told 24 bytes where fewer remain, which glibc's
    // _FORTIFY_SOURCE=3 checks (and aborts on) against the allocation
    // (+1: never a zero-byte allocation)
"""),
        ("""            p += int_width(reasons[i], p);
""",
         """            size_t w = int_width(reasons[i], numbuf);
            memcpy(p, numbuf, w);                   p += w;
"""),
        ("""            p += int_width(exits[i], p);
""",
         """            size_t w = int_width(exits[i], numbuf);
            memcpy(p, numbuf, w);                   p += w;
"""),
    ],
    # the entry points users type, and read in usage strings
    "agent/daemon.py": [
        ("Entry point:  python -m cook_tpu.agent --coordinator",
         "Entry point:  python -m cook_tpu_torch.agent --coordinator"),
        ('        prog="cook_tpu.agent",',
         '        prog="cook_tpu_torch.agent",'),
    ],
    "cli/__init__.py": [
        ("Entry point: `python -m cook_tpu.cli <subcommand> ...`.",
         "Entry point: `python -m cook_tpu_torch.cli <subcommand> ...`."),
    ],
    "sim/analysis.py": [
        ("(written by `Simulator.write_run_trace` / `python -m cook_tpu.sim\n",
         "(written by `Simulator.write_run_trace` / `python -m cook_tpu_torch.sim\n"),
        ("    python -m cook_tpu.sim.analysis run1.csv [run2.csv ...] \\\n",
         "    python -m cook_tpu_torch.sim.analysis run1.csv [run2.csv ...] \\\n"),
        ('    p = argparse.ArgumentParser(prog="python -m cook_tpu.sim.analysis")',
         '    p = argparse.ArgumentParser(\n        prog="python -m cook_tpu_torch.sim.analysis")'),
    ],
    # the sidecar a kube pod runs beside its task serves the sandbox
    # with the port's file server, not the JAX package's module
    "backends/kube/http_api.py": [
        ('                            "python -m cook_tpu.agent.file_server "',
         '                            "python -m cook_tpu_torch.agent.file_server "'),
    ],
    # the supervisor runs the port's server on the device it is given
    # (the card unless the caller asks for the CPU); the original ran
    # the JAX package's server with JAX_PLATFORMS=cpu
    "chaos/procfault.py": [
        ("""``ServerSupervisor`` is the other half: it spawns the real server
(``python -m cook_tpu.rest.server``) as a subprocess with the kill
sites armed, detects SIGKILL death, and restarts it against the same
store directory with the incarnation bumped — the harness
``tests/livestack.py`` and ``bench.py crash-soak`` both drive it.""",
         """``ServerSupervisor`` is the other half: it spawns the port's server
(``python -m cook_tpu_torch.rest.server --device <device>``) as a
subprocess with the kill sites armed, detects SIGKILL death, and
restarts it against the same store directory with the incarnation
bumped — the harness ``tests/torch_livestack.py`` (and through it
``bench_torch.py failover``) drives it."""),
        ("""    incarnation bumped so the procfault rng re-rolls.
    \"\"\"
""",
         """    incarnation bumped so the procfault rng re-rolls. ``device`` is the
    server's ``--device``: "cuda" unless the caller asks for "cpu".
    \"\"\"
"""),
        ("""                 extra_env: Optional[dict] = None):
        self.config_path = config_path
""",
         """                 extra_env: Optional[dict] = None,
                 device: str = "cuda"):
        self.config_path = config_path
        self.device = device
"""),
        ("""        env.setdefault("JAX_PLATFORMS", "cpu")
""", ""),
        ("""            [sys.executable, "-m", "cook_tpu.rest.server",
             "--config", self.config_path],""",
         """            [sys.executable, "-m", "cook_tpu_torch.rest.server",
             "--config", self.config_path, "--device", self.device],"""),
    ],
    "backends/kube/standin.py": [
        ('    """`python -m cook_tpu.backends.kube.standin --port 12380',
         '    """`python -m cook_tpu_torch.backends.kube.standin --port 12380'),
    ],
    # cookcheck checks the port's tree: its entry point, default paths
    # and baseline, the self-skips, the module anchor and the lock and
    # metric vocabularies name cook_tpu_torch; R1 runs over
    # scheduler/resident.py too and follows calls across modules
    # (trace_purity.py, R1, is rewritten for the port: host syncs, not
    # jax.jit purity)
    "analysis/__init__.py": [
        ('"""cookcheck: repo-native static analysis for cook_tpu.',
         '"""cookcheck: repo-native static analysis for cook_tpu_torch.'),
        ("""  R1  trace-purity    host syncs / impurities inside functions reached
                      from ``jax.jit`` in ``ops/`` and ``parallel/``
""",
         """  R1  host syncs      device reads on the host (``.item()``,
                      ``bool(t)``, pageable uploads, ...) inside
                      functions reached from the port's device entry
                      points in ``ops/``, ``parallel/`` and
                      ``scheduler/resident.py``
"""),
        ("""Run ``python -m cook_tpu.analysis --help`` for the CLI; see
``docs/static-analysis.md`` for rule details, the per-line suppression
syntax (``# cookcheck: disable=R2``) and the baseline workflow.""",
         """Run ``python -m cook_tpu_torch.analysis --help`` for the CLI; see
``docs/static-analysis.md`` for rule details, the per-line suppression
syntax (``# cookcheck: disable=R2``) and the baseline workflow (R1's
are in ``trace_purity.py``'s docstring; the port's baseline is
``cook_tpu_torch/analysis/baseline.json``)."""),
        ("""The package is pure-stdlib AST analysis: it never imports jax, numpy,
or any cook_tpu runtime module, so it runs anywhere Python runs.""",
         """The package is pure-stdlib AST analysis: it never imports torch, jax,
numpy, anything of cook_tpu or any cook_tpu_torch runtime module, so it
runs anywhere Python runs."""),
    ],
    "analysis/__main__.py": [
        ("    python -m cook_tpu.analysis [paths...] [--strict] [--rules R1,R2]",
         "    python -m cook_tpu_torch.analysis [paths...] [--strict] [--rules R1,R2]"),
        ("""With no paths, scans the cook_tpu package of the repo the module was
imported from.""",
         """With no paths, scans the cook_tpu_torch package of the repo the
module was imported from, against the package's own baseline
(cook_tpu_torch/analysis/baseline.json)."""),
        ('''            if "cook_tpu/analysis" in rel.replace(os.sep, "/"):
                continue
            if rel in seen:
                continue
            seen.add(rel)
            with open(fp, encoding="utf-8") as f:''',
         '''            if "cook_tpu_torch/analysis" in rel.replace(os.sep, "/"):
                continue
            if rel in seen:
                continue
            seen.add(rel)
            with open(fp, encoding="utf-8") as f:'''),
        ('''            if "cook_tpu/analysis" in rel.replace(os.sep, "/"):
                continue
            if rel in seen:
                continue
            seen.add(rel)
            with open(fp, encoding="utf-8") as fh:''',
         '''            if "cook_tpu_torch/analysis" in rel.replace(os.sep, "/"):
                continue
            if rel in seen:
                continue
            seen.add(rel)
            with open(fp, encoding="utf-8") as fh:'''),
        ('        prog="python -m cook_tpu.analysis",',
         '        prog="python -m cook_tpu_torch.analysis",'),
        ('        description="cookcheck: trace-purity (R1), lock discipline (R2), "',
         '        description="cookcheck: host syncs (R1), lock discipline (R2), "'),
        ('''                    help="files or directories (default: the cook_tpu "
                         "package)")''',
         '''                    help="files or directories (default: the "
                         "cook_tpu_torch package)")'''),
        ('''                    default=os.path.join(_REPO_ROOT,
                                         "analysis_baseline.json"),
                    help="baseline file (default: analysis_baseline.json "
                         "at the repo root)")''',
         '''                    default=os.path.join(_PKG_ROOT, "analysis",
                                         "baseline.json"),
                    help="baseline file (default: the package's "
                         "analysis/baseline.json)")'''),
    ],
    "analysis/core.py": [
        ('''    "R1": ("ops", "parallel"),
''',
         '''    "R1": ("ops", "parallel", "resident.py"),
'''),
        ('''                   apply_suppressions: bool = True) -> list[Finding]:
    """Run the per-module AST rules over one source text."""
''',
         '''                   apply_suppressions: bool = True,
                   r1_reach: Optional[dict] = None) -> list[Finding]:
    """Run the per-module AST rules over one source text. `r1_reach`
    ({path: function names}, from trace_purity.reach over the scanned
    files) lets R1 follow calls into other modules."""
'''),
        ('''        findings += trace_purity.check(mod)
''',
         '''        findings += trace_purity.check(
            mod, None if r1_reach is None else r1_reach.get(path, set()))
'''),
        ('''    from cook_tpu_torch.analysis import rest_drift
    findings: list[Finding] = []
''',
         '''    from cook_tpu_torch.analysis import rest_drift, trace_purity
    findings: list[Finding] = []
    # R1 follows calls across modules: its reach over every file it
    # runs on, before the per-module pass
    r1_files = []
    if "R1" in rules:
        for path in paths:
            explicit_file = os.path.isfile(path)
            for fp in iter_py_files(path):
                rel = os.path.relpath(fp, root)
                if "cook_tpu_torch/analysis" in rel.replace(os.sep, "/"):
                    continue
                if explicit_file or "R1" in _rules_for(rel, rules):
                    with open(fp, encoding="utf-8") as f:
                        r1_files.append((rel, f.read()))
    r1_reach = trace_purity.reach(r1_files) if r1_files else None
'''),
        ('''            if "cook_tpu/analysis" in rel.replace(os.sep, "/"):
                continue
            active''',
         '''            if "cook_tpu_torch/analysis" in rel.replace(os.sep, "/"):
                continue
            active'''),
        ('''                findings += analyze_source(src, rel, active,
                                           apply_suppressions)
''',
         '''                findings += analyze_source(src, rel, active,
                                           apply_suppressions, r1_reach)
'''),
    ],
    "analysis/interproc.py": [
        (":func:`cook_tpu.utils.lockwitness.witness_lock` (the analyzer reads the",
         ":func:`cook_tpu_torch.utils.lockwitness.witness_lock` (the analyzer reads the"),
        ('''                      "cook_tpu.utils.lockwitness.witness_lock",
                      "cook_tpu.utils.lockwitness.witness_condition"}''',
         '''                      "cook_tpu_torch.utils.lockwitness.witness_lock",
                      "cook_tpu_torch.utils.lockwitness.witness_condition"}'''),
        ("# Repo-native by design: this is cook_tpu's own vocabulary.",
         "# Repo-native by design: this is cook_tpu_torch's own vocabulary."),
        ('''    if "cook_tpu" in parts:
        parts = parts[parts.index("cook_tpu"):]''',
         '''    if "cook_tpu_torch" in parts:
        parts = parts[parts.index("cook_tpu_torch"):]'''),
    ],
    "analysis/lock_discipline.py": [
        ('''    "cook_tpu.utils.lockwitness.witness_lock",
    "cook_tpu.utils.lockwitness.witness_condition",''',
         '''    "cook_tpu_torch.utils.lockwitness.witness_lock",
    "cook_tpu_torch.utils.lockwitness.witness_condition",'''),
    ],
    "analysis/lock_order.py": [
        ("Built on the interprocedural model (:mod:`cook_tpu.analysis.interproc`):",
         "Built on the interprocedural model (:mod:`cook_tpu_torch.analysis.interproc`):"),
    ],
    "analysis/metrics_discipline.py": [
        ('    for mod in ("cook_tpu.obs.metrics", "cook_tpu.utils.metrics")',
         '    for mod in ("cook_tpu_torch.obs.metrics", "cook_tpu_torch.utils.metrics")'),
    ],
    "analysis/retry_discipline.py": [
        ("`cook_tpu.utils.retry.RetryPolicy` is the one retry loop in the repo:",
         "`cook_tpu_torch.utils.retry.RetryPolicy` is the one retry loop in the port:"),
        ("`cook_tpu/utils/retry.py` itself is exempt by path",
         "`cook_tpu_torch/utils/retry.py` itself is exempt by path"),
    ],
    "analysis/witness.py": [
        ("The runtime lock-witness (:mod:`cook_tpu.utils.lockwitness`) writes one",
         "The runtime lock-witness (:mod:`cook_tpu_torch.utils.lockwitness`) writes one"),
    ],
}

# whole lines replaced, by file and line number: comments drop the
# number of the change that introduced them
LINES = {
    "analysis/interproc.py": {
        5: "found so far (the day-soak pair, the sizing hangs) spanned"},
    "obs/decisions.py": {
        4: "job's fate — ranked out, quota-gated, unplaceable, matched "
           "— and this"},
    "utils/metrics.py": {
        208: "# This IS the obs registry instance: every producer that"},
}

_IMPORT = re.compile(r"^(\s*)(from|import) cook_tpu(?=[.\s])", re.M)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_original(rel):
    text = (REF / rel).read_text()
    if rel.endswith(".py"):
        text = _IMPORT.sub(r"\1\2 cook_tpu_torch", text)
    for old, new in DIFFERENCES.get(rel, ()):
        assert text.count(old) == 1, (rel, old[:60])
        text = text.replace(old, new)
    lines = text.split("\n")
    for n, line in LINES.get(rel, {}).items():
        lines[n - 1] = line
    text = "\n".join(lines)
    assert (PORT / rel).read_text() == text


def _functions(path, names):
    src = path.read_text()
    tree = ast.parse(src)
    return {n.name: ast.get_source_segment(src, n) for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in names}


def test_federation_helpers_are_byte_identical():
    names = ("distribute_jobs", "place_pools")
    ref = _functions(REF / "parallel/federation.py", names)
    port = _functions(PORT / "parallel/federation.py", names)
    assert set(ref) == set(names) and port == ref


def test_every_host_module_of_the_port_is_listed():
    """A module the server's and the simulator's closure brings in is
    either a listed copy or a port of its own (the device-touching
    ones)."""
    ported = {"scheduler/coordinator.py", "scheduler/resident.py",
              "parallel/federation.py", "rest/server.py",
              "sim/__init__.py", "sim/__main__.py",
              "analysis/trace_purity.py"}
    for sub in ("utils", "chaos", "state", "native", "obs", "backends",
                "scheduler", "rest", "plugins", "agent", "sim", "cli",
                "client", "integrations", "analysis"):
        for f in (PORT / sub).rglob("*"):
            rel = f.relative_to(PORT).as_posix()
            if f.suffix in (".py", ".cpp") and "__pycache__" not in rel:
                assert rel in COPIES or rel in ported, rel


# the reference's modules with no counterpart of the same path in the
# port, and why
UNPORTED = {
    # the two Pallas kernels: the hand-written CUDA kernels of csrc/
    # behind ops/fused_match.py
    "ops/pallas_match.py": "ops/fused_match.py and csrc/",
    # whether Pallas lowers on the TPU: the port has one route a device
    # (its kernels on CUDA, their plain versions on the CPU), nothing to
    # probe
    "ops/pallas_probe.py": "none",
}


# the ported device modules are rewritten for PyTorch, not copied, so
# they are not diffed as text; where they decide otherwise than the
# reference on purpose (ROADMAP Queue C), the hunk that does it is listed
# here by file, each present once in the port and absent from the
# reference: (hunk, why)
PORT_DIFFERENCES = {
    "ops/match.py": [
        ("""                   & fits_exact(torch.where(p_bids[:, None], vals[:, :3],
                                            0.0), p_host, left))""",
         "an f32-cancelled running demand let a host take a bid that "
         "overcommits it"),
    ],
    "ops/cycle.py": [
        ("""    over = torch.cat([exact_overage(over[:, :2], demand[:, :2], start_idx,
                                    room[uid]), over[:, 2:]], -1)""",
         "behind a long prefix the f32 running demand refused a job that "
         "fits its quota exactly"),
    ],
    "ops/rebalance.py": [
        ("""        units = torch.cat([sp_units, c_units], 1)[:, perm]
        total = torch.cumsum(units, 1)""",
         "far into the host-major sequence the f32 prefix read a covering "
         "victim set short and left the job unplaced"),
    ],
}


@pytest.mark.parametrize("rel", sorted(PORT_DIFFERENCES))
def test_port_differences_are_listed(rel):
    port, ref = (PORT / rel).read_text(), (REF / rel).read_text()
    for hunk, why in PORT_DIFFERENCES[rel]:
        assert port.count(hunk) == 1, (rel, hunk[:60])
        assert hunk not in ref and why


# bench.py's modes with no counterpart in bench_torch.py's MODES, and
# why (ROADMAP: Queue A, and "Not queued")
UNPORTED_MODES = {
    # A/Bs the use_pallas switch, which the port does not have
    "pallas": "not queued",
    # the store and the log alone, code the port copies verbatim; none
    # reaches the device
    "crash-soak": "not queued",
    "launch": "not queued",
    "store-shard": "not queued",
}


def test_every_bench_mode_has_a_counterpart_or_a_reason():
    import bench_torch
    modes = set(re.findall(r'which == "([\w-]+)"',
                           (ROOT / "bench.py").read_text()))
    assert modes - set(bench_torch.MODES) == set(UNPORTED_MODES)


def test_every_module_of_the_reference_has_a_counterpart():
    missing = set()
    for f in REF.rglob("*.py"):
        rel = f.relative_to(REF).as_posix()
        if "__pycache__" in rel or (PORT / rel).exists():
            continue
        top = rel.split("/")[0]
        missing.add(f"{top}/*" if f"{top}/*" in UNPORTED else rel)
    assert missing == set(UNPORTED)
    assert (PORT / "ops/fused_match.py").exists()
    assert (PORT / "analysis/trace_purity.py").exists()
    assert {"exact_scan.cu", "best_host.cu"} <= {
        f.name for f in (PORT / "csrc").glob("*.cu")}


# tests/torch_daysoak.py's own-memory reading, added after _server_rss_mb
OWN_RSS_FN = '''

def _server_own_rss_mb(sup) -> float:
    """The server's resident memory less the clean pages of the files it
    maps read-only (its libraries' code and constant data): the memory
    the server itself holds, which is what grows with its backlog or a
    leak. Read from /proc/<pid>/smaps: each read-only file mapping
    counts only its Anonymous (copied-on-write) pages, every other
    mapping its whole Rss. Where smaps has no Anonymous field the
    read-only file mappings count nothing, which under-counts by their
    relocated pages (a few MB). The pages left out sit in the page
    cache, shared with every process that maps the same files: torch
    built for CUDA maps its CUDA libraries (GBs of them resident on an
    H100 host: `bench_torch.py day-soak` prints both readings)."""
    proc = getattr(sup, "_proc", None)
    if proc is None or proc.poll() is not None:
        return 0.0
    total_kb = shared_kb = 0
    clean = False
    try:
        with open(f"/proc/{proc.pid}/smaps") as f:
            for line in f:
                key = line.split(None, 1)[0]
                if key == "Rss:":
                    kb = int(line.split()[1])
                    total_kb += kb
                    if clean:
                        shared_kb += kb
                elif key == "Anonymous:" and clean:
                    shared_kb -= int(line.split()[1])
                elif not key.endswith(":"):
                    # a mapping's header: range perms offset dev inode path
                    parts = line.split(None, 5)
                    path = parts[5].strip() if len(parts) > 5 else ""
                    clean = (parts[1][1] == "-" and path != ""
                             and not path.startswith("["))
    except (OSError, IndexError, ValueError):
        return 0.0
    return (total_kb - shared_kb) / 1024.0
'''


# the soak harnesses the port's failover soak runs on, copied from the
# reference's tests/ with their imports on the port (cook_tpu ->
# cook_tpu_torch, tests.livestack -> tests.torch_livestack) and these
# hunks, each applied once: (original hunk, copy's hunk)
TEST_COPIES = {
    "torch_livestack.py": ("livestack.py", [
        # LiveServer runs the port's server on a device, and each
        # incarnation names its device (and, once stopped, its launches)
        # in the server log
        ("""- ``LiveServer``: the real server (``python -m cook_tpu.rest.server``)
  as a supervised SUBPROCESS over a durable store directory, with
  procfault kill points armable — the crash-soak harness.""",
         """- ``LiveServer``: the port's server (``python -m
  cook_tpu_torch.rest.server --device <device>``) as a supervised
  SUBPROCESS over a durable store directory, with procfault kill points
  armable — the crash-soak harness. Each incarnation writes its pid and
  device to the server log at boot, and its kernel launches on SIGTERM
  (``incarnations``)."""),
        ("""from cook_tpu_torch.rest.server import ApiServer
""",
         """from cook_tpu_torch.rest.server import INCARNATION, ApiServer
"""),
        ("""def _merge(base: dict, over: dict) -> dict:""",
         '''def incarnations(log_path) -> list:
    """The server incarnations a log holds, in boot order: each a dict
    of its pid and device, and `kernel_launches` (None until it wrote
    them on SIGTERM; a SIGKILLed incarnation never does)."""
    out: dict = {}
    try:
        with open(log_path, errors="replace") as f:
            for line in f:
                i = line.find(INCARNATION)
                if i < 0:
                    continue
                try:
                    rec = json.loads(line[i + len(INCARNATION):])
                except ValueError:
                    continue
                got = out.setdefault(rec["pid"], {
                    "pid": rec["pid"], "device": rec["device"],
                    "kernel_launches": None})
                if "kernel_launches" in rec:
                    got["kernel_launches"] = rec["kernel_launches"]
    except OSError:
        pass
    return list(out.values())


def _merge(base: dict, over: dict) -> dict:'''),
        ("""    def __init__(self, store_dir, sites=None, seed=0, max_kills=2,
                 overrides=None, name=None, port=None):""",
         """    def __init__(self, store_dir, sites=None, seed=0, max_kills=2,
                 overrides=None, name=None, port=None, device="cuda"):"""),
        ('''        pre-allocates ports and passes them in."""''',
         '''        pre-allocates ports and passes them in. ``device`` is the
        server's ``--device`` ("cuda" unless the caller asks for
        "cpu")."""'''),
        ("""            log_path=self.server_log)""",
         """            log_path=self.server_log, device=device)"""),
        ("""    def stop(self) -> None:
        self.sup.stop()""",
         '''    def incarnations(self) -> list:
        """This member's server incarnations (``incarnations``)."""
        return incarnations(self.server_log)

    def stop(self) -> None:
        self.sup.stop()'''),
    ]),
    "torch_fedsoak.py": ("fedsoak.py", [
        # the HA pair is the port's servers, on the device given
        ("""The day-soak churns the AGENT fleet under one coordinator; this tier
churns the COORDINATOR tier itself. Two real server processes (an HA
pair, ``tests.livestack.LiveServer`` with per-member file suffixes)""",
         """The day-soak churns the AGENT fleet under one coordinator; this tier
churns the COORDINATOR tier itself. Two real server processes of the
port (an HA pair, ``tests.torch_livestack.LiveServer`` with per-member
file suffixes, each on the device it is given)"""),
        ("""Evidence is COLLECTED here and asserted by the caller
(tests/test_federation_soak.py; ``bench.py failover`` measures the
MTTR half at full magnitude). Every input schedule and ledger is
written to $CHAOS_ARTIFACTS_DIR so a red run ships its replay.""",
         """Evidence is COLLECTED here and asserted by the caller
(tests/test_torch_failover_soak.py; ``bench_torch.py failover`` and
chip_smoke.py measure the MTTR half on the card). Every input schedule
and ledger is written to $CHAOS_ARTIFACTS_DIR so a red run ships its
replay."""),
        ('''                      post_jobs=2, churn=True):
    """One compressed failover day. Returns an evidence dict; asserts
    nothing. churn=False is the quiet baseline: same pair, same
    traffic, zero leader faults — exactly one epoch ever minted.''',
         '''                      post_jobs=2, churn=True, device="cuda"):
    """One compressed failover day. Returns an evidence dict; asserts
    nothing. churn=False is the quiet baseline: same pair, same
    traffic, zero leader faults — exactly one epoch ever minted. Both
    servers run on ``device`` ("cuda" unless the caller asks for
    "cpu"); their logs (``server-a.log``, ``server-b.log`` in
    ``store_root``) name each incarnation's device and, once stopped,
    its kernel launches (``tests.torch_livestack.incarnations``).'''),
        ("""        "a": LiveServer(store_root, name="a", sites=None, seed=seed,
                        max_kills=0, overrides=overrides),
        "b": LiveServer(store_root, name="b", sites=None, seed=seed,
                        max_kills=0, overrides=overrides),""",
         """        "a": LiveServer(store_root, name="a", sites=None, seed=seed,
                        max_kills=0, overrides=overrides, device=device),
        "b": LiveServer(store_root, name="b", sites=None, seed=seed,
                        max_kills=0, overrides=overrides, device=device),"""),
    ]),
    "torch_daysoak.py": ("daysoak.py", [
        # the coordinator is the port's server, on the device given, and
        # the evidence names each of its incarnations
        ("""  - transport chaos: the ``cook_tpu.chaos`` controller armed in the""",
         """  - transport chaos: the ``cook_tpu_torch.chaos`` controller armed in the"""),
        ("""  - process chaos: ``chaos.procfault`` SIGKILLs the real coordinator
    subprocess at seeded store/cycle kill points (tests.livestack);""",
         """  - process chaos: ``chaos.procfault`` SIGKILLs the real coordinator
    subprocess (the port's server, on the device it is given) at seeded
    store/cycle kill points (tests.torch_livestack);"""),
        ("""The harness COLLECTS evidence; the caller (tests/test_day_soak.py, or
``bench.py day-soak`` for the nightly full-magnitude run) asserts the
gates: zero lost jobs, at-most-once launch per task_id across every
agent incarnation, monotone instance history across coordinator
restarts, bounded server RSS, bounded front-door p99.""",
         """The harness COLLECTS evidence; the caller
(tests/test_torch_day_soak.py, chip_smoke.py, or ``bench_torch.py
day-soak`` for the full-magnitude run on the card) asserts the gates:
zero lost jobs, at-most-once launch per task_id across every agent
incarnation, monotone instance history across coordinator restarts,
bounded server RSS, bounded front-door p99."""),
        ("""from tests.torch_livestack import LiveServer
""",
         """from tests.torch_livestack import LiveServer, incarnations
"""),
        ('''                 churn=True, transport=True, kill_sites=None):
    """One compressed day. Returns an evidence dict; asserts nothing.
''',
         '''                 churn=True, transport=True, kill_sites=None,
                 device="cuda"):
    """One compressed day. Returns an evidence dict; asserts nothing.
    The server runs on ``device`` ("cuda" unless the caller asks for
    "cpu"); the evidence's ``incarnations`` are its incarnations
    (``tests.torch_livestack.incarnations``), read once it stopped, so
    the last one's kernel launches are in it.
'''),
        ("""    ``bench.py day-soak``): jobs=120, agents=6, window_s=30, wall_s=600,""",
         """    ``bench_torch.py day-soak``): jobs=120, agents=6, window_s=30,
    wall_s=600,"""),
        ("""                                 {"heartbeat_timeout_s": 6.0}})""",
         """                                 {"heartbeat_timeout_s": 6.0}},
                      device=device)"""),
        # a port-only measure: the server's own memory beside its RSS
        # (bench_torch.day_soak_gates holds a CUDA server to it)
        ("""                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0
""",
         """                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0
""" + OWN_RSS_FN),
        ("""    max_rss_mb = 0.0
""",
         """    max_rss_mb = 0.0
    max_rss_own_mb = 0.0
"""),
        ("""            max_rss_mb = max(max_rss_mb, _server_rss_mb(live.sup))
""",
         """            max_rss_mb = max(max_rss_mb, _server_rss_mb(live.sup))
            max_rss_own_mb = max(max_rss_own_mb,
                                 _server_own_rss_mb(live.sup))
"""),
        ("""            "max_rss_mb": round(max_rss_mb, 1),
""",
         """            "max_rss_mb": round(max_rss_mb, 1),
            "max_rss_own_mb": round(max_rss_own_mb, 1),
"""),
        ("""        return {
            "seed": seed,""",
         """        out = {
            "seed": seed,"""),
        ("""                pass
        live.stop()
""",
         """                pass
        live.stop()
    out["incarnations"] = incarnations(live.server_log)
    return out
"""),
    ]),
}
_TEST_IMPORT = re.compile(r"^(\s*from )tests\.livestack(?= import)", re.M)


@pytest.mark.parametrize("rel", sorted(TEST_COPIES))
def test_soak_harness_copy_equals_original(rel):
    orig, hunks = TEST_COPIES[rel]
    text = _IMPORT.sub(r"\1\2 cook_tpu_torch",
                       (ROOT / "tests" / orig).read_text())
    text = _TEST_IMPORT.sub(r"\1tests.torch_livestack", text)
    for old, new in hunks:
        assert text.count(old) == 1, (rel, old[:60])
        text = text.replace(old, new)
    assert (ROOT / "tests" / rel).read_text() == text
