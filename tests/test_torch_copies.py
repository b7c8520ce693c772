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
    "backends/kube/standin.py": [
        ('    """`python -m cook_tpu.backends.kube.standin --port 12380',
         '    """`python -m cook_tpu_torch.backends.kube.standin --port 12380'),
    ],
}

# whole lines replaced, by file and line number: two comments drop the
# number of the change that introduced them
LINES = {
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
              "sim/__init__.py", "sim/__main__.py"}
    for sub in ("utils", "chaos", "state", "native", "obs", "backends",
                "scheduler", "rest", "plugins", "agent", "sim", "cli",
                "client", "integrations"):
        for f in (PORT / sub).rglob("*"):
            rel = f.relative_to(PORT).as_posix()
            if f.suffix in (".py", ".cpp") and "__pycache__" not in rel:
                assert rel in COPIES or rel in ported, rel


# the reference's modules with no counterpart of the same path in the
# port, and why
UNPORTED = {
    # the static checker; its rule R1 is about jax.jit purity: still to
    # port, with R1 re-aimed at host syncs in the port's device functions
    "analysis/*": "still to port",
    # the two Pallas kernels: the hand-written CUDA kernels of csrc/
    # behind ops/fused_match.py
    "ops/pallas_match.py": "ops/fused_match.py and csrc/",
    # whether Pallas lowers on the TPU: the port has one route a device
    # (its kernels on CUDA, their plain versions on the CPU), nothing to
    # probe
    "ops/pallas_probe.py": "none",
}


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
    assert {"exact_scan.cu", "best_host.cu"} <= {
        f.name for f in (PORT / "csrc").glob("*.cu")}
