"""cookcheck for the port (cook_tpu_torch.analysis) against cook_tpu's.

- R2-R14 are copies: the fixture sources of tests/test_analysis.py, with
  their cook_tpu imports rewritten to cook_tpu_torch, give the same
  findings through both analyzers, and so do the port's verbatim copies
  of cook_tpu's host modules against their originals.
- R1 is the port's own (host syncs in device code): a case for each
  sync kind it flags and for what it leaves alone, and what it names on
  the port's tree.
- `python -m cook_tpu_torch.analysis --strict` exits 0 against the
  port's baseline in a process without torch, jax or cook_tpu, and a
  CPU coordinator run under the lock witness diffs clean.
"""
from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from cook_tpu import analysis as ref_analysis
from cook_tpu.analysis import core as ref_core
from cook_tpu_torch import analysis as port_analysis
from cook_tpu_torch.analysis import core as port_core
from tests.test_torch_copies import COPIES, DIFFERENCES, LINES

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "cook_tpu_torch"
# the per-module rules the two analyzers share (R1 is the port's own)
SHARED = ("R2", "R3", "R5", "R6", "R7", "R8", "R9", "R10", "R13", "R14")
# paths the fixtures are analyzed at: rules R6-R14 are scoped by file
FIXTURE_PATHS = (
    "mod.py", "scheduler/coordinator.py", "scheduler/resident.py",
    "scheduler/federation.py", "state/store.py", "backends/agent.py",
    "native/consumefold.py", "obs/profiler.py", "obs/metrics.py",
    "utils/retry.py", "rest/api.py", "agent/daemon.py")
_REF_NAME = re.compile(r"\bcook_tpu(?=[./])")


def _to_port(text: str) -> str:
    return _REF_NAME.sub("cook_tpu_torch", text)


def _to_ref(text: str) -> str:
    return text.replace("cook_tpu_torch", "cook_tpu")


def _key(f, prefix=""):
    return (f.rule, _to_ref(f.path), f.line, f.symbol, _to_ref(f.message))


def _fixtures():
    """(single sources, multi-file packages) of tests/test_analysis.py:
    every multi-line string literal that parses to code with a def or a
    class, and every file list given to `_model` / `analyze_package`."""
    tree = ast.parse((ROOT / "tests/test_analysis.py").read_text())
    consts = {n.targets[0].id: n.value.value for n in tree.body
              if isinstance(n, ast.Assign) and len(n.targets) == 1
              and isinstance(n.targets[0], ast.Name)
              and isinstance(n.value, ast.Constant)
              and isinstance(n.value.value, str)}
    singles, packages = [], []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and "\n" in node.value:
            src = textwrap.dedent(node.value)
            try:
                parsed = ast.parse(src)
            except SyntaxError:
                continue
            if any(isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)) for n in ast.walk(parsed)):
                singles.append(src)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in ("_model", "analyze_package") \
                and node.args and isinstance(node.args[0], ast.List):
            files = []
            for elt in node.args[0].elts:
                if not (isinstance(elt, ast.Tuple) and len(elt.elts) == 2
                        and isinstance(elt.elts[0], ast.Constant)):
                    break
                src = elt.elts[1]
                text = consts.get(src.id) if isinstance(src, ast.Name) \
                    else getattr(src, "value", None)
                if not isinstance(text, str):
                    break
                files.append((elt.elts[0].value, textwrap.dedent(text)))
            else:
                packages.append(files)
    return singles, packages


SINGLES, PACKAGES = _fixtures()


def test_the_fixtures_were_found():
    assert len(SINGLES) >= 60 and len(PACKAGES) >= 5


@pytest.mark.parametrize("where", FIXTURE_PATHS)
def test_fixture_findings_equal_the_reference(where):
    """Every fixture source at `where`: the rules R2-R14 run per module
    find the same (rule, line, symbol, message) in both packages, the
    port reading the source with its imports rewritten."""
    total = 0
    for src in SINGLES:
        ref = ref_analysis.analyze_source(src, f"cook_tpu/{where}", SHARED)
        port = port_analysis.analyze_source(
            _to_port(src), f"cook_tpu_torch/{where}", SHARED)
        assert [_key(f) for f in port] == [_key(f) for f in ref], src[:300]
        total += len(ref)
    assert total > 0


def test_package_fixture_findings_equal_the_reference():
    """R11 (lock order) and R12 (durability before the ack) over every
    multi-file fixture and every single source as one module: equal in
    both packages."""
    total = 0
    groups = PACKAGES + [[("cook_tpu/scheduler/fixture.py", s)]
                         for s in SINGLES]
    for files in groups:
        ref = ref_core.analyze_package(files, ("R11", "R12"))
        port = port_core.analyze_package(
            [(_to_port(p), _to_port(s)) for p, s in files], ("R11", "R12"))
        assert [_key(f) for f in port] == [_key(f) for f in ref], files[0]
        total += len(ref)
    assert total > 0


def test_verbatim_copies_find_what_their_originals_find():
    """Every host module the port copies verbatim (imports aside), as
    named files through both analyzers at once (every rule: the
    per-module ones, R4 on the REST pair, R11 and R12 across them):
    the same findings, the package prefix aside."""
    rels = [r for r in COPIES if r.endswith(".py")
            and r not in DIFFERENCES and r not in LINES
            and not r.startswith("analysis/")]
    rules = tuple(r for r in ref_core.ALL_RULES if r != "R1")
    ref = ref_core.analyze_paths([str(ROOT / "cook_tpu" / r) for r in rels],
                                 str(ROOT), rules)
    port = port_core.analyze_paths([str(PORT / r) for r in rels],
                                   str(ROOT), rules)
    assert [_key(f) for f in port] == [_key(f) for f in ref]
    assert {f.rule for f in ref} >= {"R7"}


# ----------------------------------------------------------------------
# R1: host syncs in device code

def r1(src: str, path="cook_tpu_torch/ops/cycle.py"):
    return port_analysis.analyze_source(textwrap.dedent(src), path, ("R1",))


SYNCS = {
    "item": "x.sum().item()",
    "tolist": "x.tolist()",
    "cpu": "x.cpu()",
    "numpy": "x.detach().numpy()",
    "bool": "bool(x.any())",
    "int": "int(x.sum())",
    "float": "float(x.max())",
    "np_of_tensor": "np.asarray(x)",
    "cuda_synchronize": "torch.cuda.synchronize()",
    "event_synchronize": "ev.synchronize()",
    "stream_synchronize": "torch.cuda.current_stream(x.device).synchronize()",
    "tensor_upload": "torch.tensor(n, dtype=torch.int32, device=x.device)",
    "as_tensor_upload": "torch.as_tensor(n, device=x.device)",
    "to_device": "y.to(x.device)",
    "to_device_kw": "y.to(device=x.device, dtype=torch.float32)",
    "cuda_method": "y.cuda()",
    "nonzero_method": "x.nonzero()",
    "torch_nonzero": "torch.nonzero(x)",
    "unique": "torch.unique(x)",
    "masked_select": "torch.masked_select(x, x > 0)",
    "repeat_interleave": "x.repeat_interleave(y)",
}


@pytest.mark.parametrize("kind", sorted(SYNCS))
def test_r1_flags_each_sync_kind(kind):
    """One sync in a helper that the root calls: one R1 finding, at the
    line Python reports (a method call's: its attribute's line)."""
    fs = r1(f"""
        import numpy as np
        import torch

        def _helper(x, y, n, ev):
            z = (x
                 + 1)
            return {SYNCS[kind]}

        def rank_and_match(x, y, n, ev):
            return _helper(x, y, n, ev)
    """)
    assert [(f.rule, f.line, f.symbol) for f in fs] == \
        [("R1", 8, "_helper")], fs


CLEAN = {
    "shape": "int(x.shape[0]) + len(x) + float(x.ndim)",
    "non_blocking": "y.to(x.device, non_blocking=True)",
    "to_dtype": "y.to(torch.float32) + y.to(x.dtype)",
    "dtype_name": "y.to(f)",
    "output_size": "x.repeat_interleave(y, output_size=4)",
    "numpy_of_host": "np.arange(len(x)).reshape(2, -1).tolist()",
    "int_of_dtype_test": "int(x.dtype == torch.int64)",
}


@pytest.mark.parametrize("kind", sorted(CLEAN))
def test_r1_leaves_host_values_alone(kind):
    fs = r1(f"""
        import numpy as np
        import torch

        def rank_and_match(x, y):
            f = torch.float32
            return {CLEAN[kind]}
    """)
    assert fs == []


def test_r1_leaves_the_plain_cpu_branch_alone():
    """A wrapper's CPU branch (the plain version) is neither checked nor
    followed; its CUDA branch and a plain version reached from it are."""
    fs = r1("""
        import torch

        def plain(x):
            return int(x.sum())

        def wrapper(x):
            dev = x.device
            if dev.type == "cpu":
                return plain(x)
            if x.device.type != "cuda":
                raise ValueError(x.item())
            return x.cpu()

        def wrapper2(x):
            if x.device.type == "cuda":
                return x + 1
            else:
                return bool(x.any())

        def rank_and_match(x):
            return wrapper(x) + wrapper2(x)
    """)
    assert [(f.line, f.symbol) for f in fs] == [(13, "wrapper")]


def test_r1_only_checks_what_a_root_reaches():
    fs = r1("""
        def chip_check(x):
            return x.item()

        def rank_and_match(x):
            return x + 1
    """)
    assert fs == []


def test_r1_suppression():
    fs = r1("""
        def rank_and_match(x):
            return bool(x.any())  # cookcheck: disable=R1
    """)
    assert fs == []


def test_r1_follows_calls_across_modules(tmp_path):
    """A tree scan follows the roots into the modules they import (an
    aliased module, a from-import, a returned closure); one file alone
    sees only its own."""
    ops = tmp_path / "cook_tpu_torch" / "ops"
    par = tmp_path / "cook_tpu_torch" / "parallel"
    ops.mkdir(parents=True)
    par.mkdir(parents=True)
    (ops / "cycle.py").write_text(textwrap.dedent("""
        from cook_tpu_torch.ops import helper as helper_ops
        from cook_tpu_torch.ops.other import count

        def rank_and_match(x):
            return helper_ops.read(x) + count(x)
    """))
    (ops / "helper.py").write_text(textwrap.dedent("""
        def read(x):
            return x.item()

        def unused(x):
            return x.item()
    """))
    (ops / "other.py").write_text(textwrap.dedent("""
        def count(x):
            return int(x.sum())
    """))
    (par / "sharded_match.py").write_text(textwrap.dedent("""
        def sharded_match_scan(mesh):
            def run(x):
                return x.cpu()
            return run
    """))
    fs = port_analysis.analyze_paths([str(tmp_path)], str(tmp_path),
                                     ("R1",))
    assert sorted((f.path, f.symbol) for f in fs) == [
        ("cook_tpu_torch/ops/helper.py", "read"),
        ("cook_tpu_torch/ops/other.py", "count"),
        ("cook_tpu_torch/parallel/sharded_match.py", "run")]
    alone = port_analysis.analyze_paths([str(ops / "helper.py")],
                                        str(tmp_path), ("R1",))
    assert alone == []


def test_rule_scoping_by_directory(tmp_path):
    # an R1 violation under scheduler/ (outside resident.py) must NOT
    # fire during a tree scan (R1 covers ops/, parallel/ and
    # scheduler/resident.py), but the same file named explicitly gets
    # every rule; under ops/ it fires in the scan
    pkg = tmp_path / "cook_tpu_torch" / "scheduler"
    pkg.mkdir(parents=True)
    mod = pkg / "notops.py"
    src = textwrap.dedent("""
        def rank_and_match(x):
            return x.item()
    """)
    mod.write_text(src)
    assert port_analysis.analyze_paths([str(tmp_path)], str(tmp_path)) == []
    explicit = port_analysis.analyze_paths([str(mod)], str(tmp_path))
    assert [f.rule for f in explicit] == ["R1"]
    ops = tmp_path / "cook_tpu_torch" / "ops"
    ops.mkdir()
    (ops / "cycle.py").write_text(src)
    (pkg / "resident.py").write_text(src.replace("rank_and_match",
                                                 "device_cycle"))
    scan = port_analysis.analyze_paths([str(tmp_path)], str(tmp_path))
    assert sorted((f.rule, f.path) for f in scan) == [
        ("R1", "cook_tpu_torch/ops/cycle.py"),
        ("R1", "cook_tpu_torch/scheduler/resident.py")]


@pytest.fixture(scope="module")
def port_tree():
    """Every finding on the port's tree, no baseline, no suppression."""
    return port_analysis.analyze_paths([str(PORT)], str(ROOT),
                                       apply_suppressions=False)


def _line_of(rel, pattern):
    lines = (PORT / rel).read_text().splitlines()
    hits = [i + 1 for i, ln in enumerate(lines) if pattern in ln]
    assert len(hits) == 1, (rel, pattern, hits)
    return hits[0]


def test_r1_names_the_port_syncs(port_tree):
    """The syncs of a cycle that the card traces (PERF.md §5): the
    pageable uploads of the window cap (ops/cycle.py), the round
    predicate (ops/match.py's `pending`), the candidate walk's fallback
    branch; not the best_host division check, which no root reaches."""
    r1s = {(f.path, f.line) for f in port_tree if f.rule == "R1"}
    want = [
        ("ops/cycle.py", "cap = torch.tensor(num_considerable"),
        ("ops/cycle.py", "cap = torch.minimum(cap, torch.as_tensor("),
        ("ops/match.py", "return bool((mask & (st[0] == NO_HOST)"),
        ("ops/match.py", "if bool(need_full):"),
        ("parallel/sharded_match.py",
         "[jobs.valid, jobs.unique_group, jobs.gpus > 0]).cpu().tolist()"),
    ]
    for rel, pattern in want:
        assert (f"cook_tpu_torch/{rel}", _line_of(rel, pattern)) in r1s, \
            (rel, pattern)
    assert ("cook_tpu_torch/ops/cycle.py", 259) in r1s
    assert ("cook_tpu_torch/ops/cycle.py", 261) in r1s
    assert ("cook_tpu_torch/ops/match.py", 625) in r1s
    assert ("cook_tpu_torch/ops/match.py", 208) in r1s
    div = _line_of("ops/fused_match.py", "return int(bad.item())")
    assert ("cook_tpu_torch/ops/fused_match.py", div) not in r1s
    assert not any(p.startswith("cook_tpu_torch/scheduler/")
                   and not p.endswith("resident.py") for p, _ in r1s)


def test_port_only_lock_findings_are_none(port_tree):
    """Every R2 / R11 finding on the port's tree is one the reference's
    baseline holds for the counterpart function: the port adds no lock
    hazard of its own (one would be repaired or recorded in ROADMAP
    Queue C)."""
    ref = json.loads((ROOT / "analysis_baseline.json").read_text())
    counts, sups = {}, {}
    for f in port_tree:
        if f.path not in sups:
            sups[f.path] = port_core.collect_suppressions(
                (ROOT / f.path).read_text())
        if f.rule in ("R2", "R11") and \
                not port_core.suppressed(f, sups[f.path]):
            fp = _to_ref(f.fingerprint)
            counts[fp] = counts.get(fp, 0) + 1
    extra = {fp: n for fp, n in counts.items()
             if n > ref["findings"].get(fp, 0)}
    assert counts and extra == {}


_STRICT_CHILD = r"""
import json, runpy, sys
sys.argv = ["cook_tpu_torch.analysis", "--strict"]
try:
    runpy.run_module("cook_tpu_torch.analysis", run_name="__main__",
                     alter_sys=True)
    rc = 0
except SystemExit as e:
    rc = e.code
bad = sorted(n for n in sys.modules if n.split(".")[0] in
             ("torch", "jax", "jaxlib", "cook_tpu"))
print("RC", rc, "BAD", json.dumps(bad))
"""


def test_strict_exits_0_without_torch_jax_or_cook_tpu():
    """`python -m cook_tpu_torch.analysis --strict` over the port's tree
    against its own baseline: exit 0, and no module of torch, jax or
    cook_tpu in the process."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", _STRICT_CHILD],
                          cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "0 finding(s)" in proc.stdout
    assert proc.stdout.splitlines()[-1] == "RC 0 BAD []"


_WITNESS_CHILD = r"""
from cook_tpu_torch import e2e
r = e2e.launch_trace("cpu", 4, P0=800, H=40, U=10, pools=2, store_shards=2,
                     durable=True, pipeline_depth=1, concurrent=True)
print("LAUNCHED", sum(len(c) for c in r["per_cycle"]))
"""


def test_coordinator_run_diffs_clean_through_witness(tmp_path, capsys):
    """Coordinator cycles on the CPU (2 pools from 2 threads, 2 store
    shards, a durable log, one cycle in flight) under COOK_LOCK_WITNESS:
    every lock edge they take is one the port's static model has."""
    from cook_tpu_torch.analysis.__main__ import main

    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env.update(PYTHONPATH=str(ROOT), COOK_LOCK_WITNESS=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", _WITNESS_CHILD],
                          cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) > 0
    files = list(tmp_path.glob("witness-*.jsonl"))
    assert files
    observed = [json.loads(ln) for f in files
                for ln in f.read_text().splitlines()]
    assert any(e["to"] == "ResidentPool._ev_lock" for e in observed)
    capsys.readouterr()
    assert main([str(PORT), "--witness", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert re.search(r"(\d+) explained, 0 unexplained", out), out
    assert not re.search(r" 0 explained", out), out
