"""Isolation and device rules of the port (cook_tpu_torch):

* a process running the port never imports jax nor any cook_tpu module;
* no file of the port, nor chip_smoke.py, imports jax or cook_tpu;
* entry points default to CUDA and raise when it is absent;
* on a CUDA tensor the exact_scan wrapper launches the kernel and never
  reaches the plain version (needs the card; skipped without one).
"""
import ast
import os
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
for m in mods:
    importlib.import_module(m)
from cook_tpu_torch import entry
w = entry.resident_workload(R=40, P=200, H=32, U=4, C=16, forb_cap=32,
                            device="cpu")
out, mat_idx, _ = w.cycle()
fn, args = entry.entry(device="cpu")
res = fn(*args)
assert int(res.n_matched) > 0 and len(mat_idx) > 0
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


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("name", ["package", "chip_smoke"])
def test_no_static_import_of_jax_or_cook_tpu(name):
    files = sorted(PORT.rglob("*.py")) if name == "package" \
        else [ROOT / "chip_smoke.py"]
    assert files
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "cook_tpu"), (f, mod)


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
