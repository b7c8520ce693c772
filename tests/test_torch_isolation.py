"""Isolation and device rules of the port (cook_tpu_torch):

* a process running the port never imports jax nor any cook_tpu module;
* no file of the port, nor chip_smoke.py, imports jax or cook_tpu;
* entry points default to CUDA and raise when it is absent;
* on a CUDA tensor each kernel wrapper launches its kernel and never
  reaches its plain version, and agrees with that plain version; the
  batched matcher's host depletion is bit-reproducible there (needs the
  card; skipped without one).
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
out, bat_idx, _ = w.cycle(sequential=False)
assert len(bat_idx) > 0
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
    for b, spread in ((None, 0.2), (None, 0.0), (bonus, 0.0)):
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
def test_host_depletion_is_bit_reproducible_on_cuda():
    """apply_accept's per-host depletion of demands spanning 2**30 (wider
    than any f32 sum is exact over) gives bit-equal host lanes in two
    runs on the card, and the same bits as the call on the CPU: each
    host's demands are added in one fixed order on every device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the GPU machine only")
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

    first, second = run("cuda"), run("cuda")
    on_cpu = run("cpu")
    for lane in (1, 2, 3, 4):
        assert torch.equal(first[lane], second[lane])
        assert torch.equal(first[lane].cpu(), on_cpu[lane])
