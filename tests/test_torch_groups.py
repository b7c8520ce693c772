"""The match step with job groups and a data-locality bonus: the port's
resident cycle (cook_tpu_torch/scheduler/resident.py::device_cycle on
`entry.ResidentWorkload(groups=..., locality=...)`) against the JAX
package's `_device_cycle(use_pallas=False)` (its XLA scan and XLA dense
rounds), fed the same packed delta bundles, on the CPU; and the routing:
with `use_kernel=True` such a cycle takes the two match kernels (their
plain versions on CPU tensors), never `_scan_assign` or the plain dense
expression.

The workload fills the group lanes as the resident pool does (dense ids
in arrival order, unique host placement, num_groups = 1 or bucket(groups
seen)) and the bonus rows as sparse rows of the (Kb, H) table.

Tolerances: none. Every cycle output but why_amt exact (why_amt within
rtol 1e-6, atol 1e-3, as tests/test_torch_resident.py holds it), every
state lane exact, f32 lanes bit for bit.

The headline size (100k pending x 10k hosts, C = 1024 and 8192) is
marked slow:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_groups.py -m slow
"""
import numpy as np
import pytest
import jax
import torch

from cook_tpu.scheduler import resident as jres
from cook_tpu_torch import convert, entry
from cook_tpu_torch.ops import fused_match
from cook_tpu_torch.ops import match as tmatch
from cook_tpu_torch.scheduler import resident as tres

OUT_NAMES = ("cons_idx", "cons_host", "head_matched", "n_matched",
             "n_considerable", "mat_idx", "mat_host", "why_idx", "why_code",
             "why_amt")
J_SCATTERS = {"pend": jres._scatter_pend, "run": jres._scatter_run,
              "forb": jres._scatter_forb, "bonus": jres._scatter_bonus,
              "credit": jres._scatter_credit}
# the cells' knobs: Spark executors (unique groups) and data-local jobs
VARIANTS = {"grouped": dict(groups=(0.1, 8)),
            "locality": dict(locality=0.2)}


def _compare(cyc, jout, tout, jstate, rs):
    for name, r, g in zip(OUT_NAMES, jout, tout):
        if name == "why_amt":
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                       atol=1e-3)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                          err_msg=f"cycle {cyc} {name}")
    got = tres.state_to_numpy(rs.state)
    for table in ("pend", "run", "host"):
        for k, v in got[table].items():
            ref = np.asarray(jstate[table][k])
            if v.dtype == np.float32:
                v, ref = v.view(np.int32), ref.view(np.int32)
            np.testing.assert_array_equal(v, ref, err_msg=f"{table}.{k}")
    for k in ("forb", "bonus"):
        np.testing.assert_array_equal(got[k], np.asarray(jstate[k]),
                                      err_msg=k)


def run_against_jax(w, cycles, sequential, match_kw=None):
    """`cycles` resident cycles of workload `w` on the port (use_kernel,
    CPU tensors) and on cook_tpu's `_device_cycle`, compared each cycle;
    returns (matched per cycle, num_groups per cycle)."""
    rs = w.rs
    jstate = jax.device_put(tres.state_to_numpy(rs.state))
    qm, qc, qn = (np.asarray(q.numpy()) for q in (w.qm, w.qc, w.qn))
    matched, groups = [], []
    fused_match.reset_launches()
    for cyc in range(cycles):
        spills, bundle = rs.pack(rs.drain())
        for kind, arrays in spills:
            jstate = J_SCATTERS[kind](jstate, *arrays)
            tres.SCATTERS[kind](rs.state, *convert.tensors(arrays, "cpu"))
        G = w.num_groups
        jstate, jout = jres._device_cycle(
            jstate, bundle, qm, qc, qn, np.int32(w.C), np.int32(w.now_s),
            num_considerable=w.C, sequential=sequential, num_groups=G,
            dru_mode="default", use_pallas=False, match_kw=match_kw,
            with_bonus=rs.with_bonus, with_est=True)
        tout = rs.run_cycle(convert.tensors(bundle, "cpu"), w.qm, w.qc, w.qn,
                            w.C, w.now_s, w.C, num_groups=G, use_kernel=True,
                            sequential=sequential, match_kw=match_kw)
        _compare(cyc, jout, tout, jstate, rs)
        mat_idx, mat_host = rs.readback(tout)
        matched.append(len(mat_idx))
        groups.append(G)
        w.advance(mat_idx, mat_host)
    assert set(fused_match.LAUNCHES.values()) == {0}   # CPU: plain
    return matched, groups


@pytest.mark.parametrize("sequential", [True, False])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_resident_cycles_with_groups_or_locality_equal_jax(variant,
                                                           sequential):
    """Three chained cycles of a small pool with 10% of its jobs in unique
    groups of 8 (G = 64) or 20% with a bonus row, sequential (C = 64)
    and batched (C = 128, head 16)."""
    w = entry.resident_workload(R=400, P=3000, H=160, U=20,
                                C=64 if sequential else 128, forb_cap=512,
                                constrained=0.05, seed=5, device="cpu",
                                **VARIANTS[variant])
    if variant == "grouped":
        assert w.num_groups == 64 and not w.rs.with_bonus
    else:
        assert w.num_groups == 1 and w.rs.with_bonus
        assert w.rs.bonus_cap == 1024
    match_kw = None if sequential else (("head_exact", 16),)
    matched, _ = run_against_jax(w, 3, sequential, match_kw)
    assert min(matched) > 0


def test_workload_group_lanes_and_bonus_rows():
    """The knobs fill the pool's lanes as the resident pool would: dense
    group ids in arrival order, `size` members a group, all unique; a
    bonus slot per data-local job with LOCALITY_HOSTS nonzero entries
    below LOCALITY_MAX; freed slots and rows reused; no draw without the
    knobs (the default workload's stream is unchanged)."""
    w = entry.resident_workload(R=200, P=2000, H=96, U=10, C=64,
                                forb_cap=64, groups=(0.25, 4),
                                locality=0.3, seed=2, device="cpu")
    pm = w.rs._pend_m
    live = pm["valid"]
    grp = pm["group"][live]
    ids = np.unique(grp[grp >= 0])
    np.testing.assert_array_equal(ids, np.arange(len(ids)))
    assert (np.bincount(grp[grp >= 0])[:-1] == 4).all()
    assert (pm["unique_group"][live] == (grp >= 0)).all()
    assert 0.2 < (grp >= 0).mean() < 0.3
    assert w.num_groups == max(64, 1 << int(np.ceil(np.log2(len(ids)))))
    slots = pm["bonus_slot"][live]
    assert 0.25 < (slots >= 0).mean() < 0.35
    rows = w.rs._bonus_rows_m[slots[slots >= 0]]
    assert ((rows > 0).sum(axis=1) <= entry.LOCALITY_HOSTS).all()
    assert rows.max() < entry.LOCALITY_MAX and rows.min() >= 0
    assert len(np.unique(slots[slots >= 0])) == (slots >= 0).sum()
    for _ in range(2):
        w.cycle()
    slots = w.rs._pend_m["bonus_slot"][w.rs._pend_m["valid"]]
    assert len(np.unique(slots[slots >= 0])) == (slots >= 0).sum()
    plain = entry.resident_workload(R=200, P=2000, H=96, U=10, C=64,
                                    forb_cap=64, seed=2, device="cpu")
    again = entry.resident_workload(R=200, P=2000, H=96, U=10, C=64,
                                    forb_cap=64, groups=None, locality=0.0,
                                    seed=2, device="cpu")
    for k, v in plain.rs._pend_m.items():
        np.testing.assert_array_equal(v, again.rs._pend_m[k], err_msg=k)
    assert plain.num_groups == 1 and not plain.rs.with_bonus


@pytest.mark.parametrize("sequential", [True, False])
def test_grouped_locality_cycle_takes_the_kernels(monkeypatch, sequential):
    """With use_kernel=True a cycle with groups and a bonus never enters
    `_scan_assign` or the plain dense expression (both routed to raise:
    `_feasible` is that expression's mask, and the kernels' plain
    versions do not call it); it runs the kernels' plain versions, the
    walk with its (G, H) occupancy and the dense rounds with theirs."""
    def refuse(*a, **k):
        raise AssertionError("a plain match route ran")

    w = entry.resident_workload(R=400, P=3000, H=160, U=20,
                                C=64 if sequential else 256, forb_cap=512,
                                constrained=0.1, groups=(0.2, 8),
                                locality=0.2, seed=6, device="cpu")
    assert w.num_groups > 1 and w.rs.with_bonus
    calls = {"exact_scan": [], "best_host": []}
    real = (fused_match.exact_scan, fused_match.best_host)

    def scan(*a, **k):
        calls["exact_scan"].append((k.get("occ") is not None,
                                    k.get("bonus") is not None))
        return real[0](*a, **k)

    def dense(*a, **k):
        calls["best_host"].append((k.get("occ") is not None,
                                   a[3] is not None))
        return real[1](*a, **k)

    monkeypatch.setattr(tmatch, "_scan_assign", refuse)
    monkeypatch.setattr(tmatch, "_feasible", refuse)
    monkeypatch.setattr(fused_match, "exact_scan", scan)
    monkeypatch.setattr(fused_match, "best_host", dense)
    total = 0
    for _ in range(2):
        _, mat_idx, _ = w.cycle(use_kernel=True, sequential=sequential,
                                match_kw=None if sequential
                                else {"head_exact": 32})
        total += len(mat_idx)
    assert total > 0
    assert calls["exact_scan"] == [(True, True)] * 2
    if not sequential:
        assert calls["best_host"]
        assert set(calls["best_host"]) == {(True, True)}
    else:
        assert not calls["best_host"]


@pytest.mark.slow
@pytest.mark.parametrize("C", [1024, 8192])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_headline_cycles_with_groups_or_locality_equal_jax(variant, C):
    """The headline deployment (R = 10k, P = 100k, H = 10k, U = 500, 2%
    constrained, ports and estimated completion) with the cells' knobs:
    10% of jobs in unique groups of 8 (G = 2048) or 20% with a bonus row,
    two cycles at C = 1024 (sequential) and C = 8192 (match_rounds, head
    256). Several GB on the CPU (the locality table alone is 32,768 x
    16,384 f32, twice)."""
    w = entry.resident_workload(device="cpu", seed=0, C=C,
                                **VARIANTS[variant])
    if variant == "grouped":
        assert w.num_groups == 2048
    sequential = entry.sequential_for(C)
    match_kw = None if sequential else (("head_exact", entry.HEAD_START),)
    matched, _ = run_against_jax(w, 2, sequential, match_kw)
    assert min(matched) > 0
