"""The port's resident cycle (cook_tpu_torch/scheduler/resident.py::
device_cycle) against the JAX package's `_device_cycle(use_pallas=False)`
on the CPU: the same state and the same packed delta bundles, three
chained cycles, the first carrying spill-over beyond DELTA_CHUNK and
FORB_CHUNK.

The port runs the kernel route (`use_kernel=True`: on CPU tensors the
kernel's plain version). Tolerances: every output and every integer /
bool state lane exact; f32 state lanes exact (same f32 operations).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cook_tpu.scheduler import resident as jres
from cook_tpu_torch import convert, entry
from cook_tpu_torch.ops import fused_match
from cook_tpu_torch.scheduler import resident as tres

OUT_NAMES = ("cons_idx", "cons_host", "head_matched", "n_matched",
             "n_considerable", "mat_idx", "mat_host", "why_idx", "why_code",
             "why_amt")
J_SCATTERS = {"pend": jres._scatter_pend, "run": jres._scatter_run,
              "forb": jres._scatter_forb, "bonus": jres._scatter_bonus,
              "credit": jres._scatter_credit}


def _assert_state_equal(jstate, tstate):
    got = tres.state_to_numpy(tstate)
    for table in ("pend", "run", "host"):
        for k, v in got[table].items():
            np.testing.assert_array_equal(
                v, np.asarray(jstate[table][k]), err_msg=f"{table}.{k}")
    for k in ("forb", "bonus"):
        np.testing.assert_array_equal(got[k], np.asarray(jstate[k]),
                                      err_msg=k)


def test_device_cycle_equals_jax_three_cycles():
    w = entry.resident_workload(R=400, P=6000, H=200, U=20, C=64,
                               forb_cap=512, constrained=0.05, seed=3,
                               device="cpu")
    rs = w.rs
    assert rs.Pcap == 8192 and rs.with_est
    jstate = jax.device_put(tres.state_to_numpy(rs.state))
    # first cycle: more changed rows than one chunk holds
    rows = np.arange(tres.DELTA_CHUNK + 700)
    rs.pend_m["priority"][rows] = (rs.pend_m["priority"][rows] + 1) % 3
    rs.mark_pend(rows)
    rs.mark_forb(range(tres.FORB_CHUNK + 40))
    qm, qc, qn = (np.asarray(q.numpy()) for q in (w.qm, w.qc, w.qn))
    fused_match.reset_launches()
    spilled = False
    for cyc in range(3):
        spills, bundle = rs.pack(rs.drain())
        spilled |= bool(spills)
        for kind, arrays in spills:
            jstate = J_SCATTERS[kind](jstate, *arrays)
        jstate, jout = jres._device_cycle(
            jstate, bundle, qm, qc, qn, np.int32(w.C), np.int32(w.now_s),
            num_considerable=w.C, sequential=True, num_groups=1,
            dru_mode="default", use_pallas=False, match_kw=None,
            with_bonus=False, with_est=True)
        for kind, arrays in spills:
            tres.SCATTERS[kind](rs.state, *convert.tensors(arrays, "cpu"))
        tout = rs.dispatch(convert.tensors(bundle, "cpu"), w.qm, w.qc, w.qn,
                           w.C, w.now_s, w.C, use_kernel=True)
        for name, r, g in zip(OUT_NAMES, jout, tout):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                          err_msg=f"cycle {cyc} {name}")
        _assert_state_equal(jstate, rs.state)
        mat_idx, mat_host = rs.readback(tout)
        assert len(mat_idx) == int(tout[3]) > 0
        # matched rows are invalid afterwards, on the device
        assert not rs.state["pend"]["valid"][torch.from_numpy(
            mat_idx).long()].any()
        w.advance(mat_idx, mat_host)
    assert spilled
    assert fused_match.LAUNCHES["exact_scan"] == 0   # CPU: plain version


@pytest.mark.parametrize("use_kernel,head", [(False, 16), (True, 0)])
def test_device_cycle_batched_equals_jax(use_kernel, head):
    """device_cycle(sequential=False) against the reference's
    `_device_cycle(sequential=False, use_pallas=False)` over three
    chained cycles. With use_kernel the port's dense rounds run
    best_host's plain version, the reference its XLA formula (no head,
    so the head's reciprocal/division forms never meet). mat_idx,
    mat_host, why_code and every integer state lane exact; f32 host lanes
    within rtol 1e-5, atol 1e-5 (per-host sums added in another order)."""
    w = entry.resident_workload(R=400, P=3000, H=160, U=20, C=128,
                                forb_cap=512, constrained=0.1, seed=8,
                                device="cpu")
    rs = w.rs
    jstate = jax.device_put(tres.state_to_numpy(rs.state))
    qm, qc, qn = (np.asarray(q.numpy()) for q in (w.qm, w.qc, w.qn))
    match_kw = (("head_exact", head),)
    fused_match.reset_launches()
    for cyc in range(3):
        spills, bundle = rs.pack(rs.drain())
        for kind, arrays in spills:
            jstate = J_SCATTERS[kind](jstate, *arrays)
            tres.SCATTERS[kind](rs.state, *convert.tensors(arrays, "cpu"))
        jstate, jout = jres._device_cycle(
            jstate, bundle, qm, qc, qn, np.int32(w.C), np.int32(w.now_s),
            num_considerable=w.C, sequential=False, num_groups=1,
            dru_mode="default", use_pallas=False, match_kw=match_kw,
            with_bonus=False, with_est=True)
        tout = rs.dispatch(convert.tensors(bundle, "cpu"), w.qm, w.qc, w.qn,
                           w.C, w.now_s, w.C, use_kernel=use_kernel,
                           sequential=False, match_kw=match_kw)
        for name, r, g in zip(OUT_NAMES, jout, tout):
            if name == "why_amt":
                np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                           rtol=1e-6, atol=1e-3)
            else:
                np.testing.assert_array_equal(
                    g.numpy(), np.asarray(r), err_msg=f"cycle {cyc} {name}")
        got = tres.state_to_numpy(rs.state)
        for table in ("pend", "run", "host"):
            for k, v in got[table].items():
                ref = np.asarray(jstate[table][k])
                if v.dtype == np.float32 and table == "host":
                    np.testing.assert_allclose(v, ref, rtol=1e-5, atol=1e-5,
                                               err_msg=f"host.{k}")
                else:
                    np.testing.assert_array_equal(v, ref,
                                                  err_msg=f"{table}.{k}")
        mat_idx, mat_host = rs.readback(tout)
        assert len(mat_idx) == int(tout[3]) > 0
        assert not rs.state["pend"]["valid"][torch.from_numpy(
            mat_idx).long()].any()
        w.advance(mat_idx, mat_host)
    assert fused_match.LAUNCHES["best_host"] == 0   # CPU: plain version


def test_workload_batched_sizing_and_choice():
    """C = 8192 sizes the pool as the reference's rebuild does and takes
    the coordinator's batched matcher; C = 1024 stays sequential."""
    assert entry.sequential_for(2048) and not entry.sequential_for(2049)
    assert entry.HEAD_LADDER == (0, 64, 128, 256)
    assert entry.HEAD_START == 256
    from cook_tpu.scheduler.coordinator import AdaptiveHead, SchedulerConfig
    assert AdaptiveHead.LADDER == entry.HEAD_LADDER
    assert AdaptiveHead().head == entry.HEAD_START
    assert SchedulerConfig().sequential_match_threshold == \
        entry.SEQUENTIAL_MATCH_THRESHOLD
    w = entry.resident_workload(R=10_000, P=100_000, H=10_000, U=50,
                                C=8192, forb_cap=64, constrained=0.0,
                                device="cpu")
    assert (w.rs.Pcap, w.rs.Rcap, w.rs.Hcap) == (262144, 32768, 16384)


def test_workload_batched_cycles_and_invariants():
    w = entry.resident_workload(R=300, P=4000, H=128, U=10, C=2560,
                                forb_cap=256, seed=2, device="cpu")
    total = 0
    for _ in range(2):
        out, mat_idx, mat_host = w.cycle(match_kw={"head_exact": 64})
        total += len(mat_idx)
        h = w.rs.state["host"]
        for lane in ("mem", "cpus", "gpus"):
            assert (h[lane][:-1] >= -1e-6).all(), lane
        assert (h["task_slots"][:-1] >= 0).all()
        assert (mat_host >= 0).all() and (mat_host < 128).all()
    assert total > 0


def test_workload_cycles_and_invariants():
    w = entry.resident_workload(R=300, P=2000, H=128, U=10, C=64,
                                forb_cap=256, seed=1, device="cpu")
    total = 0
    for _ in range(4):
        out, mat_idx, mat_host = w.cycle()
        total += len(mat_idx)
        h = w.rs.state["host"]
        for lane in ("mem", "cpus", "gpus"):
            assert (h[lane][:-1] >= -1e-6).all(), lane
        assert (h["task_slots"][:-1] >= 0).all()
        assert (mat_host >= 0).all() and (mat_host < 128).all()
        assert out[5].dtype == torch.int32
    assert total > 0


def test_state_round_trip_keeps_dtypes():
    w = entry.resident_workload(R=50, P=200, H=64, U=4, C=16, forb_cap=64,
                               device="cpu")
    back = tres.state_to_numpy(w.rs.state)
    for k, v in w.rs.pend_m.items():
        assert back["pend"][k].dtype == v.dtype, k
        np.testing.assert_array_equal(back["pend"][k], v)
    assert back["forb"].dtype == bool and back["forb"].shape == (64, 64)
    assert w.rs.state["forb"].shape == (65, 64)      # + sink row


def _bonus_state(seed=4):
    """A small ResidentState with the data-locality bonus lane on and
    a unique-placement group (the kernel-ineligible resident path)."""
    rng = np.random.default_rng(seed)
    P, R, H, U = 256, 128, 64, 6
    rs = tres.ResidentState(P, R, H, forb_cap=32, bonus_cap=16,
                            with_bonus=True, device="cpu")
    pm, rm, hm = rs.pend_m, rs.run_m, rs.host_m
    n = 200
    pm["user"][:n] = rng.integers(0, U, n)
    pm["mem"][:n] = rng.uniform(1, 10, n)
    pm["cpus"][:n] = rng.uniform(0.5, 4, n)
    pm["priority"][:n] = rng.integers(0, 3, n)
    pm["start_time"][:n] = rng.integers(0, 50, n)
    pm["valid"][:n] = True
    pm["mem_share"][:n], pm["cpus_share"][:n] = 1000.0, 200.0
    pm["bonus_slot"][:n] = np.where(rng.random(n) < 0.3,
                                    rng.integers(0, 16, n), -1)
    pm["forb_slot"][:n] = np.where(rng.random(n) < 0.1,
                                   rng.integers(0, 32, n), -1)
    rm["user"][:64] = rng.integers(0, U, 64)
    rm["mem"][:64] = rng.uniform(1, 10, 64)
    rm["cpus"][:64] = rng.uniform(1, 4, 64)
    rm["valid"][:64] = True
    hm["cap_mem"][:] = rng.uniform(32, 128, H)
    hm["cap_cpus"][:] = rng.uniform(8, 32, H)
    hm["mem"][:], hm["cpus"][:] = hm["cap_mem"], hm["cap_cpus"]
    hm["valid"][:], hm["task_slots"][:], hm["ports"][:] = True, 50, 100
    rs.forb_m[:] = rng.random((32, H)) < 0.2
    rs.upload()
    rs.bonus_m[:] = rng.uniform(0, 0.5, (16, H))
    rs.mark_bonus(range(16))
    rs.credit(3, mem=2.0, cpus=1.0, slots=1, ports=2)
    return rs


def test_device_cycle_with_bonus_equals_jax():
    rs = _bonus_state()
    jstate = jax.device_put(tres.state_to_numpy(rs.state))
    spills, bundle = rs.pack(rs.drain())
    assert not spills and bundle[-1].shape == (tres.BONUS_CHUNK, 64)
    q = np.full(6, np.float32(3.4e38))
    qn = np.full(6, 1e9, np.float32)
    jstate, jout = jres._device_cycle(
        jstate, bundle, q, q, qn, np.int32(48), np.int32(0),
        num_considerable=64, sequential=True, num_groups=1,
        dru_mode="default", use_pallas=False, match_kw=None,
        with_bonus=True, with_est=False)
    fused_match.reset_launches()
    tout = rs.dispatch(convert.tensors(bundle, "cpu"), torch.from_numpy(q),
                       torch.from_numpy(q), torch.from_numpy(qn), 48, 0, 64,
                       use_kernel=True)
    for name, r, g in zip(OUT_NAMES, jout, tout):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=name)
    _assert_state_equal(jstate, rs.state)
    assert int(tout[4]) == 48 and int(tout[3]) > 0
    # a bonus makes the call kernel-ineligible: the plain loop ran
    assert fused_match.LAUNCHES["exact_scan"] == 0


def test_hostset_scatter_equals_jax():
    rs = _bonus_state(5)
    rng = np.random.default_rng(5)
    idx = np.full(tres.HOSTSET_CHUNK, 64, np.int32)
    idx[:5] = [0, 7, 9, 33, 63]
    hf = rng.uniform(0, 50, (len(tres.HOST_F32), tres.HOSTSET_CHUNK)) \
        .astype(np.float32)
    hi = rng.integers(0, 3, (len(tres.HOST_I32), tres.HOSTSET_CHUNK)) \
        .astype(np.int32)
    jstate = jres._scatter_hostset(
        jax.device_put(tres.state_to_numpy(rs.state)), idx, hf, hi)
    tres.scatter_hostset(rs.state, *convert.tensors((idx, hf, hi), "cpu"))
    _assert_state_equal(jstate, rs.state)


def test_convert_state_from_jax_arrays():
    rs = _bonus_state(6)
    jstate = jax.device_put(tres.state_to_numpy(rs.state))
    back = convert.state(jstate, "cpu")
    _assert_state_equal(jstate, back)
    for k, v in back["host"].items():
        assert v.dtype == rs.state["host"][k].dtype, k
