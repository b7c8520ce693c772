"""The port's sequential match (cook_tpu_torch/ops/match.py,
ops/fused_match.py) against the JAX package on the same seeded inputs,
on the CPU.

The port's walk follows the reference's default route, the XLA scan
`_scan_assign` (division-form fitness, any groups, a bonus); the
reference's own two routes disagree where a division ties and the TPU
kernel's product by a reciprocal does not (`test_division_tie_*`).

Tolerances: `job_host` exact. Against `_scan_assign` the kernel's plain
version keeps every host lane and the occupancy bit for bit
(`test_exact_scan_groups_bonus_equals_scan_assign`). Against the Pallas
kernel in interpret mode (reciprocal form) the seeded inputs of
`test_exact_scan_plain_equals_pallas_interpret` hold no such tie: the
choices and so the depleted lanes are equal bit for bit, and the host
lanes against `_scan_assign` are held there as
tests/test_pallas_match.py holds them: mem within 1e-2, slots within
1e-3, occupancy exact.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cook_tpu.ops import match as jmatch
from cook_tpu.ops import pallas_match
from cook_tpu_torch import convert
from cook_tpu_torch.ops import fused_match
from cook_tpu_torch.ops import match as tmatch


def pallas_problem(seed, S=64, H=1024):
    """The inputs of tests/test_pallas_match.py:157-171."""
    rng = np.random.default_rng(seed)
    mem_h = np.where(np.arange(H) % 2 == 0, 4000.0,
                     rng.uniform(2000, 16000, H)).astype(np.float32)
    hb = jmatch.make_hosts(
        mem=mem_h, cpus=rng.uniform(4, 32, H).astype(np.float32),
        gpus=np.where(np.arange(H) % 13 == 0, 4.0, 0.0).astype(np.float32),
        task_slots=np.full(H, 5, np.int32))
    jb = jmatch.make_jobs(
        mem=rng.uniform(100, 8000, S).astype(np.float32),
        cpus=rng.uniform(0.5, 8, S).astype(np.float32),
        gpus=np.where(rng.random(S) < 0.12, 1.0, 0.0).astype(np.float32),
        unique_group=(rng.random(S) < 0.2),
        group=np.zeros(S, np.int32))
    forb = jnp.asarray(rng.random((S, H)) < 0.08)
    return jb, hb, forb


def packed(jb, hb, H, occ0=None):
    jp = pallas_match.pack_jobs(jb.mem, jb.cpus, jb.gpus, jb.valid,
                                jb.unique_group)
    occ = jnp.zeros(H, bool) if occ0 is None else jnp.asarray(occ0)
    hp = pallas_match.pack_hosts(hb.mem, hb.cpus, hb.gpus, hb.cap_mem,
                                 hb.cap_cpus, hb.cap_gpus, hb.task_slots,
                                 hb.valid, occ)
    return jp, hp


@pytest.mark.parametrize("seed", [0, 1])
def test_exact_scan_plain_equals_pallas_interpret(seed):
    jb, hb, forb = pallas_problem(seed)
    H = 1024
    jp, hp = packed(jb, hb, H)
    fu8 = forb.astype(jnp.uint8)
    jh_ref, hout_ref = pallas_match.exact_scan(jp, hp, fu8, interpret=True)
    jh, hout = fused_match.exact_scan(*convert.tensors((jp, hp, fu8), "cpu"))
    np.testing.assert_array_equal(jh.numpy(), np.asarray(jh_ref))
    np.testing.assert_array_equal(hout.numpy(), np.asarray(hout_ref))
    # and against the XLA scan, as the reference's own test holds it
    carry = (hb.mem, hb.cpus, hb.gpus, hb.task_slots,
             jnp.zeros((1, H), bool))
    c_ref, ref_hosts = jmatch._scan_assign(
        jb, hb, forb, jnp.zeros((64, H), jnp.float32), 1, carry)
    np.testing.assert_array_equal(jh.numpy(), np.asarray(ref_hosts))
    np.testing.assert_allclose(hout[fused_match.H_MEM].numpy(),
                               np.asarray(c_ref[0]), atol=1e-2)
    np.testing.assert_allclose(hout[fused_match.H_SLOTS].numpy(),
                               np.asarray(c_ref[3]).astype(np.float32),
                               atol=1e-3)
    np.testing.assert_array_equal(hout[fused_match.H_OCC0].numpy() > 0,
                                  np.asarray(c_ref[4][0]))


def test_pack_equals_reference():
    jb, hb, _ = pallas_problem(3, S=16, H=128)
    occ = np.random.default_rng(3).random(128) < 0.2
    jp, hp = packed(jb, hb, 128, occ)
    tj = convert.jobs(jb, "cpu")
    th = convert.hosts(hb, "cpu")
    tjp = fused_match.pack_jobs(tj.mem, tj.cpus, tj.gpus, tj.valid,
                                tj.unique_group)
    thp = fused_match.pack_hosts(th.mem, th.cpus, th.gpus, th.cap_mem,
                                 th.cap_cpus, th.cap_gpus, th.task_slots,
                                 th.valid, torch.from_numpy(occ))
    np.testing.assert_array_equal(tjp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(thp.numpy(), np.asarray(hp))


def _match_problem(seed, n=48, h=96, groups=4):
    rng = np.random.default_rng(seed)
    grp = rng.integers(-1, groups, n).astype(np.int32)
    kw = dict(mem=rng.uniform(1, 20, n).astype(np.float32),
              cpus=rng.uniform(0.5, 8, n).astype(np.float32),
              gpus=np.where(rng.random(n) < 0.1, 1.0, 0.0).astype(np.float32),
              valid=rng.random(n) < 0.95, group=grp,
              unique_group=(grp >= 0) & (rng.random(n) < 0.7))
    hkw = dict(mem=rng.uniform(20, 80, h).astype(np.float32),
               cpus=rng.uniform(4, 24, h).astype(np.float32),
               gpus=np.where(rng.random(h) < 0.1, 4.0, 0.0).astype(np.float32),
               task_slots=rng.integers(0, 4, h).astype(np.int32))
    forb = rng.random((n, h)) < 0.1
    bonus = rng.uniform(0, 0.3, (n, h)).astype(np.float32)
    return kw, hkw, forb, bonus


def _compare_match(ref, got):
    np.testing.assert_array_equal(got.job_host.numpy(),
                                  np.asarray(ref.job_host))
    for name in ("mem_left", "cpus_left", "gpus_left"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.slots_left.numpy(),
                                  np.asarray(ref.slots_left))


@pytest.mark.parametrize("case", ["groups", "bonus", "groups_bonus",
                                  "single_kernel"])
def test_match_scan_equals_jax(case):
    kw, hkw, forb, bonus = _match_problem(
        {"groups": 0, "bonus": 1, "groups_bonus": 2, "single_kernel": 3}[case])
    num_groups = 1 if case in ("bonus", "single_kernel") else 4
    if num_groups == 1:
        kw["group"] = np.where(kw["group"] >= 0, 0, -1).astype(np.int32)
    use_bonus = "bonus" in case
    jb, hb = jmatch.make_jobs(**kw), jmatch.make_hosts(**hkw)
    ref = jmatch.match_scan(jb, hb, jnp.asarray(forb), num_groups=num_groups,
                            bonus=jnp.asarray(bonus) if use_bonus else None)
    tj = tmatch.make_jobs(**kw, device="cpu")
    th = tmatch.make_hosts(**hkw, device="cpu")
    fused_match.reset_launches()
    got = tmatch.match_scan(tj, th, torch.from_numpy(forb),
                            num_groups=num_groups,
                            bonus=torch.from_numpy(bonus) if use_bonus
                            else None, use_kernel=True)
    _compare_match(ref, got)
    assert fused_match.LAUNCHES["exact_scan"] == 0   # CPU: plain version


def _mixed_scan(rng, S, H):
    """A mixed exact_scan problem at any (S, H): gpu and unique-group
    jobs, gpu and slot-exhausted hosts, 2% forbidden."""
    jb = jmatch.make_jobs(
        mem=rng.uniform(1, 30, S).astype(np.float32),
        cpus=rng.uniform(0.5, 6, S).astype(np.float32),
        gpus=np.where(rng.random(S) < 0.1, 1.0, 0.0).astype(np.float32),
        unique_group=rng.random(S) < 0.3, group=np.zeros(S, np.int32))
    hb = jmatch.make_hosts(
        mem=rng.uniform(10, 40, H).astype(np.float32),
        cpus=rng.uniform(2, 12, H).astype(np.float32),
        gpus=np.where(rng.random(H) < 0.05, 2.0, 0.0).astype(np.float32),
        task_slots=rng.integers(0, 3, H).astype(np.int32))
    return jb, hb, rng.random((S, H)) < 0.02


def _adversarial(case):
    """(jobs, hosts, forbidden, S, H, occ0) of one exact_scan case: the
    cluster kernel's edges (one host, a few hosts over many CTAs, one
    warp of hosts per CTA, more hosts than fit on chip, one host taking
    every job, unique jobs against occupied hosts) and the one-block
    kernel's (ties, nothing feasible, H off every tile size)."""
    rng = np.random.default_rng(11)
    occ0 = None
    shapes = {"h1": (8, 1), "h33": (8, 33), "h512": (256, 512),
              "h100000": (8, 100_000)}
    if case in shapes:
        S, H = shapes[case]
        jb, hb, forb = _mixed_scan(rng, S, H)
    elif case == "one_host":
        # host 300 starts fuller than the rest, so the bin-packer sends it
        # every job: each step must see the last step's depletion
        S, H = 256, 512
        mem = np.full(H, 1000.0, np.float32)
        mem[300] = 600.0
        jb = jmatch.make_jobs(mem=np.full(S, 1.5, np.float32),
                              cpus=np.full(S, 0.25, np.float32))
        hb = jmatch.make_hosts(mem=mem, cpus=np.full(H, 100.0, np.float32),
                               task_slots=np.full(H, 1000, np.int32))
        hb = hb._replace(cap_mem=np.full(H, 1000.0, np.float32))
        forb = np.zeros((S, H), bool)
    elif case == "unique_occ0":
        S, H = 64, 512
        jb, hb, forb = _mixed_scan(rng, S, H)
        jb = jb._replace(unique_group=np.ones(S, bool))
        occ0 = rng.random(H) < 0.3
    elif case == "all_tie":
        S, H = 16, 256
        jb = jmatch.make_jobs(mem=np.full(S, 1.0, np.float32),
                              cpus=np.full(S, 1.0, np.float32))
        hb = jmatch.make_hosts(mem=np.full(H, 16.0, np.float32),
                               cpus=np.full(H, 16.0, np.float32),
                               task_slots=np.full(H, 5, np.int32))
        forb = np.zeros((S, H), bool)
    elif case == "all_infeasible":
        S, H = 16, 256
        jb = jmatch.make_jobs(mem=rng.uniform(1, 4, S).astype(np.float32),
                              cpus=rng.uniform(1, 2, S).astype(np.float32))
        hb = jmatch.make_hosts(mem=rng.uniform(8, 16, H).astype(np.float32),
                               cpus=rng.uniform(4, 8, H).astype(np.float32))
        forb = np.ones((S, H), bool)
    elif case == "wide_operands":
        # operands beyond [2^-60, 2^60] (the CUDA kernel divides those
        # with __fdiv_rn): used < 0, capacities of 3 x 2^61 and
        # 3 x 2^-62, memory without capacity; demands of 1e-20 memory
        # and 3 x 2^59 cpus
        S, H = 64, 1024
        jb, hb, forb = _mixed_scan(rng, S, H)
        mem, cap_mem = np.array(hb.mem), np.array(hb.cap_mem)
        cap_cpus = np.array(hb.cap_cpus)
        mem[130] = 300.0
        cap_mem[400] = mem[400] = 3 * 2.0 ** 61
        cap_cpus[700] = 3 * 2.0 ** -62
        cap_mem[900], mem[900] = 0.0, 50.0
        hb = hb._replace(mem=jnp.asarray(mem), cap_mem=jnp.asarray(cap_mem),
                         cap_cpus=jnp.asarray(cap_cpus))
        jm, jc = np.array(jb.mem), np.array(jb.cpus)
        jm[1::2] = 1e-20
        jc[1::4] = 3 * 2.0 ** 59
        jb = jb._replace(mem=jnp.asarray(jm), cpus=jnp.asarray(jc))
    elif case == "used_negative":
        # free amounts above the capacity on some hosts: dividends of
        # both signs (the CUDA kernel's reciprocal route is odd in them)
        S, H = 64, 512
        jb, hb, forb = _mixed_scan(rng, S, H)
        mem, cpus = np.array(hb.mem), np.array(hb.cpus)
        mem[::7] *= 1.5
        cpus[::5] *= 1.25
        hb = hb._replace(mem=jnp.asarray(mem), cpus=jnp.asarray(cpus))
    else:   # H not a multiple of 1024 (nor of 32)
        S, H = 40, 1000
        jb, hb, forb = _mixed_scan(rng, S, H)
    return jb, hb, forb, S, H, occ0


@pytest.mark.parametrize("case", ["all_tie", "all_infeasible", "h1000",
                                  "h1", "h33", "h512", "h100000",
                                  "one_host", "unique_occ0",
                                  "wide_operands", "used_negative"])
def test_exact_scan_adversarial(case):
    jb, hb, forb, S, H, occ0 = _adversarial(case)
    occ = jnp.zeros((1, H), bool) if occ0 is None else jnp.asarray(occ0)[None]
    carry = (hb.mem, hb.cpus, hb.gpus, hb.task_slots, occ)
    c_ref, ref_hosts = jmatch._scan_assign(
        jb, hb, jnp.asarray(forb), jnp.zeros((S, H), jnp.float32), 1, carry)
    jp, hp = packed(jb, hb, H, occ0)
    jh, hout = fused_match.exact_scan(
        *convert.tensors((jp, hp, forb.astype(np.uint8)), "cpu"))
    np.testing.assert_array_equal(jh.numpy(), np.asarray(ref_hosts))
    np.testing.assert_allclose(hout[fused_match.H_MEM].numpy(),
                               np.asarray(c_ref[0]), atol=1e-5)
    np.testing.assert_array_equal(hout[fused_match.H_SLOTS].numpy(),
                                  np.asarray(c_ref[3]).astype(np.float32))
    if case == "all_tie":
        # each job takes the lowest-index host with the best fitness:
        # the first host fills up its 5 slots, then the next
        np.testing.assert_array_equal(jh.numpy(), np.arange(S) // 5)
    np.testing.assert_array_equal(hout[fused_match.H_OCC0].numpy() > 0,
                                  np.asarray(c_ref[4][0]))
    if case == "all_infeasible":
        assert (jh.numpy() == -1).all()
        np.testing.assert_array_equal(hout.numpy(), hp)
    if case == "one_host":
        assert (jh.numpy() == 300).all()
    if case == "unique_occ0":
        assert not occ0[jh.numpy()[jh.numpy() >= 0]].any()
        assert (jh.numpy() >= 0).sum() > 10


def test_exact_scan_gate():
    """Every walk the XLA scan takes: any groups (the TPU gate's one),
    any S (its multiple of 8), any H (its multiple of 1024)."""
    assert fused_match.exact_scan_ok(1024, 16384, 1)   # TPU gate refused
    assert fused_match.exact_scan_ok(8, 1000, 1)
    assert fused_match.exact_scan_ok(1024, 16384, 2)
    assert fused_match.exact_scan_ok(1024, 16384, 2048)
    assert fused_match.exact_scan_ok(4, 1024, 1)
    assert not fused_match.exact_scan_ok(8, 1024, 0)
    assert not fused_match.exact_scan_ok(8, 1024, fused_match.MAX_GROUPS)
    assert not fused_match.exact_scan_ok(8, 0, 1)
    assert not pallas_match.exact_scan_ok(1024, 16384, 1)
    assert not pallas_match.exact_scan_ok(1024, 16384, 2)
    jp = torch.zeros((8, fused_match.JOB_COLS))
    hp = torch.zeros((fused_match.HOST_ROWS, 64))
    forb = torch.zeros((8, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="shapes"):
        fused_match.exact_scan(jp, hp, forb,
                               occ=torch.zeros((4, 63), dtype=torch.bool))
    with pytest.raises(ValueError, match="shapes"):
        fused_match.exact_scan(jp, hp, forb, bonus=torch.zeros((8, 63)))
    with pytest.raises(TypeError, match="occ"):
        fused_match.exact_scan(jp, hp, forb, occ=torch.zeros((4, 64)))


def _tie_case():
    """One valid job (mem 3/64, no cpus) and two valid hosts of 1024:
    host 0 empty with 1.0 of memory, host 1 holding 0.28125 of 7.0. Both
    divisions give 3/64 exactly, a tie the lowest index wins; the TPU
    kernel's 0.328125 * RN(1/7) does not tie."""
    S, H = 8, 1024
    mem = np.zeros(S, np.float32)
    mem[0] = 0.046875
    valid = np.zeros(S, bool)
    valid[0] = True
    hmem = np.zeros(H, np.float32)
    hcap = np.zeros(H, np.float32)
    hmem[:2] = [1.0, 6.71875]
    hcap[:2] = [1.0, 7.0]
    hvalid = np.zeros(H, bool)
    hvalid[:2] = True
    jobs = dict(mem=mem, cpus=np.zeros(S, np.float32), valid=valid)
    hosts = dict(mem=hmem, cpus=np.zeros(H, np.float32), cap_mem=hcap,
                 cap_cpus=np.zeros(H, np.float32), valid=hvalid,
                 task_slots=np.full(H, 4, np.int32))
    return jobs, hosts, np.zeros((S, H), bool)


def test_division_tie_takes_lowest_host_as_reference_default():
    """The port's walk, kernel route and its plain version, gives host 0
    as cook_tpu's default route (use_pallas=False, `_scan_assign`); the
    reference's Pallas kernel (reciprocal form) gives host 1."""
    jobs, hosts, forb = _tie_case()
    jb, hb = jmatch.make_jobs(**jobs), jmatch.make_hosts(**hosts)
    ref = jmatch.match_scan(jb, hb, jnp.asarray(forb), use_pallas=False)
    H = forb.shape[1]
    carry = (hb.mem, hb.cpus, hb.gpus, hb.task_slots,
             jnp.zeros((1, H), bool))
    _, ref_scan = jmatch._scan_assign(
        jb, hb, jnp.asarray(forb), jnp.zeros(forb.shape, jnp.float32), 1,
        carry)
    assert int(ref.job_host[0]) == 0 and int(ref_scan[0]) == 0
    jp, hp = packed(jb, hb, H)
    jh_pallas, _ = pallas_match.exact_scan(jp, hp, jnp.asarray(
        forb, jnp.uint8), interpret=True)
    assert int(jh_pallas[0]) == 1
    tj = tmatch.make_jobs(**jobs, device="cpu")
    th = tmatch.make_hosts(**hosts, device="cpu")
    got = tmatch.match_scan(tj, th, torch.from_numpy(forb), use_kernel=True)
    jh, _ = fused_match.exact_scan_plain(
        *convert.tensors((jp, hp, forb.astype(np.uint8)), "cpu"))
    for x in (got.job_host, jh):
        np.testing.assert_array_equal(x.numpy(), np.asarray(ref.job_host))
    assert int(got.job_host[0]) == 0


def _group_scan_problem(seed, G, case, S=96, H=160):
    """numpy (jobs kwargs, hosts kwargs, forbidden, occupancy on entry
    (G, H), bonus (S, H)) of a grouped walk. Group ids run from -1 to
    G + 1 (clipped to [0, G - 1] in use). case: mixed | one_group (every
    job in one unique group: at most one a host) | tie_bonus (identical
    hosts: the bonus alone decides, and a higher host wins)."""
    rng = np.random.default_rng(seed)
    grp = rng.integers(-1, G + 2, S).astype(np.int32)
    jobs = dict(mem=rng.uniform(1, 20, S).astype(np.float32),
                cpus=rng.uniform(0.5, 8, S).astype(np.float32),
                gpus=np.where(rng.random(S) < 0.1, 1.0, 0.0)
                .astype(np.float32),
                valid=rng.random(S) < 0.95, group=grp,
                unique_group=(grp >= 0) & (rng.random(S) < 0.7))
    hosts = dict(mem=rng.uniform(20, 80, H).astype(np.float32),
                 cpus=rng.uniform(4, 24, H).astype(np.float32),
                 gpus=np.where(rng.random(H) < 0.1, 4.0, 0.0)
                 .astype(np.float32),
                 task_slots=rng.integers(0, 5, H).astype(np.int32))
    forb = rng.random((S, H)) < 0.1
    occ = rng.random((G, H)) < 0.1
    bonus = rng.uniform(0, 0.3, (S, H)).astype(np.float32)
    if case == "one_group":
        jobs["group"] = np.full(S, G - 1, np.int32)
        jobs["unique_group"] = np.ones(S, bool)
        jobs["valid"] = np.ones(S, bool)
    elif case == "tie_bonus":
        for k in ("mem", "cpus"):
            hosts[k] = np.full(H, 32.0, np.float32)
        hosts["gpus"] = np.zeros(H, np.float32)
        jobs["gpus"] = np.zeros(S, np.float32)
        hosts["task_slots"] = np.full(H, 2, np.int32)
        forb[:] = False
        bonus = np.zeros((S, H), np.float32)
        bonus[:, H - 7] = 0.125
    return jobs, hosts, forb, occ, bonus


@pytest.mark.parametrize("use_bonus", [False, True])
@pytest.mark.parametrize("G,case", [(2, "mixed"), (4, "mixed"),
                                    (64, "mixed"), (4, "one_group"),
                                    (64, "tie_bonus")])
def test_exact_scan_groups_bonus_equals_scan_assign(G, case, use_bonus):
    """exact_scan's plain version with a (G, H) occupancy (set on entry)
    and an optional bonus against the reference's XLA scan step for
    step: job_host, every host lane and the occupancy bit for bit."""
    jobs, hosts, forb, occ, bonus = _group_scan_problem(G, G, case)
    S, H = forb.shape
    if not use_bonus:
        bonus = np.zeros((S, H), np.float32)
    jb, hb = jmatch.make_jobs(**jobs), jmatch.make_hosts(**hosts)
    carry = (hb.mem, hb.cpus, hb.gpus, hb.task_slots, jnp.asarray(occ))
    c_ref, ref_hosts = jmatch._scan_assign(
        jb, hb, jnp.asarray(forb), jnp.asarray(bonus), G, carry)
    tj = tmatch.make_jobs(**jobs, device="cpu")
    th = tmatch.make_hosts(**hosts, device="cpu")
    jp = fused_match.pack_jobs(tj.mem, tj.cpus, tj.gpus, tj.valid,
                               tj.unique_group, tj.group)
    hp = fused_match.pack_hosts(th.mem, th.cpus, th.gpus, th.cap_mem,
                                th.cap_cpus, th.cap_gpus, th.task_slots,
                                th.valid, torch.zeros(H, dtype=torch.bool))
    fused_match.reset_launches()
    jh, hout, occ_out = fused_match.exact_scan(
        jp, hp, torch.from_numpy(forb), occ=torch.from_numpy(occ),
        bonus=torch.from_numpy(bonus) if use_bonus else None)
    assert fused_match.LAUNCHES["exact_scan"] == 0      # CPU: plain
    np.testing.assert_array_equal(jh.numpy(), np.asarray(ref_hosts))
    for k, lane in ((0, fused_match.H_MEM), (1, fused_match.H_CPUS),
                    (2, fused_match.H_GPUS)):
        np.testing.assert_array_equal(
            hout[lane].numpy().view(np.int32),
            np.asarray(c_ref[k]).view(np.int32), err_msg=str(lane))
    np.testing.assert_array_equal(hout[fused_match.H_SLOTS].numpy(),
                                  np.asarray(c_ref[3]).astype(np.float32))
    assert occ_out.dtype == torch.bool
    np.testing.assert_array_equal(occ_out.numpy(), np.asarray(c_ref[4]))
    np.testing.assert_array_equal(hout[fused_match.H_OCC0].numpy(),
                                  hp[fused_match.H_OCC0].numpy())
    placed = jh.numpy() >= 0
    assert placed.sum() > 0
    if case == "one_group":
        # one unique group: at most one member a host, none on a host
        # its group held on entry
        hosts_used = jh.numpy()[placed]
        assert len(set(hosts_used.tolist())) == len(hosts_used)
        assert not occ[G - 1, hosts_used].any()
    if case == "tie_bonus" and use_bonus:
        # the bonus breaks the tie between identical hosts
        assert (jh.numpy()[placed][:1] == H - 7).all()


def test_inversion_audit_copy_agrees():
    kw, hkw, forb, _ = _match_problem(5, groups=1)
    kw["unique_group"] = np.zeros_like(kw["unique_group"])
    jb, hb = jmatch.make_jobs(**kw), jmatch.make_hosts(**hkw)
    jh = np.random.default_rng(5).integers(-1, 96, 48)
    ref = jmatch.inversion_positions_np(jb, hb, forb, jh)
    got = tmatch.inversion_positions_np(
        tmatch.make_jobs(**kw, device="cpu"),
        tmatch.make_hosts(**hkw, device="cpu"), forb, torch.from_numpy(jh))
    np.testing.assert_array_equal(got, ref)
