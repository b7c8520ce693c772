"""The port's batched matcher (cook_tpu_torch/ops/match.py::match_rounds)
against the JAX package's match_rounds on the same seeded inputs, on the
CPU. The problems exercise each round kind: plain cpu/mem jobs (window +
pairing rounds), unconstrained gpu jobs (gpu window rounds), constrained
and gpu jobs (dense rounds), and a locality bonus (dense rounds only,
spread forced to 0).

Tolerances: `job_host` and `slots_left` exact. Host lanes exact on
dyadic inputs (every demand and capacity a multiple of 1/8, so f32 sums
do not depend on association); otherwise within rtol 1e-5, atol 1e-5
(the port adds each host's accepted demands in a fixed doubling order,
XLA in row order). Every case also checks that no host is oversubscribed
and that queue positions < head_exact have no head-of-line inversion.

With the kernels on, the port is held against `use_pallas=True,
pallas_interpret=True` at shapes JAX's dense-round gate takes (H a
multiple of 128, and H <= 1024 or a multiple of 1024). JAX's exact head
then runs `_scan_assign` (division form) below H = 1024, the port's runs
exact_scan's plain version (reciprocal form): host capacities are powers
of two there, where the two forms are equal.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cook_tpu.ops import match as jmatch
from cook_tpu_torch.ops import fused_match
from cook_tpu_torch.ops import match as tmatch


def problem(seed, kind, n=256, h=128, dyadic=True, pow2=False, groups=1):
    """numpy (jobs kwargs, hosts kwargs, forbidden (n, h), bonus or None)
    of one matcher input. kind: plain | gpu | dense | bonus."""
    rng = np.random.default_rng(seed)

    def q(a):
        a = np.asarray(a, np.float32)
        return (np.round(a * 8) / 8).astype(np.float32) if dyadic else a

    jobs = dict(mem=q(rng.uniform(1, 10, n)), cpus=q(rng.uniform(0.5, 3, n)),
                valid=rng.random(n) < 0.95)
    gpu_jobs = kind in ("gpu", "dense")
    jobs["gpus"] = np.where(gpu_jobs & (rng.random(n) < 0.15), 1.0,
                            0.0).astype(np.float32)
    cap_gpus = np.where(rng.random(h) < 0.2, 4.0, 0.0).astype(np.float32)
    if pow2:
        cap_mem = np.full(h, 64.0, np.float32)
        cap_cpus = np.full(h, 16.0, np.float32)
    else:
        cap_mem = q(rng.uniform(24, 72, h))
        cap_cpus = q(rng.uniform(6, 18, h))
    used = rng.uniform(0, 0.6, h)
    hosts = dict(mem=q(cap_mem * (1 - used)), cpus=q(cap_cpus * (1 - used)),
                 gpus=q(cap_gpus * rng.integers(0, 2, h)), cap_mem=cap_mem,
                 cap_cpus=cap_cpus, cap_gpus=cap_gpus,
                 valid=rng.random(h) < 0.97,
                 task_slots=rng.integers(0, 12, h).astype(np.int32))
    forb = np.zeros((n, h), bool)
    if kind == "dense":
        rows = rng.random(n) < 0.3
        forb[rows] = rng.random((int(rows.sum()), h)) < 0.2
    if groups > 1:
        grp = rng.integers(-1, groups, n).astype(np.int32)
        jobs["group"] = grp
        jobs["unique_group"] = (grp >= 0) & (rng.random(n) < 0.7)
    bonus = (q(rng.uniform(0, 0.5, (n, h))) if kind == "bonus" else None)
    return jobs, hosts, forb, bonus


def run_both(jobs, hosts, forb, bonus, use_kernel=False, **kw):
    jb, hb = jmatch.make_jobs(**jobs), jmatch.make_hosts(**hosts)
    ref = jmatch.match_rounds(
        jb, hb, jnp.asarray(forb),
        bonus=None if bonus is None else jnp.asarray(bonus),
        use_pallas=use_kernel, pallas_interpret=use_kernel, **kw)
    fused_match.reset_launches()
    got = tmatch.match_rounds(
        tmatch.make_jobs(**jobs, device="cpu"),
        tmatch.make_hosts(**hosts, device="cpu"), torch.from_numpy(forb),
        bonus=None if bonus is None else torch.from_numpy(bonus),
        use_kernel=use_kernel, **kw)
    assert fused_match.LAUNCHES == {"exact_scan": 0, "best_host": 0}
    return jb, hb, ref, got


def check(jb, hb, forb, ref, got, dyadic, head_exact):
    jh = got.job_host.numpy()
    assert got.job_host.dtype == torch.int32
    np.testing.assert_array_equal(jh, np.asarray(ref.job_host))
    np.testing.assert_array_equal(got.slots_left.numpy(),
                                  np.asarray(ref.slots_left))
    for name in ("mem_left", "cpus_left", "gpus_left"):
        g, r = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        if dyadic:
            np.testing.assert_array_equal(g, r, err_msg=name)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        assert g.min() >= -1e-5, name            # never oversubscribed
    assert got.slots_left.min() >= 0
    inv = jmatch.inversion_positions_np(jb, hb, forb, jh)
    assert (inv >= head_exact).all(), inv[:10]
    assert (jh >= 0).sum() > 0


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("kind", ["plain", "gpu", "dense", "bonus"])
def test_match_rounds_plain_equals_xla(kind, groups):
    """use_kernel=False against use_pallas=False, head_exact 64."""
    jobs, hosts, forb, bonus = problem(10 + groups, kind, groups=groups)
    jb, hb, ref, got = run_both(jobs, hosts, forb, bonus, head_exact=64,
                                num_groups=groups)
    check(jb, hb, forb, ref, got, True, 64)


@pytest.mark.parametrize("head_exact", [0, 256])
def test_match_rounds_head_sizes(head_exact):
    jobs, hosts, forb, bonus = problem(20, "dense", n=320)
    jb, hb, ref, got = run_both(jobs, hosts, forb, bonus,
                                head_exact=head_exact)
    check(jb, hb, forb, ref, got, True, head_exact)


@pytest.mark.parametrize("kind", ["plain", "dense"])
def test_match_rounds_non_dyadic(kind):
    jobs, hosts, forb, bonus = problem(30, kind, dyadic=False)
    jb, hb, ref, got = run_both(jobs, hosts, forb, bonus, head_exact=64)
    check(jb, hb, forb, ref, got, False, 64)


def test_match_rounds_knobs():
    """rounds, dense_rounds, spread and dense_cap pass through: a small
    dense prefix forces the ceil(N / D) + 2 dense-round bound."""
    jobs, hosts, forb, bonus = problem(40, "dense")
    kw = dict(rounds=2, dense_rounds=2, spread=0.05, head_exact=16,
              dense_cap=64)
    jb, hb, ref, got = run_both(jobs, hosts, forb, bonus, **kw)
    check(jb, hb, forb, ref, got, True, 16)


@pytest.mark.parametrize("head_exact", [0, 64])
@pytest.mark.parametrize("kind", ["plain", "dense", "bonus"])
def test_match_rounds_kernel_equals_pallas_interpret(kind, head_exact):
    """use_kernel=True (the kernels' plain versions on CPU tensors)
    against use_pallas=True with the Pallas dense kernel in interpret
    mode, H = 256; power-of-two capacities for the exact head."""
    jobs, hosts, forb, bonus = problem(50, kind, n=256, h=256, pow2=True)
    jb, hb, ref, got = run_both(jobs, hosts, forb, bonus, use_kernel=True,
                                head_exact=head_exact)
    check(jb, hb, forb, ref, got, True, head_exact)


def test_match_rounds_kernel_h1024():
    """H a multiple of 1024 (the reference's production bucket), no head:
    JAX's exact head would try to lower Mosaic on the CPU."""
    jobs, hosts, forb, bonus = problem(60, "dense", n=384, h=1024)
    jb, hb, ref, got = run_both(jobs, hosts, forb, bonus, use_kernel=True,
                                head_exact=0)
    check(jb, hb, forb, ref, got, True, 0)


def test_match_rounds_kernel_gate_groups():
    """num_groups > 1 keeps both kernels off, in the port and in JAX."""
    jobs, hosts, forb, bonus = problem(70, "dense", h=256, groups=4)
    jb, hb, ref, got = run_both(jobs, hosts, forb, bonus, use_kernel=True,
                                head_exact=64, num_groups=4)
    check(jb, hb, forb, ref, got, True, 64)


@pytest.mark.parametrize("kind", ["plain", "dense"])
def test_match_rounds_kernel_route_equals_plain_route(kind):
    """The port's use_kernel=True against its use_kernel=False at the
    main path's kind of shape (a full 1024-row dense prefix, the
    256-job exact head), power-of-two capacities."""
    jobs, hosts, forb, _ = problem(80, kind, n=1536, h=512, pow2=True)
    args = (tmatch.make_jobs(**jobs, device="cpu"),
            tmatch.make_hosts(**hosts, device="cpu"), torch.from_numpy(forb))
    a = tmatch.match_rounds(*args, use_kernel=True)
    b = tmatch.match_rounds(*args, use_kernel=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert (a.job_host >= 0).sum() > 256


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_sums_fixed_order_over_wide_demands(seed):
    """apply_accept's per-host depletion sums on demands spanning 2**30
    (wider than any f32 sum is exact over): within rtol 1e-6 of the exact
    sum, and a host's sum depends only on its own rows in row order —
    moving the other hosts' rows around leaves every lane bit-equal."""
    rng = np.random.default_rng(seed)
    n, H = 3000, 37
    host = rng.integers(0, H + 1, n)              # H = dropped
    vals = (2.0 ** rng.uniform(-10, 20, (n, 3))).astype(np.float32)
    got = tmatch._host_sums(torch.from_numpy(host), torch.from_numpy(vals),
                            H).numpy()
    exact = np.zeros((H + 1, 3))
    np.add.at(exact, host, vals.astype(np.float64))
    np.testing.assert_allclose(got, exact[:H], rtol=1e-6)
    moved = host[rng.permutation(n)]
    moved_vals = np.empty_like(vals)
    for h in range(H + 1):
        moved_vals[moved == h] = vals[host == h]
    again = tmatch._host_sums(torch.from_numpy(moved),
                              torch.from_numpy(moved_vals), H).numpy()
    np.testing.assert_array_equal(again, got)
