"""The port's dense-round kernel wrapper (cook_tpu_torch/ops/fused_match.py
`best_host`, whose CPU route is `best_host_plain`) against the JAX
package on the same seeded inputs, on the CPU.

Tolerances: `best_host` exact. `best_fit` against the Pallas kernel in
interpret mode within rtol 1e-6 (the same f32 operations in the same
order; XLA-CPU may contract a multiply-add that the port rounds twice),
and bit-equal where the test says so. Against the XLA dense-round
formula (match.py:667-700, jitter included) the same.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cook_tpu.ops import match as jmatch
from cook_tpu.ops import pallas_match
from cook_tpu_torch.ops import fused_match


def problem(seed, n=16, h=256, gpu_frac=0.2, forbid_frac=0.1):
    """The mix of tests/test_pallas_match.py::random_problem."""
    rng = np.random.default_rng(seed)
    cap_mem = rng.uniform(20, 40, h).astype(np.float32)
    cap_cpus = rng.uniform(8, 16, h).astype(np.float32)
    cap_gpus = ((rng.random(h) < gpu_frac)
                * rng.integers(1, 5, h)).astype(np.float32)
    return dict(
        job_mem=rng.uniform(1, 10, n).astype(np.float32),
        job_cpus=rng.uniform(1, 4, n).astype(np.float32),
        job_gpus=((rng.random(n) < gpu_frac)
                  * rng.integers(1, 3, n)).astype(np.float32),
        active=rng.random(n) < 0.9, unique=rng.random(n) < 0.2,
        cap_mem=cap_mem, cap_cpus=cap_cpus, cap_gpus=cap_gpus,
        mem_left=cap_mem * rng.uniform(0, 1, h).astype(np.float32),
        cpus_left=cap_cpus * rng.uniform(0, 1, h).astype(np.float32),
        gpus_left=cap_gpus * rng.uniform(0, 1, h).astype(np.float32),
        slots=rng.integers(0, 4, h).astype(np.int32),
        hvalid=rng.random(h) < 0.95, occ0=rng.random(h) < 0.1,
        forb=rng.random((n, h)) < forbid_frac,
        bonus=rng.uniform(0, 0.5, (n, h)).astype(np.float32))


def packed(p):
    jp = pallas_match.pack_jobs(*(jnp.asarray(p[k]) for k in (
        "job_mem", "job_cpus", "job_gpus", "active", "unique")))
    hp = pallas_match.pack_hosts(*(jnp.asarray(p[k]) for k in (
        "mem_left", "cpus_left", "gpus_left", "cap_mem", "cap_cpus",
        "cap_gpus", "slots", "hvalid", "occ0")))
    return np.array(jp), np.array(hp)


def port(p, use_bonus, spread, occ=None):
    jp, hp = packed(p)
    if occ is not None:
        jp[:, fused_match.J_GROUP] = p["group"]
    fit, idx = fused_match.best_host(
        torch.from_numpy(jp), torch.from_numpy(hp),
        torch.from_numpy(p["forb"].astype(np.uint8)),
        torch.from_numpy(p["bonus"]) if use_bonus else None, spread=spread,
        occ=None if occ is None else torch.from_numpy(occ))
    assert fit.dtype == torch.float32 and idx.dtype == torch.int32
    return idx.numpy(), fit.numpy()


def pallas(p, use_bonus, spread, block_n=8, block_h=128):
    jp, hp = packed(p)
    fit, idx = pallas_match.best_host(
        jnp.asarray(jp), jnp.asarray(hp), jnp.asarray(p["forb"], jnp.uint8),
        jnp.asarray(p["bonus"]) if use_bonus else None,
        block_n=block_n, block_h=block_h, interpret=True, spread=spread)
    return np.asarray(idx), np.asarray(fit)


def xla_dense(p, use_bonus, spread, occ=None):
    """The XLA dense round's score and argmax (match.py:667-700) over
    every row, jitter keyed on the row index; with `occ` (G, H) each
    unique row checks its group's row, clip(group, 0, G - 1)."""
    n, h = p["forb"].shape
    a = {k: jnp.asarray(v) for k, v in p.items()}
    col = lambda k: a[k][:, None]
    row = lambda k: a[k][None, :]
    ok = jmatch._feasible(col("job_mem"), col("job_cpus"), col("job_gpus"),
                          row("mem_left"), row("cpus_left"),
                          row("gpus_left"), row("cap_gpus"), row("hvalid"),
                          row("slots"), a["forb"])
    occupied = (row("occ0") if occ is None else jnp.asarray(occ)[
        jnp.clip(a["group"], 0, occ.shape[0] - 1)])
    ok &= col("active") & ~(col("unique") & occupied)
    fit = jmatch._fitness(col("job_mem"), col("job_cpus"), row("mem_left"),
                          row("cpus_left"), row("cap_mem"), row("cap_cpus"))
    if use_bonus:
        fit = fit + a["bonus"]
    noise = xla_noise(n, h, spread)
    fit = np.asarray(jnp.where(ok, fit + noise, -1.0))
    choice = fit.argmax(axis=1)
    best = fit[np.arange(n), choice]
    return np.where(best > -0.5, choice, -1), best


def xla_noise(rows, cols, spread):
    """match.py:690-697, verbatim."""
    z = (jnp.arange(rows, dtype=jnp.uint32)[:, None] * jnp.uint32(2654435761)
         + jnp.arange(cols, dtype=jnp.uint32)[None, :] * jnp.uint32(40503))
    z = z ^ (z >> 15)
    z = z * jnp.uint32(2246822519)
    z = z ^ (z >> 13)
    return (z & jnp.uint32(0xFFFF)).astype(jnp.float32) / 65536.0 * spread


@pytest.mark.parametrize("spread", [0.0, 0.2])
@pytest.mark.parametrize("use_bonus", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_best_host_plain_equals_pallas_interpret(seed, use_bonus, spread):
    p = problem(seed)
    ref_idx, ref_fit = pallas(p, use_bonus, spread)
    idx, fit = port(p, use_bonus, spread)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_allclose(fit, ref_fit, rtol=1e-6)
    assert (idx >= 0).sum() > 0


@pytest.mark.parametrize("spread", [0.0, 0.2])
@pytest.mark.parametrize("seed", [4, 5])
def test_best_host_plain_equals_xla_dense_round(seed, spread):
    p = problem(seed, n=24, h=384)
    ref_idx, ref_fit = xla_dense(p, False, spread)
    idx, fit = port(p, False, spread)
    np.testing.assert_array_equal(idx, ref_idx)
    feas = ref_idx >= 0
    np.testing.assert_allclose(fit[feas], ref_fit[feas], rtol=1e-6)
    np.testing.assert_array_equal(fit[~feas], -1.0)


def test_best_host_jitter_equals_xla_hash():
    """fused_match.jitter is the u32 hash of the XLA dense round, bit for
    bit; its mod-2**32 products stay exact for any u32 operand."""
    ref = np.asarray(xla_noise(40, 300, 0.2))
    got = fused_match.jitter(40, 300, 0.2, "cpu")
    np.testing.assert_array_equal(got.numpy(), ref)
    big = np.random.default_rng(0).integers(0, 2 ** 32, 4096,
                                            dtype=np.uint64)
    big[:3] = [0, 1, 2 ** 32 - 1]
    for k in (2654435761, 40503, 2246822519):
        want = (big * np.uint64(k)) & np.uint64(0xFFFFFFFF)   # wraps 2**64
        got = fused_match._mul_u32(torch.from_numpy(big.astype(np.int64)),
                                   k)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_best_host_all_infeasible():
    p = problem(5, n=8, h=128)
    p["forb"][:] = True
    idx, fit = port(p, False, 0.2)
    ref_idx, ref_fit = pallas(p, False, 0.2)
    assert (idx == -1).all() and (fit == -1.0).all()
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(fit, ref_fit)


@pytest.mark.parametrize("use_bonus", [False, True])
def test_best_host_tie_breaks_toward_lowest_host_across_tiles(use_bonus):
    n, h = 8, 256
    p = problem(9, n=n, h=h, gpu_frac=0.0, forbid_frac=0.0)
    for k in ("cap_mem", "cap_cpus", "mem_left", "cpus_left"):
        p[k] = np.full(h, 16.0, np.float32)
    p["slots"] = np.full(h, 5, np.int32)
    p["hvalid"] = np.ones(h, bool)
    p["occ0"] = np.zeros(h, bool)
    p["active"] = np.ones(n, bool)
    p["bonus"] = np.full((n, h), 0.25, np.float32)
    idx, fit = port(p, use_bonus, 0.0)
    ref_idx, ref_fit = pallas(p, use_bonus, 0.0)    # two H tiles
    assert (idx == 0).all()
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(fit, ref_fit)


@pytest.mark.parametrize("n,h", [(13, 300), (200, 1000)])
def test_best_host_odd_shapes(n, h):
    """Shapes the TPU kernel refuses (N, H not block multiples, H not a
    multiple of 128): the port takes them, and equals the XLA formula."""
    p = problem(6, n=n, h=h)
    with pytest.raises(ValueError):
        pallas(p, False, 0.2, block_n=8, block_h=128)
    ref_idx, ref_fit = xla_dense(p, False, 0.2)
    idx, fit = port(p, False, 0.2)
    np.testing.assert_array_equal(idx, ref_idx)
    feas = ref_idx >= 0
    np.testing.assert_allclose(fit[feas], ref_fit[feas], rtol=1e-6)


def test_best_host_gate_and_checks():
    """No gate is left (any groups take the kernel); the wrapper checks
    shapes and types, the occupancy's too."""
    assert not hasattr(fused_match, "best_host_ok")
    jp = torch.zeros((8, fused_match.JOB_COLS))
    hp = torch.zeros((fused_match.HOST_ROWS, 64))
    with pytest.raises(ValueError, match="shapes"):
        fused_match.best_host(jp, hp, torch.zeros((8, 63), dtype=torch.uint8))
    with pytest.raises(TypeError, match="forbidden"):
        fused_match.best_host(jp, hp, torch.zeros((8, 64)))
    forb = torch.zeros((8, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="shapes"):
        fused_match.best_host(jp, hp, forb,
                              occ=torch.zeros((4, 63), dtype=torch.bool))
    with pytest.raises(TypeError, match="occ"):
        fused_match.best_host(jp, hp, forb, occ=torch.zeros((4, 64)))
    meta = [t.to("meta") for t in (jp, hp)]
    with pytest.raises(ValueError, match="unsupported device"):
        fused_match.best_host(*meta, torch.zeros((8, 64), dtype=torch.uint8,
                                                 device="meta"))



@pytest.mark.parametrize("use_bonus", [False, True])
@pytest.mark.parametrize("spread", [0.0, 0.2])
@pytest.mark.parametrize("G", [4, 64])
def test_best_host_groups_equals_xla_dense_round(G, spread, use_bonus):
    """With a (G, H) occupancy, unique rows of groups -1..G+1 (clipped)
    against the XLA dense round's group gather: best_host exact, best_fit
    within rtol 1e-6 (and -1.0 where nothing is feasible). The host
    stack's group-0 row (set here) is not read."""
    p = problem(20 + G, n=40, h=300)
    rng = np.random.default_rng(G)
    p["group"] = rng.integers(-1, G + 2, 40).astype(np.int32)
    p["unique"] = rng.random(40) < 0.6
    occ = rng.random((G, 300)) < 0.3
    ref_idx, ref_fit = xla_dense(p, use_bonus, spread, occ=occ)
    idx, fit = port(p, use_bonus, spread, occ=occ)
    np.testing.assert_array_equal(idx, ref_idx)
    feas = ref_idx >= 0
    np.testing.assert_allclose(fit[feas], ref_fit[feas], rtol=1e-6)
    np.testing.assert_array_equal(fit[~feas], -1.0)
    assert feas.sum() > 0
    g = np.clip(p["group"], 0, G - 1)
    assert not (p["unique"][feas] & occ[g[feas], idx[feas]]).any()
