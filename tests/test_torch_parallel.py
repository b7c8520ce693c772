"""The port's multi-device paths (cook_tpu_torch/parallel/, the sharded
resident pool's matcher, entry.dryrun_multichip) against cook_tpu's, on
the CPU: the JAX package on its 8 virtual CPU devices
(tests/conftest.py), the port on meshes that list the CPU device once a
shard. Integers must be equal and f32 lanes bit-equal.

The pool-sharded and federated cycles are held on every CycleResult
field against JAX's vmapped cycles (`shard_map` of `jax.vmap(
rank_and_match)`), past the f32 blocking thresholds of the rank's prefix
sums, the usage scatters and the dense rounds' window sums: on XLA-CPU
the vmapped cycle adds in the order of the unbatched one, which the port
takes per pool.
"""
import contextlib
import importlib
import itertools
import time
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cook_tpu.ops import cycle as jcycle
from cook_tpu.ops import match as jmatch
from cook_tpu.parallel import federation as jfed
from cook_tpu.parallel import pools as jpools
from cook_tpu.parallel import sharded_match as jsharded
from cook_tpu_torch import parallel as tpar
from cook_tpu_torch.ops import cycle as tcycle
from cook_tpu_torch.ops import match as tmatch
from cook_tpu_torch.parallel import federation as tfed
from cook_tpu_torch.parallel import pools as tpools
from cook_tpu_torch.parallel import sharded_match as tsharded

INF = np.float32(3.4e38)
CPU = torch.device("cpu")


def cpu_mesh(n, axis="x"):
    return tpar.Mesh([CPU] * n, (axis,))


def cycle_inputs(rng, n_pools, R, P, H, U, forb_density=0.0,
                 cpus_quota=INF):
    """n_pools pools of rank_and_match's 24 arguments as numpy, stacked
    on a leading pools axis (hosts as a dict of lanes; no forbidden mask
    when forb_density is None)."""
    def one():
        h_mem = rng.uniform(20, 60, H).astype(np.float32)
        h_cpus = rng.uniform(8, 24, H).astype(np.float32)
        return [
            rng.integers(0, U, R).astype(np.int32),
            rng.uniform(1, 10, R).astype(np.float32),
            rng.uniform(1, 4, R).astype(np.float32),
            rng.integers(0, 3, R).astype(np.int32),
            rng.integers(0, 100, R).astype(np.int32),
            rng.random(R) < 0.8,
            np.full(R, 100.0, np.float32),
            np.full(R, 20.0, np.float32),
            rng.integers(0, U, P).astype(np.int32),
            rng.uniform(1, 10, P).astype(np.float32),
            rng.uniform(0.5, 4, P).astype(np.float32),
            np.zeros(P, np.float32),
            rng.integers(0, 3, P).astype(np.int32),
            rng.integers(100, 200, P).astype(np.int32),
            rng.random(P) < 0.9,
            np.full(P, 100.0, np.float32),
            np.full(P, 20.0, np.float32),
            np.full(P, -1, np.int32),
            np.zeros(P, bool),
            dict(mem=h_mem, cpus=h_cpus, gpus=np.zeros(H, np.float32),
                 cap_mem=h_mem, cap_cpus=h_cpus,
                 cap_gpus=np.zeros(H, np.float32), valid=np.ones(H, bool),
                 task_slots=np.full(H, 10_000, np.int32)),
            None if forb_density is None
            else rng.random((P, H)) < forb_density,
            np.full(U, INF), np.full(U, cpus_quota, np.float32),
            np.full(U, 1e9, np.float32),
        ]

    parts = [one() for _ in range(n_pools)]
    out = []
    for col in zip(*parts):
        if col[0] is None:
            out.append(None)
        elif isinstance(col[0], dict):
            out.append({k: np.stack([c[k] for c in col]) for k in col[0]})
        else:
            out.append(np.stack(col))
    return out


def to_jax(arrays, lead=None):
    def conv(a):
        a = jnp.asarray(a)
        return a if lead is None else a.reshape(lead + a.shape[1:])
    return tuple(None if a is None else
                 jmatch.Hosts(**{k: conv(v) for k, v in a.items()})
                 if isinstance(a, dict) else conv(a) for a in arrays)


def to_torch(arrays, lead=None):
    def conv(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t if lead is None else t.reshape(lead + t.shape[1:])
    return tuple(None if a is None else
                 tmatch.Hosts(**{k: conv(v) for k, v in a.items()})
                 if isinstance(a, dict) else conv(a) for a in arrays)


def assert_bits_equal(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want, err_msg=what)


def assert_cycle_equal(got, want, what=""):
    for f in jcycle.CycleResult._fields:
        assert_bits_equal(getattr(got, f).numpy(), getattr(want, f),
                          f"{what} {f}")


# -- the pool-sharded cycle -------------------------------------------------
POOL_CASES = {
    # tests/test_cycle_parallel.py's shape: 8 pools on 8 devices
    "8x16_sequential": dict(n_pools=8, jax_dev=8, port_dev=8, R=16, P=24,
                            H=6, U=4, C=16, sequential=True),
    # past the blocking thresholds (prefix sums of 2,000 rows, 512-job
    # dense prefixes, 256-host window sums), batched, 5% forbidden pairs
    # and a binding cpus quota; JAX vmaps two pools a device
    "4x2000_batched": dict(n_pools=4, jax_dev=2, port_dev=4, R=500,
                           P=2000, H=256, U=16, C=512, sequential=False,
                           forb_density=0.05, cpus_quota=3000.0),
}


def _pool_case(case):
    c = dict(POOL_CASES[case])
    rng = np.random.default_rng(3)
    arrays = cycle_inputs(rng, c["n_pools"], c["R"], c["P"], c["H"],
                          c["U"], c.get("forb_density", 0.0),
                          c.get("cpus_quota", INF))
    jmesh = jpools.make_pool_mesh(c["jax_dev"])
    want = jpools.pool_sharded_cycle(
        jmesh, num_considerable=c["C"],
        sequential=c["sequential"])(to_jax(arrays))
    return c, arrays, want


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_sharded_cycle_equals_jax(case):
    c, arrays, want = _pool_case(case)
    args = to_torch(arrays)
    run = tpools.pool_sharded_cycle(cpu_mesh(c["port_dev"], "pools"),
                                    num_considerable=c["C"],
                                    sequential=c["sequential"])
    got = run(args)
    assert_cycle_equal(got.result, want.result, case)
    for f in tpools.PoolCycleStats._fields:
        assert int(getattr(got.stats, f)) == int(getattr(want.stats, f)), f
    assert int(got.stats.total_matched) == \
        int((got.result.job_host >= 0).sum()) > 0
    # one shard holding every pool gives the same result
    one = tpools.pool_sharded_cycle(cpu_mesh(1, "pools"),
                                    num_considerable=c["C"],
                                    sequential=c["sequential"])(args)
    for f in tcycle.CycleResult._fields:
        assert torch.equal(getattr(one.result, f), getattr(got.result, f))


def test_pool_sharded_cycle_needs_a_multiple_of_the_mesh():
    arrays = cycle_inputs(np.random.default_rng(0), 3, 4, 6, 4, 2)
    run = tpools.pool_sharded_cycle(cpu_mesh(2, "pools"),
                                    num_considerable=4)
    with pytest.raises(ValueError, match="pad with empty pools"):
        run(to_torch(arrays))


@pytest.mark.slow
def test_pool_sharded_cycle_at_bench_pools_shape_equals_jax():
    """bench.py::bench_pools' shape (8 pools x R=1,250, P=12,500,
    H=1,250, U=100, C=1,024, batched; no constraints), JAX's one-device
    mesh vmapping all eight against the port on four shards."""
    rng = np.random.default_rng(0)
    arrays = cycle_inputs(rng, 8, 1250, 12500, 1250, 100,
                          forb_density=None)
    want = jpools.pool_sharded_cycle(
        jpools.make_pool_mesh(1), num_considerable=1024,
        sequential=False)(to_jax(arrays))
    got = tpools.pool_sharded_cycle(cpu_mesh(4, "pools"),
                                    num_considerable=1024,
                                    sequential=False)(to_torch(arrays))
    assert_cycle_equal(got.result, want.result, "bench_pools")
    assert int(got.stats.total_matched) == int(want.stats.total_matched)


# -- the host-sharded scan --------------------------------------------------
def _scan_inputs(seed, N, H, G=1, forb=0.0, bonus=False):
    rng = np.random.default_rng(seed)
    group = (rng.integers(-1, G, N).astype(np.int32) if G > 1
             else np.full(N, -1, np.int32))
    a = dict(mem=rng.uniform(1, 20, N).astype(np.float32),
             cpus=rng.uniform(0.5, 8, N).astype(np.float32),
             valid=rng.random(N) < 0.9, group=group,
             unique_group=group >= 0)
    h = dict(mem=rng.uniform(40, 120, H).astype(np.float32),
             cpus=rng.uniform(8, 32, H).astype(np.float32))
    f = rng.random((N, H)) < forb
    b = rng.uniform(0, 0.5, (N, H)).astype(np.float32) if bonus else None
    return a, h, f, b


SCAN_CASES = {"plain": dict(N=40, H=16),
              "groups_forb": dict(N=48, H=16, G=4, forb=0.1),
              "bonus": dict(N=48, H=24, G=4, forb=0.1, bonus=True)}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_sharded_match_scan_equals_jax(case):
    c = SCAN_CASES[case]
    G = c.get("G", 1)
    a, h, f, b = _scan_inputs(4, c["N"], c["H"], G, c.get("forb", 0.0),
                              c.get("bonus", False))
    jjobs = jmatch.make_jobs(**a)
    jhosts = jmatch.make_hosts(**h)
    jfn = jsharded.sharded_match_scan(jsharded.make_host_mesh(8),
                                      num_groups=G, with_bonus=b is not None)
    want = jfn(jjobs, jhosts, jnp.asarray(f),
               None if b is None else jnp.asarray(b))
    tjobs = tmatch.make_jobs(**a, device="cpu")
    thosts = tmatch.make_hosts(**h, device="cpu")
    mesh = tsharded.make_host_mesh(devices=[CPU] * 8)
    fn = tsharded.sharded_match_scan(mesh, num_groups=G,
                                     with_bonus=b is not None)
    tb = None if b is None else torch.from_numpy(b)
    got = fn(tjobs, thosts, torch.from_numpy(f), tb)
    assert_bits_equal(got.job_host.numpy(), want.job_host, "job_host")
    single = tmatch.match_scan(tjobs, thosts, torch.from_numpy(f),
                               num_groups=G, bonus=tb)
    assert torch.equal(got.job_host, single.job_host)
    for k in ("mem_left", "cpus_left", "gpus_left", "slots_left"):
        lane = torch.cat(getattr(got, k))
        assert_bits_equal(lane.numpy(), getattr(want, k), k)
        assert torch.equal(lane, getattr(single, k)), k
    assert (got.job_host >= 0).sum() > 0
    jh = got.job_host.numpy()
    for g in range(G):   # no two cotasks of a unique group share a host
        used = jh[(a["group"] == g) & (jh >= 0)]
        assert len(used) == len(set(used.tolist()))


def test_sharded_match_scan_rejects_an_unexpected_bonus():
    a, h, f, _ = _scan_inputs(0, 4, 8)
    fn = tsharded.sharded_match_scan(cpu_mesh(2, "hosts"))
    with pytest.raises(ValueError, match="with_bonus=False"):
        fn(tmatch.make_jobs(**a, device="cpu"),
           tmatch.make_hosts(**h, device="cpu"), torch.from_numpy(f),
           torch.zeros((4, 8)))


def test_resident_matcher_is_cached_per_mesh():
    m1, m2 = cpu_mesh(2, "hosts"), cpu_mesh(2, "hosts")
    assert m1 == m2 and hash(m1) == hash(m2)
    assert tsharded.resident_matcher(m1, 1, False) is \
        tsharded.resident_matcher(m2, 1, False)
    assert tsharded.resident_matcher(m1, 2, False) is not \
        tsharded.resident_matcher(m1, 1, False)


# -- the federated cycle ----------------------------------------------------
def test_federated_cycle_2x4_equals_jax():
    rng = np.random.default_rng(5)
    arrays = cycle_inputs(rng, 8, 16, 24, 6, 4)
    jmesh = jfed.make_federation_mesh(2, 4)
    want = jfed.federated_cycle(jmesh, num_considerable=16)(
        to_jax(arrays, (2, 4)))
    tmesh = tfed.make_federation_mesh(2, 4, devices=[CPU] * 8)
    got = tfed.federated_cycle(tmesh, num_considerable=16)(
        to_torch(arrays, (2, 4)))
    assert got.result.job_host.shape[:2] == (2, 4)
    assert_cycle_equal(got.result, want.result, "federated")
    for f in tfed.FederationStats._fields:
        assert_bits_equal(getattr(got.stats, f).numpy(),
                          getattr(want.stats, f), f)
    jh = got.result.job_host.numpy()
    per_slice = got.stats.per_slice_matched.numpy()
    assert per_slice.tolist() == [int((jh[s] >= 0).sum()) for s in (0, 1)]
    assert per_slice.sum() == int(got.stats.total_matched) > 0


# -- meshes and collectives -------------------------------------------------
def test_meshes_raise_on_too_few_devices():
    with pytest.raises(ValueError, match="need 2 cpu devices, have 1"):
        tsharded.make_host_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="need 3 cpu devices"):
        tpools.make_pool_mesh(3, device="cpu")
    with pytest.raises(ValueError, match="need 2 x 2 devices, have 1"):
        tfed.make_federation_mesh(2, 2, device="cpu")
    # one visible device makes a mesh of one; repeats only when listed
    assert tpools.make_pool_mesh(1, device="cpu").devices.size == 1
    assert tsharded.make_host_mesh(device="cpu").devices.size == 1
    m = tsharded.make_host_mesh(devices=["cpu"] * 3)
    assert m.devices.size == 3 and m.shape == {"hosts": 3}
    assert tfed.make_federation_mesh(2, 2, devices=[CPU] * 4).shape == \
        {"slice": 2, "pools": 2}


def test_collectives_reduce_over_mesh_axes():
    mesh = tpar.Mesh(np.array([[CPU] * 3] * 2, dtype=object), ("a", "b"))
    parts = [torch.tensor([i, 10 - i], dtype=torch.int32) for i in range(6)]
    assert [t.tolist() for t in tpar.psum(parts, mesh)] == [[15, 45]] * 6
    assert [t.tolist() for t in tpar.psum(parts, mesh, "b")] == \
        [[3, 27]] * 3 + [[12, 18]] * 3
    assert [t.tolist() for t in tpar.pmax(parts, mesh, "a")] == \
        [[3, 10], [4, 9], [5, 8]] * 2
    assert [t.tolist() for t in tpar.pmin(parts, mesh, ("a", "b"))] == \
        [[0, 5]] * 6
    with pytest.raises(ValueError, match="2 parts for a mesh of 6"):
        tpar.psum(parts[:2], mesh)


# -- dryrun_multichip -------------------------------------------------------
WALL = 1_700_000_000.0


@contextlib.contextmanager
def pinned(root):
    """Clocks and uuids pinned for package `root` (as
    tests/torch_coord_harness.py pins them)."""
    model = importlib.import_module(f"{root}.state.model")
    counter = itertools.count(1)
    saved = (uuid.uuid4, time.time)
    uuid.uuid4 = lambda: uuid.UUID(int=next(counter))
    time.time = lambda: WALL
    model.set_clock(lambda: WALL)
    try:
        yield
    finally:
        uuid.uuid4, time.time = saved
        model.reset_clock()


@pytest.mark.parametrize("n", [8, 5])
def test_dryrun_multichip_prints_the_reference_line(n, capsys):
    import __graft_entry__
    from cook_tpu_torch import entry
    with pinned("cook_tpu"):
        __graft_entry__.dryrun_multichip(n)
    want = capsys.readouterr().out.strip().splitlines()[-1]
    with pinned("cook_tpu_torch"):
        entry.dryrun_multichip(n, device="cpu", devices=[CPU] * n)
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want
    assert f"ONE pool sharded over {n} devices" in got


def test_dryrun_multichip_needs_its_devices():
    from cook_tpu_torch import entry
    with pytest.raises(ValueError, match="need 4 cpu devices"):
        entry.dryrun_multichip(4, device="cpu")


# -- the candidate-compressed scan ------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_candidate_scan_equals_jax(seed):
    """tests/test_match.py::test_candidate_scan_equals_full_scan for the
    port: half the hosts identical (fitness ties at the top-K cut), a
    gpu slice, forbidden pairs and unique groups; K=4 forces the full
    fallback. job_host must equal JAX's full scan, and every lane and
    the occupancy JAX's candidate scan bit for bit."""
    rng = np.random.default_rng(seed)
    S, H = 192, 2048
    h = dict(mem=np.where(np.arange(H) % 2 == 0, 4000.0,
                          rng.uniform(2000, 16000, H)).astype(np.float32),
             cpus=np.where(np.arange(H) % 2 == 0, 8.0,
                           rng.uniform(4, 32, H)).astype(np.float32),
             gpus=np.where(np.arange(H) % 17 == 0, 4.0,
                           0.0).astype(np.float32),
             task_slots=np.full(H, 3, np.int32))
    a = dict(mem=rng.uniform(100, 6000, S).astype(np.float32),
             cpus=rng.uniform(0.5, 8, S).astype(np.float32),
             gpus=np.where(rng.random(S) < 0.1, 1.0, 0.0).astype(np.float32),
             group=np.where(rng.random(S) < 0.2, rng.integers(0, 4, S),
                            -1).astype(np.int32),
             unique_group=rng.random(S) < 0.15)
    forb = rng.random((S, H)) < 0.05
    jh, jj = jmatch.make_hosts(**h), jmatch.make_jobs(**a)
    th = tmatch.make_hosts(**h, device="cpu")
    tj = tmatch.make_jobs(**a, device="cpu")

    def jcarry():
        return (jh.mem, jh.cpus, jh.gpus, jh.task_slots,
                jnp.zeros((4, H), bool))

    _, full = jmatch._scan_assign(jj, jh, jnp.asarray(forb),
                                  jnp.zeros((S, H), jnp.float32), 4,
                                  jcarry())
    for K in (4, 32):
        jc, jcand = jmatch._scan_assign_candidates(
            jj, jh, jnp.asarray(forb), jnp.zeros((S, H), jnp.float32), 4,
            jcarry(), K=K)
        tc, tcand = tmatch._scan_assign_candidates(
            tj, th, torch.from_numpy(forb), torch.zeros((S, H)), 4,
            (th.mem, th.cpus, th.gpus, th.task_slots,
             torch.zeros((4, H), dtype=torch.bool)), K=K)
        assert_bits_equal(tcand.numpy(), full, f"K={K} job_host")
        assert_bits_equal(tcand.numpy(), jcand, f"K={K} job_host")
        for name, got, want in zip(("mem", "cpus", "gpus", "slots", "occ"),
                                   tc, jc):
            assert_bits_equal(got.numpy(), want, f"K={K} {name}")
