"""The port's fused cycle (cook_tpu_torch/ops/cycle.py::rank_and_match)
against the JAX package's rank_and_match(use_pallas=False), on the CPU,
on __graft_entry__._cycle_args() and on seeded variants.

Tolerances: every integer / bool field exact. f32 host lanes exact (the
depletion is the same f32 subtraction in both). `pending_dru` exact:
the port's f32 cumsum adds in XLA-CPU's order
(tests/test_torch_cumsum.py). `why_amt` holds host ids and rank
ordinals (exact) and quota overages (f32 sums of running usage): rtol
1e-6, atol 1e-3. The batched matcher's host lanes: see compare_batched.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import __graft_entry__ as graft
from cook_tpu.ops import cycle as jcycle
from cook_tpu.ops import match as jmatch
from cook_tpu_torch import convert, entry
from cook_tpu_torch.ops import cycle as tcycle
from cook_tpu_torch.ops import fused_match

INT_FIELDS = ("queue_rank", "considerable", "job_host", "slots_left",
              "cons_idx", "cons_host", "head_matched", "n_matched",
              "n_considerable", "mat_idx", "mat_host", "why_idx",
              "why_code")
LANES = ("mem_left", "cpus_left", "gpus_left")


def compare(ref, got):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(
            getattr(got, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
        assert getattr(got, f).dtype in (torch.int32, torch.bool), f
    for f in LANES:
        np.testing.assert_array_equal(
            getattr(got, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_array_equal(got.pending_dru.numpy(),
                                  np.asarray(ref.pending_dru))
    np.testing.assert_allclose(got.why_amt.numpy(), np.asarray(ref.why_amt),
                               rtol=1e-6, atol=1e-3)


def test_graft_cycle_args_equal():
    """entry.cycle_args replays __graft_entry__._cycle_args draw for draw."""
    ref = graft._cycle_args()
    got, _ = entry.cycle_args(device="cpu")
    for i, (r, g) in enumerate(zip(ref, got)):
        if isinstance(g, tuple):
            for a, b in zip(r, g):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                          err_msg=str(i))


@pytest.mark.parametrize("use_kernel", [True, False])
def test_graft_entry_cycle(use_kernel):
    args = graft._cycle_args()
    ref = jcycle.rank_and_match(*args, num_considerable=256)
    fused_match.reset_launches()
    got = tcycle.rank_and_match(*convert.cycle_args(args, "cpu"),
                                num_considerable=256,
                                use_kernel=use_kernel)
    compare(ref, got)
    assert int(got.n_matched) > 0
    fn, targs = entry.entry(device="cpu")
    compare(ref, fn(*targs))
    assert fused_match.LAUNCHES["exact_scan"] == 0   # CPU: plain version


def _variant(case):
    """numpy (args, kwargs) of one seeded cycle variant."""
    opts = dict(constrained=0.15, ports=True, est=True)
    arrays, kw = entry.cycle_arrays(R=192, Pn=384, H=96, U=12, seed=5,
                                    **opts)
    rng = np.random.default_rng(17)
    U, Pn, H = 12, 384, 96
    if case in ("dyadic", "quota", "gpu", "sparse_bonus"):
        for i in (1, 2, 9, 10):        # run/pend mem, cpus
            arrays[i] = (np.round(arrays[i] * 8) / 8).astype(np.float32)
        arrays[6][:], arrays[7][:] = 64.0, 16.0
        arrays[15][:], arrays[16][:] = 64.0, 16.0
    if case == "quota":     # args 21-23: per-user mem/cpus/count quotas
        arrays[21] = np.full(U, 96.0, np.float32)
        arrays[22] = np.full(U, np.float32(3.4e38))
        arrays[23] = rng.integers(8, 30, U).astype(np.float32)
    if case == "gpu":
        arrays[11] = (rng.integers(0, 3, Pn) / 2).astype(np.float32)
        kw["run_gpus"] = (rng.integers(0, 3, 192) / 2).astype(np.float32)
        kw["run_gpu_share"] = np.full(192, 8.0, np.float32)
        kw["pend_gpu_share"] = np.full(Pn, 8.0, np.float32)
        hosts = arrays[19]
        hosts["cap_gpus"] = np.where(rng.random(H) < 0.3, 4.0,
                                     0.0).astype(np.float32)
        hosts["gpus"] = hosts["cap_gpus"].copy()
    return arrays, kw


def _jax_args(arrays):
    out = []
    for a in arrays:
        if isinstance(a, dict):
            out.append(jmatch.Hosts(**{k: jnp.asarray(v)
                                       for k, v in a.items()}))
        elif isinstance(a, tuple):
            out.append(tuple(jnp.asarray(x) for x in a))
        else:
            out.append(jnp.asarray(a))
    return out


def _torch_args(arrays):
    out = []
    for a in arrays:
        if isinstance(a, dict):
            out.append(convert.hosts(
                jmatch.Hosts(**a), "cpu"))
        elif isinstance(a, tuple):
            out.append(convert.tensors(a, "cpu"))
        else:
            out.append(convert.tensor(a, "cpu"))
    return out


def _sparse(forb, rng, K=64):
    """(rows (K, H), slot_of (P,)) holding the same masks as `forb`."""
    P, H = forb.shape
    own = np.flatnonzero(forb.any(1))[:K - 1]
    rows = np.zeros((K, H), bool)
    slot_of = np.full(P, -1, np.int32)
    slots = rng.permutation(K)[:len(own)]
    rows[slots] = forb[own]
    slot_of[own] = slots
    return rows, slot_of


CASES = {
    # name: (num_considerable, kwargs of the call)
    "dense": (128, {}),
    "dyadic": (128, {}),
    "quota": (128, {}),
    "limit": (128, {"considerable_limit": 40}),
    "gpu": (128, {"dru_mode": "gpu"}),
    "sparse": (128, {}),
    "no_ports_est": (128, {}),
    "sparse_bonus": (64, {}),
    "groups": (64, {"num_groups": 4}),
    "wide": (512, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rank_and_match_equals_jax(case):
    C, call_kw = CASES[case]
    arrays, kw = _variant(case)
    rng = np.random.default_rng(23)
    if case == "no_ports_est":
        kw = {}
    if case in ("sparse", "sparse_bonus"):
        arrays[20] = _sparse(arrays[20], rng)
    if case == "sparse_bonus":
        P, H = arrays[8].shape[0], arrays[19]["mem"].shape[0]
        brows = (rng.integers(0, 4, (16, H)) / 8).astype(np.float32)
        bslot = np.where(rng.random(P) < 0.2, rng.integers(0, 16, P),
                         -1).astype(np.int32)
        call_kw = {"bonus": (brows, bslot)}
    if case == "groups":
        P = arrays[8].shape[0]
        grp = rng.integers(-1, 4, P).astype(np.int32)
        arrays[17] = grp
        arrays[18] = (grp >= 0) & (rng.random(P) < 0.8)
    jkw = {k: (tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple)
               else jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in {**kw, **call_kw}.items()}
    tkw = {k: (convert.tensors(v, "cpu") if isinstance(v, tuple)
               else convert.tensor(v, "cpu") if isinstance(v, np.ndarray)
               else v)
           for k, v in {**kw, **call_kw}.items()}
    ref = jcycle.rank_and_match(*_jax_args(arrays), num_considerable=C,
                                **jkw)
    got = tcycle.rank_and_match(*_torch_args(arrays), num_considerable=C,
                                use_kernel=True, **tkw)
    compare(ref, got)
    assert int(got.n_matched) > 0
    if case == "quota":
        codes = set(got.why_code.numpy().tolist())
        assert codes & {4, 6}, codes       # quota gate fired
    if case == "limit":
        assert int(got.n_considerable) == 40


def test_rank_and_match_at_backlog_equals_jax():
    """A real backlog: 22,000 pending jobs of 100 users with non-dyadic
    demands, per-user shares and quotas, 48 hosts, the sequential
    matcher, the kernel off on both sides. The rank (through
    segment_cumsum) and the quota filter add in XLA-CPU's order, so the
    queue order, the considered and matched jobs, their hosts and
    reasons and `pending_dru` equal the reference's exactly."""
    U, Pn, H, C = 100, 22_000, 48, 256
    arrays, _ = entry.cycle_arrays(R=4_000, Pn=Pn, H=H, U=U, seed=31)
    rng = np.random.default_rng(31)
    ms = rng.uniform(50, 150, U).astype(np.float32)
    cs = rng.uniform(10, 30, U).astype(np.float32)
    arrays[6], arrays[7] = ms[arrays[0]], cs[arrays[0]]
    arrays[15], arrays[16] = ms[arrays[8]], cs[arrays[8]]
    arrays[21] = rng.uniform(150, 900, U).astype(np.float32)
    arrays[22] = rng.uniform(40, 250, U).astype(np.float32)
    arrays[23] = rng.integers(40, 400, U).astype(np.float32)
    ref = jcycle.rank_and_match(*_jax_args(arrays), num_considerable=C,
                                use_pallas=False)
    got = tcycle.rank_and_match(*_torch_args(arrays), num_considerable=C,
                                use_kernel=False)
    compare(ref, got)
    assert int(got.n_matched) > 0
    assert set(got.why_code.numpy().tolist()) & {4, 6}   # quota gate fired


BATCHED = ("mat_idx", "mat_host", "why_code", "why_idx", "cons_idx",
           "cons_host", "n_matched", "job_host", "slots_left")


def compare_batched(ref, got):
    """The batched matcher's outputs: integer fields exact; host lanes
    bit-equal on non-dyadic inputs too (the port adds each host's
    accepted demands in XLA's row order, `segments.scatter_add_ordered_`,
    and the running usage per user the same way)."""
    for f in BATCHED:
        np.testing.assert_array_equal(
            getattr(got, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    for f in LANES:
        g, r = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        np.testing.assert_array_equal(g.view(np.int32), r.view(np.int32),
                                      err_msg=f)


def test_match_rounds_not_ported():
    """sequential=False runs the ported match_rounds (it used to raise
    NotImplementedError) and equals the reference's on the graft args."""
    args = graft._cycle_args()
    ref = jcycle.rank_and_match(*args, num_considerable=64,
                                sequential=False)
    got = tcycle.rank_and_match(*convert.cycle_args(args, "cpu"),
                                num_considerable=64, sequential=False)
    compare_batched(ref, got)
    assert int(got.n_matched) > 0


@pytest.mark.parametrize("case", ["dyadic", "sparse_bonus", "groups", "gpu"])
def test_rank_and_match_batched_equals_jax(case):
    """rank_and_match(sequential=False, match_kw=...) against the
    reference's, constrained, ports and estimated-completion lanes on."""
    C = 128
    arrays, kw = _variant(case)
    rng = np.random.default_rng(29)
    call_kw = {"match_kw": (("head_exact", 32), ("dense_rounds", 4))}
    if case == "sparse_bonus":
        arrays[20] = _sparse(arrays[20], rng)
        P, H = arrays[8].shape[0], arrays[19]["mem"].shape[0]
        brows = (rng.integers(0, 4, (16, H)) / 8).astype(np.float32)
        bslot = np.where(rng.random(P) < 0.2, rng.integers(0, 16, P),
                         -1).astype(np.int32)
        call_kw["bonus"] = (brows, bslot)
    if case == "groups":
        P = arrays[8].shape[0]
        grp = rng.integers(-1, 4, P).astype(np.int32)
        arrays[17] = grp
        arrays[18] = (grp >= 0) & (rng.random(P) < 0.8)
        call_kw["num_groups"] = 4
    if case == "gpu":
        call_kw["dru_mode"] = "gpu"
    jkw = {k: (tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple)
               and k != "match_kw" else jnp.asarray(v)
               if isinstance(v, np.ndarray) else v)
           for k, v in {**kw, **call_kw}.items()}
    tkw = {k: (convert.tensors(v, "cpu") if isinstance(v, tuple)
               and k != "match_kw" else convert.tensor(v, "cpu")
               if isinstance(v, np.ndarray) else v)
           for k, v in {**kw, **call_kw}.items()}
    ref = jcycle.rank_and_match(*_jax_args(arrays), num_considerable=C,
                                sequential=False, **jkw)
    got = tcycle.rank_and_match(*_torch_args(arrays), num_considerable=C,
                                sequential=False, use_kernel=False, **tkw)
    compare_batched(ref, got)
    assert int(got.n_matched) > 0
