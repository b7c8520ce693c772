"""Agreement with the JAX package at the headline shape: 8 batched cycles
of `entry.ResidentWorkload` at R=10k running, P=100k pending, H=10k hosts,
U=500 users, C=8192 (Pcap 262,144, Hcap 16,384; the cell chip_smoke.py
runs on the card), fed the same packed delta bundles two ways:

* the port's `device_cycle` on CPU tensors with `use_kernel=True` (every
  kernel wrapper runs its plain version: the path chip_smoke.py's plain
  replay holds the card's kernels to), its 256-job head included;
* the JAX package's resident `_device_cycle(sequential=False,
  use_pallas=False)` under JAX_PLATFORMS=cpu.

mat_idx, mat_host and why_code must be equal every cycle (tolerance
none); the matched counts are printed (`-s`). The workload advances from
the port's readback, which equals the reference's.

Marked slow: at this shape it takes ~40 s and ~2 GB on 8 CPU cores,
which the tier-1 run (`-m 'not slow'`, several workers sharing a machine)
should not carry.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_headline.py -m slow -s
"""
import numpy as np
import pytest
import jax

from cook_tpu.scheduler import resident as jres
from cook_tpu_torch import convert, entry
from cook_tpu_torch.scheduler import resident as tres

CYCLES = 8
J_SCATTERS = {"pend": jres._scatter_pend, "run": jres._scatter_run,
              "forb": jres._scatter_forb, "bonus": jres._scatter_bonus,
              "credit": jres._scatter_credit}


@pytest.mark.slow
def test_batched_cycles_equal_jax_at_headline_shape():
    w = entry.resident_workload(device="cpu", seed=0, C=8192)
    rs = w.rs
    assert (rs.Pcap, rs.Rcap, rs.Hcap) == (262144, 32768, 16384)
    jstate = jax.device_put(tres.state_to_numpy(rs.state))
    qm, qc, qn = (np.asarray(q.numpy()) for q in (w.qm, w.qc, w.qn))
    match_kw = (("head_exact", entry.HEAD_START),)
    matched = []
    for cyc in range(CYCLES):
        spills, bundle = rs.pack(rs.drain())
        for kind, arrays in spills:
            jstate = J_SCATTERS[kind](jstate, *arrays)
            tres.SCATTERS[kind](rs.state, *convert.tensors(arrays, "cpu"))
        jstate, jout = jres._device_cycle(
            jstate, bundle, qm, qc, qn, np.int32(w.C), np.int32(w.now_s),
            num_considerable=w.C, sequential=False, num_groups=1,
            dru_mode="default", use_pallas=False, match_kw=match_kw,
            with_bonus=False, with_est=True)
        tout = rs.run_cycle(convert.tensors(bundle, "cpu"), w.qm, w.qc, w.qn,
                            w.C, w.now_s, w.C, use_kernel=True,
                            sequential=False, match_kw=match_kw)
        n = int(tout[3])
        assert n == int(jout[3]), f"cycle {cyc}: n_matched"
        for i, name in ((5, "mat_idx"), (6, "mat_host"), (8, "why_code")):
            np.testing.assert_array_equal(tout[i].numpy(),
                                          np.asarray(jout[i]),
                                          err_msg=f"cycle {cyc} {name}")
        matched.append(n)
        print(f"cycle {cyc}: matched {n} (port == JAX)", flush=True)
        mat_idx, mat_host = rs.readback(tout)
        w.advance(mat_idx, mat_host)
    print("matched per cycle", matched)
    assert matched[0] > matched[-1] > 0
