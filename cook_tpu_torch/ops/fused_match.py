"""The fused match kernels: the counterpart of
cook_tpu/ops/pallas_match.py (`pack_jobs`, `pack_hosts`, `exact_scan`,
`_exact_scan_kernel`, `exact_scan_ok`, `best_host`, `_score_tile`,
`_accumulate`, `_kernel`, `_kernel_bonus`).

  exact_scan  the whole sequential-greedy walk (the Fenzo walk) in one
              launch of a thread-block cluster (csrc/exact_scan.cu), for
              any number of groups and an optional fitness bonus;
  best_host   one dense round of the batched matcher: feasibility +
              fitness + optional bonus + hash jitter, row argmax over
              hosts, for any number of groups (csrc/best_host.cu).

Each wrapper launches its hand-written sm_90a kernel for CUDA tensors
and runs its plain PyTorch version (`*_plain`) for CPU tensors; anything
else raises. There is no fallback from a kernel to its plain version.

Both score fitness in the division form of the reference's default
route (`match._fitness`, cook_tpu/ops/match.py:112-118, the XLA scan and
the XLA dense round), and both kernels divide correctly rounded. The
TPU scan kernel's reciprocal form (pallas_match.py:190-191, 214-215) is
not reproduced: the reference's two routes disagree where a division
ties and a product by a reciprocal does not.

Unique occupancy: with one group it is the host stack's `H_OCC0` row
(the TPU kernels' fold); with G groups a (G, H) bool or uint8 `occ`,
each unique job checking its group's row, clip(J_GROUP, 0, G - 1).
"""
from __future__ import annotations

import ctypes
import threading

import torch

NO_HOST = -1
EPS = 1e-6

# host-stack row indices of the (16, H) host tensor
H_MEM, H_CPUS, H_GPUS, H_CAP_MEM, H_CAP_CPUS, H_CAP_GPUS, \
    H_SLOTS, H_VALID, H_OCC0 = range(9)
HOST_ROWS = 16

# job-stack column indices of the (N, 8) job tensor; J_GROUP holds the
# group id as f32 (exact below 2**24; clipped to [0, G - 1] in use, so
# any id gives the result of its clip while G < 2**24)
J_MEM, J_CPUS, J_GPUS, J_ACTIVE, J_UNIQUE, J_GROUP = range(6)
JOB_COLS = 8
MAX_GROUPS = 2 ** 24

# kernel launches by name, counted by the wrapper where it launches; a
# route of a kernel counts under its own name: exact_scan/bonus (one
# group, a bonus), exact_scan/groups (a (G, H) occupancy, a bonus or
# none), best_host/groups (a (G, H) occupancy)
LAUNCHES = {"exact_scan": 0, "exact_scan/bonus": 0, "exact_scan/groups": 0,
            "best_host": 0, "best_host/groups": 0, "blocked_cumsum": 0,
            "blocked_cumsum/global": 0, "ordered_scatter": 0,
            "ordered_scatter/cluster": 0, "ordered_scatter/sorted": 0,
            "sum_ordered": 0, "sum_ordered/cluster": 0,
            "sum_ordered/levels": 0}


# the counters are bumped from every thread that launches (each pool's
# match_cycle runs on a thread of its own when a bench cycle drives K
# pools together); `d[k] += 1` is a read and a write, so bumps take it
_COUNT_LOCK = threading.Lock()


def count(table: dict, name: str) -> None:
    """Add one to `table[name]` (LAUNCHES, match.ROUNDS) under the
    counters' lock."""
    with _COUNT_LOCK:
        table[name] += 1


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def pack_hosts(mem_left, cpus_left, gpus_left, cap_mem, cap_cpus,
               cap_gpus, slots_left, valid, occ0) -> torch.Tensor:
    """(16, H) f32 host field stack."""
    f = torch.float32
    rows = [mem_left, cpus_left, gpus_left, cap_mem, cap_cpus, cap_gpus,
            slots_left.to(f), valid.to(f), occ0.to(f)]
    out = torch.zeros((HOST_ROWS, mem_left.shape[0]), dtype=f,
                      device=mem_left.device)
    out[:len(rows)] = torch.stack(rows, dim=0)
    return out


def pack_jobs(mem, cpus, gpus, active, unique, group=None) -> torch.Tensor:
    """(N, 8) f32 job field stack; the group column stays 0 without
    `group` (the TPU layout)."""
    f = torch.float32
    cols = [mem, cpus, gpus, active.to(f), unique.to(f)]
    if group is not None:
        cols.append(group.to(f))
    out = torch.zeros((mem.shape[0], JOB_COLS), dtype=f, device=mem.device)
    out[:, :len(cols)] = torch.stack(cols, dim=1)
    return out


def exact_scan_ok(S: int, H: int, num_groups: int) -> bool:
    """Eligibility gate of the walk kernel: any walk the reference's XLA
    scan takes — any number of groups below MAX_GROUPS (the group id
    rides as f32), any S, a bonus or none.

    The TPU gate's conditions do not carry over. `num_groups == 1` and
    the absent bonus came from the Pallas kernel's single occupancy row;
    the CUDA kernel reads a (G, H) occupancy and a bonus ring. `S % 8`
    and `H % 1024` came from the (8, 128) vector tiling of a
    VMEM-resident host stack; the CUDA kernel cuts the hosts into one
    slice per CTA of its cluster and walks each slice with a strided
    loop, so any H works (a mask or bonus row not 16-byte sized is read
    with plain loads instead of bulk copies). The VMEM budget kept the
    whole (S, H) forbidden mask on chip; the CUDA kernel prefetches a few
    mask rows at a time and keeps up to 65,536 hosts' lanes on chip, the
    rest in a device-memory scratch, so no H is refused. The remaining
    limits are the index widths: i32 host ids, i64 mask offsets.
    """
    return 1 <= num_groups < MAX_GROUPS and 0 <= S and 1 <= H < 2 ** 31


def exact_scan(jobs_packed: torch.Tensor, hosts_packed: torch.Tensor,
               forbidden_u8: torch.Tensor, occ: torch.Tensor | None = None,
               bonus: torch.Tensor | None = None):
    """Fused sequential-greedy assignment (`match._scan_assign`).

    jobs_packed: (S, 8) f32 (J_GROUP read only with `occ`); hosts_packed:
    (16, H) f32; forbidden_u8: (S, H) uint8 or bool (nonzero =
    excluded); occ: None (one group: the host stack's H_OCC0 row) or the
    (G, H) bool/uint8 occupancy of G groups; bonus: None or an (S, H)
    f32 fitness bonus. Returns (job_host (S,) i32, hosts_out (16, H) f32
    — the depleted host stack, H_OCC0 updated when occ is None), plus
    the updated (G, H) occupancy (occ's dtype) when occ is given. CUDA
    tensors launch the kernel; CPU tensors run the plain version.
    """
    dev = jobs_packed.device
    if dev.type == "cpu":
        return exact_scan_plain(jobs_packed, hosts_packed, forbidden_u8,
                                occ, bonus)
    if dev.type != "cuda":
        raise ValueError(f"exact_scan: unsupported device {dev}")
    return _exact_scan_cuda(jobs_packed, hosts_packed, forbidden_u8, occ,
                            bonus)


def exact_scan_cluster() -> int:
    """CTAs in the CUDA kernel's cluster: 16 where the card can co-schedule
    them, else 8 (builds the kernel; needs the CUDA toolkit)."""
    from cook_tpu_torch.kernels import build

    return int(build.load("exact_scan").exact_scan_cluster())


def _ptr(t):
    """A tensor's (or None's) data pointer for ctypes."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _check_occ(kernel, forb, occ):
    """The byte masks' dtypes and the occupancy's group count."""
    for name, t in (("forbidden", forb), ("occ", occ)):
        if t is not None and t.dtype not in (torch.uint8, torch.bool):
            raise TypeError(f"{kernel}: {name} must be uint8/bool, got "
                            f"{t.dtype}")
    if occ is not None and occ.shape[0] >= MAX_GROUPS:
        raise ValueError(f"{kernel}: {occ.shape[0]} groups, the group "
                         f"column is exact below {MAX_GROUPS}")


def _check(jobs_packed, hosts_packed, forb, occ=None, bonus=None):
    S = jobs_packed.shape[0]
    H = hosts_packed.shape[1]
    if jobs_packed.shape != (S, JOB_COLS) or \
            hosts_packed.shape != (HOST_ROWS, H) or forb.shape != (S, H) \
            or (bonus is not None and bonus.shape != (S, H)) \
            or (occ is not None and (occ.dim() != 2 or occ.shape[1] != H
                                     or occ.shape[0] < 1)):
        raise ValueError(
            f"exact_scan shapes: jobs {tuple(jobs_packed.shape)}, hosts "
            f"{tuple(hosts_packed.shape)}, forbidden {tuple(forb.shape)}, "
            f"occ {None if occ is None else tuple(occ.shape)}, bonus "
            f"{None if bonus is None else tuple(bonus.shape)}")
    if jobs_packed.dtype != torch.float32 or \
            hosts_packed.dtype != torch.float32 or \
            (bonus is not None and bonus.dtype != torch.float32):
        raise TypeError("exact_scan: jobs, hosts and bonus must be float32")
    _check_occ("exact_scan", forb, occ)
    return S, H


def _exact_scan_cuda(jobs_packed, hosts_packed, forb, occ, bonus):
    from cook_tpu_torch.kernels import build

    S, H = _check(jobs_packed, hosts_packed, forb, occ, bonus)
    dev = jobs_packed.device
    ins = [t for t in (jobs_packed, hosts_packed, forb, occ, bonus)
           if t is not None]
    if any(t.device != dev for t in ins):
        raise ValueError("exact_scan: all inputs must be on one device")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("exact_scan: inputs must be contiguous")
    if not (S >= 0 and 1 <= H < 2 ** 31):
        raise ValueError(f"exact_scan: S={S}, H={H} out of range")
    if forb.dtype == torch.bool:
        forb = forb.view(torch.uint8)
    lib = build.load("exact_scan")
    job_host = torch.empty(S, dtype=torch.int32, device=dev)
    hosts_out = torch.empty_like(hosts_packed)
    occ_out = None if occ is None else torch.empty_like(occ)
    # scratch for the hosts beyond the kernel's on-chip capacity: per
    # host mutable lanes (mem, cpus, gpus, slots), static lanes (cap_mem,
    # cap_cpus, 1/cap_mem, 1/cap_cpus) and flag bits, indexed by host
    dyn = torch.empty((H, 4), dtype=torch.float32, device=dev)
    stat = torch.empty((H, 4), dtype=torch.float32, device=dev)
    flags = torch.empty(H, dtype=torch.uint8, device=dev)

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.exact_scan_launch(
            _ptr(jobs_packed), _ptr(hosts_packed), _ptr(forb), _ptr(bonus),
            _ptr(occ), _ptr(job_host), _ptr(hosts_out), _ptr(occ_out),
            _ptr(dyn), _ptr(stat), _ptr(flags), ctypes.c_int(S),
            ctypes.c_int(H),
            ctypes.c_int(1 if occ is None else occ.shape[0]),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"exact_scan kernel launch failed: CUDA error "
                           f"{rc}")
    count(LAUNCHES, "exact_scan/groups" if occ is not None else
          "exact_scan/bonus" if bonus is not None else "exact_scan")
    if occ is None:
        return job_host, hosts_out
    return job_host, hosts_out, occ_out


def _frac(used_plus, cap):
    """The reference's `where(cap > 0, (used + demand) / cap, 0)`."""
    return torch.where(cap > 0, used_plus / cap, 0.0)


def exact_scan_plain(jobs_packed: torch.Tensor, hosts_packed: torch.Tensor,
                     forbidden_u8: torch.Tensor,
                     occ: torch.Tensor | None = None,
                     bonus: torch.Tensor | None = None):
    """Plain PyTorch version of the kernel, on any device: one Python-loop
    step per job of `match._scan_assign` (cook_tpu/ops/match.py:135-172)
    on the packed layout — the feasibility mask, the group's unique
    occupancy, division-form fitness `0.5 * (f_mem + f_cpu)` then
    `+ bonus`, the first maximum, and the depletion. Returns what
    `exact_scan` returns."""
    S, H = _check(jobs_packed, hosts_packed, forbidden_u8, occ, bonus)
    dev = hosts_packed.device
    hp = hosts_packed
    cap_mem, cap_cpus, cap_gpus = hp[H_CAP_MEM], hp[H_CAP_CPUS], \
        hp[H_CAP_GPUS]
    is_gpu = cap_gpus > 0
    base_ok = hp[H_VALID] > 0
    mem, cpus, gpus = hp[H_MEM].clone(), hp[H_CPUS].clone(), \
        hp[H_GPUS].clone()
    slots, occ0 = hp[H_SLOTS].clone(), hp[H_OCC0].clone()
    groups = None if occ is None else occ != 0      # a fresh (G, H) copy
    gclip = None if occ is None else torch.clamp(
        jobs_packed[:, J_GROUP], 0, occ.shape[0] - 1).long()
    allowed = forbidden_u8 == 0
    job_host = torch.empty(S, dtype=torch.int32, device=dev)
    for i in range(S):
        row = jobs_packed[i]
        jm, jc, jg = row[J_MEM], row[J_CPUS], row[J_GPUS]
        ju = row[J_UNIQUE] > 0
        ok = base_ok & (slots > 0) & allowed[i]
        ok = ok & (mem + EPS >= jm) & (cpus + EPS >= jc)
        ok = ok & torch.where(jg > 0, is_gpu & (gpus + EPS >= jg), ~is_gpu)
        if groups is None:
            occupied = occ0 > 0
        else:
            g = gclip[i:i + 1]                          # (1,): no sync
            occupied = groups[g][0]
        ok = ok & ~(ju & occupied) & (row[J_ACTIVE] > 0)
        fit = 0.5 * (_frac(cap_mem - mem + jm, cap_mem)
                     + _frac(cap_cpus - cpus + jc, cap_cpus))
        if bonus is not None:
            fit = fit + bonus[i]
        fit = torch.where(ok, fit, -1.0)
        best = torch.argmax(fit).view(1)     # first maximum
        assigned = fit[best] > -0.5
        a = assigned.to(torch.float32)
        job_host[i] = torch.where(assigned, best, NO_HOST)[0]
        mem[best] = mem[best] - a * jm
        cpus[best] = cpus[best] - a * jc
        gpus[best] = gpus[best] - a * jg
        slots[best] = slots[best] - a
        if groups is None:
            occ0[best] = torch.maximum(occ0[best], a * ju.to(torch.float32))
        else:
            groups[g, best] = groups[g, best] | (assigned & ju)
    hosts_out = hosts_packed.clone()
    hosts_out[H_MEM], hosts_out[H_CPUS], hosts_out[H_GPUS] = mem, cpus, gpus
    hosts_out[H_SLOTS], hosts_out[H_OCC0] = slots, occ0
    if occ is None:
        return job_host, hosts_out
    return job_host, hosts_out, groups.to(occ.dtype)


# ---- best_host: one dense round ---------------------------------------

_U32 = 0xFFFFFFFF


def _mul_u32(z: torch.Tensor, k: int) -> torch.Tensor:
    """(z * k) mod 2**32 for int64 tensors holding u32 values: the
    factor is split in 16-bit halves so no int64 product overflows."""
    lo = z * (k & 0xFFFF)
    hi = ((z * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def jitter(rows: int, cols: int, spread: float, device) -> torch.Tensor:
    """(rows, cols) f32 per-(row, host) noise in [0, spread): the u32
    hash of the XLA dense round (match.py:690-697) and the TPU kernel
    (pallas_match.py:114-129), keyed on the global row and host index,
    in int64 with every product reduced mod 2**32."""
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    z = (_mul_u32(r, 2654435761) + _mul_u32(c, 40503)) & _U32
    z = z ^ (z >> 15)
    z = _mul_u32(z, 2246822519)
    z = z ^ (z >> 13)
    return ((z & 0xFFFF).to(torch.float32) / 65536.0
            * torch.tensor(spread, dtype=torch.float32, device=device))


def best_host(jobs_packed: torch.Tensor, hosts_packed: torch.Tensor,
              forbidden: torch.Tensor, bonus: torch.Tensor | None = None,
              spread: float = 0.0, occ: torch.Tensor | None = None):
    """Fused feasibility + fitness + argmax over hosts, for every row.

    jobs_packed: (N, 8) f32 from pack_jobs (J_GROUP read only with
    `occ`); hosts_packed: (16, H) f32 from pack_hosts; forbidden: (N, H)
    uint8 or bool (nonzero = excluded); bonus: optional (N, H) f32
    additive fitness; spread: the jitter amplitude (0 = none); occ: None
    (one group: the host stack's H_OCC0 row) or the (G, H) bool/uint8
    occupancy of G groups. Returns (best_fit (N,) f32, best_host (N,)
    i32): the first maximum of each row and its host, or (-1.0, -1) when
    no host is feasible. CUDA tensors launch the kernel; CPU tensors run
    the plain version.

    The TPU kernel's gates do not carry over. Its single group came from
    folding group-0 occupancy into the host stack; the CUDA kernel reads
    a (G, H) occupancy beside the mask. `N % bn`, `H % bh` and `H % 128`
    (pallas_match.py:304-309) and the `_D`/`H` divisibility conditions
    of match.py:410-413 came from BlockSpec tiles of (8, 128)-aligned
    VMEM blocks; the CUDA kernel tiles rows and hosts itself and masks
    the ragged edges (an H that is not a multiple of 16 takes byte mask
    loads), so any N and H work. The remaining limits are index widths
    (i32 host ids, i64 mask offsets, at most 65,535 tiles of 128 hosts),
    checked by the wrapper.
    """
    dev = jobs_packed.device
    if dev.type == "cpu":
        return best_host_plain(jobs_packed, hosts_packed, forbidden, bonus,
                               spread, occ)
    if dev.type != "cuda":
        raise ValueError(f"best_host: unsupported device {dev}")
    return _best_host_cuda(jobs_packed, hosts_packed, forbidden, bonus,
                           spread, occ)


def _check_best(jobs_packed, hosts_packed, forb, bonus, occ=None):
    N = jobs_packed.shape[0]
    H = hosts_packed.shape[1]
    if jobs_packed.shape != (N, JOB_COLS) or \
            hosts_packed.shape != (HOST_ROWS, H) or forb.shape != (N, H) \
            or (bonus is not None and bonus.shape != (N, H)) \
            or (occ is not None and (occ.dim() != 2 or occ.shape[1] != H
                                     or occ.shape[0] < 1)):
        raise ValueError(
            f"best_host shapes: jobs {tuple(jobs_packed.shape)}, hosts "
            f"{tuple(hosts_packed.shape)}, forbidden {tuple(forb.shape)}, "
            f"bonus {None if bonus is None else tuple(bonus.shape)}, occ "
            f"{None if occ is None else tuple(occ.shape)}")
    if jobs_packed.dtype != torch.float32 or \
            hosts_packed.dtype != torch.float32 or \
            (bonus is not None and bonus.dtype != torch.float32):
        raise TypeError("best_host: jobs, hosts and bonus must be float32")
    _check_occ("best_host", forb, occ)
    return N, H


def _best_host_cuda(jobs_packed, hosts_packed, forb, bonus, spread, occ):
    from cook_tpu_torch.kernels import build

    N, H = _check_best(jobs_packed, hosts_packed, forb, bonus, occ)
    dev = jobs_packed.device
    ins = [t for t in (jobs_packed, hosts_packed, forb, bonus, occ)
           if t is not None]
    if any(t.device != dev for t in ins):
        raise ValueError("best_host: all inputs must be on one device")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("best_host: inputs must be contiguous")
    if not (N >= 1 and 1 <= H <= 65535 * 128):
        raise ValueError(f"best_host: N={N}, H={H} out of range")
    if forb.dtype == torch.bool:
        forb = forb.view(torch.uint8)
    lib = build.load("best_host")
    best_fit = torch.empty(N, dtype=torch.float32, device=dev)
    best_idx = torch.empty(N, dtype=torch.int32, device=dev)
    # each row's argmax slot and the kernel's CTA counter (zeroed by the
    # launch function on the stream)
    scratch = torch.empty(N + 1, dtype=torch.int64, device=dev)

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.best_host_launch(
            _ptr(jobs_packed), _ptr(hosts_packed), _ptr(forb), _ptr(bonus),
            _ptr(occ), _ptr(best_fit), _ptr(best_idx), _ptr(scratch),
            ctypes.c_int(N), ctypes.c_int(H),
            ctypes.c_int(1 if occ is None else occ.shape[0]),
            ctypes.c_float(spread), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"best_host kernel launch failed: CUDA error "
                           f"{rc}")
    count(LAUNCHES, "best_host" if occ is None else "best_host/groups")
    return best_fit, best_idx


def best_host_division_mismatches(b0: int = 0, nb: int = 1 << 23) -> int:
    """How often best_host's division, RN(a / b) from a reciprocal taken
    once per host, differs from IEEE division (`__fdiv_rn`) over the b
    mantissas [b0, b0 + nb) x every a mantissa (a, b in [1, 2)); the
    default covers every pair, 2^46 of them. The kernel uses it only
    where both scale by powers of two without rounding, so 0 here holds
    it for every pair it divides. Runs on the current CUDA device and
    reads the count back."""
    from cook_tpu_torch.kernels import build

    lib = build.load("best_host")
    bad = torch.zeros(1, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    step = 1 << 16
    for b in range(b0, b0 + nb, step):
        rc = lib.best_host_div_check(b, min(step, b0 + nb - b),
                                     ctypes.c_void_p(bad.data_ptr()),
                                     ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"best_host_div_check launch failed: CUDA "
                               f"error {rc}")
    return int(bad.item())


def best_host_feasible(jobs_packed: torch.Tensor, hosts_packed: torch.Tensor,
                       forbidden: torch.Tensor,
                       occ: torch.Tensor | None = None) -> torch.Tensor:
    """(N, H) bool: the (row, host) pairs best_host scores — host valid
    with slots left, not forbidden, mem/cpus fit within 1e-6, the
    gpu-host rule, no unique clash (the H_OCC0 row, or the row's group's
    row of `occ`), row active (the TPU kernel's mask,
    pallas_match.py:93-105; the XLA dense round's group gather,
    match.py:676-678)."""
    def col(c):
        return jobs_packed[:, c:c + 1]

    def row(r):
        return hosts_packed[r][None, :]

    jg = col(J_GPUS)
    is_gpu = row(H_CAP_GPUS) > 0
    ok = (row(H_VALID) > 0) & (row(H_SLOTS) > 0) & (forbidden == 0)
    ok = ok & (row(H_MEM) + EPS >= col(J_MEM)) \
        & (row(H_CPUS) + EPS >= col(J_CPUS))
    ok = ok & torch.where(jg > 0, is_gpu & (row(H_GPUS) + EPS >= jg),
                          ~is_gpu)
    if occ is None:
        occupied = row(H_OCC0) > 0
    else:
        g = torch.clamp(jobs_packed[:, J_GROUP], 0, occ.shape[0] - 1)
        occupied = occ[g.long()] != 0
    return ok & ~((col(J_UNIQUE) > 0) & occupied) & (col(J_ACTIVE) > 0)


def best_host_plain(jobs_packed: torch.Tensor, hosts_packed: torch.Tensor,
                    forbidden: torch.Tensor,
                    bonus: torch.Tensor | None = None, spread: float = 0.0,
                    occ: torch.Tensor | None = None):
    """Plain PyTorch version of the kernel, on any device: the (N, H)
    masked fitness materialised, then a first-maximum argmax per row.
    Same f32 operations in the same order as the kernel: division-form
    fitness, `0.5 * (f_mem + f_cpu)`, then `+ bonus`, then `+ noise`
    (only when spread is nonzero, as in the TPU kernel)."""
    N, H = _check_best(jobs_packed, hosts_packed, forbidden, bonus, occ)
    ok = best_host_feasible(jobs_packed, hosts_packed, forbidden, occ)
    jm = jobs_packed[:, J_MEM:J_MEM + 1]
    jc = jobs_packed[:, J_CPUS:J_CPUS + 1]
    mem, cpus = hosts_packed[H_MEM][None, :], hosts_packed[H_CPUS][None, :]
    cap_mem = hosts_packed[H_CAP_MEM][None, :]
    cap_cpus = hosts_packed[H_CAP_CPUS][None, :]
    fit = 0.5 * (_frac(cap_mem - mem + jm, cap_mem)
                 + _frac(cap_cpus - cpus + jc, cap_cpus))
    if bonus is not None:
        fit = fit + bonus
    if spread:
        fit = fit + jitter(N, H, spread, fit.device)
    fit = torch.where(ok, fit, -1.0)
    best = torch.argmax(fit, dim=1)             # first maximum
    m = fit.gather(1, best[:, None])[:, 0]
    # the TPU kernel's running max starts at (-1.0, none)
    return (torch.clamp(m, min=-1.0),
            torch.where(m > -1.0, best, NO_HOST).to(torch.int32))
