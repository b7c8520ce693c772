"""The fused match kernels: the counterpart of
cook_tpu/ops/pallas_match.py (`pack_jobs`, `pack_hosts`, `exact_scan`,
`_exact_scan_kernel`, `exact_scan_ok`, `best_host`, `_score_tile`,
`_accumulate`, `_kernel`, `_kernel_bonus`).

  exact_scan  the whole sequential-greedy walk (the Fenzo walk) in one
              launch of a thread-block cluster (csrc/exact_scan.cu);
  best_host   one dense round of the batched matcher: feasibility +
              fitness + optional bonus + hash jitter, row argmax over
              hosts (csrc/best_host.cu).

Each wrapper launches its hand-written sm_90a kernel for CUDA tensors
and runs its plain PyTorch version (`*_plain`) for CPU tensors; anything
else raises. There is no fallback from a kernel to its plain version.

`exact_scan_plain` repeats its kernel's arithmetic exactly: fitness with
precomputed reciprocals (pallas_match.py:190-191, 214-215), not
`match._fitness`'s division. `best_host_plain` uses the division form
(pallas_match.py:108-111), as its kernel and the XLA dense round do.
"""
from __future__ import annotations

import ctypes

import torch

NO_HOST = -1
EPS = 1e-6

# host-stack row indices of the (16, H) host tensor
H_MEM, H_CPUS, H_GPUS, H_CAP_MEM, H_CAP_CPUS, H_CAP_GPUS, \
    H_SLOTS, H_VALID, H_OCC0 = range(9)
HOST_ROWS = 16

# job-stack column indices of the (N, 8) job tensor
J_MEM, J_CPUS, J_GPUS, J_ACTIVE, J_UNIQUE = range(5)
JOB_COLS = 8

# kernel launches by name, counted by the wrapper where it launches
LAUNCHES = {"exact_scan": 0, "best_host": 0, "blocked_cumsum": 0,
            "blocked_cumsum/global": 0, "ordered_scatter": 0,
            "ordered_scatter/sorted": 0, "sum_ordered": 0,
            "sum_ordered/levels": 0}


def reset_launches() -> None:
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


def pack_jobs(mem, cpus, gpus, active, unique) -> torch.Tensor:
    """(N, 8) f32 job field stack."""
    f = torch.float32
    cols = [mem, cpus, gpus, active.to(f), unique.to(f)]
    out = torch.zeros((mem.shape[0], JOB_COLS), dtype=f, device=mem.device)
    out[:, :len(cols)] = torch.stack(cols, dim=1)
    return out


def exact_scan_ok(S: int, H: int, num_groups: int) -> bool:
    """Eligibility gate: the reference's semantic conditions only —
    single-group coupling and at least one 8-row tile of jobs (the
    caller checks there is no bonus).

    The TPU gate's other two conditions do not carry over. `H % 1024`
    came from the (8, 128) vector tiling of a VMEM-resident host stack;
    the CUDA kernel cuts the hosts into one slice per CTA of its cluster
    and walks each slice with a strided loop, so any H works (a mask row
    not 16-byte sized is read with plain loads instead of bulk copies).
    The VMEM budget kept the whole (S, H) forbidden mask on chip; the
    CUDA kernel prefetches a few mask rows at a time and keeps up to
    65,536 hosts' lanes on chip, the rest in a device-memory scratch, so
    no H is refused. The remaining limits are the index widths: i32 host
    ids, i64 mask offsets.
    """
    return num_groups == 1 and S >= 8 and 1 <= H < 2 ** 31


def exact_scan(jobs_packed: torch.Tensor, hosts_packed: torch.Tensor,
               forbidden_u8: torch.Tensor):
    """Fused sequential-greedy assignment for num_groups == 1.

    jobs_packed: (S, 8) f32; hosts_packed: (16, H) f32; forbidden_u8:
    (S, H) uint8 or bool (nonzero = excluded). Returns (job_host (S,)
    i32, hosts_out (16, H) f32 — the depleted host stack incl. occ0).
    CUDA tensors launch the kernel; CPU tensors run the plain version.
    """
    dev = jobs_packed.device
    if dev.type == "cpu":
        return exact_scan_plain(jobs_packed, hosts_packed, forbidden_u8)
    if dev.type != "cuda":
        raise ValueError(f"exact_scan: unsupported device {dev}")
    return _exact_scan_cuda(jobs_packed, hosts_packed, forbidden_u8)


def exact_scan_cluster() -> int:
    """CTAs in the CUDA kernel's cluster: 16 where the card can co-schedule
    them, else 8 (builds the kernel; needs the CUDA toolkit)."""
    from cook_tpu_torch.kernels import build

    return int(build.load("exact_scan").exact_scan_cluster())


def _check(jobs_packed, hosts_packed, forb):
    S = jobs_packed.shape[0]
    H = hosts_packed.shape[1]
    if jobs_packed.shape != (S, JOB_COLS) or \
            hosts_packed.shape != (HOST_ROWS, H) or forb.shape != (S, H):
        raise ValueError(
            f"exact_scan shapes: jobs {tuple(jobs_packed.shape)}, hosts "
            f"{tuple(hosts_packed.shape)}, forbidden {tuple(forb.shape)}")
    if jobs_packed.dtype != torch.float32 or \
            hosts_packed.dtype != torch.float32:
        raise TypeError("exact_scan: jobs and hosts must be float32")
    if forb.dtype not in (torch.uint8, torch.bool):
        raise TypeError(f"exact_scan: forbidden must be uint8/bool, got "
                        f"{forb.dtype}")
    return S, H


def _exact_scan_cuda(jobs_packed, hosts_packed, forb):
    from cook_tpu_torch.kernels import build

    S, H = _check(jobs_packed, hosts_packed, forb)
    dev = jobs_packed.device
    if hosts_packed.device != dev or forb.device != dev:
        raise ValueError("exact_scan: all inputs must be on one device")
    if not (jobs_packed.is_contiguous() and hosts_packed.is_contiguous()
            and forb.is_contiguous()):
        raise ValueError("exact_scan: inputs must be contiguous")
    if not (S >= 1 and 1 <= H < 2 ** 31):
        raise ValueError(f"exact_scan: S={S}, H={H} out of range")
    if forb.dtype == torch.bool:
        forb = forb.view(torch.uint8)
    lib = build.load("exact_scan")
    job_host = torch.empty(S, dtype=torch.int32, device=dev)
    hosts_out = torch.empty_like(hosts_packed)
    # scratch for the hosts beyond the kernel's on-chip capacity: per
    # host mutable lanes (mem, cpus, gpus, slots), static lanes (cap_mem,
    # cap_cpus, 1/cap_mem, 1/cap_cpus) and flag bits, indexed by host
    dyn = torch.empty((H, 4), dtype=torch.float32, device=dev)
    stat = torch.empty((H, 4), dtype=torch.float32, device=dev)
    flags = torch.empty(H, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.exact_scan_launch(
            ctypes.c_void_p(jobs_packed.data_ptr()),
            ctypes.c_void_p(hosts_packed.data_ptr()),
            ctypes.c_void_p(forb.data_ptr()),
            ctypes.c_void_p(job_host.data_ptr()),
            ctypes.c_void_p(hosts_out.data_ptr()),
            ctypes.c_void_p(dyn.data_ptr()),
            ctypes.c_void_p(stat.data_ptr()),
            ctypes.c_void_p(flags.data_ptr()),
            ctypes.c_int(S), ctypes.c_int(H), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"exact_scan kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["exact_scan"] += 1
    return job_host, hosts_out


def exact_scan_plain(jobs_packed: torch.Tensor, hosts_packed: torch.Tensor,
                     forbidden_u8: torch.Tensor):
    """Plain PyTorch version of the kernel, on any device: the same
    feasibility mask, reciprocal-form fitness, first-maximum argmax and
    depletion, one Python-loop step per job."""
    S, H = _check(jobs_packed, hosts_packed, forbidden_u8)
    dev = hosts_packed.device
    hp = hosts_packed
    cap_mem, cap_cpus, cap_gpus = hp[H_CAP_MEM], hp[H_CAP_CPUS], \
        hp[H_CAP_GPUS]
    is_gpu = cap_gpus > 0
    inv_cm = torch.where(cap_mem > 0, 1.0 / cap_mem, 0.0)
    inv_cc = torch.where(cap_cpus > 0, 1.0 / cap_cpus, 0.0)
    base_ok = hp[H_VALID] > 0
    mem, cpus, gpus = hp[H_MEM].clone(), hp[H_CPUS].clone(), \
        hp[H_GPUS].clone()
    slots, occ0 = hp[H_SLOTS].clone(), hp[H_OCC0].clone()
    allowed = forbidden_u8 == 0
    job_host = torch.empty(S, dtype=torch.int32, device=dev)
    for i in range(S):
        row = jobs_packed[i]
        jm, jc, jg = row[J_MEM], row[J_CPUS], row[J_GPUS]
        ju = (row[J_UNIQUE] > 0).to(torch.float32)
        ok = base_ok & (slots > 0) & allowed[i]
        ok = ok & (mem + EPS >= jm) & (cpus + EPS >= jc)
        ok = ok & torch.where(jg > 0, is_gpu & (gpus + EPS >= jg), ~is_gpu)
        ok = ok & ~((ju > 0) & (occ0 > 0)) & (row[J_ACTIVE] > 0)
        fit = 0.5 * ((cap_mem - mem + jm) * inv_cm
                     + (cap_cpus - cpus + jc) * inv_cc)
        fit = torch.where(ok, fit, -1.0)
        best = torch.argmax(fit).view(1)     # first maximum
        m = fit[best]
        a = (m > -0.5).to(torch.float32)
        job_host[i] = torch.where(m > -0.5, best, NO_HOST)[0]
        mem[best] = mem[best] - a * jm
        cpus[best] = cpus[best] - a * jc
        gpus[best] = gpus[best] - a * jg
        slots[best] = slots[best] - a
        occ0[best] = torch.maximum(occ0[best], a * ju)
    hosts_out = hosts_packed.clone()
    hosts_out[H_MEM], hosts_out[H_CPUS], hosts_out[H_GPUS] = mem, cpus, gpus
    hosts_out[H_SLOTS], hosts_out[H_OCC0] = slots, occ0
    return job_host, hosts_out


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


def best_host_ok(num_groups: int) -> bool:
    """Eligibility gate of the dense-round kernel: single-group coupling
    only (the kernel folds group-0 unique occupancy in, as the TPU
    kernel does; the multi-group gather stays on the plain path).

    The TPU gates do not carry over. `N % bn`, `H % bh` and `H % 128`
    (pallas_match.py:304-309) and the `_D`/`H` divisibility conditions
    of match.py:410-413 came from BlockSpec tiles of (8, 128)-aligned
    VMEM blocks; the CUDA kernel tiles rows and hosts itself and masks
    the ragged edges (an H that is not a multiple of 16 takes byte mask
    loads), so any N and H work. The remaining limits are index widths
    (i32 host ids, i64 mask offsets, at most 65,535 tiles of 128 hosts),
    checked by the wrapper.
    """
    return num_groups == 1


def best_host(jobs_packed: torch.Tensor, hosts_packed: torch.Tensor,
              forbidden: torch.Tensor, bonus: torch.Tensor | None = None,
              spread: float = 0.0):
    """Fused feasibility + fitness + argmax over hosts, for every row.

    jobs_packed: (N, 8) f32 from pack_jobs; hosts_packed: (16, H) f32
    from pack_hosts; forbidden: (N, H) uint8 or bool (nonzero =
    excluded); bonus: optional (N, H) f32 additive fitness; spread: the
    jitter amplitude (0 = none). Returns (best_fit (N,) f32, best_host
    (N,) i32): the first maximum of each row and its host, or
    (-1.0, -1) when no host is feasible. CUDA tensors launch the
    kernel; CPU tensors run the plain version.
    """
    dev = jobs_packed.device
    if dev.type == "cpu":
        return best_host_plain(jobs_packed, hosts_packed, forbidden, bonus,
                               spread)
    if dev.type != "cuda":
        raise ValueError(f"best_host: unsupported device {dev}")
    return _best_host_cuda(jobs_packed, hosts_packed, forbidden, bonus,
                           spread)


def _check_best(jobs_packed, hosts_packed, forb, bonus):
    N = jobs_packed.shape[0]
    H = hosts_packed.shape[1]
    if jobs_packed.shape != (N, JOB_COLS) or \
            hosts_packed.shape != (HOST_ROWS, H) or forb.shape != (N, H) \
            or (bonus is not None and bonus.shape != (N, H)):
        raise ValueError(
            f"best_host shapes: jobs {tuple(jobs_packed.shape)}, hosts "
            f"{tuple(hosts_packed.shape)}, forbidden {tuple(forb.shape)}, "
            f"bonus {None if bonus is None else tuple(bonus.shape)}")
    if jobs_packed.dtype != torch.float32 or \
            hosts_packed.dtype != torch.float32 or \
            (bonus is not None and bonus.dtype != torch.float32):
        raise TypeError("best_host: jobs, hosts and bonus must be float32")
    if forb.dtype not in (torch.uint8, torch.bool):
        raise TypeError(f"best_host: forbidden must be uint8/bool, got "
                        f"{forb.dtype}")
    return N, H


def _best_host_cuda(jobs_packed, hosts_packed, forb, bonus, spread):
    from cook_tpu_torch.kernels import build

    N, H = _check_best(jobs_packed, hosts_packed, forb, bonus)
    dev = jobs_packed.device
    ins = [jobs_packed, hosts_packed, forb] + \
        ([] if bonus is None else [bonus])
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
            ctypes.c_void_p(jobs_packed.data_ptr()),
            ctypes.c_void_p(hosts_packed.data_ptr()),
            ctypes.c_void_p(forb.data_ptr()),
            ctypes.c_void_p(None if bonus is None else bonus.data_ptr()),
            ctypes.c_void_p(best_fit.data_ptr()),
            ctypes.c_void_p(best_idx.data_ptr()),
            ctypes.c_void_p(scratch.data_ptr()),
            ctypes.c_int(N), ctypes.c_int(H), ctypes.c_float(spread),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"best_host kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["best_host"] += 1
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
                       forbidden: torch.Tensor) -> torch.Tensor:
    """(N, H) bool: the (row, host) pairs best_host scores — host valid
    with slots left, not forbidden, mem/cpus fit within 1e-6, the
    gpu-host rule, no group-0 unique clash, row active (the TPU kernel's
    mask, pallas_match.py:93-105)."""
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
    return ok & ~((col(J_UNIQUE) > 0) & (row(H_OCC0) > 0)) \
        & (col(J_ACTIVE) > 0)


def best_host_plain(jobs_packed: torch.Tensor, hosts_packed: torch.Tensor,
                    forbidden: torch.Tensor,
                    bonus: torch.Tensor | None = None, spread: float = 0.0):
    """Plain PyTorch version of the kernel, on any device: the (N, H)
    masked fitness materialised, then a first-maximum argmax per row.
    Same f32 operations in the same order as the kernel: division-form
    fitness, `0.5 * (f_mem + f_cpu)`, then `+ bonus`, then `+ noise`
    (only when spread is nonzero, as in the TPU kernel)."""
    N, H = _check_best(jobs_packed, hosts_packed, forbidden, bonus)
    ok = best_host_feasible(jobs_packed, hosts_packed, forbidden)
    jm = jobs_packed[:, J_MEM:J_MEM + 1]
    jc = jobs_packed[:, J_CPUS:J_CPUS + 1]
    mem, cpus = hosts_packed[H_MEM][None, :], hosts_packed[H_CPUS][None, :]
    cap_mem = hosts_packed[H_CAP_MEM][None, :]
    cap_cpus = hosts_packed[H_CAP_CPUS][None, :]
    f_mem = torch.where(cap_mem > 0, (cap_mem - mem + jm) / cap_mem, 0.0)
    f_cpu = torch.where(cap_cpus > 0, (cap_cpus - cpus + jc) / cap_cpus, 0.0)
    fit = 0.5 * (f_mem + f_cpu)
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
