"""The fused sequential-greedy match (the Fenzo walk) as one CUDA kernel:
the counterpart of cook_tpu/ops/pallas_match.py (`exact_scan`,
`_exact_scan_kernel`, `exact_scan_ok`, `pack_jobs`, `pack_hosts`).

`exact_scan` launches the hand-written sm_90a kernel
(csrc/exact_scan.cu) for CUDA tensors and runs `exact_scan_plain`, its
plain PyTorch version, for CPU tensors; anything else raises. There is
no fallback from the kernel to the plain version.

`exact_scan_plain` repeats the kernel's arithmetic exactly: fitness with
precomputed reciprocals (pallas_match.py:190-191, 214-215), not
`match._fitness`'s division, so the two agree bit for bit.
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
LAUNCHES = {"exact_scan": 0}


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
    the CUDA kernel walks hosts with a strided loop and masks nothing,
    so any H works. The VMEM budget kept the whole (S, H)
    forbidden mask on chip; the CUDA kernel streams each step's mask row
    from device memory and keeps host state in a device-memory scratch,
    so its footprint is independent of on-chip memory. The remaining
    limits are the index widths: i32 host ids, i64 mask offsets.
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
    # scratch: per host mutable lanes (mem, cpus, gpus, slots), static
    # lanes (cap_mem, cap_cpus, 1/cap_mem, 1/cap_cpus) and flag bits
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
