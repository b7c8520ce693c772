"""Distributed sequential-greedy match, hosts sharded over the mesh (a
port of cook_tpu/parallel/sharded_match.py).

Per scan step (one job):
  1. every shard scores its local hosts (feasibility + fitness +
     same-cycle group occupancy + optional data-locality bonus),
  2. one `pmax` reduces the best local fitness to the global best,
  3. one `pmin` picks the lowest global host index among the shards
     tying at that fitness (the single-device argmax's tie-break),
  4. the winning shard subtracts the job's resources from its hosts and
     marks its group-occupancy row.

Occupancy is per-host state, so each shard keeps a (num_groups, H_local)
bool of its own hosts and only the winning shard marks it: feasibility
stays shard-local. Semantics are those of ops/match.match_scan.

The reference is one compiled `lax.scan`; here the S steps are a Python
loop of eager launches per shard that reads nothing back to the host
within a step (per-step values stay (1,) tensors: a 0-d integer tensor
used as an index would be read back by PyTorch's indexing); each job's
validity, group and gpu flags are read once before the loop, so a step
launches only the terms that apply to its job. It is plain PyTorch: the
reference's scan is XLA, not a Pallas kernel.
"""
from __future__ import annotations

import functools

import torch

from cook_tpu_torch.ops import match as match_ops
from cook_tpu_torch.parallel import Mesh, pmax, pmin, visible_devices

HOST_AXIS = "hosts"
_BIG = 2 ** 30


def make_host_mesh(n_devices: int | None = None, devices=None,
                   device="cuda") -> Mesh:
    """A 1-D host mesh over the first `n_devices` visible devices of type
    `device`, or over an explicit `devices` list (which may repeat a
    device). Raises when fewer than `n_devices` are visible."""
    if devices is None:
        devices = visible_devices(n_devices, device)
    return Mesh(list(devices), (HOST_AXIS,))


def shard_hosts(mesh: Mesh, hosts: match_ops.Hosts) -> list:
    """A `Hosts` of (H,) lanes as per-shard `Hosts` of H / D contiguous
    hosts each, on the shards' devices."""
    D = mesh.devices.size
    H = hosts.mem.shape[0]
    if H % D:
        raise ValueError(f"{H} hosts do not shard evenly over {D} devices")
    Hl = H // D
    return [match_ops.Hosts(*(f[s * Hl:(s + 1) * Hl].to(d)
                              for f in hosts))
            for s, d in enumerate(mesh.devices.flat)]


def shard_columns(mesh: Mesh, x: torch.Tensor) -> list:
    """An (N, H) tensor as per-shard (N, H / D) column blocks on the
    shards' devices."""
    D = mesh.devices.size
    Hl = x.shape[1] // D
    return [x[:, s * Hl:(s + 1) * Hl].to(d)
            for s, d in enumerate(mesh.devices.flat)]


def sharded_match_scan(mesh: Mesh, num_groups: int = 1,
                       with_bonus: bool = False):
    """Build the host-sharded greedy matcher for `mesh`.

    fn(jobs: Jobs, hosts, forbidden[, bonus]) -> MatchResult

    `hosts` is a `Hosts` of (H,) lanes with H divisible by the mesh size,
    or a list of per-shard `Hosts` already on the shards' devices;
    `forbidden` and `bonus` are (N, H) tensors or lists of per-shard
    (N, H / D) blocks. jobs are replicated to every shard. The returned
    job_host (N,) i32 is on the mesh's first device; the *_left lanes
    stay sharded: lists of per-shard (H / D,) tensors. num_groups bounds
    the same-cycle group-occupancy table as match_scan's."""
    shards = list(mesh.devices.flat)
    G = num_groups

    def run(jobs, hosts, forbidden, bonus=None):
        if bonus is not None and not with_bonus:
            raise ValueError(
                "bonus passed to a matcher built with with_bonus=False; "
                "build sharded_match_scan(mesh, with_bonus=True)")
        if isinstance(hosts, match_ops.Hosts):
            hosts = shard_hosts(mesh, hosts)
        if isinstance(forbidden, torch.Tensor):
            forbidden = shard_columns(mesh, forbidden)
        if isinstance(bonus, torch.Tensor):
            bonus = shard_columns(mesh, bonus)
        N = jobs.mem.shape[0]
        # which steps run, and which of their terms apply: read once
        # before the loop (one sync a call, none a step). An invalid
        # job places nowhere and changes nothing; a job of no unique
        # group leaves occupancy alone; a cpu job leaves the gpu lane
        # alone and fits only the non-gpu hosts
        valid, unique, gpu_job = torch.stack(
            [jobs.valid, jobs.unique_group, jobs.gpus > 0]).cpu().tolist()
        st = []
        base = 0
        for s, d in enumerate(shards):
            h = hosts[s]
            Hl = h.mem.shape[0]
            j = match_ops.Jobs(*(f.to(d) for f in jobs))
            cap2 = torch.stack([h.cap_mem, h.cap_cpus])
            is_gpu = h.cap_gpus > 0
            st.append({
                "h": h, "allowed": ~forbidden[s],
                "bonus": None if bonus is None else bonus[s],
                # (mem, cpus) side by side: one op serves both lanes,
                # each element through the same f32 ops as match_scan's
                "job2": torch.stack([j.mem, j.cpus], -1)[:, :, None],
                "jgpus": j.gpus,
                "gclip": torch.clamp(j.group, 0, G - 1).long(),
                "gar": torch.arange(G, device=d)[:, None],
                # this shard's hosts by their global index
                "gidx": torch.arange(base, base + Hl, device=d),
                "base": base, "cap2": cap2, "cap_pos2": cap2 > 0,
                "is_gpu": is_gpu, "not_gpu": ~is_gpu,
                "left2": torch.stack([h.mem, h.cpus]),
                "gpus": h.gpus.clone(), "slots": h.task_slots.clone(),
                "occ": torch.zeros((G, Hl), dtype=torch.bool, device=d),
            })
            base += Hl
        job_host = torch.full((N,), match_ops.NO_HOST, dtype=torch.int32,
                              device=shards[0])
        for i in range(N):
            if not valid[i]:
                continue
            lfit, lbest = [], []
            for c in st:
                h, j2 = c["h"], c["job2"][i]
                # match._feasible's terms
                ok = h.valid & (c["slots"] > 0) & c["allowed"][i]
                ok = ok & (c["left2"] + 1e-6 >= j2).all(0)
                if gpu_job[i]:
                    jg = c["jgpus"][i]
                    ok = ok & (c["is_gpu"] & (c["gpus"] + 1e-6 >= jg))
                else:
                    ok = ok & c["not_gpu"]
                if unique[i]:
                    # this shard's hosts already holding a cotask
                    ok = ok & ~torch.index_select(
                        c["occ"], 0, c["gclip"][i:i + 1])[0]
                # match._fitness: the mean of the used fractions
                f2 = torch.where(c["cap_pos2"],
                                 (c["cap2"] - c["left2"] + j2) / c["cap2"],
                                 0.0)
                fit = 0.5 * (f2[0] + f2[1])
                if c["bonus"] is not None:
                    fit = fit + c["bonus"][i]
                fit = torch.where(ok, fit, -1.0)
                # first maximum: the lowest local index among ties
                f, b = torch.max(fit, dim=0, keepdim=True)
                lfit.append(f)
                lbest.append(b)
            gfit = pmax(lfit, mesh)
            cand = [torch.where((lf == gf) & (gf > -0.5), c["base"] + lb,
                                _BIG)
                    for lf, gf, lb, c in zip(lfit, gfit, lbest, st)]
            gwin = pmin(cand, mesh)
            for c, gw in zip(st, gwin):
                # gwin == _BIG (unassigned) matches no host
                onehot = c["gidx"] == gw
                c["left2"] = c["left2"] - torch.where(onehot, c["job2"][i],
                                                      0.0)
                if gpu_job[i]:
                    c["gpus"] = c["gpus"] - torch.where(
                        onehot, c["jgpus"][i], 0.0)
                c["slots"] = c["slots"] - onehot.to(torch.int32)
                if unique[i]:
                    c["occ"] = c["occ"] | (
                        (c["gar"] == c["gclip"][i:i + 1]) & onehot[None, :])
            job_host[i:i + 1] = torch.where(gwin[0] < _BIG, gwin[0],
                                            match_ops.NO_HOST)
        return match_ops.MatchResult(
            job_host=job_host, mem_left=[c["left2"][0] for c in st],
            cpus_left=[c["left2"][1] for c in st],
            gpus_left=[c["gpus"] for c in st],
            slots_left=[c["slots"] for c in st])

    return run


@functools.lru_cache(maxsize=32)
def resident_matcher(mesh: Mesh, num_groups: int, with_bonus: bool):
    """Cached factory for the resident pool's dispatch path: a matcher
    with the (jobs, hosts, forb, bonus) -> MatchResult signature
    cycle_ops.rank_and_match accepts as its `matcher` override, one per
    (mesh, num_groups, with_bonus)."""
    return sharded_match_scan(mesh, num_groups=num_groups,
                              with_bonus=with_bonus)
