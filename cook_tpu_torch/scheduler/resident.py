"""Device-resident match state, device half (a port of
cook_tpu/scheduler/resident.py:80-271, 597-616, 1276-1356).

All job/offer tensors live on the device across cycles; the host ships
only the rows that changed since the last cycle, in fixed-shape packed
chunks, and reads back only the matched prefix of the compaction
epilogue. The match result IS the new host availability, so
consecutive cycles chain on the device; external capacity changes
(completions) flow back in as additive credits.

State layout: the reference's dict — "pend"/"run"/"host" dicts of 1-D
lanes, "forb" (K, H) bool, "bonus" (Kb, H) f32 — with ONE extra sink
slot at the end of every lane and row block: the reference's
`.at[idx].set(..., mode="drop")` with idx == cap becomes a plain
scatter whose dropped writes land in the sink, which nothing reads.
The reference donates the state to its jitted programs
(`donate_argnums`); here every program updates the state tensors in
place.

`ResidentPool` is the host half (a port of resident.py:274-1871): the
coordinator-bound pool with store listeners, mirrors of store truth,
delta packing, light and full resync, host reconcile and the
background rebuild. Its host code is the reference's; the device
touchpoints are the upload (`state_to_device`), the scatters above,
`device_cycle`, and the readback of each cycle into pinned buffers of
its own (`start_readback` / `read_outputs`).
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from cook_tpu_torch.device import resolve_device, to_device
from cook_tpu_torch.ops import cycle as cycle_ops
from cook_tpu_torch.ops import match as match_ops
from cook_tpu_torch.ops import segments
from cook_tpu_torch.parallel import Mesh
from cook_tpu_torch.parallel.sharded_match import HOST_AXIS, resident_matcher
from cook_tpu_torch.scheduler import constraints as constraints_mod
from cook_tpu_torch.scheduler.tensorize import F32_MAX, bucket, share_of
from cook_tpu_torch.state.model import JobState
from cook_tpu_torch.utils.lockwitness import witness_lock

log = logging.getLogger(__name__)

# field order is the wire format of a pend-row delta
PEND_FIELDS = ("user", "mem", "cpus", "gpus", "priority", "start_time",
               "valid", "mem_share", "cpus_share", "gpu_share", "group",
               "unique_group", "ports", "forb_slot", "est_s", "bonus_slot")
RUN_FIELDS = ("user", "mem", "cpus", "gpus", "priority", "start_time",
              "valid", "mem_share", "cpus_share", "gpu_share")
_DTYPES = {"user": np.int32, "priority": np.int32, "start_time": np.int32,
           "group": np.int32, "ports": np.int32, "forb_slot": np.int32,
           "est_s": np.int32, "bonus_slot": np.int32,
           "valid": bool, "unique_group": bool,
           "task_slots": np.int32, "death_s": np.int32}

# host death-time sentinel for the estimated-completion lane
EST_NEVER = 1 << 30

DELTA_CHUNK = 4096          # fixed scatter width per table and cycle
PEND_F32 = ("mem", "cpus", "gpus", "mem_share", "cpus_share", "gpu_share")
PEND_I32 = ("user", "priority", "start_time", "group", "ports",
            "forb_slot", "est_s", "bonus_slot",
            "valid", "unique_group")     # bools ride as i32
RUN_F32 = ("mem", "cpus", "gpus", "mem_share", "cpus_share", "gpu_share")
RUN_I32 = ("user", "priority", "start_time", "valid")
FORB_CHUNK = 256
BONUS_CHUNK = 64
HOSTSET_CHUNK = 256
HOST_F32 = ("mem", "cpus", "gpus", "cap_mem", "cap_cpus", "cap_gpus")
HOST_I32 = ("task_slots", "ports", "death_s", "valid")
HOST_FIELDS = HOST_F32 + HOST_I32
CREDIT_CHUNK = 2048
_BOOLS = ("valid", "unique_group")


def _dtype(name):
    return _DTYPES.get(name, np.float32)


def _set_rows(table, fields_f32, fields_i32, idx, tf, ti):
    """table[name][idx] = packed values, in place; idx == cap -> sink."""
    idx = idx.long()
    for k, name in enumerate(fields_f32):
        table[name][idx] = tf[k]
    for k, name in enumerate(fields_i32):
        v = ti[k]
        table[name][idx] = (v != 0) if name in _BOOLS else v


def _apply_pend(pend, idx, pf, pi):
    _set_rows(pend, PEND_F32, PEND_I32, idx, pf, pi)


def _apply_run(run, idx, rf, ri):
    _set_rows(run, RUN_F32, RUN_I32, idx, rf, ri)


def _apply_credit(host, idx, cf, ci):
    """Additive credits, `.at[idx].add(mode="drop")` as the reference:
    the f32 lanes add each host's credits in update order, the three in
    one ordered scatter (one sort) on an (Hcap, 3) copy without the sink
    slot, so idx == Hcap is dropped; the integer lanes are exact in any
    order."""
    names = ("mem", "cpus", "gpus")
    lanes = torch.stack([host[n][:-1] for n in names], -1)
    segments.scatter_add_ordered_(lanes, idx, cf.t().contiguous())
    for k, n in enumerate(names):
        host[n][:-1].copy_(lanes[:, k])
    idx = idx.long()
    host["task_slots"].index_add_(0, idx, ci[0])
    host["ports"].index_add_(0, idx, ci[1])


def scatter_pend(state, idx, pf, pi):
    _apply_pend(state["pend"], idx, pf, pi)


def scatter_run(state, idx, rf, ri):
    _apply_run(state["run"], idx, rf, ri)


# A pool sharded over devices (ResidentPool(devices=...)) keeps its host
# axis in D contiguous blocks: "host" is a list of per-shard lane dicts,
# "forb" and "bonus" lists of per-shard (rows, H / D) blocks, each with
# its own sink slot and on its shard's device; "pend" and "run" stay on
# the first device. Host-axis deltas route to their shard.
def _shards(host_blocks):
    """(first global host, hosts, device, lanes) of each shard."""
    lo = 0
    for h in host_blocks:
        n = h["mem"].shape[0] - 1
        yield lo, n, h["mem"].device, h
        lo += n


def _local(idx, lo, n, dev):
    """Global host indices as one shard's local indices on its device:
    another shard's hosts and the drop index go to the shard's sink."""
    idx = idx.to(dev, non_blocking=True)
    return torch.where((idx >= lo) & (idx < lo + n), idx - lo, n)


def _set_row_blocks(blocks, slot_idx, rows):
    """blocks[slot_idx] = rows for a (rows, H) block or per-shard column
    blocks of one."""
    if not isinstance(blocks, list):
        blocks[slot_idx.long()] = rows
        return
    lo = 0
    for b in blocks:
        n = b.shape[1]
        b[slot_idx.to(b.device, non_blocking=True).long()] = \
            rows[:, lo:lo + n].to(b.device, non_blocking=True)
        lo += n


def scatter_forb(state, slot_idx, rows):
    _set_row_blocks(state["forb"], slot_idx, rows)


def scatter_bonus(state, slot_idx, rows):
    _set_row_blocks(state["bonus"], slot_idx, rows)


def scatter_credit(state, idx, cf, ci):
    host = state["host"]
    if not isinstance(host, list):
        _apply_credit(host, idx, cf, ci)
        return
    # every shard takes the whole update list, another shard's updates
    # dropped: each host's credits still add in update order
    for lo, n, d, h in _shards(host):
        _apply_credit(h, _local(idx, lo, n, d),
                      cf.to(d, non_blocking=True),
                      ci.to(d, non_blocking=True))


def scatter_hostset(state, idx, hf, hi):
    """Set whole host rows (adds, removals, rejoins); unlike the
    additive credit scatter, this REPLACES the row."""
    host = state["host"]
    if not isinstance(host, list):
        _set_rows(host, HOST_F32, HOST_I32, idx, hf, hi)
        return
    for lo, n, d, h in _shards(host):
        _set_rows(h, HOST_F32, HOST_I32, _local(idx, lo, n, d),
                  hf.to(d, non_blocking=True), hi.to(d, non_blocking=True))


SCATTERS = {"pend": scatter_pend, "run": scatter_run, "forb": scatter_forb,
            "bonus": scatter_bonus, "credit": scatter_credit}


def device_cycle(state, deltas, qm, qc, qn, considerable_limit, now_s, *,
                 num_considerable, sequential=True, num_groups=1,
                 dru_mode="default", use_kernel=True, with_bonus=False,
                 with_est=False, matcher=None, match_kw=None):
    """One resident cycle (the counterpart of `_device_cycle`): apply the
    packed delta bundle, rank + filter + match, invalidate matched rows
    and write the match result back as the host state — all in place
    on `state`. Returns the reference's output tuple (cons_idx,
    cons_host, head_matched, n_matched, n_considerable, mat_idx,
    mat_host, why_idx, why_code, why_amt)."""
    (p_idx, pf, pi, r_idx, rf, ri, c_idx, cf, ci, f_idx, frows,
     b_idx, brows) = deltas
    _apply_pend(state["pend"], p_idx, pf, pi)
    _apply_run(state["run"], r_idx, rf, ri)
    scatter_credit(state, c_idx, cf, ci)
    scatter_forb(state, f_idx, frows)
    scatter_bonus(state, b_idx, brows)

    # views without the sink slot
    p = {k: v[:-1] for k, v in state["pend"].items()}
    r = {k: v[:-1] for k, v in state["run"].items()}
    sharded = isinstance(state["host"], list)
    if sharded:
        hb = [{k: v[:-1] for k, v in h.items()} for h in state["host"]]
        forb = [f[:-1] for f in state["forb"]]
        bonus = [b[:-1] for b in state["bonus"]]
    else:
        hb = [{k: v[:-1] for k, v in state["host"].items()}]
        forb = state["forb"][:-1]
        bonus = state["bonus"][:-1]
    hosts = [match_ops.Hosts(
        mem=h["mem"], cpus=h["cpus"], gpus=h["gpus"],
        cap_mem=h["cap_mem"], cap_cpus=h["cap_cpus"],
        cap_gpus=h["cap_gpus"], valid=h["valid"],
        task_slots=h["task_slots"]) for h in hb]
    ports = [h["ports"] for h in hb]
    death = [h["death_s"] for h in hb]
    if not sharded:
        hosts, ports, death = hosts[0], ports[0], death[0]
    gpu = dru_mode == "gpu"
    res = cycle_ops.rank_and_match(
        r["user"], r["mem"], r["cpus"], r["priority"], r["start_time"],
        r["valid"], r["mem_share"], r["cpus_share"],
        p["user"], p["mem"], p["cpus"], p["gpus"], p["priority"],
        p["start_time"], p["valid"], p["mem_share"], p["cpus_share"],
        p["group"], p["unique_group"],
        hosts, (forb, p["forb_slot"]), qm, qc, qn,
        num_considerable=num_considerable, num_groups=num_groups,
        sequential=sequential, considerable_limit=considerable_limit,
        use_kernel=use_kernel, dru_mode=dru_mode,
        run_gpus=r["gpus"] if gpu else None,
        run_gpu_share=r["gpu_share"] if gpu else None,
        pend_gpu_share=p["gpu_share"] if gpu else None,
        pend_ports=p["ports"], host_ports=ports,
        bonus=(bonus, p["bonus_slot"]) if with_bonus else None,
        pend_est_s=p["est_s"] if with_est else None,
        host_death_s=death if with_est else None,
        now_s=now_s if with_est else None,
        matcher=matcher, match_kw=match_kw)
    Pcap = p["valid"].shape[0]
    H = sum(h["ports"].shape[0] for h in hb)
    # matched rows leave the pending set on the device, immediately
    matched = (res.cons_idx >= 0) & (res.cons_host >= 0)
    state["pend"]["valid"].index_fill_(
        0, torch.where(matched, res.cons_idx, Pcap).long(), False)
    # approximate in-kernel port depletion for matched jobs (exact port
    # numbers stay host-side)
    want = torch.where(
        matched, p["ports"][torch.clamp(res.cons_idx, 0, Pcap - 1).long()],
        0)
    target = torch.where(matched, res.cons_host, H)
    lanes = zip(res.mem_left, res.cpus_left, res.gpus_left,
                res.slots_left) if sharded else \
        [(res.mem_left, res.cpus_left, res.gpus_left, res.slots_left)]
    lo = 0
    for h, (mem, cpus, gpus, slots) in zip(hb, lanes):
        n, d = h["ports"].shape[0], h["ports"].device
        used = torch.zeros(n + 1, dtype=torch.int32, device=d)
        used.index_add_(0, (_local(target, lo, n, d) if sharded
                            else target).long(),
                        want.to(d, non_blocking=True))
        # the match result IS the new host availability
        h["mem"].copy_(mem)
        h["cpus"].copy_(cpus)
        h["gpus"].copy_(gpus)
        h["task_slots"].copy_(slots)
        h["ports"].sub_(used[:n])
        lo += n
    return (res.cons_idx, res.cons_host, res.head_matched, res.n_matched,
            res.n_considerable, res.mat_idx, res.mat_host,
            res.why_idx, res.why_code, res.why_amt)


def state_to_device(state_np, device, shard_devices=None) -> dict:
    """Device state from numpy lanes in the reference's layout (no sink
    slot): every lane / row block gets its sink slot appended. With
    `shard_devices`, the host axis is split into that many contiguous
    blocks, one on each device (the sharded layout above)."""
    dev = resolve_device(device)

    def lane(a, d=dev):
        a = np.asarray(a)
        sink = np.zeros((1,) + a.shape[1:], a.dtype)
        return torch.from_numpy(np.concatenate([a, sink])).to(d)

    state = {
        "pend": {k: lane(v) for k, v in state_np["pend"].items()},
        "run": {k: lane(v) for k, v in state_np["run"].items()},
    }
    if shard_devices is None:
        state["host"] = {k: lane(v) for k, v in state_np["host"].items()}
        state["forb"] = lane(state_np["forb"])
        state["bonus"] = lane(state_np["bonus"])
        return state
    n = len(state_np["host"]["mem"]) // len(shard_devices)
    cols = [(slice(s * n, (s + 1) * n), d)
            for s, d in enumerate(shard_devices)]
    state["host"] = [{k: lane(np.asarray(v)[sl], d)
                      for k, v in state_np["host"].items()}
                     for sl, d in cols]
    for k in ("forb", "bonus"):
        state[k] = [lane(np.asarray(state_np[k])[:, sl], d)
                    for sl, d in cols]
    return state


def state_to_numpy(state) -> dict:
    """The reference's layout (sink slots dropped), as numpy arrays; a
    sharded state's blocks joined along the host axis."""
    def a(t):
        return t[:-1].cpu().numpy()

    out = {
        "pend": {k: a(v) for k, v in state["pend"].items()},
        "run": {k: a(v) for k, v in state["run"].items()},
    }
    host = state["host"]
    if not isinstance(host, list):
        out["host"] = {k: a(v) for k, v in host.items()}
        out["forb"] = a(state["forb"])
        out["bonus"] = a(state["bonus"])
        return out
    out["host"] = {k: np.concatenate([a(h[k]) for h in host])
                   for k in host[0]}
    for k in ("forb", "bonus"):
        out[k] = np.concatenate([a(b) for b in state[k]], axis=1)
    return out


class DeltaPacking:
    """The delta wire format (resident.py:1276-1356): the rows, slots and
    credits a drain marked, packed into the fixed-shape bundle
    `device_cycle` consumes, spill-over beyond one chunk first as
    standalone scatters; and the call into `device_cycle` itself. Shared
    by `ResidentState` and `ResidentPool`, whose mirrors (`_pend_m`,
    `_run_m`, `_forb_rows_m`, `_bonus_rows_m`), caps, lanes and device
    state it reads."""

    def _pack_pend(self, rows):
        D = DELTA_CHUNK
        idx = np.full(D, self.Pcap, np.int32)
        idx[:len(rows)] = rows
        pf = np.zeros((len(PEND_F32), D), np.float32)
        pi = np.zeros((len(PEND_I32), D), np.int32)
        for k, f in enumerate(PEND_F32):
            pf[k, :len(rows)] = self._pend_m[f][rows]
        for k, f in enumerate(PEND_I32):
            pi[k, :len(rows)] = self._pend_m[f][rows]
        return idx, pf, pi

    def _pack_run(self, rows):
        D = DELTA_CHUNK
        idx = np.full(D, self.Rcap, np.int32)
        idx[:len(rows)] = rows
        rf = np.zeros((len(RUN_F32), D), np.float32)
        ri = np.zeros((len(RUN_I32), D), np.int32)
        for k, f in enumerate(RUN_F32):
            rf[k, :len(rows)] = self._run_m[f][rows]
        for k, f in enumerate(RUN_I32):
            ri[k, :len(rows)] = self._run_m[f][rows]
        return idx, rf, ri

    def _pack_forb(self, slots):
        idx = np.full(FORB_CHUNK, self.forb_cap, np.int32)
        idx[:len(slots)] = slots
        rows = np.zeros((FORB_CHUNK, self.Hcap), bool)
        if slots:
            rows[:len(slots)] = self._forb_rows_m[slots]
        return idx, rows

    def _pack_bonus(self, slots):
        # zero-width chunk when data locality is off
        chunk = BONUS_CHUNK if self.with_bonus else 0
        idx = np.full(chunk, self.bonus_cap, np.int32)
        idx[:len(slots)] = slots
        rows = np.zeros((chunk, self.Hcap), np.float32)
        if slots:
            rows[:len(slots)] = self._bonus_rows_m[slots]
        return idx, rows

    def _pack_credit(self, items):
        idx = np.full(CREDIT_CHUNK, self.Hcap, np.int32)
        cf = np.zeros((3, CREDIT_CHUNK), np.float32)
        ci = np.zeros((2, CREDIT_CHUNK), np.int32)
        for i, (hid, c) in enumerate(items):
            idx[i] = hid
            cf[0, i], cf[1, i], cf[2, i] = c[0], c[1], c[2]
            ci[0, i], ci[1, i] = c[3], c[4]
        return idx, cf, ci

    def _dev(self, arrays) -> tuple:
        """Packed numpy arrays as tensors on the pool's device."""
        return tuple(torch.from_numpy(a).to(self.device, non_blocking=True)
                     for a in arrays)

    def pack(self, deltas: dict):
        """numpy packing of this cycle's changes: (spills, bundle).
        `spills` lists (kind, arrays) for the changes beyond one chunk
        per table, to apply with `SCATTERS[kind]` before the cycle;
        `bundle` is the fixed-shape 13-tuple `device_cycle` consumes."""
        pend, run, forb = deltas["pend"], deltas["run"], deltas["forb"]
        bonus = deltas.get("bonus", [])
        credit = list(deltas["credit"].items())
        spills = []
        while len(pend) > DELTA_CHUNK:
            rows, pend = pend[:DELTA_CHUNK], pend[DELTA_CHUNK:]
            spills.append(("pend", self._pack_pend(rows)))
        while len(run) > DELTA_CHUNK:
            rows, run = run[:DELTA_CHUNK], run[DELTA_CHUNK:]
            spills.append(("run", self._pack_run(rows)))
        while len(forb) > FORB_CHUNK:
            slots, forb = forb[:FORB_CHUNK], forb[FORB_CHUNK:]
            spills.append(("forb", self._pack_forb(slots)))
        while len(bonus) > BONUS_CHUNK:   # empty when with_bonus is off
            slots, bonus = bonus[:BONUS_CHUNK], bonus[BONUS_CHUNK:]
            spills.append(("bonus", self._pack_bonus(slots)))
        while len(credit) > CREDIT_CHUNK:
            part, credit = credit[:CREDIT_CHUNK], credit[CREDIT_CHUNK:]
            spills.append(("credit", self._pack_credit(part)))
        bundle = (*self._pack_pend(pend), *self._pack_run(run),
                  *self._pack_credit(credit), *self._pack_forb(forb),
                  *self._pack_bonus(bonus))
        return spills, bundle

    def ship(self, deltas: dict):
        """Apply the spill-over scatters on the device state and return
        the delta bundle as device tensors."""
        spills, bundle = self.pack(deltas)
        for kind, arrays in spills:
            SCATTERS[kind](self.state, *self._dev(arrays))
        return self._dev(bundle)

    def run_cycle(self, bundle, qm, qc, qn, considerable_limit: int,
                  now_s: int, num_considerable: int, num_groups: int = 1,
                  dru_mode: str = "default", use_kernel: bool = True,
                  sequential: bool = True, match_kw=None, matcher=None):
        """One `device_cycle` on the device state (the sequential match,
        or `match_rounds` with `match_kw` when `sequential` is False, or
        `matcher`), with this state's bonus and estimated-completion
        lanes. Returns its output tuple."""
        dev = self.device
        return device_cycle(
            self.state, bundle, to_device(qm, dev), to_device(qc, dev),
            to_device(qn, dev), int(considerable_limit), np.int32(now_s),
            num_considerable=num_considerable, sequential=sequential,
            num_groups=int(num_groups), dru_mode=dru_mode,
            use_kernel=use_kernel, with_bonus=self.with_bonus,
            with_est=self.with_est, matcher=matcher, match_kw=match_kw)


class ResidentState(DeltaPacking):
    """Host mirrors + device state of one resident pool.

    The mirrors are numpy arrays in the reference's layout
    (resident.py:597-616, 635-653); callers edit them and mark what they
    touched (`mark_pend`, `mark_run`, `mark_forb`, `mark_bonus`,
    `credit`). Each cycle, `drain` + `ship` pack the marked rows into
    the fixed-shape delta bundle exactly as the reference's
    `_pack_*`/`_ship` do (spill-over beyond one chunk rides standalone
    scatters first), `run_cycle` runs `device_cycle`, and `readback`
    fetches `n_matched` and then only the matched prefix.
    """

    def __init__(self, Pcap: int, Rcap: int, Hcap: int,
                 forb_cap: int = 4096, bonus_cap: int = 1,
                 with_bonus: bool = False, with_est: bool = False,
                 device="cuda"):
        self.device = resolve_device(device)
        self.Pcap, self.Rcap, self.Hcap = Pcap, Rcap, Hcap
        self.forb_cap = forb_cap
        self.with_bonus = with_bonus
        self.bonus_cap = bonus_cap if with_bonus else 1
        self.with_est = with_est
        self._pend_m = {f: np.zeros(Pcap, _dtype(f)) for f in PEND_FIELDS}
        self._pend_m["forb_slot"][:] = -1
        self._pend_m["bonus_slot"][:] = -1
        self._pend_m["mem_share"][:] = F32_MAX
        self._pend_m["cpus_share"][:] = F32_MAX
        self._pend_m["gpu_share"][:] = F32_MAX
        self._pend_m["group"][:] = -1
        self._run_m = {f: np.zeros(Rcap, _dtype(f)) for f in RUN_FIELDS}
        self._run_m["mem_share"][:] = F32_MAX
        self._run_m["cpus_share"][:] = F32_MAX
        self._run_m["gpu_share"][:] = F32_MAX
        self.host_m = {f: np.zeros(Hcap, _dtype(f)) for f in HOST_FIELDS}
        self.host_m["death_s"][:] = EST_NEVER
        self._forb_rows_m = np.zeros((forb_cap, Hcap), bool)
        self._bonus_rows_m = np.zeros((self.bonus_cap, Hcap), np.float32)
        self.state = None
        self._reset_dirty()

    def _reset_dirty(self):
        self._dirty_pend: set[int] = set()
        self._dirty_run: set[int] = set()
        self._dirty_forb: set[int] = set()
        self._dirty_bonus: set[int] = set()
        self._host_credit: dict[int, list] = {}

    # -- mirrors -----------------------------------------------------------
    def upload(self) -> None:
        """Whole-state upload of the mirrors (build / resync only)."""
        self.state = state_to_device(
            {"pend": self._pend_m, "run": self._run_m, "host": self.host_m,
             "forb": self._forb_rows_m, "bonus": self._bonus_rows_m},
            self.device)
        self._reset_dirty()

    def mark_pend(self, rows) -> None:
        self._dirty_pend.update(int(r) for r in rows)

    def mark_run(self, rows) -> None:
        self._dirty_run.update(int(r) for r in rows)

    def mark_forb(self, slots) -> None:
        self._dirty_forb.update(int(s) for s in slots)

    def mark_bonus(self, slots) -> None:
        self._dirty_bonus.update(int(s) for s in slots)

    def credit(self, host: int, mem=0.0, cpus=0.0, gpus=0.0, slots=0,
               ports=0) -> None:
        """Additive host-capacity credit (task completions)."""
        c = self._host_credit.setdefault(int(host), [0.0, 0.0, 0.0, 0, 0])
        c[0] += mem
        c[1] += cpus
        c[2] += gpus
        c[3] += slots
        c[4] += ports

    def drain(self) -> dict:
        deltas = {"pend": sorted(self._dirty_pend),
                  "run": sorted(self._dirty_run),
                  "forb": sorted(self._dirty_forb),
                  "bonus": sorted(self._dirty_bonus),
                  "credit": self._host_credit}
        self._reset_dirty()
        return deltas

    def readback(self, out):
        """(mat_idx, mat_host) numpy i32 of the matched prefix of a
        `run_cycle` output: one sync for n_matched, then a copy of only
        the prefix (`read_outputs`)."""
        co = _CycleOut(0, *out)
        n = int(read_outputs(co, ("n_matched",))[0])
        return tuple(read_outputs(co, ("mat_idx", "mat_host"), n))


# -- readback of one cycle's outputs -----------------------------------------
def _record_event(device) -> Optional[torch.cuda.Event]:
    """An event behind the work queued so far on `device`'s current
    stream (None on the CPU, where that work has already run)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def start_readback(out, names) -> None:
    """Start the device->host copies of a cycle's outputs `names` now:
    each into a pinned buffer of this cycle's own with a non_blocking
    copy, and an event recorded behind them on the dispatching stream
    (`out.host`, `out.ready`). `read_outputs` waits on that event, on
    whichever thread consumes the cycle. CPU outputs are host memory
    already."""
    first = getattr(out, names[0])
    if first.device.type != "cuda":
        return
    host = {}
    for name in names:
        t = getattr(out, name)
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        host[name] = buf
    out.host, out.ready = host, _record_event(first.device)


def read_outputs(out, names, n: Optional[int] = None) -> list:
    """numpy copies of a cycle's outputs `names` (their first `n`
    elements when given): from the cycle's early copies once their
    event completed, when dispatch started them; otherwise copied now,
    all behind one synchronization of the current stream."""
    if out.host is not None and all(k in out.host for k in names):
        out.ready.synchronize()
        arrs = [out.host[k].numpy() for k in names]
        return arrs if n is None else [a[:n] for a in arrs]
    ts = [getattr(out, k) for k in names]
    if n is not None:
        ts = [t[:n] for t in ts]
    if ts[0].device.type != "cuda":
        return [t.numpy().copy() for t in ts]
    bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in ts]
    for buf, t in zip(bufs, ts):
        buf.copy_(t, non_blocking=True)
    torch.cuda.current_stream(ts[0].device).synchronize()
    return [buf.numpy() for buf in bufs]


# everything a full (re)build produces — the background-rebuild swap
# transplants exactly these from the shadow onto the live pool. Kept
# next to nothing: if _build_from_scratch/_init_and_fill_mirrors grow a
# new piece of state, it must be added here (test_background_rebuild_*
# exercises the swap against the rebuild oracle).
_SWAP_ATTRS = (
    "_share_cache", "_fill_batch", "_run_batch", "_built_sig", "_adjust",
    "with_bonus", "bonus_cap", "with_est", "offer_cluster", "_host_gens",
    "host_names", "host_ids", "_host_index_all", "_host_attr_cache",
    "_host_sigs", "host_attrs", "Hcap", "_t0_ms", "Pcap", "Rcap",
    "forb_cap", "_pend_m", "_run_m", "row_uuid", "pend_row", "_pend_free",
    "run_row", "_run_free", "_forb_rows_m", "_forb_free",
    "_bonus_rows_m", "_bonus_free", "_dataset_jobs", "_group_ids",
    "state", "_dirty_pend", "_dirty_run", "_dirty_forb", "_dirty_bonus",
    "_host_credit", "_last_resv",
)


# ---------------------------------------------------------------------------
@dataclass
class _CycleOut:
    """One dispatched cycle awaiting consumption."""

    cycle_no: int
    cons_idx: torch.Tensor       # device refs (async)
    cons_host: torch.Tensor
    head_matched: torch.Tensor
    n_matched: torch.Tensor
    n_considerable: torch.Tensor
    mat_idx: torch.Tensor        # matched rows compacted to the prefix
    mat_host: torch.Tensor       # (queue order; -1 pad past n_matched)
    why_idx: torch.Tensor = None  # decision provenance (ops/cycle.py
    why_code: torch.Tensor = None  # "why" window): pend row / reason
    why_amt: torch.Tensor = None  # code / datum per queue position
    t_dispatch: float = 0.0
    row_uuid: Optional[list] = None   # not snapshotted; rows are stable
                                      # until consumed_through advances
    # early readback (pipelined / async modes): this cycle's own pinned
    # host copies, filled by non_blocking copies at dispatch, and the
    # CUDA event recorded behind them on the dispatching stream
    host: Optional[dict] = None
    ready: Optional[torch.cuda.Event] = None


class ResidentPool(DeltaPacking):
    """Per-pool device-resident state + host mirrors + delta plumbing.

    Thread model: store events arrive on arbitrary threads and are only
    QUEUED (O(1) under a small lock). All mirror/device mutation happens
    on the coordinator's cycle thread (drain + dispatch); launch
    writeback happens on the consumer thread (or inline when
    synchronous=True, the test/sim mode).
    """

    def __init__(self, coordinator, pool: str,
                 forb_cap: int = 4096,
                 bonus_cap: int = 2048,
                 resync_interval: int = 512,
                 full_resync_every: int = 16,
                 locality_refresh_cycles: int = 16,
                 synchronous: bool = True,
                 pipeline_depth: int = 0,
                 background_rebuild: Optional[bool] = None,
                 device=None, devices=None):
        self.coord = coordinator
        self.pool = pool
        self.forb_cap = forb_cap
        self.resync_interval = resync_interval
        # every resync_interval cycles a LIGHT resync reconciles row
        # membership against store truth (O(P+R) dict diff, no device
        # re-upload, no in-flight drain); every full_resync_every'th
        # periodic resync is a full rebuild, resetting f32 host-lane
        # drift and compacting sparse slots. Bounds the r3 "unmeasured
        # multi-second periodic stall" to a rare, measured event.
        self.full_resync_every = full_resync_every
        self._light_since_full = 0
        self.synchronous = synchronous
        # double-buffered SYNC mode: dispatch cycle N+1 before consuming
        # cycle N, leaving up to pipeline_depth cycles in flight on the
        # cycle thread itself (no consumer thread). 0 = classic inline
        # consume. Async pools ignore this — the depth-2 consume queue
        # already provides the overlap.
        self.pipeline_depth = pipeline_depth
        # per-pool device pinning: each pool's resident state may live
        # on its own chip (the per-pool parallel loops of SURVEY §2.5.1
        # — pools are independent scheduling problems; N pools across N
        # chips scale the leader horizontally). None = default device.
        self.device = resolve_device(
            device if device is not None
            else getattr(coordinator, "device", "cuda"))
        # ONE pool spanning MANY chips (VERDICT r5 #2): `devices` shards
        # the pool's HOST axis over a mesh — host/forb/bonus tensors
        # live in per-shard blocks on their devices, pend/run (and the
        # cycle's outputs) on the first, and the match runs the
        # distributed scan (parallel/sharded_match: shard-local
        # score + pmax/pmin argmax + shard-local depletion, unique
        # host-placement groups included). Opt in for pools whose host
        # count or HBM footprint exceeds one chip.
        self.mesh = None
        if devices is not None and len(devices) > 1:
            if device is not None:
                raise ValueError("pass device= or devices=, not both")
            self.mesh = Mesh(list(devices), (HOST_AXIS,))
            self.device = self.mesh.devices.flat[0]
        # per-cycle launch plugins run against the COMPACT readback at
        # consume time (the reference filters considerables,
        # plugins/launch.clj:59-121 — the readback loop is the same
        # choke point); the adjuster is applied wherever a job's row is
        # (re)filled, so the mirrors always hold adjusted values.
        # Adjusters must be deterministic AND (when they mutate the job
        # in place) idempotent — the reference re-applies them every
        # cycle to the same store-backed jobs, so it assumes the same;
        # a copy-returning adjuster is re-derived from the store job at
        # fill and at consume and never compounds.
        # _adjust / with_bonus / with_est are captured per REBUILD and
        # resync_due watches for live config changes (a plugin or cost
        # store installed after enable must not half-apply).
        self._adjust = None
        self.with_bonus = False
        self.bonus_cap = 1
        self._bonus_cap_cfg = bonus_cap
        self.locality_refresh_cycles = locality_refresh_cycles
        self._dl_gen = -1
        self._dl_fetching = False
        self._dataset_jobs: set[str] = set()
        # launch-filter deferrals: uuid -> monotonic revalidation time.
        # A deferred job's row goes invalid until the expiry so the
        # kernel stops re-matching it every cycle.
        self._deferred: dict[str, float] = {}
        self._ev_lock = witness_lock("ResidentPool._ev_lock")
        # serializes mirror access between the cycle thread (drain) and
        # the consumer thread's launch loop; the device readback — the
        # long pole — happens outside it
        self.mirror_lock = witness_lock("ResidentPool.mirror_lock")
        self._events: list = []
        self.cycle_no = 0
        self.consumed_through = -1
        self._last_resync_cycle = 0
        self._force_resync = False
        self._inflight: deque[_CycleOut] = deque()
        self._cooling: deque = deque()      # (tag_cycle, kind, row)
        self._consumed_res: dict[str, tuple] = {}   # task -> (hostrow, m, c, g, 1, ports)
        self.enabled = True
        self.stats_last = None
        # background double-buffered full rebuild (VERDICT r4 #1): the
        # replacement state builds on a thread against a store snapshot
        # while cycles keep matching on the old mirrors, then swaps
        # atomically at the next cycle boundary. Default: on for async
        # (production) pools, off for synchronous (test/sim) pools —
        # sync callers expect a resync to be visible when the cycle
        # returns. Urgent rebuilds (consumer failures, cap overflow)
        # always run inline regardless.
        self.background_rebuild = ((not synchronous)
                                   if background_rebuild is None
                                   else background_rebuild)
        self._bg: Optional[dict] = None
        self._bg_build_hook = None   # test seam: called with the shadow
        #                              before it is marked ready
        self._build_from_scratch()

    def _feature_sig(self) -> tuple:
        """The match-affecting feature config a rebuild bakes into the
        mirrors/device program; resync_due forces a rebuild when it
        moves (e.g. plugins installed after enable_resident)."""
        co = self.coord
        plugins = co.plugins
        return ("adjuster" in getattr(plugins, "custom", ())
                if plugins is not None else False,
                co.data_locality is not None,
                co.config.estimated_completion.enabled)

    # -- full (re)build ----------------------------------------------------
    def _build_from_scratch(self) -> None:
        co, pool = self.coord, self.pool
        store = co.store
        self._share_cache = {}
        self._fill_batch: dict = {}
        self._run_batch: dict = {}
        self._built_sig = self._feature_sig()
        plugins = co.plugins
        self._adjust = (plugins.adjuster.adjust_job
                        if self._built_sig[0] else None)
        # data-locality: jobs with datasets own a sparse f32 bonus row
        # (w * (1 - cost)) the kernel blends into fitness, the resident
        # form of the DataLocalFitnessCalculator (data_locality.clj:192)
        self.with_bonus = self._built_sig[1]
        if self.with_bonus and self.bonus_cap < self._bonus_cap_cfg:
            self.bonus_cap = self._bonus_cap_cfg
        elif not self.with_bonus:
            self.bonus_cap = 1
        # host universe from current offers (one O(H) pass, only at
        # resync; per-cycle host state lives on device)
        offers = []
        self.offer_cluster: dict[str, str] = {}
        gens = {}
        for cluster in co.clusters.all():
            # generation BEFORE the offers read: a host registering
            # between the two must surface as a gen mismatch next
            # resync_due, not be silently absorbed into _host_gens
            gens[cluster.name] = getattr(cluster, "offer_generation",
                                         lambda p: 0)(pool)
            for o in cluster.pending_offers(pool):
                offers.append(o)
                self.offer_cluster[o.hostname] = cluster.name
        self._host_gens = gens
        self.host_names = [o.hostname for o in offers]
        self.host_ids = {h: i for i, h in enumerate(self.host_names)}
        # name -> index including tombstoned (removed) hosts: indices
        # must stay stable for the life of a build (mask columns and
        # in-flight readbacks address hosts by index), and a rejoining
        # host reuses its old slot
        self._host_index_all = dict(self.host_ids)
        self._host_attr_cache: Optional[dict] = None   # attr -> values
        self._host_sigs = {o.hostname: self._host_sig(o) for o in offers}
        self._host_rebase_cycle: dict[int, int] = {}
        self._build_count = getattr(self, "_build_count", 0) + 1
        self.host_attrs = [o.attributes for o in offers]
        H = max(bucket(len(offers)), 64)
        if self.mesh is not None:
            # the host axis shards evenly over the mesh
            D = self.mesh.devices.size
            H = ((H + D - 1) // D) * D
        self.Hcap = H
        hostd = {
            "mem": np.zeros(H, np.float32),
            "cpus": np.zeros(H, np.float32),
            "gpus": np.zeros(H, np.float32),
            "cap_mem": np.zeros(H, np.float32),
            "cap_cpus": np.zeros(H, np.float32),
            "cap_gpus": np.zeros(H, np.float32),
            "valid": np.zeros(H, bool),
            "task_slots": np.zeros(H, np.int32),
            "ports": np.zeros(H, np.int32),
        }
        for i, o in enumerate(offers):
            hostd["mem"][i] = o.mem
            hostd["cpus"][i] = o.cpus
            hostd["gpus"][i] = o.gpus
            hostd["cap_mem"][i] = o.cap_mem or o.mem
            hostd["cap_cpus"][i] = o.cap_cpus or o.cpus
            hostd["cap_gpus"][i] = o.cap_gpus or o.gpus
            hostd["valid"][i] = True
            hostd["task_slots"][i] = 10_000
            hostd["ports"][i] = sum(hi - lo + 1 for lo, hi in o.ports)
        # estimated-completion lane (constraints.clj:200-247): host
        # death times as relative-epoch i32 seconds; the kernel forbids
        # now_s + est_s >= death_s, so lifetimes decay on device with
        # no per-cycle re-masking. Active only when configured AND some
        # host advertises a start time (reference returns None then).
        self._t0_ms = time.time() * 1000.0
        ec = co.config.estimated_completion
        death = np.full(H, EST_NEVER, np.int32)
        any_start = False
        if ec.enabled:
            for i, o in enumerate(offers):
                d = self._death_s_for(o.attributes)
                if d != EST_NEVER:
                    any_start = True
                    death[i] = d
        hostd["death_s"] = death
        self.with_est = bool(ec.enabled and any_start)

        # atomic pending+running basis (snapshot_view): a launch landing
        # between two separate reads would appear in both lists; the
        # background rebuild makes this window real (builder thread vs
        # live transactions), the sync rebuild benefits too
        with store.snapshot_view(pool) as sv:
            pending = list(sv.pending.values())
            run_insts = list(sv.running)
        if self._adjust is not None:
            # job-adjuster plugin (plugins/adjustment.clj): the mirrors
            # hold ADJUSTED values; a job migrated out of this pool
            # belongs to the destination pool's cycle
            pending = [j for j in (self._adjust(j) for j in pending)
                       if j.pool == pool]
        # 20% slack rows before the next resync-with-growth; the bucket
        # is the jit shape, so slack costs compile-shape stability, not
        # per-cycle work. Rcap additionally floors at a fraction of the
        # pending backlog: a pool enabled before anything runs would
        # otherwise start at 1024 running rows and cascade through
        # growth rebuilds as the first cycles launch (rows are ~40
        # bytes each — slack is cheap, rebuilds are seconds).
        # Pipelined consume adds its own headroom term: a matched
        # pending row is freed (and a completed running row released)
        # only when the lagging consume folds, up to pipeline_depth
        # cycles after dispatch, while refills keep claiming fresh
        # rows — at steady state the transient overshoot is up to
        # depth x considerable on BOTH tables, and without covering it
        # the pool full-resyncs every few cycles (the rebuild cost
        # hiding inside drain_ms).
        head = self.pipeline_depth * \
            self.coord.config.max_jobs_considered
        # caps are monotone non-shrinking for the pool's lifetime:
        # resizing DOWN to the current backlog re-buckets the jit
        # shapes (a multi-second recompile) and sits the pool right
        # back at the edge that overflowed it — a burst-refill then
        # oscillates between two buckets, full-resyncing every few
        # cycles. Rows are ~40 bytes; holding the high-water bucket is
        # noise next to one recompile.
        Pcap = bucket(max(len(pending) + len(pending) // 5 + head,
                          1024, getattr(self, "Pcap", 0)))
        Rcap = bucket(max(len(run_insts) + len(run_insts) // 5 + head,
                          len(pending) // 8, 1024,
                          getattr(self, "Rcap", 0)))
        self.Pcap, self.Rcap = Pcap, Rcap
        while True:
            try:
                self._init_and_fill_mirrors(pending, run_insts, H)
                break
            except _NeedResync as e:
                # sparse-slot demand exceeded a fixed cap during the
                # rebuild itself: grow the cap and refill (bounded by
                # log2 doublings; Pcap/Rcap cannot overflow here — they
                # were just sized from the store)
                msg = str(e)
                if "forbidden" in msg:
                    self.forb_cap *= 2
                elif "bonus" in msg:
                    self.bonus_cap *= 2
                else:
                    raise
                log.info("resident rebuild grew caps (forb=%d bonus=%d)"
                         ": %s", self.forb_cap, self.bonus_cap, msg)
        # device state: upload mirrors wholesale (resync only)
        self.state = state_to_device({
            "pend": {f: self._pend_m[f] for f in PEND_FIELDS},
            "run": {f: self._run_m[f] for f in RUN_FIELDS},
            "host": hostd,
            "forb": self._forb_rows_m,
            "bonus": self._bonus_rows_m,
        }, self.device, None if self.mesh is None
            else list(self.mesh.devices.flat))
        # a background rebuild uploads on its builder thread: the swap
        # waits on these events before the cycle thread uses the state
        devs = ([self.device] if self.mesh is None
                else dict.fromkeys(self.mesh.devices.flat))
        self._upload_events = [e for e in map(_record_event, devs)
                               if e is not None]
        self._dirty_pend: set[int] = set()
        self._dirty_forb: set[int] = set()
        self._dirty_bonus: set[int] = set()
        self._dirty_run: set[int] = set()
        self._host_credit: dict[int, list] = {}
        self._last_resv: dict[str, str] = dict(co.reservations)

    def _init_and_fill_mirrors(self, pending, run_insts, H: int) -> None:
        """Allocate fresh host mirrors at the current caps and fill
        them from the store (the retried section of a rebuild)."""
        Pcap, Rcap = self.Pcap, self.Rcap
        # dirty tracking must exist before the fill loops run (they mark
        # sparse slots dirty); reset again after the wholesale upload
        self._dirty_pend: set[int] = set()
        self._dirty_forb: set[int] = set()
        self._dirty_bonus: set[int] = set()
        self._dirty_run: set[int] = set()
        self._host_credit: dict[int, list] = {}
        self._pend_m = {f: np.zeros(Pcap, _dtype(f)) for f in PEND_FIELDS}
        self._pend_m["forb_slot"][:] = -1
        self._pend_m["bonus_slot"][:] = -1
        self._pend_m["mem_share"][:] = F32_MAX
        self._pend_m["cpus_share"][:] = F32_MAX
        self._pend_m["gpu_share"][:] = F32_MAX
        self._pend_m["group"][:] = -1
        self._run_m = {f: np.zeros(Rcap, _dtype(f)) for f in RUN_FIELDS}
        self._run_m["mem_share"][:] = F32_MAX
        self._run_m["cpus_share"][:] = F32_MAX
        self._run_m["gpu_share"][:] = F32_MAX
        self.row_uuid: list = [None] * Pcap
        self.pend_row: dict[str, int] = {}
        self._pend_free = list(range(Pcap - 1, -1, -1))
        self.run_row: dict[str, int] = {}
        self._run_free = list(range(Rcap - 1, -1, -1))
        self._forb_rows_m = np.zeros((self.forb_cap, H), bool)
        self._forb_free = list(range(self.forb_cap - 1, -1, -1))
        self._bonus_rows_m = np.zeros((self.bonus_cap, H), np.float32)
        self._bonus_free = list(range(self.bonus_cap - 1, -1, -1))
        self._dataset_jobs.clear()
        self._fill_batch = {}
        self._run_batch = {}
        self._group_ids: dict[str, int] = {}
        self._cooling.clear()
        self._inflight.clear()
        self._consumed_res.clear()
        self.consumed_through = self.cycle_no - 1
        # deferred-launch bookkeeping survives a rebuild (the filter's
        # cache is coordinator state); prune expired entries so the
        # fill marks only live deferrals invalid
        now = time.monotonic()
        self._deferred = {u: e for u, e in self._deferred.items()
                          if e > now}
        for job in pending:
            self._alloc_pend(job)
        for inst, job in run_insts:
            self._alloc_run(inst, job)
            hid = self.host_ids.get(inst.hostname, -1)
            self._consumed_res[inst.task_id] = (
                hid, self.coord._effective_mem(job), job.cpus, job.gpus,
                1, job.ports)
        self._flush_fill_batch()
        self._flush_run_batch()

    # -- row management ----------------------------------------------------
    def _alloc_pend(self, job) -> int:
        if not self._pend_free:
            raise _NeedResync("pending capacity exceeded")
        row = self._pend_free.pop()
        self.pend_row[job.uuid] = row
        self.row_uuid[row] = job.uuid
        self._fill_pend(row, job)
        return row

    def _fill_pend(self, row: int, job) -> None:
        """Write (or queue) one pending job's mirror row. Unconstrained
        jobs with no mask/bonus slot to manage take the BATCH path — a
        dict of row -> job flushed vectorized at the end of the drain,
        which is several times cheaper than per-row numpy scalar stores
        at thousands of churned rows per cycle. Constrained jobs (mask
        rows), dataset jobs (bonus rows) and rows holding a stale slot
        go scalar."""
        m = self._pend_m
        if m["forb_slot"][row] < 0 and m["bonus_slot"][row] < 0 \
                and not (self.with_bonus
                         and getattr(job, "datasets", None)) \
                and not self._constrained(job):
            self._fill_batch[row] = job
            return
        self._fill_batch_pop(row)
        self._fill_pend_scalar(row, job)

    def _fill_batch_pop(self, row: int) -> None:
        self._fill_batch.pop(row, None)

    def _fill_pend_scalar(self, row: int, job) -> None:
        co = self.coord
        m = self._pend_m
        m["user"][row] = co.interner.id(job.user)
        m["mem"][row] = co._effective_mem(job)
        m["cpus"][row] = job.cpus
        m["gpus"][row] = job.gpus
        m["priority"][row] = job.priority
        m["start_time"][row] = (job.submit_time_ms // 1000) % (2 ** 30)
        m["valid"][row] = True
        ms, cs, gs = self._share_cached(job.user)
        m["mem_share"][row] = ms
        m["cpus_share"][row] = cs
        m["gpu_share"][row] = gs
        m["ports"][row] = job.ports
        gid = -1
        unique = False
        if job.group is not None:
            g = co.store.groups.get(job.group)
            gid = self._group_ids.setdefault(job.group, len(self._group_ids))
            unique = bool(g is not None
                          and g.host_placement.get("type") == "unique")
        m["group"][row] = gid
        m["unique_group"][row] = unique
        m["est_s"][row] = self._est_s(job)
        # constraint mask row (sparse): only when the job needs one
        mask = self._mask_for(job)
        slot = int(m["forb_slot"][row])
        if mask is None:
            if slot >= 0:
                self._forb_free.append(slot)
                m["forb_slot"][row] = -1
        else:
            if slot < 0:
                if not self._forb_free:
                    raise _NeedResync("forbidden-mask capacity exceeded")
                slot = self._forb_free.pop()
                m["forb_slot"][row] = slot
            self._forb_rows_m[slot, :] = False
            self._forb_rows_m[slot, :len(mask)] = mask
            self._forb_rows_m[slot, len(self.host_names):] = True
            self._dirty_forb.add(slot)
        # data-locality bonus row (sparse): only dataset jobs own one
        bslot = int(m["bonus_slot"][row])
        if self.with_bonus and getattr(job, "datasets", None):
            self._dataset_jobs.add(job.uuid)
            if bslot < 0:
                if not self._bonus_free:
                    raise _NeedResync("bonus capacity exceeded")
                bslot = self._bonus_free.pop()
                m["bonus_slot"][row] = bslot
            dl = self.coord.data_locality
            costs = dl.get_costs(job.uuid)
            brow = self._bonus_rows_m[bslot]
            brow[:] = 0.0   # unknown host = cost 1.0 = zero bonus
            for name, c in costs.items():
                h = self.host_ids.get(name)
                if h is not None:
                    brow[h] = dl.weight * (1.0 - c)
            self._dirty_bonus.add(bslot)
        elif bslot >= 0:
            self._bonus_free.append(bslot)
            m["bonus_slot"][row] = -1
            self._dataset_jobs.discard(job.uuid)
        # a launch-filter deferral keeps the row out of the match until
        # its revalidation time, whatever refilled it meanwhile
        if job.uuid in self._deferred:
            m["valid"][row] = False

    def _flush_fill_batch(self) -> None:
        batch = self._fill_batch
        if not batch:
            return
        self._fill_batch = {}
        co = self.coord
        m = self._pend_m
        rows = np.fromiter(batch.keys(), np.int64, len(batch))
        jobs = list(batch.values())
        iid = co.interner.id
        m["user"][rows] = [iid(j.user) for j in jobs]
        m["mem"][rows] = [co._effective_mem(j) for j in jobs]
        m["cpus"][rows] = [j.cpus for j in jobs]
        m["gpus"][rows] = [j.gpus for j in jobs]
        m["priority"][rows] = [j.priority for j in jobs]
        m["start_time"][rows] = [(j.submit_time_ms // 1000) % (2 ** 30)
                                 for j in jobs]
        m["valid"][rows] = True
        shares = [self._share_cached(j.user) for j in jobs]
        m["mem_share"][rows] = [s[0] for s in shares]
        m["cpus_share"][rows] = [s[1] for s in shares]
        m["gpu_share"][rows] = [s[2] for s in shares]
        m["ports"][rows] = [j.ports for j in jobs]
        gids = self._group_ids
        m["group"][rows] = [
            (gids.setdefault(j.group, len(gids)) if j.group is not None
             else -1) for j in jobs]
        m["unique_group"][rows] = False   # batch path = unconstrained
        # forb_slot/bonus_slot already < 0 for every batch row (path
        # precondition; dataset jobs are routed scalar)
        m["est_s"][rows] = [self._est_s(j) for j in jobs] \
            if self.with_est else 0
        # deferred jobs stay invalid whatever refilled them
        for u in self._deferred:
            r = self.pend_row.get(u)
            if r is not None and r in batch:
                m["valid"][r] = False

    def _adjusted(self, job):
        """Apply the job-adjuster plugin (when customized) so mirror
        rows always hold adjusted values; deterministic by contract."""
        return job if self._adjust is None else self._adjust(job)

    @staticmethod
    def _host_sig(offer) -> tuple:
        """STABLE identity of a host's offer: total capacity +
        attributes. Availability is excluded on purpose — the device
        chains that per cycle; only a capacity/attr change (restart,
        relabel) forces a row re-base. Known limitation: a live host's
        port-RANGE reconfiguration is also availability-shaped (free
        ranges vary with running tasks) and so is not in the signature;
        it lands at the next periodic resync (the LIGHT rung follows
        its membership reconcile with an O(H) reconcile_hosts probe, so
        the window is resync_interval cycles, not the full-rebuild
        period), and until then port launches that lost capacity refuse
        at allocate_ports and retry (degraded, never corrupt)."""
        return (offer.cap_mem or offer.mem, offer.cap_cpus or offer.cpus,
                offer.cap_gpus or offer.gpus,
                tuple(sorted(offer.attributes.items())))

    def _death_s_for(self, attrs) -> int:
        """Relative-epoch death seconds for one host's attributes
        (EST_NEVER = no advertised/parsable start time)."""
        ec = self.coord.config.estimated_completion
        if not ec.enabled:
            return EST_NEVER
        start = attrs.get("host-start-time")
        if start is None:
            return EST_NEVER
        try:
            start_s = float(start)
        except (TypeError, ValueError):
            return EST_NEVER   # malformed attr = unconstrained host
        rel_s = (start_s * 1000.0 + ec.host_lifetime_mins * 60_000.0
                 - self._t0_ms) / 1000.0
        return int(np.clip(rel_s, -EST_NEVER, EST_NEVER))

    def _est_s(self, job) -> int:
        """Capped expected-runtime seconds for the estimated-completion
        lane (the job side of constraints.clj:200-247): max of the
        scaled expected runtime and prior host-lost runtimes, capped at
        host-lifetime minus grace. 0 = unconstrained."""
        if not self.with_est:
            return 0
        ec = self.coord.config.estimated_completion
        scaled = (job.expected_runtime_ms or 0) \
            * ec.expected_runtime_multiplier
        lost = [(inst.end_time_ms - inst.start_time_ms)
                for inst in job.instances
                if inst.reason_code == 5000
                and inst.end_time_ms and inst.start_time_ms]
        expected = max([scaled] + lost)
        if expected <= 0:
            return 0
        cap_ms = (ec.host_lifetime_mins
                  - ec.agent_start_grace_period_mins) * 60_000.0
        return max(1, int(min(expected, cap_ms) / 1000.0))

    def defer_job_locked(self, uuid: str, until: float) -> None:
        """Launch-filter deferral: invalidate the job's row until the
        monotonic revalidation time (drain re-syncs it after). Caller
        holds mirror_lock (the consume loop)."""
        self._deferred[uuid] = until
        row = self.pend_row.get(uuid)
        if row is not None:
            self._fill_batch_pop(row)
            self._pend_m["valid"][row] = False
            self._dirty_pend.add(row)

    def _constrained(self, job) -> bool:
        co = self.coord
        if job.constraints or job.uuid in co.reservations:
            return True
        if any(i.hostname for i in job.instances):   # novel-host
            return True
        if job.group is not None:
            g = co.store.groups.get(job.group)
            if g is not None and (g.host_placement.get("type")
                                  in ("unique", "balanced", "attribute-equals")):
                return True
        return False

    def _mask_for(self, job) -> Optional[np.ndarray]:
        """(H_real,) bool forbidden mask for one job, or None when the
        job is unconstrained (ships no mask bytes). Shares the pool's
        host-index/attr caches: this runs once per constrained-row
        fill, and per-call cache rebuilding is O(H) — at 10k hosts that
        turned a 2k-row mask refresh into seconds (measured)."""
        if not self._constrained(job):
            return None
        co = self.coord
        pins = co._group_attr_pins([job])
        uhosts = co._group_unique_hosts([job], self.host_names,
                                        self.host_attrs)
        if self._host_attr_cache is None:
            self._host_attr_cache = {}
        forb = constraints_mod.build_forbidden(
            [job], self.host_names, self.host_attrs, co.reservations,
            pins, uhosts, host_index=self._host_index_all,
            attr_cache=self._host_attr_cache)
        return np.asarray(forb[0], bool)

    def _free_pend(self, uuid: str) -> None:
        row = self.pend_row.pop(uuid, None)
        self._deferred.pop(uuid, None)
        self._dataset_jobs.discard(uuid)
        if row is None:
            return
        self._fill_batch_pop(row)   # a queued fill must not resurrect it
        m = self._pend_m
        m["valid"][row] = False
        self._dirty_pend.add(row)
        slot = int(m["forb_slot"][row])
        if slot >= 0:
            m["forb_slot"][row] = -1
            self._cooling.append((self.cycle_no, "forb", slot))
        bslot = int(m["bonus_slot"][row])
        if bslot >= 0:
            m["bonus_slot"][row] = -1
            self._bonus_free.append(bslot)
        self.row_uuid[row] = None
        # rows cool until every in-flight cycle that may reference them
        # is consumed (the consumer maps rows -> uuids at readback)
        self._cooling.append((self.cycle_no, "pend", row))

    def _alloc_run(self, inst, job) -> int:
        if not self._run_free:
            raise _NeedResync("running capacity exceeded")
        row = self._run_free.pop()
        self.run_row[inst.task_id] = row
        self._run_batch[row] = (inst, job)
        return row

    def _fill_run_scalar(self, row: int, inst, job) -> None:
        m = self._run_m
        co = self.coord
        m["user"][row] = co.interner.id(job.user)
        m["mem"][row] = job.mem
        m["cpus"][row] = job.cpus
        m["gpus"][row] = job.gpus
        m["priority"][row] = job.priority
        m["start_time"][row] = (inst.start_time_ms // 1000) % (2 ** 30)
        m["valid"][row] = True
        ms, cs, gs = self._share_cached(job.user)
        m["mem_share"][row] = ms
        m["cpus_share"][row] = cs
        m["gpu_share"][row] = gs

    def _flush_run_batch(self) -> None:
        batch = self._run_batch
        if not batch:
            return
        self._run_batch = {}
        co = self.coord
        m = self._run_m
        rows = np.fromiter(batch.keys(), np.int64, len(batch))
        pairs = list(batch.values())
        iid = co.interner.id
        m["user"][rows] = [iid(j.user) for _, j in pairs]
        m["mem"][rows] = [j.mem for _, j in pairs]
        m["cpus"][rows] = [j.cpus for _, j in pairs]
        m["gpus"][rows] = [j.gpus for _, j in pairs]
        m["priority"][rows] = [j.priority for _, j in pairs]
        m["start_time"][rows] = [(i.start_time_ms // 1000) % (2 ** 30)
                                 for i, _ in pairs]
        m["valid"][rows] = True
        shares = [self._share_cached(j.user) for _, j in pairs]
        m["mem_share"][rows] = [s[0] for s in shares]
        m["cpus_share"][rows] = [s[1] for s in shares]
        m["gpu_share"][rows] = [s[2] for s in shares]

    def _share_cached(self, user: str):
        """Per-cycle share lookup cache (share values repeat across the
        thousands of rows a drain touches; invalidated every drain so
        live share updates land within a cycle)."""
        v = self._share_cache.get(user)
        if v is None:
            v = self._share_cache[user] = share_of(
                self.coord.shares, user, self.pool)
        return v

    def _free_run(self, task_id: str) -> None:
        row = self.run_row.pop(task_id, None)
        if row is None:
            return
        self._run_batch.pop(row, None)
        self._run_m["valid"][row] = False
        self._dirty_run.add(row)
        self._cooling.append((self.cycle_no, "run", row))

    # -- event intake ------------------------------------------------------
    def on_event(self, kind: str, data: dict) -> None:
        """Store listener: O(1) enqueue on arbitrary threads."""
        if kind in ("job", "commit", "inst", "insts", "status", "statuses",
                    "retry", "kill", "gc"):
            with self._ev_lock:
                self._events.append((kind, data))

    def mark_job_dirty(self, uuid: str) -> None:
        """Re-evaluate a pending job's row next drain (reservation
        changes, share/quota updates...)."""
        with self._ev_lock:
            self._events.append(("_dirty", {"job": uuid}))

    def queue_credit(self, hid: int, mem: float, cpus: float, gpus: float,
                     slots: int, ports: int,
                     as_of: Optional[int] = None) -> None:
        """Thread-safe capacity credit (the consumer returns resources
        of refused launches through the same event funnel). as_of: the
        cycle whose device state the credit corrects — a credit for a
        host row RE-BASED after that cycle is dropped at drain (the
        re-base already restored the capacity from backend truth)."""
        with self._ev_lock:
            self._events.append(
                ("_credit", {"c": (hid, mem, cpus, gpus, slots, ports),
                             "as_of": as_of}))

    # -- drain: events -> mirrors -> deltas -------------------------------
    def _release_cooling(self) -> None:
        while self._cooling and self._cooling[0][0] <= self.consumed_through:
            _, kind, row = self._cooling.popleft()
            if kind == "pend":
                self._pend_free.append(row)
            elif kind == "run":
                self._run_free.append(row)
            else:
                self._forb_free.append(row)

    def _sync_job(self, job) -> None:
        """Reconcile one job's pend row with its store state."""
        job = self._adjusted(job)
        if job.pool != self.pool:
            self._free_pend(job.uuid)
            return
        is_pending = (job.committed and job.state == JobState.WAITING)
        row = self.pend_row.get(job.uuid)
        if is_pending:
            if row is None:
                row = self._alloc_pend(job)
            else:
                self._fill_pend(row, job)
            self._dirty_pend.add(row)
        elif row is not None:
            self._free_pend(job.uuid)

    def _credit(self, hid: int, mem: float, cpus: float, gpus: float,
                slots: int, ports: int,
                as_of: Optional[int] = None) -> None:
        if hid < 0:
            return
        if as_of is not None and \
                self._host_rebase_cycle.get(hid, -1) > as_of:
            # the row was re-based from backend truth after the cycle
            # this credit corrects: applying it would double-restore
            return
        c = self._host_credit.setdefault(hid, [0.0, 0.0, 0.0, 0, 0])
        c[0] += mem
        c[1] += cpus
        c[2] += gpus
        c[3] += slots
        c[4] += ports

    def _handle_terminal(self, job, inst) -> None:
        self._free_run(inst.task_id)
        res = self._consumed_res.pop(inst.task_id, None)
        if res is not None:
            self._credit(*res)

    def _handle_inst(self, job, inst, ours: bool,
                     match_cycle: Optional[int] = None) -> None:
        if job.pool != self.pool:
            return
        self._sync_job(job)   # frees the pend row (job left WAITING)
        if inst.task_id not in self.run_row and inst.active:
            self._dirty_run.add(self._alloc_run(inst, job))
        if inst.task_id not in self._consumed_res:
            hid = self.host_ids.get(inst.hostname, -1)
            if ours and match_cycle is not None and \
                    self._host_rebase_cycle.get(hid, -1) > match_cycle:
                # the host row was RE-BASED from backend truth after
                # this launch's match cycle: the depletion this record
                # would credit back at terminal lived on the wiped
                # lane — record no host so the credit drops (the
                # re-based row already reflects the launch once the
                # backend saw it; see reconcile_hosts)
                hid = -1
            mem = self.coord._effective_mem(job)
            self._consumed_res[inst.task_id] = (hid, mem, job.cpus,
                                                job.gpus, 1, job.ports)
            if not ours:
                # launched outside this pool's match path: the device
                # never depleted it — debit now
                self._credit(hid, -mem, -job.cpus, -job.gpus, -1,
                             -job.ports)

    def drain(self) -> dict:
        """Apply queued store events to mirrors and collect deltas.
        Returns the delta bundle for this cycle's dispatch. Runs on the
        cycle thread only."""
        with self._ev_lock:
            events, self._events = self._events, []
        self._maybe_refresh_locality()   # network OFF the mirror lock
        self.mirror_lock.acquire()
        try:
            return self._drain_locked(events)
        finally:
            self.mirror_lock.release()

    def _maybe_refresh_locality(self) -> None:
        """Kick a BACKGROUND data-locality cost fetch on the refresh
        cadence (the reference's background cost updater,
        data_locality.clj:66). Never on the cycle thread and never
        under mirror_lock — a slow or hung cost service must not stall
        dispatches or the consumer's launch loop. _drain_locked folds
        the results in whenever dl.generation moves."""
        dl = self.coord.data_locality
        if dl is None or not self._dataset_jobs or self._dl_fetching \
                or self.cycle_no % self.locality_refresh_cycles:
            return
        jobs = [j for u in list(self._dataset_jobs)
                if (j := self.coord.store.get_job(u)) is not None]
        if not jobs:
            return
        self._dl_fetching = True

        def fetch():
            try:
                dl.update(jobs)   # TTL-gated internally; thread-safe
            except Exception:
                log.exception("data-locality refresh failed")
            finally:
                # single-flight gate, not shared state: only this
                # fetch thread clears it, only the consume loop sets
                # it, and a stale read merely skips one TTL-gated
                # refresh attempt
                self._dl_fetching = False  # cookcheck: disable=R2

        threading.Thread(target=fetch, daemon=True,
                         name=f"dl-fetch-{self.pool}").start()

    def _drain_locked(self, events) -> dict:
        self._release_cooling()
        self._share_cache: dict = {}
        # launch-filter deferrals whose revalidation time passed come
        # back into the match (plugins/launch.clj cache expiry; the
        # age-out force-accept lands at the next consume check)
        if self._deferred:
            now = time.monotonic()
            expired = [u for u, e in self._deferred.items() if e <= now]
            for u in expired:
                self._deferred.pop(u, None)
                job = self.coord.store.get_job(u)
                if job is not None:
                    self._sync_job(job)
        # fold freshly-fetched data-locality costs in (the background
        # fetch in _maybe_refresh_locality bumped dl.generation):
        # re-mask dataset jobs' bonus rows — in-memory work only
        dl = self.coord.data_locality
        if dl is not None and dl.generation != self._dl_gen:
            self._dl_gen = dl.generation
            for u in list(self._dataset_jobs):
                job = self.coord.store.get_job(u)
                if job is not None:
                    self._sync_job(job)
        # reservation changes re-mask the affected jobs (the rebalancer
        # writes reservations between cycles, rebalancer.clj:413-426)
        resv = dict(self.coord.reservations)
        if resv != self._last_resv:
            for uuid in set(resv) ^ set(self._last_resv):
                job = self.coord.store.get_job(uuid)
                if job is not None:
                    self._sync_job(job)
            self._last_resv = resv
        group_dirty: set[str] = set()
        for kind, data in events:
            if kind in ("job", "commit", "retry"):
                self._sync_job(data["obj"])
            elif kind == "_dirty":
                job = self.coord.store.get_job(data["job"])
                if job is not None:
                    self._sync_job(job)
            elif kind == "inst":
                self._handle_inst(data["obj"], data["inst"], ours=False)
                if data["obj"].group:
                    group_dirty.add(data["obj"].group)
            elif kind == "insts":
                origin = data.get("origin") or ()
                ours = (len(origin) >= 2 and origin[0] == "resident"
                        and origin[1] == self.pool)
                m_cycle = origin[2] if ours and len(origin) > 2 else None
                for job, inst in data["items"]:
                    self._handle_inst(job, inst, ours=ours,
                                      match_cycle=m_cycle)
                    if job.group:
                        group_dirty.add(job.group)
            elif kind == "_credit":
                self._credit(*data["c"], as_of=data.get("as_of"))
            elif kind in ("status", "statuses"):
                items = (data["items"] if kind == "statuses"
                         else [(data["obj"], data["inst"], data["was"])])
                for job, inst, _was in items:
                    if job.pool != self.pool:
                        continue
                    if inst.active:
                        # RUNNING echo of a launch we already folded in
                        # at the insts event: nothing changes for any
                        # resident row — skip (thousands per cycle)
                        if inst.task_id in self.run_row:
                            continue
                    else:
                        self._handle_terminal(job, inst)
                    self._sync_job(job)   # retries return to WAITING
                    if job.group:
                        group_dirty.add(job.group)
            elif kind == "kill":
                job = data["obj"]
                if job.pool != self.pool:
                    continue
                self._free_pend(job.uuid)
                for tid in data.get("to_kill", ()):
                    inst = self.coord.store.get_instance(tid)
                    if inst is not None:
                        self._handle_terminal(job, inst)
            elif kind == "gc":
                self._free_pend(data["job"])
        # group-placement masks depend on cotask hosts: re-mask pending
        # members of groups whose membership changed this drain
        for gname in group_dirty:
            g = self.coord.store.groups.get(gname)
            if g is None:
                continue
            for ju in g.jobs:
                if ju in self.pend_row:
                    job = self.coord.store.get_job(ju)
                    if job is not None and self._constrained(job):
                        self._fill_pend(self.pend_row[ju], job)
                        self._dirty_pend.add(self.pend_row[ju])
        # vectorized flush of every queued row fill — mirrors must be
        # final before the deltas pack them
        self._flush_fill_batch()
        self._flush_run_batch()
        deltas = {
            "pend": sorted(self._dirty_pend),
            "run": sorted(self._dirty_run),
            "forb": sorted(self._dirty_forb),
            "bonus": sorted(self._dirty_bonus),
            "credit": self._host_credit,
        }
        self._dirty_pend = set()
        self._dirty_run = set()
        self._dirty_forb = set()
        self._dirty_bonus = set()
        self._host_credit = {}
        return deltas

    # -- dispatch ----------------------------------------------------------
    # pack this cycle's changes into the fixed-shape delta bundle the
    # fused cycle consumes; changes beyond one chunk per table spill into
    # standalone scatter dispatches first (rare)
    _ship = DeltaPacking.ship

    def flush(self, deltas: Optional[dict] = None) -> None:
        """Apply all pending deltas via standalone scatters, with no
        match dispatch (tests, shutdown, pre-resync settling)."""
        if deltas is None:
            deltas = self.drain()
        pend, run, forb = deltas["pend"], deltas["run"], deltas["forb"]
        bonus = deltas.get("bonus", [])
        credit = list(deltas["credit"].items())
        st, dev = self.state, self._dev
        for lo in range(0, len(pend), DELTA_CHUNK):
            scatter_pend(st, *dev(self._pack_pend(pend[lo:lo + DELTA_CHUNK])))
        for lo in range(0, len(run), DELTA_CHUNK):
            scatter_run(st, *dev(self._pack_run(run[lo:lo + DELTA_CHUNK])))
        for lo in range(0, len(forb), FORB_CHUNK):
            scatter_forb(st, *dev(self._pack_forb(forb[lo:lo + FORB_CHUNK])))
        for lo in range(0, len(bonus), BONUS_CHUNK):
            scatter_bonus(
                st, *dev(self._pack_bonus(bonus[lo:lo + BONUS_CHUNK])))
        for lo in range(0, len(credit), CREDIT_CHUNK):
            scatter_credit(
                st, *dev(self._pack_credit(credit[lo:lo + CREDIT_CHUNK])))

    def dispatch(self, bundle, qm, qc, qn, considerable_limit: int,
                 num_considerable: int, sequential: bool,
                 dru_mode: str, match_kw=None) -> _CycleOut:
        """Run one `device_cycle` on the resident state, through the
        kernels: a CUDA tensor launches them, a CPU tensor takes their
        plain versions."""
        # exactly 1 when no groups exist (enables the fused kernel scan
        # and a smaller occupancy map); bucketed otherwise
        num_groups = (1 if not self._group_ids
                      else bucket(len(self._group_ids)))
        now_s = np.int32((time.time() * 1000.0 - self._t0_ms) / 1000.0)
        matcher = None
        if self.mesh is not None:
            # the host-sharded distributed scan, one cached matcher per
            # (mesh, num_groups, bonus)
            matcher = resident_matcher(self.mesh, int(num_groups),
                                       self.with_bonus)
        out = self.run_cycle(
            bundle, qm, qc, qn, considerable_limit, now_s, num_considerable,
            num_groups=num_groups, dru_mode=dru_mode, sequential=sequential,
            match_kw=match_kw, matcher=matcher)
        co = _CycleOut(self.cycle_no, *out, t_dispatch=time.perf_counter())
        # ASYNC and PIPELINED modes: start the device->host copy of the
        # scalars and the matched prefix NOW, into this cycle's own
        # pinned buffers, so by the time the consumer (one or two
        # cycles later, on whichever thread) waits on the cycle's event
        # the transfer has already run behind the next dispatch's host
        # work. In pure inline mode the consume follows immediately and
        # copies only the matched prefix (see coordinator._consume_cycle).
        if not self.synchronous or self.pipeline_depth > 0:
            names = ["head_matched", "n_matched", "n_considerable",
                     "mat_idx", "mat_host"]
            if getattr(self.coord.config, "decision_provenance", False):
                # provenance rides the same early copy
                names += ["why_idx", "why_code", "why_amt"]
            start_readback(co, names)
        self._inflight.append(co)
        self.cycle_no += 1
        return co

    def request_resync(self) -> None:
        """Ask for a full rebuild at the next safe point (consumer
        failures, suspected drift)."""
        self._force_resync = True

    def resync_due(self) -> bool:
        return self.resync_reason() is not None

    def resync_reason(self) -> Optional[str]:
        """None, "light" (periodic membership reconcile), "hosts"
        (incremental host-set reconcile), "full" (rebuild, background-
        eligible) or "full-urgent" (rebuild NOW, inline — the state is
        suspect after a consumer failure, so cycling on it while a
        background build runs is not safe). Elapsed-based (not an exact
        modulo) so a cycle being in flight at the boundary only DELAYS
        the resync, never skips it."""
        if self._force_resync:
            return "full-urgent"
        # a plugin / cost store / est-completion config installed (or
        # removed) after the last rebuild must fully apply, not
        # half-apply via the consume path only
        if self._feature_sig() != self._built_sig:
            return "full"
        for cluster in self.coord.clusters.all():
            gen = getattr(cluster, "offer_generation", None)
            if gen is not None and \
                    self._host_gens.get(cluster.name) != gen(self.pool):
                # host adds/removals reconcile INCREMENTALLY
                # (reconcile_hosts); the coordinator falls back to a
                # full rebuild only when that reports impossible
                return "hosts"
        # built before any backend registered hosts (the server enables
        # the resident path at build time): an empty host universe while
        # a cluster has offers means we'd schedule nothing until the
        # interval backstop — rebuild now. Backends that bump
        # offer_generation are caught above; this probe is the backstop
        # for ones that don't, throttled because pending_offers is an
        # O(hosts) construction per cluster.
        if not self.host_names and self.cycle_no % 8 == 0:
            for cluster in self.coord.clusters.all():
                if cluster.pending_offers(self.pool):
                    return "hosts"
        if self.cycle_no - self._last_resync_cycle >= self.resync_interval:
            return ("full" if self._light_since_full + 1
                    >= self.full_resync_every else "light")
        return None

    def reconcile_hosts(self, rebase_all: bool = False) -> bool:
        """Incremental host-set reconcile (agent joins/leaves, kube
        node events): removed hosts tombstone in place (valid=False,
        zero capacity — indices stay stable for mask columns and
        in-flight readbacks), added hosts take fresh or reused slots,
        and constrained/bonus rows refresh their columns. A 2.1-2.7 s
        full rebuild at 100k pending (measured) becomes an O(changes)
        scatter. Returns False when only a full rebuild can cope (host
        slots exhausted, or the est-completion lane must activate).
        No in-flight drain is needed: indices never shift, and a match
        already in flight to a removed host simply fails at the backend
        like any offer that raced a host death.

        rebase_all=True re-bases EVERY live host row from its current
        offer (availability included), not just signature changes — the
        background-rebuild swap uses it to bring the shadow's host
        lanes (read at build start) up to backend truth at swap time.
        All the overcommit-rule funnels (credit purge, rebase stamps,
        consumption-record nulling) apply; the swap rebuilds the
        consumption records from current truth right after."""
        co = self.coord
        gens = {}
        offers = []
        cluster_of = {}
        for cluster in co.clusters.all():
            gens[cluster.name] = getattr(cluster, "offer_generation",
                                         lambda p: 0)(self.pool)
            for o in cluster.pending_offers(self.pool):
                offers.append(o)
                cluster_of[o.hostname] = cluster.name
        offer_by_name = {o.hostname: o for o in offers}
        live = set(self.host_ids)
        added = offer_by_name.keys() - live
        removed = live - offer_by_name.keys()
        # a host whose STABLE signature (total capacity + attributes)
        # changed left and rejoined between cycles (or was relabeled):
        # its row must re-base from the fresh offer — availability
        # (o.mem etc.) is deliberately NOT in the signature, the device
        # chains that itself
        sig_changed = {
            h for h in (live & offer_by_name.keys())
            if self._host_sig(offer_by_name[h]) != self._host_sigs.get(h)}
        changed = (live & offer_by_name.keys()) if rebase_all \
            else sig_changed
        n_fresh = len([h for h in added if h not in self._host_index_all])
        if len(self.host_names) + n_fresh > self.Hcap:
            return False   # out of host slots: full rebuild grows Hcap
        ec = co.config.estimated_completion
        if ec.enabled and not self.with_est and any(
                self._death_s_for(offer_by_name[h].attributes) != EST_NEVER
                for h in (added | changed)):
            # first host with a start time: the est lane must turn on,
            # which is a jit-static flag — rebuild
            return False
        with self.mirror_lock:
            idxs, hfs, his = [], [], []
            rebased: set[int] = set()
            for h in removed:
                i = self.host_ids.pop(h)
                self._host_sigs.pop(h, None)
                idxs.append(i)
                hfs.append((0.0,) * len(HOST_F32))
                his.append((0, 0, EST_NEVER, 0))
            for h in added | changed:
                o = offer_by_name[h]
                i = self._host_index_all.get(h)
                if i is None:
                    i = len(self.host_names)
                    self.host_names.append(h)
                    self.host_attrs.append(dict(o.attributes))
                    self._host_index_all[h] = i
                else:
                    self.host_attrs[i] = dict(o.attributes)   # rejoin
                self.host_ids[h] = i
                self.offer_cluster[h] = cluster_of[h]
                self._host_sigs[h] = self._host_sig(o)
                rebased.add(i)
                idxs.append(i)
                hfs.append((o.mem, o.cpus, o.gpus,
                            o.cap_mem or o.mem, o.cap_cpus or o.cpus,
                            o.cap_gpus or o.gpus))
                his.append((10_000,
                            sum(hi - lo + 1 for lo, hi in o.ports),
                            self._death_s_for(o.attributes), 1))
            if rebased:
                if added or sig_changed:
                    self._host_attr_cache = None   # attr arrays stale
                # a re-based row's capacity comes from backend truth:
                # every OLDER correction targeting it must drop or it
                # double-restores (overcommit). Three funnels: stale
                # consumption records (null their host), credits queued
                # but undrained (purge), and credits still to be queued
                # by consumes of pre-rebase cycles (the rebase-cycle
                # stamp + queue_credit's as_of drops them at drain).
                for tid, rec in self._consumed_res.items():
                    if rec[0] in rebased:
                        self._consumed_res[tid] = (-1,) + rec[1:]
                for i in rebased:
                    self._host_credit.pop(i, None)
                    self._host_rebase_cycle[i] = self.cycle_no
                with self._ev_lock:
                    self._events = [
                        (k, d) for k, d in self._events
                        if not (k == "_credit" and d["c"][0] in rebased)]
            for lo in range(0, len(idxs), HOSTSET_CHUNK):
                sl = slice(lo, lo + HOSTSET_CHUNK)
                n = len(idxs[sl])
                idx = np.full(HOSTSET_CHUNK, self.Hcap, np.int32)
                idx[:n] = idxs[sl]
                hf = np.zeros((len(HOST_F32), HOSTSET_CHUNK), np.float32)
                hi_arr = np.zeros((len(HOST_I32), HOSTSET_CHUNK), np.int32)
                hf[:, :n] = np.asarray(hfs[sl], np.float32).T
                hi_arr[:, :n] = np.asarray(his[sl], np.int32).T
                scatter_hostset(self.state,
                                *self._dev((idx, hf, hi_arr)))
            if added or sig_changed:
                # constrained rows gain/refresh columns for the new or
                # relabeled hosts: recompute their masks against the
                # updated universe (bonus rows via the dataset re-sync).
                # Occupancy test vectorized — at 100k pending only the
                # constrained minority pays Python work. (rebase_all
                # with unchanged signatures skips this: availability
                # re-bases don't move masks.)
                m = self._pend_m
                slotted = np.nonzero(m["forb_slot"] >= 0)[0]
                for row in slotted.tolist():
                    uuid = self.row_uuid[row]
                    job = co.store.get_job(uuid) if uuid else None
                    if job is None:
                        continue
                    self._fill_pend_scalar(row, self._adjusted(job))
                    self._dirty_pend.add(row)
                for u in list(self._dataset_jobs):
                    job = co.store.get_job(u)
                    if job is not None:
                        self._sync_job(job)
        self._host_gens = gens
        return True

    def resync(self) -> None:
        # a background build in flight is now stale: discard it (the
        # builder thread finishes into a dict nothing reads)
        self._bg = None
        with self._ev_lock:
            self._events.clear()
        with self.mirror_lock:
            self._build_from_scratch()
        self._last_resync_cycle = self.cycle_no
        self._light_since_full = 0
        self._force_resync = False

    # -- background double-buffered rebuild (VERDICT r4 #1) ----------------
    def rebuilding(self) -> bool:
        return self._bg is not None and not self._bg["done"].is_set()

    def rebuild_ready(self) -> bool:
        return self._bg is not None and self._bg["done"].is_set()

    def start_background_rebuild(self) -> None:
        """Kick a full state rebuild on a builder thread. Cycles keep
        matching on the current mirrors; the coordinator installs the
        finished shadow at a later cycle boundary (swap_in_shadow). The
        builder reads the store through snapshot_view and shares only
        immutable-ish coordinator state with the live pool (interner
        ids are locked; caps are copied here). This takes the 2-4 s
        full-rebuild stall off the match-cycle path — the reference
        likewise keeps reconciliation off its match loop
        (scheduler.clj:1041-1104)."""
        if self._bg is not None:
            return
        bg = {"done": threading.Event(), "shadow": None, "err": None,
              "build_ms": 0.0}
        self._bg = bg

        def body():
            t0 = time.perf_counter()
            try:
                shadow = ResidentPool(
                    self.coord, self.pool, synchronous=True,
                    background_rebuild=False,
                    forb_cap=self.forb_cap,
                    bonus_cap=self._bonus_cap_cfg,
                    resync_interval=self.resync_interval,
                    full_resync_every=self.full_resync_every,
                    locality_refresh_cycles=self.locality_refresh_cycles,
                    device=self.device if self.mesh is None else None,
                    devices=(list(self.mesh.devices.flat)
                             if self.mesh is not None else None))
                hook = self._bg_build_hook
                if hook is not None:   # test seam: hold the build open
                    hook(shadow)
                bg["shadow"] = shadow
            except Exception as e:   # surfaced at swap -> sync fallback
                bg["err"] = e
            finally:
                bg["build_ms"] = (time.perf_counter() - t0) * 1e3
                bg["done"].set()

        threading.Thread(target=body, daemon=True,
                         name=f"resident-rebuild-{self.pool}").start()

    def swap_in_shadow(self) -> bool:
        """Install the finished background build as the live state.
        Cycle thread only; the caller must have drained in-flight
        cycles and the launch queue first. Returns False when the
        build failed or was discarded (caller falls back to a
        synchronous resync). May raise _NeedResync when row capacity
        was outgrown during the build — the sync fallback re-sizes.

        Sequence, and why each step is safe:
        1. transplant the shadow's mirrors + device state (built from a
           snapshot_view basis at build start);
        2. reconcile_hosts(rebase_all=True): every host lane re-bases
           to CURRENT backend offers — having drained, those offers
           reflect every pre-swap launch — and the overcommit funnels
           (queued-credit purge + rebase stamps) drop every correction
           computed against the old basis or the old host indices;
        3. reconcile_membership(rebase=True): pend/run membership
           catches up to current store truth with no capacity side
           effects, and the consumption records rebuild wholesale;
        4. launch-filter deferrals (coordinator-lifetime state, same
           rule the sync rebuild follows) re-invalidate their rows.
        Events still queued at swap re-apply idempotently at the next
        drain: membership syncs are truth-driven, terminal credits are
        guarded by the fresh consumption records, and stale queued
        credits drop on their as_of stamps."""
        bg, self._bg = self._bg, None
        if bg is None or bg["shadow"] is None:
            if bg is not None and bg["err"] is not None:
                log.warning("background rebuild failed: %s", bg["err"])
            return False
        shadow = bg["shadow"]
        for ev in shadow._upload_events:
            # the shadow's state was uploaded on the builder thread
            ev.synchronize()
        self.last_build_ms = bg["build_ms"]
        assert not self._inflight, "swap with cycles in flight"
        with self.mirror_lock:
            for attr in _SWAP_ATTRS:
                setattr(self, attr, getattr(shadow, attr))
            self._cooling.clear()
            self._consumed_res = shadow._consumed_res
            self.consumed_through = self.cycle_no - 1
            self._host_rebase_cycle = {}
            self._build_count += 1
        if not self.reconcile_hosts(rebase_all=True):
            return False   # est-lane flip / slot overflow: sync rebuild
        self.reconcile_membership(rebase=True)
        with self.mirror_lock:
            now = time.monotonic()
            self._deferred = {u: e for u, e in self._deferred.items()
                              if e > now}
            for u in self._deferred:
                row = self.pend_row.get(u)
                if row is not None:
                    self._fill_batch_pop(row)
                    self._pend_m["valid"][row] = False
                    self._dirty_pend.add(row)
        return True

    def reconcile_membership(self, rebase: bool = False) -> None:
        """LIGHT periodic resync: reconcile pend/run row membership
        against store truth without invalidating row mappings — so
        in-flight cycles keep consuming, nothing re-uploads, and the
        cost is an O(P+R) dict diff (tens of ms at 100k rows, vs
        seconds for the full rebuild). Idempotent against the normal
        event path: anything it fixes that an event later re-reports is
        guarded by the row/consumed_res pops. Host-lane f32 drift is
        NOT corrected here; the rarer full rebuild resets it.

        rebase=True is the background-rebuild swap's catch-up step:
        the host lanes were JUST re-based from current backend offers
        (reconcile_hosts(rebase_all=True)), so membership fixes carry
        NO capacity side effects — the lanes already reflect every
        missed launch/terminal — and the consumption records rebuild
        wholesale from current truth (every currently-running task is
        excluded from the drained offers, so its future terminal
        credit is exact against the fresh lanes).

        The role of the reference's reconciliation pass, kept off the
        per-cycle match path (scheduler.clj:1041-1104)."""
        co, pool = self.coord, self.pool
        store = co.store
        with self.mirror_lock:
            # store truth and the event queue snapshot pair through
            # snapshot_view: the store emits events inside the same
            # critical section that mutates state (the invariant
            # snapshot_view owns and documents), so this pairing can
            # never see a fresh launch as a "missed" event (which
            # would double-deplete a host).
            with store.snapshot_view(pool) as sv:
                if self._adjust is None:
                    # fast path: the live pending index IS the truth
                    # dict — key-view set differences (C level)
                    # instead of rebuilding a P-sized dict
                    pend_missing = sv.pending.keys() - self.pend_row.keys()
                    pend_extra = self.pend_row.keys() - sv.pending.keys()
                    add_jobs = [sv.pending[u] for u in pend_missing]
                else:
                    # keep the RAW job: _sync_job applies the adjuster
                    # internally, and a second application here would
                    # compound a copy-returning non-idempotent adjuster
                    # (the adjusted view is only for the pool filter)
                    store_pend = {}
                    for j in sv.pending.values():
                        if self._adjusted(j).pool == pool:
                            store_pend[j.uuid] = j
                    pend_missing = store_pend.keys() - self.pend_row.keys()
                    pend_extra = self.pend_row.keys() - store_pend.keys()
                    add_jobs = [store_pend[u] for u in pend_missing]
                run_truth = {i.task_id: (i, j) for i, j in sv.running}
                with self._ev_lock:
                    queued = list(self._events)
            # rows mentioned by a queued event are the normal path's
            # business — skip them here
            skip_uuids: set = set()
            skip_tids: set = set()
            for kind, data in queued:
                if kind in ("job", "commit", "retry", "kill"):
                    skip_uuids.add(data["obj"].uuid)
                elif kind == "_dirty":
                    skip_uuids.add(data["job"])
                elif kind == "gc":
                    skip_uuids.add(data["job"])
                elif kind == "inst":
                    skip_uuids.add(data["obj"].uuid)
                    skip_tids.add(data["inst"].task_id)
                elif kind == "insts":
                    for job, inst in data["items"]:
                        skip_uuids.add(job.uuid)
                        skip_tids.add(inst.task_id)
                elif kind == "status":
                    skip_uuids.add(data["obj"].uuid)
                    skip_tids.add(data["inst"].task_id)
                elif kind == "statuses":
                    for job, inst, _was in data["items"]:
                        skip_uuids.add(job.uuid)
                        skip_tids.add(inst.task_id)
            for u in pend_extra:
                if u not in skip_uuids:
                    self._free_pend(u)
            for j in add_jobs:
                if j.uuid not in skip_uuids:
                    self._sync_job(j)
            for tid in list(self.run_row):
                if tid not in run_truth and tid not in skip_tids:
                    self._free_run(tid)
                    res = self._consumed_res.pop(tid, None)
                    if res is not None and not rebase:
                        # missed terminal: credit back
                        self._credit(*res)
            for tid, (inst, job) in run_truth.items():
                if tid in self.run_row or tid in skip_tids:
                    continue
                # missed launch: add the row and debit the capacity the
                # device never depleted (same as _handle_inst
                # ours=False) — no debit in rebase mode (the re-based
                # lanes already exclude it)
                self._dirty_run.add(self._alloc_run(inst, job))
                if not rebase and tid not in self._consumed_res:
                    hid = self.host_ids.get(inst.hostname, -1)
                    mem = co._effective_mem(job)
                    self._consumed_res[tid] = (hid, mem, job.cpus,
                                               job.gpus, 1, job.ports)
                    self._credit(hid, -mem, -job.cpus, -job.gpus, -1,
                                 -job.ports)
            if rebase:
                # wholesale: pre-swap records (and their old-universe
                # host indices) die with the old basis; fresh records
                # use the re-based universe's indices, skip set ignored
                # (truth-driven — later event replays are guarded by
                # the _consumed_res membership checks)
                self._consumed_res = {
                    tid: (self.host_ids.get(inst.hostname, -1),
                          co._effective_mem(job), job.cpus, job.gpus,
                          1, job.ports)
                    for tid, (inst, job) in run_truth.items()}
            self._flush_fill_batch()
            self._flush_run_batch()
        self._last_resync_cycle = self.cycle_no
        if rebase:
            self._light_since_full = 0
            self._force_resync = False
        else:
            self._light_since_full += 1


class _NeedResync(Exception):
    pass
