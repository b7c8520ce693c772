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

Not here yet: the coordinator-bound `ResidentPool` (store listeners,
mirrors of store truth, resync, the consumer thread).
"""
from __future__ import annotations

import numpy as np
import torch

from cook_tpu_torch.device import resolve_device
from cook_tpu_torch.ops import cycle as cycle_ops
from cook_tpu_torch.ops import match as match_ops
from cook_tpu_torch.ops import segments
from cook_tpu_torch.scheduler.tensorize import F32_MAX

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


def scatter_forb(state, slot_idx, rows):
    state["forb"][slot_idx.long()] = rows


def scatter_bonus(state, slot_idx, rows):
    state["bonus"][slot_idx.long()] = rows


def scatter_credit(state, idx, cf, ci):
    _apply_credit(state["host"], idx, cf, ci)


def scatter_hostset(state, idx, hf, hi):
    """Set whole host rows (adds, removals, rejoins); unlike the
    additive credit scatter, this REPLACES the row."""
    _set_rows(state["host"], HOST_F32, HOST_I32, idx, hf, hi)


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
    _apply_credit(state["host"], c_idx, cf, ci)
    scatter_forb(state, f_idx, frows)
    scatter_bonus(state, b_idx, brows)

    # views without the sink slot
    p = {k: v[:-1] for k, v in state["pend"].items()}
    r = {k: v[:-1] for k, v in state["run"].items()}
    h = {k: v[:-1] for k, v in state["host"].items()}
    forb = state["forb"][:-1]
    bonus = state["bonus"][:-1]
    hosts = match_ops.Hosts(
        mem=h["mem"], cpus=h["cpus"], gpus=h["gpus"],
        cap_mem=h["cap_mem"], cap_cpus=h["cap_cpus"],
        cap_gpus=h["cap_gpus"], valid=h["valid"],
        task_slots=h["task_slots"])
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
        pend_ports=p["ports"], host_ports=h["ports"],
        bonus=(bonus, p["bonus_slot"]) if with_bonus else None,
        pend_est_s=p["est_s"] if with_est else None,
        host_death_s=h["death_s"] if with_est else None,
        now_s=now_s if with_est else None,
        matcher=matcher, match_kw=match_kw)
    Pcap = p["valid"].shape[0]
    H = h["ports"].shape[0]
    # matched rows leave the pending set on the device, immediately
    matched = (res.cons_idx >= 0) & (res.cons_host >= 0)
    state["pend"]["valid"].index_fill_(
        0, torch.where(matched, res.cons_idx, Pcap).long(), False)
    # approximate in-kernel port depletion for matched jobs (exact port
    # numbers stay host-side)
    want = torch.where(
        matched, p["ports"][torch.clamp(res.cons_idx, 0, Pcap - 1).long()],
        0)
    used = torch.zeros(H + 1, dtype=torch.int32, device=want.device)
    used.index_add_(0, torch.where(matched, res.cons_host, H).long(), want)
    # the match result IS the new host availability
    h["mem"].copy_(res.mem_left)
    h["cpus"].copy_(res.cpus_left)
    h["gpus"].copy_(res.gpus_left)
    h["task_slots"].copy_(res.slots_left)
    h["ports"].sub_(used[:H])
    return (res.cons_idx, res.cons_host, res.head_matched, res.n_matched,
            res.n_considerable, res.mat_idx, res.mat_host,
            res.why_idx, res.why_code, res.why_amt)


def state_to_device(state_np, device) -> dict:
    """Device state from numpy lanes in the reference's layout (no sink
    slot): every lane / row block gets its sink slot appended."""
    dev = resolve_device(device)

    def lane(a):
        a = np.asarray(a)
        sink = np.zeros((1,) + a.shape[1:], a.dtype)
        return torch.from_numpy(np.concatenate([a, sink])).to(dev)

    return {
        "pend": {k: lane(v) for k, v in state_np["pend"].items()},
        "run": {k: lane(v) for k, v in state_np["run"].items()},
        "host": {k: lane(v) for k, v in state_np["host"].items()},
        "forb": lane(state_np["forb"]),
        "bonus": lane(state_np["bonus"]),
    }


def state_to_numpy(state) -> dict:
    """The reference's layout (sink slots dropped), as numpy arrays."""
    def a(t):
        return t[:-1].cpu().numpy()

    return {
        "pend": {k: a(v) for k, v in state["pend"].items()},
        "run": {k: a(v) for k, v in state["run"].items()},
        "host": {k: a(v) for k, v in state["host"].items()},
        "forb": a(state["forb"]),
        "bonus": a(state["bonus"]),
    }


class ResidentState:
    """Host mirrors + device state of one resident pool.

    The mirrors are numpy arrays in the reference's layout
    (resident.py:597-616, 635-653); callers edit them and mark what they
    touched (`mark_pend`, `mark_run`, `mark_forb`, `mark_bonus`,
    `credit`). Each cycle, `drain` + `ship` pack the marked rows into
    the fixed-shape delta bundle exactly as the reference's
    `_pack_*`/`_ship` do (spill-over beyond one chunk rides standalone
    scatters first), `dispatch` runs `device_cycle`, and `readback`
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
        self.pend_m = {f: np.zeros(Pcap, _dtype(f)) for f in PEND_FIELDS}
        self.pend_m["forb_slot"][:] = -1
        self.pend_m["bonus_slot"][:] = -1
        self.pend_m["mem_share"][:] = F32_MAX
        self.pend_m["cpus_share"][:] = F32_MAX
        self.pend_m["gpu_share"][:] = F32_MAX
        self.pend_m["group"][:] = -1
        self.run_m = {f: np.zeros(Rcap, _dtype(f)) for f in RUN_FIELDS}
        self.run_m["mem_share"][:] = F32_MAX
        self.run_m["cpus_share"][:] = F32_MAX
        self.run_m["gpu_share"][:] = F32_MAX
        self.host_m = {f: np.zeros(Hcap, _dtype(f)) for f in HOST_FIELDS}
        self.host_m["death_s"][:] = EST_NEVER
        self.forb_m = np.zeros((forb_cap, Hcap), bool)
        self.bonus_m = np.zeros((self.bonus_cap, Hcap), np.float32)
        self.state = None
        self._reset_dirty()
        self._pinned = None

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
            {"pend": self.pend_m, "run": self.run_m, "host": self.host_m,
             "forb": self.forb_m, "bonus": self.bonus_m}, self.device)
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

    # -- packing (the reference's wire format) -----------------------------
    def _pack_pend(self, rows):
        D = DELTA_CHUNK
        idx = np.full(D, self.Pcap, np.int32)
        idx[:len(rows)] = rows
        pf = np.zeros((len(PEND_F32), D), np.float32)
        pi = np.zeros((len(PEND_I32), D), np.int32)
        for k, f in enumerate(PEND_F32):
            pf[k, :len(rows)] = self.pend_m[f][rows]
        for k, f in enumerate(PEND_I32):
            pi[k, :len(rows)] = self.pend_m[f][rows]
        return idx, pf, pi

    def _pack_run(self, rows):
        D = DELTA_CHUNK
        idx = np.full(D, self.Rcap, np.int32)
        idx[:len(rows)] = rows
        rf = np.zeros((len(RUN_F32), D), np.float32)
        ri = np.zeros((len(RUN_I32), D), np.int32)
        for k, f in enumerate(RUN_F32):
            rf[k, :len(rows)] = self.run_m[f][rows]
        for k, f in enumerate(RUN_I32):
            ri[k, :len(rows)] = self.run_m[f][rows]
        return idx, rf, ri

    def _pack_forb(self, slots):
        idx = np.full(FORB_CHUNK, self.forb_cap, np.int32)
        idx[:len(slots)] = slots
        rows = np.zeros((FORB_CHUNK, self.Hcap), bool)
        if slots:
            rows[:len(slots)] = self.forb_m[slots]
        return idx, rows

    def _pack_bonus(self, slots):
        # zero-width chunk when data locality is off
        chunk = BONUS_CHUNK if self.with_bonus else 0
        idx = np.full(chunk, self.bonus_cap, np.int32)
        idx[:len(slots)] = slots
        rows = np.zeros((chunk, self.Hcap), np.float32)
        if slots:
            rows[:len(slots)] = self.bonus_m[slots]
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

    def _to_dev(self, arrays):
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
            SCATTERS[kind](self.state, *self._to_dev(arrays))
        return self._to_dev(bundle)

    def dispatch(self, bundle, qm, qc, qn, considerable_limit: int,
                 now_s: int, num_considerable: int, num_groups: int = 1,
                 dru_mode: str = "default", use_kernel: bool = True,
                 matcher=None, sequential: bool = True, match_kw=None):
        """Run one `device_cycle` on the resident state: the sequential
        match, or `match_rounds` with `match_kw` when `sequential` is
        False."""
        return device_cycle(
            self.state, bundle, qm, qc, qn, int(considerable_limit),
            np.int32(now_s), num_considerable=num_considerable,
            sequential=sequential, num_groups=num_groups, dru_mode=dru_mode,
            use_kernel=use_kernel, with_bonus=self.with_bonus,
            with_est=self.with_est, matcher=matcher, match_kw=match_kw)

    def readback(self, out):
        """(mat_idx, mat_host) numpy i32 of the matched prefix: one sync
        for n_matched, then a copy of only the prefix (into pinned host
        buffers on CUDA)."""
        mat_idx, mat_host = out[5], out[6]
        n = int(out[3])
        if self.device.type != "cuda":
            return (mat_idx[:n].numpy().copy(), mat_host[:n].numpy().copy())
        C = mat_idx.shape[0]
        if self._pinned is None or self._pinned.shape[1] < C:
            self._pinned = torch.empty((2, C), dtype=torch.int32,
                                       pin_memory=True)
        self._pinned[0, :n].copy_(mat_idx[:n], non_blocking=True)
        self._pinned[1, :n].copy_(mat_host[:n], non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return (self._pinned[0, :n].numpy().copy(),
                self._pinned[1, :n].numpy().copy())
