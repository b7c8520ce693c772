"""R11: whole-program lock-order discipline.

Built on the interprocedural model (:mod:`cook_tpu_torch.analysis.interproc`):
every lock-acquisition edge ``A -> B`` ("some path acquires B while
holding A") feeds a single global lock-order graph, and the rule flags
the shapes that can deadlock:

* **cycle**: a strongly-connected component of the edge graph — two
  paths acquiring the same pair of locks in opposite orders. One
  finding per distinct cycle, anchored at the cycle's first edge's
  witness site, with the full ``A -> B -> ... -> A`` chain and each
  hop's ``file:line [function]`` in the message.
* **re-entry**: a self-edge on a NON-reentrant lock — re-acquiring a
  ``threading.Lock`` the thread already holds, classically through a
  listener/callback invoked under the lock. (A reentrant lock's
  self-edge is legal same-instance re-entry and is not flagged; a
  cross-instance inversion between two instances of the same attribute
  is indistinguishable statically and is the lock-witness's job.)
* **unordered family self-edge**: a second lock of a family node (the
  store's shard-lock list) acquired outside the ascending-index
  helpers — nested shard sections, interprocedural edition of R9.
* **global-then-family inversion**: a path that acquires a class's
  family lock (shard tier) while already holding the same class's
  plain ``._lock`` (global tier). The blessed order, pinned by
  ``_global_section``, is family -> global; this is the
  shard-after-global shape R9 can only see inside one file.

Findings anchor at the witness site of the offending edge, so a
``# cookcheck: disable=R11`` suppression sits next to the code that
creates the edge, with the invariant that makes it safe."""
from __future__ import annotations

from typing import Optional

from cook_tpu_torch.analysis.core import Finding
from cook_tpu_torch.analysis.interproc import Edge, PackageModel


def check(model: PackageModel) -> list[Finding]:
    findings: list[Finding] = []
    findings += _check_self_edges(model)
    findings += _check_global_family_inversion(model)
    findings += _check_cycles(model)
    return findings


def _edge_site(e: Edge) -> str:
    via = f" {e.via}" if e.via else ""
    return f"{e.path}:{e.line} [{e.func}{via}]"


def _check_self_edges(model: PackageModel) -> list[Finding]:
    out = []
    for e in model.edges:
        if e.src != e.dst:
            continue
        lock = model.locks.get(e.src)
        if lock is None:
            continue
        if lock.family:
            if not e.ordered:
                out.append(Finding(
                    "R11", e.path, e.line, e.func,
                    f"second lock of family {e.src} acquired outside "
                    "the ascending-index helpers — nested shard "
                    "sections can deadlock against _pools_section"))
            continue
        if not lock.reentrant:
            out.append(Finding(
                "R11", e.path, e.line, e.func,
                f"non-reentrant {e.src} re-entered on the same thread "
                f"({_edge_site(e)}) — classically a listener/callback "
                "invoked under the lock acquiring it again"))
    return out


def _check_global_family_inversion(model: PackageModel) -> list[Finding]:
    out = []
    for e in model.edges:
        if e.src == e.dst:
            continue
        dst = model.locks.get(e.dst)
        if dst is None or not dst.family:
            continue
        # same-class pairing: "JobStore._lock" -> "JobStore._shard_..."
        src_cls = e.src.split(".")[0]
        dst_cls = e.dst.split(".")[0]
        if src_cls == dst_cls and e.src.endswith("._lock"):
            out.append(Finding(
                "R11", e.path, e.line, e.func,
                f"{e.dst} acquired while holding {e.src} — the pinned "
                "order is shard->global (_global_section); this path "
                "inverts it and deadlocks against any concurrent "
                "global section"))
    return out


def _check_cycles(model: PackageModel) -> list[Finding]:
    # adjacency without self-edges (reported separately above)
    adj: dict[str, set] = {}
    for e in model.edges:
        if e.src != e.dst:
            adj.setdefault(e.src, set()).add(e.dst)
    sccs = _tarjan(adj)
    out = []
    seen_cycles: set = set()
    for comp in sccs:
        if len(comp) < 2:
            continue
        cycle = _shortest_cycle(adj, comp)
        if cycle is None:
            continue
        key = frozenset(cycle)
        if key in seen_cycles:
            continue
        seen_cycles.add(key)
        hops = []
        anchor: Optional[Edge] = None
        for i, src in enumerate(cycle):
            dst = cycle[(i + 1) % len(cycle)]
            e = model.edge(src, dst)
            if e is None:
                continue
            if anchor is None:
                anchor = e
            hops.append(f"{src} -> {dst} at {_edge_site(e)}")
        if anchor is None:
            continue
        chain = " -> ".join(cycle + [cycle[0]])
        out.append(Finding(
            "R11", anchor.path, anchor.line, anchor.func,
            f"lock-order cycle {chain}: " + "; ".join(hops)))
    return out


def _tarjan(adj: dict) -> list:
    """Iterative Tarjan SCC over the adjacency dict."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set = set()
    stack: list[str] = []
    sccs: list[list[str]] = []
    counter = [0]

    nodes = set(adj)
    for vs in adj.values():
        nodes |= vs

    for root in sorted(nodes):
        if root in index:
            continue
        work = [(root, iter(sorted(adj.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(adj.get(w, ())))))
                    advanced = True
                    break
                elif w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                sccs.append(comp)
    return sccs


def _shortest_cycle(adj: dict, comp: list) -> Optional[list]:
    """Shortest cycle through the component's lexicographically first
    node (deterministic anchor for stable fingerprints)."""
    comp_set = set(comp)
    start = min(comp)
    # BFS from start back to start within the component
    prev: dict[str, Optional[str]] = {start: None}
    queue = [start]
    while queue:
        v = queue.pop(0)
        for w in sorted(adj.get(v, ())):
            if w not in comp_set:
                continue
            if w == start:
                path = [v]
                while prev[path[-1]] is not None:
                    path.append(prev[path[-1]])
                path.reverse()
                return path if len(path) > 1 or v != start else [start]
            if w not in prev:
                prev[w] = v
                queue.append(w)
    return None
