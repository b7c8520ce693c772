"""Data locality: place jobs near their data.

Equivalent of cook.scheduler.data-locality (data_locality.clj): a cost
store updated in batches from an external cost service
(fetch-data-local-costs :141, update-data-local-costs :66), blended
into match fitness as `(1 - w) * binpack + w * (1 - cost)` — the
DataLocalFitnessCalculator (:192-218, weights config.clj:418-428).

TPU-native shape: instead of a per-(job, host) Java fitness callback,
the coordinator builds a dense (P, H) float32 bonus matrix
`w * (1 - cost)` here and ships it to the match kernel (ops/match.py
`bonus` input), so locality costs ride the same device program as the
bin-packing fitness.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Callable, Optional

import numpy as np

# cost service: (job_uuids_with_datasets) -> {job_uuid: {host: cost}}
# with costs in [0, 1] (data_locality.clj cost schema)
CostFetcher = Callable[[list], dict]


def http_cost_fetcher(endpoint: str, timeout_s: float = 30.0,
                      headers: Optional[dict] = None,
                      datasets_fn: Optional[Callable[[str], list]] = None
                      ) -> CostFetcher:
    """Batched HTTP cost client (fetch-data-local-costs
    data_locality.clj:141-165): POST {batch, tasks: [{task_id,
    datasets}]} to the cost service, expect {"costs": [{"task_id": ...,
    "costs": [{"node": ..., "cost": ..., "suitable": ...}]}]}.
    Unsuitable nodes map to cost 1.0 (farthest). datasets_fn resolves a
    job uuid to its datasets when the service wants them."""
    import uuid as uuid_mod

    from cook_tpu_torch.utils.httpjson import json_request

    def fetch(job_uuids: list) -> dict:
        tasks = []
        for u in job_uuids:
            task = {"task_id": u}
            if datasets_fn is not None:
                task["datasets"] = datasets_fn(u)
            tasks.append(task)
        resp = json_request(
            "POST", endpoint,
            {"batch": str(uuid_mod.uuid4()), "tasks": tasks},
            headers=headers, timeout=timeout_s)
        out: dict = {}
        for entry in resp.get("costs", []):
            tid = entry.get("task_id")
            if tid is None:
                continue
            host_costs = {}
            for c in entry.get("costs", []):
                node = c.get("node")
                if node is None:
                    continue
                cost = float(c.get("cost", 1.0))
                if not c.get("suitable", True):
                    cost = 1.0
                host_costs[node] = cost
            out[tid] = host_costs
        return out

    return fetch


class DataLocalityCosts:
    def __init__(self, fetcher: Optional[CostFetcher] = None,
                 weight: float = 0.25, batch_size: int = 500,
                 cache_ttl_s: float = 300.0):
        assert 0.0 <= weight < 1.0
        self.fetcher = fetcher
        self.weight = weight
        self.batch_size = batch_size
        self.cache_ttl_s = cache_ttl_s
        self._costs: dict[str, dict[str, float]] = {}
        self._fetched_at: dict[str, float] = {}
        self._lock = threading.Lock()
        # bumped whenever a fetched batch lands: cheap change detection
        # for consumers that cache derived forms (the resident path's
        # sparse bonus rows re-fill only when this moves)
        self.generation = 0

    def update(self, jobs) -> int:
        """Batched fetch for jobs with datasets whose costs are missing
        or stale (update-data-local-costs :66).  Returns #jobs fetched."""
        if self.fetcher is None:
            return 0
        now = time.monotonic()
        with self._lock:
            want = [j.uuid for j in jobs if j.datasets
                    and now - self._fetched_at.get(j.uuid, -math.inf)
                    > self.cache_ttl_s]
        fetched = 0
        for i in range(0, len(want), self.batch_size):
            batch = want[i:i + self.batch_size]
            try:
                result = self.fetcher(batch)
            except Exception:
                break  # keep stale data (reference keeps last-good costs)
            with self._lock:
                for uuid, host_costs in result.items():
                    self._costs[uuid] = {
                        h: min(max(float(c), 0.0), 1.0)
                        for h, c in host_costs.items()}
                # stamp the whole attempted batch: a uuid the service has
                # no costs for must still honor cache_ttl_s rather than
                # be re-requested on every cycle
                for uuid in batch:
                    self._fetched_at[uuid] = now
                self.generation += 1
            fetched += len(batch)
        return fetched

    def get_costs(self, job_uuid: str) -> dict[str, float]:
        with self._lock:
            return dict(self._costs.get(job_uuid, {}))

    def bonus_matrix(self, jobs, host_names: list[str],
                     pad_jobs: int, pad_hosts: int) -> Optional[np.ndarray]:
        """(pad_jobs, pad_hosts) f32 bonus `w * (1 - cost)`; hosts with
        no recorded cost get cost=1 (farthest), jobs without datasets get
        a uniform 0 bonus so locality never outranks feasibility for
        them. Returns None when nothing has costs (skip the device
        transfer entirely)."""
        with self._lock:
            if not any(j.uuid in self._costs for j in jobs):
                return None
            bonus = np.zeros((pad_jobs, pad_hosts), np.float32)
            for i, job in enumerate(jobs):
                costs = self._costs.get(job.uuid)
                if not costs:
                    continue
                for h, name in enumerate(host_names):
                    cost = costs.get(name, 1.0)
                    bonus[i, h] = self.weight * (1.0 - cost)
        return bonus
