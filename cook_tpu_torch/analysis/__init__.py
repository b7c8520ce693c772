"""cookcheck: repo-native static analysis for cook_tpu_torch.

Four rule families tuned to this codebase's two hard failure classes —
silent host syncs inside jitted scheduling kernels, and unlocked
shared-state races in the threaded control plane — plus async hygiene
and REST/OpenAPI drift:

  R1  host syncs      device reads on the host (``.item()``,
                      ``bool(t)``, pageable uploads, ...) inside
                      functions reached from the port's device entry
                      points in ``ops/``, ``parallel/`` and
                      ``scheduler/resident.py``
  R2  lock-discipline unlocked reads/writes of lock-guarded ``self._*``
                      state from thread-entry/callback methods in
                      ``scheduler/`` and ``agent/``
  R3  async-hygiene   blocking calls inside ``async def`` bodies
  R4  rest-drift      route table (``rest/api.py``) vs the OpenAPI
                      generator (``rest/openapi.py``)

Run ``python -m cook_tpu_torch.analysis --help`` for the CLI; see
``docs/static-analysis.md`` for rule details, the per-line suppression
syntax (``# cookcheck: disable=R2``) and the baseline workflow (R1's
are in ``trace_purity.py``'s docstring; the port's baseline is
``cook_tpu_torch/analysis/baseline.json``).

The package is pure-stdlib AST analysis: it never imports torch, jax,
numpy, anything of cook_tpu or any cook_tpu_torch runtime module, so it
runs anywhere Python runs.
"""
from cook_tpu_torch.analysis.core import (ALL_RULES, Finding, analyze_paths,
                                    analyze_source, load_baseline)

__all__ = ["ALL_RULES", "Finding", "analyze_paths", "analyze_source",
           "load_baseline"]
