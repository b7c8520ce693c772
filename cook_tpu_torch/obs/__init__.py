"""cook_tpu.obs — stdlib-only observability subsystem.

A lock-safe tracer with a bounded ring-buffer "flight recorder" of
finished cycle spans, a bounded per-trace span index for /trace
assembly, and W3C-traceparent-style context propagation across the
REST -> store -> coordinator -> backend -> agent boundary; the
always-on cycle profiler (per-phase wall+CPU ledger with critical-path
attribution behind /debug/profile); plus the decision-provenance
`DecisionBook` (per-job reason codes sourced from the device cycle)
and the process-wide metrics `Registry` behind `/metrics`.

Deliberately dependency-free (no cook_tpu imports) so every layer can
import it without cycles.
"""
from cook_tpu_torch.obs.decisions import DecisionBook
from cook_tpu_torch.obs.export import SpanJsonlExporter, to_chrome_trace
from cook_tpu_torch.obs.metrics import Registry
from cook_tpu_torch.obs.metrics import registry as metrics_registry
from cook_tpu_torch.obs.profiler import CycleProfiler, CycleRec, profiler
from cook_tpu_torch.obs.trace import (NOOP_SPAN, Span, Tracer, assemble_tree,
                                make_traceparent, new_span_id,
                                new_trace_id, now_ms, parse_traceparent,
                                tracer)

__all__ = [
    "CycleProfiler", "CycleRec", "DecisionBook", "NOOP_SPAN", "Registry",
    "Span", "SpanJsonlExporter", "Tracer", "assemble_tree",
    "make_traceparent", "metrics_registry", "new_span_id", "new_trace_id",
    "now_ms", "parse_traceparent", "profiler", "to_chrome_trace",
    "tracer",
]
