"""On-node agents: the task executor and the sandbox sidecar.

Equivalents of the reference's on-node layer:
  executor/cook/  (1,495 LoC)  custom executor: process groups, stdout/
                               stderr capture, progress-regex watching,
                               heartbeats, graceful kill
  sidecar/cook/sidecar/ (1,009) per-node file server + progress reporter

Here both live in one package and power backends/local.py — the
ComputeCluster that actually executes commands on the local host — and
daemon.py, the standalone network agent (`python -m cook_tpu.agent`)
that registers with a remote coordinator over HTTP and streams
status/heartbeat/progress (the executor's framework-message role,
executor/cook/executor.py:421).
"""
