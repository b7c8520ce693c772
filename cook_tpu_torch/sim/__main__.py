"""CLI mirroring the reference simulator's options (simulator.md
"How to run": --trace-file/--host-file/--cycle-step-ms/--out-trace-file/
--config-file; zz_simulator.clj:548-560)."""
import argparse
import json
import sys

from cook_tpu_torch.sim import SimConfig, Simulator, load_hosts, load_trace


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m cook_tpu_torch.sim",
        description="faster-than-real-time scheduling simulator")
    p.add_argument("--trace-file", required=True,
                   help="file of jobs to submit (reference trace format)")
    p.add_argument("--host-file", required=True,
                   help="file of hosts available in the cluster")
    p.add_argument("--out-trace-file",
                   help="file to output the run trace of tasks (csv)")
    p.add_argument("--cycle-step-ms", type=int,
                   help="virtual time between cycles (overrides config)")
    p.add_argument("--config-file",
                   help="json config: shares, quotas, cycle-step-ms, "
                        "scheduler-config")
    p.add_argument("--progress-every", type=int, default=0,
                   help="print progress every N cycles")
    p.add_argument("--device", default="cuda",
                   help="where the match and rebalance cycles run: cuda "
                        "(the default; fails without a card) or cpu")
    a = p.parse_args(argv)

    config = SimConfig.from_file(a.config_file) if a.config_file \
        else SimConfig()
    if a.cycle_step_ms:
        config.cycle_step_ms = a.cycle_step_ms
    sim = Simulator(load_trace(a.trace_file), load_hosts(a.host_file),
                    config, device=a.device)
    summary = sim.run(progress_every=a.progress_every)
    if a.out_trace_file:
        n = sim.write_run_trace(a.out_trace_file)
        print(f"wrote {n} task rows -> {a.out_trace_file}", file=sys.stderr)
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
