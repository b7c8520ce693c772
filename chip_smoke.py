#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cook_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and exits non-zero
   when torch sees no CUDA device.
2. Builds the five CUDA sources of csrc/ (nvcc, first use, one
   process per source, all started together) and prints the build
   seconds and ptxas' register/shared-memory lines.
3. Holds each kernel against its plain PyTorch version on the card:
   - exact_scan (a cluster of 16 CTAs, or 8) at S=1024 jobs x H=16384
     hosts (the sequential path's shape) with a mixed workload; mixed
     problems at S in {8, 256} x H in {1, 33, cluster x 32, 100,000
     (beyond the 65,536 on-chip hosts)}; one host taking all 256 jobs
     (each step must see the last step's depletion, made by one CTA);
     256 unique-group jobs against 30% occupied hosts; all hosts
     identical, all jobs infeasible, H = 16411 (plain mask loads);
     operands beyond [2^-60, 2^60] and a value off the 2^-60 grid (the
     kernel's `__fdiv_rn` route), negative used on the grid.
     job_host must be equal and the (16, H) host stack bit-equal.
   - blocked_cumsum (the port's f32 prefix sum in XLA-CPU's
     association; it replaces no TPU kernel) at (262144, 2), (131072, 2)
     (a cluster of CTAs a column), (8192,) and (16384,) (one CTA), and at
     its routes' edges (cumsum_edges: n = 1 with -0.0, 15, 16, 17, the
     one-CTA limit and one past it, around full chunks, the cluster's
     largest n and one past it, which takes the device-memory route;
     k = 1..3; strided views): bit-equal to its plain version and across
     two runs; both launch counters must move.
   - sum_ordered (the f32 sum in XLA-CPU's association; the dense
     round's window size, the rebalancer's freed resources) at D = 1,024
     and H = 16,384 and the sizes of sum_cases: past 262,144 elements
     on its "cluster" route (one launch of one thread-block cluster) up
     to 8,388,608 (its largest; all -0.0, a NaN, +inf beside -inf at the
     300k pool's T), beyond on its "levels" route (a grid launch a lower
     tree level, then the cluster): bit-equal to its plain version and
     across two runs; all three routes' counters must move. The cluster
     route against the levels route at 300,064 in turns (levels,
     cluster, cluster, levels, twice), torch.sum beside them, and an
     empty kernel's launch (one CTA; one cluster): the launch floor.
   - best_host at D=1024 rows x H=16384 hosts (the batched path's dense
     prefix) on the same mix: no bonus at spread 0.2 and 0, and a
     U(0, 0.5) bonus at spread 0 and 0.2; adversarial: all hosts
     identical (the lowest index wins across every tile), all rows
     infeasible, H = 16411, N = 200; the tiling's edges: N = 1, H = 1,
     N = 33 x H = 515 (ragged tiles, byte mask loads; also with a bonus
     and the jitter together), a tie between hosts of three tiles (the
     lowest wins), a negative bonus that pushes every feasible fit of
     half the rows to <= -1.0 and the best host of the other half below
     another, operands beyond [2^-60, 2^60] in some host tiles and rows
     (negative used, capacities of 3 x 2^61 and 3 x 2^-62, no capacity
     with memory free, demands of 1e-20 and 3 x 2^59: the kernel's
     `__fdiv_rn` path beside its reciprocal path). best_host must be
     equal and best_fit bit-equal.
   - best_host's division (RN(a / b) from a reciprocal taken once per
     host) against IEEE division (`__fdiv_rn`) at the first and last
     2,048 b mantissas x every a mantissa: no pair may differ.
   - ordered_scatter (the port's f32 scatter-add in XLA-CPU's update
     order; it replaces no TPU kernel) at the main path's shapes: 8,192
     bids over 16,384 hosts (k=3, the window rounds' depletion), 32,768
     running tasks over 500 users (k=3, the quota usage, a tenth of them
     one heavy user's) and 2,048 credits with duplicates over 16,384
     hosts (onto a lane), and at its edges (scatter_edges: all updates on
     one target, all keys dropped, int64 keys beyond int32, k = 1..4,
     many long runs, one update, the credits' transposed copy; past one
     CTA the cluster route's edges (cluster_edges: the rebalancer's
     usage at 50,064 and 300,064 tasks, one target taking every update,
     runs straddling CTA boundaries, every key dropped, int64 keys,
     k = 1, 2, 4, n = 32,769, T = 1,023, the route's largest n) and
     shapes beyond it (T = 70,000; the largest n plus one), which take
     the sorted route): bit-equal to its plain version and across two
     runs; the longest run of each is printed; the one-launch, the
     cluster and the sorted route's counters must all move.
   - exact_scan's other routes (the reference's XLA scan with a bonus,
     with G groups, with both): S=1024 x H=16384 with a U(0, 0.3) bonus
     (one group) and with G in {4, 64, 2048} groups (half the jobs
     unique, half the ids among 8 groups, 5% occupied on entry), with and
     without a bonus; the edges: one job, S = 257 and 513 (past the bonus
     route's 256-row job tile), every host on chip and 16 a CTA beyond,
     H = 16411 and a bonus 4 bytes off a 16-byte boundary (plain loads),
     S = 256 x H = 100,000 with 64 groups and a bonus, all jobs unique
     in one group. job_host must be equal, the host stack and the (G, H)
     occupancy bit-equal, and no unique group may share a host. Then
     best_host with G = 2,048 groups at D=1024 x H=16384, with and
     without a bonus and the jitter, ragged N = 33 x H = 515 and
     N = 200 x H = 16411, and an occupancy 1 byte off a 16-byte boundary
     (byte loads): best_host equal, best_fit bit-equal.
   All kernels round every f32 op like their plain versions (no FMA
   contraction, IEEE division).
4. The sequential path: a device-resident pool of 100,000 pending x
   10,000 hosts (Pcap 131072, Hcap 16384), 10,000 running, 500 users,
   C=1024 considered per cycle (the coordinator's sequential matcher),
   2% of pending jobs constrained, the ports and estimated-completion
   lanes on, no bonus. CYCLES cycles through `device_cycle`; the
   exact_scan counter must rise by one per cycle, blocked_cumsum's at
   least once per cycle (the rank) and ordered_scatter's at least once
   per cycle (the quota usage, the credits); no call may take a route
   for shapes beyond the on-chip designs. Checks: jobs matched,
   no host lane below -eps, matched rows invalid afterwards. The first
   REPLAY cycles are replayed from the same seed through the same entry
   point with the kernel wrappers routed to their plain versions;
   mat_idx / mat_host / why_code must agree.
5. The batched path: the same deployment at C=8192 considered per cycle
   (BASELINE's headline cycle, bench.py `bench_cycle`; Pcap 262144,
   Rcap 32768, Hcap 16384), so the coordinator's choice is match_rounds
   with its 256-job exact head. BATCHED cycles with the kernels on; each
   must launch exact_scan once (the head), best_host at least once
   (the dense rounds), blocked_cumsum at least once (the rank, the
   window rounds, the accept sums), ordered_scatter at least once
   (the host depletion, the usage, the credits) and sum_ordered at
   least once (the dense rounds' window size), keep every host lane
   >= -1e-6 and slot count
   >= 0, leave no matched row valid, and show no head-of-line inversion
   at queue positions < head_exact (the host-side audit over the first
   AUDIT_WINDOW positions, whose whole count is printed). The first
   BATCHED_REPLAY cycles are replayed the same way, match_rounds then
   running every kernel's plain version: mat_idx, mat_host and why_code
   must be equal and no kernel counter may move.
5b. The grouped and locality cells: the deployment of 4 and 5 with 10%
   of pending jobs in host-placement-unique groups of 8 (Spark
   executors; num_groups = bucket(groups seen) = 2,048, then 4,096) or
   20% with a data-locality bonus row (U(0, 0.3) on 3 hosts), at C =
   1,024 and 8,192. GROUP_AGREE cycle(s) must equal the same on the
   CPU path (mat_idx, mat_host, why_code); then GROUP_TIMED cycles after
   GROUP_WARMUP, each launching the walk once on its route
   (exact_scan/groups or exact_scan/bonus) and best_host on its route
   once a dense round, no other match route; prints event and host-clock
   p50 / p99, matched and the match launches a cycle, launches and host
   syncs of one profiled cycle, and GROUP_PLAIN cycles of the plain route
   (use_kernel=False: `_scan_assign` and the plain dense expression,
   the route these cells took before the kernels covered groups and a
   bonus), which must launch no match kernel.
6. The rebalancer (ops/rebalance.py) at bench.py `bench_rebalance`'s
   shape (BASELINE config 4: T0 = 50,000 running tasks, P = 64
   preemption decisions, H = 2,000 hosts, U = 500 users, safe DRU 0.5,
   min DRU diff 0.1): exact, with candidate_cap = 8192, both again as a
   gpu-mode pool (gpus in the DRU lane, mem and cpus as two feasibility
   lanes), and a 300,000-task pool with candidate_cap = 8192 (its
   freed-resource sums take sum_ordered's cluster route). Each sweep must
   launch blocked_cumsum, ordered_scatter's cluster route once a step
   (its usage: T > 32,768) and sum_ordered (one CTA, or past 262,144 its
   cluster) twice a step, no route beyond them, place a job, and make no
   host sync before its readback (sync debug mode); the 300k sweep
   is also profiled, timed and its launches a step counted with the
   calls routed as before the cluster routes (ordered_scatter/sorted,
   sum_ordered/levels), in turns with the new routes; the same sweep
   with every wrapper routed
   to its plain version must give equal job_placed / job_host /
   preempted and bit-equal spares, and launch no kernel; the 50k sweeps
   must also equal the same call on the host CPU (the plain versions
   there are what the CPU tests hold equal to the JAX package). Prints
   each sweep's CUDA-event and host-clock ms and host syncs (device busy
   ms and launches of the profiled two); then the usage scatter alone at its shapes (50,064
   and 300,064 x 501 x 2, ordered_scatter's cluster route) against its
   plain version and the sorted route, timed in turns (sorted, cluster,
   cluster, sorted, twice) beside float `index_add_`, with the device
   kernels a call launches (torch.sort's on the sorted route).
7. The production path end to end (cook_tpu_torch/e2e.py, bench.py
   `bench_e2e`'s workload): Coordinator.match_cycle over a store of
   P0 = 100,000 pending jobs, H = 10,000 mock hosts and U = 500 users,
   through the resident pool, the device cycle, the compact readback,
   the bulk launch transaction and the mock backend's launches, with
   completions flowing back as credits; once with 1,024 considered (the
   sequential walk) and once with 8,192 (match_rounds). First the
   readback of cycles in flight: in a small pool (one user, no
   completions) two cycles in flight (pipeline_depth 1) and a consumer
   thread (synchronous=False) must launch what the inline run launches;
   then, per matcher and for both modes, E2E_READBACK_CYCLES cycles at
   the full width with completions flowing back, where every read of a
   cycle's own pinned copies must equal a plain copy of that cycle's
   device outputs and no job may launch twice. Then, per matcher, a
   deterministic run (pinned clocks and uuids, statuses applied inline
   for a fixed order, no durable log) on the card must launch the same
   (job uuid, hostname) pairs, cycle by cycle, and run the same dense
   rounds as the same run on the port's CPU path (its plain versions):
   E2E_AGREE cycles, and batched more, up to E2E_AGREE_MAX, until one
   ran a dense round; best_host must launch once per dense round there.
   The first difference fails. Then E2E_CYCLES cycles in all, the
   first E2E_WARMUP untimed, as bench.py counts them (25 and 5: 20
   timed; 100 timed before the server phases came, 40 before the mesh
   phase, 30 before the cluster routes' checks and timings; cut to make
   room for them; at 10 timed the batched run reached no dense round),
   with bench_e2e's 19 status shards and without its durable log: each
   cycle must launch exact_scan once and, batched, best_host once per
   dense round its match_rounds ran (none sequentially); the segment
   kernels' routes are counted (the running set outgrows the one-launch
   scatter as the backlog drains: the cluster route). Prints per matcher
   the host-clock
   p50 / p99 of match_cycle, matched per cycle, the phase medians
   (drain, ship, dispatch, readback, launch_txn, backend_launch), the
   cyclic collector's pauses in the slowest cycles, and, from one
   profiled cycle, launches and host syncs (by source line).
8. The coordinator's other device paths (e2e.device_paths): the legacy
   match_cycle (match_rounds at 8,192, then the sequential walk) in a
   default pool of 512 hosts and a gpu pool, and rebalance_cycle with
   its DRU head in both, once on the card and once on the CPU path: the
   traces (launches, dense rounds, preemptions, decisions) must be
   equal; exact_scan and best_host must launch and both pools preempt.
9. The scheduler server (rest/server.py `build_scheduler`, as operators
   run it, at bench_e2e's size): one mock cluster of H = 10,000 hosts
   (131,072 MB, 32 cpus), the default pool, max_jobs_considered 1,024,
   the default resident match and pipeline depth (an async consumer),
   a durable log in a temp dir, no overload ladder (as bench_e2e), served
   by an ApiServer on a free port. P = 25,000 jobs of U = 500 users
   (mem U(1,024, 10,240) MB, cpus U(0.5, 4), 2% pinned to one of 50
   racks the smoke labels the hosts with, seeded) are POSTed to
   /jobs/bulk over HTTP from 8 client threads, one user's jobs a request
   (at most 1,000), through the ingest batcher; then the cycle threads
   start as `main`'s on_leadership starts them and run until
   SERVER_CYCLES (20) resident cycles have launched jobs. exact_scan
   must launch once a cycle, each cycle launch 1,024 while the backlog
   lasts, no job launch twice, and
   every launched job read running or success through GET /jobs
   (SERVER_GET_BATCH uuids of one user a request: one GET /jobs/<uuid>
   a job took ~88 s of this phase on a slower host of the chip tool).
   Prints the ingest rate (first POST to last 201) and the host-clock
   p50 / p99 of the cycles and of the profiler's phases (drain, ship,
   dispatch, queue_wait; readback, fold, frame, launch_txn, bookkeep,
   backend_launch). Then the same at max_jobs_considered 8,192 with the
   first SERVER_BATCHED_P (30,000; 100,000 before phase 15 came, cut to
   make room for it, so its ingest rate is over 30,000 jobs and does
   not compare with the earlier 100,000-job figure) of those jobs until
   best_host has launched, best_host once per dense round: the window
   rounds place the unconstrained jobs (the 10,000 hosts fill at
   neither backlog), the constrained ones only the head and the dense
   rounds. Then a deterministic run of the
   C = 1,024 server (clocks and uuids pinned, the backlog through
   CookApi.handle in order, pipeline depth 0, statuses inline, cycles
   driven by hand) on the card and on the CPU path: SERVER_AGREE cycles
   must launch the same (job uuid, hostname) pairs.
10. The operator's path: `python -m cook_tpu_torch.rest.server --port
   <free> --config <tmp>` as a subprocess on the default device (cuda);
   10 jobs POSTed over HTTP must read running or success, and SIGTERM
   must end it. Then the simulator (`cook_tpu_torch.sim.Simulator`,
   rebalancer thresholds at 0) on generate_trace(n_jobs=5,000,
   n_users=20, seed=0) x generate_hosts(200), once on the card and once
   on the CPU path: run_trace_rows() and summary() must be equal.
11. The multi-device paths (cook_tpu_torch/parallel/) on PAR_SHARDS = 4
   shards of the one card (a mesh that lists cuda:0 four times; copies
   between shards are then no-ops, so no cross-device ordering is
   exercised), each through the kernels:
   - the host-sharded scan (parallel.sharded_match) at C = 1,024 jobs x
     H = 10,000 hosts (2,500 a shard): without groups, job_host equal to
     match_scan's (one exact_scan launch) and every lane bit-equal; with
     4 unique groups, 10% forbidden pairs and a U(0, 0.5) bonus, equal
     to match_scan's (one exact_scan/groups launch) and no group
     sharing a host;
   - the pool-sharded cycle (parallel.pools) at bench.py::bench_pools'
     shape, 8 pools x (R = 1,250, P = 12,500, H = 1,250, U = 100, C =
     1,024, match_rounds): every CycleResult field equal on one shard
     and on four, equal to each pool's own rank_and_match and, for pool
     0, to the CPU path; the psum'd totals equal the counts; exact_scan
     once a pool, best_host once a dense round; the federated 2 x 2
     cycle over the same pools equal too, its per-slice split right;
   - a resident pool sharded over the four shards through the
     Coordinator at bench_e2e's workload (P0 = 100,000, H = 10,000, U =
     500, C = 1,024): PAR_RESIDENT_CYCLES deterministic cycles launching
     what the one-device pool launches, cycle by cycle, with no
     exact_scan (the sharded scan replaces it), each shard's host lanes
     and mask rows on its own device;
   - dryrun_multichip(4) on the four shards, and, where more than one
     card is visible, the scan and the pool-sharded cycle over all of
     them held against the above.
   Prints each path's host-clock and CUDA-event ms, and launches and
   host syncs a call or cycle.
12. bench.py's remaining device entry points, through bench_torch.py's
   own functions (each prints its mode's JSON line; every launch counter
   is set to 0 just before each and read just after):
   - contended (bench.py's `contended`: the contended size mix at R =
     10k, P = 100k, H = 10k, U = 500, C = 8,192): the audit-gated head
     ladder's rung (there every considered job fits, so head 0 is
     clean) and the head-256 floor; at that rung and at head 256 the
     kernels' job_host / mat_idx / mat_host / why_code must equal the
     same call with use_kernel=False (the walk and the dense rounds in
     PyTorch) on the same card tensors, bit for bit, exact_scan launch
     once where the head is above 0 and best_host once a dense round;
     then the contended mix at bench.py's `small` shape (R = 1k, P =
     10k, H = 1k, U = 100, C = 2,048; tight hosts), where the ladder
     must climb off head 0 and end at the CPU path's rung with its
     inversions and job_host, and the same route check at that rung;
   - stream (BASELINE config 5): 1,000,000 jobs placed, 32 cycles a
     read, jobs/s and the host syncs a cycle;
   - e2e-smoke (the reference's CI gate): 20k pending x 2k hosts, 4
     pools x 4 store shards, depth 2, native consume, 15 cycles of
     which 5 untimed, the 4 pools' match_cycles from 4 threads: acked_all_durable
     and state_hash_match must be true and exact_scan launch for every
     pool's cycle; then a deterministic run of BENCH_SMOKE_AGREE cycles
     with the pools concurrent must launch each pool's (job uuid, host)
     pairs, cycle by cycle, as the same run with the pools in turn,
     both durable;
   - e2e-batched (sequential_threshold 512: C = 1,024 through
     match_rounds) at bench_e2e's 100k x 10k, BENCH_BATCHED_CYCLES
     cycles (12) of which 4 untimed: exact_scan once a cycle at least.
13. The runtime around the server, each leg on the card through
   exact_scan, each failing the run on any miss or past its deadline:
   - agents: the server (`build_scheduler` in this process on the card,
     one cluster of kind "agent" with a token, max_jobs_considered
     1,024, the default pipeline and status shards, a durable log,
     served by an ApiServer) and 64 agents of 32 cpus and 131,072 MB
     registered one by one in a fixed order: 4 `python -m
     cook_tpu_torch.agent` processes, then 60 in-process AgentDaemons.
     1,536 `true` jobs (1 cpu, 64 MB; 2,000 before phase 15) of 20
     users are POSTed through
     JobClient in bulk and AGENTS_AGREE cycles driven by hand, clocks
     and uuids pinned, each waiting until its tasks ended (the first
     under the profiler: launches, device busy and idle share; the
     second under the sync debug mode: host syncs): the same run on the
     port's CPU path must launch the same {job: hostname} pairs. Then
     64 jobs of `sleep 3` (31 cpus each: one an agent, the subprocess
     agents too), one of `exit 3`, and 3 submitted by a `python -m
     cook_tpu_torch.cli submit --raw` subprocess; the cycle threads
     start as `main` starts them; once every sleeper has launched and
     one runs on a subprocess agent, the subprocess agent running the
     most is SIGKILLed. Every job must end
     as expected: `exit 3` failed with exit code 3 (reason 1003), the
     killed agent's tasks failed mea culpa (5000) and succeeded on
     another agent, every other job a success; exact_scan once a
     placing cycle at least. Prints the hand-driven and threaded cycle
     ms (p50 / p99), jobs/s from the first POST to the last terminal
     state, the seconds from the kill to the lost tasks and to their
     launches elsewhere, launches and syncs a cycle, the idle share.
   - kube: the server with one cluster of kind "kube" whose kube_url is
     the port's ApiServerStandIn over 256 nodes (8 cpus, 32 GB),
     KubeletSim binding, starting and finishing the pods (1 s): 1,000
     jobs (2,000 before phase 15) POSTed through JobClient must all
     succeed, exact_scan launch.
   - failover: two servers on the card (`python -m
     cook_tpu_torch.rest.server --device cuda`, each writing its
     launch counters to its log on SIGTERM) race for a
     Lease on the port's stand-in and share one durable log; one agent
     process (8 cpus) carries both URLs. 24 `sleep 1` jobs go to the
     leader; once 8 run it is SIGKILLed; the standby must take the
     lease, replay the log, rebuild its resident pool and run every job
     to success, launching exact_scan. Prints the milliseconds from the
     kill to the survivor's first launch.
14. The port's cookcheck (cook_tpu_torch/analysis) against the card, and
   bench_torch.py's ingest and fleet modes:
   - R1 against the traced syncs: one resident sequential and one
     batched cycle (the deployment of 4 and 5, after a warm cycle)
     under PyTorch's sync debug mode, beside the e2e phase's traced
     cycles (sequential, batched), the rebalance phase's sweeps (which
     that phase already requires to trace none) and every other cycle
     or call an earlier phase traced (the mesh paths, bench.py's entry
     points, the agents). R1 then runs
     over cook_tpu_torch/ with no baseline and no suppressions: every
     traced `file:line` in ops/, parallel/ or scheduler/resident.py must
     be one of its findings. Prints the static findings, the traced
     sites, the sites missed (0), and the traced sites elsewhere in the
     port and outside it, by file:line.
   - `python -m cook_tpu_torch.analysis --strict` in a subprocess: exit
     0 against the port's baseline, and its wall seconds.
   - ingest: bench_torch.py's ingest leg at ANALYSIS_INGEST jobs (200
     sequential singles, 800 concurrent, 3,000 bulk), the cold replay
     holding every acked uuid.
   - fleet: bench_torch.py's fleet at 2 groups of bench.py's fleet
     member cut to 10 cycles, the first 3 untimed, through its
     FLEET_BENCH_* variables (a single member, then two at
     once, each its own process and CUDA context on the card, the
     kernels built once before): every member on cuda, exact_scan
     launched, the cold replay's state hash and acked jobs durable.
     Prints the aggregate and single-leader decisions/s and the
     speedup; the scale gate is bench_torch.py fleet's, not this
     script's.
15. The leader-failover soak and bench.py's four e2e overhead A/Bs,
   through bench_torch.py's functions (soak_phase; ~60-150 s):
   - failover: tests/test_federation_soak.py's QUICK tier (6 jobs, 2
     agents, a 4 s window, 1 SIGKILL and 1 SIGSTOP of whoever leads,
     seed 31) over an HA pair of `python -m cook_tpu_torch.rest.server
     --device cuda` processes sharing one durable store
     (tests/torch_fedsoak.py through the port's ServerSupervisor): every
     gate of _assert_gates (no lost or doubled job, strictly increasing
     epochs, the stale-epoch fence, the takeover under 20,000 ms), every
     server incarnation on the card, exact_scan launched by a survivor
     (each writes its launches to its log on SIGTERM);
   - the day soak: tests/test_day_soak.py's QUICK tier (6 jobs, 3
     agents, a 3 s window, 1 SIGKILL, seed 101) through
     bench_torch.bench_day_soak, one `python -m
     cook_tpu_torch.rest.server --device cuda` under transport faults
     on the agent RPCs (the chaos controller armed in this process),
     seeded SIGKILLs and agent churn (tests/torch_daysoak.py): every
     gate of _assert_gates (bench_torch.day_soak_gates; the RSS ceiling
     on the server's own memory, its RSS less its libraries' clean
     read-only pages, which is printed beside it), a SIGKILL
     landed, a transport fault injected, a churn schedule, every
     incarnation on the card, exact_scan launched by the final one, the
     controller reset after; then its quiet baseline (6 jobs, 2 agents,
     seed 7, no churn, kill or fault): every gate, no kill, no fault,
     the overload ladder at level 0 (a CUDA warm-up must not read as
     overload), one instance a job, exact_scan launched;
   - decision-, trace-, profile- and chaos-overhead at 20k pending x 2k
     hosts, 12 cycles an arm of which 4 untimed (decision-overhead one
     round): each toggle must take (decisions recorded off 0 and on
     more; flight spans exported as JSON; profiler cycles committed;
     armed chaos draws, the controller disarmed after) and each arm
     launch exact_scan. The overhead percentages are printed and never
     gate (one run cannot resolve a 2% budget here, bench.py:1449-1453).
   Cut for it: phase 9's C = 8,192 backlog (100,000 jobs to 30,000),
   phase 11's timed calls (3 to 2), phase 12's e2e-smoke (40 cycles in
   all to 25) and e2e-batched (35 to 20), phase 13's agent jobs (2,000
   to 1,536) and kube jobs (2,000 to 1,000). Then, after the whole
   smoke outran the 1,200 s limit on a slower host of the chip tool
   (1,212 s there, 996 s on another): phase 12's e2e-smoke (25 to 15)
   and e2e-batched (20 to 12), phase 6's profiled sweeps (5 to the 2
   it also times on the earlier routes), phase 11's sharded resident
   cycles (4 to 2), phase 9's job-state reads (batched by user), and
   the CPU path's runs of phases 5b-10 made beside the card's phases
   (below). Cut for the day soak (~40-55 s): phase 9's backlog at C =
   1,024 and its deterministic run (P = 100,000 jobs to 25,000), and
   phase 6's profiled sweeps (2 to the 300k one, which it also times on
   the earlier routes). Phase 7's full-width readback runs stay at 13
   cycles: at 11 the batched async run read no completion in one call.
16. Prints timings as JSON: per cycle CUDA events from the delta upload
   to the prefix readback, and the host clock around the whole cycle
   (including the workload's own bookkeeping); each kernel alone by CUDA
   events, exact_scan also at its dependency floor (S=1024 with one warp
   of hosts per CTA, H = cluster x 32: `exact_scan_chain_floor_ms`),
   blocked_cumsum beside torch.cumsum, ordered_scatter beside float
   `index_add_` and sum_ordered beside torch.sum; the host time each
   kernel wrapper takes per call (enqueue, no sync); all beside the
   card's name and power limit. Then
   one line {"kernels": [...]} (every kernel and route the paths
   launched, with its launches by path), the nvidia-smi line,
   and last {"ok": true, "device": {...}}.

The runs on the port's CPU path that phases 5b-10 hold the card against
(5b's agreement cycles, 6's 50k sweeps, 7's deterministic runs, 8's coordinator
paths, 9's deterministic server cycles, 10's simulator) are made in one
child process started before the build (`chip_smoke.py --cpu-refs DIR`,
no card visible, 4 threads), while the card runs the phases before
them: the same calls on the same seeded inputs, compared the same way
once each phase needs its run (class CpuRefs; the child ends with the
smoke).

`python3 chip_smoke.py --stack-samples FILE` also writes the main
thread's stack to FILE once a second (sample_stacks).

Imports torch, numpy and cook_tpu_torch only. Any failure exits non-zero
before the last line.
"""
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

CYCLES = 12
REPLAY = 3
BATCHED = 8
BATCHED_REPLAY = 2
AUDIT_WINDOW = 512
S_MAIN, H_MAIN = 1024, 16384
C_BATCHED, D_MAIN = 8192, 1024

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor f32 op/s
HBM_BPS = 3.35e12
F32_OPS = 67e12
# f32/compare operations per (job, host) pair of one exact_scan step: 5
# feasibility compares, 3 eps adds, fitness 2 subs + 2 adds + 3 muls + 1
# add, the argmax compare
OPS_PER_PAIR = 17
# best_host, counted for the function, not for the kernel's blocking:
# per host once, the 3 eps adds and 2 used subtractions; per (row, host)
# pair, feasibility 6 compares and the argmax 2; per FEASIBLE pair also
# the fitness (2 compares, 2 adds, 2 divisions, 1 add, 1 mul), the
# jitter hash (3 integer multiplies, 1 add, 2 shifts, 2 xors, 1 and,
# 1 convert, 1 division, 1 mul, 1 add) when spread > 0, and 1 add with a
# bonus; integer operations counted at the f32 rate. It reads 9 of the
# host stack's 16 rows.
BH_OPS_HOST, BH_OPS_PAIR, BH_OPS_FIT, BH_OPS_JITTER, BH_OPS_BONUS = \
    5, 8, 8, 13, 1
BH_HOST_ROWS = 9
# b mantissas at each end of [1, 2) whose divisions are checked
DIV_B = 2048
# blocked_cumsum's main-path shapes, the first the batched rank's
# (Pcap, 2) (the cluster route); (8192,) and (16384,) one CTA
CUMSUM_SHAPES = ((262144, 2), (131072, 2), (8192,), (16384,))
# the rebalancer: bench.py::bench_rebalance's pool and thresholds; its
# sweeps by (label, running tasks T0, gpu-mode pool, candidate_cap)
REB_P, REB_H, REB_U = 64, 2000, 500
REB_SAFE_DRU, REB_MIN_DRU_DIFF = 0.5, 0.1
# the sweeps also timed and profiled on the routes before the cluster
# routes, in turns with the new routes (the exact sweep too until the
# day soak came: cut to make room for it)
REB_PARENT_VARIANTS = ("t300k_capped8192",)
REB_VARIANTS = (("exact", 50_000, False, None),
                ("capped8192", 50_000, False, 8192),
                ("gpu_exact", 50_000, True, None),
                ("gpu_capped8192", 50_000, True, 8192),
                ("t300k_capped8192", 300_000, False, 8192))
# the sweeps also run on the host CPU up to this pool size
REB_CPU_MAX_T0 = 50_000
# sum_ordered's cluster route (and the levels route before it) timed at
# the 300k pool's T
SUM_LEVELS_N = 300_000 + REB_P
# the end-to-end coordinator (bench_e2e's workload): cycles held against
# the CPU path, timed cycles after warm-up, per matcher (name, consider)
E2E_SHAPE = dict(P0=100_000, H=10_000, U=500)
E2E_AGREE = 4
E2E_AGREE_MAX = 64
# (11 in one round of the day soak's cuts: the async run then read no
# completion in one call; completions flow back from the 11th cycle on)
E2E_READBACK_CYCLES = 13
# cycles in all, the first E2E_WARMUP untimed (bench.py's sense)
E2E_CYCLES = 25
E2E_WARMUP = 5
E2E_MATCHERS = (("sequential", None), ("batched", C_BATCHED))
# the server (rest/server.py build_scheduler at bench_e2e's size): the
# backlog, its users and hosts; requests of at most SERVER_BATCH jobs from
# SERVER_CLIENTS client threads; resident cycles to run (and the seconds
# they may take); batched cycles' seconds to wait for a dense round;
# deterministic cycles held against the CPU path
# (P = 100,000 until the day soak came: cut to make room for it)
SERVER_P, SERVER_H, SERVER_U = 25_000, 10_000, 500
# the C = 8,192 server's backlog: the first of the same jobs
SERVER_BATCHED_P = 30_000
# a share of the jobs carries a rack constraint (as phase 4's pool
# constrains 2%), over racks the smoke labels the mock hosts with
SERVER_CONSTRAINED, SERVER_RACKS = 0.02, 50
SERVER_BATCH, SERVER_CLIENTS = 1_000, 8
# uuids a GET /jobs request reads back
SERVER_GET_BATCH = 200
SERVER_INTERVAL_S = 0.05
# 30 cycles until the analysis phase came (cut to make room for it)
SERVER_CYCLES, SERVER_MAX_S = 20, 240
SERVER_BATCHED_MAX_S = 120
SERVER_AGREE = 4
# the operator's `python -m` boot: jobs posted, seconds allowed to boot
# and to run them; the simulator's trace
SERVER_SMOKE_JOBS, SERVER_BOOT_S = 10, 120
SIM_JOBS, SIM_USERS, SIM_HOSTS = 5000, 20, 200
# the multi-device paths on shards of one card: the shards; the
# host-sharded scan's jobs x hosts (the sequential cell's C and H) and
# its groups; bench.py::bench_pools' pools; sharded resident cycles
# (bench_e2e's workload); timed calls of each
PAR_SHARDS = 4
PAR_SCAN_C, PAR_SCAN_H, PAR_GROUPS = 1024, 10_000, 4
PAR_POOLS = dict(n_pools=8, R=1_250, P=12_500, H=1_250, U=100, C=1_024)
# (4 until the whole smoke outran its limit on a slower host)
PAR_RESIDENT_CYCLES = 2
# 3 before phase 15 came (cut to make room for it)
PAR_TIMED = 2
# the grouped and locality cells: the headline deployment with 10% of
# pending jobs in host-placement-unique groups of 8 (Spark executors;
# G = bucket(~1,250 groups) = 2,048) or 20% with a data-locality bonus
# row, at C = 1,024 and 8,192; cycles held against the CPU path, timed
# after warm-up, and on the plain route; the walk's groups counts
GROUP_CELLS = (("grouped", {"groups": (0.1, 8)}),
               ("locality", {"locality": 0.2}))
GROUP_AGREE, GROUP_WARMUP, GROUP_TIMED, GROUP_PLAIN = 1, 2, 20, 2
GROUP_G = (4, 64, 2048)
# 12. bench.py's remaining entry points through bench_torch.py: contended
# (bench.py:2219-2224) at the headline width, stream (BASELINE config 5,
# 1,000,000 jobs), e2e-smoke (the reference's CI gate: 20k pending x 2k
# hosts, 4 pools x 4 store shards, depth 2, native consume, the
# durability check; BENCH_SMOKE_CYCLES in all, the first
# BENCH_SMOKE_WARMUP untimed: 60 timed before the cluster routes'
# timings, 30 before phase 15, 15 until the whole smoke outran the
# 1,200 s limit on a slower host, cut for the time limit) and
# e2e-batched (sequential_threshold 512 at bench_e2e's 100k x 10k,
# BENCH_BATCHED_CYCLES in all, the first BENCH_BATCHED_WARMUP untimed:
# 560 timed cut to 30, to 15 for phase 15, then to 8). Cycle counts are
# bench.py's: in all, the warm-up included
BENCH_CONTENDED = dict(R=10_000, P=100_000, H=10_000, U=500, C=8_192)
BENCH_CONTENDED_CYCLES = 30
# the contended mix at bench.py's `small` shape, where the hosts are
# tight and the ladder climbs (tests/test_torch_bench_modes.py holds the
# CPU path's ladder there equal to cook_tpu's)
BENCH_CONTENDED_SMALL = dict(R=1_000, P=10_000, H=1_000, U=100, C=2_048)
BENCH_STREAM_JOBS = 1_000_000
BENCH_SMOKE = dict(P0=20_000, H=2_000, U=500)
BENCH_SMOKE_KNOBS = dict(pools=4, store_shards=4, pipeline_depth=2,
                         native=True)
BENCH_SMOKE_CYCLES, BENCH_SMOKE_WARMUP = 15, 5
# concurrent pools against pools in turn: through the first completions
# (jobs run 10 s of the mock's clock, one a cycle)
BENCH_SMOKE_AGREE = 13
BENCH_BATCHED = dict(P0=100_000, H=10_000, U=500)
BENCH_BATCHED_CYCLES, BENCH_BATCHED_WARMUP = 12, 4
# phase 13: the fleet of agents (subprocesses, in-process daemons), each
# AGENT_CPUS x AGENT_MEM; the backlog of `true` jobs from AGENTS_USERS,
# the sleepers (one subprocess agent is killed under them), the jobs the
# cs CLI submits; the hand-driven cycles held against the CPU path; the
# agents' lease (heartbeat timeout) and heartbeat; each leg's deadline
AGENT_TOKEN = "chip-smoke"
AGENTS_SUB, AGENTS_INPROC = 4, 60
AGENT_CPUS, AGENT_MEM = 32.0, 131_072.0
AGENTS_C = 1_024
# (2,000 jobs before phase 15 came: cut to make room for it; the second
# hand-driven cycle still launches 512)
AGENTS_JOBS, AGENTS_USERS = 1_536, 20
AGENTS_SLEEPERS, AGENTS_SLEEP_S = 64, 3
AGENTS_CLI_JOBS = 3
AGENTS_AGREE = 2
AGENTS_LEASE_S, AGENTS_HEARTBEAT_S = 5.0, 0.5
AGENTS_MAX_S = 240
# the kube leg: the stand-in's nodes (8 cpus, 32 GB each: 2,048 1-cpu
# slots), its jobs, KubeletSim's pod runtime
# (2,000 jobs before phase 15 came; cut to make room for it)
KUBE_NODES, KUBE_JOBS, KUBE_RUNTIME_S, KUBE_MAX_S = 256, 1_000, 1.0, 180
# the failover leg: the jobs (sleep 1, 1 cpu) on one agent of 8 cpus
FAILOVER_JOBS, FAILOVER_AGENT_CPUS, FAILOVER_MAX_S = 24, 8.0, 240
# phase 14: the ingest leg's jobs (bench.py's 2,000 / 8,000 / 30,000
# cut) and the fleet's groups and member cycles (bench.py's 4 groups,
# 40 cycles of which 8 untimed, cut), set as FLEET_BENCH_* variables
ANALYSIS_INGEST = dict(n_single=200, n_conc=800, n_bulk=3_000)
ANALYSIS_FLEET_GROUPS = 2
ANALYSIS_FLEET_ENV = {"FLEET_BENCH_CYCLES": "10", "FLEET_BENCH_WARMUP": "3"}
# phase 15: the failover soak at tests/test_federation_soak.py's QUICK
# tier (seed 31, servers on the card), and bench.py's four e2e overhead
# A/Bs at its 20k pending x 2k hosts, each arm SOAK_AB_CYCLES cycles in
# all, the first SOAK_AB_WARMUP untimed (bench.py's arms: 120 and 20)
SOAK_FAILOVER = dict(jobs=6, agents=2, window_s=4.0, wall_s=90.0, kills=1,
                     partitions=1)
SOAK_SEED = 31
SOAK_AB_CYCLES, SOAK_AB_WARMUP = 12, 4
# phase 15's day soak: tests/test_day_soak.py:27's QUICK tier at seed 101
# and its quiet baseline (:77-103, seed 7), the server on the card
DAY_QUICK = dict(jobs=6, agents=3, window_s=3.0, wall_s=75.0, max_kills=1)
DAY_QUICK_SEED = 101
DAY_QUIET = dict(jobs=6, agents=2, window_s=2.0, wall_s=60.0, max_kills=0,
                 churn=False, transport=False)
DAY_QUIET_SEED = 7
# the port's files R1 covers when it scans the package
R1_SCOPE = ("cook_tpu_torch/ops/", "cook_tpu_torch/parallel/",
            "cook_tpu_torch/scheduler/resident.py")


T_START = time.perf_counter()


def mark(phase):
    """One line with the seconds since the start, at a phase's end."""
    print(json.dumps({"phase_done": phase,
                      "elapsed_s": time.perf_counter() - T_START}),
          flush=True)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Device ms per call of `fn`, by CUDA events over `reps` calls. A
    ~20 ms device sleep is queued first, so the host has enqueued the
    calls before the first event runs and the events see device time,
    not the wrappers' host time (which host_us reports)."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(35_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def host_us(fn, reps=200):
    """Host microseconds per call of `fn` (the enqueue: allocation,
    argument checks, the launch; no sync inside the timed loop)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / reps * 1e6


def scan_problem(rng, S, H, device):
    """Mixed exact_scan / best_host inputs: 2% forbidden density, ~5% gpu
    hosts, some gpu jobs, slot-exhausted and invalid hosts, unique-group
    jobs."""
    import torch
    from cook_tpu_torch.ops import fused_match as fm

    cap_mem = rng.uniform(64, 256, H).astype(np.float32)
    cap_cpus = rng.uniform(16, 64, H).astype(np.float32)
    gpu = rng.random(H) < 0.05
    cap_gpus = np.where(gpu, 8.0, 0.0).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    hp = fm.pack_hosts(
        t(cap_mem * rng.uniform(0.05, 1, H).astype(np.float32)),
        t(cap_cpus * rng.uniform(0.05, 1, H).astype(np.float32)),
        t((cap_gpus * rng.uniform(0, 1, H)).round().astype(np.float32)),
        t(cap_mem), t(cap_cpus), t(cap_gpus),
        t(np.where(rng.random(H) < 0.03, 0, rng.integers(1, 6, H))
          .astype(np.int32)),
        t(rng.random(H) > 0.01), t(rng.random(H) < 0.03))
    jp = fm.pack_jobs(
        t(rng.uniform(1, 48, S).astype(np.float32)),
        t(rng.uniform(0.5, 12, S).astype(np.float32)),
        t(np.where(rng.random(S) < 0.05, rng.integers(1, 3, S), 0)
          .astype(np.float32)),
        t(rng.random(S) > 0.02), t(rng.random(S) < 0.1))
    forb = t((rng.random((S, H)) < 0.02).astype(np.uint8))
    return jp, hp, forb


def check_kernel(jp, hp, forb, label):
    """exact_scan vs plain on the same inputs; returns (max |host lane
    diff|, jobs assigned)."""
    import torch
    from cook_tpu_torch.ops import fused_match as fm

    jh_k, hout_k = fm.exact_scan(jp, hp, forb)
    jh_p, hout_p = fm.exact_scan_plain(jp, hp, forb)
    torch.cuda.synchronize()
    if not torch.equal(jh_k, jh_p):
        bad = int((jh_k != jh_p).sum())
        fail(f"exact_scan {label}: job_host differs from plain at {bad} "
             f"jobs")
    if not torch.equal(hout_k, hout_p):
        fail(f"exact_scan {label}: host stack not bit-equal to plain "
             f"(max abs diff {float((hout_k - hout_p).abs().max())})")
    return float((hout_k - hout_p).abs().max()), int((jh_k >= 0).sum())


def check_best_host(jp, hp, forb, bonus, spread, label, occ=None):
    """best_host vs plain on the same inputs; returns (max |fit diff|,
    rows assigned, best_host)."""
    import torch
    from cook_tpu_torch.ops import fused_match as fm

    fit_k, idx_k = fm.best_host(jp, hp, forb, bonus, spread, occ=occ)
    fit_p, idx_p = fm.best_host_plain(jp, hp, forb, bonus, spread, occ=occ)
    torch.cuda.synchronize()
    if not torch.equal(idx_k, idx_p):
        bad = int((idx_k != idx_p).sum())
        fail(f"best_host {label}: best_host differs from plain at {bad} "
             f"rows")
    if not torch.equal(fit_k, fit_p):
        fail(f"best_host {label}: best_fit not bit-equal to plain (max "
             f"abs diff {float((fit_k - fit_p).abs().max())})")
    return float((fit_k - fit_p).abs().max()), int((idx_k >= 0).sum()), \
        idx_k


def identical_hosts(S, H, device):
    """(jp, hp, forb): S unit jobs, H identical hosts with 5 slots."""
    import torch
    from cook_tpu_torch.ops import fused_match as fm

    f = lambda v, n: torch.full((n,), v, dtype=torch.float32, device=device)
    hp = fm.pack_hosts(f(16.0, H), f(16.0, H), f(0.0, H), f(16.0, H),
                       f(16.0, H), f(0.0, H),
                       torch.full((H,), 5, dtype=torch.int32, device=device),
                       torch.ones(H, dtype=torch.bool, device=device),
                       torch.zeros(H, dtype=torch.bool, device=device))
    jp = fm.pack_jobs(f(1.0, S), f(1.0, S), f(0.0, S),
                      torch.ones(S, dtype=torch.bool, device=device),
                      torch.zeros(S, dtype=torch.bool, device=device))
    forb = torch.zeros((S, H), dtype=torch.uint8, device=device)
    return jp, hp, forb


def adversarial(device, cluster):
    """(label, jp, hp, forb) of the exact_scan edge cases: mixed problems
    at S in {8, 256} x H in {1, 33, cluster x 32 (one warp of hosts per
    CTA), 100,000 (beyond the on-chip capacity)}; one host taking every
    job; unique jobs against occupied hosts; all hosts identical; all
    jobs infeasible; H = 16411 (not a multiple of 16: plain mask loads);
    operands beyond [2^-60, 2^60] (negative used, huge and tiny
    capacities, no capacity with memory free, tiny and huge demands: the
    kernel's `__fdiv_rn` beside its reciprocal-and-correction division);
    negative used on the 2^-60 grid (the reciprocal route with dividends
    of both signs); one valid host off the grid (the exact route)."""
    import torch
    from cook_tpu_torch.ops import fused_match as fm

    rng = np.random.default_rng(7)
    out = []
    for S in (8, 256):
        for H in (1, 33, cluster * 32, 100_000):
            out.append((f"s{S}_h{H}", *scan_problem(rng, S, H, device)))
    # host 9000 starts fuller than the rest, so the bin-packer sends it
    # all 256 jobs: its CTA's depletion must reach every CTA each step
    jp, hp, forb = identical_hosts(256, H_MAIN, device)
    hp[fm.H_MEM].fill_(1000.0)
    hp[fm.H_CAP_MEM].fill_(1000.0)
    hp[fm.H_MEM, 9000] = 600.0
    hp[fm.H_CPUS].fill_(100.0)
    hp[fm.H_CAP_CPUS].fill_(100.0)
    hp[fm.H_SLOTS].fill_(1000.0)
    jp[:, fm.J_MEM] = 1.5
    jp[:, fm.J_CPUS] = 0.25
    out.append(("one_host", jp, hp, forb))
    jp, hp, forb = scan_problem(rng, 256, H_MAIN, device)
    jp[:, fm.J_UNIQUE] = 1.0
    hp[fm.H_OCC0] = torch.from_numpy(
        (rng.random(H_MAIN) < 0.3).astype(np.float32)).to(device)
    out.append(("unique_occ0", jp, hp, forb))
    out.append(("all_tie", *identical_hosts(64, 4096, device)))
    jp2, hp2, _ = scan_problem(rng, 32, 2048, device)
    out.append(("all_infeasible", jp2, hp2,
                torch.ones((32, 2048), dtype=torch.uint8, device=device)))
    # H not a multiple of 1024 (nor of 16)
    jp3, hp3, forb3 = scan_problem(rng, 200, 16411, device)
    out.append(("h16411", jp3, hp3, forb3))
    # used < 0 (free memory above the capacity), capacities of 3 x 2^61
    # and 3 x 2^-62, a host without memory capacity but with memory; jobs
    # demanding 1e-20 memory or 3 x 2^59 cpus
    jp4, hp4, forb4 = scan_problem(rng, 256, 2048, device)
    for h, lane, v in ((130, fm.H_MEM, 300.0),
                       (400, fm.H_CAP_MEM, 3 * 2.0 ** 61),
                       (400, fm.H_MEM, 3 * 2.0 ** 61),
                       (700, fm.H_CAP_CPUS, 3 * 2.0 ** -62),
                       (900, fm.H_CAP_MEM, 0.0),
                       (900, fm.H_MEM, 50.0)):
        hp4[lane, h] = v
    jp4[1::2, fm.J_MEM] = 1e-20
    jp4[1::4, fm.J_CPUS] = 3 * 2.0 ** 59
    out.append(("wide_operands", jp4, hp4, forb4))
    # free amounts above the capacity (used < 0: dividends of both signs)
    # on the 2^-60 grid, so the launch divides by the reciprocal alone;
    # then one valid host's memory off the grid (1e-13): the exact route
    jp5, hp5, forb5 = scan_problem(rng, 256, 4096, device)
    hp5[fm.H_MEM, ::7] = hp5[fm.H_CAP_MEM, ::7] * 1.5
    hp5[fm.H_CPUS, ::5] = hp5[fm.H_CAP_CPUS, ::5] * 1.25
    out.append(("used_negative", jp5, hp5, forb5))
    jp6, hp6, forb6 = scan_problem(rng, 256, 4096, device)
    hp6[fm.H_MEM, 17] = 1e-13
    hp6[fm.H_VALID, 17] = 1.0
    out.append(("off_grid", jp6, hp6, forb6))
    return out


def check_adversarial(label, jp, hp, jh):
    """The expected outcome of the cases with one (job_host on the
    card, already equal to the plain version's)."""
    import torch
    from cook_tpu_torch.ops import fused_match as fm

    if label == "all_tie":
        want = torch.arange(jp.shape[0], device=jh.device) // 5
        if not torch.equal(jh.long(), want):
            fail("all_tie: lowest index did not win the ties")
    if label == "all_infeasible" and bool((jh >= 0).any()):
        fail("all_infeasible: a job was assigned")
    if label == "one_host" and not bool((jh == 9000).all()):
        fail("one_host: a job left host 9000")
    if label == "unique_occ0":
        got = jh[jh >= 0].long()
        if len(got) < 10 or bool((hp[fm.H_OCC0][got] > 0).any()) \
                or len(torch.unique(got)) != len(got):
            fail("unique_occ0: a unique job shared or took an occupied host")


def best_host_edges(device):
    """(label, jp, hp, forb, bonus, spread) of best_host's tiling edges:
    N = 1; H = 1; N = 33 x H = 515 (ragged row and host tiles, byte mask
    loads), also with a bonus and the jitter together; a tie between
    hosts 700, 1500 and 9000 (three host tiles)
    that host 700 must win; a negative bonus (see check_best_host_edge);
    operands beyond [2^-60, 2^60] (negative used, huge and tiny
    capacities, no capacity, tiny and huge demands)."""
    import torch
    from cook_tpu_torch.ops import fused_match as fm

    rng = np.random.default_rng(5)
    out = [("n1", *scan_problem(rng, 1, H_MAIN, device), None, 0.2),
           ("h1", *scan_problem(rng, 200, 1, device), None, 0.2),
           ("n33_h515", *scan_problem(rng, 33, 515, device), None, 0.2)]
    jp, hp, forb = scan_problem(rng, 33, 515, device)
    out.append(("n33_h515_bonus", jp, hp, forb, torch.from_numpy(
        rng.uniform(-0.5, 0.5, (33, 515)).astype(np.float32)).to(device),
        0.2))
    jp, hp, forb = identical_hosts(64, H_MAIN, device)
    for h in (700, 1500, 9000):      # fuller: the best fit, all equal
        hp[fm.H_MEM, h] = 8.0
        hp[fm.H_CPUS, h] = 8.0
    out.append(("tie_tiles", jp, hp, forb, None, 0.0))
    jp, hp, forb = scan_problem(rng, 256, H_MAIN, device)
    bonus = torch.from_numpy(rng.uniform(0, 0.5, (256, H_MAIN))
                             .astype(np.float32)).to(device)
    bonus[:128] = -3.0              # every feasible fit <= -1.0
    _, best = fm.best_host_plain(jp, hp, forb, bonus, 0.0)
    rows = torch.arange(128, 256, device=device)
    ok = best[128:] >= 0            # the other half: its best host sinks
    bonus[rows[ok], best[128:][ok].long()] = -3.0
    out.append(("neg_bonus", jp, hp, forb, bonus, 0.0))
    # operands outside [2^-60, 2^60]: free memory above the capacity
    # (used < 0), capacities of 3 x 2^61 and 3 x 2^-62, a host without
    # memory capacity but with memory; rows demanding 1e-20 memory or
    # 3 x 2^59 cpus. Host tiles 1, 3, 5 and 7 of 128 hold one each, the
    # others none; the odd rows are such rows, the even ones not.
    jp, hp, forb = scan_problem(rng, 256, 2048, device)
    for h, lane, v in ((130, fm.H_MEM, 300.0),
                       (400, fm.H_CAP_MEM, 3 * 2.0 ** 61),
                       (400, fm.H_MEM, 3 * 2.0 ** 61),
                       (700, fm.H_CAP_CPUS, 3 * 2.0 ** -62),
                       (900, fm.H_CAP_MEM, 0.0),
                       (900, fm.H_MEM, 50.0)):
        hp[lane, h] = v
    jp[1::2, fm.J_MEM] = 1e-20
    jp[1::4, fm.J_CPUS] = 3 * 2.0 ** 59
    out.append(("wide_operands", jp, hp, forb, None, 0.2))
    return out


def check_best_host_edge(label, idx):
    """The expected outcome of the edges with one (best_host on the card,
    already equal to the plain version's)."""
    if label == "tie_tiles" and not bool((idx == 700).all()):
        fail("best_host tie_tiles: host 700 did not win the tie")
    if label == "neg_bonus" and bool((idx[:128] >= 0).any()):
        fail("best_host neg_bonus: a fit <= -1.0 was chosen")


def group_problem(rng, S, H, G, with_bonus, device):
    """scan_problem's mix for the walk's and the dense round's other
    routes: with G > 1 groups half the jobs unique, half of the group ids
    among 8 groups (so a walk's own placements exclude hosts) and the
    rest in -1..G+1 (clipped in use), 5% of each group's hosts occupied
    on entry; with `with_bonus` a U(0, 0.3) (S, H) bonus. Returns (jp,
    hp, forb, occ or None, bonus or None)."""
    import torch
    from cook_tpu_torch.ops import fused_match as fm

    jp, hp, forb = scan_problem(rng, S, H, device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    occ = None
    if G > 1:
        ids = np.where(rng.random(S) < 0.5, rng.integers(0, 8, S),
                       rng.integers(-1, G + 2, S))
        jp[:, fm.J_GROUP] = t(ids.astype(np.float32))
        jp[:, fm.J_UNIQUE] = t((rng.random(S) < 0.5).astype(np.float32))
        occ = t(rng.random((G, H), dtype=np.float32) < 0.05)
    bonus = (t(rng.uniform(0, 0.3, (S, H)).astype(np.float32))
             if with_bonus else None)
    return jp, hp, forb, occ, bonus


def misaligned(x, offset_bytes):
    """A contiguous copy of x whose storage starts `offset_bytes` past a
    16-byte boundary (the kernels then take plain loads)."""
    import torch
    n = x.numel() * x.element_size()
    buf = torch.empty(n + 16, dtype=torch.uint8, device=x.device)
    out = buf[offset_bytes:offset_bytes + n].view(x.dtype).view(x.shape)
    out.copy_(x)
    return out


def check_scan_route(jp, hp, forb, occ, bonus, label):
    """exact_scan vs its plain version on one route's inputs: job_host
    equal, the host stack and the occupancy bit-equal, and no unique job
    on a host its group held before it. Returns (max |lane diff|, jobs
    assigned)."""
    import torch
    from cook_tpu_torch.ops import fused_match as fm

    got = fm.exact_scan(jp, hp, forb, occ=occ, bonus=bonus)
    want = fm.exact_scan_plain(jp, hp, forb, occ=occ, bonus=bonus)
    torch.cuda.synchronize()
    if not torch.equal(got[0], want[0]):
        bad = int((got[0] != want[0]).sum())
        fail(f"exact_scan {label}: job_host differs from plain at {bad} "
             f"jobs")
    if not torch.equal(got[1].view(torch.int32), want[1].view(torch.int32)):
        fail(f"exact_scan {label}: host stack not bit-equal to plain "
             f"(max abs diff {float((got[1] - want[1]).abs().max())})")
    if occ is not None:
        if not torch.equal(got[2], want[2]):
            fail(f"exact_scan {label}: occupancy differs from plain")
        jh = got[0].cpu().numpy()
        j = jp.cpu().numpy()
        uniq = (j[:, fm.J_UNIQUE] > 0) & (jh >= 0)
        g = np.clip(j[:, fm.J_GROUP], 0, occ.shape[0] - 1).astype(np.int64)
        pairs = list(zip(g[uniq].tolist(), jh[uniq].tolist()))
        if len(set(pairs)) != len(pairs) or bool(occ.cpu().numpy()[
                g[uniq], jh[uniq]].any()):
            fail(f"exact_scan {label}: a unique group shares a host")
    return float((got[1] - want[1]).abs().max()), int((got[0] >= 0).sum())


def scan_route_edges(device, cluster):
    """(label, S, H, G, with_bonus, misaligned bonus) of the walk's other
    routes at their edges: one job (the ring never fills); S past the
    bonus route's 256-row job tile once and twice; every host on chip
    (H = cluster x 4,096) and 16 a CTA beyond; H = 16411 (plain mask and
    bonus loads); a bonus 4 bytes off a 16-byte boundary (plain loads at
    H % 16 = 0); S = 256 x H = 100,000 past the 65,536 on-chip hosts with
    64 groups and a bonus; and all jobs unique in one group."""
    cap = cluster * 4096
    return [("bonus_s1", 1, H_MAIN, 1, True, False),
            ("groups_bonus_s257", 257, 4096, 64, True, False),
            ("groups_bonus_s513_all_on_chip", 513, cap, 4, True, False),
            ("bonus_beyond_cap", 64, cap + cluster * 16, 1, True, False),
            ("groups_beyond_cap", 64, cap + cluster * 16, 64, False, False),
            ("groups_bonus_h16411", 200, 16411, 64, True, False),
            ("bonus_misaligned", 128, H_MAIN, 1, True, True),
            ("groups_bonus_h100000", 256, 100_000, 64, True, False),
            ("one_unique_group", 256, 4096, 4, False, False)]


def group_routes(dev, cluster):
    """2d: exact_scan's bonus and groups routes and best_host's groups
    route against their plain versions on the card (module docstring),
    then their times at the main shapes. Returns the stats."""
    import torch
    from cook_tpu_torch.ops import fused_match as fm

    rng = np.random.default_rng(21)
    S, H = S_MAIN, H_MAIN
    scan_err, assigned, main = 0.0, {}, {}
    for G in (1,) + GROUP_G:
        for with_bonus in ((True,) if G == 1 else (False, True)):
            label = f"g{G}" + ("_bonus" if with_bonus else "")
            args = group_problem(rng, S, H, G, with_bonus, dev)
            err, assigned[label] = check_scan_route(*args, label)
            scan_err = max(scan_err, err)
            main[label] = args
    for label, S_, H_, G, with_bonus, off in scan_route_edges(dev, cluster):
        jp, hp, forb, occ, bonus = group_problem(rng, S_, H_, G, with_bonus,
                                                 dev)
        if label == "one_unique_group":
            jp[:, fm.J_UNIQUE] = 1.0
            jp[:, fm.J_GROUP] = 2.0
            jp[:, fm.J_ACTIVE] = 1.0
        if off:
            bonus = misaligned(bonus, 4)
        err, assigned[label] = check_scan_route(jp, hp, forb, occ, bonus,
                                                label)
        scan_err = max(scan_err, err)
    if assigned["one_unique_group"] < 64:
        fail(f"one_unique_group: {assigned['one_unique_group']} placed")
    print(json.dumps({"exact_scan_routes_vs_plain": "bit-equal",
                      "max_abs_err": scan_err, "assigned": assigned}),
          flush=True)

    # best_host with G groups: D rows x H hosts at G = 2,048
    D, Gm = D_MAIN, GROUP_G[-1]
    jp, hp, forb, occ, bonus = group_problem(rng, D, H, Gm, True, dev)
    bh_err = 0.0
    for b, spread, label in ((None, 0.2, "groups spread 0.2"),
                             (None, 0.0, "groups spread 0"),
                             (bonus, 0.0, "groups bonus spread 0"),
                             (bonus, 0.2, "groups bonus spread 0.2")):
        err, n, _ = check_best_host(jp, hp, forb, b, spread, label,
                                    occ=occ)
        bh_err = max(bh_err, err)
        if n == 0:
            fail(f"best_host {label}: no row found a host")
    for label, N_, H_, G, with_bonus in (("groups_n33_h515", 33, 515, 64,
                                          True),
                                         ("groups_n200_h16411", 200, 16411,
                                          64, False),
                                         ("groups_occ_misaligned", 256, H,
                                          64, True)):
        a, b, c, o, bb = group_problem(rng, N_, H_, G, with_bonus, dev)
        if label == "groups_occ_misaligned":
            o = misaligned(o, 1)
        err, _, _ = check_best_host(a, b, c, bb, 0.2, label, occ=o)
        bh_err = max(bh_err, err)
    print(json.dumps({"best_host_groups_vs_plain": "equal",
                      "max_abs_err": bh_err}), flush=True)

    # times at the main shapes: S = 1,024 / D = 1,024 x H = 16,384
    out = {"scan_err": scan_err, "best_host_err": bh_err}
    jb = main["g1_bonus"]
    jg = main[f"g{Gm}"]
    jgb = main[f"g{Gm}_bonus"]
    out["exact_scan_bonus_ms"] = cuda_ms(
        lambda: fm.exact_scan(jb[0], jb[1], jb[2], bonus=jb[4]), 20)
    out["exact_scan_bonus_plain_ms"] = cuda_ms(
        lambda: fm.exact_scan_plain(jb[0], jb[1], jb[2], bonus=jb[4]), 1)
    out["exact_scan_groups_ms"] = cuda_ms(
        lambda: fm.exact_scan(jg[0], jg[1], jg[2], occ=jg[3]), 20)
    out["exact_scan_groups_bonus_ms"] = cuda_ms(
        lambda: fm.exact_scan(*jgb[:3], occ=jgb[3], bonus=jgb[4]), 20)
    out["exact_scan_groups_plain_ms"] = cuda_ms(
        lambda: fm.exact_scan_plain(jg[0], jg[1], jg[2], occ=jg[3]), 1)
    # the groups route's and the bonus route's chain floors: the same S
    # steps with one warp of hosts a CTA
    fb = group_problem(np.random.default_rng(4), S, cluster * 32, 1, True,
                       dev)
    check_scan_route(*fb, "bonus chain floor")
    out["exact_scan_bonus_chain_floor_ms"] = cuda_ms(
        lambda: fm.exact_scan(*fb[:3], bonus=fb[4]), 20)
    fg = group_problem(np.random.default_rng(4), S, cluster * 32, Gm, True,
                       dev)
    check_scan_route(*fg, "groups chain floor")
    out["exact_scan_groups_chain_floor_ms"] = cuda_ms(
        lambda: fm.exact_scan(*fg[:3], occ=fg[3], bonus=fg[4]), 20)
    out["best_host_groups_ms"] = cuda_ms(
        lambda: fm.best_host(jp, hp, forb, None, 0.2, occ=occ), 50)
    out["best_host_groups_bonus_ms"] = cuda_ms(
        lambda: fm.best_host(jp, hp, forb, bonus, 0.0, occ=occ), 50)
    out["best_host_groups_plain_ms"] = cuda_ms(
        lambda: fm.best_host_plain(jp, hp, forb, None, 0.2, occ=occ), 5)
    # bounds: each input read once, each output written once; the walk's
    # operations per (job, host) pair plus 1 for the bonus add and 1 for
    # the occupancy test; best_host's as the G = 1 route's plus 1 a
    # unique row's pair, and the occupancy rows of the unique rows'
    # groups read once
    lanes = 16 * H * 4
    out["exact_scan_bonus_bound"] = bound(
        S * 8 * 4 + lanes + S * H + S * H * 4 + S * 4 + lanes,
        S * H * (OPS_PER_PAIR + 1))
    out["exact_scan_groups_bound"] = bound(
        S * 8 * 4 + lanes + S * H + 2 * Gm * H + S * 4 + lanes,
        S * H * (OPS_PER_PAIR + 1))
    j = jp.cpu().numpy()
    uniq = j[:, fm.J_UNIQUE] > 0
    rows = len(np.unique(np.clip(j[uniq, fm.J_GROUP], 0, Gm - 1)))
    feas = int(fm.best_host_feasible(jp, hp, forb, occ).sum())
    out["best_host_groups_feasible_pairs"] = feas
    out["best_host_groups_bound"] = bound(
        D * 8 * 4 + BH_HOST_ROWS * H * 4 + D * H + rows * H + D * 8,
        H * BH_OPS_HOST + D * H * BH_OPS_PAIR + int(uniq.sum()) * H
        + feas * (BH_OPS_FIT + BH_OPS_JITTER))
    out["G"] = Gm
    print(json.dumps({"group_routes": out}), flush=True)
    return out


def group_cells():
    """Phase 5b's cells, (cell, knobs, C), named as group_cells_phase
    names them."""
    from cook_tpu_torch.entry import sequential_for
    return [(f"{name}_{'sequential' if sequential_for(C) else 'batched'}",
             knobs, C) for name, knobs in GROUP_CELLS
            for C in (S_MAIN, C_BATCHED)]


def group_cycle_outputs(out, mi, mh):
    """What phase 5b holds the card to the CPU path on: a cycle's
    mat_idx, mat_host and why_code."""
    return {"mat_idx": np.asarray(mi).tolist(),
            "mat_host": np.asarray(mh).tolist(),
            "why_code": out[8].cpu().tolist()}


def group_cpu_cycles(knobs, C):
    """Phase 5b's first GROUP_AGREE cycles of a cell on the CPU path."""
    from cook_tpu_torch.entry import resident_workload
    wc = resident_workload(device="cpu", seed=0, C=C, **knobs)
    return [group_cycle_outputs(*wc.cycle()) for _ in range(GROUP_AGREE)]


def group_cells_phase(dev):
    """4b: the grouped and locality cells (module docstring). Returns
    ({cell: stats}, {cell: kernel launches of its timed cycles})."""
    import torch
    from cook_tpu_torch.entry import resident_workload, sequential_for
    from cook_tpu_torch.ops import fused_match as fm
    from cook_tpu_torch.ops import match as match_ops

    stats, launches = {}, {}
    match = ("exact_scan", "exact_scan/bonus", "exact_scan/groups",
             "best_host", "best_host/groups")
    for name, knobs in GROUP_CELLS:
        for C in (S_MAIN, C_BATCHED):
            seq = sequential_for(C)
            cell = f"{name}_{'sequential' if seq else 'batched'}"
            t0 = time.perf_counter()
            w = resident_workload(device=dev, seed=0, C=C, **knobs)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            want, _ = CPU_REFS.get(f"group_{cell}")
            for c in range(GROUP_AGREE):
                out, mi, mh = w.cycle()
                if as_json(group_cycle_outputs(out, mi, mh)) != want[c]:
                    fail(f"{cell} cycle {c}: the card disagrees with the "
                         f"CPU path")
                check_cycle_state(w, mi, c, cell)
            host_ms, event_ms, matched, groups = [], [], [], []
            per_cycle = []
            for c in range(GROUP_WARMUP):
                w.cycle()
            fm.reset_launches()
            for c in range(GROUP_TIMED):
                before = dict(fm.LAUNCHES)
                rounds = match_ops.ROUNDS["dense"]
                t = time.perf_counter()
                out, mi, mh = w.cycle()
                torch.cuda.synchronize()
                host_ms.append((time.perf_counter() - t) * 1e3)
                event_ms.append(w.timing["event_ms"])
                matched.append(len(mi))
                groups.append(w.num_groups)
                per_cycle.append({k: fm.LAUNCHES[k] - before[k]
                                  for k in match})
                per_cycle[-1]["dense_rounds"] = \
                    match_ops.ROUNDS["dense"] - rounds
                check_cycle_state(w, mi, c, cell)
            launches[cell] = dict(fm.LAUNCHES)
            # the walk (or the head) once a cycle on this cell's route,
            # best_host on its route once a dense round, nothing else
            route = ("exact_scan/groups" if name == "grouped"
                     else "exact_scan/bonus")
            dense = "best_host/groups" if name == "grouped" else "best_host"
            for c, d in enumerate(per_cycle):
                other = sum(d[k] for k in match) - d[route] - d[dense]
                if d[route] != 1 or d[dense] != d["dense_rounds"] or other:
                    fail(f"{cell} cycle {c}: match launches {d}")
            if not seq and not any(d[dense] for d in per_cycle):
                fail(f"{cell}: no dense round ran")
            if not sum(matched):
                fail(f"{cell}: nothing matched")
            cost = launches_and_syncs(lambda: w.cycle())
            # the plain route (_scan_assign and the plain dense
            # expression), which these cells took before the kernels
            # covered groups and a bonus
            plain_ms = []
            snap = {k: fm.LAUNCHES[k] for k in match}
            for _ in range(GROUP_PLAIN):
                t = time.perf_counter()
                _, mi, _ = w.cycle(use_kernel=False)
                torch.cuda.synchronize()
                plain_ms.append((time.perf_counter() - t) * 1e3)
            if {k: fm.LAUNCHES[k] for k in match} != snap:
                fail(f"{cell}: the plain route launched a match kernel")
            stats[cell] = {
                "C": C, "knobs": {k: list(v) if isinstance(v, tuple) else v
                                  for k, v in knobs.items()},
                "setup_s": setup_s, "cycles": GROUP_TIMED,
                "num_groups": groups,
                "event_ms_p50": float(np.median(event_ms)),
                "event_ms_p99": float(np.percentile(event_ms, 99)),
                "host_ms_p50": float(np.median(host_ms)),
                "host_ms_p99": float(np.percentile(host_ms, 99)),
                "matched_per_cycle": matched,
                "match_launches_per_cycle": per_cycle,
                **cost,
                "plain_route_label": "the parent's route: before the "
                                     "kernels covered groups and a bonus "
                                     "this cell ran _scan_assign and the "
                                     "plain dense expression (forced "
                                     "here with use_kernel=False)",
                "plain_route_host_ms": plain_ms,
                "elapsed_s": time.perf_counter() - T_START}
            print(json.dumps({f"group_cell_{cell}": stats[cell]}),
                  flush=True)
            del w
    return stats, launches


def scatter_cases(device):
    """(label, out, idx, vals) of ordered_scatter at the main path's
    shapes: the window rounds' host depletion (8,192 bids over 16,384
    hosts, 10% not accepted, k=3), the quota usage (32,768 running tasks
    over 500 users, 30% invalid, a tenth of them one heavy user's, k=3)
    and the credits (2,048 slots with duplicates, half padding, onto a
    16,384-host lane)."""
    import torch

    rng = np.random.default_rng(9)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    ti = lambda a: t(a.astype(np.int32))     # the main path's index type

    def vals(n, k):
        shape = (n,) if k == 1 else (n, k)
        return (10.0 ** rng.uniform(-3, 3, shape)).astype(np.float32)

    H, U = H_MAIN, 500
    bids = np.where(rng.random(C_BATCHED) < 0.9,
                    rng.integers(0, H, C_BATCHED), H)
    users = np.where(rng.random(32768) < 0.1, 7, rng.integers(0, U, 32768))
    users = np.where(rng.random(32768) < 0.3, U, users)
    credit = np.where(np.arange(2048) < 1024, rng.integers(0, 800, 2048), H)
    lane = rng.uniform(0, 256, H).astype(np.float32)
    return [
        ("bids_8192x16384", torch.zeros((H, 3), device=device), ti(bids),
         t(vals(C_BATCHED, 3))),
        ("usage_32768x500", torch.zeros((U, 3), device=device), ti(users),
         t(vals(32768, 3))),
        ("credits_2048x16384", t(lane), ti(credit), t(vals(2048, 1)))]


def scatter_edges(device):
    """(label, out, idx, vals) of ordered_scatter's edges: every update on
    one target (one run of 32,768: the warp path; and of 8,192 over two
    radix passes); every key dropped; int64 keys beyond int32 (dropped
    like -1 and T); k = 1, 2, 4; 64 targets of ~512 updates each (many
    runs handed to warps); one update; the credits' transposed copy;
    past one CTA, the cluster route's (cluster_edges); and a shape
    beyond both on-chip routes (T = 70,000), which takes the sorted
    route."""
    import torch

    rng = np.random.default_rng(11)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def vals(n, k):
        shape = (n,) if k == 1 else (n, k)
        return t((10.0 ** rng.uniform(-3, 3, shape)
                  * rng.choice([-1.0, 1.0], shape)).astype(np.float32))

    z = lambda T, k: torch.zeros((T,) if k == 1 else (T, k), device=device)
    i32 = lambda a: t(np.asarray(a, np.int32))
    H = H_MAIN
    wide = rng.integers(0, H, 4096)
    wide[::5] = 2 ** 40
    wide[1::7] = -(2 ** 40)
    wide[2::11] = H
    wide[3::13] = -1
    cf = vals(3 * 2048, 1).view(3, 2048)
    out = [
        ("one_target_32768x500", z(500, 3), i32(np.full(32768, 7)),
         vals(32768, 3)),
        ("one_target_8192x16384", z(H, 1), i32(np.full(8192, 9000)),
         vals(8192, 1)),
        ("all_dropped", z(H, 3), i32(np.where(rng.random(8192) < 0.5, -1, H)),
         vals(8192, 3)),
        ("int64_wide", z(H, 2), t(wide.astype(np.int64)), vals(4096, 2)),
        ("runs_512x64_k4", z(64, 4), i32(rng.integers(0, 64, 32768)),
         vals(32768, 4)),
        ("n1", z(1, 1), i32([0]), vals(1, 1)),
        ("credits_transposed", z(H, 3), i32(np.where(
            np.arange(2048) < 1024, rng.integers(0, 800, 2048), H)),
         cf.t().contiguous()),
        ("sorted_t70000", z(70000, 1), i32(rng.integers(0, 70001, 3000)),
         vals(3000, 1))]
    for k in (1, 2, 4):
        out.append((f"bids_k{k}", z(H, k), i32(np.where(
            rng.random(C_BATCHED) < 0.9, rng.integers(0, H, C_BATCHED), H)),
            vals(C_BATCHED, k)))
    return out + cluster_edges(device)


def cluster_edges(device):
    """(label, out, idx, vals) of ordered_scatter's cluster route (n past
    32,768, T <= 1,023) at the rebalancer's usage (T = 501, k = 2): at
    50,064 and 300,064 tasks; one target taking every update (a warp's
    chain over every CTA's places); 7 runs of ~7,150 (each straddles
    CTA boundaries); every key dropped; int64 keys beyond int32; k = 1,
    2 and 4; n = 32,769 (the first call past one CTA) and 40,000 at T =
    500; T = 1,023 (10-bit keys); the route's largest n at T = 501; and
    one more, which must take the sorted route."""
    import torch
    from cook_tpu_torch.ops import segments as seg

    rng = np.random.default_rng(12)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def vals(n, k):
        shape = (n,) if k == 1 else (n, k)
        return t((10.0 ** rng.uniform(-3, 3, shape)
                  * rng.choice([-1.0, 1.0], shape)).astype(np.float32))

    z = lambda T, k: torch.zeros((T,) if k == 1 else (T, k), device=device)
    i32 = lambda a: t(np.asarray(a, np.int32))
    U = REB_U
    n = 50_000 + REB_P
    users = lambda m: np.concatenate([rng.integers(0, U, m - REB_P),
                                      np.full(REB_P, U)])
    wide = users(n).astype(np.int64)
    wide[::5] = 2 ** 40
    wide[1::7] = -(2 ** 40)
    wide[2::11] = U + 1
    wide[3::13] = -1
    top = seg.scatter_cluster_max_n(U + 1)
    out = [
        (f"usage_{n}x{U + 1}", z(U + 1, 2), i32(users(n)), vals(n, 2)),
        (f"usage_{300_000 + REB_P}x{U + 1}", z(U + 1, 2),
         i32(users(300_000 + REB_P)), vals(300_000 + REB_P, 2)),
        (f"one_target_{n}", z(U + 1, 2), i32(np.full(n, 7)), vals(n, 2)),
        (f"straddle_7runs_{n}", z(U + 1, 2),
         i32(np.arange(n) * 7 // n * 50), vals(n, 2)),
        (f"all_dropped_{n}", z(U + 1, 2),
         i32(np.where(rng.random(n) < 0.5, -1, U + 1)), vals(n, 2)),
        (f"int64_wide_{n}", z(U + 1, 2), t(wide), vals(n, 2)),
        ("n32769x500", z(500, 3), i32(rng.integers(-1, 501, 32769)),
         vals(32769, 3)),
        ("n40000x500", z(500, 3), i32(rng.integers(-1, 501, 40000)),
         vals(40000, 3)),
        ("t1023_n40000", z(1023, 1), i32(rng.integers(-1, 1024, 40000)),
         vals(40000, 1)),
        (f"largest_n{top}x{U + 1}", z(U + 1, 2), i32(users(top)),
         vals(top, 2)),
        (f"sorted_n{top + 1}x{U + 1}", z(U + 1, 2), i32(users(top + 1)),
         vals(top + 1, 2))]
    for k in (1, 2, 4):
        out.append((f"usage_{n}_k{k}", z(U + 1, k), i32(users(n)),
                    vals(n, k)))
    return out


def rebalance_usage_case(device, T0=50_000):
    """(out, idx, vals) of the rebalancer's per-user usage scatter at
    bench_rebalance's shape: T = T0 + 64 task slots (the 64 fill slots
    invalid: the drop bucket U) over U + 1 = 501 targets, k=2 (mem,
    cpus): ordered_scatter's cluster route (n > 32,768)."""
    import torch

    rng = np.random.default_rng(21)
    U = REB_U
    users = np.concatenate([rng.integers(0, U, T0), np.full(REB_P, U)])
    vals = (10.0 ** rng.uniform(-3, 3, (T0 + REB_P, 2))).astype(np.float32)
    return (torch.zeros((U + 1, 2), device=device),
            torch.from_numpy(users.astype(np.int32)).to(device),
            torch.from_numpy(vals).to(device))


def cumsum_edges(device):
    """(label, x) of blocked_cumsum's edges, by route: one CTA (n = 1
    with -0.0, 15, 16, 17, 4,097, 16,384), the cluster (16,385: 5 CTAs
    of 4,096; 32,767 and 32,769 around 8 full chunks of 4,096; 131,073;
    262,143 and 262,145 around 8 chunks of 32,768; 327,680, the route's
    largest), device memory (327,681), 2-D k = 2 and 3, and strided
    views (columns 1:3 of 4, every other row)."""
    import torch

    rng = np.random.default_rng(13)

    def mixed(shape):
        return torch.from_numpy((10.0 ** rng.uniform(-3, 3, shape)
                                 * rng.choice([-1.0, 1.0], shape))
                                .astype(np.float32)).to(device)

    out = [("n1_neg_zero", torch.full((1,), -0.0, device=device))]
    for n in (15, 16, 17, 4097, 16384, 16385, 32767, 32769, 131073, 262143,
              262145, 327680, 327681):
        out.append((f"n{n}", mixed((n,))))
    for n, k in ((17, 2), (16384, 3), (16385, 3), (262144, 3), (327681, 2)):
        out.append((f"n{n}_k{k}", mixed((n, k))))
    for n in (8192, 100000):
        out.append((f"n{n}_cols_1_3_of_4", mixed((n, 4))[:, 1:3]))
        out.append((f"n{n}_every_other_row", mixed((2 * n,))[::2]))
    return out


def sum_cases(device):
    """(label, x) of sum_ordered: the dense round's D = 1,024 and H =
    16,384 (the main path's calls), one element (-0.0 stays), sizes
    around one window and a level, the one-CTA kernel's largest n, past
    it the cluster route (262,145, the 300k rebalance pool's T, ~1M,
    its largest n 8,388,608; at the pool's T also all -0.0, a NaN, and
    +inf beside -inf), and beyond it the levels route (8,388,609: one
    level launch, then the cluster)."""
    import torch
    from cook_tpu_torch.ops import segments as seg

    rng = np.random.default_rng(17)
    out = [("n1_neg_zero", torch.full((1,), -0.0, device=device))]
    for n in (2, 31, 32, 33, 1000, D_MAIN, 1025, H_MAIN, 16385, 100000,
              262144, 262145, SUM_LEVELS_N, 1048573, seg.SUM_CLUSTER_MAX,
              seg.SUM_CLUSTER_MAX + 1):
        x = (10.0 ** rng.uniform(-3, 3, n)
             * rng.choice([-1.0, 1.0], n)).astype(np.float32)
        x[::97] = 0.0
        out.append((f"n{n}", torch.from_numpy(x).to(device)))
    n = SUM_LEVELS_N
    nan = (10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
    nan[n // 3] = np.nan
    inf = (10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
    inf[1000], inf[n - 5] = np.inf, -np.inf
    out += [(f"n{n}_all_neg_zero", torch.full((n,), -0.0, device=device)),
            (f"n{n}_nan", torch.from_numpy(nan).to(device)),
            (f"n{n}_inf_minus_inf", torch.from_numpy(inf).to(device))]
    return out


def check_sum(x, label):
    """sum_ordered vs its plain version, bit for bit, and run to run."""
    import torch
    from cook_tpu_torch.ops import segments as seg

    a, b = seg.sum_ordered(x), seg.sum_ordered(x)
    p = seg.sum_ordered_plain(x)
    torch.cuda.synchronize()
    bits = lambda t: t.view(torch.int32)
    if not torch.equal(bits(a), bits(p)):
        fail(f"sum_ordered {label}: not bit-equal to plain ({float(a)} vs "
             f"{float(p)})")
    if not torch.equal(bits(a), bits(b)):
        fail(f"sum_ordered {label}: two runs differ")
    d = abs(float(a) - float(p))
    return d if d == d else 0.0     # bit-equal NaNs


def off_route(launches):
    """Launches of the routes the resident cycles (headline, sequential,
    batched; their calls all fit one CTA or blocked_cumsum's cluster)
    must not take: beyond the on-chip designs, or past one CTA."""
    return sum(launches[k] for k in (
        "ordered_scatter/cluster", "ordered_scatter/sorted",
        "blocked_cumsum/global", "sum_ordered/cluster",
        "sum_ordered/levels"))


@contextlib.contextmanager
def parent_routes():
    """Route the segment kernels' calls past one CTA as before the
    cluster routes (to time both in one run): scatters the cluster
    route would take go to ordered_scatter/sorted (torch.sort, then the
    walk), sums past SUM_MAX to the levels route and the one-CTA
    kernel."""
    from cook_tpu_torch.ops import segments as seg

    plan, top = seg.scatter_plan, seg.SUM_CLUSTER_MAX

    def sorted_plan(n, T):
        route = plan(n, T)
        return ("ordered_scatter/sorted", 0, ()) \
            if route[0] == "ordered_scatter/cluster" else route

    seg.scatter_plan, seg.SUM_CLUSTER_MAX = sorted_plan, seg.SUM_MAX
    try:
        yield
    finally:
        seg.scatter_plan, seg.SUM_CLUSTER_MAX = plan, top


def in_turns(parent, new, reps, rounds=2):
    """CUDA-event ms per call of `parent` and of `new`, timed in turns
    (parent, new, new, parent, ...): ([parent ms], [new ms])."""
    a, b = [], []
    for _ in range(rounds):
        a.append(cuda_ms(parent, reps))
        b.append(cuda_ms(new, reps))
        b.append(cuda_ms(new, reps))
        a.append(cuda_ms(parent, reps))
    return a, b


def routes_ran(before, names, label):
    """Fail unless each launch counter in `names` moved since `before`."""
    from cook_tpu_torch.ops import fused_match as fm

    for k in names:
        if fm.LAUNCHES[k] == before[k]:
            fail(f"{label}: the {k} route never ran")


def check_scatter(out, idx, vals, label):
    """ordered_scatter vs its plain version, bit for bit, and run to run;
    returns (max |diff|, the longest run: updates of one target)."""
    import torch
    from cook_tpu_torch.ops import segments as seg

    a = seg.scatter_add_ordered_(out.clone(), idx, vals)
    b = seg.scatter_add_ordered_(out.clone(), idx, vals)
    p = seg.scatter_add_ordered_plain_(out.clone(), idx, vals)
    torch.cuda.synchronize()
    bits = lambda x: x.view(torch.int32)
    if not torch.equal(bits(a), bits(p)):
        fail(f"ordered_scatter {label}: not bit-equal to plain (max abs "
             f"diff {float((a - p).abs().max())})")
    if not torch.equal(bits(a), bits(b)):
        fail(f"ordered_scatter {label}: two runs differ")
    i = idx.cpu().numpy()
    return float((a - p).abs().max()), int(np.bincount(
        i[(i >= 0) & (i < out.shape[0])], minlength=1).max())


def check_cumsum(x, label):
    """blocked_cumsum vs its plain version, bit for bit, and run to run."""
    import torch
    from cook_tpu_torch.ops import segments as seg

    a, b = seg.blocked_cumsum(x), seg.blocked_cumsum(x)
    p = seg.blocked_cumsum_plain(x)
    torch.cuda.synchronize()
    bits = lambda t: t.view(torch.int32)
    if not torch.equal(bits(a), bits(p)):
        fail(f"blocked_cumsum {label}: not bit-equal to plain (max abs "
             f"diff {float((a - p).abs().max())})")
    if not torch.equal(bits(a), bits(b)):
        fail(f"blocked_cumsum {label}: two runs differ")
    return float((a - p).abs().max())


def bound(bytes_moved, ops):
    """(bound_ms, bound_by) from bytes over HBM rate and operations over
    the f32 rate."""
    b_ms = bytes_moved / HBM_BPS * 1e3
    o_ms = ops / F32_OPS * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel wrapper to its plain version (replay only)."""
    from cook_tpu_torch.ops import fused_match as fm
    from cook_tpu_torch.ops import segments as seg

    saved = (fm.exact_scan, fm.best_host, seg.blocked_cumsum,
             seg.scatter_add_ordered_, seg.sum_ordered)
    fm.exact_scan, fm.best_host = fm.exact_scan_plain, fm.best_host_plain
    seg.blocked_cumsum = seg.blocked_cumsum_plain
    seg.scatter_add_ordered_ = seg.scatter_add_ordered_plain_
    seg.sum_ordered = seg.sum_ordered_plain
    try:
        yield
    finally:
        (fm.exact_scan, fm.best_host, seg.blocked_cumsum,
         seg.scatter_add_ordered_, seg.sum_ordered) = saved


def head_window_inversions(w, out, now_s):
    """Queue positions (< AUDIT_WINDOW) of head-of-line inversions in one
    batched cycle, by the copied host-side audit: jobs in compact slot
    (= queue) order, each host's capacity before the match (the state
    after it plus what the cycle's matches took), and each job's mask as
    the cycle built it (forbidden row, ports, estimated completion)."""
    import torch
    from cook_tpu_torch.ops import match as mo

    st = w.rs.state
    a = lambda t: t[:-1].cpu().numpy()
    pend = {k: a(st["pend"][k]) for k in
            ("mem", "cpus", "gpus", "ports", "est_s", "forb_slot",
             "unique_group")}
    host = {k: a(v) for k, v in st["host"].items()}
    cons_idx = out[0].cpu().numpy()
    cons_host = out[1].cpu().numpy()
    H = host["mem"].shape[0]
    m = (cons_idx >= 0) & (cons_host >= 0)
    mi, mh = cons_idx[m], cons_host[m]

    def before(lane, vals):
        return host[lane] + np.bincount(mh, vals, minlength=H)

    mem0 = before("mem", pend["mem"][mi])
    cpus0 = before("cpus", pend["cpus"][mi])
    gpus0 = before("gpus", pend["gpus"][mi])
    slots0 = host["task_slots"] + np.bincount(mh, minlength=H)
    ports0 = host["ports"] + np.bincount(mh, pend["ports"][mi],
                                         minlength=H).astype(np.int64)
    win = cons_idx[:AUDIT_WINDOW]
    valid = win >= 0
    rows = np.where(valid, win, 0)
    fslot = pend["forb_slot"][rows]
    forb = np.zeros((len(win), H), bool)
    has = valid & (fslot >= 0)
    forb[has] = st["forb"][:-1][torch.from_numpy(
        fslot[has].astype(np.int64)).to(st["forb"].device)].cpu().numpy()
    forb |= pend["ports"][rows][:, None] > ports0[None, :]
    est = pend["est_s"][rows]
    forb |= (est > 0)[:, None] & \
        ((now_s + est)[:, None] >= host["death_s"][None, :])
    jobs = mo.Jobs(mem=pend["mem"][rows], cpus=pend["cpus"][rows],
                   gpus=pend["gpus"][rows], valid=valid,
                   group=np.full(len(win), -1, np.int32),
                   unique_group=pend["unique_group"][rows])
    hosts = mo.Hosts(mem=mem0, cpus=cpus0, gpus=gpus0,
                     cap_mem=host["cap_mem"], cap_cpus=host["cap_cpus"],
                     cap_gpus=host["cap_gpus"], valid=host["valid"],
                     task_slots=slots0)
    return mo.inversion_positions_np(jobs, hosts, forb,
                                     cons_host[:AUDIT_WINDOW])


def check_cycle_state(w, mat_idx, c, label):
    import torch

    rs = w.rs
    h = rs.state["host"]
    for lane in ("mem", "cpus", "gpus"):
        low = float(h[lane][:-1].min())
        if low < -1e-6:
            fail(f"{label} cycle {c}: host lane {lane} went to {low}")
    if int(h["task_slots"][:-1].min()) < 0:
        fail(f"{label} cycle {c}: negative task slots")
    if len(mat_idx) and bool(rs.state["pend"]["valid"][
            torch.from_numpy(mat_idx).to(rs.device).long()].any()):
        fail(f"{label} cycle {c}: a matched row is still valid")


def _first_difference(names, got, want):
    """The name of the first of two results' tensors that differ (floats
    by their bits), or None."""
    import torch

    for name, g, w in zip(names, got, want):
        if g.is_floating_point():
            g, w = g.view(torch.int32), w.view(torch.int32)
        if not torch.equal(g, w):
            return name
    return None


def tensor_bits(xs):
    """Each tensor of `xs` as [dtype, its values] (floats by their
    bits), for holding results against a run in another process."""
    import torch
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return [[str(x.dtype), (x.view(ints[x.element_size()])
                            if x.is_floating_point() else x).tolist()]
            for x in xs]


def rebalance_cpu_run(T0, gpu, cap):
    """Phase 6's sweep on the host CPU (tensor_bits of its result)."""
    from cook_tpu_torch.entry import rebalance_args
    from cook_tpu_torch.ops import rebalance as reb
    args, kw = rebalance_args(T0, REB_P, REB_H, REB_U, gpu=gpu,
                              device="cpu")
    return tensor_bits(reb.rebalance(*args, REB_SAFE_DRU, REB_MIN_DRU_DIFF,
                                     candidate_cap=cap, **kw))


def rebalance_phase(dev):
    """The rebalancer's sweeps (REB_VARIANTS) through the kernels, each
    held against the same sweep through the plain versions. Returns
    ({label: numbers}, launches of the counted sweeps by kernel)."""
    import torch
    from cook_tpu_torch.entry import rebalance_args
    from cook_tpu_torch.ops import fused_match as fm
    from cook_tpu_torch.ops import rebalance as reb
    from cook_tpu_torch.ops import segments as seg
    from cook_tpu_torch.profile_cycle import profile_calls, sync_sources

    out, launches = {}, dict.fromkeys(fm.LAUNCHES, 0)
    for label, T0, gpu, cap in REB_VARIANTS:
        t0 = time.perf_counter()
        args, kw = rebalance_args(T0, REB_P, REB_H, REB_U, gpu=gpu,
                                  device=dev)
        sweep = lambda: reb.rebalance(*args, REB_SAFE_DRU, REB_MIN_DRU_DIFF,
                                      candidate_cap=cap, **kw)
        sweep()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        # the counted sweep: counters from 0, CUDA events and the host
        # clock from the call to the readback
        fm.reset_launches()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        t = time.perf_counter()
        res = sweep()
        got = [x.cpu() for x in res]
        host_ms = (time.perf_counter() - t) * 1e3
        ev[1].record()
        ev[1].synchronize()
        d = dict(fm.LAUNCHES)
        for k, v in d.items():
            launches[k] += v
        T = T0 + REB_P
        # one launch a call: the DRU cumsum (the cover test's prefix is
        # an exact int64 sum, no kernel), the usage scatter (T tasks onto
        # U + 1) on the cluster route, the freed-resource sums on the
        # one-CTA kernel, past SUM_MAX on the cluster
        need = {"blocked_cumsum": REB_P,
                seg.scatter_plan(T, REB_U + 1)[0]: REB_P,
                seg.sum_ordered_route(T): 2 * REB_P}
        if need.get("ordered_scatter/cluster") != REB_P:
            fail(f"rebalance {label}: its usage scatter would not take the "
                 f"cluster route ({need})")
        for k, n in need.items():
            if d[k] < n:
                fail(f"rebalance {label}: {k} launched {d[k]} times, "
                     f"fewer than {n}")
        if d["ordered_scatter/sorted"] or d["sum_ordered/levels"]:
            fail(f"rebalance {label}: a route past the cluster's launched "
                 f"({d})")
        if d["exact_scan"] or d["best_host"]:
            fail(f"rebalance {label}: a match kernel launched ({d})")
        if not bool(got[0].any()):
            fail(f"rebalance {label}: no job placed")
        syncs = sync_sources(sweep)
        if syncs:
            fail(f"rebalance {label}: the sweep synchronised the host "
                 f"before its readback: {syncs}")
        # profiled (launches, device busy) only where the routes before
        # the cluster's are timed too: the profiler's summary of a sweep
        # (thousands of events) takes ~8 s on the host
        parent = label in REB_PARENT_VARIANTS
        if parent:
            _, kernels, _, wall_ms = profile_calls(sweep, 1)
            with parent_routes():
                parent_kernels = profile_calls(sweep, 1)[1]

        def timed_sweep(parent):
            with parent_routes() if parent else contextlib.nullcontext():
                ev[0].record()
                [x.cpu() for x in sweep()]
                ev[1].record()
                ev[1].synchronize()
            return ev[0].elapsed_time(ev[1])

        # the sweep on the routes before the cluster's and on the new
        # routes, in turns: parent, new, new, parent, ...
        events, parent_events = [], []
        for _ in range(2 if parent else 0):
            parent_events.append(timed_sweep(True))
            events += [timed_sweep(False), timed_sweep(False)]
            parent_events.append(timed_sweep(True))
        while len(events) < 3:
            events.append(timed_sweep(False))
        # the same sweep through the plain versions
        before = dict(fm.LAUNCHES)
        t = time.perf_counter()
        with plain_kernels():
            want = [x.cpu() for x in sweep()]
        plain_s = time.perf_counter() - t
        if fm.LAUNCHES != before:
            fail(f"rebalance {label}: the plain replay launched a kernel")
        bad = _first_difference(res._fields, got, want)
        if bad:
            fail(f"rebalance {label}: {bad} differs from the plain "
                 f"versions'")
        # the 50k sweeps once more on the host CPU: the port's plain
        # versions there are what tests/test_torch_rebalance.py holds
        # equal to the JAX package's, so the card's sort and scatter
        # orders are held to the reference's too
        cpu_s = None
        if T0 <= REB_CPU_MAX_T0:
            on_cpu, cpu_s = CPU_REFS.get(f"rebalance_{label}")
            bad = next((name for name, g, w in zip(
                res._fields, tensor_bits(got), on_cpu) if g != w), None)
            if bad:
                fail(f"rebalance {label}: {bad} on the card differs from "
                     f"the CPU's")
        out[label] = {
            "T0": T0, "gpu_mode": gpu, "candidate_cap": cap,
            "placed": int(got[0].sum()), "preempted": int(got[2].sum()),
            "sweep_event_ms": float(np.median(events)),
            "sweep_event_ms_runs": events,
            "sweep_host_ms_counted": host_ms,
            **({"device_busy_ms": sum(k[1] for k in kernels),
                "device_idle_share": 1.0 - sum(k[1] for k in kernels)
                / wall_ms if wall_ms else None,
                "launches_per_sweep": sum(k[2] for k in kernels),
                "launches_per_step": sum(k[2] for k in kernels) / REB_P,
                "parent_routes_launches_per_step":
                sum(k[2] for k in parent_kernels) / REB_P,
                "parent_routes_sweep_event_ms": float(np.median(
                    parent_events)),
                "parent_routes_sweep_event_ms_runs": parent_events}
               if parent else {}),
            "host_syncs_before_readback": sum(syncs.values()),
            "kernel_launches": {k: v for k, v in d.items() if v},
            "plain_replay_s": plain_s, "cpu_run_s": cpu_s,
            "setup_s": setup_s}
        print(json.dumps({f"rebalance_{label}": out[label]}), flush=True)
    return out, launches


def e2e_agreement_run(device, consider):
    """Phase 7's deterministic run of one matcher: E2E_AGREE cycles, and
    batched on until one ran a dense round, up to E2E_AGREE_MAX."""
    from cook_tpu_torch import e2e
    return e2e.launch_trace(device, E2E_AGREE, consider=consider,
                            until_dense=E2E_AGREE_MAX if consider else 0,
                            **E2E_SHAPE)


def _first_launch_difference(got, want, names=("card", "CPU path")) -> str:
    k = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    at = lambda x: x[k] if k < len(x) else None
    return (f"launch {k}: {names[0]} {at(got)} vs {names[1]} {at(want)} "
            f"({len(got)} vs {len(want)} launches)")


def e2e_phase(dev):
    """7: bench_e2e's production path on the card (see the module
    docstring). Returns ({matcher: stats}, {matcher: launch counts of
    its timed run})."""
    import torch
    from cook_tpu_torch import e2e
    from cook_tpu_torch.ops import fused_match as fm
    from cook_tpu_torch.ops import match as match_ops
    from cook_tpu_torch.profile_cycle import profile_calls, sync_sources

    # the readback of cycles in flight. A small pool, one user, no
    # completions: the same launches as the inline run
    small = dict(P0=3000, H=100, U=1, advance=False)
    ref = e2e.launch_trace(dev, 4, mode="inline", **small)
    if not ref["launched"]:
        fail("e2e readback check: the inline run launched nothing")
    for mode in ("pipelined", "async"):
        got = e2e.launch_trace(dev, 4, mode=mode, **small)
        if got["launched"] != ref["launched"]:
            fail(f"e2e readback check, {mode}: "
                 + _first_launch_difference(got["launched"],
                                            ref["launched"]))
        if mode == "pipelined" and got["max_inflight"] < 2:
            fail("e2e readback check: never two cycles in flight")
    # ... and at full width with completions flowing back: every read of
    # a cycle's own pinned copies equals a plain copy of its outputs,
    # and no job is launched twice
    readback = []
    for name, consider in E2E_MATCHERS:
        for mode in ("pipelined", "async"):
            got = e2e.launch_trace(dev, E2E_READBACK_CYCLES, mode=mode,
                                   audit=True, consider=consider,
                                   **E2E_SHAPE)
            label = f"e2e readback check, {name} {mode}, full width"
            if got["audit_mismatches"]:
                fail(f"{label}: {got['audit_mismatches'][:3]}")
            if not got["audited_reads"] or not got["completed"]:
                fail(f"{label}: {got['audited_reads']} early reads, "
                     f"{got['completed']} completions")
            jobs = [u for u, _ in got["launched"]]
            if len(set(jobs)) != len(jobs):
                twice = dict(list(got["repeats"].items())[:5])
                fail(f"{label}: a job launched twice; instances (host, "
                     f"status, reason): {twice}")
            if mode == "pipelined" and got["max_inflight"] < 2:
                fail(f"{label}: never two cycles in flight")
            readback.append({"matcher": name, "mode": mode,
                             "cycles": E2E_READBACK_CYCLES,
                             "launched": len(jobs),
                             "completed": got["completed"],
                             "early_reads_checked": got["audited_reads"],
                             "max_inflight": got["max_inflight"]})
    print(json.dumps({"e2e_readback": readback}), flush=True)

    results, launches = {}, {}
    for name, consider in E2E_MATCHERS:
        t0 = time.perf_counter()
        # batched, the card's run goes on past E2E_AGREE cycles until
        # one has run a dense round (best_host), up to E2E_AGREE_MAX
        before = dict(fm.LAUNCHES)
        card_run = e2e_agreement_run(dev, consider)
        agree_bh = fm.LAUNCHES["best_host"] - before["best_host"]
        k = len(card_run["dense_rounds"])
        card_run = as_json(card_run)
        cpu_run, cpu_s = CPU_REFS.get(f"e2e_{name}")
        agree_s = time.perf_counter() - t0
        for c, (g, h) in enumerate(zip(card_run["per_cycle"],
                                       cpu_run["per_cycle"])):
            if g != h:
                fail(f"e2e {name} cycle {c}: "
                     + _first_launch_difference(g, h))
        if card_run["dense_rounds"] != cpu_run["dense_rounds"]:
            fail(f"e2e {name}: dense rounds {card_run['dense_rounds']} "
                 f"on the card, {cpu_run['dense_rounds']} on the CPU path")
        agreed = [len(x) for x in card_run["per_cycle"]]
        if not sum(agreed[:k]):
            fail(f"e2e {name}: the agreement cycles launched nothing")
        agree_dense = sum(card_run["dense_rounds"])
        if consider is not None and not agree_dense:
            fail(f"e2e {name}: no dense round in {k} agreement cycles")
        if agree_bh != agree_dense:
            fail(f"e2e {name}: best_host launched {agree_bh} times in "
                 f"{agree_dense} dense rounds of the agreement")

        t0 = time.perf_counter()
        # no durable log here (bench_torch.py e2e keeps bench_e2e's log,
        # rotation and retention): its rotation checkpoints stall
        # cycles for seconds, which the smoke need not wait out
        w = e2e.Workload(consider=consider, device=dev, durable=False,
                         **E2E_SHAPE)
        setup_s = time.perf_counter() - t0
        e2e.apply_gc_discipline()
        try:
            per = []
            fm.reset_launches()
            snap = [dict(fm.LAUNCHES), match_ops.ROUNDS["dense"]]

            def on_cycle(c, stats):
                d = {k: fm.LAUNCHES[k] - snap[0][k] for k in snap[0]}
                dense = match_ops.ROUNDS["dense"] - snap[1]
                snap[0] = dict(fm.LAUNCHES)
                snap[1] = match_ops.ROUNDS["dense"]
                per.append((d["exact_scan"], d["best_host"], dense))
                if d["exact_scan"] != 1:
                    fail(f"e2e {name} cycle {c}: exact_scan launched "
                         f"{d['exact_scan']} times")
                if d["best_host"] != dense or (consider is None and dense):
                    fail(f"e2e {name} cycle {c}: best_host launched "
                         f"{d['best_host']} times in {dense} dense rounds")

            r = e2e.run_cycles(w, E2E_CYCLES, E2E_WARMUP, on_cycle=on_cycle)
            # every route counts here: the running set outgrows the
            # one-launch scatter (Rcap > 32,768) as the backlog drains
            launches[name] = dict(fm.LAUNCHES)
            if consider is not None and not any(p[2] for p in per):
                fail(f"e2e {name}: no cycle reached a dense round")

            def one_cycle():
                w.coord.match_cycle(e2e.POOL)
                w.advance()

            _, kernels, _, prof_wall = profile_calls(one_cycle, 1)
            sources = sync_sources(one_cycle)
            busy = sum(k[1] for k in kernels)
            n_cycles = E2E_CYCLES
            s = e2e.summary(r)
            results[name] = {
                "C": min(consider or 1024, w.rp.Pcap), **E2E_SHAPE,
                "agreement_cycles": k,
                "agreement_launches_per_cycle": agreed,
                "agreement_dense_rounds": card_run["dense_rounds"],
                "agreement_best_host_launches": agree_bh,
                "agreement_s": agree_s, "agreement_cpu_path_s": cpu_s,
                "setup_s": setup_s,
                "seed_submit_s": w.seed_s,
                "p50_cycle_ms": s["p50_cycle_ms"],
                "p99_cycle_ms": s["p99_cycle_ms"],
                "mean_cycle_ms": s["mean_cycle_ms"],
                "max_cycle_ms": s["max_cycle_ms"],
                "cycles": s["cycles"],
                "matched_per_cycle": s["matched_per_cycle"],
                "value": s["value"],
                "phase_median_ms": s["phase_median_ms"],
                "resyncs": s["resyncs"],
                "gc_refreezes": s["gc_refreezes"],
                "gc_ms_median": s["gc_ms_median"],
                "gc_ms_max": s["gc_ms_max"],
                "worst_cycles": s["worst_cycles"],
                "kernel_launches": launches[name],
                "exact_scan_launches_per_cycle":
                    launches[name]["exact_scan"] / n_cycles,
                "best_host_launches_per_cycle":
                    launches[name]["best_host"] / n_cycles,
                "dense_rounds_per_cycle": [p[2] for p in per[-5:]],
                "launches_per_cycle": sum(k[2] for k in kernels),
                "device_busy_ms_per_cycle": busy,
                "device_idle_share": (1.0 - busy / prof_wall
                                      if prof_wall else None),
                "host_syncs_per_cycle": sum(sources.values()),
                "host_sync_sources": sources,
                "pending_steady": len(w.store.pending_jobs(e2e.POOL)),
                "running_steady": len(
                    w.store.running_instances(e2e.POOL)),
            }
        finally:
            w.close()
        torch.cuda.synchronize()
        print(json.dumps({"e2e": name, **results[name]}), flush=True)
    return results, launches



def paths_phase(dev):
    """8: the coordinator's device paths besides the resident cycle
    (`e2e.device_paths`: the legacy match_cycle, batched and sequential,
    in a default and a gpu pool; rebalance_cycle with its DRU head in
    both) on the card and on the port's CPU path: the traces must be
    equal, and the card's run must launch exact_scan and best_host and
    preempt in both pools."""
    from cook_tpu_torch import e2e
    from cook_tpu_torch.ops import fused_match as fm

    t0 = time.perf_counter()
    before = dict(fm.LAUNCHES)
    card = as_json(e2e.device_paths(dev))
    launched = {k: fm.LAUNCHES[k] - before[k] for k in before}
    card_s = time.perf_counter() - t0
    cpu, _ = CPU_REFS.get("paths")
    for a, b in zip(card, cpu):
        if a != b:
            what = a[:4] if a[0] == "cycle" else a[:2]
            fail(f"coordinator paths: {what} differs on the card from "
                 f"the CPU path")
    if len(card) != len(cpu):
        fail("coordinator paths: the traces differ in length")
    for k in ("exact_scan", "best_host"):
        if not launched[k]:
            fail(f"coordinator paths: {k} never launched")
    preempted = {t[1]: t[2] for t in card if t[0] == "rebalance"}
    if not all(preempted.values()):
        fail(f"coordinator paths: preempted {preempted}")
    out = {"cycles": [{"pool": t[1], "consider": t[2], "dense_rounds": t[3],
                       "launched": len(t[4])}
                      for t in card if t[0] == "cycle"],
           "preempted": preempted,
           "placed": {t[1]: t[3] for t in card if t[0] == "rebalance"},
           "kernel_launches": {k: v for k, v in launched.items() if v},
           "card_s": card_s}
    print(json.dumps({"coordinator_paths": out}), flush=True)
    return out


def server_config(log_dir, consider=1024, **sched):
    """Phase 9's deployment: bench_e2e's cluster as one mock cluster of
    identical hosts behind `build_scheduler`, the default pool, header
    auth (one user a request), a durable log in `log_dir`. Without the
    overload ladder, as bench_e2e's coordinator runs: its pending_jobs
    watermark (4 x max_jobs_considered) reads the 100,000-job backlog as
    overload and halves the consider window after three evaluations."""
    return {"clusters": [{"kind": "mock", "name": "mock",
                          "hosts": SERVER_H, "host_mem": 131072.0,
                          "host_cpus": 32.0}],
            "auth": {"scheme": "header"},
            "log_path": os.path.join(log_dir, "events.log"),
            "scheduler": {"max_jobs_considered": consider,
                          "match_interval_s": SERVER_INTERVAL_S,
                          "overload_enabled": False, **sched}}


def server_requests(n=None, seed=0, first=0):
    """The seeded backlog as /jobs/bulk bodies: n (P) jobs of U users
    (mem U(1,024, 10,240) MB, cpus U(0.5, 4), deterministic uuids from
    `first`; SERVER_CONSTRAINED of them pinned to one rack), each
    request one user's jobs (the API authenticates one user a request),
    at most SERVER_BATCH jobs."""
    import uuid
    n = SERVER_P if n is None else n
    rng = np.random.default_rng(seed)
    users = rng.integers(0, SERVER_U, n)
    mem = rng.uniform(1024, 10240, n)
    cpus = rng.uniform(0.5, 4, n)
    pinned = rng.random(n) < SERVER_CONSTRAINED
    racks = rng.integers(0, SERVER_RACKS, n)
    by_user = {}
    for i in range(n):
        spec = {"uuid": str(uuid.UUID(int=(1 << 64) + first + i)),
                "command": "true", "mem": float(mem[i]),
                "cpus": float(cpus[i])}
        if pinned[i]:
            spec["constraints"] = [["rack", "EQUALS", f"r{racks[i]}"]]
        by_user.setdefault(int(users[i]), []).append(spec)
    return [(f"u{u}", {"jobs": jobs[k:k + SERVER_BATCH]})
            for u, jobs in sorted(by_user.items())
            for k in range(0, len(jobs), SERVER_BATCH)]


def post_http(url, reqs, clients=SERVER_CLIENTS, path="/jobs/bulk"):
    """POST every request from `clients` threads; seconds from the first
    POST to the last 201."""
    import threading
    import urllib.request
    bodies = [(u, json.dumps(b).encode()) for u, b in reqs]
    errors = []

    def worker(k):
        for user, body in bodies[k::clients]:
            r = urllib.request.Request(
                url + path, data=body, method="POST",
                headers={"Content-Type": "application/json",
                         "x-cook-user": user})
            try:
                with urllib.request.urlopen(r, timeout=300) as f:
                    if f.status != 201:
                        errors.append(f.status)
            except Exception as e:
                errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    if errors:
        fail(f"server ingest: {len(errors)} requests failed: {errors[:3]}")
    return dt


def label_racks(coord):
    """Host attributes the config has no field for: each mock host in
    one of SERVER_RACKS racks, before the first cycle reads them."""
    for cluster in coord.clusters.all():
        for i, host in enumerate(sorted(cluster.hosts)):
            cluster.hosts[host].attributes["rack"] = f"r{i % SERVER_RACKS}"


def start_cycles(coord):
    """The cycle threads as rest/server.py main's on_leadership starts
    them: backends initialized, the coordinator's timer threads, and the
    real-time tick that advances mock clocks a second a second."""
    import threading
    for cluster in coord.clusters.all():
        cluster.initialize()
    coord.run()

    def tick():
        while not coord._stop.wait(1.0):
            for cluster in coord.clusters.all():
                if hasattr(cluster, "advance"):
                    cluster.advance(1.0)

    threading.Thread(target=tick, daemon=True).start()


def _pct(xs):
    return ({"p50": float(np.percentile(xs, 50)),
             "p99": float(np.percentile(xs, 99)), "n": len(xs)}
            if xs else None)


def run_server(dev, consider, until, max_s, check=None, n=SERVER_P):
    """Build phase 9's server at `consider`, take the backlog of `n` jobs
    over HTTP
    (an ApiServer, the ingest batcher), start the cycle threads and run
    until `until(entries)` holds for the profiler's committed cycle
    records (fails after `max_s` seconds of cycles), then stop the
    cycles and call `check(store, entries, url)` while the server still
    answers.
    Returns the run's records of the default pool, the ingest seconds,
    the launches counted from the cycles' start, the dense rounds and
    the overload ladder's level."""
    import shutil
    import tempfile
    from cook_tpu_torch import obs
    from cook_tpu_torch.ops import fused_match as fm
    from cook_tpu_torch.ops import match as match_ops
    from cook_tpu_torch.rest.server import (ApiServer, apply_gc_discipline,
                                            build_scheduler)
    tmp = tempfile.mkdtemp(prefix="cook_smoke_server_")
    reqs = server_requests(n)
    store, coord, api = build_scheduler(server_config(tmp, consider),
                                        device=dev)
    label_racks(coord)
    server = ApiServer(api).start()
    entries = []
    stopped = False
    try:
        ingest_s = post_http(server.url, reqs)
        if len(store.jobs) != n:
            fail(f"server ingest: {len(store.jobs)} jobs in the store")
        apply_gc_discipline()
        obs.profiler.add_listener(entries.append)
        fm.reset_launches()
        d0 = match_ops.ROUNDS["dense"]
        start_cycles(coord)
        t0 = time.perf_counter()
        while not until(list(entries)):
            if time.perf_counter() - t0 > max_s:
                fail(f"server at C={consider}: not done after {max_s} s "
                     f"({len(entries)} cycle records)")
            time.sleep(0.05)
        coord.stop()
        stopped = True
        launches = dict(fm.LAUNCHES)
        dense = match_ops.ROUNDS["dense"] - d0
        obs.profiler.remove_listener(entries.append)
        entries = [e for e in entries if e["pool"] == "default"]
        if check is not None:
            check(store, entries, server.url)
        return {"entries": entries, "ingest_s": ingest_s,
                "launches": launches, "dense_rounds": dense,
                "overload_level":
                    coord.overload.level if coord.overload else None}
    finally:
        server.stop()
        if api.ingest is not None:
            api.ingest.stop()
        if not stopped:
            coord.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def get_states(url, jobs, ok, clients=SERVER_CLIENTS):
    """GET /jobs?uuid=...&uuid=... for each user's jobs of `jobs`, (uuid,
    user) pairs, up to SERVER_GET_BATCH uuids a request, from `clients`
    threads; the (uuid, state) pairs whose state is not in `ok` (a job
    the answer lacks reads None)."""
    import threading
    import urllib.parse
    import urllib.request
    by_user = {}
    for u, user in jobs:
        by_user.setdefault(user, []).append(u)
    reqs = [(user, us[i:i + SERVER_GET_BATCH])
            for user, us in sorted(by_user.items())
            for i in range(0, len(us), SERVER_GET_BATCH)]
    bad = []

    def worker(k):
        for user, us in reqs[k::clients]:
            q = urllib.parse.urlencode([("uuid", u) for u in us])
            r = urllib.request.Request(f"{url}/jobs?{q}",
                                       headers={"x-cook-user": user})
            try:
                with urllib.request.urlopen(r, timeout=60) as f:
                    states = {j["uuid"]: j["state"]
                              for j in json.loads(f.read())}
            except Exception as e:
                states = dict.fromkeys(us, repr(e))
            bad.extend((u, states.get(u)) for u in us
                       if states.get(u) not in ok)

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return bad


def _kinds(entries, kind):
    return [e for e in entries if e["kind"] == kind]


def server_agreement(device, cycles):
    """Phase 9's server, deterministic: clocks and uuids pinned, the
    backlog taken through CookApi.handle in order, pipeline depth 0 and
    statuses applied inline, each cycle driven by hand and drained.
    Returns the backend launches, (job uuid, hostname), of each cycle."""
    import shutil
    import tempfile
    from cook_tpu_torch import e2e
    from cook_tpu_torch.rest.server import build_scheduler
    tmp = tempfile.mkdtemp(prefix="cook_smoke_agree_")
    per = []
    with e2e.pinned_clocks():
        store, coord, api = build_scheduler(
            server_config(tmp, pipeline_depth=0, status_shards=0),
            device=device)
        label_racks(coord)
        try:
            for user, body in server_requests():
                r = api.handle("POST", "/jobs/bulk", {}, body,
                               {"x-cook-user": user})
                if r.status != 201:
                    fail(f"server agreement ingest: {r.status}")
            launched = []
            for cluster in coord.clusters.all():
                launch = cluster.launch_tasks

                def record(pool, specs, _launch=launch):
                    launched.extend((s.job_uuid, s.hostname) for s in specs)
                    return _launch(pool, specs)

                cluster.launch_tasks = record
            for _ in range(cycles):
                n0 = len(launched)
                coord.match_cycle("default")
                coord.drain_resident("default")
                per.append(launched[n0:])
        finally:
            if api.ingest is not None:
                api.ingest.stop()
            coord.stop()
            shutil.rmtree(tmp, ignore_errors=True)
    return per


def server_phase(dev):
    """9: the server at bench_e2e's size (see the module docstring).
    Returns (stats, launches of the server's cycles at 1,024 and 8,192
    summed)."""
    import torch
    card = card_line()

    # C = 1,024: the sequential walk, exact_scan once a cycle
    def matched_enough(entries):
        return sum(1 for e in _kinds(entries, "consume")
                   if e.get("attrs", {}).get("matched")) >= SERVER_CYCLES

    read = {}

    def launched_jobs_read_running(store, entries, url):
        # no job launched twice, and every launched job reads running
        # or success through GET /jobs
        done = sum(e["attrs"]["matched"] for e in _kinds(entries,
                                                          "consume"))
        launched = [(j.uuid, j.user) for j in store.jobs.values()
                    for _ in j.instances]
        if len(launched) != done or len(set(launched)) != len(launched):
            fail(f"server: {len(launched)} instances for {done} launches")
        bad = get_states(url, launched, ("running", "success"))
        if bad:
            fail(f"server: launched jobs read {bad[:3]}")
        read["jobs_read"] = len(launched)

    r = run_server(dev, 1024, matched_enough, SERVER_MAX_S,
                   check=launched_jobs_read_running)
    matches, consumes = _kinds(r["entries"], "match"), \
        _kinds(r["entries"], "consume")
    seq_launches = r["launches"]
    if seq_launches["exact_scan"] != len(matches):
        fail(f"server: exact_scan launched {seq_launches['exact_scan']} "
             f"times in {len(matches)} cycles")
    if seq_launches["best_host"] or r["dense_rounds"]:
        fail("server at C=1024: a dense round ran")
    matched = [e["attrs"]["matched"] for e in consumes]
    done = 0
    for k, m in enumerate(matched):
        if SERVER_P - done >= 1024 and m != 1024:
            fail(f"server: consumed cycle {k} launched {m} of 1024 "
                 f"(overload level {r['overload_level']})")
        done += m

    def phase_ms(es, names):
        out = {}
        for n in names:
            xs = [p["ms"] for e in es for p in e["phases"]
                  if p["name"] == n]
            out[n] = _pct(xs)
        return out

    resyncs = [p["ms"] for e in matches for p in e["phases"]
               if p["name"] == "resync"]
    stats = {
        "C": 1024, "P": SERVER_P, "H": SERVER_H, "U": SERVER_U,
        "requests": len(server_requests()), "clients": SERVER_CLIENTS,
        "ingest_s": r["ingest_s"],
        "ingest_jobs_per_s": SERVER_P / r["ingest_s"],
        "cycles": len(matches), "consumed": len(consumes),
        "matched_per_cycle": matched,
        "launched": done, **read,
        "exact_scan_launches": seq_launches["exact_scan"],
        "match_cycle_ms": _pct([e["wall_ms"] for e in matches]),
        "consume_ms": _pct([e["wall_ms"] for e in consumes]),
        "match_cycle_ms_after_first": _pct(
            [e["wall_ms"] for e in matches[1:]]),
        "resync_ms": resyncs,
        "phase_ms": {**phase_ms(matches, ("drain", "ship", "dispatch",
                                          "queue_wait")),
                     **phase_ms(consumes, ("readback", "fold", "frame",
                                           "launch_txn", "bookkeep",
                                           "backend_launch"))},
        "overload_level": r["overload_level"],
        "card": card,
    }
    del r

    # C = 8,192: match_rounds, best_host once per dense round
    def dense_ran(entries):
        from cook_tpu_torch.ops import fused_match as fm
        return fm.LAUNCHES["best_host"] >= 1

    r = run_server(dev, C_BATCHED, dense_ran, SERVER_BATCHED_MAX_S,
                   n=SERVER_BATCHED_P)
    matches = _kinds(r["entries"], "match")
    b_launches = r["launches"]
    if b_launches["exact_scan"] != len(matches):
        fail(f"server at C=8192: exact_scan launched "
             f"{b_launches['exact_scan']} times in {len(matches)} cycles")
    if b_launches["best_host"] != r["dense_rounds"] or \
            not r["dense_rounds"]:
        fail(f"server at C=8192: best_host launched "
             f"{b_launches['best_host']} times in {r['dense_rounds']} "
             f"dense rounds")
    stats["batched"] = {
        "C": C_BATCHED, "P": SERVER_BATCHED_P, "ingest_s": r["ingest_s"],
        "ingest_jobs_per_s": SERVER_BATCHED_P / r["ingest_s"],
        "cycles": len(matches), "dense_rounds": r["dense_rounds"],
        "matched_per_cycle": [e["attrs"]["matched"] for e in
                              _kinds(r["entries"], "consume")],
        "match_cycle_ms": _pct([e["wall_ms"] for e in matches]),
        "kernel_launches": {k: v for k, v in b_launches.items() if v}}
    del r
    torch.cuda.synchronize()

    # the deterministic run on the card against the CPU path
    t0 = time.perf_counter()
    got = as_json(server_agreement(dev, SERVER_AGREE))
    want, _ = CPU_REFS.get("server")
    for c, (g, w) in enumerate(zip(got, want)):
        if g != w:
            fail(f"server agreement cycle {c}: "
                 + _first_launch_difference(g, w))
    if not sum(len(g) for g in got):
        fail("server agreement: nothing launched")
    stats["agreement"] = {"cycles": SERVER_AGREE,
                          "launched_per_cycle": [len(g) for g in got],
                          "s": time.perf_counter() - t0}
    launches = {k: seq_launches[k] + b_launches[k] for k in seq_launches}
    stats["kernel_launches"] = {k: v for k, v in launches.items() if v}
    print(json.dumps({"server": stats}), flush=True)
    return stats, launches


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def simulate(device):
    """Phase 10's simulator run: (run_trace_rows(), summary(), seconds)."""
    from cook_tpu_torch import e2e
    from cook_tpu_torch.sim import (SimConfig, Simulator, parse_hosts,
                                    parse_trace)
    from cook_tpu_torch.sim.gen import generate_hosts, generate_trace
    cfg = SimConfig()
    cfg.scheduler.rebalancer.safe_dru_threshold = 0.0
    cfg.scheduler.rebalancer.min_dru_diff = 0.0
    sim = Simulator(
        parse_trace(generate_trace(n_jobs=SIM_JOBS, n_users=SIM_USERS,
                                   seed=0)),
        parse_hosts(generate_hosts(SIM_HOSTS)), cfg, device=device)
    t = time.perf_counter()
    with e2e.pinned_clocks():
        summary = sim.run()
        rows = sim.run_trace_rows()
    return rows, summary, time.perf_counter() - t


def operator_phase(dev):
    """10: `python -m cook_tpu_torch.rest.server` as operators start it,
    and the simulator on the card against the CPU path (see the module
    docstring). Returns (stats, the card simulator's launches)."""
    import shutil
    import signal
    import tempfile
    import urllib.request
    import uuid
    from cook_tpu_torch.ops import fused_match as fm

    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="cook_smoke_boot_")
    port = _free_port()
    cfg = os.path.join(tmp, "cfg.json")
    with open(cfg, "w") as f:
        json.dump({"log_path": os.path.join(tmp, "events.log")}, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "cook_tpu_torch.rest.server", "--port",
         str(port), "--config", cfg], cwd=tmp, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    url = f"http://127.0.0.1:{port}"
    boot = {}
    try:
        while True:
            try:
                urllib.request.urlopen(url + "/info", timeout=2).close()
                break
            except OSError:
                if proc.poll() is not None:
                    fail(f"python -m server exited {proc.returncode}: "
                         f"{proc.stderr.read()[-2000:]}")
                if time.perf_counter() - t0 > SERVER_BOOT_S:
                    fail("python -m server never listened")
                time.sleep(0.2)
        boot["listen_s"] = time.perf_counter() - t0
        uuids = [str(uuid.UUID(int=(2 << 64) + i))
                 for i in range(SERVER_SMOKE_JOBS)]
        t1 = time.perf_counter()
        for u in uuids:
            req = urllib.request.Request(
                url + "/jobs", method="POST",
                data=json.dumps({"jobs": [{"uuid": u, "command": "true",
                                           "mem": 512, "cpus": 1}]}
                                ).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                if r.status != 201:
                    fail(f"python -m server: POST /jobs {r.status}")
        states = {}
        while time.perf_counter() - t1 < SERVER_BOOT_S:
            for u in uuids:
                with urllib.request.urlopen(f"{url}/jobs/{u}",
                                            timeout=10) as r:
                    states[u] = json.loads(r.read())["state"]
            if all(s in ("running", "success") for s in states.values()):
                break
            time.sleep(0.2)
        else:
            fail(f"python -m server: job states {sorted(states.values())}")
        boot["jobs_running_s"] = time.perf_counter() - t1
        boot["states"] = sorted(states.values())
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            fail("python -m server did not exit on SIGTERM")
        shutil.rmtree(tmp, ignore_errors=True)
    boot["exit_code"] = proc.returncode

    fm.reset_launches()
    rows, summary, card_s = simulate(dev)
    sim_launches = dict(fm.LAUNCHES)
    rows, summary = as_json([rows, summary])
    (cpu_rows, cpu_summary), cpu_s = CPU_REFS.get("simulator")
    if summary != cpu_summary:
        fail(f"simulator: summary on the card {summary} != CPU path "
             f"{cpu_summary}")
    if rows != cpu_rows:
        k = next(i for i, (a, b) in enumerate(zip(rows, cpu_rows))
                 if a != b) if len(rows) == len(cpu_rows) else "length"
        fail(f"simulator: run trace differs from the CPU path at row {k}")
    if summary["completed"] != SIM_JOBS or not sim_launches["exact_scan"]:
        fail(f"simulator: {summary['completed']} completed, launches "
             f"{sim_launches}")
    stats = {"python_m_server": boot,
             "simulator": {"jobs": SIM_JOBS, "users": SIM_USERS,
                           "hosts": SIM_HOSTS, "cycles": summary["cycles"],
                           "completed": summary["completed"],
                           "preemptions": summary["preemptions"],
                           "rows": len(rows), "card_s": card_s,
                           "cpu_s": cpu_s,
                           "kernel_launches": {k: v for k, v in
                                               sim_launches.items() if v}}}
    print(json.dumps(stats), flush=True)
    return stats, sim_launches

def par_scan_problem(rng, C, H, dev, groups=1, forb_pairs=0.0,
                     bonus=False):
    """C jobs x H hosts for the host-sharded scan: the resident cells'
    host and job mix (U(64, 256) GB x U(16, 64) cpus hosts, 5% gpu, each
    20-100% free; U(1, 10) GB x U(0.5, 4) cpu jobs, 1% gpu). Without
    groups 2% of the jobs forbid 5% of the hosts; with `groups`, jobs in
    one of them (unique placement) or none, `forb_pairs` of all pairs
    forbidden, and a U(0, 0.5) bonus when asked."""
    import torch
    from cook_tpu_torch.ops import match as match_ops

    gpu = rng.random(H) < 0.05
    cap_mem = rng.uniform(64, 256, H).astype(np.float32)
    cap_cpus = rng.uniform(16, 64, H).astype(np.float32)
    cap_gpus = np.where(gpu, rng.choice([4.0, 8.0], H), 0.0).astype(
        np.float32)
    free = rng.uniform(0.2, 1.0, H).astype(np.float32)
    hosts = match_ops.make_hosts(
        mem=cap_mem * free, cpus=cap_cpus * free, gpus=cap_gpus,
        cap_mem=cap_mem, cap_cpus=cap_cpus, cap_gpus=cap_gpus, device=dev)
    group = (rng.integers(-1, groups, C).astype(np.int32) if groups > 1
             else np.full(C, -1, np.int32))
    jobs = match_ops.make_jobs(
        mem=rng.uniform(1, 10, C).astype(np.float32),
        cpus=rng.uniform(0.5, 4, C).astype(np.float32),
        gpus=np.where(rng.random(C) < 0.01, 1.0, 0.0).astype(np.float32),
        group=group, unique_group=group >= 0, device=dev)
    if groups > 1:
        forb = rng.random((C, H)) < forb_pairs
    else:
        forb = (rng.random(C) < 0.02)[:, None] & (rng.random((C, H)) < 0.05)
    b = (torch.from_numpy(rng.uniform(0, 0.5, (C, H)).astype(np.float32))
         .to(dev) if bonus else None)
    return jobs, hosts, torch.from_numpy(forb).to(dev), b


def check_sharded_scan(got, want, label):
    """A host-sharded scan's result equal to the one-device match_scan's:
    job_host equal, every lane bit-equal once the shards are joined."""
    import torch
    if not torch.equal(got.job_host, want.job_host):
        bad = (got.job_host != want.job_host).nonzero()[:5].flatten()
        fail(f"sharded scan {label}: job_host differs at {bad.tolist()}")
    for k in ("mem_left", "cpus_left", "gpus_left", "slots_left"):
        lane = torch.cat(getattr(got, k))
        w = getattr(want, k)
        if lane.dtype == torch.float32:
            lane, w = lane.view(torch.int32), w.view(torch.int32)
        if not torch.equal(lane, w):
            fail(f"sharded scan {label}: {k} not bit-equal")
    n = int((got.job_host >= 0).sum())
    if n == 0:
        fail(f"sharded scan {label}: no job placed")
    return n


def timed(fn, reps, dev, warm=True):
    """Host-clock ms and CUDA-event ms of each of `reps` calls of `fn`
    (each ends in a readback), after one untimed call when `warm`."""
    import torch
    if warm:
        fn()
    host, event = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        t = time.perf_counter()
        fn()
        b.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
        event.append(a.elapsed_time(b))
    return {"host_ms": host, "event_ms": event,
            "host_ms_median": float(np.median(host)),
            "event_ms_median": float(np.median(event))}


def launches_and_syncs(fn):
    """Device launches (kernels and copies, by the profiler's CUDA
    activity alone: a sharded scan makes ~10^5) and host syncs (by
    source line, PyTorch's sync debug mode) of one `fn()`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from cook_tpu_torch.profile_cycle import sync_sources

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sources = sync_sources(fn)
        torch.cuda.synchronize()
    # the raw device events: no per-event Python objects to build
    n = sum(e.device_type() == DeviceType.CUDA
            for e in prof.profiler.kineto_results.events())
    return {"launches_per_call": n,
            "host_syncs_per_call": sum(sources.values()),
            "host_sync_sources": sources}


def par_costs(fn, reps, dev):
    """timed() of `fn` and launches_and_syncs() of one more call."""
    return {**timed(fn, reps, dev), **launches_and_syncs(fn)}


def parallel_phase(dev):
    """11: the multi-device paths on shards of the card (see the module
    docstring). Returns (stats, {path: kernel launch counts})."""
    import torch
    from cook_tpu_torch import e2e
    from cook_tpu_torch.entry import dryrun_multichip
    from cook_tpu_torch.ops import cycle as cycle_ops
    from cook_tpu_torch.ops import fused_match as fm
    from cook_tpu_torch.ops import match as match_ops
    from cook_tpu_torch.parallel import federation
    from cook_tpu_torch.parallel import pools as pool_par
    from cook_tpu_torch.parallel import sharded_match
    import bench_torch

    shards = [dev] * PAR_SHARDS
    stats = {"shards": PAR_SHARDS, "device_count": torch.cuda.device_count()}
    launches = {}

    # ---- the host-sharded scan at the sequential cell's C x H ----------
    C, H = PAR_SCAN_C, PAR_SCAN_H
    hmesh = sharded_match.make_host_mesh(devices=shards)
    jobs, hosts, forb, _ = par_scan_problem(np.random.default_rng(11), C,
                                            H, dev)
    scan = sharded_match.sharded_match_scan(hmesh)
    got = scan(jobs, hosts, forb)
    before = fm.LAUNCHES["exact_scan"]
    want = match_ops.match_scan(jobs, hosts, forb, use_kernel=True)
    if fm.LAUNCHES["exact_scan"] != before + 1:
        fail("the one-device scan beside the sharded one is not exact_scan")
    placed = check_sharded_scan(got, want, "plain")
    jg, hg, fg, bg = par_scan_problem(np.random.default_rng(12), C, H, dev,
                                      groups=PAR_GROUPS, forb_pairs=0.1,
                                      bonus=True)
    scan_g = sharded_match.sharded_match_scan(hmesh, num_groups=PAR_GROUPS,
                                              with_bonus=True)
    got_g = scan_g(jg, hg, fg, bg)
    before = dict(fm.LAUNCHES)
    want_g = match_ops.match_scan(jg, hg, fg, num_groups=PAR_GROUPS,
                                  bonus=bg, use_kernel=True)
    if {k: v - before[k] for k, v in fm.LAUNCHES.items() if v != before[k]} \
            != {"exact_scan/groups": 1}:
        fail("the grouped scan with a bonus beside the sharded one is not "
             "one exact_scan/groups launch")
    placed_g = check_sharded_scan(got_g, want_g, "groups+bonus")
    jh = got_g.job_host.cpu().numpy()
    grp = jg.group.cpu().numpy()
    for g in range(PAR_GROUPS):
        used = jh[(grp == g) & (jh >= 0)]
        if len(used) != len(set(used.tolist())):
            fail(f"sharded scan: unique group {g} shares a host")
    # one timed call (the first ran above), one counted
    fn = lambda: scan(jobs, hosts, forb).job_host.cpu()   # noqa: E731
    stats["sharded_scan"] = {
        "C": C, "H": H, "placed": placed, "placed_groups_bonus": placed_g,
        **timed(fn, 1, dev, warm=False), **launches_and_syncs(fn),
        "exact_scan_ms": cuda_ms(
            lambda: match_ops.match_scan(jobs, hosts, forb, use_kernel=True),
            5), "elapsed_s": time.perf_counter() - T_START}
    print(json.dumps({"parallel_sharded_scan": stats["sharded_scan"]}),
          flush=True)

    # ---- the pool-sharded cycle at bench.py::bench_pools' shape -------
    sp = PAR_POOLS
    n = sp["n_pools"]
    args = bench_torch.pools_setup(n, sp["R"], sp["P"], sp["H"], sp["U"],
                                   dev)
    kw = dict(num_considerable=sp["C"], sequential=False)
    one = pool_par.pool_sharded_cycle(
        pool_par.make_pool_mesh(devices=[dev]), **kw)
    four = pool_par.pool_sharded_cycle(
        pool_par.make_pool_mesh(devices=shards), **kw)
    r1 = one(args)
    torch.cuda.synchronize()
    fm.reset_launches()
    dense0 = match_ops.ROUNDS["dense"]
    r4 = four(args)
    torch.cuda.synchronize()
    launches["pools"] = dict(fm.LAUNCHES)
    dense = match_ops.ROUNDS["dense"] - dense0
    lp = launches["pools"]
    if lp["exact_scan"] != n or lp["blocked_cumsum"] < n \
            or lp["ordered_scatter"] < n or lp["best_host"] != dense \
            or off_route(lp):
        fail(f"pool-sharded cycle launches {lp} ({dense} dense rounds)")
    for f in cycle_ops.CycleResult._fields:
        if not torch.equal(getattr(r1.result, f), getattr(r4.result, f)):
            fail(f"pool-sharded cycle: {f} differs between one and "
                 f"{PAR_SHARDS} shards")
    for p in range(n):
        direct = cycle_ops.rank_and_match(
            *(None if a is None else
              match_ops.Hosts(*(x[p] for x in a)) if isinstance(a, tuple)
              else a[p] for a in args), use_kernel=True, **kw)
        for f in cycle_ops.CycleResult._fields:
            if not torch.equal(getattr(direct, f), getattr(r4.result, f)[p]):
                fail(f"pool-sharded cycle: pool {p} {f} differs from its "
                     f"own rank_and_match")
    jh = r4.result.job_host
    sums = [int((jh >= 0).sum()), int(r4.result.considerable.sum()),
            int(args[14].sum())]
    if [int(r4.stats.total_matched), int(r4.stats.total_considerable),
            int(r4.stats.total_pending)] != sums or not sums[0]:
        fail(f"pool-sharded totals {r4.stats} against counts {sums}")
    cpu0 = cycle_ops.rank_and_match(
        *(None if a is None else
          match_ops.Hosts(*(x[0].cpu() for x in a)) if isinstance(a, tuple)
          else a[0].cpu() for a in args), use_kernel=True, **kw)
    for f in cycle_ops.CycleResult._fields:
        if not torch.equal(getattr(cpu0, f), getattr(r4.result, f)[0].cpu()):
            fail(f"pool-sharded cycle: pool 0 {f} differs from the CPU path")
    # the federated 2 x 2 mesh over the same pools, as (2 slices, 4)
    fmesh = federation.make_federation_mesh(2, PAR_SHARDS // 2,
                                            devices=shards)
    fed = federation.federated_cycle(fmesh, **kw)
    fo = fed(federation.slice_args(args, 2))
    for f in cycle_ops.CycleResult._fields:
        x = getattr(fo.result, f)
        if not torch.equal(x.reshape((n,) + x.shape[2:]),
                           getattr(r4.result, f)):
            fail(f"federated cycle: {f} differs from the pool-sharded one")
    per_slice = [int((jh[:n // 2] >= 0).sum()), int((jh[n // 2:] >= 0).sum())]
    if fo.stats.per_slice_matched.tolist() != per_slice \
            or int(fo.stats.total_matched) != sums[0]:
        fail(f"federated totals {fo.stats} against {per_slice}")
    stats["pools"] = {
        **{k: v for k, v in sp.items()}, "matched_per_cycle": sums[0],
        "considered_per_cycle": sums[1], "dense_rounds": dense,
        "kernel_launches": lp,
        "one_device": timed(lambda: int(one(args).stats.total_matched),
                            PAR_TIMED, dev),
        f"{PAR_SHARDS}_shards": par_costs(
            lambda: int(four(args).stats.total_matched), PAR_TIMED, dev),
        "federated_2x2": timed(lambda: int(fed(federation.slice_args(
            args, 2)).stats.total_matched), PAR_TIMED, dev),
        "per_slice_matched": per_slice,
        "elapsed_s": time.perf_counter() - T_START}
    print(json.dumps({"parallel_pools": stats["pools"]}), flush=True)

    # ---- a resident pool sharded through the Coordinator ---------------
    def resident_run(shard_devices, label):
        with e2e.pinned_clocks():
            w = e2e.Workload(device=dev, durable=False, status_shards=0,
                             shard_devices=shard_devices, **E2E_SHAPE)
            try:
                per, host, event = [], [], []
                fm.reset_launches()
                for _ in range(PAR_RESIDENT_CYCLES):
                    n0 = len(w.launched)
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    torch.cuda.synchronize()
                    a.record()
                    t = time.perf_counter()
                    w.coord.match_cycle(e2e.POOL)
                    b.record()
                    torch.cuda.synchronize()
                    host.append((time.perf_counter() - t) * 1e3)
                    event.append(a.elapsed_time(b))
                    per.append(list(w.launched[n0:]))
                    w.advance()
                counts = dict(fm.LAUNCHES)
                rp = w.rp
                out = {"per_cycle": per, "host_ms": host, "event_ms": event,
                       "kernel_launches": counts}
                if shard_devices is not None:
                    blocks = rp.state["host"]
                    if list(rp.mesh.devices.flat) != shard_devices or [
                            h[k].device for h in blocks for k in h] != [
                            d for d, h in zip(shard_devices, blocks)
                            for _ in h]:
                        fail(f"{label}: a shard's host tensors are not on "
                             f"its device")
                    if [f.device for f in rp.state["forb"]] != shard_devices:
                        fail(f"{label}: a shard's mask rows are not on its "
                             f"device")

                    def one_cycle():
                        w.coord.match_cycle(e2e.POOL)
                        w.advance()

                    c = launches_and_syncs(one_cycle)
                    out["launches_per_cycle"] = c["launches_per_call"]
                    out["host_syncs_per_cycle"] = c["host_syncs_per_call"]
                    out["host_sync_sources"] = c["host_sync_sources"]
                out["setup_s"] = w.seed_s
                out["elapsed_s"] = time.perf_counter() - T_START
                return out
            finally:
                w.close()

    plain = resident_run(None, "resident pool, one device")
    sharded = resident_run(shards, "resident pool, sharded")
    launches["sharded"] = sharded.pop("kernel_launches")
    ls = launches["sharded"]
    if ls["exact_scan"] or ls["blocked_cumsum"] < PAR_RESIDENT_CYCLES \
            or ls["ordered_scatter"] < PAR_RESIDENT_CYCLES:
        fail(f"sharded resident cycles launched {ls}")
    for c, (g, h) in enumerate(zip(sharded["per_cycle"],
                                   plain["per_cycle"])):
        if g != h:
            fail(f"sharded resident cycle {c}: "
                 + _first_launch_difference(g, h))
    if not sum(len(x) for x in plain["per_cycle"]):
        fail("the resident cycles launched nothing")
    stats["sharded_pool"] = {
        **E2E_SHAPE, "C": 1024, "cycles": PAR_RESIDENT_CYCLES,
        "launched_per_cycle": [len(x) for x in sharded["per_cycle"]],
        "kernel_launches": ls,
        "one_device_host_ms": plain["host_ms"],
        "one_device_event_ms": plain["event_ms"],
        **{k: v for k, v in sharded.items() if k != "per_cycle"}}
    print(json.dumps({"parallel_sharded_pool": stats["sharded_pool"]}),
          flush=True)

    # ---- dryrun_multichip on shards of the card, and a real mesh -------
    t0 = time.perf_counter()
    dryrun_multichip(PAR_SHARDS, devices=shards)
    stats["dryrun_s"] = time.perf_counter() - t0
    nd = torch.cuda.device_count()
    if nd > 1:
        # the same paths over every visible card, held against the above
        real = sharded_match.sharded_match_scan(
            sharded_match.make_host_mesh(nd))
        if H % nd == 0:
            check_sharded_scan(real(jobs, hosts, forb), want,
                               f"{nd}-card mesh")
        if n % nd == 0:
            rn = pool_par.pool_sharded_cycle(pool_par.make_pool_mesh(nd),
                                             **kw)(args)
            for f in cycle_ops.CycleResult._fields:
                if not torch.equal(getattr(rn.result, f),
                                   getattr(r4.result, f)):
                    fail(f"pool-sharded cycle on {nd} cards: {f} differs")
        stats["real_mesh_devices"] = nd
    print(json.dumps({"parallel_dryrun_s": stats["dryrun_s"],
                      "device_count": nd}), flush=True)
    return stats, launches


def bench_phase(dev):
    """12: bench.py's remaining device entry points through
    bench_torch.py (see the module docstring). Returns ({mode: line},
    {mode: launch counts of its run})."""
    import torch

    import bench_torch
    from cook_tpu_torch import e2e
    from cook_tpu_torch.entry import HEAD_LADDER
    from cook_tpu_torch.ops import cycle as cycle_ops
    from cook_tpu_torch.ops import fused_match as fm
    from cook_tpu_torch.ops import match as match_ops

    out, launches = {}, {}

    def run(name, fn):
        t0 = time.perf_counter()
        fm.reset_launches()
        line = fn()
        launches[name] = dict(fm.LAUNCHES)
        out[name] = {"s": time.perf_counter() - t0,
                     "launches": launches[name], **line}
        return line

    def routes_agree(args, C, head, label):
        """The rung through the kernels against use_kernel=False (the
        walk and the dense rounds in PyTorch) on the same card tensors:
        job_host, mat_idx, mat_host and why_code bit for bit; exact_scan
        once where the head is above 0, best_host once a dense round."""
        got, ran = {}, {}
        for use_kernel in (True, False):
            before = dict(fm.LAUNCHES)
            dense = match_ops.ROUNDS["dense"]
            r = cycle_ops.rank_and_match(
                *args, num_considerable=C, sequential=False,
                use_kernel=use_kernel, match_kw=(("head_exact", head),))
            got[use_kernel] = {k: getattr(r, k).cpu().numpy() for k in (
                "job_host", "mat_idx", "mat_host", "why_code", "n_matched")}
            ran[use_kernel] = {k: fm.LAUNCHES[k] - before[k]
                               for k in ("exact_scan", "best_host")}
            ran[use_kernel]["dense_rounds"] = \
                match_ops.ROUNDS["dense"] - dense
        for k, v in got[True].items():
            if not np.array_equal(v, got[False][k]):
                fail(f"{label} head {head}: {k} of the kernels differs from "
                     f"use_kernel=False at "
                     f"{np.flatnonzero(v != got[False][k])[:8].tolist()}")
        k_ran = ran[True]
        if k_ran["exact_scan"] != (1 if head else 0) or \
                k_ran["best_host"] != k_ran["dense_rounds"] or \
                ran[False]["exact_scan"] or ran[False]["best_host"]:
            fail(f"{label} head {head}: launches {ran}")
        return {"head": head, "matched": int(got[True]["n_matched"]),
                "kernel_vs_plain_route": "bit-equal", **k_ran}

    # contended at the headline width: the ladder and its rung; the
    # rung and the top rung (the head-256 floor) held against the plain
    # route
    line = run("contended", lambda: bench_torch.bench_cycle(
        **BENCH_CONTENDED, label="100k-pending x 10k-offers, contended mix",
        contended=True, cycles=BENCH_CONTENDED_CYCLES, device=dev))
    head = line["adaptive_head_converged"]
    if not line["matched_per_cycle"] or off_route(launches["contended"]):
        fail(f"contended: {line['matched_per_cycle']} matched, launches "
             f"{launches['contended']}")
    args = bench_torch.cycle_setup(*(BENCH_CONTENDED[k] for k in "RPHU"),
                                   dev, contended=True)
    out["contended"]["routes"] = [
        routes_agree(args, BENCH_CONTENDED["C"], h, "contended")
        for h in sorted({head, HEAD_LADDER[-1]})]
    del args

    # ... and at the small shape, where the ladder climbs: the card's
    # ladder ends where the CPU path's does, with its inversions and its
    # job_host
    def contended_small():
        shape = [BENCH_CONTENDED_SMALL[k] for k in "RPHU"]
        C = BENCH_CONTENDED_SMALL["C"]
        card_args = bench_torch.cycle_setup(*shape, dev, contended=True)
        rung, inv, res = bench_torch.head_ladder(card_args, C,
                                                 use_kernel=True)
        cpu_args = bench_torch.cycle_setup(*shape, torch.device("cpu"),
                                           contended=True)
        want = bench_torch.head_ladder(cpu_args, C, use_kernel=True)
        if (rung, inv) != want[:2] or not np.array_equal(
                res.job_host.cpu().numpy(), want[2].job_host.numpy()):
            fail(f"contended small: the card's ladder ends at {rung} with "
                 f"{inv} inversions, the CPU path's at {want[:2]}, or "
                 f"job_host differs")
        if not rung:
            fail("contended small: the ladder ended at head 0")
        return {"adaptive_head_converged": rung,
                "head_window_inversions": inv,
                "equal_to_cpu_path": True,
                "shape": BENCH_CONTENDED_SMALL,
                "routes": routes_agree(card_args, C, rung,
                                       "contended small")}

    small = run("contended_small", contended_small)
    print(json.dumps({"bench_contended": {
        "converged_head": head,
        "head_window_inversions": line["head_window_inversions"],
        "matched_per_cycle": line["matched_per_cycle"],
        "routes": out["contended"]["routes"],
        "small": small}}), flush=True)

    # stream: 1,000,000 jobs at the headline width
    line = run("stream", lambda: bench_torch.bench_stream(
        total_jobs=BENCH_STREAM_JOBS, **{k: BENCH_CONTENDED[k]
                                         for k in "RPHUC"}, device=dev))
    if line["jobs_placed"] < BENCH_STREAM_JOBS:
        fail(f"stream placed {line['jobs_placed']} jobs")
    if not launches["stream"]["exact_scan"]:
        fail(f"stream: launches {launches['stream']}")

    # e2e-smoke at bench.py's shape, then its pools concurrently against
    # the same pools in turn, deterministic (clocks and uuids pinned,
    # statuses inline)
    line = run("e2e_smoke", lambda: bench_torch.bench_e2e(
        **BENCH_SMOKE, cycles=BENCH_SMOKE_CYCLES, warmup=BENCH_SMOKE_WARMUP,
        durability_check=True, device=dev,
        **bench_torch.smoke_knobs(**BENCH_SMOKE_KNOBS)))
    dur = line["durability_check"]
    if not (dur["acked_all_durable"] and dur["state_hash_match"]):
        fail(f"e2e-smoke durability: {dur}")
    K = BENCH_SMOKE_KNOBS["pools"]
    n_cycles = BENCH_SMOKE_CYCLES
    if launches["e2e_smoke"]["exact_scan"] < K * n_cycles or \
            launches["e2e_smoke"]["best_host"]:
        fail(f"e2e-smoke: launches {launches['e2e_smoke']} in {n_cycles} "
             f"cycles of {K} pools")
    t0 = time.perf_counter()
    traces = {conc: e2e.launch_trace(
        dev, BENCH_SMOKE_AGREE, concurrent=conc, durable=True,
        **BENCH_SMOKE, **BENCH_SMOKE_KNOBS) for conc in (True, False)}
    for name in traces[True]["per_pool"]:
        for c, (a, b) in enumerate(zip(traces[True]["per_pool"][name],
                                       traces[False]["per_pool"][name])):
            if a != b:
                fail(f"e2e-smoke pool {name} cycle {c}: "
                     + _first_launch_difference(
                         a, b, ("concurrent", "in turn")))
        if not sum(map(len, traces[True]["per_pool"][name])):
            fail(f"e2e-smoke pool {name} launched nothing")
    for conc, tr in traces.items():
        d = tr["durability"]
        if not (d["acked_all_durable"] and d["state_hash_match"]):
            fail(f"e2e-smoke deterministic run (concurrent {conc}) "
                 f"durability: {d}")
    out["e2e_smoke"]["concurrent_vs_in_turn"] = {
        "cycles": BENCH_SMOKE_AGREE, "equal": True,
        "launched_per_pool": {p: sum(map(len, v)) for p, v in
                              traces[True]["per_pool"].items()},
        "completed": traces[True]["completed"],
        # the same deterministic cycles, K threads against one thread
        "cycle_ms_median": {
            "concurrent": float(np.median(traces[True]["cycle_ms"])),
            "in_turn": float(np.median(traces[False]["cycle_ms"]))},
        "cycle_ms": {"concurrent": traces[True]["cycle_ms"],
                     "in_turn": traces[False]["cycle_ms"]},
        "s": time.perf_counter() - t0}
    print(json.dumps({"bench_e2e_smoke_concurrent_vs_in_turn":
                      out["e2e_smoke"]["concurrent_vs_in_turn"]}),
          flush=True)

    # e2e-batched: match_rounds at C = 1024 (sequential_threshold 512)
    line = run("e2e_batched", lambda: bench_torch.bench_e2e(
        **BENCH_BATCHED, cycles=BENCH_BATCHED_CYCLES,
        warmup=BENCH_BATCHED_WARMUP, sequential_threshold=512,
        label="e2e coordinator @ 100k-pending x 10k-offers, batched "
              "matcher", device=dev))
    n_cycles = BENCH_BATCHED_CYCLES
    if line["sequential"] or \
            launches["e2e_batched"]["exact_scan"] < n_cycles:
        fail(f"e2e-batched: sequential {line['sequential']}, launches "
             f"{launches['e2e_batched']}")
    if not launches["e2e_batched"]["best_host"]:
        print(json.dumps({"e2e_batched_note": "no dense round ran"}),
              flush=True)
    return out, launches


# ---- 13. agents, kube and failover ----------------------------------------
def _wait(cond, max_s, what, poll=0.02, report=None):
    """Poll `cond()` until true, then print the seconds it took; fail
    after `max_s` seconds, with `report()` when given."""
    t0 = time.perf_counter()
    while True:
        v = cond()
        if v:
            print(json.dumps({"waited": what,
                              "s": time.perf_counter() - t0}), flush=True)
            return v
        if time.perf_counter() - t0 > max_s:
            fail(f"{what}: not within {max_s} s"
                 + (f"; {report()}" if report else ""))
        time.sleep(poll)


def _agents_report(cluster, store, uuids):
    """Where `uuids` stand, and each agent's liveness and tracked use."""
    states = {}
    for u in uuids:
        key = tuple((i.hostname, i.status.name, i.reason_code)
                    for i in store.get_job(u).instances)[-1:]
        states[str(key)] = states.get(str(key), 0) + 1
    agents = {h: (a.alive, cluster._used.get(h, [0, 0])[1], a.cpus)
              for h, a in list(cluster.agents.items())}
    busy = {h: v for h, v in agents.items() if not v[0] or v[1]}
    return json.dumps({"jobs_by_last_instance": states,
                       "agents_dead_or_used": busy,
                       "liveness": cluster.liveness.counts()
                       if cluster.liveness else None})


def _child_env(here):
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("PYTHONSTARTUP", None)
    return env


def _log_tail(path, n=2000):
    try:
        with open(path, "rb") as f:
            return f.read()[-n:].decode(errors="replace")
    except OSError:
        return ""


class AgentFleet:
    """`n_sub` `python -m cook_tpu_torch.agent` processes, then `n_in`
    in-process AgentDaemons, registered with `url` one by one in that
    order (each waits until `cluster` knows it), every agent AGENT_CPUS
    x AGENT_MEM."""

    def __init__(self, url, cluster, tmp, n_sub, n_in):
        from cook_tpu_torch.agent.daemon import AgentDaemon
        here = os.path.dirname(os.path.abspath(__file__))
        self.procs, self.daemons, self.tmp = {}, [], tmp
        self.hostnames = [f"sub-{k}" for k in range(n_sub)] + \
            [f"agent-{k:02d}" for k in range(n_in)]
        try:
            for h in self.hostnames[:n_sub]:
                log = open(os.path.join(tmp, f"{h}.log"), "wb")
                self.procs[h] = proc = subprocess.Popen(
                    [sys.executable, "-m", "cook_tpu_torch.agent",
                     "--coordinator", url, "--hostname", h,
                     "--mem", str(AGENT_MEM), "--cpus", str(AGENT_CPUS),
                     "--sandbox-root", os.path.join(tmp, h),
                     "--heartbeat-interval", str(AGENTS_HEARTBEAT_S),
                     "--agent-token", AGENT_TOKEN],
                    cwd=tmp, env=_child_env(here), stdout=log,
                    stderr=subprocess.STDOUT)
                log.close()

                def registered(h=h, proc=proc):
                    if proc.poll() is not None:
                        fail(f"agent {h} exited {proc.returncode}: "
                             + self.log(h))
                    return h in cluster.agents
                _wait(registered, 60, f"agent {h} registers")
            for h in self.hostnames[n_sub:]:
                # start() returns once registered
                self.daemons.append(AgentDaemon(
                    url, hostname=h, mem=AGENT_MEM, cpus=AGENT_CPUS,
                    sandbox_root=os.path.join(tmp, h),
                    heartbeat_interval_s=AGENTS_HEARTBEAT_S,
                    agent_token=AGENT_TOKEN).start())
        except BaseException:
            self.stop()
            raise
        if list(cluster.agents) != self.hostnames:
            fail("agents: registered out of order")

    def log(self, h):
        return _log_tail(os.path.join(self.tmp, f"{h}.log"))

    def stop(self):
        # together: each daemon's stop waits out its HTTP server's poll
        # (0.5 s), 30 s for 60 daemons one by one
        from concurrent.futures import ThreadPoolExecutor
        if self.daemons:
            with ThreadPoolExecutor(len(self.daemons)) as ex:
                list(ex.map(lambda d: d.stop(), self.daemons))
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.terminate()
        for proc in self.procs.values():
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def agents_config(tmp, consider):
    """The agent leg's server: one cluster of kind "agent" with a token,
    the default pool and the server's defaults (resident match, its
    pipeline and status shards), a durable log, no overload ladder."""
    return {"clusters": [{"kind": "agent", "name": "agents",
                          "agent_heartbeat_timeout_s": AGENTS_LEASE_S}],
            "auth": {"scheme": "header", "agent_token": AGENT_TOKEN},
            "log_path": os.path.join(tmp, "events.log"),
            "scheduler": {"max_jobs_considered": consider,
                          "match_interval_s": SERVER_INTERVAL_S,
                          "overload_enabled": False}}


def _job_specs(n, first, command, users, **kw):
    """{user: [spec]}: n jobs (1 cpu, 64 MB unless `kw` says) of
    `command`, uuids from `first`, dealt to `users` users in turn."""
    import uuid
    out = {}
    for i in range(n):
        out.setdefault(f"u{i % users}", []).append(
            {"uuid": str(uuid.UUID(int=(3 << 64) + first + i)),
             "command": command, "mem": 64.0, "cpus": 1.0, **kw})
    return out


def _terminal(store, uuids):
    """True once every job of `uuids` is completed."""
    return all(store.get_job(u).state.name == "COMPLETED" for u in uuids)


def _tasks_done(store, uuids):
    """True once no instance of `uuids` is still staged or running."""
    return all(i.status.name in ("SUCCESS", "FAILED")
               for u in uuids for i in store.get_job(u).instances)


def agents_run(device, full, n_sub=AGENTS_SUB, n_in=AGENTS_INPROC,
               jobs=AGENTS_JOBS, consider=AGENTS_C):
    """The agent leg on `device`. The fleet registers in a fixed order,
    the backlog of `true` jobs is POSTed through JobClient in bulk, and
    AGENTS_AGREE cycles are driven by hand with clocks and uuids pinned,
    each waiting until its tasks ended (on the card the first under the
    profiler, the second under the sync debug mode). Returns their
    launches, {job uuid: hostname} a cycle; with `full`, the rest of the
    run's numbers (see the module docstring, phase 13) too."""
    import shutil
    import tempfile
    import torch
    from cook_tpu_torch import e2e, obs
    from cook_tpu_torch.client import JobClient
    from cook_tpu_torch.ops import fused_match as fm
    from cook_tpu_torch.profile_cycle import profile_calls, sync_sources
    from cook_tpu_torch.rest.server import (ApiServer, apply_gc_discipline,
                                            build_scheduler)
    here = os.path.dirname(os.path.abspath(__file__))
    on_card = torch.device(device).type == "cuda"
    tmp = tempfile.mkdtemp(prefix="cook_smoke_agents_")
    stats, per = {}, []
    pin = e2e.pinned_clocks()
    pin.__enter__()
    pinned, stopped = True, False
    fleet = server = None
    store, coord, api = build_scheduler(agents_config(tmp, consider),
                                        device=device)
    try:
        server = ApiServer(api).start()
        (cluster,) = coord.clusters.all()
        t0 = time.perf_counter()
        fleet = AgentFleet(server.url, cluster, tmp, n_sub, n_in)
        stats["fleet_register_s"] = time.perf_counter() - t0
        launched = {}
        launch = cluster.launch_tasks

        def record(pool, specs):
            for s in specs:
                launched[s.job_uuid] = s.hostname
            return launch(pool, specs)

        cluster.launch_tasks = record
        backlog = _job_specs(jobs, 0, "true", AGENTS_USERS)
        uuids = [s["uuid"] for u in sorted(backlog) for s in backlog[u]]
        t_first_post = time.perf_counter()
        for user in sorted(backlog):
            JobClient(server.url, user=user).submit_jobs_bulk(backlog[user])
        if on_card:
            fm.reset_launches()

        def one():
            coord.match_cycle("default")
            coord.drain_resident("default")

        hand_ms = []
        for c in range(AGENTS_AGREE):
            launched.clear()
            t = time.perf_counter()
            if on_card and c == 0:
                _, kernels, _, wall = profile_calls(one, 1)
                busy = sum(k[1] for k in kernels)
                stats["launches_per_cycle"] = sum(k[2] for k in kernels)
                stats["device_busy_ms_per_cycle"] = busy
                stats["device_idle_share"] = 1.0 - busy / wall
            elif on_card:
                sources = sync_sources(one)
                stats["host_syncs_per_cycle"] = sum(sources.values())
                stats["host_sync_sources"] = sources
            else:
                one()
            hand_ms.append((time.perf_counter() - t) * 1e3)
            per.append(dict(launched))
            print(json.dumps({"agents_hand_cycle": c, "device": str(device),
                              "ms": hand_ms[-1],
                              "launched": len(launched)}), flush=True)
            _wait(lambda: _tasks_done(store, uuids), 120,
                  f"agents on {device}: cycle {c}'s tasks end",
                  report=lambda: _agents_report(cluster, store, uuids))
        pin.__exit__(None, None, None)
        pinned = False
        if not full:
            return per, stats
        stats["hand_cycle_ms"] = hand_ms
        if sum(len(p) for p in per) != jobs:
            fail(f"agents: the {AGENTS_AGREE} hand-driven cycles launched "
                 f"{[len(p) for p in per]} of {jobs}")

        # the sleepers, the cs CLI's jobs, one job that exits 3. A
        # sleeper takes all but one cpu of an agent, so each agent runs
        # one (the subprocess agents too) and the small jobs fit beside
        sleepers = _job_specs(AGENTS_SLEEPERS, jobs,
                              f"sleep {AGENTS_SLEEP_S}", 4, max_retries=2,
                              cpus=AGENT_CPUS - 1)
        sleep_uuids = [s["uuid"] for u in sorted(sleepers)
                       for s in sleepers[u]]
        for user in sorted(sleepers):
            JobClient(server.url, user=user).submit_jobs_bulk(
                sleepers[user])
        (bad,) = _job_specs(1, jobs + AGENTS_SLEEPERS, "exit 3", 1,
                            max_retries=1)["u0"]
        JobClient(server.url, user="u0").submit_jobs([bad])
        cs_cfg = os.path.join(tmp, "cs.json")
        with open(cs_cfg, "w") as f:
            json.dump({}, f)
        raw = os.path.join(tmp, "cli_jobs.json")
        with open(raw, "w") as f:
            json.dump([{"command": f"echo cli-{k}"}
                       for k in range(AGENTS_CLI_JOBS)], f)
        cli = subprocess.run(
            [sys.executable, "-m", "cook_tpu_torch.cli", "--config",
             cs_cfg, "--url", server.url, "--user", "cli", "submit",
             "--mem", "64", "--raw", raw], cwd=tmp, env=_child_env(here),
            capture_output=True, text=True, timeout=120)
        cli_uuids = cli.stdout.split()
        if cli.returncode != 0 or len(cli_uuids) != AGENTS_CLI_JOBS:
            fail(f"cs submit exited {cli.returncode}: {cli.stdout[-500:]} "
                 f"{cli.stderr[-1000:]}")
        everything = uuids + sleep_uuids + [bad["uuid"]] + cli_uuids

        entries = []
        obs.profiler.add_listener(entries.append)
        apply_gc_discipline()
        start_cycles(coord)

        def sleepers_on_subprocess_agents():
            # every sleeper launched, and {subprocess agent: [sleepers
            # running there]} once one runs any (an in-process agent
            # the server's GIL starved past its lease fails its
            # sleeper mea culpa, which then waits for a free agent)
            if not all(store.get_job(u).instances for u in sleep_uuids):
                return None
            on = {}
            for u in sleep_uuids:
                i = store.get_job(u).instances[-1]
                if i.status.name == "RUNNING" and i.hostname in fleet.procs:
                    on.setdefault(i.hostname, []).append(u)
            return on
        on_host = _wait(sleepers_on_subprocess_agents, 60,
                        "agents: the sleepers run",
                        report=lambda: _agents_report(cluster, store,
                                                      sleep_uuids))
        # the subprocess agent running the most sleepers dies
        victim = max(on_host, key=lambda h: len(on_host[h]))
        victims = on_host[victim]
        n0 = {u: len(store.get_job(u).instances) for u in victims}
        t_kill = time.perf_counter()
        fleet.procs[victim].kill()
        fleet.procs[victim].wait(timeout=10)
        _wait(lambda: all(store.get_job(u).instances[n0[u] - 1].status.name
                          == "FAILED" for u in victims), 60,
              "agents: the killed agent's tasks fail")
        kill_to_lost_s = time.perf_counter() - t_kill
        _wait(lambda: all(len(store.get_job(u).instances) > n0[u]
                          for u in victims), 60,
              "agents: the killed agent's tasks launch again")
        kill_to_retry_s = time.perf_counter() - t_kill
        _wait(lambda: _terminal(store, everything), AGENTS_MAX_S,
              "agents: every job completes",
              report=lambda: _agents_report(cluster, store, everything))
        t_done = time.perf_counter()
        # once: a second stop would wait on a cycle its first left in
        # flight, with no consumer left to take it
        coord.stop()
        stopped = True
        obs.profiler.remove_listener(entries.append)
        launches = dict(fm.LAUNCHES)

        # every job in its expected state
        for u in uuids + cli_uuids:
            j = store.get_job(u)
            if not j.success or j.instances[-1].status.name != "SUCCESS":
                ins = [(i.status.name, i.reason_code) for i in j.instances]
                fail(f"agents: job {u} ended {j.state.name} {ins}")
        for u in sleep_uuids:
            j = store.get_job(u)
            ins = [(i.hostname, i.status.name, i.reason_code)
                   for i in j.instances]
            if not j.success or (u in victims and (
                    ins[n0[u] - 1] != (victim, "FAILED", 5000)
                    or ins[-1][0] == victim)):
                fail(f"agents: sleeper {u} ended {j.state.name} {ins}")
        j = store.get_job(bad["uuid"])
        ins = [(i.status.name, i.exit_code, i.reason_code)
               for i in j.instances]
        if j.success or [x for x in ins if x[2] != 5000] != [
                ("FAILED", 3, 1003)]:
            fail(f"agents: the exit-3 job ended {ins}")

        matches = [e for e in entries if e["kind"] == "match"]
        placing = [e["wall_ms"] for e in entries if e["kind"] == "consume"
                   and e.get("attrs", {}).get("matched")]
        cycles = AGENTS_AGREE + len(matches)
        if launches["exact_scan"] < AGENTS_AGREE + len(placing):
            fail(f"agents: exact_scan launched {launches['exact_scan']} "
                 f"times for {AGENTS_AGREE + len(placing)} placing cycles")
        stats.update({
            "agents": len(fleet.hostnames), "subprocess_agents": n_sub,
            "C": consider, "jobs": len(everything),
            "jobs_per_s": len(everything) / (t_done - t_first_post),
            "first_post_to_last_terminal_s": t_done - t_first_post,
            "cycles": cycles,
            "cycle_ms": _pct([e["wall_ms"] for e in matches]),
            "placing_consume_ms": _pct(placing),
            "killed": victim, "killed_tasks": len(victims),
            "kill_to_tasks_lost_s": kill_to_lost_s,
            "kill_to_retried_launches_s": kill_to_retry_s,
            "exact_scan_launches": launches["exact_scan"],
            "kernel_launches": {k: v for k, v in launches.items() if v}})
        return per, stats, launches
    finally:
        if pinned:
            pin.__exit__(None, None, None)
        if fleet is not None:
            fleet.stop()
        if server is not None:
            server.stop()
        if api.ingest is not None:
            api.ingest.stop()
        if not stopped:
            coord.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def kube_leg(dev, nodes=KUBE_NODES, jobs=KUBE_JOBS):
    """The server with one cluster of kind "kube" whose kube_url is the
    port's ApiServerStandIn over `nodes` nodes, KubeletSim binding,
    starting and finishing the pods: every job must succeed, exact_scan
    launch. Returns (stats, launches)."""
    import shutil
    import tempfile
    from cook_tpu_torch import obs
    from cook_tpu_torch.backends.kube import FakeKube, Node
    from cook_tpu_torch.backends.kube.standin import (ApiServerStandIn,
                                                      KubeletSim)
    from cook_tpu_torch.client import JobClient
    from cook_tpu_torch.ops import fused_match as fm
    from cook_tpu_torch.rest.server import ApiServer, build_scheduler
    tmp = tempfile.mkdtemp(prefix="cook_smoke_kube_")
    standin = ApiServerStandIn(FakeKube([
        Node(f"node{i}", mem=32_768.0, cpus=8.0) for i in range(nodes)]))
    sim = KubeletSim(standin.fake, interval_s=0.1,
                     runtime_s=KUBE_RUNTIME_S).start()
    store, coord, api = build_scheduler({
        "clusters": [{"kind": "kube", "name": "kube",
                      "kube_url": standin.url}],
        "auth": {"scheme": "header"},
        "log_path": os.path.join(tmp, "events.log"),
        "scheduler": {"max_jobs_considered": AGENTS_C,
                      "match_interval_s": SERVER_INTERVAL_S,
                      "overload_enabled": False}}, device=dev)
    server = ApiServer(api).start()
    entries = []
    stopped = False
    try:
        backlog = _job_specs(jobs, 1 << 20, "true", AGENTS_USERS)
        uuids = [s["uuid"] for u in sorted(backlog) for s in backlog[u]]
        t0 = time.perf_counter()
        for user in sorted(backlog):
            JobClient(server.url, user=user).submit_jobs_bulk(backlog[user])
        obs.profiler.add_listener(entries.append)
        fm.reset_launches()
        start_cycles(coord)
        _wait(lambda: _terminal(store, uuids), KUBE_MAX_S,
              "kube: every job completes")
        dt = time.perf_counter() - t0
        coord.stop()
        stopped = True
        obs.profiler.remove_listener(entries.append)
        launches = dict(fm.LAUNCHES)
        failed = [store.get_job(u) for u in uuids
                  if not store.get_job(u).success]
        if failed:
            ins = [(i.status.name, i.reason_code)
                   for i in failed[0].instances]
            fail(f"kube: {len(failed)} jobs failed, e.g. {ins}")
        if not launches["exact_scan"]:
            fail("kube: exact_scan never launched")
        matches = [e for e in entries if e["kind"] == "match"]
        return {"nodes": nodes, "jobs": jobs, "C": AGENTS_C,
                "pod_runtime_s": KUBE_RUNTIME_S,
                "first_post_to_last_success_s": dt,
                "jobs_per_s": jobs / dt, "cycles": len(matches),
                "cycle_ms": _pct([e["wall_ms"] for e in matches]),
                "pods_listed": standin.list_counts,
                "exact_scan_launches": launches["exact_scan"],
                "kernel_launches": {k: v for k, v in launches.items()
                                    if v}}, launches
    finally:
        server.stop()
        if api.ingest is not None:
            api.ingest.stop()
        if not stopped:
            coord.stop()
        sim.stop()
        cluster = next(iter(coord.clusters.all()))
        cluster.api.stop()
        standin.close()
        shutil.rmtree(tmp, ignore_errors=True)


def failover_leg(dev_name="cuda"):
    """Two servers on the card race for a Lease on the port's stand-in
    and share one durable log; one agent carries both URLs. The leader
    is SIGKILLed with jobs running and waiting: the standby takes the
    lease, replays the log, rebuilds its resident pool and places the
    rest. Returns (stats, the survivor's launches)."""
    import shutil
    import signal
    import tempfile
    import urllib.request
    from cook_tpu_torch.backends.kube.standin import ApiServerStandIn
    from cook_tpu_torch.client import JobClient
    from tests.torch_livestack import incarnations
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="cook_smoke_failover_")
    lease = ApiServerStandIn()
    ports = [_free_port(), _free_port()]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    procs, logs = [], []

    def info(url):
        try:
            with urllib.request.urlopen(url + "/info", timeout=2) as r:
                return json.loads(r.read())
        except (OSError, ValueError):
            return None

    def spawn(k):
        cfg = os.path.join(tmp, f"server{k}.json")
        with open(cfg, "w") as f:
            json.dump({
                "port": ports[k], "url": urls[k],
                "clusters": [{"kind": "agent", "name": "agents",
                              "agent_heartbeat_timeout_s": AGENTS_LEASE_S}],
                "auth": {"scheme": "header", "agent_token": AGENT_TOKEN},
                "leader_lease_url": lease.url,
                "leader_lease_duration_s": 2.0,
                "log_path": os.path.join(tmp, "shared-eventlog"),
                "scheduler": {"max_jobs_considered": AGENTS_C,
                              "match_interval_s": SERVER_INTERVAL_S}}, f)
        logs.append(os.path.join(tmp, f"server{k}.log"))
        out = open(logs[-1], "wb")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cook_tpu_torch.rest.server", "--device",
             dev_name, "--config", cfg], cwd=tmp, env=_child_env(here), stdout=out,
            stderr=subprocess.STDOUT))
        out.close()

    def up(k, leader):
        def ok():
            if procs[k].poll() is not None:
                fail(f"failover: server {k} exited {procs[k].returncode}: "
                     + _log_tail(logs[k]))
            i = info(urls[k])
            return i is not None and (not leader or i.get("is-leader"))
        return ok

    def one_leader():
        # both answer, and the lease made exactly one of them leader
        if not (up(0, False)() and up(1, False)()):
            return None
        lead = [k for k in (0, 1)
                if (info(urls[k]) or {}).get("is-leader")]
        return lead if len(lead) == 1 else None

    try:
        t0 = time.perf_counter()
        spawn(0)
        spawn(1)
        (lead,) = _wait(one_leader, SERVER_BOOT_S,
                        "failover: both servers up, one leader", poll=0.1)
        standby = 1 - lead
        boot_s = time.perf_counter() - t0
        agent_log = os.path.join(tmp, "agent.log")
        out = open(agent_log, "wb")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cook_tpu_torch.agent", "--coordinator",
             ",".join(urls), "--hostname", "ha-agent", "--mem",
             str(AGENT_MEM), "--cpus", str(FAILOVER_AGENT_CPUS),
             "--sandbox-root", os.path.join(tmp, "sandboxes"),
             "--heartbeat-interval", str(AGENTS_HEARTBEAT_S),
             "--agent-token", AGENT_TOKEN], cwd=tmp, env=_child_env(here),
            stdout=out, stderr=subprocess.STDOUT))
        out.close()
        client = JobClient(urls[lead], user="u0")
        backlog = _job_specs(FAILOVER_JOBS, 1 << 21, "sleep 1", 1)["u0"]
        uuids = client.submit_jobs_bulk(backlog)

        def started():
            jobs = client.query_jobs(uuids)
            return sum(j.status == "running" for j in jobs) \
                >= FAILOVER_AGENT_CPUS
        _wait(started, 60, "failover: the first jobs run", poll=0.1)
        kill_ms = time.time() * 1e3
        t_kill = time.perf_counter()
        procs[lead].send_signal(signal.SIGKILL)
        procs[lead].wait(timeout=10)
        _wait(up(standby, True), 60, "failover: the standby takes over",
              poll=0.05)
        takeover_s = time.perf_counter() - t_kill
        survivor = JobClient(urls[standby], user="u0")

        def done():
            try:
                jobs = survivor.query_jobs(uuids)
            except Exception:
                return None
            return jobs if all(j.status == "completed" for j in jobs) \
                else None
        def report():
            try:
                states = sorted((j.status, j.state, len(j.instances))
                                for j in survivor.query_jobs(uuids))
            except Exception as e:
                states = repr(e)
            return (f"jobs (status, state, instances): {states}; the "
                    f"survivor's log: {_log_tail(logs[standby])}; the "
                    f"agent's: {_log_tail(agent_log, 800)}")
        jobs = _wait(done, FAILOVER_MAX_S, "failover: every job completes",
                     poll=0.2, report=report)
        bad = [(j.uuid, j.state) for j in jobs if j.state != "success"]
        if bad:
            fail(f"failover: jobs ended {bad[:3]}")
        after = [i.start_time for j in jobs for i in j.instances
                 if i.start_time and i.start_time >= kill_ms]
        if not after:
            fail("failover: the survivor launched nothing")
        procs[standby].send_signal(signal.SIGTERM)
        procs[standby].wait(timeout=60)
        counted = [i["kernel_launches"] for i in incarnations(logs[standby])
                   if i["kernel_launches"] is not None]
        if not counted:
            fail("failover: the survivor wrote no launch counts: "
                 + _log_tail(logs[standby]))
        launches = counted[-1]
        if not launches["exact_scan"]:
            fail("failover: the survivor never launched exact_scan")
        return {"jobs": FAILOVER_JOBS, "agent_cpus": FAILOVER_AGENT_CPUS,
                "boot_s": boot_s, "kill_to_takeover_s": takeover_s,
                "kill_to_first_launch_ms": min(after) - kill_ms,
                "instances": sum(len(j.instances) for j in jobs),
                "survivor_exact_scan_launches": launches["exact_scan"],
                "survivor_kernel_launches": {k: v for k, v in
                                             launches.items() if v}
                }, launches
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        lease.close()
        shutil.rmtree(tmp, ignore_errors=True)


def agents_phase(dev):
    """13: the agent, kube and failover legs (see the module
    docstring). Returns (stats, launches by leg)."""
    t0 = time.perf_counter()
    want, _ = agents_run("cpu", full=False)
    got, stats, agent_launches = agents_run(dev, full=True)
    for c, (g, w) in enumerate(zip(got, want)):
        if g != w:
            diff = sorted(u for u in set(g) | set(w) if g.get(u) != w.get(u))
            fail(f"agents agreement cycle {c}: {len(diff)} jobs differ, "
                 f"e.g. {diff[0]}: card {g.get(diff[0])} CPU path "
                 f"{w.get(diff[0])}")
    stats["agreement"] = {"cycles": AGENTS_AGREE,
                          "launched_per_cycle": [len(g) for g in got]}
    stats["leg_s"] = time.perf_counter() - t0
    print(json.dumps({"agents": stats}), flush=True)
    t0 = time.perf_counter()
    kube, kube_launches = kube_leg(dev)
    kube["leg_s"] = time.perf_counter() - t0
    print(json.dumps({"kube": kube}), flush=True)
    t0 = time.perf_counter()
    fo, fo_launches = failover_leg()
    fo["leg_s"] = time.perf_counter() - t0
    print(json.dumps({"failover": fo}), flush=True)
    return ({"agents": stats, "kube": kube, "failover": fo},
            {"agents": agent_launches, "kube": kube_launches,
             "failover": fo_launches})


def _traced_syncs(obj, label, into):
    """Every `host_sync_sources` an earlier phase's output holds, by
    where it sits in that output."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            if k == "host_sync_sources" and isinstance(v, dict):
                into[label] = v
            else:
                _traced_syncs(v, f"{label}.{k}", into)
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            _traced_syncs(v, f"{label}.{i}", into)
    return into


def analysis_phase(dev, traced_phases):
    """14: the port's cookcheck against the syncs the card traces, and
    bench_torch.py's ingest and fleet (see the module docstring).
    `traced_phases` are earlier phases' outputs ({name: output}): their
    traced syncs join this phase's. Returns (stats, launches by
    path)."""
    import torch

    import bench_torch
    from cook_tpu_torch.analysis import analyze_paths
    from cook_tpu_torch.entry import resident_workload
    from cook_tpu_torch.ops import fused_match as fm
    from cook_tpu_torch.profile_cycle import sync_sources

    here = os.path.dirname(os.path.abspath(__file__))
    stats, launches = {}, {}
    # ---- R1 against the traced syncs ------------------------------------
    traced = {}
    for name, kw in (("sequential", {}), ("batched", {"C": C_BATCHED})):
        w = resident_workload(device=dev, seed=0, **kw)
        w.cycle(use_kernel=True)
        torch.cuda.synchronize()
        fm.reset_launches()
        traced[f"resident_{name}"] = sync_sources(
            lambda: w.cycle(use_kernel=True))
        launches[f"analysis_{name}"] = dict(fm.LAUNCHES)
        if launches[f"analysis_{name}"]["exact_scan"] != 1:
            fail(f"analysis {name} cycle: exact_scan launched "
                 f"{launches[f'analysis_{name}']['exact_scan']} times")
        del w
    for name, out in traced_phases.items():
        _traced_syncs(out, name, traced)
    if not {"e2e.sequential", "e2e.batched"} <= set(traced):
        fail(f"analysis: the e2e phase's traced syncs are missing "
             f"({sorted(traced)})")
    # the rebalance phase fails on any sync a sweep traces
    traced["rebalance"] = {}
    t0 = time.perf_counter()
    found = analyze_paths([os.path.join(here, "cook_tpu_torch")], here,
                          rules=("R1",), apply_suppressions=False)
    r1_s = time.perf_counter() - t0
    static = {f"{f.path}:{f.line}" for f in found}
    sites = {}
    for src in traced.values():
        for site, n in src.items():
            sites[site] = sites.get(site, 0) + n
    in_scope = sorted(s for s in sites if s.startswith(R1_SCOPE))
    missed = [s for s in in_scope if s not in static]
    elsewhere = sorted(s for s in sites if s.startswith("cook_tpu_torch/")
                       and s not in in_scope)
    outside = sorted(s for s in sites if not s.startswith("cook_tpu_torch/"))
    stats["r1"] = {
        "static_findings": len(found), "static_sites": len(static),
        "traced_sites": len(sites), "traced_sites_in_scope": len(in_scope),
        "traced_sites_missed": len(missed), "missed": missed,
        "in_scope": {s: sites[s] for s in in_scope},
        "elsewhere_in_port": {s: sites[s] for s in elsewhere},
        "outside_port": {s: sites[s] for s in outside},
        "traced_by_path": traced, "scan_s": r1_s}
    print(json.dumps({"analysis_r1": stats["r1"]}), flush=True)
    if missed:
        fail(f"R1 misses traced syncs: {missed}")
    if not in_scope:
        fail("no traced sync in ops/, parallel/ or resident.py: nothing "
             "held R1 to the card")
    # ---- the checker as a user runs it --------------------------------
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "cook_tpu_torch.analysis", "--strict"],
        cwd=here, capture_output=True, text=True, timeout=600)
    stats["strict"] = {"rc": proc.returncode,
                       "wall_s": time.perf_counter() - t0,
                       "summary": proc.stdout.strip().splitlines()[-1:]}
    print(json.dumps({"analysis_strict": stats["strict"]}), flush=True)
    if proc.returncode != 0:
        fail(f"python -m cook_tpu_torch.analysis --strict exited "
             f"{proc.returncode}: {proc.stdout[-2000:]}")
    # ---- bench_torch.py ingest ------------------------------------------
    fm.reset_launches()
    ingest = bench_torch.bench_ingest(**ANALYSIS_INGEST, device=dev)
    launches["ingest"] = dict(fm.LAUNCHES)
    if not ingest["durability_check"]["acked_all_durable"] or \
            ingest["acked_total"] == 0:
        fail(f"ingest: {ingest['durability_check']}")
    stats["ingest"] = ingest
    # ---- bench_torch.py fleet --------------------------------------------
    saved = {k: os.environ.get(k) for k in ANALYSIS_FLEET_ENV}
    os.environ.update(ANALYSIS_FLEET_ENV)
    try:
        fleet = bench_torch.bench_fleet(groups=ANALYSIS_FLEET_GROUPS,
                                        device=dev, timeout_s=600)
    except SystemExit as e:
        fail(f"fleet: {e}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    members = fleet["per_group"] + [fleet["single_leader"]]
    for i, g in enumerate(members):
        if g["platform"] != "gpu" or g["exact_scan_launches"] < 1 or \
                not (g["state_hash_match"] and g["acked_all_durable"]):
            fail(f"fleet member {i}: {g}")
    launches["fleet"] = {k: sum(g["kernel_launches"].get(k, 0)
                                for g in members)
                         for k in fm.LAUNCHES}
    stats["fleet"] = fleet
    summary = {"card": card_line(),
               "r1_static_findings": len(found),
               "traced_sites": len(sites),
               "traced_sites_missed": len(missed),
               "strict_rc": proc.returncode,
               "strict_wall_s": stats["strict"]["wall_s"],
               "ingest_bulk_jps": ingest["bulk_jps"],
               "ingest_single_seq_jps": ingest["single_seq_jps"],
               "ingest_single_conc_jps": ingest["single_conc_jps"],
               "ingest_acked_all_durable":
                   ingest["durability_check"]["acked_all_durable"],
               "fleet_aggregate_dps": fleet["value"],
               "fleet_single_leader_dps": fleet["single_leader_dps"],
               "fleet_speedup": fleet["speedup_vs_single"],
               "fleet_compute_mode": fleet["compute_mode"],
               "fleet_exact_scan_launches": [g["exact_scan_launches"]
                                             for g in members]}
    stats["summary"] = summary
    print(json.dumps({"analysis": summary}), flush=True)
    return stats, launches


def soak_phase(dev):
    """15: the leader-failover soak and the four e2e overhead A/Bs,
    through bench_torch.py's functions (each prints its mode's line).

    The soak: bench_torch.bench_failover at SOAK_FAILOVER, an HA pair of
    `python -m cook_tpu_torch.rest.server --device cuda` processes over
    one durable store, the leader SIGKILLed once and frozen once. It
    fails the run when a gate of tests/test_federation_soak.py's
    _assert_gates breaks (bench_torch.failover_gates), when a server
    incarnation ran on another device, when no survivor launched
    exact_scan, or when a takeover took over 20,000 ms.

    The A/Bs, each once at bench.py's shape with SOAK_AB_CYCLES cycles
    an arm (decision-overhead: one round): the run fails when a toggle
    did not take (provenance off recorded a decision, on recorded none;
    no flight span exported, or an export that is not JSON; no profiler
    cycle committed; no armed chaos draw, or the controller left armed)
    or when an arm launched no exact_scan. The overhead percentages are
    printed and never gate the run: one run cannot resolve bench.py's 2%
    budget on this path (bench.py:1449-1453), so a gate on them would
    fail at random. Returns (stats, launches by leg)."""
    import shutil
    import tempfile
    import bench_torch
    from cook_tpu_torch import chaos
    from cook_tpu_torch.ops import fused_match as fm

    t_phase = time.perf_counter()
    out, launches = {}, {}
    zero = {k: 0 for k in fm.LAUNCHES}

    def total(lines):
        got = dict(zero)
        for line in lines:
            for k, v in line.items():
                got[k] += v
        return got

    t0 = time.perf_counter()
    fo = bench_torch.bench_failover(seed=SOAK_SEED, device=dev.type,
                                    **SOAK_FAILOVER)
    if not fo["ok"]:
        fail(f"failover soak: gate breaches {fo['gate_breaches'][:5]}, "
             f"worst MTTR {fo['value']} ms, incarnations "
             f"{fo['incarnations']} (all on {dev.type}: "
             f"{fo['incarnations_on_device']}), survivors' exact_scan "
             f"launches {fo['survivor_exact_scan_launches']}")
    launches["soak_failover"] = total(fo["survivor_kernel_launches"])
    out["failover"] = {k: fo[k] for k in (
        "value", "mttr_ms_median", "mttr_ms_all", "epochs", "completed",
        "expected_jobs", "server_deaths", "incarnations",
        "survivor_exact_scan_launches", "wall_s")}
    out["failover"]["leg_s"] = time.perf_counter() - t0

    for leg, seed, scale in (("quick", DAY_QUICK_SEED, DAY_QUICK),
                             ("quiet", DAY_QUIET_SEED, DAY_QUIET)):
        t0 = time.perf_counter()
        d = bench_torch.bench_day_soak(seed=seed, device=dev.type, **scale)
        # ok: bench.py's ok, every gate, every incarnation on the card,
        # exact_scan launched by the final one
        bad = [] if d["ok"] else [
            f"not ok: breaches {d['gate_breaches']}, bench.py's ok "
            f"{d['bench_ok']}, incarnations {d['incarnations']}, the "
            f"final one's launches {d['final_kernel_launches']} (every "
            f"one that reported: {d['reported_kernel_launches']})"]
        if chaos.controller.enabled or chaos.controller.stats()["sites"]:
            bad.append(f"the transport-chaos controller was left armed: "
                       f"{chaos.controller.stats()}")
        if leg == "quick":
            if d["server_deaths"] < 1:
                bad.append("no coordinator SIGKILL landed")
            if not d["transport_injected"]:
                bad.append("no transport fault injected")
            if not d["churn_events"]:
                bad.append("the churn schedule was empty")
        else:
            if d["kills"] or d["server_deaths"]:
                bad.append(f"{d['kills']} kills, {d['server_deaths']} "
                           f"server deaths on a quiet day")
            if d["transport_injected"]:
                bad.append(f"{d['transport_injected']} transport faults "
                           f"on a quiet day")
            if d["overload_level_max"]:
                bad.append(f"overload level {d['overload_level_max']} on "
                           f"a quiet day")
            if d["max_instances"] > 1:
                bad.append(f"a job churned {d['max_instances']} instances "
                           f"on a quiet day")
        if bad:
            fail(f"day soak, {leg} (seed {seed}): {bad[:5]}")
        launches[f"day_soak_{leg}"] = total([d["final_kernel_launches"]])
        out[f"day_soak_{leg}"] = {k: d[k] for k in (
            "value", "unit", "seed", "wall_s", "server_deaths", "kills",
            "churn_events", "transport_injected", "submit_p99_ms",
            "max_rss_mb", "max_rss_own_mb", "overload_level_max",
            "max_instances",
            "ready_times_s", "incarnations", "final_exact_scan_launches",
            "final_kernel_launches")}
        out[f"day_soak_{leg}"]["leg_s"] = time.perf_counter() - t0

    ab = dict(cycles=SOAK_AB_CYCLES, warmup=SOAK_AB_WARMUP, device=dev)
    tmp = tempfile.mkdtemp(prefix="cook_smoke_ab_")
    try:
        t0 = time.perf_counter()
        d = bench_torch.bench_decision_overhead(rounds=1, **ab)
        if d["decisions_recorded_disabled"] != 0 or \
                not d["decisions_recorded_enabled"]:
            fail(f"decision-overhead: recorded "
                 f"{d['decisions_recorded_disabled']} off, "
                 f"{d['decisions_recorded_enabled']} on")
        t1 = time.perf_counter()
        path = os.path.join(tmp, "trace.json")
        t = bench_torch.bench_trace_overhead(out_path=path, **ab)
        try:
            with open(path) as f:
                json.load(f)
        except (OSError, ValueError) as e:
            fail(f"trace-overhead: the Chrome trace is not JSON: {e!r}")
        if not t["flight_spans_exported"]:
            fail("trace-overhead: no flight span exported")
        t2 = time.perf_counter()
        p = bench_torch.bench_profile_overhead(
            out_path=os.path.join(tmp, "profile.json"), **ab)
        if not p["committed"]:
            fail("profile-overhead: no cycle committed")
        t3 = time.perf_counter()
        c = bench_torch.bench_chaos_overhead(**ab)
        if not c["armed_draws"] or c["armed_after"] or \
                chaos.controller.enabled:
            fail(f"chaos-overhead: {c['armed_draws']} armed draws, armed "
                 f"after: {c['armed_after'] or chaos.controller.enabled}")
        t4 = time.perf_counter()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, line, s in (("decision", d, t1 - t0), ("trace", t, t2 - t1),
                          ("profile", p, t3 - t2), ("chaos", c, t4 - t3)):
        for arm, k in line["kernel_launches"].items():
            if not k["exact_scan"]:
                fail(f"{name}-overhead arm {arm}: exact_scan never "
                     f"launched")
        launches[f"ab_{name}"] = total(line["kernel_launches"].values())
        out[f"{name}_overhead"] = {
            # reported, never gated (bench.py:1449-1453)
            "overhead_pct": line["value"],
            "overhead_ok": line["overhead_ok"],
            **{k: v for k, v in line.items()
               if k.startswith(("decisions_per_sec", "p99_cycle_ms",
                                "decisions_recorded"))},
            "exact_scan_launches": {a: k["exact_scan"] for a, k in
                                    line["kernel_launches"].items()},
            "leg_s": s}
    out["trace_overhead"]["flight_spans_exported"] = \
        t["flight_spans_exported"]
    out["profile_overhead"]["committed"] = p["committed"]
    out["profile_overhead"]["dominant_match"] = p["dominant_match"]
    out["chaos_overhead"]["armed_draws"] = c["armed_draws"]
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"soak": out}), flush=True)
    return out, launches


def as_json(x):
    """`x` as the CPU references come back from their process (tuples as
    lists), for comparing the card's runs with them."""
    return json.loads(json.dumps(x))


class CpuRefs:
    """The runs on the port's CPU path that phases 5b to 10 hold the card
    against, made in one child process (`chip_smoke.py --cpu-refs DIR`,
    which sees no card) while the card runs the phases before them. Each
    is the same call on the same seeded inputs that the phase made in
    turn before; `get` waits for one and returns (result, seconds)."""

    THREADS = 4
    MAX_S = 900

    def __init__(self):
        self.proc = self.dir = None

    @staticmethod
    def runs():
        """{name: the run}, in the order the phases need them."""
        from cook_tpu_torch import e2e

        def e2e_run(consider):
            r = e2e_agreement_run("cpu", consider)
            return {k: r[k] for k in ("per_cycle", "dense_rounds")}

        runs = {f"group_{cell}": (lambda k=knobs, c=C: group_cpu_cycles(k, c))
                for cell, knobs, C in group_cells()}
        runs.update({f"rebalance_{label}": (
            lambda t=T0, g=gpu, c=cap: rebalance_cpu_run(t, g, c))
            for label, T0, gpu, cap in REB_VARIANTS if T0 <= REB_CPU_MAX_T0})
        runs.update({
            "e2e_sequential": lambda: e2e_run(None),
            "e2e_batched": lambda: e2e_run(C_BATCHED),
            "paths": lambda: e2e.device_paths("cpu"),
            "server": lambda: server_agreement("cpu", SERVER_AGREE),
            "simulator": lambda: simulate("cpu")[:2]})
        return runs

    def start(self, here):
        import atexit
        import tempfile
        self.dir = tempfile.mkdtemp(prefix="cook_smoke_cpu_refs_")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   CHIP_SMOKE_PARENT=str(os.getpid()))
        self.err = open(os.path.join(self.dir, "stderr"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(here, "chip_smoke.py"),
             "--cpu-refs", self.dir], cwd=here, env=env,
            stdin=subprocess.DEVNULL, stdout=self.err, stderr=self.err)
        atexit.register(self.stop)

    def get(self, name):
        path = os.path.join(self.dir, name + ".json")
        t0 = time.perf_counter()
        while not os.path.exists(path):
            if self.proc.poll() is not None:
                with open(os.path.join(self.dir, "stderr")) as f:
                    tail = f.read()[-3000:]
                fail(f"the CPU path's references ended with code "
                     f"{self.proc.returncode} before {name}:\n{tail}")
            if time.perf_counter() - t0 > self.MAX_S:
                fail(f"the CPU path's reference {name} not made in "
                     f"{self.MAX_S} s")
            time.sleep(0.2)
        with open(path) as f:
            r = json.load(f)
        return r["result"], r["s"]

    def stop(self):
        import shutil
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if self.dir is not None:
            self.err.close()
            shutil.rmtree(self.dir, ignore_errors=True)
        self.proc = self.dir = None

    @classmethod
    def child(cls, out):
        """The child's body: each reference in turn, written to `out`."""
        import threading
        parent = int(os.environ.get("CHIP_SMOKE_PARENT", os.getppid()))

        def orphaned():
            # ends with the smoke, however the smoke ends
            while os.getppid() == parent:
                time.sleep(1.0)
            os._exit(1)

        threading.Thread(target=orphaned, daemon=True).start()
        import torch
        here = os.path.dirname(os.path.abspath(__file__))
        sys.path.insert(0, here)
        torch.set_num_threads(cls.THREADS)
        for name, run in cls.runs().items():
            t = time.perf_counter()
            r = run()
            tmp = os.path.join(out, name + ".tmp")
            with open(tmp, "w") as f:
                json.dump({"result": r, "s": time.perf_counter() - t}, f)
            os.replace(tmp, os.path.join(out, name + ".json"))


CPU_REFS = CpuRefs()


def main():
    import faulthandler
    import torch
    # a native abort prints every thread's Python stack
    faulthandler.enable(all_threads=True)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "cook_tpu_torch")):
        fail("the cook_tpu_torch package is not beside chip_smoke.py")
    sys.path.insert(0, here)
    CPU_REFS.start(here)
    from cook_tpu_torch.entry import (HEAD_START, resident_workload,
                                      sequential_for)
    from cook_tpu_torch.kernels import build
    from cook_tpu_torch.ops import fused_match as fm

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    secs = build.build_all()
    print(json.dumps({"build_s": secs,
                      "build_wall_s": time.perf_counter() - t0}), flush=True)
    for name, log in build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas[{name}]: {line.strip()}", flush=True)
    dev = torch.device("cuda", 0)

    mark("build")
    # ---- 2. exact_scan vs plain on the card --------------------------------
    cluster = fm.exact_scan_cluster()
    print(json.dumps({"exact_scan_cluster_ctas": cluster}), flush=True)
    rng = np.random.default_rng(0)
    jp, hp, forb = scan_problem(rng, S_MAIN, H_MAIN, dev)
    max_err, n_assigned = check_kernel(jp, hp, forb, "mixed 1024x16384")
    if n_assigned == 0:
        fail("mixed exact_scan assigned no job")
    cases = {}
    for label, a, b, c in adversarial(dev, cluster):
        err, n = check_kernel(a, b, c, label)
        max_err = max(max_err, err)
        cases[label] = n
        check_adversarial(label, a, b, fm.exact_scan(a, b, c)[0])
    print(json.dumps({"exact_scan_vs_plain": "equal", "max_abs_err": max_err,
                      "mixed_assigned": n_assigned,
                      "adversarial_assigned": cases}), flush=True)
    kernel_ms = cuda_ms(lambda: fm.exact_scan(jp, hp, forb), 20)
    plain_ms = cuda_ms(lambda: fm.exact_scan_plain(jp, hp, forb), 2)
    jh_, fb_ = jp[:HEAD_START].contiguous(), forb[:HEAD_START].contiguous()
    head_ms = cuda_ms(lambda: fm.exact_scan(jh_, hp, fb_), 20)
    # the dependency floor: the same S steps with one warp of hosts per CTA
    jf, hf, ff = scan_problem(np.random.default_rng(4), S_MAIN, cluster * 32,
                              dev)
    check_kernel(jf, hf, ff, "chain floor")
    floor_ms = cuda_ms(lambda: fm.exact_scan(jf, hf, ff), 20)
    S, H = S_MAIN, H_MAIN
    scan_bound_ms, scan_bound_by = bound(
        S * 8 * 4 + 16 * H * 4 + S * H + S * 4 + 16 * H * 4,
        S * H * OPS_PER_PAIR)

    # ---- 2b. blocked_cumsum vs plain on the card ---------------------------
    from cook_tpu_torch.ops import segments as seg
    cs_err = 0.0
    xs = {}
    before = dict(fm.LAUNCHES)
    for shape in CUMSUM_SHAPES:
        x = torch.from_numpy((10.0 ** rng.uniform(-3, 3, shape)
                              * rng.choice([-1.0, 1.0], shape))
                             .astype(np.float32)).to(dev)
        cs_err = max(cs_err, check_cumsum(x, str(shape)))
        xs[shape] = x
    cs_routes = {}
    for label, x in cumsum_edges(dev):
        cs_err = max(cs_err, check_cumsum(x, label))
        cs_routes[label] = seg.blocked_cumsum_plan(x.shape[0])[:2]
    routes_ran(before, ("blocked_cumsum", "blocked_cumsum/global"),
               "blocked_cumsum edges")
    print(json.dumps({"blocked_cumsum_vs_plain": "bit-equal, run to run",
                      "shapes": [list(k) for k in CUMSUM_SHAPES],
                      "edges_route_ctas": cs_routes}), flush=True)
    cs_ms, cs_bound = {}, {}
    for shape, x in xs.items():
        cs_ms[str(shape)] = cuda_ms(lambda: seg.blocked_cumsum(x), 50)
        # each input float read once, each output float written once;
        # one addition per element (plus n/15 for the levels above)
        cs_bound[str(shape)] = bound(2 * x.numel() * 4,
                                     x.numel() * 16 // 15)
    x = xs[CUMSUM_SHAPES[0]]
    cs_plain_ms = cuda_ms(lambda: seg.blocked_cumsum_plain(x), 5)
    cs_lib_ms = cuda_ms(lambda: torch.cumsum(x, dim=0), 50)
    # torch.cumsum on the layout it scans fast (each column one
    # contiguous row): with the transpose, and on a transposed copy
    cs_lib_inner_ms = cuda_ms(
        lambda: torch.cumsum(x.t().contiguous(), dim=1), 50)
    xt = x.t().contiguous()
    cs_lib_rows_ms = cuda_ms(lambda: torch.cumsum(xt, dim=1), 50)
    CS_MAIN = str(CUMSUM_SHAPES[0])
    cs_bound_ms, cs_bound_by = cs_bound[CS_MAIN]

    # ---- 2c. sum_ordered vs plain on the card ------------------------------
    sum_err, cl_err, lv_err = 0.0, 0.0, 0.0
    sxs = {}
    before = dict(fm.LAUNCHES)
    for label, x in sum_cases(dev):
        err = check_sum(x, label)
        n = x.shape[0]
        if n > seg.SUM_CLUSTER_MAX:
            lv_err = max(lv_err, err)
        elif n > seg.SUM_MAX:
            cl_err = max(cl_err, err)
        else:
            sum_err = max(sum_err, err)
        sxs[label] = x
    routes_ran(before, ("sum_ordered", "sum_ordered/cluster",
                        "sum_ordered/levels"), "sum_ordered cases")
    print(json.dumps({"sum_ordered_vs_plain": "bit-equal, run to run",
                      "cases": list(sxs),
                      "sum_ordered_cluster_ctas":
                          seg.sum_cluster_ctas()}), flush=True)
    sx = lambda n: sxs[f"n{n}"]
    sum_ms = {n: cuda_ms(lambda: seg.sum_ordered(sx(n)), 50)
              for n in (D_MAIN, H_MAIN, SUM_LEVELS_N)}
    sum_plain_ms = cuda_ms(lambda: seg.sum_ordered_plain(sx(H_MAIN)), 5)
    sum_lib_ms = cuda_ms(lambda: torch.sum(sx(H_MAIN)), 50)
    # the floats read once, one written; one addition per element
    sum_bound_ms, sum_bound_by = bound(4 * H_MAIN + 4, H_MAIN)
    # the cluster route (one launch) against the levels route (a level
    # launch and the one-CTA kernel) at the 300k pool's T, in turns
    xl = sx(SUM_LEVELS_N)

    def sum_parent():
        with parent_routes():
            seg.sum_ordered(xl)

    lv_ms_turns, cl_ms_turns = in_turns(sum_parent,
                                        lambda: seg.sum_ordered(xl), 50)
    lv_plain_ms = cuda_ms(lambda: seg.sum_ordered_plain(xl), 5)
    lv_lib_ms = cuda_ms(lambda: torch.sum(xl), 50)
    lv_bound = bound(4 * SUM_LEVELS_N + 4, SUM_LEVELS_N)
    # the launch floor: an empty kernel, one CTA of 32 threads and one
    # cluster of the cluster routes' CTAs of 1,024
    empty_ms = {kind: cuda_ms(lambda: seg.noop_launch(kind), 50)
                for kind in ("one_cta", "cluster")}
    print(json.dumps({"sum_ordered_ms_in_turns": {
        "n": SUM_LEVELS_N, "parent_levels_ms": lv_ms_turns,
        "cluster_ms": cl_ms_turns, "torch_sum_ms": lv_lib_ms,
        "empty_launch_ms": empty_ms, "card": card}}), flush=True)

    # ---- 3. best_host vs plain on the card ---------------------------------
    D = D_MAIN
    jp, hp, forb = scan_problem(np.random.default_rng(1), D, H_MAIN, dev)
    bonus = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 0.5, (D, H_MAIN)).astype(np.float32)).to(dev)
    bh_err = 0.0
    for b, spread, label in ((None, 0.2, "mixed spread 0.2"),
                             (None, 0.0, "mixed spread 0"),
                             (bonus, 0.0, "mixed bonus spread 0"),
                             (bonus, 0.2, "mixed bonus spread 0.2")):
        err, n, _ = check_best_host(jp, hp, forb, b, spread, label)
        bh_err = max(bh_err, err)
        if n == 0:
            fail(f"best_host {label}: no row found a host")
    a, b, c = identical_hosts(D, H_MAIN, dev)
    _, _, idx = check_best_host(a, b, c, None, 0.0, "all_tie")
    if not bool((idx == 0).all()):
        fail("best_host all_tie: the lowest index did not win")
    _, n, _ = check_best_host(jp, hp, torch.ones_like(forb), None, 0.2,
                              "all_infeasible")
    if n != 0:
        fail("best_host all_infeasible: a row found a host")
    for N_, H_ in ((D, 16411), (200, H_MAIN)):
        a, b, c = scan_problem(np.random.default_rng(3), N_, H_, dev)
        err, _, _ = check_best_host(a, b, c, None, 0.2, f"{N_}x{H_}")
        bh_err = max(bh_err, err)
    for label, a, b, c, bb, spread in best_host_edges(dev):
        err, _, idx = check_best_host(a, b, c, bb, spread, label)
        bh_err = max(bh_err, err)
        check_best_host_edge(label, idx)
    print(json.dumps({"best_host_vs_plain": "equal", "max_abs_err": bh_err}),
          flush=True)
    # its division, RN(a / b) from a per-host reciprocal, against IEEE
    # division: the first and last 2,048 b mantissas x every a (the cuda
    # test test_best_host_division_equals_ieee_on_cuda takes all 2^46)
    div_bad = fm.best_host_division_mismatches(0, DIV_B) + \
        fm.best_host_division_mismatches((1 << 23) - DIV_B, DIV_B)
    print(json.dumps({"best_host_division_vs_fdiv_rn": {
        "pairs": 2 * DIV_B << 23, "mismatches": div_bad}}), flush=True)
    if div_bad:
        fail(f"best_host division differs from IEEE division at {div_bad} "
             f"mantissa pairs")
    # the main path's call: no bonus, spread 0.2
    bh_ms = cuda_ms(lambda: fm.best_host(jp, hp, forb, None, 0.2), 50)
    bh_plain_ms = cuda_ms(lambda: fm.best_host_plain(jp, hp, forb, None,
                                                     0.2), 5)
    bh_bonus_ms = cuda_ms(lambda: fm.best_host(jp, hp, forb, bonus, 0.0), 50)
    feas = int(fm.best_host_feasible(jp, hp, forb).sum())

    # ---- 3b. ordered_scatter vs plain on the card --------------------------
    sc_runs, sc_ms, sc_plain_ms, sc_lib_ms, sc_bound = {}, {}, {}, {}, {}
    sc_args, sc_err = {}, 0.0
    for label, o, i, v in scatter_cases(dev):
        err, sc_runs[label] = check_scatter(o, i, v, label)
        sc_err = max(sc_err, err)
        sc_args[label] = (o, i, v)
        T, k = o.shape[0], o[0].numel()
        work = o.clone()
        sc_ms[label] = cuda_ms(lambda: seg.scatter_add_ordered_(work, i, v),
                               50)
        sc_plain_ms[label] = cuda_ms(
            lambda: seg.scatter_add_ordered_plain_(work, i, v), 3)
        # the yardstick: float index_add_ onto a sink slot (any order)
        sink = torch.zeros((T + 1,) + tuple(o.shape[1:]), device=dev)
        lib_i = torch.where((i >= 0) & (i < T), i, T)
        sc_lib_ms[label] = cuda_ms(lambda: sink.index_add_(0, lib_i, v), 50)
        # the indices and values read once, each touched target read and
        # written once; one add per value
        n = i.shape[0]
        touched = int(torch.unique(i[(i >= 0) & (i < T)]).numel())
        sc_bound[label] = bound(
            i.element_size() * n + 4 * v.numel() + 8 * k * touched,
            v.numel())
    before = dict(fm.LAUNCHES)
    sc_edge_runs, sc_edge_routes, sc_cl_err = {}, {}, 0.0
    for label, o, i, v in scatter_edges(dev):
        err, sc_edge_runs[label] = check_scatter(o, i, v, label)
        route = seg.scatter_plan(i.shape[0], o.shape[0])[0]
        sc_edge_routes[label] = route
        if route == "ordered_scatter/cluster":
            sc_cl_err = max(sc_cl_err, err)
        else:
            sc_err = max(sc_err, err)
    routes_ran(before, ("ordered_scatter", "ordered_scatter/cluster",
                        "ordered_scatter/sorted"), "ordered_scatter edges")
    print(json.dumps({"ordered_scatter_vs_plain": "bit-equal, run to run",
                      "longest_run": sc_runs,
                      "edges_longest_run": sc_edge_runs,
                      "edges_route": sc_edge_routes,
                      "ordered_scatter_cluster_grid":
                          seg.scatter_cluster_grid()}), flush=True)
    SC_MAIN = "bids_8192x16384"
    # device activities (kernels, memsets, copies) a call of the
    # rebalancer's usage scatter launches on the cluster route and on the
    # route before it (torch.sort's), by the profiler; counted this early
    # (later, after the rebalance phase's profiles, one run read no
    # activity for the cluster route and 13.4 for the sorted one)
    from cook_tpu_torch.profile_cycle import profile_calls
    usage_kernels = {}
    for T0 in (50_000, 300_000):
        o, i, v = rebalance_usage_case(dev, T0)

        def sorted_call():
            with parent_routes():
                seg.scatter_add_ordered_(o, i, v)

        usage_kernels[T0] = {
            name: sum(k[2] for k in profile_calls(fn, 20)[1])
            for name, fn in (
                ("sorted", sorted_call),
                ("cluster", lambda: seg.scatter_add_ordered_(o, i, v)))}
    print(json.dumps({"usage_device_activities_per_call": usage_kernels}),
          flush=True)

    # ---- 3c. host time of each wrapper per call (enqueue only) -------------
    jh_, fb_ = jp[:HEAD_START].contiguous(), forb[:HEAD_START].contiguous()
    o, i, v = sc_args[SC_MAIN]
    wrapper_host_us = {
        "exact_scan": host_us(lambda: fm.exact_scan(jh_, hp, fb_), 50),
        "best_host": host_us(lambda: fm.best_host(jp, hp, forb, None, 0.2)),
        "blocked_cumsum": host_us(lambda: seg.blocked_cumsum(xs[
            CUMSUM_SHAPES[0]])),
        "ordered_scatter": host_us(
            lambda: seg.scatter_add_ordered_(o, i, v)),
        "sum_ordered": host_us(lambda: seg.sum_ordered(sx(H_MAIN))),
        "torch_add_reference": host_us(lambda: torch.add(o, 1.0)),
    }
    print(json.dumps({"wrapper_host_us_per_call": wrapper_host_us}),
          flush=True)
    # jobs, the host rows read, the mask (and the bonus), the outputs
    bh_bytes = D * 8 * 4 + BH_HOST_ROWS * H_MAIN * 4 + D * H_MAIN + D * 8
    bh_ops = H_MAIN * BH_OPS_HOST + D * H_MAIN * BH_OPS_PAIR
    bh_bound_ms, bh_bound_by = bound(
        bh_bytes, bh_ops + feas * (BH_OPS_FIT + BH_OPS_JITTER))
    bh_bonus_bound_ms, _ = bound(
        bh_bytes + D * H_MAIN * 4, bh_ops + feas * (BH_OPS_FIT + BH_OPS_BONUS))

    # ---- 3d. the walk's bonus and groups routes, best_host's groups ------
    gr = group_routes(dev, cluster)

    mark("kernels")
    # ---- 4. the sequential path: resident cycles through exact_scan --------
    t0 = time.perf_counter()
    w = resident_workload(device=dev, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rs = w.rs
    if (rs.Pcap, rs.Hcap, w.C) != (131072, 16384, 1024) or \
            not sequential_for(w.C):
        fail(f"unexpected sizing {(rs.Pcap, rs.Hcap, w.C)}")
    recorded = []
    host_ms, matched = [], []
    phase_ms = {}
    fm.reset_launches()
    for c in range(CYCLES):
        t = time.perf_counter()
        out, mat_idx, mat_host = w.cycle(use_kernel=True)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t) * 1e3)
        for k, v in w.timing.items():
            phase_ms.setdefault(k, []).append(v)
        matched.append(len(mat_idx))
        check_cycle_state(w, mat_idx, c, "sequential")
        if c < REPLAY:
            recorded.append((mat_idx, mat_host, out[8].cpu().numpy()))
    seq_launches = dict(fm.LAUNCHES)
    if seq_launches["exact_scan"] != CYCLES or seq_launches["best_host"] \
            or seq_launches["blocked_cumsum"] < CYCLES \
            or seq_launches["ordered_scatter"] < CYCLES \
            or seq_launches["sum_ordered"] or off_route(seq_launches):
        fail(f"sequential path launches {seq_launches} in {CYCLES} cycles")
    if sum(matched) == 0:
        fail("the sequential cycles matched nothing")

    w2 = resident_workload(device=dev, seed=0)
    for c in range(REPLAY):
        with plain_kernels():
            out, mat_idx, mat_host = w2.cycle(use_kernel=True)
        ri, rh, rc = recorded[c]
        if not (np.array_equal(mat_idx, ri) and np.array_equal(mat_host, rh)
                and np.array_equal(out[8].cpu().numpy(), rc)):
            fail(f"replay cycle {c}: plain version disagrees with kernel")
    if fm.LAUNCHES != seq_launches:
        fail("the sequential plain replay launched a kernel")
    del w, w2

    mark("sequential")
    # ---- 5. the batched path: match_rounds through both kernels ------------
    t0 = time.perf_counter()
    wb = resident_workload(device=dev, seed=0, C=C_BATCHED)
    torch.cuda.synchronize()
    b_setup_s = time.perf_counter() - t0
    rs = wb.rs
    if (rs.Pcap, rs.Rcap, rs.Hcap) != (262144, 32768, 16384) or \
            sequential_for(wb.C):
        fail(f"unexpected batched sizing {(rs.Pcap, rs.Rcap, rs.Hcap)}")
    b_recorded, b_host_ms, b_matched, b_phase = [], [], [], {}
    bh_per_cycle, cs_per_cycle, os_per_cycle, so_per_cycle = [], [], [], []
    inversions, why_counts = [], []
    fm.reset_launches()
    for c in range(BATCHED):
        before = dict(fm.LAUNCHES)
        now_s = wb.now_s
        t = time.perf_counter()
        out, mat_idx, mat_host = wb.cycle(use_kernel=True)
        torch.cuda.synchronize()
        b_host_ms.append((time.perf_counter() - t) * 1e3)
        for k, v in wb.timing.items():
            b_phase.setdefault(k, []).append(v)
        b_matched.append(len(mat_idx))
        d = {k: fm.LAUNCHES[k] - before[k] for k in before}
        bh_per_cycle.append(d["best_host"])
        cs_per_cycle.append(d["blocked_cumsum"])
        os_per_cycle.append(d["ordered_scatter"])
        so_per_cycle.append(d["sum_ordered"])
        if d["exact_scan"] != 1:
            fail(f"batched cycle {c}: exact_scan launched "
                 f"{d['exact_scan']} times")
        for k in ("best_host", "blocked_cumsum", "ordered_scatter",
                  "sum_ordered"):
            if d[k] < 1:
                fail(f"batched cycle {c}: {k} never launched")
        check_cycle_state(wb, mat_idx, c, "batched")
        why_counts.append(np.bincount(out[8].cpu().numpy(),
                                      minlength=8).tolist())
        inv = head_window_inversions(wb, out, now_s)
        inversions.append(len(inv))
        if (inv < HEAD_START).any():
            fail(f"batched cycle {c}: inversions inside the exact head at "
                 f"{inv[inv < HEAD_START][:10].tolist()}")
        if c < BATCHED_REPLAY:
            b_recorded.append((mat_idx, mat_host, out[8].cpu().numpy()))
    b_launches = dict(fm.LAUNCHES)
    if off_route(b_launches):
        fail(f"batched path launches {b_launches}: a call beyond the "
             f"on-chip routes")
    if sum(b_matched) == 0:
        fail("the batched cycles matched nothing")
    print(json.dumps({"batched_best_host_launches_per_cycle": bh_per_cycle,
                      "batched_blocked_cumsum_launches_per_cycle":
                          cs_per_cycle,
                      "batched_ordered_scatter_launches_per_cycle":
                          os_per_cycle,
                      "batched_sum_ordered_launches_per_cycle":
                          so_per_cycle,
                      "batched_head_window_inversions": inversions,
                      "batched_why_code_counts": why_counts,
                      "audit_window": AUDIT_WINDOW}), flush=True)

    wb2 = resident_workload(device=dev, seed=0, C=C_BATCHED)
    for c in range(BATCHED_REPLAY):
        with plain_kernels():
            out, mat_idx, mat_host = wb2.cycle(use_kernel=True)
        ri, rh, rc = b_recorded[c]
        if not (np.array_equal(mat_idx, ri) and np.array_equal(mat_host, rh)
                and np.array_equal(out[8].cpu().numpy(), rc)):
            fail(f"batched replay cycle {c}: plain versions disagree with "
                 f"the kernels")
    if fm.LAUNCHES != b_launches:
        fail("the batched plain replay launched a kernel")

    mark("batched")
    # ---- 5b. the grouped and locality cells --------------------------------
    group_out, group_launches = group_cells_phase(dev)
    mark("groups")
    # ---- 6. the rebalancer: bench_rebalance's sweeps through the kernels -
    reb_out, reb_launches = rebalance_phase(dev)
    # its usage scatter alone at 50k and 300k tasks: the cluster route
    # against the parent's (torch.sort, then the walk), in turns
    usage = {}
    for T0 in (50_000, 300_000):
        o, i, v = rebalance_usage_case(dev, T0)
        label = f"{T0 + REB_P}x{REB_U + 1}x2"
        before = dict(fm.LAUNCHES)
        err, run = check_scatter(o, i, v, f"rebalance_usage_{label}")
        routes_ran(before, ("ordered_scatter/cluster",),
                   f"rebalance usage {label}")
        with parent_routes():
            before = dict(fm.LAUNCHES)
            perr, _ = check_scatter(o, i, v, f"rebalance_usage_{label} "
                                             f"(sorted route)")
            routes_ran(before, ("ordered_scatter/sorted",),
                       f"rebalance usage {label} (sorted route)")
        work = o.clone()

        def parent_call():
            with parent_routes():
                seg.scatter_add_ordered_(work, i, v)

        new_call = lambda: seg.scatter_add_ordered_(work, i, v)
        parent_ms, new_ms = in_turns(parent_call, new_call, 50)
        sink = torch.zeros_like(o)
        usage[label] = {
            "err": err, "sorted_err": perr, "longest_run": run,
            "cluster_ms_turns": new_ms, "sorted_ms_turns": parent_ms,
            "cluster_ms": float(np.median(new_ms)),
            "sorted_ms": float(np.median(parent_ms)),
            "plain_ms": cuda_ms(
                lambda: seg.scatter_add_ordered_plain_(work, i, v), 3),
            "index_add_ms": cuda_ms(lambda: sink.index_add_(0, i, v), 50),
            # the indices and values read once, each touched target read
            # and written once; one add per value
            "bound": bound(4 * i.shape[0] + 4 * v.numel()
                           + 8 * 2 * o.shape[0], v.numel()),
            "device_activities_per_call": usage_kernels[T0],
            "host_us": {"cluster": host_us(new_call),
                        "sorted": host_us(parent_call)}}
        print(json.dumps({f"rebalance_usage_{label}": usage[label],
                          "card": card}), flush=True)
    RU = f"{50_000 + REB_P}x{REB_U + 1}x2"

    mark("rebalance")
    # ---- 7. the production path end to end: Coordinator over a store -----
    e2e_out, e2e_launches = e2e_phase(dev)
    mark("e2e")
    # ---- 8. the coordinator's other device paths, card against CPU ------
    paths_out = paths_phase(dev)
    mark("paths")
    # ---- 9. the scheduler server at bench_e2e's size ------------------------
    server_out, server_launches = server_phase(dev)
    mark("server")
    # ---- 10. python -m server, and the simulator card against CPU ----------
    operator_out, sim_launches = operator_phase(dev)
    mark("operator")
    # ---- 11. the multi-device paths on shards of the card ---------------
    parallel_out, par_launches = parallel_phase(dev)
    mark("parallel")
    # ---- 12. bench.py's remaining entry points (bench_torch.py) ---------
    bench_out, bench_launches = bench_phase(dev)
    mark("bench")
    # ---- 13. agents, kube over HTTP, leader failover ---------------------
    agents_out, agents_launches = agents_phase(dev)
    mark("agents")
    # ---- 14. cookcheck against the card; ingest and fleet ----------------
    analysis_out, analysis_launches = analysis_phase(dev, {
        "e2e": e2e_out, "parallel": parallel_out, "bench": bench_out,
        "agents": agents_out})
    mark("analysis")
    # ---- 15. the failover soak and the four e2e overhead A/Bs -----------
    soak_out, soak_launches = soak_phase(dev)
    mark("soak")

    def cycle_stats(phase, host, match):
        return {
            "cycle_event_ms_median": float(np.median(phase["event_ms"])),
            "cycle_event_ms_p99": float(np.percentile(phase["event_ms"],
                                                      99)),
            "cycle_host_ms_median": float(np.median(host)),
            "cycle_host_ms_p99": float(np.percentile(host, 99)),
            "cycle_host_ms_p99_after_first": float(
                np.percentile(host[1:], 99)),
            "phase_median_ms": {k: float(np.median(v))
                                for k, v in phase.items()},
            "cycle_host_ms": host,
            "matched_per_cycle": match,
        }

    timings = {
        "card": card, "kind": kind,
        "sequential": {"setup_s": setup_s, "cycles": CYCLES, "C": 1024,
                       **cycle_stats(phase_ms, host_ms, matched)},
        "batched": {"setup_s": b_setup_s, "cycles": BATCHED,
                    "C": C_BATCHED, "head_exact": HEAD_START,
                    "best_host_launches_per_cycle": bh_per_cycle,
                    "blocked_cumsum_launches_per_cycle": cs_per_cycle,
                    "ordered_scatter_launches_per_cycle": os_per_cycle,
                    "sum_ordered_launches_per_cycle": so_per_cycle,
                    **cycle_stats(b_phase, b_host_ms, b_matched)},
        "exact_scan_cluster_ctas": cluster,
        "exact_scan_ms": kernel_ms,
        "exact_scan_head_ms": head_ms,
        "exact_scan_plain_ms": plain_ms,
        "exact_scan_bound_ms": scan_bound_ms,
        "exact_scan_chain_floor_ms": floor_ms,
        "exact_scan_chain_floor_hosts": cluster * 32,
        "best_host_ms": bh_ms,
        "best_host_bonus_ms": bh_bonus_ms,
        "best_host_bonus_bound_ms": bh_bonus_bound_ms,
        "best_host_plain_ms": bh_plain_ms,
        "best_host_bound_ms": bh_bound_ms,
        "best_host_feasible_pairs": feas,
        "blocked_cumsum_ms": cs_ms,
        "blocked_cumsum_plain_ms": cs_plain_ms,
        "blocked_cumsum_bound_ms": {k: v[0] for k, v in cs_bound.items()},
        "torch_cumsum_dim0_ms": cs_lib_ms,
        "torch_cumsum_transposed_ms": cs_lib_inner_ms,
        "torch_cumsum_rows_ms": cs_lib_rows_ms,
        "ordered_scatter_ms": sc_ms,
        "ordered_scatter_plain_ms": sc_plain_ms,
        "ordered_scatter_bound_ms": {k: v[0] for k, v in sc_bound.items()},
        "index_add_ms": sc_lib_ms,
        "ordered_scatter_longest_run": sc_runs,
        "sum_ordered_ms": sum_ms,
        "sum_ordered_plain_ms": sum_plain_ms,
        "sum_ordered_bound_ms": sum_bound_ms,
        "torch_sum_ms": sum_lib_ms,
        "sum_ordered_levels_n": SUM_LEVELS_N,
        "sum_ordered_levels_plain_ms": lv_plain_ms,
        "sum_ordered_levels_bound_ms": lv_bound[0],
        "torch_sum_levels_ms": lv_lib_ms,
        "rebalance": reb_out,
        "e2e": e2e_out,
        "coordinator_paths": paths_out,
        "server": server_out,
        "operator": operator_out,
        "parallel": parallel_out,
        "bench": bench_out,
        "agents": agents_out,
        "analysis": analysis_out,
        "soak": soak_out,
        "group_routes": gr,
        "group_cells": group_out,
        "rebalance_usage": usage,
        "sum_ordered_cluster_ms_turns": cl_ms_turns,
        "sum_ordered_levels_ms_turns": lv_ms_turns,
        "empty_launch_ms": empty_ms,
        "wrapper_host_us_per_call": wrapper_host_us,
        "library_note": "no single PyTorch call computes the sequential "
                        "scan or the masked fitness argmax; "
                        "torch.cumsum(x, 0) computes blocked_cumsum's "
                        "function in another association, float "
                        "index_add_ ordered_scatter's in no fixed order, "
                        "torch.sum sum_ordered's in another association",
    }
    print(json.dumps(timings), flush=True)
    by_path = {k: {"sequential": seq_launches[k], "batched": b_launches[k],
                   "rebalance": reb_launches[k],
                   "e2e_sequential": e2e_launches["sequential"][k],
                   "e2e_batched": e2e_launches["batched"][k],
                   "server": server_launches[k], "sim": sim_launches[k],
                   "pools": par_launches["pools"][k],
                   "sharded": par_launches["sharded"][k],
                   **{f"bench_{m}": bench_launches[m][k]
                      for m in bench_launches},
                   **{leg: agents_launches[leg].get(k, 0)
                      for leg in agents_launches},
                   **{leg: analysis_launches[leg].get(k, 0)
                      for leg in analysis_launches},
                   **{leg: soak_launches[leg].get(k, 0)
                      for leg in soak_launches},
                   **{cell: group_launches[cell][k]
                      for cell in group_launches}}
               for k in seq_launches}

    def entry(name, route, source, replaces, err, ms, plain, bnd, lib,
              **extra):
        return {"name": name, "route": route, "source": source,
                "replaces": replaces,
                "launches": sum(by_path[name].values()),
                "launches_by_path": by_path[name], "max_abs_err": err,
                "ms": ms, "plain_ms": plain, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": lib, **extra}

    print(json.dumps({"kernels": [
        entry("exact_scan", "cuda", "cook_tpu_torch/csrc/exact_scan.cu",
              "cook_tpu/ops/pallas_match.py:166", max_err, kernel_ms,
              plain_ms, (scan_bound_ms, scan_bound_by), None,
              chain_floor_ms=floor_ms, cluster_ctas=cluster),
        entry("exact_scan/bonus", "cuda", "cook_tpu_torch/csrc/exact_scan.cu",
              "cook_tpu/ops/pallas_match.py:166 (the route of the XLA scan "
              "cook_tpu/ops/match.py:135 with a bonus)", gr["scan_err"],
              gr["exact_scan_bonus_ms"], gr["exact_scan_bonus_plain_ms"],
              gr["exact_scan_bonus_bound"], None,
              chain_floor_ms=gr["exact_scan_bonus_chain_floor_ms"]),
        entry("exact_scan/groups", "cuda",
              "cook_tpu_torch/csrc/exact_scan.cu",
              "cook_tpu/ops/pallas_match.py:166 (the route of the XLA scan "
              "cook_tpu/ops/match.py:135 with G groups)", gr["scan_err"],
              gr["exact_scan_groups_ms"], gr["exact_scan_groups_plain_ms"],
              gr["exact_scan_groups_bound"], None, groups=gr["G"],
              with_bonus_ms=gr["exact_scan_groups_bonus_ms"],
              chain_floor_ms=gr["exact_scan_groups_chain_floor_ms"]),
        entry("best_host", "cuda", "cook_tpu_torch/csrc/best_host.cu",
              "cook_tpu/ops/pallas_match.py:285", bh_err, bh_ms,
              bh_plain_ms, (bh_bound_ms, bh_bound_by), None),
        entry("best_host/groups", "cuda", "cook_tpu_torch/csrc/best_host.cu",
              "cook_tpu/ops/pallas_match.py:285 (the route of the XLA dense "
              "round cook_tpu/ops/match.py:667 with G groups)",
              gr["best_host_err"], gr["best_host_groups_ms"],
              gr["best_host_groups_plain_ms"], gr["best_host_groups_bound"],
              None, groups=gr["G"],
              with_bonus_ms=gr["best_host_groups_bonus_ms"]),
        entry("blocked_cumsum", "cuda",
              "cook_tpu_torch/csrc/blocked_cumsum.cu",
              "none: jnp.cumsum (cook_tpu/ops/segments.py:39, dru.py:136, "
              "match.py:530-563), no pl.pallas_call", cs_err,
              cs_ms[CS_MAIN], cs_plain_ms, cs_bound[CS_MAIN], cs_lib_ms,
              shape=list(CUMSUM_SHAPES[0]), ms_by_shape=cs_ms,
              library_transposed_ms=cs_lib_inner_ms,
              library_rows_ms=cs_lib_rows_ms,
              edge_launches_global_route=by_path[
                  "blocked_cumsum/global"]),
        entry("ordered_scatter", "cuda",
              "cook_tpu_torch/csrc/ordered_scatter.cu",
              "none: jax.ops.segment_sum / .at[].add "
              "(cook_tpu/ops/match.py:490-497, ops/cycle.py:173-179, "
              "scheduler/resident.py:157-159)", sc_err, sc_ms[SC_MAIN],
              sc_plain_ms[SC_MAIN], sc_bound[SC_MAIN], sc_lib_ms[SC_MAIN],
              case=SC_MAIN, ms_by_case=sc_ms,
              longest_run=sc_runs[SC_MAIN],
              sorted_route_launches_by_path=by_path[
                  "ordered_scatter/sorted"]),
        entry("sum_ordered", "cuda", "cook_tpu_torch/csrc/sum_ordered.cu",
              "none: jnp.sum (cook_tpu/ops/match.py:636-649), no "
              "pl.pallas_call", sum_err, sum_ms[H_MAIN], sum_plain_ms,
              (sum_bound_ms, sum_bound_by), sum_lib_ms, n=H_MAIN,
              ms_by_n=sum_ms),
        entry("ordered_scatter/cluster", "cuda",
              "cook_tpu_torch/csrc/ordered_scatter.cu",
              "none: jax.ops.segment_sum (cook_tpu/ops/rebalance.py:191-194,"
              " :219-220; ops/cycle.py:173-179 past 32,768 running tasks), "
              "no pl.pallas_call", max(sc_cl_err, usage[RU]["err"]),
              usage[RU]["cluster_ms"], usage[RU]["plain_ms"],
              usage[RU]["bound"], usage[RU]["index_add_ms"],
              case=f"rebalance_usage_{RU}",
              longest_run=usage[RU]["longest_run"],
              ms_by_case={k: u["cluster_ms"] for k, u in usage.items()},
              cluster_grid=seg.scatter_cluster_grid()),
        entry("sum_ordered/cluster", "cuda",
              "cook_tpu_torch/csrc/sum_ordered.cu",
              "none: jnp.sum past 262,144 elements (cook_tpu/ops/"
              "rebalance.py:304-308), no pl.pallas_call", cl_err,
              float(np.median(cl_ms_turns)), lv_plain_ms, lv_bound,
              lv_lib_ms, n=SUM_LEVELS_N, cluster_ctas=seg.sum_cluster_ctas(),
              empty_launch_ms=empty_ms),
        entry("ordered_scatter/sorted", "cuda",
              "cook_tpu_torch/csrc/ordered_scatter.cu",
              "none: jax.ops.segment_sum past the cluster route's shapes, "
              "no pl.pallas_call", max(sc_err, usage[RU]["sorted_err"]),
              usage[RU]["sorted_ms"], usage[RU]["plain_ms"],
              usage[RU]["bound"], usage[RU]["index_add_ms"],
              case=f"rebalance_usage_{RU}",
              ms_by_case={k: u["sorted_ms"] for k, u in usage.items()},
              ms_note="the whole call: torch.sort of the keys, then the "
                      "walk kernel; timed with the calls routed as before "
                      "the cluster route"),
        entry("sum_ordered/levels", "cuda",
              "cook_tpu_torch/csrc/sum_ordered.cu",
              "none: jnp.sum past 8,388,608 elements, no pl.pallas_call",
              lv_err, float(np.median(lv_ms_turns)), lv_plain_ms, lv_bound,
              lv_lib_ms, n=SUM_LEVELS_N,
              ms_note="the whole call: its level launch and the one-CTA "
                      "kernel; timed with the calls routed as before the "
                      "cluster route")]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def sample_stacks(path, every_s=1.0):
    """Writes the main thread's Python stack to `path` every `every_s`
    seconds (the seconds since the start, then its frames innermost
    first, `file:function:line` joined by " < "): where a run's time
    goes, at no cost to the card."""
    import threading
    import traceback
    main_id = threading.get_ident()

    def sampler():
        with open(path, "w") as f:
            while True:
                time.sleep(every_s)
                frame = sys._current_frames().get(main_id)
                if frame is None:
                    return
                stack = traceback.extract_stack(frame)
                f.write(f"{time.perf_counter() - T_START:.0f} " + " < ".join(
                    f"{os.path.basename(x.filename)}:{x.name}:{x.lineno}"
                    for x in reversed(stack[-14:])) + "\n")
                f.flush()

    threading.Thread(target=sampler, daemon=True).start()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cpu-refs"]:
        CpuRefs.child(sys.argv[2])
    else:
        if sys.argv[1:2] == ["--stack-samples"]:
            sample_stacks(sys.argv[2])
        main()
