"""On-card smoke run of the PyTorch/CUDA port (`madsim_tpu_torch`).

Run from the repo root on a machine with one CUDA card:

    python3 chip_smoke.py

It drives the port's main path — the 5-node Raft fuzz sweep through
`BatchedSim.run` and `summarize`, then FaultPlan chaos, the four other
workloads, the membership, durability and straggler paths with their
workloads, the triage path (trace, shrink, replay), and continuous
batching with the coverage plane, the causal-lineage plane, the telemetry
plane, the coverage-guided explorer and its device-resident search loop,
campaigns and the island federation, the speclang device face, measured
tuning, the fuzz service, the lane mesh, the host runtime under the
differential oracle and every workload's host face — and checks it, in
twenty phases. Every sweep without a refill queue runs
`BatchedSim._run`'s captured blocks (one CUDA graph replay per 32 gated
steps), so the pins and digests of phases 2, 4 and 6-9 are the capture's
correctness gate too:

1. device: needs a CUDA card (exits non-zero without one); prints the
   card's name and power limit as nvidia-smi reports them;
2. parity: 64-lane runs of the headline bench config and the `entry()`
   config on the card and on the CPU, every state leaf and the summary
   equal, and the card's digests equal to the pinned constants (which the
   CPU tests hold against the JAX engine); also the u32 product wrap and
   the argmin tie order on the card;
3. epoch rebase: a mid-run state shifted to just under REBASE_US, stepped
   on the card and on the CPU, leaf-equal;
4. headline sweep: the bench config at 32768 lanes x 5 nodes, 10 virtual
   seconds, max_steps 8000: a warm-up, then the median of 3 fresh-seed
   reps (seeds/s, events/s, step ms), and seeds 0..63 of the warm-up equal
   per seed to phase 2's 64-lane run;
4b. the capture's A/B: 64 gated steps of the bench config at 32768 and at
   16 lanes, eager (the engine's private `_eager_run`) and captured, every
   leaf equal; ms/step, the first block's wall and peak memory of each;
5. profile, in a child process (a profiler session slows its process's
   later steps): torch.profiler over 20 steady eager steps at 32768 lanes
   — kernels launched per step, device idle share, top device kernels —
   and the same steps with and without deterministic mode's
   uninitialized-memory fills, leaves equal; then two captured blocks at
   32768 and at 16 lanes: host launch calls per step, kernels and device
   busy per step when the profiler sees inside the graph, and the replays
   timed by CUDA events; phases 7-16 then run without the fills (as phase
   6 and phase 9's parity runs did);
6. golden (in a child process started after phase 1, beside phases 2
   and 3 and phase 9's parity runs, and joined before phase 4; the card
   is launch-bound and idle most of each step, so two processes share it;
   its lines count seconds from its own start): each of the five
   workloads (raft, paxos, kv, twopc, chain) runs
   its pinned 16-lane, 1500-step CHAOS_PLAN run on the card, and its
   canonical digest must equal the JAX package's GOLDEN value; the Raft
   run has the causal-lineage plane on (`lineage=True`, which must leave
   the digest at GOLDEN), is held leaf for leaf (`nem.*`, `lin.*` and
   `msgs.sent_eid` included) against the CPU, and its lineage leaves hash
   to `digest.PINNED_LINEAGE`; lineage's share of that run's step is
   probed at the same 16 lanes;
7. storm sweep: the bench Raft spec under `compile_plan` of an eight-clause
   plan (the documented raft-storm plan plus LinkClog, LatencySpike and
   MsgLoss) at 32768 lanes x 5 nodes, 10 virtual seconds (cut when a probed
   step time says its two runs would overrun the phase budget; the cut is
   printed): one timed run; every enabled fire kind must fire, and seeds
   0..63 must equal a 64-lane run of the same config per seed in every
   leaf but `key` (a done lane's key advances while any lane of its batch
   runs);
8. workloads (run last, so they absorb the horizon cuts): paxos, chain
   (8192 lanes), kv and twopc (32768 lanes) at their factories' defaults,
   10 virtual seconds (cut when a probed step time says the phase would
   overrun what is left of the script's time target; the cut is printed),
   one timed run each; kv's exact linearizability check runs over lanes
   0..127 and its counts are printed;
9. membership, durability and the straggler tail: `isr_workload` and
   `lease_workload` (buggy 10 virtual s, correct 5), `wal_workload` (buggy
   8, correct 4) and the two-handler unilateral-abort 2PC participant
   under the quiet config with a 5% heavy tail (10 virtual s), each at
   32768 lanes, correct and buggy, one timed run each (a horizon is cut,
   never below half for a buggy build and a quarter for a correct one,
   when a probed step time says the runs would pass PHASE9_END_S; the cut
   is printed). The correct builds never violate,
   every enabled fire
   kind fires and stragglers ride the side pool, each planted bug fires on
   at least the share of lanes its JAX test demands (isr > 64/128, lease >
   16/128, wal >= 8/256, twopc > 0), every violating wal lane lost
   unsynced state, and seeds 0..63 of the buggy 2PC run equal a 64-lane
   card run in every leaf but `key`. Earlier, after phase 3 (beside phase
   6, fills off), a 64-lane two-handler Raft run at
   unequal ring depths and a 64-lane Raft run under Reconfig + DiskFault
   (crash-wipe, skew and the tail composed in) are leaf-equal card/CPU,
   lineage off and on; with lineage on every non-lineage leaf equals the
   lineage-off card run's;
10. triage (after phase 9, before phase 8): the planted deposed-leader
   re-stamp Raft under Crash + Partition (`triage_workload`, 5 virtual s)
   through `run_batch(range(24), ..., max_traces=1,
   shrink_on_violation=True)`. The first violating seed is traced (its
   final state equals its batch lane in every leaf but `key`, its
   TraceRecord stream equals the CPU's leaf for leaf, and its events end
   in VIOLATION at the lane's violation step), shrunk by the default refill
   evaluator in at most 10 batched dispatches with `causal=True` into a v3
   bundle whose causal sha is `digest.PINNED_CAUSAL` and whose digest is
   `digest.PINNED_BUNDLE_V3` (and, with its causal field cleared,
   `digest.PINNED_BUNDLE`), replayed twice by `repro.replay_device` at the
   bundle's step and time and a third time with lineage on (`explain=8`),
   which must reproduce the bundle's causal sha, and its shrunk plan passes
   the twin schedule check under the bundle's ctl. A triage sim under the
   default ctl reproduces phase 2's bench run leaf for leaf (ctl aside).
   The phase runs with telemetry on (it observes only: every gate holds):
   the traced seed's Perfetto file parses with one track per node and one
   flow per delivery edge of `causal.graph_from_trace` of a lineage trace
   of the same steps, the replay writes `--perfetto`'s timeline,
   `causal.slice_perfetto` of the explain slice writes one, and the events
   stream holds `record_batch_result`'s and `record_shrink`'s lines;
11. continuous batching (after phase 10, before phase 8): the spread mix
   (`digest.spread_mix`, after `madsim_tpu/tune.py:499-552`: Crash + 5%
   loss, one admission in 8 at the 1-virtual-second horizon, the rest at
   a tenth of it; triage and coverage on). 32768 admissions run as one
   32768-lane chunked reference and as refill sweeps over 512 lanes (held
   to occupancy >= 0.90 and a lane-step advantage >= 2.0 over the chunked
   path at chunk 512) and over 4096 lanes (ungated; dropped, and said so,
   when the probe says the phase would overrun its budget); every
   per-admission row of each sweep equals the chunked reference's. The
   pinned 256-admission refill run is leaf-equal card/CPU (queue and log
   included) and its row digest is `digest.PINNED_REFILL`; two alternating
   pairs of 20-step bench probes at 32768 lanes with coverage off and on
   give coverage's step cost, with every non-cov leaf equal;
12. lineage's step cost (after phase 11, before phase 8): eight alternating
   pairs of 20-step bench probes at 32768 lanes with lineage off and on,
   every non-lineage leaf equal; the difference of the medians counts as
   resolved only when it exceeds the spread of the off probes;
13. the explorer as campaigns (after phase 12, before phase 8): (a) the
   pinned search (`digest.EXPLORE_RUN`, 16 lanes, 2 generations, on
   `explore_workload`: the planted re-stamp Raft under Crash + Partition
   at 2.5 virtual s) as a `campaign.Campaign` by refill with telemetry
   on, checkpointed after generation 1, dropped and resumed from its
   directory (`Campaign.resume`, which must stand at generation 1) for
   generation 2; and chunked and serial with telemetry off as an
   `Explorer`; each at `digest.PINNED_EXPLORE` (the JAX face's
   fingerprint) and `PINNED_EXPLORE_CORPUS`, the two corpora equal entry
   for entry, telemetry counting 2 dispatches and 2 generations across
   the kill; (b) a full-width search, `Campaign(meta_seed=0, lanes=4096,
   max_shrinks=1)` by refill for 2 generations, then its bug dedup:
   generations and admissions per second, ms per refill iteration, host
   read ms per iteration, coverage and corpus per generation,
   violations, records and witnesses per record, the shrink's wall; the
   coverage curve is monotone, the bug is found in generation 0, every
   violation is a witness of exactly one record, one record carries a
   bundle (the shrink of the first coarse group's first witness),
   stamped with its signature, the campaign and generation 0, that keeps
   the candidate's suppressions and that `campaign.regress` replays green
   at its step and time. Phase 9's end moves earlier by PHASE13_BUDGET_S
   to pay for it;
14. the device-resident search loop (after phase 13, before phase 8):
   (a) one generation boundary at 4096 admissions
   (`devloop_boundary_state`: a seeded refill log with ties in novelty,
   an uploaded ring, union and seen table with planted duplicates) on the
   card equals the CPU's in every leaf, `loop.*` included, inside the
   window (mutate and respawn) and at its end; (b) `Explorer(meta_seed=0,
   lanes=4096, device_loop=True, device_window=2)` with telemetry on
   equals phase 13(b)'s host search (fingerprint, curves, corpus entry
   for entry) with one decode for the window and the events counting its
   2 generations; generations/s, admissions/s, ms per refill iteration,
   ms per boundary and host read ms per iteration beside phase 13(b)'s.
   Phase 9's end moves earlier by PHASE14_BUDGET_S to pay for it;
15. campaigns and the island federation (after phase 14, before phase 8):
   (a) `campaign.merge_and_minimize` of phase 13's two campaigns in one
   dispatch (a lane per merged entry): the kept union equals the merged
   union, every replayed bitmap its recorded one, kept <= merged, and the
   merged corpus refuses a resume; (b) the pinned federation
   (`digest.FEDERATION_RUN`: 2 islands x 8 lanes, exchange every 2, 3
   generations on `explore_workload` at 0.5 virtual s) reaches
   `digest.PINNED_FEDERATION` (the JAX face's) with a non-empty exchange,
   and its device-loop form (windows clipped to 2 + 1) gives the same
   fingerprint, exchange log, coverage and violations; (c)
   `measure.time_scan_ms` on the 16-lane pinned sim beside
   `measure.fresh_seeds`' blocks (not gated). Phase 9's end moves earlier
   by PHASE15_BUDGET_S to pay for it;
16. the speclang device face (after phase 15, before phase 8): (a)
   `python -m madsim_tpu_torch.speclang emit --check` is clean; (b) in
   phase 6's child, twopc-gen's golden run reaches GOLDEN["twopc"] and
   lease-gen under RICH_PLAN (CHAOS_PLAN plus Duplicate and Reorder)
   equals the hand lease on the card and itself on the CPU, leaf for
   leaf; (c) twopc-gen and the hand twopc at 32768 lanes x 1 virtual s
   give one canonical digest; (d) the generated backup, correct and
   buggy, at 32768 lanes x 5 nodes and its default 10 virtual s (cut only
   when a probed step says a build would overrun BACKUP_BUDGET_S, never
   below half for the buggy build nor a quarter for the correct one; the
   cut is printed): the correct build never violates, the buggy build on
   at least 5/64 of its lanes, every enabled fire kind fires, and seeds
   0..63 equal a 64-lane CPU run in every leaf but `key`; (e) the explorer
   over the buggy backup (64 lanes, one generation, one shrink) finds the
   bug, and its shrunk bundle keeps Duplicate or Reorder ((e) runs last
   in phase 18's child, at the host valve's horizon: its line appears
   after phase 17's). Phase 9's end moves earlier by PHASE16_BUDGET_S to
   pay for it;
17. measured tuning and the fuzz service (in phase 18's child, after
   phase 19: its lines appear after phase 19's): (a) `tune.tune_workload` over the registry's raft at 2 virtual s,
   4096 seeds, the quick Tier-A grid, into a fresh cache directory: its
   trials, winner, fallback, baseline and tuned seeds/s and cache key are
   printed; the entry's device kind is the card's sanitized name,
   `load_tuned` finds it, and no timed trial captured a graph (captures
   counted around every trial's timed rep); (b) `run_batch` over the
   same seeds under `tuning="auto"` (that cache), under a forced {chunk
   1024, dispatch_steps 5000, pipeline off} and under {refill_lanes
   1024}: every seed's violated / deadlocked / violation-step row equals
   the default run's (and its step count, on the chunked paths), and
   seeds 0..63 equal a 64-lane CPU run; (c) the Tier-B gate's legs 1-2
   (engine acceptance, zero overflow and saturation) reject the planted
   pool budget (msg_capacity 8) for overflow and pass the shipped config
   at 48 seeds, with the CPU's reasons and summaries; (d)
   `campaign.serve(oracle=False)` on the card over a watch dir with two
   requests at `EXPLORE_RUN`'s size for 2 generations, one slice each per
   round: the pinned explorer run ("planted", under "tuning": "auto" with
   a card entry for its scale) and the registry's raft at 1 virtual s
   (the host valve's horizon); stopped after round 1 and restarted on
   the same dir: "planted" ends at `PINNED_EXPLORE`, under its persisted
   tuning, and raft at the final fingerprint of an uninterrupted CPU
   serve of the same request;
18. the lane mesh (in a child process started after phase 9, beside
   phases 10-16(d), joined before phase 8; the child then runs phases
   19, 17, 16(e) and 20: its lines appear after phase 16(d)'s and count
   seconds from the child's start; the host shows one
   card, so every mesh repeats it and a mesh's shards run one after
   another there): (a) the sharded refill of 32 admissions of
   tests/test_multichip.py's plan with a 10x horizon spread, 4 lanes a
   shard, at 1, 2 and 4 shards: rows equal to the CPU's one-shard
   refill, per-shard occupancy, lane-steps per iteration and ms per
   iteration printed; (b) `run_batch(mesh=<4 shards>)` over 32 seeds,
   chunked and refill (8 lanes a shard): per-seed rows equal to
   `mesh=None`'s on the card and on the CPU, `n_devices` 4; (c) the
   chaos-free violation's shrink on 2 shards: the CPU's unsharded
   bundle; (d) the pinned federation on a 2-shard "islands" mesh:
   sharded, at `PINNED_FEDERATION`; (e) `serve` over [card, card] (two
   slice lanes on two threads) drains three requests at the one-device
   CPU serve's fingerprints, and two threads capture and replay their
   own sims' graphs at once with the CPU's rows; (f) at full width:
   `run_batch` over 32768 seeds of the bench config at 1 virtual s,
   chunked, on 4 shards (8192 lanes a shard) against `mesh=None` at the
   same width, rows equal and both peaks of device memory printed, and
   phase 11's spread mix (32768 admissions) as a sharded refill of 4096
   lanes a shard on 2 shards, rows equal to the unsharded refill of 4096
   lanes. Every check is asserted. Its walls and per-iteration times are
   taken beside phases 10-16(d) (the two processes share the card and
   the host). Phase 9's end moves earlier by CHILD_BUDGET_S, the time the
   child is expected to add to the phases beside it, and later by
   PHASE9_SLACK_S, the slack the runs before phase 17 left below 1150 s;
   its horizons are printed. Before phase 10 and the child start, a
   depth valve probes eager refill iterations at one shard (18(a)'s
   config) and, on a host slower than the reference host (VALVE_REF_MS),
   scales the depths of 16(e) (the buggy backup's horizon) and 17(d)
   (the raft request's horizon) down in proportion, never below their
   floors (printed; the child is given them as one JSON argument);
19. the host runtime under the differential oracle (in phase 18's child,
   after phase 18, under PYTHONHASHSEED=0; (e) in the parent right after
   phase 10): (a) `madsim_tpu_torch.Runtime.run_batch` over 8192 seeds of
   chain's blind-apply spec under heavy-tail stragglers at 8 virtual s
   (tests/test_tpu_chain.py:40-63) violates on more than half the lanes,
   the correct spec on none, the first 16 lanes equal a CPU run, and its
   `host_repros` are a CPU call of the port's chain twin each; (b) a raft5
   lane traced on the card under PLAN8 (tests/test_oracle.py) at 3 virtual
   s: chaos events = schedule = the host NemesisDriver's applied stream,
   skew equal; (c) `oracle.check_seed` on 16 lanes of a card sweep of the
   raft bench config under PLAN8 at 10 virtual s, each MATCH, the pinned
   lane at `digest.PINNED_ORACLE`; under the divergence plant it diverges
   at a reorder_extra draw, the plant lane shrinks to [("reorder", None)]
   and `python -m madsim_tpu_torch.repro <bundle> --backend both` exits 1
   naming the first divergent event; (d) `serve` with its oracle tenant on
   the card, two raft requests at 1 virtual s (one under all eight
   clauses), stopped after round 1 and restarted: the tenant checked
   lanes and compared coin draws with no error or divergence, its cursor
   resumed,
   and oracle.json and the status block equal an uninterrupted CPU
   serve's; the tenant's host seconds are printed beside the slice walls;
   (e) phase 10's card bundle replays with `backend="both"`;
20. the rest of the host faces (in phase 18's child, after 16(e); its
   CPU references in a process of their own; budget PHASE20_BUDGET_S,
   printed beside its wall): (a) `Runtime.run_batch` over 8192 seeds of
   buggy paxos (`buggy_ignore_discovered`, paxos's bench width) at 8
   virtual s violates, and its two host repros (the paxos factory's twin,
   which runs the correct protocol as on the JAX face) are dicts that
   report 0 violations and that a second call returns again; (b) the same
   for the generated buggy backup at its 10 virtual s, its host repros
   the generic twin with the planted bug and the handlers on the card,
   each reporting 1 violation; (c) `kv_workload(2 virtual s,
   device=card).host_repro` on two seeds: the one-lane card run's exact
   linearizability verdict and the kv twin's dict equal the CPU
   process's; (d) the generated twins' `digest.HOSTRT_RUNS` with the
   handlers on the card equal the CPU process's dicts and reach
   `digest.PINNED_HOSTRT`, the buggy backup under `HOSTRT_PLAN` raises the
   CPU's message, and the wall per handler call (the invariant checks
   and the runtime included) is printed beside the CPU's;
   (e) in the parent inside phase 9, the first two violating seeds of the
   buggy isr, lease and wal sweeps go through their factories'
   `host_repro` (host time), each verdict printed.

`python3 chip_smoke.py --contention-probe` runs none of the phases: it
times the host valve's probe alone, over and over beside the child of
phases 18, 19, 17, 16(e) and 20 (at their full depths), and alone again, and
prints the probe's slowdown in each of the child's phases.

The port has no hand-written kernel (the JAX package has no Pallas kernel
to port), so the kernel list is empty; the reason is printed on the line
before it. The full measurements are printed as one `report: {...}` line.
The last line is the run's result; any failed check exits non-zero before
it.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

CARD = "cuda"
LANES = 32768
SEEDS_SMALL = 64
MAX_STEPS = 8000
PROFILE_STEPS = 20
# the argument that runs phase 5's profile as a child process
PROFILE_FLAG = "--phase5-profile"
# the argument that runs phase 6 (the golden runs) as a child process
GOLDEN_FLAG = "--phase6-golden"
# the argument that runs phases 18, 19, 17, 16(e) and 20 as a child process,
# with the valve's depths as one JSON object after it
MESH_FLAG = "--phase18-mesh"
# the argument that times phases 2, 3, 9's parity runs and phase 6 one
# after the other, then overlapped (serial_probe), without the rest of the
# script
SERIAL_FLAG = "--serial-probe"
# the argument that times the valve's probe alone, over and over beside
# the child of MESH_FLAG, and alone again (contention_probe), without the
# rest of the script
CONTENTION_FLAG = "--contention-probe"
# phase 19's CPU references run in a process of their own, beside its card
# legs (a thread would share the GIL with the card's host-bound launches)
ORACLE_CPU_FLAG = "--phase19-cpu"
PHASE4_BUDGET_S = 300.0
STORM_LANES = 32768
# (45 s since phase 13 came: on one H100 the script ended at 1114 s with
# phases 8 and 9 at their floors, so the storm's horizon gives the margin)
PHASE7_BUDGET_S = 45.0
# phase 8: (workload, lanes, max_steps at 10 virtual s) as bench.py runs
# them
WORKLOADS = (
    ("paxos", 8192, 18_000),
    ("chain", 8192, 26_000),
    ("kv", 32768, 14_000),
    ("twopc", 32768, 18_000),
)
# phase 9: (workload, lanes, virtual seconds of the correct build, of the
# buggy build). The correct isr, lease and wal builds run half the buggy
# horizon, to make room for phase 10; their checks (no violation, every
# enabled kind fires) hold there
MEMBERSHIP = (
    ("isr", 32768, 5.0, 10.0),
    ("lease", 32768, 5.0, 10.0),
    ("wal", 32768, 4.0, 8.0),
    ("twopc_tail", 32768, 10.0, 10.0),
)
# the share of lanes each planted bug must violate on (its JAX test's
# demand: isr > 64/128, lease > 16/128, wal >= 8/256, twopc > 0), and
# whether the bound itself passes
BUG_SHARE = {"isr": (64 / 128, False), "lease": (16 / 128, False),
             "wal": (8 / 256, True), "twopc_tail": (0.0, False)}
PHASE9_MAX_STEPS = 40_000
# steps of each phase-9 run at its MEMBERSHIP horizon (the longest lane of
# 32768, measured by this script on an H100 at the full horizons; for the
# halved correct builds, half that count, an estimate), to estimate its
# wall from a probed step time
PHASE9_STEPS = {
    "isr_correct": 1798, "isr_buggy": 2819,
    "lease_correct": 1126, "lease_buggy": 2251,
    "wal_correct": 1194, "wal_buggy": 2387,
    "twopc_tail_correct": 2071, "twopc_tail_buggy": 2087,
}
# phase 9's runs must end by then (its two 64-lane card/CPU parity runs,
# phase 10's at most PHASE10_BUDGET_S and phase 11's PHASE11_BUDGET_S
# follow); phase 8 then gets what is left of TARGET_S
# (phase 10's two causal legs, the shrink's lineage replay and the
# replay's, took 23.8 s together on one H100: both are in its budget and
# in the anchor below, so phase 9's horizons stay where they were)
PHASE10_BUDGET_S = 224.0
PHASE11_BUDGET_S = 60.0
# phases 13 (the explorer), 14 (the device loop) and 15 (campaigns and the
# federation) buy their time from
# phase 9: the anchor moves earlier by their budgets, so phase 9's rule
# cuts its horizons to make room (the buggy cells never below half, the
# correct cells never below a quarter)
PHASE13_BUDGET_S = 160.0
PHASE14_BUDGET_S = 45.0
PHASE15_BUDGET_S = 45.0
# phase 16 (the speclang device face: full-width twopc-gen and backup, the
# explorer on the buggy backup) buys its time from phase 9 the same way
PHASE16_BUDGET_S = 120.0
# phases 18 (the lane mesh), 19 (the host oracle), 17 (measured tuning
# and the fuzz service) and 16(e) (the explorer over the buggy backup) run
# one after another in one child process beside phases 10-16(d), whose
# eager steps leave the card idle most of the time; they buy from phase 9
# the time the child is expected to add to the phases beside it: beside
# its phases 18 / 19 / 17 / 16(e) an eager refill iteration here took
# 1.11 / 1.23 / 1.13 / 1.20x its time alone (`--contention-probe` on one
# H100, 700 W), so ~60-120 s over 10-16(d)'s ~520 s on the reference
# host; 140 s keeps the anchor where phases 17 and 18 left it
CHILD_BUDGET_S = 140.0
# before phase 17, five runs on one H100 ended at 884.0-973.6 s with
# phase 9 at its floors, ending ~90 s past the anchor below: those 90 s
# and the 176 s the slowest run left below 1150 s go back to phase 9,
# toward its full horizons
PHASE9_SLACK_S = 265.0
# phase 6 runs in a child process beside phases 2 and 3 and phase 9's
# parity runs (all correctness checks: the card is launch-bound and idle
# most of each step, so two processes share it), which the anchor below
# was set without: the overlap moves phase 9's start earlier by about
# this much
PHASE6_OVERLAP_S = 120.0
PHASE9_END_S = (984.0 + PHASE9_SLACK_S - PHASE10_BUDGET_S
                - PHASE11_BUDGET_S - PHASE13_BUDGET_S - PHASE14_BUDGET_S
                - PHASE15_BUDGET_S - PHASE16_BUDGET_S - CHILD_BUDGET_S
                - PHASE6_OVERLAP_S)
# the least share of its horizon a phase-9 cell may be cut to: the buggy
# cells keep half (the JAX face's bug shares were measured there), the
# correct cells' gates (no violation, every enabled kind fires) are
# printed with their fires at any horizon
PHASE9_FLOOR = {False: 0.25, True: 0.5}
# phase 10: the triage sweep's seeds, and the spec reference its bundle
# carries (resolved from the repo root by repro.resolve_spec)
TRIAGE_SEEDS = 24
TRIAGE_SPEC_REF = "chip_smoke:planted_restamp_spec"
# phase 13: the explorer's workload horizon (explore_workload), and the
# full-width search's lanes and generations (fixed at 2: one boundary
# between generations and the final fold, which phase 14's device loop
# runs again)
EXPLORE_H_US = 2_500_000
EXPLORE_LANES = 4096
EXPLORE_GENERATIONS_FLOOR = 2
# phase 14: the seed of the boundary state held card against CPU
DEVLOOP_STATE_SEED = 14
# phase 11: the refill spread mix (digest.spread_mix) at the JAX smoke's
# horizon, its admissions, the refill lanes held to the occupancy floor,
# the wider lane count run beside them (ungated: at 8 waves the drain tail
# of the last long admissions keeps its occupancy low), and the
# per-admission step budget
REFILL_H_US = 1_000_000
REFILL_ADMISSIONS = 32768
REFILL_LANES = 512
REFILL_WIDE_LANES = 4096
REFILL_MAX_STEPS = 50_000
# iterations of each refill sweep and steps of the chunked reference (this
# script's CPU rehearsal: per-seed step counts do not depend on lanes, and
# a list-scheduling model of them gives the refill engine's iterations
# exactly), to estimate the phase's wall from a probed step
REFILL_EST_STEPS = {REFILL_LANES: 1037, REFILL_WIDE_LANES: 187,
                    "chunked": 129}
# the bars: occupancy (the JAX smoke's floor) and the lane-step advantage
# over the chunked path at chunk = REFILL_LANES
REFILL_OCCUPANCY_FLOOR = 0.90
REFILL_ADVANTAGE_FLOOR = 2.0
# a plane's step cost (coverage in phase 11, lineage in phases 6 and 12):
# steps per probe, and alternating off/on probe pairs (ab_probe)
AB_STEPS = 20
COV_PAIRS = 2
LINEAGE_PAIRS_SMALL = 4
LINEAGE_PAIRS = 8
# phase 10's replay prints (and cross-checks) the last links of the slice
EXPLAIN_LINKS = 8
# the buggy run whose seeds 0..63 are held against a 64-lane run (the
# two-handler path and the straggler pool; one such run fits the time)
PHASE9_INDEPENDENCE = "twopc_tail"
PHASE9_PARITY_STEPS = 200
# phase 4b: the captured `_run` against the eager loop, gated steps from
# one initial state at each lane count
CAPTURE_AB_LANES = (LANES, 16)
CAPTURE_AB_STEPS = 64
# phase 16(d): backup's lanes, the steps of its longest lane at the
# default 10-virtual-second horizon (972 correct and 1025 buggy of 32768
# lanes on one H100; 973 of 64 lanes on the CPU), each build's share
# of PHASE16_BUDGET_S, the least share of its horizon a build may be cut
# to, and the buggy build's share of violating lanes (the JAX test's 5 of
# 64, tests/test_speclang.py:241)
BACKUP_LANES = 32768
BACKUP_EST_STEPS = 1100
BACKUP_BUDGET_S = 30.0
BACKUP_FLOOR = {False: 0.25, True: 0.5}
BACKUP_BUG_SHARE = 5 / 64
# phase 16(e): the explorer's lanes over the buggy backup (the JAX deep
# test's, tests/test_speclang.py:251-276)
SPECLANG_EXPLORE_LANES = 64
# 16(e)'s buggy backup horizon (the workload's default); the host valve may
# cut it, never below VALVE_FLOORS' (16(d)'s floor for a buggy build)
BACKUP_EXPLORE_SECS = 10.0
# phase 17: the Tier-A tune's sweep (the registry's raft at TUNE_SECS
# virtual seconds, TUNE_SEEDS seeds, the quick grid), the forced Tier-A
# assignments run beside its cache hit, the Tier-B gate's seeds (the JAX
# test's, tests/test_tune.py:426-440), and serve's requests: the pinned
# explorer run (as "planted", on explore_workload) and the registry's raft
# at SERVE_SECS (which the host valve may cut), both at EXPLORE_RUN's size
# for SERVE_GENERATIONS; 19(d) serves its raft requests at that size, at
# SERVE_SECS uncut
TUNE_SEEDS = 4096
TUNE_SECS = 2.0
TUNE_FORCED = {"forced": {"chunk": 1024, "dispatch_steps": 5000,
                          "pipeline": False},
               "refill": {"refill_lanes": 1024}}
GATE_SEEDS = 48
SERVE_SECS = 1.0
SERVE_GENERATIONS = 2
# the tuned-cache entry phase 17(d) writes for its "planted" request's
# scale (16 lanes): a hit for the card, so the request runs tuned
SERVE_TUNED = {"refill_lanes": 8, "dispatch_steps": 5000, "pipeline": False}
# phase 18: the lane mesh on one card (every mesh repeats the card): (a)
# the sharded refill of MESH_ADMISSIONS admissions of the multichip plan
# at MESH_H_US with the 10x horizon spread (one long admission in 4),
# MESH_LANES lanes per shard, at each shard count of MESH_SHARDS; (b)
# run_batch over MESH_BATCH_SEEDS seeds on a MESH_BATCH_SHARDS-shard mesh,
# chunked and refill (MESH_BATCH_REFILL lanes per shard); (c) the
# chaos-free violation's shrink on a 2-shard mesh; (d) the pinned
# federation on a 2-shard "islands" mesh; (e) serve over two slice lanes
# on the card with MESH_SERVE_REQUEST x 3, and two threads' captured runs
# of MESH_THREAD_LANES lanes
MESH_H_US = 500_000
MESH_ADMISSIONS = 32
MESH_LANES = 4
MESH_SHARDS = (1, 2, 4)
MESH_BATCH_SEEDS = 32
MESH_BATCH_SHARDS = 4
MESH_BATCH_REFILL = 8
MESH_SERVE_REQUEST = {"workload": "raft", "virtual_secs": 0.2, "lanes": 8,
                      "chunk": 8, "generations": 2, "shrink": False}
MESH_THREAD_LANES = 64
# (f): the bench config's horizon (virtual s) of the full-width chunked
# run_batch over STORM_LANES seeds on MESH_BATCH_SHARDS shards, and the
# shard count of phase 11's spread mix as a sharded refill of
# REFILL_WIDE_LANES lanes a shard
MESH_WIDE_SECS = 1.0
MESH_REFILL_SHARDS = 2
# phase 19 (the host runtime under the differential oracle) runs in the
# child after phase 18 (83.5-97.8 s there on one H100 without traced
# seeds in (a), PERF.md section 6); 19(a): chain's blind apply under heavy-tail stragglers at chain's bench
# width (tests/test_tpu_chain.py:40-63 at 8192 lanes), and the host repros
CHAIN_TAIL_SEEDS = 8192
CHAIN_TAIL_SECS = 8.0
CHAIN_HOST_REPROS = 4
# 19(b): tests/test_oracle.py's PLAN8 horizon and seed
PLAN8_H_US = 3_000_000
PLAN8_SEED = 7
# 19(c): the lanes of the card sweep the oracle replays at the bench horizon
ORACLE_SEEDS = 16
# phase 20 (the host faces of item 16's rest, in the child after 16(e)):
# its budget (printed beside its wall); (a) buggy paxos through
# Runtime.run_batch at paxos's bench width and PAXOS_REPRO_SECS (the
# factory's twin runs the correct protocol: its repros report 0
# violations), (b) the generated buggy backup at the same width and its
# default horizon (its twin carries the bug: 1 violation a repro), each
# with HOST_FACE_REPROS host repros run twice, at fixed horizons; (c)
# kv's two-part host_repro on KV_REPRO_SEEDS at KV_REPRO_SECS; (d) the
# generated twins' digest.HOSTRT_RUNS on the card; (e) in the parent's
# phase 9, the first HOST_FACE_REPROS violating seeds of the buggy isr,
# lease and wal sweeps through their factories' host_repro
PHASE20_BUDGET_S = 90.0
HOST_FACE_LANES = 8192
PAXOS_REPRO_SECS = 8.0
BACKUP_REPRO_SECS = 10.0
HOST_FACE_REPROS = 2
KV_REPRO_SECS = 2.0
KV_REPRO_SEEDS = (1, 2)
# phase 20's CPU references run in a process of their own, as phase 19's
HOSTFACE_CPU_FLAG = "--phase20-cpu"
# the host valve: the reference host, on which the script's phases were
# budgeted, took 29.4 ms per eager refill iteration at one shard (phase
# 18(a)'s one-shard run, PERF.md section 6; H100 80GB HBM3, 700 W); a
# slower host scales the depths of 16(e) and 17(d) down in proportion,
# never below these floors (virtual s)
VALVE_REF_MS = 29.4
VALVE_FLOORS = {"backup_explore_secs": 5.0, "serve_secs": 0.5}
# those depths uncut, and the valve's grain for each (whole tenths of a
# virtual second for 16(e), whole twentieths for 17(d))
FULL_DEPTHS = {"backup_explore_secs": BACKUP_EXPLORE_SECS,
               "serve_secs": SERVE_SECS}
DEPTH_GRAIN = {"backup_explore_secs": 10, "serve_secs": 20}
# the whole script must end well inside the 1200 s the card run allows;
# phase 8 (run last) splits what is left of this target across its runs
TARGET_S = 1050.0
T_START = time.perf_counter()
KV_CHECK_LANES = 128


def phase(n: int, msg: str) -> None:
    elapsed = time.perf_counter() - T_START
    print(f"phase {n} [{elapsed:.0f} s]: {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def leaves_equal(a: dict, b: dict) -> list:
    """Names of the leaves that differ (or exist on one side only)."""
    return sorted(
        k for k in set(a) | set(b)
        if k not in a or k not in b or not np.array_equal(a[k], b[k])
    )


def summaries_equal(a: dict, b: dict) -> list:
    """Keys that differ; float lane means at rtol 1e-6 (summed in another
    order on each device), everything else exactly."""
    bad = []
    for k in set(a) | set(b):
        x, y = a.get(k), b.get(k)
        if isinstance(x, float) and isinstance(y, float):
            if not np.isclose(x, y, rtol=1e-6, atol=0):
                bad.append(k)
        elif x != y:
            bad.append(k)
    return sorted(bad)


def first_lanes(state, n: int):
    """The first n lanes of every leaf of a state (a fresh 64-lane view)."""
    from madsim_tpu_torch.tpu.spec import tree_map

    return tree_map(lambda t: t[:n], state)


def storm_plan():
    """The documented raft-storm plan (Crash, Partition, Duplicate, Reorder,
    ClockSkew) plus LinkClog, LatencySpike and MsgLoss at their defaults,
    so every ported clause fires."""
    from madsim_tpu_torch import nemesis as nm

    return nm.FaultPlan(name="raft-storm+", clauses=(
        nm.Crash(interval_lo_us=500_000, interval_hi_us=2_000_000),
        nm.Partition(),
        nm.Duplicate(rate=0.05),
        nm.Reorder(rate=0.1, window_us=50_000),
        nm.ClockSkew(max_ppm=20_000),
        nm.LinkClog(),
        nm.LatencySpike(),
        nm.MsgLoss(rate=0.05),
    ))


def planted_restamp_spec():
    """Raft with the deposed-leader re-stamp bug planted
    (tests/test_triage.py:40-57, over the port's [L, N] axes): a deposed
    leader re-stamps its stale log tail with the newly adopted term, so
    committed prefixes disagree under elections that chaos forces."""
    from madsim_tpu_torch.tpu import make_raft_spec
    from madsim_tpu_torch.tpu.raft import LEADER
    from madsim_tpu_torch.tpu.spec import replace_handlers

    spec = make_raft_spec(5, client_rate=0.8)

    def buggy_on_message(s, nid, src, kind, payload, now, key):
        state, out, timer = spec.on_message(s, nid, src, kind, payload, now,
                                            key)
        deposed = (s.role == LEADER) & (state.role != LEADER)
        log_idx = torch.arange(s.log_term.shape[-1], dtype=torch.int32,
                               device=s.log_term.device)
        in_log = log_idx < state.log_len[..., None]
        log_term = torch.where(deposed[..., None] & in_log,
                               state.term[..., None], state.log_term)
        return state._replace(log_term=log_term), out, timer

    return replace_handlers(spec, on_message=buggy_on_message)


def triage_workload():
    """The planted re-stamp Raft under Crash + Partition (the schedule
    clauses of tests/test_triage.py:64-70) over a 5-virtual-second config
    without base loss: the shrinker has real occurrence atoms to drop."""
    import dataclasses

    from madsim_tpu_torch import nemesis as nm
    from madsim_tpu_torch.tpu import SimConfig, compile_plan, raft_workload

    plan = nm.FaultPlan(name="sched-only", clauses=(
        nm.Crash(interval_lo_us=400_000, interval_hi_us=1_500_000,
                 down_lo_us=300_000, down_hi_us=1_000_000),
        nm.Partition(interval_lo_us=300_000, interval_hi_us=1_200_000,
                     heal_lo_us=400_000, heal_hi_us=1_500_000),
    ))
    cfg = compile_plan(plan, SimConfig(horizon_us=5_000_000, loss_rate=0.0))
    return dataclasses.replace(
        raft_workload(spec=planted_restamp_spec()), config=cfg
    )


def explore_workload(horizon_us: int = EXPLORE_H_US):
    """The explorer's pinned workload: the planted re-stamp Raft under the
    Crash + Partition plan of tests/test_explore.py:42-63 at a
    2.5-virtual-second horizon (or `horizon_us`) without base loss, 20000
    steps at most."""
    import dataclasses

    from madsim_tpu_torch import nemesis as nm
    from madsim_tpu_torch.tpu import SimConfig, compile_plan, raft_workload

    plan = nm.FaultPlan(name="explore-test", clauses=(
        nm.Crash(interval_lo_us=300_000, interval_hi_us=900_000,
                 down_lo_us=200_000, down_hi_us=700_000),
        nm.Partition(interval_lo_us=250_000, interval_hi_us=800_000,
                     heal_lo_us=300_000, heal_hi_us=900_000),
    ))
    cfg = compile_plan(plan, SimConfig(horizon_us=int(horizon_us),
                                       loss_rate=0.0))
    return dataclasses.replace(
        raft_workload(spec=planted_restamp_spec()), config=cfg,
        host_repro=None, max_steps=20_000,
    )


def timed_run(sim, seeds, max_steps):
    """(final state, wall seconds) of one synchronized sweep."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = sim.run(seeds, max_steps)
    torch.cuda.synchronize()
    return st, time.perf_counter() - t0


def probe(sim, lanes: int, steps: int = 10):
    """(wall ms per step of `steps` steps after 3 warm steps at `lanes`,
    the state after them)."""
    st = sim.init(range(lanes))
    for _ in range(3):
        st = sim.step(st)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        st = sim.step(st)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3, st


def block_probe(sim, lanes: int, blocks: int = 2):
    """(wall ms per step of `blocks` blocks of `sim.run`'s loop, the state
    after them) at `lanes`, after one block that captures the graph on a
    CUDA sim: the step time a sweep of this sim pays."""
    from madsim_tpu_torch.tpu.engine import DONE_CHECK_STEPS

    st = sim._run(sim.init(range(lanes)), DONE_CHECK_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = sim._run(st, blocks * DONE_CHECK_STEPS)
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) / (blocks * DONE_CHECK_STEPS) * 1e3,
            st)


def ab_probe(make_sim, lanes: int, pairs: int) -> dict:
    """Step ms of a plane off and on (`make_sim(on)` builds the sim):
    `pairs` alternating pairs of AB_STEPS-step probes (off, on / on,
    off / ...) after one discarded off probe, which also grows the
    allocator's cache. Returns both lists, their medians, the spread of
    the off probes (the distance between their quartiles), the pairs the
    plane made slower, and each side's last state's leaves."""
    from madsim_tpu_torch.tpu.convert import state_to_numpy

    ms = {False: [], True: []}
    states = {}
    order = [False] + [on for i in range(pairs)
                       for on in ((False, True) if i % 2 == 0
                                  else (True, False))]
    for i, on in enumerate(order):
        t, st = probe(make_sim(on), lanes, AB_STEPS)
        if i:
            ms[on].append(t)
        states[on] = state_to_numpy(st)
        del st
    q = statistics.quantiles(ms[False], n=4)
    return {
        "off_ms": ms[False], "on_ms": ms[True],
        "off_median": statistics.median(ms[False]),
        "on_median": statistics.median(ms[True]),
        "off_iqr": q[2] - q[0],
        "slower_pairs": sum(b > a for a, b in zip(ms[False], ms[True])),
        "pairs": pairs, "states": states,
    }


def ab_line(r: dict) -> str:
    """One phase-line rendering of an ab_probe result."""
    d = r["on_median"] - r["off_median"]
    verdict = ("resolved" if abs(d) > r["off_iqr"]
               else "unresolved: within the off probes' spread")
    return (f"off {[round(x, 3) for x in r['off_ms']]} / on "
            f"{[round(x, 3) for x in r['on_ms']]} ms/step, medians "
            f"{r['off_median']:.3f} / {r['on_median']:.3f} ({d:+.3f} ms/step,"
            f" {verdict} {r['off_iqr']:.3f}), on slower in "
            f"{r['slower_pairs']} of {r['pairs']} pairs")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    torch.use_deterministic_algorithms(True)
    cuda = torch.device(CARD)
    report: dict = {}

    # -- 1. device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    report["card"] = card
    print(card, flush=True)
    phase(1, f"device {kind!r}, count {torch.cuda.device_count()}, "
             f"torch {torch.__version__}, cuda {torch.version.cuda}")

    # -- 6. the golden runs, in a child process beside phases 2, 3 and 9's
    # parity runs; joined before phase 4's timings
    small, parity, report["overlap"] = overlapped_start(cuda, report)
    phase_4_5_on(cuda, report, small, card, parity)
    return report


def overlapped_start(cuda, report: dict) -> tuple:
    """Phases 2, 3 and 9's parity runs in this process while phase 6 runs
    in a child process: (phase 2's leaves, the parity rows, both sides'
    walls)."""
    t0 = time.perf_counter()
    golden = spawn_child(GOLDEN_FLAG)
    try:
        small, parity = phases_2_3_parity(cuda, report)
        main_s = time.perf_counter() - t0
        res = join_child(golden, "phase 6", 1200)
    finally:
        if golden.poll() is None:
            golden.kill()
            golden.wait()
    report["golden"] = res["golden"]
    report["speclang_golden"] = res["speclang"]
    walls = {"main_s": main_s, "golden_s": res["wall_s"],
             "joined_s": time.perf_counter() - t0}
    phase(6, f"overlapped: phases 2, 3 and 9's parity runs took "
             f"{main_s:.1f} s in this process, phase 6 "
             f"{res['wall_s']:.1f} s in its own; joined after "
             f"{walls['joined_s']:.1f} s")
    return small, parity, walls


def phases_2_3_parity(cuda, report: dict) -> tuple:
    """Phases 2 and 3 (fills on), then phase 9's 64-lane parity runs
    (fills off, as in phases 6-16): (phase 2's leaves, the parity rows)."""
    import torch.utils.deterministic as tdet

    small = phases_2_3(cuda, report)
    tdet.fill_uninitialized_memory = False
    try:
        parity = phase9_parity(cuda)
    finally:
        tdet.fill_uninitialized_memory = True
    return small, parity


def serial_probe() -> dict:
    """main()'s overlapped start taken one part after the other (phases 2,
    3 and 9's parity runs in this process, then phase 6's child process
    alone), then overlapped as main() runs it: both walls from one
    process, back to back."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    torch.use_deterministic_algorithms(True)
    cuda = torch.device(CARD)
    print(card_line(), flush=True)
    t0 = time.perf_counter()
    phases_2_3_parity(cuda, {})
    main_s = time.perf_counter() - t0
    res = join_child(spawn_child(GOLDEN_FLAG), "phase 6", 1200)
    serial = {"main_s": main_s, "golden_s": res["wall_s"],
              "serial_s": time.perf_counter() - t0}
    phase(6, f"serial: phases 2, 3 and 9's parity runs took {main_s:.1f} s,"
             f" then phase 6 {res['wall_s']:.1f} s in its own process; "
             f"{serial['serial_s']:.1f} s in all")
    return {"serial": serial, "overlapped": overlapped_start(cuda, {})[2]}


def spawn_child(*args: str):
    """This script in a child process, with `args`; join_child reads it.
    Its output goes to unnamed files (a pipe read only at the join would
    stall a child that fills it). The child's str hash seed is pinned
    (PYTHONHASHSEED=0), as the host runtime asks for cross-process
    repro."""
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(2)]
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *args],
        stdout=logs[0], stderr=logs[1], text=True,
        env=dict(os.environ, PYTHONHASHSEED="0"),
    )
    child.logs = logs
    return child


def join_child(child, what: str, timeout_s: float) -> dict:
    """Wait for a child process of this script, print its phase lines and
    return its result (its last stdout line, JSON)."""
    try:
        child.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        child.kill()
        child.wait()
    texts = []
    for f in child.logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    out, err = texts
    check(child.returncode == 0, f"{what}'s process failed: {err[-3000:]}")
    lines = out.strip().splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    return json.loads(lines[-1])


def phases_2_3(cuda, report: dict) -> dict:
    """Phases 2 (parity) and 3 (epoch rebase); returns phase 2's 64-lane
    leaves by pinned run name."""
    from madsim_tpu_torch.tpu import BatchedSim, summarize
    from madsim_tpu_torch.tpu import prng
    from madsim_tpu_torch.tpu.convert import state_to_numpy
    from madsim_tpu_torch.tpu.digest import PINNED, canonical_digest, pinned_run
    from madsim_tpu_torch.tpu.raft import make_raft_spec, raft_bench_config
    from madsim_tpu_torch.tpu.spec import (
        INF_GUARD, REBASE_US, expand_to, tree_map,
    )

    # -- 2. parity on the card: u32 wrap, tie order, whole runs
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32),
        rng.integers(0, 2**32, size=1 << 20, dtype=np.uint64).astype(np.uint32),
    ])
    for c in (0x85EBCA6B, 0xC2B2AE35, prng.GOLDEN):
        got = prng._mul32(torch.as_tensor(x.astype(np.int64), device=cuda), c)
        want = (x * np.uint32(c)).astype(np.int64)
        check(np.array_equal(got.cpu().numpy(), want),
              f"u32 product wrap differs on the card (c={c:#x})")
    ties = rng.integers(0, 3, size=(4096, 40)).astype(np.int64)
    check(np.array_equal(torch.as_tensor(ties, device=cuda).argmin(1).cpu()
                         .numpy(), ties.argmin(1)),
          "argmin tie order on the card is not the first minimum")
    small = {}
    for name in ("raft_bench", "raft_entry"):
        spec, cfg, seeds, max_steps = pinned_run(name)
        t0 = time.perf_counter()
        st_gpu = BatchedSim(spec, cfg, device=cuda).run(seeds, max_steps)
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        st_cpu = BatchedSim(spec, cfg, device="cpu").run(seeds, max_steps)
        g, c = state_to_numpy(st_gpu), state_to_numpy(st_cpu)
        bad = leaves_equal(g, c)
        check(not bad, f"{name}: card and CPU leaves differ: {bad}")
        sg, sc = summarize(st_gpu, spec), summarize(st_cpu, spec)
        bad = summaries_equal(sg, sc)
        check(not bad, f"{name}: card and CPU summaries differ: {bad}")
        dg = canonical_digest(g)
        check(dg == PINNED[name],
              f"{name}: card digest {dg} != pinned {PINNED[name]}")
        small[name] = g
        report[f"parity_{name}"] = {
            "lanes": len(seeds), "steps": int(g["steps"].max()),
            "card_s": t_gpu, "digest": dg,
        }
        phase(2, f"{name}: {len(seeds)} lanes x {int(g['steps'].max())} "
                 f"steps, {len(g)} leaves equal card/CPU, summary equal, "
                 f"digest {dg[:16]} == pinned")

    # -- 3. epoch rebase on the card
    kw = dict(n_nodes=5, client_rate=0.1, log_capacity=16)
    cfg400 = raft_bench_config(400.0)
    sim_g = BatchedSim(make_raft_spec(**kw), cfg400, device=cuda)
    sim_c = BatchedSim(make_raft_spec(**kw), cfg400, device="cpu")
    mid = sim_g.run_steps(sim_g.init(range(SEEDS_SMALL)), 120)
    delta = (REBASE_US - 3_000) - mid.clock

    def shifted(x):  # move live offsets so the clock sits under REBASE_US
        return torch.where(x < INF_GUARD, x + expand_to(delta, x), x)

    mid = mid._replace(
        clock=shifted(mid.clock), timer=shifted(mid.timer),
        chaos_at=shifted(mid.chaos_at), part_at=shifted(mid.part_at),
        msgs=mid.msgs._replace(deliver=shifted(mid.msgs.deliver)),
    )
    g = state_to_numpy(sim_g.run_steps(mid, 60))
    c = state_to_numpy(sim_c.run_steps(tree_map(lambda t: t.cpu(), mid), 60))
    bad = leaves_equal(g, c)
    check(not bad, f"rebase: card and CPU leaves differ: {bad}")
    check(bool((g["epoch"] == 1).all()), "rebase: not every lane rebased")
    phase(3, f"epoch rebase: {SEEDS_SMALL} lanes x 60 steps from a clock "
             f"{REBASE_US - 3000} us state, every lane at epoch 1, "
             f"{len(g)} leaves equal card/CPU")
    return small


def phase_4_5_on(cuda, report: dict, small: dict, card: str,
                 parity: dict) -> None:
    """Phases 4, 5, 7, 9-18 and 8, in that order, into `report`."""
    from madsim_tpu_torch.tpu import BatchedSim, summarize
    from madsim_tpu_torch.tpu.raft import make_raft_spec, raft_bench_config

    kw = dict(n_nodes=5, client_rate=0.1, log_capacity=16)

    # -- 4. headline sweep
    spec = make_raft_spec(**kw)
    virtual_secs = 10.0
    sim = BatchedSim(spec, raft_bench_config(virtual_secs), device=cuda)
    probe_ms, probe_st = block_probe(sim, LANES)
    # a 10 s horizon takes ~1210 steps; 4 sweeps must fit the phase budget
    est_s = 4 * 1210 * probe_ms / 1e3
    cut = ""
    if est_s > PHASE4_BUDGET_S:
        virtual_secs = max(1.0, round(10.0 * PHASE4_BUDGET_S / est_s, 1))
        cut = (f" (cut: virtual_secs 10 -> {virtual_secs}; 4 sweeps at "
               f"{probe_ms:.2f} ms/step were estimated at {est_s:.0f} s)")
        sim = BatchedSim(spec, raft_bench_config(virtual_secs), device=cuda)
    del probe_st
    t_phase = time.perf_counter()
    warm = sim.run(range(LANES), MAX_STEPS)
    torch.cuda.synchronize()
    warm_np = {k: getattr(warm, k)[:SEEDS_SMALL].cpu().numpy()
               for k in ("violated", "violation_step", "events", "steps",
                         "clock", "epoch")}
    del warm
    torch.cuda.reset_peak_memory_stats()
    walls, states = [], []
    for rep in range(3):
        seeds = np.arange(LANES, dtype=np.int64) + (rep + 1) * LANES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = sim.run(seeds, MAX_STEPS)
        done_all = bool(st.done.all())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check(done_all, "headline sweep hit max_steps before the horizon")
        states.append(summarize(st, spec) | {
            "steps_run": int(st.steps.max())})
        del st
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    wall = statistics.median(walls)
    s = states[walls.index(wall)]
    head = {
        "lanes": LANES, "nodes": 5, "virtual_secs": virtual_secs,
        "walls_s": walls, "wall_s": wall, "seeds_per_sec": LANES / wall,
        "events_per_sec": s["total_events"] / wall,
        "step_ms": wall / s["steps_run"] * 1e3, "steps_run": s["steps_run"],
        "total_overflow": s["total_overflow"], "violations": s["violations"],
        "log_saturated_lanes": s["log_saturated_lanes"],
        "peak_mem_gib": peak_gib, "probe_step_ms": probe_ms,
        "phase_s": time.perf_counter() - t_phase,
    }
    report["headline"] = head
    check(s["total_overflow"] == 0, f"headline overflow {s['total_overflow']}")
    if virtual_secs == 10.0:
        ref = small["raft_bench"]
        for k, v in warm_np.items():
            check(np.array_equal(v.astype(np.int64), ref[k]),
                  f"batch independence: seeds 0..63 differ in {k!r} between "
                  f"the {LANES}-lane and the 64-lane run")
        indep = "seeds 0..63 equal the 64-lane run"
    else:
        indep = "batch independence not checked (horizon cut)"
    phase(4, f"headline {LANES} lanes x 5 nodes, {virtual_secs} virtual s"
             f"{cut}: {head['seeds_per_sec']:.1f} seeds/s, "
             f"{head['events_per_sec']:.0f} events/s, "
             f"{head['step_ms']:.3f} ms/step x {head['steps_run']} steps "
             f"(median of {[round(w, 3) for w in walls]} s), overflow "
             f"{head['total_overflow']}, violations {head['violations']}, "
             f"log_saturated_lanes {head['log_saturated_lanes']}, peak "
             f"{peak_gib:.2f} GiB; {indep}")
    # the sim's captured graph holds its memory pool while the sim lives
    del sim
    report["capture"] = phase4b_capture(cuda, card)

    # -- 5. profile over steady steps, in a child process: a CUDA profiler
    # session leaves its process's later host steps slower (PERF.md,
    # section 5), so the process that profiles is not the one that runs
    # the later phases
    eager_ms = report["capture"][str(LANES)]["eager"]["ms_per_step"]
    prof_out = join_child(spawn_child(PROFILE_FLAG, str(virtual_secs),
                                      str(eager_ms)), "phase 5", 900)
    if prof_out["kernels_per_step"] is not None:
        phase(5, f"profile {PROFILE_STEPS} steps at {LANES} lanes: "
                 f"{prof_out['kernels_per_step']:.0f} kernels/step "
                 f"({prof_out['launch_calls_per_step']:.0f} launch calls), "
                 f"device busy {prof_out['device_busy_ms_per_step']:.3f} "
                 f"ms/step; idle share {prof_out['idle_share']:.3f} of the "
                 f"profiled {prof_out['window_ms'] / PROFILE_STEPS:.3f} "
                 f"ms/step, {prof_out['idle_share_unprofiled']:.3f} of phase "
                 f"4b's eager {eager_ms:.3f} ms/step")
        for i, k in enumerate(prof_out["top"]):
            print(f"  top{i + 1}: {k['ms_per_step']:.4f} ms/step "
                  f"x{k['count_per_step']:.0f} {k['name'][:90]}", flush=True)
    else:
        phase(5, f"profile: torch.profiler recorded no device events; "
                 f"step {prof_out['window_ms'] / PROFILE_STEPS:.3f} ms by "
                 f"host clock, {prof_out['launch_calls_per_step']:.0f} "
                 "launch calls/step; device kernels and idle share not "
                 "measured")
    for lanes, c in prof_out["captured"].items():
        busy = ("device busy not seen by the profiler" if
                c["device_busy_ms_per_step"] is None else
                f"{c['kernels_per_step']:.0f} kernels/step, device busy "
                f"{c['device_busy_ms_per_step']:.3f} ms/step, idle share "
                f"{c['idle_share_of_replay']:.3f} of the replays")
        phase(5, f"captured, {lanes} lanes x {c['steps']} steps: "
                 f"{c['launch_calls_per_step']:.3f} host launch calls/step "
                 f"({c['graph_launches']} graph launches; eager "
                 f"{c['eager_launch_calls_per_step']} per step), {busy}; "
                 f"{c['window_ms_per_step']:.3f} ms/step profiled, replays "
                 f"{c['replay_ms_per_step']:.3f} ms/step by CUDA events")
    on, off = prof_out["fill_on"], prof_out["fill_off"]
    phase(5, f"uninitialized-memory fills on: {on['launch_calls_per_step']} "
             f"launches, {on['step_ms']:.3f} ms/step; off: "
             f"{off['launch_calls_per_step']} launches, {off['step_ms']:.3f} "
             f"ms/step; leaves equal after {PROFILE_STEPS + 1} steps")
    # the later phases run without the fills (their card/CPU and digest
    # checks would still catch a read of uninitialized memory): the
    # script must fit the card run's time limit
    import torch.utils.deterministic as tdet

    tdet.fill_uninitialized_memory = False
    phase(5, "phases 7-16 run with uninitialized-memory fills off (as "
             "phase 6 and phase 9's parity runs did)")
    report["profile"] = prof_out
    report["storm"] = phase7_storm(cuda)
    report["membership"] = phase9_membership(cuda) | {"parity": parity}
    # the depth valve: a slow host scales the depths of 16(e) and 17(d)
    # before they run
    report["valve"] = host_valve(cuda)
    # phases 18, 19, 17, 16(e) and 20 run in a child process beside phases
    # 10-16(d): both sides are host-bound eager sweeps (the card idles
    # most of each step), so its walls overlap theirs, as phase 6's do
    # phases 2-3's
    child = spawn_child(MESH_FLAG, json.dumps(report["valve"]["depths"]))
    work = tempfile.mkdtemp(prefix="chip_smoke_campaigns-")
    try:
        report["triage"], bundle10 = phase10_triage(
            cuda, small["raft_bench"], card)
        report["replay_both"] = phase19_replay_both(cuda, bundle10)
        report["refill"] = phase11_refill(cuda, card)
        report["lineage"] = phase12_lineage_cost(cuda, card)
        report["explore"], host13 = phase13_explore(cuda, card, work)
        report["devloop"] = phase14_devloop(
            cuda, card, {**host13, "row": report["explore"]["wide"]})
        report["campaigns"] = phase15_campaigns(cuda, card, host13["dirs"])
        report["speclang"] = phase16_speclang(cuda, card, work)
        t0 = time.perf_counter()
        res = join_child(child, "phases 16(e) and 17-20", 900)
        wait_s = time.perf_counter() - t0
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        shutil.rmtree(work, ignore_errors=True)
    report["speclang"]["explore"] = res.pop("speclang_explore")
    report["tune_serve"] = res.pop("tune_serve")
    report["host_oracle"] = res.pop("host_oracle")
    report["host_faces"] = res.pop("host_faces")
    report["mesh"] = res
    # the child's wall-clock marks on this script's clock
    t_zero = time.time() - (time.perf_counter() - T_START)
    at = {k: v - t_zero for k, v in res["marks"].items()}
    fed = res["federation"]["wall_s"]
    phase(18, f"overlapped: the child ran phases 18, 19, 17, 16(e) and 20 "
              f"in {res['wall_s']:.1f} s beside phases 10-16(d) (on this "
              f"script's clock: started {at['start']:.0f} s, 19 at "
              f"{at['19']:.0f} s, 17 at {at['17']:.0f} s, 16(e) at "
              f"{at['16(e)']:.0f} s, 20 at {at['20']:.0f} s, ended "
              f"{at['end']:.0f} s; joined after a {wait_s:.1f} s wait); "
              f"phases 19 and 20 took "
              f"{report['host_oracle']['phase_s']:.1f} and "
              f"{report['host_faces']['phase_s']:.1f} s of it; its "
              f"sharded federation took {fed:.2f} s against phase 15's "
              f"{report['campaigns']['federation']['host_s']:.2f} s island "
              "by island")
    report["workloads"] = phase8_workloads(cuda)
    report["total_s"] = time.perf_counter() - T_START


def phase4b_capture(cuda, card: str) -> dict:
    """The captured `_run` against the eager loop on the bench config
    (`_eager_run`, the engine's private switch for this A/B): at each of
    CAPTURE_AB_LANES, CAPTURE_AB_STEPS gated steps from one initial state,
    eager then captured, every leaf equal; ms/step of each after a first
    block (the eager allocator's warm-up; the capture), that block's wall,
    and each side's peak device memory."""
    from madsim_tpu_torch.tpu import BatchedSim
    from madsim_tpu_torch.tpu.convert import state_to_numpy
    from madsim_tpu_torch.tpu.engine import DONE_CHECK_STEPS
    from madsim_tpu_torch.tpu.raft import make_raft_spec, raft_bench_config

    spec = make_raft_spec(5, client_rate=0.1, log_capacity=16)
    cfg = raft_bench_config(10.0)
    out = {}
    for lanes in CAPTURE_AB_LANES:
        row, leaves = {}, {}
        for mode in ("eager", "captured"):
            sim = BatchedSim(spec, cfg, device=cuda)
            sim._eager_run = mode == "eager"
            st0 = sim.init(range(lanes))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            sim._run(st0, DONE_CHECK_STEPS)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            st = sim._run(st0, CAPTURE_AB_STEPS)
            torch.cuda.synchronize()
            row[mode] = {
                "ms_per_step": (time.perf_counter() - t0)
                / CAPTURE_AB_STEPS * 1e3,
                "first_block_s": first_s,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            }
            check(sim._graph is None if mode == "eager"
                  else sim._graph is not None,
                  f"capture A/B: the {mode} sim took the other path")
            leaves[mode] = state_to_numpy(st)
            del st, st0, sim
        bad = leaves_equal(leaves["eager"], leaves["captured"])
        check(not bad, f"capture A/B at {lanes} lanes: captured and eager "
                       f"leaves differ: {bad}")
        e, c = row["eager"], row["captured"]
        row["speedup"] = e["ms_per_step"] / c["ms_per_step"]
        out[str(lanes)] = row
        phase("4b", f"on {card}, {lanes} lanes x {CAPTURE_AB_STEPS} gated "
                    f"steps, eager / captured: {e['ms_per_step']:.3f} / "
                    f"{c['ms_per_step']:.3f} ms/step (x{row['speedup']:.2f}),"
                    f" first block {e['first_block_s']:.3f} / "
                    f"{c['first_block_s']:.3f} s (the capture's), peak "
                    f"{e['peak_gib']:.3f} / {c['peak_gib']:.3f} GiB; "
                    f"{len(leaves['eager'])} leaves equal")
    return out


def busy_us(dev_events) -> float:
    """Microseconds in the union of the device events' spans."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev_events)
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return busy + cur_e - cur_s


def captured_profile(spec, cfg, lanes: int) -> dict:
    """Under capture: torch.profiler over two replayed blocks of the sim's
    `_run` at `lanes` (the graph captured by a first block): host launch
    calls per step (kernel and graph launches; beside them one eager
    step's), kernels and device busy ms per step when the profiler sees
    the kernels inside the graph; and, whatever it sees, CUDA events over
    two more replays, and the device's idle share of them."""
    from torch.profiler import ProfilerActivity, profile

    from madsim_tpu_torch.tpu import BatchedSim
    from madsim_tpu_torch.tpu.engine import DONE_CHECK_STEPS

    sim = BatchedSim(spec, cfg, device=CARD)
    st = sim.init(range(lanes))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.step(st)
    eager_launches = sum(1 for e in prof.events()
                         if e.name.startswith("cudaLaunch"))
    st = sim._run(st, DONE_CHECK_STEPS)
    torch.cuda.synchronize()
    n = 2 * DONE_CHECK_STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = sim._run(st, n)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    events = list(prof.events())
    dev = [e for e in events
           if str(getattr(e, "device_type", "")).endswith("CUDA")]
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    row = {
        "lanes": lanes, "steps": n, "window_ms_per_step": window_ms / n,
        "eager_launch_calls_per_step": eager_launches,
        "launch_calls_per_step": sum(
            1 for e in events
            if e.name.startswith(("cudaLaunch", "cudaGraphLaunch"))) / n,
        "graph_launches": sum(1 for e in events
                              if e.name.startswith("cudaGraphLaunch")),
        "kernels_per_step": len(kernels) / n if kernels else None,
        "device_busy_ms_per_step": (busy_us(dev) / n / 1e3 if kernels
                                    else None),
    }
    graph = sim._graph[1]
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(2):
        graph.replay()
    ev1.record()
    torch.cuda.synchronize()
    row["replay_ms_per_step"] = ev0.elapsed_time(ev1) / n
    row["idle_share_of_replay"] = (
        None if row["device_busy_ms_per_step"] is None
        else 1.0 - row["device_busy_ms_per_step"] / row["replay_ms_per_step"])
    del st, sim
    return row


def phase5_profile(virtual_secs: float, eager_step_ms: float) -> dict:
    """Phase 5's measurements (run as a child process of the script):
    torch.profiler over PROFILE_STEPS steady steps of the headline sweep —
    kernels per step, device busy time, idle share, top kernels — and the
    same steps with and without deterministic mode's uninitialized-memory
    fills, leaves equal."""
    from torch.profiler import ProfilerActivity, profile

    import torch.utils.deterministic as tdet
    from madsim_tpu_torch.tpu import BatchedSim
    from madsim_tpu_torch.tpu.convert import state_to_numpy
    from madsim_tpu_torch.tpu.raft import make_raft_spec, raft_bench_config

    sim = BatchedSim(make_raft_spec(5, client_rate=0.1, log_capacity=16),
                     raft_bench_config(virtual_secs), device=CARD)
    st = sim.init(range(LANES))
    for _ in range(200):
        st = sim.step(st)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            st = sim.step(st)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    dev_events = [
        e for e in prof.events()
        if str(getattr(e, "device_type", "")).endswith("CUDA")
    ]
    kernels = [e for e in dev_events
               if not e.name.startswith(("Memcpy", "Memset"))]
    # host-side launch calls: a count that needs no device trace
    launch_calls = sum(1 for e in prof.events()
                       if e.name.startswith("cudaLaunch"))
    prof_out = {"window_ms": window_us / 1e3, "steps": PROFILE_STEPS,
                "launch_calls_per_step": launch_calls / PROFILE_STEPS,
                "kernels_per_step": None}
    if kernels:
        busy = busy_us(dev_events)
        by_name: dict = {}
        for e in kernels:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + (e.time_range.end - e.time_range.start),
                               n + 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
        busy_ms = busy / PROFILE_STEPS / 1e3
        prof_out |= {
            "kernels_per_step": len(kernels) / PROFILE_STEPS,
            "device_busy_ms_per_step": busy_ms,
            # the profiler slows the host; the unprofiled share compares
            # the same device time with phase 4b's eager step time
            "idle_share": 1.0 - busy / window_us,
            "idle_share_unprofiled": 1.0 - busy_ms / eager_step_ms,
            "top": [{"name": n[:120], "ms_per_step": t / PROFILE_STEPS / 1e3,
                     "count_per_step": c / PROFILE_STEPS}
                    for n, (t, c) in top],
        }

    # deterministic mode also fills every fresh uninitialized allocation
    # (torch.utils.deterministic.fill_uninitialized_memory); the step
    # writes all of every output it allocates, so the fills change no
    # result: measure the same steps with and without them
    def timed(state, fill: bool):
        tdet.fill_uninitialized_memory = fill
        try:
            with profile(activities=[ProfilerActivity.CPU]) as p:
                state = sim.step(state)
            launches = sum(1 for e in p.events()
                           if e.name.startswith("cudaLaunch"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PROFILE_STEPS):
                state = sim.step(state)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / PROFILE_STEPS * 1e3
        finally:
            tdet.fill_uninitialized_memory = True
        return state_to_numpy(state), launches, ms

    a, launches_fill, ms_fill = timed(st, True)
    b, launches_nofill, ms_nofill = timed(st, False)
    bad = leaves_equal(a, b)
    check(not bad, f"fill_uninitialized_memory changed leaves: {bad}")
    prof_out["fill_on"] = {"launch_calls_per_step": launches_fill,
                           "step_ms": ms_fill}
    prof_out["fill_off"] = {"launch_calls_per_step": launches_nofill,
                            "step_ms": ms_nofill}
    del st
    spec, cfg = sim.spec, sim.config
    del sim
    prof_out["captured"] = {str(lanes): captured_profile(spec, cfg, lanes)
                            for lanes in CAPTURE_AB_LANES}
    return prof_out


def phase6_golden(cuda) -> dict:
    """The JAX package's five GOLDEN digests, reproduced on the card; the
    Raft run with the lineage plane on, held to the CPU and to
    PINNED_LINEAGE."""
    from madsim_tpu_torch.tpu import BatchedSim
    from madsim_tpu_torch.tpu.convert import state_to_numpy
    from madsim_tpu_torch.tpu.digest import (
        GOLDEN, PINNED_LINEAGE, canonical_digest, golden_run, lineage_digest,
    )

    out = {}
    for name in ("raft", "paxos", "kv", "twopc", "chain"):
        spec, cfg, seeds, steps = golden_run(name)
        lineage = name == "raft"
        st, wall = timed_run(BatchedSim(spec, cfg, lineage=lineage,
                                        device=cuda), seeds, steps)
        g = state_to_numpy(st)
        check(bool((g["steps"] == steps).all()) and not g["done"].any(),
              f"golden {name}: the run did not take exactly {steps} live steps")
        dg = canonical_digest(g)
        check(dg == GOLDEN[name],
              f"golden {name}: card digest {dg} != GOLDEN {GOLDEN[name]}")
        row = {"lanes": len(seeds), "steps": steps, "card_s": wall,
               "step_ms": wall / steps * 1e3, "digest": dg,
               "lineage": lineage}
        extra = ""
        if lineage:
            c = state_to_numpy(BatchedSim(spec, cfg, lineage=True,
                                          device="cpu").run(
                seeds, steps, dispatch_steps=steps))
            bad = leaves_equal(g, c)
            check(not bad, f"golden raft: card and CPU leaves differ: {bad}")
            ld = lineage_digest(g)
            check(ld == PINNED_LINEAGE,
                  f"golden raft: lineage digest {ld} != pinned "
                  f"{PINNED_LINEAGE}")
            n_nem = sum(1 for k in g if k.startswith("nem."))
            n_lin = sum(1 for k in g if k.startswith("lin.")
                        or k.endswith(".sent_eid"))
            # lineage's share of this run's step: the same 16 lanes
            ab = ab_probe(lambda on: BatchedSim(spec, cfg, lineage=on,
                                                device=cuda),
                          len(seeds), LINEAGE_PAIRS_SMALL)
            del ab["states"]
            row.update(probe=ab, lineage_digest=ld, lineage_share=(
                ab["on_median"] - ab["off_median"]) / ab["on_median"])
            extra = (f", lineage on: {len(g)} leaves ({n_nem} nem.*, {n_lin} "
                     f"lineage) equal card/CPU, lineage digest {ld[:16]} == "
                     f"pinned; probes of {len(seeds)} lanes x {AB_STEPS} "
                     f"steps lineage {ab_line(ab)}; lineage's share "
                     f"{row['lineage_share']:+.3f}")
        out[name] = row
        phase(6, f"golden {name}: {len(seeds)} lanes x {steps} steps in "
                 f"{wall:.3f} s, digest {dg[:16]} == GOLDEN{extra}")
    return out


def phase7_storm(cuda) -> dict:
    """The eight-clause storm plan at full width: throughput, fire counts
    of every enabled kind, and batch independence."""
    from madsim_tpu_torch.tpu import BatchedSim, summarize
    from madsim_tpu_torch.tpu.convert import state_to_numpy
    from madsim_tpu_torch.tpu.nemesis import compile_plan, enabled_fire_kinds
    from madsim_tpu_torch.tpu.raft import make_raft_spec, raft_bench_config

    spec = make_raft_spec(5, client_rate=0.1, log_capacity=16)
    virtual_secs = 10.0
    cfg = compile_plan(storm_plan(), raft_bench_config(virtual_secs))
    sim = BatchedSim(spec, cfg, device=cuda)
    # a 10 s horizon takes ~1277 steps; the timed run and the 64-lane run
    # must fit the phase budget, else the horizon is cut (printed)
    ms = block_probe(sim, STORM_LANES)[0]
    est_s = 2 * 1277 * ms / 1e3
    cut = ""
    if est_s > PHASE7_BUDGET_S:
        # every clause's first window opens within 1-5 s: below 4 s some
        # kind may never fire
        virtual_secs = max(4.0, round(10.0 * PHASE7_BUDGET_S / est_s, 1))
        cut = (f" (cut: virtual_secs 10 -> {virtual_secs}; 2 runs at "
               f"{ms:.2f} ms/step were estimated at {est_s:.0f} s)")
        cfg = compile_plan(storm_plan(), raft_bench_config(virtual_secs))
        sim = BatchedSim(spec, cfg, device=cuda)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    st, wall = timed_run(sim, range(STORM_LANES), MAX_STEPS)
    check(bool(st.done.all()), "storm timed run hit max_steps")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    s = summarize(st, spec)
    steps_run = int(st.steps.max())
    warm64 = state_to_numpy(first_lanes(st, SEEDS_SMALL))
    del st
    kinds = enabled_fire_kinds(cfg)
    fires = {k: s[f"fires_{k}"] for k in kinds}
    dead = [k for k, n in fires.items() if n <= 0]
    check(not dead, f"storm: enabled kinds that never fired: {dead}")
    small = state_to_numpy(sim.run(range(SEEDS_SMALL), MAX_STEPS))
    # `key` is the one leaf that depends on the batch: a done lane's key
    # advances while any lane of its batch is live (as on the JAX face)
    del warm64["key"], small["key"]
    bad = leaves_equal(warm64, small)
    check(not bad, f"storm batch independence: seeds 0..{SEEDS_SMALL - 1} of "
                   f"the {STORM_LANES}-lane run differ from the "
                   f"{SEEDS_SMALL}-lane run in {bad}")
    out = {
        "lanes": STORM_LANES, "nodes": 5, "virtual_secs": virtual_secs,
        "plan": [type(c).__name__ for c in storm_plan().clauses],
        "probe_step_ms": ms, "wall_s": wall,
        "seeds_per_sec": STORM_LANES / wall,
        "step_ms": wall / steps_run * 1e3, "steps_run": steps_run,
        "events_per_sec": s["total_events"] / wall,
        "total_overflow": s["total_overflow"], "violations": s["violations"],
        "peak_mem_gib": peak_gib, "fires": fires,
        "phase_s": time.perf_counter() - t_phase,
    }
    phase(7, f"storm {STORM_LANES} lanes x 5 nodes, {virtual_secs} virtual "
             f"s{cut}, {len(out['plan'])} clauses: "
             f"{out['seeds_per_sec']:.1f} seeds/s, "
             f"{out['step_ms']:.3f} ms/step x {steps_run} steps "
             f"({wall:.3f} s), {out['events_per_sec']:.0f} events/s, "
             f"overflow {out['total_overflow']}, violations "
             f"{out['violations']}, peak {peak_gib:.2f} GiB; fires "
             + ", ".join(f"{k} {n}" for k, n in fires.items())
             + f"; every enabled kind fired; {len(warm64)} leaves (all but "
             f"key) of seeds 0..{SEEDS_SMALL - 1} equal the "
             f"{SEEDS_SMALL}-lane run")
    return out


def phase8_workloads(cuda) -> dict:
    """paxos, chain, kv and twopc at bench.py's sizes; kv's exact check."""
    from madsim_tpu_torch.tpu import (
        BatchedSim, chain_workload, kv_workload, paxos_workload, summarize,
        twopc_workload,
    )
    from madsim_tpu_torch.tpu import linearize

    factories = {"paxos": paxos_workload, "chain": chain_workload,
                 "kv": kv_workload, "twopc": twopc_workload}
    # steps a 10-virtual-second lane takes (JAX face, 64 lanes, CPU), to
    # estimate each run's wall from a probed step time
    est_steps = {"paxos": 780, "chain": 3050, "kv": 4050, "twopc": 1350}
    out = {}
    for i, (name, lanes, max_steps) in enumerate(WORKLOADS):
        virtual_secs = 10.0
        wl = factories[name](virtual_secs=virtual_secs)
        sim = BatchedSim(wl.spec, wl.config, device=cuda)
        ms = block_probe(sim, lanes)[0]
        est_s = est_steps[name] * ms / 1e3
        # each run also spends ~5 s outside its timed sweep (probe, build,
        # summary), which the split keeps back
        left = len(WORKLOADS) - i
        budget_s = (TARGET_S - (time.perf_counter() - T_START)) / left - 5.0
        cut = ""
        if est_s > budget_s:
            virtual_secs = max(1.0, round(10.0 * budget_s / est_s, 1))
            # bench.py's max_steps: virtual_secs * rate + 2000
            max_steps = int((max_steps - 2000) * virtual_secs / 10.0) + 2000
            cut = (f" (cut: virtual_secs 10 -> {virtual_secs}; "
                   f"{est_steps[name]} steps at {ms:.2f} ms/step were "
                   f"estimated at {est_s:.0f} s)")
            wl = factories[name](virtual_secs=virtual_secs)
            sim = BatchedSim(wl.spec, wl.config, device=cuda)
        torch.cuda.reset_peak_memory_stats()
        st, wall = timed_run(sim, range(lanes), max_steps)
        check(bool(st.done.all()), f"{name}: hit max_steps {max_steps}")
        s = summarize(st, wl.spec)
        steps_run = int(st.steps.max())
        row = {
            "lanes": lanes, "virtual_secs": virtual_secs,
            "max_steps": max_steps, "wall_s": wall,
            "seeds_per_sec": lanes / wall, "steps_run": steps_run,
            "step_ms": wall / steps_run * 1e3, "probe_step_ms": ms,
            "events_per_sec": s["total_events"] / wall,
            "total_overflow": s["total_overflow"],
            "violations": s["violations"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        }
        row["violation_lanes"] = s["violation_lanes"]
        extra = ""
        if name == "kv":
            t0 = time.perf_counter()
            n_check = min(KV_CHECK_LANES, lanes)
            ex = linearize.check_lanes(st.node, range(n_check))
            row["exact_check"] = {
                "lanes": n_check, "ops_checked": ex["ops_checked"],
                "unmatched_reads": ex["unmatched_reads"],
                "violations": ex["violations"],
                "non_linearizable_lanes": ex["non_linearizable_lanes"],
                "check_s": time.perf_counter() - t0,
            }
            extra = (f"; exact check over lanes 0..{n_check - 1}: "
                     f"{ex['ops_checked']} ops checked, "
                     f"{ex['unmatched_reads']} unmatched reads, "
                     f"{ex['violations']} violations "
                     f"{ex['non_linearizable_lanes']}")
        del st
        out[name] = row
        phase(8, f"{name} {lanes} lanes, {virtual_secs} virtual s{cut}: "
                 f"{row['seeds_per_sec']:.1f} seeds/s, {row['step_ms']:.3f} "
                 f"ms/step x {steps_run} steps ({wall:.3f} s), "
                 f"{row['events_per_sec']:.0f} events/s, overflow "
                 f"{row['total_overflow']}, violations {row['violations']} "
                 f"{row['violation_lanes']}, "
                 f"peak {row['peak_mem_gib']:.2f} GiB{extra}")
    return out


def phase9_workload(name: str, buggy: bool, virtual_secs: float):
    """(spec, config) of one phase-9 run."""
    from madsim_tpu_torch.tpu import (
        SimConfig, isr_workload, lease_workload, make_twopc_spec,
        unilateral_abort_spec, wal_workload,
    )

    if name == "twopc_tail":
        # tests/test_buggify.py's quiet_config(buggify_delay_rate=0.05):
        # no loss, no crashes, no partitions, only the heavy tail
        cfg = SimConfig(horizon_us=int(virtual_secs * 1e6), loss_rate=0.0,
                        msg_depth_msg=2, msg_depth_timer=2,
                        buggify_delay_rate=0.05)
        spec = unilateral_abort_spec(5) if buggy else make_twopc_spec(5)
        return spec, cfg
    factory = {"isr": isr_workload, "lease": lease_workload,
               "wal": wal_workload}[name]
    wl = factory(virtual_secs=virtual_secs, buggy=buggy)
    return wl.spec, wl.config


def phase9_membership(cuda) -> dict:
    """isr, lease, wal and the tail-exposed 2PC bug at full width, correct
    and buggy; then two 64-lane card/CPU parity runs."""
    from madsim_tpu_torch.tpu import BatchedSim, summarize
    from madsim_tpu_torch.tpu.convert import state_to_numpy
    from madsim_tpu_torch.tpu.nemesis import enabled_fire_kinds

    out = {}
    runs = [(name, lanes, secs, buggy)
            for name, lanes, *horizons in MEMBERSHIP
            for buggy, secs in zip((False, True), horizons)]
    for i, (name, lanes, full_secs, buggy) in enumerate(runs):
        tag = f"{name}_{'buggy' if buggy else 'correct'}"
        virtual_secs = full_secs
        spec, cfg = phase9_workload(name, buggy, virtual_secs)
        sim = BatchedSim(spec, cfg, device=cuda)
        ms, st = block_probe(sim, lanes)
        strag_pending = (None if st.strag is None
                         else int(st.strag.valid.sum()))
        del st
        # the time left before PHASE9_END_S, shared by the runs still to
        # go (the 64-lane run counts as one); over it, the horizon is cut
        # (printed), never below PHASE9_FLOOR: the bug shares hold at half
        # (JAX face, 512 lanes at half horizons: isr 0.98, lease 0.39, wal
        # 0.45, twopc 0.11 of lanes)
        left = len(runs) - i + 1
        budget_s = (PHASE9_END_S - (time.perf_counter() - T_START)) / left
        est_s = PHASE9_STEPS[tag] * ms / 1e3
        cut = ""
        if est_s > budget_s:
            virtual_secs = round(
                max(PHASE9_FLOOR[buggy], budget_s / est_s) * full_secs, 2)
            cut = (f" (cut: virtual_secs {full_secs} -> {virtual_secs}; "
                   f"{PHASE9_STEPS[tag]} steps at {ms:.2f} ms/step were "
                   f"estimated at {est_s:.0f} s)")
            spec, cfg = phase9_workload(name, buggy, virtual_secs)
            sim = BatchedSim(spec, cfg, device=cuda)
        torch.cuda.reset_peak_memory_stats()
        st, wall = timed_run(sim, range(lanes), PHASE9_MAX_STEPS)
        check(bool(st.done.all()),
              f"{tag}: hit max_steps {PHASE9_MAX_STEPS}")
        s = summarize(st, spec)
        steps_run = int(st.steps.max())
        violated = st.violated.cpu().numpy()
        loss = st.unsynced_loss.cpu().numpy()
        kinds = enabled_fire_kinds(cfg)
        fires = {k: s[f"fires_{k}"] for k in kinds}
        row = {
            "lanes": lanes, "virtual_secs": virtual_secs,
            "wall_s": wall, "seeds_per_sec": lanes / wall,
            "steps_run": steps_run, "step_ms": wall / steps_run * 1e3,
            "events_per_sec": s["total_events"] / wall,
            "total_overflow": s["total_overflow"],
            "violations": s["violations"],
            "total_nonmember_drops": s["total_nonmember_drops"],
            "total_unsynced_loss": s["total_unsynced_loss"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "fires": fires, "probe_step_ms": ms,
            "strag_pending_after_96_steps": strag_pending,
        }
        dead = [k for k, n in fires.items() if n <= 0]
        check(not dead, f"{tag}: enabled kinds that never fired: {dead}")
        if cfg.buggify_delay_rate > 0:
            check(bool(strag_pending),
                  f"{tag}: no straggler in the side pool")
        extra = ""
        if not buggy:
            check(s["violations"] == 0,
                  f"{tag}: the correct build violated on "
                  f"{s['violations']} lanes {s['violation_lanes']}")
        else:
            share, inclusive = BUG_SHARE[name]
            got = s["violations"] / lanes
            check(got >= share if inclusive else got > share,
                  f"{tag}: the planted bug violated {s['violations']}"
                  f"/{lanes} lanes, the JAX test demands "
                  f"{'>=' if inclusive else '>'} {share:.4f}")
            if name == "wal":
                check(bool((loss[violated] > 0).all()),
                      f"{tag}: violating lanes without unsynced loss")
                extra += "; every violating lane lost unsynced state"
            if name in ("isr", "lease", "wal"):
                # 20(e): the first violating seeds on the host twin
                row["host_repros"] = reps = phase9_host_repros(
                    name, virtual_secs, violated)
                extra += "; 20(e) host_repro " + ", ".join(
                    f"seed {sd}: {v['violations']} violation"
                    f"{'' if v['violations'] == 1 else 's'} "
                    f"({v['wall_s']:.2f} s)"
                    + (f" {v['violation'][:60]!r}" if v["violation"]
                       else "") for sd, v in reps.items())
        if buggy and name == PHASE9_INDEPENDENCE:
            big = state_to_numpy(first_lanes(st, SEEDS_SMALL))
            small = state_to_numpy(
                sim.run(range(SEEDS_SMALL), PHASE9_MAX_STEPS))
            del big["key"], small["key"]
            bad = leaves_equal(big, small)
            check(not bad, f"{tag} batch independence: seeds 0.."
                           f"{SEEDS_SMALL - 1} differ from the "
                           f"{SEEDS_SMALL}-lane run in {bad}")
            extra += (f"; {len(big)} leaves (all but key) of seeds "
                      f"0..{SEEDS_SMALL - 1} equal the "
                      f"{SEEDS_SMALL}-lane run")
        out[tag] = row
        phase(9, f"{tag} {lanes} lanes, {virtual_secs} virtual s{cut}: "
                 f"{row['seeds_per_sec']:.1f} seeds/s, "
                 f"{row['step_ms']:.3f} ms/step x {steps_run} steps "
                 f"({wall:.3f} s), {row['events_per_sec']:.0f} events/s, "
                 f"overflow {row['total_overflow']}, violations "
                 f"{row['violations']}/{lanes}, nonmember drops "
                 f"{row['total_nonmember_drops']}, unsynced loss "
                 f"{row['total_unsynced_loss']}, peak "
                 f"{row['peak_mem_gib']:.2f} GiB; fires "
                 + (", ".join(f"{k} {n}" for k, n in fires.items())
                    or "none enabled")
                 + (f"; {strag_pending} stragglers pending after 96 "
                    "steps" if strag_pending is not None else "")
                 + extra)
        del st
    phase(9, "horizons (virtual s, of the full): " + ", ".join(
        f"{tag} {row['virtual_secs']}/{full}" for (tag, row), full in zip(
            out.items(), [secs for _, _, *h in MEMBERSHIP for secs in h]))
        + f"; anchor PHASE9_END_S {PHASE9_END_S:.0f} s")
    return out


def membership_plan():
    """Reconfig + DiskFault with crash-wipe, skew and duplication."""
    from madsim_tpu_torch import nemesis as nm

    return nm.FaultPlan(name="membership+durability", clauses=(
        nm.Reconfig(interval_lo_us=300_000, interval_hi_us=900_000),
        nm.DiskFault(interval_lo_us=300_000, interval_hi_us=900_000,
                     torn_rate=0.5),
        nm.Crash(interval_lo_us=300_000, interval_hi_us=900_000,
                 wipe_rate=0.5),
        nm.ClockSkew(max_ppm=20_000),
        nm.Duplicate(rate=0.05),
    ))


def is_lineage_leaf(name: str) -> bool:
    return name.startswith("lin.") or name.endswith(".sent_eid")


def phase9_parity(cuda) -> dict:
    """64-lane card/CPU leaf equality of the two-handler path at unequal
    ring depths and of Raft under Reconfig + DiskFault (the straggler
    pool), lineage off and on; with lineage on, every non-lineage leaf
    equals the lineage-off card run's."""
    from madsim_tpu_torch.tpu import BatchedSim, SimConfig, make_raft_spec
    from madsim_tpu_torch.tpu.convert import state_to_numpy
    from madsim_tpu_torch.tpu.nemesis import compile_plan
    from madsim_tpu_torch.tpu.spec import replace_handlers

    raft = make_raft_spec(5)
    runs = {
        "raft_two_handler_1_3": (
            replace_handlers(raft, on_message=raft.on_message),
            SimConfig(horizon_us=5_000_000, loss_rate=0.05,
                      msg_depth_msg=1, msg_depth_timer=3,
                      crash_interval_lo_us=300_000,
                      crash_interval_hi_us=900_000,
                      partition_interval_lo_us=300_000,
                      partition_interval_hi_us=900_000),
        ),
        "raft_reconfig_disk": (
            raft,
            compile_plan(membership_plan(), SimConfig(
                horizon_us=5_000_000, buggify_delay_rate=0.2)),
        ),
    }
    out = {}
    steps = PHASE9_PARITY_STEPS
    for name, (spec, cfg) in runs.items():
        row = {"lanes": SEEDS_SMALL, "steps": steps}
        faces = {}
        for lineage in (False, True):
            st, wall = timed_run(BatchedSim(spec, cfg, lineage=lineage,
                                            device=cuda),
                                 range(SEEDS_SMALL), steps)
            g = state_to_numpy(st)
            c = state_to_numpy(BatchedSim(spec, cfg, lineage=lineage,
                                          device="cpu").run(
                range(SEEDS_SMALL), steps))
            tag = "lineage on" if lineage else "lineage off"
            bad = leaves_equal(g, c)
            check(not bad, f"{name} ({tag}): card and CPU leaves differ: "
                           f"{bad}")
            check(int(g["steps"].max()) == steps, f"{name}: ran short")
            faces[lineage] = g
            row["lineage_card_s" if lineage else "card_s"] = wall
        on, off = faces[True], faces[False]
        n_lin = sum(1 for k in on if is_lineage_leaf(k))
        bad = leaves_equal(
            {k: v for k, v in on.items() if not is_lineage_leaf(k)}, off)
        check(not bad and n_lin >= 3 and on["msgs.sent_eid"].any(),
              f"{name}: lineage on changed non-lineage leaves {bad}")
        row.update(leaves=len(off), lineage_leaves=n_lin)
        out[name] = row
        phase(9, f"{name}: {SEEDS_SMALL} lanes x {steps} steps, "
                 f"{len(off)} leaves equal card/CPU; lineage on "
                 f"({row['lineage_card_s']:.3f} s on the card against "
                 f"{row['card_s']:.3f} s off): {len(on)} leaves ({n_lin} "
                 "lineage) equal card/CPU, every non-lineage leaf equals "
                 "the lineage-off card run's")
    return out


def phase10_triage(cuda, bench64: dict, card: str) -> dict:
    """The triage path on the card: sweep, trace, shrink (with the causal
    digest), replay (with the causal slice), twin check; and the default
    ctl against phase 2's bench run. Its summary line names the card
    (`card`, as nvidia-smi reports it)."""
    import dataclasses
    import re

    from madsim_tpu_torch import causal, repro, telemetry
    from madsim_tpu_torch.tpu import BatchedSim, run_batch
    from madsim_tpu_torch.tpu import nemesis as ttn
    from madsim_tpu_torch.tpu.convert import state_to_numpy
    from madsim_tpu_torch.tpu.digest import (
        PINNED, PINNED_BUNDLE, PINNED_BUNDLE_V3, PINNED_CAUSAL, bundle_digest,
        canonical_digest, pinned_run,
    )
    from madsim_tpu_torch.tpu.engine import (
        DONE_CHECK_STEPS, IDLE_BLOCK_STEPS_DEFAULT, TraceRecord,
    )
    from madsim_tpu_torch.tpu.trace import extract_trace

    t_phase = time.perf_counter()
    wl = triage_workload()

    # the sweep's and the shrinker's sims, pre-built so the trace leg's
    # (state, records) and the shrink's batched dispatches (the default
    # refill evaluator's run_refill calls; its traced tail steps without
    # them) can be read and timed
    sim = BatchedSim(wl.spec, wl.config, device=cuda)
    tsim = BatchedSim(wl.spec, wl.config, triage=True, device=cuda)
    traced, dispatched, explained = [], [], []
    timed_calls_of(sim, "run_traced", traced)
    timed_calls_of(tsim, "run_refill", dispatched)
    # the causal legs: the shrink's and the replay's lineage replays
    explain = causal.explain
    timed_calls_of(causal, "explain", explained)
    log = []
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_bundles-")
    tel_dir = os.path.join(out_dir, "telemetry")
    # the whole phase runs with telemetry on: it observes only, so every
    # pinned gate below holds as with it off
    telemetry.enable(out_dir=tel_dir)
    try:
        # -- 1. sweep, shrink and trace through the user's entry point
        t0 = time.perf_counter()
        result = run_batch(
            range(TRIAGE_SEEDS), wl, sim=sim, max_traces=1,
            shrink_on_violation=True, shrink_kwargs={
                "out_dir": out_dir, "spec_ref": TRIAGE_SPEC_REF, "sim": tsim,
                "causal": True,
                "log": lambda m: log.append((time.perf_counter(), m)),
            },
        )
        torch.cuda.synchronize()
        batch_wall = time.perf_counter() - t0
        check(result.bundle is not None,
              f"triage: the shrink did not produce a bundle ({log})")
        seed = result.violating_seeds[0]
        check(seed == PINNED_BUNDLE[0],
              f"triage: first violating seed {seed} != {PINNED_BUNDLE[0]}")
        lane = int(np.nonzero(result.seeds == seed)[0][0])
        vstep = int(result.violation_step[lane])
        # the trace leg: wl.max_steps ungated steps, live until the lane
        # is done (read every DONE_CHECK_STEPS), then idle steps in blocks
        # of IDLE_BLOCK_STEPS_DEFAULT lanes
        check(len(traced) == 1, f"triage: {len(traced)} traced runs")
        (st, recs), trace_s = traced[0]
        live = -(-(vstep + 1) // DONE_CHECK_STEPS) * DONE_CHECK_STEPS
        launched = live + -(-(wl.max_steps - live) // IDLE_BLOCK_STEPS_DEFAULT)
        trace_ms = trace_s / launched * 1e3
        # its records of the steps up to the violation, and its final
        # state, against the CPU's leaf for leaf (`key` aside: the card
        # took wl.max_steps steps)
        # (the CPU run has lineage on, for the timeline's flow check
        # below; its other records and leaves are the lineage-off ones)
        cst, crecs = BatchedSim(wl.spec, wl.config, lineage=True,
                                device="cpu").run_traced(
            seed, max_steps=vstep + 1)
        rec_fields = [f for f in TraceRecord._fields
                      if getattr(recs, f) is not None]
        bad = [f for f in rec_fields
               if not torch.equal(getattr(recs, f)[:vstep + 1].cpu(),
                                  getattr(crecs, f))]
        check(not bad, f"triage: card and CPU trace records differ: {bad}")
        final = state_to_numpy(st)
        cfinal = {k: v for k, v in state_to_numpy(cst).items()
                  if not is_lineage_leaf(k)}
        del final["key"], cfinal["key"]
        bad = leaves_equal(final, cfinal)
        check(not bad, f"triage: card and CPU traced states differ: {bad}")
        batch_lane = {k: v[lane:lane + 1]
                      for k, v in state_to_numpy(result.state).items()
                      if k != "key"}
        bad = leaves_equal(final, batch_lane)
        check(not bad, f"triage: traced seed {seed} differs from its batch "
                       f"lane in {bad}")
        events = extract_trace(recs, kind_names=wl.spec.msg_kind_names)
        check(events[-1].kind == "violation" and events[-1].step == vstep,
              f"triage: the trace ends in {events[-1]}, not the violation "
              f"at step {vstep}")
        check([str(e) for e in events] == [str(e) for e in result.traces[seed]],
              "triage: run_batch's trace leg differs from its own records")
        phase(10, f"sweep {TRIAGE_SEEDS} lanes, 5 virtual s: "
                  f"{result.violations} seeds violating "
                  f"{result.violating_seeds}, sweep "
                  f"{result.device_ms / 1e3:.3f} s; seed {seed} traced "
                  f"{wl.max_steps} steps ({live} live, {launched - live} "
                  f"idle-block steps) in {trace_s:.3f} s, {trace_ms:.3f} ms "
                  f"per launched step, {len(rec_fields)} record leaves of "
                  f"{vstep + 1} steps and the final state equal card/CPU, "
                  f"final state equals its batch lane (all but key), "
                  f"{len(events)} events ending {events[-1]}")

        # -- 2. the default ctl is the plain engine
        spec, cfg, seeds, max_steps = pinned_run("raft_bench")
        t2 = time.perf_counter()
        g = state_to_numpy(BatchedSim(spec, cfg, triage=True, device=cuda)
                           .run(seeds, max_steps))
        default_s = time.perf_counter() - t2
        ctl_keys = [k for k in g if k.startswith("ctl.")]
        for k in ctl_keys:
            del g[k]
        bad = leaves_equal(g, bench64)
        check(len(ctl_keys) == 5 and not bad,
              f"triage: default ctl differs from the plain run in {bad}")
        check(canonical_digest(g) == PINNED["raft_bench"],
              "triage: default-ctl digest != pinned")
        phase(10, f"default ctl: raft_bench {len(seeds)} lanes in "
                  f"{default_s:.3f} s, {len(g)} leaves (ctl aside) equal "
                  "phase 2's plain run, digest == pinned")

        # -- 3. the shrink: its report line, counted dispatches, bundle
        shrink_end, last = log[-1]
        found = re.search(r"(\d+) atoms -> (\d+) in (\d+) dispatches", last)
        check(found is not None, f"triage: unexpected shrink report {last!r}")
        atoms_before, atoms_after, dispatches = map(int, found.groups())
        dispatch_s = [wall for _, wall in dispatched]
        dispatch_steps = [int(st.refill.iters) for st, _ in dispatched]
        check(dispatches == len(dispatch_s) and dispatches <= 10,
              f"triage: {dispatches} dispatches reported, {len(dispatch_s)} "
              "counted; at most 10 allowed")
        # from the end of the sweep loop to the shrinker's last report
        # line (its dispatches, its traced tail, the bundle's save)
        shrink_s = shrink_end - (t0 + result.device_ms / 1e3)
        bundle = result.bundle
        check(len(explained) == 1, f"triage: {len(explained)} causal legs "
                                   "in the shrink, want 1")
        shrink_causal_s = explained[0][1]
        dg = bundle_digest(bundle)
        dg2 = bundle_digest(dataclasses.replace(bundle, causal=None))
        sha = (bundle.causal or {}).get("sha")
        check(sha == PINNED_CAUSAL,
              f"triage: causal sha {sha} != pinned {PINNED_CAUSAL}")
        check(dg == PINNED_BUNDLE_V3 and dg2 == PINNED_BUNDLE[1],
              f"triage: bundle digest {dg} (causal cleared: {dg2}) != pinned "
              f"{PINNED_BUNDLE_V3} ({PINNED_BUNDLE[1]})")
        phase(10, f"shrink: {atoms_before} atoms -> {atoms_after} in "
                  f"{dispatches} refill dispatches of {dispatch_steps} "
                  f"iterations "
                  f"({[round(x, 3) for x in dispatch_s]} s), "
                  f"{sum(dispatch_s) / dispatches * 1e3:.3f} ms/dispatch, "
                  f"{sum(dispatch_s) / sum(dispatch_steps) * 1e3:.3f} "
                  f"ms/step, "
                  f"shrink wall {shrink_s:.3f} s; dropped "
                  f"{bundle.dropped_clauses}, occ_off {bundle.occ_off}, "
                  f"violation step {bundle.violation_step} t="
                  f"{bundle.violation_t_us} us, horizon {bundle.horizon_us} "
                  f"us; causal leg {shrink_causal_s:.3f} s, chain "
                  f"{bundle.causal['chain_len']} of a {bundle.causal['cone_size']}"
                  f"-event cone, sha {sha} == pinned; bundle digest {dg[:16]} "
                  "== pinned v3, and with causal cleared == pinned")

        # -- 4. replay twice, then once more with lineage on (it raises
        # when the slice's sha differs from the bundle's), and the twin
        # schedule check
        t3 = time.perf_counter()
        printed = []
        replay_tl = os.path.join(out_dir, "replay.perfetto.json")
        rep = repro.replay_device(bundle, repeats=2, device=cuda,
                                  explain=EXPLAIN_LINKS, perfetto=replay_tl,
                                  out=printed.append)
        replay_s = time.perf_counter() - t3
        check(len(explained) == 2, "triage: the replay ran no causal leg")
        replay_causal_s = explained[1][1]
        check((rep["step"], rep["t_us"]) == (bundle.violation_step,
                                            bundle.violation_t_us),
              f"triage: replay at {rep} != the bundle's")
        check(rep["causal"] == bundle.causal and any(
            f"chain of {EXPLAIN_LINKS} events" in p for p in printed),
              f"triage: the replay's causal slice {rep.get('causal')} "
              "differs from the bundle's")
        twin = ttn.assert_device_matches_schedule(
            tsim, bundle.shrunk_plan(), seed, horizon_us=bundle.horizon_us,
            max_steps=bundle.violation_step + 2, ctl=bundle.ctl(1),
            occ_off=bundle.occ_off)
        phase(10, f"replay: violation at step {rep['step']} t={rep['t_us']} "
                  f"us in both of 2 runs, then the lineage replay's last "
                  f"{EXPLAIN_LINKS} links, sha {rep['causal']['sha']} == the "
                  f"bundle's; replay wall {replay_s:.3f} s (causal leg "
                  f"{replay_causal_s:.3f} s); twin "
                  f"check: {twin} chaos events equal the shrunk schedule "
                  f"[{time.perf_counter() - t_phase:.0f} s in phase 10]")

        # -- 5. what telemetry wrote: the traced seed's timeline (one
        # track per node, one flow per delivery edge of the lineage
        # graph of the same steps), the replay's --perfetto timeline, the
        # explain slice's, and the record lines
        tl = telemetry_checks(
            tel_dir, wl, seed, crecs, replay_tl,
            causal.slice_perfetto(explained[1][0][1], label="explain"),
            os.path.join(out_dir, "slice.perfetto.json"))
        phase(10, f"telemetry: seed {seed}'s timeline has "
                  f"{tl['node_tracks']} node tracks and {tl['flows']} flows "
                  f"= {tl['graph_edges']} delivery edges of the lineage "
                  f"graph; replay timeline {tl['replay_events']} events, "
                  f"slice timeline {tl['slice_events']} events; "
                  f"{tl['events']} event lines with "
                  f"{', '.join(tl['records'])}")
        phase(10, f"on {card}: {result.violations} of {TRIAGE_SEEDS} seeds "
                  f"violating; {atoms_before} -> {atoms_after} atoms in "
                  f"{dispatches} dispatches, {trace_ms:.3f} ms per traced "
                  f"step, {sum(dispatch_s) / dispatches * 1e3:.3f} ms per "
                  f"shrink dispatch, shrink wall {shrink_s:.3f} s, replay "
                  f"wall {replay_s:.3f} s, causal legs {shrink_causal_s:.3f}"
                  f" + {replay_causal_s:.3f} s")
    finally:
        telemetry.disable()
        causal.explain = explain
        shutil.rmtree(out_dir, ignore_errors=True)
    return {
        "telemetry": tl,
        "seeds": TRIAGE_SEEDS, "violating": result.violations,
        "violating_seeds": result.violating_seeds, "seed": seed,
        "violation_step": vstep, "sweep_s": result.device_ms / 1e3,
        "run_batch_s": batch_wall, "trace_s": trace_s,
        "trace_steps_launched": launched, "trace_live_steps": live,
        "trace_ms_per_step": trace_ms, "atoms_before": atoms_before,
        "atoms_after": atoms_after, "dispatches": dispatches,
        "dispatch_s": dispatch_s, "dispatch_steps": dispatch_steps,
        "ms_per_dispatch": sum(dispatch_s) / dispatches * 1e3,
        "shrink_s": shrink_s, "default_ctl_s": default_s,
        "replay_s": replay_s, "twin_events": twin, "bundle_digest": dg,
        "causal_sha": sha, "shrink_causal_s": shrink_causal_s,
        "replay_causal_s": replay_causal_s,
        "phase_s": time.perf_counter() - t_phase,
    }, bundle


def telemetry_checks(tel_dir: str, wl, seed: int, lineage_recs,
                     replay_tl: str, slice_doc: dict, slice_tl: str) -> dict:
    """Phase 10's telemetry gates: the traced seed's Perfetto file parses,
    with one track per node and one flow per delivery edge of
    `causal.graph_from_trace` of the lineage records of the same steps;
    the replay's timeline and the explain slice's (written here) parse;
    the events stream holds record_batch_result's and record_shrink's
    lines (and record_causal's)."""
    from madsim_tpu_torch import causal, telemetry

    n = wl.spec.n_nodes
    with open(os.path.join(tel_dir, f"{wl.spec.name}-seed{seed}"
                                    ".perfetto.json")) as f:
        doc = json.load(f)
    evs = doc["traceEvents"]
    tracks = {e["tid"] for e in evs if e["ph"] == "M"
              and e["name"] == "thread_name" and 0 <= e.get("tid", -1) < n}
    flows = sum(1 for e in evs if e["ph"] == "s")
    g = causal.graph_from_trace(lineage_recs,
                                kind_names=wl.spec.msg_kind_names, n_nodes=n)
    check(tracks == set(range(n)),
          f"telemetry: node tracks {sorted(tracks)} != {n} nodes")
    check(flows == len(g.msg_pred) > 0,
          f"telemetry: {flows} flows != {len(g.msg_pred)} delivery edges")
    with open(replay_tl) as f:
        replay_events = len(json.load(f)["traceEvents"])
    with open(slice_tl, "w") as f:
        json.dump(slice_doc, f)
    with open(slice_tl) as f:
        slice_events = len(json.load(f)["traceEvents"])
    check(replay_events > n and slice_events > n,
          "telemetry: an empty replay or slice timeline")
    lines = telemetry.read_events(os.path.join(tel_dir, "events.jsonl"))
    names = {e["name"] for e in lines}
    records = ["sweep_lanes", "sweep_violations", "shrink_atoms_original",
               "shrink_dispatches", "causal_chain_len"]
    missing = [r for r in records if r not in names]
    check(not missing, f"telemetry: no {missing} lines in the events")
    return {"node_tracks": len(tracks), "flows": flows,
            "graph_edges": len(g.msg_pred), "replay_events": replay_events,
            "slice_events": slice_events, "events": len(lines),
            "records": records}


def phase11_refill(cuda, card: str) -> dict:
    """Continuous batching on the card: the spread mix's refill sweeps at
    REFILL_LANES (held to the occupancy and lane-step bars) and at
    REFILL_WIDE_LANES (dropped, and said so, when the probe says the phase
    would overrun), each against the chunked reference's rows; the pinned
    small refill run card against CPU; coverage's step cost on the bench
    config. Its summary line names the card."""
    from madsim_tpu_torch.tpu import BatchedSim, make_raft_spec
    from madsim_tpu_torch.tpu.convert import state_to_numpy
    from madsim_tpu_torch.tpu.digest import (
        PINNED_REFILL, refill_digest, refill_run, spread_ctl, spread_mix,
    )
    from madsim_tpu_torch.tpu.engine import refill_results
    from madsim_tpu_torch.tpu.raft import raft_bench_config

    t_phase = time.perf_counter()
    A, h = REFILL_ADMISSIONS, REFILL_H_US
    spec = make_raft_spec()

    def mix_sim():
        return BatchedSim(spec, spread_mix(h), triage=True, coverage=True,
                          device=cuda)

    seeds = np.arange(A, dtype=np.int64)
    ctl = spread_ctl(h, A)

    # -- the chunked reference: the admissions as lanes of one run
    csim = mix_sim()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cst = csim.run(seeds, REFILL_MAX_STEPS, ctl=ctl)
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    check(bool(cst.done.all()), "refill: the chunked reference hit max_steps")
    ref = {f: getattr(cst, f).cpu().numpy() for f in (
        "violated", "deadlocked", "violation_at", "violation_epoch",
        "violation_step", "steps", "events", "overflow", "dead_drops",
        "clock", "epoch", "fires", "occ_fired")}
    ref.update(cov_bitmap=cst.cov.bitmap.cpu().numpy(),
               cov_hiwater=cst.cov.hiwater.cpu().numpy(),
               cov_transitions=cst.cov.transitions.cpu().numpy())
    chunk_steps = int(cst.steps.max())
    del cst
    phase(11, f"chunked reference {A} lanes, spread mix at "
              f"{h / 1e6} virtual s: {chunk_steps} steps in {chunk_s:.3f} s "
              f"({chunk_s / chunk_steps * 1e3:.3f} ms/step)")

    # -- the refill sweeps; the wide one only when the probe says it fits
    ms = probe(mix_sim(), REFILL_LANES)[0]
    # a refill iteration costs ~1.1 probed steps (measured on one H100);
    # the small card/CPU run and the coverage probes take ~16 s
    est_s = (REFILL_EST_STEPS[REFILL_LANES] + REFILL_EST_STEPS[
        REFILL_WIDE_LANES]) * ms * 1.15 / 1e3 + 16.0
    left_s = PHASE11_BUDGET_S - (time.perf_counter() - t_phase)
    widths = [REFILL_LANES]
    if est_s <= left_s:
        widths.append(REFILL_WIDE_LANES)
    else:
        phase(11, f"the {REFILL_WIDE_LANES}-lane sweep is dropped: the "
                  f"phase's rest was estimated at {est_s:.0f} s of "
                  f"{left_s:.0f} s left ({ms:.2f} ms/step)")
    sweeps = {}
    for L in widths:
        sim = mix_sim()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = sim.run_refill(seeds, lanes=L, max_steps=REFILL_MAX_STEPS,
                            ctl=ctl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res = refill_results(st)
        del st
        check(res["truncated"] == 0 and (res["retired"] >= 0).all(),
              f"refill {L}: {res['truncated']} admissions truncated")
        bad = [f for f, v in ref.items() if not np.array_equal(v, res[f])]
        check(not bad, f"refill {L}: rows differ from the chunked "
                       f"reference: {bad}")
        steps = ref["steps"].astype(np.int64).reshape(-1, L)
        chunk_total = int((steps.max(axis=1) * L).sum())
        row = {
            "lanes": L, "iters": res["iters"], "wall_s": wall,
            "ms_per_iter": wall / res["iters"] * 1e3,
            "admissions_per_s": A / wall, "occupancy": res["occupancy"],
            "truncated": res["truncated"],
            "chunked_occupancy": steps.sum() / chunk_total,
            "lane_step_advantage": chunk_total / res["total_lane_steps"],
            "host_read_s": sim.refill_read_s,
            "host_read_ms_per_iter": sim.refill_read_s / res["iters"] * 1e3,
        }
        sweeps[L] = row
        phase(11, f"refill {A} admissions over {L} lanes: {row['iters']} "
                  f"iterations in {wall:.3f} s ({row['ms_per_iter']:.3f} "
                  f"ms/iteration; probe {ms:.3f} ms/step at "
                  f"{REFILL_LANES} lanes), {row['admissions_per_s']:.1f} "
                  f"admissions/s, occupancy {row['occupancy']:.4f} "
                  f"(chunked at chunk {L}: {row['chunked_occupancy']:.4f}), "
                  f"lane-step advantage {row['lane_step_advantage']:.3f}, "
                  f"truncated {row['truncated']}, host read "
                  f"{row['host_read_ms_per_iter']:.3f} ms/iteration; "
                  f"{len(ref)} row fields equal the chunked reference")
    gated = sweeps[REFILL_LANES]
    check(gated["occupancy"] >= REFILL_OCCUPANCY_FLOOR,
          f"refill: occupancy {gated['occupancy']:.4f} < "
          f"{REFILL_OCCUPANCY_FLOOR}")
    check(gated["lane_step_advantage"] >= REFILL_ADVANTAGE_FLOOR,
          f"refill: lane-step advantage {gated['lane_step_advantage']:.3f} "
          f"< {REFILL_ADVANTAGE_FLOOR}")

    # -- the pinned small refill run, card against CPU
    rspec, rcfg, rseeds, rctl, rlanes, rmax = refill_run()
    t0 = time.perf_counter()
    faces = {}
    for dev in (cuda, "cpu"):
        rst = BatchedSim(rspec, rcfg, triage=True, coverage=True,
                         device=dev).run_refill(rseeds, lanes=rlanes,
                                                max_steps=rmax, ctl=rctl)
        faces[str(dev)] = (state_to_numpy(rst), refill_results(rst))
    small_s = time.perf_counter() - t0
    (g, gres), (c, cres) = faces[str(cuda)], faces["cpu"]
    bad = leaves_equal(g, c)
    check(not bad and "refill.retired" in g and "queue.seeds" in g,
          f"refill: card and CPU refill states differ: {bad}")
    dg = refill_digest(gres)
    check(dg == PINNED_REFILL and refill_digest(cres) == dg,
          f"refill: row digest {dg} != pinned {PINNED_REFILL}")
    phase(11, f"pinned refill run {len(rseeds)} admissions over {rlanes} "
              f"lanes: {len(g)} leaves (queue and log included) equal "
              f"card/CPU, row digest {dg[:16]} == pinned ({small_s:.3f} s "
              "for both)")

    # -- coverage's cost: the bench config's steps, off and on
    kw = dict(n_nodes=5, client_rate=0.1, log_capacity=16)
    ab = ab_probe(lambda on: BatchedSim(make_raft_spec(**kw),
                                        raft_bench_config(10.0), coverage=on,
                                        device=cuda), LANES, COV_PAIRS)
    states = ab.pop("states")
    on = {k: v for k, v in states[True].items() if not k.startswith("cov.")}
    bad = leaves_equal(on, states[False])
    check(not bad and len(states[True]) == len(on) + 3,
          f"coverage on/off: non-cov leaves differ: {bad}")
    cov_ms = ab["on_median"] - ab["off_median"]
    phase(11, f"coverage cost, bench config {LANES} lanes x {AB_STEPS} "
              f"steps: {ab_line(ab)}; every non-cov leaf equal")
    phase(11, f"on {card}: refill over {REFILL_LANES} lanes "
              f"{gated['admissions_per_s']:.1f} admissions/s at occupancy "
              f"{gated['occupancy']:.4f}, lane-step advantage "
              f"{gated['lane_step_advantage']:.3f}, host read "
              f"{gated['host_read_ms_per_iter']:.3f} ms/iteration; coverage "
              f"{cov_ms:+.3f} ms/step "
              f"[{time.perf_counter() - t_phase:.0f} s in phase 11]")
    return {
        "h_us": h, "admissions": A, "chunked_s": chunk_s,
        "chunked_steps": chunk_steps, "probe_step_ms": ms,
        "sweeps": {str(L): row for L, row in sweeps.items()},
        "small_run_s": small_s, "small_digest": dg,
        "cov_off_ms": ab["off_ms"], "cov_on_ms": ab["on_ms"],
        "phase_s": time.perf_counter() - t_phase,
    }


def phase12_lineage_cost(cuda, card: str) -> dict:
    """Lineage's step cost on the bench config at full width: LINEAGE_PAIRS
    alternating off/on probe pairs (ab_probe), every non-lineage leaf of
    the last lineage-on probe equal to the last lineage-off one's."""
    from madsim_tpu_torch.tpu import BatchedSim, make_raft_spec
    from madsim_tpu_torch.tpu.raft import raft_bench_config

    t_phase = time.perf_counter()
    kw = dict(n_nodes=5, client_rate=0.1, log_capacity=16)
    ab = ab_probe(lambda on: BatchedSim(make_raft_spec(**kw),
                                        raft_bench_config(10.0), lineage=on,
                                        device=cuda), LANES, LINEAGE_PAIRS)
    states = ab.pop("states")
    on = {k: v for k, v in states[True].items() if not is_lineage_leaf(k)}
    bad = leaves_equal(on, states[False])
    check(not bad and len(states[True]) == len(on) + 3
          and bool(states[True]["lin.eid"].any()),
          f"lineage on/off: non-lineage leaves differ: {bad}")
    phase(12, f"on {card}: lineage cost, bench config {LANES} lanes x "
              f"{AB_STEPS} steps: {ab_line(ab)}; every non-lineage "
              f"leaf equal [{time.perf_counter() - t_phase:.0f} s in phase "
              "12]")
    return {"lanes": LANES, "steps": AB_STEPS, **ab,
            "phase_s": time.perf_counter() - t_phase}


def suppressions_kept(cand, bundle) -> list:
    """The candidate's suppressions (`Candidate.base_ctl`) its shrunk
    bundle does not keep: every clause it switched off stays dropped, every
    occurrence it switched off stays off (or its clause dropped), every
    rate scale stays (or its clause dropped), and the horizon stays within
    the candidate's. Empty when all are kept (and for a default
    candidate, which has none)."""
    base = cand.base_ctl() or {}
    dropped = set(bundle.dropped_clauses)
    lost = [n for n in base.get("off_clauses", ()) if n not in dropped]
    for n, mask in base.get("occ_off", {}).items():
        if n not in dropped and (bundle.occ_off.get(n, 0) & mask) != mask:
            lost.append(f"{n}.occ_off")
    for n, sc in base.get("rate_scale", {}).items():
        if n not in dropped and bundle.rate_scale.get(n) != sc:
            lost.append(f"{n}.scale")
    if base.get("horizon_us") and bundle.horizon_us > base["horizon_us"]:
        lost.append("horizon")
    return lost


def phase13_explore(cuda, card: str, work: str) -> dict:
    """The explorer's host loop on the card, run as campaigns under
    `work`. (a) The pinned run (`digest.EXPLORE_RUN` on
    `explore_workload`) twice: as a campaign by refill with telemetry on,
    killed after generation 1 (checkpoint, object dropped) and resumed
    from its directory for generation 2; and as a chunked, serial
    Explorer with telemetry off. Both reach PINNED_EXPLORE and
    PINNED_EXPLORE_CORPUS, and their corpora are equal entry for entry.
    (b) A full-width search as a campaign: EXPLORE_LANES lanes by refill,
    EXPLORE_GENERATIONS_FLOOR generations, then bug dedup with one
    shrink (of the first coarse group's first witness); the coverage
    curve is monotone, the bug is found in generation 0 (the uniform
    chunk), every violation is a witness of exactly one BugRecord, one
    record carries a bundle, stamped with its signature, the campaign
    and generation 0, that keeps the candidate's suppressions, and
    `campaign.regress` replays it green at its step and time. Its
    summary line names the card. Returns (the phase's report, the
    full-width search's report and corpus, which phase 14 holds its
    device loop to, and the two campaign directories, which phase 15
    merges)."""
    from madsim_tpu_torch import campaign, telemetry, triage
    from madsim_tpu_torch.explore import Candidate, Explorer
    from madsim_tpu_torch.tpu import BatchedSim
    from madsim_tpu_torch.tpu.digest import (
        EXPLORE_GENERATIONS, EXPLORE_RUN, PINNED_EXPLORE,
        PINNED_EXPLORE_CORPUS, explore_corpus_digest,
    )

    t_phase = time.perf_counter()
    wl = explore_workload()
    out: dict = {}
    dirs = {"pinned": os.path.join(work, "pinned"),
            "wide": os.path.join(work, "wide")}

    # -- (a) the pinned run: a campaign killed and resumed, and chunked
    tel_dir = os.path.join(work, "telemetry")
    telemetry.enable(out_dir=tel_dir)
    try:
        c = campaign.Campaign(
            wl, dirs["pinned"], shrink=False, device=cuda,
            **{k: EXPLORE_RUN[k] for k in ("meta_seed", "lanes", "chunk")})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c.run(1)
        t1 = time.perf_counter()
        c.checkpoint()
        del c  # the kill: only the checkpoint survives
        resumed = campaign.Campaign.resume(dirs["pinned"], workload=wl,
                                           device=cuda)
        check(resumed.generation == 1,
              f"explore campaign: resumed at generation "
              f"{resumed.generation}, not 1")
        t2 = time.perf_counter()
        rep = resumed.run(EXPLORE_GENERATIONS - 1)
        resumed.checkpoint()
        t3 = time.perf_counter()
        spans = [sp.name for sp in telemetry.spans()]
    finally:
        telemetry.disable()
    out["pinned_campaign_s"] = t3 - t0
    out["pinned_checkpoint_reload_s"] = t2 - t1
    chunked = Explorer(wl, device=cuda, refill=False, pipeline=False,
                       **EXPLORE_RUN)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunked_rep = chunked.run(EXPLORE_GENERATIONS)
    out["pinned_chunked_s"] = time.perf_counter() - t0
    corpora = {}
    for name, ex, rp in (("campaign", resumed.ex, rep),
                         ("chunked", chunked, chunked_rep)):
        fp = rp.fingerprint()
        check(fp == PINNED_EXPLORE,
              f"explore {name}: fingerprint {fp} != {PINNED_EXPLORE}")
        cd = explore_corpus_digest(ex)
        check(cd == PINNED_EXPLORE_CORPUS,
              f"explore {name}: corpus digest {cd} != pinned")
        corpora[name] = [e.to_dict() for e in ex.corpus]
        extra = ""
        if name == "campaign":
            lines = telemetry.read_events(os.path.join(tel_dir,
                                                       "events.jsonl"))
            gens = [e for e in lines if e["name"] == "explore_generations"]
            check(spans.count("dispatch") == EXPLORE_GENERATIONS
                  and gens and gens[-1]["value"] == EXPLORE_GENERATIONS,
                  f"explore {name}: telemetry saw {spans} and {gens}")
            extra = (f", killed after generation 1 and resumed (checkpoint"
                     f" + reload {out['pinned_checkpoint_reload_s']:.3f} "
                     f"s), telemetry on ({len(lines)} event lines, "
                     f"{len(spans)} spans)")
        phase(13, f"pinned {name}: {EXPLORE_RUN['lanes']} lanes x "
                  f"{EXPLORE_GENERATIONS} generations in "
                  f"{out[f'pinned_{name}_s']:.3f} s, coverage "
                  f"{rp.coverage_curve}, corpus {rp.corpus_curve}, "
                  f"violations {rp.violation_curve}; fingerprint "
                  f"{fp[:16]} == pinned, corpus digest == pinned{extra}")
    check(corpora["campaign"] == corpora["chunked"],
          "explore: the campaign's and the chunked corpora differ")

    # -- (b) full width: probe, then the campaign with one shrink
    sim = BatchedSim(wl.spec, wl.config, triage=True, coverage=True,
                     device=cuda)
    ms = probe(sim, EXPLORE_LANES)[0]
    gens = EXPLORE_GENERATIONS_FLOOR
    refills, shrinks, ends = [], [], []
    timed_calls_of(sim, "run_refill", refills, keep=lambda st: (
        int(st.refill.busy.shape[0]), int(st.refill.iters),
        sim.refill_read_s))
    shrink_seed = triage.shrink_seed
    timed_calls_of(triage, "shrink_seed", shrinks)
    try:
        c = campaign.Campaign(
            wl, dirs["wide"], meta_seed=0, lanes=EXPLORE_LANES, sim=sim,
            max_shrinks=1, spec_ref=TRIAGE_SPEC_REF, device=cuda,
            regression_dir=os.path.join(dirs["wide"], "regression"),
            log=lambda m: ends.append(time.perf_counter())
            if m.startswith("dispatch ") else None,
        )
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = c.run(gens)
        wall = time.perf_counter() - t0
        t1 = time.perf_counter()
        c.checkpoint()
        checkpoint_s = time.perf_counter() - t1
    finally:
        triage.shrink_seed = shrink_seed
    check(rep.coverage_curve == sorted(rep.coverage_curve),
          f"explore wide: coverage curve {rep.coverage_curve} falls")
    check(rep.first_violation_dispatch == 0,
          f"explore wide: first violation at dispatch "
          f"{rep.first_violation_dispatch}, not 0 (the uniform chunk)")
    wits = sorted(w["seed"] for b in c.bugs for w in b.witnesses)
    check(wits == sorted(v["seed"] for v in rep.violations),
          f"explore wide: {len(wits)} witnesses over {len(c.bugs)} records"
          f" for {len(rep.violations)} violations, want each once")
    shrunk = [b for b in c.bugs if b.bundle_path]
    check(len(shrunk) == 1 and len(shrinks) == 1 and c._shrinks_done == 1
          and not any(b.shrink_error for b in c.bugs),
          f"explore wide: {len(shrunk)} bundles, {len(shrinks)} shrinks, "
          f"errors {[b.shrink_error for b in c.bugs if b.shrink_error]}; "
          "want 1")
    rec = shrunk[0]
    bundle = triage.ReproBundle.load(rec.bundle_path)
    check((bundle.signature, bundle.campaign, bundle.generation)
          == (rec.signature, c.campaign_id, 0),
          f"explore wide: bundle stamped {bundle.signature}, "
          f"{bundle.campaign}, {bundle.generation}")
    first = rec.witnesses[0]
    cand = Candidate(*first["candidate"][:5], origin=first["origin"])
    check(bundle.seed == cand.seed,
          f"explore wide: shrunk seed {bundle.seed}, first witness "
          f"{cand.seed}")
    lost = suppressions_kept(cand, bundle)
    check(not lost, f"explore wide: the bundle of {cand.describe()} "
                    f"lost the candidate's suppressions {lost}")
    said = []
    t1 = time.perf_counter()
    reg = campaign.regress(dirs["wide"], device=cuda, out=said.append)
    replay_s = time.perf_counter() - t1
    ok = [m for m in said if m.startswith("device replay OK")]
    check(reg["bundles"] == 1 and not reg["failures"] and len(ok) == 1
          and f"at step {bundle.violation_step}, t={bundle.violation_t_us}us"
          in ok[0], f"explore wide: regress {reg}, said {said}")
    # the generations' own sweeps (EXPLORE_LANES lanes) and the
    # shrink's dispatches (lane_width lanes) are told apart by width;
    # each call's host reads are its step of the cumulative read time
    reads = np.diff([0.0] + [r for (_, _, r), _ in refills])
    gen_calls = [(it, w, rd) for ((lanes, it, _), w), rd
                 in zip(refills, reads) if lanes == EXPLORE_LANES]
    iters = [it for it, _, _ in gen_calls]
    gen_s = [w for _, w, _ in gen_calls]
    shrink_s = shrinks[0][1]
    ends = [t0] + ends
    gen_walls = [ends[i + 1] - ends[i] for i in range(gens)]
    row = {
        "lanes": EXPLORE_LANES, "generations": gens,
        "probe_step_ms": ms, "wall_s": wall,
        "generation_walls_s": gen_walls,
        "generations_per_s": gens / sum(gen_walls),
        "admissions_per_s": gens * EXPLORE_LANES / sum(gen_walls),
        "refill_iters": iters, "refill_s": gen_s,
        "ms_per_refill_iter": sum(gen_s) / sum(iters) * 1e3,
        "read_ms_per_iter": sum(rd for _, _, rd in gen_calls)
        / sum(iters) * 1e3,
        "coverage_curve": rep.coverage_curve,
        "corpus_curve": rep.corpus_curve,
        "violation_curve": rep.violation_curve,
        "violations": len(rep.violations),
        "first_violation_dispatch": rep.first_violation_dispatch,
        "records": len(c.bugs),
        "witnesses_per_record": [len(b.witnesses) for b in c.bugs],
        "shrunk_seed": cand.seed, "shrink_s": shrink_s,
        "shrink_dispatches": len(refills) - len(gen_calls),
        "shrunk": cand.describe(), "clause_profile": rec.clause_profile,
        "signature": rec.signature, "checkpoint_s": checkpoint_s,
        "violation_step": bundle.violation_step, "replay_s": replay_s,
    }
    out["wide"] = row
    phase(13, f"full width {EXPLORE_LANES} lanes x {gens} generations "
              f"in {wall:.3f} s (dedup and shrink included): "
              f"{row['generations_per_s']:.4f} generations/s, "
              f"{row['admissions_per_s']:.1f} admissions/s (generation "
              f"walls {[round(x, 3) for x in gen_walls]} s), refill "
              f"{iters} iterations at {row['ms_per_refill_iter']:.3f} "
              f"ms/iteration (probe {ms:.3f} ms/step), coverage "
              f"{rep.coverage_curve}, corpus {rep.corpus_curve}, "
              f"violations {rep.violation_curve}, first at dispatch "
              f"{rep.first_violation_dispatch}")
    phase(13, f"dedup: {len(rep.violations)} violations -> "
              f"{len(c.bugs)} records, witnesses per record "
              f"{row['witnesses_per_record']}; shrink of the first coarse "
              f"group's first witness, {cand.describe()}, in "
              f"{shrink_s:.3f} s ({row['shrink_dispatches']} dispatches), "
              f"clauses {rec.clause_profile}, signature "
              f"{rec.signature[:16]}, stamped (campaign {c.campaign_id}, "
              f"generation 0), its suppressions kept; checkpoint "
              f"{checkpoint_s:.3f} s; regress 1/1 green at step "
              f"{bundle.violation_step} t={bundle.violation_t_us} us in "
              f"{replay_s:.3f} s")
    out["phase_s"] = time.perf_counter() - t_phase
    phase(13, f"on {card}: pinned campaign {out['pinned_campaign_s']:.3f}"
              f" s, chunked {out['pinned_chunked_s']:.3f} s; full width "
              f"{row['admissions_per_s']:.1f} admissions/s, "
              f"{row['ms_per_refill_iter']:.3f} ms/iteration, "
              f"shrink {shrink_s:.3f} s "
              f"[{out['phase_s']:.0f} s in phase 13]")
    return out, {"report": rep, "corpus": [e.to_dict() for e in c.ex.corpus],
                 "dirs": dirs}


def phase15_campaigns(cuda, card: str, dirs: dict) -> dict:
    """Campaigns, the federation and the measurement discipline on the
    card. (a) `campaign.merge_and_minimize` over phase 13's two campaign
    directories at a lane width of at least the merged entry count (one
    dispatch): the kept union equals the merged union (popcount and
    words), every replayed bitmap equals its recorded one (raised on in
    `minimize`), kept <= merged, and the merged manifest is "merged",
    which `Campaign.resume` refuses. (b) The pinned federation
    (`digest.FEDERATION_RUN` at FEDERATION_H_US) on the host loop reaches
    PINNED_FEDERATION with an exchange whose merged corpus is not empty,
    and on the device loop (`device_window=3`, windows clipped to 2 + 1)
    gives the same fingerprint, exchange log, coverage bits and
    violations. (c) `measure.time_scan_ms` on the 16-lane pinned sim
    (scan 20, warm 10, 3 rounds), beside `measure.fresh_seeds`' blocks;
    not gated on its value. Its summary line names the card."""
    from madsim_tpu_torch import campaign, measure
    from madsim_tpu_torch.explore import Federation, popcount_rows
    from madsim_tpu_torch.tpu import BatchedSim
    from madsim_tpu_torch.tpu.digest import (
        EXPLORE_RUN, FEDERATION_GENERATIONS, FEDERATION_H_US, FEDERATION_RUN,
        PINNED_FEDERATION,
    )

    t_phase = time.perf_counter()
    wl = explore_workload()
    out: dict = {}

    # -- (a) merge + minimize, one dispatch
    srcs = [dirs["pinned"], dirs["wide"]]
    entries, _ = campaign.merge_corpora(srcs)
    merged = os.path.join(os.path.dirname(dirs["wide"]), "merged")
    sim = BatchedSim(wl.spec, wl.config, triage=True, coverage=True,
                     device=cuda)
    runs = []
    timed_calls_of(sim, "run", runs, keep=lambda st: None)
    t0 = time.perf_counter()
    res = campaign.merge_and_minimize(srcs, merged, workload=wl, sim=sim,
                                      lane_width=max(2, len(entries)))
    wall = time.perf_counter() - t0
    union = np.zeros_like(entries[0].bitmap)
    for e in entries:
        union |= e.bitmap
    kept_union = np.zeros_like(union)
    for e in res["kept"]:
        kept_union |= e.bitmap
    bits = int(popcount_rows(union[None, :])[0])
    check(np.array_equal(kept_union, union)
          and np.array_equal(res["union"], union)
          and res["kept_bits"] == res["merged_bits"] == bits,
          f"merge: kept {res['kept_bits']} bits, merged "
          f"{res['merged_bits']}, recorded union {bits}")
    check(0 < len(res["kept"]) <= len(entries) == res["replayed"]
          and res["dispatches"] == len(runs) == 1,
          f"merge: {len(res['kept'])} kept of {len(entries)} in "
          f"{res['dispatches']} dispatches")
    with open(os.path.join(merged, campaign.MANIFEST)) as f:
        kind = json.load(f)["kind"]
    refused = ""
    try:
        campaign.Campaign.resume(merged, workload=wl, device=cuda)
    except ValueError as e:
        refused = str(e)
    check(kind == "merged" and "resume" in refused,
          f"merge: manifest kind {kind!r}, resume said {refused!r}")
    out["merge"] = {"merged": len(entries), "kept": len(res["kept"]),
                    "bits": bits, "wall_s": wall, "dispatch_s": runs[0][1]}
    phase(15, f"merge + minimize of phase 13's two campaigns: "
              f"{len(entries)} merged -> {len(res['kept'])} kept, "
              f"{bits} union bits kept exactly, every replayed bitmap "
              f"equal to its recorded one; 1 dispatch of {len(entries)} "
              f"lanes in {runs[0][1]:.3f} s ({wall:.3f} s in all); the "
              "merged corpus refuses a resume")
    del sim

    # -- (b) the pinned federation, host loop and device loop
    fwl = explore_workload(FEDERATION_H_US)
    feds = {}
    for name, kw in (("host", {}),
                     ("device", dict(device_loop=True, device_window=3))):
        fed = Federation(fwl, device=cuda, **FEDERATION_RUN, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = fed.run(FEDERATION_GENERATIONS)
        feds[name] = (rep, time.perf_counter() - t0)
    host, dev = feds["host"][0], feds["device"][0]
    check(host["fingerprint"] == PINNED_FEDERATION,
          f"federation: fingerprint {host['fingerprint']} != "
          f"{PINNED_FEDERATION}")
    check(bool(host["exchanges"]) and host["exchanges"][0]["merged"] > 0,
          f"federation: exchanges {host['exchanges']}")
    for key in ("fingerprint", "exchanges", "coverage_bits", "violations"):
        check(dev[key] == host[key],
              f"federation: the device loop's {key} {dev[key]} != the "
              f"host loop's {host[key]}")
    out["federation"] = {
        "generations": FEDERATION_GENERATIONS,
        "host_s": feds["host"][1], "device_s": feds["device"][1],
        "host_generations_per_s": FEDERATION_GENERATIONS / feds["host"][1],
        "device_generations_per_s": FEDERATION_GENERATIONS
        / feds["device"][1],
        "exchanges": host["exchanges"], "coverage_bits":
        host["coverage_bits"], "violations": host["violations"],
    }
    phase(15, f"federation {FEDERATION_RUN['n_islands']} islands x "
              f"{FEDERATION_RUN['lanes']} lanes x {FEDERATION_GENERATIONS} "
              f"generations at {FEDERATION_H_US / 1e6} virtual s: host loop"
              f" {feds['host'][1]:.3f} s, device loop (windows 2 + 1) "
              f"{feds['device'][1]:.3f} s; fingerprint "
              f"{host['fingerprint'][:16]} == pinned on both, exchanges "
              f"{host['exchanges']}, {host['coverage_bits']} bits, "
              f"{host['violations']} violations, equal")

    # -- (c) the measurement discipline on CUDA tensors
    psim = BatchedSim(wl.spec, wl.config, triage=True, coverage=True,
                      device=cuda)
    lanes = EXPLORE_RUN["lanes"]
    step_ms = measure.time_scan_ms(psim.init, psim.run_steps, lanes=lanes,
                                   scan=20, warm_steps=10, rounds=3)
    blocks = [measure.fresh_seeds(r, lanes) for r in range(4)]
    out["measure"] = {"lanes": lanes, "scan": 20, "warm_steps": 10,
                      "rounds": 3, "step_ms": step_ms,
                      "seed_blocks": [[int(b[0]), int(b[-1])]
                                      for b in blocks]}
    phase(15, f"measure.time_scan_ms: {lanes} lanes, scan 20 after 10 "
              f"warm steps, median of 3 fresh-seed reps: {step_ms:.3f} "
              f"ms/step; seed blocks (warm, reps 1-3) "
              f"{out['measure']['seed_blocks']}")
    out["phase_s"] = time.perf_counter() - t_phase
    phase(15, f"on {card}: minimize dispatch {runs[0][1]:.3f} s, "
              f"federation {out['federation']['host_generations_per_s']:.4f}"
              f" / {out['federation']['device_generations_per_s']:.4f} "
              f"generations/s (host / device loop), scan "
              f"{step_ms:.3f} ms/step [{out['phase_s']:.0f} s in phase 15]")
    return out


def devloop_boundary_state(sim, seed: int, gens_done: int, target: int):
    """A device-loop state at a generation boundary (the queue drained,
    every lane done), made from `seed` on sim's device at its plan's
    population: an uploaded ring (12 rows, novelty ties), a sparse union,
    a seen table holding the ring's genomes and generation 0's (planted
    duplicates: a mutant that restores its parent's horizon is its
    parent) plus random rows and one repeated row, and a refill log of
    seeded bitmaps (bits from a pool of 600, so ties in novelty),
    violations, high waters and transitions. `gens_done`/`target` place
    the boundary inside the window (the next generation is built) or at
    its end (fold only)."""
    from madsim_tpu_torch import explore
    from madsim_tpu_torch import nemesis as nm
    from madsim_tpu_torch.tpu.engine import COV_WORDS

    plan, dev = sim.devloop, sim.device
    A, K = plan.pop, plan.top_k
    rng = np.random.default_rng(seed)
    n_occ = len(nm.OCC_CLAUSES)
    pop = [explore.Candidate(seed=i) for i in range(A)]
    rows = []
    for i in range(K - 4):
        occ = [0] * n_occ
        occ[nm.OCC_ROW["crash"]] = int(rng.integers(0, 8))
        rows.append(explore.Candidate(
            seed=int(rng.integers(0, 2**32)),
            off=int(rng.integers(0, 2)) * nm.TRIAGE_BIT["partition"],
            occ_off=tuple(occ), origin="mutant"))
    bits = sorted(rng.choice([300, 120, 120, 40, 40, 40, 9], len(rows)),
                  reverse=True)
    ring = {
        "n": len(rows), "bits": bits, "seed": [c.seed for c in rows],
        "off": [c.off for c in rows], "occ": [c.occ_off for c in rows],
        "rate": [c.rate_scale for c in rows],
        "h": [c.horizon_us for c in rows],
    }
    hs = [explore.genome_hash64(c.key()) for c in rows + pop]
    hs += [(int(a), int(b)) for a, b in rng.integers(0, 2**32, (64, 2))]
    hs.append(hs[len(rows) // 2])
    pool = rng.choice(COV_WORDS * 32, 600, replace=False)
    union = np.zeros(COV_WORDS, np.uint32)
    for b in rng.choice(pool, 150, replace=False):
        union[b // 32] |= np.uint32(1 << (b % 32))
    st = sim.init_devloop(
        np.arange(A, dtype=np.uint32), lanes=A,
        ctl=explore.ctl_for(pop, plan.full_h, dev), window=2,
        step_cap=20_000, meta_seed=seed,
        meta_counter=int(rng.integers(0, 1000)), next_fresh=A,
        target_gens=target, gen_h_raw=[0] * A, gen_origin=[0] * A,
        ring=ring, union=union,
        seen={"n": len(hs), "h1": [a for a, _ in hs],
              "h2": [b for _, b in hs]},
    )
    bm = np.zeros((A, COV_WORDS), np.int64)
    for i in range(A):
        for b in rng.choice(pool, rng.integers(0, 6)):
            bm[i, b // 32] |= 1 << (b % 32)

    def t(a):
        return torch.as_tensor(a, device=dev)

    rf = st.refill._replace(
        cursor=t(np.int32(A)), cov_bitmap=t(bm),
        violated=t(rng.random(A) < 0.3),
        cov_hiwater=t(rng.integers(0, 60, A).astype(np.int32)),
        cov_transitions=t(rng.integers(0, 900, A).astype(np.int32)),
        steps=t(rng.integers(1, 2000, A).astype(np.int32)),
        retired=t(rng.integers(0, 600, A).astype(np.int32)),
    )
    return st._replace(
        done=torch.ones_like(st.done), refill=rf,
        loop=st.loop._replace(gens_done=t(np.int32(gens_done))),
    )


def phase14_devloop(cuda, card: str, host: dict) -> dict:
    """The device-resident search loop on the card. (a) The boundary at
    EXPLORE_LANES admissions: `_devloop_boundary` of a seeded boundary
    state (`devloop_boundary_state`) on the card equals the CPU's in every
    leaf, `loop.*` included, inside the window (mutate and respawn) and at
    its end (fold only). (b) The full-width search by the device loop,
    `Explorer(meta_seed=0, lanes=EXPLORE_LANES, device_loop=True)` over
    phase 13(b)'s generations in one window, with telemetry on: its
    fingerprint, curves and corpus (entry for entry) equal phase 13(b)'s
    host loop, the explorer's window oracle passes with one
    `devloop_results` per window, and the events count the generations.
    Prints generations/s, admissions/s, ms per refill iteration, ms per
    boundary and host read ms per iteration beside phase 13(b)'s."""
    from madsim_tpu_torch import telemetry
    from madsim_tpu_torch.explore import Explorer
    from madsim_tpu_torch.tpu import BatchedSim, engine
    from madsim_tpu_torch.tpu.convert import state_to_numpy
    from madsim_tpu_torch.tpu.spec import tree_map

    t_phase = time.perf_counter()
    wl = explore_workload()
    plan = engine.make_devloop_plan(wl.config, pop=EXPLORE_LANES)
    out: dict = {}

    # -- (a) one boundary, card against CPU
    sims = {str(d): BatchedSim(wl.spec, wl.config, triage=True,
                               coverage=True, devloop=plan, device=d)
            for d in ("cpu", cuda)}
    for gens_done, where in ((0, "inside the window"), (1, "window end")):
        st = devloop_boundary_state(sims["cpu"], DEVLOOP_STATE_SEED,
                                    gens_done, 2)
        card_st = tree_map(lambda x: x.to(cuda), st)
        want = sims["cpu"]._devloop_boundary(st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sims[str(cuda)]._devloop_boundary(card_st)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        g, c = state_to_numpy(got), state_to_numpy(want)
        bad = leaves_equal(g, c)
        check(not bad and any(k.startswith("loop.") for k in g),
              f"devloop boundary ({where}): card and CPU leaves differ: "
              f"{bad}")
        org = g["loop.gen_origin"]
        mut = org[plan.n_fresh:plan.n_fresh + plan.n_mut]
        extra = (f"; next generation: {int((mut == 1).sum())} mutants, "
                 f"{int((mut == 0).sum())} fallbacks, "
                 f"{int((org == 2).sum())} swarm"
                 if gens_done == 0 else "")
        out[f"boundary_{gens_done}"] = {"first_call_ms": ms}
        phase(14, f"boundary at {EXPLORE_LANES} admissions ({where}): "
                  f"{len(g)} leaves equal card/CPU, {int(g['loop.accepts'])}"
                  f" accepted, ring {int(g['loop.ring_n'])}, seen "
                  f"{int(g['loop.seen_n'])} rows{extra}; first card call "
                  f"{ms:.1f} ms")
    del sims

    # -- (b) the full-width search by the device loop
    gens = host["report"].dispatches
    sim = BatchedSim(wl.spec, wl.config, triage=True, coverage=True,
                     devloop=plan, device=cuda)
    runs, boundaries, decodes = [], [], []
    timed_calls_of(sim, "run_devloop", runs,
                   keep=lambda st: int(st.refill.iters))
    inner = sim._devloop_boundary

    def boundary(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = inner(*a, **kw)
        torch.cuda.synchronize()
        boundaries.append(time.perf_counter() - t0)
        return res

    sim._devloop_boundary = boundary
    results = engine.devloop_results
    engine.devloop_results = lambda st: decodes.append(1) or results(st)
    tel_dir = tempfile.mkdtemp(prefix="chip_smoke_devloop-")
    telemetry.enable(out_dir=tel_dir)
    try:
        ex = Explorer(wl, meta_seed=0, lanes=EXPLORE_LANES, sim=sim,
                      device_loop=True, device_window=gens,
                      shrink_violations=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = ex.run(gens)
        wall = time.perf_counter() - t0
        lines = telemetry.read_events(os.path.join(tel_dir, "events.jsonl"))
    finally:
        telemetry.disable()
        engine.devloop_results = results
        shutil.rmtree(tel_dir, ignore_errors=True)
    want = host["report"]
    for what, a, b in (
        ("fingerprint", rep.fingerprint(), want.fingerprint()),
        ("coverage curve", rep.coverage_curve, want.coverage_curve),
        ("corpus curve", rep.corpus_curve, want.corpus_curve),
        ("violation curve", rep.violation_curve, want.violation_curve),
        ("corpus", [e.to_dict() for e in ex.corpus], host["corpus"]),
        ("violating candidates", [v["candidate"] for v in rep.violations],
         [v["candidate"] for v in want.violations]),
    ):
        check(a == b, f"devloop wide: the {what} differs from phase 13(b)'s "
                      "host loop")
    check(len(decodes) == 1 and len(runs) == 1,
          f"devloop wide: {len(decodes)} decodes, {len(runs)} windows")
    tel = [e for e in lines if e["name"] == "explore_devloop_generations"]
    check(bool(tel) and tel[-1]["value"] == gens,
          f"devloop wide: telemetry counted {tel[-1:]} generations")
    iters, run_s = runs[0]
    h13 = host["row"]
    row = {
        "lanes": EXPLORE_LANES, "generations": gens, "wall_s": wall,
        "generations_per_s": gens / wall,
        "admissions_per_s": gens * EXPLORE_LANES / wall,
        "refill_iters": iters, "ms_per_refill_iter": run_s / iters * 1e3,
        "boundary_ms": [b * 1e3 for b in boundaries],
        "read_ms_per_iter": sim.refill_read_s / iters * 1e3,
        "coverage_curve": rep.coverage_curve,
        "corpus_curve": rep.corpus_curve,
        "violation_curve": rep.violation_curve,
    }
    out["wide"] = row
    out["phase_s"] = time.perf_counter() - t_phase
    phase(14, f"device loop {EXPLORE_LANES} lanes x {gens} generations in "
              f"one window: fingerprint, curves and {len(ex.corpus)} corpus "
              f"entries equal phase 13(b)'s host loop, 1 decode, telemetry "
              f"counted {gens} generations")
    phase(14, f"on {card}, device loop / host loop (phase 13(b)): "
              f"{row['generations_per_s']:.4f} / "
              f"{h13['generations_per_s']:.4f} generations/s, "
              f"{row['admissions_per_s']:.1f} / "
              f"{h13['admissions_per_s']:.1f} admissions/s, "
              f"{row['ms_per_refill_iter']:.3f} / "
              f"{h13['ms_per_refill_iter']:.3f} ms per refill iteration "
              f"({iters} / {sum(h13['refill_iters'])} iterations), host "
              f"read {row['read_ms_per_iter']:.3f} / "
              f"{h13['read_ms_per_iter']:.3f} ms per iteration; boundaries "
              f"{[round(b, 3) for b in row['boundary_ms']]} ms "
              f"[{out['phase_s']:.0f} s in phase 14]")
    return out


def rich_plan():
    """CHAOS_PLAN with every message clause armed on top: Duplicate 0.1 and
    Reorder 0.2 / 120 ms (tests/test_speclang.py:76-82's RICH_PLAN)."""
    from madsim_tpu_torch import nemesis as nm
    from madsim_tpu_torch.tpu.digest import CHAOS_PLAN

    return nm.FaultPlan(name="speclang-rich", clauses=CHAOS_PLAN.clauses + (
        nm.Duplicate(rate=0.1), nm.Reorder(rate=0.2, window_us=120_000),
    ))


def phase16_golden(cuda) -> dict:
    """Phase 16(b), in phase 6's child process: twopc-gen's golden run at
    GOLDEN["twopc"], and lease-gen under RICH_PLAN equal to the hand lease
    on the card and to lease-gen on the CPU, leaf for leaf."""
    from madsim_tpu_torch.nemesis import FIRE_INDEX
    from madsim_tpu_torch.speclang.generated import (
        lease_device, twopc_device,
    )
    from madsim_tpu_torch.tpu import BatchedSim, SimConfig, compile_plan
    from madsim_tpu_torch.tpu import make_lease_spec
    from madsim_tpu_torch.tpu.convert import state_to_numpy
    from madsim_tpu_torch.tpu.digest import (
        GOLDEN, canonical_digest, golden_run,
    )

    _, cfg, seeds, steps = golden_run("twopc")
    st, wall = timed_run(BatchedSim(twopc_device.make_spec(), cfg,
                                    device=cuda), seeds, steps)
    g = state_to_numpy(st)
    check(bool((g["steps"] == steps).all()),
          f"twopc-gen golden: the run did not take exactly {steps} steps")
    dg = canonical_digest(g)
    check(dg == GOLDEN["twopc"],
          f"twopc-gen golden: card digest {dg} != GOLDEN {GOLDEN['twopc']}")
    out = {"twopc_gen": {"lanes": len(seeds), "steps": steps, "card_s": wall,
                         "digest": dg}}
    phase(16, f"(b) twopc-gen golden: {len(seeds)} lanes x {steps} steps in "
              f"{wall:.3f} s, digest {dg[:16]} == GOLDEN['twopc']")
    rcfg = compile_plan(rich_plan(), SimConfig(horizon_us=30_000_000))
    gen_st, gen_s = timed_run(BatchedSim(lease_device.make_spec(), rcfg,
                                         device=cuda), seeds, steps)
    gen = state_to_numpy(gen_st)
    hand = state_to_numpy(BatchedSim(make_lease_spec(), rcfg,
                                     device=cuda).run(seeds, steps))
    cpu = state_to_numpy(BatchedSim(lease_device.make_spec(), rcfg,
                                    device="cpu").run(seeds, steps))
    for what, other in (("the hand lease on the card", hand),
                        ("lease-gen on the CPU", cpu)):
        bad = leaves_equal(gen, other)
        check(not bad, f"lease-gen under RICH_PLAN differs from {what}: {bad}")
    fires = {k: int(gen["fires"][:, FIRE_INDEX[k]].sum())
             for k in ("dup", "reorder")}
    check(min(fires.values()) > 0, f"lease-gen under RICH_PLAN: {fires}")
    out["lease_gen"] = {"lanes": len(seeds), "steps": steps,
                        "card_s": gen_s, "fires": fires}
    phase(16, f"(b) lease-gen under RICH_PLAN: {len(seeds)} lanes x {steps} "
              f"steps in {gen_s:.3f} s, {len(gen)} leaves equal the hand "
              f"lease on the card and lease-gen on the CPU; dup "
              f"{fires['dup']}, reorder {fires['reorder']}")
    return out


def phase16e_explore(cuda, virtual_secs: float) -> dict:
    """Phase 16(e), last in the child (an eager, host-bound leg; the
    parent's phases run beside it): the explorer over the buggy backup
    (the JAX deep test's: 64 lanes, one generation, one shrink) at
    `virtual_secs` (the valve's depth) finds the bug, and its shrunk
    bundle keeps Duplicate or Reorder."""
    from madsim_tpu_torch import explore, triage
    from madsim_tpu_torch.speclang.generated import backup_device

    work = tempfile.mkdtemp(prefix="chip_smoke_speclang-")
    try:
        t0 = time.perf_counter()
        bundles = os.path.join(work, "speclang-bundles")
        ex = explore.Explorer(
            backup_device.make_workload(buggy=True,
                                        virtual_secs=virtual_secs),
            meta_seed=0, lanes=SPECLANG_EXPLORE_LANES,
            shrink_violations=True, max_shrinks=1,
            shrink_kwargs={"out_dir": bundles}, device=cuda,
        )
        rep = ex.run(1)
        wall = time.perf_counter() - t0
        check(bool(rep.violations),
              f"speclang explorer: the planted stale-read bug not found in "
              f"{SPECLANG_EXPLORE_LANES} lanes")
        shrunk = [v for v in rep.violations if v.get("bundle_path")]
        check(bool(shrunk), "speclang explorer: no violation was shrunk")
        bundle = triage.ReproBundle.load(shrunk[0]["bundle_path"])
        kept = sorted({type(c).__name__ for c in
                       triage.plan_from_json(bundle.plan).clauses})
        check(bundle.violation_step > 0
              and bool(set(kept) & {"Duplicate", "Reorder"}),
              f"speclang explorer: the shrunk plan {kept} lost the "
              "message-clause axis the stale-read bug needs")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase(16, f"(e) explorer over the buggy backup, "
              f"{SPECLANG_EXPLORE_LANES} lanes x 1 generation at "
              f"{virtual_secs} virtual s in {wall:.1f} s (in the child, "
              f"after phase 17): {len(rep.violations)} violations, seed "
              f"{shrunk[0]['seed']} shrunk to {kept} at step "
              f"{bundle.violation_step}")
    return {"lanes": SPECLANG_EXPLORE_LANES, "virtual_secs": virtual_secs,
            "wall_s": wall, "violations": len(rep.violations),
            "seed": shrunk[0]["seed"],
            "violation_step": bundle.violation_step, "kept": kept,
            "fingerprint": rep.fingerprint()}


def phase16_speclang(cuda, card: str, work: str) -> dict:
    """Phase 16, the speclang device face at full width: (a) `emit --check`
    is clean; (c) twopc-gen and the hand twopc at 32768 lanes x 1 virtual s
    give one canonical digest; (d) backup, correct and buggy, at
    BACKUP_LANES x 5 nodes at its defaults (a horizon cut only when the
    probe says a build would overrun BACKUP_BUDGET_S, never below
    BACKUP_FLOOR, printed): the correct build never violates, the buggy
    one on at least BACKUP_BUG_SHARE of its lanes, every enabled fire kind
    fires, and seeds 0..63 equal a 64-lane CPU run in every leaf but
    `key`. (b) runs in phase 6's child, (e) in phase 18's
    (`phase16e_explore`)."""
    from madsim_tpu_torch.speclang.__main__ import main as speclang_main
    from madsim_tpu_torch.speclang.generated import (
        backup_device, twopc_device,
    )
    from madsim_tpu_torch.tpu import BatchedSim, summarize, twopc_workload
    from madsim_tpu_torch.tpu.convert import state_to_numpy
    from madsim_tpu_torch.tpu.digest import canonical_digest
    from madsim_tpu_torch.tpu.nemesis import enabled_fire_kinds

    t_phase = time.perf_counter()
    out = {}
    # -- (a) the drift gate
    check(speclang_main(["emit", "--check"]) == 0,
          "speclang: `emit --check` found drift")
    phase(16, "(a) `python -m madsim_tpu_torch.speclang emit --check`: clean")

    # -- (c) twopc-gen against the hand twopc at full width
    gen_wl = twopc_device.make_workload(virtual_secs=1.0)
    hand_wl = twopc_workload(virtual_secs=1.0)
    check(gen_wl.config.to_toml() == hand_wl.config.to_toml(),
          "twopc-gen's config differs from the hand twopc's")
    digests, walls = {}, {}
    for what, wl in (("gen", gen_wl), ("hand", hand_wl)):
        st, walls[what] = timed_run(BatchedSim(wl.spec, wl.config,
                                               device=cuda),
                                    range(LANES), MAX_STEPS)
        check(bool(st.done.all()), f"twopc {what}: hit max_steps")
        digests[what] = canonical_digest(state_to_numpy(st))
        steps_run = int(st.steps.max())
        del st
    check(digests["gen"] == digests["hand"],
          f"twopc-gen {digests['gen']} != hand twopc {digests['hand']} at "
          f"{LANES} lanes")
    out["twopc"] = {"lanes": LANES, "virtual_secs": 1.0,
                    "steps_run": steps_run, "walls_s": walls,
                    "digest": digests["gen"]}
    phase(16, f"(c) twopc-gen / hand twopc, {LANES} lanes x 1 virtual s x "
              f"{steps_run} steps: {walls['gen']:.3f} / {walls['hand']:.3f}"
              f" s, one canonical digest {digests['gen'][:16]}")

    # -- (d) backup at full width, correct and buggy
    for buggy in (False, True):
        tag = "buggy" if buggy else "correct"
        full_secs = virtual_secs = 10.0
        wl = backup_device.make_workload(buggy=buggy)
        sim = BatchedSim(wl.spec, wl.config, device=cuda)
        ms = block_probe(sim, BACKUP_LANES)[0]
        est_s = BACKUP_EST_STEPS * ms / 1e3
        cut = ""
        if est_s > BACKUP_BUDGET_S:
            virtual_secs = round(max(BACKUP_FLOOR[buggy],
                                     BACKUP_BUDGET_S / est_s) * full_secs, 2)
            cut = (f" (cut: virtual_secs {full_secs} -> {virtual_secs}; "
                   f"{BACKUP_EST_STEPS} steps at {ms:.2f} ms/step were "
                   f"estimated at {est_s:.0f} s)")
            wl = backup_device.make_workload(buggy=buggy,
                                             virtual_secs=virtual_secs)
            sim = BatchedSim(wl.spec, wl.config, device=cuda)
        st, wall = timed_run(sim, range(BACKUP_LANES), MAX_STEPS)
        check(bool(st.done.all()), f"backup {tag}: hit max_steps")
        s = summarize(st, wl.spec)
        steps_run = int(st.steps.max())
        kinds = enabled_fire_kinds(wl.config)
        fires = {k: s[f"fires_{k}"] for k in kinds}
        check(set(kinds) >= {"crash", "dup", "reorder"},
              f"backup {tag}: enabled fire kinds {kinds}")
        dead = [k for k, n in fires.items() if n <= 0]
        check(not dead, f"backup {tag}: enabled kinds that never fired: "
                        f"{dead}")
        if buggy:
            check(s["violations"] >= BACKUP_BUG_SHARE * BACKUP_LANES,
                  f"backup buggy: violated on {s['violations']}/"
                  f"{BACKUP_LANES} lanes, the JAX test demands >= "
                  f"{BACKUP_BUG_SHARE:.4f}")
        else:
            check(s["violations"] == 0,
                  f"backup correct: violated on {s['violations']} lanes "
                  f"{s['violation_lanes']}")
        big = state_to_numpy(first_lanes(st, SEEDS_SMALL))
        del st, sim
        small = state_to_numpy(BatchedSim(wl.spec, wl.config, device="cpu")
                               .run(range(SEEDS_SMALL), MAX_STEPS))
        del big["key"], small["key"]
        bad = leaves_equal(big, small)
        check(not bad, f"backup {tag}: seeds 0..{SEEDS_SMALL - 1} of the "
                       f"card run differ from a {SEEDS_SMALL}-lane CPU run "
                       f"in {bad}")
        out[f"backup_{tag}"] = {
            "lanes": BACKUP_LANES, "virtual_secs": virtual_secs,
            "probe_step_ms": ms, "wall_s": wall, "steps_run": steps_run,
            "step_ms": wall / steps_run * 1e3,
            "seeds_per_sec": BACKUP_LANES / wall,
            "violations": s["violations"], "fires": fires,
            "total_overflow": s["total_overflow"],
        }
        phase(16, f"(d) backup {tag} {BACKUP_LANES} lanes x 5 nodes, "
                  f"{virtual_secs} virtual s{cut}: "
                  f"{BACKUP_LANES / wall:.1f} seeds/s, "
                  f"{wall / steps_run * 1e3:.3f} ms/step x {steps_run} steps "
                  f"({wall:.3f} s), violations {s['violations']}/"
                  f"{BACKUP_LANES}, overflow {s['total_overflow']}; fires "
                  + ", ".join(f"{k} {n}" for k, n in fires.items())
                  + f"; {len(big)} leaves (all but key) of seeds "
                  f"0..{SEEDS_SMALL - 1} equal a {SEEDS_SMALL}-lane CPU run")

    out["phase_s"] = time.perf_counter() - t_phase
    phase(16, f"(a)-(d) took {out['phase_s']:.0f} s")
    return out


def card_kind(index: int = 0) -> str:
    """The card's name as the tuned cache keys it (`tune.device_kind`)."""
    return "".join(c if c.isalnum() else "_"
                   for c in torch.cuda.get_device_name(index))


def count_captures(sim_cls, counter: list):
    """Wrap `sim_cls._block_graph` to add one to counter[0] per CUDA graph
    it captures (the sim's graph slot changing); returns the undo."""
    inner = sim_cls._block_graph

    def counted(self, state):
        before = self._graph
        out = inner(self, state)
        if self._graph is not before:
            counter[0] += 1
        return out

    sim_cls._block_graph = counted
    return lambda: setattr(sim_cls, "_block_graph", inner)


def phase17_tune_serve(cuda, card: str, work: str, serve_secs: float) -> dict:
    """Phase 17, in the child after phase 19: measured tuning and the fuzz
    service on the card: (a) the Tier-A tune, every timed trial's graph
    captures counted; (b) the tuned sweeps' rows against the default's and
    the CPU's; (c) the Tier-B gate's legs 1-2 against the CPU's; (d) serve
    stopped and restarted, against PINNED_EXPLORE and an uninterrupted CPU
    serve, its raft request at `serve_secs` (the valve's depth)."""
    import dataclasses

    from madsim_tpu_torch import campaign, tune
    from madsim_tpu_torch.explore import _named_workload
    from madsim_tpu_torch.tpu import BatchedSim, raft_workload
    from madsim_tpu_torch.tpu.batch import run_batch
    from madsim_tpu_torch.tpu.digest import EXPLORE_RUN, PINNED_EXPLORE

    t_phase = time.perf_counter()
    out: dict = {}
    cache = os.path.join(work, "tuned")
    prev_cache = os.environ.get("MADSIM_TUNED_DIR")
    os.environ["MADSIM_TUNED_DIR"] = cache
    try:
        # -- (a) Tier A on the card, no capture inside a timed trial
        wl = _named_workload("raft", TUNE_SECS, False)
        captures, timed = [0], []
        inner_timer = tune.SweepTimer

        def timer(run, **kw):
            def counted(assign, rep):
                before = captures[0]
                res = run(assign, rep)
                if rep != 0:  # SweepTimer's warm rep is rep 0
                    timed.append(captures[0] - before)
                return res
            return inner_timer(counted, **kw)

        undo = count_captures(BatchedSim, captures)
        tune.SweepTimer = timer
        trial_lines: list = []
        t0 = time.perf_counter()
        try:
            entry = tune.tune_workload(
                wl, "raft", lanes=TUNE_SEEDS, quick=True, cache_dir=cache,
                log=trial_lines.append, device=cuda)
        finally:
            tune.SweepTimer = inner_timer
            undo()
        tune_s = time.perf_counter() - t0
        check(entry.device_kind == card_kind(),
              f"tune: entry device kind {entry.device_kind!r} is not the "
              f"card's {card_kind()!r}")
        check(tune.load_tuned(wl.spec.name, wl.config, TUNE_SEEDS, dir=cache,
                              device=cuda) == entry,
              "tune: load_tuned does not find the entry it wrote")
        check(len(timed) == entry.trials,
              f"tune: {len(timed)} timed reps for {entry.trials} trials")
        check(sum(timed) == 0 and captures[0] > 0,
              f"tune: timed trials captured {sum(timed)} graphs "
              f"({captures[0]} captures in all)")
        out["tune"] = {"seeds": TUNE_SEEDS, "virtual_secs": TUNE_SECS,
                       "wall_s": tune_s, "entry": entry.to_doc(),
                       "key": entry.key(), "trial_lines": trial_lines,
                       "captures": captures[0], "timed_captures": sum(timed)}
        phase(17, f"(a) Tier-A tune of raft5, {TUNE_SEEDS} seeds x "
                  f"{TUNE_SECS} virtual s, quick grid, in {tune_s:.1f} s: "
                  f"{entry.trials} trials ("
                  + "; ".join(x.replace("[tune] ", "") for x in trial_lines)
                  + f"); winner {entry.dispatch or 'the defaults'}, fallback "
                  f"{entry.fallback}, baseline {entry.baseline_seeds_per_sec}"
                  f" / tuned {entry.tuned_seeds_per_sec} seeds/s; key "
                  f"{entry.key()}; {captures[0]} graph captures, none inside "
                  f"a timed trial; {card}")

        # -- (b) the tuned sweeps' rows on the card
        rows = ("violated", "deadlocked", "violation_step")
        sim = BatchedSim(wl.spec, wl.config, device=cuda)
        walls = {}

        def sweep(what, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = run_batch(range(TUNE_SEEDS), wl, sim=sim, max_traces=0,
                            repro_on_host=False, **kw)
            walls[what] = time.perf_counter() - t
            return res

        base = sweep("default")
        for what, tuning in (("auto", "auto"), *TUNE_FORCED.items()):
            res = sweep(what, tuning=tuning)
            for k in rows:
                check(np.array_equal(getattr(res, k), getattr(base, k)),
                      f"tuned sweep {what}: {k} differs from the default's")
            if "refill_lanes" not in tune.resolve_tuning(
                    tuning, wl.spec.name, wl.config, TUNE_SEEDS, device=cuda):
                check(np.array_equal(res.retired_step, base.retired_step),
                      f"tuned sweep {what}: step counts differ")
        cpu = run_batch(range(SEEDS_SMALL), wl, device="cpu", max_traces=0,
                        repro_on_host=False)
        for k in rows + ("retired_step",):
            check(np.array_equal(getattr(base, k)[:SEEDS_SMALL],
                                 getattr(cpu, k)),
                  f"tuned sweeps: seeds 0..{SEEDS_SMALL - 1} differ from the "
                  f"CPU in {k}")
        out["sweeps"] = {"walls_s": walls,
                         "violations": int(base.violated.sum())}
        phase(17, f"(b) {TUNE_SEEDS}-seed sweeps default / auto / "
                  + " / ".join(f"{k} {v}" for k, v in TUNE_FORCED.items())
                  + ": " + " / ".join(f"{w:.2f}" for w in walls.values())
                  + f" s; every seed's rows equal, violations "
                  f"{int(base.violated.sum())}; seeds 0..{SEEDS_SMALL - 1} "
                  "equal a CPU run")

        # -- (c) the Tier-B gate's legs 1-2, card against CPU
        gwl = dataclasses.replace(raft_workload(virtual_secs=0.5),
                                  host_repro=None)
        planted = dataclasses.replace(gwl.config, msg_capacity=8,
                                      msg_depth_msg=None)
        gates = {}
        for what, cfg in (("planted", planted), ("shipped", gwl.config)):
            g = tune.tier_b_gate(gwl, cfg, seeds=GATE_SEEDS, certify=False,
                                 device=cuda)
            c = tune.tier_b_gate(gwl, cfg, seeds=GATE_SEEDS, certify=False,
                                 device="cpu")
            check(g == c, f"Tier-B gate {what}: card {g} != CPU {c}")
            gates[what] = g
        check(not gates["planted"]["ok"] and any(
            "overflow" in r for r in gates["planted"]["reasons"]),
            f"Tier-B gate: the planted config passed: {gates['planted']}")
        check(gates["shipped"]["ok"],
              f"Tier-B gate: the shipped config failed: {gates['shipped']}")
        out["gate"] = gates
        phase(17, f"(c) Tier-B gate legs 1-2 at {GATE_SEEDS} seeds, card = "
                  f"CPU: planted msg_capacity 8 rejected "
                  f"({gates['planted']['reasons'][0][:60]}...), shipped "
                  f"config passes (overflow "
                  f"{gates['shipped']['summary']['total_overflow']})")

        # -- (d) serve on the card, stopped after round 1 and restarted
        pwl = explore_workload()
        tune.TunedEntry(
            device_kind=card_kind(), workload=pwl.spec.name,
            config_hash=tune.config_hash_sans_tier_b(pwl.config),
            lane_bucket=tune.lane_bucket(EXPLORE_RUN["lanes"]),
            dispatch=dict(SERVE_TUNED),
        ).save(cache)
        size = {k: EXPLORE_RUN[k] for k in ("meta_seed", "lanes", "chunk")}
        requests = {
            "planted": dict(size, workload="planted", tuning="auto",
                            generations=SERVE_GENERATIONS, shrink=False),
            "raft": dict(size, workload="raft", virtual_secs=serve_secs,
                         generations=SERVE_GENERATIONS, shrink=False),
        }

        def serve_on(device, d, **kw):
            def factory(request, campaign_dir, regression_dir, log):
                if request["workload"] != "planted":
                    return campaign._default_factory(
                        request, campaign_dir, regression_dir, log,
                        device=device)
                if os.path.exists(os.path.join(campaign_dir,
                                               campaign.MANIFEST)):
                    return campaign.Campaign.resume(
                        campaign_dir, workload=pwl, device=device,
                        regression_dir=regression_dir)
                return campaign.Campaign(
                    pwl, campaign_dir, campaign_id=request["id"],
                    shrink=False, regression_dir=regression_dir,
                    tuning=request["tuning"], device=device, **size)

            lines: list = []
            campaign.serve(d, out=lambda x: lines.append(json.loads(x)),
                           factory=factory, sleep=lambda x: None,
                           oracle=False, device=device, **kw)
            return [x for x in lines if "fingerprint" in x]

        svc = os.path.join(work, "serve")
        for name, req in requests.items():
            os.makedirs(os.path.join(svc, "queue"), exist_ok=True)
            with open(os.path.join(svc, "queue", f"{name}.json"), "w") as f:
                json.dump(req, f)
        t0 = time.perf_counter()
        first = serve_on(cuda, svc, max_rounds=1)
        check(sorted(os.listdir(os.path.join(svc, "active"))) ==
              ["planted.json", "raft.json"] and len(first) == 2,
              "serve: round 1 did not leave both requests in flight")
        second = serve_on(cuda, svc, idle_rounds=1)
        serve_s = time.perf_counter() - t0
        final = {x["campaign"]: x["fingerprint"] for x in first + second
                 if x["generation"] == SERVE_GENERATIONS}
        man = campaign._read_manifest(os.path.join(svc, "campaigns",
                                                   "planted"))
        check(man["tuning"] == SERVE_TUNED,
              f"serve: planted ran under {man['tuning']}, not the card "
              f"entry's {SERVE_TUNED}")
        check(final.get("planted") == PINNED_EXPLORE,
              f"serve: planted ended at {final.get('planted')}, not "
              f"PINNED_EXPLORE {PINNED_EXPLORE}")
        ref = os.path.join(work, "serve-cpu")
        os.makedirs(os.path.join(ref, "queue"))
        with open(os.path.join(ref, "queue", "raft.json"), "w") as f:
            json.dump(requests["raft"], f)
        t0 = time.perf_counter()
        cpu_lines = serve_on("cpu", ref, idle_rounds=1)
        cpu_s = time.perf_counter() - t0
        want = [x["fingerprint"] for x in cpu_lines
                if x["generation"] == SERVE_GENERATIONS]
        check(final.get("raft") is not None and [final["raft"]] == want,
              f"serve: raft ended at {final.get('raft')}, an uninterrupted "
              f"CPU serve at {want}")
        out["serve"] = {"wall_s": serve_s, "cpu_s": cpu_s, "final": final,
                        "slices": len(first) + len(second),
                        "virtual_secs": serve_secs}
        out["phase_s"] = time.perf_counter() - t_phase
        phase(17, f"(d) serve on the card, {len(requests)} requests x "
                  f"{SERVE_GENERATIONS} generations (raft at {serve_secs} "
                  f"virtual s), stopped after round 1 "
                  f"and restarted, {serve_s:.1f} s: planted under "
                  f"{SERVE_TUNED} at PINNED_EXPLORE, raft "
                  f"{final['raft'][:16]} = the uninterrupted CPU serve's "
                  f"({cpu_s:.1f} s) [{out['phase_s']:.0f} s in phase 17]")
    finally:
        if prev_cache is None:
            os.environ.pop("MADSIM_TUNED_DIR", None)
        else:
            os.environ["MADSIM_TUNED_DIR"] = prev_cache
    return out


def multichip_plan():
    """tests/test_multichip.py's plan: Crash, Partition and 5% loss."""
    from madsim_tpu_torch import nemesis as nm

    return nm.FaultPlan(name="multichip-tests", clauses=(
        nm.Crash(interval_lo_us=150_000, interval_hi_us=450_000,
                 down_lo_us=100_000, down_hi_us=300_000),
        nm.Partition(interval_lo_us=200_000, interval_hi_us=600_000,
                     heal_lo_us=150_000, heal_hi_us=450_000),
        nm.MsgLoss(rate=0.05),
    ))


def chaos_free_violation():
    """The planted workload with an invariant that breaks once virtual
    time reaches 600 ms: every seed violates within a few dozen steps
    whatever the chaos, so its shrink drops every atom in two dispatches
    (tests/test_triage.py's chaos-free case)."""
    import dataclasses

    from madsim_tpu_torch.tpu import make_raft_spec
    from madsim_tpu_torch.tpu.spec import replace_handlers

    return dataclasses.replace(triage_workload(), spec=replace_handlers(
        make_raft_spec(5),
        check_invariants=lambda ns, alive, now: now < 600_000))


def phase18_mesh(cuda, card: str, work: str) -> dict:
    """Phase 18, the lane mesh on the card. The host shows one card, so
    every mesh repeats it and its shards run one after another there
    (concurrency across cards is not measured). (a) The sharded refill at
    each of MESH_SHARDS shards: rows equal to the CPU's one-shard refill,
    per-shard occupancy, lane-steps per iteration and ms per iteration
    beside the one-shard run's. (b) `run_batch` on a 4-shard mesh, chunked
    and refill: per-seed rows equal to `mesh=None`'s on the card and on
    the CPU, `n_devices` 4. (c) The chaos-free violation's shrink on a
    2-shard mesh: the CPU's unsharded bundle. (d) The pinned federation on
    a 2-shard "islands" mesh: sharded, at PINNED_FEDERATION. (e) `serve`
    over [card, card] (two slice lanes on two threads) drains three
    requests at the one-device CPU serve's fingerprints, and two threads
    capture and replay their own sims' graphs at once with the CPU's rows.
    (f) At full width: the chunked `run_batch` over STORM_LANES seeds of
    the bench config on a 4-shard mesh against `mesh=None`, rows equal and
    both device-memory peaks printed; phase 11's spread mix as a sharded
    refill of REFILL_WIDE_LANES lanes a shard on MESH_REFILL_SHARDS shards,
    rows equal to the unsharded refill of REFILL_WIDE_LANES lanes. Every
    check is asserted."""
    import threading

    from madsim_tpu_torch import campaign, triage
    from madsim_tpu_torch.explore import Federation
    from madsim_tpu_torch.tpu import (
        BatchedSim, BatchWorkload, SimConfig, TriageCtl, compile_plan,
        make_raft_spec, run_batch,
    )
    from madsim_tpu_torch.tpu.digest import (
        FEDERATION_GENERATIONS, FEDERATION_H_US, FEDERATION_RUN,
        PINNED_FEDERATION, spread_ctl, spread_mix,
    )
    from madsim_tpu_torch.tpu.engine import (
        refill_results, refill_results_sharded,
    )
    from madsim_tpu_torch.tpu.mesh import Mesh, canonical_device
    from madsim_tpu_torch.tpu.raft import raft_bench_config
    from madsim_tpu_torch.tpu.spec import REBASE_US

    t_phase = time.perf_counter()
    dev = canonical_device(cuda)
    out: dict = {"visible_cards": torch.cuda.device_count()}
    phase(18, f"the host shows {out['visible_cards']} card(s): every mesh "
              f"repeats {dev}, so a mesh's shards run one after another on "
              "it (concurrency across cards is not measured)")

    def mesh(n: int, axis: str = "seeds") -> Mesh:
        return Mesh((dev,) * n, axis)

    def same(a, b) -> bool:
        return a is None and b is None or np.array_equal(
            np.asarray(a).astype(np.int64), np.asarray(b).astype(np.int64))

    # -- (a) the sharded refill at 1, 2 and 4 shards against the CPU
    cfg = compile_plan(multichip_plan(), SimConfig(horizon_us=MESH_H_US))
    A = MESH_ADMISSIONS
    h = np.where(np.arange(A) % 4 == 0, MESH_H_US,
                 MESH_H_US // 10).astype(np.int64)
    ctl = TriageCtl(
        off=torch.zeros((A,), dtype=torch.int32),
        occ=torch.zeros((A, 4), dtype=torch.int32),
        rate_scale=torch.ones((A, 3), dtype=torch.float32),
        h_epoch=torch.as_tensor((h // REBASE_US).astype(np.int32)),
        h_off=torch.as_tensor((h % REBASE_US).astype(np.int32)),
    )
    seeds = np.arange(A, dtype=np.uint32)
    fields = ("violated", "deadlocked", "violation_at", "violation_epoch",
              "violation_step", "steps", "events", "overflow", "dead_drops",
              "clock", "epoch", "fires", "occ_fired", "cov_bitmap",
              "cov_hiwater", "cov_transitions")
    cpu_rows = refill_results(BatchedSim(
        make_raft_spec(), cfg, triage=True, coverage=True, device="cpu",
    ).run_refill(seeds, lanes=MESH_LANES, max_steps=30_000, ctl=ctl))
    sim = BatchedSim(make_raft_spec(), cfg, triage=True, coverage=True,
                     device=cuda)
    # warm-up: a one-admission sweep, so the first timed run does not pay
    # the process's first launches of the refill step's kernels
    sim.run_refill(seeds[1:2], lanes=1, max_steps=30_000,
                   ctl=TriageCtl(*(x[1:2] for x in ctl)))
    out["refill"] = {}
    for D in MESH_SHARDS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if D == 1:
            res = refill_results(sim.run_refill(
                seeds, lanes=MESH_LANES, max_steps=30_000, ctl=ctl))
            per = [{k: res[k] for k in ("iters", "busy_lane_steps",
                                        "total_lane_steps", "occupancy")}]
            lspi = res["busy_lane_steps"] / max(res["iters"], 1)
        else:
            res = refill_results_sharded(sim.run_refill_sharded(
                seeds, lanes=MESH_LANES, mesh=mesh(D), max_steps=30_000,
                ctl=ctl), admissions=A)
            per, lspi = res["per_device"], res["lane_steps_per_iter"]
        wall = time.perf_counter() - t0
        bad = [f for f in fields if not same(res[f], cpu_rows[f])]
        check(not bad, f"mesh (a): {D} shards' rows differ from the CPU's "
                       f"one-shard refill in {bad}")
        check(res["truncated"] == 0, f"mesh (a): {D} shards truncated "
                                     f"{res['truncated']} admissions")
        shard_iters = sum(p["iters"] for p in per)
        row = {
            "wall_s": wall, "iters": max(p["iters"] for p in per),
            "shard_iters": shard_iters,
            "ms_per_iter": wall / max(max(p["iters"] for p in per), 1) * 1e3,
            "ms_per_shard_iter": wall / max(shard_iters, 1) * 1e3,
            "occupancy": [p["occupancy"] for p in per],
            "lane_steps_per_iter": lspi,
        }
        out["refill"][D] = row
        phase(18, f"(a) refill over {D} shard(s) x {MESH_LANES} lanes, {A} "
                  f"admissions: rows = the CPU's one-shard refill; occupancy "
                  f"{[round(o, 3) for o in row['occupancy']]}, "
                  f"{lspi:.2f} lane-steps/iteration, {row['iters']} "
                  f"iterations ({shard_iters} shard-iterations) in "
                  f"{wall:.2f} s: {row['ms_per_iter']:.2f} ms/iteration, "
                  f"{row['ms_per_shard_iter']:.2f} ms/shard-iteration")
    one = out["refill"][1]
    for D in MESH_SHARDS[1:]:
        out["refill"][D]["scaling_vs_1"] = (
            out["refill"][D]["lane_steps_per_iter"]
            / max(one["lane_steps_per_iter"], 1e-9))
    phase(18, "(a) lane-steps per iteration over the one-shard run's: "
              + ", ".join(f"{D} shards {out['refill'][D]['scaling_vs_1']:.2f}x"
                          for D in MESH_SHARDS[1:])
              + f"; ms per shard-iteration {one['ms_per_shard_iter']:.2f} "
              "(1 shard) vs " + ", ".join(
                  f"{out['refill'][D]['ms_per_shard_iter']:.2f} ({D})"
                  for D in MESH_SHARDS[1:]))
    del sim

    # -- (b) run_batch on a 4-shard mesh, both paths
    wl = BatchWorkload(spec=make_raft_spec(), config=cfg, max_steps=30_000)
    bseeds = range(MESH_BATCH_SEEDS)
    kw = dict(max_traces=0, repro_on_host=False, coverage=True)
    ref = run_batch(bseeds, wl, mesh=None, device=cuda, **kw)
    cpu_ref = run_batch(bseeds, wl, mesh=None, device="cpu", **kw)
    out["batch"] = {}
    for path, extra in (("chunked", {}),
                        ("refill", {"refill": MESH_BATCH_REFILL})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = run_batch(bseeds, wl, mesh=mesh(MESH_BATCH_SHARDS), device=cuda,
                      **kw, **extra)
        wall = time.perf_counter() - t0
        check(r.summary["n_devices"] == MESH_BATCH_SHARDS,
              f"mesh (b) {path}: n_devices {r.summary['n_devices']}")
        for base, what in ((ref, "mesh=None on the card"),
                           (cpu_ref, "mesh=None on the CPU")):
            for f in ("violated", "deadlocked", "violation_step"):
                check(np.array_equal(getattr(r, f), getattr(base, f)),
                      f"mesh (b) {path}: {f} differs from {what}")
            check(np.array_equal(r.coverage.bitmap, base.coverage.bitmap),
                  f"mesh (b) {path}: coverage differs from {what}")
            if path == "chunked":
                check(np.array_equal(r.retired_step, base.retired_step),
                      f"mesh (b) {path}: steps differ from {what}")
        out["batch"][path] = {
            "wall_s": wall, "per_device_occupancy":
            r.summary.get("per_device_occupancy")}
    phase(18, f"(b) run_batch over {MESH_BATCH_SEEDS} seeds on "
              f"{MESH_BATCH_SHARDS} shards: chunked "
              f"{out['batch']['chunked']['wall_s']:.2f} s, refill "
              f"({MESH_BATCH_REFILL} lanes a shard) "
              f"{out['batch']['refill']['wall_s']:.2f} s, occupancy "
              f"{out['batch']['refill']['per_device_occupancy']}; per-seed "
              "rows = mesh=None's on the card and on the CPU, n_devices "
              f"{MESH_BATCH_SHARDS}")

    # -- (c) the shrink on a 2-shard mesh against the CPU's, unsharded
    # (the planted shrink on a mesh, ~30 s more on the card, is
    # tests/test_torch_multichip.py's)
    swl = chaos_free_violation()
    t0 = time.perf_counter()
    sr = triage.shrink_seed(swl, 3, lane_width=4, device=cuda, mesh=mesh(2),
                            out_dir=os.path.join(work, "mesh-card"))
    shrink_s = time.perf_counter() - t0
    cpu_sr = triage.shrink_seed(swl, 3, lane_width=4, device="cpu",
                                out_dir=os.path.join(work, "mesh-cpu"))
    check(sr.bundle.to_json() == cpu_sr.bundle.to_json()
          and sr.kept_atoms == cpu_sr.kept_atoms == []
          and sr.dispatches == cpu_sr.dispatches,
          "mesh (c): the sharded shrink's bundle differs from the CPU's "
          "unsharded one")
    out["shrink"] = {"wall_s": shrink_s, "dispatches": sr.dispatches,
                     "step": sr.bundle.violation_step}
    phase(18, f"(c) shrink of the chaos-free violation on 2 shards: "
              f"{sr.dispatches} dispatches, {shrink_s:.2f} s, the CPU's "
              f"unsharded bundle (every atom dropped, violation step "
              f"{sr.bundle.violation_step})")

    # -- (d) the pinned federation, one shard per island
    fed = Federation(explore_workload(FEDERATION_H_US), device=cuda,
                     mesh=mesh(FEDERATION_RUN["n_islands"], "islands"),
                     **FEDERATION_RUN)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = fed.run(FEDERATION_GENERATIONS)
    fed_s = time.perf_counter() - t0
    check(rep["sharded"] and rep["fingerprint"] == PINNED_FEDERATION,
          f"mesh (d): sharded {rep['sharded']}, fingerprint "
          f"{rep['fingerprint']} (pinned {PINNED_FEDERATION})")
    out["federation"] = {"wall_s": fed_s}
    phase(18, f"(d) federation {FEDERATION_RUN['n_islands']} islands on "
              f"{FEDERATION_RUN['n_islands']} shards, "
              f"{FEDERATION_GENERATIONS} generations: sharded, at "
              f"PINNED_FEDERATION, {fed_s:.2f} s")

    # -- (e) serve over two slice lanes on the card, and two threads'
    # captures
    def serve_on(device, devices, d):
        for i, cid in enumerate(("a", "b", "c")):
            os.makedirs(os.path.join(d, "queue"), exist_ok=True)
            with open(os.path.join(d, "queue", f"{cid}.json"), "w") as f:
                json.dump(dict(MESH_SERVE_REQUEST, meta_seed=i + 1), f)
        lines: list = []
        res = campaign.serve(d, out=lambda x: lines.append(json.loads(x)),
                             sleep=lambda x: None, oracle=False,
                             idle_rounds=1, devices=devices, device=device)
        check(sorted(res["completed"]) == ["a", "b", "c"],
              f"mesh (e): serve on {device} completed {res['completed']}")
        return sorted((x["campaign"], x["generation"], x["fingerprint"])
                      for x in lines if "fingerprint" in x), lines

    t0 = time.perf_counter()
    two, lines = serve_on(cuda, [dev, dev], os.path.join(work, "mesh-serve"))
    serve_s = time.perf_counter() - t0
    one_cpu, _ = serve_on("cpu", None, os.path.join(work, "mesh-serve-cpu"))
    check(two == one_cpu and len(two) == 6,
          "mesh (e): serve over two lanes on the card streamed other "
          "fingerprints than the one-device CPU serve")
    check({x["device"] for x in lines if "report" in x} == {0, 1},
          "mesh (e): serve did not use both slice lanes")
    tcfg = compile_plan(multichip_plan(), SimConfig(horizon_us=MESH_H_US))
    tseeds = [np.arange(MESH_THREAD_LANES) + i * MESH_THREAD_LANES
              for i in range(2)]
    sims = [BatchedSim(make_raft_spec(), tcfg, device=cuda)
            for _ in range(2)]
    got: dict = {}

    def run(i):
        st = sims[i].run(tseeds[i], 30_000)
        got[i] = (st.violated.cpu().numpy(), st.steps.cpu().numpy(),
                  st.events.cpu().numpy())

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    threads_s = time.perf_counter() - t0
    csim = BatchedSim(make_raft_spec(), tcfg, device="cpu")
    for i in range(2):
        check(i in got and (sims[i]._graph is not None
                            or dev.type != "cuda"),
              f"mesh (e): thread {i} did not run its captured sweep")
        st = csim.run(tseeds[i], 30_000)
        want = (st.violated.numpy(), st.steps.numpy(), st.events.numpy())
        check(all(np.array_equal(a, b) for a, b in zip(got[i], want)),
              f"mesh (e): thread {i}'s captured rows differ from the CPU's")
    out["serve"] = {"wall_s": serve_s, "threads_s": threads_s}
    phase(18, f"(e) serve over [{dev}, {dev}] (two slice lanes), 3 "
              f"requests x {MESH_SERVE_REQUEST['generations']} generations "
              f"in {serve_s:.2f} s: the one-device CPU serve's "
              f"fingerprints; two threads captured and replayed their own "
              f"{MESH_THREAD_LANES}-lane sims at once in {threads_s:.2f} s, "
              f"rows = the CPU's")

    # -- (f) full width: the chunked run_batch over STORM_LANES seeds of
    # the bench config, 4 shards against none, each with its memory peak
    bwl = BatchWorkload(
        spec=make_raft_spec(n_nodes=5, client_rate=0.1, log_capacity=16),
        config=raft_bench_config(MESH_WIDE_SECS), max_steps=MAX_STEPS)
    wide: dict = {}
    for m in (None, mesh(MESH_BATCH_SHARDS)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        r = run_batch(range(STORM_LANES), bwl, mesh=m, device=cuda,
                      chunk=STORM_LANES, **kw)
        torch.cuda.synchronize()
        wide[0 if m is None else m.size] = (
            r, time.perf_counter() - t0,
            (torch.cuda.max_memory_allocated(dev) - base) / 2**30)
    (r0, w0, p0), (r4, w4, p4) = wide[0], wide[MESH_BATCH_SHARDS]
    check(r4.summary["n_devices"] == MESH_BATCH_SHARDS,
          f"mesh (f): n_devices {r4.summary['n_devices']}")
    for f in ("violated", "deadlocked", "violation_step", "retired_step"):
        check(np.array_equal(getattr(r4, f), getattr(r0, f)),
              f"mesh (f): the {STORM_LANES}-seed sweep's {f} differs "
              "between 4 shards and mesh=None")
    check(np.array_equal(r4.coverage.bitmap, r0.coverage.bitmap),
          f"mesh (f): the {STORM_LANES}-seed sweep's coverage differs "
          "between 4 shards and mesh=None")
    steps = int(r0.retired_step.max())
    out["wide_batch"] = {"seeds": STORM_LANES, "steps": steps,
                         "wall_s": w0, "sharded_wall_s": w4,
                         "peak_gib": p0, "sharded_peak_gib": p4}
    phase(18, f"(f) run_batch over {STORM_LANES} seeds of the bench config "
              f"at {MESH_WIDE_SECS} virtual s ({steps} steps), chunked: "
              f"{MESH_BATCH_SHARDS} shards x {STORM_LANES // MESH_BATCH_SHARDS}"
              f" lanes in {w4:.2f} s against mesh=None's {w0:.2f} s, peak "
              f"device memory {p4:.2f} GiB against {p0:.2f} GiB above the "
              f"start; per-seed rows and coverage equal, n_devices "
              f"{MESH_BATCH_SHARDS}")
    del wide, r0, r4

    # -- (f) full width: phase 11's spread mix as a refill of L lanes, then
    # as a sharded refill of L lanes a shard, each with its memory peak
    A, L, D = REFILL_ADMISSIONS, REFILL_WIDE_LANES, MESH_REFILL_SHARDS
    msim = BatchedSim(make_raft_spec(), spread_mix(REFILL_H_US), triage=True,
                      coverage=True, device=cuda)
    mctl = spread_ctl(REFILL_H_US, A)
    legs: dict = {}
    for m in (None, mesh(D)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        if m is None:
            res = refill_results(msim.run_refill(
                np.arange(A, dtype=np.int64), lanes=L,
                max_steps=REFILL_MAX_STEPS, ctl=mctl))
        else:
            res = refill_results_sharded(msim.run_refill_sharded(
                np.arange(A, dtype=np.int64), lanes=L, mesh=m,
                max_steps=REFILL_MAX_STEPS, ctl=mctl), admissions=A)
        wall = time.perf_counter() - t0
        check(res["truncated"] == 0, f"mesh (f): the refill over "
                                     f"{1 if m is None else D} shard(s) "
                                     f"truncated {res['truncated']} admissions")
        legs[m is not None] = (res, wall, (torch.cuda.max_memory_allocated(
            dev) - base) / 2**30)
    (r1, w1, p1), (rd, wd, pd) = legs[False], legs[True]
    bad = [f for f in fields if not same(rd[f], r1[f])]
    check(not bad, f"mesh (f): the sharded refill's rows differ from the "
                   f"unsharded refill's in {bad}")
    per = rd["per_device"]
    shard_iters = sum(p["iters"] for p in per)
    out["wide_refill"] = {
        "admissions": A, "lanes": L, "shards": D, "wall_s": w1,
        "sharded_wall_s": wd, "iters": r1["iters"],
        "shard_iters": shard_iters,
        "ms_per_iter": w1 / max(r1["iters"], 1) * 1e3,
        "ms_per_shard_iter": wd / max(shard_iters, 1) * 1e3,
        "occupancy": r1["occupancy"],
        "shard_occupancy": [p["occupancy"] for p in per],
        "lane_steps_per_iter": rd["lane_steps_per_iter"],
        "peak_gib": p1, "sharded_peak_gib": pd,
    }
    w = out["wide_refill"]
    out["phase_s"] = time.perf_counter() - t_phase
    phase(18, f"(f) phase 11's spread mix, {A} admissions, refill over "
              f"{D} shards x {L} lanes: rows = the unsharded {L}-lane "
              f"refill's; {shard_iters} shard-iterations in {wd:.2f} s "
              f"({w['ms_per_shard_iter']:.2f} ms/shard-iteration) against "
              f"{r1['iters']} iterations in {w1:.2f} s "
              f"({w['ms_per_iter']:.2f} ms/iteration), occupancy "
              f"{[round(o, 4) for o in w['shard_occupancy']]} against "
              f"{r1['occupancy']:.4f}, {rd['lane_steps_per_iter']:.1f} "
              f"lane-steps/iteration, peak device memory {pd:.2f} GiB "
              f"against {p1:.2f} GiB above the start "
              f"[{out['phase_s']:.0f} s in phase 18 on {card}]")
    return out


def chain_tail_workloads():
    """(buggy, correct) chain workloads of 19(a): chain's bench config at
    CHAIN_TAIL_SECS under a 5% heavy tail of depth 8
    (tests/test_tpu_chain.py:40-63), the buggy one on the blind-apply
    spec; each ships the chain twin as its host_repro."""
    import dataclasses

    from madsim_tpu_torch.tpu import chain_workload, make_chain_spec

    base = chain_workload(virtual_secs=CHAIN_TAIL_SECS)
    tails = dataclasses.replace(base.config, buggify_delay_rate=0.05,
                                buggify_depth=8)
    buggy = dataclasses.replace(
        base, spec=make_chain_spec(5, buggy_blind_apply=True), config=tails,
        max_steps=40_000)
    return buggy, dataclasses.replace(base, config=tails, max_steps=40_000)


def oracle_workload():
    """19(d)'s "plan8" request's workload: the registry's raft at
    SERVE_SECS with ORACLE_PLAN (all eight clauses, the message clauses
    whose coins the tenant compares among them) compiled onto it."""
    import dataclasses

    from madsim_tpu_torch.tpu import compile_plan, raft_workload
    from madsim_tpu_torch.tpu.digest import ORACLE_PLAN

    wl = raft_workload(virtual_secs=SERVE_SECS)
    return dataclasses.replace(wl, host_repro=None,
                               config=compile_plan(ORACLE_PLAN, wl.config))


def oracle_serve(device, d, **kw):
    """`campaign.serve` with its oracle tenant over 19(d)'s two raft
    requests at phase 17(d)'s size (queued unless their campaigns exist):
    the registry's raft at SERVE_SECS, and "plan8", raft under
    oracle_workload's eight clauses: (slice lines, status.json's oracle
    block, oracle.json's text)."""
    from madsim_tpu_torch import campaign
    from madsim_tpu_torch.tpu.digest import EXPLORE_RUN

    size = {k: EXPLORE_RUN[k] for k in ("meta_seed", "lanes", "chunk")}
    requests = {
        "raft": dict(size, workload="raft", virtual_secs=SERVE_SECS,
                     generations=SERVE_GENERATIONS, shrink=False),
        "plan8": dict(size, workload="plan8", meta_seed=3,
                      generations=SERVE_GENERATIONS, shrink=False),
    }
    pwl = oracle_workload()

    def factory(request, campaign_dir, regression_dir, log):
        if request["workload"] != "plan8":
            return campaign._default_factory(
                request, campaign_dir, regression_dir, log, device=device)
        if os.path.exists(os.path.join(campaign_dir, campaign.MANIFEST)):
            return campaign.Campaign.resume(
                campaign_dir, workload=pwl, device=device,
                regression_dir=regression_dir, log=log)
        return campaign.Campaign(
            pwl, campaign_dir, campaign_id=request["id"], shrink=False,
            regression_dir=regression_dir, log=log, device=device,
            **dict(size, meta_seed=request["meta_seed"]))

    for name, req in requests.items():
        os.makedirs(os.path.join(d, "queue"), exist_ok=True)
        if not os.path.exists(os.path.join(d, "campaigns", name)):
            with open(os.path.join(d, "queue", f"{name}.json"), "w") as f:
                json.dump(req, f)
    lines: list = []
    campaign.serve(d, out=lambda x: lines.append(json.loads(x)),
                   factory=factory, sleep=lambda x: None, device=device,
                   oracle_sample_rate=0.5, **kw)
    with open(os.path.join(d, "status.json")) as f:
        status = json.load(f)
    with open(os.path.join(d, "oracle.json")) as f:
        doc = f.read()
    return [x for x in lines if "fingerprint" in x], status["oracle"], doc


def phase19_cpu_references() -> dict:
    """Phase 19's CPU references, in a process of their own: the first 16
    lanes of 19(a)'s buggy sweep (rows) with the chain twin's dict for
    its first CHAIN_HOST_REPROS violating seeds, and 19(d)'s
    uninterrupted serve (oracle.json's text and the status block)."""
    from madsim_tpu_torch.tpu import run_batch

    buggy, _ = chain_tail_workloads()
    t0 = time.perf_counter()
    cpu = run_batch(range(16), buggy, device="cpu", max_traces=0,
                    max_host_repros=CHAIN_HOST_REPROS)
    rows_s = time.perf_counter() - t0
    out = {"rows": {k: np.asarray(getattr(cpu, k)).astype(np.int64).tolist()
                    for k in ("violated", "deadlocked", "violation_step",
                              "retired_step")},
           "host_repros": {str(k): v for k, v in cpu.host_repros.items()},
           "rows_s": rows_s}
    work = tempfile.mkdtemp(prefix="chip_smoke_oracle_cpu-")
    try:
        t0 = time.perf_counter()
        _, status, doc = oracle_serve("cpu", work, idle_rounds=1)
        out["serve"] = {"doc": doc, "oracle": status,
                        "wall_s": time.perf_counter() - t0}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def phase19_host_oracle(cuda, card: str, work: str) -> dict:
    """Phase 19, the host runtime under the differential oracle, in phase
    18's child after phase 18 (the child runs under PYTHONHASHSEED=0); its
    CPU references run meanwhile in a process of their own
    (`phase19_cpu_references`). (a) `madsim_tpu_torch.Runtime.run_batch`
    over CHAIN_TAIL_SEEDS seeds of chain's blind-apply spec under
    heavy-tail stragglers (tests/test_tpu_chain.py:40-63) on the card:
    violations on more than half the lanes, the correct spec clean under
    the same tails, the first 16 lanes' rows equal to a CPU run, and
    `host_repros` holding `max_host_repros` seeds, each the dict a CPU call
    of the port's chain twin returns. (b) A raft5 lane traced on the card
    under ORACLE_PLAN at PLAN8_H_US: its chaos events = the pure schedule
    = the port's NemesisDriver's applied stream, and the per-node skew
    equal. (c) The oracle at the bench horizon: `check_seed` on
    ORACLE_SEEDS lanes of a card sweep of `digest.oracle_config()` (the
    raft bench config with ORACLE_PLAN on it), each MATCH, the pinned lane
    at PINNED_ORACLE; under the plant the pinned lane diverges at a
    reorder_extra draw, the plant lane shrinks to [("reorder", None)], and
    `python -m madsim_tpu_torch.repro <bundle> --backend both` exits 1
    naming the same first divergent event. (d) `serve` with its oracle
    tenant on the card: two raft requests at phase 17(d)'s size, stopped
    after round 1 and restarted; the tenant checked lanes with no error
    and no divergence, its cursor resumed, and oracle.json and the status
    block equal an uninterrupted CPU serve's. Every check is asserted."""
    import madsim_tpu_torch as ms
    from madsim_tpu_torch import oracle, triage
    from madsim_tpu_torch import nemesis as nm
    from madsim_tpu_torch.tpu import (
        BatchedSim, SimConfig, compile_plan, make_raft_spec,
    )
    from madsim_tpu_torch.tpu import nemesis as ttn
    from madsim_tpu_torch.tpu.digest import (
        ORACLE_PLAN, ORACLE_SEED, PINNED_ORACLE, oracle_config,
    )
    from madsim_tpu_torch.workloads import raft_host

    t_phase = time.perf_counter()
    out: dict = {}
    rows = ("violated", "deadlocked", "violation_step", "retired_step")
    cpu_child = spawn_child(ORACLE_CPU_FLAG)

    # -- (a) Runtime.run_batch at full width, host repros on the CPU
    t0 = time.perf_counter()
    buggy, correct = chain_tail_workloads()
    seeds = range(CHAIN_TAIL_SEEDS)
    # (no traced seeds: the traced step is phase 10's leg, and two traced
    # chain lanes would add ~50 s of eager card work beside the parent's)
    r = ms.Runtime.run_batch(seeds, buggy, device=cuda, max_traces=0,
                             max_host_repros=CHAIN_HOST_REPROS)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    check(r.violations > CHAIN_TAIL_SEEDS // 2,
          f"run_batch: blind apply under tails violated on {r.violations} "
          f"of {CHAIN_TAIL_SEEDS} lanes, not more than half")
    rc = ms.Runtime.run_batch(seeds, correct, device=cuda, max_traces=0,
                              repro_on_host=False)
    check(rc.violations == 0,
          f"run_batch: the correct chain violated on {rc.violations} lanes "
          "under the same tails")
    check(sorted(r.host_repros) == r.violating_seeds[:CHAIN_HOST_REPROS]
          and len(r.host_repros) == CHAIN_HOST_REPROS,
          f"run_batch: host repros for {sorted(r.host_repros)}, not the "
          f"first {CHAIN_HOST_REPROS} violating seeds")
    out["run_batch"] = {
        "seeds": CHAIN_TAIL_SEEDS, "violations": int(r.violations),
        "correct_violations": int(rc.violations),
        "host_repros": sorted(r.host_repros), "wall_s": card_s,
        "sweep_s": r.device_ms / 1e3, "correct_sweep_s": rc.device_ms / 1e3,
    }
    phase(19, f"(a) Runtime.run_batch, chain blind apply under tails, "
              f"{CHAIN_TAIL_SEEDS} seeds x {CHAIN_TAIL_SECS} virtual s: "
              f"{r.violations} violating (> half), the correct spec 0; "
              f"sweeps {r.device_ms / 1e3:.2f} / {rc.device_ms / 1e3:.2f} s, "
              f"{card_s:.1f} s with {CHAIN_HOST_REPROS} host repros "
              f"[{time.perf_counter() - t_phase:.0f} s in phase 19]")

    # -- (b) three faces: the traced card lane, the schedule, the driver
    t0 = time.perf_counter()
    n = 5
    sim = BatchedSim(make_raft_spec(n),
                     compile_plan(ORACLE_PLAN,
                                  SimConfig(horizon_us=PLAN8_H_US)),
                     device=cuda)
    n_dev = ttn.assert_device_matches_schedule(sim, ORACLE_PLAN, PLAN8_SEED,
                                               PLAN8_H_US)
    art = raft_host.fuzz_one_seed(
        PLAN8_SEED, n_nodes=n, virtual_secs=PLAN8_H_US / 1e6, chaos=False,
        plan=ORACLE_PLAN, lineage=True)["nemesis"]
    sched = [e for e in ORACLE_PLAN.schedule(PLAN8_SEED, PLAN8_H_US, n)
             if e.kind != "skew"]
    check(list(art["applied"]) == sched,
          "three faces: the host driver's applied stream differs from the "
          "schedule")
    check(ttn.schedule_tuples(art["applied"], PLAN8_H_US)
          == ttn.schedule_tuples(sched, PLAN8_H_US),
          "three faces: the driver's stream differs from the schedule's "
          "tuples")
    dev_ppm = sim.init([PLAN8_SEED]).nem.skew_ppm[0].tolist()
    want_ppm = ORACLE_PLAN.skew_ppm(PLAN8_SEED, n)
    check(dev_ppm == want_ppm and art["node_skew"] == {
        art["node_ids"][i]: p for i, p in enumerate(want_ppm) if p},
        f"three faces: skew card {dev_ppm}, host {art['node_skew']}, "
        f"schedule {want_ppm}")
    out["three_faces"] = {"events": n_dev, "wall_s":
                          time.perf_counter() - t0}
    phase(19, f"(b) raft5 seed {PLAN8_SEED} under all eight clauses, "
              f"{PLAN8_H_US / 1e6} virtual s: the card's traced chaos "
              f"stream ({n_dev} events) = the schedule = the host driver's "
              f"applied stream; skew {want_ppm} ppm on all three; "
              f"{out['three_faces']['wall_s']:.1f} s")

    # -- (c) the oracle at the bench horizon, then the plant
    t0 = time.perf_counter()
    cfg = oracle_config()
    st = BatchedSim(make_raft_spec(n), cfg, device=cuda).run(
        range(ORACLE_SEEDS))
    torch.cuda.synchronize()
    check(bool(st.done.all()), "oracle: the card sweep did not reach its "
                               "horizon")
    sweep_s = time.perf_counter() - t0
    plan = triage.plan_from_config(cfg)
    t1 = time.perf_counter()
    reps = [oracle.check_seed("raft5", plan, s, int(cfg.horizon_us),
                              n_nodes=n, loss_rate=float(cfg.loss_rate),
                              repeats=2)
            for s in range(ORACLE_SEEDS)]
    check_s = time.perf_counter() - t1
    bad = [r.render() for r in reps if r.diverged]
    check(not bad, f"oracle: divergences on a clean tree: {bad[:2]}")
    check(reps[ORACLE_SEED].digest == PINNED_ORACLE,
          f"oracle: seed {ORACLE_SEED}'s digest {reps[ORACLE_SEED].digest} "
          f"!= PINNED_ORACLE {PINNED_ORACLE}")
    draws = sum(r.draws for r in reps)
    prev = os.environ.get(nm.PLANT_ENV)
    os.environ[nm.PLANT_ENV] = nm.PLANT_REORDER_OFF_BY_ONE
    try:
        planted = oracle.check_seed("raft5", plan, ORACLE_SEED,
                                    int(cfg.horizon_us), n_nodes=n,
                                    loss_rate=float(cfg.loss_rate),
                                    repeats=1)
        check(planted.diverged and planted.first.site == "reorder_extra",
              f"oracle: the plant did not diverge at a reorder_extra draw: "
              f"{planted.render()[:300]}")
        plant_plan = nm.FaultPlan(name="oracle-plant", clauses=(
            nm.Crash(interval_lo_us=400_000, interval_hi_us=1_500_000,
                     down_lo_us=200_000, down_hi_us=800_000),
            nm.MsgLoss(rate=0.05),
            nm.Reorder(rate=0.2, window_us=40_000),
        ))
        t2 = time.perf_counter()
        sr = oracle.shrink_divergence("raft5", plant_plan, 3, 2_000_000,
                                      n_nodes=n,
                                      out_dir=os.path.join(work, "oracle"))
        shrink_s = time.perf_counter() - t2
        check(sr.kept_atoms == [("reorder", None)],
              f"oracle: the planted divergence shrank to {sr.kept_atoms}")
        head = next(ln for ln in sr.bundle.trace_tail
                    if ln.startswith("first divergent event"))
        t2 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "madsim_tpu_torch.repro", sr.bundle_path,
             "--backend", "both"], cwd=ROOT, capture_output=True, text=True,
            timeout=300)
        cli_s = time.perf_counter() - t2
        check(cli.returncode == 1 and head in cli.stdout.splitlines(),
              f"oracle: repro --backend both exited {cli.returncode}, "
              f"without {head!r}: {cli.stdout[-500:]} {cli.stderr[-500:]}")
    finally:
        if prev is None:
            os.environ.pop(nm.PLANT_ENV, None)
        else:
            os.environ[nm.PLANT_ENV] = prev
    out["oracle"] = {"seeds": ORACLE_SEEDS, "horizon_us": int(cfg.horizon_us),
                     "sweep_s": sweep_s, "check_s": check_s, "draws": draws,
                     "shrink_s": shrink_s, "shrink_replays": sr.dispatches,
                     "repro_cli_s": cli_s}
    phase(19, f"(c) card sweep of {ORACLE_SEEDS} lanes of the raft bench "
              f"config under all eight clauses ({sweep_s:.1f} s), "
              f"check_seed x2 on each: MATCH ({draws} coin draws, "
              f"{check_s:.1f} s), seed {ORACLE_SEED} at PINNED_ORACLE; "
              f"planted: diverges at reorder_extra, shrinks to "
              f"[('reorder', None)] in {sr.dispatches} replays "
              f"({shrink_s:.1f} s), repro --backend both exits 1 naming "
              f"it ({cli_s:.1f} s) [{time.perf_counter() - t_phase:.0f} s "
              "in phase 19]")

    # -- (d) serve with its oracle tenant, stopped and restarted
    tenant_calls: list = []
    observe = oracle.OracleTenant.observe
    timed_calls_of(oracle.OracleTenant, "observe", tenant_calls,
                   keep=lambda o: o["checked"])
    try:
        svc = os.path.join(work, "serve-oracle")
        t0 = time.perf_counter()
        first, _, doc1 = oracle_serve(cuda, svc, max_rounds=1)
        round1 = json.loads(doc1)
        check(round1["cursor"] == {"raft": 1, "plan8": 1},
              f"serve: round 1's cursor {round1['cursor']}")
        second, block, doc = oracle_serve(cuda, svc, idle_rounds=1)
        serve_s = time.perf_counter() - t0
    finally:
        oracle.OracleTenant.observe = observe
    check(block["seeds_checked"] > 0 and block["draws_checked"] > 0
          and block["errors"] == 0 and block["divergences"] == 0,
          f"serve: the tenant's status block {block}")
    final = json.loads(doc)
    check(final["cursor"] == {"raft": 2, "plan8": 2},
          f"serve: the cursor did not resume ({round1} -> {final})")

    # the CPU references, joined: 19(a)'s rows and host repros, 19(d)'s
    # uninterrupted serve
    t0 = time.perf_counter()
    ref = join_child(cpu_child, "phase 19's CPU references", 600)
    wait_s = time.perf_counter() - t0
    for k in rows:
        check(np.array_equal(np.asarray(getattr(r, k))[:16],
                             np.asarray(ref["rows"][k])),
              f"run_batch: the card's first 16 lanes' {k} differ from the "
              "CPU's")
    got = json.loads(json.dumps({str(k): v for k, v in
                                 r.host_repros.items()}))
    check(got == ref["host_repros"],
          f"run_batch: the card run's host repros {sorted(got)} differ from "
          f"a CPU call of the chain twin for {sorted(ref['host_repros'])}")
    cpu = ref["serve"]
    check(doc == cpu["doc"] and block == cpu["oracle"],
          f"serve: oracle.json {final} != the CPU serve's "
          f"{json.loads(cpu['doc'])}")
    tenant_s = [s for _, s in tenant_calls]
    slice_s = [x["report"]["wall_s"] for x in first + second]
    out["serve"] = {"wall_s": serve_s, "cpu_s": cpu["wall_s"],
                    "tenant_s": tenant_s, "slice_s": slice_s,
                    "oracle": block, "slices": len(first + second)}
    out["cpu_child"] = {"wall_s": ref["wall_s"], "rows_s": ref["rows_s"],
                        "wait_s": wait_s}
    out["phase_s"] = time.perf_counter() - t_phase
    phase(19, f"(d) serve with its oracle tenant on the card, 2 raft "
              f"requests (one under all eight clauses) x "
              f"{SERVE_GENERATIONS} generations at {SERVE_SECS} "
              f"virtual s, stopped after round 1 and restarted, "
              f"{serve_s:.1f} s: tenant host s per slice "
              f"{[round(s, 3) for s in tenant_s]} beside slice walls "
              f"{[round(s, 3) for s in slice_s]}; {block['seeds_checked']} "
              f"lanes checked ({block['draws_checked']} draws), 0 errors, "
              f"0 divergences; the cursor resumed")
    phase(19, f"(a, d) the CPU references' process ({ref['wall_s']:.1f} s, "
              f"joined after a {wait_s:.1f} s wait): 19(a)'s first 16 lanes "
              f"= the card's ({ref['rows_s']:.1f} s) and its "
              f"{CHAIN_HOST_REPROS} host repros = the card run's; 19(d)'s "
              f"uninterrupted serve ({cpu['wall_s']:.1f} s) wrote the card "
              f"serve's oracle.json and status block "
              f"[{out['phase_s']:.0f} s in phase 19]")
    phase(19, f"on {card}: phase 19 took {out['phase_s']:.1f} s")
    return out


def phase19_replay_both(cuda, bundle) -> dict:
    """Phase 19(e), in the parent right after phase 10: phase 10's card
    bundle replayed with `backend="both"`: the device half reproduces the
    violation on the card at the bundle's step and time, and the host
    schedule twin applies the shrunk plan's events exactly."""
    from madsim_tpu_torch import repro

    t0 = time.perf_counter()
    lines: list = []
    rep = repro.replay(bundle, backend="both", repeats=1, device=cuda,
                       out=lines.append)
    wall = time.perf_counter() - t0
    check(rep["violated"] and (rep["step"], rep["t_us"]) ==
          (bundle.violation_step, bundle.violation_t_us),
          f"replay both: the device half gave {rep}")
    check(any(ln.startswith("host schedule twin OK") for ln in lines)
          and rep["events"] >= 0,
          f"replay both: no host schedule twin line in {lines}")
    phase(19, f"(e) phase 10's card bundle, repro backend both: the card "
              f"replays the violation at step {rep['step']}, t="
              f"{rep['t_us']} us, and the host schedule twin applies the "
              f"shrunk plan's {rep['events']} events exactly; {wall:.2f} s")
    return {"wall_s": wall, "events": rep["events"], "step": rep["step"]}


def jsonable(x):
    """A host repro's result as JSON values (an exception as its repr), so
    a card process's and the CPU process's compare."""
    return json.loads(json.dumps(x, default=repr))


def twin_runs(device) -> dict:
    """Phase 20(d)'s generated-twin runs on `device`: the HOSTRT_RUNS
    dicts (JSON part), their digest, the buggy backup's message under
    HOSTRT_PLAN, the handler calls and the wall of the four runs."""
    from madsim_tpu_torch.speclang import hostrt
    from madsim_tpu_torch.speclang.generated import backup_host
    from madsim_tpu_torch.speclang.specs import PROTOCOLS
    from madsim_tpu_torch.tpu import digest

    # build (and warm) the runs' kits first, so the wall counts handler
    # calls only
    kits = [hostrt.kit_for(p, device=device) for p in PROTOCOLS.values()]
    calls0 = sum(k.calls for k in kits)
    t0 = time.perf_counter()
    res = digest.hostrt_runs(device)
    wall = time.perf_counter() - t0
    calls = sum(k.calls for k in kits) - calls0
    t0 = time.perf_counter()
    try:
        backup_host.fuzz_one_seed(0, virtual_secs=8.0, chaos=False,
                                  buggy=True, plan=digest.HOSTRT_PLAN,
                                  device=device)
        buggy = None
    except backup_host.InvariantViolation as e:
        buggy = str(e)
    return {"results": [digest.hostrt_result(r) for r in res],
            "digest": digest.hostrt_digest(res), "buggy": buggy,
            "calls": calls, "wall_s": wall,
            "ms_per_call": wall / max(calls, 1) * 1e3,
            "buggy_s": time.perf_counter() - t0}


def kv_repros(device, virtual_secs: float) -> dict:
    """Phase 20(c): kv_workload's two-part host_repro (one engine lane on
    `device` under the exact checker, then the host twin) on
    KV_REPRO_SEEDS: {seed: JSON result}, and the wall."""
    from madsim_tpu_torch.tpu import kv_workload

    wl = kv_workload(virtual_secs=virtual_secs, device=device)
    t0 = time.perf_counter()
    out = {str(s): jsonable(wl.host_repro(s)) for s in KV_REPRO_SEEDS}
    return {"repros": out, "wall_s": time.perf_counter() - t0}


def phase20_cpu_references() -> dict:
    """Phase 20's CPU references, in a process of their own: 20(c)'s kv
    host repros and 20(d)'s generated-twin runs with the handlers on the
    CPU."""
    return {"kv": kv_repros("cpu", KV_REPRO_SECS),
            "twins": twin_runs("cpu")}


def host_face_sweep(cuda, wl, tag: str, repro_violations: int) -> dict:
    """Phase 20(a)/(b): `Runtime.run_batch` of `wl` over HOST_FACE_LANES
    seeds on the card with HOST_FACE_REPROS host repros; the planted bug
    violates, and each repro is a dict (no exception) that reports
    `repro_violations` violations and that a second call returns again."""
    import madsim_tpu_torch as ms

    t0 = time.perf_counter()
    r = ms.Runtime.run_batch(range(HOST_FACE_LANES), wl, device=cuda,
                             max_traces=0, max_host_repros=HOST_FACE_REPROS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(r.violations > 0, f"{tag}: the planted bug never violated in "
                            f"{HOST_FACE_LANES} lanes")
    want = r.violating_seeds[:HOST_FACE_REPROS]
    check(sorted(r.host_repros) == sorted(want)
          and len(want) == HOST_FACE_REPROS,
          f"{tag}: host repros for {sorted(r.host_repros)}, not the first "
          f"{HOST_FACE_REPROS} violating seeds")
    bad = {s: repr(v) for s, v in r.host_repros.items()
           if not isinstance(v, dict)}
    check(not bad, f"{tag}: host repros raised: {bad}")
    got = {s: v["violations"] for s, v in r.host_repros.items()}
    check(all(v == repro_violations for v in got.values()),
          f"{tag}: host repros report {got} violations, not "
          f"{repro_violations} each")
    t1 = time.perf_counter()
    again = {s: wl.host_repro(s) for s in want}
    repro_s = time.perf_counter() - t1
    check(jsonable(again) == jsonable(r.host_repros),
          f"{tag}: a second host repro differs: {jsonable(again)} != "
          f"{jsonable(r.host_repros)}")
    return {"lanes": HOST_FACE_LANES, "violations": int(r.violations),
            "sweep_s": r.device_ms / 1e3, "wall_s": wall,
            "repro_twice_s": repro_s,
            "repros": {str(s): {k: v for k, v in jsonable(x).items()
                                if k in ("violations", "violation",
                                         "events", "checks")}
                       for s, x in r.host_repros.items()}}


def phase20_host_faces(cuda, card: str) -> dict:
    """Phase 20, the rest of item 16's host faces, in phase 18's child
    after 16(e); its CPU references run meanwhile in a process of their
    own (`phase20_cpu_references`). (a) `Runtime.run_batch` on the card
    over buggy paxos (`buggy_ignore_discovered`) at paxos's bench width,
    HOST_FACE_REPROS host repros through the paxos twin, which runs the
    correct protocol (the factory's twin, as on the JAX face: the spec is
    swapped, the twin is not), so each repro reports 0 violations; (b)
    the same for the generated buggy backup, whose host_repro runs the
    generic twin's handlers on the card with the planted bug, so each
    repro reports the violation; (c) kv_workload's two-part host_repro with its
    engine lane on the card: the device verdict and the twin's dict equal
    the CPU process's; (d) the generated twins' HOSTRT_RUNS with the
    handlers on the card: equal to the CPU process's and at
    PINNED_HOSTRT, the buggy backup raises the CPU's message, the wall
    per handler call (the invariant checks and the runtime included)
    printed beside the CPU's. Every check is asserted."""
    import dataclasses

    from madsim_tpu_torch.speclang.generated import backup_device
    from madsim_tpu_torch.tpu import make_paxos_spec, paxos_workload
    from madsim_tpu_torch.tpu.digest import PINNED_HOSTRT

    t_phase = time.perf_counter()
    out: dict = {}
    cpu_child = spawn_child(HOSTFACE_CPU_FLAG)

    # -- (a) buggy paxos, the (correct) paxos twin as host_repro
    wl = paxos_workload(virtual_secs=PAXOS_REPRO_SECS)
    wl = dataclasses.replace(
        wl, spec=make_paxos_spec(5, buggy_ignore_discovered=True))
    out["paxos"] = row = host_face_sweep(cuda, wl, "paxos", 0)
    phase(20, f"(a) Runtime.run_batch, buggy paxos, {HOST_FACE_LANES} "
              f"lanes x {PAXOS_REPRO_SECS} virtual s: {row['violations']} "
              f"violating (sweep {row['sweep_s']:.2f} s, "
              f"{row['wall_s']:.1f} s with {HOST_FACE_REPROS} host "
              f"repros); the factory's twin runs the correct protocol, so "
              f"its repros {row['repros']} report 0 violations, equal when "
              f"run again ({row['repro_twice_s']:.2f} s)")

    # -- (b) the generated buggy backup, the generic twin on the card
    wl = backup_device.make_workload(
        buggy=True, virtual_secs=BACKUP_REPRO_SECS, device=cuda)
    out["backup"] = row = host_face_sweep(cuda, wl, "backup", 1)
    phase(20, f"(b) Runtime.run_batch, generated buggy backup, "
              f"{HOST_FACE_LANES} lanes x {BACKUP_REPRO_SECS} virtual s: "
              f"{row['violations']} violating (sweep {row['sweep_s']:.2f} "
              f"s, {row['wall_s']:.1f} s with {HOST_FACE_REPROS} host "
              f"repros on the card); the buggy twin reproduces: repros "
              f"{row['repros']} report 1 violation each, equal when run "
              f"again ({row['repro_twice_s']:.2f} s)")

    # -- (c) kv's two-part host_repro, its engine lane on the card
    out["kv"] = kv = kv_repros(cuda, KV_REPRO_SECS)
    # -- (d) the generated twins, the handlers on the card
    out["twins"] = tw = twin_runs(cuda)
    check(tw["digest"] == PINNED_HOSTRT,
          f"generated twins: digest {tw['digest']} != PINNED_HOSTRT "
          f"{PINNED_HOSTRT}")
    check(tw["buggy"] is not None,
          "generated twins: the buggy backup survived the plan on the card")

    # the CPU references, joined
    t0 = time.perf_counter()
    ref = join_child(cpu_child, "phase 20's CPU references", 600)
    wait_s = time.perf_counter() - t0
    check(kv["repros"] == ref["kv"]["repros"],
          f"kv host_repro: the card's {kv['repros']} != the CPU's "
          f"{ref['kv']['repros']}")
    for s, x in kv["repros"].items():
        check(x["device"]["ops_checked"] > 0
              and isinstance(x["host_twin"], dict),
              f"kv host_repro seed {s}: {x}")
    cpu_tw = ref["twins"]
    check(tw["results"] == cpu_tw["results"]
          and cpu_tw["digest"] == PINNED_HOSTRT,
          "generated twins: the card's dicts differ from the CPU's")
    check(tw["buggy"] == cpu_tw["buggy"],
          f"generated twins: buggy backup {tw['buggy']!r} on the card, "
          f"{cpu_tw['buggy']!r} on the CPU")
    verdicts = {s: (x["device"]["violations"], x["host_twin"]["acked_ops"])
                for s, x in kv["repros"].items()}
    phase(20, f"(c) kv_workload({KV_REPRO_SECS} virtual s).host_repro on "
              f"seeds {list(KV_REPRO_SEEDS)}, the engine lane on the card: "
              f"(device violations, twin acked ops) {verdicts}, equal to "
              f"the CPU process's; {kv['wall_s']:.1f} s (CPU "
              f"{ref['kv']['wall_s']:.1f} s)")
    phase(20, f"(d) the generated twins' {len(tw['results'])} runs with "
              f"the handlers on the card: = the CPU process's, at "
              f"PINNED_HOSTRT; {tw['calls']} handler calls in "
              f"{tw['wall_s']:.2f} s, {tw['ms_per_call']:.3f} ms of wall "
              f"per handler call, the invariant checks and the runtime "
              f"included (CPU {cpu_tw['ms_per_call']:.3f} ms, "
              f"{cpu_tw['calls']} calls in {cpu_tw['wall_s']:.2f} s); the "
              f"buggy backup "
              f"raises the CPU's message ({tw['buggy_s']:.2f} s)")
    out["cpu_child"] = {"wall_s": ref["wall_s"], "wait_s": wait_s,
                        "kv_s": ref["kv"]["wall_s"],
                        "twins_s": cpu_tw["wall_s"],
                        "ms_per_call": cpu_tw["ms_per_call"]}
    out["phase_s"] = time.perf_counter() - t_phase
    phase(20, f"on {card}: phase 20 took {out['phase_s']:.1f} s (budget "
              f"{PHASE20_BUDGET_S:.0f} s); its CPU process "
              f"{ref['wall_s']:.1f} s, joined after a {wait_s:.1f} s wait")
    return out


def phase9_host_repros(name: str, virtual_secs: float, violated) -> dict:
    """Phase 20(e), in the parent inside phase 9: the first
    HOST_FACE_REPROS violating seeds of a buggy isr, lease or wal sweep
    through its factory's host_repro (the host twin, host time only).
    Returns {seed: verdict}; a repro that raises fails the run."""
    from madsim_tpu_torch.tpu import isr_workload, lease_workload, wal_workload

    factory = {"isr": isr_workload, "lease": lease_workload,
               "wal": wal_workload}[name]
    wl = factory(virtual_secs=virtual_secs, buggy=True)
    seeds = [int(s) for s in np.nonzero(violated)[0][:HOST_FACE_REPROS]]
    out = {}
    for s in seeds:
        t0 = time.perf_counter()
        r = wl.host_repro(s)
        check(isinstance(r, dict) and "violations" in r,
              f"{name} host_repro seed {s}: {r!r}")
        out[s] = {"violations": r["violations"],
                  "violation": r.get("violation"),
                  "events": r.get("events"),
                  "wall_s": time.perf_counter() - t0}
    return out


def valve_probe(cuda):
    """The host valve's probe: a function that times eager refill
    iterations at one shard (phase 18(a)'s config, 4 admissions on
    MESH_LANES lanes, after a one-lane warm-up here) and returns (ms per
    iteration, iterations)."""
    from madsim_tpu_torch.tpu import (
        BatchedSim, SimConfig, TriageCtl, compile_plan, make_raft_spec,
    )
    from madsim_tpu_torch.tpu.spec import REBASE_US

    cfg = compile_plan(multichip_plan(), SimConfig(horizon_us=MESH_H_US))
    A = 4
    h = np.full((A,), MESH_H_US, dtype=np.int64)
    ctl = TriageCtl(
        off=torch.zeros((A,), dtype=torch.int32),
        occ=torch.zeros((A, 4), dtype=torch.int32),
        rate_scale=torch.ones((A, 3), dtype=torch.float32),
        h_epoch=torch.as_tensor((h // REBASE_US).astype(np.int32)),
        h_off=torch.as_tensor((h % REBASE_US).astype(np.int32)),
    )
    sim = BatchedSim(make_raft_spec(), cfg, triage=True, coverage=True,
                     device=cuda)
    seeds = np.arange(A, dtype=np.uint32)
    sim.run_refill(seeds[:1], lanes=1, max_steps=30_000,
                   ctl=TriageCtl(*(x[:1] for x in ctl)))  # warm-up

    def run() -> tuple:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = sim.run_refill(seeds, lanes=MESH_LANES, max_steps=30_000,
                            ctl=ctl)
        iters = int(st.refill.iters)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / max(iters, 1) * 1e3, iters

    return run


def host_valve(cuda) -> dict:
    """The depth valve for a slow host, before phase 10 and the child
    start: when valve_probe's iteration is slower than VALVE_REF_MS, the
    depths of 16(e) (the buggy backup's horizon, BACKUP_EXPLORE_SECS; its
    64 lanes x 1 generation are the JAX deep test's), 17(d) (the raft
    request's horizon, SERVE_SECS) are scaled down in proportion, never
    below VALVE_FLOORS. 13(b) keeps its width (EXPLORE_LANES) and its
    depth, two generations, which is its floor (one boundary and the final
    fold, which phase 14 runs again); every pinned leg keeps its depth and
    no gate is dropped. Returns the probe and the depths, which the child
    (phases 18, 19, 17, 16(e) and 20) is given."""
    ms_iter, iters = valve_probe(cuda)()
    scale = min(1.0, VALVE_REF_MS / ms_iter)
    full, grain = FULL_DEPTHS, DEPTH_GRAIN
    depths = {k: max(VALVE_FLOORS[k], round(v * scale * grain[k]) / grain[k])
              for k, v in full.items()}
    phase(9, f"host valve: an eager refill iteration at one shard took "
             f"{ms_iter:.1f} ms ({iters} iterations) against "
             f"{VALVE_REF_MS} ms on the reference host: scale "
             f"{scale:.2f}; 16(e) backup horizon {full['backup_explore_secs']}"
             f" -> {depths['backup_explore_secs']} virtual s, 17(d) raft "
             f"horizon {full['serve_secs']} -> {depths['serve_secs']} "
             f"virtual s; 13(b)/14 at {EXPLORE_LANES} lanes")
    return {"ms_per_iteration": ms_iter, "iterations": iters,
            "scale": scale, "depths": depths}


def contention_probe() -> dict:
    """How much the child (phases 18, 19, 17, 16(e) and 20) slows this
    process's eager work beside it: valve_probe alone, then again and
    again until the child ends, each probe placed in the child's phase by
    the wall-clock marks the child returns, then alone again."""
    import torch.utils.deterministic as tdet

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    torch.use_deterministic_algorithms(True)
    tdet.fill_uninitialized_memory = False  # as where the valve probes
    cuda = torch.device(CARD)
    card = card_line()
    print(card, flush=True)
    run = valve_probe(cuda)
    before = [run()[0] for _ in range(3)]
    child = spawn_child(MESH_FLAG, json.dumps(FULL_DEPTHS))
    series = []
    try:
        while child.poll() is None:
            t = time.time()
            series.append((t, run()[0]))
        res = join_child(child, "the child", 60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    after = [run()[0] for _ in range(3)]
    marks = res["marks"]
    order = sorted(marks, key=marks.get)
    alone = statistics.median(before + after)
    by_phase = {}
    for name, start in zip(order, order[1:]):
        ms = [m for t, m in series if marks[name] <= t < marks[start]]
        if ms:
            by_phase[name] = {"probes": len(ms),
                              "median_ms": statistics.median(ms),
                              "slowdown": statistics.median(ms) / alone}
    print(f"contention on {card}: an eager refill iteration alone "
          f"{[round(m, 2) for m in before]} before, "
          f"{[round(m, 2) for m in after]} after the child (median "
          f"{alone:.2f} ms); beside the child's "
          + "; ".join(f"{k}: {v['probes']} probes, median "
                      f"{v['median_ms']:.2f} ms (x{v['slowdown']:.2f})"
                      for k, v in by_phase.items())
          + f"; the child {res['wall_s']:.1f} s", flush=True)
    return {"card": card, "before_ms": before, "after_ms": after,
            "by_phase": by_phase, "series": series, "marks": marks,
            "child_s": res["wall_s"]}


def child_phases(depths: dict) -> dict:
    """The child process beside phases 10-16(d): phases 18, 19, 17, 16(e)
    and 20, one after another, fills off as in phases 7-16, two CPU
    threads for its CPU references (the parent's phases run beside it),
    17(d) and 16(e) at the valve's `depths`. Returns phase 18's report
    with the others' under "host_oracle", "tune_serve", "speclang_explore"
    and "host_faces", and the wall-clock time each phase started
    ("marks")."""
    import torch.utils.deterministic as tdet

    torch.use_deterministic_algorithms(True)
    tdet.fill_uninitialized_memory = False
    torch.set_num_threads(2)
    cuda, card = torch.device(CARD), card_line()
    marks = {"start": time.time() - (time.perf_counter() - T_START)}
    work = tempfile.mkdtemp(prefix="chip_smoke_child-")
    try:
        marks["18"] = time.time()
        out = phase18_mesh(cuda, card, work)
        marks["19"] = time.time()
        out["host_oracle"] = phase19_host_oracle(cuda, card, work)
        marks["17"] = time.time()
        out["tune_serve"] = phase17_tune_serve(cuda, card, work,
                                               depths["serve_secs"])
        marks["16(e)"] = time.time()
        out["speclang_explore"] = phase16e_explore(
            cuda, depths["backup_explore_secs"])
        marks["20"] = time.time()
        out["host_faces"] = phase20_host_faces(cuda, card)
        marks["end"] = time.time()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out | {"marks": marks, "depths": depths,
                  "wall_s": time.perf_counter() - T_START}


def timed_calls_of(obj, name: str, calls: list, keep=None) -> None:
    """Wrap obj.<name> (a sim's method or a module's function) to record
    (result, synchronized wall seconds) of each call; `keep(result)`, when
    given, records what to keep of the result instead of all of it."""
    inner = getattr(obj, name)

    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        res = inner(*a, **kw)
        torch.cuda.synchronize()
        calls.append((res if keep is None else keep(res),
                      time.perf_counter() - t0))
        return res

    setattr(obj, name, wrapped)


if __name__ == "__main__":
    if sys.argv[1:2] == [PROFILE_FLAG]:
        # phase 5's child process: its result is its last stdout line
        print(json.dumps(phase5_profile(float(sys.argv[2]),
                                        float(sys.argv[3]))), flush=True)
        sys.exit(0)
    if sys.argv[1:2] == [GOLDEN_FLAG]:
        # phase 6's child process, fills off as in phases 7-16: its phase
        # lines count seconds from its own start; its result is its last
        # stdout line
        import torch.utils.deterministic as tdet

        torch.use_deterministic_algorithms(True)
        tdet.fill_uninitialized_memory = False
        golden = phase6_golden(torch.device(CARD))
        speclang = phase16_golden(torch.device(CARD))
        print(json.dumps({"golden": golden, "speclang": speclang,
                          "wall_s": time.perf_counter() - T_START}),
              flush=True)
        sys.exit(0)
    if sys.argv[1:2] == [ORACLE_CPU_FLAG]:
        # phase 19's CPU references, in their own process beside the card
        # legs, on one CPU thread: its result is its last stdout line
        torch.use_deterministic_algorithms(True)
        torch.set_num_threads(1)
        print(json.dumps(phase19_cpu_references()
                         | {"wall_s": time.perf_counter() - T_START}),
              flush=True)
        sys.exit(0)
    if sys.argv[1:2] == [HOSTFACE_CPU_FLAG]:
        # phase 20's CPU references, in their own process beside the card
        # legs, on one CPU thread: its result is its last stdout line
        torch.use_deterministic_algorithms(True)
        torch.set_num_threads(1)
        print(json.dumps(phase20_cpu_references()
                         | {"wall_s": time.perf_counter() - T_START}),
              flush=True)
        sys.exit(0)
    if sys.argv[1:2] == [SERIAL_FLAG]:
        print(json.dumps(serial_probe()), flush=True)
        sys.exit(0)
    if sys.argv[1:2] == [CONTENTION_FLAG]:
        print(json.dumps(contention_probe()), flush=True)
        sys.exit(0)
    if sys.argv[1:2] == [MESH_FLAG]:
        # the child of phases 18, 19, 17, 16(e) and 20: its phase lines count
        # seconds from its own start; its result is its last stdout line
        print(json.dumps(child_phases(json.loads(sys.argv[2]))), flush=True)
        sys.exit(0)
    report = main()
    print("report: " + json.dumps(report), flush=True)
    print("kernels: none — the JAX package has no Pallas kernel to port, "
          "so no hand-written kernel is on the main path", flush=True)
    print(json.dumps({"kernels": []}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
