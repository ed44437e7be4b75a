"""On-card smoke run of the PyTorch/CUDA port (`madsim_tpu_torch`).

Run from the repo root on a machine with one CUDA card:

    python3 chip_smoke.py

It drives the port's main path — the 5-node Raft fuzz sweep through
`BatchedSim.run` and `summarize`, then FaultPlan chaos, the four other
workloads, the membership, durability and straggler paths with their
workloads, and the triage path (trace, shrink, replay) — and checks it, in
ten phases:

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
5. profile, in a child process (a profiler session slows its process's
   later steps): torch.profiler over 20 steady steps at 32768 lanes —
   kernels launched per step, device idle share, top device kernels — and
   the same steps with and without deterministic mode's
   uninitialized-memory fills, leaves equal; phases 6-10 then run without
   the fills;
6. golden: each of the five workloads (raft, paxos, kv, twopc, chain) runs
   its pinned 16-lane, 1500-step CHAOS_PLAN run on the card, and its
   canonical digest must equal the JAX package's GOLDEN value; the Raft
   run is also held leaf for leaf (`nem.*` included) against the CPU;
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
   never below half, when a probed step time says the runs would pass
   PHASE9_END_S; the cut is printed). The correct builds never violate,
   every enabled fire
   kind fires and stragglers ride the side pool, each planted bug fires on
   at least the share of lanes its JAX test demands (isr > 64/128, lease >
   16/128, wal >= 8/256, twopc > 0), every violating wal lane lost
   unsynced state, and seeds 0..63 of the buggy 2PC run equal a 64-lane
   card run in every leaf but `key`. Then a 64-lane two-handler Raft run at
   unequal ring depths and a 64-lane Raft run under Reconfig + DiskFault
   (crash-wipe, skew and the tail composed in) are leaf-equal card/CPU;
10. triage (after phase 9, before phase 8): the planted deposed-leader
   re-stamp Raft under Crash + Partition (`triage_workload`, 5 virtual s)
   through `run_batch(range(24), ..., max_traces=1,
   shrink_on_violation=True)`. The first violating seed is traced (its
   final state equals its batch lane in every leaf but `key`, its
   TraceRecord stream equals the CPU's leaf for leaf, and its events end
   in VIOLATION at the lane's violation step), shrunk in at most 10
   batched dispatches into a bundle whose digest is
   `digest.PINNED_BUNDLE`, replayed twice by `repro.replay_device` at the
   bundle's step and time, and its shrunk plan passes the twin schedule
   check under the bundle's ctl. A triage sim under the default ctl
   reproduces phase 2's bench run leaf for leaf (ctl aside).

The port has no hand-written kernel (the JAX package has no Pallas kernel
to port), so the kernel list is empty; the reason is printed on the line
before it. The full measurements are printed as one `report: {...}` line.
The last line is the run's result; any failed check exits non-zero before
it.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
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
PHASE4_BUDGET_S = 300.0
STORM_LANES = 32768
PHASE7_BUDGET_S = 60.0
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
# phase 9's runs must end by then (its two 64-lane card/CPU parity runs
# and phase 10's at most PHASE10_BUDGET_S follow); phase 8 then gets what
# is left of TARGET_S
PHASE10_BUDGET_S = 200.0
PHASE9_END_S = 960.0 - PHASE10_BUDGET_S
# phase 10: the triage sweep's seeds, and the spec reference its bundle
# carries (resolved from the repo root by repro.resolve_spec)
TRIAGE_SEEDS = 24
TRIAGE_SPEC_REF = "chip_smoke:planted_restamp_spec"
# the buggy run whose seeds 0..63 are held against a 64-lane run (the
# two-handler path and the straggler pool; one such run fits the time)
PHASE9_INDEPENDENCE = "twopc_tail"
PHASE9_PARITY_STEPS = 200
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
    from madsim_tpu_torch.tpu import BatchedSim, summarize
    from madsim_tpu_torch.tpu import prng
    from madsim_tpu_torch.tpu.convert import state_to_numpy
    from madsim_tpu_torch.tpu.digest import PINNED, canonical_digest, pinned_run
    from madsim_tpu_torch.tpu.raft import make_raft_spec, raft_bench_config
    from madsim_tpu_torch.tpu.spec import (
        INF_GUARD, REBASE_US, expand_to, tree_map,
    )

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

    # -- 4. headline sweep
    spec = make_raft_spec(**kw)
    virtual_secs = 10.0
    sim = BatchedSim(spec, raft_bench_config(virtual_secs), device=cuda)
    probe = sim.init(range(LANES))
    for _ in range(3):
        probe = sim.step(probe)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        probe = sim.step(probe)
    torch.cuda.synchronize()
    probe_ms = (time.perf_counter() - t0) / PROFILE_STEPS * 1e3
    # a 10 s horizon takes ~1210 steps; 4 sweeps must fit the phase budget
    est_s = 4 * 1210 * probe_ms / 1e3
    cut = ""
    if est_s > PHASE4_BUDGET_S:
        virtual_secs = max(1.0, round(10.0 * PHASE4_BUDGET_S / est_s, 1))
        cut = (f" (cut: virtual_secs 10 -> {virtual_secs}; 4 sweeps at "
               f"{probe_ms:.2f} ms/step were estimated at {est_s:.0f} s)")
        sim = BatchedSim(spec, raft_bench_config(virtual_secs), device=cuda)
    del probe
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

    # -- 5. profile over steady steps, in a child process: a CUDA profiler
    # session leaves its process's later host steps slower (PERF.md,
    # section 5), so the process that profiles is not the one that runs
    # phases 6-10
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), PROFILE_FLAG,
         str(virtual_secs), str(head["step_ms"])],
        capture_output=True, text=True, timeout=900,
    )
    check(child.returncode == 0,
          f"phase 5's profiling process failed: {child.stderr[-3000:]}")
    prof_out = json.loads(child.stdout.strip().splitlines()[-1])
    if prof_out["kernels_per_step"] is not None:
        phase(5, f"profile {PROFILE_STEPS} steps at {LANES} lanes: "
                 f"{prof_out['kernels_per_step']:.0f} kernels/step "
                 f"({prof_out['launch_calls_per_step']:.0f} launch calls), "
                 f"device busy {prof_out['device_busy_ms_per_step']:.3f} "
                 f"ms/step; idle share {prof_out['idle_share']:.3f} of the "
                 f"profiled {prof_out['window_ms'] / PROFILE_STEPS:.3f} "
                 f"ms/step, {prof_out['idle_share_unprofiled']:.3f} of phase "
                 f"4's {head['step_ms']:.3f} ms/step")
        for i, k in enumerate(prof_out["top"]):
            print(f"  top{i + 1}: {k['ms_per_step']:.4f} ms/step "
                  f"x{k['count_per_step']:.0f} {k['name'][:90]}", flush=True)
    else:
        phase(5, f"profile: torch.profiler recorded no device events; "
                 f"step {prof_out['window_ms'] / PROFILE_STEPS:.3f} ms by "
                 f"host clock, {prof_out['launch_calls_per_step']:.0f} "
                 "launch calls/step; device kernels and idle share not "
                 "measured")
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
    phase(5, "phases 6-10 run with uninitialized-memory fills off")
    report["profile"] = prof_out
    report["golden"] = phase6_golden(cuda)
    report["storm"] = phase7_storm(cuda)
    report["membership"] = phase9_membership(cuda)
    report["triage"] = phase10_triage(cuda, small["raft_bench"], card)
    report["workloads"] = phase8_workloads(cuda)
    report["total_s"] = time.perf_counter() - T_START
    return report


def phase5_profile(virtual_secs: float, head_step_ms: float) -> dict:
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
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in dev_events)
        busy, cur_s, cur_e = 0.0, *spans[0]
        for a, b in spans[1:]:
            if a > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = a, b
            else:
                cur_e = max(cur_e, b)
        busy += cur_e - cur_s
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
            # the same device time with phase 4's step time
            "idle_share": 1.0 - busy / window_us,
            "idle_share_unprofiled": 1.0 - busy_ms / head_step_ms,
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
    return prof_out


def phase6_golden(cuda) -> dict:
    """The JAX package's five GOLDEN digests, reproduced on the card."""
    from madsim_tpu_torch.tpu import BatchedSim
    from madsim_tpu_torch.tpu.convert import state_to_numpy
    from madsim_tpu_torch.tpu.digest import GOLDEN, canonical_digest, golden_run

    out = {}
    for name in ("raft", "paxos", "kv", "twopc", "chain"):
        spec, cfg, seeds, steps = golden_run(name)
        st, wall = timed_run(BatchedSim(spec, cfg, device=cuda), seeds, steps)
        g = state_to_numpy(st)
        check(bool((g["steps"] == steps).all()) and not g["done"].any(),
              f"golden {name}: the run did not take exactly {steps} live steps")
        dg = canonical_digest(g)
        check(dg == GOLDEN[name],
              f"golden {name}: card digest {dg} != GOLDEN {GOLDEN[name]}")
        extra = ""
        if name == "raft":
            c = state_to_numpy(BatchedSim(spec, cfg, device="cpu").run(
                seeds, steps, dispatch_steps=steps))
            bad = leaves_equal(g, c)
            check(not bad, f"golden raft: card and CPU leaves differ: {bad}")
            n_nem = sum(1 for k in g if k.startswith("nem."))
            extra = f", {len(g)} leaves ({n_nem} nem.*) equal card/CPU"
        out[name] = {"lanes": len(seeds), "steps": steps, "card_s": wall,
                     "step_ms": wall / steps * 1e3, "digest": dg}
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
    ms = probe(sim, STORM_LANES)[0]
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
        ms = probe(sim, lanes)[0]
        est_s = est_steps[name] * ms / 1e3
        budget_s = (TARGET_S - (time.perf_counter() - T_START)) / (
            len(WORKLOADS) - i)
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
        ms, st = probe(sim, lanes)
        strag_pending = (None if st.strag is None
                         else int(st.strag.valid.sum()))
        del st
        # the time left before PHASE9_END_S, shared by the runs still to
        # go (the 64-lane run counts as one); over it, the horizon is cut
        # (printed), never below half: the bug shares hold there (JAX
        # face, 512 lanes at half horizons: isr 0.98, lease 0.39, wal
        # 0.45, twopc 0.11 of lanes)
        left = len(runs) - i + 1
        budget_s = (PHASE9_END_S - (time.perf_counter() - T_START)) / left
        est_s = PHASE9_STEPS[tag] * ms / 1e3
        cut = ""
        if est_s > budget_s:
            virtual_secs = round(
                max(0.5, budget_s / est_s) * full_secs, 1)
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
            "strag_pending_after_13_steps": strag_pending,
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
                 + (f"; {strag_pending} stragglers pending after 13 "
                    "steps" if strag_pending is not None else "")
                 + extra)
        del st
    out["parity"] = phase9_parity(cuda)
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


def phase9_parity(cuda) -> dict:
    """64-lane card/CPU leaf equality of the two-handler path at unequal
    ring depths and of Raft under Reconfig + DiskFault."""
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
        st, wall = timed_run(BatchedSim(spec, cfg, device=cuda),
                             range(SEEDS_SMALL), steps)
        g = state_to_numpy(st)
        c = state_to_numpy(BatchedSim(spec, cfg, device="cpu").run(
            range(SEEDS_SMALL), steps))
        bad = leaves_equal(g, c)
        check(not bad, f"{name}: card and CPU leaves differ: {bad}")
        check(int(g["steps"].max()) == steps, f"{name}: ran short")
        out[name] = {"lanes": SEEDS_SMALL, "steps": steps, "card_s": wall,
                     "leaves": len(g)}
        phase(9, f"{name}: {SEEDS_SMALL} lanes x {steps} steps, "
                 f"{len(g)} leaves equal card/CPU")
    return out


def phase10_triage(cuda, bench64: dict, card: str) -> dict:
    """The triage path on the card: sweep, trace, shrink, replay, twin
    check; and the default ctl against phase 2's bench run. Its summary
    line names the card (`card`, as nvidia-smi reports it)."""
    import re
    import shutil
    import tempfile

    from madsim_tpu_torch import repro
    from madsim_tpu_torch.tpu import BatchedSim, run_batch
    from madsim_tpu_torch.tpu import nemesis as ttn
    from madsim_tpu_torch.tpu.convert import state_to_numpy
    from madsim_tpu_torch.tpu.digest import (
        PINNED, PINNED_BUNDLE, bundle_digest, canonical_digest, pinned_run,
    )
    from madsim_tpu_torch.tpu.engine import (
        DONE_CHECK_STEPS, IDLE_BLOCK_STEPS_DEFAULT, TraceRecord,
    )
    from madsim_tpu_torch.tpu.trace import extract_trace

    t_phase = time.perf_counter()
    wl = triage_workload()

    def timed_calls(sim, name, calls):
        """Wrap sim.<name> to record (result, wall seconds) of each call."""
        inner = getattr(sim, name)

        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = inner(*a, **kw)
            torch.cuda.synchronize()
            calls.append((out, time.perf_counter() - t0))
            return out

        setattr(sim, name, wrapped)

    # the sweep's and the shrinker's sims, pre-built so the trace leg's
    # (state, records) and the shrink's batched dispatches (its run calls;
    # its traced tail steps without run) can be read and timed
    sim = BatchedSim(wl.spec, wl.config, device=cuda)
    tsim = BatchedSim(wl.spec, wl.config, triage=True, device=cuda)
    traced, dispatched = [], []
    timed_calls(sim, "run_traced", traced)
    timed_calls(tsim, "run", dispatched)
    log = []
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_bundles-")
    try:
        # -- 1. sweep, shrink and trace through the user's entry point
        t0 = time.perf_counter()
        result = run_batch(
            range(TRIAGE_SEEDS), wl, sim=sim, max_traces=1,
            shrink_on_violation=True, shrink_kwargs={
                "out_dir": out_dir, "spec_ref": TRIAGE_SPEC_REF, "sim": tsim,
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
        cst, crecs = BatchedSim(wl.spec, wl.config, device="cpu").run_traced(
            seed, max_steps=vstep + 1)
        rec_fields = [f for f in TraceRecord._fields
                      if getattr(recs, f) is not None]
        bad = [f for f in rec_fields
               if not torch.equal(getattr(recs, f)[:vstep + 1].cpu(),
                                  getattr(crecs, f))]
        check(not bad, f"triage: card and CPU trace records differ: {bad}")
        final = state_to_numpy(st)
        cfinal = state_to_numpy(cst)
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
        dispatch_steps = [int(st.steps.max()) for st, _ in dispatched]
        check(dispatches == len(dispatch_s) and dispatches <= 10,
              f"triage: {dispatches} dispatches reported, {len(dispatch_s)} "
              "counted; at most 10 allowed")
        # from the end of the sweep loop to the shrinker's last report
        # line (its dispatches, its traced tail, the bundle's save)
        shrink_s = shrink_end - (t0 + result.device_ms / 1e3)
        bundle = result.bundle
        dg = bundle_digest(bundle)
        check(dg == PINNED_BUNDLE[1],
              f"triage: bundle digest {dg} != pinned {PINNED_BUNDLE[1]}")
        phase(10, f"shrink: {atoms_before} atoms -> {atoms_after} in "
                  f"{dispatches} dispatches of {dispatch_steps} steps "
                  f"({[round(x, 3) for x in dispatch_s]} s), "
                  f"{sum(dispatch_s) / dispatches * 1e3:.3f} ms/dispatch, "
                  f"{sum(dispatch_s) / sum(dispatch_steps) * 1e3:.3f} "
                  f"ms/step, "
                  f"shrink wall {shrink_s:.3f} s; dropped "
                  f"{bundle.dropped_clauses}, occ_off {bundle.occ_off}, "
                  f"violation step {bundle.violation_step} t="
                  f"{bundle.violation_t_us} us, horizon {bundle.horizon_us} "
                  f"us; bundle digest {dg[:16]} == pinned")

        # -- 4. replay twice, and the twin schedule check
        t3 = time.perf_counter()
        rep = repro.replay_device(bundle, repeats=2, device=cuda,
                                  out=lambda *_: None)
        replay_s = time.perf_counter() - t3
        check((rep["step"], rep["t_us"]) == (bundle.violation_step,
                                            bundle.violation_t_us),
              f"triage: replay at {rep} != the bundle's")
        twin = ttn.assert_device_matches_schedule(
            tsim, bundle.shrunk_plan(), seed, horizon_us=bundle.horizon_us,
            max_steps=bundle.violation_step + 2, ctl=bundle.ctl(1),
            occ_off=bundle.occ_off)
        phase(10, f"replay: violation at step {rep['step']} t={rep['t_us']} "
                  f"us in both of 2 runs, replay wall {replay_s:.3f} s; twin "
                  f"check: {twin} chaos events equal the shrunk schedule "
                  f"[{time.perf_counter() - t_phase:.0f} s in phase 10]")
        phase(10, f"on {card}: {result.violations} of {TRIAGE_SEEDS} seeds "
                  f"violating; {atoms_before} -> {atoms_after} atoms in "
                  f"{dispatches} dispatches, {trace_ms:.3f} ms per traced "
                  f"step, {sum(dispatch_s) / dispatches * 1e3:.3f} ms per "
                  f"shrink dispatch, shrink wall {shrink_s:.3f} s, replay "
                  f"wall {replay_s:.3f} s")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return {
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
        "phase_s": time.perf_counter() - t_phase,
    }


if __name__ == "__main__":
    if sys.argv[1:2] == [PROFILE_FLAG]:
        # phase 5's child process: its result is its last stdout line
        print(json.dumps(phase5_profile(float(sys.argv[2]),
                                        float(sys.argv[3]))), flush=True)
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
