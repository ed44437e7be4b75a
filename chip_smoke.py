"""On-card smoke run of the PyTorch/CUDA port (`madsim_tpu_torch`).

Run from the repo root on a machine with one CUDA card:

    python3 chip_smoke.py

It drives the port's main path — the 5-node Raft fuzz sweep through
`BatchedSim.run` and `summarize`, then FaultPlan chaos and the four other
workloads — and checks it, in eight phases:

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
5. profile: torch.profiler over 20 steady steps at 32768 lanes — kernels
   launched per step, device idle share, top device kernels;
6. golden: each of the five workloads (raft, paxos, kv, twopc, chain) runs
   its pinned 16-lane, 1500-step CHAOS_PLAN run on the card, and its
   canonical digest must equal the JAX package's GOLDEN value; the Raft
   run is also held leaf for leaf (`nem.*` included) against the CPU;
7. storm sweep: the bench Raft spec under `compile_plan` of an eight-clause
   plan (the documented raft-storm plan plus LinkClog, LatencySpike and
   MsgLoss) at 32768 lanes x 5 nodes, 10 virtual seconds: a warm run, then
   a timed run; every enabled fire kind must fire, and seeds 0..63 must
   equal a 64-lane run of the same config per seed in every leaf but
   `key` (a done lane's key advances while any lane of its batch runs);
8. workloads: paxos, chain (8192 lanes), kv and twopc (32768 lanes) at
   their factories' defaults, 10 virtual seconds (cut when a probed step
   time says the phase would overrun its budget; the cut is printed), one
   timed run each; kv's exact linearizability check runs over lanes
   0..127 and its counts are printed.

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
PHASE4_BUDGET_S = 300.0
STORM_LANES = 32768
# phase 8: (workload, lanes, max_steps at 10 virtual s) as bench.py runs
# them
WORKLOADS = (
    ("paxos", 8192, 18_000),
    ("chain", 8192, 26_000),
    ("kv", 32768, 14_000),
    ("twopc", 32768, 18_000),
)
# the whole script must end well inside the 1200 s the card run allows;
# phase 8 splits what is left of this target across its timed runs
TARGET_S = 900.0
T_START = time.perf_counter()
KV_CHECK_LANES = 128


def phase(n: int, msg: str) -> None:
    print(f"phase {n}: {msg}", flush=True)


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


def timed_run(sim, seeds, max_steps):
    """(final state, wall seconds) of one synchronized sweep."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = sim.run(seeds, max_steps)
    torch.cuda.synchronize()
    return st, time.perf_counter() - t0


def probe_step_ms(sim, lanes: int, steps: int = 10) -> float:
    """Wall ms per step of `steps` steps after 3 warm steps at `lanes`."""
    st = sim.init(range(lanes))
    for _ in range(3):
        st = sim.step(st)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        st = sim.step(st)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


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

    # -- 5. profile over steady steps
    st = sim.init(range(LANES))
    for _ in range(200):
        st = sim.step(st)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

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
                "launch_calls_per_step": launch_calls / PROFILE_STEPS}
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
            "idle_share_unprofiled": 1.0 - busy_ms / head["step_ms"],
            "top": [{"name": n[:120], "ms_per_step": t / PROFILE_STEPS / 1e3,
                     "count_per_step": c / PROFILE_STEPS}
                    for n, (t, c) in top],
        }
        phase(5, f"profile {PROFILE_STEPS} steps at {LANES} lanes: "
                 f"{prof_out['kernels_per_step']:.0f} kernels/step "
                 f"({prof_out['launch_calls_per_step']:.0f} launch calls), "
                 f"device busy {busy_ms:.3f} ms/step; idle share "
                 f"{prof_out['idle_share']:.3f} of the profiled "
                 f"{window_us / PROFILE_STEPS / 1e3:.3f} ms/step, "
                 f"{prof_out['idle_share_unprofiled']:.3f} of phase 4's "
                 f"{head['step_ms']:.3f} ms/step")
        for i, k in enumerate(prof_out["top"]):
            print(f"  top{i + 1}: {k['ms_per_step']:.4f} ms/step "
                  f"x{k['count_per_step']:.0f} {k['name'][:90]}", flush=True)
    else:
        prof_out["kernels_per_step"] = None
        phase(5, f"profile: torch.profiler recorded no device events; "
                 f"step {window_us / PROFILE_STEPS / 1e3:.3f} ms by host "
                 f"clock, {prof_out['launch_calls_per_step']:.0f} launch "
                 "calls/step; device kernels and idle share not measured")

    # deterministic mode also fills every fresh uninitialized allocation
    # (torch.utils.deterministic.fill_uninitialized_memory); the step
    # writes all of every output it allocates, so the fills change no
    # result: measure the same steps with and without them
    import torch.utils.deterministic as tdet

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
    phase(5, f"uninitialized-memory fills on: {launches_fill} launches, "
             f"{ms_fill:.3f} ms/step; off: {launches_nofill} launches, "
             f"{ms_nofill:.3f} ms/step; leaves equal after "
             f"{PROFILE_STEPS + 1} steps")
    report["profile"] = prof_out
    del st, a, b
    report["golden"] = phase6_golden(cuda)
    report["storm"] = phase7_storm(cuda)
    report["workloads"] = phase8_workloads(cuda)
    report["total_s"] = time.perf_counter() - T_START
    return report


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
    cfg = compile_plan(storm_plan(), raft_bench_config(10.0))
    sim = BatchedSim(spec, cfg, device=cuda)
    t_phase = time.perf_counter()
    warm, warm_s = timed_run(sim, range(STORM_LANES), MAX_STEPS)
    check(bool(warm.done.all()), "storm warm run hit max_steps")
    warm64 = state_to_numpy(first_lanes(warm, SEEDS_SMALL))
    del warm
    torch.cuda.reset_peak_memory_stats()
    seeds = np.arange(STORM_LANES, dtype=np.int64) + STORM_LANES
    st, wall = timed_run(sim, seeds, MAX_STEPS)
    check(bool(st.done.all()), "storm timed run hit max_steps")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    s = summarize(st, spec)
    steps_run = int(st.steps.max())
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
        "lanes": STORM_LANES, "nodes": 5, "virtual_secs": 10.0,
        "plan": [type(c).__name__ for c in storm_plan().clauses],
        "warm_s": warm_s, "wall_s": wall, "seeds_per_sec": STORM_LANES / wall,
        "step_ms": wall / steps_run * 1e3, "steps_run": steps_run,
        "events_per_sec": s["total_events"] / wall,
        "total_overflow": s["total_overflow"], "violations": s["violations"],
        "peak_mem_gib": peak_gib, "fires": fires,
        "phase_s": time.perf_counter() - t_phase,
    }
    phase(7, f"storm {STORM_LANES} lanes x 5 nodes, 10 virtual s, "
             f"{len(out['plan'])} clauses: {out['seeds_per_sec']:.1f} seeds/s, "
             f"{out['step_ms']:.3f} ms/step x {steps_run} steps ({wall:.3f} s; "
             f"warm run {warm_s:.3f} s), {out['events_per_sec']:.0f} events/s, "
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
        ms = probe_step_ms(sim, lanes)
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


if __name__ == "__main__":
    report = main()
    print("report: " + json.dumps(report), flush=True)
    print("kernels: none — the JAX package has no Pallas kernel to port, "
          "so no hand-written kernel is on the main path", flush=True)
    print(json.dumps({"kernels": []}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
